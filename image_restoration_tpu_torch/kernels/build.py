"""Builds the CUDA kernels of ``kernels/csrc`` into one shared library.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds: one ``nvcc -c`` per source, all started together,
then one link. The library goes to ``kernels/build/`` (ignored by git)
under a name that hashes the sources and flags: a changed source gets a
fresh build, an unchanged one is reused. Nothing is built at import; the
first kernel launch calls :func:`load_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ir_block_front_smem": (_I, [_I] * 4),
    "ir_block_front_blocks": (_I, [_I] * 4),
    "ir_block_front": (_I, [_P] * 12 + [_I] * 8 + [_F, _P]),
    "ir_block_apply_gdfn_smem": (_I, [_I, _I, _I]),
    "ir_block_apply_gdfn": (_I, [_P] * 13 + [_I] * 7 + [_F, _P]),
    "ir_drs_apply_msfn_smem": (_I, [_I] * 4),
    "ir_drs_apply_msfn": (_I, [_P] * 19 + [_I] * 9 + [_F, _P]),
    "ir_mefc_step_smem": (_I, [_I, _I]),
    "ir_mefc_step": (_I, [_P] * 7 + [_I] * 5 + [_P]),
    "ir_ska_blocks": (_I, [_I] * 7),
    "ir_ska": (_I, [_P] * 3 + [_I] * 11 + [_P]),
    "ir_ln_qkv_dwconv_smem": (_I, [_I] * 3),
    "ir_ln_qkv_dwconv": (_I, [_P] * 8 + [_I] * 6 + [_F, _P]),
    "ir_attn_acc_smem": (_I, [_I] * 4),
    "ir_attn_acc_blocks": (_I, [_I] * 4),
    "ir_attn_acc": (_I, [_P] * 5 + [_I] * 7 + [_P]),
    "ir_attn_apply_smem": (_I, [_I] * 6),
    "ir_attn_apply_blocks": (_I, [_I] * 6),
    "ir_attn_apply": (_I, [_P] * 6 + [_I] * 9 + [_P]),
    "ir_ln_gdfn_smem": (_I, [_I, _I, _I]),
    "ir_ln_gdfn": (_I, [_P] * 10 + [_I] * 7 + [_F, _P]),
    "ir_error_string": (ctypes.c_char_p, [_I]),
}


class KernelLibrary:
    """The loaded library, with how it was obtained (for reports)."""

    def __init__(self, path: Path, build_seconds: float, compiler_log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when an earlier build was reused
        self.compiler_log = compiler_log
        self.lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.restype, fn.argtypes = restype, argtypes

    def check(self, code: int, what: str):
        if code != 0:
            msg = self.lib.ir_error_string(code).decode()
            raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


_LIBRARY: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build(sources, tmp: Path, path: Path) -> str:
    """Compile every source at once, link them into ``path``; returns the
    compiler's output."""
    nvcc = _nvcc()
    objs = [tmp / f"{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    failed = [src.name for src, p in zip(sources, procs) if p.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    lib = tmp / path.name
    res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
                          *map(str, objs)],
                         capture_output=True, text=True)
    log += res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
    os.replace(lib, path)
    return log


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode() + src.read_bytes())
    path = BUILD_DIR / f"libirkernels-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log = _build(sources, Path(tmp), path)
        seconds = time.perf_counter() - t0
    _LIBRARY = KernelLibrary(path, seconds, log)
    return _LIBRARY
