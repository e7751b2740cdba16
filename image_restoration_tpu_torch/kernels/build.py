"""Builds the CUDA kernels of ``kernels/csrc`` into one shared library.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds. The library goes to ``kernels/build/`` (ignored by
git) under a name that hashes the sources and flags: a changed source gets a
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ir_block_front_smem": (_I, [_I, _I, _I]),
    "ir_block_front": (_I, [_P] * 12 + [_I] * 7 + [_F, _P]),
    "ir_block_apply_gdfn_smem": (_I, [_I, _I]),
    "ir_block_apply_gdfn": (_I, [_P] * 13 + [_I] * 6 + [_F, _P]),
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
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, path)
    _LIBRARY = KernelLibrary(path, seconds, log)
    return _LIBRARY
