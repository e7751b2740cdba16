"""The port's inference surface: ``make_restore_fn`` against the JAX one, the
folder CLI, the package's independence from jax, and ``chip_smoke.py``'s
refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.cli.infer import make_restore_fn as jax_restore_fn
from image_restoration_tpu.models.restormer import Restormer as JRestormer
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--set", "model_kwargs.dim=16",
        "--set", "model_kwargs.num_blocks=(1,1,1,1)",
        "--set", "model_kwargs.num_refinement_blocks=1"]


def test_restore_odd_size_matches_jax():
    """37x45 reflect-pads to 40x48 in both packages and crops back; fp32
    with the same weights, atol=1e-4 (fp32 summation order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = parse_options(TINY + ["--fp32", "--device", "cpu"])
    model = build_model(cfg)
    jkw = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg["model_kwargs"].items()}
    jnet = JRestormer(**jkw)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 40, 48, 3)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        shapes)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict()),
                          strict=True)
    img = rng.random((37, 45, 3), dtype=np.float32)

    got = infer.make_restore_fn(cfg, model)(img)
    want = jax_restore_fn({"model": "restormer", "model_kwargs": jkw,
                           "pad_multiple": 8}, jnet, params)(img)
    assert got.shape == want.shape == (37, 45, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_infer_folder_cli(tmp_path):
    from PIL import Image

    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(37, 45), (32, 24)]):
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(str(src / f"im{i}.png"))
    outs = infer.main(TINY + ["--device", "cpu", "--input", str(src),
                              "--output_dir", str(tmp_path / "out")])
    assert [np.asarray(Image.open(p)).shape for p in outs] == [
        (37, 45, 3), (32, 24, 3)]
    with pytest.raises(SystemExit):
        infer.main(TINY + ["--device", "cpu"])  # no --input


@pytest.mark.parametrize("caller", [(True, True), (False, True),
                                    (True, False), (False, False)],
                         ids=["both_on", "cudnn_only", "matmul_only", "off"])
def test_restore_runs_without_tf32(caller):
    """The JAX restore runs under ``default_matmul_precision("highest")``
    whatever the dtype: the port's forward sees both TF32 flags False, and
    the caller's settings come back after, also when the forward raises."""
    seen = []

    class Stub(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, x):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            if x.shape[-1] == 24:
                raise RuntimeError("stub failure")
            return x * self.w

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = caller
        restore = infer.make_restore_fn({"pad_multiple": 8}, Stub())
        img = np.random.default_rng(3).random((13, 11, 3), dtype=np.float32)
        np.testing.assert_array_equal(restore(img), img)
        assert seen == [(False, False)]
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        assert after == caller
        with pytest.raises(RuntimeError, match="stub failure"):
            restore(np.zeros((24, 24, 3), np.float32))
        assert seen[-1] == (False, False)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == caller
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import image_restoration_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("args", [[], ["--tail", "8"],
                                  ["--front", "8", "4", "--warps", "16"],
                                  ["--msfn", "8", "4", "--warps", "8"],
                                  ["--mefc", "4", "2"],
                                  ["--ska", "2", "4", "--ring", "2"]],
                         ids=["full", "tail", "front", "msfn", "mefc", "ska"])
def test_chip_smoke_refuses_without_cuda(tmp_path, args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
