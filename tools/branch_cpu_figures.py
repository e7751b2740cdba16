"""The CPU figures behind the port's RectiFormer, FPN-Restormer and MyModel
notes (PERF.md §6, ROADMAP Queue 3 findings): each is printed on its own
line.

1. torch's FLOP count of each model at its ``MODEL_DEFAULTS`` on one 64x64
   image, and that count x 64 (a 512x512 image, as the convs and the
   channel attention scale with the pixels).
2. The largest imaginary part of the fft2 coefficients that are real for a
   real input (DC, the Nyquist row and column), JAX's CPU fft2 against
   torch's, at sides that are and are not powers of two.
3. FPN-Restormer (dim 16, two blocks a level) with BatchNorm statistics
   from two 64x64 images: max |output| at 64, 128, 256 and 512, then with
   statistics from a 512x512 image.
4. MyModel's whole-model input gradient (the configuration of
   tests/test_torch_mymodel.py): JAX compiled with the tests' ``FAST``
   options, JAX at XLA's full optimisation and the port, pairwise:
   relative L2 and max |difference| / max |gradient|.

Usage:  JAX_PLATFORMS=cpu python tools/branch_cpu_figures.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def flops():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from image_restoration_tpu_torch.models import get_model
    from image_restoration_tpu_torch.utils.options import MODEL_DEFAULTS

    torch.manual_seed(0)
    for name in ("rectiformer", "fpn_restormer", "mymodel"):
        model = get_model(name, **MODEL_DEFAULTS[name]).eval()
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model(torch.rand(1, 3, 64, 64))
        f = fc.get_total_flops()
        print(f"flops {name}: {f / 1e9:.3f} GFLOP at 64x64, "
              f"{64 * f / 1e12:.3f} TFLOP x64 (512x512)")


def fft_noise():
    import jax.numpy as jnp
    import torch

    for shape in ((2, 32, 32, 8), (2, 64, 64, 4), (2, 64, 48, 8),
                  (2, 32, 24, 4)):
        x = np.random.default_rng(0).standard_normal(shape).astype(
            np.float32)
        h, w = shape[1:3]
        real = [(0, 0), (0, w // 2), (h // 2, 0), (h // 2, w // 2)]
        zj = np.asarray(jnp.fft.fft2(jnp.asarray(x), axes=(1, 2)))
        zt = torch.fft.fft2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
        print(f"fft2 {shape}: max |imag| of the real coefficients, JAX "
              f"{max(np.abs(zj[:, i, j].imag).max() for i, j in real):.3e}, "
              f"torch "
              f"{max(np.abs(zt[:, i, j].imag).max() for i, j in real):.3e}")


def fpn_growth():
    import torch
    from seeding import seed_branches

    from image_restoration_tpu_torch.models import get_model

    kw = dict(dim=16, num_blocks=(2, 2, 2, 2), num_refinement_blocks=1)
    torch.manual_seed(0)
    model = get_model("fpn_restormer", **kw).eval()
    seed_branches(model, 1, torch.rand(2, 3, 64, 64))
    for side in (64, 128, 256, 512):
        with torch.no_grad():
            out = model(torch.rand(1, 3, side, side))
        print(f"fpn_restormer, statistics from 64x64: max |output| at "
              f"{side}x{side} {out.abs().max().item():.4g}")
    seed_branches(model, 1, torch.rand(1, 3, 512, 512))
    with torch.no_grad():
        out = model(torch.rand(1, 3, 512, 512))
    print(f"fpn_restormer, statistics from 512x512: max |output| at 512x512 "
          f"{out.abs().max().item():.4g}")


def mymodel_gradient_spread():
    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_mymodel as T
    from moe_parity import compiled

    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        v, x = T._variables()
        jnet = T.jm.MyModel(**T.TINY)
        g = np.random.default_rng(11).standard_normal(x.shape).astype(
            np.float32)

        def loss(p, a):
            return jnp.sum(jnet.apply({**v, "params": p}, a) * g)

        fast = np.asarray(compiled(jax.grad(loss, argnums=1), v["params"], x))
        full = np.asarray(jax.jit(jax.grad(loss, argnums=1))(v["params"], x))
        xt = T.nchw(x).requires_grad_(True)
        (T._port_model(v)(xt) * T.nchw(g)).sum().backward()
        port = T.nhwc(xt.grad)
    for name, a, b in (("JAX FAST - JAX full", fast, full),
                       ("port - JAX full", port, full),
                       ("port - JAX FAST", port, fast)):
        d = a - b
        print(f"mymodel input gradient, {name}: relative L2 "
              f"{np.linalg.norm(d) / np.linalg.norm(b):.3e}, max "
              f"{np.abs(d).max() / np.abs(b).max():.3e} x max")


if __name__ == "__main__":
    flops()
    fft_noise()
    fpn_growth()
    mymodel_gradient_spread()
