"""The port's SKA (image_restoration_tpu_torch.ops.ska, kernels.ska) against
the JAX package's.

* ``ska_plain`` vs JAX ``ska_xla`` and vs ``ska_pallas._ska_forward`` run
  in interpret mode, fp32, rtol=atol=1e-5 (the JAX tests' own bound,
  tests/test_ska.py: the same taps summed in the same order, fp32).
* Shapes: ragged 7x9, and 5x3, where every pixel is within one of the
  border; wc in {2, 6, 16} with C / wc > 1, so that the channel map
  c -> c mod wc (a tile, not an interleave) is tested; k = 3, and k = 5 at
  one shape.
* bf16: the port's plain version vs JAX ``ska_xla`` on the same bf16
  inputs. Both sum in fp32 and round once, so they differ by at most one
  bf16 rounding step: atol = 2^-8 x max|JAX output|.
* The kernel's wrapper on a CPU tensor runs the plain version and counts
  no launch; malformed shapes raise before any work. The kernel itself runs
  only on the card: tests/test_torch_ska_cuda.py holds it to ska_plain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from image_restoration_tpu.kernels import ska_pallas as JK
from image_restoration_tpu.ops.ska import ska_xla
from image_restoration_tpu_torch.kernels import ska as TK
from image_restoration_tpu_torch.ops.ska import ska, ska_plain

# (B, H, W, C, wc, ks)
CASES = [(2, 7, 9, 12, 2, 3), (1, 7, 9, 24, 6, 3), (2, 8, 10, 32, 16, 3),
         (1, 5, 3, 12, 6, 3), (1, 7, 9, 12, 6, 5)]


def _inputs(case, seed=0):
    b, h, w, c, wc, ks = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c), dtype=np.float32)
    wt = rng.standard_normal((b, h, w, wc, ks * ks), dtype=np.float32)
    return x, wt


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_ska_xla(case):
    x, w = _inputs(case)
    want = np.asarray(ska_xla(jnp.asarray(x), jnp.asarray(w)))
    got = ska_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES[:3])
def test_plain_matches_pallas_interpret(case, monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    x, w = _inputs(case, seed=1)
    want = np.asarray(JK._ska_forward(jnp.asarray(x), jnp.asarray(w)))
    got = ska_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_bf16_matches_jax_bf16():
    x, w = _inputs((2, 7, 9, 24, 6, 3), seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    want = np.asarray(ska_xla(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                              jnp.asarray(wb.float().numpy(), jnp.bfloat16)),
                      np.float32)
    got = ska_plain(xb, wb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -8 * np.abs(want).max())


def test_wrapper_and_dispatcher_on_cpu_run_the_plain_version():
    x, w = (torch.from_numpy(a) for a in _inputs(CASES[1], seed=3))
    n = TK.ska.launches
    want = ska_plain(x, w)
    assert torch.equal(TK.ska(x, w), want)
    assert torch.equal(ska(x, w, use_kernel=True), want)
    assert torch.equal(ska(x, w, use_kernel=False), want)
    assert TK.ska.launches == n


@pytest.mark.parametrize("xs,ws", [
    ((1, 4, 4, 12), (1, 4, 4, 5, 9)),    # C not a multiple of wc
    ((1, 4, 4, 12), (1, 4, 4, 6, 4)),    # even kernel size (2x2)
    ((1, 4, 4, 12), (1, 4, 4, 6, 8)),    # k^2 not a square
    ((1, 4, 4, 12), (1, 4, 5, 6, 9)),    # pixel grids differ
    ((4, 4, 12), (1, 4, 4, 6, 9)),       # x not (B, H, W, C)
])
def test_malformed_shapes_raise(xs, ws):
    with pytest.raises(ValueError):
        TK.ska(torch.zeros(xs), torch.zeros(ws))
