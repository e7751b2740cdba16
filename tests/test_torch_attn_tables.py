"""The attention core's launch tables and its CPU path (jax-free).

``kernels/attn_core.py`` picks K5's and K6's launch configurations from
per-width tables measured at Restormer-base's block widths; every width a
default Restormer runs must have an entry in each, or it would silently
take the generic configuration. On a CPU tensor the wrappers run
``attn_acc_ref``/``attn_apply_ref`` (bit-equal) and count no launch.
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import attn_core as KA
from image_restoration_tpu_torch.models.restormer import (
    Restormer,
    TransformerBlock,
)
from image_restoration_tpu_torch.utils.options import MODEL_DEFAULTS

TABLES = (KA._ACC_PIXELS, KA._ACC_RING, KA._ACC_WALK, KA._APPLY_PIXELS,
          KA._APPLY_WARPS, KA._APPLY_COLS, KA._APPLY_GROUPS)


def _default_block_widths():
    cfg = {k: v for k, v in MODEL_DEFAULTS["restormer"].items()
           if k != "fused_block"}
    with torch.device("meta"):
        model = Restormer(**cfg)
    return sorted({(m.attn.project_out.weight.shape[0], m.num_heads)
                   for m in model.modules()
                   if isinstance(m, TransformerBlock)})


def test_default_widths_have_table_entries():
    widths = _default_block_widths()
    assert widths == [(48, 1), (96, 1), (96, 2), (192, 4), (384, 8)]
    for c, heads in widths:
        ch = c // heads
        for table in TABLES:
            assert c in table, (c, table)
        pix, ring = KA._acc_config(c)
        assert pix % 16 == 0 and ring in (2, 3) and KA._ACC_WALK[c] >= 1
        pix, warps, cols, groups = KA._apply_config(c)
        assert pix % 16 == 0 and warps in (4, 8) and cols in (16, 48, 96)
        assert c % groups == 0 and (c // groups) % cols == 0
        assert cols == 16 or ch in (48, 96)


@pytest.mark.parametrize("c,heads", [(48, 1), (96, 2), (384, 8)])
def test_cpu_wrappers_run_the_plain_versions_uncounted(c, heads):
    """Exact: the CPU wrappers are the plain versions themselves."""
    rng = np.random.default_rng(c)
    ch = c // heads

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(torch.bfloat16)

    qkv, x = bf16((2, 5, 7, 3 * c)), bf16((2, 5, 7, c))
    at = bf16((2, heads, ch, ch))
    w = torch.from_numpy(rng.standard_normal((c, c, 1, 1)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    before = KA.attn_acc.launches, KA.attn_apply.launches
    for got, want in zip(KA.attn_acc(qkv, heads), KA.attn_acc_ref(qkv, heads)):
        assert torch.equal(got, want)
    assert torch.equal(KA.attn_apply(qkv, x, at, w, bias),
                       KA.attn_apply_ref(qkv, x, at, w, bias))
    assert (KA.attn_acc.launches, KA.attn_apply.launches) == before
