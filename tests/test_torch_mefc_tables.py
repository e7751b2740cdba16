"""The MEFC step wrapper's launch tables and its CPU path (jax-free).

``kernels/mefc.py`` picks the step kernel's tile rows from
``_MEFC_TILE_ROWS``, measured at DRSformer's two Subnet widths; every width
a default DRSformer runs must have an entry, or it would silently take the
generic rule. On a CPU tensor the wrapper runs
``mefc_step_ref`` (bit-equal) and counts no launch.
"""

import numpy as np
import pytest
import torch
from test_torch_drs_cuda import mix_weights, step_params

from image_restoration_tpu_torch.kernels import mefc as M
from image_restoration_tpu_torch.models.drsformer import DRSformer, Subnet
from image_restoration_tpu_torch.utils.options import MODEL_DEFAULTS


def _default_subnet_widths():
    cfg = {k: v for k, v in MODEL_DEFAULTS["drsformer"].items()
           if k != "fused_block"}
    with torch.device("meta"):
        model = DRSformer(**cfg)
    return sorted({m.layers[1]._ops[0].step_params().wcat.shape[0]
                   for m in model.modules() if isinstance(m, Subnet)})


def test_default_widths_have_table_entries():
    widths = _default_subnet_widths()
    assert widths == [48, 96]
    for c in widths:
        assert M._MEFC_TILE_ROWS[c] in (1, 2, 4, 8)


@pytest.mark.parametrize("c", [48, 96])
def test_cpu_wrapper_runs_the_plain_version_uncounted(c):
    """Exact: the CPU wrapper is the plain version itself."""
    rng = np.random.default_rng(c)
    sp = step_params(rng, c, torch.device("cpu"))
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, c)).astype(np.float32))
    x = x.to(torch.bfloat16)
    m = M.fold_step(sp, mix_weights(rng, 2, torch.device("cpu")),
                    torch.bfloat16)
    before = M.mefc_step.launches
    assert torch.equal(M.mefc_step(x, sp, m), M.mefc_step_ref(x, sp, m))
    assert M.mefc_step.launches == before
