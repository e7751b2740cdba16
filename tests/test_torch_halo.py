"""The port's halo exchange (``parallel/halo.py``) on gloo CPU ranks
against the JAX package's ``halo_tiled_apply`` on the 8-device CPU mesh.

``tests/test_halo.py``'s conv stack (three 5x5 convs with GELU: a
receptive-field radius of 6 rows) restores a (2, 64, 48, 3) image. At the
radius the port's 4-strip result equals JAX's 8-strip result and the
zero-extended unsharded forward (atol 1e-5, fp32 rounding of the convs);
at halo 2 it misses the latter by more than 1e-4; ``halo=0`` equals
window tiling; ``scale=2`` crops ``halo * scale`` rows; ``suggest_halo``
returns JAX's numbers. Ranks as in ``tests/test_torch_mesh_train.py``
(``spawn_ranks``, a ``file://`` rendezvous, a deadline).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from mesh_ranks import conv_net, halo_rank

from image_restoration_tpu_torch.parallel.dryrun import spawn_ranks
from image_restoration_tpu_torch.parallel.halo import suggest_halo as port_suggest

DEADLINE = 180.0


@pytest.fixture
def case():
    rng = np.random.default_rng(0)
    kernels = [(rng.standard_normal(s, dtype=np.float32) * 0.2)
               for s in ((5, 5, 3, 8), (5, 5, 8, 8), (5, 5, 8, 3))]
    x = rng.random((2, 64, 48, 3), dtype=np.float32)
    return kernels, x


def _jax_net(kernels):
    ks = [jnp.asarray(k) for k in kernels]

    def net(x):
        for k in ks:
            dn = jax.lax.conv_dimension_numbers(x.shape, k.shape,
                                                ("NHWC", "HWIO", "NHWC"))
            x = jax.lax.conv_general_dilated(x, k, (1, 1), [(2, 2), (2, 2)],
                                             dimension_numbers=dn)
            x = jax.nn.gelu(x)
        return x

    return net


def _nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def test_halo_matches_jax_at_the_radius(case, tmp_path):
    from image_restoration_tpu.core.mesh import make_mesh
    from image_restoration_tpu.parallel.halo import halo_tiled_apply

    kernels, x = case
    net = _jax_net(kernels)
    mesh = make_mesh((1, 1, 8), ("data", "expert", "spatial"))
    with mesh:
        want = np.asarray(halo_tiled_apply(net, jnp.asarray(x), mesh, halo=6))
    ref = np.asarray(net(jnp.pad(jnp.asarray(x),
                                 ((0, 0), (6, 6), (0, 0), (0, 0)))))[:, 6:-6]
    got = spawn_ranks(halo_rank, 4, str(tmp_path), DEADLINE, kernels=kernels,
                      x=_nchw(x), halos=(6, 2), scale=1, mesh_shape=(1, 4),
                      axes=("data", "spatial"))[0]
    exact = got[6].numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(exact, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(exact, ref, rtol=1e-5, atol=1e-5)
    small = got[2].numpy().transpose(0, 2, 3, 1)
    assert np.abs(small - ref).max() > 1e-4


def test_halo_zero_is_window_tiling_and_batch_axis(case, tmp_path):
    """``halo=0`` on a (2, 2) data x spatial mesh: each data rank its
    image, each spatial rank its strip, no exchange -- the strips' own
    forwards stacked."""
    kernels, x = case
    got = spawn_ranks(halo_rank, 4, str(tmp_path), DEADLINE, kernels=kernels,
                      x=_nchw(x), halos=(0,), scale=1, mesh_shape=(2, 2),
                      axes=("data", "spatial"), batch_axis="data")
    net = conv_net(kernels)
    xt = torch.from_numpy(_nchw(x))
    with torch.no_grad():
        want = torch.cat([net(xt[:, :, i * 32:(i + 1) * 32])
                          for i in range(2)], 2)
    for r in got:
        np.testing.assert_array_equal(r[0].numpy(), want.numpy())


def test_halo_scale_two(case, tmp_path):
    """A x2 restorer: each strip's output is cropped by ``halo * 2`` rows,
    and the stitched result equals the unsharded x2 forward of the
    zero-extended image."""
    kernels, x = case
    got = spawn_ranks(halo_rank, 2, str(tmp_path), DEADLINE, kernels=kernels,
                      x=_nchw(x), halos=(6,), scale=2, mesh_shape=(2,),
                      axes=("spatial",))[0][6]
    net = conv_net(kernels, 2)
    xt = torch.nn.functional.pad(torch.from_numpy(_nchw(x)), (0, 0, 6, 6))
    with torch.no_grad():
        want = net(xt)[:, :, 12:-12]
    assert got.shape == (2, 3, 128, 96)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("geometry", [
    dict(num_blocks=(4, 6, 6, 8), num_refinement_blocks=4),
    dict(num_blocks=(4, 6, 6, 8), num_refinement_blocks=4, align=8),
    dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, align=8),
    dict(num_blocks=(4, 6, 6, 8), num_refinement_blocks=4, cap=32),
    dict(num_blocks=(2,), num_refinement_blocks=0, kernel=5,
         dwconvs_per_block=1),
])
def test_suggest_halo_matches_jax(geometry):
    from image_restoration_tpu.parallel.halo import suggest_halo

    assert port_suggest(**geometry) == suggest_halo(**geometry)


def test_suggest_halo_values():
    """The numbers the dry run and the chip phase use."""
    assert port_suggest((1, 1, 1, 1), 1, align=8) == 64
    assert port_suggest((4, 6, 6, 8), 4, align=8) == 312
