"""This slice's paths on the card: SKA's custom op (``kernels/ska.py``
``ska_op``, ``ir_torch::ska``) against the direct launch, forward and
backward, an exported LSNet-T that holds the op and launches K9 when
loaded, and two gloo ranks sharing the card through the halo exchange.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py -q

Rules: the op runs the same launch as ``_ska``, so its forward and both
gradients are bit-equal to the launches' (K9, K9b); the loaded program is
bit-equal to the live model (the same aten ops and the same K9 launches);
the halo exchange of a conv stack at its radius equals the zero-extended
forward within 1e-5 (cuDNN's fp32 convs, TF32 off).
"""

import io

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import ska as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ska_op_equals_the_launch(cuda, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 14, 14, 256),
                                             dtype=np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((4, 14, 14, 32, 9),
                                             dtype=np.float32)).to(cuda, dtype)
    n = K.ska.launches
    got = K.ska_op(x, w)
    torch.cuda.synchronize()
    assert K.ska.launches == n + 1
    assert torch.equal(got, K._ska(x, w))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = K.ska(xg, wg)
    go = torch.randn_like(out)
    out.backward(go)
    assert torch.equal(out.detach(), got)
    assert torch.equal(xg.grad, K.ska_bwd_x(x, w, go))
    assert torch.equal(wg.grad, K.ska_bwd_w(x, w, go))


@pytest.mark.cuda
def test_exported_lsnet_holds_and_launches_the_op(cuda, tmp_path):
    from image_restoration_tpu_torch.models import get_model
    from image_restoration_tpu_torch.train.distill import (
        export_program, load_program,
    )

    torch.manual_seed(0)
    model = get_model("lsnet", num_classes=0, use_pallas_ska=True,
                      dtype=torch.bfloat16).to(cuda).eval()
    x = torch.rand(4, 3, 224, 224, device=cuda)
    blob = export_program(model, (x,), str(tmp_path / "lsnet.pt2"))
    program = torch.export.load(io.BytesIO(blob))
    ops = [str(n.target) for n in program.graph.nodes]
    assert ops.count("ir_torch.ska.default") == 2  # LSNet-T's 2 LSConvs
    loaded = load_program(blob)
    n = K.ska.launches
    with torch.no_grad():
        got = loaded(x)
        torch.cuda.synchronize()
        assert K.ska.launches == n + 2
        assert torch.equal(got, model(x))


def _halo_rank(rank, n, init_method, x, kernels, halo):
    import torch.nn.functional as F

    from image_restoration_tpu_torch.core.mesh import make_mesh
    from image_restoration_tpu_torch.parallel.dryrun import join_group
    from image_restoration_tpu_torch.parallel.halo import (
        gather_strips, halo_tiled_apply,
    )

    join_group(rank, n, init_method, "cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((n,), ("spatial",))
    ws = [torch.from_numpy(k).cuda() for k in kernels]

    def net(t):
        for w in ws:
            t = F.gelu(F.conv2d(t, w, padding=2))
        return t

    with torch.no_grad():
        out = halo_tiled_apply(net, torch.from_numpy(x).cuda(), mesh, halo)
        return gather_strips(out, mesh).cpu()


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card_through_the_halo(cuda, tmp_path):
    import torch.nn.functional as F

    from image_restoration_tpu_torch.parallel.dryrun import spawn_ranks

    rng = np.random.default_rng(1)
    kernels = [rng.standard_normal(s, dtype=np.float32) * 0.2
               for s in ((8, 3, 5, 5), (3, 8, 5, 5))]
    x = rng.random((1, 3, 64, 48), dtype=np.float32)
    got = spawn_ranks(_halo_rank, 2, str(tmp_path), 300, x=x,
                      kernels=kernels, halo=4)
    torch.backends.cudnn.allow_tf32 = False
    t = F.pad(torch.from_numpy(x).cuda(), (0, 0, 4, 4))
    with torch.no_grad():
        for k in kernels:
            t = F.gelu(F.conv2d(t, torch.from_numpy(k).cuda(), padding=2))
    want = t[:, :, 4:-4].cpu()
    for out in got:
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
