"""Training through the whole-block kernels on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no jax (tests/test_torch_train.py holds the same trainer to
the JAX package on the CPU):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py -q

A small Restormer (dim 16, blocks 1/1/1/1, 1 refinement block: 8
TransformerBlocks, head width 16 at every level) in bf16 with
``fused_block`` takes two train steps on a batch of 2 at 64x64: each step's
forward launches K1 and K2 once a block and its backward neither; the
losses are finite. Gradient rule (``chip_smoke.py`` phase 4's, phase 3's
rule applied to gradients): the relative L2 error of all parameter
gradients of the kernel bf16 model against the plain fp32 model is within
3x the plain bf16 model's, from the same weights and batch.

A small MoCE-IR (dim 16, levels 3, one EncoderBlock a level and one
refinement block: 4 blocks on K1/K2, head width 16; three decoder blocks,
top-1 of 4 experts, ``rank_type="spread"``, ``with_complexity``; every
bias seeded, as the init's are zero) trains with ``train=True``: a step's
forward launches K1 and K2 once per EncoderBlock and its backward
neither, the balance loss is logged and finite, and its gradients hold
the same rule against the plain models', all three routed with the same
noise (a device generator of one seed). ``routing_noise`` draws the same
numbers from two device generators of one seed, and others from another.
"""

import numpy as np
import pytest
import torch
from seeding import seed_biases

from image_restoration_tpu_torch.data.degradations import step_generator
from image_restoration_tpu_torch.kernels import block as K
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.ops.moe import routing_noise
from image_restoration_tpu_torch.train import trainer as T
from image_restoration_tpu_torch.train.recipes import default_recipe

SMALL = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
             heads=(1, 2, 4, 8))
BLOCKS = 8
MOCE = dict(dim=16, levels=3, heads=(1, 2, 4), num_blocks=(1, 1, 1),
            num_dec_blocks=(1, 2), num_refinement_blocks=1, topk=1,
            num_experts=4, rank_type="spread", with_complexity=True)
MOCE_BLOCKS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(fused, dtype, device, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        m = get_model("restormer", fused_block=fused, dtype=dtype, **SMALL)
    return m.to(device).train()


def _batch(device, seed=1):
    rng = np.random.default_rng(seed)
    gt = rng.random((2, 3, 64, 64)).astype(np.float32)
    lq = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1)
    return {"lq": torch.from_numpy(lq.astype(np.float32)).to(device),
            "gt": torch.from_numpy(gt).to(device)}


def _flat(grads):
    return torch.cat([g.float().flatten() for g in grads.values()])


@pytest.mark.cuda
def test_gradients_hold_the_plain_models_rule(cuda):
    batch = _batch(cuda)
    recipe = default_recipe({"l1": 1.0})
    kern = _model(True, torch.bfloat16, cuda)
    before = (K.block_front.launches, K.block_apply_gdfn.launches)
    _, g_kern = T.loss_and_grads(kern, recipe, batch)
    torch.cuda.synchronize()
    assert (K.block_front.launches - before[0],
            K.block_apply_gdfn.launches - before[1]) == (BLOCKS, BLOCKS)
    grads = {}
    for name, fused, dtype in (("plain16", False, torch.bfloat16),
                               ("plain32", False, None)):
        m = _model(fused, dtype, cuda)
        m.load_state_dict(kern.state_dict())
        grads[name] = _flat(T.loss_and_grads(m, recipe, batch)[1])
    oracle = grads["plain32"]
    err_kern = ((_flat(g_kern) - oracle).norm() / oracle.norm()).item()
    err_plain = ((grads["plain16"] - oracle).norm() / oracle.norm()).item()
    assert np.isfinite(err_kern) and err_kern <= 3 * err_plain, (
        err_kern, err_plain)


@pytest.mark.cuda
def test_two_train_steps_through_the_kernels(cuda):
    model = _model(True, torch.bfloat16, cuda)
    cfg = T.TrainerConfig(learning_rate=1e-3, ema_decay=0.999)
    tx = T.make_optimizer(cfg)
    state = T.TrainState.create(model, tx, ema_decay=cfg.ema_decay)
    step = T.make_train_step(model, tx, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        start = (K.block_front.launches, K.block_apply_gdfn.launches)
        state, logs = step(state, _batch(cuda, seed=i))
        torch.cuda.synchronize()
        assert (K.block_front.launches - start[0],
                K.block_apply_gdfn.launches - start[1]) == (BLOCKS, BLOCKS)
        assert logs["total"].device.type == "cuda"
        assert torch.isfinite(logs["total"]).item()
    assert state.step == 2
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) == len(before)


def _moce(fused, dtype, device):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        m = get_model("moce_ir", fused_block=fused, dtype=dtype, **MOCE)
    seed_biases(m, 1)  # the init's are 0
    return m.to(device).train()


@pytest.mark.cuda
def test_routing_noise_is_reproducible_on_the_card(cuda):
    a = routing_noise((8, 4), step_generator(0, 3, cuda, 1))
    b = routing_noise((8, 4), step_generator(0, 3, cuda, 1))
    c = routing_noise((8, 4), step_generator(0, 4, cuda, 1))
    assert a.device.type == "cuda" and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        routing_noise((8, 4), None)


@pytest.mark.cuda
def test_moce_ir_trains_through_the_kernels(cuda):
    batch = _batch(cuda)
    recipe = default_recipe({"l1": 1.0}, aux_loss_weight=0.01)
    kern = _moce(True, torch.bfloat16, cuda)
    cfg = T.TrainerConfig(learning_rate=1e-3, aux_loss_weight=0.01,
                          apply_kwargs={"train": True})
    tx = T.make_optimizer(cfg)
    state = T.TrainState.create(_moce(True, torch.bfloat16, cuda), tx)
    step = T.make_train_step(state.model, tx, cfg)
    start = (K.block_front.launches, K.block_apply_gdfn.launches)
    state, logs = step(state, batch, step_generator(0, 0, cuda, 1))
    torch.cuda.synchronize()
    assert (K.block_front.launches - start[0],
            K.block_apply_gdfn.launches - start[1]) == (MOCE_BLOCKS,
                                                        MOCE_BLOCKS)
    assert torch.isfinite(logs["aux"]).item() and logs["aux"].item() > 0

    def grads(model):
        kw = {"train": True, "generator": step_generator(0, 0, cuda, 1)}
        return _flat(T.loss_and_grads(model, recipe, batch, kw)[1])

    g_kern = grads(kern)
    runs = {}
    for name, dtype in (("plain16", torch.bfloat16), ("plain32", None)):
        m = _moce(False, dtype, cuda)
        m.load_state_dict(kern.state_dict())
        runs[name] = grads(m)
    oracle = runs["plain32"]
    err_kern = ((g_kern - oracle).norm() / oracle.norm()).item()
    err_plain = ((runs["plain16"] - oracle).norm() / oracle.norm()).item()
    assert np.isfinite(err_kern) and err_kern <= 3 * err_plain, (
        err_kern, err_plain)
