"""The port's ``train/distill.py`` against the JAX package's: the feature
loss and its logs (1e-6), the three ``freeze_mask`` strategies on LSNet-T
(each parameter's mask against the JAX mask at the leaf the weight bridge
puts it on), ``frozen_optimizer`` against optax's ``multi_transform`` with
``set_to_zero`` over two AdamW steps with weight decay and a global-norm
clip (1e-6), the distillation step, and the ``torch.export`` round trip on
the CPU: an LSNet with ``use_pallas_ska`` keeps SKA as its custom op, and
a model whose kernels are ctypes launches refuses to export."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models.lsnet import lsnet_key_map
from image_restoration_tpu_torch.train import distill as D
from image_restoration_tpu_torch.train.trainer import Optimizer, TrainerConfig
from image_restoration_tpu_torch.utils import jax_bridge

SMALL = dict(img_size=64, num_classes=0)


def test_feature_distill_loss_matches_jax():
    from image_restoration_tpu.train.distill import feature_distill_loss

    rng = np.random.default_rng(0)
    s = rng.standard_normal((6, 32)).astype(np.float32)
    t = rng.standard_normal((6, 32)).astype(np.float32)
    t[2] = 0.0  # a zero feature: the eps clamp
    want, wlogs = feature_distill_loss(jnp.asarray(s), jnp.asarray(t), 0.7, 2.0)
    got, logs = D.feature_distill_loss(torch.from_numpy(s), torch.from_numpy(t),
                                       0.7, 2.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    for k in wlogs:
        np.testing.assert_allclose(float(logs[k]), float(wlogs[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def lsnet_tree():
    from image_restoration_tpu.models import get_model as jget

    jm = jget("lsnet", num_classes=10)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 224, 224, 3))))["params"]
    return params, get_model("lsnet", num_classes=10)


@pytest.mark.parametrize("kw", [
    dict(strategy="freeze_layers", frozen_layers=("blocks1", "mixer")),
    dict(strategy="freeze_all_except_last_layers"),
    dict(strategy="freeze_ratio", freeze_ratio=0.5),
])
def test_freeze_mask_matches_jax(lsnet_tree, kw):
    from image_restoration_tpu.train.distill import freeze_mask

    params, model = lsnet_tree
    want = freeze_mask(params, **kw)
    got = D.freeze_mask(model, key_map=lsnet_key_map, **kw)
    assert set(got) == {k for k, _ in model.named_parameters()}
    flips = 0
    for name, trainable in got.items():
        path = jax_bridge._locate(params, lsnet_key_map(name))
        node = want
        for p in path:
            node = node[p]
        assert trainable == bool(node), (name, path)
        flips += not trainable
    assert 0 < flips < len(got)


def test_frozen_optimizer_matches_optax_multi_transform():
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    mask = {"a": True, "b": False, "c": True}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 3
              for k, s in shapes.items()} for _ in range(2)]
    inner = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(1.0),
                        optax.adamw(1e-2, weight_decay=0.1))
    tx = optax.multi_transform({"train": inner, "frozen": optax.set_to_zero()},
                               {k: "train" if m else "frozen"
                                for k, m in mask.items()})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, up)

    opt = D.frozen_optimizer(Optimizer(TrainerConfig(
        learning_rate=1e-2, weight_decay=0.1, grad_clip=1.0)), mask)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = opt.init(tp)
    assert set(tstate["mu"]) == {"a", "c"}  # no moments for the frozen
    for g in grads:
        up, tstate = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                tstate, tp)
        for k in tp:
            tp[k] += up[k]
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tp["b"].numpy(), p0["b"])


def test_distill_step_trains_the_unfrozen():
    torch.manual_seed(0)
    teacher = get_model("lsnet", **SMALL)
    student = get_model("lsnet", **SMALL)
    mask = D.freeze_mask(student, "freeze_ratio", freeze_ratio=0.5,
                         key_map=lsnet_key_map)
    tx = D.frozen_optimizer(Optimizer(TrainerConfig(learning_rate=1e-3)), mask)
    step = D.make_distill_step(student, teacher, tx)
    before = {k: p.detach().clone() for k, p in student.named_parameters()}
    x = torch.rand(2, 3, 64, 64)
    logs = [step(x) for _ in range(2)]
    assert all(np.isfinite(float(lg["total"])) for lg in logs)
    moved = {k: not torch.equal(p.detach(), before[k])
             for k, p in student.named_parameters()}
    assert not any(moved[k] for k, m in mask.items() if not m)
    # a trainable parameter stays only where its gradient is exactly 0
    # (a 3x3 depthwise conv on stage 4's 1x1 map into a batch-2
    # BatchNorm, whose output does not depend on the conv's scale)
    train = [k for k, m in mask.items() if m]
    assert sum(moved[k] for k in train) > 0.9 * len(train)
    assert len(train) < len(mask)


def test_export_round_trip_keeps_the_ska_op(tmp_path):
    model = get_model("lsnet", use_pallas_ska=True, **SMALL).eval()
    x = torch.rand(2, 3, 64, 64)
    path = tmp_path / "lsnet.pt2"
    blob = D.export_program(model, (x,), str(path))
    assert path.read_bytes() == blob
    program = torch.export.load(str(path))
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function"]
    assert sum(o == "ir_torch.ska.default" for o in ops) > 0
    loaded = D.load_program(blob)
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(x).numpy(), model(x).numpy())
    # a function exports too
    fblob = D.export_program(lambda t: t * 2 + 1, (x,))
    np.testing.assert_array_equal(D.load_program(fblob)(x).numpy(),
                                  (x * 2 + 1).numpy())


def test_export_refuses_a_ctypes_kernel():
    model = get_model("restormer", dim=16, num_blocks=(1, 1, 1, 1),
                      num_refinement_blocks=1, heads=(1, 2, 4, 8),
                      dtype=torch.bfloat16, fused_block=True)
    with pytest.raises(RuntimeError, match="block_front"):
        D.export_program(model, (torch.rand(1, 3, 32, 32),))
    plain = get_model("lsnet", use_pallas_ska=False, **SMALL).eval()
    blob = D.export_program(plain, (torch.rand(1, 3, 64, 64),))
    program = torch.export.load(__import__("io").BytesIO(blob))
    assert not any("ir_torch" in str(n.target) for n in program.graph.nodes)
