"""The port's classification training engine (``train/classification.py``)
and FGSM/PGD attack (``eval/robustness.py`` ``fgsm_pgd_attack``) against
the JAX package's, on the CPU in fp32.

* ``cross_entropy`` with hard labels (no smoothing and 0.1) and soft
  labels, and ``accuracy`` with tied logits (JAX's descending argsort puts
  the higher index first): rtol 1e-6 and exact.
* ``mixup_cutmix``: the same ``np.random.Generator`` seed gives the same
  bits, over seeds that take the cutmix, the mixup and the no-mix branch.
* ``make_cls_train_step``: one SGD step with EMA of a tiny LSNet (the
  SKA kernel's wrapper, so the backward goes through ``_SKA`` and
  ``ska_bwd_plain``) from the same weights as the JAX step; the loss, and
  the parameters and EMA after the step at rtol 1e-4, atol 1e-5 x the
  largest |value| of the tensor (the gradient is a sum over the batch's
  pixels, in another order).
* ``fgsm_pgd_attack``: FGSM, and PGD from JAX's own random start (its
  ``PRNGKey(0)`` uniform draw, handed to the port as ``init_noise``), on
  the tiny LSNet: every iterate moves by the step along the gradient's
  sign, so the attacked images must agree where the sign is not in doubt,
  |g| > 1e-6 (d|x|/dx at 0 differs between the packages, ROADMAP watch
  list), to 1e-5; everywhere they lie in the eps-ball and the normalized
  image of [0, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from family_parity import init_shapes, load, randomized
from test_torch_robust import TINY as ROBUST_TINY

from image_restoration_tpu.eval import robustness as JR
from image_restoration_tpu.models import lsnet as JL
from image_restoration_tpu.train import classification as JC
from image_restoration_tpu.train import trainer as JT
from image_restoration_tpu_torch.eval import robustness as TR
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models.lsnet import lsnet_key_map
from image_restoration_tpu_torch.train import classification as TC
from image_restoration_tpu_torch.train import trainer as TT
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

RTOL, ATOL = 1e-4, 1e-5
# tests/test_torch_robust.py's LSNet with one block in each of stages 2-4:
# stage 1's second block is an LSConv, so SKA runs once a forward
TINY = dict(ROBUST_TINY, depth=(2, 1, 1, 1))


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    hard = rng.integers(0, 10, 6)
    soft = rng.random((6, 10)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    for labels in (hard, soft):
        want = JC.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                smoothing)
        got = TC.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), smoothing)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_accuracy_matches_jax_with_ties():
    rng = np.random.default_rng(1)
    logits = rng.integers(0, 4, (32, 7)).astype(np.float32)  # many ties
    labels = rng.integers(0, 7, 32)
    for topk in ((1, 5), (1, 2, 3)):
        want = JC.accuracy(jnp.asarray(logits), jnp.asarray(labels), topk)
        got = TC.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                          topk)
        assert got == want


def test_mixup_cutmix_is_bit_equal_from_one_seed():
    images = np.random.default_rng(2).random((6, 12, 10, 3)).astype(
        np.float32)
    labels = np.array([0, 3, 1, 4, 2, 3])
    seen = set()
    for seed in range(8):
        for prob in (1.0, 0.5):
            kw = dict(num_classes=5, prob=prob)
            ji, jl = JC.mixup_cutmix(np.random.default_rng(seed), images,
                                     labels, **kw)
            ti, tl = TC.mixup_cutmix(np.random.default_rng(seed), images,
                                     labels, **kw)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)
            seen.add("none" if ti is images else
                     "cutmix" if np.any(ti == images) else "mixup")
    assert seen == {"none", "cutmix", "mixup"}


@pytest.fixture
def lsnet_pair():
    """The tiny LSNet in both packages, the same seeded weights and
    BatchNorm statistics (fp32; from the variables' shapes, which trace in
    a fraction of the time an init takes)."""
    jnet = JL.LSNet(**TINY)
    shapes = init_shapes(jnet, jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(0)
    params = randomized(shapes["params"], rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (1.0 + 0.2 * np.abs(z) if path[-1].key == "running_var"
                         else 0.2 * z).astype(np.float32)
        if (z := rng.standard_normal(v.shape)) is not None else None,
        shapes["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    tnet = load(get_model("lsnet", **TINY, use_pallas_ska=True).eval(),
                params, lsnet_key_map, stats)
    return jnet, variables, tnet


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    x = ((rng.random((n, 32, 32, 3)) - TR.IMAGENET_MEAN) / TR.IMAGENET_STD)
    return x.astype(np.float32), rng.integers(0, TINY["num_classes"], n)


def _assert_tree(got_sd, jparams, like):
    want = state_dict_from_jax(jparams, like, lsnet_key_map)
    for k, w in want.items():
        if k not in dict(got_sd):
            continue
        g = got_sd[k].detach()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL * float(w.abs().max()),
                                   err_msg=k)


def test_cls_train_step_matches_jax(lsnet_pair):
    jnet, variables, tnet = lsnet_pair
    stats = variables["batch_stats"]

    class Apply:
        """JAX's step applies {"params": ...}; LSNet also reads its
        BatchNorm statistics."""

        @staticmethod
        def apply(v, x):
            return jnet.apply({"params": v["params"], "batch_stats": stats},
                              x)

    # SGD with momentum: the update is the gradient times the rate, so the
    # parameters carry the gradient's agreement (Adam's first update,
    # g / (|g| + eps), would amplify fp32 noise where |g| is tiny)
    jtx = optax.sgd(0.1, momentum=0.9)
    jstate = JT.TrainState.create(variables["params"], jtx, ema_decay=0.9)
    jstep = JC.make_cls_train_step(Apply, jtx, smoothing=0.1, ema_decay=0.9)
    x, y = _batch(3)
    jstate, jlogs = jstep(jstate, {"image": jnp.asarray(x),
                                   "label": jnp.asarray(y)})

    tx = TT.Optimizer(TT.TrainerConfig(learning_rate=0.1, optimizer="sgd"))
    like = tnet.state_dict()
    tstate = TT.TrainState.create(tnet, tx, ema_decay=0.9)
    tstep = TC.make_cls_train_step(tnet, tx, smoothing=0.1, ema_decay=0.9)
    image = torch.from_numpy(x).permute(0, 3, 1, 2)
    tstate, tlogs = tstep(tstate, {"image": image,
                                   "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tlogs["loss"]), float(jlogs["loss"]),
                               rtol=RTOL)
    assert tstate.step == 1
    _assert_tree(dict(tnet.named_parameters()), jstate.params, like)
    _assert_tree(tstate.ema_params, jstate.ema_params, like)


@pytest.mark.parametrize("adv", ["FGSM", "PGD"])
def test_fgsm_pgd_attack_matches_jax(lsnet_pair, adv):
    jnet, variables, tnet = lsnet_pair
    x, y = _batch(4)
    eps = 1.0 / 255.0
    kw = dict(epsilon=eps, alpha=(0.5 if adv == "PGD" else 1.0) / 255.0,
              max_iters=5 if adv == "PGD" else 1, random_init=adv == "PGD")

    want = np.asarray(JR.fgsm_pgd_attack(jnet.apply, variables,
                                         jnp.asarray(x), jnp.asarray(y),
                                         **kw))
    noise = None
    if adv == "PGD":
        noise = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(0), x.shape, jnp.float32, -1.0, 1.0))
    got = TR.fgsm_pgd_attack(tnet, torch.from_numpy(x), torch.from_numpy(y),
                             init_noise=noise, **kw).numpy()

    # the sign is in doubt where the gradient at an iterate is tiny: replay
    # the port's iterations to find those places
    std, mean = TR.IMAGENET_STD, TR.IMAGENET_MEAN
    lo, hi = (0 - mean) / std, (1 - mean) / std
    ball, step = eps / std, kw["alpha"] / std
    z = np.clip(x if noise is None else x + noise * ball, lo, hi)
    sure = np.ones(x.shape, bool)
    for _ in range(kw["max_iters"]):
        zt = torch.from_numpy(z.astype(np.float32)).requires_grad_()
        logp = torch.log_softmax(tnet(zt.permute(0, 3, 1, 2)), dim=-1)
        loss = -logp.gather(1, torch.from_numpy(y)[:, None]).mean()
        g = torch.autograd.grad(loss, zt)[0].numpy()
        sure &= np.abs(g) > 1e-6
        z = np.clip(np.clip(z + step * np.sign(g), x - ball, x + ball), lo, hi)
    np.testing.assert_allclose(got, z, rtol=0, atol=1e-6)
    assert sure.mean() > 0.9
    np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-5)
    assert np.all(np.abs(got - x) <= ball + 1e-6)
    assert np.all((got >= lo - 1e-6) & (got <= hi + 1e-6))
