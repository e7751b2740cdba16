"""The port's training building blocks against the JAX package's, on seeded
numpy inputs, in fp32 (JAX at "highest" matmul precision):

* every loss of ``train/losses.py`` ``LOSSES`` (14 names) and the extra
  ones (pyramid, GAN, contrastive, SupCon, block-normalised HOG), NCHW
  against NHWC: values at rtol 1e-4, atol 1e-5, and d loss / d pred at
  rtol 1e-4, atol 1e-4 x max |gradient| (the gradients are O(1 / pixels),
  and the edge loss's passes back through two 5x5 blurs, sums of up to
  625 fp32 terms that XLA and torch add in other orders);
* every schedule of ``SCHEDULES`` at a list of steps, at rtol 1e-5 and atol
  1e-10 (JAX computes in float32, the port in float64; 1e-10 is 5e-7 of
  the base rate);
* ``default_recipe`` and ``nerd_rain_recipe`` (``darkir`` and
  ``transweather`` are held in tests/test_torch_family_recipes.py; the
  recipes of models the port does not have raise);
* ``make_optimizer`` against optax on the same parameters and gradients
  over four steps: adamw, adamw_hf, adam and sgd; clipping with a NaN in
  one gradient; the plateau scale through ``set_lr_scale``; freezing (no
  decay on a frozen subtree); ``MultiSteps`` k=2 with the EMA tick, through
  both packages' train steps on a one-conv model;
* ``AIOTrainDataset`` items for one seed, equal;
* ``degrade_batch`` and ``mixup_device`` on the draws JAX makes from a key,
  passed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from image_restoration_tpu.data import datasets as JD
from image_restoration_tpu.data import degradations as JG
from image_restoration_tpu.train import losses as JL
from image_restoration_tpu.train import recipes as JR
from image_restoration_tpu.train import schedulers as JS
from image_restoration_tpu.train import trainer as JT
from image_restoration_tpu_torch.data import datasets as TD
from image_restoration_tpu_torch.data import degradations as TG
from image_restoration_tpu_torch.train import losses as TL
from image_restoration_tpu_torch.train import recipes as TR
from image_restoration_tpu_torch.train import schedulers as TS
from image_restoration_tpu_torch.train import trainer as TT

RTOL, ATOL = 1e-4, 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _pair(seed, shape=(2, 32, 24, 3)):
    """A prediction near a target; no two values are equal, so no |x| sits
    at its kink (see test_abs_kink_takes_torchs_subgradient)."""
    rng = np.random.default_rng(seed)
    gt = rng.random(shape).astype(np.float32)
    pred = (gt + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return pred, gt


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(TL.LOSSES))
def test_loss_matches_jax(name):
    assert len(TL.LOSSES) == 14 and set(TL.LOSSES) == set(JL.LOSSES)
    pred, gt = _pair(len(name))
    with jax.default_matmul_precision("highest"):
        want, jgrad = jax.value_and_grad(JL.LOSSES[name])(jnp.asarray(pred),
                                                          jnp.asarray(gt))
    p = _nchw(pred).requires_grad_()
    got = TL.LOSSES[name](p, _nchw(gt))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    (g,) = torch.autograd.grad(got, p)
    _grad_close(_nhwc(g), jgrad)


def test_abs_kink_takes_torchs_subgradient():
    """Where a difference is exactly 0 (here neighbouring pixels clipped to
    the same value), d|x|/dx is torch's 0 in the port and 1 in JAX, so the
    gradients of the |.| losses differ there and only there (ROADMAP watch
    list): the port's equals JAX's with |x| given slope 0 at 0, and the
    loss values agree."""
    pred = np.zeros((1, 4, 4, 3), np.float32)
    pred[:, 2:] = 0.5

    def smooth(x, absf):
        gy = x[:, 1:, :, :] - x[:, :-1, :, :]
        gx = x[:, :, 1:, :] - x[:, :, :-1, :]
        return jnp.mean(absf(gy)) + jnp.mean(absf(gx))

    def abs0(x):
        return jnp.where(x == 0, 0.0, jnp.abs(x))

    want, jgrad = jax.value_and_grad(JL.gradient_smoothness_loss)(
        jnp.asarray(pred))
    kinked = jax.grad(lambda x: smooth(x, abs0))(jnp.asarray(pred))
    p = _nchw(pred).requires_grad_()
    got = TL.gradient_smoothness_loss(p)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    (g,) = torch.autograd.grad(got, p)
    _grad_close(_nhwc(g), kinked)
    assert np.abs(_nhwc(g) - np.asarray(jgrad)).max() > 1e-3


@pytest.mark.parametrize("case", ["pyramid", "gan", "gan_bce", "pearson",
                                  "contrastive", "supcon", "hog_blocks",
                                  "edge_l1", "weighted"])
def test_extra_losses_match_jax(case):
    pred, gt = _pair(7, (2, 32, 32, 3))
    jp, jt, tp, tt = jnp.asarray(pred), jnp.asarray(gt), _nchw(pred), _nchw(gt)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((6, 8)).astype(np.float32)
    labels = np.array([0, 1, 0, 2, 1, 0], np.int32)
    with jax.default_matmul_precision("highest"):
        if case == "pyramid":
            for w, g in zip(JL.build_pyramid(jp, 3), TL.build_pyramid(tp, 3)):
                np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=RTOL,
                                           atol=ATOL)
            return
        pairs = {
            "gan": (JL.gan_loss(jp, True), TL.gan_loss(tp, True)),
            "gan_bce": (JL.gan_loss(jp, False, use_lsgan=False),
                        TL.gan_loss(tp, False, use_lsgan=False)),
            "pearson": (JL.pearson_loss(jp, jt), TL.pearson_loss(tp, tt)),
            "contrastive": (JL.contrastive_style_loss(jnp.asarray(emb),
                                                      jnp.asarray(labels)),
                            TL.contrastive_style_loss(torch.from_numpy(emb),
                                                      torch.from_numpy(labels))),
            "supcon": (JL.supcon_loss(jnp.asarray(emb), jnp.asarray(labels)),
                       TL.supcon_loss(torch.from_numpy(emb),
                                      torch.from_numpy(labels))),
            "hog_blocks": (JL.hog_loss(jp, jt, block_size=2, cell_size=4),
                           TL.hog_loss(tp, tt, block_size=2, cell_size=4)),
            "edge_l1": (JL.edge_loss(jp, jt, "l1"), TL.edge_loss(tp, tt, "l1")),
        }
        if case == "weighted":
            terms = {"l1": 1.0, "fft": 0.1, "ssim": 0.5}
            (wt, wl), (gt_, gl) = (JL.weighted_loss(terms)(jp, jt),
                                   TL.weighted_loss(terms)(tp, tt))
            assert set(wl) == set(gl) == set(terms)
            pairs = {"weighted": (wt, gt_)}
        want, got = pairs[case]
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


STEPS = [0, 1, 5, 9, 10, 11, 39, 40, 41, 50, 75, 99, 100, 150, 399]
SCHEDULE_ARGS = {
    "linear_warmup_cosine": dict(base_lr=2e-4, warmup_steps=10, max_steps=100,
                                 warmup_start_lr=1e-5, eta_min=1e-6),
    "cosine": dict(base_lr=2e-4, t_max=100, eta_min=1e-6),
    "cosine_restart": dict(base_lr=2e-4, periods=[40, 60],
                           restart_weights=(1.0, 0.5), eta_min=1e-6),
    "cosine_restart_cyclic": dict(base_lr=2e-4, periods=[40, 60],
                                  restart_weights=(1.0, 0.5),
                                  eta_mins=(1e-5, 1e-6)),
    "multistep": dict(base_lr=2e-4, milestones=[30, 60], gamma=0.5),
    "multistep_restart": dict(base_lr=2e-4, milestones=[30, 60, 90],
                              gamma=0.5, restarts=(0, 50),
                              restart_weights=(1.0, 0.5)),
    "linear": dict(base_lr=2e-4, total_steps=400),
    "vibrate": dict(base_lr=2e-4, total_steps=400),
    "gradual_warmup": dict(base_lr=2e-4, multiplier=2.0, warmup_steps=10),
    "constant": dict(base_lr=2e-4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_ARGS))
def test_schedule_matches_jax(name):
    assert set(TS.SCHEDULES) == set(JS.SCHEDULES) == set(SCHEDULE_ARGS)
    cases = [({}, {})]
    if name == "gradual_warmup":  # with and without the hand-off
        cases.append(({"after": JS.cosine_annealing(4e-4, 50)},
                      {"after": TS.cosine_annealing(4e-4, 50)}))
    for jextra, textra in cases:
        js = JS.SCHEDULES[name](**SCHEDULE_ARGS[name], **jextra)
        ts = TS.SCHEDULES[name](**SCHEDULE_ARGS[name], **textra)
        got = [ts(s) for s in STEPS]
        assert all(isinstance(v, float) for v in got)
        np.testing.assert_allclose(got, [float(js(s)) for s in STEPS],
                                   rtol=1e-5, atol=1e-10)
    assert TS.cosine_loss_weight(30, 100, 0.1) == pytest.approx(
        JS.cosine_loss_weight(30, 100, 0.1), rel=1e-12)


def test_recipes_match_jax():
    pred, gt = _pair(11, (2, 32, 32, 3))
    terms = {"l1": 1.0, "charbonnier": 0.5}
    jw, jl = JR.default_recipe(terms, 0.01)(jnp.asarray(pred),
                                            {"aux_loss": jnp.float32(0.3)},
                                            {"gt": jnp.asarray(gt)})
    tw, tl = TR.default_recipe(terms, 0.01)(_nchw(pred),
                                            {"aux_loss": torch.tensor(0.3)},
                                            {"gt": _nchw(gt)})
    assert set(jl) == set(tl) == {"l1", "charbonnier", "aux"}
    np.testing.assert_allclose(float(tw), float(jw), rtol=RTOL, atol=ATOL)

    # NeRD-Rain's 7 outputs: 3 scales, then INR outputs at index 3 and 5
    rng = np.random.default_rng(12)
    sizes = [32, 16, 8, 16, 16, 8, 8]
    outs = [rng.random((2, s, s, 3)).astype(np.float32) for s in sizes]
    with jax.default_matmul_precision("highest"):
        jw, jl = JR.nerd_rain_recipe()(tuple(map(jnp.asarray, outs)), {},
                                       {"gt": jnp.asarray(gt)})
    tw, tl = TR.nerd_rain_recipe()(tuple(map(_nchw, outs)), {},
                                   {"gt": _nchw(gt)})
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(float(tw), float(jw), rtol=RTOL, atol=ATOL)
    # HOGformer's and MWFormer's style recipe (their train steps:
    # tests/test_torch_hogformer.py, test_torch_mwformer.py)
    emb = rng.standard_normal((6, 64)).astype(np.float32)
    de_id = np.array([0, 1, 0, 2, 1, 0], np.int32)
    for name, out, batch in (
            ("hogformer", outs[0], {"gt": gt}),
            ("mwformer_style", emb, {"de_id": de_id})):
        with jax.default_matmul_precision("highest"):
            jw, jl = JR.make_recipe(name)(jnp.asarray(out), {}, {
                k: jnp.asarray(v) for k, v in batch.items()})
        to = _nchw if out.ndim == 4 else torch.from_numpy
        tw, tl = TR.make_recipe(name)(to(out), {}, {
            k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v))
            for k, v in batch.items()})
        assert set(jl) == set(tl)
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(float(tw), float(jw), rtol=RTOL, atol=ATOL)
    for name in ("darkir", "transweather"):  # tests/test_torch_family_recipes.py
        assert callable(TR.make_recipe(name))


# ------------------------------------------------------------- optimizer ---

# a JAX tree and the port's flat names of the same leaves
TREE = {"a": {"w": (5, 3)}, "encoder_level1_0": {"k": (4,)},
        "style_filter": {"w": (3, 2)}}
NAMES = {"a.w": ("a", "w"), "encoder_level1.0.k": ("encoder_level1_0", "k"),
         "style_filter.w": ("style_filter", "w")}


def _tree(rng):
    return {top: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in leaves.items()} for top, leaves in TREE.items()}


def _flat(tree):
    return {n: torch.from_numpy(tree[t][k].copy()) for n, (t, k) in NAMES.items()}


OPT_CASES = {
    "adamw": dict(optimizer="adamw", weight_decay=0.05),
    "adamw_hf": dict(optimizer="adamw_hf", weight_decay=0.05),
    "adam": dict(optimizer="adam"),
    "sgd": dict(optimizer="sgd"),
    "clip_nan": dict(optimizer="adamw", grad_clip=0.5, weight_decay=0.01),
    "plateau": dict(optimizer="adamw", plateau=True),
    "freeze": dict(optimizer="adamw", weight_decay=0.1,
                   freeze_prefixes=("style",)),
    "multisteps": dict(optimizer="adam", accumulate_grad_batches=2),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = OPT_CASES[case]
    rng = np.random.default_rng(len(case))
    params = _tree(rng)
    jcfg = JT.TrainerConfig(learning_rate=JS.linear_warmup_cosine(1e-2, 2, 8),
                            **kw)
    tcfg = TT.TrainerConfig(learning_rate=TS.linear_warmup_cosine(1e-2, 2, 8),
                            **kw)
    jtx, ttx = JT.make_optimizer(jcfg), TT.make_optimizer(tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = _flat(params)
    tstate = ttx.init(tp)
    for step in range(4):
        grads = _tree(rng)
        if case == "clip_nan" and step == 1:
            grads["a"]["w"][2, 1] = np.nan
        if case == "plateau" and step == 2:
            jstate = JT.set_lr_scale(jstate, 0.25)
            TT.set_lr_scale(tstate, 0.25)
        jupd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = ttx.update(_flat(grads), tstate, tp)
        if case == "multisteps" and step % 2 == 0:
            assert tupd is None  # a micro-step: optax's updates are zero
            assert all(not np.any(np.asarray(u)) for u in jax.tree.leaves(jupd))
        else:
            for n, (t, k) in NAMES.items():
                np.testing.assert_allclose(tupd[n].numpy(),
                                           np.asarray(jupd[t][k]),
                                           rtol=RTOL, atol=1e-7)
                tp[n] = tp[n] + tupd[n]
        for n, (t, k) in NAMES.items():
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[t][k]),
                                       rtol=RTOL, atol=ATOL)
    if case == "freeze":
        for k, v in params["style_filter"].items():
            np.testing.assert_array_equal(tp[f"style_filter.{k}"].numpy(), v)
    if case == "plateau":
        with pytest.raises(ValueError):
            TT.set_lr_scale(TT.make_optimizer(TT.TrainerConfig()).init(tp), 0.5)


class _JaxConv(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(3, (3, 3), padding=1, name="conv")(x)


class _TorchConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)

    def forward(self, x):
        return self.conv(x)


def test_multisteps_ema_ticks_per_optimizer_step():
    """Both train steps, k=2 accumulation and EMA 0.9 on a one-conv model:
    the loss, the parameters and the EMA after each of four micro-steps."""
    rng = np.random.default_rng(9)
    jm = _JaxConv()
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.3, jnp.float32),
        params)
    tm = _TorchConv()
    with torch.no_grad():
        tm.conv.weight.copy_(torch.from_numpy(
            np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        tm.conv.bias.copy_(torch.from_numpy(np.array(params["conv"]["bias"])))
    kw = dict(ema_decay=0.9, accumulate_grad_batches=2, optimizer="adamw",
              weight_decay=0.01)
    jcfg = JT.TrainerConfig(learning_rate=1e-2, **kw)
    tcfg = TT.TrainerConfig(learning_rate=1e-2, **kw)
    jtx, ttx = JT.make_optimizer(jcfg), TT.make_optimizer(tcfg)
    jstate = JT.TrainState.create(params, jtx, ema_decay=0.9)
    jstep = JT.make_train_step(jm, jtx, jcfg, donate=False)
    tstate = TT.TrainState.create(tm, ttx, ema_decay=0.9)
    tstep = TT.make_train_step(tm, ttx, tcfg)
    ema0 = tstate.ema_params["conv.weight"].clone()
    with jax.default_matmul_precision("highest"):
        for i in range(4):
            lq = rng.random((2, 8, 8, 3)).astype(np.float32)
            gt = rng.random((2, 8, 8, 3)).astype(np.float32)
            jstate, jlogs = jstep(jstate, {"lq": jnp.asarray(lq),
                                           "gt": jnp.asarray(gt)}, None)
            tstate, tlogs = tstep(tstate, {"lq": _nchw(lq), "gt": _nchw(gt)})
            assert tlogs["total"].dim() == 0 and tstate.step == i + 1
            np.testing.assert_allclose(float(tlogs["total"]),
                                       float(jlogs["total"]), rtol=RTOL,
                                       atol=ATOL)
            for name, tree in (("params", jstate.params),
                               ("ema", jstate.ema_params)):
                src = dict(tm.named_parameters()) if name == "params" \
                    else tstate.ema_params
                np.testing.assert_allclose(
                    src["conv.weight"].detach().numpy(),
                    np.asarray(tree["conv"]["kernel"]).transpose(3, 2, 0, 1),
                    rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(src["conv.bias"].detach().numpy(),
                                           np.asarray(tree["conv"]["bias"]),
                                           rtol=RTOL, atol=ATOL)
            if i == 0:  # a micro-step: neither the params nor the EMA move
                assert torch.equal(tstate.ema_params["conv.weight"], ema0)


# ---------------------------------------------------------------- data ---

def _write_aio_tree(root, rng):
    def save(rel, arr):
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr.astype(np.uint8)).save(p)

    for i in range(3):
        clean = (rng.random((40, 36, 3)) * 255).astype(np.uint8)
        save(f"denoising/{i}.png", clean)
        save(f"deraining/RainTrainL/gt/norain-{i}.png", clean)
        save(f"deraining/RainTrainL/rainy/norain-{i}.png",
             np.clip(clean + rng.integers(0, 40, clean.shape), 0, 255))
        save(f"dehazing/RESIDE/clear/{i}.png", clean)
        save(f"dehazing/RESIDE/part1/{i}_0.8_0.1.png", clean * 0.7 + 50)


def test_aio_dataset_items_equal_jax(tmp_path):
    _write_aio_tree(tmp_path, np.random.default_rng(0))
    de = ["denoise_15", "denoise_25", "denoise_50", "derain", "dehaze"]
    jd = JD.AIOTrainDataset(str(tmp_path), de, patch_size=16, seed=5)
    td = TD.AIOTrainDataset(str(tmp_path), de, patch_size=16, seed=5)
    assert len(td) == len(jd) == 3 * 3 * 3 + 3 * 120 + 3
    assert TD.TASK_SPECS.keys() == JD.TASK_SPECS.keys()
    assert TD.ADAIR_NAME_LISTS.keys() == JD.ADAIR_NAME_LISTS.keys()
    for i in [0, 5, 9, 17, 30, 200, 389, 388, 9, 0]:
        j, t = jd[i], td[i]
        assert j.keys() == t.keys() and j["name"] == t["name"]
        for k in ("lq", "gt", "de_id", "sigma"):
            np.testing.assert_array_equal(t[k], j[k])
    p = "/d/deraining/rainy/rain-12.png"
    assert TD.adair_rain_gt(p) == JD.adair_rain_gt(p)
    p = "/d/dehazing/synthetic/part2/0001_0.8_0.2.jpg"
    assert TD.adair_haze_gt(p) == JD.adair_haze_gt(p)


def test_degrade_batch_matches_jax_on_its_draws():
    rng = np.random.default_rng(4)
    gt = rng.random((3, 16, 12, 3)).astype(np.float32)
    lq = rng.random((3, 16, 12, 3)).astype(np.float32)
    sigma = np.array([25.0, 0.0, 50.0], np.float32)
    key = jax.random.PRNGKey(7)
    want = JG.degrade_batch(key, {"gt": jnp.asarray(gt), "lq": jnp.asarray(lq),
                                  "sigma": jnp.asarray(sigma)})
    noise = jax.random.normal(key, gt.shape, jnp.float32)  # JAX's own draw
    got = TG.degrade_batch({"gt": _nchw(gt), "lq": _nchw(lq),
                            "sigma": torch.from_numpy(sigma)},
                           noise=_nchw(noise))
    np.testing.assert_allclose(_nhwc(got["lq"]), np.asarray(want["lq"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_nhwc(got["lq"])[1], lq[1])
    assert torch.equal(got["gt"], _nchw(gt))
    # drawn from a generator seeded by (seed, step): the same at a step
    # whatever ran before it, another at the next step
    a = TG.degrade_batch({"gt": _nchw(gt), "lq": _nchw(lq),
                          "sigma": torch.from_numpy(sigma)},
                         TG.step_generator(0, 3, "cpu"))["lq"]
    TG.step_generator(0, 2, "cpu")
    b = TG.degrade_batch({"gt": _nchw(gt), "lq": _nchw(lq),
                          "sigma": torch.from_numpy(sigma)},
                         TG.step_generator(0, 3, "cpu"))["lq"]
    c = TG.degrade_batch({"gt": _nchw(gt), "lq": _nchw(lq),
                          "sigma": torch.from_numpy(sigma)},
                         TG.step_generator(0, 4, "cpu"))["lq"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise_std = float(((a - _nchw(gt))[0]).std()) * 255
    assert 15 < noise_std < 35


@pytest.mark.parametrize("use_identity", [False, True])
def test_mixup_matches_jax_on_its_draws(use_identity):
    rng = np.random.default_rng(8)
    lq = rng.random((4, 8, 8, 3)).astype(np.float32)
    gt = rng.random((4, 8, 8, 3)).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jlq, jgt = JG.mixup_device(key, jnp.asarray(lq), jnp.asarray(gt), 1.2,
                                   use_identity)
        k_lam, k_perm, k_id = jax.random.split(key, 3)
        lam = float(jax.random.beta(k_lam, 1.2, 1.2, dtype=jnp.float32))
        perm = torch.from_numpy(np.asarray(jax.random.permutation(k_perm, 4)))
        mixes = bool(jax.random.bernoulli(k_id, 0.5))
        tlq, tgt = TG.mixup_device(_nchw(lq), _nchw(gt), 1.2, use_identity,
                                   lam=lam, perm=perm, identity=not mixes)
        np.testing.assert_allclose(_nhwc(tlq), np.asarray(jlq), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(_nhwc(tgt), np.asarray(jgt), rtol=RTOL,
                                   atol=ATOL)
    drawn = TG.mixup_device(_nchw(lq), _nchw(gt), 1.2, False,
                            TG.step_generator(1, 2, "cpu", 2))
    again = TG.mixup_device(_nchw(lq), _nchw(gt), 1.2, False,
                            TG.step_generator(1, 2, "cpu", 2))
    assert all(torch.equal(a, b) for a, b in zip(drawn, again))
