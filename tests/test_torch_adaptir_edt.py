"""The port's EDT with AdaptIR's adapters (``models/adaptir_edt.py``)
against the JAX package's, on the same weights and BatchNorm statistics.

Each JAX module gets seeded random parameters and running statistics
(``tests/family_parity.py`` ``seeded_adaptir``; the adapters'
zero-initialised ``tail`` is random too, so every adapter reaches the
output, and the phase weights are integers), the trees go into the
port through ``state_dict_from_jax`` with :func:`edt_key_map`, and both
run the same seeded numpy inputs in fp32 (JAX at "highest" matmul
precision, torch with TF32 off); the port takes NCHW maps where the JAX
modules take NHWC or (B, L, C) tokens. Width 60: half 30 over 6 heads,
the adapter's hidden 60 // 14 = 4 and its channel gate 4 // 4 = 1.

Tolerance: rtol=1e-4, atol=1e-5 for the window helpers, the attention,
the adapter and the conv blocks; the CSwin blocks, the body and the whole
model at atol=1e-5 x max|output| and rtol=1e-4. bf16: the port's bf16
output against JAX's fp32 within 3x the JAX bf16 model's error against it
(max and mean).

* The window partition, the shift mask against ``_swin_mask`` at both
  halves, WindowAttention with and without the mask, the adapter (eval
  and ``train=True``), CSwinBlock plain and shifted, SwinBody at two
  stages of two blocks, ResBlockDown (with and without the down conv),
  ResBlockUp, ConvTranspose2x, UpResBlock, ResBlockSkip.
* The whole EDT at embed 60 (36 CSwin blocks): ``sr_2`` at 48x48 (the
  bilinear residual, x2 out) and ``denoise_30`` at 96x96; bf16 at
  ``denoise_30``; ``derain``, whose JAX tree differs from ``denoise_30``'s
  in its head's and tail's names only: the JAX tree's shapes load into
  the port, and the ``denoise_30`` weights under its names give the
  ``denoise_30`` output exactly. A ragged size raises.
* A JAX ``.npz`` and a reference-layout ``.pth`` (with the ``mean`` and
  ``attn_mask`` buffers) load strictly through ``load_params``.
* ``cli/infer.py --pad_multiple 96`` against the JAX ``pad_test`` of the
  JAX model applied with its ``batch_stats`` (the JAX CLI applies the
  parameters alone and cannot serve EDT).
* The adapter's and a shifted CSwinBlock's input and parameter gradients
  against ``jax.grad`` at ``train=False`` (the phase weight's in the
  adapter's test, at an odd-sided map with a positive DC coefficient).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    ATOL, RTOL, grads_close, init_shapes, load, nchw, nhwc, seeded_adaptir,
)
from moe_parity import FAST, compiled, traced_shapes
from PIL import Image

from image_restoration_tpu.eval.tiled import pad_test
from image_restoration_tpu.models import adaptir_edt as je
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import adaptir_edt as te
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


D, HALF, HEADS = 60, 30, 6


def _variables(jmod, rng, *inputs, **static):
    return seeded_adaptir(init_shapes(jmod, *inputs, **static), rng)


def _port(tmod, v):
    return load(tmod, v["params"], te.edt_key_map,
                v.get("batch_stats")).eval()


def _map(rng, h, w, c, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _close_to_max(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_window_partition_round_trip():
    x = torch.randn(2, 24, 48, 5)
    w = te._window_partition(x, 6, 24)
    want = je._window_partition(jnp.asarray(x.numpy()), 6, 24)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want))
    assert torch.equal(te._window_reverse(w, 6, 24, 24, 48), x)


@pytest.mark.parametrize("index", [0, 1])
def test_shift_mask(index):
    hs, ws = te._win_hw(te.WINDOW, index)
    want = je._swin_mask(48, 72, hs, ws, hs // 2, ws // 2)
    got = te.shift_mask(48, 72, hs, ws, hs // 2, ws // 2, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got is te.shift_mask(48, 72, hs, ws, hs // 2, ws // 2, "cpu")


@pytest.mark.parametrize("index,shifted", [(0, False), (0, True),
                                           (1, True)])
def test_window_attention(index, shifted):
    rng = np.random.default_rng(1)
    q, k, v = (_map(rng, 48, 48, HALF) for _ in range(3))
    hs, ws = te._win_hw(te.WINDOW, index)
    mask = je._swin_mask(48, 48, hs, ws, hs // 2, ws // 2) if shifted \
        else None
    jmod = je.WindowAttention(HALF, HEADS, te.WINDOW, index)
    var = _variables(jmod, rng, q, k, v, mask)
    want = jmod.apply(var, q, k, v, mask)
    tmod = _port(te.WindowAttention(HALF, HEADS, te.WINDOW, index), var)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (q, k, v)),
                   None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want)


@pytest.mark.parametrize("train", [False, True])
def test_adapter(train):
    rng = np.random.default_rng(2)
    x = _map(rng, 12, 10, D)
    jmod, tmod = je.AdaptIRAdapter(D), te.AdaptIRAdapter(D)
    v = _variables(jmod, rng, x)
    _port(tmod, v)
    if train:
        want, new = jmod.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want, new = jmod.apply(v, x), v
    with torch.no_grad():
        got = tmod(nchw(x), train)
    _close(nhwc(got), want)
    stats = state_dict_from_jax(v["params"], tmod.state_dict(),
                                te.edt_key_map, jax.tree.map(
                                    np.array, new["batch_stats"]))
    for k in ("BN.running_mean", "BN.running_var"):
        _close(tmod.state_dict()[k].numpy(), stats[k].numpy())


@functools.lru_cache(maxsize=None)
def _cswin(shifted):
    rng = np.random.default_rng(3 + shifted)
    x = rng.standard_normal((2, 24 * 48, D)).astype(np.float32)
    jmod = je.CSwinBlock(D, HEADS, shifted=shifted)
    return jmod, _variables(jmod, rng, x, h=24, w=48), x


@pytest.mark.parametrize("shifted", [False, True])
def test_cswin_block(shifted):
    jmod, v, x = _cswin(shifted)
    want = jmod.apply(v, x, 24, 48)
    with torch.no_grad():
        got = _port(te.CSwinBlock(D, HEADS, shifted=shifted), v)(
            torch.from_numpy(x), 24, 48)
    _close_to_max(got.numpy(), want)


def test_swin_body():
    rng = np.random.default_rng(5)
    x = _map(rng, 24, 48, D, b=1)
    kw = dict(embed_dim=D, depths=(2, 2), num_heads=(HEADS, HEADS))
    jmod = je.SwinBody(**kw)
    v = _variables(jmod, rng, x)
    want = compiled(lambda var, a: jmod.apply(var, a), v, x)
    with torch.no_grad():
        got = _port(te.SwinBody(**kw), v)(nchw(x))
    _close_to_max(nhwc(got), want)


@pytest.mark.parametrize("name", ["down", "no_down", "up", "convT",
                                  "up_res", "skip"])
def test_conv_blocks(name):
    rng = np.random.default_rng(6)
    x = _map(rng, 12, 10, 8)
    skip = _map(rng, 24, 20, 16) if name == "up_res" else _map(rng, 12, 10,
                                                               16)
    jmod, tmod, args = {
        "down": (je.ResBlockDown(8, 16, down=True),
                 te.ResBlockDown(8, 16, True), (x,)),
        "no_down": (je.ResBlockDown(8, 16), te.ResBlockDown(8, 16), (x,)),
        "up": (je.ResBlockUp(16), te.ResBlockUp(8, 16), (x,)),
        "convT": (je.ConvTranspose2x(16), te.ConvTranspose2x(8, 16), (x,)),
        "up_res": (je.UpResBlock(16), te.UpResBlock(8, 16), (x, skip)),
        "skip": (je.ResBlockSkip(16), te.ResBlockSkip(8, 16, 16),
                 (x, skip)),
    }[name]
    v = _variables(jmod, rng, *args)
    want = jmod.apply(v, *args)
    with torch.no_grad():
        got = _port(tmod, v)(*(nchw(a) for a in args))
    if name == "down":
        for g, w in zip(got, want):
            _close(nhwc(g), w)
    else:
        _close(nhwc(got), want)


def test_adapter_gradients_match_jax():
    """d(sum(out * g))/d(input, every parameter) of the adapter at
    ``train=False`` on an 11x9 map: odd sides leave the DC coefficient as
    the only real one, and a BatchNorm bias of 3 makes it positive, so
    every phase, and the phase weight's gradient, is unambiguous."""
    rng = np.random.default_rng(8)
    x = _map(rng, 11, 9, D)
    jmod = je.AdaptIRAdapter(D)
    v = _variables(jmod, rng, x)
    v["params"]["BN"]["bias"] = np.full_like(v["params"]["BN"]["bias"], 3.0)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(params, a):
        out = jmod.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, a)
        return jnp.sum(out * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    tmod = _port(te.AdaptIRAdapter(D), v)
    xt = nchw(x).requires_grad_(True)
    (tmod(xt) * nchw(g)).sum().backward()
    _close_to_max(nhwc(xt.grad), jgx)
    grads_close(tmod, jgp, te.edt_key_map)


def test_gradients_match_jax():
    """d(sum(out * g))/d(input, every parameter) of a shifted CSwinBlock at
    ``train=False``. The phase weight's gradient is -phase x ..., and the
    phase of a real negative DC or Nyquist coefficient is +-pi by the sign
    of rounding noise (``seeded_adaptir``): that one gradient is checked in
    :func:`test_adapter_gradients_match_jax`, where no phase is
    ambiguous."""
    jmod, v, x = _cswin(True)
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def loss(params, a):
        out = jmod.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, a, 24, 48)
        return jnp.sum(out * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    tmod = _port(te.CSwinBlock(D, HEADS, shifted=True), v)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmod(xt, 24, 48) * torch.from_numpy(g)).sum().backward()
    _close_to_max(xt.grad.numpy(), jgx)
    grads_close(tmod, jgp, te.edt_key_map, ("adaptir.pha_fuse.weight",))


TINY = dict(embed_dim=D)  # half 30, 6 heads, 6 stages of 6 blocks
SIZE = {"sr_2": 48, "denoise_30": 96}


@functools.lru_cache(maxsize=None)
def _jax_model(de_type, bf16=False):
    """(variables, x, compiled JAX forward, its output) of EDT at ``TINY``
    for ``de_type`` at batch 1; the forward takes (variables, x). The
    bf16 model draws the same seeded weights."""
    rng = np.random.default_rng(10)
    s = SIZE[de_type]
    x = rng.random((1, s, s, 3), dtype=np.float32)
    jnet = je.EDT(de_type=de_type, **TINY,
                  dtype=jnp.bfloat16 if bf16 else None)
    v = _jax_model(de_type)[0] if bf16 else seeded_adaptir(
        traced_shapes(jnet, jnp.asarray(x)), rng)
    exe = jax.jit(lambda var, a: jnet.apply(var, a)).lower(
        v, jnp.asarray(x)).compile(FAST)
    return v, x, exe, np.asarray(exe(v, jnp.asarray(x)), np.float32)


def _port_edt(v, de_type, dtype=None):
    return _port(get_model("edt", de_type=de_type, **TINY, dtype=dtype), v)


@pytest.mark.parametrize("de_type", ["sr_2", "denoise_30"])
def test_whole_model_matches_jax(de_type):
    v, x, _, want = _jax_model(de_type)
    with torch.inference_mode():
        got = _port_edt(v, de_type)(nchw(x))
    scale = 2 if de_type == "sr_2" else 1
    s = SIZE[de_type] * scale
    assert got.dtype == torch.float32 and got.shape == (1, 3, s, s)
    _close_to_max(nhwc(got), want)


def test_bf16_within_three_times_jax_bf16():
    v, x, _, want32 = _jax_model("denoise_30")
    _, _, _, want16 = _jax_model("denoise_30", bf16=True)
    with torch.inference_mode():
        got = _port_edt(v, "denoise_30", torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err_port = np.abs(nhwc(got) - want32)
    err_jax = np.abs(want16 - want32)
    assert err_port.max() <= 3 * err_jax.max(), (err_port.max(),
                                                 err_jax.max())
    assert err_port.mean() <= 3 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())


def test_derain_is_denoise_under_other_names():
    v, x, _, want = _jax_model("denoise_30")
    shapes = traced_shapes(je.EDT(de_type="derain", **TINY),
                           jnp.zeros((1, 96, 96, 3)))
    params = {k.replace("_dn_g30", "_dr_H"): t
              for k, t in v["params"].items()}
    assert jax.tree.map(np.shape, params) == jax.tree.map(
        lambda s: s.shape, shapes["params"])
    model = load(get_model("edt", de_type="derain", **TINY), params,
                 te.edt_key_map, v["batch_stats"]).eval()
    assert any(k.startswith("head_dr_H.") for k in model.state_dict())
    with torch.inference_mode():
        got = model(nchw(x))
    np.testing.assert_array_equal(nhwc(got), nhwc(_port_edt(
        v, "denoise_30")(nchw(x)).detach()))
    _close_to_max(nhwc(got), want)


@pytest.mark.parametrize("de_type,size", [("sr_2", (48, 60)),
                                          ("denoise_30", (96, 120))])
def test_ragged_size_raises(de_type, size):
    m = 24 if de_type == "sr_2" else 96
    with pytest.raises(ValueError, match=f"multiples of {m}"):
        get_model("edt", de_type=de_type, **TINY)(torch.rand(1, 3, *size))


def _reference_pth(path, v):
    """A reference-layout checkpoint of the ``denoise_30`` weights: the
    port's keys (the reference's), the ``mean`` buffer and a block's
    ``attn_mask`` buffer, which have no JAX leaf."""
    sd = dict(_port_edt(v, "denoise_30").state_dict())
    sd["mean"] = torch.tensor(te.RGB_MEAN).view(1, 3, 1, 1)
    sd["body.layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(
        16, 144, 144)
    torch.save({"params": sd}, path)
    return sd


def test_npz_and_reference_pth_load_strictly(tmp_path):
    v, _, _, _ = _jax_model("denoise_30")
    npz = str(tmp_path / "edt.npz")
    save_params_npz(npz, v["params"])
    kw = dict(de_type="denoise_30", **TINY)
    fresh = get_model("edt", **kw)
    model = load_params({"model": "edt", "ckpt": npz},
                        get_model("edt", **kw))
    sd = model.state_dict()
    blk = v["params"]["body"]["layers_3_blocks_5"]
    np.testing.assert_array_equal(
        sd["body.layers.3.residual_group.blocks.5.mlp.dwconv.weight"]
        .numpy(), blk["mlp_dwconv"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["tail_dn_g30.0.up.weight"].numpy(),
        v["params"]["tail_dn_g30_0"]["up"]["kernel"].transpose(3, 2, 0, 1))
    key = "body.layers.0.residual_group.blocks.0.adaptir.BN.running_mean"
    assert torch.equal(sd[key], fresh.state_dict()[key])  # params only

    pth = str(tmp_path / "edt.pth")
    src = _reference_pth(pth, v)
    model = load_params({"model": "edt_adaptir", "ckpt": pth},
                        get_model("edt", **kw))
    for k, t in model.state_dict().items():
        assert torch.equal(t, src[k]), k


def test_infer_pad_multiple_96_matches_jax(tmp_path):
    """A 90x70 image reflect-padded to 96x96 through the port's
    ``make_restore_fn`` from the ``cli/infer.py`` options, against the
    JAX ``pad_test`` of the JAX model with its ``batch_stats``; then
    ``main`` writes it."""
    v, _, exe, _ = _jax_model("denoise_30")
    img = np.random.default_rng(20).random((90, 70, 3), dtype=np.float32)
    want = pad_test(lambda a: jnp.clip(exe(v, a), 0.0, 1.0),
                    jnp.asarray(img)[None], 96)[0]
    pth = str(tmp_path / "edt.pth")
    _reference_pth(pth, v)
    argv = ["--model", "edt", "--fp32", "--device", "cpu", "--pad_multiple",
            "96", "--set", "model_kwargs.de_type=denoise_30", "--set",
            f"model_kwargs.embed_dim={D}", "--ckpt", pth]
    cfg = parse_options(argv)
    got = infer.make_restore_fn(cfg, load_params(cfg, build_model(cfg)))(img)
    assert got.shape == img.shape
    _close(got, want)
    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray((img * 255).astype(np.uint8)).save(str(src / "a.png"))
    outs = infer.main(argv + ["--input", str(src), "--output_dir",
                              str(tmp_path / "out")])
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(90, 70, 3)]
