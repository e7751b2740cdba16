"""The port's IPT with AdaptIR's adapters (``models/adaptir_ipt.py``)
against the JAX package's, on the same weights and BatchNorm statistics.

Each JAX module gets seeded random parameters and running statistics
(``tests/family_parity.py`` ``seeded_adaptir``; the adapter's
zero-initialised ``tail`` is random too, so the adapter reaches the
output, and the phase weights are integers), the trees go into the
port through ``state_dict_from_jax``, and both run the same seeded numpy
inputs in fp32 (JAX at "highest" matmul precision, torch with TF32 off);
the port takes NCHW maps where the JAX modules take NHWC or (B, L, C)
tokens. Widths are narrow: the adapter's hidden width is d_model // 24
and its channel gate reduces that by 8, so d_model 216 (hidden 9, gate 1)
is the narrowest that keeps every branch.

Tolerance: rtol=1e-4, atol=1e-5 for ResBlock, the adapter and the
attention; the layers, the VisionTransformer and the whole model at
atol=1e-5 x max|output| and rtol=1e-4 (IPT computes on x255 values, and
a softmax over random projections turns fp32 rounding of its logits into
errors of ~1e-5 of a layer's largest output).
bf16: the port's bf16 output against JAX's fp32 within 3x the JAX bf16
model's error against it (max and mean).

* ResBlock, the adapter (eval and ``train=True``, the running statistics
  updated as JAX's ``mutable=["batch_stats"]`` updates them),
  MultiheadAttention (self and cross), EncoderLayer, DecoderLayer, the
  VisionTransformer at 2 + 2 layers.
* The whole IPT at n_feats 24 (embed 216, 12 heads, 12 + 12 layers) at
  48x48 for tasks 0 (x2) and 5 (x1); bf16 at task 5; the size error. The
  head's first conv is seeded at 1/255 of the fan-in scale, as the input
  is x255: at the fan-in scale the encoder's output (the decoder's
  unnormalised cross-attention memory) is ~700, those softmaxes saturate,
  and both packages' fp32 outputs lie ~5e-5 x max|output| from the port
  run in float64.
* A JAX ``.npz`` and a reference-layout ``.pth`` (with the MeanShift
  convs, ``position_ids`` and another task's head and tail) load
  strictly through ``cli/test.py`` ``load_params``.
* ``cli/infer.py --tile 48`` against the JAX ``windowed_apply`` of the
  JAX model applied with its ``batch_stats`` (the JAX CLI applies the
  parameters alone and cannot serve IPT).
* The adapter's and the VisionTransformer's (1 + 1 layers) input and
  parameter gradients against ``jax.grad`` at ``train=False`` (the phase
  weights' in the adapter's test, on an odd-sided grid with a positive DC
  coefficient).
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

from image_restoration_tpu.eval.tiled import windowed_apply
from image_restoration_tpu.models import adaptir_ipt as ji
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.cli.train import build_model
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import adaptir_ipt as ti
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax
from image_restoration_tpu_torch.utils.options import parse_options


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


D, HEADS, HIDDEN = 216, 12, 96  # the narrowest width with every branch


def _variables(jmod, rng, *inputs, **static):
    return seeded_adaptir(init_shapes(jmod, *inputs, **static), rng)


def _port(tmod, v):
    return load(tmod, v["params"], ti.ipt_key_map,
                v.get("batch_stats")).eval()


def _tokens(rng, b, n, c=D):
    return rng.standard_normal((b, n, c)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_res_block():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 10, 8)).astype(np.float32)
    v = _variables(ji.ResBlock(8), rng, x)
    want = ji.ResBlock(8).apply(v, x)
    with torch.no_grad():
        got = _port(ti.ResBlock(8), v)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), RTOL, ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_adapter(train):
    """(B, L, C) tokens of an 8x8 grid in JAX, the NCHW map in the port;
    with ``train`` the batch's statistics and the running ones' update."""
    rng = np.random.default_rng(1)
    x = _tokens(rng, 2, 64)
    jmod, tmod = ji.AdaptIRAdapter(D), ti.AdaptIRAdapter(D)
    v = _variables(jmod, rng, x)
    _port(tmod, v)
    if train:
        want, new = jmod.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want, new = jmod.apply(v, x), v
    with torch.no_grad():
        got = tmod(ti._tokens_to_map(torch.from_numpy(x), 8, 8), train)
    _close(ti._map_to_tokens(got), want)
    stats = state_dict_from_jax(v["params"], tmod.state_dict(),
                                ti.ipt_key_map, jax.tree.map(
                                    np.array, new["batch_stats"]))
    for k in ("BN.running_mean", "BN.running_var"):
        _close(tmod.state_dict()[k], stats[k].numpy())


@pytest.mark.parametrize("lk", [16, 20], ids=["self", "cross"])
def test_multihead_attention(lk):
    rng = np.random.default_rng(2)
    q, k, v = _tokens(rng, 2, 16, 24), _tokens(rng, 2, lk, 24), _tokens(
        rng, 2, lk, 24)
    jmod, tmod = ji.MultiheadAttention(24, 4), ti.MultiheadAttention(24, 4)
    var = _variables(jmod, rng, q, k, v)
    want = jmod.apply(var, q, k, v)
    with torch.no_grad():
        got = _port(tmod, var)(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got, want)


def _close_to_max(got, want):
    """Within 1e-5 x max|want| (and rtol 1e-4): a layer's attention
    softmax over random projections turns fp32 rounding of its logits
    into errors of ~1e-5 of the layer's largest output."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_encoder_layer():
    rng = np.random.default_rng(3)
    src = _tokens(rng, 2, 64)
    jmod = ji.EncoderLayer(D, HEADS, HIDDEN)
    v = _variables(jmod, rng, src, None)
    want = jmod.apply(v, src, None)
    with torch.no_grad():
        got = _port(ti.EncoderLayer(D, HEADS, HIDDEN), v)(
            torch.from_numpy(src), (8, 8))
    _close_to_max(got, want)


def test_decoder_layer():
    rng = np.random.default_rng(4)
    tgt, mem, pos = (_tokens(rng, 2, 64) for _ in range(3))
    jmod = ji.DecoderLayer(D, HEADS, HIDDEN)
    v = _variables(jmod, rng, tgt, mem, pos)
    want = jmod.apply(v, tgt, mem, pos)
    with torch.no_grad():
        got = _port(ti.DecoderLayer(D, HEADS, HIDDEN), v)(
            torch.from_numpy(tgt), torch.from_numpy(mem), (8, 8),
            torch.from_numpy(pos))
    _close_to_max(got, want)


VIT = dict(num_channels=24, embedding_dim=D, num_heads=HEADS, num_layers=2,
           hidden_dim=HIDDEN, num_queries=2)


@functools.lru_cache(maxsize=None)
def _vit(layers=2):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 48, 48, 24)).astype(np.float32)
    jmod = ji.VisionTransformer(**dict(VIT, num_layers=layers))
    return jmod, _variables(jmod, rng, x, query_idx=1), x


def test_vision_transformer():
    """Unfold, the encoding residual, the query row of task 1, 2 + 2
    layers, the MLP head and the fold."""
    jmod, v, x = _vit()
    want = compiled(lambda var, a: jmod.apply(var, a, 1), v, x)
    with torch.no_grad():
        got = _port(ti.VisionTransformer(**VIT), v)(nchw(x), 1)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), RTOL,
                               ATOL * np.abs(want).max())


def test_adapter_gradients_match_jax():
    """d(sum(out * g))/d(input, every parameter) of the adapter at
    ``train=False`` on a 9x9 grid: odd sides leave the DC coefficient as
    the only real one, and a BatchNorm bias of 3 makes it positive, so
    every phase, and the phase weight's gradient, is unambiguous."""
    rng = np.random.default_rng(7)
    x = _tokens(rng, 2, 81)
    jmod = ji.AdaptIRAdapter(D)
    v = _variables(jmod, rng, x)
    v["params"]["BN"]["bias"] = np.full_like(v["params"]["BN"]["bias"], 3.0)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(params, a):
        out = jmod.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, a)
        return jnp.sum(out * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    tmod = _port(ti.AdaptIRAdapter(D), v)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ti._map_to_tokens(tmod(ti._tokens_to_map(xt, 9, 9)))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), RTOL,
                               ATOL * np.abs(jgx).max())
    grads_close(tmod, jgp, ti.ipt_key_map)


def test_gradients_match_jax():
    """d(sum(out * g))/d(input, every parameter) of the VisionTransformer
    at 1 + 1 layers (an encoder layer, a decoder layer with its
    cross-attention, both adapters) at ``train=False``: at 2 + 2 layers
    JAX's fp32 input gradient lies 1.1e-5 x max from the port run in
    float64, and the port's, one torch thread, 2.5e-5. The phase weight's
    gradient is -phase x ..., and the phase of a real negative DC or
    Nyquist coefficient is +-pi by the sign of rounding noise
    (``seeded_adaptir``): those gradients are checked in
    :func:`test_adapter_gradients_match_jax`, where no phase is
    ambiguous."""
    jmod, v, x = _vit(1)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def loss(params, a):
        out = jmod.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, a, 1)
        return jnp.sum(out * g)

    jgp, jgx = compiled(jax.grad(loss, argnums=(0, 1)), v["params"], x)
    tmod = _port(ti.VisionTransformer(**dict(VIT, num_layers=1)), v)
    xt = nchw(x).requires_grad_(True)
    (tmod(xt, 1) * nchw(g)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx), RTOL,
                               ATOL * np.abs(jgx).max())
    grads_close(tmod, jgp, ti.ipt_key_map, ("adaptir.pha_fuse.weight",))


TINY = dict(n_feats=24)  # embed 216, 12 heads, hidden 864, 12 + 12 layers
BATCH = 2  # the two 48x48 windows of a 48x80 image (--tile 48)


@functools.lru_cache(maxsize=None)
def _jax_model(task, bf16=False):
    """(variables, x, compiled JAX forward, its output) of IPT at ``TINY``
    for ``task``; the forward takes (variables, x). The bf16 model draws
    the same seeded weights."""
    rng = np.random.default_rng(10 + task)
    x = rng.random((BATCH, 48, 48, 3), dtype=np.float32)
    jnet = ji.IPT(**TINY, dtype=jnp.bfloat16 if bf16 else None)
    if bf16:
        v = _jax_model(task)[0]
    else:
        v = seeded_adaptir(traced_shapes(jnet, jnp.asarray(x),
                                         task_idx=task), rng)
        head = v["params"][f"head_{task}_0"]["conv"]
        head["kernel"] = head["kernel"] / 255.0  # see the module docstring
    fwd = jax.jit(lambda var, a: jnet.apply(var, a, task_idx=task))
    exe = fwd.lower(v, jnp.asarray(x)).compile(FAST)
    return v, x, exe, np.asarray(exe(v, jnp.asarray(x)), np.float32)


def _port_ipt(v, task, dtype=None):
    return _port(get_model("ipt", **TINY, task_idx=task, dtype=dtype), v)


@pytest.mark.parametrize("task", [0, 5])
def test_whole_model_matches_jax(task):
    v, x, _, want = _jax_model(task)
    with torch.inference_mode():
        got = _port_ipt(v, task)(nchw(x))
    scale = 2 if task == 0 else 1
    assert got.dtype == torch.float32
    assert got.shape == (BATCH, 3, 48 * scale, 48 * scale)
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def test_bf16_within_three_times_jax_bf16():
    v, x, _, want32 = _jax_model(5)
    _, _, _, want16 = _jax_model(5, bf16=True)
    with torch.inference_mode():
        got = _port_ipt(v, 5, torch.bfloat16)(nchw(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err_port = np.abs(nhwc(got) - want32)
    err_jax = np.abs(want16 - want32)
    assert err_port.max() <= 3 * err_jax.max(), (err_port.max(),
                                                 err_jax.max())
    assert err_port.mean() <= 3 * err_jax.mean(), (err_port.mean(),
                                                   err_jax.mean())


def test_size_other_than_48_raises():
    with pytest.raises(ValueError, match="48x48"):
        get_model("ipt", **TINY)(torch.rand(1, 3, 64, 64))


def _reference_pth(path, v):
    """A reference-layout checkpoint of task 5's weights: the port's keys
    (the reference's), the frozen MeanShift convs, the ``position_ids``
    buffer and task 0's head and tail."""
    sd = dict(_port_ipt(v, 5).state_dict())
    other = get_model("ipt", **TINY, task_idx=0).state_dict()
    sd.update({k: t for k, t in other.items()
               if k.startswith(("head.0.", "tail.0."))})
    for name in ("sub_mean", "add_mean"):
        sd[f"{name}.weight"] = torch.eye(3).view(3, 3, 1, 1)
        sd[f"{name}.bias"] = torch.zeros(3)
    sd["body.position_encoding.position_ids"] = torch.arange(256)[None]
    torch.save({"state_dict": sd}, path)
    return sd


def test_npz_and_reference_pth_load_strictly(tmp_path):
    v, _, _, _ = _jax_model(5)
    npz = str(tmp_path / "ipt.npz")
    save_params_npz(npz, v["params"])
    fresh = get_model("ipt", **TINY)
    model = load_params({"model": "ipt", "ckpt": npz},
                        get_model("ipt", **TINY))
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["body.decoder.layers.3.adaptir.amp_fuse.weight"].numpy().ravel(),
        v["params"]["body"]["decoder_layers_3"]["adaptir"]["amp_fuse_weight"])
    np.testing.assert_array_equal(
        sd["head.5.1.body.2.weight"].numpy(),
        v["params"]["head_5_1"]["body_2"]["conv"]["kernel"].transpose(
            3, 2, 0, 1))
    np.testing.assert_array_equal(sd["body.query_embed.weight"].numpy(),
                                  v["params"]["body"]["query_embed"])
    key = "body.encoder.layers.0.adaptir.BN.running_var"
    assert torch.equal(sd[key], fresh.state_dict()[key])  # params only

    pth = str(tmp_path / "ipt.pth")
    src = _reference_pth(pth, v)
    for task in (5, 0):
        model = load_params({"model": "ipt_adaptir", "ckpt": pth},
                            get_model("ipt", **TINY, task_idx=task))
        for k, t in model.state_dict().items():
            assert torch.equal(t, src[k]), k


def test_infer_tile_48_matches_jax(tmp_path):
    """A 48x80 image in two 48x48 windows, one batch, through the port's
    ``make_restore_fn`` from the ``cli/infer.py`` options, against the
    JAX ``windowed_apply`` of the JAX model with its ``batch_stats``; then
    ``main`` writes it."""
    v, _, exe, _ = _jax_model(5)
    img = np.random.default_rng(20).random((48, 80, 3), dtype=np.float32)
    want = windowed_apply(lambda w: jnp.clip(exe(v, w), 0.0, 1.0),
                          jnp.asarray(img)[None], 48)[0]
    pth = str(tmp_path / "ipt.pth")
    _reference_pth(pth, v)
    argv = ["--model", "ipt", "--fp32", "--device", "cpu", "--tile", "48",
            "--set", "model_kwargs.n_feats=24", "--ckpt", pth]
    cfg = parse_options(argv)
    got = infer.make_restore_fn(cfg, load_params(cfg, build_model(cfg)))(img)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, np.asarray(want), RTOL, ATOL)
    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray((img * 255).astype(np.uint8)).save(str(src / "a.png"))
    outs = infer.main(argv + ["--input", str(src), "--output_dir",
                              str(tmp_path / "out")])
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(48, 80, 3)]


@pytest.mark.parametrize("name", ["ipt", "ipt_adaptir", "edt",
                                  "edt_adaptir"])
def test_train_cli_refuses(name, tmp_path):
    """As the JAX ``cli/train.py``, which keeps no ``batch_stats``, the
    training CLI refuses IPT and EDT; they train at model level."""
    from image_restoration_tpu_torch.cli import train as train_cli

    with pytest.raises(NotImplementedError, match="model level"):
        train_cli.main(["--model", name, "--device", "cpu", "--ckpt_dir",
                        str(tmp_path)])
