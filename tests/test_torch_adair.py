"""The port's AdaIR against the JAX package's, on the same weights.

Each JAX module is given seeded random parameters (``para1`` and ``para2``
included: ``para1``'s zero init would hide the FreModule's output), the
same tree is loaded into the port through ``state_dict_from_jax`` with
``adair_key_map``, and both run on the same numpy input in fp32 (JAX at
"highest" matmul precision, torch with TF32 off); the port takes NCHW, the
JAX package NHWC.

* Modules (ChannelCrossAttention, SpatialGate, ChannelGate, FreRefine,
  FreModule) and ``resize_bilinear``: rtol=1e-4, atol=1e-5.
* ``adaptive_rect_mask``: exact. The FreModule runs once with a small
  ``mask_n`` so that its low-pass rectangle is not empty (at the reference's
  128 it is empty below 128 pixels).
* The whole model at dim 8, blocks 1/1/1/1, on 32x24 and on 256x256, with
  plain blocks, ``fused_block`` and the three-kernel block, against the
  plain JAX model (the JAX flags run the same composition on the CPU):
  atol=2e-4. At 256x256 the last FreModule runs at 128x128, where the
  rectangle is empty unless its rate gate saturates at 1.0, so the test
  sets that gate's weights to saturate it and checks the rectangle is not
  empty.
* Checkpoints: a JAX ``.npz`` through ``load_params`` and the registered
  key map; a torch state_dict with the reference's unused ``fre1.conv`` and
  ``fre1.score_gen`` through ``load_params``; ``cli.infer --model adair``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from seeding import seed_biases

from image_restoration_tpu.models import adair as ja
from image_restoration_tpu.ops.resample import resize_bilinear as j_resize
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import adair as ta
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.ops.resample import resize_bilinear
from image_restoration_tpu_torch.utils.jax_bridge import state_dict_from_jax

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            heads=(1, 2, 4, 8))
MODES = {"plain": {}, "fused_block": dict(fused_block=True),
         "three_kernel": dict(fused_attn=True, fused_gdfn=True)}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _randomized(shapes, rng):
    """Every leaf of a param tree (or its shapes) replaced by seeded values:
    kernels at the fan-in scale, LN weights and temperatures near 1, the
    rest (para1, para2 and biases included) near 0."""
    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
                continue
            z = rng.standard_normal(v.shape)
            if k == "kernel":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "temperature" or (parent == "body" and k == "weight"):
                z = 1.0 + 0.2 * z
            else:
                z = 0.5 * z
            out[k] = z.astype(np.float32)
        return out
    return walk(shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _load(tmod, params):
    tmod.load_state_dict(state_dict_from_jax(params, tmod.state_dict(),
                                             ta.adair_key_map), strict=True)
    return tmod


def _pair(jmod, tmod, rng, *inputs):
    """(JAX output, port output), both NHWC numpy, on shared weights."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *inputs)
    params = _randomized(shapes["params"], rng)
    _load(tmod, params)
    want = np.asarray(jmod.apply({"params": params}, *inputs))
    with torch.no_grad():
        got = tmod(*(_nchw(x) for x in inputs))
    return want, got.permute(0, 2, 3, 1).numpy()


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("dim,heads,bias", [(16, 2, False), (32, 4, True)])
def test_channel_cross_attention(dim, heads, bias):
    rng = np.random.default_rng(dim)
    want, got = _pair(ja.ChannelCrossAttention(dim, heads, bias),
                      ta.ChannelCrossAttention(dim, heads, bias), rng,
                      _x(rng, dim), _x(rng, dim))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["SpatialGate", "ChannelGate"])
def test_gates(name):
    rng = np.random.default_rng(1)
    args = () if name == "SpatialGate" else (32,)
    want, got = _pair(getattr(ja, name)(*args), getattr(ta, name)(*args), rng,
                      _x(rng, 32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fre_refine():
    rng = np.random.default_rng(2)
    want, got = _pair(ja.FreRefine(32), ta.FreRefine(32), rng, _x(rng, 32),
                      _x(rng, 32))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h,w,n", [(256, 384, 64), (40, 24, 8), (64, 64, 128)])
def test_adaptive_rect_mask(h, w, n):
    frac = np.random.default_rng(h).random((3, 2), dtype=np.float32)
    want = np.asarray(ja.adaptive_rect_mask(h, w, jnp.asarray(frac[:, 0]),
                                            jnp.asarray(frac[:, 1]), n))
    got = ta.adaptive_rect_mask(h, w, torch.from_numpy(frac[:, 0]),
                                torch.from_numpy(frac[:, 1]), n)
    assert got.shape == (3, 1, h, w)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert want.any() == (h >= n)


@pytest.mark.parametrize("size", [(8, 6), (16, 12), (32, 24), (64, 48),
                                  (100, 70)])
@pytest.mark.parametrize("src", [(64, 48), (37, 45)])
def test_resize_bilinear(size, src):
    """Downsampling (antialiased, as jax.image.resize), the same size and
    upsampling, from 64x48 (whole scale factors) and from 37x45."""
    x = np.random.default_rng(3).random((2,) + src + (3,), dtype=np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), *size))
    got = resize_bilinear(_nchw(x), *size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_fre_module_with_a_low_band():
    """mask_n 8 at 32x24: the rectangle's half-extents are floor(4 * frac)
    and floor(3 * frac), not empty for the seeded gate."""
    rng = np.random.default_rng(4)
    jmod = ja.FreModule(16, 4, mask_n=8)
    tmod = ta.FreModule(16, 4, mask_n=8)
    rates = []
    tmod.rate_conv.register_forward_hook(lambda m, i, o: rates.append(o))
    img = rng.random((2, 64, 48, 3), dtype=np.float32)
    want, got = _pair(jmod, tmod, rng, img, _x(rng, 16, 32, 24))
    thr = torch.sigmoid(rates[0].reshape(2, 2))
    assert ta.adaptive_rect_mask(32, 24, thr[:, 0], thr[:, 1], 8).sum() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _saturate_rate_gate(tree, name):
    """Weights of ``name``'s rate gate that drive both logits to about
    +1000 * |mean feature|: row 0 of the first 1x1 sums the channels, row 1
    negates the sum, and every output sums both GELUs with weight 1000, so
    one GELU is large and positive whatever the input's sign. The sigmoid
    is then exactly 1.0 in fp32 and the rectangle's half-extent is
    floor(h // 128)."""
    k0 = tree[name]["rate_conv_0"]["conv"]["kernel"]
    c = k0.shape[2]
    k0 = np.zeros_like(k0)
    k0[..., 0], k0[..., 1] = 100.0 / c, -100.0 / c
    tree[name]["rate_conv_0"]["conv"]["kernel"] = k0
    k2 = tree[name]["rate_conv_2"]["conv"]["kernel"]
    tree[name]["rate_conv_2"]["conv"]["kernel"] = np.full_like(k2, 1000.0)


@functools.lru_cache(maxsize=None)
def _jax_reference(hw):
    """(params, input, JAX output) of the plain JAX model at one size. On
    the CPU the JAX kernel flags run their plain compositions, the same
    function, so this output is the reference for every block mode of the
    port (one JAX compile per size instead of one per mode)."""
    rng = np.random.default_rng(5)
    x = rng.random((1,) + hw + (3,), dtype=np.float32)
    jnet = ja.AdaIR(**TINY)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = _randomized(shapes["params"], rng)
    if hw[0] >= 256:
        _saturate_rate_gate(params, "fre3")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(
            lambda p, xx: jnet.apply({"params": p}, xx))(params,
                                                         jnp.asarray(x)))
    return params, x, want


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("hw", [(32, 24), (256, 256)])
def test_whole_model_matches_jax(mode, hw):
    params, x, want = _jax_reference(hw)
    tnet = _load(get_model("adair", **TINY, **MODES[mode]).eval(), params)
    rates = []
    tnet.fre3.rate_conv.register_forward_hook(lambda m, i, o: rates.append(o))
    with torch.inference_mode():
        got = tnet(_nchw(x))
    assert got.dtype == torch.float32
    if hw[0] >= 256:  # fre3 runs at 128x128 with a 2x2 low band
        thr = torch.sigmoid(rates[0].reshape(1, 2))
        mask = ta.adaptive_rect_mask(128, 128, thr[:, 0], thr[:, 1])
        assert mask.sum() == 4
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=2e-4)


def _jax_tree(seed=0):
    jnet = ja.AdaIR(**TINY)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 24, 3)))
    return _randomized(shapes["params"], np.random.default_rng(seed))


def _cfg(ckpt):
    return {"model": "adair", "ckpt": ckpt, "model_kwargs": dict(TINY)}


def test_npz_checkpoint_loads_through_the_key_map(tmp_path):
    tree = _jax_tree()
    path = str(tmp_path / "adair.npz")
    save_params_npz(path, tree)
    model = load_params(_cfg(path), get_model("adair", **TINY))
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["fre1.para1"].numpy(), tree["fre1"]["para1"])
    np.testing.assert_array_equal(
        sd["fre2.frequency_refine.ChannelGate.mlp.2.weight"].numpy(),
        tree["fre2"]["frequency_refine"]["ChannelGate"]["mlp_2"]["conv"][
            "kernel"].transpose(3, 2, 0, 1))


def test_torch_checkpoint_drops_the_unused_fre_params(tmp_path):
    """The reference's fre*.conv and fre*.score_gen are sent to None by the
    key map and are not in the model: load_params drops them. A key the map
    keeps and the model lacks still fails the strict load."""
    src = get_model("adair", **TINY)
    seed_biases(src, 0, 1.0)  # the init's are 0: the load must move them
    sd = dict(src.state_dict())
    sd["fre1.conv.weight"] = torch.randn(64, 3, 3, 3)
    sd["fre1.score_gen.weight"] = torch.randn(2, 2, 7, 7)
    path = str(tmp_path / "adair.pth")
    torch.save({"params": sd}, path)
    model = load_params(_cfg(path), get_model("adair", **TINY))
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    sd["fre1.bogus.weight"] = torch.zeros(1)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="bogus"):
        load_params(_cfg(path), get_model("adair", **TINY))


def test_infer_cli_serves_adair(tmp_path):
    from PIL import Image

    src = tmp_path / "in"
    src.mkdir()
    arr = (np.random.default_rng(6).random((37, 45, 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(str(src / "im.png"))
    sets = [a for k, v in (("dim", 8), ("num_blocks", "(1,1,1,1)"),
                           ("num_refinement_blocks", 1))
            for a in ("--set", f"model_kwargs.{k}={v}")]
    outs = infer.main(["--model", "adair", "--device", "cpu", "--input",
                       str(src), "--output_dir", str(tmp_path / "out")]
                      + sets)
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]
