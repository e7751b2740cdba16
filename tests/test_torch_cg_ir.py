"""The port's CG-IR (DACG-IR) and the gated, per-sample finalize against
the JAX package, on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same numpy inputs in fp32 (JAX at "highest" matmul precision, torch
with TF32 off); the port takes NCHW, the JAX package NHWC.

* Modules (DegradationAwareModule, AdaptiveGatedFusion with and without
  ``out_dim``, CGDM, ContextAdaptiveGatedAttention, CGTB plain and fused,
  GroupNorm): rtol=1e-4, atol=1e-5.
* The gated finalize (``kernels/block.py``): ``fused_block(..., gate=)``
  and ``reference_block(..., gate=)`` with a per-sample (b, heads)
  temperature at batch 2 and 16 channels, against JAX
  ``_reference_block(..., gate=)`` in fp32 (rtol=1e-4, atol=1e-5), and in
  bf16 against JAX ``block_pallas._forward`` with both Pallas kernels in
  interpret mode (rtol=atol=5e-2, the tolerance of
  tests/test_torch_block.py).
* The whole model at dim 16, one block a level, 32x32, batch 2, plain and
  ``fused_block``, each against the JAX model in the same mode: atol=2e-4.
* Entry points: a JAX ``.npz`` through ``load_params``, and ``cli.infer
  --model cg_ir`` on the CPU.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    ATOL,
    RTOL,
    init_shapes,
    load,
    nchw,
    nhwc,
    pair,
    randomized,
)
from test_torch_block import _jax_params, _jnp, _port_params

from image_restoration_tpu.kernels import block_pallas as JK
from image_restoration_tpu.models import cg_ir as jc
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.kernels import block as TK
from image_restoration_tpu_torch.models import cg_ir as tc
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.ops.layernorm import GroupNorm

TINY = dict(dim=16, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
            heads=(1, 2, 4, 8), context_dim=16, num_scales=2)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _to_torch(x):
    return nchw(x) if x.ndim == 4 else torch.from_numpy(np.asarray(x))


def _close(got, want):
    got = [got] if isinstance(got, torch.Tensor) else got
    want = [want] if not isinstance(want, (list, tuple)) else want
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = nhwc(g) if g.ndim == 4 else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def test_degradation_aware_module():
    rng = np.random.default_rng(0)
    dims = (16, 32, 64, 128)
    img = rng.random((2, 24, 20, 3), dtype=np.float32)
    (want_p, want_g), (got_p, got_g) = pair(
        jc.DegradationAwareModule(16, 3, dims),
        tc.DegradationAwareModule(16, 3, dims), rng, img, to_torch=_to_torch)
    _close(got_p + [got_g], list(want_p) + [want_g])


@pytest.mark.parametrize("out_dim", [None, 32])
def test_adaptive_gated_fusion(out_dim):
    rng = np.random.default_rng(1)
    want, got = pair(jc.AdaptiveGatedFusion(16, out_dim),
                     tc.AdaptiveGatedFusion(16, out_dim), rng, _x(rng, 16),
                     _x(rng, 16))
    _close(got, want)


@pytest.mark.parametrize("hw", [(8, 8), (12, 10)])
def test_cgdm(hw):
    """rfft2/irfft2 (``norm="ortho"``), an even and an odd half-spectrum."""
    rng = np.random.default_rng(2)
    want, got = pair(jc.CGDM(32, 16), tc.CGDM(32, 16), rng,
                     _x(rng, 32, *hw), rng.standard_normal((2, 16)).astype(
                         np.float32), to_torch=_to_torch)
    _close(got, want)


@pytest.mark.parametrize("heads,bias", [(1, False), (2, True)])
def test_context_adaptive_gated_attention(heads, bias):
    rng = np.random.default_rng(3 + heads)
    want, got = pair(jc.ContextAdaptiveGatedAttention(32, heads, bias, 16),
                     tc.ContextAdaptiveGatedAttention(32, heads, bias, 16),
                     rng, _x(rng, 32),
                     rng.standard_normal((2, 16)).astype(np.float32),
                     to_torch=_to_torch)
    _close(got, want)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_cgtb(fused):
    """Fused: the port's K1/K2 plain passes with finalize's folded gate
    against the JAX fused path on its canvas layout (on the CPU its
    ``_reference_block`` with the gate), both fp32."""
    rng = np.random.default_rng(5)
    x, ctx = _x(rng, 32), rng.standard_normal((2, 32)).astype(np.float32)
    jmod = jc.CGTB(32, 2, context_dim=32, fused_block=fused)
    jx, kw = (JK.canvas_pad(jnp.asarray(x)), dict(w_real=x.shape[2])) \
        if fused else (x, {})
    params = randomized(init_shapes(jmod, jx, ctx, **kw)["params"], rng)
    want = jmod.apply({"params": params}, jx, ctx, **kw)
    if fused:
        want = JK.canvas_unpad(want, x.shape[2], 32)
    tmod = load(tc.CGTB(32, 2, context_dim=32, fused_block=fused), params)
    with torch.no_grad():
        got = tmod(nchw(x), torch.from_numpy(ctx))
    _close(got, want)


def test_group_norm_matches_flax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 6, 5, 16)) * 3 + 1).astype(np.float32)
    jmod = fnn.GroupNorm(num_groups=8, epsilon=1e-5)
    want, got = pair(jmod, GroupNorm(8, 16, eps=1e-5), rng, x)
    _close(got, want)


# ------------------------------------------------------- gated finalize ----

C, HW, EPS = 16, (12, 10), 1e-5


def _gated_case(rng, heads, ln_type):
    """JAX params with a per-sample (2, heads) temperature, the port's
    BlockParams of the same weights, x (2, H, W, 16) and gate (2, 16)."""
    jp = list(_jax_params(rng, C, heads, ln_type))
    jp[6] = np.exp(rng.standard_normal((2, heads)) * 0.3).astype(np.float32)
    x = rng.standard_normal((2,) + HW + (C,)).astype(np.float32)
    gate = (1 / (1 + np.exp(-rng.standard_normal((2, C))))).astype(np.float32)
    return tuple(jp), _port_params(tuple(jp), C), x, gate


CASES = [(1, "WithBias"), (2, "WithBias"), (2, "BiasFree")]


@pytest.mark.parametrize("heads,ln_type", CASES)
def test_gated_blocks_match_jax_reference(heads, ln_type):
    rng = np.random.default_rng(heads)
    jp, p, x, gate = _gated_case(rng, heads, ln_type)
    want = np.asarray(JK._reference_block(jnp.asarray(x), _jnp(jp), heads,
                                          ln_type, EPS, gate=jnp.asarray(gate)))
    xt, gt = torch.from_numpy(x), torch.from_numpy(gate)
    for fn in (TK.reference_block, TK.fused_block):
        got = fn(xt, p, heads, EPS, gate=gt)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ungated = TK.fused_block(xt, p, heads, EPS).numpy()
    assert np.abs(ungated - want).max() > 1e-2  # the gate is not a no-op


@pytest.mark.parametrize("heads,ln_type", CASES)
def test_gated_fused_block_matches_jax_interpret(monkeypatch, heads,
                                                 ln_type):
    rng = np.random.default_rng(10 + heads)
    jp, p, x, gate = _gated_case(rng, heads, ln_type)
    xb = jnp.asarray(x * 0.5, jnp.bfloat16)
    monkeypatch.setattr(JK, "_INTERPRET", True)
    cfg = (C, HW[1], heads, ln_type, EPS)
    want = JK.canvas_unpad(JK._forward(JK.canvas_pad(xb), _jnp(jp), cfg,
                                       jnp.asarray(gate)), HW[1], C)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got = TK.fused_block(xt, p, heads, EPS, gate=torch.from_numpy(gate))
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


def test_finalize_folds_the_gate_per_sample():
    """A^T diag(gate) W_proj per sample, fp32: the fold of image 1 uses
    image 1's temperature and gate only."""
    rng = np.random.default_rng(20)
    b, heads, ch = 2, 2, 8
    gram = torch.from_numpy(rng.standard_normal((b, heads, ch, ch)).astype(
        np.float32))
    ss = torch.from_numpy((rng.random((b, 2, C)) + 0.5).astype(np.float32))
    temp = torch.from_numpy(rng.random((b, heads)).astype(np.float32) + 0.5)
    gate = torch.from_numpy(rng.random((b, C)).astype(np.float32))
    wp = torch.from_numpy(rng.standard_normal((C, C, 1, 1)).astype(np.float32))
    got = TK.finalize(gram, ss, temp, wp, torch.float32, gate)
    for i in range(b):
        a = TK.attention_softmax(gram[i:i + 1], ss[i:i + 1], temp[i:i + 1])
        full = torch.block_diag(*a[0])  # (C, C): A of every head
        want = full.t() @ torch.diag(gate[i]) @ wp.reshape(C, C).t()
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------- whole model ----

@functools.lru_cache(maxsize=None)
def _jax_model(fused):
    rng = np.random.default_rng(30)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    jnet = jc.DACG_IR(**TINY, fused_block=fused)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"],
                        np.random.default_rng(31))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a))(
            params, jnp.asarray(x)))
    return params, x, want


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_whole_model_matches_jax(fused):
    params, x, want = _jax_model(fused)
    tnet = load(get_model("cg_ir", **TINY, fused_block=fused).eval(), params)
    with torch.inference_mode():
        got = tnet(nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=2e-4)


def test_npz_checkpoint_loads(tmp_path):
    params, _, _ = _jax_model(False)
    path = str(tmp_path / "cg_ir.npz")
    save_params_npz(path, params)
    model = load_params({"model": "cg_ir", "ckpt": path},
                        get_model("cg_ir", **TINY))
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["latent.0.attn.log_base_temperature"].numpy(),
        params["latent_0"]["attn"]["log_base_temperature"])
    np.testing.assert_array_equal(
        sd["context_net.layer_prompts.2.weight"].numpy(),
        params["context_net"]["layer_prompts_2"]["kernel"].T)


def test_infer_cli_serves_cg_ir(tmp_path):
    from PIL import Image

    src = tmp_path / "in"
    src.mkdir()
    arr = (np.random.default_rng(32).random((37, 45, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(str(src / "im.png"))
    sets = [a for k, v in (("dim", 16), ("num_blocks", "(1,1,1,1)"),
                           ("num_refinement_blocks", 1))
            for a in ("--set", f"model_kwargs.{k}={v}")]
    outs = infer.main(["--model", "cg_ir", "--device", "cpu", "--input",
                       str(src), "--output_dir", str(tmp_path / "out")]
                      + sets)
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]
