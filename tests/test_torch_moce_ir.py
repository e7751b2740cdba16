"""The port's MoCE-IR (``models/moce_ir.py``, ``ops/moe.py``, the MoCE
mixer's ``ChannelCrossAttention(kv_kernel=7)``) against the JAX package's,
on the same weights.

Each JAX module gets seeded random parameters (``tests/family_parity.py``),
the tree goes into the port through ``state_dict_from_jax``, and both run
the same seeded numpy inputs in fp32 (JAX at "highest" matmul precision,
torch with TF32 off); the port takes NCHW, the JAX package NHWC.

Tolerance: rtol=1e-4, atol=1e-5 for every module and for the helpers;
the whole model at atol=1e-5 x the largest |output| (random weights give
outputs near 10, not an image's 1) and rtol=1e-4. Routing picks must be
the same: every test that routes asserts that the gap between the k-th
and the (k+1)-th softmax score exceeds 1e-5, far above fp32 rounding
(~1e-7), so a pick cannot flip between the two packages.

* ``ops/moe.py``: the gates, top-k and dense combine against the JAX
  ``noisy_topk_gates`` (eval, no noise) and ``dense_moe_combine``; ties
  in the logits pick the lower index, in the gates and in a
  RoutingFunction whose two best experts have equal weights.
* Modules: FFTAttention (patch 4 and 8 on a map that needs padding),
  ModExpert, RoutingFunction, AdapterLayer at batch 1 (top-1: the
  switched path) and batch 2 (dense), EncoderBlock plain, DecoderBlock,
  FrequencyEmbedding, the 7x7 ChannelCrossAttention, the static helpers.
* EncoderBlock with ``fused_block`` in bf16 against the JAX block with
  both Pallas kernels in interpret mode (rtol=atol=5e-2, the bf16 rule of
  tests/test_torch_cg_ir.py), with WithBias LN, every conv bias and
  hidden 2C.
* The whole model, plain and ``fused_block`` (fp32: K1/K2's plain
  versions), at dim 16, one block a level, 20x28 (padded to 4) with
  ``rank_type="spread"`` top-1 at batch 1, and top-2 at batch 2.
* Loading: a JAX ``.npz`` and a reference-layout ``.pth`` (``.layers.``
  nesting, ``routing.complexity`` buffers, a Lightning envelope) through
  ``cli/test.py`` ``load_params``; ``cli/infer.py --model moce_ir`` and
  ``cli/test.py --model moce_ir`` on the CPU; a tiled restore (a batch of
  windows: the dense path) against the JAX ``make_restore_fn``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from family_parity import (
    ATOL,
    GAP_MIN,
    RTOL,
    init_shapes,
    kth_gap,
    load,
    nchw,
    nhwc,
    pair,
    randomized,
    routing_gaps,
)
from PIL import Image
from seeding import seed_biases

from image_restoration_tpu.cli import infer as jinfer
from image_restoration_tpu.kernels import block_pallas as JK
from image_restoration_tpu.models import adair as ja
from image_restoration_tpu.models import moce_ir as jm
from image_restoration_tpu.ops import moe as jmoe
from image_restoration_tpu.train.checkpoint import save_params_npz
from image_restoration_tpu_torch.cli import infer
from image_restoration_tpu_torch.cli import test as ttest
from image_restoration_tpu_torch.cli.test import load_params
from image_restoration_tpu_torch.models import adair as ta
from image_restoration_tpu_torch.models import get_model
from image_restoration_tpu_torch.models import moce_ir as tm
from image_restoration_tpu_torch.ops import moe as tmoe

@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _to_torch(x):
    return nchw(x) if np.ndim(x) == 4 else torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = nhwc(got) if got.ndim == 4 else got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _x(rng, c, h=12, w=10, b=2):
    return rng.standard_normal((b, h, w, c)).astype(np.float32)


def _vec(rng, b, n):
    return rng.standard_normal((b, n)).astype(np.float32)


# ------------------------------------------------------------- ops/moe ----

def test_gates_match_jax_noisy_topk_eval():
    rng = np.random.default_rng(0)
    logits = _vec(rng, 6, 4)
    for k in (1, 2):
        jg, ji, jv, _ = jmoe.noisy_topk_gates(jnp.asarray(logits), k, 0.25)
        tg, ti, tv, _ = tmoe.noisy_topk_gates(torch.from_numpy(logits), k)
        assert kth_gap(logits, k) > GAP_MIN
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), RTOL, ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), RTOL, ATOL)


def test_gates_keep_the_lower_index_on_ties():
    logits = np.array([[0.5, 2.0, 2.0, 1.0],      # tie at the top
                       [3.0, 1.0, 0.0, 1.0],      # tie for second
                       [1.0, 1.0, 1.0, 1.0]], np.float32)
    for k in (1, 2, 3):
        _, ji, _, _ = jmoe.noisy_topk_gates(jnp.asarray(logits), k, 0.25)
        _, ti, _, _ = tmoe.noisy_topk_gates(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, ti, _, _ = tmoe.noisy_topk_gates(torch.from_numpy(logits), 2)
    assert ti.tolist() == [[1, 2], [0, 1], [0, 1]]


def test_dense_combine_matches_jax():
    rng = np.random.default_rng(1)
    gates = rng.random((2, 4)).astype(np.float32)
    outs = [_x(rng, 3, 5, 4) for _ in range(4)]
    want = jmoe.dense_moe_combine(jnp.asarray(gates), [jnp.asarray(o)
                                                       for o in outs])
    got = tmoe.dense_moe_combine(torch.from_numpy(gates),
                                 [nchw(o) for o in outs])
    _close(got, want)


# ------------------------------------------------------------- modules ----

@pytest.mark.parametrize("patch,hw", [(4, (12, 10)), (8, (13, 9))])
def test_fft_attention(patch, hw):
    rng = np.random.default_rng(2 + patch)
    want, got = pair(jm.FFTAttention(8, 7, patch),
                     tm.FFTAttention(8, 7, patch), rng, _x(rng, 8, *hw))
    _close(got, want)


def test_mod_expert():
    rng = np.random.default_rng(3)
    want, got = pair(jm.ModExpert(16, 4, 8, 5), tm.ModExpert(16, 4, 8), rng,
                     _x(rng, 16), _x(rng, 16))
    _close(got, want)


def test_routing_function():
    rng = np.random.default_rng(4)
    x, f = _x(rng, 16), _vec(rng, 2, 32)
    jmod = jm.RoutingFunction(16, 32, 4, 2, (1.0,) * 4)
    tmod = tm.RoutingFunction(16, 32, 4, 2)
    (jg, ji, jv, _), (tg, ti, tv, _) = pair(jmod, tmod, rng, x, f,
                                         to_torch=_to_torch)
    assert kth_gap(tmod.logits(nchw(x), torch.from_numpy(f)), 2) > GAP_MIN
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    _close(tv, jv)


def test_routing_tie_picks_the_lower_index():
    """Experts 1 and 3 get the same, largest logit: the switched adapter
    runs expert 1, as JAX's does."""
    rng = np.random.default_rng(5)
    x, f, shared = _x(rng, 16, b=1), _vec(rng, 1, 32), _x(rng, 16, b=1)
    jmod = jm.AdapterLayer(16, 2, 4, 1, freq_dim=32)
    params = randomized(init_shapes(jmod, x, f, shared)["params"], rng)
    r = params["routing"]
    r["gate_2"]["kernel"][:] = r["gate_2"]["kernel"][:, :1]  # one image gate
    up = np.sign(f[0])
    r["freq_gate"]["kernel"][:] = np.stack([-up, up, -up, up], axis=1)

    def port(switched):
        m = tm.AdapterLayer(16, 2, 4, 1, freq_dim=32, switched_eval=switched)
        return load(m, params).eval()

    tmod = port(True)
    xt, ft, st = nchw(x), torch.from_numpy(f), nchw(shared)
    logits = tmod.routing.logits(xt, ft)[0]
    assert logits[1] == logits[3] and logits[1] > logits[0] + 1.0
    assert tmod.routing(xt, ft)[1].item() == 1
    want = jmod.apply({"params": params}, x, f, shared)[0]
    with torch.no_grad():
        _close(tmod(xt, ft, st), want)
        _close(port(False)(xt, ft, st), want)  # the dense combine agrees


@pytest.mark.parametrize("batch,top_k", [(1, 1), (2, 1), (2, 2)],
                         ids=["switched", "dense-top1", "dense-top2"])
def test_adapter_layer(batch, top_k):
    rng = np.random.default_rng(6 + batch + top_k)
    x, f, s = _x(rng, 16, b=batch), _vec(rng, batch, 32), _x(rng, 16,
                                                             b=batch)
    kw = dict(num_experts=4, top_k=top_k, rank_type="spread", freq_dim=32)
    tmod = tm.AdapterLayer(16, 2, **kw)
    (want, _), got = pair(jm.AdapterLayer(16, 2, stage_depth=1,
                                          depth_type="constant",
                                          with_complexity=True, **kw),
                          tmod, rng, x, f, s, to_torch=_to_torch)
    assert kth_gap(tmod.routing.logits(nchw(x), torch.from_numpy(f)),
                   top_k) > GAP_MIN
    _close(got, want)


def test_switched_path_runs_one_expert(monkeypatch):
    rng = np.random.default_rng(9)
    tmod = tm.AdapterLayer(16, 2, 4, 1, freq_dim=32).eval()
    calls = []
    for i, e in enumerate(tmod.experts):
        monkeypatch.setattr(e[0], "forward", functools.partial(
            lambda i, fwd, *a: calls.append(i) or fwd(*a), i, e[0].forward))
    x, f = nchw(_x(rng, 16, b=1)), torch.from_numpy(_vec(rng, 1, 32))
    with torch.no_grad():
        tmod(x, f, x)
        assert len(calls) == 1
        tmod(torch.cat([x, x]), torch.cat([f, f]), torch.cat([x, x]))
    assert len(calls) == 1 + 4  # batch 2: the dense combine


def test_encoder_block_plain():
    rng = np.random.default_rng(10)
    want, got = pair(jm.EncoderBlock(32, 2, 2.0, True),
                     tm.EncoderBlock(32, 2, 2.0, True), rng, _x(rng, 32))
    _close(got, want)


def test_decoder_block():
    rng = np.random.default_rng(11)
    kw = dict(rank=2, num_experts=4, top_k=2, freq_dim=32)
    x, f = _x(rng, 16), _vec(rng, 2, 32)
    tmod = tm.DecoderBlock(16, 2, 2.0, False, **kw)
    (want, _), got = pair(jm.DecoderBlock(16, 2, 2.0, False, **kw), tmod,
                          rng, x, f, to_torch=_to_torch)
    _close(got, want)


def test_frequency_embedding_and_high_pass_init():
    rng = np.random.default_rng(12)
    want, got = pair(jm.FrequencyEmbedding(32), tm.FrequencyEmbedding(32),
                     rng, _x(rng, 32))
    _close(got, want)
    x = jnp.asarray(_x(rng, 8))
    jw = jm.FrequencyEmbedding(8).init(jax.random.PRNGKey(0), x)
    jw = np.asarray(jw["params"]["high_conv_0"]["kernel"]).transpose(3, 2, 0,
                                                                       1)
    np.testing.assert_array_equal(
        tm.FrequencyEmbedding(8).high_conv[0].weight.detach().numpy(), jw)


def test_cross_attention_kv_kernel_7():
    rng = np.random.default_rng(13)
    want, got = pair(ja.ChannelCrossAttention(16, 2, True, kv_kernel=7),
                     ta.ChannelCrossAttention(16, 2, True, kv_kernel=7), rng,
                     _x(rng, 16), _x(rng, 16))
    _close(got, want)


@pytest.mark.parametrize("rank_type", ["constant", "lin", "spread"])
@pytest.mark.parametrize("depth_type", ["lin", "constant", "exp", 2])
def test_static_helpers(rank_type, depth_type):
    args = (4, 2, 2, 48, depth_type, rank_type)
    assert tm._expert_schedules(*args) == jm._expert_schedules(*args)
    for r in tm._expert_schedules(*args)[3]:
        assert tm.expert_param_count(48, r) == jm.expert_param_count(48, r)
        assert (tm.fft_attention_param_count(r, 7)
                == jm.fft_attention_param_count(r, 7))
        # the count is the module's own
        assert tm.expert_param_count(48, r) == sum(
            p.numel() for p in tm.ModExpert(48, r, 4).parameters())


def test_key_map():
    assert tm.moce_key_map("dec.0.2.layers.1.adapter.routing.complexity") \
        is None
    assert (tm.moce_key_map("enc.0.0.layers.3.mixer.qkv.weight")
            == jm.moce_key_map("enc.0.0.layers.3.mixer.qkv.weight")
            == "enc.0.0.3.mixer.qkv.weight")


# ------------------------------------------------------- fused encoder ----

def test_fused_encoder_block_matches_jax_interpret(monkeypatch):
    """K1/K2's plain versions in bf16 against the JAX Pallas kernels in
    interpret mode, at MoCE-IR's block parameters: WithBias LN, every conv
    bias, hidden 2C."""
    rng = np.random.default_rng(14)
    c, heads, h, w = 32, 2, 12, 10
    x = 0.5 * _x(rng, c, h, w)
    jmod = jm.EncoderBlock(c, heads, 2.0, True, fused_block=True)
    xc = JK.canvas_pad(jnp.asarray(x))
    params = randomized(init_shapes(jmod, xc, w_real=w)["params"], rng)
    tmod = load(tm.EncoderBlock(c, heads, 2.0, True, fused_block=True),
                params).eval()
    p = tmod.block_params()
    assert p.out_w.shape[1] == 2 * c and all(
        b is not None for b in (p.qkv_b, p.dw_b, p.proj_b, p.in_b, p.dw2_b,
                                p.out_b, p.ln1_b, p.ln2_b))
    monkeypatch.setattr(JK, "_INTERPRET", True)
    xb = JK.canvas_pad(jnp.asarray(x, jnp.bfloat16))
    want = JK.canvas_unpad(jmod.apply({"params": params}, xb, w_real=w), w,
                           c)
    xt = nchw(np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = tmod(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


# --------------------------------------------------------- whole model ----

TINY = dict(dim=16, levels=3, heads=(1, 2, 4), num_blocks=(1, 1, 1),
            num_dec_blocks=(1, 1), num_refinement_blocks=1)
CASES = {
    "top1-spread": (dict(TINY, topk=1, rank_type="spread",
                         depth_type="constant", stage_depth=(1, 1),
                         with_complexity=True), (1, 20, 28, 3)),
    "top2": (dict(TINY, topk=2), (2, 20, 28, 3)),
}


@functools.lru_cache(maxsize=None)
def _jax_model(case, fused=False):
    kw, shape = CASES[case]
    x = np.random.default_rng(20).random(shape, dtype=np.float32)
    jnet = jm.MoCEIR(**kw)
    params = randomized(init_shapes(jnet, jnp.asarray(x))["params"],
                        np.random.default_rng(21))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a))(
            params, jnp.asarray(x)))
    return params, x, want


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_whole_model_matches_jax(case, fused):
    params, x, want = _jax_model(case)
    tnet = load(get_model("moce_ir", **CASES[case][0], fused_block=fused)
                .eval(), params, tm.moce_key_map)
    gaps = routing_gaps(tnet)
    with torch.inference_mode():
        got = tnet(nchw(x))
    assert got.dtype == torch.float32 and got.shape == nchw(x).shape
    assert len(gaps) == 2 and min(gaps) > GAP_MIN
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


# -------------------------------------------------------------- loading ----

def test_npz_checkpoint_loads(tmp_path):
    params, x, want = _jax_model("top2")
    path = str(tmp_path / "moce.npz")
    save_params_npz(path, params)
    model = load_params({"model": "moce_ir", "ckpt": path},
                        get_model("moce_ir", **CASES["top2"][0])).eval()
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["dec.1.2.0.adapter.routing.gate.2.weight"].numpy(),
        params["dec_1_2_0"]["adapter"]["routing"]["gate_2"]["kernel"].T)
    with torch.inference_mode():
        got = model(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def _reference_layout(sd):
    """The port's state_dict in the reference's layout: blocks under a
    ResidualGroup's ``layers`` and a ``routing.complexity`` buffer per
    adapter."""
    import re

    out = {}
    for k, v in sd.items():
        k2 = re.sub(r"^(enc\.\d+\.0|latent|refinement|dec\.\d+\.2)\.(\d+)\.",
                    r"\1.layers.\2.", k)
        out[k2] = v
        if k2.endswith("adapter.routing.freq_gate.weight"):
            out[k2.replace("freq_gate.weight", "complexity")] = torch.ones(4)
    return out


def test_reference_pth_loads(tmp_path):
    src = get_model("moce_ir", **CASES["top2"][0])
    seed_biases(src, 0, 1.0)  # the init's are 0: the load must move them
    ref = _reference_layout(src.state_dict())
    assert any(".layers." in k for k in ref)
    assert sum(k.endswith("routing.complexity") for k in ref) == 2
    path = str(tmp_path / "moce.ckpt")
    torch.save({"state_dict": {f"net.{k}": v for k, v in ref.items()}}, path)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(99)
        model = get_model("moce_ir", **CASES["top2"][0])
    model = load_params({"model": "moce_ir", "ckpt": path}, model)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_infer_cli_serves_moce_ir(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    arr = (np.random.default_rng(22).random((37, 45, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(str(src / "im.png"))
    sets = [a for k, v in (("dim", 16), ("num_blocks", "(1,1,1,1)"),
                           ("num_dec_blocks", "(1,1,1)"),
                           ("num_refinement_blocks", 1))
            for a in ("--set", f"model_kwargs.{k}={v}")]
    outs = infer.main(["--model", "moce_ir", "--device", "cpu", "--input",
                       str(src), "--output_dir", str(tmp_path / "out")]
                      + sets)
    assert [np.asarray(Image.open(p)).shape for p in outs] == [(37, 45, 3)]
    d = tmp_path / "data" / "deraining" / "Rain100L"
    for sub in ("input", "target"):
        os.makedirs(d / sub)
        Image.fromarray(arr).save(str(d / sub / "0.png"))
    res = ttest.main(["--model", "moce_ir", "--device", "cpu",
                      "--benchmarks", "derain", "--data_file_dir",
                      str(tmp_path / "data"), "--output_dir",
                      str(tmp_path / "res")] + sets)
    assert res["derain"]["n"] == 1 and np.isfinite(res["derain"]["psnr"])


def test_tiled_restore_matches_jax():
    """A 24x20 image in 16x16 windows: four windows through the model as
    one batch (the dense combine), against the JAX restore."""
    kw = dict(TINY, topk=1, rank_type="spread", depth_type="constant",
              stage_depth=(1, 1))
    img = np.random.default_rng(23).random((24, 20, 3), dtype=np.float32)
    jnet = jm.MoCEIR(**kw)
    params = randomized(init_shapes(jnet, jnp.zeros((1, 16, 16, 3)))
                        ["params"], np.random.default_rng(24))
    cfg = {"model": "moce_ir", "tile": 16}
    want = jinfer.make_restore_fn(cfg, jnet, params)(img)
    tnet = load(get_model("moce_ir", **kw).eval(), params)
    gaps = routing_gaps(tnet)
    got = infer.make_restore_fn(cfg, tnet)(img)
    assert got.shape == img.shape and min(gaps) > GAP_MIN
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
