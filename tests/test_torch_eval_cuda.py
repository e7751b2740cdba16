"""The benchmark-evaluation path on the card: its metrics, the block
kernels at the shapes evaluation gives them, and the tiled batch.

Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eval_cuda.py -q

- ``eval/metrics.py`` and ``evaluate`` on the card against the same
  functions on the CPU, with both TF32 flags turned on by the caller
  (the metrics must turn them off): PSNR 1e-4 dB, SSIM 1e-5, ``ssim_yc``
  1e-4 (the tolerances of tests/test_torch_metrics.py).
- K1/K2 (``kernels/block.py``) at Restormer-base's deepest map under
  ``pad_test`` of a 481x321 and a 321x481 image (61x41 and 41x61 at 384
  channels, 8 heads): phase 2's rule of ``chip_smoke.py`` (with the fp32
  plain version as the oracle, max relative error below max(3 x the plain
  bf16 version's, 4e-3)) and two bit-equal runs; at the deepest map of a
  128x128 window (16x16x384), a batch of 12 images gives each image's bits
  alone.
- ``windowed_apply`` of Restormer-base (``cli/infer.py`` ``--tile 128``)
  on a 321x481 image: 12 windows in one batch, each bit-equal to the
  window restored alone, or else within phase 2's rule against the plain
  fp32 model (phase 3f of ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.kernels import block as K

PSNR_TOL = 1e-4
SSIM_TOL = 1e-5
SSIM_YC_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, oracle):
    scale = oracle.float().abs().max().item() + 1e-12
    return (got.float() - oracle.float()).abs().max().item() / scale


def _pair(seed, h=321, w=481):
    rng = np.random.default_rng(seed)
    pred = rng.random((1, 3, h, w)).astype(np.float32)
    noise = rng.standard_normal(pred.shape).astype(np.float32) * 0.05
    target = np.clip(pred + noise, 0.0, 1.0).astype(np.float32)
    mask = np.repeat(rng.random((1, 1, h, w)) > 0.2, 3, axis=1)
    return (torch.from_numpy(pred), torch.from_numpy(target),
            torch.from_numpy(mask.astype(np.float32)))


@pytest.mark.cuda
def test_metrics_on_card_match_cpu(cuda, monkeypatch):
    from image_restoration_tpu_torch.eval import metrics as M

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cpu = _pair(1)
    dev = [t.to(cuda) for t in cpu]
    cases = [
        (lambda p, t, m: M.psnr(p, t), PSNR_TOL),
        (lambda p, t, m: M.masked_psnr(p, t, m), PSNR_TOL),
        (lambda p, t, m: M.ssim(p, t), SSIM_TOL),
        (lambda p, t, m: M.ssim(p, t, sample_covariance=False), SSIM_TOL),
        (lambda p, t, m: M.masked_ssim(p, t, m), SSIM_TOL),
        (lambda p, t, m: M.psnr_yc(p, t, 4), PSNR_TOL),
        (lambda p, t, m: M.ssim_yc(p, t, 4), SSIM_YC_TOL),
    ]
    for i, (fn, tol) in enumerate(cases):
        got, want = fn(*dev), fn(*cpu)
        assert got.device.type == "cuda", i
        assert (got.cpu() - want).abs().max().item() <= tol, i
    assert torch.backends.cudnn.allow_tf32  # the caller's flags are back


@pytest.mark.cuda
@pytest.mark.parametrize("y_channel", [False, True], ids=["rgb", "y"])
def test_evaluate_on_card_matches_cpu(cuda, y_channel):
    from image_restoration_tpu_torch.eval.benchmarks import evaluate

    items = []
    for seed, (h, w) in enumerate([(321, 481), (481, 321)]):
        p, t, _ = _pair(seed, h, w)
        items.append({"lq": p[0].permute(1, 2, 0).numpy(),
                      "gt": t[0].permute(1, 2, 0).numpy(), "name": f"{seed}"})

    def fn(x):
        return 0.9 * x + 0.05

    kw = dict(y_channel=y_channel, crop_border=4 if y_channel else 0)
    got = evaluate(fn, items, device=cuda, **kw)
    want = evaluate(fn, items, device="cpu", **kw)
    assert got.n == want.n == 2
    assert abs(got.psnr - want.psnr) <= PSNR_TOL
    assert abs(got.ssim - want.ssim) <= (SSIM_YC_TOL if y_channel else SSIM_TOL)


def _block(seed, c=384, heads=8):
    """Restormer-base's deepest block (WithBias LN, bias-free convs, hidden
    1021) from the module's init, LN affine and temperature perturbed."""
    from image_restoration_tpu_torch.models.restormer import TransformerBlock

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        blk = TransformerBlock(c, heads)
    with torch.no_grad():
        for mod in (blk.norm1.body, blk.norm2.body):
            mod.weight.add_(0.2 * torch.randn(c, generator=gen))
            mod.bias.add_(0.2 * torch.randn(c, generator=gen))
        blk.attn.temperature.copy_(0.5 + torch.rand(heads, 1, 1, generator=gen))
    return blk.cuda().block_params()


def _x(seed, b, h, w, c=384):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((b, h, w, c), generator=gen).to("cuda", torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(61, 41), (41, 61)])
def test_block_kernels_at_eval_deep_maps(cuda, h, w):
    p, x = _block(h), _x(h + w, 1, h, w)
    oracle = K.block_front_ref(x.float(), p, 8)
    plain = K.block_front_ref(x, p, 8)
    got = K.block_front(x, p, 8)
    again = K.block_front(x, p, 8)
    torch.cuda.synchronize()
    for name, o, pl, g, a in zip(("v", "gram", "sumsq"), oracle, plain, got,
                                 again):
        assert g.shape == pl.shape and torch.isfinite(g).all(), name
        assert _rel(g, o) < max(3 * _rel(pl, o), 4e-3), name
        assert torch.equal(g, a), name

    v, gram, ss = plain
    atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
    oracle = K.block_apply_gdfn_ref(v.float(), x.float(), atw.float(), p)
    plain = K.block_apply_gdfn_ref(v, x, atw, p)
    got = K.block_apply_gdfn(v, x, atw, p)
    again = K.block_apply_gdfn(v, x, atw, p)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert _rel(got, oracle) < max(3 * _rel(plain, oracle), 4e-3)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_block_kernels_batch_of_12_equal_each_image_alone(cuda):
    p, x = _block(5), _x(6, 12, 16, 16)
    v, gram, ss = K.block_front(x, p, 8)
    atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
    out = K.block_apply_gdfn(v, x, atw, p)
    for i in range(12):
        v1, g1, s1 = K.block_front(x[i:i + 1], p, 8)
        o1 = K.block_apply_gdfn(v1, x[i:i + 1], atw[i:i + 1], p)
        torch.cuda.synchronize()
        for name, a, b in (("v", v[i:i + 1], v1), ("gram", gram[i:i + 1], g1),
                           ("sumsq", ss[i:i + 1], s1),
                           ("out", out[i:i + 1], o1)):
            assert torch.equal(a, b), (i, name)


@pytest.mark.cuda
def test_windowed_batch_of_12(cuda):
    from image_restoration_tpu_torch.cli.infer import make_restore_fn
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.eval.tiled import window_partition
    from image_restoration_tpu_torch.utils.options import parse_options
    from image_restoration_tpu_torch.utils.precision import full_fp32

    cfg = dict(parse_options(["--seed", "4"]), tile=128)
    model = build_model(cfg)
    img = np.random.default_rng(2).random((321, 481, 3), dtype=np.float32)
    x = torch.from_numpy(img).permute(2, 0, 1)[None].to(cuda)
    wins, _ = window_partition(x, 128)
    assert wins.shape[0] == 12
    restore = make_restore_fn(cfg, model)
    K.block_front.launches = 0
    tiled = restore(img)
    assert K.block_front.launches == 44  # one forward of the 12 windows

    sd = model.state_dict()

    def plain(bf16):
        mk = dict(cfg["model_kwargs"], fused_block=False)
        m = build_model(dict(cfg, bf16=bf16, model_kwargs=mk))
        m.load_state_dict(sd)
        return m

    plain32 = plain16 = None
    with torch.inference_mode(), full_fp32():
        batched = model(wins)
        for k in range(12):
            one = model(wins[k:k + 1])
            if torch.equal(batched[k:k + 1], one):
                continue
            if plain32 is None:
                plain32, plain16 = plain(False), plain(True)
            ref = plain32(wins[k:k + 1])
            assert _rel(batched[k:k + 1], ref) < max(
                3 * _rel(plain16(wins[k:k + 1]), ref), 4e-3), k
    assert tiled.shape == img.shape and np.isfinite(tiled).all()
