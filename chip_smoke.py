#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (image_restoration_tpu_torch).

Run from the root of the repository on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py [--profile DIR]

Phases, any failure ends the run with a nonzero exit code:
1. device and build: the card's name and power limit; the CUDA kernels are
   built from ``image_restoration_tpu_torch/kernels/csrc`` (timed);
2. kernels vs plain versions: both passes of the Restormer block kernel (K1,
   K2) at every block shape of Restormer-base serving a 512x512 image, in
   bf16, against their plain PyTorch versions, with the fp32 plain version
   as the oracle. The kernel passes if its max relative error is below
   max(3 x the plain bf16 version's, 4e-3). Times are CUDA-event medians;
2b. the same for DRSformer's kernels: the MSFN pass (K7) at the five block
   shapes of DRSformer serving a 512x512 image, and the MEFC step (K8) at
   512x512 x 48 and x 96, four steps each;
3. the Restormer serving slice: Restormer-base from ``build_model`` (bf16,
   fused blocks, seeded random weights) restores three images through
   ``make_restore_fn``. The outputs must be finite; each forward must launch
   44 + 44 block kernels; the fused bf16 model must agree with the fp32
   plain model within 3x the bf16 plain model's own error. ms/img and MP/s
   at 512x512 follow;
2c. the SKA dynamic conv (K9) at LSNet-B's three shapes at batch 64,
   224x224, in bf16 (the same rule, fp32 plain version as the oracle) and
   in fp32 (max relative error 1e-5);
3b. the DRSformer serving slice, the same way: each forward must launch 40
   K1, 40 K7 and 8 K8 (two MEFC Subnets of four steps);
3c. LSNet-B classification serving: ``build_model`` (bf16, the SKA kernel,
   seeded random weights and BatchNorm statistics) scores three seeded
   normalised batches of 64 at 224x224 through ``eval/robustness.py``
   ``batch_hits``. Each forward must launch 9 SKA kernels, the logits must
   be finite, and the kernel model's max |logit error| against the plain
   fp32 model must stay within 3x the plain bf16 model's; top-1 agreement,
   images/s and forward ms follow;
2d. the three-kernel Restormer block's kernels at the five block shapes of
   phase 2, in bf16, by phase 2's rule and timing: LN + qkv + depthwise
   (K4), the attention accumulation (K5, against its plain version on the
   fp32 oracle's q and k, and also held to its plain version on the same
   bf16 map at 1e-5 relative), the attention apply (K6) and LN + GDFN (K3);
3d. Restormer-base with ``fused_block=False, fused_attn=True,
   fused_gdfn=True`` served as phase 3: 44 launches of each of K3-K6 per
   forward, the same agreement rule (the plain models turn all three flags
   off);
3e. AdaIR from its serving defaults (``fused_block``: 44 K1 + 44 K2 per
   forward; its FreModules plain torch, with seeded non-zero ``para1`` and
   ``para2`` so that their output reaches the image), the same way.
Each serving phase sets the launch counts to 0 just before its three
forwards and reads them just after.

Every kernel's row carries its bound: the largest of the bytes it must
move (inputs read once, outputs written once) over 3.35 TB/s, its
products' multiply-adds over the 989 TFLOP/s of bf16 tensor cores, and its
depthwise and SKA taps over the 67 TFLOP/s of fp32 (the elementwise work is
left out, so it stays a lower bound), summed over the forward's calls like
its time. No single PyTorch call computes any of these functions, so
``library_ms`` is null throughout: K1-K4 and K7 are a LayerNorm, 1x1 and
depthwise convs and a Gram reduction or a GDFN/MSFN in one pass; K5 is a
per-head Gram and two sums of squares; K6 is two chained products with a
bf16 rounding between them and a residual; K8 an eight-op mixture; K9 a
dynamic conv whose weights vary per pixel.

The line before the last is a JSON object of the kernels; before it, the
card's name and power limit as nvidia-smi gives them. The last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits nonzero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Block shapes of Restormer-base at a 512x512 input: (H, W, C, heads, blocks
# per forward). Level 1 has two widths: the 4 encoder blocks at 48 and the
# 4 decoder + 4 refinement blocks at 96 after the skip concat.
LEVELS = [
    (512, 512, 48, 1, 4),
    (256, 256, 96, 2, 12),
    (128, 128, 192, 4, 12),
    (64, 64, 384, 8, 8),
    (512, 512, 96, 1, 8),
]
BLOCKS_PER_FORWARD = sum(lv[-1] for lv in LEVELS)  # 44
# DRSformer at a 512x512 input: the same levels, 40 blocks (no refinement
# blocks: the refinement is an MEFC Subnet at 96 channels, as level 0's is
# at 48), decoder level 1 at 96 channels with heads[0].
DRS_LEVELS = [
    (512, 512, 48, 1, 4),
    (256, 256, 96, 2, 12),
    (128, 128, 192, 4, 12),
    (64, 64, 384, 8, 8),
    (512, 512, 96, 1, 4),
]
DRS_BLOCKS_PER_FORWARD = sum(lv[-1] for lv in DRS_LEVELS)  # 40
MEFC_STEPS = [(512, 512, 48, 4), (512, 512, 96, 4)]  # (H, W, C, steps)
MEFC_STEPS_PER_FORWARD = sum(lv[-1] for lv in MEFC_STEPS)  # 8
# LSNet-B (lsnet.py:221-222) classifying a batch of 64 at 224x224: SKA runs
# in every LSConv, at (H, W, C, wc, calls per forward); stage 3's odd
# blocks are attention, so 2 + 3 + 4 = 9 calls.
LSNET_B = ["--set", "model_kwargs.embed_dim=(128,256,384,512)",
           "--set", "model_kwargs.depth=(4,6,8,10)"]
LSNET_BATCH = 64
SKA_SHAPES = [(28, 28, 128, 16, 2), (14, 14, 256, 32, 3), (7, 7, 384, 48, 4)]
SKA_PER_FORWARD = sum(lv[-1] for lv in SKA_SHAPES)  # 9
# The three-kernel Restormer block (K4, K5 + K6, K3) instead of the pair.
THREE_KERNEL = ("model_kwargs.fused_block=False",
                "model_kwargs.fused_attn=True", "model_kwargs.fused_gdfn=True")
CSRC = "image_restoration_tpu_torch/kernels/csrc/"
KERNELS = {
    "block_front": (CSRC + "block_front.cu",
                    "image_restoration_tpu/kernels/block_pallas.py:80"),
    "block_apply_gdfn": (CSRC + "block_apply_gdfn.cu",
                         "image_restoration_tpu/kernels/block_pallas.py:223"),
    "ln_gdfn": (CSRC + "ln_gdfn.cu",
                "image_restoration_tpu/kernels/gdfn_pallas.py:68"),
    "ln_qkv_dwconv": (CSRC + "ln_qkv_dwconv.cu",
                      "image_restoration_tpu/kernels/mdta_pallas.py:29"),
    "attn_acc": (CSRC + "attn_core.cu",
                 "image_restoration_tpu/kernels/attn_core_pallas.py:41"),
    "attn_apply": (CSRC + "attn_core.cu",
                   "image_restoration_tpu/kernels/attn_core_pallas.py:67"),
    "drs_apply_msfn": (CSRC + "drs_apply_msfn.cu",
                       "image_restoration_tpu/kernels/drs_block_pallas.py:387"),
    "mefc_step": (CSRC + "mefc_step.cu",
                  "image_restoration_tpu/kernels/mefc_pallas.py:129"),
    "ska": (CSRC + "ska.cu", "image_restoration_tpu/kernels/ska_pallas.py:30"),
}
# The card's published peaks (NVIDIA H100 SXM data sheet), per ms.
HBM_BYTES_PER_MS = 3.35e9
BF16_TC_FLOP_PER_MS = 989e9
FP32_FLOP_PER_MS = 67e9


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def time_cuda(fn, reps=15, warmup=3, head_start_ms=2.0):
    """Median device ms of the GPU work ``fn`` enqueues, by CUDA events.

    The L2 cache is flushed before each rep, and a spin kernel holds the GPU
    for ``head_start_ms`` (at ~2 GHz) while the host enqueues ``fn``, so the
    events time the device work, not the host's launch gaps.
    """
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int(head_start_ms * 2e6))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_block(c, heads, seed):
    """A TransformerBlock's parameters on the GPU, from ``seed``: the
    module's own init, with LN affine and temperature perturbed so every
    term of the kernels is exercised."""
    import torch

    from image_restoration_tpu_torch.models.restormer import TransformerBlock

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        blk = TransformerBlock(c, heads)
    with torch.no_grad():
        for mod in (blk.norm1.body, blk.norm2.body):
            mod.weight.add_(0.2 * torch.randn(c, generator=gen))
            mod.bias.add_(0.2 * torch.randn(c, generator=gen))
        blk.attn.temperature.copy_(
            0.5 + torch.rand(heads, 1, 1, generator=gen))
    return blk.cuda().block_params()


def rel_err(got, oracle):
    scale = oracle.float().abs().max().item() + 1e-12
    return (got.float() - oracle.float()).abs().max().item() / scale


def _new_report(names):
    return {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by_ms": {"bytes": 0.0,
                                                    "operations": 0.0},
                   "per_shape": []} for name in names}


def _record(report, name, shape, n_calls, t_k, t_p, abs_err, bound,
            **extra):
    """One shape's numbers; ``bound`` = (ms, "bytes" or "operations") of
    one call. The per-forward bound is the sum of the calls' bounds."""
    r = report[name]
    r["per_shape"].append({"shape": shape, "calls": n_calls, "ms": t_k,
                           "plain_ms": t_p, "bound_ms": bound[0],
                           "bound_by": bound[1], **extra})
    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    r["ms"] += n_calls * t_k
    r["plain_ms"] += n_calls * t_p
    r["bound_ms"] += n_calls * bound[0]
    r["bound_by_ms"][bound[1]] += n_calls * bound[0]


def roofline(nbytes, tc_flops=0.0, fp32_flops=0.0):
    """(least ms, what bounds it) for work that moves ``nbytes`` of device
    memory and does ``tc_flops`` on bf16 tensor cores and ``fp32_flops``
    on the fp32 units. The two pipes run concurrently, so the operations'
    least time is the slower pipe's, not the sum."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = max(tc_flops / BF16_TC_FLOP_PER_MS, fp32_flops / FP32_FLOP_PER_MS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_block_front(h, w, c, heads):
    """K1: read x, write v (bf16), the fp32 Gram and sums of squares; the
    qkv 1x1 and q^T k on the tensor cores, the 3x3 depthwise in fp32."""
    n, ch = h * w, c // heads
    nbytes = 2 * n * c * 2 + 4 * (heads * ch * ch + 2 * c) \
        + 2 * 3 * c * c + 4 * (27 * c + 2 * c)
    return roofline(nbytes, 2 * n * c * 3 * c + 2 * n * c * ch,
                    2 * 9 * 3 * c * n)


def bound_block_apply_gdfn(h, w, c):
    """K2: read v and x, write out (bf16), A^T W_proj and the GDFN
    weights; v A^T W, the content|gate 1x1 and the out 1x1 on the tensor
    cores, the 3x3 depthwise over 2 hidden in fp32."""
    n, hid = h * w, int(c * 2.66)
    nbytes = 3 * 2 * n * c + 2 * c * c + 2 * 3 * hid * c + 4 * 18 * hid
    tc = 2 * n * c * c + 2 * n * c * 2 * hid + 2 * n * hid * c
    return roofline(nbytes, tc, 2 * 9 * 2 * hid * n)


def bound_ln_qkv_dwconv(h, w, c):
    """K4: read x, write the 3C-wide qkv map (bf16) and the weights; the
    qkv 1x1 on the tensor cores, the 3x3 depthwise over 3C in fp32."""
    n = h * w
    nbytes = 2 * n * c + 2 * n * 3 * c + 2 * 3 * c * c + 4 * (27 * c + 2 * c)
    return roofline(nbytes, 2 * n * c * 3 * c, 2 * 9 * 3 * c * n)


def bound_attn_acc(h, w, c, heads):
    """K5: read q and k (bf16), write the fp32 Gram and sums of squares;
    q^T k per head on the tensor cores, the squares in fp32."""
    n, ch = h * w, c // heads
    nbytes = 2 * 2 * n * c + 4 * (heads * ch * ch + 2 * c)
    return roofline(nbytes, 2 * n * c * ch, 2 * 2 * n * c)


def bound_attn_apply(h, w, c, heads):
    """K6: read v and x, write out (bf16), A^T per head and W_proj; v A^T
    per head and t W_proj on the tensor cores."""
    n, ch = h * w, c // heads
    nbytes = 3 * 2 * n * c + 2 * (heads * ch * ch + c * c)
    return roofline(nbytes, 2 * n * c * ch + 2 * n * c * c)


def bound_ln_gdfn(h, w, c):
    """K3: read x, write out (bf16), the GDFN weights; the content|gate 1x1
    and the out 1x1 on the tensor cores, the 3x3 depthwise over 2 hidden in
    fp32."""
    n, hid = h * w, int(c * 2.66)
    nbytes = 2 * 2 * n * c + 2 * 3 * hid * c + 4 * 18 * hid + 4 * 2 * c
    tc = 2 * n * c * 2 * hid + 2 * n * hid * c
    return roofline(nbytes, tc, 2 * 9 * 2 * hid * n)


def bound_drs_apply_msfn(h, w, c):
    """K7: as K2 with MSFN: project_in to 2H, the 3x3 and 5x5 banks over
    2H and the grouped 3x3 and 5x5 over H pairs in fp32, project_out."""
    n, hid = h * w, int(c * 2.66)
    nbytes = 3 * 2 * n * c + 2 * c * c + 2 * 4 * hid * c \
        + 4 * (2 * hid * 34 + 2 * hid * 34)
    tc = 2 * n * c * c + 2 * 2 * n * c * 2 * hid
    return roofline(nbytes, tc, 2 * n * (2 * hid * 34 + 2 * hid * 34))


def bound_mefc_step(h, w, c):
    """K8: read x, write out (bf16), the 8 folded C x C mix matrices and
    the 4 inner 1x1s; 12 C x C products per pixel on the tensor cores; the
    84 + 84 + 83 depthwise taps and the 9-tap pool per channel in fp32."""
    n = h * w
    nbytes = 2 * 2 * n * c + 2 * 12 * c * c + 4 * 251 * c
    return roofline(nbytes, 12 * 2 * n * c * c, 2 * n * c * 251 + 9 * n * c)


def bound_ska(b, h, w, c, wc, esize):
    """K9: read x and w, write out; 9 fp32 multiply-adds per output."""
    n = b * h * w
    return roofline(esize * (2 * n * c + n * wc * 9), 0.0, 2 * 9 * n * c)


def _bound(plain):
    return max(3.0 * plain, 4e-3)


def phase_kernels():
    import torch

    from image_restoration_tpu_torch.kernels import block as K

    report = _new_report(("block_front", "block_apply_gdfn"))
    for i, (h, w, c, heads, n_blocks) in enumerate(LEVELS):
        p = random_block(c, heads, seed=100 + i)
        gen = torch.Generator().manual_seed(200 + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda", torch.bfloat16)

        oracle = K.block_front_ref(x.float(), p, heads)
        plain = K.block_front_ref(x, p, heads)
        kern = K.block_front(x, p, heads)
        torch.cuda.synchronize()
        errs = []
        for name, o, pl, kn in zip(("v", "gram", "sumsq"), oracle, plain, kern):
            ek, ep = rel_err(kn, o), rel_err(pl, o)
            errs.append(f"{name} {ek:.3e} (plain {ep:.3e})")
            check(torch.isfinite(kn).all().item(), f"block_front {name} "
                  f"not finite at {h}x{w}x{c}")
            check(ek < _bound(ep), f"block_front {name} at {h}x{w}x{c}: "
                  f"rel err {ek:.3e} above max(3 x {ep:.3e}, 4e-3)")
        abs_front = (kern[0].float() - plain[0].float()).abs().max().item()
        t_k = time_cuda(lambda: K.block_front(x, p, heads))
        t_p = time_cuda(lambda: K.block_front_ref(x, p, heads))
        print(f"block_front {h}x{w}x{c} heads {heads}: rel err "
              f"{'; '.join(errs)}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms",
              flush=True)
        _record(report, "block_front", [1, h, w, c], n_blocks, t_k, t_p,
                abs_front, bound_block_front(h, w, c, heads))

        v, gram, ss = plain
        atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
        oracle2 = K.block_apply_gdfn_ref(v.float(), x.float(), atw.float(), p)
        plain2 = K.block_apply_gdfn_ref(v, x, atw, p)
        kern2 = K.block_apply_gdfn(v, x, atw, p)
        torch.cuda.synchronize()
        ek, ep = rel_err(kern2, oracle2), rel_err(plain2, oracle2)
        check(torch.isfinite(kern2).all().item(),
              f"block_apply_gdfn not finite at {h}x{w}x{c}")
        check(ek < _bound(ep), f"block_apply_gdfn at {h}x{w}x{c}: rel err "
              f"{ek:.3e} above max(3 x {ep:.3e}, 4e-3)")
        t_k = time_cuda(lambda: K.block_apply_gdfn(v, x, atw, p))
        t_p = time_cuda(lambda: K.block_apply_gdfn_ref(v, x, atw, p))
        print(f"block_apply_gdfn {h}x{w}x{c} heads {heads}: rel err "
              f"{ek:.3e} (plain {ep:.3e}); kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms", flush=True)
        _record(report, "block_apply_gdfn", [1, h, w, c], n_blocks, t_k, t_p,
                (kern2.float() - plain2.float()).abs().max().item(),
                bound_block_apply_gdfn(h, w, c))
    return report


def _check_rule(name, shape, kern, plain, oracle):
    """Phase 2's rule on one output; returns the message part."""
    ek, ep = rel_err(kern, oracle), rel_err(plain, oracle)
    check(kern.isfinite().all().item(), f"{name} not finite at {shape}")
    check(ek < _bound(ep), f"{name} at {shape}: rel err {ek:.3e} above "
          f"max(3 x {ep:.3e}, 4e-3)")
    return f"{ek:.3e} (plain {ep:.3e})"


def phase_3k_kernels():
    """K4, K5, K6 and K3 at the block shapes of Restormer-base, each on its
    plain version's inputs, against the plain version with the fp32 plain
    chain as the oracle."""
    import torch

    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KM

    report = _new_report(("ln_gdfn", "ln_qkv_dwconv", "attn_acc",
                          "attn_apply"))
    for i, (h, w, c, heads, n_blocks) in enumerate(LEVELS):
        p = random_block(c, heads, seed=100 + i)
        gen = torch.Generator().manual_seed(200 + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda", torch.bfloat16)
        shape = f"{h}x{w}x{c} heads {heads}"
        f = p.front()

        def run(name, kern_fn, plain_fn, oracle, bound, to_plain=None):
            """Phase 2's rule on each output; with ``to_plain``, also the
            kernel's relative error against its plain version on the same
            inputs must stay below it."""
            kern, plain = kern_fn(), plain_fn()
            torch.cuda.synchronize()
            kerns = kern if isinstance(kern, tuple) else (kern,)
            plains = plain if isinstance(plain, tuple) else (plain,)
            oracles = oracle if isinstance(oracle, tuple) else (oracle,)
            msg = "; ".join(_check_rule(name, shape, k, pl, o)
                            for k, pl, o in zip(kerns, plains, oracles))
            if to_plain is not None:
                errs = [rel_err(k, pl) for k, pl in zip(kerns, plains)]
                check(max(errs) < to_plain, f"{name} at {shape}: rel err "
                      f"{errs} against its plain version, above {to_plain}")
                msg += "; against plain " + ", ".join(f"{e:.3e}" for e in errs)
            t_k, t_p = time_cuda(kern_fn), time_cuda(plain_fn)
            print(f"{name} {shape}: rel err {msg}; kernel {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]})", flush=True)
            _record(report, name, [1, h, w, c], n_blocks, t_k, t_p,
                    (kerns[0].float() - plains[0].float()).abs().max().item(),
                    bound)
            return plains

        oqkv = KM.ln_qkv_dwconv_ref(x.float(), f)
        (qkv,) = run("ln_qkv_dwconv", lambda: KM.ln_qkv_dwconv(x, f),
                     lambda: KM.ln_qkv_dwconv_ref(x, f), oqkv,
                     bound_ln_qkv_dwconv(h, w, c))
        # K5 and its plain version widen the same bf16 map exactly, so both
        # errors against the oracle are the map's rounding; the kernel is
        # also held to its plain version: fp32 sums in another order.
        gram, ss = run("attn_acc", lambda: KA.attn_acc(qkv, heads),
                       lambda: KA.attn_acc_ref(qkv, heads),
                       KA.attn_acc_ref(oqkv, heads),
                       bound_attn_acc(h, w, c, heads), to_plain=1e-5)
        at = KA.finalize_at(gram, ss, p.temperature, torch.bfloat16)
        oracle = KA.attn_apply_ref(qkv.float(), x.float(), at.float(),
                                   p.proj_w, p.proj_b)
        del oqkv
        (x2,) = run("attn_apply",
                    lambda: KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b),
                    lambda: KA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b),
                    oracle, bound_attn_apply(h, w, c, heads))
        g = p.gdfn()
        run("ln_gdfn", lambda: KG.fused_ln_gdfn(x2, g),
            lambda: KG.ln_gdfn_ref(x2, g), KG.ln_gdfn_ref(x2.float(), g),
            bound_ln_gdfn(h, w, c))
    return report


def random_drs_block(c, heads, seed):
    """A DRSformer TransformerBlock's parameters on the GPU, from ``seed``:
    the module's own init, with LN affines, temperature and attn1..4
    perturbed so every term of the kernels is exercised."""
    import torch

    from image_restoration_tpu_torch.models.drsformer import TransformerBlock

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        blk = TransformerBlock(c, heads)
    with torch.no_grad():
        for mod in (blk.norm1.body, blk.norm2.body):
            mod.weight.add_(0.2 * torch.randn(c, generator=gen))
            mod.bias.add_(0.2 * torch.randn(c, generator=gen))
        blk.attn.temperature.copy_(0.5 + torch.rand(heads, 1, 1, generator=gen))
        for i in range(4):
            getattr(blk.attn, f"attn{i + 1}").add_(
                0.1 * torch.randn(1, generator=gen))
    return blk.cuda().block_params()


def random_mefc_steps(c, n_steps, seed):
    """``n_steps`` MEFC steps' parameters on the GPU (the module's own init,
    from ``seed``) and their (1, n_steps, 8) bf16 mix weights."""
    import torch

    from image_restoration_tpu_torch.models.drsformer import OperationLayer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        steps = [OperationLayer(c).cuda().step_params() for _ in range(n_steps)]
        logits = torch.randn(1, n_steps, 8)
    return steps, torch.softmax(logits, -1).to("cuda", torch.bfloat16)


def phase_drs_kernels():
    import torch

    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as K
    from image_restoration_tpu_torch.kernels import mefc as M

    report = _new_report(("drs_apply_msfn", "mefc_step"))
    for i, (h, w, c, heads, n_blocks) in enumerate(DRS_LEVELS):
        p = random_drs_block(c, heads, seed=300 + i)
        gen = torch.Generator().manual_seed(400 + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda", torch.bfloat16)
        v, gram, ss = KB.block_front_ref(x, p.front(), heads)
        atw = K.tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w,
                              torch.bfloat16)
        oracle = K.drs_apply_msfn_ref(v.float(), x.float(), atw.float(), p)
        plain = K.drs_apply_msfn_ref(v, x, atw, p)
        kern = K.drs_apply_msfn(v, x, atw, p)
        torch.cuda.synchronize()
        ek, ep = rel_err(kern, oracle), rel_err(plain, oracle)
        check(torch.isfinite(kern).all().item(),
              f"drs_apply_msfn not finite at {h}x{w}x{c}")
        check(ek < _bound(ep), f"drs_apply_msfn at {h}x{w}x{c}: rel err "
              f"{ek:.3e} above max(3 x {ep:.3e}, 4e-3)")
        del oracle
        t_k = time_cuda(lambda: K.drs_apply_msfn(v, x, atw, p))
        t_p = time_cuda(lambda: K.drs_apply_msfn_ref(v, x, atw, p))
        print(f"drs_apply_msfn {h}x{w}x{c} heads {heads}: rel err {ek:.3e} "
              f"(plain {ep:.3e}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms",
              flush=True)
        _record(report, "drs_apply_msfn", [1, h, w, c], n_blocks, t_k, t_p,
                (kern.float() - plain.float()).abs().max().item(),
                bound_drs_apply_msfn(h, w, c))

    for i, (h, w, c, n_steps) in enumerate(MEFC_STEPS):
        steps, mix = random_mefc_steps(c, n_steps, seed=500 + i)
        gen = torch.Generator().manual_seed(600 + i)
        x = torch.randn((1, h, w, c), generator=gen).abs()
        x = x.to("cuda", torch.bfloat16)
        errs, t_ks, t_ps, abs_err = [], [], [], 0.0
        for st, sp in enumerate(steps):  # each step on the plain chain's input
            m = M.fold_step(sp, mix[:, st], torch.bfloat16)
            oracle = M.mefc_step_ref(
                x.float(), sp, M.fold_step(sp, mix[:, st], torch.float32))
            plain = M.mefc_step_ref(x, sp, m)
            kern = M.mefc_step(x, sp, m)
            torch.cuda.synchronize()
            ek, ep = rel_err(kern, oracle), rel_err(plain, oracle)
            check(torch.isfinite(kern).all().item(),
                  f"mefc_step not finite at {h}x{w}x{c} step {st}")
            check(ek < _bound(ep), f"mefc_step at {h}x{w}x{c} step {st}: rel "
                  f"err {ek:.3e} above max(3 x {ep:.3e}, 4e-3)")
            errs.append(f"{ek:.3e} (plain {ep:.3e})")
            abs_err = max(abs_err,
                          (kern.float() - plain.float()).abs().max().item())
            t_ks.append(time_cuda(lambda: M.mefc_step(x, sp, m)))
            t_ps.append(time_cuda(lambda: M.mefc_step_ref(x, sp, m)))
            x = plain
        t_k, t_p = statistics.median(t_ks), statistics.median(t_ps)
        print(f"mefc_step {h}x{w}x{c}, {n_steps} steps: rel err "
              f"{'; '.join(errs)}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms "
              f"(median over the steps)", flush=True)
        _record(report, "mefc_step", [1, h, w, c], n_steps, t_k, t_p, abs_err,
                bound_mefc_step(h, w, c))
    return report


def _profile(fn, inputs, profile_dir, tag, gpu, what):
    """torch.profiler over ``fn`` on the first two ``inputs``: device busy
    time per input against the host clock, a table and a trace."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in inputs[:2]:
            fn(a)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 2
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               ) / 2e3  # us -> ms per input
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(os.path.join(profile_dir, f"{tag}_profile_2.txt"), "w") as f:
        f.write(f"{gpu}\n{table}\n")
    prof.export_chrome_trace(os.path.join(profile_dir, f"{tag}_trace_2.json"))
    print(f"{tag}: profile of 2 {what}: device busy {busy:.3f} ms per one of "
          f"{wall:.3f} ms (host clock, under the profiler), "
          f"{100 * (1 - busy / wall):.2f}% idle; table and trace in "
          f"{profile_dir}", flush=True)


def perturb_adair(model, seed):
    """Seeded, non-trivial ``para1`` and ``para2`` in every FreModule: the
    init's zero ``para1`` makes a FreModule return its input, so nothing it
    computes would reach the output."""
    import torch

    from image_restoration_tpu_torch.models.adair import FreModule

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FreModule):
                for p in (m.para1, m.para2):
                    p.copy_(0.5 * torch.randn(p.shape, generator=gen))


def phase_slice(gpu, profile_dir, model_name, counters, expected,
                overrides=(), tag=None, perturb=None):
    """Serve ``model_name`` from ``build_model`` with its serving defaults
    and the ``--set`` ``overrides`` (its seeded weights passed through
    ``perturb`` first, if given): three restores with the ``counters``
    (name -> wrapper) set to 0 just before and read just after, each
    expected to count ``expected[name]`` per forward; then the agreement
    with the plain fp32 model (every kernel flag off) and the timings,
    printed under ``tag``. Returns the launch counts."""
    import torch

    from image_restoration_tpu_torch.cli.infer import make_restore_fn
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.utils.options import parse_options

    tag = tag or model_name
    sets = [a for kv in overrides for a in ("--set", kv)]
    cfg = parse_options(["--model", model_name, "--device", "cuda",
                         "--seed", "0"] + sets)
    mk = cfg["model_kwargs"]
    check(cfg["bf16"] and (mk.get("fused_block") or (
        mk.get("fused_attn") and mk.get("fused_gdfn"))),
          f"{tag}: not bf16 with fused blocks or the three-kernel block")
    model = load_params(cfg, build_model(cfg))
    if perturb is not None:
        perturb(model)
    restore = make_restore_fn(cfg, model)
    rng = np.random.default_rng(0)
    images = [rng.random((512, 512, 3), dtype=np.float32),
              rng.random((512, 512, 3), dtype=np.float32),
              rng.random((500, 376, 3), dtype=np.float32)]
    restore(images[0])  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    for fn in counters.values():
        fn.launches = 0
    outs = [restore(img) for img in images]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"{tag} serving: {len(images)} images, launches {launches}",
          flush=True)
    for img, out in zip(images, outs):
        check(out.shape == img.shape, f"output {out.shape} for {img.shape}")
        check(np.isfinite(out).all(), "non-finite restored image")
    for name, n in launches.items():
        check(n == len(images) * expected[name],
              f"{tag} {name}: {n} launches for {len(images)} forwards,"
              f" expected {expected[name]} each")

    # agreement: fused bf16 vs plain fp32 (oracle), against plain bf16
    x = torch.from_numpy(images[0]).permute(2, 0, 1)[None].cuda()
    sd = model.state_dict()

    def variant(bf16):
        plain = {k: False for k in ("fused_block", "fused_attn", "fused_gdfn")
                 if k in mk}
        c2 = dict(cfg, bf16=bf16, model_kwargs=dict(mk, **plain))
        m = build_model(c2)
        m.load_state_dict(sd)
        return m

    with torch.inference_mode():
        out_fused = model(x)
        out_ref = variant(False)(x)
        out_plain = variant(True)(x)
    err_fused = (out_fused - out_ref).abs().max().item()
    err_plain = (out_plain - out_ref).abs().max().item()
    del out_ref, out_plain
    print(f"{tag} serving: max |fused bf16 - plain fp32| "
          f"{err_fused:.4e}, max |plain bf16 - plain fp32| {err_plain:.4e}",
          flush=True)
    check(np.isfinite(err_fused) and err_fused <= 3.0 * err_plain,
          f"{tag}: fused model error {err_fused:.4e} above 3 x "
          f"{err_plain:.4e}")

    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(images[0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: model(x), reps=10, head_start_ms=150.0)
    print(f"{tag} serving 512x512 bf16 batch 1 on {gpu}: {ms:.3f} "
          f"ms/img (restore, host clock, median of 10; min {min(times):.3f}, "
          f"max {max(times):.3f}), {0.262144 / (ms / 1e3):.4f} MP/s; forward "
          f"{fwd_ms:.3f} ms (device, CUDA events)", flush=True)
    if profile_dir:
        _profile(restore, images, profile_dir, tag, gpu,
                 "restores at 512x512")
    return launches


def phase_ska_kernels():
    """K9 against ska_plain at LSNet-B's shapes, bf16 and fp32."""
    import torch

    from image_restoration_tpu_torch.kernels import ska as K
    from image_restoration_tpu_torch.ops.ska import ska_plain

    report = _new_report(("ska",))
    b = LSNET_BATCH
    for i, (h, w, c, wc, calls) in enumerate(SKA_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(800 + i)
        x = torch.randn((b, h, w, c), generator=gen, device="cuda")
        wt = torch.randn((b, h, w, wc, 9), generator=gen, device="cuda")
        xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
        oracle = ska_plain(x, wt)
        kern32 = K.ska(x, wt)
        plain = ska_plain(xb, wb)
        kern = K.ska(xb, wb)
        torch.cuda.synchronize()
        e32 = rel_err(kern32, oracle)
        ek, ep = rel_err(kern, oracle), rel_err(plain, oracle)
        check(torch.isfinite(kern).all().item(),
              f"ska not finite at {h}x{w}x{c}")
        check(e32 <= 1e-5,
              f"ska fp32 at {h}x{w}x{c}: rel err {e32:.3e} above 1e-5")
        check(ek < _bound(ep), f"ska at {h}x{w}x{c}: rel err {ek:.3e} above "
              f"max(3 x {ep:.3e}, 4e-3)")
        t_k = time_cuda(lambda: K.ska(xb, wb))
        t_p = time_cuda(lambda: ska_plain(xb, wb))
        t_k32 = time_cuda(lambda: K.ska(x, wt))
        t_p32 = time_cuda(lambda: ska_plain(x, wt))
        bound = bound_ska(b, h, w, c, wc, 2)
        bound32 = bound_ska(b, h, w, c, wc, 4)
        print(f"ska {b}x{h}x{w}x{c} wc {wc}: bf16 rel err {ek:.3e} (plain "
              f"{ep:.3e}), kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}); fp32 rel err {e32:.3e}, "
              f"kernel {t_k32:.4f} ms, plain {t_p32:.4f} ms, bound "
              f"{bound32[0]:.4f} ms", flush=True)
        _record(report, "ska", [b, h, w, c, wc], calls, t_k, t_p,
                (kern.float() - plain.float()).abs().max().item(), bound,
                fp32_ms=t_k32, fp32_plain_ms=t_p32, fp32_bound_ms=bound32[0],
                fp32_max_rel_err=e32)
    return report


def perturb_lsnet(model, seed):
    """Seeded, non-trivial BatchNorm statistics and affines and LeViT
    attention biases, so no BN is the identity and every bias counts."""
    import torch
    from torch import nn

    from image_restoration_tpu_torch.models.lsnet import LeViTAttention

    gen = torch.Generator().manual_seed(seed)

    def randn(like):
        return torch.randn(like.shape, generator=gen).to(like.device)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.1 * randn(m.running_mean))
                m.running_var.copy_(0.5 + randn(m.running_var).abs())
                m.weight.add_(0.1 * randn(m.weight))
                m.bias.add_(0.1 * randn(m.bias))
            elif isinstance(m, LeViTAttention):
                m.attention_biases.copy_(0.2 * randn(m.attention_biases))


def phase_lsnet(gpu, profile_dir):
    """LSNet-B classification serving through ``batch_hits``: three batches
    with the SKA count set to 0 just before and read just after, then the
    agreement with the plain fp32 model and the timings."""
    import torch

    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.eval.robustness import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        batch_hits,
    )
    from image_restoration_tpu_torch.kernels import ska as KS
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(["--model", "lsnet", "--device", "cuda", "--seed",
                         "0"] + LSNET_B)
    check(cfg["bf16"] and cfg["model_kwargs"]["use_pallas_ska"],
          "lsnet serving defaults are not bf16 + the SKA kernel")
    model = load_params(cfg, build_model(cfg))
    perturb_lsnet(model, seed=700)
    n_params = sum(p.numel() for p in model.parameters())
    b = LSNET_BATCH
    gen = torch.Generator(device="cuda").manual_seed(0)
    mean = torch.from_numpy(IMAGENET_MEAN).cuda()
    std = torch.from_numpy(IMAGENET_STD).cuda()
    batches = [((torch.rand((b, 224, 224, 3), generator=gen, device="cuda")
                 - mean) / std,
                torch.randint(0, 1000, (b,), generator=gen, device="cuda"))
               for _ in range(3)]
    batch_hits(model, *batches[0])  # warm-up: cuDNN algorithm choice
    torch.cuda.synchronize()

    KS.ska.launches = 0
    hits = [batch_hits(model, im, lb) for im, lb in batches]
    torch.cuda.synchronize()
    launches = {"ska": KS.ska.launches}
    print(f"lsnet serving: LSNet-B ({n_params} parameters), {len(batches)} "
          f"batches of {b} at 224x224, launches {launches}, top-1 hits "
          f"{[int(t1.sum()) for t1, _ in hits]}", flush=True)
    check(launches["ska"] == len(batches) * SKA_PER_FORWARD,
          f"lsnet ska: {launches['ska']} launches for {len(batches)} "
          f"forwards, expected {SKA_PER_FORWARD} each")

    # agreement: kernel bf16 vs plain fp32 (oracle), against plain bf16
    sd = model.state_dict()

    def variant(bf16):
        c2 = dict(cfg, bf16=bf16,
                  model_kwargs=dict(cfg["model_kwargs"], use_pallas_ska=False))
        m = build_model(c2)
        m.load_state_dict(sd)
        return m

    ref, plain16 = variant(False), variant(True)
    err_k = err_p = 0.0
    agree = agree_p = 0
    with torch.inference_mode():
        for im, _ in batches:
            x = im.permute(0, 3, 1, 2)
            lk, lr, lp = model(x), ref(x), plain16(x)
            check(torch.isfinite(lk).all().item() and lk.shape == (b, 1000),
                  f"lsnet logits {tuple(lk.shape)} not finite")
            err_k = max(err_k, (lk - lr).abs().max().item())
            err_p = max(err_p, (lp - lr).abs().max().item())
            agree += int((lk.argmax(-1) == lr.argmax(-1)).sum())
            agree_p += int((lp.argmax(-1) == lr.argmax(-1)).sum())
        scale = ref(batches[0][0].permute(0, 3, 1, 2)).abs().max().item()
    del ref, plain16
    n = b * len(batches)
    print(f"lsnet serving: max |kernel bf16 - plain fp32| logit {err_k:.4e}, "
          f"max |plain bf16 - plain fp32| {err_p:.4e} (fp32 logits up to "
          f"{scale:.3f}); top-1 agreement with the fp32 model: kernel bf16 "
          f"{agree}/{n}, plain bf16 {agree_p}/{n}", flush=True)
    check(np.isfinite(err_k) and err_k <= 3.0 * err_p,
          f"lsnet: kernel model error {err_k:.4e} above 3 x {err_p:.4e}")

    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_hits(model, *batches[0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    x0 = batches[0][0].permute(0, 3, 1, 2)
    with torch.inference_mode():
        fwd_ms = time_cuda(lambda: model(x0), reps=10, head_start_ms=50.0)
    print(f"lsnet serving LSNet-B 224x224 bf16 batch {b} on {gpu}: {ms:.3f} "
          f"ms/batch (batch_hits, host clock, median of 10; min "
          f"{min(times):.3f}, max {max(times):.3f}), {b / (ms / 1e3):.1f} "
          f"images/s; forward {fwd_ms:.3f} ms (device, CUDA events)",
          flush=True)
    if profile_dir:
        _profile(lambda a: batch_hits(model, *a), batches, profile_dir,
                 "lsnet", gpu, f"batches of {b} at 224x224")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables and traces of "
                         "two forwards per model")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from image_restoration_tpu_torch.kernels.build import load_library
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KQ
    from image_restoration_tpu_torch.kernels import mefc as KM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = gpu_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} ({gpu}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    lib = load_library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.2f} s", flush=True)
    for line in lib.compiler_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    report = phase_kernels()
    report.update(phase_drs_kernels())
    report.update(phase_ska_kernels())
    report.update(phase_3k_kernels())
    by_path = {
        "restormer": phase_slice(
            gpu, args.profile, "restormer",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": BLOCKS_PER_FORWARD,
             "block_apply_gdfn": BLOCKS_PER_FORWARD}),
        "drsformer": phase_slice(
            gpu, args.profile, "drsformer",
            {"block_front": KB.block_front,
             "drs_apply_msfn": KD.drs_apply_msfn,
             "mefc_step": KM.mefc_step},
            {"block_front": DRS_BLOCKS_PER_FORWARD,
             "drs_apply_msfn": DRS_BLOCKS_PER_FORWARD,
             "mefc_step": MEFC_STEPS_PER_FORWARD}),
        "lsnet": phase_lsnet(gpu, args.profile),
        "restormer_3k": phase_slice(
            gpu, args.profile, "restormer",
            {"ln_qkv_dwconv": KQ.ln_qkv_dwconv, "attn_acc": KA.attn_acc,
             "attn_apply": KA.attn_apply, "ln_gdfn": KG.fused_ln_gdfn},
            dict.fromkeys(("ln_qkv_dwconv", "attn_acc", "attn_apply",
                           "ln_gdfn"), BLOCKS_PER_FORWARD),
            overrides=THREE_KERNEL, tag="restormer_3k"),
        "adair": phase_slice(
            gpu, args.profile, "adair",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": BLOCKS_PER_FORWARD,
             "block_apply_gdfn": BLOCKS_PER_FORWARD},
            perturb=lambda m: perturb_adair(m, seed=800)),
    }
    ms_is = {"block_front": "sum over the 44 blocks of one Restormer-base "
                            "512x512 forward of per-call CUDA-event medians",
             "block_apply_gdfn": "the same, 44 blocks",
             "ln_gdfn": "the same, 44 blocks of the three-kernel variant",
             "ln_qkv_dwconv": "the same, 44 blocks of the three-kernel "
                              "variant",
             "attn_acc": "the same, 44 blocks of the three-kernel variant",
             "attn_apply": "the same, 44 blocks of the three-kernel variant",
             "drs_apply_msfn": "sum over the 40 blocks of one DRSformer "
                               "512x512 forward of per-call CUDA-event medians",
             "mefc_step": "sum over the 8 steps of one DRSformer 512x512 "
                          "forward of per-shape medians of per-call "
                          "CUDA-event medians",
             "ska": "sum over the 9 calls of one LSNet-B forward of a batch "
                    "of 64 at 224x224 of per-call CUDA-event medians, bf16"}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = report[name]
        per_path = {path: n[name] for path, n in by_path.items() if name in n}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(per_path.values()),
                        "launches_by_path": per_path,
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": max(r["bound_by_ms"],
                                        key=r["bound_by_ms"].get),
                        "library_ms": None,
                        "ms_is": ms_is[name], "per_shape": r["per_shape"]})
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
