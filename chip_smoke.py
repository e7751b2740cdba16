#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (image_restoration_tpu_torch).

Run from the root of the repository on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --tail [ROWS ...] [--warps 8|16]
    python3 chip_smoke.py --front [ROWS ...] [--warps 8|16]
    python3 chip_smoke.py --msfn [ROWS ...] [--warps 8|16]
    python3 chip_smoke.py --mefc [ROWS ...]
    python3 chip_smoke.py --attn [PIX ...] [--warps 4|8] [--cols N]
                                 [--groups N] [--ring 2|3] [--walk N]
    python3 chip_smoke.py --ska [TH ...] [--ring 1|2] [--split 1|2|4|8]

The second form checks and times only the two kernels that share the GDFN
tail (K2, K3), at the wrappers' tile height and warps or at those given: the
sweep behind ``kernels/block.py`` ``_APPLY_TILE_ROWS`` and ``_APPLY_WARPS``.
The third does the same for the two kernels that share the block front (K1,
K4; ``_FRONT_TILE_ROWS``/``_FRONT_WARPS`` in ``kernels/block.py``,
``_QKV_TILE_ROWS``/``_QKV_WARPS`` in ``kernels/mdta.py``). The fourth does
it for DRSformer's MSFN pass (K7) at the five block shapes of phase 2b
(``_MSFN_TILE_ROWS``/``_MSFN_WARPS`` in ``kernels/drs_block.py``). The
fifth does it for the MEFC step (K8, 16 warps a block) at its two shapes,
with a batch of two at both and the wrapper's weight packing timed apart
(``_MEFC_TILE_ROWS`` in ``kernels/mefc.py``). The sixth does it for the
attention core (K5, K6) at the five block shapes: phase 2d's rule (K5 also
1e-5 of its plain version), two bit-equal runs of both, a batch of two at
64x64 x 384 whose images differ, and their times, at the wrappers' pixels a
tile or at each of PIX, with K6's warps a block, output columns a warp and
column groups and K5's tile slots and fewest tiles a block walks as given; K6's weight packing and the host time
of a wrapper call are timed apart (the sweep behind ``kernels/attn_core.py``
``_ACC_*`` and ``_APPLY_*``). The seventh does it for the SKA dynamic
conv (K9) at LSNet-B's three shapes at batch 64, bf16 and fp32: phase 2c's
rules, two bit-equal runs of both and their times, at the wrapper's rows a
strip or at each of TH, with strip slots and the threads that share a
unit's channel repeats as given; the plain versions, the
timer's floor (a one-value ``zero_``), copies of x and w, and the host
time of a wrapper call and of its parts are timed apart (the sweep behind
``kernels/ska.py`` ``_SKA_*``). With no option it touches no table, so
copied into an older tree it times that tree's K9. None of them prints a
result line.

Phases, any failure ends the run with a nonzero exit code:
1. device and build: the card's name and power limit; the CUDA kernels are
   built from ``image_restoration_tpu_torch/kernels/csrc`` (timed);
2. kernels vs plain versions: both passes of the Restormer block kernel (K1,
   K2) at every block shape of Restormer-base serving a 512x512 image, in
   bf16, against their plain PyTorch versions, with the fp32 plain version
   as the oracle. The kernel passes if its max relative error is below
   max(3 x the plain bf16 version's, 4e-3). K1 and K2 must also give the
   same bits on a second run, and hold the rule on a batch of two at 64x64
   x 384.
   Times are CUDA-event medians;
2b. the same for DRSformer's kernels: the MSFN pass (K7) at the five block
   shapes of DRSformer serving a 512x512 image, with K1's two extra checks,
   and the MEFC step (K8) at 512x512 x 48 and x 96, four steps each, with
   two bit-equal runs of every step and, at x 96, a batch of two whose
   images have different mix weights;
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
3c. LSNet-B classification serving: ``build_model`` from ``cli/robust.py``'s
   options with ``--bf16`` given (the CLI itself classifies in fp32; this
   phase times bf16), the SKA kernel, seeded random weights and BatchNorm
   statistics; it scores three seeded
   normalised batches of 64 at 224x224 through ``eval/robustness.py``
   ``batch_hits``. Each forward must launch 9 SKA kernels, the logits must
   be finite, and the kernel model's max |logit error| against the plain
   fp32 model must stay within 3x the plain bf16 model's; top-1 agreement,
   images/s and forward ms follow;
2d. the three-kernel Restormer block's kernels at the five block shapes of
   phase 2, in bf16, by phase 2's rule and timing: LN + qkv + depthwise
   (K4, with K1's two extra checks), the attention accumulation (K5,
   against its plain version on the fp32 oracle's q and k, and also held to
   its plain version on the same bf16 map at 1e-5 relative), the attention
   apply (K6), both with K1's two extra checks (the batch of two with A^T's
   heads reversed in its second image), and LN + GDFN (K3, with K2's two
   extra checks);
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
import contextlib
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
        check_twice_and_batch2(
            "block_front", f"{h}x{w}x{c}", lambda: K.block_front(x, p, heads),
            kern, _batch2(K.block_front, K.block_front_ref, (x,), p, heads)
            if c == 384 else None)
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
        check_twice_and_batch2(
            "block_apply_gdfn", f"{h}x{w}x{c}",
            lambda: K.block_apply_gdfn(v, x, atw, p), kern2,
            _batch2(K.block_apply_gdfn, K.block_apply_gdfn_ref, (v, x, atw), p)
            if c == 384 else None)
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


def _batch2(kern_fn, plain_fn, tensors, *rest):
    """(kernel, plain, oracle) calls on a batch of two: each of ``tensors``
    stacked with its flip along dim 1."""
    import torch

    two = [torch.cat([t, t.flip(1)]) for t in tensors]
    return (lambda: kern_fn(*two, *rest), lambda: plain_fn(*two, *rest),
            lambda: plain_fn(*(t.float() for t in two), *rest))


def _outputs(r):
    return r if isinstance(r, tuple) else (r,)


def check_twice_and_batch2(name, shape, kern_fn, first, batch2=None):
    """The extra checks of K1-K4: a second run gives ``first``'s bits (no
    block order or atomics in the result); ``batch2`` = (kernel call, plain
    call, oracle call) on a batch of two must hold phase 2's rule. Outputs
    may be tensors or tuples of them."""
    import torch

    again = kern_fn()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(_outputs(first),
                                                _outputs(again))),
          f"{name} at {shape}: two runs differ")
    if batch2 is not None:
        kern, plain, oracle = (fn() for fn in batch2)
        torch.cuda.synchronize()
        msg = "; ".join(_check_rule(name, f"{shape} batch 2", k, p, o)
                        for k, p, o in zip(_outputs(kern), _outputs(plain),
                                           _outputs(oracle)))
        print(f"{name} {shape} batch 2: rel err {msg}", flush=True)


def _sweep_calls(group, x, p, heads, c):
    """name -> (kernel call, plain call, oracle call, batch-2 calls, module,
    tile-row table, warps table, warps of c, shared memory of a tile height)
    for the kernels of ``group``: "tail" (K2, K3), "front" (K1, K4) or
    "msfn" (K7; ``p`` a DRSformer block's)."""
    import torch

    from image_restoration_tpu_torch.kernels import block as K
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KM
    from image_restoration_tpu_torch.kernels.build import load_library

    lib = load_library().lib
    if group == "msfn":
        v, gram, ss = K.block_front_ref(x, p.front(), heads)
        atw = KD.tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w,
                               torch.bfloat16)
        return {"drs_apply_msfn": (
            lambda: KD.drs_apply_msfn(v, x, atw, p),
            lambda: KD.drs_apply_msfn_ref(v, x, atw, p),
            lambda: KD.drs_apply_msfn_ref(v.float(), x.float(), atw.float(),
                                          p),
            _batch2(KD.drs_apply_msfn, KD.drs_apply_msfn_ref, (v, x, atw), p),
            KD, "_MSFN_TILE_ROWS", "_MSFN_WARPS", lambda: KD._msfn_warps(c),
            lambda th: KD._msfn_smem(c, p.s3_w.shape[0], th,
                                     KD._msfn_warps(c)))}
    if group == "front":
        f = p.front()
        return {
            "block_front": (
                lambda: K.block_front(x, f, heads),
                lambda: K.block_front_ref(x, f, heads),
                lambda: K.block_front_ref(x.float(), f, heads),
                _batch2(K.block_front, K.block_front_ref, (x,), f, heads),
                K, "_FRONT_TILE_ROWS", "_FRONT_WARPS",
                lambda: K._front_warps(c),
                lambda th: lib.ir_block_front_smem(c, heads, th,
                                                   K._front_warps(c))),
            "ln_qkv_dwconv": (
                lambda: KM.ln_qkv_dwconv(x, f),
                lambda: KM.ln_qkv_dwconv_ref(x, f),
                lambda: KM.ln_qkv_dwconv_ref(x.float(), f),
                _batch2(KM.ln_qkv_dwconv, KM.ln_qkv_dwconv_ref, (x,), f),
                KM, "_QKV_TILE_ROWS", "_QKV_WARPS",
                lambda: KM._qkv_warps(c),
                lambda th: lib.ir_ln_qkv_dwconv_smem(c, th, KM._qkv_warps(c))),
        }
    v, gram, ss = K.block_front_ref(x, p, heads)
    atw = K.finalize(gram, ss, p.temperature, p.proj_w, torch.bfloat16)
    g = p.gdfn()
    return {
        "block_apply_gdfn": (
            lambda: K.block_apply_gdfn(v, x, atw, p),
            lambda: K.block_apply_gdfn_ref(v, x, atw, p),
            lambda: K.block_apply_gdfn_ref(v.float(), x.float(), atw.float(),
                                           p),
            _batch2(K.block_apply_gdfn, K.block_apply_gdfn_ref, (v, x, atw),
                    p),
            K, "_APPLY_TILE_ROWS", "_APPLY_WARPS", lambda: K._apply_warps(c),
            lambda th: lib.ir_block_apply_gdfn_smem(c, th, K._apply_warps(c))),
        "ln_gdfn": (
            lambda: KG.fused_ln_gdfn(x, g),
            lambda: KG.ln_gdfn_ref(x, g),
            lambda: KG.ln_gdfn_ref(x.float(), g),
            _batch2(KG.fused_ln_gdfn, KG.ln_gdfn_ref, (x,), g),
            K, "_APPLY_TILE_ROWS", "_APPLY_WARPS", lambda: K._apply_warps(c),
            lambda th: lib.ir_ln_gdfn_smem(c, th, K._apply_warps(c))),
    }


@contextlib.contextmanager
def _kept(c, *tables):
    """Puts back each launch table's entry for width ``c`` (or its absence)
    when the sweep that changes them ends."""
    saved = [t.get(c) for t in tables]
    try:
        yield
    finally:
        for t, v in zip(tables, saved):
            if v is None:
                t.pop(c, None)
            else:
                t[c] = v


def _try_rows(label, table, c, th, smem_of, limit):
    """Sets ``table[c] = th`` when a block of ``th`` rows fits the card's
    shared memory, else says so and returns False; ``th`` None keeps the
    wrapper's own choice."""
    if th is None:
        return True
    if smem_of(th) > limit:
        print(f"{label}: does not fit", flush=True)
        return False
    table[c] = th
    return True


def phase_sweep(group, rows, warps=None):
    """The kernels of ``group`` alone (``--tail``: K2 and K3, which share
    the GDFN tail; ``--front``: K1 and K4, which share the block front;
    ``--msfn``: K7 at DRSformer's shapes): phase 2's rule, two equal runs,
    a batch of two at 64x64 x 384, and the kernel's and plain version's
    times at the five block shapes, once per tile height in ``rows`` that
    fits the card (none given: the wrappers' own choice), in blocks of
    ``warps`` warps (None: the wrappers' own choice)."""
    import torch

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    drs = group == "msfn"
    levels = DRS_LEVELS if drs else LEVELS
    sums = {}
    for i, (h, w, c, heads, n_blocks) in enumerate(levels):
        p = (random_drs_block(c, heads, seed=300 + i) if drs
             else random_block(c, heads, seed=100 + i))
        gen = torch.Generator().manual_seed((400 if drs else 200) + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda", torch.bfloat16)
        for name, (kern_fn, plain_fn, oracle_fn, batch2, mod, rows_table,
                   warps_table, warps_of, smem_of) in _sweep_calls(
                       group, x, p, heads, c).items():
            wtable, table = getattr(mod, warps_table), getattr(mod, rows_table)
            with _kept(c, table, wtable):
                if warps is not None:
                    wtable[c] = warps
                plain, oracle = plain_fn(), oracle_fn()
                t_p = time_cuda(plain_fn)
                for th in rows or [None]:
                    where = f"{h}x{w}x{c} th {th or 'own'}"
                    if not _try_rows(f"{group} {name} {where}", table, c, th,
                                     smem_of, limit):
                        continue
                    kern = kern_fn()
                    torch.cuda.synchronize()
                    msg = "; ".join(
                        _check_rule(name, where, k, pl, o) for k, pl, o in
                        zip(_outputs(kern), _outputs(plain), _outputs(oracle)))
                    check_twice_and_batch2(name, where, kern_fn, kern,
                                           batch2 if c == 384 else None)
                    t_k = time_cuda(kern_fn)
                    detail = (f" ({warps_of()} warps, {smem_of(th)} B shared)"
                              if th is not None else "")
                    print(f"{group} {name} {where}{detail}: rel err {msg}; "
                          f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms",
                          flush=True)
                    sums.setdefault((name, th or "own"), []).append(
                        (n_blocks * t_k, n_blocks * t_p))
                    del kern
                del plain, oracle
    for (name, th), parts in sums.items():
        if len(parts) == len(levels):
            print(f"{group} {name} th {th}: {sum(k for k, _ in parts):.3f} "
                  f"ms per forward ({sum(lv[-1] for lv in levels)} blocks), "
                  f"plain "
                  f"{sum(p for _, p in parts):.3f}", flush=True)


def check_attn_twice_and_batch2(shape, qkv, x, at, p, heads, batch2):
    """K5's and K6's extra checks (phase 2d, ``--attn``): two runs give
    the same bits; with ``batch2``, a batch of two (each input stacked with
    its flip along H, and A^T with its heads reversed, so the two images
    differ) holds phase 2's rule, K5 at 1e-5 of its plain version (which
    widens the same bf16 map exactly, so the rule's oracle is the plain
    version itself)."""
    import torch

    from image_restoration_tpu_torch.kernels import attn_core as KA

    check_twice_and_batch2("attn_acc", shape,
                           lambda: KA.attn_acc(qkv, heads),
                           KA.attn_acc(qkv, heads))
    if batch2:
        two = torch.cat([qkv, qkv.flip(1)])
        kern, plain = KA.attn_acc(two, heads), KA.attn_acc_ref(two, heads)
        errs = [rel_err(k, pl) for k, pl in zip(kern, plain)]
        check(all(k.isfinite().all().item() for k in kern) and
              max(errs) < 1e-5, f"attn_acc at {shape} batch 2: rel err "
              f"{errs} against its plain version, above 1e-5")
        print(f"attn_acc {shape} batch 2: rel err against plain "
              f"{max(errs):.3e}", flush=True)

    def apply_fn(fn):
        return lambda q2, x2, a2: fn(q2, x2, a2, p.proj_w, p.proj_b)

    check_twice_and_batch2(
        "attn_apply", shape, lambda: KA.attn_apply(qkv, x, at, p.proj_w,
                                                   p.proj_b),
        KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b),
        _batch2(apply_fn(KA.attn_apply), apply_fn(KA.attn_apply_ref),
                (qkv, x, at)) if batch2 else None)


def phase_attn_sweep(pixels, warps=None, cols=None, groups=None,
                     ring=None, walk=None):
    """``--attn``: K5 and K6 alone at the five block shapes: phase 2d's
    rule (K5 also 1e-5 of its plain version), two equal runs, a batch of
    two at 64x64 x 384, and the kernels' times, once per tile size in
    ``pixels`` (none given: the wrappers' own), with K6's warps, columns a
    warp and column groups and K5's tile slots (``ring``) and fewest tiles
    a block walks (``walk``) as given (None: the wrappers' own). The wrapper's weight
    packing and a wrapper call's host time are timed apart."""
    import torch

    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import mdta as KM
    from image_restoration_tpu_torch.kernels.build import load_library

    lib = load_library().lib
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    sums = {}
    for i, (h, w, c, heads, n_blocks) in enumerate(LEVELS):
        p = random_block(c, heads, seed=100 + i)
        gen = torch.Generator().manual_seed(200 + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda", torch.bfloat16)
        f = p.front()
        oqkv = KM.ln_qkv_dwconv_ref(x.float(), f)
        qkv = oqkv.to(torch.bfloat16)
        gram_o = KA.attn_acc_ref(oqkv, heads)
        del oqkv
        gram_p = KA.attn_acc_ref(qkv, heads)
        at = KA.finalize_at(*gram_p, p.temperature, torch.bfloat16)
        out_p = KA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b)
        out_o = KA.attn_apply_ref(qkv.float(), x.float(), at.float(),
                                  p.proj_w, p.proj_b)
        t_pa = time_cuda(lambda: KA.attn_acc_ref(qkv, heads))
        t_pb = time_cuda(
            lambda: KA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b))
        t_pack = time_cuda(lambda: KA._apply_weights(p.proj_w, p.proj_b))
        host = {}
        for name, fn in (("attn_acc", lambda: KA.attn_acc(qkv, heads)),
                         ("attn_apply", lambda: KA.attn_apply(
                             qkv, x, at, p.proj_w, p.proj_b))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            host[name] = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
        shape = f"{h}x{w}x{c} heads {heads}"
        print(f"attn {shape}: plain acc {t_pa:.4f} ms, plain apply "
              f"{t_pb:.4f} ms; the wrapper's weight packing {t_pack:.4f} "
              f"ms on the card; host ms a wrapper call (launch included): "
              f"acc {host['attn_acc']:.4f}, apply {host['attn_apply']:.4f}",
              flush=True)
        for pix in pixels or [None]:
            where = f"{shape} pix {pix or 'own'}"
            tables = () if not (pix or warps or cols or groups or ring
                                or walk) else (
                (KA._ACC_PIXELS, pix), (KA._ACC_RING, ring),
                (KA._ACC_WALK, walk), (KA._APPLY_PIXELS, pix),
                (KA._APPLY_WARPS, warps), (KA._APPLY_COLS, cols),
                (KA._APPLY_GROUPS, groups))
            given = [(t, v) for t, v in tables if v is not None]
            with _kept(c, *(t for t, _ in given)):
                for t, v in given:
                    t[c] = v
                if given:
                    acc_smem = lib.ir_attn_acc_smem(c, heads,
                                                    *KA._acc_config(c))
                    apply_smem = lib.ir_attn_apply_smem(c, heads,
                                                        *KA._apply_config(c))
                    if max(acc_smem, apply_smem) > limit:
                        print(f"attn {where}: does not fit or is not built",
                              flush=True)
                        continue
                    where += (f" (acc {KA._acc_config(c)}, {acc_smem} B; "
                              f"apply {KA._apply_config(c)}, {apply_smem} B)")
                kern = KA.attn_acc(qkv, heads)
                torch.cuda.synchronize()
                msg = "; ".join(_check_rule("attn_acc", where, k, pl, o)
                                for k, pl, o in zip(kern, gram_p, gram_o))
                errs = [rel_err(k, pl) for k, pl in zip(kern, gram_p)]
                check(max(errs) < 1e-5, f"attn_acc at {where}: rel err "
                      f"{errs} against its plain version, above 1e-5")
                kb = KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b)
                torch.cuda.synchronize()
                msg_b = _check_rule("attn_apply", where, kb, out_p, out_o)
                check_attn_twice_and_batch2(where, qkv, x, at, p, heads,
                                            c == 384)
                t_a = time_cuda(lambda: KA.attn_acc(qkv, heads))
                t_b = time_cuda(
                    lambda: KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b))
                print(f"attn {where}: acc rel err {msg}, against plain "
                      f"{max(errs):.3e}; kernel {t_a:.4f} ms; apply rel err "
                      f"{msg_b}; kernel {t_b:.4f} ms", flush=True)
                sums.setdefault(pix or "own", []).append(
                    (n_blocks * t_a, n_blocks * t_b, n_blocks * t_pa,
                     n_blocks * t_pb))
                del kern, kb
    for pix, parts in sums.items():
        if len(parts) == len(LEVELS):
            tot = [sum(col) for col in zip(*parts)]
            print(f"attn pix {pix}: per forward ({BLOCKS_PER_FORWARD} "
                  f"blocks) acc {tot[0]:.3f} ms (plain {tot[2]:.3f}), apply "
                  f"{tot[1]:.3f} ms (plain {tot[3]:.3f})", flush=True)


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
        check_twice_and_batch2(
            "ln_qkv_dwconv", shape, lambda: KM.ln_qkv_dwconv(x, f),
            KM.ln_qkv_dwconv(x, f),
            _batch2(KM.ln_qkv_dwconv, KM.ln_qkv_dwconv_ref, (x,), f)
            if c == 384 else None)
        # K5 and its plain version widen the same bf16 map exactly, so both
        # errors against the oracle are the map's rounding; the kernel is
        # also held to its plain version: fp32 sums in another order.
        gram, ss = run("attn_acc", lambda: KA.attn_acc(qkv, heads),
                       lambda: KA.attn_acc_ref(qkv, heads),
                       KA.attn_acc_ref(oqkv, heads),
                       bound_attn_acc(h, w, c, heads), to_plain=1e-5)
        at = KA.finalize_at(gram, ss, p.temperature, torch.bfloat16)
        check_attn_twice_and_batch2(shape, qkv, x, at, p, heads, c == 384)
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
        check_twice_and_batch2(
            "ln_gdfn", shape, lambda: KG.fused_ln_gdfn(x2, g),
            KG.fused_ln_gdfn(x2, g),
            _batch2(KG.fused_ln_gdfn, KG.ln_gdfn_ref, (x2,), g)
            if c == 384 else None)
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
        check_twice_and_batch2(
            "drs_apply_msfn", f"{h}x{w}x{c}",
            lambda: K.drs_apply_msfn(v, x, atw, p), kern,
            _batch2(K.drs_apply_msfn, K.drs_apply_msfn_ref, (v, x, atw), p)
            if c == 384 else None)
        t_k = time_cuda(lambda: K.drs_apply_msfn(v, x, atw, p))
        t_p = time_cuda(lambda: K.drs_apply_msfn_ref(v, x, atw, p))
        print(f"drs_apply_msfn {h}x{w}x{c} heads {heads}: rel err {ek:.3e} "
              f"(plain {ep:.3e}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms",
              flush=True)
        _record(report, "drs_apply_msfn", [1, h, w, c], n_blocks, t_k, t_p,
                (kern.float() - plain.float()).abs().max().item(),
                bound_drs_apply_msfn(h, w, c))

    for i, (h, w, c, n_steps) in enumerate(MEFC_STEPS):
        t_k, t_p, msg, abs_err = _mefc_shape(i, h, w, c, n_steps,
                                             batch2=c == 96)
        print(f"mefc_step {h}x{w}x{c}, {n_steps} steps: rel err {msg}; "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median over the "
              f"steps)", flush=True)
        _record(report, "mefc_step", [1, h, w, c], n_steps, t_k, t_p, abs_err,
                bound_mefc_step(h, w, c))
    return report


def _mefc_shape(i, h, w, c, n_steps, batch2, plain=True):
    """K8 at shape ``i`` of MEFC_STEPS, each step on the plain chain's
    input: phase 2's rule, two bit-equal runs and, with ``batch2``, the rule
    on a batch of two whose images have different mix weights (the second
    image's M has its ops flipped). Returns the kernel's and (with
    ``plain``) the plain version's median ms over the steps, the errors and
    the max |kernel - plain|."""
    import torch

    from image_restoration_tpu_torch.kernels import mefc as M

    steps, mix = random_mefc_steps(c, n_steps, seed=500 + i)
    gen = torch.Generator().manual_seed(600 + i)
    x = torch.randn((1, h, w, c), generator=gen).abs()
    x = x.to("cuda", torch.bfloat16)
    errs, t_ks, t_ps, abs_err = [], [], [], 0.0
    for st, sp in enumerate(steps):
        where = f"{h}x{w}x{c} step {st}"
        m = M.fold_step(sp, mix[:, st], torch.bfloat16)
        oracle = M.mefc_step_ref(
            x.float(), sp, M.fold_step(sp, mix[:, st], torch.float32))
        ref = M.mefc_step_ref(x, sp, m)
        kern = M.mefc_step(x, sp, m)
        torch.cuda.synchronize()
        errs.append(_check_rule("mefc_step", where, kern, ref, oracle))
        del oracle
        check_twice_and_batch2(
            "mefc_step", where, lambda: M.mefc_step(x, sp, m), kern,
            _batch2(lambda x2, m2: M.mefc_step(x2, sp, m2),
                    lambda x2, m2: M.mefc_step_ref(x2, sp, m2), (x, m))
            if batch2 else None)
        abs_err = max(abs_err, (kern.float() - ref.float()).abs().max().item())
        t_ks.append(time_cuda(lambda: M.mefc_step(x, sp, m)))
        if plain:
            t_ps.append(time_cuda(lambda: M.mefc_step_ref(x, sp, m)))
        x = ref
    return (statistics.median(t_ks),
            statistics.median(t_ps) if plain else None, "; ".join(errs),
            abs_err)


def phase_mefc_sweep(rows):
    """``--mefc``: K8 alone at its two shapes (phase 2b's checks, with a
    batch of two at both), once per tile height in ``rows`` that fits the
    card (none given: the wrapper's own choice); per-step and per-forward
    times, and the wrapper's weight packing timed apart."""
    import torch

    from image_restoration_tpu_torch.kernels import mefc as M

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    sums = {}
    for i, (h, w, c, n_steps) in enumerate(MEFC_STEPS):
        _, t_p, _, _ = _mefc_shape(i, h, w, c, 1, batch2=False)
        steps, _ = random_mefc_steps(c, 1, seed=500 + i)
        t_pack = time_cuda(lambda: M._pack_step(steps[0]))
        print(f"mefc {h}x{w}x{c}: plain {t_p:.4f} ms a step (step 0); the "
              f"wrapper's weight packing {t_pack:.4f} ms a call", flush=True)
        with _kept(c, M._MEFC_TILE_ROWS):
            for th in rows or [None]:
                where = f"mefc {h}x{w}x{c} th {th or 'own'}"
                if not _try_rows(where, M._MEFC_TILE_ROWS, c, th,
                                 lambda t: M._mefc_smem(c, t), limit):
                    continue
                used = M._mefc_tile_rows(1, h, w, c, torch.device("cuda"))
                t_k, _, msg, _ = _mefc_shape(i, h, w, c, n_steps, batch2=True,
                                             plain=False)
                print(f"{where} (th {used}, {M._mefc_smem(c, used)} B "
                      f"shared): rel err {msg}; kernel {t_k:.4f} ms a step "
                      f"(median of {n_steps}), {n_steps * t_k:.4f} ms a "
                      f"forward", flush=True)
                sums.setdefault(th or "own", []).append(n_steps * t_k)
    for th, parts in sums.items():
        if len(parts) == len(MEFC_STEPS):
            print(f"mefc th {th}: {sum(parts):.4f} ms per forward "
                  f"({MEFC_STEPS_PER_FORWARD} steps)", flush=True)


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


def _ska_inputs(i, h, w, c, wc):
    """Shape ``i`` of SKA_SHAPES at batch 64: fp32 x and w, their bf16
    copies, the fp32 plain version (the oracle) and the bf16 one."""
    import torch

    from image_restoration_tpu_torch.ops.ska import ska_plain

    gen = torch.Generator(device="cuda").manual_seed(800 + i)
    x = torch.randn((LSNET_BATCH, h, w, c), generator=gen, device="cuda")
    wt = torch.randn((LSNET_BATCH, h, w, wc, 9), generator=gen,
                     device="cuda")
    xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
    return x, wt, xb, wb, ska_plain(x, wt), ska_plain(xb, wb)


def _ska_rule(where, kern, oracle, plain=None):
    """Phase 2c's rule on one kernel output: bf16 (``plain`` given) within
    max(3 x the plain bf16 error, 4e-3) of the fp32 oracle, fp32 within
    1e-5; returns the error and the plain version's."""
    import torch

    torch.cuda.synchronize()
    check(torch.isfinite(kern).all().item(), f"ska not finite at {where}")
    err = rel_err(kern, oracle)
    if plain is None:
        check(err <= 1e-5, f"ska fp32 at {where}: rel err {err:.3e} above "
              f"1e-5")
        return err, None
    ep = rel_err(plain, oracle)
    check(err < _bound(ep), f"ska at {where}: rel err {err:.3e} above "
          f"max(3 x {ep:.3e}, 4e-3)")
    return err, ep


def phase_ska_kernels():
    """K9 against ska_plain at LSNet-B's shapes, bf16 and fp32."""
    from image_restoration_tpu_torch.kernels import ska as K
    from image_restoration_tpu_torch.ops.ska import ska_plain

    report = _new_report(("ska",))
    b = LSNET_BATCH
    for i, (h, w, c, wc, calls) in enumerate(SKA_SHAPES):
        x, wt, xb, wb, oracle, plain = _ska_inputs(i, h, w, c, wc)
        kern = K.ska(xb, wb)
        ek, ep = _ska_rule(f"{h}x{w}x{c}", kern, oracle, plain)
        e32, _ = _ska_rule(f"{h}x{w}x{c}", K.ska(x, wt), oracle)
        abs_err = (kern.float() - plain.float()).abs().max().item()
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
        _record(report, "ska", [b, h, w, c, wc], calls, t_k, t_p, abs_err,
                bound, fp32_ms=t_k32, fp32_plain_ms=t_p32,
                fp32_bound_ms=bound32[0], fp32_max_rel_err=e32)
    return report


def _host_ms(fn, n=200):
    """Host ms of one call of ``fn`` (the enqueue, not the device work),
    mean over ``n`` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def _ska_host_parts(xb, wb):
    """Host ms of a wrapper call of K9 and of the parts every call
    repeats."""
    import torch

    from image_restoration_tpu_torch.kernels import ska as K
    from image_restoration_tpu_torch.kernels.forward_only import forward_only
    from image_restoration_tpu_torch.ops.ska import ska_shape

    def in_device():
        with torch.cuda.device(xb.device):
            pass

    parts = {"call": lambda: K.ska(xb, wb),
             "ska_shape": lambda: ska_shape(xb, wb),
             "empty_like": lambda: torch.empty_like(xb),
             "cuda.device": in_device,
             "current_stream": lambda: torch.cuda.current_stream(
                 xb.device).cuda_stream,
             "current_device": torch.cuda.current_device,
             "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                 xb.device.index),
             "forward_only": lambda: forward_only("ska", (xb, wb),
                                                  lambda: None)}
    return ", ".join(f"{k} {_host_ms(fn):.4f}" for k, fn in parts.items())


def phase_ska_sweep(rows, ring=None, split=None):
    """``--ska``: K9 alone at LSNet-B's three shapes at batch 64, bf16 and
    fp32: phase 2c's rules, two bit-equal runs and the times, at the
    wrapper's rows a strip or at each of ``rows`` that fits the card (each
    type on its own), with ``ring`` strip slots and the channel repeats of
    a unit ``split`` over threads as given (None: the
    wrapper's own). The plain versions, the timer's floor, copies of the
    same inputs and the host ms of a wrapper call and of its parts are
    timed apart. With no option it touches no table,
    so an older tree's K9 can be timed by this script."""
    import torch

    from image_restoration_tpu_torch.kernels import ska as K
    from image_restoration_tpu_torch.kernels.build import load_library
    from image_restoration_tpu_torch.ops.ska import ska_plain

    b = LSNET_BATCH
    sums = {}
    for i, (h, w, c, wc, calls) in enumerate(SKA_SHAPES):
        x, wt, xb, wb, oracle, plain = _ska_inputs(i, h, w, c, wc)
        shape = f"{b}x{h}x{w}x{c} wc {wc}"
        tiny = torch.zeros(1, device="cuda")
        print(f"ska {shape}: plain {time_cuda(lambda: ska_plain(xb, wb)):.4f} "
              f"ms, fp32 {time_cuda(lambda: ska_plain(x, wt)):.4f} ms; the "
              f"timer's floor (a 1-value zero_) "
              f"{time_cuda(tiny.zero_):.4f} ms; copies of x and w (two "
              f"clones) bf16 {time_cuda(lambda: (xb.clone(), wb.clone())):.4f}"
              f" ms, fp32 {time_cuda(lambda: (x.clone(), wt.clone())):.4f} "
              f"ms; host ms of a wrapper call and its parts: "
              f"{_ska_host_parts(xb, wb)}", flush=True)
        for th in rows or [None]:
            for dt, esize, xd, wd in (("bf16", 2, xb, wb), ("fp32", 4, x, wt)):
                where = f"{shape} {dt} th {th or 'own'}"
                given = [(getattr(K, name, None), v) for name, v in (
                    ("_SKA_ROWS", th), ("_SKA_RING", ring),
                    ("_SKA_SPLIT", split))
                    if v is not None]
                with _kept((c, esize), *(t for t, _ in given)):
                    for t, v in given:
                        t[(c, esize)] = v
                    if given:
                        cfg = K._config(c, esize)
                        if not load_library().lib.ir_ska_blocks(
                                w, c, wc, esize == 4, *cfg):
                            print(f"ska {where}: does not fit", flush=True)
                            continue
                        where += f" (rows, ring, split {cfg})"
                    kern = K.ska(xd, wd)
                    err, ep = _ska_rule(where, kern, oracle,
                                        plain if esize == 2 else None)
                    check_twice_and_batch2("ska", where,
                                           lambda: K.ska(xd, wd), kern)
                    t_k = time_cuda(lambda: K.ska(xd, wd))
                    bound = bound_ska(b, h, w, c, wc, esize)[0]
                    if ep is not None:
                        gap = (kern.float() - plain.float()).abs().max()
                        err = (f"{err:.3e} (plain {ep:.3e}), max |kernel - "
                               f"plain| {gap.item():.3e}")
                    else:
                        err = f"{err:.3e}"
                    print(f"ska {where}: rel err {err}; kernel {t_k:.4f} ms, "
                          f"bound {bound:.4f} ({bound / t_k:.1%})", flush=True)
                    sums.setdefault((dt, th or "own"), []).append(calls * t_k)
                    del kern
    for (dt, th), parts in sums.items():
        if len(parts) == len(SKA_SHAPES):
            print(f"ska {dt} th {th}: {sum(parts):.4f} ms per forward "
                  f"({SKA_PER_FORWARD} calls)", flush=True)


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

    from image_restoration_tpu_torch.cli.robust import build_argparser
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.eval.robustness import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        batch_hits,
    )
    from image_restoration_tpu_torch.kernels import ska as KS
    from image_restoration_tpu_torch.utils.options import parse_options

    # cli/robust.py classifies in fp32 unless asked: this phase times bf16
    cfg = parse_options(["--device", "cuda", "--seed", "0", "--bf16"]
                        + LSNET_B, build_argparser())
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
    ap.add_argument("--tail", nargs="*", type=int, default=None,
                    metavar="ROWS",
                    help="only K2 and K3 at the five block shapes: the rule, "
                         "two equal runs, batch 2 at 64x64x384 and the "
                         "times, at the wrappers' tile height or at each of "
                         "ROWS; prints no result line")
    ap.add_argument("--front", nargs="*", type=int, default=None,
                    metavar="ROWS",
                    help="only K1 and K4 at the five block shapes: the rule, "
                         "two equal runs, batch 2 at 64x64x384 and the "
                         "times, at the wrappers' tile height or at each of "
                         "ROWS; prints no result line")
    ap.add_argument("--msfn", nargs="*", type=int, default=None,
                    metavar="ROWS",
                    help="only K7 at DRSformer's five block shapes, as "
                         "--tail; prints no result line")
    ap.add_argument("--mefc", nargs="*", type=int, default=None,
                    metavar="ROWS",
                    help="only K8 at its two shapes: the rule, two equal "
                         "runs, batch 2 and the times, at the wrapper's tile "
                         "height or at each of ROWS; prints no result line")
    ap.add_argument("--attn", nargs="*", type=int, default=None,
                    metavar="PIX",
                    help="only K5 and K6 at the five block shapes: the "
                         "rule, two equal runs, batch 2 at 64x64x384 and "
                         "the times, at the wrappers' pixels a tile or at "
                         "each of PIX, with the wrapper's weight packing "
                         "and host time a call timed apart; prints no "
                         "result line")
    ap.add_argument("--ska", nargs="*", type=int, default=None,
                    metavar="TH",
                    help="only K9 at LSNet-B's three shapes, bf16 and fp32: "
                         "the rules, two equal runs and the times, at the "
                         "wrapper's rows a strip or at each of TH, with the "
                         "host time of a wrapper call and its parts timed "
                         "apart; prints no result line")
    ap.add_argument("--warps", type=int, default=None,
                    help="with --tail, --front or --msfn (8 or 16): warps a "
                         "block at every width; with --attn (4 or 8): K6's "
                         "warps a block")
    ap.add_argument("--cols", type=int, default=None, choices=[16, 48, 96],
                    help="with --attn: K6's output columns a warp job")
    ap.add_argument("--groups", type=int, default=None, choices=[1, 2, 4],
                    help="with --attn: K6's column groups (blocks a tile)")
    ap.add_argument("--ring", type=int, default=None, choices=[1, 2, 3],
                    help="with --attn (2 or 3): K5's tile slots (loads "
                         "ring - 1 tiles ahead); with --ska (1 or 2): K9's "
                         "strip slots (1: one strip a block)")
    ap.add_argument("--split", type=int, default=None, choices=[1, 2, 4, 8],
                    help="with --ska: threads that share a K9 unit's channel "
                         "repeats")
    ap.add_argument("--walk", type=int, default=None,
                    help="with --attn: the fewest tiles a K5 block walks")
    args = ap.parse_args(argv)
    sweeps = {"tail": args.tail, "front": args.front, "msfn": args.msfn}
    warps_of = {"tail": (8, 16), "front": (8, 16), "msfn": (8, 16),
                "attn": (4, 8)}
    given = [k for k in warps_of if getattr(args, k) is not None]
    if args.warps is not None and not given:
        ap.error("--warps goes with --tail, --front, --msfn or --attn (K8 "
                 "runs 16 warps a block, K9 sizes its blocks from its strip)")
    if args.warps is not None and any(args.warps not in warps_of[k]
                                      for k in given):
        ap.error("--warps: 8 or 16 with --tail, --front or --msfn; 4 or 8 "
                 "with --attn")
    if (args.cols or args.groups or args.walk) and args.attn is None:
        ap.error("--cols, --groups and --walk go with --attn")
    if args.ring is not None and (args.attn is None) == (args.ska is None):
        ap.error("--ring goes with one of --attn and --ska")
    if args.ring == (1 if args.attn is not None else 3):
        ap.error("--ring: 2 or 3 with --attn, 1 or 2 with --ska")
    if args.split is not None and args.ska is None:
        ap.error("--split goes with --ska")

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
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    if args.mefc is not None or args.attn is not None or \
            args.ska is not None or any(rows is not None
                                        for rows in sweeps.values()):
        for group, rows in sweeps.items():
            if rows is not None:
                phase_sweep(group, rows, args.warps)
        if args.mefc is not None:
            phase_mefc_sweep(args.mefc)
        if args.attn is not None:
            phase_attn_sweep(args.attn, args.warps, args.cols, args.groups,
                             args.ring, args.walk)
        if args.ska is not None:
            phase_ska_sweep(args.ska, args.ring, args.split)
        print(gpu)
        return 0

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
