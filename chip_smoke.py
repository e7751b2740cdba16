#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (image_restoration_tpu_torch).

Run from the root of the repository on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --tail [ROWS ...] [--warps 8|16] [--shapes S]
    python3 chip_smoke.py --front [ROWS ...] [--warps 8|16] [--shapes S]
    python3 chip_smoke.py --msfn [ROWS ...] [--warps 8|16]
    python3 chip_smoke.py --mefc [ROWS ...]
    python3 chip_smoke.py --attn [PIX ...] [--warps 4|8] [--cols N]
                                 [--groups N] [--ring 2|3] [--walk N]
    python3 chip_smoke.py --ska [TH ...] [--ring 1|2] [--split 1|2|4|8]
    python3 chip_smoke.py --ska-bwd [TH ...] [--ring 1|2] [--split 1|2|4|8]
    python3 chip_smoke.py --learn DIM
    python3 chip_smoke.py --learn-moce
    python3 chip_smoke.py --phases NAME [NAME ...]

The second form checks and times only the two kernels that share the GDFN
tail (K2, K3), at the wrappers' tile height and warps or at those given: the
sweep behind ``kernels/block.py`` ``_APPLY_TILE_ROWS`` and ``_APPLY_WARPS``.
The third does the same for the two kernels that share the block front (K1,
K4; ``_FRONT_TILE_ROWS``/``_FRONT_WARPS`` in ``kernels/block.py``,
``_QKV_TILE_ROWS``/``_QKV_WARPS`` in ``kernels/mdta.py``). With
``--shapes measnet`` either runs K2 or K1 alone at MEASNet's five block
shapes (C 32, 64, 128, 256; batch 2 at 64x64 x 256), the sweep behind
those tables' entries for C 32, 64, 128 and 256; ``--shapes nerd_rain``
at NeRD-Rain's nine. The fourth does
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
copied into an older tree it times that tree's K9. The eighth does it for
SKA's two backward kernels (``csrc/ska_bwd.cu``) at the shapes, batches
and types of the four paths that run them (LSNet-B's backward at batch 64
in bf16, the attack's at 16 in fp32, LSNet-T's step at 32 in bf16, the
distillation step's at 32 in bf16): the bits of ``ska_bwd_plain``, two
equal runs and the times of the simple kernels and of the strip kernels
at the tables' rows a strip or at each of TH, with strip slots and the
threads a unit as given, and each path's sums per backward (the sweep behind
``kernels/ska.py`` ``_BWD_*``). The ninth runs
``tools/learn_run.py``'s overfit configuration (its synthetic rain set
and its argv, 2000 steps, the run behind ``LEARN_r03.json``) through the
port's ``cli/train.py`` at ``model_kwargs.dim`` DIM: 24 is the width of
the JAX run (which sets no kernel flag and so trains plain XLA blocks);
here K1/K2 run every block at either width, at 24 with each 24-wide head
padded to 32 (``kernels/widths.py``), at 48 as they are; it prints the
loss and validation PSNR curves as one JSON line. The model starts
from the port's seeded init, which draws as the JAX package's flax init
does (``lecun_normal`` weights, zero biases). The tenth does the same for
``tools/learn_run2.py``'s ``moce_ir`` argv (MoCE-IR at dim 24, 4 experts,
top-2, aux weight 0.01, lr 1e-3, 2500 steps: the run behind
``LEARN_moce_ir_r05.json``), its balance loss's curve beside the others.
The eleventh runs the build, the kernel checks (phases 2-2h) and then only
the named phases of the ones that follow them (``PHASES``: 3, 3w, 3j, 3l,
3m, 3n, 3o, 3p, 3q, 3f, "3f family", "3f 3l", "3f 3o", "3f 3p", "3f 3q",
4, 4m, 4f, 4n, 4p, 4q, 5, 5v, 5a, 6, 6m, 6d), so that a family's phases
run on the card without the whole run.
None of them prints a result line.

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
2e. K1 and K2 as phase 2 at MEASNet's five block shapes serving a 512x512
   image (C 32, 64, 128, 256; batch 2 at 64x64 x 256) and at NeRD-Rain's
   nine (C 48, 96, 192 at its three scales; batch 2 at the C 192 ones);
   CG-IR's have phase 2's shapes. Then CG-IR's gated pair: ``fused_block``
   with a per-sample (2, heads) temperature and a (2, C) output gate
   folded into A^T W_proj, on a batch of two at 128x128 x 192 and 64x64 x
   384, by phase 2's rule against ``reference_block(..., gate=)``, two
   runs bit-equal;
2w. the kernel APIs at widths the raw kernels do not take, which run
   them in padded layouts (``kernels/widths.py``: each head padded, LN
   statistics over the real channels, the finalize at the real width):
   ``fused_block`` and the three-kernel block's APIs at the 12 blocks of
   Restormer at dim 24 (tools/learn_run.py's heads 1/2/4/8) serving a
   512x512 image whose heads are 24 wide (512^2 x 24 in 1 head, 256^2 x
   48 in 2, 128^2 x 96 in 4, 64^2 x 192 in 8), ``fused_drs_block`` at
   DRSformer's at dim 24, ``fused_mefc_steps`` at its 24-wide Subnet (4
   steps at 512^2), and CG-IR's gated pair at batch 2 with heads of 20.
   Each API is held to its plain composition at the real width by phase
   2's rule, two runs give the same bits, and every pad channel of each
   raw launch's output is exactly 0. Times: each API against its plain
   composition, the raw launches, and of the API's time the activation
   pad + unpad copies and the weight padding (the kernels line's by_path
   "dim24" holds the raw launches, bounds at the real width);
3g. CG-IR, MEASNet and NeRD-Rain served as phase 3 from their serving
   defaults (``fused_block``): 44, 40 and 78 K1 + K2 launches per forward,
   the same agreement rule against each plain fp32 model (NeRD-Rain on its
   restored image, the first of its 7 outputs; its restores pad to
   multiples of 16). MEASNet's FD BatchNorm statistics and affines and its
   FreqBlocks' ``param_alpha``/``param_beta`` are seeded non-trivial
   (``perturb_measnet``), so every FreqBlock reaches the image;
3f. evaluation: a seeded synthetic benchmark tree in the JAX layout
   (Rain100L-shaped: three pairs, 481x321 twice and 321x481; BSD68-shaped:
   three clean images of those sizes; GoPro-shaped: one 1280x720 pair) is
   scored through ``cli/test.py`` ``main``. Restormer-base from its serving
   defaults, seeded weights passed as a ``.pth`` ``--ckpt``, scores derain,
   denoise_25 and deblur: 44 K1 + 44 K2 launches per forward, finite
   scores, and each image's on-card PSNR and SSIM within 1e-3 dB and 1e-4
   of a float64 host recomputation (scipy, the skimage formula) of the
   same clipped output. On every input shape the benchmarks fed it (the
   padded 328x488 and 488x328 of Rain100L, deep maps 41x61 and 61x41 at
   384 channels; BSD68's 320x480 and 480x320 crops; GoPro's 768x1280
   bucket) the kernel model holds phase 3's rule against the plain fp32
   model. ``make_restore_fn`` with ``tile=128`` on a 512x512 image runs its
   16 windows as one batch of 16 (one forward's launches); every window of
   the restore holds phase 2's rule against the plain fp32 model (both
   clipped), and the windows whose bits equal their own batch-1 forward
   are counted. DRSformer scores derain: 40 K1, 40 K7 and 8 K8 per
   forward, finite outputs and scores, and phase 3's rule against its
   plain fp32 model at 328x488 and 488x328. ms/img per benchmark follow:
   the host clock around the evaluate loop, and inside it the forward and
   the metrics by CUDA events. Then SRConvNet, TransWeather and DarkIR
   (phase 3j's models, seeded weights as a ``--ckpt``) score a
   Set5-shaped x4 tree (``sr_set5_x4``: Y channel, 4 border pixels),
   a RainDrop-shaped one (720x480 pairs, ``raindrop``) and a LOLv1-shaped
   one (600x400, ``synllie``, with a seeded ``--lpips_ckpt``: the LPIPS
   column finite): no kernel launch, finite scores, and each image's
   on-card PSNR and SSIM within 1e-3 dB and 1e-4 of the float64 host
   recomputation (the Y-channel protocol for SR).
2f. K1 and K2 as phase 2 at MoCE-IR's block parameters (WithBias LN, a
   bias on every conv, GDFN hidden 2C) and its four block shapes serving a
   512x512 image: 512^2 x 48 (1 head, 8 blocks), 256^2 x 96 (2, 6),
   128^2 x 192 (4, 6) and 64^2 x 384 (8, 8; batch 2 there);
3h. MoCE-IR from its serving defaults (the big config, ``fused_block``;
   its init's zero biases seeded, ``perturb_biases``)
   served as phase 3: 28 K1 + 28 K2 launches per forward, finite outputs,
   phase 3's rule against its plain fp32 model. Every decoder block's
   expert pick in the kernel bf16, plain bf16 and plain fp32 models and
   the smallest top-1/top-2 softmax gap are printed; a pick of the kernel
   model that differs from the plain fp32 model's fails the phase. The
   host syncs of one forward are counted (the switched top-1 adapter reads
   each decoder block's pick on the host);
3w. the dim-24 models served as phase 3 at 512x512 with every kernel
   flag on and their blocks padded: Restormer at tools/learn_run.py's
   configuration (16 K1 + 16 K2 a forward), DRSformer at dim 24 (40 K1 +
   40 K7 + 8 K8) and MoCE-IR at tools/learn_run2.py's moce_ir argv (28 K1
   + 28 K2). ``build_model`` prints no "off" line; phase 3's agreement
   rule; the forward's device ms of the kernel model against the plain
   bf16 model's;
3i. IGMoCE-IR (its zero-initialised residual scales seeded,
   ``perturb_igmoce``), LumiSenseMoE and the patch-routed MoCE-IR from
   their serving defaults, served the same way without a kernel: every
   kernel's launch count must read 0; their picks are printed, not held.
3j. SRConvNet (dim 64, 10 blocks, 8 heads, 4 kernels, x4), TransWeather
   (the paper configuration) and DarkIR-m (width 32, encoder 1/2/3,
   middle 2/2, decoder 3/1/1) from their serving defaults, plain torch
   (no Pallas kernel behind them in JAX either), seeded weights with the
   zero-initialised DarkIR ``beta``/``gamma`` and the 1e-6 SRConvNet
   ``layer_scale`` perturbed (``perturb_family``), restore through
   ``make_restore_fn`` in bf16 at batch 1: SRConvNet 128x128 to 512x512,
   TransWeather 512x512, DarkIR 512x512 and 400x600 (LOLv1's shape).
   Outputs finite and of the expected size, every kernel's launch count
   0; the bf16 error against the card's fp32 model printed; the card's
   fp32 forward at a small input within 1e-4 relative L2 of the CPU
   port's; the forward's device ms, the restore's ms/img, MP/s of the
   output pixels and the peak memory;
3l. HOGformer (dim 36, blocks 4/4/6/8, heads 1/2/4/8), SFHformer and
   MWFormer (their field defaults) the same way at 512x512, plain torch
   (no Pallas kernel behind them in JAX either), HOGformer's near-zero
   ``sigma`` and SFHformer's zero ``beta``/``gamma`` perturbed and
   MWFormer's style vector calibrated to O(1) (``calibrate_style``); the
   card's fp32 forward within 1e-5 of the CPU port's, HOGformer's under
   the CPU's sort and bin decisions (``models/hogformer.py``
   ``decision_tape``; the free-running difference printed). Then phase
   3f's scoring for them: HOGformer and SFHformer on a Rain100L-shaped
   tree (481x321, ``derain``), MWFormer on the RainDrop-shaped one
   (``raindrop``), the same checks;
2g. K1 and K2 as phase 2 at the five block shapes of a Restormer-base
   training step (batch 8 of 128x128 patches: 128^2 x 48, 64^2 x 96,
   32^2 x 192, 16^2 x 384, 128^2 x 96, all on the batch of 8), two runs
   bit-equal, each timed. Then ``fused_block``'s backward on a batch of 8
   at 16^2 x 384 and 128^2 x 48: its gradients of x and every parameter
   under a fixed linear loss against ``reference_block``'s, which it
   recomputes (largest relative difference printed, below 4e-3; cuDNN
   held to its deterministic algorithms), with no K1 or K2 launch in the
   backward; forward + backward timed beside ``reference_block``'s, as
   phase 2h does for the other kernel APIs.
2b train, 2d train. DRSformer's kernels (K1 with DRSformer's front, K7;
   K8 at its two MEFC Subnets' steps, each image with its own mix
   weights) and the three-kernel block's (K4, K5, K6, K3) as phases 2b
   and 2d at the shapes of a training step's forward (batch 8 of
   128x128 patches), two runs bit-equal, each timed.
2c cls_train, 2c robust. K9 and SKA's two backward kernels as phases 2c
   and 2c backward at LSNet-T's two SKA shapes (14^2 x 128, 7^2 x 192) on
   a batch of 32, the classification step's, and at LSNet-B's on a batch
   of 16, the attack's.
2c backward. SKA's two backward kernels (``ska_bwd_x``, ``ska_bwd_w``,
   ``csrc/ska_bwd.cu``) at phase 2c's shapes, bf16 and fp32: the strip
   path at each, the bits of ``ska_bwd_plain`` (the same products and
   sums in the same order), phase 2c's rule against the fp32 plain
   version, two runs bit-equal, each image of a batch of two as it is
   alone; timed beside the simple kernels forced at the same shapes (the
   same bits), each with its share of the bound, and the plain version;
2h. the kernel APIs' VJPs: ``ln_qkv_dwconv``, ``fused_mdta_core``,
   ``fused_ln_gdfn`` and ``fused_drs_block`` on a batch of 8 at 16x16 x
   384 (8 heads), ``fused_mefc_steps`` on a batch of 8 at 128x128 x 48
   (four steps): the gradients of the input and of every parameter under
   a fixed linear loss against the plain recompute's (below 4e-3), the
   forward's output against the plain composition by phase 2's rule, the
   forward's launches as expected and none in the backward; forward +
   backward timed beside the plain composition's.
4. training: a seeded synthetic five-task AIO tree (``TASK_SPECS``'
   layout, four 256x256 images a task, two validation pairs) and
   ``cli/train.py`` ``main`` with Restormer-base's port defaults in bf16
   (``fused_block``), batch 8 of 128x128 patches, the five default tasks,
   ``--warmup_epochs 0 --ema_decay 0.999 --lr 2e-4`` (the JAX CLI's lr),
   20 steps, validation and saves every 10: 44 K1 + 44 K2 launches a
   forward (the 20 steps' and the 4 validation forwards'), every logged
   loss finite, the mean of the last five below the first, the
   checkpoints and ``best`` written; ``--resume`` continues from step 20
   to 23; ``cli/test.py --ckpt`` scores the final checkpoint on phase
   3f's synthetic tree with a finite PSNR. Gradient rule: on a batch of 2
   at 128x128, the relative L2 error of all parameter gradients of the
   kernel bf16 model against the plain fp32 model within 3x the plain
   bf16 model's (printed per level). Then a training step alone on a
   batch on the card: its launches (44 + 44, none in the backward), the
   host syncs of a step that does not log, step ms by CUDA events
   (median of 10 after three warm-up steps), images/s and peak memory,
   for the kernel model and the plain bf16 model. Then DRSformer the same
   way (its port defaults, ``fused_block``): 6 steps on the same tree,
   validation and saves every 3: 40 K1 + 40 K7 + 8 K8 launches a forward
   (the steps' and the validation's), none in a backward, no K2; finite
   losses; the L1 loss on a fixed batch lower with the final
   checkpoint's parameters than with the initial model's; ``cli/test.py
   --ckpt`` scores its final checkpoint with a finite PSNR; step ms and
   peak memory against the plain bf16 model. Then the three-kernel
   Restormer-base: a step launches 44 each of K4, K5, K6 and K3 (in its
   forward), no K1 or K2; step ms and peak memory against the plain bf16
   model.
2g moce_ir. K1 and K2 as phase 2g at MoCE-IR's training shapes (phase
   2f's block parameters; batch 8 at 128^2 x 48, 64^2 x 96, 32^2 x 192 and
   16^2 x 384), two runs bit-equal, each timed.
4m. MoCE-IR training: ``cli/train.py`` ``main`` with MoCE-IR's serving
   defaults (dim 48, blocks 4/6/6/8, decoder 2/4/4, 4 refinement, top-1
   of 4 experts, ``rank_type="spread"``, the complexity bias,
   ``fused_block``) in bf16 on phase 4's tree, batch 8 of 128x128,
   ``--aux_loss_weight`` 0.01 (the CLI's default), 6 steps, validation
   and saves every 3: noisy top-k routing from each step's generator, 28
   K1 + 28 K2 launches a forward (the steps' and the validation's), the
   balance loss logged and finite at every step, the L1 loss on a fixed
   batch lower with the final checkpoint's parameters than with the
   initial model's, ``cli/test.py --ckpt`` scoring the final checkpoint
   with a finite PSNR. Then IGMoCE-IR, LumiSenseMoE and the patch model
   take three steps each through ``main`` at their defaults: finite
   losses and balance losses, no kernel launch. Then phase 4's gradient
   rule (biases seeded; the three models route with noise from one
   generator seed, their picks printed) and a step's launches (28 + 28,
   none in the backward), host syncs, step ms, images/s and peak memory
   against the plain bf16 model.
4f. DarkIR-m (``--recipe darkir``: the side head's EnhanceLoss) and
   TransWeather (``--recipe transweather`` with a seeded torchvision-layout
   VGG16 ``.pth`` as ``--vgg_ckpt``) train through ``cli/train.py``
   ``main`` in bf16 on phase 4's tree, batch 8 of 128x128, 8 steps,
   validation and saves every 4: no kernel launch, every logged loss term
   finite (the enhance and perceptual terms too), the L1 loss on a fixed
   batch lower with the final checkpoint's parameters than with the
   initial model's, ``cli/test.py --ckpt`` scoring the final checkpoint
   with a finite PSNR; the bf16 gradients' relative L2 error against the
   fp32 model's (printed); step ms, images/s and peak memory.
4n. The same for HOGformer (``--recipe hogformer``: L1, Pearson and HOG
   terms), SFHformer (the default recipe; its BatchNorms train on the
   batch's statistics), MWFormer's style filter (``--model mwformer_style
   --recipe mwformer_style``: SupCon over the embeddings with the tree's
   five degradation labels, six steps, no validation, no fixed-batch L1 or
   scoring) and MWFormer (``--style_ckpt`` the style run's checkpoint
   directory: the filter loaded and frozen, bit-equal in the final
   checkpoint).
5. LSNet differentiates through SKA's backward kernels: LSNet-B in fp32
   (``cli/robust.py``'s default), seeded weights and BatchNorm statistics
   as a ``.pth`` ``--ckpt``; 16 seeded 224x224 images in an ImageFolder
   tree of 1000 class dirs, each image under the class the model predicts
   for it. One attacked batch, FGSM and PGD (``fgsm_pgd_attack``): every
   iterate in the 1/255 ball and in the normalized image of [0, 1], 9 K9
   + 9 ``ska_bwd_x`` + 9 ``ska_bwd_w`` launches per iteration.
   ``cli/robust.py`` clean, ``--adv FGSM`` and ``--adv PGD``: clean top-1
   at least 90% (100% but for a near-tie), each attack's no higher. Then
   five ``train/classification.py`` ``make_cls_train_step`` steps of
   LSNet-T in bf16 (AdamW) on one seeded batch of 32: finite losses, the
   last below the first, its 2 LSConvs' SKA a step through K9 and each
   backward kernel (10 launches of each in the five steps).
3m. ViG-T and HierViG-T (the JAX field defaults) from ``cli/robust.py``'s
   ``build_model`` in bf16 classify three seeded batches of 64 at 224x224
   through ``batch_hits``: finite bf16 logits; relative L2, max |error|
   and top-1 agreement against the card's fp32 model; the card's fp32
   logits within 1e-5 relative L2 of the CPU's on two images; ms a batch,
   images/s, the forward's device ms, peak memory, and the batch-1
   forward in MP/s.
3n. RetinaNet and Semantic-FPN over LSNet-T (80 and 150 classes, SKA
   plain as in JAX) in bf16, BatchNorm statistics from one train-mode
   forward of other images, on a batch of 2 at 512x512: the forward;
   ``decode_detections`` of each image and ``retinanet_loss`` on seeded
   boxes with two padded slots an image; ``segmentation_ce_loss`` and
   ``mean_iou``; all finite; bf16 against the card's fp32 model; the
   card's fp32 within 1e-5 of the CPU's at 256x256; forward ms, peak.
5v. Five ``make_cls_train_step`` steps (AdamW, bf16) of ViG-T and
   HierViG-T on one seeded batch of 32 at 224x224, and three
   ``train/trainer.py`` ``Optimizer`` steps of each dense model on phase
   3n's batch (focal + smooth L1; CE), the BatchNorms in eval mode as
   JAX's ``train=False`` step: finite losses, the last below the first;
   step ms, peak memory, the bf16 gradients' relative L2 against fp32.
   Phases 3m, 3n and 5v launch no kernel (JAX's GLA is ``lax.scan`` and
   einsums, and its dense engines run SKA through XLA): every count is
   set to 0 before each run and checked at 0 after.
3o. IPT (n_feats 64, task 5, x1) and EDT (embed 180, ``denoise_30``),
   plain torch (no Pallas kernel behind them in JAX either), seeded
   weights with every AdaptIR adapter's zero-initialised ``tail`` drawn,
   IPT's first head conv scaled by 1/255 and the adapters' BatchNorm
   statistics from one ``train=True`` forward (``perturb_adaptir``),
   restore a 512x512 image through ``make_restore_fn`` in bf16: IPT with
   ``--tile 48`` (121 windows, one batch), EDT with ``--pad_multiple 96``
   (576x576). Every kernel's count 0; finite outputs of the input's size;
   forward ms (CUDA events), restore ms/img, MP/s, peak memory; bf16
   against the card's fp32 (relative L2, max |error|); the card's fp32
   forward within 1e-5 relative L2 of the CPU's (48x48, 96x96). IPT's
   ``overlap_average_apply`` restore (patch 48, stride 12) timed once.
   At model level: EDT ``sr_2`` on 240x240 (480x480 out) and IPT's task 0
   (x2) on a 48x48 window, finite, their card fp32 within 1e-5 of the
   CPU's at 48x48.
"3f 3o". ``cli/test.py`` scores IPT on ``denoise_50`` (``--tile 48``)
   and EDT on ``denoise_25`` (``--pad_multiple 96``) on a BSD68-shaped
   tree (two 481x321 images), phase 3f's checks.
5a. Five ``Optimizer`` steps (AdamW) of the whole IPT (batch 8 of 48x48)
   and EDT (``denoise_30``, batch 8 of 96x96) in bf16 with ``model(lq,
   train=True)`` and an L1 loss: finite losses and gradients, the last
   loss below the first, no kernel launch; step ms, images/s, peak
   memory, the bf16 gradients' relative L2 against fp32. ``cli/train.py``
   refuses both, as the JAX CLI cannot train them.
6. ``--mesh`` training: ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m image_restoration_tpu_torch.cli.train --mesh 1``
   (``IR_TPU_MULTIHOST=1``, NCCL) trains Restormer-base at its port
   defaults for MESH_STEPS steps on phase 4's tree; its logged losses and
   final parameters equal the same steps of ``main`` in this process; then
   the sharded step on a one-rank NCCL mesh timed against the one-process
   step (CUDA events, in turns) with its launches (44 + 44).
6m. Two gloo ranks share the card (``parallel/dryrun.py``): which
   collectives gloo runs on CUDA tensors; MoCE-IR's full-width step at
   batch 8 x 128x128 split over a (2, 1) data x expert mesh, held to one
   process by the 3x rule, 28 + 28 launches a rank; Restormer-base's
   halo forward of a 640x512 image in two strips with the 312-row halo,
   the interior within 3x the unsharded bf16 forward's own error and a
   16-row halo missing that bound, 44 + 44 launches a strip.
6d. LSNet-B distils LSNet-B (``train/distill.py``, ``freeze_ratio`` 0.5,
   both on K9) at batch 32 x 224x224: 18 K9 and 9 + 9 K9b launches a
   step, frozen parameters unchanged; the student exported
   (``torch.export``, 9 ``ir_torch::ska`` nodes) and reloaded, equal to
   the live student and launching K9.
Each phase's seconds are printed.
Each serving phase sets the launch counts to 0 just before its forwards
and reads them just after; the kernels line's ``launches_by_path`` lists
phase 3f's two ``main`` runs as ``eval`` (Restormer-base, 7 forwards) and
``eval_drsformer`` (3 forwards), phase 3g's as ``cg_ir``, ``measnet``
and ``nerd_rain``, phase 3h's as ``moce_ir`` and phase 3i's (zeros) as
``igmoce_ir``, ``lumisense_moe`` and ``moce_ir_patch``, phase 3j's
(zeros) as ``srconvnet``, ``transweather`` and ``darkir``, phase 3f's
runs for them (zeros) as ``eval_srconvnet``, ``eval_transweather`` and
``eval_darkir``, phase 4f's (zeros) as ``train_darkir`` and
``train_transweather``, phase 3l's, its scoring's and phase 4n's (zeros)
as ``hogformer``, ``sfhformer``, ``mwformer``, ``eval_hogformer``,
``eval_sfhformer``, ``eval_mwformer``, ``train_hogformer``,
``train_sfhformer``, ``train_mwformer_style`` and ``train_mwformer``,
phase 4's first
``main`` run as ``train``, its DRSformer run as ``train_drsformer`` and
the three-kernel step as ``train_3k``, phase 4m's ``main`` runs as
``train_moce`` and (zeros) ``train_igmoce_ir``, ``train_lumisense_moe``
and ``train_moce_ir_patch``, and phase 5's ``cli/robust.py``
runs as ``robust_clean``, ``robust_fgsm`` and ``robust_pgd`` and its
classification steps as ``cls_train``, phases 3m, 3n and 5v's (zeros)
as ``vig``, ``vig_h``, ``retinanet_lsnet``, ``semanticfpn_lsnet`` and
``train_`` each of them, and phases 3o, "3f 3o" and 5a's (zeros) as
``ipt``, ``edt``, ``ipt_edt_model_level``, ``eval_ipt``, ``eval_edt``,
``train_ipt`` and ``train_edt``, and phases 6, 6m and 6d's as
``mesh_train`` (a sharded step), ``mesh_moce`` (both ranks' sharded
steps), ``halo`` (both strips' forwards) and ``distill`` (the
distillation steps). Each kernel's row keeps the
serving path's per-forward sums; its ``by_path`` holds those of the other
paths that phase 2 checks it at (K1/K2: MEASNet's, NeRD-Rain's,
MoCE-IR's, a training step's and MoCE-IR's training step's
(``train_moce``); K1, K7, K8: ``train_drsformer``; K3-K6:
``train_3k``; K9 and its backward kernels: ``cls_train`` and ``robust``),
and its ``per_shape`` rows of those shapes carry a ``path``.

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
dynamic conv whose weights vary per pixel, and ``ska_bwd_x`` and
``ska_bwd_w`` its two gradients.

The line before the last is a JSON object of the kernels; before it, the
card's name and power limit as nvidia-smi gives them. The last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits nonzero
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
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
# MEASNet (MODEL_DEFAULTS["measnet"]: dim 32, blocks 4/4/6/8, 4 refinement,
# heads 1/2/4/8) at a 512x512 input: level 1 at 32, level 2 at 64 (4
# encoder + 4 decoder blocks), level 3 at 128 (6 + 6), the latent at 256,
# and decoder level 1 + refinement at 64 with heads[0].
MEASNET_LEVELS = [
    (512, 512, 32, 1, 4),
    (256, 256, 64, 2, 8),
    (128, 128, 128, 4, 12),
    (64, 64, 256, 8, 8),
    (512, 512, 64, 1, 8),
]
MEASNET_BLOCKS_PER_FORWARD = sum(lv[-1] for lv in MEASNET_LEVELS)  # 40
# NeRD-Rain large (dim 48, blocks 2/3/3, heads 1/2/4) at a 512x512 input:
# its U-Nets run at 1/4 scale (once, 2 + 2 / 3 + 3 / 3 blocks a level), 1/2
# (two encoder and two decoder passes) and full scale (three of each).
NERD_LEVELS = [
    (128, 128, 48, 1, 4), (64, 64, 96, 2, 6), (32, 32, 192, 4, 3),
    (256, 256, 48, 1, 8), (128, 128, 96, 2, 12), (64, 64, 192, 4, 6),
    (512, 512, 48, 1, 12), (256, 256, 96, 2, 18), (128, 128, 192, 4, 9),
]
NERD_BLOCKS_PER_FORWARD = sum(lv[-1] for lv in NERD_LEVELS)  # 78
# MoCE-IR big (MODEL_DEFAULTS["moce_ir"]: dim 48, levels 4, blocks 4/6/6/8,
# 4 refinement, heads 1/2/4/8) at a 512x512 input: its encoder, latent and
# refinement EncoderBlocks (WithBias LN, a bias on every conv, GDFN hidden
# 2C) run the pair; its 10 decoder blocks are plain torch.
MOCE_LEVELS = [
    (512, 512, 48, 1, 8),
    (256, 256, 96, 2, 6),
    (128, 128, 192, 4, 6),
    (64, 64, 384, 8, 8),
]
MOCE_BLOCKS_PER_FORWARD = sum(lv[-1] for lv in MOCE_LEVELS)  # 28
MOCE_DECODER_BLOCKS = 10  # 4 + 4 + 2: one routing pick read on the host each
MOCE_BLOCK = dict(expansion=2.0, bias=True)
# The MoCE family's other three models run no kernel (plain XLA in JAX).
KERNEL_FREE = ("igmoce_ir", "lumisense_moe", "moce_ir_patch")
# Restormer-base training at the JAX CLI's defaults: batch 8 of 128x128
# patches; a step's forward runs the 44 blocks at these shapes (H, W, C,
# heads, blocks), each on the batch of 8.
TRAIN_BATCH, TRAIN_PATCH = 8, 128
TRAIN_LEVELS = [
    (128, 128, 48, 1, 4),
    (64, 64, 96, 2, 12),
    (32, 32, 192, 4, 12),
    (16, 16, 384, 8, 8),
    (128, 128, 96, 1, 8),
]
# fused_block's backward is checked at the deepest and the widest map
BACKWARD_SHAPES = [(16, 16, 384, 8), (128, 128, 48, 1)]
# Phase 4's run of cli/train.py: steps, validation and save period, the
# learning rate (the JAX CLI's default), the steps after the resume, the
# synthetic tree's images a task (256x256) and validation pairs.
TRAIN_STEPS, TRAIN_EVERY, TRAIN_LR, RESUME_STEPS = 20, 10, 2e-4, 3
TRAIN_IMAGES, VAL_IMAGES = 4, 2
# DRSformer's run in phase 4: steps, and the validation and save period.
DRS_TRAIN_STEPS, DRS_TRAIN_EVERY = 6, 3
# Phase 4m: MoCE-IR's run (steps, validation and save period), its
# training forward's K1/K2 shapes (batch 8 of 128x128: MOCE_LEVELS at a
# quarter of the 512x512 side), and the steps of the MoCE family's three
# kernel-free models.
MOCE_TRAIN_STEPS, MOCE_TRAIN_EVERY = 6, 3
MOCE_TRAIN_LEVELS = [(h * TRAIN_PATCH // 512, w * TRAIN_PATCH // 512, c,
                      heads, n) for h, w, c, heads, n in MOCE_LEVELS]
FAMILY_TRAIN_STEPS = 3
# Phase 3j: the serving defaults phase 3j holds SRConvNet, TransWeather
# (its paper configuration: the model's own defaults) and DarkIR-m to, the
# inputs (H, W) each restores (SRConvNet x4: 128x128 to 512x512; DarkIR
# also LOLv1's 400x600) and the small input of the card-against-CPU check.
FAMILY_WIDTHS = {
    "srconvnet": dict(dim=64, n_blocks=10, num_heads=8, scale=4),
    "transweather": {},
    "darkir": dict(width=32, enc_blk_nums=(1, 2, 3), middle_blk_num_enc=2,
                   middle_blk_num_dec=2, dec_blk_nums=(3, 1, 1),
                   dilations=(1, 4, 9)),
}
FAMILY_SERVE = {"srconvnet": [(128, 128)], "transweather": [(512, 512)],
                "darkir": [(512, 512), (400, 600)]}
FAMILY_SMALL = {"srconvnet": (32, 24), "transweather": (96, 64),
                "darkir": (64, 48)}
# Phase 3f's runs for them: (model, benchmark, images, Y border), the
# Set5-shaped HR sizes, RainDrop's 720x480 and LOLv1's 600x400 (H, W).
FAMILY_EVAL = [("srconvnet", "sr_set5_x4", 2, 4),
               ("transweather", "raindrop", 2, 0),
               ("darkir", "synllie", 2, 0)]
SR_EVAL_SIZES = [(256, 256), (176, 144)]
RAINDROP_SIZE, LOL_SIZE = (480, 720), (400, 600)
# Phase 4f: DarkIR's and TransWeather's runs (steps, validation and save
# period).
FAMILY_TRAIN_STEPS_4F, FAMILY_TRAIN_EVERY = 6, 3
# Phases 3l, 3f 3l and 4n: HOGformer (JAX utils/options.py:51: dim 36,
# blocks 4/4/6/8, heads 1/2/4/8), SFHformer and MWFormer (their field
# defaults) served at 512x512, scored on a Rain100L-shaped tree (321x481)
# and the RainDrop-shaped one, and trained (MWFormer in its two stages,
# the style filter's for FAMILY_STYLE_STEPS); their card-against-CPU
# check holds to 1e-5, PR 18's three to 1e-4.
FAMILY_WIDTHS.update({
    "hogformer": dict(dim=36, num_blocks=(4, 4, 6, 8), heads=(1, 2, 4, 8)),
    "sfhformer": {}, "mwformer": {}, "mwformer_style": {}})
FAMILY_SMALL.update({"hogformer": (48, 32), "sfhformer": (48, 32),
                     "mwformer": (96, 64)})
SERVE_3L = {"hogformer": [(512, 512)], "sfhformer": [(512, 512)],
            "mwformer": [(512, 512)]}
EVAL_3L = [("hogformer", "derain", 2, 0), ("sfhformer", "derain", 2, 0),
           ("mwformer", "raindrop", 2, 0)]
RAIN100L_SIZE = (321, 481)
TRAIN_4F = ("darkir", "transweather")
TRAIN_4N = ("hogformer", "sfhformer", "mwformer_style", "mwformer")
FAMILY_STYLE_STEPS = 6
CARD_CPU_LIMIT = {"hogformer": 1e-5, "sfhformer": 1e-5, "mwformer": 1e-5}
# Phase 5: images of the attacked ImageFolder tree (one batch, 224x224),
# and LSNet-T's classification steps, their batch and learning rate. The
# step keeps the BatchNorms in eval mode (as the JAX package's does), so
# their statistics stay those of the random init while AdamW's first
# steps move every weight by ~lr at once: at 1e-3 the loss climbs from
# ln(1000) to ~90 in five steps; at 3e-5 it falls at every step.
ADV_IMAGES = 16
CLS_STEPS, CLS_BATCH, CLS_LR = 5, 32, 3e-5
# Phases 3m and 5v: ViG-T and HierViG-T classify GLA_BATCHES batches of
# GLA_BATCH at 224x224 and take GLA_TRAIN_STEPS classification steps
# (AdamW at GLA_LR) on one batch of GLA_TRAIN_BATCH; phase 3n: RetinaNet
# and Semantic-FPN over LSNet-T on a batch of DENSE_BATCH at DENSE_SIZE^2
# (DENSE_SLOTS box slots an image, two of them padded), and in phase 5v
# DENSE_TRAIN_STEPS Optimizer steps (AdamW at DENSE_LR) on it. The card's
# fp32 forward of each is held to the CPU's within CARD_CPU_GLA relative L2.
GLA_BATCH, GLA_BATCHES = 64, 3
GLA_TRAIN_BATCH, GLA_TRAIN_STEPS, GLA_LR = 32, 5, 1e-4
DENSE_BATCH, DENSE_SIZE, DENSE_SLOTS = 2, 512, 8
DENSE_TRAIN_STEPS, DENSE_LR = 3, 1e-4
CARD_CPU_GLA = 1e-5
# The phases after the kernel checks, in their order: ``--phases`` runs the
# named ones.
PHASES = ("3", "3w", "3j", "3l", "3m", "3n", "3o", "3p", "3q", "3f",
          "3f family", "3f 3l", "3f 3o", "3f 3p", "3f 3q", "4", "4m", "4f",
          "4n", "4p", "4q", "5", "5v", "5a", "6", "6m", "6d")
# Phases 3o, "3f 3o" and 5a: IPT (its field defaults: n_feats 64, task 5,
# x1) served in 48x48 windows (--tile 48: 121 at 512x512, one batch) and
# EDT (embed 180, denoise_30) padded to multiples of 96 (576x576), the
# options and model_kwargs of each; the small input of the card-against-CPU
# check (and of the BatchNorm calibration), held to CARD_CPU_ADAPTIR; IPT's
# overlap-average restore in batches of ADAPTIR_OVERLAP_BATCH; EDT sr_2's
# model-level input side; the BSD68-shaped set's images; the training
# steps, batch and AdamW learning rate.
ADAPTIR_SERVE = {"ipt": (["--tile", "48"], {}),
                 "edt": (["--pad_multiple", "96"], {"de_type": "denoise_30"})}
ADAPTIR_SMALL = {"ipt": (48, 48), "edt": (96, 96)}
CARD_CPU_ADAPTIR = 1e-5
ADAPTIR_OVERLAP_BATCH = 256
ADAPTIR_SR_IN = 240
ADAPTIR_EVAL_IMAGES = 2
ADAPTIR_TRAIN_STEPS, ADAPTIR_TRAIN_BATCH, ADAPTIR_LR = 5, 8, 1e-4
# Phases 3p, "3f 3p" and 4p: RectiFormer, FPN-Restormer and MyModel at
# their serving defaults (the JAX field defaults: 32.10 M, 13.37 M and
# 6.26 M parameters); the small input of the card-against-CPU check (and
# of the BatchNorm calibration), held to CARD_CPU_BRANCH; the model-level
# training steps and AdamW learning rate (batch TRAIN_BATCH of
# TRAIN_PATCH^2). RectiFormer's DGSB mask is NaN below 64x64 inputs.
BRANCH_MODELS = ("rectiformer", "fpn_restormer", "mymodel")
BRANCH_SMALL = (64, 64)
CARD_CPU_BRANCH = 1e-5
BRANCH_TRAIN_STEPS, BRANCH_LR = 5, 1e-4
# Phases 3q, "3f 3q" and 4q: SFSNiD (num_res 3, base 32) and PINN at their
# serving defaults (the JAX field defaults), the small input of their
# card-against-CPU checks, held to CARD_CPU_DEMO (SFSNiD's output after
# its stage SFSNID_HELD, where the card's run and the CPU's lie on the same
# side of the angle's branch cut at every rfft2 coefficient:
# phase_serve_demo); HiLo at model level
# (dim 96, a LITv2 stage-1 map: batch 64 of 56x56); the frequency MoE
# layer and FCM (dim 48) at batch 8 of 128x128; the unpaired folder's
# images; FID's two sets. Training takes BRANCH_TRAIN_STEPS steps.
DEMO_MODELS = ("sfsnid", "pinn")
DEMO_SMALL = (64, 64)
CARD_CPU_DEMO = 1e-5
SFSNID_HELD = "Encoder.1"
HILO_BATCH, HILO_SIDE, HILO_DIM = 64, 56, 96
LAYER_BATCH, LAYER_SIDE, LAYER_DIM = 8, 128, 48
UNPAIRED_IMAGES, UNPAIRED_SIZE = 3, 512
FID_IMAGES = 96
# CG-IR's 44 CGTBs have Restormer-base's block shapes (LEVELS); the gated
# pair runs at batch 2 at two of them in phase 2e.
GATED_SHAPES = [(128, 128, 192, 4), (64, 64, 384, 8)]
MEFC_STEPS = [(512, 512, 48, 4), (512, 512, 96, 4)]  # (H, W, C, steps)
MEFC_STEPS_PER_FORWARD = sum(lv[-1] for lv in MEFC_STEPS)  # 8
# Phase 2w: the kernel APIs at widths the raw kernels do not take, which
# they run in padded layouts (kernels/widths.py). Restormer at
# tools/learn_run.py's dim 24 (blocks 2/2/2/2, 2 refinement, heads 1/2/4/8:
# every head 24 wide) serving a 512x512 image, (H, W, C, heads, blocks a
# forward): its 12 blocks whose heads are 24 wide; decoder level 1 and the
# refinement (4 blocks, 48 in one head) take K1 as they are. DRSformer at
# dim 24: DRS_LEVELS' padded blocks at half the width, and its level-0 MEFC
# Subnet (24 wide, 4 steps; the refinement's is 48 wide). CG-IR's gated
# pair at batch 2 with heads of 20 (padded to 32).
DIM24_LEVELS = [(512, 512, 24, 1, 2), (256, 256, 48, 2, 4),
                (128, 128, 96, 4, 4), (64, 64, 192, 8, 2)]
DIM24_BLOCKS_PER_FORWARD = 16
DRS24_LEVELS = [(512, 512, 24, 1, 4), (256, 256, 48, 2, 12),
                (128, 128, 96, 4, 12), (64, 64, 192, 8, 8)]
MEFC24_STEPS = (512, 512, 24, 4)
GATED24_SHAPE = (128, 128, 40, 2)
# Phase 3w: the dim-24 models serving 512x512 (--set overrides): Restormer
# at tools/learn_run.py's configuration, DRSformer at dim 24, MoCE-IR at
# tools/learn_run2.py's moce_ir argv.
LEARN_RUN_RESTORMER = ("model_kwargs.dim=24",
                       "model_kwargs.num_blocks=(2,2,2,2)",
                       "model_kwargs.num_refinement_blocks=2",
                       "model_kwargs.heads=(1,2,4,8)")
# DRSformer's training forward (batch 8 of 128x128 patches): its blocks and
# MEFC steps at a quarter of the 512x512 side.
DRS_TRAIN_LEVELS = [(h * TRAIN_PATCH // 512, w * TRAIN_PATCH // 512, c, heads,
                     n) for h, w, c, heads, n in DRS_LEVELS]
MEFC_TRAIN_STEPS = [(h * TRAIN_PATCH // 512, w * TRAIN_PATCH // 512, c, n)
                    for h, w, c, n in MEFC_STEPS]
# LSNet-B (lsnet.py:221-222) classifying a batch of 64 at 224x224: SKA runs
# in every LSConv, at (H, W, C, wc, calls per forward); stage 3's odd
# blocks are attention, so 2 + 3 + 4 = 9 calls.
LSNET_B = ["--set", "model_kwargs.embed_dim=(128,256,384,512)",
           "--set", "model_kwargs.depth=(4,6,8,10)"]
LSNET_BATCH = 64
SKA_SHAPES = [(28, 28, 128, 16, 2), (14, 14, 256, 32, 3), (7, 7, 384, 48, 4)]
SKA_PER_FORWARD = sum(lv[-1] for lv in SKA_SHAPES)  # 9
# LSNet-T (MODEL_DEFAULTS["lsnet"]: embed 64/128/192/256, depth 1/2/3/4) at
# 224x224 has one LSConv in stage 1 and one in stage 2: SKA at these shapes
# in a classification step's forward (batch CLS_BATCH).
LSNET_T_SKA_SHAPES = [(14, 14, 128, 16, 1), (7, 7, 192, 24, 1)]
LSNET_T_SKA_PER_FORWARD = sum(lv[-1] for lv in LSNET_T_SKA_SHAPES)  # 2
# The synthetic benchmark tree of phase 3f, (H, W) per image in the JAX
# layout of eval/benchmarks.py: Rain100L- and BSD68-shaped (481x321 and
# 321x481 images) and GoPro-shaped (1280x720); the benchmarks it scores
# and their images.
EVAL_SIZES = [(321, 481), (321, 481), (481, 321)]
GOPRO_SIZE = (720, 1280)
EVAL_BENCHES = ["derain", "denoise_25", "deblur"]
EVAL_IMAGES = {"derain": 3, "denoise_25": 3, "deblur": 1}
# The model options that route work through a kernel.
KERNEL_FLAGS = ("fused_block", "fused_attn", "fused_gdfn", "use_pallas_ska")
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
    # the backward of JAX's SKA custom VJP, XLA in JAX (no Pallas kernel)
    "ska_bwd_x": (CSRC + "ska_bwd.cu",
                  "image_restoration_tpu/kernels/ska_pallas.py:109"),
    "ska_bwd_w": (CSRC + "ska_bwd.cu",
                  "image_restoration_tpu/kernels/ska_pallas.py:109"),
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


def random_block(c, heads, seed, expansion=2.66, bias=False):
    """A TransformerBlock's parameters on the GPU, from ``seed``: the
    module's own init (GDFN ``expansion``; with ``bias`` a bias on every
    conv, as MoCE-IR's EncoderBlock), with LN affine and temperature
    perturbed so every term of the kernels is exercised."""
    import torch

    from image_restoration_tpu_torch.models.restormer import TransformerBlock

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        blk = TransformerBlock(c, heads, expansion, use_bias=bias)
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


def bound_block_front(h, w, c, heads, b=1):
    """K1 on a batch of ``b``: read x, write v (bf16), the fp32 Gram and
    sums of squares of each image; the qkv 1x1 and q^T k on the tensor
    cores, the 3x3 depthwise in fp32."""
    n, ch = b * h * w, c // heads
    nbytes = 2 * n * c * 2 + 4 * b * (heads * ch * ch + 2 * c) \
        + 2 * 3 * c * c + 4 * (27 * c + 2 * c)
    return roofline(nbytes, 2 * n * c * 3 * c + 2 * n * c * ch,
                    2 * 9 * 3 * c * n)


def bound_block_apply_gdfn(h, w, c, expansion=2.66, b=1):
    """K2 on a batch of ``b``: read v and x, write out (bf16), each image's
    A^T W_proj and the GDFN weights; v A^T W, the content|gate 1x1 and the
    out 1x1 on the tensor cores, the 3x3 depthwise over 2 hidden in fp32."""
    n, hid = b * h * w, int(c * expansion)
    nbytes = 3 * 2 * n * c + 2 * b * c * c + 2 * 3 * hid * c + 4 * 18 * hid
    tc = 2 * n * c * c + 2 * n * c * 2 * hid + 2 * n * hid * c
    return roofline(nbytes, tc, 2 * 9 * 2 * hid * n)


def bound_ln_qkv_dwconv(h, w, c, b=1):
    """K4 on a batch of ``b``: read x, write the 3C-wide qkv map (bf16) and
    the weights; the qkv 1x1 on the tensor cores, the 3x3 depthwise over 3C
    in fp32."""
    n = b * h * w
    nbytes = 2 * n * c + 2 * n * 3 * c + 2 * 3 * c * c + 4 * (27 * c + 2 * c)
    return roofline(nbytes, 2 * n * c * 3 * c, 2 * 9 * 3 * c * n)


def bound_attn_acc(h, w, c, heads, b=1):
    """K5 on a batch of ``b``: read q and k (bf16), write each image's fp32
    Gram and sums of squares; q^T k per head on the tensor cores, the
    squares in fp32."""
    n, ch = b * h * w, c // heads
    nbytes = 2 * 2 * n * c + 4 * b * (heads * ch * ch + 2 * c)
    return roofline(nbytes, 2 * n * c * ch, 2 * 2 * n * c)


def bound_attn_apply(h, w, c, heads, b=1):
    """K6 on a batch of ``b``: read v and x, write out (bf16), each image's
    A^T per head and W_proj; v A^T per head and t W_proj on the tensor
    cores."""
    n, ch = b * h * w, c // heads
    nbytes = 3 * 2 * n * c + 2 * (b * heads * ch * ch + c * c)
    return roofline(nbytes, 2 * n * c * ch + 2 * n * c * c)


def bound_ln_gdfn(h, w, c, b=1):
    """K3 on a batch of ``b``: read x, write out (bf16), the GDFN weights;
    the content|gate 1x1 and the out 1x1 on the tensor cores, the 3x3
    depthwise over 2 hidden in fp32."""
    n, hid = b * h * w, int(c * 2.66)
    nbytes = 2 * 2 * n * c + 2 * 3 * hid * c + 4 * 18 * hid + 4 * 2 * c
    tc = 2 * n * c * 2 * hid + 2 * n * hid * c
    return roofline(nbytes, tc, 2 * 9 * 2 * hid * n)


def bound_drs_apply_msfn(h, w, c, b=1):
    """K7 on a batch of ``b``: as K2 with MSFN: project_in to 2H, the 3x3
    and 5x5 banks over 2H and the grouped 3x3 and 5x5 over H pairs in fp32,
    project_out."""
    n, hid = b * h * w, int(c * 2.66)
    nbytes = 3 * 2 * n * c + 2 * b * c * c + 2 * 4 * hid * c \
        + 4 * (2 * hid * 34 + 2 * hid * 34)
    tc = 2 * n * c * c + 2 * 2 * n * c * 2 * hid
    return roofline(nbytes, tc, 2 * n * (2 * hid * 34 + 2 * hid * 34))


def bound_mefc_step(h, w, c, b=1):
    """K8 on a batch of ``b``: read x, write out (bf16), each image's 8
    folded C x C mix matrices and the 4 inner 1x1s; 12 C x C products per
    pixel on the tensor cores; the 84 + 84 + 83 depthwise taps and the
    9-tap pool per channel in fp32."""
    n = b * h * w
    nbytes = 2 * 2 * n * c + 2 * (8 * b + 4) * c * c + 4 * 251 * c
    return roofline(nbytes, 12 * 2 * n * c * c, 2 * n * c * 251 + 9 * n * c)


def bound_ska(b, h, w, c, wc, esize):
    """K9: read x and w, write out; 9 fp32 multiply-adds per output."""
    n = b * h * w
    return roofline(esize * (2 * n * c + n * wc * 9), 0.0, 2 * 9 * n * c)


def _bound(plain):
    return max(3.0 * plain, 4e-3)


def phase_kernels(levels=LEVELS, seed=100, tag="", expansion=2.66,
                  bias=False, batch=1):
    """K1 and K2 at ``levels`` (Restormer-base's by default) on a batch of
    ``batch``, phase 2's rule, two equal runs, a batch of two at the
    widest level (when ``batch`` is 1), and the times; printed with
    ``tag``. ``expansion`` and ``bias`` are ``random_block``'s."""
    import torch

    from image_restoration_tpu_torch.kernels import block as K

    report = _new_report(("block_front", "block_apply_gdfn"))
    widest = max(lv[2] for lv in levels) if batch == 1 else None
    for i, (h, w, c, heads, n_blocks) in enumerate(levels):
        p = random_block(c, heads, seed + i, expansion, bias)
        gen = torch.Generator().manual_seed(seed + 100 + i)
        x = torch.randn((batch, h, w, c), generator=gen).to("cuda",
                                                            torch.bfloat16)

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
            if c == widest else None)
        abs_front = (kern[0].float() - plain[0].float()).abs().max().item()
        t_k = time_cuda(lambda: K.block_front(x, p, heads))
        t_p = time_cuda(lambda: K.block_front_ref(x, p, heads))
        print(f"{tag}block_front {h}x{w}x{c} heads {heads}: rel err "
              f"{'; '.join(errs)}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms",
              flush=True)
        _record(report, "block_front", [batch, h, w, c], n_blocks, t_k, t_p,
                abs_front, bound_block_front(h, w, c, heads, batch))

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
            if c == widest else None)
        t_k = time_cuda(lambda: K.block_apply_gdfn(v, x, atw, p))
        t_p = time_cuda(lambda: K.block_apply_gdfn_ref(v, x, atw, p))
        print(f"{tag}block_apply_gdfn {h}x{w}x{c} heads {heads}: rel err "
              f"{ek:.3e} (plain {ep:.3e}); kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms", flush=True)
        _record(report, "block_apply_gdfn", [batch, h, w, c], n_blocks, t_k,
                t_p, (kern2.float() - plain2.float()).abs().max().item(),
                bound_block_apply_gdfn(h, w, c, expansion, batch))
    return report


def phase_gated():
    """CG-IR's gated pair on the card (phase 2e): ``fused_block`` with a
    per-sample (2, heads) temperature and a (2, C) output gate, K1, the
    finalize that folds the gate into A^T W_proj, K2, on a batch of two
    whose images, temperatures and gates differ, held by phase 2's rule
    against ``reference_block(..., gate=)`` (fp32 oracle, bf16 plain); two
    runs give the same bits."""
    import torch

    from image_restoration_tpu_torch.kernels import block as K

    for i, (h, w, c, heads) in enumerate(GATED_SHAPES):
        gen = torch.Generator().manual_seed(900 + i)
        temp = torch.exp(0.3 * torch.randn(2, heads, generator=gen))
        gate = torch.sigmoid(torch.randn(2, c, generator=gen))
        p = random_block(c, heads, seed=950 + i)._replace(
            temperature=temp.cuda())
        gate = gate.cuda()
        x = torch.randn((2, h, w, c), generator=gen).to("cuda",
                                                         torch.bfloat16)
        shape = f"2x{h}x{w}x{c} heads {heads}"
        kern = K.fused_block(x, p, heads, gate=gate)
        torch.cuda.synchronize()
        msg = _check_rule("gated fused_block", shape, kern,
                          K.reference_block(x, p, heads, gate=gate),
                          K.reference_block(x.float(), p, heads, gate=gate))
        check_twice_and_batch2("gated fused_block", shape,
                               lambda: K.fused_block(x, p, heads, gate=gate),
                               kern)
        print(f"gated fused_block {shape}: rel err {msg}", flush=True)


def _zero_pads(name, shape, t, lay, slots=1):
    """Checks that every pad channel of ``t``'s last axis in the padded
    layout ``lay`` is exactly 0."""
    parts = t.reshape(*t.shape[:-1], slots * lay.heads, lay.chp)
    n = int(parts[..., lay.ch:].count_nonzero().item())
    check(n == 0, f"{name} at {shape}: {n} pad values are not 0")


def _api_rule(name, shape, api, plain, oracle):
    """A kernel API at a padded width against its plain composition at the
    real width: phase 2's rule on each output (``oracle``: the fp32 plain
    composition) and two bit-equal runs. Returns the API's output, the
    plain one and the message."""
    import torch

    kern, pl = api(), plain()
    torch.cuda.synchronize()
    msg = "; ".join(_check_rule(name, shape, k, p, o) for k, p, o in zip(
        _outputs(kern), _outputs(pl), _outputs(oracle())))
    check_twice_and_batch2(name, shape, api, kern)
    return kern, pl, msg


def _dev_ms(fn):
    """``time_cuda`` of ``fn`` with the spin's head start at least twice
    the host time of one call (10 reps after 2): the padded APIs enqueue
    tens of small launches a call, which a 2 ms head start does not cover
    on a slow host, and then the events would time the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return time_cuda(fn, reps=10, warmup=2,
                     head_start_ms=max(2.0, 2.0 * host_ms))


def phase_width_kernels():
    """Phase 2w: the kernel APIs at the widths they run padded
    (``kernels/widths.py``), on the card. At DIM24_LEVELS, ``fused_block``
    (K1, the finalize at the real width, K2) and the three-kernel block's
    ``ln_qkv_dwconv`` (K4), ``fused_mdta_core`` (K5, K6) and
    ``fused_ln_gdfn`` (K3); at DRS24_LEVELS ``fused_drs_block`` (K1, K7);
    ``fused_mefc_steps`` (K8) at MEFC24_STEPS; CG-IR's gated pair at
    GATED24_SHAPE. Each is held to its plain composition at the real width
    by phase 2's rule, two runs give the same bits, and every pad channel
    of each raw launch's output in the padded space is exactly 0. Times:
    each API call against its plain composition, and of the API's time the
    activation pad + unpad copies and the weight padding (CUDA-event
    medians, ``_dev_ms``), and the pair's host ms a call. Returns the raw
    launches' report (real-width bounds)."""
    import torch
    import torch.nn.functional as F

    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import block as K
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KQ
    from image_restoration_tpu_torch.kernels import mefc as KM
    from image_restoration_tpu_torch.kernels.widths import (
        flat_layout, pad_channels, pad_square, real_stats, unpad_channels,
    )

    report = _new_report(("block_front", "block_apply_gdfn", "ln_qkv_dwconv",
                          "attn_acc", "attn_apply", "ln_gdfn",
                          "drs_apply_msfn", "mefc_step"))
    eps = 1e-5
    per_forward = {k: 0.0 for k in ("pair", "pair plain", "pair copies",
                                    "pair weights", "3k", "3k plain",
                                    "3k copies", "3k weights", "pair host",
                                    "pair host weights", "pair host plain")}

    def plain_pair(x, p, heads, gate=None):
        v, gram, ss = K.block_front_ref(x, p.front(), heads, eps)
        atw = K.finalize(gram, ss, p.temperature, p.proj_w, x.dtype, gate)
        return K.block_apply_gdfn_ref(v, x, atw, p, eps)

    def plain_core(qkv, x, p, heads):
        gram, ss = KA.attn_acc_ref(qkv, heads)
        at = KA.finalize_at(gram, ss, p.temperature, x.dtype)
        return KA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b)

    def record(name, hwc, n, t_k, t_p, kern, plain, bound):
        _record(report, name, hwc, n, t_k, t_p,
                (kern.float() - plain.float()).abs().max().item(), bound)

    for i, (h, w, c, heads, n) in enumerate(DIM24_LEVELS):
        p = random_block(c, heads, seed=2600 + i)
        gen = torch.Generator().manual_seed(2700 + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda",
                                                         torch.bfloat16)
        shape, hwc = f"1x{h}x{w}x{c} heads {heads}", [1, h, w, c]

        # the pair, in K1's layout
        lay = K.front_layout(c, heads)
        check(lay.padded, f"2w: {shape} is not padded")
        out, _, msg = _api_rule(
            "fused_block (padded)", shape, lambda: K.fused_block(x, p, heads),
            lambda: plain_pair(x, p, heads),
            lambda: plain_pair(x.float(), p, heads))
        xp, pp = pad_channels(x, lay), K.pad_block_params(p, lay)
        v, gram, ss = K.block_front(xp, pp.front(), heads, eps, c)
        for t in (v, ss):
            _zero_pads("block_front (padded)", shape, t, lay)
        check(int(gram[..., lay.ch:, :].count_nonzero().item()) == 0 and int(
            gram[..., lay.ch:].count_nonzero().item()) == 0,
              f"block_front (padded) at {shape}: a Gram pad is not 0")
        atw = pad_square(K.finalize(*real_stats(gram, ss, lay), p.temperature,
                                    p.proj_w, x.dtype), lay)
        outp = K.block_apply_gdfn(v, xp, atw, pp, eps, c)
        _zero_pads("block_apply_gdfn (padded)", shape, outp, lay)
        vr, gr, sr = K.block_front_ref(x, p.front(), heads, eps)
        atr = K.finalize(gr, sr, p.temperature, p.proj_w, x.dtype)
        t_api = _dev_ms(lambda: K.fused_block(x, p, heads))
        t_plain = _dev_ms(lambda: plain_pair(x, p, heads))
        t_copies = _dev_ms(lambda: (pad_channels(x, lay),
                                      unpad_channels(outp, lay)))
        t_weights = _dev_ms(lambda: K.pad_block_params(p, lay))
        t_k1 = _dev_ms(lambda: K.block_front(xp, pp.front(), heads, eps, c))
        t_k2 = _dev_ms(lambda: K.block_apply_gdfn(v, xp, atw, pp, eps, c))
        # host ms a call, on a 16x16 map so that the card keeps up
        xs = x[:, :16, :16].contiguous()
        h_api = _host_ms(lambda: K.fused_block(xs, p, heads), 50)
        h_weights = _host_ms(lambda: K.pad_block_params(p, lay), 50)
        h_plain = _host_ms(lambda: plain_pair(xs, p, heads), 50)
        record("block_front", hwc, n, t_k1,
               _dev_ms(lambda: K.block_front_ref(x, p.front(), heads, eps)),
               unpad_channels(v, lay), vr, bound_block_front(h, w, c, heads))
        record("block_apply_gdfn", hwc, n, t_k2,
               _dev_ms(lambda: K.block_apply_gdfn_ref(vr, x, atr, p, eps)),
               out, plain_pair(x, p, heads), bound_block_apply_gdfn(h, w, c))
        print(f"2w fused_block {shape} padded to {lay.cp} ({lay.heads} x "
              f"{lay.chp}): rel err {msg}; API {t_api:.4f} ms (K1 {t_k1:.4f},"
              f" K2 {t_k2:.4f}, x pad + out unpad {t_copies:.4f}, weight "
              f"padding {t_weights:.4f}), plain {t_plain:.4f} ms; host ms a "
              f"call: API {h_api:.4f} (weight padding {h_weights:.4f}), "
              f"plain {h_plain:.4f}", flush=True)
        for k, t in (("pair", t_api), ("pair plain", t_plain),
                     ("pair copies", t_copies), ("pair weights", t_weights),
                     ("pair host", h_api), ("pair host weights", h_weights),
                     ("pair host plain", h_plain)):
            per_forward[k] += n * t

        # the three-kernel block: K4 and K3 flat, K5 and K6 in their layout
        f, g = p.front(), p.gdfn()
        flat, att = flat_layout(c), KA.attn_layout(c, heads)
        qkv, qkv_plain, msg4 = _api_rule(
            "ln_qkv_dwconv (padded)", shape, lambda: KQ.ln_qkv_dwconv(x, f),
            lambda: KQ.ln_qkv_dwconv_ref(x, f, eps),
            lambda: KQ.ln_qkv_dwconv_ref(x.float(), f, eps))
        core, core_plain, msg56 = _api_rule(
            "fused_mdta_core (padded)", shape,
            lambda: KA.fused_mdta_core(qkv_plain, x, p.temperature, p.proj_w,
                                       p.proj_b, heads),
            lambda: plain_core(qkv_plain, x, p, heads),
            lambda: plain_core(qkv_plain.float(), x.float(), p, heads))
        gd, gd_plain, msg3 = _api_rule(
            "fused_ln_gdfn (padded)", shape, lambda: KG.fused_ln_gdfn(x, g),
            lambda: KG.ln_gdfn_ref(x, g, eps),
            lambda: KG.ln_gdfn_ref(x.float(), g, eps))
        xf, ff = pad_channels(x, flat), K.pad_front_params(f, flat)
        gf = K.pad_gdfn_params(g, flat)
        qkv_f = KQ._ln_qkv_dwconv(xf, ff, eps, c)
        gd_f = KG._fused_ln_gdfn(xf, gf, eps, c)
        _zero_pads("ln_qkv_dwconv (padded)", shape, qkv_f, flat, 3)
        _zero_pads("ln_gdfn (padded)", shape, gd_f, flat)
        qa, xa = pad_channels(qkv_plain, att, 3), pad_channels(x, att)
        ga, sa = KA.attn_acc(qa, heads)
        _zero_pads("attn_acc (padded)", shape, sa, att)
        d = att.chp - att.ch
        at = F.pad(KA.finalize_at(*real_stats(ga, sa, att), p.temperature,
                                  x.dtype), (0, d, 0, d))
        wa = pad_channels(pad_channels(p.proj_w, att, dim=0), att, dim=1)
        ba = pad_channels(p.proj_b, att, dim=0)
        core_a = KA.attn_apply(qa, xa, at, wa, ba)
        _zero_pads("attn_apply (padded)", shape, core_a, att)

        def three(x):
            qkv = KQ.ln_qkv_dwconv(x, f)
            x = KA.fused_mdta_core(qkv, x, p.temperature, p.proj_w, p.proj_b,
                                   heads)
            return KG.fused_ln_gdfn(x, g)

        def three_plain(x):
            qkv = KQ.ln_qkv_dwconv_ref(x, f, eps)
            return KG.ln_gdfn_ref(plain_core(qkv, x, p, heads), g, eps)

        def copies():  # the three APIs' activation pads and unpads
            pad_channels(x, flat)
            unpad_channels(qkv_f, flat, 3)
            pad_channels(qkv, att, 3)
            pad_channels(x, att)
            unpad_channels(core_a, att)
            pad_channels(x, flat)
            unpad_channels(gd_f, flat)

        def weights():
            K.pad_front_params(f, flat)
            pad_channels(pad_channels(p.proj_w, att, dim=0), att, dim=1)
            K.pad_gdfn_params(g, flat)

        t3 = _dev_ms(lambda: three(x))
        t3p = _dev_ms(lambda: three_plain(x))
        t3c, t3w = _dev_ms(copies), _dev_ms(weights)
        t_k4 = _dev_ms(lambda: KQ._ln_qkv_dwconv(xf, ff, eps, c))
        t_k5 = _dev_ms(lambda: KA.attn_acc(qa, heads))
        t_k6 = _dev_ms(lambda: KA.attn_apply(qa, xa, at, wa, ba))
        t_k3 = _dev_ms(lambda: KG._fused_ln_gdfn(xf, gf, eps, c))
        record("ln_qkv_dwconv", hwc, n, t_k4,
               _dev_ms(lambda: KQ.ln_qkv_dwconv_ref(x, f, eps)), qkv,
               qkv_plain, bound_ln_qkv_dwconv(h, w, c))
        record("attn_acc", hwc, n, t_k5,
               _dev_ms(lambda: KA.attn_acc_ref(qkv_plain, heads)),
               real_stats(ga, sa, att)[1],
               KA.attn_acc_ref(qkv_plain, heads)[1],
               bound_attn_acc(h, w, c, heads))
        record("attn_apply", hwc, n, t_k6,
               _dev_ms(lambda: plain_core(qkv_plain, x, p, heads)), core,
               core_plain, bound_attn_apply(h, w, c, heads))
        record("ln_gdfn", hwc, n, t_k3,
               _dev_ms(lambda: KG.ln_gdfn_ref(x, g, eps)), gd, gd_plain,
               bound_ln_gdfn(h, w, c))
        print(f"2w three-kernel block {shape}: K4 (flat {flat.cp}) rel err "
              f"{msg4}; K5/K6 ({att.heads} x {att.chp}) {msg56}; K3 (flat "
              f"{flat.cp}) {msg3}; the block's APIs {t3:.4f} ms (K4 "
              f"{t_k4:.4f}, K5 {t_k5:.4f}, K6 {t_k6:.4f}, K3 {t_k3:.4f}, pad "
              f"+ unpad copies {t3c:.4f}, weight padding {t3w:.4f}), plain "
              f"{t3p:.4f} ms", flush=True)
        for k, t in (("3k", t3), ("3k plain", t3p), ("3k copies", t3c),
                     ("3k weights", t3w)):
            per_forward[k] += n * t
        del qkv, qkv_plain, core, core_plain, gd, gd_plain, qa, xa, core_a

    for kind in ("pair", "3k"):
        t = per_forward[kind]
        print(f"2w Restormer dim 24 {kind} over the "
              f"{sum(lv[-1] for lv in DIM24_LEVELS)} padded blocks of a "
              f"512x512 forward: API {t:.4f} ms, plain "
              f"{per_forward[kind + ' plain']:.4f} ms; activation pad + "
              f"unpad copies {per_forward[kind + ' copies']:.4f} ms "
              f"({100 * per_forward[kind + ' copies'] / t:.1f}%), weight "
              f"padding {per_forward[kind + ' weights']:.4f} ms "
              f"({100 * per_forward[kind + ' weights'] / t:.1f}%)",
              flush=True)
    print(f"2w Restormer dim 24 pair, host ms over the 12 blocks: API "
          f"{per_forward['pair host']:.4f} (weight padding "
          f"{per_forward['pair host weights']:.4f}), plain "
          f"{per_forward['pair host plain']:.4f}", flush=True)

    t_drs = t_drs_plain = t_drs_copies = 0.0
    for i, (h, w, c, heads, n) in enumerate(DRS24_LEVELS):
        p = random_drs_block(c, heads, seed=2800 + i)
        gen = torch.Generator().manual_seed(2900 + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda",
                                                         torch.bfloat16)
        shape, hwc = f"1x{h}x{w}x{c} heads {heads}", [1, h, w, c]

        def plain_drs(x):
            v, gram, ss = K.block_front_ref(x, p.front(), heads, eps)
            atw = KD.tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w,
                                   x.dtype)
            return KD.drs_apply_msfn_ref(v, x, atw, p, eps)

        out, plain, msg = _api_rule(
            "fused_drs_block (padded)", shape,
            lambda: KD.fused_drs_block(x, p, heads), lambda: plain_drs(x),
            lambda: plain_drs(x.float()))
        lay = K.front_layout(c, heads)
        xp, pp = pad_channels(x, lay), KD.pad_drs_params(p, lay)
        v, gram, ss = K.block_front(xp, pp.front(), heads, eps, c)
        _zero_pads("block_front (DRSformer, padded)", shape, v, lay)
        atw = pad_square(KD.tksa_finalize(*real_stats(gram, ss, lay),
                                          p.temperature, p.mix, p.proj_w,
                                          x.dtype), lay)
        vr, gr, sr = K.block_front_ref(x, p.front(), heads, eps)
        atr = KD.tksa_finalize(gr, sr, p.temperature, p.mix, p.proj_w,
                               x.dtype)
        outp = KD.drs_apply_msfn(v, xp, atw, pp, eps, c)
        _zero_pads("drs_apply_msfn (padded)", shape, outp, lay)
        t_api = _dev_ms(lambda: KD.fused_drs_block(x, p, heads))
        t_plain = _dev_ms(lambda: plain_drs(x))
        t_copies = _dev_ms(lambda: (pad_channels(x, lay),
                                      unpad_channels(outp, lay)))
        t_k7 = _dev_ms(lambda: KD.drs_apply_msfn(v, xp, atw, pp, eps, c))
        record("drs_apply_msfn", hwc, n, t_k7,
               _dev_ms(lambda: KD.drs_apply_msfn_ref(vr, x, atr, p, eps)),
               out, plain, bound_drs_apply_msfn(h, w, c))
        print(f"2w fused_drs_block {shape} padded to {lay.cp}: rel err {msg}"
              f"; API {t_api:.4f} ms (K7 {t_k7:.4f}, x pad + out unpad "
              f"{t_copies:.4f}), plain {t_plain:.4f} ms", flush=True)
        t_drs += n * t_api
        t_drs_plain += n * t_plain
        t_drs_copies += n * t_copies
    print(f"2w DRSformer dim 24 over the {sum(lv[-1] for lv in DRS24_LEVELS)} "
          f"padded blocks of a 512x512 forward: API {t_drs:.4f} ms, plain "
          f"{t_drs_plain:.4f} ms; activation pad + unpad copies "
          f"{t_drs_copies:.4f} ms ({100 * t_drs_copies / t_drs:.1f}%)",
          flush=True)

    h, w, c, n_steps = MEFC24_STEPS
    steps, mix = random_mefc_steps(c, n_steps, seed=3000)
    gen = torch.Generator().manual_seed(3001)
    x = torch.randn((1, h, w, c), generator=gen).abs().to("cuda",
                                                          torch.bfloat16)
    shape = f"1x{h}x{w}x{c}, {n_steps} steps"

    def plain_steps(x, dt):
        for st, sp in enumerate(steps):
            x = KM.mefc_step_ref(x, sp, KM.fold_step(sp, mix[:, st], dt))
        return x

    out, plain, msg = _api_rule(
        "fused_mefc_steps (padded)", shape,
        lambda: KM.fused_mefc_steps(x, steps, mix),
        lambda: plain_steps(x, torch.bfloat16),
        lambda: plain_steps(x.float(), torch.float32))
    lay = KM.mefc_layout(c)
    xp = pad_channels(x, lay)
    m = pad_square(KM.fold_step(steps[0], mix[:, 0], torch.bfloat16), lay)
    sp0 = KM.pad_step_params(steps[0], lay)
    _zero_pads("mefc_step (padded)", shape, KM.mefc_step(xp, sp0, m), lay)
    t_api = _dev_ms(lambda: KM.fused_mefc_steps(x, steps, mix))
    t_plain = _dev_ms(lambda: plain_steps(x, torch.bfloat16))
    m_r = KM.fold_step(steps[0], mix[:, 0], torch.bfloat16)
    record("mefc_step", [1, h, w, c], n_steps,
           _dev_ms(lambda: KM.mefc_step(xp, sp0, m)),
           _dev_ms(lambda: KM.mefc_step_ref(x, steps[0], m_r)), out, plain,
           bound_mefc_step(h, w, c))
    print(f"2w fused_mefc_steps {shape} padded to {lay.cp}: rel err {msg}; "
          f"API {t_api:.4f} ms, plain {t_plain:.4f} ms", flush=True)

    h, w, c, heads = GATED24_SHAPE
    gen = torch.Generator().manual_seed(3100)
    temp = torch.exp(0.3 * torch.randn(2, heads, generator=gen)).cuda()
    gate = torch.sigmoid(torch.randn(2, c, generator=gen)).cuda()
    p = random_block(c, heads, seed=3101)._replace(temperature=temp)
    x = torch.randn((2, h, w, c), generator=gen).to("cuda", torch.bfloat16)
    shape = f"2x{h}x{w}x{c} heads {heads}"
    _, _, msg = _api_rule(
        "gated fused_block (padded)", shape,
        lambda: K.fused_block(x, p, heads, gate=gate),
        lambda: plain_pair(x, p, heads, gate),
        lambda: plain_pair(x.float(), p, heads, gate))
    print(f"2w gated fused_block {shape} padded to "
          f"{K.front_layout(c, heads).cp}: rel err {msg}", flush=True)
    return report


def merge_path(report, extra, path):
    """Adds each kernel's per-shape rows of another path's shapes to
    ``report`` (tagged with ``path``) and that path's per-forward sums
    under ``by_path``; ``report``'s own sums stay the serving path's."""
    for name, r in extra.items():
        base = report[name]
        base["max_abs_err"] = max(base["max_abs_err"], r["max_abs_err"])
        base["per_shape"] += [dict(row, path=path) for row in r["per_shape"]]
        base.setdefault("by_path", {})[path] = {
            k: r[k] for k in ("ms", "plain_ms", "bound_ms")}


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


def phase_sweep(group, rows, warps=None, shapes="restormer"):
    """The kernels of ``group`` alone (``--tail``: K2 and K3, which share
    the GDFN tail; ``--front``: K1 and K4, which share the block front;
    ``--msfn``: K7 at DRSformer's shapes): phase 2's rule, two equal runs,
    a batch of two at the widest level, and the kernel's and plain
    version's times at the five block shapes, once per tile height in
    ``rows`` that fits the card (none given: the wrappers' own choice), in
    blocks of ``warps`` warps (None: the wrappers' own choice). With
    ``shapes`` "measnet" or "nerd_rain", K1 or K2 alone at that model's
    block shapes."""
    import torch

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    drs = group == "msfn"
    levels = DRS_LEVELS if drs else {
        "restormer": LEVELS, "measnet": MEASNET_LEVELS,
        "nerd_rain": NERD_LEVELS}[shapes]
    pair_only = shapes != "restormer"
    widest = max(lv[2] for lv in levels)
    sums = {}
    for i, (h, w, c, heads, n_blocks) in enumerate(levels):
        p = (random_drs_block(c, heads, seed=300 + i) if drs
             else random_block(c, heads, seed=100 + i))
        gen = torch.Generator().manual_seed((400 if drs else 200) + i)
        x = torch.randn((1, h, w, c), generator=gen).to("cuda", torch.bfloat16)
        for name, (kern_fn, plain_fn, oracle_fn, batch2, mod, rows_table,
                   warps_table, warps_of, smem_of) in _sweep_calls(
                       group, x, p, heads, c).items():
            if pair_only and name not in ("block_front", "block_apply_gdfn"):
                continue
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
                                           batch2 if c == widest else None)
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


def phase_3k_kernels(levels=LEVELS, batch=1, tag=""):
    """K4, K5, K6 and K3 at ``levels`` (Restormer-base's serving shapes by
    default) on a batch of ``batch``, each on its plain version's inputs,
    against the plain version with the fp32 plain chain as the oracle; a
    batch of two at the widest level when ``batch`` is 1. Printed with
    ``tag``."""
    import torch

    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KM

    report = _new_report(("ln_gdfn", "ln_qkv_dwconv", "attn_acc",
                          "attn_apply"))
    widest = max(lv[2] for lv in levels) if batch == 1 else None
    for i, (h, w, c, heads, n_blocks) in enumerate(levels):
        p = random_block(c, heads, seed=100 + i)
        gen = torch.Generator().manual_seed(200 + i)
        x = torch.randn((batch, h, w, c), generator=gen).to("cuda",
                                                            torch.bfloat16)
        shape = f"{batch}x{h}x{w}x{c} heads {heads}"
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
            print(f"{tag}{name} {shape}: rel err {msg}; kernel {t_k:.4f} "
                  f"ms, plain {t_p:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]})", flush=True)
            _record(report, name, [batch, h, w, c], n_blocks, t_k, t_p,
                    (kerns[0].float() - plains[0].float()).abs().max().item(),
                    bound)
            return plains

        oqkv = KM.ln_qkv_dwconv_ref(x.float(), f)
        (qkv,) = run("ln_qkv_dwconv", lambda: KM.ln_qkv_dwconv(x, f),
                     lambda: KM.ln_qkv_dwconv_ref(x, f), oqkv,
                     bound_ln_qkv_dwconv(h, w, c, batch))
        check_twice_and_batch2(
            "ln_qkv_dwconv", shape, lambda: KM.ln_qkv_dwconv(x, f),
            KM.ln_qkv_dwconv(x, f),
            _batch2(KM.ln_qkv_dwconv, KM.ln_qkv_dwconv_ref, (x,), f)
            if c == widest else None)
        # K5 and its plain version widen the same bf16 map exactly, so both
        # errors against the oracle are the map's rounding; the kernel is
        # also held to its plain version: fp32 sums in another order.
        gram, ss = run("attn_acc", lambda: KA.attn_acc(qkv, heads),
                       lambda: KA.attn_acc_ref(qkv, heads),
                       KA.attn_acc_ref(oqkv, heads),
                       bound_attn_acc(h, w, c, heads, batch), to_plain=1e-5)
        at = KA.finalize_at(gram, ss, p.temperature, torch.bfloat16)
        check_attn_twice_and_batch2(shape, qkv, x, at, p, heads, c == widest)
        oracle = KA.attn_apply_ref(qkv.float(), x.float(), at.float(),
                                   p.proj_w, p.proj_b)
        del oqkv
        (x2,) = run("attn_apply",
                    lambda: KA.attn_apply(qkv, x, at, p.proj_w, p.proj_b),
                    lambda: KA.attn_apply_ref(qkv, x, at, p.proj_w, p.proj_b),
                    oracle, bound_attn_apply(h, w, c, heads, batch))
        g = p.gdfn()
        run("ln_gdfn", lambda: KG.fused_ln_gdfn(x2, g),
            lambda: KG.ln_gdfn_ref(x2, g), KG.ln_gdfn_ref(x2.float(), g),
            bound_ln_gdfn(h, w, c, batch))
        check_twice_and_batch2(
            "ln_gdfn", shape, lambda: KG.fused_ln_gdfn(x2, g),
            KG.fused_ln_gdfn(x2, g),
            _batch2(KG.fused_ln_gdfn, KG.ln_gdfn_ref, (x2,), g)
            if c == widest else None)
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


def phase_drs_kernels(levels=DRS_LEVELS, mefc=MEFC_STEPS, batch=1, tag="",
                      front=False):
    """K7 at DRSformer's block shapes ``levels`` and K8 at its MEFC steps
    ``mefc`` (the 512x512 serving forward's by default) on a batch of
    ``batch``: phase 2's rule, two equal runs, a batch of two at the widest
    level (when ``batch`` is 1), the times; printed with ``tag``. With
    ``front``, K1 at the blocks' shapes too (DRSformer's front: LN with
    bias, no conv bias), in the report as "block_front"."""
    import torch

    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as K
    from image_restoration_tpu_torch.kernels import mefc as M

    report = _new_report(("drs_apply_msfn", "mefc_step")
                         + (("block_front",) if front else ()))
    widest = max(lv[2] for lv in levels) if batch == 1 else None
    for i, (h, w, c, heads, n_blocks) in enumerate(levels):
        p = random_drs_block(c, heads, seed=300 + i)
        gen = torch.Generator().manual_seed(400 + i)
        x = torch.randn((batch, h, w, c), generator=gen).to("cuda",
                                                            torch.bfloat16)
        shape = f"{batch}x{h}x{w}x{c}"
        v, gram, ss = KB.block_front_ref(x, p.front(), heads)
        if front:
            kern = KB.block_front(x, p.front(), heads)
            torch.cuda.synchronize()
            msg = "; ".join(_check_rule("block_front", f"DRSformer {shape}",
                                        k, pl, o) for k, pl, o in zip(
                kern, (v, gram, ss), KB.block_front_ref(x.float(), p.front(),
                                                        heads)))
            check_twice_and_batch2(
                "block_front", f"DRSformer {shape}",
                lambda: KB.block_front(x, p.front(), heads), kern)
            t_k = time_cuda(lambda: KB.block_front(x, p.front(), heads))
            t_p = time_cuda(lambda: KB.block_front_ref(x, p.front(), heads))
            print(f"{tag}block_front DRSformer {shape} heads {heads}: rel "
                  f"err {msg}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms",
                  flush=True)
            _record(report, "block_front", [batch, h, w, c], n_blocks, t_k,
                    t_p, (kern[0].float() - v.float()).abs().max().item(),
                    bound_block_front(h, w, c, heads, batch))
        atw = K.tksa_finalize(gram, ss, p.temperature, p.mix, p.proj_w,
                              torch.bfloat16)
        oracle = K.drs_apply_msfn_ref(v.float(), x.float(), atw.float(), p)
        plain = K.drs_apply_msfn_ref(v, x, atw, p)
        kern = K.drs_apply_msfn(v, x, atw, p)
        torch.cuda.synchronize()
        ek, ep = rel_err(kern, oracle), rel_err(plain, oracle)
        check(torch.isfinite(kern).all().item(),
              f"drs_apply_msfn not finite at {shape}")
        check(ek < _bound(ep), f"drs_apply_msfn at {shape}: rel err "
              f"{ek:.3e} above max(3 x {ep:.3e}, 4e-3)")
        del oracle
        check_twice_and_batch2(
            "drs_apply_msfn", shape,
            lambda: K.drs_apply_msfn(v, x, atw, p), kern,
            _batch2(K.drs_apply_msfn, K.drs_apply_msfn_ref, (v, x, atw), p)
            if c == widest else None)
        t_k = time_cuda(lambda: K.drs_apply_msfn(v, x, atw, p))
        t_p = time_cuda(lambda: K.drs_apply_msfn_ref(v, x, atw, p))
        print(f"{tag}drs_apply_msfn {shape} heads {heads}: rel err "
              f"{ek:.3e} (plain {ep:.3e}); kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms", flush=True)
        _record(report, "drs_apply_msfn", [batch, h, w, c], n_blocks, t_k,
                t_p, (kern.float() - plain.float()).abs().max().item(),
                bound_drs_apply_msfn(h, w, c, batch))

    for i, (h, w, c, n_steps) in enumerate(mefc):
        t_k, t_p, msg, abs_err = _mefc_shape(i, h, w, c, n_steps,
                                             batch2=batch == 1 and c == 96,
                                             batch=batch)
        print(f"{tag}mefc_step {batch}x{h}x{w}x{c}, {n_steps} steps: rel "
              f"err {msg}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median "
              f"over the steps)", flush=True)
        _record(report, "mefc_step", [batch, h, w, c], n_steps, t_k, t_p,
                abs_err, bound_mefc_step(h, w, c, batch))
    return report


def _mefc_shape(i, h, w, c, n_steps, batch2, plain=True, batch=1):
    """K8 at shape ``i`` of MEFC_STEPS (or of MEFC_TRAIN_STEPS) on a batch
    of ``batch`` whose images have their own mix weights, each step on the
    plain chain's input: phase 2's rule, two bit-equal runs and, with
    ``batch2``, the rule on a batch of two whose images have different mix
    weights (the second image's M has its ops flipped). Returns the
    kernel's and (with ``plain``) the plain version's median ms over the
    steps, the errors and the max |kernel - plain|."""
    import torch

    from image_restoration_tpu_torch.kernels import mefc as M

    steps, mix = random_mefc_steps(c, n_steps, seed=500 + i)
    gen = torch.Generator().manual_seed(600 + i)
    if batch > 1:
        mix = torch.softmax(torch.randn((batch, n_steps, 8), generator=gen),
                            -1).to("cuda", torch.bfloat16)
    x = torch.randn((batch, h, w, c), generator=gen).abs()
    x = x.to("cuda", torch.bfloat16)
    errs, t_ks, t_ps, abs_err = [], [], [], 0.0
    for st, sp in enumerate(steps):
        where = f"{batch}x{h}x{w}x{c} step {st}"
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


def plain_variant(cfg, model, bf16):
    """``model``'s weights in the model that ``cfg`` builds with every
    kernel flag off, computing in bf16 or fp32: the plain model the kernel
    model is held to."""
    from image_restoration_tpu_torch.cli.train import build_model

    mk = cfg["model_kwargs"]
    off = {k: False for k in KERNEL_FLAGS if k in mk}
    m = build_model(dict(cfg, bf16=bf16, model_kwargs=dict(mk, **off)))
    m.load_state_dict(model.state_dict())
    return m


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


def perturb_biases(model, seed):
    """Seeded biases (0.1 x a standard normal) for every parameter named
    ``bias``: the init's are zero, as the JAX package's, so a path that
    dropped a bias would agree with its plain version."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


def phase_slice(gpu, profile_dir, model_name, counters, expected,
                overrides=(), tag=None, perturb=None, kernel_free=False,
                inspect=None):
    """Serve ``model_name`` from ``build_model`` with its serving defaults
    and the ``--set`` ``overrides`` (its seeded weights passed through
    ``perturb`` first, if given): three restores with the ``counters``
    (name -> wrapper) set to 0 just before and read just after, each
    expected to count ``expected[name]`` per forward; then the agreement
    with the plain fp32 model (every kernel flag off) and the timings,
    printed under ``tag``. The serving defaults must turn a kernel path on,
    or, with ``kernel_free``, must have no kernel flag at all (a model the
    JAX package serves without a Pallas kernel). ``inspect(tag, model,
    plain16, plain32, x)``, if given, runs beside the agreement check.
    Returns the launch counts."""
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
    if kernel_free:
        check(cfg["bf16"] and not set(mk) & set(KERNEL_FLAGS),
              f"{tag}: not bf16, or a kernel flag in a kernel-free model")
    else:
        check(cfg["bf16"] and (mk.get("fused_block") or (
            mk.get("fused_attn") and mk.get("fused_gdfn"))),
              f"{tag}: not bf16 with fused blocks or the three-kernel block")
    model = load_params(cfg, build_model(cfg))
    if perturb is not None:
        perturb(model)
    restore = make_restore_fn(cfg, model)
    print(f"{tag} serving: pad_multiple {cfg['pad_multiple']}", flush=True)
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

    def image(out):  # NeRD-Rain returns its 7 scales, the restoration first
        return out[0] if isinstance(out, tuple) else out

    plain32 = plain_variant(cfg, model, False)
    plain16 = plain_variant(cfg, model, True)
    with torch.inference_mode():
        out_fused = image(model(x))
        out_ref = image(plain32(x))
        out_plain = image(plain16(x))
    err_fused = (out_fused - out_ref).abs().max().item()
    err_plain = (out_plain - out_ref).abs().max().item()
    del out_ref, out_plain
    if inspect is not None:
        inspect(tag, model, plain16, plain32, x)
    del plain32, plain16
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


def _ska_inputs(i, h, w, c, wc, batch=LSNET_BATCH):
    """Shape ``i`` of SKA_SHAPES (or another table) at batch ``batch``: fp32
    x and w, their bf16 copies, the fp32 plain version (the oracle) and the
    bf16 one."""
    import torch

    from image_restoration_tpu_torch.ops.ska import ska_plain

    gen = torch.Generator(device="cuda").manual_seed(800 + i)
    x = torch.randn((batch, h, w, c), generator=gen, device="cuda")
    wt = torch.randn((batch, h, w, wc, 9), generator=gen, device="cuda")
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


def phase_ska_kernels(shapes=SKA_SHAPES, b=LSNET_BATCH, tag=""):
    """K9 against ska_plain at ``shapes`` (LSNet-B's by default) on a batch
    of ``b``, bf16 and fp32; printed with ``tag``."""
    from image_restoration_tpu_torch.kernels import ska as K
    from image_restoration_tpu_torch.ops.ska import ska_plain

    report = _new_report(("ska",))
    for i, (h, w, c, wc, calls) in enumerate(shapes):
        x, wt, xb, wb, oracle, plain = _ska_inputs(i, h, w, c, wc, b)
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
        print(f"{tag}ska {b}x{h}x{w}x{c} wc {wc}: bf16 rel err {ek:.3e} "
              f"(plain {ep:.3e}), kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
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


def _perturbed_batchnorm(m, randn):
    """Seeded running statistics and affine of BatchNorm ``m``."""
    m.running_mean.copy_(0.1 * randn(m.running_mean))
    m.running_var.copy_(0.5 + randn(m.running_var).abs())
    m.weight.add_(0.1 * randn(m.weight))
    m.bias.add_(0.1 * randn(m.bias))


def _randn_from(seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return lambda like: torch.randn(like.shape, generator=gen).to(like.device)


def calibrate_batchnorm(model, x):
    """Every BatchNorm's running statistics set to the batch statistics of
    one train-mode forward of ``x`` (NCHW), each BN normalizing what the
    ones before it normalized: a random LSNet then keeps its activations
    and logits at unit scale, as a trained one does. With the init's
    statistics (mean 0, variance 1) its logits grow to ~1e8 through the
    residual stages, the softmax saturates and the input gradient is 0."""
    import torch
    from torch import nn

    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    was_training = model.training
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: one batch's statistics
    model.train()
    with torch.no_grad():
        model(x)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    model.train(was_training)


def perturb_lsnet(model, seed, x):
    """Seeded, non-trivial BatchNorm affines and LeViT attention biases,
    so no BN is the identity and every bias counts, and the BatchNorm
    statistics of :func:`calibrate_batchnorm` on the images ``x``."""
    import torch
    from torch import nn

    from image_restoration_tpu_torch.models.lsnet import LeViTAttention

    randn = _randn_from(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                _perturbed_batchnorm(m, randn)
            elif isinstance(m, LeViTAttention):
                m.attention_biases.copy_(0.2 * randn(m.attention_biases))
    calibrate_batchnorm(model, x)


def perturb_measnet(model, seed):
    """Seeded BatchNorm statistics and affines in every FD, as
    ``perturb_lsnet`` gives them, and non-trivial ``param_alpha`` and
    ``param_beta`` in every FreqBlock: the init's zero alpha makes a
    FreqBlock return its input, so nothing it computes would reach the
    output."""
    import torch
    from torch import nn

    from image_restoration_tpu_torch.models.measnet import FreqBlock

    randn = _randn_from(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                _perturbed_batchnorm(m, randn)
            elif isinstance(m, FreqBlock):
                m.param_alpha.copy_(0.5 * randn(m.param_alpha))
                m.param_beta.copy_(1.0 + 0.2 * randn(m.param_beta))


def perturb_igmoce(model, seed):
    """Seeded, non-trivial residual scales in IGMoCE-IR: every
    IGEncoderBlock's ``gamma`` (its attention and gate branches) and
    ``beta`` (its FFN), and every SpAM's ``beta``, start at zero, so at
    the init nothing those branches compute would reach the output."""
    import torch

    from image_restoration_tpu_torch.models.igmoce_ir import (
        IGEncoderBlock,
        SpAM,
    )

    randn = _randn_from(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (IGEncoderBlock, SpAM)):
                m.beta.copy_(0.5 * randn(m.beta))
            if isinstance(m, IGEncoderBlock):
                m.gamma.copy_(0.5 * randn(m.gamma))


def _record_routes(model):
    """Hooks on every MoE router of ``model``: each call appends (picks,
    the smallest gap between the k-th and (k+1)-th softmax score). Returns
    the list and the hooks' handles."""
    import torch

    from image_restoration_tpu_torch.models.moce_ir import RoutingFunction
    from image_restoration_tpu_torch.models.moce_ir_patch import (
        PatchRoutingFunction,
    )

    routes = []

    def hook(mod, inputs, out):
        s = torch.sort(torch.softmax(mod.logits(*inputs), -1), -1,
                       descending=True).values
        routes.append((out[1].tolist(),
                       (s[:, mod.k - 1] - s[:, mod.k]).min().item()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (RoutingFunction, PatchRoutingFunction))]
    return routes, handles


def host_syncs(fn):
    """The host syncs ``fn`` makes, as {"file:line": count} of the
    innermost frame of this repository's code that led to each: CUDA's
    sync debug mode warns at each ("called a synchronizing CUDA
    operation"; turning the mode on warns once that it is a prototype)."""
    import collections
    import os
    import traceback
    import warnings

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    seen = collections.Counter()

    def record(message, category, filename, lineno, *rest):
        if "called a synchronizing" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(here)]
        f = ours[-1] if ours else None
        seen[f"{os.path.relpath(f.filename, here)}:{f.lineno}" if f
             else f"{os.path.basename(filename)}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return seen


def inspect_routes(strict):
    """``phase_slice``'s ``inspect`` for the MoCE family: each router's
    picks in the kernel bf16, plain bf16 and plain fp32 models and the
    smallest top-k gap over them, and the host syncs of one kernel-model
    forward. With ``strict`` a pick of the kernel model that differs from
    the plain fp32 model's fails the phase."""
    import torch

    def inspect(tag, model, plain16, plain32, x):
        picks = {}
        for name, m in (("kernel bf16", model), ("plain bf16", plain16),
                        ("plain fp32", plain32)):
            routes, handles = _record_routes(m)
            with torch.inference_mode():
                m(x)
            for h in handles:
                h.remove()
            picks[name] = routes
            flat = [p for r, _ in routes for row in r for p in row]
            shown = (str([r[0][0] for r, _ in routes]) if len(flat) == len(
                routes) else f"{len(flat)} picks over {len(routes)} routers")
            print(f"{tag} routing {name}: picks {shown}, smallest top-k gap "
                  f"{min(g for _, g in routes):.4e}", flush=True)
        diff = [i for i, (a, b) in enumerate(zip(picks["kernel bf16"],
                                                 picks["plain fp32"]))
                if a[0] != b[0]]
        print(f"{tag} routing: routers whose picks differ between the kernel "
              f"bf16 and plain fp32 models: {diff or 'none'}", flush=True)
        if strict:
            check(not diff, f"{tag}: routers {diff} pick other experts in "
                  f"the kernel model than in the plain fp32 model")
        with torch.inference_mode():
            syncs = host_syncs(lambda: model(x))
        print(f"{tag} serving: {sum(syncs.values())} host syncs a forward "
              f"({dict(syncs)})", flush=True)

    return inspect


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
    n_params = sum(p.numel() for p in model.parameters())
    b = LSNET_BATCH
    gen = torch.Generator(device="cuda").manual_seed(0)
    mean = torch.from_numpy(IMAGENET_MEAN).cuda()
    std = torch.from_numpy(IMAGENET_STD).cuda()
    batches = [((torch.rand((b, 224, 224, 3), generator=gen, device="cuda")
                 - mean) / std,
                torch.randint(0, 1000, (b,), generator=gen, device="cuda"))
               for _ in range(4)]
    # the BatchNorm statistics from a fourth batch, not one of the scored
    perturb_lsnet(model, seed=700, x=batches.pop()[0].permute(0, 3, 1, 2))
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
    ref, plain16 = (plain_variant(cfg, model, False),
                    plain_variant(cfg, model, True))
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


def _smooth_image(rng, h, w):
    """A seeded uint8 RGB image with structure at several scales (a sum of
    upsampled random fields), so that SSIM sees edges and flat areas."""
    img = np.zeros((h, w, 3))
    for cell, amp in ((64, 0.5), (16, 0.3), (4, 0.2)):
        lo = rng.random((-(-h // cell) + 1, -(-w // cell) + 1, 3))
        img += amp * np.kron(lo, np.ones((cell, cell, 1)))[:h, :w]
    return (img * 255).clip(0, 255).astype(np.uint8)


def write_eval_tree(root, seed=0):
    """Phase 3f's seeded benchmark tree under ``root``: Rain100L-shaped
    pairs (the input with seeded streak-like noise), BSD68-shaped clean
    images (the benchmark adds the noise) and one GoPro-shaped pair."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)

    def save(rel, arr):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path)

    def degrade(gt):
        noise = rng.standard_normal(gt.shape) * 12.0
        streaks = (rng.random(gt.shape[:2]) > 0.97)[..., None] * 80.0
        return np.clip(gt + noise + streaks, 0, 255).astype(np.uint8)

    for i, (h, w) in enumerate(EVAL_SIZES):
        gt = _smooth_image(rng, h, w)
        save(f"deraining/Rain100L/target/{i:03d}.png", gt)
        save(f"deraining/Rain100L/input/{i:03d}.png", degrade(gt))
        save(f"denoising/bsd68/{i:03d}.png", _smooth_image(rng, h, w))
    gt = _smooth_image(rng, *GOPRO_SIZE)
    save("deblurring/GoPro/test/target/000.png", gt)
    save("deblurring/GoPro/test/input/000.png", degrade(gt))


class _MetricProbe:
    """Stands in for ``eval/benchmarks.py``'s metrics module while a phase
    scores: each PSNR/SSIM call runs the real function between two CUDA
    events, and with ``keep`` the clipped output, the target and the value
    are kept for the host recomputation."""

    def __init__(self, metrics, keep):
        self.m, self.keep = metrics, keep
        self.events, self.kept = [], []

    def _timed(self, fn, out, gt, *rest):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        val = fn(out, gt, *rest)
        end.record()
        self.events.append((start, end))
        if self.keep:
            self.kept.append((fn.__name__, out[0].double().cpu().numpy(),
                              gt[0].double().cpu().numpy(), val))
        return val

    def __getattr__(self, name):
        return getattr(self.m, name)

    def psnr(self, out, gt):
        return self._timed(self.m.psnr, out, gt)

    def ssim(self, out, gt):
        return self._timed(self.m.ssim, out, gt)

    def psnr_yc(self, out, gt, crop_border=0):
        return self._timed(self.m.psnr_yc, out, gt, crop_border)

    def ssim_yc(self, out, gt, crop_border=0):
        return self._timed(self.m.ssim_yc, out, gt, crop_border)

    def ms(self):
        return sum(s.elapsed_time(e) for s, e in self.events)


@contextlib.contextmanager
def metric_probe(keep=False):
    from image_restoration_tpu_torch.eval import benchmarks as B

    saved = B.M
    B.M = probe = _MetricProbe(saved, keep)
    try:
        yield probe
    finally:
        B.M = saved


def host_psnr_ssim(out, gt, data_range=1.0, sample_covariance=True):
    """float64 PSNR and SSIM of (C, H, W) arrays by the skimage formula:
    gaussian weights sigma 1.5 truncated at 3.5 (radius 5), sample
    covariance (BasicSR's SSIM without it), the map cropped by the radius
    and averaged (scipy)."""
    from scipy.ndimage import gaussian_filter

    psnr = 10.0 * np.log10(data_range ** 2 / np.mean((out - gt) ** 2))

    def filt(a):
        return gaussian_filter(a, sigma=(0, 1.5, 1.5), truncate=3.5)

    cov = 121.0 / 120.0 if sample_covariance else 1.0
    ux, uy = filt(out), filt(gt)
    vx = cov * (filt(out * out) - ux * ux)
    vy = cov * (filt(gt * gt) - uy * uy)
    vxy = cov * (filt(out * gt) - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    return psnr, float(s[:, 5:-5, 5:-5].mean())


def host_psnr_ssim_y(out, gt, border):
    """float64 Y-channel PSNR and SSIM of (3, H, W) RGB arrays, the SR
    protocol of ``eval/metrics.py`` ``psnr_yc``/``ssim_yc``: BT.601 Y
    ('MATLAB' ycbcr), ``border`` pixels cropped, SSIM on the 0-255 scale
    without the sample covariance (BasicSR)."""
    w = np.array([65.481, 128.553, 24.966]) / 255.0

    def y(a):
        return (np.tensordot(w, a, 1) + 16.0 / 255.0)[
            None, border:-border, border:-border]

    yo, yg = y(out), y(gt)
    return (host_psnr_ssim(yo, yg)[0],
            host_psnr_ssim(yo * 255.0, yg * 255.0, 255.0, False)[1])


def _metrics_to_host(tag, kept, border=0):
    """Each image's on-card PSNR and SSIM (``kept`` pairs) within 1e-3 dB
    and 1e-4 of the float64 host recomputation (Y channel, ``border``
    cropped, when the benchmark scores so)."""
    worst = [0.0, 0.0]
    for (fn, out, gt, p), (_, _, _, s) in zip(kept[::2], kept[1::2]):
        host = (host_psnr_ssim_y(out, gt, border) if fn == "psnr_yc"
                else host_psnr_ssim(out, gt))
        dp, ds = abs(p.item() - host[0]), abs(s.item() - host[1])
        worst = [max(worst[0], dp), max(worst[1], ds)]
        check(dp <= 1e-3 and ds <= 1e-4,
              f"eval {tag} metrics at {out.shape}: card PSNR {p.item():.6f} "
              f"SSIM {s.item():.7f}, host float64 {host[0]:.6f} "
              f"{host[1]:.7f}")
    print(f"eval {tag}: {len(kept) // 2} images, on-card metrics vs float64 "
          f"host: max |dPSNR| {worst[0]:.3e} dB (limit 1e-3), max |dSSIM| "
          f"{worst[1]:.3e} (limit 1e-4)", flush=True)


def _eval_main(tag, argv, counters, expected, n_forwards):
    """``cli/test.py`` ``main(argv)`` with the launch ``counters`` set to 0
    just before and read just after, every clipped output and metric kept;
    checks the launches per forward, finite scores and results.json."""
    import json
    import os

    import torch

    from image_restoration_tpu_torch.cli import test as T

    for fn in counters.values():
        fn.launches = 0
    with metric_probe(keep=True) as probe:
        results = T.main(argv)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"eval {tag}: {n_forwards} forwards, launches {launches}; "
          + "; ".join(f"{b} PSNR {r['psnr']:.4f} dB SSIM {r['ssim']:.4f} "
                      f"n {r['n']}" for b, r in results.items()), flush=True)
    for name, n in launches.items():
        check(n == n_forwards * expected[name],
              f"eval {tag} {name}: {n} launches for {n_forwards} forwards, "
              f"expected {expected[name]} each")
    with open(os.path.join(argv[argv.index("--output_dir") + 1],
                           "results.json")) as f:
        check(json.load(f) == results, f"eval {tag}: results.json differs")
    for b, r in results.items():
        check(np.isfinite(r["psnr"]) and np.isfinite(r["ssim"]),
              f"eval {tag} {b}: non-finite scores {r}")
    check(len(probe.kept) == 2 * n_forwards,
          f"eval {tag}: {len(probe.kept)} metric calls")
    return launches, probe.kept


def _eval_times(gpu, tag, model, data):
    """ms/img of each benchmark: the host clock around ``run_benchmark``
    (the evaluate loop: read, copy, pad, forward, metrics, one readback),
    and inside it the forward and the metrics by CUDA events; then the
    forward's device time alone at the first image's padded shape (the
    host kept ahead by a spin, as phase 3 times it). Returns the first
    model input of each shape that the benchmarks fed the forward."""
    import torch

    from image_restoration_tpu_torch.cli.test import make_eval_fn
    from image_restoration_tpu_torch.eval.benchmarks import run_benchmark

    fn = make_eval_fn(model)
    device = next(model.parameters()).device
    by_shape = {}
    for bench in (EVAL_BENCHES if tag == "restormer" else ["derain"]):
        fwd_events, inputs = [], []

        def timed(x):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x)
            end.record()
            fwd_events.append((start, end))
            inputs.append(x)
            return out

        with metric_probe() as probe:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run_benchmark(bench, timed, data, device=device)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / r.n
        fwd = sum(s.elapsed_time(e) for s, e in fwd_events) / r.n
        x0 = inputs[0]
        alone = time_cuda(lambda: fn(x0), reps=10, head_start_ms=150.0)
        print(f"eval {tag} {bench} bf16 on {gpu}: {r.n} images, {host:.3f} "
              f"ms/img (evaluate loop, host clock), forward {fwd:.3f} ms/img, "
              f"metrics {probe.ms() / r.n:.3f} ms/img (CUDA events); forward "
              f"device time alone {alone:.3f} ms at {x0.shape[2]}x"
              f"{x0.shape[3]}", flush=True)
        for x in inputs:
            by_shape.setdefault((bench, tuple(x.shape[2:])), x)
    return by_shape


def _hold_to_plain(tag, model, plain32, plain16, inputs):
    """Phase 3's rule on each input the benchmarks fed ``model``: the kernel
    model's max |error| against the plain fp32 model within 3x the plain
    bf16 model's."""
    import torch

    from image_restoration_tpu_torch.utils.precision import full_fp32

    for (bench, (h, w)), x in inputs.items():
        with torch.inference_mode(), full_fp32():
            ref = plain32(x)
            err_k = (model(x).float() - ref).abs().max().item()
            err_p = (plain16(x).float() - ref).abs().max().item()
        del ref
        print(f"eval {tag} {bench} {h}x{w} (deep map {h // 8}x{w // 8}): max "
              f"|kernel bf16 - plain fp32| {err_k:.4e}, max |plain bf16 - "
              f"plain fp32| {err_p:.4e}", flush=True)
        check(np.isfinite(err_k) and err_k <= 3.0 * err_p,
              f"eval {tag} {bench} at {h}x{w}: kernel model error "
              f"{err_k:.4e} above 3 x {err_p:.4e}")


def _windows_by_rule(model, plain32, plain16, img, tiled):
    """The ``--tile 128`` restore ``tiled`` of ``img``, window by window:
    each window held to phase 2's rule against the plain fp32 model (both
    clipped to [0, 1], as the restore clips), and counted when its bits
    equal the window's own batch-1 forward. The batch changes finalize's
    batched cuBLAS product and cuDNN's conv algorithms, so equal bits are
    not expected (PERF.md section 6)."""
    import torch

    from image_restoration_tpu_torch.eval.tiled import window_partition
    from image_restoration_tpu_torch.utils.precision import full_fp32

    x = torch.from_numpy(img).permute(2, 0, 1)[None].cuda()
    wins, _ = window_partition(x, 128)
    out = torch.from_numpy(tiled).permute(2, 0, 1)[None].cuda()
    got, _ = window_partition(out, 128)
    equal, worst = 0, (0.0, 0.0)
    with torch.inference_mode(), full_fp32():
        for k in range(wins.shape[0]):
            win = wins[k:k + 1]
            ref = plain32(win).clamp(0.0, 1.0)
            ek = rel_err(got[k:k + 1], ref)
            ep = rel_err(plain16(win).clamp(0.0, 1.0), ref)
            equal += torch.equal(model(win).clamp(0.0, 1.0).float(),
                                 got[k:k + 1])
            worst = max(worst, (ek, ep))
            check(ek < _bound(ep), f"tiled window {k}: rel err {ek:.3e} "
                  f"above max(3 x {ep:.3e}, 4e-3)")
    print(f"eval restormer --tile 128 on 512x512: 16 windows in one batch of "
          f"16, each within phase 2's rule against plain fp32 (worst rel err "
          f"{worst[0]:.3e}, plain bf16 {worst[1]:.3e}); {equal} of 16 "
          f"bit-equal to their batch-1 forward", flush=True)


def phase_eval(gpu):
    """Phase 3f: score Restormer-base and DRSformer through ``cli/test.py``
    on a seeded synthetic benchmark tree; the on-card metrics against a
    float64 host recomputation; the times; the kernel model against the
    plain fp32 model on every input shape the benchmarks fed it; the
    ``--tile 128`` windows by phase 2's rule. Returns the launch counts of
    the two ``main`` runs."""
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli.infer import make_restore_fn
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import mefc as KM
    from image_restoration_tpu_torch.utils.options import parse_options

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ir_eval_") as tmp:
        data = os.path.join(tmp, "data")
        write_eval_tree(data)
        # Restormer-base from its serving defaults, seeded weights through
        # the checkpoint path
        ckpt = os.path.join(tmp, "restormer.pth")
        torch.save(build_model(parse_options(["--seed", "7"])).state_dict(),
                   ckpt)
        n_fwd = sum(EVAL_IMAGES.values())
        pair = {"block_front": KB.block_front,
                "block_apply_gdfn": KB.block_apply_gdfn}
        launches, kept = _eval_main(
            "restormer", ["--model", "restormer", "--ckpt", ckpt,
                          "--benchmarks", *EVAL_BENCHES, "--data_file_dir",
                          data, "--output_dir", os.path.join(tmp, "r")],
            pair, dict.fromkeys(pair, BLOCKS_PER_FORWARD), n_fwd)
        worst = [0.0, 0.0]
        for (_, out, gt, p), (_, _, _, s) in zip(kept[::2], kept[1::2]):
            p_host, s_host = host_psnr_ssim(out, gt)
            dp, ds = abs(p.item() - p_host), abs(s.item() - s_host)
            worst = [max(worst[0], dp), max(worst[1], ds)]
            check(dp <= 1e-3 and ds <= 1e-4,
                  f"eval metrics at {out.shape}: card PSNR {p.item():.6f} "
                  f"SSIM {s.item():.7f}, host float64 {p_host:.6f} "
                  f"{s_host:.7f}")
        print(f"eval restormer: {len(kept) // 2} images, on-card metrics vs "
              f"float64 host: max |dPSNR| {worst[0]:.3e} dB (limit 1e-3), "
              f"max |dSSIM| {worst[1]:.3e} (limit 1e-4)", flush=True)

        cfg = parse_options(["--model", "restormer", "--ckpt", ckpt])
        model = load_params(cfg, build_model(cfg))
        inputs = _eval_times(gpu, "restormer", model, data)
        plain32, plain16 = (plain_variant(cfg, model, False),
                            plain_variant(cfg, model, True))
        _hold_to_plain("restormer", model, plain32, plain16, inputs)

        # --tile 128 on a 512x512 image: 16 windows through one forward
        restore = make_restore_fn(dict(cfg, tile=128), model)
        img = np.random.default_rng(3).random((512, 512, 3), dtype=np.float32)
        restore(img)
        for fn in pair.values():
            fn.launches = 0
        tiled = restore(img)
        torch.cuda.synchronize()
        check(all(fn.launches == BLOCKS_PER_FORWARD for fn in pair.values()),
              f"tiled: {[fn.launches for fn in pair.values()]} launches, "
              f"expected one batched forward ({BLOCKS_PER_FORWARD} each)")
        _windows_by_rule(model, plain32, plain16, img, tiled)
        del model, plain32, plain16, inputs

        trio = {"block_front": KB.block_front,
                "drs_apply_msfn": KD.drs_apply_msfn,
                "mefc_step": KM.mefc_step}
        n_drs = EVAL_IMAGES["derain"]
        drs_launches, kept = _eval_main(
            "drsformer", ["--model", "drsformer", "--benchmarks", "derain",
                          "--data_file_dir", data, "--output_dir",
                          os.path.join(tmp, "d")], trio,
            {"block_front": DRS_BLOCKS_PER_FORWARD,
             "drs_apply_msfn": DRS_BLOCKS_PER_FORWARD,
             "mefc_step": MEFC_STEPS_PER_FORWARD}, n_drs)
        for _, out, _, val in kept:
            check(np.isfinite(out).all() and np.isfinite(val.item()),
                  "eval drsformer: non-finite output or score")
        # the same seeded weights as main's model
        dcfg = parse_options(["--model", "drsformer"])
        model = load_params(dcfg, build_model(dcfg))
        inputs = _eval_times(gpu, "drsformer", model, data)
        _hold_to_plain("drsformer", model, plain_variant(dcfg, model, False),
                       plain_variant(dcfg, model, True), inputs)
    print(f"eval: phase 3f took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, drs_launches


def perturb_family(model, seed):
    """Seeded, non-trivial residual scales of the kernel-free families:
    DarkIR's and SFHformer's ``beta``/``gamma`` start at zero (nothing a
    block's branches compute reaches the image), SRConvNet's
    ``layer_scale`` at 1e-6 (FConvMod's softmax over H*W is then nearly
    uniform) and HOGformer's ``sigma`` (the FFN's feature decomposition)
    at 1e-5."""
    import torch

    randn = _randn_from(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("beta", "gamma", "layer_scale",
                              "sigma.scale")):
                p.copy_(0.5 + 0.2 * randn(p))


def calibrate_style(model, hw, seed):
    """MWFormer's style filter with ``out1_fc`` scaled so that the vector
    it gives a seeded image of ``hw`` has largest |entry| 1, as a trained
    filter's is O(1): a random filter sums its Gram matrices over the
    pixels into a vector of ~1e3 at 512x512, which the backbone's
    hypernets turn into saturated softmaxes that amplify rounding ~1e4-fold
    (tests/test_torch_mwformer.py). Other models are left as they are."""
    import torch

    sf = getattr(model, "style_filter", None)
    if sf is None:
        return
    dev = next(model.parameters()).device
    x = torch.rand((1, 3, *hw), generator=torch.Generator().manual_seed(
        seed)).to(dev)
    with torch.no_grad():
        scale = sf(x).float().abs().max()
        sf.out1_fc.weight.div_(scale)
        sf.out1_fc.bias.div_(scale)


def _family_cfg(name, tag):
    """``name``'s options from its serving defaults on the card, held to
    phase 3j's configuration: bf16, no kernel flag, and the widths
    ``FAMILY_WIDTHS`` names."""
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(["--model", name, "--device", "cuda", "--seed",
                         "0"])
    mk = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["model_kwargs"].items()}
    check(cfg["bf16"] and not set(mk) & set(KERNEL_FLAGS)
          and all(mk.get(k) == v for k, v in FAMILY_WIDTHS[name].items()),
          f"{tag}: not {name}'s bf16 kernel-free defaults ({mk})")
    return cfg


def phase_serve_family(gpu, profile_dir=None, serve=FAMILY_SERVE):
    """Phase 3j (``serve``: SRConvNet, TransWeather and DarkIR) and 3l
    (HOGformer, SFHformer, MWFormer): each model from its serving defaults
    (``FAMILY_WIDTHS``), seeded weights with ``perturb_family`` (and
    ``calibrate_style``), restores ``serve``'s inputs in bf16 at batch 1
    through ``make_restore_fn``: finite outputs of the input's size (4x
    it for SRConvNet), every kernel's launch count 0. Then each model's
    bf16 error against the card's fp32 model at those inputs (printed),
    the card's fp32 forward against the CPU port's at ``FAMILY_SMALL``
    (within ``CARD_CPU_LIMIT`` relative L2, else 1e-4; TF32 off on both;
    HOGformer's under the CPU's sort and bin decisions,
    ``models/hogformer.py`` ``decision_tape``, its free-running difference
    printed), and the forward's device ms (CUDA
    events), the restore's ms/img (host clock), MP/s of the output pixels
    and the peak memory; with ``profile_dir``, a profile of two restores
    of the first input. Returns the launch counts by model."""
    import copy

    import torch

    from image_restoration_tpu_torch.cli.infer import make_restore_fn
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.models.hogformer import decision_tape
    from image_restoration_tpu_torch.utils.precision import full_fp32

    every = _every_kernel()
    rng = np.random.default_rng(1500)
    out = {}
    for name, sizes in serve.items():
        cfg = _family_cfg(name, f"{name} serving")
        scale = cfg["model_kwargs"].get("scale", 1) if name == "srconvnet" \
            else 1
        model = load_params(cfg, build_model(cfg))
        perturb_family(model, 1510)
        calibrate_style(model, sizes[0], 1511)
        restore = make_restore_fn(cfg, model)
        images = [rng.random((h, w, 3), dtype=np.float32) for h, w in sizes]
        for img in images:
            restore(img)  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        for fn in every.values():
            fn.launches = 0
        outs = [restore(img) for img in images]
        torch.cuda.synchronize()
        out[name] = {k: f.launches for k, f in every.items()}
        check(not any(out[name].values()),
              f"{name} serving launched a kernel: {out[name]}")
        for img, res in zip(images, outs):
            want = (img.shape[0] * scale, img.shape[1] * scale, 3)
            check(res.shape == want and np.isfinite(res).all(),
                  f"{name}: output {res.shape} for {img.shape}, or not "
                  f"finite")
        plain32 = plain_variant(cfg, model, False)
        for img in images:
            h, w = img.shape[:2]
            x = torch.from_numpy(img).permute(2, 0, 1)[None].cuda()
            with torch.inference_mode(), full_fp32():
                ref = plain32(x)
                got = model(x).float()
            err = (got - ref).abs().max().item()
            rel = ((got - ref).norm() / ref.norm()).item()
            check(np.isfinite(err), f"{name}: non-finite bf16 error")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                restore(img)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ms = statistics.median(times)
            with torch.inference_mode(), full_fp32():
                fwd = time_cuda(lambda: model(x), reps=5, warmup=1,
                                head_start_ms=50.0)
            mp = h * w * scale * scale / 1e6
            print(f"{name} serving {h}x{w} -> {h * scale}x{w * scale} bf16 "
                  f"batch 1 on {gpu}: forward {fwd:.3f} ms (device, CUDA "
                  f"events), restore {ms:.3f} ms/img (host clock, median of "
                  f"5), {mp / (ms / 1e3):.4f} MP/s of output, peak memory "
                  f"{peak:.3f} GiB; bf16 against the card's fp32 model: max "
                  f"|err| {err:.4e}, relative L2 {rel:.4e}", flush=True)
        if profile_dir:
            _profile(restore, [images[0]] * 2, profile_dir, name, gpu,
                     f"restores at {images[0].shape[0]}x"
                     f"{images[0].shape[1]}")
        # the card's fp32 model against the CPU port's, at a small input
        small = torch.rand((1, 3, *FAMILY_SMALL[name]),
                           generator=torch.Generator().manual_seed(1520))
        limit = CARD_CPU_LIMIT.get(name, 1e-4)
        with torch.inference_mode(), full_fp32():
            free = plain32(small.cuda()).cpu().double()
            with decision_tape([]) as tape:
                cpu = copy.deepcopy(plain32).cpu()(small).double()
            decisions = len(tape)
            with decision_tape(tape, replay=True):
                card = plain32(small.cuda()).cpu().double()
        rel = ((card - cpu).norm() / cpu.norm()).item()
        note = ""
        if decisions:
            note = (f"; under the CPU's {decisions} sort and bin decisions "
                    f"(free-running: {((free - cpu).norm() / cpu.norm()).item():.3e})")
        print(f"{name}: fp32 forward at {tuple(small.shape[2:])}, card "
              f"against CPU: relative L2 {rel:.3e} (limit {limit:g}){note}",
              flush=True)
        check(rel <= limit, f"{name}: card fp32 forward {rel:.3e} from the "
              f"CPU's")
        del model, plain32, restore
    return out


def _write_pairs(root, rel_lq, rel_gt, sizes, rng, degrade):
    import os

    from PIL import Image

    for i, (h, w) in enumerate(sizes):
        gt = _smooth_image(rng, h, w)
        for rel, arr in ((rel_gt, gt), (rel_lq, degrade(gt))):
            path = os.path.join(root, rel, f"{i:03d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)


def write_family_eval_tree(root, seed=0):
    """Phase 3f's trees for the kernel-free families: Set5-shaped
    (``sr/Set5/HR`` and ``LR_bicubic/X4``, the LR a PIL bicubic x1/4 of
    the HR), RainDrop-shaped (``weather/RainDrop/{input,gt}``, 720x480
    with bright spots and noise), LOLv1-shaped
    (``llie/LOLv1/Test/{input,target}``, 600x400, the input dark and
    noisy) and Rain100L-shaped (``deraining/Rain100L/{input,target}``,
    481x321 with streaks and noise)."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(SR_EVAL_SIZES):
        hr = _smooth_image(rng, h, w)
        for rel, img in (("HR", Image.fromarray(hr)),
                         ("LR_bicubic/X4", Image.fromarray(hr).resize(
                             (w // 4, h // 4), Image.BICUBIC))):
            name = f"{i:03d}.png" if rel == "HR" else f"{i:03d}x4.png"
            path = os.path.join(root, "sr", "Set5", rel, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            img.save(path)

    def drops(gt):
        spots = (rng.random(gt.shape[:2]) > 0.99)[..., None]
        return gt * 0.8 + spots * 100.0 + rng.standard_normal(gt.shape) * 6

    def dark(gt):
        return gt * 0.15 + rng.standard_normal(gt.shape) * 4.0

    _write_pairs(root, "weather/RainDrop/input", "weather/RainDrop/gt",
                 [RAINDROP_SIZE] * 2, rng, drops)
    _write_pairs(root, "llie/LOLv1/Test/input", "llie/LOLv1/Test/target",
                 [LOL_SIZE] * 2, rng, dark)

    def rain(gt):
        streaks = (rng.random(gt.shape[:2]) > 0.97)[..., None] * 80.0
        return gt + streaks + rng.standard_normal(gt.shape) * 6

    _write_pairs(root, "deraining/Rain100L/input", "deraining/Rain100L/target",
                 [RAIN100L_SIZE] * 2, rng, rain)


def _seeded_vgg16(path, seed, prefix=""):
    """A torchvision-layout VGG16 state_dict (``features.N``; to relu5_3),
    seeded at the fan-in scale, saved to ``path`` with ``prefix`` on every
    key; with ``prefix="net."`` and LPIPS's five heads
    (``lin{i}.model.1.weight``, non-negative) it is an LPIPS checkpoint."""
    import torch

    from image_restoration_tpu_torch.eval.perceptual import VGG16_CFG

    g = torch.Generator().manual_seed(seed)
    sd, cin, idx = {}, 3, 0
    for v in VGG16_CFG[:-1]:
        if v == "M":
            idx += 1
            continue
        sd[f"{prefix}features.{idx}.weight"] = torch.randn(
            v, cin, 3, 3, generator=g) / (9 * cin) ** 0.5
        sd[f"{prefix}features.{idx}.bias"] = 0.05 * torch.randn(v,
                                                                 generator=g)
        cin, idx = v, idx + 2
    if prefix:
        for i, c in enumerate((64, 128, 256, 512, 512)):
            sd[f"lin{i}.model.1.weight"] = torch.rand(1, c, 1, 1,
                                                      generator=g) / c
    torch.save(sd, path)


def phase_eval_family(gpu, runs=FAMILY_EVAL, tag="3f (family)"):
    """Phase 3f for SRConvNet, TransWeather and DarkIR (``runs``), and
    for HOGformer, SFHformer and MWFormer (``EVAL_3L``): ``cli/test.py``
    ``main`` scores each, from its serving defaults with seeded weights
    (``perturb_family``, ``calibrate_style`` at 768x512) as a ``.pth``
    ``--ckpt``, on its synthetic benchmark (``write_family_eval_tree``):
    SRConvNet ``sr_set5_x4`` (Y channel, 4 border pixels cropped),
    TransWeather and MWFormer ``raindrop`` (bucket 64: 768x512 forwards),
    DarkIR ``synllie`` with a seeded ``--lpips_ckpt`` (the LPIPS column
    finite), HOGformer and SFHformer ``derain`` (328x488 forwards). Every
    kernel's launch count 0, finite scores, and each image's on-card PSNR
    and SSIM within 1e-3 dB and 1e-4 of the float64 host recomputation.
    Returns the launch counts by path."""
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model

    t0 = time.perf_counter()
    every = _every_kernel()
    out = {}
    with tempfile.TemporaryDirectory(prefix="ir_eval_family_") as tmp:
        data = os.path.join(tmp, "data")
        write_family_eval_tree(data)
        lpips = os.path.join(tmp, "lpips.pth")
        _seeded_vgg16(lpips, 1530, prefix="net.")
        for name, bench, n, border in runs:
            cfg = _family_cfg(name, f"eval {name}")
            model = load_params(cfg, build_model(cfg))
            perturb_family(model, 1540)
            calibrate_style(model, (512, 768), 1541)
            ckpt = os.path.join(tmp, f"{name}.pth")
            torch.save(model.state_dict(), ckpt)
            del model
            extra = ["--lpips_ckpt", lpips] if name == "darkir" else []
            launches, kept = _eval_main(
                name, ["--model", name, "--ckpt", ckpt, "--benchmarks",
                       bench, "--data_file_dir", data, "--output_dir",
                       os.path.join(tmp, name), *extra],
                every, dict.fromkeys(every, 0), n)
            with open(os.path.join(tmp, name, "results.json")) as f:
                res = json.load(f)[bench]
            if extra:
                print(f"eval {name} {bench}: LPIPS {res['lpips']:.6f} "
                      f"(seeded LPIPS weights)", flush=True)
                check(np.isfinite(res["lpips"]), f"eval {name}: LPIPS "
                      f"{res.get('lpips')}")
            _metrics_to_host(name, kept, border)
            out[f"eval_{name}"] = launches
    print(f"eval: phase {tag} took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def phase_train_family(gpu, runs=TRAIN_4F, tag="4f"):
    """Phases 4f (``runs``: DarkIR-m with ``--recipe darkir``, the side
    head's EnhanceLoss; TransWeather with ``--recipe transweather`` and a
    seeded torchvision-layout VGG16 ``.pth`` as ``--vgg_ckpt``) and 4n
    (``TRAIN_4N``: HOGformer with ``--recipe hogformer``; SFHformer with
    the default recipe, its BatchNorms in train mode; MWFormer's style
    filter with ``--recipe mwformer_style`` for ``FAMILY_STYLE_STEPS``
    steps on the tree's five degradation labels, then MWFormer with
    ``--style_ckpt`` that run's checkpoints). Each trains through
    ``cli/train.py`` ``main`` on phase 4's tree in bf16, batch 8 of
    128x128, ``FAMILY_TRAIN_STEPS_4F`` steps with validation and saves
    every ``FAMILY_TRAIN_EVERY`` (the style filter: no validation): every
    kernel's launch count 0, every logged loss finite with the recipe's
    terms; for the restoration models, the L1 loss on a fixed batch lower
    with the final checkpoint's parameters than with the initial model's
    (in the forward mode they train in) and ``cli/test.py --ckpt``
    scoring the final checkpoint with a finite PSNR; MWFormer's loaded
    style filter bit-equal in its final checkpoint. Then the relative L2
    error of the bf16 model's gradients (the recipe's loss, batch 2 at
    128x128; the style filter: 4, two labels) against the fp32 model's,
    and step ms (CUDA events, median of 5 after 2 warm-up steps),
    images/s and peak memory. Returns the launch counts by path."""
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli import test as T
    from image_restoration_tpu_torch.cli import train as TR
    from image_restoration_tpu_torch.train.recipes import make_recipe
    from image_restoration_tpu_torch.train.trainer import (
        TrainerConfig, TrainState, loss_and_grads, make_optimizer,
        make_train_step,
    )
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, parse_options,
    )

    t0 = time.perf_counter()
    every = _every_kernel()
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1550)
    shape = (TRAIN_BATCH, 3, TRAIN_PATCH, TRAIN_PATCH)
    gt = torch.rand(shape, generator=gen, device="cuda")
    batch = {"gt": gt, "lq": (gt * 0.5 + 0.1 * torch.randn(
        shape, generator=gen, device="cuda")).clamp(0, 1)}
    benches = dict((m, b) for m, b, _, _ in FAMILY_EVAL + EVAL_3L)
    with tempfile.TemporaryDirectory(prefix="ir_family_") as tmp:
        data = os.path.join(tmp, "data")
        _train_tree(data)
        bench = os.path.join(tmp, "bench")
        write_family_eval_tree(bench)
        vgg = os.path.join(tmp, "vgg16.pth")
        _seeded_vgg16(vgg, 1560)
        style_ckpt = os.path.join(tmp, "exp", "mwformer_style", "ckpt")
        # phase 4f's fixed batch is noise; phase 4n's, the validation
        # pairs' top-left crops: SFHformer's BatchNorms normalise by the
        # batch, so its loss is read on the data it trains on
        fixed_batch, fixed_from = {k: v[:2] for k, v in batch.items()}, \
            "uniform noise"
        if tag != "4f":
            fixed_batch = {k: torch.stack([_read_image(os.path.join(
                data, "val", k, f"{i:03d}.png"))[:, :TRAIN_PATCH,
                                                 :TRAIN_PATCH]
                for i in range(2)]) for k in ("lq", "gt")}
            fixed_from = "validation pairs' crops"
        specs = {  # model: (recipe, logged terms but total, extra argv)
            "darkir": ("darkir", ("l1", "enhance"), []),
            "transweather": ("transweather", ("smooth_l1", "perceptual"),
                             ["--vgg_ckpt", vgg]),
            "hogformer": ("hogformer", ("l_pix", "l_pear", "l_hog"), []),
            "sfhformer": ("default", ("l1",), []),
            "mwformer_style": ("mwformer_style", ("supcon",), []),
            "mwformer": ("default", ("l1",), ["--style_ckpt", style_ckpt]),
        }
        for name in runs:
            recipe, terms, extra = specs[name]
            image = name != "mwformer_style"  # the style filter embeds
            steps = FAMILY_TRAIN_STEPS_4F if image else FAMILY_STYLE_STEPS
            val = (["--val_every", str(FAMILY_TRAIN_EVERY), "--val_lq_dir",
                    f"{data}/val/lq", "--val_gt_dir", f"{data}/val/gt"]
                   if image else [])
            argv = ["--model", name, "--recipe", recipe, "--device", "cuda",
                    "--data_file_dir", data, "--batch_size",
                    str(TRAIN_BATCH), "--patch_size", str(TRAIN_PATCH),
                    "--warmup_epochs", "0", "--lr", str(TRAIN_LR),
                    "--save_every", str(FAMILY_TRAIN_EVERY), *val,
                    "--log_every", "1", "--ckpt_dir",
                    os.path.join(tmp, "exp"), "--name", name, *extra]
            cfg = parse_options(argv, build_train_parser())
            check(cfg["bf16"] and not set(cfg["model_kwargs"])
                  & set(KERNEL_FLAGS), f"phase {tag} {name}: not bf16 and "
                  f"kernel-free ({cfg['model_kwargs']})")
            for fn in every.values():
                fn.launches = 0
            t1 = time.perf_counter()
            TR.main(argv, max_steps_override=steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            out[f"train_{name}"] = {k: f.launches for k, f in every.items()}
            exp = os.path.join(tmp, "exp", name)
            with open(os.path.join(exp, "metrics.jsonl")) as f:
                logged = [json.loads(line) for line in f]
            rows = [e for e in logged if "train/total" in e]
            vals = [e["val/psnr"] for e in logged if "val/psnr" in e]
            print(f"train {name}: {steps} steps in {wall:.1f} s (host "
                  f"clock, with validation and saves); "
                  + "; ".join(f"{k} {[round(e[f'train/{k}'], 5) for e in rows]}"
                              for k in ("total", *terms))
                  + f"; validation PSNR {vals}", flush=True)
            check(not any(out[f"train_{name}"].values()),
                  f"train {name} launched a kernel: {out[f'train_{name}']}")
            check(len(rows) == steps and all(
                np.isfinite(e[f"train/{k}"]) for e in rows
                for k in ("total", *terms)) and np.isfinite(vals).all()
                and len(vals) == (steps // FAMILY_TRAIN_EVERY if image
                                  else 0),
                f"train {name}: a loss term or PSNR missing or not finite")
            final = os.path.join(exp, "ckpt", f"{steps}.pth")
            trained = torch.load(final, map_location="cuda")["params"]
            if "--style_ckpt" in extra:
                style = torch.load(os.path.join(
                    style_ckpt, f"{FAMILY_STYLE_STEPS}.pth"),
                    map_location="cuda")["params"]
                same = all(torch.equal(trained[f"style_filter.{k}"], v)
                           for k, v in style.items())
                print(f"train {name}: the style filter of "
                      f"{os.path.basename(style_ckpt)}/"
                      f"{FAMILY_STYLE_STEPS}.pth ({len(style)} tensors) "
                      f"bit-equal after {steps} steps: {same}", flush=True)
                check(same, f"train {name}: the frozen style filter moved")
            model = TR.build_model(cfg)
            apply_kw = {**TR.model_apply_kwargs(model),
                        **TR.RECIPE_APPLY_KWARGS.get(recipe, {})}
            if image:
                fixed = []
                for params in (None, trained):
                    if params is not None:
                        model.load_state_dict(params)
                    with torch.inference_mode():
                        res = model(fixed_batch["lq"], **apply_kw)
                        res = res[0] if isinstance(res, tuple) else res
                        fixed.append((res - fixed_batch["gt"]).abs().mean()
                                     .item())
                print(f"train {name}: L1 on a fixed batch of 2 at "
                      f"{TRAIN_PATCH}^2 ({fixed_from}): initial model "
                      f"{fixed[0]:.5f}, after {steps} steps {fixed[1]:.5f}",
                      flush=True)
                check(np.isfinite(fixed).all() and fixed[1] < fixed[0],
                      f"train {name}: the loss did not fall")
                res = T.main(["--model", name, "--device", "cuda", "--ckpt",
                              final, "--benchmarks", benches[name],
                              "--data_file_dir", bench, "--output_dir",
                              os.path.join(tmp, f"r_{name}")])
                print(f"train {name}: cli/test.py --ckpt "
                      f"{os.path.basename(final)}: {res}", flush=True)
                check(np.isfinite(res[benches[name]]["psnr"]),
                      f"train {name}: scoring the checkpoint gave {res}")
                step_batch, small = batch, {k: v[:2] for k, v in
                                            batch.items()}
            else:
                model.load_state_dict(trained)
                step_batch = dict(batch, de_id=torch.arange(
                    TRAIN_BATCH, device="cuda") % 2)
                small = {k: v[:4] for k, v in step_batch.items()}

            # the bf16 gradients against the fp32 model's
            recipe_kw = TR.build_recipe_kwargs(cfg)
            fn = make_recipe(recipe, **({"loss_terms": {"l1": 1.0}}
                                        if recipe == "default"
                                        else recipe_kw))
            grads = {}
            for bf16 in (True, False):
                m = plain_variant(cfg, model, bf16).train()
                grads[bf16] = torch.cat([
                    g.float().flatten() for g in loss_and_grads(
                        m, fn, small, apply_kw)[1].values()])
                del m
            rel = ((grads[True] - grads[False]).norm()
                   / grads[False].norm()).item()
            print(f"train {name}: bf16 gradient against fp32, relative L2 "
                  f"{rel:.4e} (all parameters, batch "
                  f"{len(small['lq'])} at {TRAIN_PATCH}^2)", flush=True)
            check(np.isfinite(rel), f"train {name}: non-finite gradients")

            # a step alone: ms, images/s, peak memory
            model.train()
            tcfg = TrainerConfig(learning_rate=TRAIN_LR, recipe=recipe,
                                 recipe_kwargs=recipe_kw,
                                 apply_kwargs=apply_kw)
            tx = make_optimizer(tcfg)
            state = TrainState.create(model, tx)
            step = make_train_step(model, tx, tcfg)
            for _ in range(2):
                step(state, step_batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(state, step_batch)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            ms = statistics.median(times)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"train step {name} bf16 batch {TRAIN_BATCH} x "
                  f"{TRAIN_PATCH}^2 on {gpu}: {ms:.3f} ms (CUDA events, "
                  f"median of 5 after 2 warm-up steps; min {min(times):.3f}, "
                  f"max {max(times):.3f}), {TRAIN_BATCH / (ms / 1e3):.2f} "
                  f"images/s, peak memory {peak:.3f} GiB", flush=True)
            del model, state, step, tx, recipe_kw, fn, trained
    print(f"train: phase {tag} took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def phase_block_backward():
    """Phase 2g's backward: ``fused_block`` on a batch of 8 at
    ``BACKWARD_SHAPES`` by ``_check_vjp``: its gradients (x and every
    parameter) against ``reference_block``'s, which its backward
    recomputes; K1 and K2 once in the forward, neither in the backward;
    forward + backward timed beside ``reference_block``'s."""
    import torch

    from image_restoration_tpu_torch.kernels import block as K

    counters = {"block_front": K.block_front,
                "block_apply_gdfn": K.block_apply_gdfn}
    for i, (h, w, c, heads) in enumerate(BACKWARD_SHAPES):
        p = random_block(c, heads, 1600 + i)
        gen = torch.Generator(device="cuda").manual_seed(1700 + i)
        x = torch.randn((TRAIN_BATCH, h, w, c), generator=gen,
                        device="cuda").to(torch.bfloat16)
        _check_vjp(f"fused_block backward {TRAIN_BATCH}x{h}x{w}x{c} heads "
                   f"{heads}",
                   lambda x, *q: K.fused_block(x, K.BlockParams(*q), heads),
                   lambda x, *q: K.reference_block(x, K.BlockParams(*q),
                                                   heads),
                   (x, *p), counters, dict.fromkeys(counters, 1))


def _train_tree(root, seed=0):
    """Phase 4's seeded five-task AIO tree in ``TASK_SPECS``' layout:
    clean 256x256 images under ``denoising/`` (the three noise levels are
    synthesised on the card), rain pairs under ``deraining/RainTrainL``,
    hazy images under ``dehazing/RESIDE/part1`` with their clear images,
    and a validation pair folder ``val/{lq,gt}``."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)

    def save(rel, arr):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr.astype(np.uint8)).save(path)

    def rain(gt):
        streaks = (rng.random(gt.shape[:2]) > 0.97)[..., None] * 80.0
        return np.clip(gt + rng.standard_normal(gt.shape) * 8.0 + streaks,
                       0, 255)

    for i in range(TRAIN_IMAGES):
        save(f"denoising/{i:03d}.png", _smooth_image(rng, 256, 256))
        gt = _smooth_image(rng, 256, 256)
        save(f"deraining/RainTrainL/gt/norain-{i:03d}.png", gt)
        save(f"deraining/RainTrainL/rainy/norain-{i:03d}.png", rain(gt))
        gt = _smooth_image(rng, 256, 256)
        save(f"dehazing/RESIDE/clear/{i:03d}.png", gt)
        save(f"dehazing/RESIDE/part1/{i:03d}_0.8_0.2.png", gt * 0.6 + 90)
    for i in range(VAL_IMAGES):
        gt = _smooth_image(rng, 256, 256)
        save(f"val/gt/{i:03d}.png", gt)
        save(f"val/lq/{i:03d}.png", rain(gt))


def _read_image(path):
    """A PNG as a (3, H, W) float tensor in [0, 1] on the card."""
    import torch
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return torch.from_numpy(arr).permute(2, 0, 1).cuda()


def _grad_groups(grads):
    """{level: flat fp32 gradient} by the parameter's top-level module."""
    import torch

    groups = {}
    for name, g in grads.items():
        groups.setdefault(name.split(".")[0], []).append(g.float().flatten())
    return {k: torch.cat(v) for k, v in groups.items()}


def _train_grad_rule(cfg, perturb=None):
    """Phase 4's gradient rule: one batch of 2 at 128x128; the relative L2
    error of all parameter gradients of the kernel bf16 model against the
    plain fp32 model within 3x the plain bf16 model's. Printed per
    level. A MoE model (``uses_moe_rng``) trains with ``train=True``, its
    balance loss at ``cfg``'s weight, and each of the three models draws
    its routing noise from a device generator of the same seed; their
    picks are printed. ``perturb(model)``, if given, reseeds the kernel
    model's weights first (the plain models load them)."""
    import torch

    from image_restoration_tpu_torch.cli.train import (
        build_model, model_apply_kwargs,
    )
    from image_restoration_tpu_torch.train.recipes import default_recipe
    from image_restoration_tpu_torch.train.trainer import loss_and_grads

    gen = torch.Generator(device="cuda").manual_seed(1800)
    gt = torch.rand((2, 3, TRAIN_PATCH, TRAIN_PATCH), generator=gen,
                    device="cuda")
    lq = (gt + 0.1 * torch.randn(gt.shape, generator=gen,
                                 device="cuda")).clamp(0, 1)
    kern = build_model(cfg).train()
    if perturb is not None:
        perturb(kern)
    moe = model_apply_kwargs(kern)
    batch = {"lq": lq, "gt": gt}
    recipe = default_recipe({"l1": 1.0}, cfg["aux_loss_weight"] if moe
                            else 0.0)
    groups, picks = {}, {}
    for tag, bf16 in (("kernel", True), ("plain32", False), ("plain16", True)):
        model = kern if tag == "kernel" else \
            plain_variant(cfg, kern, bf16).train()
        kw = dict(moe, generator=torch.Generator(
            device="cuda").manual_seed(1801)) if moe else {}
        routes, handles = _record_routes(model)
        with contextlib.nullcontext() if tag == "kernel" else \
                _no_kernels():
            grads = loss_and_grads(model, recipe, batch, kw)[1]
        for h in handles:
            h.remove()
        picks[tag] = [r for r, _ in routes]
        groups[tag] = _grad_groups(grads)
        del model, grads
    if moe:
        flips = sum(a != b for a, b in zip(picks["kernel"],
                                           picks["plain32"]))
        print(f"train gradient rule: routers' picks (noisy, train=True) "
              f"kernel bf16 {picks['kernel']}, plain fp32 "
              f"{picks['plain32']}; {flips} routers differ", flush=True)
    oracle = groups["plain32"]

    def rel(tag, keys):
        num = sum(float((groups[tag][k] - oracle[k]).norm()) ** 2
                  for k in keys)
        den = sum(float(oracle[k].norm()) ** 2 for k in keys)
        return (num / den) ** 0.5

    for k in oracle:
        print(f"train gradient rule {k}: kernel bf16 {rel('kernel', [k]):.4e}"
              f", plain bf16 {rel('plain16', [k]):.4e}", flush=True)
    ek, ep = rel("kernel", list(oracle)), rel("plain16", list(oracle))
    print(f"train gradient rule, all parameters: kernel bf16 {ek:.4e}, plain "
          f"bf16 {ep:.4e} (relative L2 against the plain fp32 model)",
          flush=True)
    check(np.isfinite(ek) and ek <= 3 * ep, f"train gradients: kernel error "
          f"{ek:.4e} above 3 x {ep:.4e}")


@contextlib.contextmanager
def _no_kernels():
    """Fails the phase if a kernel launches inside (the plain models)."""
    from image_restoration_tpu_torch.kernels import block as K

    before = (K.block_front.launches, K.block_apply_gdfn.launches)
    yield
    check((K.block_front.launches, K.block_apply_gdfn.launches) == before,
          "a plain model launched a kernel")


# The step ms of phase 4's timings in this run, by "label tag", for
# phase 6 to print beside its own.
STEP_MS = {}


def _train_step_times(gpu, cfg, profile_dir, counters, per_forward,
                      label="Restormer-base", warmup=3, reps=10):
    """Step ms by CUDA events (median of ``reps`` after ``warmup`` warm-up
    steps) of the kernel model ``cfg`` builds and of its plain bf16 model
    on one batch of 8 at 128x128 on the card, images/s, peak memory, the
    launches of one step (``counters`` must each count ``per_forward``:
    a forward's, none in the backward) and the host syncs of a step that
    does not log. Returns the launches of the counted step."""
    import torch

    from image_restoration_tpu_torch.cli.train import (
        build_model, model_apply_kwargs,
    )
    from image_restoration_tpu_torch.data.degradations import step_generator
    from image_restoration_tpu_torch.train.trainer import (
        TrainerConfig, TrainState, make_optimizer, make_train_step,
    )

    gen = torch.Generator(device="cuda").manual_seed(1900)
    shape = (TRAIN_BATCH, 3, TRAIN_PATCH, TRAIN_PATCH)
    gt = torch.rand(shape, generator=gen, device="cuda")
    batch = {"gt": gt, "lq": (gt + 0.1 * torch.randn(
        shape, generator=gen, device="cuda")).clamp(0, 1)}
    out = {}
    kern = build_model(cfg)
    moe = model_apply_kwargs(kern)
    tcfg = TrainerConfig(learning_rate=TRAIN_LR, ema_decay=0.999,
                         aux_loss_weight=cfg["aux_loss_weight"] if moe
                         else 0.0, apply_kwargs=moe)

    def noise(i):  # the CLI's generator of step i's routing noise
        return step_generator(0, i, "cuda", 1) if moe else None

    for tag in ("kernel", "plain bf16"):
        model = kern if tag == "kernel" else plain_variant(cfg, kern, True)
        model.train()
        tx = make_optimizer(tcfg)
        state = TrainState.create(model, tx, ema_decay=tcfg.ema_decay)
        step = make_train_step(model, tx, tcfg)
        for i in range(warmup):
            step(state, batch, noise(i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch, noise(warmup + i))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        STEP_MS[f"{label} {tag}"] = ms
        peak = torch.cuda.max_memory_allocated() / 2**30
        if tag == "kernel":
            for fn in counters.values():
                fn.launches = 0
            syncs = host_syncs(lambda: step(state, batch,
                                            noise(warmup + reps)))
            torch.cuda.synchronize()
            out = {name: fn.launches for name, fn in counters.items()}
            print(f"train step {label} launches {out}; host syncs of a step "
                  f"that does not log: {sum(syncs.values())} {dict(syncs)}",
                  flush=True)
            check(out == per_forward, f"a {label} training step launched "
                  f"{out}, expected {per_forward} in its forward and none "
                  f"in its backward")
            kernel_step = (step, state)
        print(f"train step {tag}, {label} bf16 batch {TRAIN_BATCH} x "
              f"{TRAIN_PATCH}^2 on {gpu}: {ms:.3f} ms (CUDA events, median "
              f"of {reps} after {warmup} warm-up steps; min {min(times):.3f}, "
              f"max {max(times):.3f}), {TRAIN_BATCH / (ms / 1e3):.2f} "
              f"images/s, peak memory {peak:.3f} GiB", flush=True)
        del model, state, step, tx
    if profile_dir:  # after both timings, which it would perturb
        step, state = kernel_step
        _profile(lambda b: step(state, b, noise(0)), [batch, batch],
                 profile_dir,
                 "train", gpu, f"train steps at batch {TRAIN_BATCH} x "
                 f"{TRAIN_PATCH}^2")
    return out


def phase_train(gpu, profile_dir):
    """Phase 4: train Restormer-base through ``cli/train.py`` ``main`` on a
    seeded synthetic five-task tree at the port defaults in bf16, batch 8
    of 128x128, with validation and saves every 10 steps; resume; score
    the final checkpoint through ``cli/test.py``; then DRSformer the same
    way (``_train_drsformer``); the gradient rule; the step times; the
    three-kernel Restormer's step (``_train_three_kernel``). Returns the
    launch counts of the ``main`` runs and of the three-kernel step, by
    path."""
    import json
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli import test as T
    from image_restoration_tpu_torch.cli import train as TR
    from image_restoration_tpu_torch.kernels import block as K
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, parse_options,
    )

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ir_train_") as tmp:
        data = os.path.join(tmp, "data")
        _train_tree(data)
        argv = ["--model", "restormer", "--device", "cuda",
                "--data_file_dir", data, "--batch_size", str(TRAIN_BATCH),
                "--patch_size", str(TRAIN_PATCH), "--warmup_epochs", "0",
                "--ema_decay", "0.999", "--lr", str(TRAIN_LR),
                "--save_every", str(TRAIN_EVERY), "--val_every",
                str(TRAIN_EVERY), "--val_lq_dir", f"{data}/val/lq",
                "--val_gt_dir", f"{data}/val/gt", "--log_every", "1",
                "--ckpt_dir", os.path.join(tmp, "exp"), "--name", "smoke"]
        cfg = parse_options(argv, build_train_parser())
        check(cfg["bf16"] and cfg["model_kwargs"].get("fused_block")
              and cfg["de_type"] == ["denoise_15", "denoise_25",
                                     "denoise_50", "derain", "dehaze"],
              "phase 4: not the port's bf16 fused_block defaults on the five "
              "AIO tasks")
        n_val = TRAIN_STEPS // TRAIN_EVERY * VAL_IMAGES
        K.block_front.launches = K.block_apply_gdfn.launches = 0
        t1 = time.perf_counter()
        state = TR.main(argv, max_steps_override=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {"block_front": K.block_front.launches,
                    "block_apply_gdfn": K.block_apply_gdfn.launches}
        n_fwd = TRAIN_STEPS + n_val
        print(f"train: {TRAIN_STEPS} steps + {n_val} validation forwards in "
              f"{wall:.1f} s (host clock, loading, saves and validation "
              f"included), launches {launches}", flush=True)
        check(launches == dict.fromkeys(launches, n_fwd * BLOCKS_PER_FORWARD),
              f"train: {launches} for {TRAIN_STEPS} steps and {n_val} "
              f"validation forwards, expected {BLOCKS_PER_FORWARD} each")
        exp = os.path.join(tmp, "exp", "smoke")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [e["train/total"] for e in logged if "train/total" in e]
        vals = [e["val/psnr"] for e in logged if "val/psnr" in e]
        print(f"train losses (lr {TRAIN_LR}): first {losses[0]:.5f}, mean of "
              f"the last five {np.mean(losses[-5:]):.5f}; all "
              f"{[round(v, 5) for v in losses]}; validation PSNR {vals}",
              flush=True)
        check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
              and len(vals) == TRAIN_STEPS // TRAIN_EVERY
              and np.isfinite(vals).all(), "train: a loss or PSNR is not "
              "finite, or missing")
        check(np.mean(losses[-5:]) < losses[0], "train: the loss did not "
              "fall")
        ckpts = sorted(os.listdir(os.path.join(exp, "ckpt")))
        print(f"train: checkpoints {ckpts}", flush=True)
        want = {f"{s}.pth" for s in range(TRAIN_EVERY, TRAIN_STEPS + 1,
                                          TRAIN_EVERY)} | {"best"}
        check(want <= set(ckpts), f"train: checkpoints {ckpts}")

        state = TR.main(argv + ["--resume"],
                        max_steps_override=TRAIN_STEPS + RESUME_STEPS)
        torch.cuda.synchronize()
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f]
        check(state.step == TRAIN_STEPS + RESUME_STEPS
              and steps[-1] == TRAIN_STEPS + RESUME_STEPS - 1
              and TRAIN_STEPS in steps and steps.count(TRAIN_STEPS) == 1,
              f"train: resume reached step {state.step}, logged {steps}")
        del state

        bench = os.path.join(tmp, "bench")
        write_eval_tree(bench)
        final = os.path.join(exp, "ckpt",
                             f"{TRAIN_STEPS + RESUME_STEPS}.pth")
        results = T.main(["--model", "restormer", "--device", "cuda",
                          "--ckpt", final,
                          "--benchmarks", "derain", "--data_file_dir",
                          bench, "--output_dir", os.path.join(tmp, "r")])
        print(f"train: cli/test.py --ckpt {os.path.basename(final)}: "
              f"{results}", flush=True)
        check(np.isfinite(results["derain"]["psnr"])
              and results["derain"]["n"] == EVAL_IMAGES["derain"],
              f"train: scoring the checkpoint gave {results}")
        t2 = time.perf_counter()
        drs = _train_drsformer(gpu, data, bench, tmp)
        print(f"train: the DRSformer run took {time.perf_counter() - t2:.1f} "
              f"s", flush=True)
    _train_grad_rule(cfg)
    _train_step_times(gpu, cfg, profile_dir,
                      {"block_front": K.block_front,
                       "block_apply_gdfn": K.block_apply_gdfn},
                      dict.fromkeys(("block_front", "block_apply_gdfn"),
                                    BLOCKS_PER_FORWARD))
    three = _train_three_kernel(gpu)
    print(f"train: phase 4 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"train": launches, "train_drsformer": drs, "train_3k": three}


def phase_train_moce(gpu):
    """Phase 4m: MoCE-IR at its serving defaults (``MODEL_DEFAULTS``: dim
    48, blocks 4/6/6/8, decoder 2/4/4, 4 refinement, top-1 of 4 experts,
    ``rank_type="spread"``, the complexity bias, ``fused_block``) trains
    through ``cli/train.py`` ``main`` in bf16 on phase 4's seeded tree,
    batch 8 of 128x128, ``--aux_loss_weight`` at the CLI's 0.01,
    validation and saves every ``MOCE_TRAIN_EVERY`` steps: 28 K1 + 28 K2
    launches a forward (the steps' and the validation's), ``train/aux``
    logged and finite at every step, the L1 loss on a fixed batch lower
    with the final checkpoint's parameters than with the initial model's,
    ``cli/test.py --ckpt`` scoring the final checkpoint with a finite PSNR.
    Then the gradient rule (biases seeded, the same routing noise in the
    three models), a step's launches (28 + 28 in its forward, none in its
    backward), its host syncs, step ms, images/s and peak memory against
    the plain bf16 model. Then IGMoCE-IR, LumiSenseMoE and the patch model
    take ``FAMILY_TRAIN_STEPS`` steps each through ``main`` at their
    defaults: finite losses and balance losses, no kernel launch. Returns
    the launch counts by path."""
    import json
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli import test as T
    from image_restoration_tpu_torch.cli import train as TR
    from image_restoration_tpu_torch.kernels import block as K
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, parse_options,
    )

    t0 = time.perf_counter()
    counters = {"block_front": K.block_front,
                "block_apply_gdfn": K.block_apply_gdfn}
    with tempfile.TemporaryDirectory(prefix="ir_moce_") as tmp:
        data = os.path.join(tmp, "data")
        _train_tree(data)
        argv = ["--model", "moce_ir", "--device", "cuda",
                "--data_file_dir", data, "--batch_size", str(TRAIN_BATCH),
                "--patch_size", str(TRAIN_PATCH), "--warmup_epochs", "0",
                "--ema_decay", "0.999", "--lr", str(TRAIN_LR),
                "--save_every", str(MOCE_TRAIN_EVERY), "--val_every",
                str(MOCE_TRAIN_EVERY), "--val_lq_dir", f"{data}/val/lq",
                "--val_gt_dir", f"{data}/val/gt", "--log_every", "1",
                "--ckpt_dir", os.path.join(tmp, "exp"), "--name", "moce"]
        cfg = parse_options(argv, build_train_parser())
        mk = cfg["model_kwargs"]
        check(cfg["bf16"] and mk.get("fused_block")
              and cfg["aux_loss_weight"] == 0.01 and mk["dim"] == 48
              and tuple(mk["num_blocks"]) == (4, 6, 6, 8)
              and tuple(mk["num_dec_blocks"]) == (2, 4, 4)
              and mk["topk"] == 1 and mk["num_experts"] == 4
              and mk["rank_type"] == "spread" and mk["with_complexity"],
              f"phase 4m: not MoCE-IR's bf16 serving defaults ({mk})")
        for fn in counters.values():
            fn.launches = 0
        t1 = time.perf_counter()
        TR.main(argv, max_steps_override=MOCE_TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {k: f.launches for k, f in counters.items()}
        n_val = MOCE_TRAIN_STEPS // MOCE_TRAIN_EVERY * VAL_IMAGES
        n_fwd = MOCE_TRAIN_STEPS + n_val
        print(f"train moce_ir: {MOCE_TRAIN_STEPS} steps + {n_val} "
              f"validation forwards in {wall:.1f} s (host clock), launches "
              f"{launches}", flush=True)
        check(launches == dict.fromkeys(counters,
                                        n_fwd * MOCE_BLOCKS_PER_FORWARD),
              f"train moce_ir: {launches} for {n_fwd} forwards, expected "
              f"{MOCE_BLOCKS_PER_FORWARD} of each a forward")
        exp = os.path.join(tmp, "exp", "moce")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        losses = [e["train/total"] for e in logged if "train/total" in e]
        aux = [e["train/aux"] for e in logged if "train/aux" in e]
        vals = [e["val/psnr"] for e in logged if "val/psnr" in e]
        print(f"train moce_ir losses (lr {TRAIN_LR}): "
              f"{[round(v, 5) for v in losses]}; balance losses "
              f"{[round(v, 5) for v in aux]}; validation PSNR {vals}",
              flush=True)
        check(len(losses) == len(aux) == MOCE_TRAIN_STEPS
              and np.isfinite(losses).all() and np.isfinite(aux).all()
              and np.isfinite(vals).all(), "train moce_ir: a loss, balance "
              "loss or PSNR is not finite, or missing")
        final = os.path.join(exp, "ckpt", f"{MOCE_TRAIN_STEPS}.pth")
        model = TR.build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(2950)
        gt = torch.rand((2, 3, TRAIN_PATCH, TRAIN_PATCH), generator=gen,
                        device="cuda")
        lq = (gt + 0.1 * torch.randn(gt.shape, generator=gen,
                                     device="cuda")).clamp(0, 1)
        fixed = []
        for params in (None, torch.load(final, map_location="cuda")["params"]):
            if params is not None:
                model.load_state_dict(params)
            with torch.inference_mode():
                fixed.append((model(lq) - gt).abs().mean().item())
        del model
        print(f"train moce_ir: L1 on a fixed batch of 2 at {TRAIN_PATCH}^2: "
              f"initial model {fixed[0]:.5f}, after {MOCE_TRAIN_STEPS} steps "
              f"{fixed[1]:.5f}", flush=True)
        check(np.isfinite(fixed).all() and fixed[1] < fixed[0],
              "train moce_ir: the loss did not fall")
        bench = os.path.join(tmp, "bench")
        write_eval_tree(bench)
        results = T.main(["--model", "moce_ir", "--device", "cuda",
                          "--ckpt", final, "--benchmarks", "derain",
                          "--data_file_dir", bench,
                          "--output_dir", os.path.join(tmp, "rm")])
        print(f"train moce_ir: cli/test.py --ckpt "
              f"{os.path.basename(final)}: {results}", flush=True)
        check(np.isfinite(results["derain"]["psnr"]),
              f"train moce_ir: scoring the checkpoint gave {results}")

        out = {"train_moce": launches}
        every = dict(counters, **_every_kernel())
        for name in KERNEL_FREE:
            for fn in every.values():
                fn.launches = 0
            TR.main(["--model", name, "--device", "cuda",
                     "--data_file_dir", data, "--batch_size",
                     str(TRAIN_BATCH), "--patch_size", str(TRAIN_PATCH),
                     "--warmup_epochs", "0", "--lr", str(TRAIN_LR),
                     "--log_every", "1", "--save_every", "100000",
                     "--ckpt_dir", os.path.join(tmp, "exp"), "--name", name],
                    max_steps_override=FAMILY_TRAIN_STEPS)
            torch.cuda.synchronize()
            n = {k: f.launches for k, f in every.items()}
            with open(os.path.join(tmp, "exp", name, "metrics.jsonl")) as f:
                logged = [json.loads(line) for line in f]
            got = [(e["train/total"], e["train/aux"]) for e in logged
                   if "train/total" in e]
            print(f"train {name}: (loss, balance loss) {got}, launches "
                  f"{sum(n.values())}", flush=True)
            check(len(got) == FAMILY_TRAIN_STEPS and np.isfinite(got).all()
                  and not any(n.values()), f"train {name}: {got}, "
                  f"launches {n}")
            out[f"train_{name}"] = n
    _train_grad_rule(cfg, perturb=lambda m: perturb_biases(m, seed=2960))
    _train_step_times(gpu, cfg, None, counters,
                      dict.fromkeys(counters, MOCE_BLOCKS_PER_FORWARD),
                      "MoCE-IR", warmup=2, reps=5)
    print(f"train: phase 4m took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def _zero(counters):
    for f in counters.values():
        f.launches = 0


def _read(counters):
    import torch

    torch.cuda.synchronize()
    return {k: f.launches for k, f in counters.items()}


def _rel_l2(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def _card_against_cpu(tag, model32, x, pick=lambda out: out,
                      limit=CARD_CPU_GLA):
    """The card's fp32 ``model32`` against a CPU copy of it on ``x`` (NCHW,
    on the CPU), TF32 off on both: relative L2, printed and held to
    ``limit``. ``pick`` takes the compared tensor from the output."""
    import copy

    import torch

    from image_restoration_tpu_torch.utils.precision import full_fp32

    with torch.inference_mode(), full_fp32():
        card = pick(model32(x.cuda()))
        cpu = pick(copy.deepcopy(model32).cpu()(x))
    rel = _rel_l2(card, cpu)
    print(f"{tag}: fp32 forward at {tuple(x.shape)}, card against CPU: "
          f"relative L2 {rel:.3e} (limit {limit})", flush=True)
    check(rel <= limit, f"{tag}: card fp32 forward "
          f"{rel:.3e} from the CPU's")


def phase_serve_gla(gpu, profile_dir=None):
    """Phase 3m: ViG-T and HierViG-T (``MODEL_DEFAULTS``: the JAX field
    defaults) classify from ``cli/robust.py``'s ``build_model`` in bf16:
    ``GLA_BATCHES`` seeded batches of ``GLA_BATCH`` at 224x224 through
    ``batch_hits``, every kernel's count 0; finite bf16 logits; their
    relative L2, max |error| and top-1 agreement against the card's fp32
    model; the card's fp32 logits against the CPU's on a batch of 2
    (``CARD_CPU_GLA``); host ms a batch and images/s (median of 5), the
    forward's device ms (CUDA events) and peak memory; ViG-T's batch-1
    forward at 224x224 in MP/s, the geometry of the JAX bench row
    ``vig224_mps``; with ``profile_dir``, a profile of two batches.
    Returns the launch counts by model."""
    import torch

    from image_restoration_tpu_torch.cli.robust import build_argparser
    from image_restoration_tpu_torch.cli.test import load_params
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.eval.robustness import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        batch_hits,
    )
    from image_restoration_tpu_torch.utils.options import parse_options

    every = _every_kernel()
    mean = torch.from_numpy(IMAGENET_MEAN).cuda()
    std = torch.from_numpy(IMAGENET_STD).cuda()
    out = {}
    for name in ("vig", "vig_h"):
        cfg = parse_options(["--model", name, "--device", "cuda", "--seed",
                             "0", "--bf16"], build_argparser())
        check(cfg["bf16"] and not cfg["model_kwargs"],
              f"{name} serving: not bf16 at the JAX field defaults")
        model = load_params(cfg, build_model(cfg))
        n_params = sum(p.numel() for p in model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(3000)
        batches = [((torch.rand((GLA_BATCH, 224, 224, 3), generator=gen,
                                device="cuda") - mean) / std,
                    torch.randint(0, 1000, (GLA_BATCH,), generator=gen,
                                  device="cuda"))
                   for _ in range(GLA_BATCHES)]
        batch_hits(model, *batches[0])  # warm-up: cuDNN, the allocator
        torch.cuda.synchronize()
        _zero(every)
        hits = [batch_hits(model, im, lb) for im, lb in batches]
        out[name] = got = _read(every)
        print(f"{name} serving: {n_params} parameters, {len(batches)} "
              f"batches of {GLA_BATCH} at 224x224 bf16, launches {got}, "
              f"top-1 hits {[int(t1.sum()) for t1, _ in hits]}", flush=True)
        check(not any(got.values()), f"{name} serving launched a kernel")

        ref = plain_variant(cfg, model, False)
        num = den = err = 0.0
        agree = 0
        with torch.inference_mode():
            for im, _ in batches:
                x = im.permute(0, 3, 1, 2)
                l16, l32 = model(x), ref(x)
                check(l16.dtype == torch.bfloat16 and l16.shape ==
                      (GLA_BATCH, 1000) and torch.isfinite(l16).all().item(),
                      f"{name}: logits {l16.dtype} {tuple(l16.shape)} not "
                      f"finite bf16")
                d = l16.float() - l32
                num += float(d.double().square().sum())
                den += float(l32.double().square().sum())
                err = max(err, d.abs().max().item())
                agree += int((l16.argmax(-1) == l32.argmax(-1)).sum())
        n = GLA_BATCH * len(batches)
        print(f"{name} serving: bf16 against the card's fp32 model: "
              f"relative L2 {np.sqrt(num / den):.4e}, max |err| {err:.4e} "
              f"(fp32 logits up to {l32.abs().max().item():.3f}), top-1 "
              f"agreement {agree}/{n}", flush=True)
        small = batches[0][0][:2].permute(0, 3, 1, 2).cpu()
        _card_against_cpu(name, ref, small)
        del ref

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_hits(model, *batches[0])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        x0 = batches[0][0].permute(0, 3, 1, 2)
        with torch.inference_mode():
            fwd = time_cuda(lambda: model(x0), reps=5, warmup=1,
                            head_start_ms=50.0)
            one = x0[:1].contiguous()
            fwd1 = time_cuda(lambda: model(one), reps=10, warmup=2,
                             head_start_ms=20.0)
        print(f"{name} serving 224x224 bf16 batch {GLA_BATCH} on {gpu}: "
              f"{ms:.3f} ms/batch (batch_hits, host clock, median of 5), "
              f"{GLA_BATCH / (ms / 1e3):.1f} images/s; forward {fwd:.3f} ms "
              f"(device, CUDA events); peak memory {peak:.3f} GiB; batch 1: "
              f"forward {fwd1:.3f} ms, {224 * 224 / 1e6 / (fwd1 / 1e3):.3f} "
              f"MP/s", flush=True)
        if profile_dir:
            _profile(lambda a: batch_hits(model, *a), batches[:2],
                     profile_dir, name, gpu,
                     f"batches of {GLA_BATCH} at 224x224")
        del model
    return out


def _dense_cfg(name):
    from image_restoration_tpu_torch.utils.options import parse_options

    cfg = parse_options(["--model", name, "--device", "cuda", "--seed",
                         "0"])
    check(cfg["bf16"] and not cfg["model_kwargs"].get("use_pallas_ska"),
          f"{name}: not bf16 with SKA plain")
    return cfg


def _dense_targets(gen):
    """Seeded ground truth for a batch of ``DENSE_BATCH`` at
    ``DENSE_SIZE``: per image ``DENSE_SLOTS`` box slots, the last two
    padded (zero boxes, invalid), with COCO labels; ADE20K-style label maps
    with an ignored band."""
    import torch

    s = DENSE_SIZE
    xy = torch.rand((DENSE_BATCH, DENSE_SLOTS, 2), generator=gen,
                    device="cuda") * s * 0.7
    wh = torch.rand((DENSE_BATCH, DENSE_SLOTS, 2), generator=gen,
                    device="cuda") * s * 0.25 + 16
    boxes = torch.cat([xy, (xy + wh).clamp(max=s)], -1)
    valid = torch.ones((DENSE_BATCH, DENSE_SLOTS), dtype=torch.bool,
                       device="cuda")
    valid[:, -2:] = False
    boxes[~valid] = 0
    labels = torch.randint(0, 80, (DENSE_BATCH, DENSE_SLOTS), generator=gen,
                           device="cuda")
    seg = torch.randint(0, 150, (DENSE_BATCH, s, s), generator=gen,
                        device="cuda")
    seg[:, :16] = 255
    return boxes, labels, valid, seg


def _dense_losses(name, model, x, targets):
    """``retinanet_loss`` summed over the images (focal + smooth L1, each
    averaged over the batch) or ``segmentation_ce_loss``, with the
    forward's output."""
    from image_restoration_tpu_torch.models import lsnet_dense as D

    boxes, labels, valid, seg = targets
    out = model(x)
    if name == "semanticfpn_lsnet":
        return D.segmentation_ce_loss(out, seg), out
    cls, box, sizes = out
    anchors = model.anchors(sizes, x.device)
    total = 0.0
    for i in range(x.shape[0]):
        c, b = D.retinanet_loss(cls[i], box[i], anchors, boxes[i],
                                labels[i], valid[i], model.num_classes)
        total = total + (c + b) / x.shape[0]
    return total, out


def phase_dense(gpu):
    """Phase 3n: RetinaNet and Semantic-FPN over LSNet-T
    (``MODEL_DEFAULTS``: 80 and 150 classes, FPN 256, SKA plain as JAX
    builds them) from ``build_model`` in bf16, seeded weights and BatchNorm
    statistics from one train-mode forward of other images, on a batch of
    ``DENSE_BATCH`` at ``DENSE_SIZE``^2: one forward with every kernel's
    count 0; RetinaNet: ``decode_detections`` of each image and
    ``retinanet_loss`` on seeded boxes with two padded slots an image;
    Semantic-FPN: ``segmentation_ce_loss`` with an ignored band and
    ``mean_iou``: all finite. Then bf16 against the card's fp32 model
    (relative L2 and max |error| of the class logits), the card's fp32
    against the CPU's at batch 1 of 256x256, the forward's device ms and
    peak memory. Returns the launch counts by model."""
    import torch

    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.models import lsnet_dense as D

    every = _every_kernel()
    gen = torch.Generator(device="cuda").manual_seed(3100)
    shape = (DENSE_BATCH, 3, DENSE_SIZE, DENSE_SIZE)
    calib = torch.rand(shape, generator=gen, device="cuda")
    x = torch.rand(shape, generator=gen, device="cuda")
    targets = _dense_targets(gen)
    out = {}
    for name in ("retinanet_lsnet", "semanticfpn_lsnet"):
        cfg = _dense_cfg(name)
        model = build_model(cfg)
        calibrate_batchnorm(model, calib)
        ref = plain_variant(cfg, model, False)
        with torch.inference_mode():
            model(x)  # warm-up
            _zero(every)
            loss, res = _dense_losses(name, model, x, targets)
            out[name] = got = _read(every)
            check(not any(got.values()), f"{name} launched a kernel: {got}")
            logits = res if name == "semanticfpn_lsnet" else res[0]
            finite = [loss, logits]
            if name == "retinanet_lsnet":
                anchors = model.anchors(res[2], x.device)
                dets = [D.decode_detections(res[0][i], res[1][i], anchors)
                        for i in range(DENSE_BATCH)]
                finite += [t for d in dets for t in d[:2]]
                note = (f"{anchors.shape[0]} anchors, kept "
                        f"{[int((d[1] > 0).sum()) for d in dets]} "
                        f"detections")
            else:
                miou, _ = D.mean_iou(logits.argmax(1), targets[3], 150)
                finite.append(miou)
                note = f"mIoU {miou.item():.4f}"
            check(all(torch.isfinite(t).all().item() for t in finite),
                  f"{name}: a non-finite output, loss or detection")
            print(f"{name}: batch {DENSE_BATCH} at {DENSE_SIZE}^2 bf16, "
                  f"launches {got}, loss {float(loss):.5f}, {note}",
                  flush=True)
            want = ref(x)
            want = want if name == "semanticfpn_lsnet" else want[0]
            err = (logits.float() - want).abs().max().item()
            print(f"{name}: bf16 against the card's fp32 model: relative "
                  f"L2 {_rel_l2(logits.float(), want):.4e}, max |err| "
                  f"{err:.4e} (fp32 logits up to "
                  f"{want.abs().max().item():.3f})", flush=True)
        small = x[:1, :, :256, :256].cpu()
        _card_against_cpu(name, ref, small,
                          (lambda o: o) if name == "semanticfpn_lsnet"
                          else (lambda o: o[0]))
        del ref
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            fwd = time_cuda(lambda: model(x), reps=5, warmup=1,
                            head_start_ms=50.0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name} forward batch {DENSE_BATCH} at {DENSE_SIZE}^2 bf16 "
              f"on {gpu}: {fwd:.3f} ms (device, CUDA events), peak memory "
              f"{peak:.3f} GiB", flush=True)
        del model
    return out


def _grad_rel_l2(model16, model32, loss_fn):
    """Relative L2 of the bf16 model's gradients (all parameters, one
    vector) against the fp32 model's with the same weights."""
    import torch

    grads = []
    for m in (model16, model32):
        params = [p for p in m.parameters()]
        g = torch.autograd.grad(loss_fn(m), params, allow_unused=True)
        grads.append(torch.cat([(torch.zeros_like(p) if t is None else t)
                                .double().flatten()
                                for p, t in zip(params, g)]))
    return float((grads[0] - grads[1]).norm() / grads[1].norm())


def _timed_steps(step, n):
    """``n`` calls of ``step()`` (returning the loss); (losses, median
    device ms of the calls after the first, CUDA events)."""
    import torch

    losses, times = [], []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step()
        end.record()
        end.synchronize()
        losses.append(float(loss))
        if i:
            times.append(start.elapsed_time(end))
    return losses, statistics.median(times)


def phase_train_gla(gpu):
    """Phase 5v: ``GLA_TRAIN_STEPS`` ``make_cls_train_step`` steps
    (AdamW, lr ``GLA_LR``, label smoothing 0.1) of ViG-T and HierViG-T in
    bf16 on one seeded batch of ``GLA_TRAIN_BATCH`` at 224x224: finite
    losses, the last below the first, every kernel's count 0; step ms
    (CUDA events, median after the first), images/s, peak memory, and the
    bf16 gradients' relative L2 against the fp32 model's (batch 8). Then
    ``DENSE_TRAIN_STEPS`` ``train/trainer.py`` ``Optimizer`` steps (AdamW,
    lr ``DENSE_LR``) of RetinaNet (focal + smooth L1 on phase 3n's boxes)
    and Semantic-FPN (CE) in bf16 on one batch of ``DENSE_BATCH`` at
    ``DENSE_SIZE``^2, in eval mode (the BatchNorms on their running
    statistics, as JAX's ``train=False`` step): the loss falls, every
    kernel's count 0, step ms and peak memory. Returns the launch counts
    by path."""
    import torch

    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.train import classification as TC
    from image_restoration_tpu_torch.train import trainer as TT
    from image_restoration_tpu_torch.utils.options import parse_options

    every = _every_kernel()
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(3200)
    images = torch.randn((GLA_TRAIN_BATCH, 3, 224, 224), generator=gen,
                         device="cuda")
    labels = torch.randint(0, 1000, (GLA_TRAIN_BATCH,), generator=gen,
                           device="cuda")
    for name in ("vig", "vig_h"):
        cfg = parse_options(["--model", name, "--device", "cuda", "--seed",
                             "0"])
        net = build_model(cfg)
        check(next(net.parameters()).dtype == torch.float32 and
              net.dtype == torch.bfloat16, f"{name}: not a bf16 model")
        ref = plain_variant(cfg, net, False)
        rel = _grad_rel_l2(net, ref, lambda m: TC.cross_entropy(
            m(images[:8]), labels[:8], 0.1))
        del ref
        tx = TT.Optimizer(TT.TrainerConfig(learning_rate=GLA_LR,
                                           weight_decay=0.05))
        state = TT.TrainState.create(net, tx)
        step = TC.make_cls_train_step(net, tx, smoothing=0.1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(every)

        def one():
            nonlocal state
            state, logs = step(state, {"image": images, "label": labels})
            return logs["loss"]

        losses, ms = _timed_steps(one, GLA_TRAIN_STEPS)
        out[f"train_{name}"] = got = _read(every)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name} make_cls_train_step on {gpu}: {GLA_TRAIN_STEPS} "
              f"steps at batch {GLA_TRAIN_BATCH} 224x224 bf16, losses "
              f"{[round(v, 5) for v in losses]}, launches {got}; step "
              f"{ms:.3f} ms (device, CUDA events, median of "
              f"{GLA_TRAIN_STEPS - 1}), {GLA_TRAIN_BATCH / (ms / 1e3):.1f} "
              f"images/s, peak memory {peak:.3f} GiB; bf16 gradients "
              f"against fp32: relative L2 {rel:.4e}", flush=True)
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{name}: losses {losses} not finite or not falling")
        check(not any(got.values()), f"{name} training launched a kernel")
        del net, state, step

    gen = torch.Generator(device="cuda").manual_seed(3100)
    shape = (DENSE_BATCH, 3, DENSE_SIZE, DENSE_SIZE)
    calib = torch.rand(shape, generator=gen, device="cuda")
    x = torch.rand(shape, generator=gen, device="cuda")
    targets = _dense_targets(gen)
    for name in ("retinanet_lsnet", "semanticfpn_lsnet"):
        cfg = _dense_cfg(name)
        net = build_model(cfg)
        calibrate_batchnorm(net, calib)
        net.eval()
        params = dict(net.named_parameters())
        tx = TT.Optimizer(TT.TrainerConfig(learning_rate=DENSE_LR))
        state = TT.TrainState.create(net, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(every)

        def one():
            loss, _ = _dense_losses(name, net, x, targets)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in grads.items()}
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 params)
            TT.apply_updates(state, params, updates, None)
            return loss.detach()

        losses, ms = _timed_steps(one, DENSE_TRAIN_STEPS)
        out[f"train_{name}"] = got = _read(every)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name} Optimizer steps on {gpu}: {DENSE_TRAIN_STEPS} at "
              f"batch {DENSE_BATCH} {DENSE_SIZE}^2 bf16, losses "
              f"{[round(v, 5) for v in losses]}, launches {got}; step "
              f"{ms:.3f} ms (device, CUDA events, median of "
              f"{DENSE_TRAIN_STEPS - 1}), peak memory {peak:.3f} GiB",
              flush=True)
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{name}: losses {losses} not finite or not falling")
        check(not any(got.values()), f"{name} training launched a kernel")
        del net, state
    return out


def _adaptir_cfg(name, extra=(), **model_kwargs):
    """``name``'s options from its serving defaults on the card (bf16, no
    kernel flag) with the command-line flags ``extra`` and the
    ``model_kwargs`` given."""
    from image_restoration_tpu_torch.utils.options import parse_options

    sets = [a for k, v in model_kwargs.items()
            for a in ("--set", f"model_kwargs.{k}={v}")]
    cfg = parse_options(["--model", name, "--device", "cuda", "--seed",
                         "0", *extra, *sets])
    check(cfg["bf16"] and not set(cfg["model_kwargs"]) & set(KERNEL_FLAGS),
          f"{name}: not bf16 without a kernel flag ({cfg['model_kwargs']})")
    return cfg


def calibrate_forward_bns(model, x, **kw):
    """Every BatchNorm2d's statistics set to the batch statistics of one
    ``model(x, train=True, **kw)`` (the BatchNorms of the AdaptIR
    adapters, FPN-Restormer and MyModel follow the forward's ``train``, not
    the module's mode; ``kw``: MyModel's routing generator), each
    normalizing what the ones before it normalized."""
    import torch

    from image_restoration_tpu_torch.ops.layernorm import BatchNorm2d

    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    if not bns:
        return
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = 1.0  # the running statistics become the batch's
    with torch.no_grad():
        model(x, train=True, **kw)
    for bn, momentum in zip(bns, momenta):
        bn.momentum = momentum


def perturb_adaptir(model, seed, x):
    """IPT's or EDT's seeded weights made to exercise every adapter: the
    zero-initialised adapter ``tail``s (nothing an adapter computes would
    reach the image) drawn at lecun's scale, 1 / sqrt(hidden); IPT's first
    head conv at 1 / 255 of its init, as its input is x255 (at the init's
    scale the encoder's output, which the decoder's cross-attention reads
    unnormalised, is ~700, its softmaxes saturate, and fp32 runs agree to
    ~5e-5 only: tests/test_torch_adaptir_ipt.py); the BatchNorm statistics
    from one ``train=True`` forward of ``x`` (``calibrate_forward_bns``). The
    phase weights stay at their init, 1: the phase of a real negative rfft2
    coefficient is +-pi by the sign of rounding noise, which only an
    integer weight maps to one angle."""
    import torch

    from image_restoration_tpu_torch.models.adaptir_ipt import (
        IPT, AdaptIRAdapter,
    )

    randn = _randn_from(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AdaptIRAdapter):
                m.tail.weight.copy_(randn(m.tail.weight) * m.hidden ** -0.5)
        if isinstance(model, IPT):
            model.head[str(model.task_idx)][0].weight.div_(model.rgb_range)
    calibrate_forward_bns(model, x)


def _adaptir_model(cfg, seed, calib_hw, batch=2):
    """``build_model(cfg)`` (its seeded init) through ``perturb_adaptir``
    with a seeded calibration batch of ``batch`` images of ``calib_hw``."""
    import torch

    from image_restoration_tpu_torch.cli.train import build_model

    model = build_model(cfg)
    x = torch.rand((batch, 3, *calib_hw), generator=torch.Generator()
                   .manual_seed(seed + 1)).cuda()
    perturb_adaptir(model, seed, x)
    return model


def _serve_batch(cfg, x):
    """The batch ``make_restore_fn`` gives the model for the NCHW image
    ``x``: its ``--tile`` windows, or the image padded to
    ``--pad_multiple``."""
    from image_restoration_tpu_torch.eval.tiled import window_partition
    from image_restoration_tpu_torch.ops.common import pad_to_multiple

    if cfg.get("tile"):
        return window_partition(x, cfg["tile"])[0]
    return pad_to_multiple(x, cfg["pad_multiple"])[0]


def phase_serve_adaptir(gpu, profile_dir=None):
    """Phase 3o: IPT (its field defaults: n_feats 64, task 5, x1) and EDT
    (embed 180, ``denoise_30``) from their serving defaults, seeded weights
    through ``perturb_adaptir``, restore a seeded 512x512 image in bf16 at
    batch 1 through ``make_restore_fn`` (``ADAPTIR_SERVE``: IPT in 121
    48x48 windows as one batch, EDT padded to 576x576): every kernel's
    count 0, a finite output of the input's size; the forward's device ms
    on the batch the restore feeds it (CUDA events), the restore's ms/img
    (host clock, median of 5), MP/s, peak memory; bf16 against the card's
    fp32 model on that batch (relative L2, max |error|); the card's fp32
    forward against the CPU's at ``ADAPTIR_SMALL`` (``CARD_CPU_ADAPTIR``).
    IPT then restores the image once by ``eval/tiled.py``
    ``overlap_average_apply`` (patch 48, stride 12: 1681 windows in
    batches of ``ADAPTIR_OVERLAP_BATCH``), timed once. Model level (JAX's
    ``make_restore_fn`` crops these x1): EDT's field default ``sr_2`` on
    ``ADAPTIR_SR_IN``^2 (x2 out) and IPT's task 0 (x2) on one 48x48 window,
    finite and of twice the size, the card's fp32 against the CPU's at
    48x48. With ``profile_dir``, a profile of two restores of each model.
    Returns the launch counts by path."""
    import torch

    from image_restoration_tpu_torch.cli.infer import make_restore_fn
    from image_restoration_tpu_torch.eval.tiled import overlap_average_apply
    from image_restoration_tpu_torch.utils.precision import full_fp32

    every = _every_kernel()
    out = {}
    img = np.random.default_rng(3300).random((512, 512, 3), dtype=np.float32)
    x = torch.from_numpy(img).permute(2, 0, 1)[None].cuda()
    for name, (flags, mk) in ADAPTIR_SERVE.items():
        cfg = _adaptir_cfg(name, flags, **mk)
        model = _adaptir_model(cfg, 3310, ADAPTIR_SMALL[name])
        restore = make_restore_fn(cfg, model)
        restore(img)  # warm-up: cuDNN algorithm choice, allocator
        _zero(every)
        res = restore(img)
        out[name] = got = _read(every)
        check(not any(got.values()), f"{name} serving launched a kernel: "
              f"{got}")
        check(res.shape == img.shape and np.isfinite(res).all(),
              f"{name}: output {res.shape} for {img.shape}, or not finite")
        xb = _serve_batch(cfg, x)
        plain32 = plain_variant(cfg, model, False)
        with torch.inference_mode(), full_fp32():
            ref = plain32(xb)
            got16 = model(xb).float()
        err = (got16 - ref).abs().max().item()
        rel = _rel_l2(got16, ref)
        check(np.isfinite(err), f"{name}: non-finite bf16 error")
        del ref, got16
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore(img)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = statistics.median(times)
        with torch.inference_mode(), full_fp32():
            fwd = time_cuda(lambda: model(xb), reps=5, warmup=1,
                            head_start_ms=50.0)
        print(f"{name} serving 512x512 bf16 batch 1 on {gpu} "
              f"({' '.join(flags)}: a forward of {tuple(xb.shape)}): forward "
              f"{fwd:.3f} ms (device, CUDA events), restore {ms:.3f} ms/img "
              f"(host clock, median of 5), {0.262144 / (ms / 1e3):.4f} MP/s, "
              f"peak memory {peak:.3f} GiB, launches {got}; bf16 against "
              f"the card's fp32 model: relative L2 {rel:.4e}, max |err| "
              f"{err:.4e}", flush=True)
        if profile_dir:
            _profile(restore, [img] * 2, profile_dir, name, gpu,
                     "restores at 512x512")
        small = torch.rand((1, 3, *ADAPTIR_SMALL[name]),
                           generator=torch.Generator().manual_seed(3320))
        _card_against_cpu(name, plain32, small, limit=CARD_CPU_ADAPTIR)
        if name == "ipt":
            windows = []

            def fn(w):
                windows.append(w.shape[0])
                return torch.clamp(model(w), 0.0, 1.0)

            with torch.inference_mode(), full_fp32():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dense = overlap_average_apply(
                    fn, x, patch=48, max_batch=ADAPTIR_OVERLAP_BATCH)
                torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
            check(dense.shape == x.shape and torch.isfinite(dense).all(),
                  f"ipt overlap average: {tuple(dense.shape)} or not finite")
            print(f"ipt overlap_average_apply(patch=48, stride 12, "
                  f"max_batch {ADAPTIR_OVERLAP_BATCH}) on 512x512 bf16 on "
                  f"{gpu}: {sum(windows)} windows in {len(windows)} "
                  f"forwards, {dense_ms:.3f} ms (host clock, once), "
                  f"{0.262144 / (dense_ms / 1e3):.4f} MP/s", flush=True)
        del model, plain32, restore
    _zero(every)
    for name, cfg, hw, xin in (
            ("ipt task 0", _adaptir_cfg("ipt", task_idx=0), (48, 48),
             (48, 48)),
            ("edt sr_2", _adaptir_cfg("edt"), (48, 48),
             (ADAPTIR_SR_IN, ADAPTIR_SR_IN))):
        model = _adaptir_model(cfg, 3330, hw)
        xs = torch.rand((1, 3, *xin), generator=torch.Generator()
                        .manual_seed(3340)).cuda()
        with torch.inference_mode(), full_fp32():
            y = model(xs)
            fwd = time_cuda(lambda: model(xs), reps=5, warmup=1,
                            head_start_ms=50.0)
        check(y.shape == (1, 3, 2 * xin[0], 2 * xin[1])
              and torch.isfinite(y).all(),
              f"{name}: output {tuple(y.shape)} for {xin}, or not finite")
        print(f"{name} at model level, {xin[0]}x{xin[1]} -> "
              f"{2 * xin[0]}x{2 * xin[1]} bf16 on {gpu}: forward {fwd:.3f} "
              f"ms (device, CUDA events)", flush=True)
        plain32 = plain_variant(cfg, model, False)
        _card_against_cpu(name, plain32, torch.rand(
            (1, 3, *hw), generator=torch.Generator().manual_seed(3350)),
            limit=CARD_CPU_ADAPTIR)
        del model, plain32
    out["ipt_edt_model_level"] = got = _read(every)
    check(not any(got.values()), f"IPT/EDT at model level launched a "
          f"kernel: {got}")
    return out


def write_bsd68_tree(root, seed=0):
    """Phase "3f 3o"'s BSD68-shaped tree: ``ADAPTIR_EVAL_IMAGES`` clean
    481x321 images under ``denoising/bsd68`` (the benchmark adds the
    noise)."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(ADAPTIR_EVAL_IMAGES):
        path = os.path.join(root, "denoising", "bsd68", f"{i:03d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(_smooth_image(rng, *RAIN100L_SIZE)).save(path)


def phase_eval_adaptir(gpu):
    """Phase "3f 3o": ``cli/test.py`` ``main`` scores IPT (task 5's set,
    ``denoise_50``, ``--tile 48``: 77 windows of 48x48 an image, one
    batch) and EDT (``denoise_30`` weights on ``denoise_25``,
    ``--pad_multiple 96``: 384x576 forwards), each from phase 3o's options
    with seeded weights (``perturb_adaptir``) as a ``.pth`` ``--ckpt``, on
    a seeded BSD68-shaped tree (``write_bsd68_tree``): every kernel's count
    0, finite scores, and each image's on-card PSNR and SSIM within 1e-3 dB
    and 1e-4 of the float64 host recomputation. Returns the launch counts
    by path."""
    import os
    import tempfile

    import torch

    every = _every_kernel()
    out = {}
    with tempfile.TemporaryDirectory(prefix="ir_eval_adaptir_") as tmp:
        data = os.path.join(tmp, "data")
        write_bsd68_tree(data, seed=3360)
        for name, bench in (("ipt", "denoise_50"), ("edt", "denoise_25")):
            flags, mk = ADAPTIR_SERVE[name]
            cfg = _adaptir_cfg(name, flags, **mk)
            model = _adaptir_model(cfg, 3370, ADAPTIR_SMALL[name])
            ckpt = os.path.join(tmp, f"{name}.pth")
            torch.save(model.state_dict(), ckpt)
            del model
            sets = [a for k, v in mk.items()
                    for a in ("--set", f"model_kwargs.{k}={v}")]
            launches, kept = _eval_main(
                name, ["--model", name, "--ckpt", ckpt, "--benchmarks", bench,
                       "--data_file_dir", data, "--output_dir",
                       os.path.join(tmp, name), *flags, *sets],
                every, dict.fromkeys(every, 0), ADAPTIR_EVAL_IMAGES)
            _metrics_to_host(name, kept)
            out[f"eval_{name}"] = launches
    return out


def phase_train_adaptir(gpu):
    """Phase 5a: ``ADAPTIR_TRAIN_STEPS`` ``train/trainer.py`` ``Optimizer``
    steps (AdamW, lr ``ADAPTIR_LR``) of the whole IPT (task 5, batch
    ``ADAPTIR_TRAIN_BATCH`` of 48x48) and EDT (``denoise_30``, the batch at
    96x96) in bf16, ``model(lq, train=True)`` (the adapters' BatchNorms on
    the batch's statistics) with an L1 loss against a seeded target, on
    one seeded batch: finite losses and gradients at every step, the last
    loss below the first, every kernel's count 0; step ms (CUDA events,
    median after the first), images/s, peak memory, and the bf16
    gradients' relative L2 against the fp32 model's on the first two
    images. The training CLI refuses both models, as JAX's cannot train
    them. Returns the launch counts by path."""
    import torch

    from image_restoration_tpu_torch.train import trainer as TT

    every = _every_kernel()
    out = {}
    for name, size, mk in (("ipt", 48, {}),
                           ("edt", 96, {"de_type": "denoise_30"})):
        cfg = _adaptir_cfg(name, **mk)
        gen = torch.Generator(device="cuda").manual_seed(3400)
        shape = (ADAPTIR_TRAIN_BATCH, 3, size, size)
        gt = torch.rand(shape, generator=gen, device="cuda")
        lq = (gt + 0.1 * torch.randn(shape, generator=gen, device="cuda")
              ).clamp(0, 1)
        net = _adaptir_model(cfg, 3410, (size, size))
        ref = plain_variant(cfg, net, False)
        rel = _grad_rel_l2(net, ref, lambda m: (
            m(lq[:2], train=True) - gt[:2]).abs().mean())
        del ref
        params = dict(net.named_parameters())
        tx = TT.Optimizer(TT.TrainerConfig(learning_rate=ADAPTIR_LR))
        state = TT.TrainState.create(net, tx)
        finite = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(every)

        def one():
            loss = (net(lq, train=True) - gt).abs().mean()
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in grads.items()}
            finite.append(torch.stack([torch.isfinite(g).all()
                                       for g in grads.values()]).all())
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 params)
            TT.apply_updates(state, params, updates, None)
            return loss.detach()

        losses, ms = _timed_steps(one, ADAPTIR_TRAIN_STEPS)
        out[f"train_{name}"] = got = _read(every)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name} Optimizer steps on {gpu}: {ADAPTIR_TRAIN_STEPS} at "
              f"batch {ADAPTIR_TRAIN_BATCH} {size}x{size} bf16, train=True, "
              f"losses {[round(v, 6) for v in losses]}, launches {got}; step "
              f"{ms:.3f} ms (device, CUDA events, median of "
              f"{ADAPTIR_TRAIN_STEPS - 1}), "
              f"{ADAPTIR_TRAIN_BATCH / (ms / 1e3):.1f} images/s, peak memory "
              f"{peak:.3f} GiB; bf16 gradients against fp32: relative L2 "
              f"{rel:.4e}", flush=True)
        check(all(bool(f) for f in finite), f"{name}: a non-finite gradient")
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{name}: losses {losses} not finite or not falling")
        check(not any(got.values()), f"{name} training launched a kernel")
        del net, state
    return out


def perturb_branches(model, seed, x, device="cuda"):
    """RectiFormer's, FPN-Restormer's or MyModel's seeded weights made to
    exercise every branch: MyModel's zero-initialised ``beta``/``gamma``
    layer scales (nothing a Mix, an adapter or a decoder mixer computes
    would reach the image) drawn as 0.5 + 0.2 x a standard normal and its
    AdaptIR adapters' zero ``tail``\\ s at lecun's scale, 1 / sqrt(hidden);
    every BatchNorm's statistics from one ``train=True`` forward of ``x``
    (``calibrate_forward_bns``; MyModel's routing noise from a seeded
    ``device`` generator). RectiFormer has neither. The phase weights stay
    at their init, 1 (``perturb_adaptir``)."""
    import torch

    from image_restoration_tpu_torch.models.adaptir_ipt import AdaptIRAdapter

    randn = _randn_from(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("beta", "gamma")):
                p.copy_(0.5 + 0.2 * randn(p))
        for m in model.modules():
            if isinstance(m, AdaptIRAdapter):
                m.tail.weight.copy_(randn(m.tail.weight) * m.hidden ** -0.5)
    kw = {}
    if getattr(type(model), "uses_moe_rng", False):
        kw["generator"] = torch.Generator(device=device).manual_seed(seed)
    calibrate_forward_bns(model, x, **kw)


def _branch_model(name, seed, calib_hw=BRANCH_SMALL):
    """``build_model`` of ``name``'s serving defaults on the card (bf16;
    its seeded init), through ``perturb_branches`` with a seeded
    calibration batch of two ``calib_hw`` images: the size the model then
    runs at, as FPN-Restormer's frequency-aware blocks feed the fft2's
    magnitude, which grows with the pixel count, to their BatchNorms (with
    statistics of 64x64 images a 512x512 one gives outputs of ~1e9 in
    bf16, and inf); (cfg, model)."""
    import torch

    from image_restoration_tpu_torch.cli.train import build_model

    cfg = _adaptir_cfg(name)
    model = build_model(cfg)
    x = torch.rand((2, 3, *calib_hw), generator=torch.Generator()
                   .manual_seed(seed + 1)).cuda()
    perturb_branches(model, seed, x)
    return cfg, model


def _idle_share(fn, arg):
    """One call of ``fn(arg)`` under ``torch.profiler``: (device busy ms,
    host-clock ms of the call under the profiler); busy is None when the
    profiler shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3
    return (busy or None), wall


def _serve_one(gpu, name, cfg, model, img, profile_dir, small, limit,
               held=None):
    """One restoration model from ``cfg`` restores the seeded ``img`` in
    bf16 at batch 1 through ``make_restore_fn``: every kernel's count 0, a
    finite output of the input's size; the forward's device ms (CUDA
    events), the restore's ms/img (host clock, median of 5), MP/s, peak
    memory and the device's idle share in one profiled restore; bf16
    against the card's fp32 model (relative L2, max |error|); the card's
    fp32 forward against the CPU's at ``small`` (``limit``): its output,
    or the output of its submodule ``held`` when one is named. With
    ``profile_dir``, a profile of two restores. Returns the launch
    counts."""
    import torch

    from image_restoration_tpu_torch.cli.infer import make_restore_fn
    from image_restoration_tpu_torch.utils.precision import full_fp32

    every = _every_kernel()
    x = torch.from_numpy(img).permute(2, 0, 1)[None].cuda()
    h, w = img.shape[:2]
    restore = make_restore_fn(cfg, model)
    restore(img)  # warm-up: cuDNN algorithm choice, allocator
    _zero(every)
    res = restore(img)
    got = _read(every)
    check(not any(got.values()), f"{name} serving launched a kernel: {got}")
    check(res.shape == img.shape and np.isfinite(res).all(),
          f"{name}: output {res.shape} for {img.shape}, or not finite")
    plain32 = plain_variant(cfg, model, False)
    with torch.inference_mode(), full_fp32():
        ref = plain32(x)
        got16 = model(x).float()
    err = (got16 - ref).abs().max().item()
    rel = _rel_l2(got16, ref)
    check(np.isfinite(err) and bool(torch.isfinite(ref).all()),
          f"{name}: non-finite fp32 output or bf16 error")
    del ref, got16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    with torch.inference_mode(), full_fp32():
        fwd = time_cuda(lambda: model(x), reps=5, warmup=1,
                        head_start_ms=50.0)
    busy, wall = _idle_share(restore, img)
    idle = ("not measured (no device time in the profile)"
            if busy is None else
            f"device busy {busy:.3f} ms of {wall:.3f} ms, "
            f"{100 * (1 - busy / wall):.2f}% idle")
    print(f"{name} serving {h}x{w} bf16 batch 1 on {gpu}: forward "
          f"{fwd:.3f} ms (device, CUDA events), restore {ms:.3f} ms/img "
          f"(host clock, median of 5), {h * w / 1e6 / (ms / 1e3):.4f} MP/s, "
          f"peak memory {peak:.3f} GiB, launches {got}; one profiled "
          f"restore: {idle}; bf16 against the card's fp32 model: "
          f"relative L2 {rel:.4e}, max |err| {err:.4e}", flush=True)
    if profile_dir:
        _profile(restore, [img] * 2, profile_dir, name, gpu,
                 f"restores at {h}x{w}")
    x_small = torch.rand((1, 3, *small),
                         generator=torch.Generator().manual_seed(3520))
    if held is None:
        _card_against_cpu(name, plain32, x_small, limit=limit)
    else:
        _card_against_cpu(f"{name} after {held}", _forward_of(
            plain32, _stage_output(held)), x_small, limit=limit)
    return got


def phase_serve_branch(gpu, profile_dir=None):
    """Phase 3p: RectiFormer, FPN-Restormer and MyModel from their serving
    defaults (the JAX field defaults; bf16, ``--pad_multiple`` 8), seeded
    weights through ``perturb_branches`` (calibrated on two 512x512
    images), restore a seeded 512x512 image through ``_serve_one``, the
    card's fp32 forward held to the CPU's at ``BRANCH_SMALL``
    (``CARD_CPU_BRANCH``). Returns the launch counts by model."""
    img = np.random.default_rng(3500).random((512, 512, 3), dtype=np.float32)
    out = {}
    for name in BRANCH_MODELS:
        cfg, model = _branch_model(name, 3510, img.shape[:2])
        out[name] = _serve_one(gpu, name, cfg, model, img, profile_dir,
                               BRANCH_SMALL, CARD_CPU_BRANCH)
        del model
    return out


def phase_eval_branch(gpu):
    """Phase "3f 3p": ``cli/test.py`` ``main`` scores RectiFormer,
    FPN-Restormer and MyModel (``denoise_25`` on phase "3f 3o"'s
    BSD68-shaped tree, ``write_bsd68_tree``: 488x328 forwards at
    ``--pad_multiple`` 8), each from its serving defaults with seeded
    weights (``perturb_branches``, calibrated at 488x328) as a ``.pth``
    ``--ckpt``: every
    kernel's count 0, finite scores, and each image's on-card PSNR and SSIM
    within 1e-3 dB and 1e-4 of the float64 host recomputation. Returns the
    launch counts by path."""
    import os
    import tempfile

    import torch

    every = _every_kernel()
    out = {}
    with tempfile.TemporaryDirectory(prefix="ir_eval_branch_") as tmp:
        data = os.path.join(tmp, "data")
        write_bsd68_tree(data, seed=3530)
        for name in BRANCH_MODELS:
            _, model = _branch_model(name, 3540, (328, 488))
            ckpt = os.path.join(tmp, f"{name}.pth")
            torch.save(model.state_dict(), ckpt)
            del model
            launches, kept = _eval_main(
                name, ["--model", name, "--ckpt", ckpt, "--benchmarks",
                       "denoise_25", "--data_file_dir", data,
                       "--output_dir", os.path.join(tmp, name)],
                every, dict.fromkeys(every, 0), ADAPTIR_EVAL_IMAGES)
            _metrics_to_host(name, kept)
            out[f"eval_{name}"] = launches
    return out


def _train_through_cli(gpu, every, lq, gt, name="rectiformer", extra=(),
                       seed=3610):
    """``BRANCH_TRAIN_STEPS`` steps of ``cli/train.py`` ``main`` on
    ``name`` (phase 4p's RectiFormer, phase 4q's SFSNiD and PINN; ``extra``
    the CLI's further flags) on a seeded tree, then a step alone with the
    loss terms the flags give; the launch counts of the run."""
    import json
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli import train as TR
    from image_restoration_tpu_torch.train import trainer as TT
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, parse_options,
    )

    with tempfile.TemporaryDirectory(prefix="ir_branch_") as tmp:
        data = os.path.join(tmp, "data")
        _train_tree(data, seed=seed)
        argv = ["--model", name, "--device", "cuda",
                "--data_file_dir", data, "--batch_size", str(TRAIN_BATCH),
                "--patch_size", str(TRAIN_PATCH), "--warmup_epochs", "0",
                "--lr", str(TRAIN_LR), "--save_every",
                str(BRANCH_TRAIN_STEPS), "--log_every", "1", "--ckpt_dir",
                os.path.join(tmp, "exp"), "--name", name, *extra]
        terms = parse_options(argv, build_train_parser())["loss"]
        _zero(every)
        t1 = time.perf_counter()
        TR.main(argv, max_steps_override=BRANCH_TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = _read(every)
        exp = os.path.join(tmp, "exp", name)
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            rows = [e["train/total"] for e in map(json.loads, f)
                    if "train/total" in e]
        check(not any(got.values()), f"{name} training launched a "
              f"kernel: {got}")
        check(len(rows) == BRANCH_TRAIN_STEPS and np.isfinite(rows).all(),
              f"{name}: logged losses {rows}")
        fixed = {k: torch.stack([_read_image(os.path.join(
            data, "val", k, f"{i:03d}.png"))[:, :TRAIN_PATCH, :TRAIN_PATCH]
            for i in range(2)]) for k in ("lq", "gt")}
        trained = torch.load(os.path.join(exp, "ckpt",
                                          f"{BRANCH_TRAIN_STEPS}.pth"),
                             map_location="cuda")["params"]
    cfg = _adaptir_cfg(name)
    model = TR.build_model(cfg)
    l1 = []
    for params in (None, trained):
        if params is not None:
            model.load_state_dict(params)
        with torch.inference_mode():
            l1.append((model(fixed["lq"]) - fixed["gt"]).abs().mean().item())
    check(np.isfinite(l1).all() and l1[1] < l1[0],
          f"{name}: the fixed batch's L1 {l1} did not fall")
    ref = plain_variant(cfg, model, False)
    rel = _grad_rel_l2(model, ref, lambda m: (m(lq[:2]) - gt[:2]).abs()
                       .mean())
    del ref
    model.train()
    tcfg = TT.TrainerConfig(learning_rate=TRAIN_LR,
                            loss=terms)
    tx = TT.make_optimizer(tcfg)
    state = TT.TrainState.create(model, tx)
    step = TT.make_train_step(model, tx, tcfg)
    batch = {"lq": lq, "gt": gt}
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name} cli/train.py {' '.join(extra)} on {gpu}: "
          f"{BRANCH_TRAIN_STEPS} steps at "
          f"batch {TRAIN_BATCH} {TRAIN_PATCH}x{TRAIN_PATCH} bf16 in "
          f"{wall:.1f} s (host clock, with a save), losses "
          f"{[round(v, 6) for v in rows]}, launches {got}; L1 on a fixed "
          f"batch of 2 (validation crops): initial {l1[0]:.5f}, after "
          f"{BRANCH_TRAIN_STEPS} steps {l1[1]:.5f}; a step alone {ms:.3f} ms "
          f"(CUDA events, median of 5 after 2 warm-up steps), "
          f"{TRAIN_BATCH / (ms / 1e3):.2f} images/s, peak memory "
          f"{peak:.3f} GiB; bf16 gradients against fp32: relative L2 "
          f"{rel:.4e}", flush=True)
    return got


def phase_train_branch(gpu):
    """Phase 4p: RectiFormer takes ``BRANCH_TRAIN_STEPS`` steps of
    ``cli/train.py`` ``main`` (phase 4's tree, bf16, batch ``TRAIN_BATCH``
    of ``TRAIN_PATCH``^2, AdamW at ``TRAIN_LR``): finite logged losses,
    the L1 loss on a fixed batch (the validation pairs' crops) lower with
    the final checkpoint than with the initial model; then its step ms
    alone (``make_train_step``, CUDA events, median of 5 after 2 warm-up
    steps). FPN-Restormer and MyModel, which the CLI refuses as JAX's
    does, take ``BRANCH_TRAIN_STEPS`` ``train/trainer.py`` ``Optimizer``
    steps (AdamW, lr ``BRANCH_LR``) at model level on one seeded batch,
    ``model(lq, train=True)`` (the BatchNorms on the batch's statistics;
    MyModel's routing noise from a device generator and its balance loss
    at ``--aux_loss_weight``'s default 0.01): finite losses and gradients,
    the last loss below the first; step ms (CUDA events, median after the
    first). For each: every kernel's count 0, images/s, peak memory, and
    the bf16 gradients' relative L2 against the fp32 model's on two
    images. Returns the launch counts by path."""
    import torch

    from image_restoration_tpu_torch.train import trainer as TT

    t0 = time.perf_counter()
    every = _every_kernel()
    gen = torch.Generator(device="cuda").manual_seed(3600)
    shape = (TRAIN_BATCH, 3, TRAIN_PATCH, TRAIN_PATCH)
    gt = torch.rand(shape, generator=gen, device="cuda")
    lq = (gt + 0.1 * torch.randn(shape, generator=gen, device="cuda")
          ).clamp(0, 1)
    out = {"train_rectiformer": _train_through_cli(gpu, every, lq, gt)}
    for name in BRANCH_MODELS[1:]:
        cfg, net = _branch_model(name, 3620, (TRAIN_PATCH, TRAIN_PATCH))
        moe = getattr(type(net), "uses_moe_rng", False)
        noise = torch.Generator(device="cuda").manual_seed(3630)

        def loss_of(m, a, b, g=noise):
            res = m(a, train=True, **({"generator": g} if moe else {}))
            if moe:
                res, aux = res
                return (res - b).abs().mean() + 0.01 * aux["aux_loss"]
            return (res - b).abs().mean()

        ref = plain_variant(cfg, net, False)
        rel = _grad_rel_l2(net, ref, lambda m: loss_of(
            m, lq[:2], gt[:2], torch.Generator(device="cuda")
            .manual_seed(3640)))
        del ref
        params = dict(net.named_parameters())
        tx = TT.Optimizer(TT.TrainerConfig(learning_rate=BRANCH_LR))
        state = TT.TrainState.create(net, tx)
        finite = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(every)

        def one():
            loss = loss_of(net, lq, gt)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in grads.items()}
            finite.append(torch.stack([torch.isfinite(g).all()
                                       for g in grads.values()]).all())
            updates, state.opt_state = tx.update(grads, state.opt_state,
                                                 params)
            TT.apply_updates(state, params, updates, None)
            return loss.detach()

        losses, ms = _timed_steps(one, BRANCH_TRAIN_STEPS)
        out[f"train_{name}"] = got = _read(every)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{name} Optimizer steps on {gpu}: {BRANCH_TRAIN_STEPS} at "
              f"batch {TRAIN_BATCH} {TRAIN_PATCH}x{TRAIN_PATCH} bf16, "
              f"train=True{', L1 + 0.01 aux_loss' if moe else ''}, losses "
              f"{[round(v, 6) for v in losses]}, launches {got}; step "
              f"{ms:.3f} ms (device, CUDA events, median of "
              f"{BRANCH_TRAIN_STEPS - 1}), {TRAIN_BATCH / (ms / 1e3):.1f} "
              f"images/s, peak memory {peak:.3f} GiB; bf16 gradients "
              f"against fp32: relative L2 {rel:.4e}", flush=True)
        check(all(bool(f) for f in finite), f"{name}: a non-finite gradient")
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{name}: losses {losses} not finite or not falling")
        check(not any(got.values()), f"{name} training launched a kernel")
        del net, state
    print(f"train: phase 4p took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out

def phase_serve_demo(gpu, profile_dir=None):
    """Phase 3q: SFSNiD (num_res 3, base 32) and PINN from their serving
    defaults (the JAX field defaults; bf16, ``--pad_multiple`` 8), seeded
    init, restore a seeded 512x512 image through ``_serve_one``, the
    card's fp32 forward held to the CPU's at ``DEMO_SMALL``
    (``CARD_CPU_DEMO``): PINN's whole output, SFSNiD's after its first two
    encoder stages (``SFSNID_HELD``). Past them the card's run and the
    CPU's part at the angle's branch cut: SFSNiD's spectrum blocks add a
    1x1-conv branch to ``angle(rfft2)``, which jumps by 2 pi where a
    coefficient crosses the negative real axis, and a coefficient whose
    imaginary part is within rounding of 0 there lands on either side in
    two fp32 runs (``tools/sfsnid_branch_cut.py``; JAX's fp32 forward lies
    as far from its float64 one, ``tests/sfsnid_conditioning.py``). One
    block (64 channels, a 17x13 map of positive mean) is held to the
    CPU's as well. Then the model-level paths: HiLo (dim
    ``HILO_DIM``, 8 heads, window 2, alpha 0.5) on a batch of
    ``HILO_BATCH`` ``HILO_SIDE``^2 maps of ``HILO_DIM`` channels, fp32 and
    bf16 forwards; ``FreqAdapterLayer`` (dim ``LAYER_DIM``, four experts,
    top-2, ``freq_dim`` 128, MoCE-IR's spread ranks) and ``FCM`` (dim
    ``LAYER_DIM``) in bf16, a ``train=True`` forward and its backward on a
    batch of ``LAYER_BATCH`` ``LAYER_SIDE``^2 maps (the adapter's routing
    noise from a device generator): device ms (CUDA events), finite
    outputs and gradients, and each one's fp32 forward, card against CPU
    (``CARD_CPU_DEMO``; the adapter in eval, FCM in eval and in
    training). Every kernel's count 0. Returns the launch counts by
    path."""
    import torch

    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.models import get_model
    from image_restoration_tpu_torch.models.demo_models import (
        SFSTransformerBlock,
    )
    from image_restoration_tpu_torch.ops.freq_moe import FreqAdapterLayer
    from image_restoration_tpu_torch.ops.fusion_blocks import FCM
    from image_restoration_tpu_torch.utils.precision import full_fp32

    def seeded(seed, make):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return make()

    every = _every_kernel()
    out = {}
    img = np.random.default_rng(3700).random((512, 512, 3), dtype=np.float32)
    for name in DEMO_MODELS:
        cfg = _adaptir_cfg(name)
        out[name] = _serve_one(gpu, name, cfg, build_model(cfg), img,
                               profile_dir, DEMO_SMALL, CARD_CPU_DEMO,
                               SFSNID_HELD if name == "sfsnid" else None)
    block = seeded(3716, lambda: SFSTransformerBlock(64)).cuda().eval()
    _card_against_cpu("sfsnid block (64 channels)", block, 1.0 + torch.randn(
        (2, 64, 17, 13), generator=torch.Generator().manual_seed(3717)),
        limit=CARD_CPU_DEMO)

    gen = torch.Generator(device="cuda").manual_seed(3710)
    xh = torch.randn((HILO_BATCH, HILO_DIM, HILO_SIDE, HILO_SIDE),
                     generator=gen, device="cuda")
    h32 = seeded(3711, lambda: get_model("hilo", dim=HILO_DIM)).cuda().eval()
    h16 = get_model("hilo", dim=HILO_DIM, dtype=torch.bfloat16).cuda().eval()
    h16.load_state_dict(h32.state_dict())
    _zero(every)
    with torch.inference_mode(), full_fp32():
        o32, o16 = h32(xh), h16(xh).float()
        check(o32.shape == xh.shape and bool(torch.isfinite(o16).all()),
              f"hilo: output {tuple(o32.shape)} or not finite")
        rel = _rel_l2(o16, o32)
        ms = {tag: time_cuda(lambda m=m: m(xh), reps=10, warmup=2)
              for tag, m in (("fp32", h32), ("bf16", h16))}
    out["hilo"] = got = _read(every)
    check(not any(got.values()), f"hilo launched a kernel: {got}")
    print(f"hilo (dim {HILO_DIM}, model level) batch {HILO_BATCH} "
          f"{HILO_SIDE}x{HILO_SIDE} on {gpu}: forward fp32 "
          f"{ms['fp32']:.3f} ms, bf16 {ms['bf16']:.3f} ms (device, CUDA "
          f"events, median of 10), "
          f"{HILO_BATCH / (ms['bf16'] / 1e3):.1f} maps/s in bf16; bf16 "
          f"against fp32: relative L2 {rel:.4e}", flush=True)
    del o32, o16, xh
    _card_against_cpu("hilo", h32, torch.randn(
        (2, HILO_DIM, 16, 16), generator=torch.Generator().manual_seed(3712)),
        limit=CARD_CPU_DEMO)

    shape = (LAYER_BATCH, LAYER_DIM, LAYER_SIDE, LAYER_SIDE)
    x = torch.randn(shape, generator=gen, device="cuda")
    shared = torch.randn(shape, generator=gen, device="cuda")
    small = torch.randn((2, LAYER_DIM, 24, 20),
                        generator=torch.Generator().manual_seed(3713))
    layers = {
        "freq_adapter": lambda dt: FreqAdapterLayer(
            LAYER_DIM, 2, rank_type="spread", dtype=dt),
        "fcm": lambda dt: FCM(LAYER_DIM, dtype=dt)}
    for tag, make in layers.items():
        m32 = seeded(3714, lambda: make(None)).cuda()
        m16 = make(torch.bfloat16).cuda()
        m16.load_state_dict(m32.state_dict())
        noise = torch.Generator(device="cuda").manual_seed(3715)

        def step(m=m16, adapter=tag == "freq_adapter"):
            m.zero_grad(set_to_none=True)
            res = (m(x, None, shared, train=True, generator=noise)
                   if adapter else (m(x, train=True), 0.0))
            loss = res[0].float().square().mean() + res[1]
            loss.backward()
            return loss.detach()

        _zero(every)
        losses, step_ms = _timed_steps(step, 6)
        out[tag] = got = _read(every)
        check(not any(got.values()), f"{tag} launched a kernel: {got}")
        finite = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                     for p in m16.parameters())
        check(np.isfinite(losses).all() and finite,
              f"{tag}: losses {losses} or a gradient not finite")
        print(f"{tag} (dim {LAYER_DIM}) train=True forward + backward, "
              f"bf16, batch {LAYER_BATCH} {LAYER_SIDE}x{LAYER_SIDE} on {gpu}: "
              f"{step_ms:.3f} ms (device, CUDA events, median of 5), "
              f"launches {got}, every gradient finite", flush=True)
        if tag == "freq_adapter":
            _card_against_cpu(tag, _forward_of(m32.eval(), lambda m, a: m(
                a, None, a)[0]), small, limit=CARD_CPU_DEMO)
        else:
            _card_against_cpu(tag, m32.eval(), small, limit=CARD_CPU_DEMO)
            _card_against_cpu(f"{tag} train=True", _forward_of(
                m32, lambda m, a: m(a, train=True)), small,
                limit=CARD_CPU_DEMO)
        del m32, m16
    return out


def _forward_of(module, fn):
    """``fn(module, x)`` as the forward of an ``nn.Module`` that holds
    ``module``, which ``_card_against_cpu`` can copy to the CPU."""
    import torch

    class Forward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.module = module

        def forward(self, x):
            return fn(self.module, x)

    return Forward()


def _stage_output(name):
    """``fn(model, x)``: the output of ``model``'s submodule ``name`` in a
    forward of ``x``."""
    def fn(model, x):
        got = []
        hook = model.get_submodule(name).register_forward_hook(
            lambda m, i, o: got.append(o))
        try:
            model(x)
        finally:
            hook.remove()
        return got[0]

    return fn


def phase_eval_demo(gpu):
    """Phase "3f 3q": ``cli/test.py`` ``main`` with ``--unpaired`` scores
    SFSNiD (its serving defaults, seeded init, as a ``.pth`` ``--ckpt``)
    on a seeded folder of ``UNPAIRED_IMAGES`` ``UNPAIRED_SIZE``^2 PNGs
    with synthetic ``--niqe_params``: every kernel's count 0, the keys of
    JAX's ``results.json``, the inputs' mean NIQE equal to the host's
    recomputation exactly, the outputs' finite; the run's host seconds.
    Then ``fid_from_features`` between two seeded sets of
    ``FID_IMAGES`` 64x64 images, the features the port's VGG16 trunk's
    relu1_2 (seed-1 random weights) pooled over the pixels, on the card
    and on the CPU: both finite and within 1e-3 relative. Returns the
    launch counts by path."""
    import json
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli import test as T
    from image_restoration_tpu_torch.cli.infer import load_image
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.eval.fid import (
        extract_features, fid_from_features,
    )
    from image_restoration_tpu_torch.eval.niqe import calculate_niqe
    from image_restoration_tpu_torch.eval.perceptual import VGG16Features
    from image_restoration_tpu_torch.utils.precision import full_fp32
    from PIL import Image

    every = _every_kernel()
    out = {}
    rng = np.random.default_rng(3800)
    with tempfile.TemporaryDirectory(prefix="ir_unpaired_") as tmp:
        src = os.path.join(tmp, "lq")
        os.makedirs(src)
        for i in range(UNPAIRED_IMAGES):
            Image.fromarray(_smooth_image(rng, UNPAIRED_SIZE,
                                          UNPAIRED_SIZE)).save(
                os.path.join(src, f"{i:03d}.png"))
        pris = _load_tool("seeding", "tests").write_niqe_params(
            os.path.join(tmp, "pris.npz"), seed=3801)
        ckpt = os.path.join(tmp, "sfsnid.pth")
        torch.save(build_model(_adaptir_cfg("sfsnid")).state_dict(), ckpt)
        od = os.path.join(tmp, "res")
        _zero(every)
        t0 = time.perf_counter()
        res = T.main(["--model", "sfsnid", "--ckpt", ckpt, "--unpaired",
                      "--lq_dir", src, "--niqe_params", pris,
                      "--output_dir", od])
        wall = time.perf_counter() - t0
        out["eval_unpaired_sfsnid"] = got = _read(every)
        with open(os.path.join(od, "results.json")) as f:
            saved = json.load(f)
        host = float(np.mean([calculate_niqe(load_image(os.path.join(
            src, n)), params_path=pris) for n in sorted(os.listdir(src))]))
    r = res["unpaired"]
    check(saved == res and set(r) == {"n", "niqe", "niqe_input"}
          and r["n"] == UNPAIRED_IMAGES, f"unpaired results {saved}")
    check(not any(got.values()), f"unpaired scoring launched a kernel: "
          f"{got}")
    check(r["niqe_input"] == host, f"inputs' NIQE {r['niqe_input']} is not "
          f"the host's {host}")
    check(np.isfinite(r["niqe"]), f"outputs' NIQE {r['niqe']}")
    print(f"3f (3q) sfsnid cli/test.py --unpaired on {gpu}: "
          f"{UNPAIRED_IMAGES} images of {UNPAIRED_SIZE}x{UNPAIRED_SIZE} in "
          f"{wall:.2f} s (host clock, NIQE on the host included): NIQE "
          f"{r['niqe']:.6f}, inputs {r['niqe_input']:.6f} (equal to the "
          f"host's recomputation), launches {got}", flush=True)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        vgg = VGG16Features(taps=(3,)).eval()
    gen = torch.Generator().manual_seed(3802)
    sets = [[torch.rand((FID_IMAGES // 3, 3, 64, 64), generator=gen) * s + o
             for _ in range(3)] for s, o in ((1.0, 0.0), (0.6, 0.2))]
    fids, times = {}, {}
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        net = vgg.to(dev)

        def feature_fn(batch, net=net, dev=dev):
            with torch.inference_mode(), full_fp32():
                return net(batch.to(dev))[-1].float().mean((2, 3))

        t0 = time.perf_counter()
        feats = [extract_features(iter(s), feature_fn) for s in sets]
        fids[where] = fid_from_features(*feats)
        times[where] = time.perf_counter() - t0
    rel = abs(fids["card"] - fids["host"]) / abs(fids["host"])
    print(f"3f (3q) FID of two sets of {FID_IMAGES} 64x64 images, VGG16 "
          f"relu1_2 features (64, pooled), on {gpu}: card {fids['card']:.6f} "
          f"({times['card']:.2f} s host clock, features and distance), CPU "
          f"{fids['host']:.6f} ({times['host']:.2f} s); relative difference "
          f"{rel:.3e}", flush=True)
    check(np.isfinite(list(fids.values())).all() and rel <= 1e-3,
          f"FID card {fids['card']} against CPU {fids['host']}")
    return out


def phase_train_demo(gpu):
    """Phase 4q: ``BRANCH_TRAIN_STEPS`` steps of ``cli/train.py`` ``main``
    (phase 4's tree, bf16, batch ``TRAIN_BATCH`` of ``TRAIN_PATCH``^2,
    AdamW at ``TRAIN_LR``) on SFSNiD with the default recipe (L1 of the
    full-size output, ``train=False`` as the JAX CLI applies it) and on
    PINN with ``--loss mse=1.0 grad_smooth=1.0`` (the reference's MSE plus
    its gradient-smoothness prior, each weighted 1), through
    ``_train_through_cli``: finite logged losses, the fixed batch's L1
    lower after the steps, a step alone timed, every kernel's count 0,
    the bf16 gradients' relative L2 against the fp32 model's. Returns the
    launch counts by path."""
    import torch

    t0 = time.perf_counter()
    every = _every_kernel()
    gen = torch.Generator(device="cuda").manual_seed(3900)
    shape = (TRAIN_BATCH, 3, TRAIN_PATCH, TRAIN_PATCH)
    gt = torch.rand(shape, generator=gen, device="cuda")
    lq = (gt + 0.1 * torch.randn(shape, generator=gen, device="cuda")
          ).clamp(0, 1)
    out = {"train_sfsnid": _train_through_cli(gpu, every, lq, gt, "sfsnid",
                                              seed=3910)}
    out["train_pinn"] = _train_through_cli(
        gpu, every, lq, gt, "pinn", ["--loss", "mse=1.0", "grad_smooth=1.0"],
        seed=3920)
    print(f"train: phase 4q took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def _every_kernel():
    """Every kernel's wrapper, by the name the kernels line gives it."""
    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KQ
    from image_restoration_tpu_torch.kernels import mefc as KM
    from image_restoration_tpu_torch.kernels import ska as KS

    return {"block_front": KB.block_front,
            "block_apply_gdfn": KB.block_apply_gdfn,
            "ln_gdfn": KG.fused_ln_gdfn, "ln_qkv_dwconv": KQ.ln_qkv_dwconv,
            "attn_acc": KA.attn_acc, "attn_apply": KA.attn_apply,
            "drs_apply_msfn": KD.drs_apply_msfn, "mefc_step": KM.mefc_step,
            "ska": KS.ska, "ska_bwd_x": KS.ska_bwd_x,
            "ska_bwd_w": KS.ska_bwd_w}


def bound_ska_bwd(b, h, w, c, wc, esize):
    """``ska_bwd_x`` or ``ska_bwd_w`` (the same count for both): read go
    and w (gx) or go and x (gw), write gx or gw; 9 fp32 multiply-adds per
    channel of a pixel (gx: the taps; gw: the repeats of each of the
    9 wc weights)."""
    n = b * h * w
    return roofline(esize * (2 * n * c + n * wc * 9), 0.0, 2 * 9 * n * c)


@contextlib.contextmanager
def _bwd_tables(c, esize, th=None, ring=None, split=None):
    """SKA's backward launch tables at width ``c`` and ``esize`` bytes a
    value, for both gradients, set while the block runs; None keeps an
    entry, ``th`` 0 sends both to the simple kernels."""
    from image_restoration_tpu_torch.kernels import ska as K

    keys = [("x", c, esize), ("w", c, esize)]
    with contextlib.ExitStack() as stack:
        for key in keys:
            stack.enter_context(_kept(key, K._BWD_ROWS, K._BWD_RING,
                                      K._BWD_SPLIT))
            for table, v in ((K._BWD_ROWS, th), (K._BWD_RING, ring),
                             (K._BWD_SPLIT, split)):
                if v is not None:
                    table[key] = v
        yield


def phase_ska_bwd_kernels(shapes=SKA_SHAPES, b=LSNET_BATCH, tag=""):
    """SKA's two backward kernels (``csrc/ska_bwd.cu``) at ``shapes``
    (LSNet-B's three SKA shapes by default) on a batch of ``b``, bf16 and
    fp32: each takes the strip path; the bits of ``ska_bwd_plain`` (the
    same products and sums in the same order), K9's rule against the fp32
    plain version, two runs bit-equal, each image of a batch of two as it
    is alone; the times of both against the simple kernels forced at the
    same shapes (which must give the same bits; strip, simple, simple,
    strip, the two runs of each giving the timer's spread), each with its
    share of ``bound_ska_bwd``, and against the plain version; printed
    with ``tag``."""
    import torch

    from image_restoration_tpu_torch.kernels import ska as K
    from image_restoration_tpu_torch.ops.ska import ska_bwd_plain

    report = _new_report(("ska_bwd_x", "ska_bwd_w"))
    sums = {}
    for i, (h, w, c, wc, calls) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(2000 + i)
        x, wt, go = (torch.randn(s, generator=gen, device="cuda") for s in
                     ((b, h, w, c), (b, h, w, wc, 9), (b, h, w, c)))
        oracle = ska_bwd_plain(x, wt, go)
        where = f"{b}x{h}x{w}x{c} wc {wc}"
        out = {}
        for dt in (torch.bfloat16, torch.float32):
            esize = 4 if dt == torch.float32 else 2
            xd, wd, gd = x.to(dt), wt.to(dt), go.to(dt)
            plain = ska_bwd_plain(xd, wd, gd)
            for k, (name, fn) in enumerate((("ska_bwd_x", K.ska_bwd_x),
                                            ("ska_bwd_w", K.ska_bwd_w))):
                what = f"{name} {dt} at {where}"
                route = K.bwd_route(xd, wd, gd, name[-1])
                check(route == "strip", f"{what}: the {route} path, not the "
                      f"strip kernel")
                kern, again = fn(xd, wd, gd), fn(xd, wd, gd)
                two = fn(xd[:2], wd[:2], gd[:2])
                torch.cuda.synchronize()
                check(torch.equal(kern, plain[k]), f"{what}: not the bits of "
                      f"ska_bwd_plain (max |diff| "
                      f"{(kern.float() - plain[k].float()).abs().max():.3e})")
                check(torch.equal(kern, again), f"{what}: two runs differ")
                check(torch.equal(two[1:], fn(xd[1:2], wd[1:2], gd[1:2])) and
                      torch.equal(two, kern[:2]), f"{what}: the images of a "
                      f"batch are not independent")
                err = rel_err(kern, oracle[k])
                if dt == torch.float32:
                    check(err <= 1e-5, f"{what}: rel err {err:.3e} above 1e-5")
                else:
                    ep = rel_err(plain[k], oracle[k])
                    check(err < _bound(ep), f"{what}: rel err {err:.3e} above "
                          f"max(3 x {ep:.3e}, 4e-3)")
                # strip, simple, simple, strip: the two runs of each give
                # the timer's spread
                t_k1 = time_cuda(lambda: fn(xd, wd, gd))
                with _bwd_tables(c, esize, th=0):
                    check(K.bwd_route(xd, wd, gd, name[-1]) == "simple",
                          f"{what}: the simple kernel was not forced")
                    simple = fn(xd, wd, gd)
                    torch.cuda.synchronize()
                    check(torch.equal(simple, kern), f"{what}: the simple "
                          f"kernel's bits differ from the strip kernel's")
                    t_s1 = time_cuda(lambda: fn(xd, wd, gd))
                    t_s2 = time_cuda(lambda: fn(xd, wd, gd))
                t_k2 = time_cuda(lambda: fn(xd, wd, gd))
                t_k, t_s = (t_k1 + t_k2) / 2, (t_s1 + t_s2) / 2
                spread = max(abs(t_k1 - t_k2), abs(t_s1 - t_s2))
                out[name, dt] = (err, t_k, t_s, spread)
                bound = bound_ska_bwd(b, h, w, c, wc, esize)[0]
                for key, t in (("strip", t_k), ("simple", t_s),
                               ("bound", bound)):
                    sums[name, dt, key] = sums.get((name, dt, key), 0.0) + \
                        calls * t
            t_p = time_cuda(lambda: ska_bwd_plain(xd, wd, gd))
            out["plain", dt] = t_p
        for name in ("ska_bwd_x", "ska_bwd_w"):
            (e16, t16, s16, d16), (e32, t32, s32, d32) = (
                out[name, torch.bfloat16], out[name, torch.float32])
            bound = bound_ska_bwd(b, h, w, c, wc, 2)
            bound32 = bound_ska_bwd(b, h, w, c, wc, 4)
            print(f"{tag}{name} {where}: strip path, the bits of "
                  f"ska_bwd_plain and of the simple kernel, two runs equal; "
                  f"bf16 rel err {e16:.3e}, kernel {t16:.4f} ms "
                  f"({bound[0] / t16:.1%} of the bound), simple kernel "
                  f"{s16:.4f} ms ({bound[0] / s16:.1%}), timer spread "
                  f"{d16:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); fp32 "
                  f"rel err {e32:.3e}, kernel {t32:.4f} ms "
                  f"({bound32[0] / t32:.1%}), simple kernel {s32:.4f} ms "
                  f"({bound32[0] / s32:.1%}), timer spread {d32:.4f} ms, "
                  f"bound {bound32[0]:.4f} ms; ska_bwd_plain (both "
                  f"gradients) bf16 {out['plain', torch.bfloat16]:.4f} ms, "
                  f"fp32 {out['plain', torch.float32]:.4f} ms", flush=True)
            _record(report, name, [b, h, w, c, wc], calls, t16,
                    out["plain", torch.bfloat16], 0.0, bound, fp32_ms=t32,
                    fp32_plain_ms=out["plain", torch.float32],
                    fp32_bound_ms=bound32[0], fp32_max_rel_err=e32,
                    route="strip", simple_ms=s16, fp32_simple_ms=s32,
                    spread_ms=d16, fp32_spread_ms=d32,
                    plain_is="ska_bwd_plain, both gradients in one call")
    n_calls = sum(lv[-1] for lv in shapes)
    for name in ("ska_bwd_x", "ska_bwd_w"):
        for dt, label in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            strip, simple, bound = (sums[name, dt, key] for key in
                                    ("strip", "simple", "bound"))
            print(f"{tag}{name} per backward ({n_calls} calls), {label}: "
                  f"strip {strip:.4f} ms ({bound / strip:.1%} of the bound), "
                  f"simple {simple:.4f} ms ({bound / simple:.1%}), bound "
                  f"{bound:.4f} ms", flush=True)
    return report


def ska_bwd_paths():
    """The training and attack paths' SKA backward shapes: (path, shapes,
    batch, dtype) of phases 2c backward, 2c robust, 2c cls_train and 2c
    distill."""
    return [("lsnet_b", SKA_SHAPES, LSNET_BATCH, "bf16"),
            ("robust", SKA_SHAPES, ADV_IMAGES, "fp32"),
            ("cls_train", LSNET_T_SKA_SHAPES, CLS_BATCH, "bf16"),
            ("distill", SKA_SHAPES, DISTILL_BATCH, "bf16")]


def phase_ska_bwd_sweep(rows, ring=None, split=None):
    """``--ska-bwd``: SKA's two backward kernels alone at the four paths'
    shapes (:func:`ska_bwd_paths`): the bits of ``ska_bwd_plain`` and two
    equal runs, and the times, of the simple kernels and of the strip
    kernels at the tables' rows a strip or at each of ``rows`` that fits,
    with ``ring`` strip slots and a unit ``split`` over threads (gx's
    channel repeats, gw's 8 channels) as given (None: the tables'); the
    sums per backward of each
    path: the sweep behind ``kernels/ska.py`` ``_BWD_*``."""
    import torch

    from image_restoration_tpu_torch.kernels import ska as K
    from image_restoration_tpu_torch.kernels.build import load_library
    from image_restoration_tpu_torch.ops.ska import ska_bwd_plain

    lib = load_library().lib
    sums = {}
    for path, shapes, b, dname in ska_bwd_paths():
        dt = torch.float32 if dname == "fp32" else torch.bfloat16
        esize = 4 if dname == "fp32" else 2
        for i, (h, w, c, wc, calls) in enumerate(shapes):
            gen = torch.Generator(device="cuda").manual_seed(2000 + i)
            x, wt, go = (torch.randn(s, generator=gen, device="cuda").to(dt)
                         for s in ((b, h, w, c), (b, h, w, wc, 9),
                                   (b, h, w, c)))
            plain = ska_bwd_plain(x, wt, go)
            shape = f"{path} {b}x{h}x{w}x{c} wc {wc} {dname}"
            bound = bound_ska_bwd(b, h, w, c, wc, esize)[0]
            for k, (g, fn) in enumerate((("x", K.ska_bwd_x),
                                         ("w", K.ska_bwd_w))):
                configs = [("simple", {"th": 0})] + [
                    (f"th {th or 'own'}", {"th": th, "ring": ring,
                                           "split": split})
                    for th in rows or [None]]
                for label, cfg in configs:
                    with _bwd_tables(c, esize, **cfg):
                        if label != "simple":
                            have = K._config(c, esize, g)
                            if not lib.ir_ska_bwd_blocks(
                                    w, c, wc, int(esize == 4), *have,
                                    int(g == "w")):
                                print(f"ska_bwd_{g} {shape} {label}: does "
                                      f"not fit", flush=True)
                                continue
                            label += f" (rows, ring, split {have})"
                        got = fn(x, wt, go)
                        torch.cuda.synchronize()
                        check(torch.equal(got, plain[k]), f"ska_bwd_{g} "
                              f"{shape} {label}: not the bits of "
                              f"ska_bwd_plain")
                        check(torch.equal(got, fn(x, wt, go)),
                              f"ska_bwd_{g} {shape} {label}: two runs differ")
                        route = K.bwd_route(x, wt, go, g)
                        t = time_cuda(lambda: fn(x, wt, go))
                    print(f"ska_bwd_{g} {shape} {label}: {route} path, "
                          f"{t:.4f} ms, bound {bound:.4f} ms "
                          f"({bound / t:.1%})", flush=True)
                    key = (path, g, label.split(" (")[0])
                    sums[key] = sums.get(key, []) + [calls * t]
    n_shapes = {path: len(shapes) for path, shapes, _, _ in ska_bwd_paths()}
    for (path, g, label), parts in sums.items():
        if len(parts) == n_shapes[path]:
            print(f"ska_bwd_{g} {path} {label}: {sum(parts):.4f} ms per "
                  f"backward", flush=True)


def _check_vjp(tag, api, reference, inputs, counters, fwd_expected):
    """A kernel API's VJP on the card: its forward launches
    ``fwd_expected`` of ``counters``, its output holds phase 2's rule
    against the plain composition (``reference``; the oracle is
    ``reference`` on the inputs widened to fp32), its backward launches
    none, and its gradients of every input are the plain recompute's
    (``reference``, what its backward differentiates) within 4e-3 of
    their largest magnitude (the
    largest difference is printed: with cuDNN's deterministic algorithms
    the two are one computation). Forward + backward timed against the
    plain composition's."""
    import torch

    def leaves():
        return [None if t is None else t.detach().clone().requires_grad_()
                for t in inputs]

    got_leaves = leaves()
    before = {k: f.launches for k, f in counters.items()}
    # cuDNN's deterministic algorithms, so that the two differentiations of
    # one composition sum in one order
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = api(*got_leaves)
    fwd = {k: f.launches - before[k] for k, f in counters.items()}
    with torch.no_grad():
        fwd_msg = _check_rule(
            f"{tag} forward", "the plain composition's inputs", out.detach(),
            reference(*inputs),
            reference(*(None if t is None else t.float() for t in inputs)))
    gen = torch.Generator(device="cuda").manual_seed(2100)
    g = torch.randn(out.shape, generator=gen, device="cuda")
    wanted = [t for t in got_leaves if t is not None]
    got = torch.autograd.grad((out.float() * g).sum(), wanted)
    torch.cuda.synchronize()
    bwd = {k: f.launches - before[k] - fwd[k] for k, f in counters.items()}
    ref_leaves = leaves()
    ref_wanted = [t for t in ref_leaves if t is not None]
    want = torch.autograd.grad((reference(*ref_leaves).float() * g).sum(),
                               ref_wanted)
    torch.backends.cudnn.deterministic = deterministic
    worst = max(rel_err(a, b) for a, b in zip(got, want))
    check(fwd == fwd_expected and not any(bwd.values()),
          f"{tag}: launches forward {fwd}, backward {bwd}")
    check(all(t.isfinite().all().item() for t in got) and worst < 4e-3,
          f"{tag}: gradients off the plain recompute's by {worst:.3e}")

    def step(fn, ls, ws):
        return lambda: torch.autograd.grad((fn(*ls).float() * g).sum(), ws)

    t_k = time_cuda(step(api, got_leaves, wanted), reps=10)
    t_p = time_cuda(step(reference, ref_leaves, ref_wanted), reps=10)
    print(f"{tag}: forward rel err {fwd_msg}; largest relative difference "
          f"of {len(got)} gradients from the plain recompute's "
          f"{worst:.3e}; launches forward {fwd}, "
          f"backward {bwd}; forward + backward {t_k:.4f} ms (plain "
          f"{t_p:.4f} ms)", flush=True)


def phase_vjps():
    """The kernel APIs' VJPs (phase 2h): the three-kernel block's
    ``ln_qkv_dwconv``, ``fused_mdta_core`` and ``fused_ln_gdfn`` at
    Restormer-base's training latent (batch 8 at 16x16 x 384, 8 heads),
    ``fused_drs_block`` at DRSformer's (the same shape), and
    ``fused_mefc_steps`` at the Subnet's training shape (batch 8 at
    128x128 x 48, four steps), by ``_check_vjp``."""
    import torch

    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KQ
    from image_restoration_tpu_torch.kernels import mefc as KM

    counters = {"block_front": KB.block_front,
                "block_apply_gdfn": KB.block_apply_gdfn,
                "ln_qkv_dwconv": KQ.ln_qkv_dwconv, "attn_acc": KA.attn_acc,
                "attn_apply": KA.attn_apply, "ln_gdfn": KG.fused_ln_gdfn,
                "drs_apply_msfn": KD.drs_apply_msfn,
                "mefc_step": KM.mefc_step}
    none = dict.fromkeys(counters, 0)
    h, w, c, heads = BACKWARD_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(2200)
    x = torch.randn((TRAIN_BATCH, h, w, c), generator=gen,
                    device="cuda").to(torch.bfloat16)
    p = random_block(c, heads, 2300)
    shape = f"{TRAIN_BATCH}x{h}x{w}x{c} heads {heads}"
    _check_vjp(f"ln_qkv_dwconv VJP {shape}",
               lambda x, *q: KQ.ln_qkv_dwconv(x, KB.FrontParams(*q)),
               lambda x, *q: KB.reference_front(x, KB.FrontParams(*q)),
               (x, *p.front()), counters, dict(none, ln_qkv_dwconv=1))
    qkv = KQ.ln_qkv_dwconv(x, p.front())
    _check_vjp(f"fused_mdta_core VJP {shape}",
               lambda *t: KA.fused_mdta_core(*t, heads),
               lambda *t: KB.reference_core(*t, heads),
               (qkv, x, p.temperature, p.proj_w, p.proj_b), counters,
               dict(none, attn_acc=1, attn_apply=1))
    _check_vjp(f"fused_ln_gdfn VJP {shape}",
               lambda x, *q: KG.fused_ln_gdfn(x, KB.GDFNParams(*q)),
               lambda x, *q: KB.reference_ln_gdfn(x, KB.GDFNParams(*q)),
               (x, *p.gdfn()), counters, dict(none, ln_gdfn=1))
    pd = random_drs_block(c, heads, 2400)
    _check_vjp(f"fused_drs_block VJP {shape}",
               lambda x, *q: KD.fused_drs_block(x, KD.DRSBlockParams(*q),
                                                heads),
               lambda x, *q: KD.reference_drs_block(
                   x, KD.DRSBlockParams(*q), heads),
               (x, *pd), counters, dict(none, block_front=1,
                                        drs_apply_msfn=1))
    hm, wm, cm, n_steps = TRAIN_PATCH, TRAIN_PATCH, MEFC_STEPS[0][2], \
        MEFC_STEPS[0][3]
    steps, _ = random_mefc_steps(cm, n_steps, seed=2500)
    mix = torch.softmax(torch.randn((TRAIN_BATCH, n_steps, 8),
                                    generator=gen, device="cuda"), -1)
    xm = torch.randn((TRAIN_BATCH, hm, wm, cm), generator=gen,
                     device="cuda").abs().to(torch.bfloat16)
    _check_vjp(f"fused_mefc_steps VJP {TRAIN_BATCH}x{hm}x{wm}x{cm}, "
               f"{n_steps} steps",
               lambda x, wt, *f: KM.fused_mefc_steps(x, KM._unflat(f), wt),
               lambda x, wt, *f: KM.reference_steps(x, KM._unflat(f), wt),
               (xm, mix.to(torch.bfloat16), *KM._flat(steps)), counters,
               dict(none, mefc_step=n_steps))


def _train_drsformer(gpu, data, bench, tmp):
    """Phase 4's DRSformer run: ``cli/train.py`` ``main`` at its port
    defaults in bf16 (``fused_block``: K1 + K7 in every block, K8 in every
    MEFC step), batch 8 of 128x128 on the same synthetic tree, validation
    and saves every ``DRS_TRAIN_EVERY`` steps: the launches of every
    forward (the steps' and the validation's), none in a backward; the
    loss on a fixed batch falls; ``cli/test.py --ckpt`` scores the final
    checkpoint with a finite PSNR. Returns the launch counts of the
    run."""
    import json
    import os

    import torch

    from image_restoration_tpu_torch.cli import test as T
    from image_restoration_tpu_torch.cli import train as TR
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import mefc as KM
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, parse_options,
    )

    argv = ["--model", "drsformer", "--device", "cuda",
            "--data_file_dir", data, "--batch_size", str(TRAIN_BATCH),
            "--patch_size", str(TRAIN_PATCH), "--warmup_epochs", "0",
            "--ema_decay", "0.999", "--lr", str(TRAIN_LR),
            "--save_every", str(DRS_TRAIN_EVERY), "--val_every",
            str(DRS_TRAIN_EVERY), "--val_lq_dir", f"{data}/val/lq",
            "--val_gt_dir", f"{data}/val/gt", "--log_every", "1",
            "--ckpt_dir", os.path.join(tmp, "exp"), "--name", "drs"]
    cfg = parse_options(argv, build_train_parser())
    check(cfg["bf16"] and cfg["model_kwargs"].get("fused_block"),
          "phase 4: not DRSformer's bf16 fused_block defaults")
    counters = {"block_front": KB.block_front,
                "block_apply_gdfn": KB.block_apply_gdfn,
                "drs_apply_msfn": KD.drs_apply_msfn,
                "mefc_step": KM.mefc_step}
    per_forward = {"block_front": DRS_BLOCKS_PER_FORWARD,
                   "block_apply_gdfn": 0,
                   "drs_apply_msfn": DRS_BLOCKS_PER_FORWARD,
                   "mefc_step": MEFC_STEPS_PER_FORWARD}
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    TR.main(argv, max_steps_override=DRS_TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {k: f.launches for k, f in counters.items()}
    n_val = DRS_TRAIN_STEPS // DRS_TRAIN_EVERY * VAL_IMAGES
    n_fwd = DRS_TRAIN_STEPS + n_val
    print(f"train drsformer: {DRS_TRAIN_STEPS} steps + {n_val} validation "
          f"forwards in {wall:.1f} s (host clock), launches {launches}",
          flush=True)
    check(launches == {k: n_fwd * n for k, n in per_forward.items()},
          f"train drsformer: {launches} for {n_fwd} forwards, expected "
          f"{per_forward} each")
    exp = os.path.join(tmp, "exp", "drs")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [e["train/total"] for e in logged if "train/total" in e]
    vals = [e["val/psnr"] for e in logged if "val/psnr" in e]
    print(f"train drsformer losses (lr {TRAIN_LR}): first {losses[0]:.5f}, "
          f"mean of the last five {np.mean(losses[-5:]):.5f}; all "
          f"{[round(v, 5) for v in losses]}; validation PSNR {vals}",
          flush=True)
    check(len(losses) == DRS_TRAIN_STEPS and np.isfinite(losses).all()
          and np.isfinite(vals).all(), "train drsformer: a loss or PSNR is "
          "not finite, or missing")
    # the logged losses are of the steps' batches, whose tasks differ: the
    # fall is measured on one fixed batch, by the initial model (the seeded
    # init main started from) and by the final checkpoint's parameters
    final = os.path.join(exp, "ckpt", f"{DRS_TRAIN_STEPS}.pth")
    model = TR.build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2900)
    gt = torch.rand((2, 3, TRAIN_PATCH, TRAIN_PATCH), generator=gen,
                    device="cuda")
    lq = (gt + 0.1 * torch.randn(gt.shape, generator=gen,
                                 device="cuda")).clamp(0, 1)
    fixed = []
    for params in (None, torch.load(final, map_location="cuda")["params"]):
        if params is not None:
            model.load_state_dict(params)
        with torch.inference_mode():
            fixed.append((model(lq) - gt).abs().mean().item())
    del model
    print(f"train drsformer: L1 on a fixed batch of 2 at {TRAIN_PATCH}^2: "
          f"initial model {fixed[0]:.5f}, after {DRS_TRAIN_STEPS} steps "
          f"{fixed[1]:.5f}", flush=True)
    check(np.isfinite(fixed).all() and fixed[1] < fixed[0],
          "train drsformer: the loss did not fall")
    results = T.main(["--model", "drsformer", "--device", "cuda",
                      "--ckpt", final, "--benchmarks", "derain",
                      "--data_file_dir", bench,
                      "--output_dir", os.path.join(tmp, "rd")])
    print(f"train drsformer: cli/test.py --ckpt "
          f"{os.path.basename(final)}: {results}", flush=True)
    check(np.isfinite(results["derain"]["psnr"]),
          f"train drsformer: scoring the checkpoint gave {results}")
    _train_step_times(gpu, cfg, None, counters, per_forward,
                      "DRSformer", warmup=2, reps=5)
    return launches


def _train_three_kernel(gpu):
    """Phase 4's three-kernel Restormer step: Restormer-base with
    ``fused_attn`` and ``fused_gdfn`` (K4, K5 + K6, K3) takes training
    steps on a batch of 8 at 128x128: 44 launches of each a step's
    forward, none in its backward (and no K1 or K2); step ms and peak
    memory against the plain bf16 model. Returns the launches of one
    step."""
    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KQ
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, parse_options,
    )

    cfg = parse_options(["--model", "restormer", "--device", "cuda"]
                        + [a for kv in THREE_KERNEL for a in ("--set", kv)],
                        build_train_parser())
    counters = {"ln_qkv_dwconv": KQ.ln_qkv_dwconv, "attn_acc": KA.attn_acc,
                "attn_apply": KA.attn_apply, "ln_gdfn": KG.fused_ln_gdfn,
                "block_front": KB.block_front,
                "block_apply_gdfn": KB.block_apply_gdfn}
    per_forward = dict.fromkeys(counters, BLOCKS_PER_FORWARD)
    per_forward.update(block_front=0, block_apply_gdfn=0)
    return _train_step_times(gpu, cfg, None, counters, per_forward,
                             "Restormer-base three-kernel", warmup=2, reps=5)


def _class_tree(root, model, n, size, seed):
    """``n`` seeded images of ``size``^2 in an ImageFolder tree of 1000
    class dirs, each image under the class ``model`` predicts for it as
    ``cli/robust.py`` loads it (so the clean accuracy is 100%); returns
    the tree's path."""
    import os

    import torch
    from PIL import Image

    from image_restoration_tpu_torch.eval.robustness import _load_batch

    rng = np.random.default_rng(seed)
    imgs = [_smooth_image(rng, size, size) for _ in range(n)]
    os.makedirs(os.path.join(root, "flat"))
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(root, "flat", f"{i:03d}.png"))
        Image.fromarray(img).save(paths[-1])
    x = torch.from_numpy(_load_batch(paths, size)).cuda()
    with torch.inference_mode():
        pred = model(x.permute(0, 3, 1, 2)).argmax(-1).tolist()
    tree = os.path.join(root, "tree")
    for c in range(1000):
        os.makedirs(os.path.join(tree, f"c{c:03d}"))
    for i, (p, c) in enumerate(zip(paths, pred)):
        os.replace(p, os.path.join(tree, f"c{c:03d}", f"{i:03d}.png"))
    return tree


def phase_lsnet_grad(gpu):
    """Phase 5, LSNet differentiates through SKA's backward kernels:
    ``cli/robust.py`` with and without ``--adv FGSM`` and ``--adv PGD`` at
    LSNet-B (fp32, the CLI's default; seeded weights and BatchNorm
    statistics calibrated on other images of the same kind, passed as a
    ``.pth`` ``--ckpt``) on a seeded ImageFolder tree whose images sit
    under the classes the model predicts for them: clean accuracy 100% (at
    least 90%: a near-tie may flip between two batch orders), accuracy
    under either attack lower; one attacked batch moves some pixel by the
    whole step, stays in the eps-ball and the normalized image of [0, 1],
    and each of its backwards launches 9 ``ska_bwd_x`` + 9 ``ska_bwd_w``.
    Then five ``make_cls_train_step`` steps of LSNet-T (bf16, AdamW;
    BatchNorm statistics calibrated on the batch) on a seeded batch: a
    finite loss that starts within 1.5 of ln(1000), as unit-scale logits
    give, and falls at every step, its 2 SKAs a step launched once each
    forward and differentiated by the two kernels. Returns the launch
    counts by path."""
    import os
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli import robust as CR
    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.eval import robustness as R
    from image_restoration_tpu_torch.kernels import ska as KS
    from image_restoration_tpu_torch.models.lsnet import LSConv
    from image_restoration_tpu_torch.train import classification as TC
    from image_restoration_tpu_torch.train import trainer as TT
    from image_restoration_tpu_torch.utils.options import parse_options

    counters = {"ska": KS.ska, "ska_bwd_x": KS.ska_bwd_x,
                "ska_bwd_w": KS.ska_bwd_w}

    def zero():
        for f in counters.values():
            f.launches = 0

    def read():
        torch.cuda.synchronize()
        return {k: f.launches for k, f in counters.items()}

    by_path = {}
    argv = ["--device", "cuda", "--seed", "0", *LSNET_B]
    cfg = parse_options(argv, CR.build_argparser())
    check(not cfg["bf16"] and cfg["model_kwargs"]["use_pallas_ska"],
          "cli/robust.py defaults are not fp32 with the SKA kernel")
    model = build_model(cfg)
    n, size = ADV_IMAGES, 224
    std = torch.from_numpy(R.IMAGENET_STD).cuda()
    mean = torch.from_numpy(R.IMAGENET_MEAN).cuda()
    rng = np.random.default_rng(2650)
    calib = torch.from_numpy(np.stack([_smooth_image(rng, size, size)
                                       for _ in range(n)])).cuda()
    perturb_lsnet(model, seed=2600,
                  x=((calib / 255.0 - mean) / std).permute(0, 3, 1, 2))
    with tempfile.TemporaryDirectory(prefix="ir_adv_") as tmp:
        ckpt = os.path.join(tmp, "lsnet_b.pth")
        torch.save(model.state_dict(), ckpt)
        tree = _class_tree(tmp, model, n, size, seed=2700)
        # one attacked batch: the ball, the box, the backward's launches
        x = torch.from_numpy(R._load_batch(
            sorted(os.path.join(d, f) for d, _, fs in os.walk(tree)
                   for f in fs), size)).cuda()
        with torch.no_grad():
            logits = model(x.permute(0, 3, 1, 2))
        labels = logits.argmax(-1)
        print(f"lsnet-b logits on the tree's images: |max| "
              f"{logits.abs().max().item():.4f}, std "
              f"{logits.std().item():.4f}", flush=True)
        for adv, iters, alpha in (("FGSM", 1, 1.0), ("PGD", 5, 0.5)):
            zero()
            xa = R.fgsm_pgd_attack(model, x, labels, max_iters=iters,
                                   alpha=alpha / 255.0,
                                   random_init=adv == "PGD")
            got = read()
            ball = (xa - x).abs() / (1.0 / 255.0 / std)
            inside = ((xa >= (0 - mean) / std - 1e-6)
                      & (xa <= (1 - mean) / std + 1e-6)).all().item()
            print(f"lsnet {adv} on {n} images at {size}^2: launches {got}; "
                  f"largest |step| {ball.max().item():.6f} of the ball; in "
                  f"the normalized box: {inside}", flush=True)
            check(1 - 1e-3 <= ball.max().item() <= 1 + 1e-5 and inside,
                  f"lsnet {adv}: no pixel took the whole step, or an "
                  f"iterate left the eps-ball or the box")
            check(got == {"ska": iters * SKA_PER_FORWARD,
                          "ska_bwd_x": iters * SKA_PER_FORWARD,
                          "ska_bwd_w": iters * SKA_PER_FORWARD},
                  f"lsnet {adv}: launches {got}, expected {SKA_PER_FORWARD} "
                  f"of each a forward and backward")
        acc = {}
        for adv in (None, "FGSM", "PGD"):
            zero()
            t0 = time.perf_counter()
            res = CR.main(argv + ["--ckpt", ckpt, "--insk_path", tree,
                                  "--batch_size", str(n)]
                          + (["--adv", adv] if adv else []))
            by_path[f"robust_{adv or 'clean'}".lower()] = got = read()
            acc[adv] = res["imagenet_sketch"]["acc1"]
            print(f"lsnet cli/robust.py {'--adv ' + adv if adv else 'clean'}"
                  f": top-1 {acc[adv]:.2f}% of {res['imagenet_sketch']['n']}"
                  f", launches {got}, {time.perf_counter() - t0:.1f} s",
                  flush=True)
        check(acc[None] >= 90.0 and acc["FGSM"] < acc[None]
              and acc["PGD"] < acc[None], f"lsnet accuracies {acc}: clean "
              f"under 90% (the tree holds each image under its prediction), "
              f"or an attack did not lower the accuracy")
    del model

    # LSNet-T takes five classification steps on one seeded batch
    tcfg = parse_options(["--model", "lsnet", "--device", "cuda", "--seed",
                          "0"])
    net = build_model(tcfg)
    check(net.dtype == torch.bfloat16, "LSNet-T for training is not bf16")
    gen = torch.Generator(device="cuda").manual_seed(2800)
    images = torch.randn((CLS_BATCH, 3, 224, 224), generator=gen,
                         device="cuda")
    labels = torch.randint(0, 1000, (CLS_BATCH,), generator=gen,
                           device="cuda")
    calibrate_batchnorm(net, images)
    tx = TT.Optimizer(TT.TrainerConfig(learning_rate=CLS_LR,
                                       weight_decay=0.05))
    state = TT.TrainState.create(net, tx, ema_decay=0.999)
    step = TC.make_cls_train_step(net, tx, smoothing=0.1, ema_decay=0.999)
    losses = []
    zero()
    for _ in range(CLS_STEPS):
        state, logs = step(state, {"image": images, "label": labels})
        losses.append(float(logs["loss"]))
    got = read()
    by_path["cls_train"] = got
    print(f"lsnet-t make_cls_train_step: {CLS_STEPS} steps at batch "
          f"{CLS_BATCH}, losses {[round(v, 5) for v in losses]}, launches "
          f"{got}", flush=True)
    check(np.isfinite(losses).all() and abs(losses[0] - np.log(1000)) <= 1.5
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"lsnet-t classification losses {losses}: not finite, not "
          f"starting near ln(1000) = {np.log(1000):.4f}, or not falling at "
          f"every step")
    n_ska = sum(isinstance(m, LSConv) for m in net.modules())
    check(n_ska == LSNET_T_SKA_PER_FORWARD, f"lsnet-t has {n_ska} LSConvs, "
          f"not {LSNET_T_SKA_PER_FORWARD}")
    check(got == dict.fromkeys(counters, CLS_STEPS * LSNET_T_SKA_PER_FORWARD),
          f"lsnet-t: launches {got} in {CLS_STEPS} steps, expected "
          f"{LSNET_T_SKA_PER_FORWARD} of K9 a forward and of each backward "
          f"kernel a backward")
    return by_path


LEARN_STEPS = 2000  # tools/learn_run.py's default
LEARN_MOCE_STEPS = 2500  # the run behind LEARN_moce_ir_r05.json


def _load_tool(name, folder="tools"):
    """``<folder>/<name>.py`` as a module (the learning tools import jax
    only in their ``main``; ``tests/seeding.py`` imports torch only)."""
    import importlib.util
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, folder))
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, folder, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
    return mod


def _learn(gpu, label, model_args, steps):
    """One overfit run of ``tools/learn_run.py``'s synthetic rain set (its
    ``write_dataset``: four 128x128 pairs, seed 7) through the port's
    ``cli/train.py`` ``main`` with the learning tools' common argv (batch
    4 of 64x64 patches, warm-up-free cosine, EMA 0.99, clip 1.0,
    validation on the training pairs every ``steps`` / 20) after
    ``model_args``, in bf16 on the card. Prints the loss and validation
    PSNR curves (and the balance loss's, when logged), the best validation
    PSNR and its step, the input's PSNR, the K1/K2 launches and the wall
    time as one JSON line."""
    import json
    import os
    import tempfile

    import torch
    from PIL import Image

    from image_restoration_tpu_torch.cli import train as TR
    from image_restoration_tpu_torch.kernels import block as KB

    learn_run = _load_tool("learn_run")
    with tempfile.TemporaryDirectory(prefix="ir_learn_") as work:
        lq_dir, gt_dir = learn_run.write_dataset(os.path.join(work, "data"))
        exp_dir = os.path.join(work, "exp")
        argv = list(model_args) + [
            "--trainset", "paired", "--lq_dir", lq_dir, "--gt_dir", gt_dir,
            "--patch_size", "64", "--batch_size", "4", "--epochs", "1",
            "--scheduler", "linear_warmup_cosine",
            "--warmup_epochs", "0", "--max_steps", str(steps),
            "--ema_decay", "0.99", "--grad_clip", "1.0",
            "--val_every", str(max(steps // 20, 1)),
            "--val_lq_dir", lq_dir, "--val_gt_dir", gt_dir,
            "--ckpt_dir", exp_dir, "--name", "overfit",
            "--save_every", "100000", "--log_every", "25",
            "--device", "cuda",
        ]
        KB.block_front.launches = KB.block_apply_gdfn.launches = 0
        t0 = time.perf_counter()
        TR.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"block_front": KB.block_front.launches,
                    "block_apply_gdfn": KB.block_apply_gdfn.launches}
        with open(os.path.join(exp_dir, "overfit", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        with open(os.path.join(exp_dir, "overfit", "ckpt", "best")) as f:
            best_step, best_psnr = f.read().split()
        psnr0 = []
        for i in range(4):
            a, b = (np.asarray(Image.open(os.path.join(d, f"{i}.png")),
                               np.float64) / 255 for d in (lq_dir, gt_dir))
            psnr0.append(-10 * np.log10(np.mean((a - b) ** 2)))

    def curve(key, digits):
        return [(e["step"], round(e[key], digits)) for e in logged
                if key in e]

    out = {"learn": label, "device": gpu, "steps": steps,
           "input_psnr": round(float(np.mean(psnr0)), 3),
           "best_val_psnr": round(float(best_psnr), 3),
           "best_step": int(best_step), "wall_s": round(wall, 1),
           "launches": launches, "psnr_curve": curve("val/psnr", 3),
           "loss_curve": curve("train/total", 5)[::4]}
    if any("train/aux" in e for e in logged):
        out["aux_curve"] = curve("train/aux", 5)[::4]
    print(json.dumps(out), flush=True)
    check(np.isfinite(float(best_psnr)), "learn: no finite validation PSNR")


def phase_learn(gpu, dim):
    """``--learn DIM``: the overfit run behind ``LEARN_r03.json``:
    ``tools/learn_run.py``'s argv (a Restormer with blocks 2/2/2/2, 2
    refinement blocks, heads 1/2/4/8 at ``model_kwargs.dim`` DIM; lr 1e-3,
    2000 steps) through :func:`_learn`."""
    _learn(gpu, f"restormer dim={dim} blocks=(2,2,2,2)", [
        "--model", "restormer", "--lr", "1e-3",
        "--set", f"model_kwargs.dim={dim}",
        "--set", "model_kwargs.num_blocks=(2,2,2,2)",
        "--set", "model_kwargs.num_refinement_blocks=2",
        "--set", "model_kwargs.heads=(1,2,4,8)"], LEARN_STEPS)


def phase_learn_moce(gpu):
    """``--learn-moce``: the overfit run behind ``LEARN_moce_ir_r05.json``:
    ``tools/learn_run2.py``'s ``moce_ir`` argv (MoCE-IR at its serving
    defaults with dim 24, 4 experts, top-2, aux weight 0.01, lr 1e-3;
    noisy routing, the balance loss and EMA on), 2500 steps, through
    :func:`_learn`. Its EncoderBlocks run K1/K2 with their 24-wide heads
    padded to 32."""
    args = _load_tool("learn_run2").MODEL_ARGS["moce_ir"]
    _learn(gpu, "moce_ir " + " ".join(args[2:]), args, LEARN_MOCE_STEPS)


def phase_serve_widths(gpu, profile_dir=None):
    """Phase 3w: the dim-24 models serve 512x512 through ``make_restore_fn``
    with their kernels in the padded layouts (``phase_slice``): Restormer
    at tools/learn_run.py's configuration (16 K1 + 16 K2 a forward),
    DRSformer at dim 24 (40 K1 + 40 K7 + 8 K8) and MoCE-IR at
    tools/learn_run2.py's moce_ir argv (28 K1 + 28 K2). ``build_model``
    prints no "off" line (it prints one for each flag it turns off); the
    kernel bf16 model's error against the plain fp32 model stays within 3x
    the plain bf16 model's; the forward's device ms of the kernel model
    against the plain bf16 model's, and both on the host clock. Returns
    the launch counts by path."""
    import torch

    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import mefc as KM

    def forward_ms(tag, model, plain16, plain32, x):
        """The plain bf16 model's forward timed as ``phase_slice`` times
        the kernel model's, and both forwards on the host clock (a
        forward the host cannot enqueue ahead of the card takes its host
        time)."""
        host = {}
        with torch.inference_mode():
            t_p = time_cuda(lambda: plain16(x), reps=10, head_start_ms=150.0)
            for name, m in (("kernel", model), ("plain", plain16)):
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m(x)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                host[name] = statistics.median(times)
        print(f"{tag} forward 512x512 on {gpu}: plain bf16 {t_p:.3f} ms "
              f"(device, CUDA events, as the kernel model's below); host "
              f"clock, median of 3: kernel bf16 {host['kernel']:.3f} ms, "
              f"plain bf16 {host['plain']:.3f} ms", flush=True)

    routes = inspect_routes(strict=False)

    def moce_inspect(*args):
        routes(*args)
        forward_ms(*args)

    moce = _load_tool("learn_run2").MODEL_ARGS["moce_ir"]
    moce_sets = tuple(v for k, v in zip(moce, moce[1:])
                      if k == "--set" and v.startswith("model_kwargs."))
    pair = {"block_front": KB.block_front,
            "block_apply_gdfn": KB.block_apply_gdfn}
    runs = {
        "restormer_dim24": ("restormer", LEARN_RUN_RESTORMER, pair,
                            DIM24_BLOCKS_PER_FORWARD, {}),
        "drsformer_dim24": (
            "drsformer", ("model_kwargs.dim=24",),
            {"block_front": KB.block_front,
             "drs_apply_msfn": KD.drs_apply_msfn,
             "mefc_step": KM.mefc_step}, DRS_BLOCKS_PER_FORWARD,
            {"mefc_step": MEFC_STEPS_PER_FORWARD}),
        "moce_ir_dim24": ("moce_ir", moce_sets, pair,
                          MOCE_BLOCKS_PER_FORWARD, {}),
    }
    by_path = {}
    for tag, (name, sets, counters, blocks, other) in runs.items():
        expected = {k: other.get(k, blocks) for k in counters}
        said = io.StringIO()
        try:
            with contextlib.redirect_stdout(said):
                by_path[tag] = phase_slice(
                    gpu, profile_dir, name, counters, expected,
                    overrides=sets, tag=tag,
                    inspect=moce_inspect if name == "moce_ir" else forward_ms,
                    perturb=(lambda m: perturb_biases(m, seed=3200))
                    if name == "moce_ir" else None)
        finally:
            print(said.getvalue(), end="", flush=True)
        off = [line for line in said.getvalue().splitlines()
               if line.startswith("build_model:") and " off: " in line]
        check(not off, f"{tag}: build_model turned a kernel flag off: {off}")
    return by_path


def phase_serve_slices(gpu, profile_dir=None):
    """Phases 3-3i but 3f: the kernel models' serving slices (Restormer-base
    with the pair and with the three-kernel block, DRSformer, LSNet-B,
    AdaIR, CG-IR, MEASNet, NeRD-Rain, MoCE-IR) and the MoCE family's
    kernel-free models (``phase_slice``, ``phase_lsnet``). Returns the
    launch counts by path."""
    from image_restoration_tpu_torch.kernels import attn_core as KA
    from image_restoration_tpu_torch.kernels import block as KB
    from image_restoration_tpu_torch.kernels import drs_block as KD
    from image_restoration_tpu_torch.kernels import gdfn as KG
    from image_restoration_tpu_torch.kernels import mdta as KQ
    from image_restoration_tpu_torch.kernels import mefc as KM

    by_path = {
        "restormer": phase_slice(
            gpu, profile_dir, "restormer",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": BLOCKS_PER_FORWARD,
             "block_apply_gdfn": BLOCKS_PER_FORWARD}),
        "drsformer": phase_slice(
            gpu, profile_dir, "drsformer",
            {"block_front": KB.block_front,
             "drs_apply_msfn": KD.drs_apply_msfn,
             "mefc_step": KM.mefc_step},
            {"block_front": DRS_BLOCKS_PER_FORWARD,
             "drs_apply_msfn": DRS_BLOCKS_PER_FORWARD,
             "mefc_step": MEFC_STEPS_PER_FORWARD}),
        "lsnet": phase_lsnet(gpu, profile_dir),
        "restormer_3k": phase_slice(
            gpu, profile_dir, "restormer",
            {"ln_qkv_dwconv": KQ.ln_qkv_dwconv, "attn_acc": KA.attn_acc,
             "attn_apply": KA.attn_apply, "ln_gdfn": KG.fused_ln_gdfn},
            dict.fromkeys(("ln_qkv_dwconv", "attn_acc", "attn_apply",
                           "ln_gdfn"), BLOCKS_PER_FORWARD),
            overrides=THREE_KERNEL, tag="restormer_3k"),
        "adair": phase_slice(
            gpu, profile_dir, "adair",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": BLOCKS_PER_FORWARD,
             "block_apply_gdfn": BLOCKS_PER_FORWARD},
            perturb=lambda m: perturb_adair(m, seed=800)),
        "cg_ir": phase_slice(
            gpu, profile_dir, "cg_ir",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": BLOCKS_PER_FORWARD,
             "block_apply_gdfn": BLOCKS_PER_FORWARD}),
        "measnet": phase_slice(
            gpu, profile_dir, "measnet",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": MEASNET_BLOCKS_PER_FORWARD,
             "block_apply_gdfn": MEASNET_BLOCKS_PER_FORWARD},
            perturb=lambda m: perturb_measnet(m, seed=1200)),
        "nerd_rain": phase_slice(
            gpu, profile_dir, "nerd_rain",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": NERD_BLOCKS_PER_FORWARD,
             "block_apply_gdfn": NERD_BLOCKS_PER_FORWARD}),
        "moce_ir": phase_slice(
            gpu, profile_dir, "moce_ir",
            {"block_front": KB.block_front,
             "block_apply_gdfn": KB.block_apply_gdfn},
            {"block_front": MOCE_BLOCKS_PER_FORWARD,
             "block_apply_gdfn": MOCE_BLOCKS_PER_FORWARD},
            inspect=inspect_routes(strict=True),
            perturb=lambda m: perturb_biases(m, seed=1310)),
    }
    every_kernel = _every_kernel()
    for name in KERNEL_FREE:
        by_path[name] = phase_slice(
            gpu, profile_dir, name, every_kernel,
            dict.fromkeys(every_kernel, 0), kernel_free=True,
            inspect=inspect_routes(strict=False),
            perturb=(lambda m: perturb_igmoce(m, seed=1400))
            if name == "igmoce_ir" else None)
    return by_path


# Phase 6: Restormer-base (MODEL_DEFAULTS, the kernel pair, bf16) trains
# MESH_STEPS steps of batch TRAIN_BATCH x TRAIN_PATCH^2 through
# cli/train.py --mesh 1 under torch.distributed.run (NCCL), against the same
# steps in this process; its step is timed (CUDA events, MESH_REPS after
# MESH_WARMUP) against the one-process step. Phase 6m: two ranks share the
# card over gloo: MoCE-IR (MODEL_DEFAULTS) at batch TRAIN_BATCH x
# TRAIN_PATCH^2 on a (2, 1) data x expert mesh, and Restormer-base's halo
# forward of a HALO_IMAGE image in 2 strips (halo suggest_halo((4, 6, 6,
# 8), 4, align=8) = 312, so strips of 512 + 2 x 312 rows and an interior
# of 1024 - 2 x 312 rows; HALO_SMALL must miss the bound). Phase 6d: LSNet-B
# distils an LSNet-B student (freeze_ratio 0.5) for DISTILL_STEPS steps of
# DISTILL_BATCH x 224^2, both on K9, then exports and reloads it.
MESH_STEPS, MESH_WARMUP, MESH_REPS = 3, 1, 3
HALO_IMAGE, HALO_STRIPS, HALO_SMALL = (1024, 512), 2, 16
DISTILL_STEPS, DISTILL_BATCH, DISTILL_LR = 2, 32, 1e-4


def restormer_levels(h, w):
    """Restormer-base's block shapes (LEVELS) at an h x w input."""
    return [(h * lh // 512, w * lw // 512, c, heads, n)
            for lh, lw, c, heads, n in LEVELS]


def halo_geometry():
    """Phase 6m's halo forward: (halo, rows a strip, padded strip rows)
    of Restormer-base (MODEL_DEFAULTS) on a HALO_IMAGE image."""
    from image_restoration_tpu_torch.parallel.halo import suggest_halo
    from image_restoration_tpu_torch.utils.options import MODEL_DEFAULTS

    rest = MODEL_DEFAULTS["restormer"]
    halo = suggest_halo(tuple(rest["num_blocks"]),
                        rest["num_refinement_blocks"], align=8)
    strip = HALO_IMAGE[0] // HALO_STRIPS
    return halo, strip, strip + 2 * halo


def _release_cached_memory():
    """The earlier phases leave the caching allocator holding most of the
    card; ranks and subprocesses of phases 6 and 6m share it, so this
    process gives its cached blocks back first (without it a 6m rank ran
    out of the card's memory)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"this process holds {torch.cuda.memory_reserved() / 2**30:.3f} "
          f"GiB of the card", flush=True)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_step_times(gpu, cfg):
    """CUDA-event step ms of the sharded step on a one-rank NCCL mesh and
    of the one-process step, in turns (mesh, one, one, mesh), on one batch,
    beside the host-clock ms of each step call and phase 4's step in this
    run; the launches of one mesh step (44 + 44 in its forward)."""
    import torch
    import torch.distributed as dist

    from image_restoration_tpu_torch.cli.train import build_model
    from image_restoration_tpu_torch.core.mesh import make_mesh
    from image_restoration_tpu_torch.kernels import block as K
    from image_restoration_tpu_torch.train.trainer import (
        TrainerConfig, TrainState, make_optimizer, make_train_step,
    )

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        gen = torch.Generator(device="cuda").manual_seed(2400)
        shape = (TRAIN_BATCH, 3, TRAIN_PATCH, TRAIN_PATCH)
        gt = torch.rand(shape, generator=gen, device="cuda")
        batch = {"gt": gt, "lq": (gt + 0.1 * torch.randn(
            shape, generator=gen, device="cuda")).clamp(0, 1)}
        tcfg = TrainerConfig(learning_rate=TRAIN_LR)
        steps = {}
        for tag, m in (("mesh", mesh), ("one", None)):
            model = build_model(cfg).train()
            tx = make_optimizer(tcfg)
            state = TrainState.create(model, tx)
            steps[tag] = (make_train_step(model, tx, tcfg, m), state)
            for _ in range(MESH_WARMUP):
                steps[tag][0](state, batch)
        times = {"mesh": [], "one": []}
        host = {"mesh": [], "one": []}
        for tag in ("mesh", "one", "one", "mesh"):
            step, state = steps[tag]
            for _ in range(MESH_REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                step(state, batch)
                host[tag].append((time.perf_counter() - t0) * 1e3)
                end.record()
                end.synchronize()
                times[tag].append(start.elapsed_time(end))
        step, state = steps["mesh"]
        K.block_front.launches = K.block_apply_gdfn.launches = 0
        step(state, batch)
        torch.cuda.synchronize()
        launches = {"block_front": K.block_front.launches,
                    "block_apply_gdfn": K.block_apply_gdfn.launches}
    finally:
        dist.destroy_process_group()
    ms = {k: statistics.median(v) for k, v in times.items()}
    hms = {k: statistics.median(v) for k, v in host.items()}
    p4 = STEP_MS.get("Restormer-base kernel")
    print(f"mesh train step, Restormer-base bf16 batch {TRAIN_BATCH} x "
          f"{TRAIN_PATCH}^2 on {gpu}: one-rank NCCL mesh {ms['mesh']:.3f} ms, "
          f"one process {ms['one']:.3f} ms (CUDA events, medians of "
          f"{2 * MESH_REPS} in turns mesh/one/one/mesh after {MESH_WARMUP} "
          f"warm-up steps); phase 4's kernel step in this run "
          f"{'not run' if p4 is None else f'{p4:.3f} ms'}; host clock of "
          f"the step call (it reads nothing back, so the call's time near "
          f"the CUDA events' says the host bounds the step) mesh "
          f"{hms['mesh']:.3f}, one {hms['one']:.3f} ms; launches of a mesh "
          f"step {launches}", flush=True)
    check(launches == dict.fromkeys(launches, BLOCKS_PER_FORWARD),
          f"6: a mesh step launched {launches}, expected "
          f"{BLOCKS_PER_FORWARD} each in its forward")
    return launches


def phase_mesh_train(gpu):
    """Phase 6: ``cli/train.py --mesh 1`` under ``python -m
    torch.distributed.run --standalone --nproc_per_node 1`` (NCCL,
    ``IR_TPU_MULTIHOST=1``): Restormer-base at the port defaults (bf16,
    the kernel pair) on phase 4's seeded tree, MESH_STEPS steps; its logged
    losses and final checkpoint against the same steps of ``main`` in this
    process (one loader thread each, so both draw the same crops). Then
    the sharded step's CUDA-event ms against the one-process step's, and
    its launches (``_mesh_step_times``). A failed subprocess fails the
    run. Returns the launches, as ``mesh_train``."""
    import json
    import os
    import subprocess
    import tempfile

    import torch

    from image_restoration_tpu_torch.cli import train as TR
    from image_restoration_tpu_torch.utils.options import (
        build_train_parser, parse_options,
    )

    _release_cached_memory()
    with tempfile.TemporaryDirectory(prefix="ir_mesh_") as tmp:
        data = os.path.join(tmp, "data")
        _train_tree(data)

        def argv(name):
            return ["--model", "restormer", "--device", "cuda",
                    "--data_file_dir", data, "--batch_size", str(TRAIN_BATCH),
                    "--patch_size", str(TRAIN_PATCH), "--warmup_epochs", "0",
                    "--lr", str(TRAIN_LR), "--save_every", "0",
                    "--log_every", "1", "--num_workers", "1",
                    "--max_steps", str(MESH_STEPS), "--ckpt_dir",
                    os.path.join(tmp, "exp"), "--name", name]

        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m",
               "image_restoration_tpu_torch.cli.train", *argv("mesh"),
               "--mesh", "1"]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env={**os.environ, "IR_TPU_MULTIHOST": "1"},
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        tail = "\n".join((run.stdout + run.stderr).splitlines()[-12:])
        print(f"6: torch.distributed.run ... cli.train --mesh 1: exit "
              f"{run.returncode} in {wall:.1f} s (process start, build, "
              f"loading and {MESH_STEPS} steps)\n{tail}", flush=True)
        check(run.returncode == 0, "6: the --mesh 1 run failed")
        check("mesh={'data': 1}" in run.stdout, "6: the run built no mesh")
        cfg = parse_options(argv("one"), build_train_parser())
        one = TR.main(argv("one"))
        torch.cuda.synchronize()

        def losses(name):
            with open(os.path.join(tmp, "exp", name, "metrics.jsonl")) as f:
                return [json.loads(line)["train/total"] for line in f]

        got, want = losses("mesh"), losses("one")
        ckpt = torch.load(os.path.join(tmp, "exp", "mesh", "ckpt",
                                       f"{MESH_STEPS}.pth"),
                          map_location="cuda", weights_only=False)["params"]
        ref = one.model.state_dict()
        init = TR.build_model(cfg).state_dict()
        moved = sum(float(torch.sum((ref[k].float() - init[k].float()) ** 2))
                    for k in ref if ref[k].is_floating_point()) ** 0.5
        diff = sum(float(torch.sum((ckpt[k].float() - ref[k].float()) ** 2))
                   for k in ref if ref[k].is_floating_point()) ** 0.5
        print(f"6: losses mesh {[round(v, 6) for v in got]}, one process "
              f"{[round(v, 6) for v in want]}; final parameters "
              f"||mesh - one|| = {diff:.3e} against ||one - init|| = "
              f"{moved:.3e}", flush=True)
        check(len(got) == len(want) == MESH_STEPS
              and np.allclose(got, want, rtol=1e-3, atol=0),
              "6: the mesh run's losses are not the one-process run's")
        check(diff <= 1e-2 * moved, "6: the mesh run's parameters are not "
              "the one-process run's (1% of the distance they moved)")
    return {"mesh_train": _mesh_step_times(gpu, cfg)}


# The collectives ProcessGroupGloo runs on CUDA tensors, as the H100
# machine's torch 2.11 showed (a send of a CUDA tensor hands the device
# pointer to gloo's TCP transport and breaks the pair): phase 6m's ranks
# probe them again; ``parallel/comm.py`` ``exchange`` sends the halo rows
# through host copies.
GLOO_CUDA_OPS = ("all_reduce", "all_gather")


def _probe_gloo_cuda(group):
    """{op: True where gloo ran it on CUDA tensors over ``group`` and gave
    the right sum or list, else the error}, for GLOO_CUDA_OPS. Every rank
    calls it."""
    import torch
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    try:
        t = torch.full((4,), float(r + 1), device="cuda")
        dist.all_reduce(t, group=group)
        out["all_reduce"] = bool(torch.all(t == n * (n + 1) / 2))
    except RuntimeError as e:
        out["all_reduce"] = str(e).splitlines()[0]
    try:
        t = torch.full((3,), float(r + 1), device="cuda")
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        out["all_gather"] = all(bool(torch.all(p == i + 1))
                                for i, p in enumerate(parts))
    except RuntimeError as e:
        out["all_gather"] = str(e).splitlines()[0]
    return out


def gloo_card_rank(rank, n, init_method, checks):
    """A phase-6m rank: joins the gloo group on the card, probes which
    collectives gloo runs on CUDA tensors, and runs ``parallel/dryrun.py``
    ``checks_rank``."""
    import torch.distributed as dist

    from image_restoration_tpu_torch.parallel import dryrun

    dryrun.join_group(rank, n, init_method, "cuda")
    probe = _probe_gloo_cuda(dist.group.WORLD)
    return {"gloo_cuda": probe,
            **dryrun.checks_rank(rank, n, init_method, checks, "cuda")}


def phase_mesh_ranks(gpu):
    """Phase 6m: two ranks on the one card over gloo (NCCL takes one rank
    a card), spawned by ``parallel/dryrun.py`` ``spawn_ranks``
    (``gloo_card_rank``: which collectives gloo runs on CUDA tensors; the
    halo sends go through host copies, ``parallel/comm.py`` ``exchange``);
    the dry run's check 1 at
    MoCE-IR's full width (batch TRAIN_BATCH x TRAIN_PATCH^2, bf16, K1/K2)
    on a (2, 1) data x expert mesh, so each rank steps on its half of the
    batch, held to one process by the 3x rule (loss and gradients' distance
    from the one-process bf16 step within 3x that step's own distance from
    fp32); check 3 at Restormer-base (bf16, K1/K2, temperatures zeroed):
    a HALO_IMAGE image in HALO_STRIPS strips with the suggested halo, the
    interior within 3x the unsharded bf16 forward's own distance from fp32,
    a halo of HALO_SMALL missing that bound, and the unsharded forward
    within 3x the plain bf16 forward's distance from fp32. Phase 2 holds
    K1/K2 at the strips' and the whole image's shapes, and at a rank's
    batch of TRAIN_BATCH // 2. Returns the ranks' launches (summed), as
    ``mesh_moce`` and ``halo``."""
    import tempfile

    import torch

    from image_restoration_tpu_torch.parallel.dryrun import spawn_ranks
    from image_restoration_tpu_torch.utils.options import MODEL_DEFAULTS

    def defaults(name):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in MODEL_DEFAULTS[name].items()}

    halo, strip, _ = halo_geometry()
    checks = [("moce", (2, 1), ("data", "expert"),
               dict(cfg=defaults("moce_ir"), batch=TRAIN_BATCH,
                    size=TRAIN_PATCH, dtype=torch.bfloat16)),
              ("halo", (1, HALO_STRIPS), ("data", "spatial"),
               dict(cfg=defaults("restormer"), halo=halo, strip=strip,
                    width=HALO_IMAGE[1], dtype=torch.bfloat16,
                    bound_halo=HALO_SMALL))]
    _release_cached_memory()
    with tempfile.TemporaryDirectory(prefix="ir_ranks_") as tmp:
        t0 = time.perf_counter()
        res = spawn_ranks(gloo_card_rank, 2, tmp, 600, threads=4,
                          checks=checks)
        wall = time.perf_counter() - t0
    probe = res[0]["gloo_cuda"]
    takes = sorted(k for k, v in probe.items() if v is True)
    print(f"6m: 2 gloo ranks on {gpu} in {wall:.1f} s (spawn included); "
          f"gloo takes CUDA tensors for {takes} (probe {probe}); halo rows "
          f"sent as host copies (gloo sends no CUDA tensor)",
          flush=True)
    check(set(GLOO_CUDA_OPS) <= set(takes), f"6m: gloo refused {probe}; "
          f"the ranks need {GLOO_CUDA_OPS} on CUDA tensors")
    m, h = res[0]["moce"], res[0]["halo"]
    print(f"6m moce_ir (2, 1) data x expert, batch {TRAIN_BATCH} x "
          f"{TRAIN_PATCH}^2 bf16: loss {m['loss']:.6f} vs one process "
          f"{m['loss_one']:.6f} (fp32 {m['loss_fp32']:.6f}); gradient norm "
          f"{m['gnorm']:.6f} vs {m['gnorm_one']:.6f}; gradients' relative "
          f"L2 to one process {m['grad_dist']:.3e} (one-process bf16 vs "
          f"fp32 {m['grad_dist_fp32']:.3e})", flush=True)
    print(f"6m halo Restormer-base {HALO_IMAGE[0]}x{HALO_IMAGE[1]} in "
          f"{HALO_STRIPS} strips of {strip} rows, halo {h['halo']} (padded "
          f"strips {h['strip_rows']}x{HALO_IMAGE[1]}), bf16: interior rows "
          f"{h['halo']}..{HALO_IMAGE[0] - h['halo']} max |err| "
          f"{h['interior_err']:.4e} vs the unsharded forward (its own "
          f"bf16-vs-fp32 there {h['bf16_vs_fp32']:.4e}, bound 3x); halo "
          f"{HALO_SMALL}: {h['small_halo_err']:.4e}; the unsharded kernel "
          f"forward vs fp32 {h['full_vs_fp32']:.4e}, the plain bf16 one "
          f"{h['plain_vs_fp32']:.4e} (bound 3x)", flush=True)
    out = {}
    for path, key in (("mesh_moce", "moce"), ("halo", "halo")):
        total = {}
        for r in res:
            for k, v in r[key]["launches"].items():
                total[k] = total.get(k, 0) + v
        out[path] = total
    want_m = dict.fromkeys(("block_front", "block_apply_gdfn"),
                           2 * MOCE_BLOCKS_PER_FORWARD)
    want_h = dict.fromkeys(("block_front", "block_apply_gdfn"),
                           2 * BLOCKS_PER_FORWARD)
    print(f"6m launches: {out}", flush=True)
    check(out["mesh_moce"] == want_m, f"6m: the sharded MoCE-IR step "
          f"launched {out['mesh_moce']}, expected {want_m} (a forward on "
          f"each rank)")
    check(out["halo"] == want_h, f"6m: the halo forward launched "
          f"{out['halo']}, expected {want_h} (a forward a strip)")
    return out


def phase_distill(gpu):
    """Phase 6d: LSNet-B (seeded, BatchNorm affines perturbed and statistics
    calibrated: ``perturb_lsnet``) in eval mode distils a seeded LSNet-B
    student (``train/distill.py``: ``freeze_mask('freeze_ratio', 0.5)`` on
    the JAX paths, ``frozen_optimizer`` over AdamW, ``make_distill_step``)
    for DISTILL_STEPS steps of DISTILL_BATCH x 224^2, both built with
    ``use_pallas_ska`` in bf16: a forward of each launches K9 9 times, the
    student's backward K9b's two kernels 9 times each; frozen parameters
    stay, the loss is finite. Then ``export_program`` of the student (eval,
    statistics calibrated) holds 9 ``ir_torch::ska`` nodes, and the loaded
    program, which launches K9, is held to the live student. Returns the
    steps' launches, as ``distill``."""
    import torch

    from image_restoration_tpu_torch.kernels import ska as KS
    from image_restoration_tpu_torch.models import get_model
    from image_restoration_tpu_torch.models.lsnet import lsnet_key_map
    from image_restoration_tpu_torch.train import distill as D
    from image_restoration_tpu_torch.train.trainer import (
        Optimizer, TrainerConfig,
    )

    counters = {"ska": KS.ska, "ska_bwd_x": KS.ska_bwd_x,
                "ska_bwd_w": KS.ska_bwd_w}

    def lsnet_b(seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return get_model("lsnet", num_classes=0,
                             embed_dim=(128, 256, 384, 512),
                             depth=(4, 6, 8, 10), use_pallas_ska=True,
                             dtype=torch.bfloat16).cuda()

    gen = torch.Generator(device="cuda").manual_seed(2600)
    x = torch.rand((DISTILL_BATCH, 3, 224, 224), generator=gen, device="cuda")
    teacher = lsnet_b(26)
    perturb_lsnet(teacher, 27, x)
    teacher.eval()
    student = lsnet_b(28)
    mask = D.freeze_mask(student, "freeze_ratio", freeze_ratio=0.5,
                         key_map=lsnet_key_map)
    tx = D.frozen_optimizer(Optimizer(TrainerConfig(
        learning_rate=DISTILL_LR, weight_decay=0.05)), mask)
    step = D.make_distill_step(student, teacher, tx)
    before = {k: p.detach().clone() for k, p in student.named_parameters()}
    for f in counters.values():
        f.launches = 0
    times, losses = [], []
    for _ in range(DISTILL_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logs = step(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(logs["total"]))
    launches = {k: f.launches for k, f in counters.items()}
    frozen = [k for k, m in mask.items() if not m]
    kept = all(torch.equal(p.detach(), before[k])
               for k, p in student.named_parameters() if not mask[k])
    print(f"6d distill LSNet-B -> LSNet-B, batch {DISTILL_BATCH} x 224^2 "
          f"bf16 on {gpu}: {len(frozen)} of {len(mask)} parameters frozen "
          f"(freeze_ratio 0.5), losses {[round(v, 6) for v in losses]}, step "
          f"ms {[round(t, 3) for t in times]} (CUDA events; the first "
          f"includes the optimizer's init), launches {launches}", flush=True)
    check(kept, "6d: a frozen parameter moved")
    check(np.isfinite(losses).all(), "6d: a non-finite distillation loss")
    want = {"ska": 2 * SKA_PER_FORWARD * DISTILL_STEPS,
            "ska_bwd_x": SKA_PER_FORWARD * DISTILL_STEPS,
            "ska_bwd_w": SKA_PER_FORWARD * DISTILL_STEPS}
    check(launches == want, f"6d: launches {launches}, expected {want}")

    calibrate_batchnorm(student, x)
    student.eval()
    t0 = time.perf_counter()
    blob = D.export_program(student, (x,))
    t_export = time.perf_counter() - t0
    program = torch.export.load(__import__("io").BytesIO(blob))
    n_ops = sum(str(n.target) == "ir_torch.ska.default"
                for n in program.graph.nodes)
    loaded = D.load_program(blob)
    KS.ska.launches = 0
    with torch.no_grad():
        got = loaded(x).float()
        torch.cuda.synchronize()
        n_loaded = KS.ska.launches
        live = student(x).float()
    err = float((got - live).abs().max())
    scale = float(live.abs().max())
    print(f"6d export: {len(blob) / 2**20:.1f} MiB in {t_export:.1f} s "
          f"(host clock), {n_ops} ir_torch::ska nodes; the loaded program "
          f"launched K9 {n_loaded} times; max |loaded - live| {err:.3e} "
          f"(max |live| {scale:.3e})", flush=True)
    check(n_ops == SKA_PER_FORWARD and n_loaded == SKA_PER_FORWARD,
          "6d: the exported program does not hold and launch K9 9 times")
    check(np.isfinite(scale) and err <= 1e-3 * scale,
          "6d: the loaded program differs from the live student")
    return {"distill": launches}


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with the phase's seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
    ap.add_argument("--ska-bwd", nargs="*", type=int, default=None,
                    metavar="TH",
                    help="only SKA's two backward kernels at the four "
                         "paths' shapes: the bits, two equal runs and the "
                         "times of the simple kernels and of the strip "
                         "kernels at the tables' rows a strip or at each of "
                         "TH; prints no result line")
    ap.add_argument("--learn", type=int, default=None, metavar="DIM",
                    help="only the overfit run of tools/learn_run.py (its "
                         "synthetic rain set and its cli/train.py argv, "
                         "2000 steps) through the port's cli/train.py at "
                         "model_kwargs.dim=DIM; prints the PSNR curve and "
                         "no result line")
    ap.add_argument("--learn-moce", action="store_true",
                    help="only the overfit run of tools/learn_run2.py's "
                         "moce_ir argv (2500 steps) through the port's "
                         "cli/train.py; prints the PSNR curve and no result "
                         "line")
    ap.add_argument("--shapes", default="restormer",
                    choices=["restormer", "measnet", "nerd_rain"],
                    help="with --tail or --front: the block shapes; "
                         "measnet and nerd_rain run K2 or K1 alone at "
                         "MEASNet's five (C 32, 64, 128, 256) or "
                         "NeRD-Rain's nine")
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
                         "ring - 1 tiles ahead); with --ska or --ska-bwd "
                         "(1 or 2): K9's or its backward's strip slots (1: "
                         "one strip a block)")
    ap.add_argument("--split", type=int, default=None, choices=[1, 2, 4, 8],
                    help="with --ska or --ska-bwd: threads that share a K9 "
                         "or a gx unit's channel repeats, or a gw unit's 8 "
                         "channels")
    ap.add_argument("--walk", type=int, default=None,
                    help="with --attn: the fewest tiles a K5 block walks")
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=None,
                    metavar="NAME",
                    help="after the build and the kernel checks (phases "
                         "2-2h), only the named phases (3, 3w, 3j, 3l, 3m, "
                         "3n, "
                         "3o, 3p, 3q, 3f, '3f family', '3f 3l', '3f 3o', "
                         "'3f 3p', '3f 3q', 4, 4m, 4f, 4n, 4p, 4q, 5, 5v, "
                         "5a, 6, 6m, 6d); prints no result line")
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
    ska_given = (args.ska is not None) + (args.ska_bwd is not None)
    if args.ring is not None and (args.attn is not None) + ska_given != 1:
        ap.error("--ring goes with one of --attn, --ska and --ska-bwd")
    if args.ring == (1 if args.attn is not None else 3):
        ap.error("--ring: 2 or 3 with --attn, 1 or 2 with --ska or "
                 "--ska-bwd")
    if args.split is not None and ska_given != 1:
        ap.error("--split goes with one of --ska and --ska-bwd")
    if args.shapes != "restormer" and args.tail is None and \
            args.front is None:
        ap.error("--shapes goes with --tail or --front")
    learn = (args.learn is not None) + args.learn_moce
    if learn and (learn > 1 or args.mefc is not None or any(
            getattr(args, k) is not None
            for k in ("attn", "ska", "ska_bwd", *sweeps))):
        ap.error("--learn and --learn-moce run alone")
    if args.phases is not None and (learn or args.mefc is not None or any(
            getattr(args, k) is not None
            for k in ("attn", "ska", "ska_bwd", *sweeps))):
        ap.error("--phases goes with no sweep and no --learn")

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

    if args.mefc is not None or args.attn is not None or ska_given or \
            any(rows is not None for rows in sweeps.values()):
        for group, rows in sweeps.items():
            if rows is not None:
                phase_sweep(group, rows, args.warps,
                            "restormer" if group == "msfn" else args.shapes)
        if args.mefc is not None:
            phase_mefc_sweep(args.mefc)
        if args.attn is not None:
            phase_attn_sweep(args.attn, args.warps, args.cols, args.groups,
                             args.ring, args.walk)
        if args.ska is not None:
            phase_ska_sweep(args.ska, args.ring, args.split)
        if args.ska_bwd is not None:
            phase_ska_bwd_sweep(args.ska_bwd, args.ring, args.split)
        print(gpu)
        return 0

    if args.learn is not None:
        phase_learn(gpu, args.learn)
        print(gpu)
        return 0
    if args.learn_moce:
        phase_learn_moce(gpu)
        print(gpu)
        return 0

    t_run = time.perf_counter()
    report = timed("2", phase_kernels)
    merge_path(report, timed("2e measnet", phase_kernels, MEASNET_LEVELS,
                             1000, "measnet "), "measnet")
    merge_path(report, timed("2e nerd_rain", phase_kernels, NERD_LEVELS,
                             1100, "nerd_rain "), "nerd_rain")
    timed("2e gated", phase_gated)
    dim24 = timed("2w", phase_width_kernels)
    merge_path(report, timed("2f", phase_kernels, MOCE_LEVELS, 1300,
                             "moce_ir ", **MOCE_BLOCK), "moce_ir")
    merge_path(report, timed("2g", phase_kernels, TRAIN_LEVELS, 1500,
                             f"train batch {TRAIN_BATCH} ",
                             batch=TRAIN_BATCH), "train")
    timed("2g backward", phase_block_backward)
    report.update(timed("2b", phase_drs_kernels))
    merge_path(report, timed(
        "2b train", phase_drs_kernels, DRS_TRAIN_LEVELS, MEFC_TRAIN_STEPS,
        TRAIN_BATCH, f"train_drsformer batch {TRAIN_BATCH} ", front=True),
        "train_drsformer")
    report.update(timed("2c", phase_ska_kernels))
    report.update(timed("2c backward", phase_ska_bwd_kernels))
    for path, shapes, b in (("cls_train", LSNET_T_SKA_SHAPES, CLS_BATCH),
                            ("robust", SKA_SHAPES, ADV_IMAGES)):
        merge_path(report, timed(f"2c {path}", phase_ska_kernels, shapes, b,
                                 f"{path} "), path)
        merge_path(report, timed(f"2c {path} backward", phase_ska_bwd_kernels,
                                 shapes, b, f"{path} "), path)
    report.update(timed("2d", phase_3k_kernels))
    merge_path(report, timed("2d train", phase_3k_kernels, TRAIN_LEVELS,
                             TRAIN_BATCH, f"train_3k batch {TRAIN_BATCH} "),
               "train_3k")
    timed("2h", phase_vjps)
    merge_path(report, dim24, "dim24")  # every kernel's row is in now
    merge_path(report, timed("2g moce_ir", phase_kernels, MOCE_TRAIN_LEVELS,
                             2200, f"moce_ir train batch {TRAIN_BATCH} ",
                             batch=TRAIN_BATCH, **MOCE_BLOCK), "train_moce")
    # The ranks' shapes (phases 6m, 6d): a MoCE-IR rank's half batch, the
    # halo strips and the whole image they are held to, a distillation
    # step's batch.
    merge_path(report, timed("2g mesh_moce", phase_kernels, MOCE_TRAIN_LEVELS,
                             2300, f"mesh_moce rank batch {TRAIN_BATCH // 2} ",
                             batch=TRAIN_BATCH // 2, **MOCE_BLOCK),
               "mesh_moce")
    _, _, strip_rows = halo_geometry()
    merge_path(report, timed("2g halo", phase_kernels, restormer_levels(
        strip_rows, HALO_IMAGE[1]), 2400, "halo strip "), "halo")
    timed("2g halo full", phase_kernels, restormer_levels(*HALO_IMAGE), 2500,
          "halo full image ")
    merge_path(report, timed("2c distill", phase_ska_kernels, SKA_SHAPES,
                             DISTILL_BATCH, "distill "), "distill")
    merge_path(report, timed("2c distill backward", phase_ska_bwd_kernels,
                             SKA_SHAPES, DISTILL_BATCH, "distill "), "distill")
    later = {
        "3": lambda: phase_serve_slices(gpu, args.profile),
        "3w": lambda: phase_serve_widths(gpu, args.profile),
        "3j": lambda: phase_serve_family(gpu, args.profile),
        "3l": lambda: phase_serve_family(gpu, args.profile, SERVE_3L),
        "3m": lambda: phase_serve_gla(gpu, args.profile),
        "3n": lambda: phase_dense(gpu),
        "3o": lambda: phase_serve_adaptir(gpu, args.profile),
        "3p": lambda: phase_serve_branch(gpu, args.profile),
        "3q": lambda: phase_serve_demo(gpu, args.profile),
        "3f": lambda: dict(zip(("eval", "eval_drsformer"), phase_eval(gpu))),
        "3f family": lambda: phase_eval_family(gpu),
        "3f 3l": lambda: phase_eval_family(gpu, EVAL_3L, "3f (3l)"),
        "3f 3o": lambda: phase_eval_adaptir(gpu),
        "3f 3p": lambda: phase_eval_branch(gpu),
        "3f 3q": lambda: phase_eval_demo(gpu),
        "4": lambda: phase_train(gpu, args.profile),
        "4m": lambda: phase_train_moce(gpu),
        "4f": lambda: phase_train_family(gpu),
        "4n": lambda: phase_train_family(gpu, TRAIN_4N, "4n"),
        "4p": lambda: phase_train_branch(gpu),
        "4q": lambda: phase_train_demo(gpu),
        "5": lambda: phase_lsnet_grad(gpu),
        "5v": lambda: phase_train_gla(gpu),
        "5a": lambda: phase_train_adaptir(gpu),
        "6": lambda: phase_mesh_train(gpu),
        "6m": lambda: phase_mesh_ranks(gpu),
        "6d": lambda: phase_distill(gpu),
    }
    check(tuple(later) == PHASES, "the phases and their names differ")
    check(set(_every_kernel()) == set(KERNELS), "a kernel without its counter")
    by_path = {}
    for name, run in later.items():
        if args.phases is None or name in args.phases:
            by_path.update(timed(name, run))
    if args.phases is not None:
        print(f"chip_smoke: phases {args.phases} "
              f"{time.perf_counter() - t_run:.1f} s after the build",
              flush=True)
        print(gpu)
        return 0
    for name in ("ska_bwd_x", "ska_bwd_w"):
        check(sum(n.get(name, 0) for n in by_path.values()) > 0,
              f"{name} never launched on a path")
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s after the build",
          flush=True)
    ms_is = {"block_front": "sum over the 44 blocks of one Restormer-base "
                            "512x512 forward of per-call CUDA-event medians "
                            "(CG-IR's 44 have the same shapes); by_path "
                            "holds MEASNet's 40, NeRD-Rain's 78, "
                            "MoCE-IR's 28, the 44 of a training step's "
                            "forward (batch 8 at 128x128), the 40 of a "
                            "DRSformer training step's, the 28 of a "
                            "MoCE-IR training step's (train_moce), the 28 "
                            "of a MoCE-IR rank's step at batch 4 "
                            "(mesh_moce) and the 44 of a 1136x512 halo "
                            "strip (halo)",
             "block_apply_gdfn": "the same, 44 blocks; by_path as "
                                 "block_front's",
             "ln_gdfn": "the same, 44 blocks of the three-kernel variant; "
                        "by_path holds the 44 of a training step's forward "
                        "(train_3k, batch 8 at 128x128)",
             "ln_qkv_dwconv": "as ln_gdfn's",
             "attn_acc": "as ln_gdfn's",
             "attn_apply": "as ln_gdfn's",
             "drs_apply_msfn": "sum over the 40 blocks of one DRSformer "
                               "512x512 forward of per-call CUDA-event "
                               "medians; by_path holds the 40 of a training "
                               "step's forward (batch 8 at 128x128)",
             "mefc_step": "sum over the 8 steps of one DRSformer 512x512 "
                          "forward of per-shape medians of per-call "
                          "CUDA-event medians; by_path holds a training "
                          "step's 8 (batch 8 at 128x128)",
             "ska": "sum over the 9 calls of one LSNet-B forward of a batch "
                    "of 64 at 224x224 of per-call CUDA-event medians, bf16; "
                    "by_path holds LSNet-T's 2 at batch 32 (cls_train) and "
                    "LSNet-B's 9 at batch 16 (robust; its fp32 times, the "
                    "attack's dtype, are in per_shape) and at batch 32 "
                    "(distill)",
             "ska_bwd_x": "sum over the 9 calls of one LSNet-B backward of a "
                          "batch of 64 at 224x224 of per-call CUDA-event "
                          "medians (the strip kernel, two runs' mean), "
                          "bf16; plain_ms is ska_bwd_plain's, which "
                          "computes both gradients; per_shape holds the "
                          "simple kernel's ms at the same shape "
                          "(simple_ms) and the timer's spread; by_path as "
                          "ska's",
             "ska_bwd_w": "the same as ska_bwd_x's"}

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
                        "ms_is": ms_is[name], "per_shape": r["per_shape"],
                        **({"by_path": r["by_path"]} if "by_path" in r
                           else {})})
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
