#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_dataset_distillation_tpu_torch``)
on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository
beside this file; exits non-zero, and prints no result, otherwise.  It also
refuses to start while ``MDD_PALLAS_GCONV``, ``MDD_STEM_S2D`` or
``MDD_FUSED_JVP`` is set: each phase pins its routes through the config,
and an inherited override would turn a kernel-against-``F.conv2d`` check
into kernels against kernels.  Phases, each of which raises on failure:

1. Build the grouped 3x3 conv kernels (``csrc/gconv3x3.cu``, the generic
   route: ``mma.sync`` tensor cores on 2-D tiles, any width,
   ``csrc/gconv3x3_tc.cu``, bfloat16 tensor cores,
   ``csrc/gconv3x3_tf32.cu``, float32 on the tensor cores, and
   ``csrc/gconv3x3_narrow.cu``, 8 channels per group in both dtypes; one
   ``nvcc`` each for ``sm_90a``, started together), hold each source's
   shared-memory sizes against their Python mirrors, and print the card's
   name and power limit.
2. Hold each kernel against its plain PyTorch version at NFNet-L0's three
   grouped-conv shapes, at mini-batch 100 (the distill step's and the
   eval students'), 128 (the expert trainer's and the test passes') and
   104 (a 1000-image test split's tail): the forward conv, the input
   gradient (the forward kernel on the rotated weight) and the weight
   gradient; the generic kernels (``tc=False``) in float32 and bfloat16,
   the bf16 tensor-core kernels in bfloat16, the TF32 forward and wgrad
   in float32.  Every wgrad and the TF32 forward twice, for the same
   bits.  Hessian-vector products through the autograd Functions in
   float32 (TF32 kernels) and bfloat16 (bf16 tensor-core kernels) in three
   orientations: reverse over reverse, grad of jvp (the Functions'
   forward-mode rules under dual tensors) and jvp of grad (``torch.func``).
   Times
   of each kernel with a warm and a cold L2, of the plain version and of
   the cuDNN call, beside the card's bound.
3. The main path: ``Distiller.step_traj`` outer steps of NFNet-L0 at 224^2,
   nq=100, mb=100, syn_steps=8, bf16 inner compute, forward-HVP with the
   JAX defaults (``fr_bwd="rof"``: grad of jvp, the merged-tangent conv),
   kernels on, dropout and DropPath active; launch counters read around
   it: every grouped conv, its tangent convs, dgrad and wgrad on the
   tensor-core kernels.  Then ``MDD_PALLAS_GCONV`` (``ops/gconv.py::
   configure``): the headline tower built with ``pallas_gconv=True`` under
   ``MDD_PALLAS_GCONV=0``, with ``False`` under ``=1`` and with ``False``
   and the variable unset, one bf16 forward pass each: exactly 0, 19 (one
   per grouped site) and 0 ``gconv3x3_fwd_tc`` launches.
4. One float32 outer step with the kernels (the TF32 forward and wgrad;
   counters read around it) against the same step on
   ``F.conv2d`` (TF32 off), from the same seed and state.
5. The eval path, through its entry point: ``cli/eval_distilled.main``
   trains 5 fresh NFNet-L0 students at 224^2 on phase 3's distilled set
   (100 pairs, its learned LR) and scores each on a 1000 x 5 synthetic
   test split (Flickr30K's test shape) with seeded text embeddings in
   place of BERT's; float32, so the TF32 forward and wgrad; counters
   read around it.
6. One ``evaluate_synset`` of that path with the kernels against the same
   on ``F.conv2d`` (TF32 off), from the same init, seeds and batches.
   Then (b) one eval block of 2 students as the distill CLI runs it
   (``evaluate_synset_parallel`` on phase 3's set, the headline recipe's
   4 + 1 epochs at batch 50, a 64 x 5 test split, the library's TF32
   defaults) twice from the same init and set: the metrics equal and each
   student's trained weights and score matrices (before the top-k mask
   and after it, both ways) ``torch.equal``; launches exactly phase 5's
   formula at 2 students, each time.
7. The expert entry point: ``cli/buffer.main`` at full width (NFNet-L0
   224^2, batch 128, BERT-base random-init from the seed for the caption
   caches, the kernels on), four runs: (a) 2 experts x 1 epoch, float32,
   ``--device_augment`` (RandAugment on the card), 1000 synthetic pairs
   and a 1000 x 5 test split; on 256 pairs and 256 x 5, one epoch each,
   (b) 1 expert in bfloat16 (the bf16 tensor-core kernels), (c) 2
   experts with ``--parallel_experts=2``, (d) 1 expert with
   ``--text_trainable`` (BERT-base in the step).  Each run's buffers read
   back through the port's ``load_buffer`` at the towers' widths, every
   logged metric finite and in [0, 100], launches exactly 19 x (2 x train
   batches + test batches) forwards and 19 x train batches wgrads per
   expert-epoch, in the train dtype's route (the test passes float32);
   wall time per epoch, images/s and peak memory printed.  Then 3 steps
   of that trainer at batch 128 with ``--device_augment``, in float32 and
   in bfloat16, with the kernels against the same on ``F.conv2d`` (TF32
   off), from the same init, seeds and crops; and the on-card RandAugment
   against the same plan on the CPU, op by op.
8. The distill entry point: ``cli/distill.main`` at full width (NFNet-L0
   224^2 + ProjectionHead, BERT-base random-init from the seed) on phase
   7 (a)'s 1000 synthetic pairs, caption caches and buffers (2 experts x
   2 snapshots), in its working directory: the init from real pairs, 4
   headline outer steps (the tensor-core kernels), eval blocks of 2
   parallel float32 students at iterations 0 and 3 (the float32 kernels),
   the artifacts, a checkpoint at 2.  Every ``Grand_Loss`` finite;
   ``distilled_{0,3}.npz`` read back; the checkpoint reloaded bit for bit;
   every student's nine metrics finite and in [0, 100]; launches exactly
   4 x phase 3's per step plus 2 x phase 5's per block at 2 students.
9. The zoo's towers (BERT-base random-init caption caches, synthetic
   data, the kernels on).  (d) first: the 8-channel kernels
   (``gconv3x3_narrow.cu``, the route the rule takes) and the generic
   kernels (``tc=False``) at NF-RegNet-B1's four grouped shapes
   (8 channels per group, 11/23/45/92 groups, 56^2 to 7^2) in float32 and
   bfloat16 at mini-batches 100, 128 and 104 against the plain versions
   (the 8-channel wgrad twice, for the same bits), timed beside cuDNN and
   the bound; one float32 NF-RegNet-B1 outer step (mb=25, syn_steps=2)
   with the kernels against ``F.conv2d``, held as phase 4.  (a)
   ViT-Tiny/16, NF-ResNet50, NF-RegNet-B1 and ResNet-18-GN at 224^2 and
   ConvNet at 32^2, each through
   ``cli/buffer.main`` (1 expert x 2 epochs, float32, batch 128, 256 pairs,
   a 256 x 5 test split; buffers read back at the tower's width) and then
   ``cli/distill.main`` on those buffers (2 headline outer steps: nq=100,
   mb=100, syn_steps=8, bf16; one eval block of 1 float32 student at
   iteration 0); seconds per epoch, images/s, outer steps/s and peak
   memory per tower.  (b) ResNet-50 (BatchNorm) through the buffer CLI, 1
   epoch: all 53 running averages moved; the distill CLI refuses it before
   reading data.  (c) ``cli/eval_distilled.main`` on phase 3's distilled
   set under NF-RegNet-B1, ResNet-50, ConvNet and NFNet-L0 with
   ``--transfer``, 2 students each, on a 256 x 5 test split (ViT and
   NF-ResNet50 train their eval students in (a)).
   Launches exact in every run: NF-RegNet-B1's 16 sites on the 8-channel
   kernels in either dtype, no kernel for the towers without grouped
   convs, and the generic kernels on no path.
10. The CLIP family, ConvNeXt, the space-to-depth stem and ZCA.  (c)
   first: an NFNet-L0 outer step at phase 4's size with ``stem_s2d``
   against the plain stem, same weights, in float64 (exact math: loss
   1e-5 relative, each meta-gradient 1e-4 relative error norm) and in
   float32 on the kernels (TF32 off; loss 1e-5, meta-gradients phase 4's
   1e-2, the float32 step's own spread on the card being ~3e-4); then
   the bf16 headline step with and without it, in one pair of one timed
   step each after a warm-up step, times and peaks printed,
   each run's launches phase 3's exactly.  (a) CLIP ViT-B/32 at 224^2
   with the CLIP text tower (base, random init from the seed, 77 tokens,
   512-d caches) and (b) ConvNeXt-Tiny at 224^2 with BERT-base, each on
   phase 9's 256 pairs through the buffer CLI (1 expert x 2 epochs,
   float32; ``.pt`` = ``.npz`` at the tower's width, the ``.pt`` in the
   JAX tree's order), the distill CLI on those buffers (2 headline outer
   steps, one float32 eval student) and ``eval_distilled`` on the set it
   distilled (one student).  (d) the distill CLI at ConvNet 32^2 with
   ``--zca --save_pt True``, 2 outer steps: ``images_zca_0.pt`` against
   the fitted ZCA's ``inverse_transform`` of ``distilled_0.npz``, 1e-5.
   No grouped-conv kernel launches on (a), (b) and (d).
11. The meta-backward's orientations (``fr_bwd`` ``"rof"`` with
   ``fused_jvp`` on and off, ``"for"``).  (a) the LayerNorm, log-softmax
   and GroupNorm forms under grad-of-jvp against reverse-over-reverse in
   float64 (the port's 1e-12; the fused ops' result printed beside); an
   NFNet-L0 outer step at 64^2 (mb 4, 2 inner steps) in float64 on
   ``F.conv2d`` in each mode against the others and ``hvp_mode="reverse"``
   (loss and meta-gradients 1e-9 relative error norm); the float32 step
   of phase 4 in the two other modes, held as phase 4.  (b) the bf16
   headline step in 1 round over the modes of 1 timed step after a
   warm-up step each: medians, ranges, peaks, each run's launches phase
   3's exactly.  (c) one profiled step per mode: device ms and launches,
   the stems' double-backward cuDNN kernels' ms, the count of
   ``_convolution_double_backward`` calls.
12. The quality rehearsal's path and the files of the JAX package.  (a)
   ``tools/torch_make_fixtures.py roco`` at 256 rows (the ROCOv2 CSV, one
   truncated JPEG, one missing file), then ``cli.buffer_roco`` (1 expert x
   2 epochs), ``cli.distill`` (20 iterations, eval blocks of 2 students)
   and ``cli.eval_distilled`` (2 students) with the recipe's flags
   (ConvNet 32^2, BERT tiny): every ``Grand_Loss`` finite, every metric in
   [0, 100], ``distilled_20.npz`` readable, no grouped-conv launch.  (b)
   phase 3's expert segment as a ``.pt`` buffer with its 0-d skipinit
   gains promoted to ``(1,)`` (the JAX writers before round 4), read back
   through ``ExpertCycler`` equal to the segment, into one headline outer
   step launching phase 3's per step.  (c) each DSA op
   (``ops/diffaug.py``) and the ``'M'`` dispatcher at 100 x 224^2 on the
   card against the CPU on the same draws, float32, 1e-4 relative error
   norm, a finite pixel gradient.  (d) each part's wall seconds.
13. Data parallelism (``parallel/``): two ranks, this script run again
   with ``--phase13-rank`` and torchrun's variables, sharing the one card
   over gloo, asked for explicitly and printed (one card each over NCCL
   where the machine has two).  (a) phase 4's float32 step (mb=25 padded
   to 26, ``--shard_syn``, the TF32 kernels) against the one-process step
   on the same inputs at phase 4's tolerances; (b) the bf16 headline step
   at full width, 1 timed step after a warm-up: both ranks' losses bit
   for bit, each rank's launches phase 3's per step, outer steps/s and
   each rank's peak printed; (c) the distill CLI on the ranks for 2
   iterations on phase 7 (a)'s buffers (phase 7's 256-pair caches) with
   a checkpoint, resumed at world 1 for one step; (d) the buffer CLI on
   the ranks, 1 expert x 1 epoch on 256 pairs, against a one-rank run on
   the same global batches at phase 7's 1e-4.  A rank that fails stops
   both and fails the phase.

14. The slice's path at NFNet-L0's published test resolution, 288^2, in
   float32 (the default ``train_dtype``), the kernels on.  First the
   generic kernels at the 36-wide stage-1 shape (mini-batches 100 and
   128, both dtypes, ``tc=False``) against the plain versions, the wgrad
   twice for the same bits, and a stage-1 pass timed beside the bound,
   the plain version, the TF32 forward and cuDNN (TF32 off and on).  Then
   ``cli/buffer.main`` (1 expert x 1 epoch, 256 pairs at batch 128, a 256
   x 5 test split) and ``cli/eval_distilled.main`` (2 students on a
   seeded 100-pair set at 288^2, a 256 x 5 split): every forward and
   dgrad on the TF32 forward (every site is at most 64 wide), the wgrads
   of the 18- and 9-wide sites on the TF32 wgrad and those of the three
   36-wide stage-1 sites (past its 32) on the generic wgrad; launches
   exact in both runs.

Phases 9-11 need nothing of the others but phase 3's distilled set: once
phase 3 has run, a second process of this script (``--worker``) runs them,
in the order 11, 9, 10, on the same card beside phases 4-8 and 12-14,
and its log is printed when both are done; a failure in either fails the
run, and either stops the other.  The kernel checks and timed rows of
phases 9 (d) and 14 run before phase 3, after phase 2, so that every
kernel time is taken with nothing else on the card; the step and wall
times of phases 4-14 are taken beside the other process.

Phase 2 also times the generic kernels and the TF32 kernels in float32
(the dtype of phases 4-8's eval students) beside cuDNN's float32 call with
TF32 off and on.  Phase 2 also runs a double-backward HVP at 8 channels per
group in both dtypes (the 8-channel kernels).

Then a ``{"kernels": [...]}`` line (the 8-channel kernels' numbers at
NF-RegNet-B1's sites; the generic kernels' at the 288^2 stage-1 sites of
phase 14, with their NF-RegNet-B1 and phase-2 NFNet-L0 numbers beside),
the ``nvidia-smi`` name/power line, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
PKG = "multimodal_dataset_distillation_tpu_torch"

PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12    # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12   # H100 SXM dense TF32 tensor-core FLOP/s
TF32_PASSES = 3      # gconv3x3_tf32.cu: hi*hi + hi*lo + lo*hi
HBM_BPS = 3.35e12    # H100 SXM device memory bytes/s

# NFNet-L0's stride-1 grouped 3x3 sites at 224^2: (H, C, groups) -> count
SITES = {(28, 128, 2): 3, (14, 384, 6): 11, (7, 384, 6): 5}
BATCH = 100
# phase 2 also checks the expert trainer's batch and its test split's tail
# (1000 = 7 x 128 + 104)
CHECK_BATCHES = (BATCH, 128, 104)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # x max|plain|; see below
TPU_SRC = "multimodal_dataset_distillation_tpu/ops/pallas_gconv.py"
L2_BYTES = 50e6      # H100 L2; the cold timings rotate through 3x this
# the eight kernels: LAUNCHES key -> (kind, route, source, TPU kernel line)
KERNELS = {
    "gconv3x3_fwd": ("fwd", "generic", "gconv3x3.cu", 176),
    "gconv3x3_wgrad": ("wgrad", "generic", "gconv3x3.cu", 223),
    "gconv3x3_fwd_tc": ("fwd", "tc", "gconv3x3_tc.cu", 176),
    "gconv3x3_wgrad_tc": ("wgrad", "tc", "gconv3x3_tc.cu", 223),
    "gconv3x3_wgrad_tf32": ("wgrad", "tf32", "gconv3x3_tf32.cu", 223),
    "gconv3x3_fwd_tf32": ("fwd", "tf32", "gconv3x3_tf32.cu", 176),
    "gconv3x3_fwd_narrow": ("fwd", "narrow", "gconv3x3_narrow.cu", 176),
    "gconv3x3_wgrad_narrow": ("wgrad", "narrow", "gconv3x3_narrow.cu", 223),
}
# the wrappers' ``tc`` argument that holds each route: the rule's own
# choice for the 8-channel kernels, the forced choice for the others
ROUTE_TC = {"generic": False, "tc": True, "tf32": True, "narrow": None}
# launches per outer step of the headline configuration: each grouped site
# runs 8 forward-kernel and 4 wgrad-kernel calls per inner step, in either
# orientation of the meta-backward (tests/test_torch_gconv_jvp.py counts
# them): the inner gradient's forward and dgrad (1 wgrad), then under
# fr_bwd="rof" the primal forward, the two tangent convs of the forward-
# mode rule and the three dgrads of the reverse pass over them (3 wgrads),
# under "for" the forward, the dgrad and the jvp's two convs of each (the
# wgrad's jvp: 2 wgrads)
MAIN_PATH_PER_STEP = {"gconv3x3_fwd_tc": 19 * 8 * 8,
                      "gconv3x3_wgrad_tc": 19 * 4 * 8}
METRIC_KEYS = ("txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "img_r1",
               "img_r5", "img_r10", "img_r_mean", "r_mean")
# stride-1 grouped 3x3 sites per tower pass, of the towers that have them:
# NFNet-L0's at 64 channels per group (the tensor-core kernels) and
# NF-RegNet-B1's at 8 (the 8-channel kernels, in both dtypes)
TOWER_SITES = {"nfnet": 19, "nf_regnet": 16}
# NFNet-L0's stride-1 grouped 3x3 sites: image size / site width -> count
NFNET_STRIDES = {8: 3, 16: 11, 32: 5}
# NF-RegNet-B1's sites at 224^2: (H, C, groups) -> count
REGNET_SITES = {(56, 88, 11): 1, (28, 184, 23): 3, (14, 360, 45): 6,
                (7, 736, 92): 6}


#: the port's environment overrides of three ``Config`` fields.  Every
#: phase pins its route through ``cfg`` (phases 4, 6, 9 and 10 hold the
#: kernels against ``F.conv2d`` by building with ``pallas_gconv=False``),
#: so an inherited override would turn a check into kernels against
#: kernels without a word: the script refuses to start with one set.
ENV_OVERRIDES = ("MDD_PALLAS_GCONV", "MDD_STEM_S2D", "MDD_FUSED_JVP")


def env_overrides() -> list:
    """The variables of :data:`ENV_OVERRIDES` set in the environment, empty
    ones included."""
    return [k for k in ENV_OVERRIDES if k in os.environ]


def site_launches(encoder: str, dtype: str, fwd: int, wgrad: int,
                  image_size: int = 224) -> dict:
    """Kernel launches of ``fwd`` forward-kernel and ``wgrad`` wgrad calls
    at each grouped site of ``encoder`` in ``dtype`` at ``image_size``, by
    kernel: NFNet-L0's sites take the route ``ops/gconv.py``'s rule gives
    their width (the 64-wide kernel of the dtype, or the generic one past
    its widest width)."""
    from multimodal_dataset_distillation_tpu_torch.ops import gconv as gc

    out = dict.fromkeys(KERNELS, 0)
    if encoder == "nf_regnet":
        out["gconv3x3_fwd_narrow"] += TOWER_SITES[encoder] * fwd
        out["gconv3x3_wgrad_narrow"] += TOWER_SITES[encoder] * wgrad
    elif encoder in TOWER_SITES:
        dt = getattr(torch, dtype)
        for stride, n in NFNET_STRIDES.items():
            for kind, calls in (("fwd", fwd), ("wgrad", wgrad)):
                route = gc._route("site", kind, None, dt, gc.TC_WIDTH,
                                  gc.TC_WIDTH, image_size // stride)
                out[route_keys(route)[kind == "wgrad"]] += n * calls
    return out


def add_launches(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in KERNELS}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, args, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` back-to-back calls,
    captured in one CUDA graph and timed with events around its replay, so
    that the host's launch overhead (tens of us per wrapper call, more than
    a small kernel takes) stays out of the number.  ``args`` is one tuple
    of operands (warm: they stay in L2 between calls) or a list of copies
    used in turn (cold: see :func:`cold_copies`)."""
    sets = args if isinstance(args, list) else [args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def cold_copies(*ts: torch.Tensor) -> list:
    """Copies of the operands, enough that a call's inputs were last read
    more than 3 x the L2's size of other inputs ago: a cold L2 for each."""
    per = sum(t.numel() * t.element_size() for t in ts)
    n = max(2, math.ceil(3 * L2_BYTES / per))
    return [tuple(t.clone() for t in ts) for _ in range(n)]


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def max_err(got: torch.Tensor, want: torch.Tensor):
    err = float((got.float() - want).abs().max())
    return err, float(want.abs().max())


def check(name: str, got, want, dtype) -> float:
    err, scale = max_err(got, want)
    print(f"  {name:<6} {str(dtype)[6:]:<8} max_abs_err {err:.3e}  "
          f"max|plain| {scale:.3e}  tol {TOL[dtype] * scale:.3e}", flush=True)
    if not err <= TOL[dtype] * scale:
        raise AssertionError(f"{name} {dtype}: max abs error {err} > "
                             f"{TOL[dtype]} x {scale}")
    return err


def check_kernels(gc):
    """Phase 2.  Tolerances: float32 1e-4 of the largest plain value (both
    sides accumulate in float32, in other orders; the TF32 kernels' three
    passes keep ~2^-22 of each product, where one pass would miss by
    ~3e-4); bfloat16 1e-2 of it (the kernel rounds its float32 sum to
    bfloat16, 2^-9 relative, and the plain version is computed in float32
    from the same bfloat16 operands).  Each shape at every mini-batch of
    ``CHECK_BATCHES`` (the tile walk and split plans follow it), timed at
    ``BATCH``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (h, c, groups), sites in SITES.items():
        cpg = c // groups
        w32 = torch.randn(3, 3, cpg, c, device="cuda",
                          generator=gen) / math.sqrt(9 * cpg)
        row = {"shape": [BATCH, h, h, c], "groups": groups, "sites": sites}
        inputs = {b: [torch.randn(b, h, h, c, device="cuda", generator=gen)
                      for _ in range(2)] for b in CHECK_BATCHES}
        for batch, (x32, yb32) in inputs.items():
            print(f"shape x=({batch},{h},{h},{c}) groups={groups} "
                  f"({sites} sites per tower pass)", flush=True)
            check_shape(gc, row, x32, w32, yb32, groups)
        # bf16 (the main path's dtype) on both routes; float32 (the dtype
        # of phases 4-8's eval students) on the generic route and on TF32
        (x32, yb32), inputs = inputs[BATCH], None
        time_row(gc, row, x32.bfloat16(), w32.bfloat16(), yb32.bfloat16(),
                 groups, {"fwd": ("generic", "tc"),
                          "wgrad": ("generic", "tc")},
                 "", PEAK_BF16)
        time_row(gc, row, x32, w32, yb32, groups,
                 {"fwd": ("generic", "tf32"),
                  "wgrad": ("generic", "tf32")},
                 "_f32", PEAK_FP32)
        rows.append(row)
    return rows


ROUTES = ((torch.float32, "generic"), (torch.float32, "tf32"),
          (torch.bfloat16, "generic"), (torch.bfloat16, "tc"))


def route_keys(route: str) -> tuple:
    """The LAUNCHES keys of a route's forward and wgrad kernels."""
    sfx = "" if route == "generic" else f"_{route}"
    return f"gconv3x3_fwd{sfx}", f"gconv3x3_wgrad{sfx}"


def check_shape(gc, row, x32, w32, yb32, groups, routes=ROUTES):
    """Each route's forward, dgrad and wgrad at one shape against the plain
    version, and that they ran on that route's kernels and no other;
    ``row`` keeps each error's largest over the shapes."""
    for dtype, route in routes:
        x, w, yb = x32.to(dtype), w32.to(dtype), yb32.to(dtype)
        xf, wf, ybf = x.float(), w.float(), yb.float()
        tc = ROUTE_TC[route]
        tag = f"{route}_{'f32' if dtype == torch.float32 else 'bf16'}"
        print(f"  {route} kernels:", flush=True)
        before = dict(gc.LAUNCHES)
        y = gc.gconv3x3_fwd(x, w, groups, tc=tc)
        errs = {"fwd": check("fwd", y, gc.gconv3x3_ref(xf, wf, groups),
                             dtype)}
        if route == "tf32" and not torch.equal(
                y, gc.gconv3x3_fwd(x, w, groups, tc=True)):
            raise AssertionError("TF32 forward differs on repeat")
        xr = xf.clone().requires_grad_()
        (dx_plain,) = torch.autograd.grad(gc.gconv3x3_ref(xr, wf, groups),
                                          xr, ybf)
        errs["dgrad"] = check(
            "dgrad", gc.gconv3x3_fwd(yb, gc.rot_swap(w, groups), groups,
                                     tc=tc), dx_plain, dtype)
        dw = gc.gconv3x3_wgrad(x, yb, groups, tc=tc)
        errs["wgrad"] = check(
            "wgrad", dw, gc.gconv3x3_wgrad_ref(xf, ybf, groups), dtype)
        if not torch.equal(dw, gc.gconv3x3_wgrad(x, yb, groups, tc=tc)):
            raise AssertionError(f"{route} wgrad differs on repeat")
        ran = {k: gc.LAUNCHES[k] - before[k] for k in gc.LAUNCHES}
        if {k for k, n in ran.items() if n} != set(route_keys(route)):
            raise AssertionError(f"{route} {dtype} checks launched {ran}")
        for kind, e in errs.items():
            key = f"{kind}_err_{tag}"
            row[key] = max(row.get(key, 0.0), e)


def tf32_bound(route: str, sfx: str) -> bool:
    """Whether a route's float32 bound is three TF32 passes: the TF32
    kernels' and the generic kernels' (``mma.sync`` TF32 x 3)."""
    return bool(sfx) and route in ("tf32", "generic")


def time_row(gc, row, x, w, yb, groups, routes, sfx, peak):
    """Times of one shape in one dtype into ``row`` (keys ending in
    ``sfx``): each route's kernels (``routes``: kind -> routes) warm and
    cold, the plain version, and cuDNN's call (for float32 with TF32 off,
    the semantics, and on, PyTorch's default), beside the bound at
    ``peak`` (the TF32 route's own bound: three passes at the TF32
    rate)."""
    h, cpg, c = x.shape[1], w.shape[2], x.shape[3]
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    fwd_in, wgrad_in = cold_copies(x, w), cold_copies(x, yb)
    lib_in = {"fwd": ((x, w_oihw), cold_copies(x, w_oihw)),
              "wgrad": ((x, yb), wgrad_in)}
    flops = 2.0 * BATCH * h * h * c * 9 * cpg
    nbytes = (x.numel() + w.numel() + yb.numel()) * x.element_size()
    bound = bound_ms(flops, nbytes, peak)
    if x.dtype == torch.float32:   # the TF32 kernels' own bound
        for kind in routes:
            row[f"{kind}_bound_tf32{sfx}_ms"], row[
                f"{kind}_bound_tf32{sfx}_by"] = bound_ms(
                    TF32_PASSES * flops, nbytes, PEAK_TF32)
    library = {
        "fwd": lambda a, b: F.conv2d(a.permute(0, 3, 1, 2), b, padding=1,
                                     groups=groups),
        "wgrad": lambda a, b: torch.ops.aten.convolution_backward(
            b.permute(0, 3, 1, 2), a.permute(0, 3, 1, 2), w_oihw, None,
            [1, 1], [1, 1], [1, 1], False, [0, 0], groups,
            [False, True, False]),
    }
    plain = {"fwd": lambda a, b: gc.gconv3x3_ref(a, b, groups),
             "wgrad": lambda a, b: gc.gconv3x3_wgrad_ref(a, b, groups)}
    for kind, warm, cold in (("fwd", (x, w), fwd_in),
                             ("wgrad", (x, yb), wgrad_in)):
        row[f"{kind}_bound{sfx}_ms"], row[f"{kind}_bound{sfx}_by"] = bound
        # the plain wgrad takes up to ~100 ms a call: fewer calls time it
        row[f"{kind}_plain{sfx}_ms"] = cuda_ms(plain[kind], warm, iters=3,
                                               warmup=1)
        row[f"{kind}_library{sfx}_ms"] = cuda_ms(library[kind],
                                                 lib_in[kind][0])
        row[f"{kind}_library{sfx}_cold_ms"] = cuda_ms(library[kind],
                                                      lib_in[kind][1])
        if x.dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = True
            row[f"{kind}_library{sfx}_tf32_ms"] = cuda_ms(library[kind],
                                                          lib_in[kind][0])
            torch.backends.cudnn.allow_tf32 = False
        raw = getattr(gc, f"gconv3x3_{kind}")
        for route in routes[kind]:
            call = (lambda a, b, tc=ROUTE_TC[route]:
                    raw(a, b, groups, tc=tc))
            row[f"{kind}_{route}{sfx}_ms"] = cuda_ms(call, warm)
            row[f"{kind}_{route}{sfx}_cold_ms"] = cuda_ms(call, cold)
    del fwd_in, wgrad_in, lib_in
    print(f"  {str(x.dtype)[6:]} ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in row.items()
        if k.endswith("_ms") and ("_f32" in k) == bool(sfx)),
        flush=True)
    for kind in routes:
        for route in routes[kind]:
            bkey = "_tf32" if tf32_bound(route, sfx) else ""
            share = (row[f"{kind}_bound{bkey}{sfx}_ms"]
                     / row[f"{kind}_{route}{sfx}_cold_ms"])
            print(f"  {kind} {route}{sfx}: bound share (cold) {share:.3f}",
                  flush=True)


def check_hvp(gc):
    """Hessian-vector products through GConv3x3 (its backward and its
    forward-mode rule are GConv3x3 and GConv3x3Wgrad applies, so every
    orientation runs on the kernels) against the same through the plain
    version, at 64 channels per group (float32 on the TF32 forward and
    wgrad, bfloat16 on the tensor-core kernels) and at 8 (the 8-channel
    kernels in both dtypes), in the three orientations: reverse over
    reverse (``torch.autograd.grad`` of the gradient's dot with v), the
    gradient of a forward-mode jvp (``fr_bwd="rof"``: dual tensors of
    ``torch.autograd.forward_ad``) and the jvp of the gradient
    (``fr_bwd="for"``: ``torch.func``).  float32 tolerance 1e-4 of the
    largest plain value.  bfloat16 against the plain version in bfloat16
    on the same operands: both round every intermediate (conv outputs,
    sin, cos, products) to bfloat16 at the same places and differ only in
    the order of the float32 sums inside each conv, so 2e-2 of the largest
    plain value (a few bfloat16 ulps, 2^-8 each, carried through two
    chained convs)."""
    import torch.autograd.forward_ad as fwAD

    torch.backends.cudnn.allow_tf32 = False   # the plain version's convs
    gen = torch.Generator(device="cuda").manual_seed(1)
    # (groups, channels per group, image size, (dtype, route) pairs)
    for groups, cpg, h, runs in (
            (2, 64, 6, ((torch.float32, "tf32"), (torch.bfloat16, "tc"))),
            (11, 8, 7, ((torch.float32, "narrow"),
                        (torch.bfloat16, "narrow")))):
        x = torch.randn(2, h, h, groups * cpg, device="cuda", generator=gen)
        scale = math.sqrt(9 * cpg)
        w = torch.randn(3, 3, cpg, groups * cpg, device="cuda",
                        generator=gen) / scale
        vx, vw = torch.randn_like(x), torch.randn_like(w) / scale
        for dtype, route in runs:
            ops = [t.to(dtype) for t in (x, w, vx, vw)]

            def loss(conv):
                return lambda a, b: torch.sin(conv(a, b, groups)).sum()

            def ror(conv, xx, ww, v1, v2):
                xx, ww = xx.requires_grad_(), ww.requires_grad_()
                gx, gw = torch.autograd.grad(loss(conv)(xx, ww), (xx, ww),
                                             create_graph=True)
                return torch.autograd.grad(
                    (gx * v1).sum() + (gw * v2).sum(), (xx, ww))

            def rof(conv, xx, ww, v1, v2):
                xx, ww = xx.requires_grad_(), ww.requires_grad_()
                with fwAD.dual_level():
                    out = loss(conv)(fwAD.make_dual(xx, v1),
                                     fwAD.make_dual(ww, v2))
                    hv = fwAD.unpack_dual(out).tangent
                return torch.autograd.grad(hv, (xx, ww))

            def for_(conv, xx, ww, v1, v2):
                return torch.func.jvp(torch.func.grad(loss(conv), (0, 1)),
                                      (xx, ww), (v1, v2))[1]

            tol = 1e-4 if dtype == torch.float32 else 2e-2
            for tag, hvp in (("ror", ror), ("rof", rof), ("for", for_)):
                before = dict(gc.LAUNCHES)
                got = hvp(gc.gconv3x3, *[t.clone() for t in ops])
                torch.cuda.synchronize()
                ran = {k for k in gc.LAUNCHES if gc.LAUNCHES[k] != before[k]}
                if ran != set(route_keys(route)):
                    raise AssertionError(
                        f"the {dtype} {tag} HVP at {cpg} channels per group "
                        f"launched {sorted(ran)}")
                want = hvp(gc.gconv3x3_ref, *[t.clone() for t in ops])
                for name, a, b in zip(("hvp_x", "hvp_w"), got, want):
                    err, big = max_err(a, b.float())
                    print(f"  {tag} {name:<6} cpg {cpg:<3} "
                          f"{str(dtype)[6:]:<8} max_abs_err {err:.3e}  "
                          f"max|plain| {big:.3e}  tol {tol * big:.3e}",
                          flush=True)
                    if not err <= tol * big:
                        raise AssertionError(f"{tag} {name} {dtype} cpg "
                                             f"{cpg}: {err} > {tol} x {big}")


def main_cfg(Config, **kw):
    """The headline configuration (bench.py:188-193) with the kernels on."""
    base = dict(image_encoder="nfnet", image_size=224, num_queries=100,
                syn_steps=8, mini_batch_size=100, expert_epochs=1,
                lr_img=1000.0, lr_txt=1000.0, lr_lr=1e-2,
                lr_teacher_img=0.1, lr_teacher_txt=0.1, seed=0,
                inner_dtype="bfloat16", hvp_mode="forward", pallas_gconv=True)
    return Config(**{**base, **kw})


def make_distiller(cfg, seed: int = 0, device: str = "cuda", mesh=None):
    """Seeded NFNet-L0 bi-encoder, synthetic data and a 2-snapshot expert
    trajectory, as bench.py builds them; theta_0's skipinit gains are moved
    off zero so that the residual branches (and the grouped convs in them)
    shape the loss.  ``mesh``: the Distiller's data-parallel ranks (every
    rank builds the same inputs from the seed)."""
    from multimodal_dataset_distillation_tpu_torch.engine.distill import (
        Distiller)
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder, init_bi_encoder)
    from multimodal_dataset_distillation_tpu_torch.utils.flat import (
        flatten_params)

    model = init_bi_encoder(build_bi_encoder(cfg, device="cpu"), seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("skipinit_gain"):
                p.fill_(0.2 + 0.05 * rng.randn())
    img0 = flatten_params(model.image_encoder).numpy()
    txt0 = flatten_params(model.text_projection).numpy()
    image_syn = rng.randn(cfg.num_queries, cfg.image_size, cfg.image_size,
                          3).astype(np.float32)
    text_syn = rng.randn(cfg.num_queries, 768).astype(np.float32)
    d = Distiller(cfg, model, image_syn, text_syn, device=device, mesh=mesh)
    traj_img = d.put_trajectory(np.stack(
        [img0, img0 + 0.01 * rng.randn(*img0.shape).astype(np.float32)]))
    traj_txt = d.put_trajectory(np.stack(
        [txt0, txt0 + 0.01 * rng.randn(*txt0.shape).astype(np.float32)]))
    return d, traj_img, traj_txt, rng


def main_path(gc, cfg, steps: int = 3):
    """Phase 3: warm-up step + ``steps`` timed outer steps; counters are
    zeroed just before and read just after.  -> (metrics, the distilled
    set: image_syn, text_syn, syn_lr_img, syn_lr_txt)."""
    d, traj_img, traj_txt, rng = make_distiller(cfg)
    st0 = d.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.reset_launches()
    t0 = time.perf_counter()
    losses = [float(d.step_traj(traj_img, traj_txt, 0,
                                d.sample_indices(rng))["grand_loss"])]
    t1 = time.perf_counter()
    for _ in range(steps):
        m = d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))
        losses.append(float(m["grand_loss"]))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(gc.LAUNCHES)
    st = d.state
    print(f"main path: grand_loss per step {losses}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite grand_loss: {losses}")
    for name in ("image_syn", "text_syn", "syn_lr_img", "syn_lr_txt"):
        a, b = getattr(st0, name), getattr(st, name)
        if not bool(torch.isfinite(b).all()) or torch.equal(a, b):
            raise AssertionError(f"{name} did not move to finite values")
    for k, n in launches.items():
        want = MAIN_PATH_PER_STEP.get(k, 0) * (steps + 1)
        if n != want:
            raise AssertionError(f"{k}: {n} launches on the main path, "
                                 f"expected {want}")
    out = {
        "outer_steps": steps + 1,
        "first_step_s": t1 - t0,
        "steps_per_s": steps / (t2 - t1),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
        "launches_per_outer_step": {k: n / (steps + 1)
                                    for k, n in launches.items()},
        "syn_lr_img": float(st.syn_lr_img), "syn_lr_txt": float(st.syn_lr_txt),
    }
    print("main path: " + json.dumps(out), flush=True)
    image_syn, text_syn = d.syn_arrays()
    return out, (image_syn, text_syn, float(st.syn_lr_img),
                 float(st.syn_lr_txt))


#: phase 3's check of ``MDD_PALLAS_GCONV``: (``cfg.pallas_gconv``, the
#: variable's value or None for unset) -> whether the tower takes the kernels
GCONV_ENV_CASES = ((True, "0", False), (False, "1", True), (False, None, False))


def gconv_env_check(gc, Config, batch: int = 8, device: str = "cuda"
                    ) -> list:
    """Build the headline tower (NFNet-L0 at 224^2, seeded weights, bf16)
    under each case of :data:`GCONV_ENV_CASES` and run one forward pass of
    ``batch`` images: its 19 grouped sites launch ``gconv3x3_fwd_tc`` once
    each when the variable (or, unset, the config) asks for the kernels,
    and no kernel launches otherwise.  ``os.environ`` is restored after
    each case.  -> the ``gconv3x3_fwd_tc`` count of each case."""
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder, init_bi_encoder)
    from multimodal_dataset_distillation_tpu_torch.models.layers import WSConv

    weights = init_bi_encoder(build_bi_encoder(
        main_cfg(Config), device="cpu"), 0).image_encoder.state_dict()
    x = torch.randn(batch, 224, 224, 3, device=device,
                    generator=torch.Generator(device).manual_seed(0)
                    ).to(torch.bfloat16)
    counts = []
    for flag, env, on in GCONV_ENV_CASES:
        prev = os.environ.pop("MDD_PALLAS_GCONV", None)
        if env is not None:
            os.environ["MDD_PALLAS_GCONV"] = env
        try:
            cfg = main_cfg(Config, pallas_gconv=flag)
            tower = build_bi_encoder(cfg, device=device).image_encoder
        finally:
            os.environ.pop("MDD_PALLAS_GCONV", None)
            if prev is not None:
                os.environ["MDD_PALLAS_GCONV"] = prev
        sites = sum(m.use_gconv for m in tower.modules()
                    if isinstance(m, WSConv))
        if sites != (TOWER_SITES["nfnet"] if on else 0):
            raise AssertionError(f"pallas_gconv={flag}, MDD_PALLAS_GCONV="
                                 f"{env}: {sites} sites on the kernels")
        tower.load_state_dict(weights)
        tower = tower.to(torch.bfloat16)
        gc.reset_launches()
        with torch.no_grad():
            y = tower(x)
        torch.cuda.synchronize()
        got = dict(gc.LAUNCHES)
        want = dict.fromkeys(KERNELS, 0)
        want["gconv3x3_fwd_tc"] = TOWER_SITES["nfnet"] if on else 0
        if got != want:
            raise AssertionError(
                f"pallas_gconv={flag}, MDD_PALLAS_GCONV={env}: launches "
                f"{got}, expected {want}")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("non-finite tower output")
        counts.append(got["gconv3x3_fwd_tc"])
        del tower, y
    print("MDD_PALLAS_GCONV check: gconv3x3_fwd_tc per tower pass "
          + json.dumps({f"pallas_gconv={f},MDD_PALLAS_GCONV={e}": n
                        for (f, e, _), n in zip(GCONV_ENV_CASES, counts)}),
          flush=True)
    return counts


META_GRADS = ("pixels", "texts", "lr_img", "lr_txt")


def meta_grads(gc, d, traj_img, traj_txt, rng):
    """One outer step of a fresh Distiller ``d`` (from :func:`make_distiller`)
    -> (its loss and meta-gradients in float64, the launches).  In float64
    the trajectory goes in as float64 too (``put_trajectory`` stores
    float32, and a float32 start keeps the students' carry float32).  The
    set is read whole (:meth:`whole_state`: on data-parallel ranks the
    rows each rank updated under ``--shard_syn``, gathered)."""
    if d.cfg.inner_dtype == "float64":
        traj_img, traj_txt = traj_img.double(), traj_txt.double()
    st0 = d.whole_state()
    gc.reset_launches()
    m = d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))
    torch.cuda.synchronize()
    st = d.whole_state()
    # first step: trace = g, update = -lr * g
    res = {"loss": float(m["grand_loss"]),
           "pixels": ((st0.image_syn - st.image_syn) / d.cfg.lr_img).double(),
           "texts": ((st0.text_syn - st.text_syn) / d.cfg.lr_txt).double(),
           "lr_img": m["syn_lr_img_grad"].double(),
           "lr_txt": m["syn_lr_txt_grad"].double()}
    return res, dict(gc.LAUNCHES)


def on_host(res: dict) -> dict:
    """:func:`meta_grads`'s result with its tensors on the host."""
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in res.items()}


def rel_errors(a, b) -> dict:
    """The loss's relative error and each meta-gradient's relative error
    norm of ``a`` against ``b`` (whose meta-gradients must not be 0)."""
    r = {"loss_a": a["loss"], "loss_b": b["loss"],
         "loss_rel_err": abs(a["loss"] - b["loss"]) / abs(b["loss"])}
    for k in META_GRADS:
        if not b[k].norm() > 0:
            raise AssertionError(f"meta-gradient {k} is zero")
        r[f"{k}_grad_rel_err"] = float((a[k] - b[k]).norm() / b[k].norm())
    return r


def compare_f32(gc, cfg, mb: int = 25, syn_steps: int = 2):
    """Phase 4: one float32 outer step with the kernels against the same
    step on F.conv2d, at full width and 224^2 (mini-batch and syn_steps
    cut so that two float32 second-order graphs fit).  Tolerance 1e-3 on
    the loss and 1e-2 on each meta-gradient's relative error norm: the two
    convs sum in other orders, and the difference passes through two
    second-order inner steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for gconv in (True, False):
        c = cfg.replace(syn_steps=syn_steps, mini_batch_size=mb,
                        inner_dtype="float32", pallas_gconv=gconv)
        res[gconv], n = meta_grads(gc, *make_distiller(c))
        if gconv:
            launches = n
        torch.cuda.empty_cache()
    out = {"mini_batch": mb, "syn_steps": syn_steps, "launches": launches,
           **rel_errors(res[True], res[False])}
    if not (out["loss_rel_err"] <= 1e-3
            and all(out[f"{k}_grad_rel_err"] <= 1e-2 for k in META_GRADS)):
        raise AssertionError(f"f32 step differs: {out}")
    print("f32 kernels vs F.conv2d: " + json.dumps(out), flush=True)
    want = site_launches(cfg.image_encoder, "float32", 8 * syn_steps,
                         4 * syn_steps)
    if launches != want:
        raise AssertionError(f"float32 step launches {launches}, expected "
                             f"{want}")
    return out


def eval_cfg(Config, **kw):
    """Phase 5's configuration: the eval CLI at NFNet-L0 224^2, 5 students,
    a 1000-image synthetic test split (5 captions each: Flickr30K's test
    shape), the kernels on, and no pretrained tower, so that the result
    does not depend on whether a checkpoint file is present."""
    base = dict(dataset="synthetic", synthetic_test_size=1000,
                image_size=224, image_encoder="nfnet", pallas_gconv=True,
                num_eval=5, epoch_eval_train=1, batch_train=128,
                batch_size_test=128, k_test=128, parallel_eval=True,
                std=True, image_pretrained=False, seed=0)
    return Config(**{**base, **kw})


def eval_launches(cfg, n_pairs: int) -> dict:
    """Kernel launches of the eval path: per student, every training step
    runs each grouped site forward, its input gradient (the stem's
    parameters lie upstream of every site) and its wgrad, and every test
    batch runs them forward; float32 (NFNet-L0: the TF32 forward and
    wgrad)."""
    steps = (cfg.epoch_eval_train + 1) * math.ceil(n_pairs / cfg.batch_train)
    tests = math.ceil(cfg.synthetic_test_size / cfg.batch_size_test)
    return site_launches(cfg.image_encoder, "float32",
                         cfg.num_eval * (2 * steps + tests),
                         cfg.num_eval * steps, cfg.image_size)


def text_cache(cfg) -> np.ndarray:
    """Stand-ins for the BERT embeddings of the test captions (5 per image,
    768-d), drawn from the seed."""
    return np.random.RandomState(cfg.seed).randn(
        5 * cfg.synthetic_test_size, 768).astype(np.float32)


def eval_path(gc, Config, syn, **kw):
    """Phase 5: ``cli/eval_distilled.main`` on phase 3's distilled set, in a
    temporary working directory (the text cache is read from there);
    counters zeroed just before and read just after.  Each student's
    training steps and retrieval pass are timed on the host clock between
    synchronizes, by wrapping the trainer's step and ``retrieval_eval``."""
    from multimodal_dataset_distillation_tpu_torch.cli import eval_distilled
    from multimodal_dataset_distillation_tpu_torch.engine import eval as ev
    from multimodal_dataset_distillation_tpu_torch.engine import expert

    image_syn, text_syn, lr_img, lr_txt = syn
    times = {"train": {}, "retrieval": []}

    def timed(fn, record):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            record(a, (time.perf_counter() - t) * 1e3)
            return out
        return run

    def add_train(a, ms):   # a[0]: the student's trainer
        times["train"][id(a[0])] = times["train"].get(id(a[0]), 0.0) + ms

    step, retrieval = expert.BiEncoderTrainer.train_batch, ev.retrieval_eval
    expert.BiEncoderTrainer.train_batch = timed(step, add_train)
    ev.retrieval_eval = timed(retrieval,
                              lambda a, ms: times["retrieval"].append(ms))
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            np.savez("distilled_0.npz", image_syn=image_syn,
                     text_syn=text_syn, syn_lr_img=np.float32(lr_img),
                     syn_lr_txt=np.float32(lr_txt))
            cfg = eval_cfg(Config, distilled_npz="distilled_0.npz", **kw)
            np.savez("synthetic_bert_text_embed.npz",
                     bert_test_embed=text_cache(cfg))
            torch.backends.cudnn.allow_tf32 = True    # PyTorch's defaults
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gc.reset_launches()
            t0 = time.perf_counter()
            results = eval_distilled.main(cfg, argv=[])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(gc.LAUNCHES)
    finally:
        os.chdir(cwd)
        expert.BiEncoderTrainer.train_batch = step
        ev.retrieval_eval = retrieval
    want = eval_launches(cfg, len(image_syn))
    if launches != want:
        raise AssertionError(f"eval path launches {launches}, expected "
                             f"{want}")
    if len(results) != cfg.num_eval:
        raise AssertionError(f"{len(results)} eval results")
    for j, val in enumerate(results):
        if tuple(val) != METRIC_KEYS or not all(
                math.isfinite(v) and 0.0 <= v <= 100.0 for v in val.values()):
            raise AssertionError(f"eval model {j}: bad metrics {val}")
    train_ms = list(times["train"].values())
    out = {"num_eval": cfg.num_eval, "pairs": len(image_syn),
           "lr_net": lr_img, "test_images": cfg.synthetic_test_size,
           "wall_s": wall, "train_ms": train_ms,
           "retrieval_ms": times["retrieval"],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
           / 2**30, "launches": launches,
           "results": [{k: float(v) for k, v in r.items()} for r in results]}
    for j, val in enumerate(results):
        print(f"eval model {j}: train {train_ms[j]:.1f} ms, retrieval "
              f"{times['retrieval'][j]:.1f} ms, " + " ".join(
                  f"{k}={v:.2f}" for k, v in val.items()), flush=True)
    print("eval path: " + json.dumps(out), flush=True)
    return out


def compare_eval(gc, Config, syn, **kw):
    """Phase 6: one ``evaluate_synset`` of the eval path (same init, seeds
    and batches) with the kernels and on ``F.conv2d``, TF32 off for convs
    and matmuls.  Tolerances: each tower's trained parameters 1e-4 in
    relative error norm, and the i2t scores before the top-k mask 1e-3 of
    the largest score in max abs error (the convs sum in other orders, and
    the difference passes through two SGD steps and a 19-site encode).
    The metrics are printed side by side, not held equal: a near-tie may
    swap one rank."""
    from multimodal_dataset_distillation_tpu_torch.cli.distill import (
        make_eval_initializer)
    from multimodal_dataset_distillation_tpu_torch.data import get_dataset
    from multimodal_dataset_distillation_tpu_torch.engine import eval as ev
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder)

    image_syn, text_syn, lr_img, _ = syn
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = eval_cfg(Config, lr_net=lr_img, **kw)
    _, testloader, _, _ = get_dataset(cfg)
    bert = text_cache(cfg)
    init = make_eval_initializer(cfg)
    res = {}
    for gconv in (True, False):
        c = cfg.replace(pallas_gconv=gconv)
        model = build_bi_encoder(c)
        variables = init(model, cfg.seed + 1000)
        gc.reset_launches()
        model, acc, val = ev.evaluate_synset(0, model, variables, image_syn,
                                             text_syn, testloader, c, bert)
        sims = ev.score_matrix(testloader, model, bert)
        torch.cuda.synchronize()
        res[gconv] = {"launches": dict(gc.LAUNCHES), "acc": acc, "val": val,
                      "sims": sims, "init": variables,
                      "towers": {t: dict(getattr(model, t).named_parameters())
                                 for t in ("image_encoder",
                                           "text_projection")}}
    a, b = res[True], res[False]
    if not (a["launches"]["gconv3x3_fwd_tf32"]
            and a["launches"]["gconv3x3_wgrad_tf32"]
            and not any(b["launches"].values())
            and not a["launches"]["gconv3x3_fwd"]
            and not a["launches"]["gconv3x3_wgrad"]
            and not a["launches"]["gconv3x3_fwd_tc"]):
        raise AssertionError(f"phase 6 launches: kernels {a['launches']}, "
                             f"F.conv2d {b['launches']}")
    out = {"launches": a["launches"], "acc_kernel": a["acc"],
           "acc_plain": b["acc"]}
    for t in a["towers"]:
        pa, pb = a["towers"][t], b["towers"][t]
        flat = lambda d: torch.cat([v.detach().double().reshape(-1)  # noqa: E731
                                    for v in d.values()])
        ka, kb = flat(pa), flat(pb)
        init0 = flat({n: a["init"][f"{t}.{n}"] for n in pa})
        out[f"{t}_rel_err"] = float((ka - kb).norm() / kb.norm())
        # diagnostic: the same of the two SGD steps' updates
        out[f"{t}_update_rel_err"] = float(
            (ka - kb).norm() / (kb - init0).norm())
        if not (torch.isfinite(ka).all() and out[f"{t}_rel_err"] <= 1e-4):
            raise AssertionError(f"trained {t} differs: {out}")
    sa, sb = a["sims"], b["sims"]
    scale = float(sb.abs().max())
    out["score_max_abs_err"] = float((sa - sb).abs().max())
    out["score_max_abs"] = scale
    if not (bool(torch.isfinite(sa).all())
            and out["score_max_abs_err"] <= 1e-3 * scale):
        raise AssertionError(f"eval scores differ: {out}")
    for k in METRIC_KEYS:
        out[f"{k}_kernel_plain"] = [float(a["val"][k]), float(b["val"][k])]
    print("eval kernels vs F.conv2d: " + json.dumps(out), flush=True)
    return out


#: phase 6 (b)'s eval block: tools/torch_quality_nfnet.sh's
EVAL_REPRO = dict(num_eval=2, epoch_eval_train=4, batch_train=50,
                  synthetic_test_size=64, batch_size_test=64, distill=True)


def eval_repro(gc, Config, syn, **kw):
    """Phase 6 (b): one eval block of 2 students, as the distill CLI's
    (``evaluate_synset_parallel`` from ``make_eval_initializer``'s seeded
    inits, a fresh trainer), run twice from the same init and set.  Every
    metric equal, and per student the trained weights and the score
    matrices (before the top-k mask, i2t and t2i after it) ``torch.equal``;
    launches phase 5's formula at 2 students each time.  A miss fails the
    run.  cuDNN's TF32 as the library's default (phase 5's), and the TF32
    settings put back as they were after."""
    from multimodal_dataset_distillation_tpu_torch.cli.distill import (
        make_eval_initializer)
    from multimodal_dataset_distillation_tpu_torch.data import get_dataset
    from multimodal_dataset_distillation_tpu_torch.engine import eval as ev
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder)
    from multimodal_dataset_distillation_tpu_torch.utils.flat import (
        flatten_params)

    image_syn, text_syn, lr_img, _ = syn
    cfg = eval_cfg(Config, lr_net=lr_img, **{**EVAL_REPRO, **kw})
    _, testloader, _, _ = get_dataset(cfg)
    bert = text_cache(cfg)
    model = build_bi_encoder(cfg)
    init = make_eval_initializer(cfg)
    want = eval_launches(cfg, len(image_syn))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True    # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    try:
        for _ in range(2):
            inits = [init(model, cfg.seed + 1000 + j)
                     for j in range(cfg.num_eval)]
            reuse = {}
            torch.cuda.synchronize()
            gc.reset_launches()
            t = time.perf_counter()
            _, vals = ev.evaluate_synset_parallel(
                cfg.num_eval, model, inits, image_syn, text_syn, testloader,
                cfg, bert, reuse=reuse)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(gc.LAUNCHES)
            if launches != want:
                raise AssertionError(f"phase 6 (b) launches {launches}, "
                                     f"expected {want}")
            students = [reuse["trainer"].model_for(j)
                        for j in range(cfg.num_eval)]
            sims = [ev.score_matrix(testloader, m, bert) for m in students]
            runs.append({
                "vals": vals, "wall_s": wall,
                "weights": [flatten_params(m).detach().clone()
                            for m in students],
                "scores": [(s, ev.topk_score_matrix(s, cfg.k_test),
                            ev.topk_score_matrix(s.T, cfg.k_test))
                           for s in sims]})
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    a, b = runs
    out = {"num_eval": cfg.num_eval, "pairs": len(image_syn),
           "test_images": cfg.synthetic_test_size,
           "wall_s": [r["wall_s"] for r in runs],
           "r_mean": [[v["r_mean"] for v in r["vals"]] for r in runs],
           "metrics_equal": a["vals"] == b["vals"],
           "weights_equal": all(torch.equal(x, y) for x, y in
                                zip(a["weights"], b["weights"])),
           "scores_equal": all(torch.equal(x, y) for sa, sb in
                               zip(a["scores"], b["scores"])
                               for x, y in zip(sa, sb)),
           "launches": want}
    print("phase 6 (b) eval block twice: " + json.dumps(out), flush=True)
    if not (out["metrics_equal"] and out["weights_equal"]
            and out["scores_equal"]):
        raise AssertionError(f"phase 6 (b): two identical eval blocks "
                             f"differ: {out}")
    for val in a["vals"]:
        if not all(math.isfinite(v) and 0.0 <= v <= 100.0
                   for v in val.values()):
            raise AssertionError(f"phase 6 (b): bad metrics {val}")
    return out


# phase 7's runs of the buffer CLI: (a) the buffers phase 8 distils from;
# (b)-(d) the other routes, on a smaller split (width is what must be full)
_SMALL = dict(synthetic_size=256, synthetic_test_size=256, num_experts=1,
              train_epochs=1)
EXPERT_RUNS = {
    "a": {},
    "b": dict(_SMALL, train_dtype="bfloat16", buffer_path="buffers_b"),
    "c": dict(_SMALL, num_experts=2, parallel_experts=2,
              device_augment=False, buffer_path="buffers_c"),
    "d": dict(_SMALL, text_trainable=True, device_augment=False,
              buffer_path="buffers_d"),
}


def expert_cfg(Config, run: str, **kw):
    """Phase 7's configuration: the buffer CLI at full width (NFNet-L0 at
    224^2 + ProjectionHead, batch 128, the kernels on, BERT-base random-init
    from the seed for the caption caches), no pretrained tower; run (a) 2
    experts x 1 epoch in float32 with the in-step augment on 1000
    synthetic pairs and a 1000 x 5 test split (Flickr30K's test shape)."""
    base = dict(dataset="synthetic", synthetic_size=1000,
                synthetic_test_size=1000, image_encoder="nfnet",
                image_size=224, text_encoder="bert",
                text_encoder_config="base", text_pretrained=False,
                image_pretrained=False, pallas_gconv=True, num_experts=2,
                train_epochs=1, batch_size_train=128, batch_size_test=128,
                k_test=128, lr_teacher_img=0.1, lr_teacher_txt=0.1,
                device_augment=True, disable_wandb=True, seed=0,
                name=f"phase7{run}", buffer_path="buffers",
                save_dir="logged_files")
    return Config(**{**base, **EXPERT_RUNS.get(run, {}), **kw})


def expert_launches(cfg) -> dict:
    """Kernel launches of a buffer CLI run: per expert-epoch, every train
    step runs each grouped site forward, its input gradient (the stem lies
    upstream of every site) and its wgrad, in the train dtype (NFNet-L0:
    float32 on TF32, bfloat16 on the bf16 tensor cores), and every test
    batch runs them forward in float32.  The loader drops the last short
    train batch."""
    steps = cfg.synthetic_size // cfg.batch_size_train
    tests = math.ceil(cfg.synthetic_test_size / cfg.batch_size_test)
    n = cfg.num_experts * cfg.train_epochs
    enc = cfg.image_encoder
    return add_launches(
        site_launches(enc, cfg.train_dtype, n * 2 * steps, n * steps,
                      cfg.image_size),
        site_launches(enc, "float32", n * tests, 0, cfg.image_size))


def expert_path(gc, Config, run: str, **kw):
    """Phase 7, run ``run``: ``cli/buffer.main`` in the current directory;
    launch counters zeroed just before and read just after.  Each epoch's
    training and test pass, and BERT's cache encodes, timed on the host
    clock between synchronizes, by wrapping the trainers' epochs and the
    CLI's test.  The buffers read back through the port's ``load_buffer``
    (``.pt`` and ``.npz`` the same, the towers' widths); every logged
    metric finite, the recalls in [0, 100]."""
    from multimodal_dataset_distillation_tpu_torch.cli import buffer as cli
    from multimodal_dataset_distillation_tpu_torch.engine import expert
    from multimodal_dataset_distillation_tpu_torch.engine.buffer_io import (
        load_buffer)
    from multimodal_dataset_distillation_tpu_torch.models import bert
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder, build_trainable_text)

    cfg = expert_cfg(Config, run, **kw)
    times = {"train": [], "test": [], "encode": []}
    now = time.perf_counter

    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t = now()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[key].append(now() - t)
            return out
        setattr(obj, name, timed)
        return obj, name, fn

    saved = [wrap(c, "train_epoch_captions", "train") for c in (
        expert.BiEncoderTrainer, expert.ParallelExpertTrainer,
        expert.TrainableTextTrainer)]
    saved += [wrap(cli, "_test", "test"),
              wrap(bert.TextEncoder, "encode", "encode")]
    try:
        torch.backends.cudnn.allow_tf32 = True    # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gc.reset_launches()
        t0 = now()
        indices = cli.main(cfg)
        torch.cuda.synchronize()
        wall = now() - t0
        launches = dict(gc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)
    want = expert_launches(cfg)
    if launches != want:
        raise AssertionError(f"buffer CLI ({run}) launches {launches}, "
                             f"expected {want}")
    if indices != list(range(cfg.num_experts)):
        raise AssertionError(f"buffer CLI ({run}) saved {indices}")
    model = (build_trainable_text if cfg.text_trainable
             else build_bi_encoder)(cfg, device="cpu")
    towers = {"img": model.image_encoder,
              "txt": (model.text_encoder if cfg.text_trainable
                      else model.text_projection)}
    widths = {}
    for n in indices:
        for kind, tower in towers.items():
            stem = os.path.join(cli.expert_dir(cfg), f"{kind}_replay_buffer_"
                                f"{n}")
            (a,), (b,) = (load_buffer(stem + ext, tower)
                          for ext in (".npz", ".pt"))
            widths[kind] = a.shape[1]
            if not (a.shape == (cfg.train_epochs + 1, sum(
                    p.numel() for p in tower.parameters()))
                    and np.isfinite(a).all() and np.array_equal(a, b)
                    and not np.array_equal(a[0], a[-1])):
                raise AssertionError(f"buffer CLI ({run}): {stem} holds "
                                     f"{a.shape}, finite {np.isfinite(a).all()}")
    with open(os.path.join(cfg.save_dir, f"{cfg.name}.jsonl")) as f:
        logged = [r for r in map(json.loads, f) if "train_loss" in r]
    if len(logged) != cfg.num_experts * cfg.train_epochs or not all(
            math.isfinite(r["train_loss"]) and all(
                math.isfinite(r[k]) and 0.0 <= r[k] <= 100.0
                for k in METRIC_KEYS) for r in logged):
        raise AssertionError(f"buffer CLI ({run}) logged {logged}")
    # one train call per epoch (all experts of a lockstep group), one test
    # pass per expert and epoch
    images = (cfg.synthetic_size // cfg.batch_size_train
              * cfg.batch_size_train * max(1, cfg.parallel_experts))
    k = len(times["test"]) // len(times["train"])
    epochs = [{"train_s": tr, "test_s": sum(times["test"][i * k:(i + 1) * k]),
               "images_per_s": images / tr}
              for i, tr in enumerate(times["train"])]
    out = {"run": run, "train_dtype": cfg.train_dtype,
           "device_augment": cfg.device_augment,
           "parallel_experts": cfg.parallel_experts,
           "text_trainable": cfg.text_trainable,
           "experts": cfg.num_experts, "epochs": cfg.train_epochs,
           "pairs": cfg.synthetic_size, "test_images": cfg.synthetic_test_size,
           "wall_s": wall, "epoch_s": epochs, "bert_encode_s": times["encode"],
           "max_memory_allocated_gib": peak, "buffer_widths": widths,
           "launches": launches,
           "train_loss": [r["train_loss"] for r in logged],
           "r_mean": [r["r_mean"] for r in logged]}
    print(f"buffer CLI ({run}): " + "; ".join(
        f"epoch {i}: train {e['train_s']:.2f} s ({e['images_per_s']:.1f} "
        f"images/s), test {e['test_s']:.2f} s" for i, e in enumerate(epochs))
        + f"; wall {wall:.1f} s; peak {peak:.2f} GiB", flush=True)
    print(f"buffer CLI ({run}): " + json.dumps(out), flush=True)
    return out


# the on-card augment's tolerances on the [0, 255] scale, against the CPU:
# integer inputs and IEEE arithmetic make the histogram ops exact; the
# blends as in the CPU tests; a float32 grid coordinate at 224 px is good to
# ~2e-5 px, which a step of 255 between neighbours turns into ~5e-3 on
# each side, where a wrong sign, fill or padding moves pixels by tens
AUGMENT_TOL = {"autocontrast": 0.0, "equalize": 0.0, "brightness": 1e-4,
               "sharpness": 1e-4}
AFFINE_TOL = 5e-2


def check_augment(images) -> dict:
    """Phase 7, last: the on-card RandAugment against the same plan applied
    on the CPU, op by op: one round in which every image of ``images``
    (raw crops, (B, H, W, 3) on the card) draws the op, odd images with the
    negated sign, at the trainer's level 5 and at 8 (where brightness and
    sharpness are not the identity).  -> max abs error per op."""
    from multimodal_dataset_distillation_tpu_torch.ops import (
        randaugment_device as rd)

    b, cpu = len(images), images.cpu()
    out = {}
    for k, fn in enumerate(rd.VL_DEVICE_OPS):
        if fn is rd.identity:
            continue
        plan = rd.AugmentPlan(torch.full((b, 1), k),
                              torch.ones(b, 1, dtype=torch.bool),
                              (torch.arange(b) % 2 == 1)[:, None])
        tol = AUGMENT_TOL.get(fn.__name__, AFFINE_TOL)
        for m in (5, 8):
            got = rd.apply_augment_plan(
                images, rd.AugmentPlan(*(t.cuda() for t in plan)), m).cpu()
            err = float((got - rd.apply_augment_plan(cpu, plan, m)).abs().max())
            out[f"{fn.__name__}_{m}"] = err
            if not err <= tol:
                raise AssertionError(f"on-card {fn.__name__} at level {m}: "
                                     f"max abs error {err} > {tol}")
    print("augment card vs CPU: " + json.dumps(out), flush=True)
    return out


def compare_expert(gc, Config, steps: int = 3, **kw) -> dict:
    """Phase 7, last: ``steps`` steps of the buffer CLI's trainer
    (``BiEncoderTrainer.train_batch``) at run (a)'s batch of 128 raw crops
    with ``--device_augment``, in float32 (the TF32 kernels) and in
    bfloat16 (the bf16 tensor-core kernels), with the kernels and on
    ``F.conv2d`` (TF32 off for convs and matmuls), from the same init,
    generator seed and crops, so that both draw the same augment plans and
    dropout masks on the card.  The skipinit gains are moved off zero, as
    phase 3 does, so that the grouped convs shape every step's loss.  Then
    :func:`check_augment` on the first batch.  Tolerances, float32 /
    bfloat16: each tower's trained parameters 1e-4 (phase 6's) / 1e-3 in
    relative error norm; the steps' update of the 19 grouped convs'
    weights 1e-3 (phase 6's two-step update agreed to ~6e-6) / 5e-2.  In
    bfloat16 each conv output is rounded, 2^-9 relative, after sums in
    other orders, on both sides of 19 sites forward and back, so the two
    runs' gradients part at that rounding."""
    from multimodal_dataset_distillation_tpu_torch.cli.buffer import (
        init_expert)
    from multimodal_dataset_distillation_tpu_torch.data import get_dataset
    from multimodal_dataset_distillation_tpu_torch.engine.expert import (
        BiEncoderTrainer)
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder)

    def flat(d, names):
        return torch.cat([d[n].double().reshape(-1).cpu() for n in names])

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = expert_cfg(Config, "a", synthetic_size=steps * 128,
                     synthetic_test_size=128, **kw)
    loader, _, _, _ = get_dataset(cfg)
    rng = np.random.RandomState(cfg.seed)
    batches = [(torch.as_tensor(images, device="cuda"),
                rng.randn(len(images), 768).astype(np.float32))
               for images, *_ in loader]
    init = init_expert(build_bi_encoder(cfg, device="cpu"), cfg, cfg.seed)
    for name, v in init.items():
        if name.endswith("skipinit_gain"):
            v.fill_(0.2 + 0.05 * rng.randn())
    out = {"batches": [list(b[0].shape) for b in batches]}
    for dtype, route in (("float32", "tf32"), ("bfloat16", "tc")):
        res = {}
        for gconv in (True, False):
            model = build_bi_encoder(cfg.replace(pallas_gconv=gconv))
            trainer = BiEncoderTrainer(
                model, init, lr_img=cfg.lr_teacher_img,
                lr_txt=cfg.lr_teacher_txt, seed=cfg.seed,
                compute_dtype=dtype, device_augment=True)
            gc.reset_launches()
            losses = [trainer.train_batch(*b)[0] for b in batches]
            torch.cuda.synchronize()
            res[gconv] = {"launches": dict(gc.LAUNCHES),
                          "loss": [float(x) for x in losses],
                          "params": {n: p.detach() for n, p in
                                     model.named_parameters()}}
            if gconv:
                sites = [f"{n}.weight" for n, m in model.named_modules()
                         if getattr(m, "use_gconv", False)]
        a, b = res[True], res[False]
        want = dict.fromkeys(KERNELS, 0)
        want[f"gconv3x3_fwd_{route}"] = 19 * 2 * len(batches)
        want[f"gconv3x3_wgrad_{route}"] = 19 * len(batches)
        if (a["launches"] != want or any(b["launches"].values())
                or len(sites) != 19):
            raise AssertionError(f"expert trainer ({dtype}) launches: "
                                 f"kernels {a['launches']}, expected {want}, "
                                 f"F.conv2d {b['launches']}; {len(sites)} "
                                 f"grouped sites")
        o = {"launches": a["launches"], "loss_kernel": a["loss"],
             "loss_plain": b["loss"]}
        tol = (1e-4, 1e-3) if dtype == "float32" else (1e-3, 5e-2)
        for tower in ("image_encoder", "text_projection"):
            names = [n for n in a["params"] if n.startswith(tower + ".")]
            ka, kb = flat(a["params"], names), flat(b["params"], names)
            o[f"{tower}_rel_err"] = float((ka - kb).norm() / kb.norm())
            if not (torch.isfinite(ka).all()
                    and o[f"{tower}_rel_err"] <= tol[0]):
                raise AssertionError(f"expert trainer ({dtype}): trained "
                                     f"{tower} differs: {o}")
        w0 = flat(init, sites)
        ua, ub = (flat(r["params"], sites) - w0 for r in (a, b))
        o["gconv_update_rel_err"] = float((ua - ub).norm() / ub.norm())
        o["gconv_update_rel_norm"] = float(ub.norm() / w0.norm())
        if not (ub.norm() > 0 and o["gconv_update_rel_err"] <= tol[1]):
            raise AssertionError(f"expert trainer ({dtype}): grouped-conv "
                                 f"updates differ: {o}")
        print(f"expert trainer {dtype} kernels vs F.conv2d: " + json.dumps(o),
              flush=True)
        out[dtype] = o
    out["augment_max_abs_err"] = check_augment(batches[0][0])
    torch.backends.cudnn.allow_tf32 = True
    return out


def distill_cli_cfg(Config, **kw):
    """Phase 8's configuration: the distill CLI at full width (NFNet-L0 at
    224^2 + ProjectionHead, BERT-base random-init from the seed), the
    headline step (nq=100, mb=100, syn_steps=8, bf16, forward-HVP, the
    kernels), 4 outer steps with eval blocks of 2 parallel students at
    iterations 0 and 3, a checkpoint at 2, on 1000 synthetic train pairs
    and a 1000 x 5 test split (Flickr30K's test shape); ``ipc=50``: the
    reference's gate skips the two image grids, and ``distilled_{it}.npz``
    is written all the same."""
    base = dict(dataset="synthetic", synthetic_size=1000,
                synthetic_test_size=1000, image_encoder="nfnet",
                image_size=224, text_encoder="bert",
                text_encoder_config="base", text_pretrained=False,
                image_pretrained=False, num_queries=100, mini_batch_size=100,
                syn_steps=8, expert_epochs=1, lr_img=1000.0, lr_txt=1000.0,
                lr_lr=1e-2, lr_teacher_img=0.1, lr_teacher_txt=0.1,
                inner_dtype="bfloat16", hvp_mode="forward", pallas_gconv=True,
                Iteration=3, eval_it=3, num_eval=2, epoch_eval_train=1,
                batch_train=128, batch_size_test=128, k_test=128,
                parallel_eval=True, std=True, draw=True, ipc=50, ckpt_it=2,
                disable_wandb=True, seed=0, name="phase8",
                buffer_path="buffers", save_dir="logged_files")
    return Config(**{**base, **kw})


def distill_cli_path(gc, Config, phase3_steps_per_s: float, **kw):
    """Phase 8: ``cli/distill.main`` in the current directory, on the
    buffers and caption caches phase 7's run (a) left there; launch
    counters zeroed just before and read just after.  Times on the host
    clock, by wrapping the CLI's calls: set-up (from the call to the first
    eval block) and its calls, the outer steps between the eval blocks
    (from step 1's call to the read of step 2's result at the second
    block), and each eval block (from its read of the synthetic set to its
    last artifact) and its calls."""
    from multimodal_dataset_distillation_tpu_torch.cli import distill as cli
    from multimodal_dataset_distillation_tpu_torch.cli.eval_distilled import (
        load_distilled)
    from multimodal_dataset_distillation_tpu_torch.engine import distill as eng
    from multimodal_dataset_distillation_tpu_torch.engine.checkpoint import (
        load_distill_checkpoint)
    from multimodal_dataset_distillation_tpu_torch.models import bert
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder)

    cfg = distill_cli_cfg(Config, **kw)
    spans = []   # (label, start, end)
    rec = {}
    now = time.perf_counter

    def wrap(obj, name):
        fn = getattr(obj, name)

        def run(*a, **k):
            t = now()
            out = fn(*a, **k)
            spans.append((name, t, now()))
            return out
        setattr(obj, name, run)
        return obj, name, fn

    def save_ckpt(path, distiller, it, **k):   # the state as it is saved
        rec["ckpt"] = {f: (getattr(distiller.state, f).clone()
                           if f != "mom_lr" else
                           tuple(t.clone() for t in distiller.state.mom_lr))
                       for f in ("image_syn", "text_syn", "syn_lr_img",
                                 "syn_lr_txt", "mom_img", "mom_txt",
                                 "mom_lr")}
        rec["ckpt_rng"] = distiller.rng.get_state().clone()
        return saved_ckpt(path, distiller, it, **k)

    saved = [wrap(bert, "init_bert"), wrap(bert, "_try_hf_tokenizer"),
             wrap(eng.Distiller, "step_traj"),
             wrap(eng.Distiller, "syn_arrays")]
    saved += [wrap(cli, name) for name in (
        "get_dataset", "make_text_encoder", "get_images_texts",
        "init_bi_encoder", "build_bi_encoder", "Distiller", "ExpertCycler",
        "evaluate_synset_parallel", "save_visualizations")]
    saved_ckpt = cli.save_distill_checkpoint
    saved.append((cli, "save_distill_checkpoint", saved_ckpt))
    cli.save_distill_checkpoint = save_ckpt
    try:
        torch.backends.cudnn.allow_tf32 = True    # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gc.reset_launches()
        t0 = now()
        distiller, history = cli.main(cfg)
        torch.cuda.synchronize()
        wall = now() - t0
        launches = dict(gc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        run = os.path.join(cfg.save_dir, cfg.dataset, cfg.name)
        with open(os.path.join(cfg.save_dir, f"{cfg.name}.jsonl")) as f:
            losses = {r["step"]: r["Grand_Loss"] for r in map(json.loads, f)
                      if "Grand_Loss" in r}
        student = cli._student_cfg(cfg)
        model = build_bi_encoder(student)
        sets = {}
        for it in (0, cfg.Iteration):
            img, txt, payload = load_distilled(
                os.path.join(run, f"distilled_{it}.npz"))
            sets[it] = (img.shape, txt.shape, float(payload["syn_lr_img"]))
            if not (img.shape == (cfg.num_queries, cfg.image_size,
                                  cfg.image_size, 3)
                    and txt.shape == (cfg.num_queries,
                                      model.text_embedding)
                    and np.isfinite(img).all() and np.isfinite(txt).all()):
                raise AssertionError(f"distilled_{it}.npz: {sets[it]}")
        # the checkpoint reloads bit for bit into a fresh Distiller
        fresh = eng.Distiller(student, model, np.zeros_like(img),
                              np.zeros_like(txt), device=cfg.device)
        it_ckpt = load_distill_checkpoint(
            os.path.join(run, f"distill_ckpt_{cfg.ckpt_it}.pt"), fresh)
        same = it_ckpt == cfg.ckpt_it and torch.equal(
            fresh.rng.get_state(), rec["ckpt_rng"])
        for f, want in rec["ckpt"].items():
            got = getattr(fresh.state, f)
            pairs = zip(got, want) if f == "mom_lr" else [(got, want)]
            same = same and all(torch.equal(a, b) for a, b in pairs)
        if not same:
            raise AssertionError("distill_ckpt_2.pt does not reload bit "
                                 "for bit")
        del fresh, distiller
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)
    if sorted(losses) != list(range(cfg.Iteration + 1)) or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"Grand_Loss per iteration: {losses}")
    if [it for it, _ in history] != [0, cfg.Iteration]:
        raise AssertionError(f"eval blocks at {[it for it, _ in history]}")
    for it, results in history:
        if len(results) != cfg.num_eval:
            raise AssertionError(f"it {it}: {len(results)} eval results")
        for j, val in enumerate(results):
            if tuple(val) != METRIC_KEYS or not all(
                    math.isfinite(v) and 0.0 <= v <= 100.0
                    for v in val.values()):
                raise AssertionError(f"it {it} student {j}: bad metrics {val}")
    steps = cfg.Iteration + 1
    per_block = eval_launches(cfg, cfg.num_queries)
    want = {k: steps * MAIN_PATH_PER_STEP.get(k, 0) + 2 * per_block[k]
            for k in KERNELS}
    if launches != want:
        raise AssertionError(f"distill CLI launches {launches}, expected "
                             f"{want}")
    syn_t = [(t, u) for name, t, u in spans if name == "syn_arrays"]
    viz_t = [u for name, _, u in spans if name == "save_visualizations"]
    step_t = sorted(t for name, t, _ in spans if name == "step_traj")

    def by_label(lo, hi):
        """Seconds per wrapped call inside [lo, hi] (nested calls are also
        counted inside their callers: the inits inside build and the
        trainer)."""
        out = {}
        for name, t, u in spans:
            if lo <= t and u <= hi and name not in ("syn_arrays",):
                out[name] = out.get(name, 0.0) + (u - t)
        return out

    out = {
        "wall_s": wall, "setup_s": syn_t[0][0] - t0,
        "setup_by_call_s": by_label(t0, syn_t[0][0]),
        # steps 1 and 2: from step 1's call to the read of the set at the
        # second eval block, which waits for step 2
        "cli_steps_per_s": 2 / (syn_t[1][1] - step_t[1]),
        "step_call_intervals_s": [u - t for t, u in zip(
            step_t, step_t[1:3] + [syn_t[1][1]])],
        "phase3_steps_per_s": phase3_steps_per_s,
        "eval_block_s": [v - t for (t, _), v in zip(syn_t, viz_t)],
        "eval_block_by_call_s": [by_label(t, v) for (t, _), v in
                                 zip(syn_t, viz_t)],
        "max_memory_allocated_gib": peak, "launches": launches,
        "grand_loss": [losses[i] for i in sorted(losses)],
        "distilled": {str(k): v for k, v in sets.items()},
        "results": [[{k: float(v) for k, v in r.items()} for r in res]
                    for _, res in history]}
    print(f"distill CLI: set-up {out['setup_s']:.1f} s; {out['cli_steps_per_s']:.4f} outer "
          f"steps/s through the CLI against {phase3_steps_per_s:.4f} through "
          f"the Distiller API; eval blocks "
          f"{', '.join(f'{v:.1f}' for v in out['eval_block_s'])} s; peak "
          f"{peak:.2f} GiB", flush=True)
    print("distill CLI: " + json.dumps(out), flush=True)
    return out


# phase 9 (a)'s towers and image sizes.  ConvNet runs at the JAX rehearsal
# recipes' 32^2 (tools/quality_roco.sh): at 224^2 its first block keeps 128
# channels at full resolution, ~1.3 GB a tensor in bf16 at mini-batch 100
ZOO_TOWERS = {"vit": 224, "nf_resnet50": 224, "nf_regnet": 224,
              "resnet18_gn": 224, "convnet": 32}
ZOO_DATA = dict(synthetic_size=256, synthetic_test_size=256)
# (c): eval towers for phase 3's NFNet-distilled 224^2 set (Table D)
CROSS_EVAL = {"nf_regnet": {}, "resnet50": {}, "convnet": {},
              "nfnet_transfer": dict(image_encoder="nfnet", transfer=True)}


def zoo_distill_cfg(Config, encoder: str, size: int, **kw):
    """Phase 9 (a)'s distill configuration: phase 8's headline step (nq=100,
    mb=100, syn_steps=8, bf16, forward-HVP, the kernels) on 256 pairs, 2
    outer steps, one eval block of 1 float32 student at iteration 0, no
    artifacts."""
    base = dict(image_encoder=encoder, image_size=size, Iteration=1,
                eval_it=2, num_eval=1, parallel_eval=False, std=False,
                draw=False, ckpt_it=0, name=f"phase9_{encoder}", **ZOO_DATA)
    return distill_cli_cfg(Config, **{**base, **kw})


def zoo_expert_path(gc, Config, encoder: str, size: int, **kw):
    """Phase 9 (a)/(b), expert half: the buffer CLI through phase 7's
    :func:`expert_path` (1 expert x 2 epochs, float32, batch 128,
    ``--device_augment``, 256 pairs and a 256 x 5 test split), buffers read
    back at the tower's width, launches exact."""
    return expert_path(gc, Config, f"9_{encoder}", image_encoder=encoder,
                       image_size=size, **{
                           "num_experts": 1, "train_epochs": 2,
                           "name": f"phase9_{encoder}", **ZOO_DATA, **kw})


def zoo_distill_path(gc, Config, encoder: str, size: int, **kw):
    """Phase 9 (a), distill half: ``cli/distill.main`` on the buffers that
    :func:`zoo_expert_path` left in the current directory; launch counters
    zeroed just before and read just after; each outer step timed on the
    host clock between synchronizes; set-up from the call to the first
    step.  Every ``Grand_Loss`` finite, the student's nine metrics finite
    and in [0, 100], launches exact.  -> the summary, and the distilled set
    (image_syn, text_syn, syn_lr_img, syn_lr_txt) under ``"syn"``."""
    from multimodal_dataset_distillation_tpu_torch.cli import distill as cli
    from multimodal_dataset_distillation_tpu_torch.engine import distill as eng

    cfg = zoo_distill_cfg(Config, encoder, size, **kw)
    step_s, step_t = [], []
    step = eng.Distiller.step_traj

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_t.append(t)
        out = step(self, *a, **k)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    eng.Distiller.step_traj = timed
    try:
        torch.backends.cudnn.allow_tf32 = True    # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gc.reset_launches()
        t0 = time.perf_counter()
        distiller, history = cli.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(gc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        st = distiller.state
        syn = (*distiller.syn_arrays(), float(st.syn_lr_img),
               float(st.syn_lr_txt))
        del distiller, st
    finally:
        eng.Distiller.step_traj = step
    with open(os.path.join(cfg.save_dir, f"{cfg.name}.jsonl")) as f:
        losses = {r["step"]: r["Grand_Loss"] for r in map(json.loads, f)
                  if "Grand_Loss" in r}
    steps = cfg.Iteration + 1
    if sorted(losses) != list(range(steps)) or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{encoder}: Grand_Loss per iteration {losses}")
    if [it for it, _ in history] != [0] or len(history[0][1]) != 1:
        raise AssertionError(f"{encoder}: eval blocks {history}")
    val = history[0][1][0]
    if tuple(val) != METRIC_KEYS or not all(
            math.isfinite(v) and 0.0 <= v <= 100.0 for v in val.values()):
        raise AssertionError(f"{encoder}: bad metrics {val}")
    want = add_launches(
        site_launches(encoder, cfg.inner_dtype, 8 * cfg.syn_steps * steps,
                      4 * cfg.syn_steps * steps),
        eval_launches(cfg, cfg.num_queries))
    if launches != want:
        raise AssertionError(f"{encoder}: distill CLI launches {launches}, "
                             f"expected {want}")
    out = {"encoder": encoder, "image_size": size, "wall_s": wall,
           "setup_s": step_t[0] - t0,
           "outer_step_s": step_s, "steps_per_s": 1.0 / step_s[-1],
           "max_memory_allocated_gib": peak, "launches": launches,
           "grand_loss": [losses[i] for i in range(steps)],
           "r_mean": float(val["r_mean"])}
    print(f"distill CLI ({encoder} {size}^2): outer steps "
          f"{', '.join(f'{t:.3f}' for t in step_s)} s "
          f"({out['steps_per_s']:.3f} steps/s after the first); peak "
          f"{peak:.2f} GiB; " + json.dumps(out), flush=True)
    out["syn"] = syn
    return out


def zoo_batchnorm_path(gc, Config, size: int = 224, **kw):
    """Phase 9 (b): ResNet-50 through the buffer CLI (1 expert x 1 epoch):
    every BatchNorm's running averages moved off their init (0 / 1) to
    finite values and the snapshots read back; then the distill CLI
    refuses the tower before it reads any data (the JAX Distiller cannot
    run a BatchNorm tower either)."""
    from multimodal_dataset_distillation_tpu_torch.cli import buffer as bcli
    from multimodal_dataset_distillation_tpu_torch.cli import distill as dcli
    from multimodal_dataset_distillation_tpu_torch.models.layers import (
        BatchNorm)

    built, reads = [], []
    build, get_data = bcli.build_bi_encoder, dcli.get_dataset

    def keep(cfg, device=None):
        built.append(build(cfg, device))
        return built[-1]

    def no_data(cfg):
        reads.append(cfg)
        return get_data(cfg)

    bcli.build_bi_encoder, dcli.get_dataset = keep, no_data
    try:
        out = zoo_expert_path(gc, Config, "resnet50", size,
                              **{"train_epochs": 1, **kw})
        bns = [m for m in built[0].modules() if isinstance(m, BatchNorm)]
        moved = [bool(torch.isfinite(m.running_var).all()
                      and (m.running_var > 0).all()
                      and not (m.running_mean == 0).all()
                      and not (m.running_var == 1).all()) for m in bns]
        if len(bns) != 53 or not all(moved):
            raise AssertionError(f"resnet50: {sum(moved)} of {len(bns)} "
                                 f"BatchNorms moved their running averages")
        try:
            dcli.main(zoo_distill_cfg(Config, "resnet50", size, **kw))
        except ValueError as err:
            if "BatchNorm" not in str(err) or reads:
                raise
            out["distill_refusal"] = str(err)
        else:
            raise AssertionError("the distill CLI ran a BatchNorm tower")
    finally:
        bcli.build_bi_encoder, dcli.get_dataset = build, get_data
    out["batchnorms_moved"] = len(bns)
    print(f"resnet50: {len(bns)} BatchNorms moved; distill CLI refused: "
          f"{out['distill_refusal']}", flush=True)
    return out


def check_kernels_regnet(gc):
    """Phase 9 (d): the 8-channel kernels (the route the rule takes) and
    the generic kernels (``tc=False``) at NF-RegNet-B1's four
    grouped shapes (8 channels per group, odd group counts), forward,
    dgrad and wgrad in float32 and bfloat16 at every mini-batch of
    ``CHECK_BATCHES``: 100 (the distill step and the eval students), 128
    (the expert trainer, the test passes) and 104 (the tail of the
    1000-pair test split of (c)'s evals), against the plain versions with
    phase 2's tolerances, the 8-channel wgrad twice for the same bits;
    both routes timed warm and cold at mini-batch 100 beside cuDNN's call
    (float32: TF32 off and on) and the bound."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    routes = tuple((dtype, route) for route in ("narrow", "generic")
                   for dtype in (torch.float32, torch.bfloat16))
    both = {"fwd": ("narrow", "generic"), "wgrad": ("narrow", "generic")}
    rows = []
    for (h, c, groups), sites in REGNET_SITES.items():
        cpg = c // groups
        w32 = torch.randn(3, 3, cpg, c, device="cuda",
                          generator=gen) / math.sqrt(9 * cpg)
        row = {"shape": [BATCH, h, h, c], "groups": groups, "sites": sites}
        inputs = {b: [torch.randn(b, h, h, c, device="cuda", generator=gen)
                      for _ in range(2)] for b in CHECK_BATCHES}
        for batch, (x32, yb32) in inputs.items():
            print(f"NF-RegNet-B1 shape x=({batch},{h},{h},{c}) "
                  f"groups={groups} ({sites} sites per tower pass)",
                  flush=True)
            check_shape(gc, row, x32, w32, yb32, groups, routes)
        (x32, yb32), inputs = inputs[BATCH], None
        time_row(gc, row, x32.bfloat16(), w32.bfloat16(), yb32.bfloat16(),
                 groups, both, "", PEAK_BF16)
        time_row(gc, row, x32, w32, yb32, groups, both, "_f32", PEAK_FP32)
        rows.append(row)
    return rows


def zoo_path(gc, Config, syn, phase3_steps_per_s: float):
    """Phase 9: (d)'s float32 step first (its kernel checks,
    :func:`check_kernels_regnet`, run alone before phase 3), then (a) each
    tower's buffer -> distill run in one working directory (one caption
    cache for all), (b) ResNet-50, (c) the cross-tower evals.  -> the
    phase's summary."""
    f32 = compare_f32(gc, main_cfg(Config, image_encoder="nf_regnet"))
    torch.cuda.empty_cache()
    out = {"compare_f32_nf_regnet": f32, "towers": {}, "cross_eval": {}}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        for encoder, size in ZOO_TOWERS.items():
            out["towers"][encoder] = {
                "buffer": zoo_expert_path(gc, Config, encoder, size),
                "distill": zoo_distill_path(gc, Config, encoder, size)}
            del out["towers"][encoder]["distill"]["syn"]
            torch.cuda.empty_cache()
        out["resnet50"] = zoo_batchnorm_path(gc, Config)
        torch.cuda.empty_cache()
    for name, flags in CROSS_EVAL.items():
        out["cross_eval"][name] = eval_path(
            gc, Config, syn, num_eval=2, synthetic_test_size=256,
            **{"image_encoder": name, **flags})
        torch.cuda.empty_cache()
    print(f"card: {card_line()}", flush=True)
    for encoder, r in out["towers"].items():
        epochs = r["buffer"]["epoch_s"]
        print(f"phase 9 {encoder} at {ZOO_TOWERS[encoder]}^2: buffer "
              f"{', '.join(f'{e['train_s']:.2f} s' for e in epochs)} per "
              f"epoch ({', '.join(f'{e['images_per_s']:.1f}' for e in epochs)}"
              f" images/s), peak {r['buffer']['max_memory_allocated_gib']:.2f}"
              f" GiB; distill {r['distill']['steps_per_s']:.3f} outer "
              f"steps/s (phase 3's NFNet-L0: {phase3_steps_per_s:.3f}), peak "
              f"{r['distill']['max_memory_allocated_gib']:.2f} GiB",
              flush=True)
    for name, r in out["cross_eval"].items():
        print(f"phase 9 eval under {name}: wall {r['wall_s']:.1f} s, peak "
              f"{r['max_memory_allocated_gib']:.2f} GiB, r_mean "
              f"{[round(x['r_mean'], 2) for x in r['results']]}", flush=True)
    return out


# phase 10 (a)/(b): the last towers of the JAX zoo at 224^2, each with
# its text tower, on phase 9's 256 pairs
CLIP_ZOO = {"clip": dict(text_encoder="clip"),
            "convnext": dict(text_encoder="bert")}
S2D_PAIRS = 1        # (c): alternating pairs of timed runs
S2D_STEPS = 1        # (c): outer steps per timed run


def clip_zoo_path(gc, Config, encoder: str, size: int = 224, **kw):
    """Phase 10 (a)/(b): ``encoder`` through the three CLIs in the current
    directory: the buffer CLI (1 expert x 2 epochs, float32, 256 pairs),
    the distill CLI on its buffers (2 headline outer steps, one float32
    eval student), ``eval_distilled`` on the distilled set (one student,
    the 256 x 5 test split, the caption cache of ``text_encoder`` computed
    by its tower).  Launches 0: neither tower has a grouped 3x3 conv."""
    kw = {**CLIP_ZOO[encoder], "text_encoder_config": "base",
          "text_pretrained": False, **kw}
    buf = zoo_expert_path(gc, Config, encoder, size, **kw)
    torch.cuda.empty_cache()
    dis = zoo_distill_path(gc, Config, encoder, size, **kw)
    syn = dis.pop("syn")
    torch.cuda.empty_cache()
    ev = eval_path(gc, Config, syn, image_encoder=encoder, image_size=size,
                   num_eval=1, parallel_eval=False, std=False,
                   **{**ZOO_DATA, **kw})
    zero = dict.fromkeys(KERNELS, 0)
    for name, r in (("buffer", buf), ("distill", dis), ("eval", ev)):
        if r["launches"] != zero:
            raise AssertionError(f"{encoder} {name}: launches "
                                 f"{r['launches']}")
    width = (128 if kw["text_encoder_config"] == "tiny"
             else {"clip": 512, "bert": 768}[kw["text_encoder"]])
    if syn[1].shape[1] != width:
        raise AssertionError(f"{encoder}: text width {syn[1].shape}")
    epochs = buf["epoch_s"]
    line = {"encoder": encoder, "image_size": size,
            "text_encoder": kw["text_encoder"],
            "expert_images_per_s": epochs[-1]["images_per_s"],
            "expert_peak_gib": buf["max_memory_allocated_gib"],
            "expert_wall_s": buf["wall_s"],
            "distill_steps_per_s": dis["steps_per_s"],
            "distill_outer_step_s": dis["outer_step_s"],
            "distill_setup_s": dis["setup_s"],
            "distill_peak_gib": dis["max_memory_allocated_gib"],
            "grand_loss": dis["grand_loss"], "eval_wall_s": ev["wall_s"],
            "eval_r_mean": [r["r_mean"] for r in ev["results"]],
            "buffer_widths": buf["buffer_widths"]}
    print(f"phase 10 {encoder} + {kw['text_encoder']} at {size}^2: expert "
          f"{line['expert_images_per_s']:.1f} images/s (second epoch), peak "
          f"{line['expert_peak_gib']:.2f} GiB; distill "
          f"{line['distill_steps_per_s']:.3f} outer steps/s (second step), "
          f"set-up {line['distill_setup_s']:.1f} s, peak "
          f"{line['distill_peak_gib']:.2f} GiB; eval {ev['wall_s']:.1f} s; "
          + json.dumps(line), flush=True)
    return {"line": line, "launches": {"buffer": buf["launches"],
                                       "distill": dis["launches"],
                                       "eval": ev["launches"]}}


# (c)'s tolerances on the meta-gradients' relative error norms, s2d stem
# against the plain stem: the rewrite is exact math, so 1e-4 in float64;
# a float32 step on the card differs from itself run again by ~3e-4 in
# the pixels' meta-gradient (``plain_rerun`` below), so in float32 phase
# 4's 1e-2
S2D_GRAD_TOL = {"float64": 1e-4, "float32": 1e-2}


def s2d_compare(gc, Config, mb: int = 25, syn_steps: int = 2):
    """Phase 10 (c), first: one NFNet-L0 outer step at phase 4's size with
    the space-to-depth stem against the same step with the plain stem,
    from the same seed and weights, in float64 (``F.conv2d`` throughout:
    the kernels take bf16 and float32) and in float32 (the kernels, TF32
    off, launching phase 4's counts).  Loss 1e-5 relative, each
    meta-gradient :data:`S2D_GRAD_TOL` relative error norm.  Also printed:
    the float32 plain step against itself run again, and against the
    float64 plain step (the float32 step's own spread and error)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = (("float64", False), ("float64", True), ("float32", False),
            ("float32", False), ("float32", True))
    res, launches = {}, {}
    for dtype, on in runs:
        c = main_cfg(Config, syn_steps=syn_steps, mini_batch_size=mb,
                     inner_dtype=dtype, stem_s2d=on,
                     pallas_gconv=dtype == "float32")
        d, traj_img, traj_txt, rng = make_distiller(c)
        if d.model.image_encoder.model.stem.s2d is not on:
            raise AssertionError(f"stem_s2d={on} built the other stem")
        key = (dtype, on, "rerun") if (dtype, on) in res else (dtype, on)
        res[key], launches[(dtype, on)] = meta_grads(gc, d, traj_img,
                                                     traj_txt, rng)
        del d, traj_img, traj_txt
        torch.cuda.empty_cache()

    out = {}
    for dtype, tol in S2D_GRAD_TOL.items():
        a, b = res[(dtype, True)], res[(dtype, False)]
        r = {**rel_errors(a, b), "grad_tol": tol}
        out[dtype] = r
        print(f"phase 10 s2d {dtype} step vs the plain stem (mb={mb}, "
              f"syn_steps={syn_steps}): " + json.dumps(r), flush=True)
        if not (r["loss_rel_err"] <= 1e-5 and all(
                r[f"{k}_grad_rel_err"] <= tol for k in META_GRADS)):
            raise AssertionError(f"the s2d stem's {dtype} step differs: {r}")
    out["plain_rerun"] = rel_errors(res[("float32", False, "rerun")],
                                    res[("float32", False)])
    out["float32_vs_float64"] = rel_errors(res[("float32", False)],
                                           res[("float64", False)])
    print("phase 10 float32 plain step vs itself run again: "
          + json.dumps(out["plain_rerun"]) + "; vs the float64 step: "
          + json.dumps(out["float32_vs_float64"]), flush=True)
    zero = dict.fromkeys(KERNELS, 0)
    want = site_launches("nfnet", "float32", 8 * syn_steps, 4 * syn_steps)
    for (dtype, on), n in launches.items():
        if n != (want if dtype == "float32" else zero):
            raise AssertionError(f"s2d={on} {dtype} step launches {n}")
    out["launches"] = launches[("float32", True)]
    return out


def s2d_ab(gc, Config, pairs: int = S2D_PAIRS, steps: int = S2D_STEPS):
    """Phase 10 (c), then: the bf16 headline step (phase 3's) with the plain
    and the space-to-depth stem, one warm-up step each, then ``pairs``
    alternating pairs of ``steps`` timed outer steps (plain first in even
    pairs, s2d first in odd ones) in this one call; host clock between
    synchronizes.  Launch counters zeroed before and read after each timed
    run: phase 3's per step exactly.  -> medians, peaks, per-step times."""
    torch.backends.cudnn.allow_tf32 = True    # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for on in (False, True):
        d, traj_img, traj_txt, rng = make_distiller(
            main_cfg(Config, stem_s2d=on))
        if d.model.image_encoder.model.stem.s2d is not on:
            raise AssertionError(f"stem_s2d={on} built the other stem")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(d.step_traj(traj_img, traj_txt, 0,
                                 d.sample_indices(rng))["grand_loss"])
        torch.cuda.synchronize()
        runs[on] = {"d": d, "traj": (traj_img, traj_txt), "rng": rng,
                    "step_s": [], "losses": [loss],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    want = {k: MAIN_PATH_PER_STEP.get(k, 0) * steps for k in KERNELS}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            r = runs[on]
            gc.reset_launches()
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                m = r["d"].step_traj(*r["traj"], 0,
                                     r["d"].sample_indices(r["rng"]))
                r["losses"].append(float(m["grand_loss"]))
                torch.cuda.synchronize()
                r["step_s"].append(time.perf_counter() - t)
            if dict(gc.LAUNCHES) != want:
                raise AssertionError(f"s2d={on}: launches {gc.LAUNCHES}, "
                                     f"expected phase 3's {want}")
    out = {"pairs": pairs, "steps_per_run": steps, "launches_per_run": want}
    for on, r in runs.items():
        tag = "s2d" if on else "plain"
        if not all(math.isfinite(v) for v in r["losses"]):
            raise AssertionError(f"{tag}: grand_loss {r['losses']}")
        out[tag] = {"median_step_s": float(np.median(r["step_s"])),
                    "step_s": r["step_s"], "peak_gib": r["peak_gib"],
                    "grand_loss": r["losses"]}
    del runs
    torch.cuda.empty_cache()
    out["s2d_over_plain"] = (out["s2d"]["median_step_s"]
                             / out["plain"]["median_step_s"])
    print(f"phase 10 s2d A/B (bf16 headline step, {pairs} pairs x {steps} "
          f"steps): plain median {out['plain']['median_step_s']:.4f} s, peak "
          f"{out['plain']['peak_gib']:.2f} GiB; s2d median "
          f"{out['s2d']['median_step_s']:.4f} s, peak "
          f"{out['s2d']['peak_gib']:.2f} GiB; s2d/plain "
          f"{out['s2d_over_plain']:.4f}; " + json.dumps(out), flush=True)
    return out


def zca_path(gc, Config, size: int = 32):
    """Phase 10 (d): the distill CLI at ConvNet 32^2 with ``--zca
    --save_pt True`` (phase 9's configuration, dummy buffers from the
    student's init, 2 outer steps, the eval block's artifacts at 0):
    ``images_zca_0.pt`` read back against the fitted ZCA's
    ``inverse_transform`` of the saved ``distilled_0.npz`` pixels, 1e-5;
    launches 0."""
    from multimodal_dataset_distillation_tpu_torch.cli import distill as cli

    fitted = []
    zca_cls = cli.ZCAWhitening

    class Keep(zca_cls):
        def fit(self, images):
            fitted.append(self)
            t = time.perf_counter()
            out = super().fit(images)
            self.fit_s = time.perf_counter() - t
            return out

    cli.ZCAWhitening = Keep
    try:
        # ipc=1: the ZCA grids are among what the check reads back
        dis = zoo_distill_path(gc, Config, "convnet", size, zca=True,
                               save_pt=True, draw=True, ipc=1,
                               name="phase10_zca", buffer_path="buffers_zca")
    finally:
        cli.ZCAWhitening = zca_cls
    dis.pop("syn")
    cfg = zoo_distill_cfg(Config, "convnet", size, name="phase10_zca")
    run = os.path.join(cfg.save_dir, cfg.dataset, cfg.name)
    with np.load(os.path.join(run, "distilled_0.npz")) as z:
        image_syn = z["image_syn"]
    got = torch.load(os.path.join(run, "images_zca_0.pt"),
                     weights_only=True).numpy()
    (zca,) = fitted
    want = zca.inverse_transform(image_syn).transpose(0, 3, 1, 2)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    if not (got.shape == want.shape and err <= 1e-5):
        raise AssertionError(f"images_zca_0.pt: {got.shape}, rel err {err}")
    for name in ("zca_synthetic_images_0.png",
                 "clipped_zca_synthetic_images_0_std_2.5.png"):
        if not os.path.exists(os.path.join(run, name)):
            raise AssertionError(f"{name} missing")
    if dis["launches"] != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"zca: launches {dis['launches']}")
    line = {"encoder": "convnet", "image_size": size,
            "zca_features": int(zca.whiten.shape[0]), "zca_fit_s": zca.fit_s,
            "images_zca_rel_err": err,
            "distill_steps_per_s": dis["steps_per_s"],
            "distill_setup_s": dis["setup_s"],
            "distill_peak_gib": dis["max_memory_allocated_gib"],
            "grand_loss": dis["grand_loss"]}
    print(f"phase 10 zca (ConvNet {size}^2): fit {zca.fit_s:.1f} s on the "
          f"host, images_zca_0.pt rel err {err:.2e}; distill "
          f"{dis['steps_per_s']:.3f} outer steps/s, set-up "
          f"{dis['setup_s']:.1f} s, peak "
          f"{dis['max_memory_allocated_gib']:.2f} GiB; " + json.dumps(line),
          flush=True)
    return {"line": line, "launches": {"distill": dis["launches"]}}


def phase10(gc, Config):
    """Phase 10: (c) first (the card's memory clean), then (a) and (b) in
    one working directory each, (d) beside (b), whose caption caches it
    reads.  -> the phase's summary and its launch counts per run."""
    out = {"s2d_step": s2d_compare(gc, Config)}
    torch.cuda.empty_cache()
    out["s2d_ab"] = s2d_ab(gc, Config)
    launches = {"s2d_f32": out["s2d_step"]["launches"],
                "s2d_ab_run": out["s2d_ab"]["launches_per_run"]}
    for encoder in CLIP_ZOO:
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            r = clip_zoo_path(gc, Config, encoder)
            if encoder == "convnext":
                torch.cuda.empty_cache()
                z = zca_path(gc, Config)
                out["zca"] = z["line"]
                launches["zca_distill"] = z["launches"]["distill"]
        torch.cuda.empty_cache()
        out[encoder] = r["line"]
        for k, n in r["launches"].items():
            launches[f"{encoder}_{k}"] = n
    print(f"card: {card_line()}", flush=True)
    print("phase 10: " + json.dumps(out), flush=True)
    return out, launches


# phase 11: the meta-backward's orientations (Config.fr_bwd, fused_jvp)
FR_MODES = {"rof_fused": dict(fr_bwd="rof", fused_jvp=True),
            "rof_plain": dict(fr_bwd="rof", fused_jvp=False),
            "for": dict(fr_bwd="for")}
FR_ROUNDS = 1        # (b): rounds over the modes
FR_STEPS = 1         # (b): timed outer steps per mode and round
FR_F64_TOL = 1e-9    # (a): relative error norms in float64
# cuDNN kernels of the stems' second-order convs (PERF.md section 5)
DOUBLE_BACKWARD_KERNELS = ("precomputed_convolve_sgemm",
                           "implicit_convolve_sgemm")


def rof_vs_ror(fn, *xs):
    """(grad-of-jvp, reverse-over-reverse) gradients of the directional
    derivative of the scalar ``fn`` at ``xs`` in a seeded direction."""
    import torch.autograd.forward_ad as fwAD

    gen = torch.Generator(device=xs[0].device).manual_seed(3)
    vs = [torch.randn(x.shape, generator=gen, device=x.device,
                      dtype=x.dtype) for x in xs]
    a = [x.clone().requires_grad_() for x in xs]
    with fwAD.dual_level():
        h = fwAD.unpack_dual(
            fn(*[fwAD.make_dual(t, v) for t, v in zip(a, vs)])).tangent
    rof = torch.autograd.grad(h, a, allow_unused=True)
    b = [x.clone().requires_grad_() for x in xs]
    g = torch.autograd.grad(fn(*b), b, create_graph=True, allow_unused=True)
    ror = torch.autograd.grad(sum((gi * v).sum() for gi, v in zip(g, vs)
                                  if gi is not None), b, allow_unused=True)
    return rof, ror


def forward_ad_forms(dev: str = "cuda"):
    """Phase 11 (a), first: the ops the grad-of-jvp meta-backward must not
    reach on their fused forms, on this card's torch in float64:
    ``F.layer_norm`` (wrong second derivatives without an error on the
    build host's torch), ``log_softmax`` (raises there) and ``F.group_norm``
    on a channels-last input (raises there), each beside the port's form,
    which must match reverse-over-reverse to 1e-12 of the largest value.
    -> {op: relative error or the error's text}."""
    from multimodal_dataset_distillation_tpu_torch.models.layers import (
        GroupNorm, layer_norm)
    from multimodal_dataset_distillation_tpu_torch.ops.contrastive import (
        log_softmax)

    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(3, 5, 6, device=dev, dtype=f64, generator=gen)
    xc = torch.randn(2, 6, 3, 3, device=dev, dtype=f64,
                     generator=gen).contiguous(
                         memory_format=torch.channels_last)
    wb = [torch.randn(6, device=dev, dtype=f64, generator=gen)
          for _ in range(2)]
    ln = torch.nn.LayerNorm(6, eps=1e-5)
    gn = GroupNorm(2, 6, eps=1e-6).to(dev, f64)

    class LN:   # a LayerNorm's settings with other weight and bias
        def __init__(self, w, b):
            self.normalized_shape, self.eps = ln.normalized_shape, ln.eps
            self.weight, self.bias = w, b

    def s(y):
        return torch.sin(y).sum()

    ln_in, gn_in = [x] + wb, [xc] + wb
    cases = {   # name: (scalar function, its inputs, the port's form)
        "F.layer_norm": (lambda t, w, b: s(F.layer_norm(t, (6,), w, b,
                                                        1e-5)), ln_in, False),
        "port layer_norm": (lambda t, w, b: s(layer_norm(t, LN(w, b))),
                            ln_in, True),
        "Tensor.log_softmax": (lambda t: s(t.log_softmax(-1)), [x], False),
        "port log_softmax": (lambda t: s(log_softmax(t, -1)), [x], True),
        "F.group_norm channels-last": (lambda t, w, b: s(F.group_norm(
            t, 2, w, b, 1e-6)), gn_in, False),
        "port GroupNorm channels-last": (
            lambda t, w, b: s(torch.func.functional_call(
                gn, {"weight": w, "bias": b}, (t,))), gn_in, True),
    }
    out = {}
    for name, (fn, xs, port) in cases.items():
        try:
            rof, ror = rof_vs_ror(fn, *xs)
            out[name] = max(float((a - b).abs().max() / b.abs().max())
                            for a, b in zip(rof, ror) if b is not None)
        except RuntimeError as e:
            out[name] = f"raises: {str(e)[:80]}"
        if port and not (isinstance(out[name], float)
                         and out[name] <= 1e-12):
            raise AssertionError(f"{name} under grad-of-jvp: {out[name]}")
    print("phase 11 forward-AD forms vs reverse-over-reverse (float64, "
          "relative): " + json.dumps(out), flush=True)
    return out


def fr_compare(gc, Config, size: int = 64, mb: int = 4, syn_steps: int = 2):
    """Phase 11 (a): NFNet-L0 (full width) at ``size``^2 in float64 on
    ``F.conv2d`` throughout (the kernels take bf16 and float32; check_hvp
    holds their forward-mode rules): each mode of :data:`FR_MODES` against
    ``hvp_mode="reverse"`` and against each other, loss and every
    meta-gradient within :data:`FR_F64_TOL` relative; no kernel launched.
    Then the float32 step at phase 4's size with the kernels in each mode
    against the same mode on ``F.conv2d`` (TF32 off) at phase 4's
    tolerances, launching phase 4's counts (:func:`compare_f32`; the
    default mode's is phase 4 itself)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    forms = forward_ad_forms()
    res = {}
    zero = dict.fromkeys(KERNELS, 0)
    for mode in ("reverse", *FR_MODES):
        kw = FR_MODES.get(mode, {"hvp_mode": "reverse"})
        c = main_cfg(Config, image_size=size, mini_batch_size=mb,
                     syn_steps=syn_steps, inner_dtype="float64",
                     pallas_gconv=False, **kw)
        res[mode], launches = meta_grads(gc, *make_distiller(c))
        if launches != zero:
            raise AssertionError(f"float64 {mode} step launched {launches}")
        torch.cuda.empty_cache()
    out = {"forms": forms, "float64": {}}
    names = list(res)
    for i, a in enumerate(names[1:], 1):
        for b in names[:i]:
            r = rel_errors(res[a], res[b])
            out["float64"][f"{a}_vs_{b}"] = r
            if not all(v <= FR_F64_TOL for k, v in r.items()
                       if k.endswith("rel_err")):
                raise AssertionError(f"float64 {a} vs {b}: {r}")
    print(f"phase 11 (a) float64 NFNet-L0 at {size}^2 (mb={mb}, syn_steps="
          f"{syn_steps}), modes against each other and the reverse unroll: "
          + json.dumps(out["float64"]), flush=True)
    out["float32"] = {}
    for mode, kw in FR_MODES.items():
        if mode != "rof_fused":   # phase 4 is the default mode's
            out["float32"][mode] = compare_f32(gc, main_cfg(Config, **kw))
            torch.cuda.empty_cache()
    return out


def profile_step(step) -> dict:
    """Run ``step()`` under ``torch.profiler`` (host and card) -> its
    device ms and kernel launches in all, the device ms of each of
    :data:`DOUBLE_BACKWARD_KERNELS` and the count of
    ``aten::_convolution_double_backward`` calls.  Reads the profiler's
    raw event list: building its Python event tree takes ~70 us per
    event, minutes for the ~10^6 events of a headline step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels, calls = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            kernels.append((e.name(), e.duration_ns() / 1e6))
        elif e.name() == "aten::_convolution_double_backward":
            calls += 1
    return {"profiled_device_ms": sum(t for _, t in kernels),
            "profiled_launches": len(kernels),
            "double_backward_calls": calls,
            **{f"{k}_ms": sum(t for n, t in kernels if k in n)
               for k in DOUBLE_BACKWARD_KERNELS}}


def fr_ab(gc, Config, rounds: int = FR_ROUNDS, steps: int = FR_STEPS):
    """Phase 11 (b) and (c): the bf16 headline step (phase 3's) in each
    mode of :data:`FR_MODES`, one warm-up step each, then ``rounds``
    rounds over the modes (rotated each round) of ``steps`` timed outer
    steps; host clock between synchronizes, peaks from a reset before each
    timed run.  Launch counters zeroed before and read after each timed
    run: phase 3's per step exactly.  Then one profiled step per mode
    (``torch.profiler``): device ms of the stems' double-backward cuDNN
    kernels (:data:`DOUBLE_BACKWARD_KERNELS`), the count of
    ``aten::_convolution_double_backward`` calls, device ms and launches
    in all.  -> medians, ranges, peaks, per-step times, profiles."""
    torch.backends.cudnn.allow_tf32 = True    # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for mode, kw in FR_MODES.items():
        d, traj_img, traj_txt, rng = make_distiller(main_cfg(Config, **kw))
        torch.cuda.synchronize()
        loss = float(d.step_traj(traj_img, traj_txt, 0,
                                 d.sample_indices(rng))["grand_loss"])
        runs[mode] = {"d": d, "traj": (traj_img, traj_txt), "rng": rng,
                      "step_s": [], "losses": [loss], "peaks_gib": []}
    want = {k: MAIN_PATH_PER_STEP.get(k, 0) * steps for k in KERNELS}
    order = list(FR_MODES)
    for i in range(rounds):
        for mode in order[i % len(order):] + order[:i % len(order)]:
            r = runs[mode]
            gc.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                m = r["d"].step_traj(*r["traj"], 0,
                                     r["d"].sample_indices(r["rng"]))
                r["losses"].append(float(m["grand_loss"]))
                torch.cuda.synchronize()
                r["step_s"].append(time.perf_counter() - t)
            r["peaks_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            if dict(gc.LAUNCHES) != want:
                raise AssertionError(f"{mode}: launches {gc.LAUNCHES}, "
                                     f"expected phase 3's {want}")
    out = {"rounds": rounds, "steps_per_run": steps,
           "launches_per_run": want}
    for mode, r in runs.items():
        if not all(math.isfinite(v) for v in r["losses"]):
            raise AssertionError(f"{mode}: grand_loss {r['losses']}")
        prof = profile_step(lambda: r["d"].step_traj(
            *r["traj"], 0, r["d"].sample_indices(r["rng"])))
        out[mode] = {
            "median_step_s": float(np.median(r["step_s"])),
            "min_step_s": min(r["step_s"]), "max_step_s": max(r["step_s"]),
            "step_s": r["step_s"], "peak_gib": max(r["peaks_gib"]),
            "grand_loss": r["losses"], **prof}
    del runs
    torch.cuda.empty_cache()
    for mode in FR_MODES:
        o = out[mode]
        print(f"phase 11 (b)/(c) {mode}: median {o['median_step_s']:.4f} s "
              f"({o['min_step_s']:.4f}-{o['max_step_s']:.4f}), peak "
              f"{o['peak_gib']:.2f} GiB; profiled step: device "
              f"{o['profiled_device_ms']:.1f} ms, "
              f"{o['profiled_launches']} launches, "
              + ", ".join(f"{k} {o[k + '_ms']:.1f} ms"
                          for k in DOUBLE_BACKWARD_KERNELS)
              + f", {o['double_backward_calls']} "
                f"_convolution_double_backward calls", flush=True)
    print("phase 11 (b)/(c): " + json.dumps(out), flush=True)
    return out


def phase11(gc, Config):
    """Phase 11: (a) the orientations' agreement, then (b)/(c) their times
    and profiles on the headline step.  -> the summary and its launch
    counts per run."""
    out = {"compare": fr_compare(gc, Config)}
    torch.cuda.empty_cache()
    out["ab"] = fr_ab(gc, Config)
    launches = {f"f32_{mode}": r["launches"]
                for mode, r in out["compare"]["float32"].items()}
    launches["headline_run"] = out["ab"]["launches_per_run"]
    print(f"card: {card_line()}", flush=True)
    return out, launches


# phase 12 (a): the quality rehearsal's recipe (tools/torch_quality_roco.sh)
# at smoke depth, its flags as the recipe passes them
ROCO_ROWS = 256
ROCO_FLAGS = ["--dataset=roco", "--text_encoder=bert",
              "--text_encoder_config=tiny", "--image_size=32",
              "--batch_size_test=32", "--disable_wandb", "True",
              "--image_encoder=convnet"]
ROCO_ITERS = 20
AUG_TOL = 1e-4      # (c): relative error norm, card against the CPU


def roco_smoke_path(gc, Config, work: str) -> dict:
    """Phase 12 (a): ``tools/torch_make_fixtures.py roco`` at 256 rows,
    then in ``work`` ``cli.buffer_roco`` (1 expert x 2 epochs),
    ``cli.distill`` (20 iterations, eval blocks of 2 students at 0 and 20)
    and ``cli.eval_distilled`` (2 students) on the card, with the recipe's
    flags (ConvNet 32^2, BERT tiny).  Counters zeroed just before the CLIs
    and read just after: ConvNet has no grouped conv, so 0 launches.
    Every ``Grand_Loss`` finite, every metric in [0, 100],
    ``distilled_20.npz`` readable at the set's shape."""
    from multimodal_dataset_distillation_tpu_torch.cli import (
        buffer_roco, distill as dcli, eval_distilled as ecli)
    from multimodal_dataset_distillation_tpu_torch.config import parse_config

    fixture = os.path.join(work, "fixture")
    subprocess.run([sys.executable, str(HERE / "tools" /
                                        "torch_make_fixtures.py"), "roco",
                    fixture, str(ROCO_ROWS)], check=True)
    flags = ROCO_FLAGS + [f"--image_root={fixture}/images",
                          f"--ann_root={fixture}/radiologytraindata.csv"]
    out = {}
    with contextlib.chdir(work):
        torch.cuda.synchronize()
        gc.reset_launches()
        t0 = time.perf_counter()
        saved = buffer_roco.main(parse_config(flags + [
            "--num_experts=1", "--train_epochs=2", "--batch_size_train=32",
            "--buffer_path=./buffers", "--lr_teacher_img=0.1",
            "--lr_teacher_txt=0.1"], defaults=buffer_roco.DEFAULTS))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        distill_flags = flags + [
            "--num_queries=16", "--mini_batch_size=16", "--syn_steps=4",
            "--expert_epochs=2", "--max_start_epoch=1",
            f"--Iteration={ROCO_ITERS}", f"--eval_it={ROCO_ITERS}",
            "--num_eval=2", "--epoch_eval_train=4", "--batch_train=16",
            "--buffer_path=./buffers/roco/convnet/bert",
            "--save_dir=./logged_files", "--draw", "True", "--lr_img=10",
            "--lr_txt=10", "--lr_lr=1e-6"]
        distiller, history = dcli.main(parse_config(distill_flags))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cfg = distiller.cfg
        npz, = glob.glob(os.path.join(cfg.save_dir, "roco", "*",
                                      f"distilled_{ROCO_ITERS}.npz"))
        results = ecli.main(parse_config(flags + [
            f"--distilled_npz={npz}", "--num_eval=2", "--epoch_eval_train=4",
            "--batch_train=16", "--std", "True", "--parallel_eval", "False"]),
            argv=[])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = dict(gc.LAUNCHES)
        with np.load(npz) as z:
            shapes = (z["image_syn"].shape, z["text_syn"].shape)
        losses = [r["Grand_Loss"] for path in sorted(os.listdir(
            cfg.save_dir)) if path.endswith(".jsonl")
            for r in map(json.loads, open(os.path.join(cfg.save_dir, path)))
            if "Grand_Loss" in r]
    if saved != [0]:
        raise AssertionError(f"phase 12 (a): buffer_roco saved {saved}")
    if shapes != ((16, 32, 32, 3), (16, 128)):
        raise AssertionError(f"phase 12 (a): distilled set {shapes}")
    if len(losses) != ROCO_ITERS + 1 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"phase 12 (a): Grand_Loss {losses}")
    evals = [r for _, rs in history for r in rs] + list(results)
    if [it for it, _ in history] != [0, ROCO_ITERS] or len(evals) != 6 or \
            not all(math.isfinite(v) and 0.0 <= v <= 100.0
                    for r in evals for v in r.values()):
        raise AssertionError(f"phase 12 (a): metrics {history} {results}")
    if any(launches.values()):
        raise AssertionError(f"phase 12 (a): launches {launches}, expected "
                             f"none (ConvNet has no grouped conv)")
    out = {"buffer_s": t1 - t0, "distill_s": t2 - t1, "eval_s": t3 - t2,
           "grand_loss_first_last": [losses[0], losses[-1]],
           "r_mean_eval": [r["r_mean"] for r in results],
           "launches": launches}
    print("phase 12 (a) ROCO fixture through the three CLIs: "
          + json.dumps(out), flush=True)
    return out


def legacy_pt_path(gc, Config, work: str) -> dict:
    """Phase 12 (b): phase 3's 2-snapshot expert segment written as a
    ``.pt`` buffer the way the JAX package's writers before round 4 did
    (every leaf through ``ascontiguousarray``, so the 0-d skipinit gains
    are ``(1,)``), read back through ``ExpertCycler``, equal to the
    segment, and fed to one headline NFNet-L0 outer step; counters zeroed
    just before the step and read just after: phase 3's per step."""
    from multimodal_dataset_distillation_tpu_torch.engine.distill import (
        ExpertCycler)
    from multimodal_dataset_distillation_tpu_torch.utils.flat import (
        FlatParams)

    cfg = main_cfg(Config)
    d, traj_img, traj_txt, rng = make_distiller(cfg)
    files, promoted = [], 0
    for kind, traj, tower in (("img", traj_img, d.model.image_encoder),
                              ("txt", traj_txt, d.model.text_projection)):
        layout = FlatParams(tower)
        snaps = [[torch.from_numpy(np.ascontiguousarray(t.numpy()))
                  for t in layout.unflatten(flat).values()]
                 for flat in traj.cpu()]
        promoted += sum(t.shape == (1,) and s == () for t, s in
                        zip(snaps[0], layout.shapes))
        files.append(os.path.join(work, f"{kind}_replay_buffer_0.pt"))
        torch.save([snaps], files[-1])
    if promoted == 0:
        raise AssertionError("phase 12 (b): no 0-d leaf was promoted")
    cyc = ExpertCycler(files[:1], files[1:], 1, 1, d.model.image_encoder,
                       d.model.text_projection, seed=0, device=d.device)
    ti, tt, start = cyc.next_segment_device()
    if not (torch.equal(ti, traj_img) and torch.equal(tt, traj_txt)):
        raise AssertionError("phase 12 (b): the legacy .pt read back "
                             "differs from the segment written")
    torch.cuda.synchronize()
    gc.reset_launches()
    t0 = time.perf_counter()
    loss = float(d.step_traj(ti, tt, start, d.sample_indices(rng))[
        "grand_loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(gc.LAUNCHES)
    cyc.close()
    want = {k: MAIN_PATH_PER_STEP.get(k, 0) for k in launches}
    if launches != want or not math.isfinite(loss):
        raise AssertionError(f"phase 12 (b): loss {loss}, launches "
                             f"{launches}, expected {want}")
    out = {"promoted_leaves": promoted, "grand_loss": loss,
           "step_s": step_s, "launches": launches}
    print("phase 12 (b) legacy .pt buffer -> headline step: "
          + json.dumps(out), flush=True)
    return out


def diffaug_compare(n: int = 100, size: int = 224) -> dict:
    """Phase 12 (c): each DSA op's apply and the ``'M'`` dispatcher over
    every family on an ``n`` x ``size``^2 float32 NHWC batch on the card
    against the same call on the CPU with the same draws (a CPU
    generator): relative error norm under ``AUG_TOL``, and a finite,
    non-zero pixel gradient on the card."""
    from multimodal_dataset_distillation_tpu_torch.ops import diffaug

    p = diffaug.ParamDiffAug()
    x = torch.randn((n, size, size, 3),
                    generator=torch.Generator().manual_seed(12))
    xg = x.cuda()
    calls = {name: (lambda v, k=k, apply=apply, u=diffaug.uniforms(
        k, n, torch.Generator().manual_seed(i), False):
        apply(v, u.to(v.device), p))
        for i, (name, (k, apply)) in enumerate(diffaug.OPS.items())}
    strategy = "color_crop_cutout_flip_scale_rotate"
    pm = diffaug.ParamDiffAug(aug_mode="M")
    calls["diff_augment_M"] = lambda v: diffaug.diff_augment(
        v, strategy, torch.Generator().manual_seed(99), pm)
    out = {}
    for name, fn in calls.items():
        want = fn(x)
        v = xg.clone().requires_grad_()
        got = fn(v)
        err = float((got.detach().cpu() - want).norm() / want.norm())
        (got ** 2).sum().backward()
        gnorm = float(v.grad.norm())
        if not err <= AUG_TOL or not (math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"phase 12 (c) {name}: relative error "
                                 f"{err:.3e} (limit {AUG_TOL}), gradient "
                                 f"norm {gnorm}")
        out[name] = err
    print(f"phase 12 (c) diff_augment at {n}x{size}^2, card vs CPU, "
          "relative error norm: " + json.dumps(out), flush=True)
    return out


def phase12(gc, Config):
    """Phase 12: (a) the ROCO fixture through the three CLIs, (b) a legacy
    ``.pt`` buffer into the headline step, (c) DSA on the card against the
    CPU, (d) each part's wall seconds.  -> the summary and its launch
    counts per run."""
    out, secs = {}, {}
    for part, fn in (("a", lambda w: roco_smoke_path(gc, Config, w)),
                     ("b", lambda w: legacy_pt_path(gc, Config, w)),
                     ("c", lambda w: diffaug_compare())):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as work:
            out[part] = fn(work)
        torch.cuda.synchronize()
        secs[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 12 (d) seconds per part: " + json.dumps(secs), flush=True)
    return out, {"roco_smoke": out["a"]["launches"],
                 "legacy_pt_step": out["b"]["launches"]}


# phase 13: data parallelism across ranks (parallel/mesh.py).  Two ranks:
# on one card they share it over gloo (NCCL refuses two ranks on one
# device), asked for explicitly; with two or more cards one rank per card
# over NCCL.  The ranks are this script run again with DP_RANK_ARG.
DP_WORLD = 2
DP_RANK_ARG = "--phase13-rank"
DP_TIMEOUT = 600     # seconds for the ranks' whole run
DP_F32 = dict(syn_steps=2, mini_batch_size=25, inner_dtype="float32",
              shard_syn=True)   # (a): phase 4's step; 25 pads to 26
DP_STEPS = 1         # (b): timed headline steps after a warm-up


def dp_plan() -> dict:
    """-> the backend, whether the ranks share one card, and the launch
    environment of each rank (torchrun's variables)."""
    import socket

    share = torch.cuda.device_count() < DP_WORLD
    with socket.socket() as sk:   # a free port on this machine
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    envs = []
    for r in range(DP_WORLD):
        env = dict(os.environ, WORLD_SIZE=str(DP_WORLD), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(DP_WORLD),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env.pop("MDD_DIST_BACKEND", None)
        if share:
            env["MDD_DIST_BACKEND"] = "gloo"
        envs.append(env)
    return {"backend": "gloo" if share else "nccl", "share": share,
            "envs": envs}


def dp_spawn(work: str, job: dict) -> list:
    """Run ``job``'s parts on :data:`DP_WORLD` ranks; -> each rank's
    results.  A rank that fails or outlives :data:`DP_TIMEOUT` fails the
    phase; every rank is stopped before this returns."""
    plan = dp_plan()
    print(f"phase 13: {DP_WORLD} ranks, backend {plan['backend']} ("
          + ("sharing the one card: gloo asked for explicitly" if plan["share"]
             else "one card each") + ")", flush=True)
    path = os.path.join(work, "phase13_job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    logs = [open(os.path.join(work, f"phase13_rank{r}.log"), "w+")
            for r in range(DP_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), DP_RANK_ARG, path],
        env=env, cwd=str(HERE), stdout=log, stderr=subprocess.STDOUT)
        for env, log in zip(plan["envs"], logs)]
    deadline = time.time() + DP_TIMEOUT
    try:   # until all end, one fails (the others would wait on it) or time
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.time() < deadline):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    for r, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines():
            if line.startswith(("[rank", "Device mesh", "phase 13")):
                print(f"  rank {r}: {line}", flush=True)
        if p.returncode != 0:
            raise AssertionError(f"phase 13 rank {r} exited "
                                 f"{p.returncode}:\n{text[-6000:]}")
    out = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"phase13_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def dp_step_f32(gc, Config, mesh, job) -> dict:
    """(a): phase 4's float32 step (the TF32 kernels, TF32 off elsewhere)
    with --shard_syn on, its meta-gradients read from the update of the
    sharded rows (:func:`meta_grads`); rank 0 saves them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d, *inputs = make_distiller(main_cfg(Config, **DP_F32), mesh=mesh)
    res, launches = meta_grads(gc, d, *inputs)
    if mesh.rank == 0:
        torch.save(on_host(res), job["f32_path"])
    torch.backends.cudnn.allow_tf32 = True
    return {"launches": launches, "pad": d._inner_pad,
            "rows": list(d._slots)}


def dp_headline(gc, Config, mesh, job) -> dict:
    """(b): the bf16 headline step at full width, a warm-up step and
    :data:`DP_STEPS` timed steps; counters read around the timed ones."""
    from multimodal_dataset_distillation_tpu_torch.parallel import (
        collectives as col)

    d, traj_img, traj_txt, rng = make_distiller(main_cfg(Config), mesh=mesh)
    d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))
    torch.cuda.synchronize()
    col.barrier(mesh)
    torch.cuda.reset_peak_memory_stats()
    gc.reset_launches()
    t0 = time.perf_counter()
    losses = [d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))[
        "grand_loss"] for _ in range(DP_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gc.LAUNCHES)
    return {"launches": launches, "steps_per_s": DP_STEPS / wall,
            "losses": [float(v) for v in losses],
            "loss_bits": [float(v).hex() for v in losses],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def dp_distill_cli(gc, Config, mesh, job) -> dict:
    """(c): the distill CLI on the ranks for 2 iterations on phase 7
    (a)'s buffers, a checkpoint at iteration 1; launches of its 2
    steps."""
    from multimodal_dataset_distillation_tpu_torch.cli import distill as cli

    with contextlib.chdir(job["small_dir"]):
        gc.reset_launches()
        cli.main(distill_cli_cfg(Config, **job["cli"]))
        torch.cuda.synchronize()
    return {"launches": dict(gc.LAUNCHES)}


def dp_buffer_cli(gc, Config, mesh, job) -> dict:
    """(d): the buffer CLI on the ranks, 1 expert x 1 epoch on 256 pairs."""
    from multimodal_dataset_distillation_tpu_torch.cli import buffer as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    with contextlib.chdir(job["small_dir"]):
        gc.reset_launches()
        saved = cli.main(expert_cfg(Config, "a", **job["buffer"]))
        torch.cuda.synchronize()
    return {"launches": dict(gc.LAUNCHES), "saved": saved}


DP_PARTS = {"a": dp_step_f32, "b": dp_headline, "c": dp_distill_cli,
            "d": dp_buffer_cli}


def dp_rank_main(job_path: str) -> int:
    """A rank of phase 13: join the ranks (torchrun's environment), run
    the job's parts, write ``phase13_rank{r}.json`` beside the job."""
    exit_with_parent()
    sys.path.insert(0, str(HERE))
    import torch.distributed as dist

    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.ops import gconv as gc
    from multimodal_dataset_distillation_tpu_torch.parallel.mesh import (
        get_mesh)

    with open(job_path) as f:
        job = json.load(f)
    # the ranks share the host's cores (CPU-side set-up: inits, data)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DP_WORLD))
    gc.build()
    mesh = get_mesh(device="cuda")
    print(f"[rank {mesh.rank}] world {mesh.world}, backend {mesh.backend}, "
          f"device {mesh.device}", flush=True)
    out = {}
    for part in job["parts"]:
        t0 = time.perf_counter()
        out[part] = DP_PARTS[part](gc, Config, mesh, job)
        torch.cuda.synchronize()
        out[part]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"phase 13 ({part}) rank {mesh.rank}: "
              f"{json.dumps(out[part])}", flush=True)
    with open(os.path.join(os.path.dirname(job_path),
                           f"phase13_rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase13(gc, Config, buffers_dir: str, small_dir: str,
            phase3_steps_per_s: float) -> tuple:
    """Phase 13: data parallelism over :data:`DP_WORLD` ranks.  (a) phase
    4's float32 step on the ranks (mb=25 pads to 26, --shard_syn) against
    the one-process step on the same inputs, phase 4's tolerances (loss
    1e-3, meta-gradients 1e-2 relative error norm); (b) the bf16 headline
    step, each rank's losses bit for bit the other's and its launches
    phase 3's per step, outer steps/s and each rank's peak; (c) the distill
    CLI on the ranks for 2 iterations on phase 7's buffers with a
    checkpoint, resumed at world 1 for one step; (d) the buffer CLI on the
    ranks (1 expert x 1 epoch, 256 pairs) against a one-rank run on the
    same global batches, phase 7's tolerance (1e-4 relative error norm of
    each snapshot of each tower).  -> the summary, launch counts."""
    from multimodal_dataset_distillation_tpu_torch.cli import buffer as bcli
    from multimodal_dataset_distillation_tpu_torch.cli import distill as dcli
    from multimodal_dataset_distillation_tpu_torch.engine.buffer_io import (
        load_trajectory_npz)

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="phase13_")
    # (c) reads phase 7 (a)'s buffers from the small runs' directory,
    # whose caption caches hold 256 pairs
    cli_kw = dict(Iteration=1, num_eval=0, ckpt_it=1, draw=False,
                  name="phase13c", save_dir="logged_files_dp",
                  synthetic_size=256, synthetic_test_size=256,
                  buffer_path=os.path.join(buffers_dir, "buffers"))
    buf_kw = dict(_SMALL, name="phase13d")
    job = {"parts": list(DP_PARTS), "buffers_dir": buffers_dir,
           "small_dir": small_dir, "cli": cli_kw,
           "buffer": dict(buf_kw, buffer_path="buffers_dp"),
           "f32_path": os.path.join(work, "f32.pt")}
    # (a)'s one-process step, on the same inputs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    one = on_host(meta_grads(gc, *make_distiller(
        main_cfg(Config, **DP_F32)))[0])
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    ranks = dp_spawn(work, job)
    t_ranks = time.perf_counter() - t0 - t_ref
    out = {"world": DP_WORLD, "backend": dp_plan()["backend"],
           "reference_s": t_ref, "ranks_s": t_ranks}
    # (a)
    want = site_launches("nfnet", "float32", 8 * DP_F32["syn_steps"],
                         4 * DP_F32["syn_steps"])
    two = torch.load(job["f32_path"])
    a = {"pad": ranks[0]["a"]["pad"],
         "rows": [r["a"]["rows"] for r in ranks],
         "launches": [r["a"]["launches"] for r in ranks],
         **rel_errors(two, one)}
    if not (a["loss_rel_err"] <= 1e-3
            and all(a[f"{k}_grad_rel_err"] <= 1e-2 for k in META_GRADS)
            and all(n == want for n in a["launches"]) and a["pad"] == 1):
        raise AssertionError(f"phase 13 (a): {a}; launches expected {want}")
    out["a"] = a
    # (b)
    want = {k: n * DP_STEPS for k, n in MAIN_PATH_PER_STEP.items()}
    b = {"steps_per_s": [r["b"]["steps_per_s"] for r in ranks],
         "peak_gib": [r["b"]["peak_gib"] for r in ranks],
         "losses": [r["b"]["losses"] for r in ranks],
         "launches": [r["b"]["launches"] for r in ranks],
         "phase3_steps_per_s": phase3_steps_per_s}
    if (len({tuple(r["b"]["loss_bits"]) for r in ranks}) != 1
            or not all(math.isfinite(v) for v in b["losses"][0])
            or any({k: n for k, n in la.items() if n} != want
                   for la in b["launches"])):
        raise AssertionError(f"phase 13 (b): {b}; launches expected {want}")
    out["b"] = b
    # (c): the ranks' 2 steps, then the checkpoint at world 1, one step
    cfg = distill_cli_cfg(Config, **cli_kw)
    want = {k: n * 2 for k, n in MAIN_PATH_PER_STEP.items()}
    run_dir = os.path.join(small_dir, cfg.save_dir, cfg.dataset, cfg.name)
    ckpt = os.path.join(run_dir, "distill_ckpt_1.pt")
    with contextlib.chdir(small_dir):
        with open(os.path.join(cfg.save_dir, f"{cfg.name}.jsonl")) as f:
            two_losses = [r["Grand_Loss"] for r in map(json.loads, f)
                          if "Grand_Loss" in r]
        gc.reset_launches()
        distiller, _ = dcli.main(cfg.replace(Iteration=2, resume_from=ckpt))
        torch.cuda.synchronize()
        resumed = dict(gc.LAUNCHES)
        with open(os.path.join(cfg.save_dir, f"{cfg.name}.jsonl")) as f:
            all_losses = [r["Grand_Loss"] for r in map(json.loads, f)
                          if "Grand_Loss" in r]
    c = {"losses_two_ranks": two_losses, "losses_resumed": all_losses[2:],
         "launches": [r["c"]["launches"] for r in ranks],
         "launches_resumed": resumed}
    if not (len(two_losses) == 2 and len(all_losses) == 3
            and all(math.isfinite(v) for v in all_losses)
            and all({k: n for k, n in la.items() if n} == want
                    for la in c["launches"])
            and {k: n for k, n in resumed.items() if n}
            == dict(MAIN_PATH_PER_STEP)
            and torch.isfinite(distiller.state.image_syn).all()):
        raise AssertionError(f"phase 13 (c): {c}")
    del distiller
    torch.cuda.empty_cache()
    out["c"] = c
    # (d): the one-rank run on the same global batches
    cfg = expert_cfg(Config, "a", **buf_kw)
    torch.backends.cuda.matmul.allow_tf32 = False
    with contextlib.chdir(small_dir):
        bcli.main(cfg.replace(buffer_path="buffers_dp1"))
        d_err = {}
        for kind in ("img", "txt"):
            one_b, two_b = (load_trajectory_npz(os.path.join(
                bcli.expert_dir(cfg.replace(buffer_path=bp)),
                f"{kind}_replay_buffer_0.npz"))
                for bp in ("buffers_dp1", "buffers_dp"))
            d_err[kind] = [float(np.linalg.norm(x - y) / np.linalg.norm(y))
                           for x, y in zip(two_b, one_b)]
    dl = [r["d"]["launches"] for r in ranks]
    full = expert_launches(cfg)
    train = site_launches("nfnet", "float32", 2 * (256 // 128), 256 // 128)
    dd = {"rel_err": d_err, "launches": dl,
          "saved": [r["d"]["saved"] for r in ranks]}
    if not (all(e <= 1e-4 for v in d_err.values() for e in v)
            and dd["saved"] == [[0], []]
            and {k: n for k, n in dl[0].items() if n}
            == {k: n for k, n in full.items() if n}
            and {k: n for k, n in dl[1].items() if n}
            == {k: n for k, n in train.items() if n}):
        raise AssertionError(f"phase 13 (d): {dd}")
    out["d"] = dd
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 13: {DP_WORLD} ranks ({out['backend']}): headline "
          f"{b['steps_per_s']} outer steps/s per rank (phase 3's one "
          f"process: {phase3_steps_per_s:.4f}), peaks {b['peak_gib']} GiB; "
          f"card {card_line()}", flush=True)
    print("phase 13: " + json.dumps(out), flush=True)
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    launches = {"f32_step_rank0": a["launches"][0],
                "headline_rank0": b["launches"][0],
                "distill_cli_rank0": c["launches"][0],
                "distill_cli_resumed": resumed,
                "buffer_cli_rank0": dl[0], "buffer_cli_rank1": dl[1]}
    return out, launches


# phase 14: NFNet-L0 at timm nfnet_l0's test resolution (288^2), float32:
# the stage-1 sites are 36 wide, past the TF32 wgrad's 32
SIZE_288 = 288
RUN_288 = dict(_SMALL, image_size=SIZE_288, device_augment=False,
               buffer_path="buffers_288", name="phase14")
SYN_288 = 100        # the eval CLI's distilled pairs, drawn from the seed


def check_kernels_288(gc):
    """Phase 14, first: the generic kernels (``tc=False``) at the 288^2
    stage-1 shape (36^2 x 128, 2 groups of 64) in both dtypes at the eval
    students' and the expert trainer's mini-batches against the plain
    versions at phase 2's tolerances, the wgrad twice for the same bits;
    then a stage-1 pass at mini-batch 100 in float32 timed: the generic
    forward and wgrad, the TF32 forward (the path's forward there), the
    plain version and cuDNN (TF32 off and on), beside the bound."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(14)
    h, c, groups = SIZE_288 // 8, 128, 2
    cpg = c // groups
    w32 = torch.randn(3, 3, cpg, c, device="cuda",
                      generator=gen) / math.sqrt(9 * cpg)
    row = {"shape": [BATCH, h, h, c], "groups": groups,
           "sites": NFNET_STRIDES[8]}
    routes = ((torch.float32, "generic"), (torch.bfloat16, "generic"))
    for batch in (BATCH, 128):
        x32, yb32 = (torch.randn(batch, h, h, c, device="cuda", generator=gen)
                     for _ in range(2))
        print(f"288^2 stage-1 shape x=({batch},{h},{h},{c}) groups={groups}",
              flush=True)
        check_shape(gc, row, x32, w32, yb32, groups, routes)
        if batch == BATCH:
            time_row(gc, row, x32, w32, yb32, groups,
                     {"fwd": ("generic", "tf32"), "wgrad": ("generic",)},
                     "_f32", PEAK_FP32)
        del x32, yb32
    return [row]


def phase14(gc, Config, work: str, rows: list) -> tuple:
    """Phase 14: the 288^2 path (its kernel checks, ``rows`` of
    :func:`check_kernels_288`, run alone before phase 3): the buffer CLI
    (``RUN_288``) in ``work`` and the eval CLI on a seeded set, each with
    its launches held exactly to :func:`expert_launches` /
    :func:`eval_launches` (the rule's route per site width), and both with
    the stage-1 wgrads on the generic kernel and no generic forward.  ->
    (the phase's summary, its launches per run)."""
    with contextlib.chdir(work):
        buf = expert_path(gc, Config, "288", **RUN_288)
    torch.cuda.empty_cache()
    rs = np.random.RandomState(SIZE_288)
    syn = (rs.randn(SYN_288, SIZE_288, SIZE_288, 3).astype(np.float32),
           rs.randn(SYN_288, 768).astype(np.float32), 0.01, 0.01)
    ev = eval_path(gc, Config, syn, image_size=SIZE_288, num_eval=2,
                   synthetic_test_size=256)
    launches = {"buffer_cli": buf["launches"], "eval_cli": ev["launches"]}
    for run, n in launches.items():
        if not n["gconv3x3_wgrad"] or n["gconv3x3_fwd"]:
            raise AssertionError(f"phase 14 {run}: launches {n}")
    out = {"image_size": SIZE_288, "buffer_cli": buf, "eval_cli": ev,
           "kernels_288": rows[0]}
    print(f"phase 14 (288^2, float32): buffer CLI epoch "
          f"{buf['epoch_s'][0]['train_s']:.2f} s "
          f"({buf['epoch_s'][0]['images_per_s']:.1f} images/s), peak "
          f"{buf['max_memory_allocated_gib']:.2f} GiB; eval CLI wall "
          f"{ev['wall_s']:.1f} s, peak {ev['max_memory_allocated_gib']:.2f}"
          f" GiB; launches {json.dumps(launches)}", flush=True)
    return out, launches


def kernel_entries(rows, launches, launches_eval, launches_expert,
                   launches_cli, regnet_rows, launches_zoo, launches_p10,
                   launches_p11, launches_p12, launches_p13, rows_288,
                   launches_p14):
    """One entry per kernel, summed over one tower pass (mb=100), in the
    dtype of the paths that launch it.  The tensor-core kernels at NFNet-L0's
    19 sites: bf16 for the bf16 ones, float32 for the TF32 ones (phases 4-8;
    their bound: three passes at the TF32 rate, the CUDA cores' float32
    bound beside as ``bound_fp32_ms``).  The 8-channel kernels at
    NF-RegNet-B1's 16 sites, their path since phase 9, float32 (the buffer
    and eval students) with bfloat16 (the distill step) beside as
    ``*_bf16``.  The generic kernels at NFNet-L0's three stage-1 sites at
    288^2 in float32 (phase 14, their path since this slice; the forward
    with ``tc=False``, the path's forwards being the TF32 kernel's; bound
    TF32 x 3 as the TF32 kernels'), with their NF-RegNet-B1 numbers
    (``tc=False``, laid out as the 8-channel kernels') under
    ``nf_regnet_shapes`` and their phase-2 numbers at NFNet-L0's 224^2
    shapes under ``nfnet_shapes``.  ``launches``: of the bf16 tensor-core
    kernels phase 3's (the bf16 main path), of the TF32 ones phase 4's
    (the float32 outer step), of the 8-channel ones phase 9 (a)'s
    NF-RegNet-B1 distill CLI run, of the generic ones phase 14's (buffer
    CLI and eval CLI at 288^2); ``launches_eval``: phase 5's (the eval
    path); ``launches_expert``:
    phase 7's per run of the buffer CLI; ``launches_cli``: phase 8's (the
    distill CLI, all routes); ``launches_zoo``: phase 9's per run;
    ``launches_phase10``: phase 10's per run (the s2d A/B per timed run);
    ``launches_phase11``: phase 11's per run (the float32 steps of the
    modes other than phase 4's, and each mode's timed headline run);
    ``launches_phase13``: phase 13's per run on rank 0 (and rank 1's buffer
    CLI run, which skips the test passes); ``launches_phase14``: phase
    14's per run.  Each
    entry, and its ``nfnet_shapes``, names the tower whose shapes its
    numbers were taken at (``tower``)."""
    def measures(name, kind, route, sfx, rs):
        def total(key):
            return sum(r["sites"] * r[key] for r in rs)

        def err(tag):
            return max(r[f"{k}_err_{tag}"] for r in rs
                       for k in ((kind, "dgrad") if kind == "fwd"
                                 else (kind,)))

        bkey = f"{kind}_bound{'_tf32' if tf32_bound(route, sfx) else ''}{sfx}"
        bound, cold = (total(f"{bkey}_ms"),
                       total(f"{kind}_{route}{sfx}_cold_ms"))
        entry = {
            "dtype": "float32" if sfx else "bfloat16",
            "max_abs_err": err(f"{route}{sfx or '_bf16'}"),
            "ms": total(f"{kind}_{route}{sfx}_ms"), "ms_cold": cold,
            "plain_ms": total(f"{kind}_plain{sfx}_ms"),
            "bound_ms": bound, "bound_share_cold": bound / cold,
            "bound_by": max(rs, key=lambda r: r[f"{bkey}_ms"])[
                f"{bkey}_by"],
            "library_ms": total(f"{kind}_library{sfx}_ms"),
            "library_cold_ms": total(f"{kind}_library{sfx}_cold_ms"),
        }
        keys = ["shape", "groups", "sites", f"{kind}_{route}{sfx}_ms",
                f"{kind}_{route}{sfx}_cold_ms", f"{kind}_plain{sfx}_ms",
                f"{kind}_library{sfx}_ms", f"{kind}_library{sfx}_cold_ms",
                f"{bkey}_ms"]
        if sfx:   # cuDNN float32 with TF32
            entry["library_tf32_ms"] = total(f"{kind}_library{sfx}_tf32_ms")
            keys.append(f"{kind}_library{sfx}_tf32_ms")
        if tf32_bound(route, sfx):
            entry["bound_fp32_ms"] = total(f"{kind}_bound{sfx}_ms")
        if (route in ("generic", "narrow")   # this route's bf16 times
                and f"{kind}_{route}_ms" in rs[0]):
            entry.update({
                "max_abs_err_bf16": err(f"{route}_bf16"),
                "ms_bf16": total(f"{kind}_{route}_ms"),
                "ms_cold_bf16": total(f"{kind}_{route}_cold_ms"),
                "plain_ms_bf16": total(f"{kind}_plain_ms"),
                "bound_ms_bf16": total(f"{kind}_bound_ms"),
                "library_ms_bf16": total(f"{kind}_library_ms")})
        entry["per_shape"] = [{k: r[k] for k in keys} for r in rs]
        return entry

    entries = []
    for name, (kind, route, src, line) in KERNELS.items():
        sfx = "" if route == "tc" else "_f32"
        entry = {"name": name, "route": "cuda",
                 "source": f"{PKG}/csrc/{src}",
                 "replaces": f"{TPU_SRC}:{line}"}
        if route == "narrow":
            entry["tower"] = "nf_regnet_b1"
            entry.update(measures(name, kind, route, sfx, regnet_rows))
            entry["launches"] = launches_zoo["distill_nf_regnet"][name]
        elif route == "generic":
            entry["tower"] = "nfnet_l0_288"
            entry.update(measures(name, kind, route, sfx, rows_288))
            entry["nf_regnet_shapes"] = {
                "tower": "nf_regnet_b1",
                **measures(name, kind, route, sfx, regnet_rows)}
            entry["nfnet_shapes"] = {
                "tower": "nfnet_l0",
                **measures(name, kind, route, sfx, rows)}
            entry["launches"] = sum(n[name] for n in launches_p14.values())
        else:
            entry["tower"] = "nfnet_l0"
            entry.update(measures(name, kind, route, sfx, rows))
            entry["launches"] = launches[name]
        entry.update({
            "launches_eval": launches_eval[name],
            "launches_expert": {run: n[name]
                                for run, n in launches_expert.items()},
            "launches_cli": launches_cli[name],
            "launches_zoo": {run: n[name]
                             for run, n in launches_zoo.items()},
            "launches_phase10": {run: n[name]
                                 for run, n in launches_p10.items()},
            "launches_phase11": {run: n[name]
                                 for run, n in launches_p11.items()},
            "launches_phase12": {run: n[name]
                                 for run, n in launches_p12.items()},
            "launches_phase13": {run: n.get(name, 0)
                                 for run, n in launches_p13.items()},
            "launches_phase14": {run: n[name]
                                 for run, n in launches_p14.items()}})
        entries.append(entry)
    return entries


# Phases 9-11 need nothing of phases 4-8 and 12-14 but phase 3's set: a
# second process of this script (WORKER_ARG) runs them beside those, on the
# same card, heaviest on memory first (phase 11's ``for`` step, ~39 GiB,
# meets phases 4-7, at most ~20 GiB).  Every kernel's timed row runs
# before it starts, so no kernel time is taken beside the other process.
WORKER_ARG = "--worker"
WORKER_PHASES = ("11", "9", "10")
WORKER_TIMEOUT = 1000    # seconds from its start to its end


def exit_with_parent() -> None:
    """Stop this process once the process that started it is gone, so a
    script stopped from outside leaves nothing running on the card."""
    import threading

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(2)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def share_host(procs: int = 2) -> None:
    """The processes that run side by side share the host's cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))


def lap_clock(worker: dict | None = None):
    """-> ``lap(phase)``: prints the phase's wall seconds, empties the
    allocator's cache, and fails at once if ``worker`` has failed."""
    t_lap = [time.perf_counter()]

    def lap(phase: str) -> None:   # wall time per phase, for the budget
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now
        torch.cuda.empty_cache()
        if worker is not None and worker["proc"].poll():
            join_worker(worker)    # raises with the worker's log
    return lap


def worker_main(job_path: str) -> int:
    """The second process: phases :data:`WORKER_PHASES` on the job's set
    (phase 3's); their launch counts go to the job's ``out``."""
    exit_with_parent()
    sys.path.insert(0, str(HERE))
    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.ops import gconv as gc

    with open(job_path) as f:
        job = json.load(f)
    share_host()
    gc.build()    # built by the first process: this loads the libraries
    # the TF32 settings phase 9 began with when it ran in the first process
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(job["syn"]) as z:
        syn = (z["image_syn"], z["text_syn"], float(z["syn_lr_img"]),
               float(z["syn_lr_txt"]))
    lap = lap_clock()
    out = {}
    for phase in WORKER_PHASES:
        if phase == "9":
            zoo = zoo_path(gc, Config, syn, job["phase3_steps_per_s"])
            launches = {"compare_f32_nf_regnet":
                        zoo["compare_f32_nf_regnet"]["launches"]}
            for enc, r in zoo["towers"].items():
                launches[f"buffer_{enc}"] = r["buffer"]["launches"]
                launches[f"distill_{enc}"] = r["distill"]["launches"]
            launches["buffer_resnet50"] = zoo["resnet50"]["launches"]
            for name, r in zoo["cross_eval"].items():
                launches[f"eval_{name}"] = r["launches"]
            out["zoo"] = launches
        else:
            fn = {"10": phase10, "11": phase11}[phase]
            out[phase] = fn(gc, Config)[1]
        lap(phase)
    with open(job["out"], "w") as f:
        json.dump(out, f)
    return 0


def spawn_worker(work: str, syn, phase3_steps_per_s: float) -> dict:
    """Start :func:`worker_main` on phase 3's set, its output to a log in
    ``work``."""
    image_syn, text_syn, lr_img, lr_txt = syn
    job = {"syn": os.path.join(work, "worker_syn.npz"),
           "out": os.path.join(work, "worker_out.json"),
           "phase3_steps_per_s": phase3_steps_per_s}
    np.savez(job["syn"], image_syn=image_syn, text_syn=text_syn,
             syn_lr_img=np.float32(lr_img), syn_lr_txt=np.float32(lr_txt))
    path = os.path.join(work, "worker_job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    log = open(os.path.join(work, "worker.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), WORKER_ARG, path],
        cwd=str(HERE), stdout=log, stderr=subprocess.STDOUT)
    print(f"phases {', '.join(WORKER_PHASES)}: started in a second process "
          f"(pid {proc.pid}) beside phases 4-8 and 12-14", flush=True)
    return {"proc": proc, "log": log, "job": job,
            "deadline": time.time() + WORKER_TIMEOUT}


def stop_worker(worker: dict) -> None:
    """Stop the worker if it still runs, and print the end of its log."""
    if worker["proc"].poll() is None:
        worker["proc"].kill()
        worker["proc"].wait()
        worker["log"].seek(0)
        print("--- the second process, stopped; the end of its log ---\n"
              + worker["log"].read()[-6000:], flush=True)


def join_worker(worker: dict) -> dict:
    """Wait for the worker (until its deadline), print its log; -> its
    launch counts.  Raises if it failed or ran out of time."""
    proc = worker["proc"]
    t0 = time.perf_counter()
    while proc.poll() is None and time.time() < worker["deadline"]:
        time.sleep(0.5)
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    worker["log"].seek(0)
    text = worker["log"].read()
    names = ", ".join(WORKER_PHASES)
    print(f"--- phases {names}, the second process (waited "
          f"{time.perf_counter() - t0:.1f} s for it) ---", flush=True)
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    print("--- end of the second process ---", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"phases {names}: the second process exited "
                             f"{proc.returncode}")
    with open(worker["job"]["out"]) as f:
        return json.load(f)


def main() -> int:
    refused = env_overrides()
    if refused:
        print(f"chip_smoke: {', '.join(refused)} set in the environment; "
              f"every phase pins its route through the config, so unset "
              f"it and run again", file=sys.stderr)
        return 4
    if len(sys.argv) > 2 and sys.argv[1] == DP_RANK_ARG:
        return dp_rank_main(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == WORKER_ARG:
        return worker_main(sys.argv[2])
    if not (HERE / PKG / "csrc" / "gconv3x3_tc.cu").is_file():
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, str(HERE))
    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.ops import gconv as gc

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    print(f"card: {card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = gc.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for h, _, _ in REGNET_SITES:
        for i, kind in enumerate(("fwd", "wgrad")):
            for size in (2, 4):
                if (libs.narrow.mdd_gconv3x3_narrow_smem(i, size, h)
                        != gc.narrow_smem_bytes(kind, size, h)):
                    raise AssertionError(
                        f"narrow_smem_bytes({kind!r}, {size}, {h}) differs "
                        f"from gconv3x3_narrow.cu")
    for h, _, _ in SITES:   # the planner's shared-memory sizes are the .cu's
        for i, kind in enumerate(("fwd", "wgrad")):
            if libs.tc.mdd_gconv3x3_tc_smem(i, h) != gc.tc_smem_bytes(kind, h):
                raise AssertionError(f"tc_smem_bytes({kind!r}, {h}) differs "
                                     f"from gconv3x3_tc.cu")
        for i, mirror in enumerate((gc.tf32_fwd_smem_bytes,
                                    gc.tf32_smem_bytes)):
            if libs.tf32.mdd_gconv3x3_tf32_smem(i, h) != mirror(h):
                raise AssertionError(f"{mirror.__name__}({h}) differs from "
                                     f"gconv3x3_tf32.cu")
    for i, kind in enumerate(("fwd", "wgrad")):
        for code, dtype in enumerate((torch.float32, torch.bfloat16)):
            for cpg, opg in ((64, 64), (8, 8), (3, 130)):
                if (libs.generic.mdd_gconv3x3_generic_smem(i, code, cpg, opg)
                        != gc.generic_smem_bytes(kind, dtype, cpg, opg)):
                    raise AssertionError(
                        f"generic_smem_bytes({kind!r}, {dtype}, {cpg}, "
                        f"{opg}) differs from gconv3x3.cu")

    lap = lap_clock()
    rows = check_kernels(gc)
    check_hvp(gc)
    lap("2")
    # the kernel checks and timed rows of phases 9 and 14, here, so that
    # every kernel is timed with nothing else on the card
    regnet_rows = check_kernels_regnet(gc)
    rows_288 = check_kernels_288(gc)
    lap("9 (d) and 14 kernels")
    torch.backends.cudnn.allow_tf32 = True   # the library defaults again
    cfg = main_cfg(Config)
    path, syn = main_path(gc, cfg)
    gconv_env_check(gc, Config)
    lap("3")
    experts = {}
    # phase 7's working directories: (a)'s buffers and caption caches feed
    # phases 8 and 13 (c), the small runs' caches phase 13 (d) and 14
    tmp_dirs = tempfile.TemporaryDirectory()
    tmp = tmp_dirs.name
    worker = spawn_worker(tmp, syn, path["steps_per_s"])
    try:
        share_host()
        lap = lap_clock(worker)
        f32 = compare_f32(gc, cfg)
        lap("4")
        ev = eval_path(gc, Config, syn)
        lap("5")
        compare_eval(gc, Config, syn)
        lap("6")
        eval_repro(gc, Config, syn)
        lap("6 (b)")
        for run in EXPERT_RUNS:   # (a) alone: phase 8 reads its buffers
            work = os.path.join(tmp, "a" if run == "a" else "small")
            os.makedirs(work, exist_ok=True)
            with contextlib.chdir(work):
                experts[run] = expert_path(gc, Config, run)
            torch.cuda.empty_cache()
        compare_expert(gc, Config)
        lap("7")
        with contextlib.chdir(os.path.join(tmp, "a")):
            cli = distill_cli_path(gc, Config, path["steps_per_s"])
        lap("8")
        _, launches_p12 = phase12(gc, Config)
        lap("12")
        _, launches_p13 = phase13(gc, Config, os.path.join(tmp, "a"),
                                  os.path.join(tmp, "small"),
                                  path["steps_per_s"])
        lap("13")
        _, launches_p14 = phase14(gc, Config, os.path.join(tmp, "small"),
                                  rows_288)
        lap("14")
        side = join_worker(worker)
    finally:
        stop_worker(worker)
        worker["log"].close()
    tmp_dirs.cleanup()

    launches = {**f32["launches"], **{k: path["launches"][k]
                                      for k in MAIN_PATH_PER_STEP}}
    print(json.dumps({"kernels": kernel_entries(
        rows, launches, ev["launches"],
        {run: e["launches"] for run, e in experts.items()},
        cli["launches"], regnet_rows, side["zoo"], side["10"], side["11"],
        launches_p12, launches_p13, rows_288, launches_p14)}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
