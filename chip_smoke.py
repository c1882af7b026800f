#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths on five models at full width, random weights
from seed 0, batch 100 (104 for the patches):

* the flagship ``if_glow_mnist`` (L=2 blocks x K=16 steps of
  ``InvFlowNoPad``, coupling width 512, RQ spline 5 bins): scoring
  (``Experiment.maybe_data_init`` -> ``Flow.cheap_log_prob`` -> ``to_bpd``),
  sampling (``Flow.sample``: masked convs, no chain) and training (``maybe_data_init`` -> ``train_epoch`` -> ``train_step``:
  loss, backward, Adam with warmup and ExponentialLR, weight clamp 0.01);
* ``imagenet32`` (``bench.py``'s config: L=3 x K=48 ``InvFlowUnit``, the
  four-order chain, width 128, SLR; Adam lr 1e-5, no scheduler, no clamp)
  on synthetic (3, 32, 32) images: data init, eval, training;
* ``ff_glow_mnist`` (L=2 x K=16 ``FincFlowUnit``, width 512, RQ spline 5
  bins): data init, eval, sampling (``Flow.sample``,
  ``Experiment.sample``: FincFlow's level-2 inverse on the chain kernel)
  and training (grouped convs, no chain);
* ``real_digits_glow`` and ``real_patches_glow`` (the registry's
  real-data Glows: L=2 x K=4 ``InvFlowUnit``, width 64, SLR) trained
  through ``Experiment.run()`` for 40 epochs on the embedded real digits
  and patches, then scored on their test split;
* the paper's comparison baselines at their registry configs, led by
  ``selfnorm_glow_mnist`` (L=2 x K=16 SelfNorm 1x1 steps, width 512, no
  activation, recon weight 100): SelfNorm's modified gradient, recon loss,
  GECO and the dense exact log-det and inverse, Glow's 1x1 conv, Emerging
  (its inverse on the chain kernel) and the CNN and FC flows, one of them
  (``exact_cnn_mnist``) at batch 1000;
* the paper's Fig. 4 timing experiments: the seven ``*timescaling``
  sweeps of 2 x ``InvFlowNoPad(1, (2, 2))`` (exact, Jacobi, ``'auto'``)
  or SelfNorm 3x3 convs at batch 128 on (1, s, s) squares up to s = 128
  and (1, H, 1) tall images up to H = 4160, and ``memory_speed``'s
  (3, 32, 32) Glow (L=2 x K=16, width 256, SLR, batch 100),
* the rest of the layer zoo: ``exponential_cnn_mnist`` (9 ConvExp layers
  and RQ splines, the carried power-iteration vector ``u``), the paper's
  FastFlow ImageNet32 model (L=3 x K=48 of ``InvFlow`` TL, ``Conv1x1``
  and coupling width 512, ``GaussianizeSplit`` between levels; here
  with ``data_parallel=False``, in phase 16 data parallel), the grouped
  ``InvFlow``, the SmoothTanh
  inverse and the B-spline layers,
* the CIFAR-10 family at its registry configs on synthetic CIFAR-10
  (``if_glow_cifar``: L=2 x K=16 ``InvFlowNoPad``, width 128, batch 140;
  ``ff_glow_cifar``, ``selfnorm_glow_cifar``, ``conv1x1_glow_cifar``),
  and ``bench.py``'s bf16-coupling configurations of imagenet32 at batch
  100, 1024 and 4096 (every step checkpointed),
* the two data-parallel registry names, ``if_multiGPU_imagenet32`` (L=3
  x K=48 ``InvFlowNoPad``, width 256, RQ spline, batch 250) and
  ``if_imagenet_multi_gpu`` (FastFlow, batch 100), in spawned processes
  that each join a process group, and the native C++ library,
* the flagship Glow-MNIST with ``activation="BSpline"`` (L=2 x K=16,
  width 512, a 5-bin B-spline activation in every step): a train step
  and ``Experiment.sample``, the B-spline inverse on its kernel,
* the flagship on a 2 x 2 (data, model) mesh of 4 spawned ranks, its
  coupling nets split over the model axis,
* the port's bench entry point (``python -m inverse_flow_tpu_torch.bench``)
  and the five ``bench.py`` configurations no other phase builds: the
  flagship on four-order units (``glow_mnist_fused_units``) and with bf16
  coupling nets, ``imagenet32_exact``, and the Fig. 4 squares at s = 64
  and 128,

in phases:

  1. device: the card's name and power limit;
  2. build: the chain kernels, the Newton-inverse kernels (SLR and
     SmoothTanh, its first design too) and the B-spline-inverse kernels
     (its three layouts and its first design) from
     ``inverse_flow_tpu_torch/csrc`` (one ``nvcc`` for each source,
     all started together), each kernel's registers, shared memory and
     spills, the MUFU instructions in the Newton kernels' loops (SASS),
     which must be the counts rows H and H2 are bound by,
     the cluster kernel's resident clusters at every main-path shape,
     and the wide cluster kernel's plan (row groups, resident or
     streamed slices, resident clusters) at the wide shapes
     (:func:`print_build`);
  3. kernel: the kernel the dispatch picks (the cluster kernel at every
     main-path shape) against its plain PyTorch version on the card at
     the flagship's shapes (and both scan directions, the padded tail and
     a four-order chain), with its time beside the streaming kernel's
     (forced), the plain version's and the library call's
     (:func:`library_chain`), timed in turns with the device behind the
     host (:func:`time_launch`);
  4. backward: ``FusedChainSolve``'s dx and dW through the kernel against
     the same Function on the plain recurrence, at the kernel cases of
     phase 3; the backward's launch (BR, transposed kernel) timed against
     its plain version and the library call;
  5. slice: data init and eval over 3 validation batches, BPD, the kernel's
     launch count, log p(x) against the same model on the plain chain, and
     eval ms/batch;
  6. profile: where the time of one eval batch goes
     (:func:`profile_eval`); the flagship's ``Flow.sample`` of 100: no
     launch, finite samples, ms per 100 (:func:`flagship_sample`);
  7. train: data init and one epoch of 10 steps on the first 1,000
     synthetic training images with the registry's training config; every
     loss finite, the launch count, every weight within the clamp, the
     step-1 gradients against the plain chain, train ms/step against the
     plain chain, peak memory, and the device's time and launches per
     step (:func:`phase_train`);
  8. imagenet32: the four-order kernel, forward and backward, at the
     model's three solve shapes against its plain version and timed
     beside it and the library call; data init and one eval batch; one
     epoch of 3 steps with launch counts, losses, step-1 gradients, train
     ms/step, peak memory and a profiled step (:func:`phase_imagenet32`);
  9. ff: the kernel on FincFlow's expanded groups-4 kernel at its two
     shapes, B=100 and B=1, against its plain version and timed beside it,
     the library call and the bound; data init and one eval batch;
     ``Flow.sample`` (launches, finite samples, kernel vs plain chain on
     the same draws, round trips, ms per 100 images and per image, a
     profiled sample, host ms by layer type, peak memory) and
     ``Experiment.sample``; then 10 train steps with the registry's config
     and no launch (:func:`phase_ff`);
 10. SLR and real data: the SLR-inverse kernel against its plain loop at
     every launch shape, timed beside its first design (forced), the plain
     loop and two bounds, on the steps these inputs need and on 100 steps
     (:func:`check_slr`);
     imagenet32's sampling on phase 8's model, 144 SLR-kernel launches per
     sample, ``Flow.sample`` with the kernel and the plain loop in turns,
     ``Experiment.sample`` with the kernel (:func:`sample_imagenet32`);
     ``real_digits_glow`` and ``real_patches_glow`` through ``run()``, held
     against the TPU artifacts in ``results/`` (:func:`phase_real_data`);
     a resume from a checkpoint (:func:`phase_resume`) and the CLI's smoke
     run (:func:`phase_cli`);
 11. wide: the wide cluster kernel at the two wide blocks the cluster
     kernel refuses (W1: the paper's Fig. 4 tall sweep at H = 4160; W2: an
     ImageNet64 Glow's first level), forward and backward, against its
     plain version and timed beside the streaming kernel (forced), the
     plain version, the library call and the bound; checked at RCW = KCW =
     2048 and 512; W1's model (2 x ``InvFlowNoPad(1, (2, 2))`` at (128, 1,
     4160, 1)): loss and backward with every launch on the wide kernel,
     against the plain chain, timed beside it and the streaming kernel
     (:func:`phase_wide`);
 12. baselines: the paper's comparison baselines at their registry
     configs (:func:`phase_baselines`): ``selfnorm_glow_mnist`` (data
     init, 5 steps with the recon term, eval with the exact correction,
     exact log p against cheap + correction, cheap and exact samples,
     ``reconstruct(exact=True)``, ms/step and a profiled step), 3 GECO
     steps with the weight after each, ``selfnorm_glow_imagenet``'s step
     and its dense correction's time and memory, ``conv1x1_glow_mnist``
     and ``if_conv1x1_glow_mnist``, ``emerging_cnn_mnist`` (the chain
     kernel on Emerging's non-unit operators against its plain version
     and timed; 3 steps; ``Flow.sample`` with 16 launches against the
     plain chain; the round trip), ``if_cnn_mnist``, ``exact_cnn_mnist`` at
     B=1000 (forward, backward and dW against the plain version, timed;
     one step, its gradients against the plain chain), and 2 steps each of
     ``selfnorm_cnn_mnist``, ``selfnorm_fc_mnist``, ``exact_fc_mnist`` and
     ``real_digits_fc``; the phase's seconds;
 13. timescaling (:func:`phase_timescaling`): at every sweep size the
     Jacobi and ``'auto'`` arms against the exact arm on the same weights,
     ``'auto'``'s route against ``ops/solver_policy.py``'s window, the exact
     arm against the plain chain at s = 128 and H = 4160, the guard's
     fallback at every tap 0.7, the step-difference floor beside the
     policy's tolerances; the seven sweeps through ``run_timescaling`` at
     the registry's sizes, each size's chain launches by variant and guard
     syncs per step; the device's busy share at the largest sizes; and
     ``memory_speed`` at its full configuration;
 14. zoo (:func:`phase_zoo`): ``exponential_cnn_mnist`` at its registry
     config (data init, 10 steps with u checked after each against one
     power iteration of the new kernel, the exact log p against the cheap
     one within the series tail, ``Flow.sample`` and a round trip, ms/step,
     a profiled step, the CLI's smoke run); FastFlow ImageNet32 (the N=1 TL launch at its
     three shapes against its plain version, timed beside it, the library
     call and the bound; data init and one eval batch; 3 steps with 144 +
     144 launches a step, all ``cluster``; step-1 gradients against the
     plain chain; ms/step, peak memory, a profiled step; ``Flow.sample``);
     ``InvFlow(12, (3, 3), groups=2)`` forward and backward through the
     kernel against the plain chain, timed; the SmoothTanh-inverse kernel
     and its first design (forced) against the plain loop at imagenet32's
     shapes, B=100 and 1, beta 0.1 and 0.01, the steps each exit needs,
     timed beside the plain loop and the bound, and ``SmoothTanh.inverse``
     counted; the B-spline-inverse kernel against its plain version in
     its three layouts (shared, channel-major, last dim) at the same
     shapes, its Newton steps, timed beside its first design (forced),
     the plain version and the bound; ``BSplineActivation`` and
     ``BSplineCoupling`` (width 512) forward and inverse, ms per call
     with the kernel and the plain inverse, launch calls (at most 2 a
     ``BSplineActivation`` inverse) and round trips; the kernel on wide
     draws (coefficients at std 3) against the float64 plain inverse;
 15. CIFAR-10 and bf16 (:func:`phase_cifar_bf16`): ``if_glow_cifar``'s
     N=1 TL launch at B=140 (two waves of clusters, a ragged last
     cluster), forward and backward, against its plain version, timed;
     data init and 3 steps (32 + 32 launches a step), eval, a sample, the
     step-1 gradients against the plain chain, ms/step against the plain
     chain, a profiled step; ``ff_glow_cifar``'s 3 steps and its
     ``Flow.sample`` (32 launches on the expanded groups-4 kernel against
     the plain chain) and the grouped launch at CIFAR's shapes, timed;
     3 steps each of ``selfnorm_glow_cifar`` and ``conv1x1_glow_cifar``;
     ``imagenet32_bf16_couplings`` (B=100), ``imagenet32_b1024`` and
     ``imagenet32_b4096``: data init and train steps with their launches,
     ms/step, samples/s, peak memory and a profiled step, the four-order
     launch at B=1024 and 4096 (9 and 35 waves) against its plain version,
     timed; and the bf16 value check: bpd and gradients of the same
     weights with float32 and with bf16 coupling nets;
 16. data parallel and native (:func:`phase_data_parallel`):
     ``if_multiGPU_imagenet32``'s N=1 TL launch at B=250 (32 clusters, 3
     waves), forward and backward, against its plain version, timed (rows
     P, Pb); the registry config at full width and depth in a world of one
     over NCCL (:func:`dp_one_rank`: data init, one eval batch, 3 steps
     with 144 + 144 launches a step, all ``cluster``; step-1 gradients
     against the plain chain; ms/step, a profiled step, peak memory; 2
     steps bitwise equal to ``data_parallel=False``; FastFlow's 2 steps)
     and a world of two over gloo on the one card (:func:`dp_two_ranks`:
     125 a rank; the all-reduced step-1 gradient against the mean of two
     one-process gradients; replicas equal after every step; ms/step, the
     all-reduce's ms; FastFlow's 2 steps); the native library built from
     ``native/src``, its float64 oracle against the kernel's solve, its
     prefetcher against the numpy loader (:func:`check_native`);
 17. the B-spline Glow-MNIST (:func:`phase_bspline_glow`): data init and
     one train step (128 chain launches, no B-spline launch), then
     ``Experiment.sample`` of 100: 32 B-spline-kernel launches and no
     chain launch, finite samples; ``Flow.sample`` with the kernel and
     with the plain inverse on the same draws, timed, their launch calls;
     each block's round trip; the kernel against its plain version at the
     path's two shapes, timed beside its first design, the plain version
     and the bound;
 18. the (data, model) mesh (:func:`phase_mesh`): the chain kernel at
     B=50, forward and backward, against its plain version, timed; the
     flagship at full width and depth on a 2 x 2 mesh of 4 ranks spawned
     over gloo on the one card (:func:`mesh_flagship`: the coupling nets
     split 256 + 256 over the model axis, 50 examples a data row, 3
     steps): step 1's loss and gathered gradients against the one-process
     step, the replicas and shards equal after every step, 32 + 32 chain
     launches a step on each rank, all ``cluster``, ms/step and the
     all-reduces' ms;
 19. the bench (:func:`phase_bench`): the five configurations of
     ``bench.py`` that no other phase builds, at full width and depth
     with the bench's data init: ``glow_mnist_fused_units`` (the N=4 unit
     at the flagship's shapes against its plain version and timed, row
     E0; a step, 32 + 32 launches, against the plain chain),
     ``glow_mnist_bf16_couplings`` (a step against the plain chain and
     against itself, the bf16 value check against float32 nets),
     ``imagenet32_exact`` (loss and gradients bitwise ``imagenet32``'s on
     the same weights under deterministic algorithms, 288 launches a
     step) and ``timescale_s64`` / ``_s128`` (a step, 2 + 2
     launches, against the plain chain); ``bench.bench_config`` on each
     (2 rounds of 1 step); and ``python -m inverse_flow_tpu_torch.bench``
     in a subprocess, its last line the flagship's on this card;
 20. the coupling nets' kernels (:func:`phase_coupling_net`): their
     registers, then at each net of :data:`NET_CASES` (the flagship's two
     at the benchmark's B=8192, every float32 net of ``bench.py``'s
     configurations, the CIFAR Glows', FastFlow's, the mesh's slice and
     the SplitPriorFC's, each at its batch) the plan, the forward and the
     backward against the float64 composition, two backward runs bitwise
     equal, and each direction timed against the cuDNN composition it
     replaces (the op's plain version, ``F.conv2d``, TF32 off) and the
     bound (its FLOPs at 67 TFLOP/s). Phases 6 and 7 count the kernels'
     launches of the flagship's draw (33 forward) and train steps (66
     forward, 33 backward, 33 reduce a step).

Every chain launch of the flagship, imagenet32, ff, Emerging, FastFlow
and CIFAR paths, the bf16 configurations and the grouped ``InvFlow`` must
go to the cluster kernel
(:func:`cluster_only`), every one of W1's model to the wide cluster
kernel; the real-data runs print the variant of each launch
shape. Every phase prints one line or more and its
seconds; the line
before the last is the kernel summary as JSON, the last ``{"ok": true,
"device": ...}``. Any
failed check exits non-zero with no result line. Without a CUDA card it
fails at once: nothing runs on the CPU. Float32 throughout, TF32 off for
matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from unittest import mock

from inverse_flow_tpu_torch.utils import profiling
from inverse_flow_tpu_torch.utils.profiling import ab_ms, time_ms

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")
# device busy ms, launch calls and idle share of a few calls; the table of
# device ms by op goes to chiprun_out/profile_<name>.txt
device_profile = partial(profiling.device_profile, out_dir=OUT)
BATCH = 100
EVAL_EXAMPLES = 300
TRAIN_EXAMPLES = 1000
# the main path's solve shapes (C, H, W), and the kernel cases: both scan
# directions, the padded tail of (8, 7, 7), and a four-order chain
FLAGSHIP_SHAPES = [(4, 14, 14), (8, 7, 7)]
KERNEL_CASES = [((4, 14, 14), ("TL",)), ((8, 7, 7), ("TL",)),
                ((8, 7, 7), ("BR",)), ((4, 14, 14), ("TL", "TR", "BL", "BR"))]
# imagenet32: the InvFlowUnit solve shapes of its three levels, the unit's
# orders, and the examples of its train epoch (3 steps)
UNIT_SHAPES = [(12, 16, 16), (24, 8, 8), (48, 4, 4)]
UNIT = ("TL", "TR", "BL", "BR")
UNIT_TRAIN_EXAMPLES = 300
# |log p(x)| differences from summation order alone, float32, 38 layers
LOGPX_RTOL = 1e-4
# norm-relative differences of samples (before the final floor) and of
# inverse(forward(x)) round trips, float32 through up to 38 layers
SAMPLE_RTOL = 1e-4
# norm-relative gradient differences, kernel vs plain chain, float32
GRAD_RTOL = 1e-4
# the library call (cuBLAS trsm on the dense operator) against the kernel:
# another summation order over up to 3,072 terms per output, four solves
# chained; a gross-error check of the yardstick, not a parity bound
LIBRARY_RTOL = 1e-3
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the special-function unit (exp, log, reciprocal): 16 a clock per SM, 132
# SMs, at the card's maximum SM clock of 1,980 MHz
PEAK_MUFU_PER_S = 16 * 132 * 1.98e9
# the SmoothLeakyRelu inverse: its alpha in every model, its launch shapes
# (imagenet32's three levels at B=100 and B=1, real_digits_glow's two at
# B=100), and the special-function (MUFU) instructions of one Newton step:
# expf's EX2 and __fdividef's RCP (log1pf is a polynomial); phase 2 fails
# unless its kernel's loop holds these
SLR_ALPHA = 0.3
SLR_SHAPES = [(100, 12, 16, 16), (100, 24, 8, 8), (100, 48, 4, 4),
              (1, 12, 16, 16), (1, 24, 8, 8), (1, 48, 4, 4),
              (100, 4, 4, 4), (100, 8, 2, 2)]
SLR_MUFU_PER_STEP = 2
# the wide blocks that the cluster kernel refuses, on the wide cluster
# kernel: (C, H, W), kernel size, batch. W1: the paper's Fig. 4 tall sweep
# at its longest image (``if_tall_timescaling``: 2 x InvFlowNoPad(1, (2, 2))
# on (128, 1, 4160, 1); RCW = 520, KCW = 1, NB = 8); W2: an ImageNet64
# Glow's first level under a 3x3 kernel (RCW = KCW = 768, NB = 16). Edges,
# checked and not timed: RCW = KCW = 2048 ((64, 16, 16)) at a small batch,
# and RCW = KCW = 512 ((32, 8, 8)).
WIDE_SHAPES = {"W1": ((1, 4160, 1), (2, 2), 128),
               "W2": ((12, 32, 32), (3, 3), BATCH)}
WIDE_EDGES = [((64, 16, 16), 4), ((32, 8, 8), BATCH)]
# the real-data runs: epochs (the TPU artifacts' 40), and how far the port
# may land from the artifacts (results/real_*_bpd.jsonl): three times the
# spread of the port's own runs at seeds 0-2 on the CPU
# (scripts/train_real_torch.py --cpu: test BPD 4.6095-4.6318 for digits,
# best val BPD 4.1331-4.1836 for patches), since the two packages draw
# other init, noise and shuffles
REAL_EPOCHS = 40
PATCHES_EPOCHS = 40
DIGITS_TEST_TOL = 0.07
PATCHES_VAL_TOL = 0.15
# epoch 3's mean loss after a resume against the run that did not stop:
# cuDNN's backward sums in no fixed order, so the two runs part by float32
# round-off over 28 Adam steps
RESUME_RTOL = 1e-3


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def raster_perm(c, h, w, order, torch, device=None):
    """The NCHW-flattened indices of one image in ``order``'s raster
    order: rows of H (reversed when the order flips H), pixels of W
    (reversed when it flips W), channels innermost. In that order the
    order's masked conv is unit lower triangular."""
    from inverse_flow_tpu_torch.ops.fused_chain import ORDER_FLAGS

    fh, fw = ORDER_FLAGS[order]
    hh, ww, cc = (torch.arange(n, device=device) for n in (h, w, c))
    hh, ww = (hh.flip(0) if fh else hh), (ww.flip(0) if fw else ww)
    return ((cc[None, None, :] * h + hh[:, None, None]) * w
            + ww[None, :, None]).reshape(-1)


def library_chain(v, w_effs, orders, backward, torch):
    """The library call that computes the chain kernel's function: one
    ``torch.linalg.solve_triangular`` (cuBLAS trsm) per order on the dense
    (CHW, CHW) operator in that order's raster order (``unitriangular``
    unless its diagonal is not all ones: an Emerging kernel's), with a row
    gather between orders. Forward: ``y`` of the chain on ``v`` (B, C, H, W).
    ``backward``: the chain's transpose applied to the cotangent ``v``,
    the orders reversed, each ``upper=True`` on the transposed operator:
    the function of the backward's launch. The operators and the column
    layout (CHW, B) are built here, outside the timed call; returns the
    call, whose result :func:`from_columns` brings back to NCHW."""
    from inverse_flow_tpu_torch.ops.inv_conv import dense_operator

    b, c, h, w = v.shape
    tl = raster_perm(c, h, w, "TL", torch, v.device)
    steps = [(o, dense_operator(k, c, h, w)[tl][:, tl])
             for o, k in zip(orders, w_effs)]
    if backward:
        steps = [(o, m.T.contiguous()) for o, m in reversed(steps)]
    perms = [raster_perm(c, h, w, o, torch, v.device) for o, _ in steps]
    inverse = [torch.argsort(p) for p in perms]
    gathers = ([perms[0]] + [inverse[i - 1][perms[i]]
                             for i in range(1, len(perms))] + [inverse[-1]])
    mats = [(m, bool((torch.diagonal(m) == 1).all())) for _, m in steps]
    cols = v.detach().reshape(b, -1).T.contiguous()

    def call():
        z = cols[gathers[0]]
        for (m, unit), g in zip(mats, gathers[1:]):
            z = torch.linalg.solve_triangular(m, z, upper=backward,
                                              unitriangular=unit)[g]
        return z
    return call


def from_columns(z, shape):
    """(CHW, B) columns -> (B, C, H, W)."""
    return z.T.reshape(shape)


def chain_bound(args, torch):
    """(bound_ms, bound_by, multiply-adds per batch row) of one
    :func:`chain_phases` launch on ``args``: the larger of the
    multiply-adds this launch's data needs at the fp32 peak, and its bytes
    at the HBM rate, both counted by ``fused_chain.chain_work``."""
    from inverse_flow_tpu_torch.ops.fused_chain import chain_work

    fma, n_bytes = chain_work(args)
    ops_ms = 2 * fma * args[0].shape[1] / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", fma
    return bytes_ms, "bytes", fma


def time_launch(x, ws, orders, backward, reps, rounds, torch,
                variant="cluster"):
    """One launch's function timed in turns on the same inputs, the device
    running behind the host (:func:`time_ms`): the kernel the dispatch
    picks (``variant``: the cluster kernel at every shape of the main
    paths, the wide cluster kernel at the wide shapes), the
    streaming kernel forced, the plain version and the library call; the
    streaming kernel checked against the plain version to ``1e-5 *
    max(1, max|y|)`` and the library result against the kernel's.
    ``backward``: the backward's launch on the cotangent ``x``
    (complementary orders, transposed kernels). Returns (times dict,
    :func:`chain_bound`'s triple, library max abs err)."""
    from inverse_flow_tpu_torch.ops import fused_chain

    make = fused_chain.backward_inputs if backward else \
        fused_chain.chain_inputs
    args = make(x, ws, orders)
    if fused_chain.chain_variant(args[0].shape[2], args[4]) != variant:
        fail(f"{tuple(x.shape)} {orders} does not dispatch to the {variant} "
             f"kernel")
    library = library_chain(x, ws, orders, backward, torch)
    _, c, h, w = x.shape
    with torch.inference_mode():
        y = fused_chain._from_blocks_trim(fused_chain.chain_phases(
            *args)[-1], c, h, w)
        lib_err = (from_columns(library(), x.shape) - y).abs().max().item()
        if not lib_err <= LIBRARY_RTOL * max(1.0, y.abs().max().item()):
            fail(f"the library call disagrees with the kernel at "
                 f"{tuple(x.shape)} {orders} (backward {backward}): "
                 f"{lib_err}")
        ref = fused_chain.chain_phases_reference(*args)
        stream_err = (fused_chain.chain_phases(*args, variant="streaming")
                      - ref).abs().max().item()
        if not stream_err <= 1e-5 * max(1.0, ref.abs().max().item()):
            fail(f"the streaming kernel disagrees with its plain version at "
                 f"{tuple(x.shape)} {orders}: {stream_err}")
        t = ab_ms({"kernel": lambda: fused_chain.chain_phases(*args),
                   "streaming": lambda: fused_chain.chain_phases(
                       *args, variant="streaming"),
                   "plain": lambda: fused_chain.chain_phases_reference(
                       *args),
                   "library": library}, reps=reps, rounds=rounds,
                  ahead=True)
    return t, chain_bound(args, torch), lib_err


def solve_operands(chw, orders, gen, dev, torch, b=BATCH, kernel=(3, 3)):
    """A batch of ``b`` inputs (C, H, W) and one masked ``kernel`` per
    order, of std 0.1 / sqrt(C): at every case max|y| stays near 5 while
    the solves move y by a quarter to three fifths of |x|. (A std of 0.1
    at C >= 12 drives four chained solves to |y| of 1e3-1e4, which would
    loosen the ``1e-5 * max|y|`` limit as far.)"""
    from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

    c = chw[0]
    x = torch.randn((b,) + chw, generator=gen, device=dev)
    ws = [apply_mask(0.1 / math.sqrt(c) * torch.randn(
        (c, c) + tuple(kernel), generator=gen, device=dev)) for _ in orders]
    return x, ws


def check_forward(cases, label, gen, dev, torch, b=BATCH, kernel=(3, 3),
                  variant="cluster", operands=None):
    """The kernel the dispatch picks (``variant``) against its plain
    version on each case's launch, to ``1e-5 * max(1, max|y|)``, on
    ``operands`` (:func:`solve_operands` by default); returns the largest
    error."""
    from inverse_flow_tpu_torch.ops import fused_chain

    operands = operands or solve_operands
    max_err = 0.0
    for chw, orders in cases:
        args = fused_chain.chain_inputs(*operands(
            chw, orders, gen, dev, torch, b, kernel), orders)
        if fused_chain.chain_variant(args[0].shape[2], args[4]) != variant:
            fail(f"{chw} {orders} does not dispatch to the {variant} kernel")
        with torch.inference_mode():
            y = fused_chain.chain_phases(*args)
            torch.cuda.synchronize()
            ref = fused_chain.chain_phases_reference(*args)
        err = (y - ref).abs().max().item()
        tol = 1e-5 * max(1.0, ref.abs().max().item())
        max_err = max(max_err, err)
        print(f"{label}: ({b},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}: max_abs_err {err:.3e} (tol {tol:.3e})",
              flush=True)
        if not err <= tol:
            fail(f"chain kernel disagrees with its plain version at {chw} "
                 f"{orders}")
    return max_err


def check_backward(cases, label, gen, dev, torch, b=BATCH, kernel=(3, 3)):
    """``FusedChainSolve``'s dx and dW through the kernel (two launches)
    against the same Function on the plain recurrence, to ``1e-5 *
    max(1, max|dx|)`` and ``1e-4 * max|dW|``; returns the largest dx
    error, which is the backward launch's last phase."""
    from inverse_flow_tpu_torch.ops import fused_chain

    def vjp(x, ws, orders, gy):
        x = x.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in ws]
        y = fused_chain.fused_chain_solve(x, ws, orders)
        return torch.autograd.grad(y, [x, *ws], gy)

    max_err = 0.0
    for chw, orders in cases:
        x, ws = solve_operands(chw, orders, gen, dev, torch, b, kernel)
        gy = torch.randn(x.shape, generator=gen, device=dev)
        before = fused_chain.chain_phases.launches
        dx, *dws = vjp(x, ws, orders, gy)
        torch.cuda.synchronize()
        launched = fused_chain.chain_phases.launches - before
        with plain_chain(fused_chain):
            ref_dx, *ref_dws = vjp(x, ws, orders, gy)
        err = (dx - ref_dx).abs().max().item()
        tol = 1e-5 * max(1.0, ref_dx.abs().max().item())
        dw_rel = max(((d - r).abs().max() / r.abs().max()).item()
                     for d, r in zip(dws, ref_dws))
        max_err = max(max_err, err)
        print(f"{label}: ({b},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}: dx max_abs_err {err:.3e} (tol "
              f"{tol:.3e}), dW max err / max|dW| {dw_rel:.3e} (tol 1e-4); "
              f"{launched} kernel launches", flush=True)
        if launched != 2:
            fail(f"expected 2 chain kernel launches (forward and backward) "
                 f"at {chw} {orders}, got {launched}")
        if not (err <= tol and dw_rel <= 1e-4):
            fail(f"the backward through the kernel disagrees with the plain "
                 f"chain at {chw} {orders}")
    return max_err


def time_rows(shapes, orders, backward, reps, rounds, label, gen, dev, card,
              torch, b=BATCH, kernel=(3, 3), variant="cluster",
              operands=None):
    """The kernel, plain and library times of one launch at each shape,
    with the bound (:func:`time_launch`), on ``operands(chw, orders, gen,
    dev, torch, b, kernel)`` (:func:`solve_operands` by default); returns
    their means over the shapes, which the path launches equally often."""
    operands = operands or solve_operands
    rows = []
    for chw in shapes:
        x, ws = operands(chw, orders, gen, dev, torch, b, kernel)
        t, (bound, bound_by, fma), lib_err = time_launch(
            x, ws, orders, backward, reps, rounds, torch, variant)
        rows.append((t["kernel"], t["streaming"], t["plain"], t["library"],
                     bound))
        print(f"{label}: ({b},{','.join(map(str, chw))}) "
              f"{'-'.join(orders)}{' backward launch' * backward}: "
              f"{launch_times(t, bound, bound_by, fma, variant)}; library "
              f"vs kernel max abs diff {lib_err:.3e} {card}", flush=True)
    return mean_row(rows, bound_by)


def launch_times(t, bound, bound_by, fma, variant="cluster"):
    """One line's worth of :func:`time_launch`'s times and the bound."""
    return (f"{variant} kernel {1e3 * t['kernel']:.2f} us, streaming kernel "
            f"{1e3 * t['streaming']:.2f} us, plain torch "
            f"{1e3 * t['plain']:.2f} us, library {1e3 * t['library']:.2f} "
            f"us per call; bound {1e3 * bound:.3f} us ({bound_by}, {fma} "
            f"multiply-adds per batch row; the {variant} kernel at "
            f"{bound / t['kernel']:.3%} of it, the streaming kernel at "
            f"{bound / t['streaming']:.3%})")


def mean_row(rows, bound_by):
    """The summary entry's times: means over a path's launch shapes, which
    it launches equally often."""
    means = [statistics.fmean(col) for col in zip(*rows)]
    return dict(ms=means[0], streaming_ms=means[1], plain_ms=means[2],
                library_ms=means[3], bound_ms=means[4], bound_by=bound_by)


def profile_eval(flow, x, generator, card, torch):
    """Where the time of one eval batch goes.

    In one process, on the same batch: eval ms/batch by CUDA events (as
    phase 5 times it) and by the host clock with a sync at the end, in
    six turns of three batches each, to show how far they drift; then
    two batches under ``torch.profiler`` for device time, busy share,
    device ops and kernel launches; then one batch with a sync around every
    layer for the host-clock time by layer type (exclusive of nested
    layers). The profiler's table goes to ``chiprun_out/profile_eval.txt``.
    """
    def batch():
        return flow.cheap_log_prob(x, generator)

    def wall_ms(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            batch()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    with torch.inference_mode():
        for _ in range(2):
            batch()
        # in turns, as the pass is host-bound and its time drifts
        events_ms, host_ms = [], []
        for _ in range(6):
            events_ms.append(time_ms(batch, 3))
            host_ms.append(wall_ms(3))
    for name, ms in (("CUDA events", events_ms), ("the host clock", host_ms)):
        print(f"profile: eval ms/batch by {name}, 6 rounds of 3 batches: "
              f"{', '.join(f'{t:.3f}' for t in ms)} (median "
              f"{statistics.median(ms):.3f}) {card}", flush=True)
    with torch.inference_mode():
        device_profile("eval", "batch", batch, 2, card)
    host_by_layer(flow, "forward_with", batch, "eval batch", torch)


def host_by_layer(flow, method, fn, what, torch):
    """One call of ``fn`` with a sync around every layer's ``method``
    (``forward_with`` or ``inverse_with``): prints the host-clock ms by
    layer type, exclusive of nested layers."""
    from inverse_flow_tpu_torch.layers.base import FlowLayer

    by_type, nested = {}, []

    def timed(cls, fn):
        def wrapper(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nested.append(0.0)
            result = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            own = dt - nested.pop()
            by_type[cls.__name__] = by_type.get(cls.__name__, 0.0) + own
            if nested:
                nested[-1] += dt
            return result
        return wrapper

    # the unpatched methods first: a subclass may inherit its parent's
    originals = {type(m): getattr(type(m), method) for m in flow.modules()
                 if isinstance(m, FlowLayer)}
    with contextlib.ExitStack() as stack, torch.inference_mode():
        for cls, orig in originals.items():
            stack.enter_context(mock.patch.object(cls, method,
                                                  timed(cls, orig)))
        fn()
    print(f"profile: host ms by layer type, one {what}, synced: " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in sorted(
            by_type.items(), key=lambda kv: -kv[1])), flush=True)


def plain_chain(fused_chain):
    """A context in which every solve runs the kernel's plain version."""
    return mock.patch.object(fused_chain, "chain_phases",
                             fused_chain.chain_phases_reference)


def cluster_only(what, launches):
    """Fails unless all ``launches`` chain launches since the last
    ``reset_launches`` went to the cluster kernel; returns the counts by
    variant."""
    from inverse_flow_tpu_torch.ops import fused_chain

    by = dict(fused_chain.chain_phases.launches_by_variant)
    if by["cluster"] != launches or sum(by.values()) != launches:
        fail(f"{what}: {launches} chain launches, by variant {by}: not all "
             f"on the cluster kernel")
    return by


def counted_epoch(exp, first, torch, nets=None):
    """``maybe_data_init(first)`` and one ``train_epoch``, with the chain
    kernel's launch counts set to 0 just before and read just after; every
    launch must go to the cluster kernel. With a dict ``nets``, the
    coupling nets' launch counts of the epoch alone (set to 0 after the
    data init) go into it by kind. Returns (losses, mean loss, launches,
    backward launches, the state after data init)."""
    from inverse_flow_tpu_torch.ops import coupling_net, fused_chain

    losses, bwd = [], [0]
    step_fn = exp.train_step
    solve_bwd = fused_chain.FusedChainSolve.backward

    def recorded_step(xb):
        losses.append(step_fn(xb))
        return losses[-1]

    def counted_backward(ctx, gy):
        before = fused_chain.chain_phases.launches
        out = solve_bwd(ctx, gy)
        bwd[0] += fused_chain.chain_phases.launches - before
        return out

    with mock.patch.object(exp, "train_step", recorded_step), \
            mock.patch.object(fused_chain.FusedChainSolve, "backward",
                              staticmethod(counted_backward)):
        fused_chain.reset_launches()
        exp.maybe_data_init(first)
        init_state = copy.deepcopy(exp.flow.state_dict())
        coupling_net.reset_launches()
        mean_loss = exp.train_epoch(1)
        torch.cuda.synchronize()
        launches = fused_chain.chain_phases.launches
        if nets is not None:
            nets.update(coupling_net.coupling_net_hidden.launches_by_kind)
    cluster_only(f"{exp.cfg.name} data init + epoch", launches)
    return [float(v) for v in losses], mean_loss, launches, bwd[0], init_state


def check_grads(label, flow, first, gen, dev, torch, tol=GRAD_RTOL,
                reference=None):
    """Step-1 loss and gradients of -log p(x) after dequantization
    through the kernel against the plain chain (or, given ``reference``,
    against ``reference``'s run through the kernel: a flow with the same
    weights), on the same batch and noise: the loss within
    ``LOGPX_RTOL`` (with ``reference``, within ``tol``) and the gradients
    within ``tol``, each by relative norm. Each run's chain launch counts
    are set to 0 just before it and read after its forward and its
    backward. Returns the batch on the card and each run's (loss,
    forward launches, launches by variant)."""
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.ops import fused_chain

    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)

    def run(model, plain):
        body = Flow(model.base_distribution, model.layers[1:])
        params = [p for p in body.parameters() if p.requires_grad]
        kernel = fused_chain.chain_phases       # holds the counts
        fused_chain.reset_launches()
        with plain_chain(fused_chain) if plain else contextlib.nullcontext():
            loss = (-body(x + u)[1]).mean()
            torch.cuda.synchronize()
            fwd = kernel.launches
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
        return (loss.detach(), fwd, dict(kernel.launches_by_variant)), grads

    (ours, g), (ref, g_ref) = run(flow, False), run(
        flow if reference is None else reference, reference is None)
    rel = abs((ours[0] - ref[0]) / ref[0]).item()
    grel = max(0.0 if torch.equal(a, b) else
               ((a - b).norm() / b.norm()).item() for a, b in zip(g, g_ref))
    against = "plain chain" if reference is None else "reference"
    loss_tol = LOGPX_RTOL if reference is None else tol
    print(f"{label}: step-1 loss {ours[0].item():.4f} and gradients, kernel "
          f"vs {against}, same batch of {x.shape[0]} and noise: loss rel "
          f"err {rel:.3e} (tol {loss_tol:.0e}), max over {len(g)} tensors "
          f"of |g - g_ref| / |g_ref| {grel:.3e} (tol {tol:.0e})", flush=True)
    if not (torch.isfinite(ours[0]) and rel <= loss_tol and grel <= tol):
        fail(f"{label}: the loss or the gradients through the kernel "
             f"disagree with the {against}")
    return x, ours, ref


def time_steps(label, exp, x, reps, rounds, card, torch):
    """Train ms/step through the kernel and the plain chain, in turns."""
    from inverse_flow_tpu_torch.ops import fused_chain

    def step():
        exp.train_step(x)

    def step_plain():
        with plain_chain(fused_chain):
            exp.train_step(x)

    t = ab_ms({"kernel": step, "plain": step_plain}, reps=reps,
              rounds=rounds)
    print(f"{label}: {t['kernel']:.3f} ms/step of {exp.cfg.batch_size} "
          f"(plain chain {t['plain']:.3f} ms/step), CUDA events, median of "
          f"{rounds} turns of {reps} steps {card}", flush=True)
    return step


def phase_train(dev, card, torch):
    """Phase 7: the flagship's training path, ``maybe_data_init`` and one
    ``train_epoch`` of 10 steps, with the registry's training config
    (``inverse_flow_tpu/experiments/registry.py:145-151``). Checks every
    loss finite, ``32 x 2 + 64 x steps`` kernel launches (data init passes
    every block twice; a step runs each of the 32 solves forward and
    backward), every weight within the clamp, and the step-1 gradients
    through the kernel against the plain chain; prints train ms/step
    against the plain chain, peak memory, and the device's busy time and
    launches per step. Checks 66 forward, 33 backward and 33 reduce
    launches of the coupling nets' kernels a step. Returns the main
    path's (forward, backward) chain launches and the nets' launches a
    step by kind."""
    from inverse_flow_tpu_torch.data import ArrayLoader, mnist
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    gen = torch.Generator(dev).manual_seed(0)
    flow = build_glow((1, 28, 28), step_kind="inv_conv_no_pad", num_blocks=2,
                      block_size=16, coupling_width=512, actnorm=True,
                      split_prior=True, activation="Spline", n_bins=5,
                      tail_bound=20.0, generator=gen, device=dev)
    cfg = ExperimentConfig(
        name="2L-16K_IF_Glow_MNIST", lr=1e-5, batch_size=BATCH, epochs=2000,
        warmup_epochs=1, gamma=0.96170, scheduler_name="ExponentialLR",
        grad_clip_norm=None, weight_clamp=0.01, modified_grad=True,
        add_recon_grad=True, sym_recon_grad=True, recon_loss_weight=0.0,
        sample_true_inv=True, eval_train=True, plot_recon=False,
        metrics_path=os.path.join(HERE, "chiprun_out", "train_metrics.jsonl"),
        seed=0)
    with warnings.catch_warnings(record=True):   # phase 5 printed it
        warnings.simplefilter("always")
        train, val, test = mnist.load_data(batch_size=BATCH, seed=cfg.seed)
    train = ArrayLoader(train.data[:TRAIN_EXAMPLES], BATCH, shuffle=True,
                        seed=cfg.seed)
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    steps = len(train)
    first = train.data[:BATCH]

    nets = {}
    values, mean_loss, launches, bwd, init_state = counted_epoch(
        exp, first, torch, nets)
    peak_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    w_max = max(p.detach().abs().max().item() for p in flow.parameters())
    print(f"train: {cfg.name} data init + {len(values)} steps of {BATCH} "
          f"(lr {cfg.lr}, warmup {cfg.warmup_epochs} epoch, "
          f"{cfg.scheduler_name} {cfg.gamma}, clamp {cfg.weight_clamp}): "
          f"losses {', '.join(f'{v:.4f}' for v in values)}; mean "
          f"{mean_loss:.4f}", flush=True)
    print(f"train: chain kernel launches {launches} ({launches - bwd} "
          f"forward, {bwd} backward) for data init + {steps} steps "
          f"(32 x 2 + 64 per step); max |weight| {w_max:.6f}; Batch Time "
          f"Mean {exp.batch_time.mean:.3f} ms over the epoch's window; "
          f"peak memory {peak_gb:.3f} GB {card}", flush=True)
    if len(values) != steps or not all(math.isfinite(v) for v in values):
        fail(f"expected {steps} finite training losses, got {values}")
    if launches != 32 * 2 + 64 * steps or bwd != 32 * steps:
        fail(f"expected {32 * 2 + 64 * steps} chain kernel launches "
             f"({32 * steps} backward), got {launches} ({bwd})")
    if not w_max <= cfg.weight_clamp * (1 + 1e-6):
        fail(f"a weight exceeds the clamp: {w_max}")
    # the 33 nets (32 couplings, the SplitPrior), each step: the forward
    # and the checkpoint's recompute, one backward and one reduction
    want = {"forward": 66 * steps, "backward": 33 * steps,
            "reduce": 33 * steps}
    print(f"train: coupling net launches {nets} for {steps} steps "
          f"(66 / 33 / 33 per step)", flush=True)
    if nets != want:
        fail(f"expected coupling net launches {want}, got {nets}")

    flow.load_state_dict(init_state)
    x = check_grads("train", flow, first, gen, dev, torch)[0]
    step = time_steps("train", exp, x, 2, 4, card, torch)
    device_profile("train", "step", step, 2, card)
    return launches - bwd, bwd, {k: v // steps for k, v in nets.items()}


def phase_imagenet32(dev, gen, card, torch):
    """Phase 8: ``bench.py``'s ``imagenet32`` config (built through
    ``experiments/bench_configs.py``), L=3 x K=48
    ``InvFlowUnit`` (144 four-order solves per pass), width 128, SLR,
    batch 100, on synthetic (3, 32, 32) images through
    ``data/imagenet.py``; random weights from seed 0.

    The four-order kernel at the model's three solve shapes, forward and
    backward, against its plain version, timed beside it and the library
    call; data init and one eval batch (144 launches per pass, finite BPD,
    log p(x) against the plain chain); data init and one epoch of 3 steps
    with the ``imagenet32`` training config (Adam lr 1e-5, no warmup, no
    scheduler, no clamp): every loss finite, ``144 x 2 + 288 x steps``
    launches of which ``144 x steps`` backward, step-1 gradients against
    the plain chain, train ms/step against the plain chain, peak memory,
    and one profiled step. Returns the forward and backward kernel rows
    of the summary line."""
    from inverse_flow_tpu_torch.data import ArrayLoader, imagenet
    from inverse_flow_tpu_torch.experiments import bench_configs
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    label = "imagenet32"
    on = dict(gen=gen, dev=dev, torch=torch)
    cases = [(chw, UNIT) for chw in UNIT_SHAPES]
    errs = (check_forward(cases, f"{label}: kernel", **on),
            check_backward(cases, f"{label}: backward", **on))
    rows = [dict(time_rows(UNIT_SHAPES, UNIT, backward, 5, 4, label,
                           card=card, **on), max_abs_err=err)
            for backward, err in ((False, errs[0]), (True, errs[1]))]

    def model():
        gen = torch.Generator(dev).manual_seed(0)
        flow, _, batch = bench_configs.build("imagenet32", device=dev,
                                             generator=gen)
        if batch != BATCH:
            fail(f"bench_configs' imagenet32 batch {batch} is not {BATCH}")
        return flow, gen

    cfg = ExperimentConfig(
        name="imagenet32", lr=1e-5, batch_size=BATCH, warmup_epochs=0,
        scheduler_name="None", weight_clamp=None, add_recon_grad=False,
        max_eval_ex=BATCH, plot_recon=False, metrics_path=os.path.join(
            HERE, "chiprun_out", "imagenet32_metrics.jsonl"), seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train, val, test = imagenet.load_data(size=32, batch_size=BATCH,
                                              seed=cfg.seed)
    for w in caught:
        print(f"{label}: data: {w.message}", flush=True)
    train = ArrayLoader(train.data[:UNIT_TRAIN_EXAMPLES], BATCH,
                        shuffle=True, seed=cfg.seed)
    first = train.data[:BATCH]

    # scoring: data init and one eval batch
    flow, gen = model()
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    n_params = sum(p.numel() for p in flow.parameters())
    fused_chain.reset_launches()
    t0 = time.perf_counter()
    exp.maybe_data_init(first)
    logpx = exp.eval_epoch(val)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} data init + eval", launches)
    bpd = exp.to_bpd(logpx)
    print(f"{label}: {n_params} params, data init + eval over 1 batch of "
          f"{BATCH}: log p(x) {logpx:.4f}, BPD {bpd:.4f}; chain kernel "
          f"launches {launches} for 3 passes (144 per pass); {host_s:.1f} s",
          flush=True)
    if not math.isfinite(bpd):
        fail("imagenet32 BPD is not finite")
    if launches != 144 * 3:
        fail(f"expected {144 * 3} chain kernel launches, got {launches}")

    body = Flow(flow.base_distribution, flow.layers[1:])
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    with torch.inference_mode():
        z, lp = body(x + u)
        with plain_chain(fused_chain):
            z_ref, lp_ref = body(x + u)
    rel = ((lp - lp_ref).abs() / lp_ref.abs()).max().item()
    print(f"{label}: log p(x) kernel vs plain chain on one batch, same "
          f"noise: max rel err {rel:.3e} (tol {LOGPX_RTOL:.0e}); z "
          f"{tuple(z.shape)} max abs diff "
          f"{(z - z_ref).abs().max().item():.3e}", flush=True)
    if z.shape != (BATCH, 48, 4, 4) or not torch.isfinite(lp).all():
        fail("imagenet32 output has the wrong shape or is not finite")
    if not rel <= LOGPX_RTOL:
        fail("imagenet32 log p(x) through the kernel disagrees with the "
             "plain chain")

    def eval_batch():
        return flow.cheap_log_prob(x, exp.generator)

    def eval_batch_plain():
        with plain_chain(fused_chain):
            return flow.cheap_log_prob(x, exp.generator)

    with torch.inference_mode():
        t = ab_ms({"kernel": eval_batch, "plain": eval_batch_plain},
                  reps=1, rounds=2)
    print(f"{label}: eval {t['kernel']:.3f} ms/batch of {BATCH} (plain "
          f"chain {t['plain']:.3f} ms/batch), median of 2 turns {card}",
          flush=True)
    del exp, flow, body, z, z_ref
    torch.cuda.empty_cache()

    # training: data init and one epoch
    flow, gen = model()
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    steps = len(train)
    values, mean_loss, launches, bwd, init_state = counted_epoch(
        exp, first, torch)
    peak_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    print(f"{label}: data init + {len(values)} steps of {BATCH} (Adam lr "
          f"{cfg.lr}, no warmup, no scheduler, no clamp): losses "
          f"{', '.join(f'{v:.4f}' for v in values)}; mean {mean_loss:.4f}",
          flush=True)
    print(f"{label}: chain kernel launches {launches} ({launches - bwd} "
          f"forward, {bwd} backward) for data init + {steps} steps "
          f"(144 x 2 + 288 per step); Batch Time Mean "
          f"{exp.batch_time.mean:.3f} ms over the epoch's window; peak "
          f"memory {peak_gb:.3f} GB {card}", flush=True)
    if len(values) != steps or not all(math.isfinite(v) for v in values):
        fail(f"expected {steps} finite imagenet32 losses, got {values}")
    if launches != 144 * 2 + 288 * steps or bwd != 144 * steps:
        fail(f"expected {144 * 2 + 288 * steps} chain kernel launches "
             f"({144 * steps} backward), got {launches} ({bwd})")

    flow.load_state_dict(init_state)
    x = check_grads(label, flow, first, gen, dev, torch)[0]
    step = time_steps(label, exp, x, 1, 2, card, torch)
    device_profile(label, "step", step, 1, card)
    return [dict(r, launches=n) for r, n in zip(rows,
                                                 (launches - bwd, bwd))], exp


def grouped_operands(chw, b, gen, dev, torch):
    """``b`` inputs (C, H, W) and the kernel of a ``FincFlowUnit`` inverse:
    four (C/4, C/4, 3, 3) chunk kernels of the model's init scale
    (normal(0, 0.05)), masked and expanded into one dense block-diagonal
    kernel, as ``layers/padded_conv.py`` does."""
    from inverse_flow_tpu_torch.ops.fused_chain import expand_grouped_kernel
    from inverse_flow_tpu_torch.ops.inv_conv import apply_mask

    c = chw[0]
    x = torch.randn((b,) + chw, generator=gen, device=dev)
    w_eff = torch.cat([apply_mask(0.05 * torch.randn(
        (c // 4, c // 4, 3, 3), generator=gen, device=dev))
        for _ in range(4)])
    return x, [expand_grouped_kernel(w_eff, 4)]


def grouped_rows(gen, dev, card, torch, shapes=FLAGSHIP_SHAPES,
                 batches=(BATCH, 1), label="ff"):
    """FincFlow's level-2 launch (N=1 TL on the expanded groups-4 kernel)
    at its ``shapes`` (the flagship's by default), at each of ``batches``
    (the sample batch and one image): the kernel against its plain version
    to ``1e-5 * max(1, max|y|)``, then its time beside the plain version's,
    the library call's and the bound (which counts nonzero products: the
    zero blocks lower the kernel's share of it). Returns the summary entry
    (times at B=100, means over the shapes) without its launch count."""
    from inverse_flow_tpu_torch.ops import fused_chain

    max_err, rows = 0.0, []
    for b in batches:
        for chw in shapes:
            x, ws = grouped_operands(chw, b, gen, dev, torch)
            args = fused_chain.chain_inputs(x, ws, ("TL",))
            with torch.inference_mode():
                y = fused_chain.chain_phases(*args)
                torch.cuda.synchronize()
                ref = fused_chain.chain_phases_reference(*args)
            err = (y - ref).abs().max().item()
            tol = 1e-5 * max(1.0, ref.abs().max().item())
            max_err = max(max_err, err)
            if not err <= tol:
                fail(f"the grouped chain kernel disagrees with its plain "
                     f"version at {b} x {chw}: {err} > {tol}")
            t, (bound, bound_by, fma), lib_err = time_launch(
                x, ws, ("TL",), False, 100, 4, torch)
            if b == BATCH:
                rows.append((t["kernel"], t["streaming"], t["plain"],
                             t["library"], bound))
            print(f"{label}: kernel ({b},{','.join(map(str, chw))}) "
                  f"groups-4 TL: max_abs_err {err:.3e} (tol {tol:.3e}); "
                  f"{launch_times(t, bound, bound_by, fma)}; library vs "
                  f"kernel max abs diff {lib_err:.3e} {card}", flush=True)
    return dict(mean_row(rows, bound_by), max_abs_err=max_err)


def sample_noise(flow, n, gen, dev, torch):
    """Draws for ``flow.layers[1:]`` (the flow without its
    Dequantization) as ``Flow.sample`` takes them: z from the base and
    each SplitPrior's factored-out half, keyed by its index there."""
    from inverse_flow_tpu_torch.layers import SplitPrior

    noise = {"base": torch.randn((n,) + tuple(flow.base_distribution.size),
                                 generator=gen, device=dev)}
    for i, layer in enumerate(flow.layers[1:]):
        if isinstance(layer, SplitPrior):
            noise[i] = torch.randn((n,) + tuple(layer.base.size),
                                   generator=gen, device=dev)
    return noise


def block_magnitudes(flow, noise, torch):
    """One ``Flow.sample`` on ``noise`` with max|z| taken after every
    layer's inverse. Returns [(layer type, max|z|)] in sampling order."""
    from inverse_flow_tpu_torch.layers import Flow

    body = Flow(flow.base_distribution, flow.layers[1:])
    return [(name, z.abs().max().item())
            for name, z in sample_states(body, noise, torch)]


def flagship_sample(flow, gen, card, torch):
    """The flagship's ``Flow.sample`` of 100 images: no chain launch (its
    inverse is the masked conv), 33 forward launches of the coupling nets'
    kernel (the counts set to 0 just before), finite samples, ms per 100.
    Returns the nets' launches by kind."""
    from inverse_flow_tpu_torch.ops import coupling_net, fused_chain

    fused_chain.reset_launches()
    coupling_net.reset_launches()
    x = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    nets = dict(coupling_net.coupling_net_hidden.launches_by_kind)
    t = ab_ms({"sample": lambda: flow.sample(BATCH, gen)}, reps=1, rounds=4)
    print(f"sample: flagship Flow.sample of {BATCH}: {launches} chain kernel "
          f"launches, values {x.min().item():.0f}..{x.max().item():.0f}; "
          f"{t['sample']:.3f} ms per {BATCH} images, median of 4 {card}",
          flush=True)
    print(f"sample: coupling net launches {nets} (33 forward a draw)",
          flush=True)
    if launches != 0 or x.shape != (BATCH, 1, 28, 28) \
            or not torch.isfinite(x).all():
        fail("the flagship's samples launched the chain or are not finite")
    if nets != {"forward": 33, "backward": 0, "reduce": 0}:
        fail(f"expected 33 forward coupling net launches a draw, got {nets}")
    return nets


def phase_ff(dev, gen, card, torch):
    """Phase 9: ``ff_glow_mnist`` as the registry builds it
    (``inverse_flow_tpu/experiments/registry.py:197-206``): L=2 x K=16
    ``FincFlowUnit``, width 512, RQ spline 5 bins, batch 100, random
    weights from seed 0, synthetic MNIST. Its training forward is a
    grouped masked conv; its inverse, the sampling direction, is FincFlow's
    level 2 on the chain kernel: 32 launches per ``Flow.sample``.

    The grouped launch against its plain version and timed
    (:func:`grouped_rows`); data init and one eval batch (no launch);
    sampling on the data-initialised model at its init scale: one
    ``Flow.sample`` with its launches counted and max|z| after every layer,
    ``Experiment.sample`` (100 one-image samples, then 100 images and
    their grid), kernel vs plain chain on the same draws before the final
    floor, each RepeatedBlock's and one FincFlowUnit's round trip, sample
    ms per 100 images and per image against the plain chain, a profiled
    sample, the host ms by layer type of one sample, and peak memory;
    then one epoch of 10 train steps with the registry's config: no
    launch, finite losses, weights within the clamp, ms/step. Returns the
    summary entry, its launches those of one ``Flow.sample``."""
    from inverse_flow_tpu_torch.data import ArrayLoader, mnist
    from inverse_flow_tpu_torch.layers import Flow, RepeatedBlock
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    label, t_phase = "ff", time.perf_counter()
    row = grouped_rows(gen, dev, card, torch)

    gen = torch.Generator(dev).manual_seed(0)
    flow = build_glow((1, 28, 28), step_kind="ff", num_blocks=2,
                      block_size=16, coupling_width=512, actnorm=True,
                      split_prior=True, activation="Spline", generator=gen,
                      device=dev)
    out = os.path.join(HERE, "chiprun_out")
    cfg = ExperimentConfig(
        name="2L-16K FF Glow MNIST", lr=1e-5, batch_size=BATCH,
        modified_grad=True, add_recon_grad=True, sym_recon_grad=True,
        recon_loss_weight=10.0, weight_clamp=0.01, scheduler_name="None",
        max_eval_ex=BATCH, plot_recon=False,
        sample_dir=os.path.join(out, "samples_ff"),
        metrics_path=os.path.join(out, "ff_metrics.jsonl"), seed=0)
    with warnings.catch_warnings(record=True):   # phase 5 printed it
        warnings.simplefilter("always")
        train, val, test = mnist.load_data(batch_size=BATCH, seed=cfg.seed)
    train = ArrayLoader(train.data[:TRAIN_EXAMPLES], BATCH, shuffle=True,
                        seed=cfg.seed)
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    n_params = sum(p.numel() for p in flow.parameters())
    first = train.data[:BATCH]

    fused_chain.reset_launches()
    exp.maybe_data_init(first)
    bpd = exp.to_bpd(exp.eval_epoch(val))
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    print(f"{label}: {cfg.name} {n_params} params, data init + eval over 1 "
          f"batch of {BATCH}: BPD {bpd:.4f}; chain kernel launches "
          f"{launches} (the forward is a grouped conv)", flush=True)
    if not math.isfinite(bpd) or launches:
        fail(f"ff scoring: BPD {bpd}, {launches} chain launches")

    # ---- sampling, the main path: counts set to 0 just before ----------
    torch.cuda.reset_peak_memory_stats(dev)
    fused_chain.reset_launches()
    x = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    sample_launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} Flow.sample", sample_launches)
    print(f"{label}: Flow.sample of {BATCH}: {sample_launches} chain kernel "
          f"launches (one per FincFlowUnit: 16 + 16); values "
          f"{x.min().item():.0f}..{x.max().item():.0f}", flush=True)
    if sample_launches != 32:
        fail(f"expected 32 chain kernel launches per Flow.sample, got "
             f"{sample_launches}")
    if x.shape != (BATCH, 1, 28, 28) or not torch.isfinite(x).all():
        fail("ff samples have the wrong shape or are not finite")

    noise = sample_noise(flow, BATCH, gen, dev, torch)
    mags = block_magnitudes(flow, noise, torch)
    print(f"{label}: max|z| after each layer's inverse, in sampling order: "
          + ", ".join(f"{name} {m:.4g}" for name, m in mags), flush=True)

    body = Flow(flow.base_distribution, flow.layers[1:])
    y = body.sample(BATCH, noise=noise)
    with plain_chain(fused_chain):
        y_ref = body.sample(BATCH, noise=noise)
    rel = ((y - y_ref).norm() / y_ref.norm()).item()
    print(f"{label}: samples before the floor, kernel vs plain chain on the "
          f"same draws: |y - y_plain| / |y_plain| {rel:.3e} (tol "
          f"{SAMPLE_RTOL:.0e}); max abs diff "
          f"{(y - y_ref).abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(y).all() and rel <= SAMPLE_RTOL):
        fail("ff samples through the kernel disagree with the plain chain")

    with torch.inference_mode():
        xb = torch.as_tensor(first, device=dev)
        h = xb + torch.rand(xb.shape, generator=gen, device=dev)
        trips = []
        for layer in flow.layers[1:]:
            if isinstance(layer, RepeatedBlock):
                z = layer(h)[0]
                trips.append(((layer.inverse(z) - h).norm()
                              / h.norm()).item())
                if len(trips) == 1:
                    unit, p = layer.steps[1], layer._step_params(0)[1]
                    u = torch.randn(h.shape, generator=gen, device=dev)
                    unit_trip = ((unit.inverse_with(p, unit.forward_with(
                        p, u)[0]) - u).norm() / u.norm()).item()
            h = layer(h)[0]
    print(f"{label}: round trips |inverse(forward(x)) - x| / |x|: "
          f"RepeatedBlocks {', '.join(f'{r:.3e}' for r in trips)}; one "
          f"FincFlowUnit {unit_trip:.3e} (tol {SAMPLE_RTOL:.0e})", flush=True)
    if not max(trips + [unit_trip]) <= SAMPLE_RTOL:
        fail("an ff inverse does not undo its forward")

    t = ab_ms({"kernel": lambda: flow.sample(BATCH, gen),
               "plain": lambda: plain_sample(flow, BATCH, gen)},
              reps=1, rounds=4)
    t1 = ab_ms({"kernel": lambda: flow.sample(1, gen),
                "plain": lambda: plain_sample(flow, 1, gen)},
               reps=1, rounds=4)
    print(f"{label}: Flow.sample {t['kernel']:.3f} ms per {BATCH} images "
          f"(plain chain {t['plain']:.3f}), {t1['kernel']:.3f} ms per image "
          f"at n=1 (plain chain {t1['plain']:.3f}), CUDA events, medians of "
          f"4 turns {card}", flush=True)
    busy, calls, _ = device_profile("sample_ff", "Flow.sample",
                                    lambda: flow.sample(BATCH, gen), 2, card)
    host_by_layer(flow, "inverse_with", lambda: flow.sample(BATCH, gen),
                  f"Flow.sample of {BATCH}", torch)

    fused_chain.reset_launches()
    samples = exp.sample(1)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} Experiment.sample", launches)
    n_one = max(5, min(cfg.n_samples, 100))
    png = os.path.join(cfg.sample_dir, "1.png")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{label}: Experiment.sample: Sample Time Mean "
          f"{exp.sample_time.mean:.3f} ms, Std {exp.sample_time.std:.3f} ms "
          f"(the middle {n_one - 2 * (n_one // 5)} of {n_one} one-image "
          f"samples); {launches} chain kernel launches (32 x {n_one + 2}); "
          f"grid {os.path.relpath(png, HERE)}; peak memory while sampling "
          f"{peak_gb:.3f} GB {card}", flush=True)
    if launches != 32 * (n_one + 2) or not os.path.exists(png) \
            or not torch.isfinite(samples).all():
        fail(f"Experiment.sample: {launches} launches, grid written "
             f"{os.path.exists(png)}")

    # ---- training: FincFlow's forward reaches no chain ------------------
    values, mean_loss, launches, bwd, _ = counted_epoch(exp, first, torch)
    w_max = max(p.detach().abs().max().item() for p in flow.parameters())
    xb = torch.as_tensor(first, device=dev)
    ts = ab_ms({"step": lambda: exp.train_step(xb)}, reps=2, rounds=4)
    print(f"{label}: {len(values)} steps of {BATCH} (Adam lr {cfg.lr}, "
          f"warmup {cfg.warmup_epochs} epochs, no scheduler, clamp "
          f"{cfg.weight_clamp}, recon weight {cfg.recon_loss_weight} and no "
          f"recon layer): losses {', '.join(f'{v:.4f}' for v in values)}; "
          f"chain kernel launches {launches}; max |weight| {w_max:.6f}; "
          f"{ts['step']:.3f} ms/step, median of 4 turns of 2 {card}",
          flush=True)
    if len(values) != len(train) or not all(map(math.isfinite, values)):
        fail(f"expected {len(train)} finite ff losses, got {values}")
    if launches or bwd:
        fail(f"ff training launched the chain kernel {launches} times")
    if not w_max <= cfg.weight_clamp * (1 + 1e-6):
        fail(f"an ff weight exceeds the clamp: {w_max}")
    print(f"{label}: per Flow.sample of {BATCH}: device busy {busy:.3f} ms, "
          f"{calls:.0f} kernel launch calls, {sample_launches} chain "
          f"launches; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(row, launches=sample_launches)


def slr_bound(n, steps=None):
    """(bound_ms, bound_by) of one SmoothLeakyRelu inverse on ``n``
    elements: the larger of its bytes (y read, x written: 8 a element) at
    the HBM rate and its special-function operations (``SLR_MUFU_PER_STEP``
    a Newton step) at the SFU rate, over ``steps`` Newton steps in all
    (the steps these inputs need), or 100 an element when not given."""
    from inverse_flow_tpu_torch.ops.activations import NEWTON_ITERS

    steps = NEWTON_ITERS * n if steps is None else steps
    bytes_ms = 8 * n / PEAK_BYTES_PER_S * 1e3
    ops_ms = SLR_MUFU_PER_STEP * steps / PEAK_MUFU_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def slr_inputs(shape, gen, dev, torch):
    """y uniform in [-40, 40], both ends included."""
    y = 40.0 * (2 * torch.rand(shape, generator=gen, device=dev) - 1)
    y.view(-1)[:2] = torch.tensor([40.0, -40.0], device=dev)
    return y


def slr_steps(y, alpha, torch):
    """The Newton steps these inputs need under the kernel's exit test
    (``slr_inverse_steps`` at ``SLR_EXIT_TOL``): (the sum over elements,
    the mean, the mean over warps of 32 consecutive elements of their
    maximum, which is what a warp runs)."""
    from inverse_flow_tpu_torch.ops import activations as act

    steps = act.slr_inverse_steps(y.reshape(-1), alpha,
                                  tol=act.SLR_EXIT_TOL)
    pad = (-steps.numel()) % 32
    warps = torch.cat([steps, steps.new_zeros(pad)]).view(-1, 32)
    return (int(steps.sum()), steps.float().mean().item(),
            warps.max(1).values.float().mean().item())


def check_slr(gen, dev, card, torch):
    """The SLR-inverse kernel against its plain loop at every launch shape
    of the main paths (``SLR_SHAPES``), |y| up to 40, within ``1e-5 *
    max(1, max|y|)``; timed in turns with the device behind the host (as
    :func:`time_launch`) beside the first design (all 100 steps, forced),
    the plain loop and two bounds (:func:`slr_bound`): on the steps these
    inputs need (:func:`slr_steps`, printed with their mean and warp
    maximum) and on 100 steps an element. No single PyTorch call computes
    the function, so there is no library time. Then alpha 0.005, where the
    f' floor of 1e-2 binds (at the models' alpha 0.3 it never does: f' >=
    alpha), within ``1e-5 * max(1, max|x|)``, x being 200 times y there.
    Returns the summary entry's numbers, its times means over imagenet32's
    three shapes at B=100."""
    from inverse_flow_tpu_torch.ops import activations as act

    rows, max_err = [], 0.0
    for shape in SLR_SHAPES:
        y = slr_inputs(shape, gen, dev, torch)
        with torch.inference_mode():
            x = act.slr_inverse(y, SLR_ALPHA)
            ref = act.slr_inverse_reference(y, SLR_ALPHA)
            torch.cuda.synchronize()
            err = (x - ref).abs().max().item()
            lim = 1e-5 * max(1.0, y.abs().max().item())
            res = (act.slr(x, SLR_ALPHA) - y).abs().max().item()
            fixed_err = (act.slr_inverse(y, SLR_ALPHA, variant="fixed")
                         - ref).abs().max().item()
            total, mean, warp_max = slr_steps(y, SLR_ALPHA, torch)
            # the kernels in runs of 50 (a few us each: shorter runs let
            # the host's enqueue into the time), the plain loop of 3
            t = dict(ab_ms({"kernel": lambda: act.slr_inverse(y, SLR_ALPHA),
                            "fixed": lambda: act.slr_inverse(
                                y, SLR_ALPHA, variant="fixed")},
                           reps=50, rounds=4, ahead=True),
                     **ab_ms({"plain": lambda: act.slr_inverse_reference(
                         y, SLR_ALPHA)}, reps=3, rounds=2))
        bound, bound_by = slr_bound(y.numel(), total)
        bound_100, _ = slr_bound(y.numel())
        print(f"slr: {shape}: kernel {1e3 * t['kernel']:.2f} us, first "
              f"design (100 steps) {1e3 * t['fixed']:.2f} us, plain loop "
              f"{1e3 * t['plain']:.2f} us per call; steps needed mean "
              f"{mean:.3f}, warp maximum mean {warp_max:.3f}; bound "
              f"{1e3 * bound:.3f} us on those steps ({bound_by}; the kernel "
              f"at {bound / t['kernel']:.2%} of it), {1e3 * bound_100:.3f} "
              f"us on 100 steps (the first design at "
              f"{bound_100 / t['fixed']:.2%}); max abs err vs plain "
              f"{err:.3e}, first design {fixed_err:.3e} (limit {lim:.1e}), "
              f"|slr(x) - y| {res:.3e} {card}", flush=True)
        if not (err <= lim and fixed_err <= lim):
            fail(f"an SLR-inverse kernel disagrees with its plain loop at "
                 f"{shape}: {err}, first design {fixed_err}")
        max_err = max(max_err, err)
        if shape in SLR_SHAPES[:3]:
            rows.append((t["kernel"], t["fixed"], t["plain"], bound,
                         bound_100, mean, warp_max))
            row_bound_by = bound_by
    y = slr_inputs((BATCH, 12, 16, 16), gen, dev, torch)
    with torch.inference_mode():
        x = act.slr_inverse(y, 0.005)
        ref = act.slr_inverse_reference(y, 0.005)
        err = (x - ref).abs().max().item()
        lim = 1e-5 * max(1.0, ref.abs().max().item())
        floored = (act.slr_prime(ref, 0.005) < act.FPRIME_FLOOR).float()
        _, mean, warp_max = slr_steps(y, 0.005, torch)
    print(f"slr: alpha 0.005 at {tuple(y.shape)}: f' floored at "
          f"{floored.mean().item():.1%} of the elements; max|x| "
          f"{ref.abs().max().item():.1f}; steps needed mean {mean:.3f}, "
          f"warp maximum mean {warp_max:.3f}; max abs err vs plain "
          f"{err:.3e} (limit {lim:.1e})", flush=True)
    if not (err <= lim and floored.any()):
        fail("the SLR-inverse kernel disagrees with its plain loop where "
             "the floor binds")
    ms, fixed_ms, plain_ms, bound_ms, bound_100, mean, warp_max = (
        statistics.fmean(c) for c in zip(*rows))
    return dict(max_abs_err=max_err, ms=ms, fixed_ms=fixed_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=row_bound_by,
                bound_100_steps_ms=bound_100, steps_mean=mean,
                steps_warp_max=warp_max, library_ms=None)


def plain_slr():
    """A context in which every SmoothLeakyRelu inverse runs the plain
    loop."""
    from inverse_flow_tpu_torch.layers import activations
    from inverse_flow_tpu_torch.ops.activations import slr_inverse_reference

    return mock.patch.object(activations, "slr_inverse",
                             slr_inverse_reference)


def block_growth(flow, gen, dev, torch):
    """The first block in sampling order (imagenet32's level 3: 48 steps)
    inverted step by step from one base draw of 8, once through the SLR
    kernel and once through the plain loop: max|z| after each step, and
    the two paths' relative difference by norm after each step. Returns
    both lists."""
    from inverse_flow_tpu_torch.layers import RepeatedBlock

    block = [l for l in flow.layers if isinstance(l, RepeatedBlock)][-1]
    z = torch.randn((8,) + tuple(flow.base_distribution.size),
                    generator=gen, device=dev)
    z_ref, mags, rels = z, [], []
    with torch.inference_mode():
        for k in reversed(range(block.n_repeats)):
            for layer, pk in reversed(list(zip(block.steps,
                                               block._step_params(k)))):
                z = layer.inverse_with(pk, z)
                with plain_slr():
                    z_ref = layer.inverse_with(pk, z_ref)
            mags.append(z.abs().max().item())
            rels.append(((z - z_ref).norm() / z_ref.norm()).item())
    return mags, rels


def sample_imagenet32(exp, gen, card, torch):
    """imagenet32's sampling direction on phase 8's model: one
    ``Flow.sample`` of 100 with the launch counts set to 0 just before (144
    SLR-kernel launches, one per SmoothLeakyRelu, and no chain launch: the
    unit's inverse is its masked convs). At random init the sample
    overflows float32: an SLR inverse maps a large negative y to y / alpha,
    3.33 times farther out, and nothing of the untrained steps pulls it
    back, so max|z| grows several times a step and passes float32's
    3.4e38 well before step 144; the same arithmetic in any
    implementation. So the phase prints that growth, step by step through
    the first block, holds the kernel against the plain loop on the same
    draw after each of the first 6 steps (still finite) to
    ``SAMPLE_RTOL`` by norm, checks one SLR round trip,
    and leaves finite samples to the trained real-data models
    (:func:`real_data_phase`). Then ``Flow.sample`` of 100 and of 1 and
    ``Experiment.sample`` (``n_samples`` 8 with ``log_timing``: 8 timed
    one-image samples after one warm-up, then 8 images) with the kernel
    and with the plain loop, ``Experiment.sample`` and one profiled
    ``Flow.sample`` of 1 with the kernel only (the plain loop's took half
    a minute). Returns the SLR kernel's launches per sample."""
    from inverse_flow_tpu_torch.layers import SmoothLeakyRelu
    from inverse_flow_tpu_torch.ops import activations as act
    from inverse_flow_tpu_torch.ops import fused_chain

    label, flow, dev = "sample_imagenet32", exp.flow, exp.device
    fused_chain.reset_launches()
    act.reset_slr_launches()
    x = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    slr_launches = act.slr_inverse.launches_by_variant["early_exit"]
    chain = fused_chain.chain_phases.launches
    print(f"{label}: Flow.sample of {BATCH}: {slr_launches} SLR-kernel "
          f"launches ({act.slr_inverse.launches_by_variant}), {chain} chain "
          f"launches; shape {tuple(x.shape)}, finite values "
          f"{torch.isfinite(x).float().mean().item():.1%}", flush=True)
    if slr_launches != 144 or act.slr_inverse.launches != 144 or chain != 0:
        fail(f"expected 144 SLR-kernel launches and no chain launch per "
             f"imagenet32 sample, got {slr_launches} and {chain}")
    if x.shape != (BATCH, 3, 32, 32):
        fail("imagenet32 samples have the wrong shape")

    mags, rels = block_growth(flow, gen, dev, torch)
    finite = [m for m in mags if math.isfinite(m)]
    print(f"{label}: max|z| after each step of the first block in sampling "
          f"order: {', '.join(f'{m:.3g}' for m in mags[:12])}, ...; "
          f"finite for {len(finite)} of {len(mags)} steps, x"
          f"{(finite[-1] / finite[0]) ** (1 / max(1, len(finite) - 1)):.3g} "
          f"a step; SLR kernel vs plain loop on the same draw, "
          f"|z - z_plain| / |z_plain| after steps 1-6: "
          f"{', '.join(f'{r:.2e}' for r in rels[:6])} (tol "
          f"{SAMPLE_RTOL:.0e})", flush=True)
    if not (len(finite) >= 6 and max(rels[:6]) <= SAMPLE_RTOL):
        fail("imagenet32's block inverse through the SLR kernel disagrees "
             "with the plain loop")

    layer = SmoothLeakyRelu(SLR_ALPHA)
    u = 3 * torch.randn((BATCH, 12, 16, 16), generator=gen, device=dev)
    with torch.inference_mode():
        rel = ((layer.inverse(layer(u)[0]) - u).norm() / u.norm()).item()
    print(f"{label}: SLR round trip |inverse(forward(x)) - x| / |x| "
          f"{rel:.3e} at {tuple(u.shape)} (tol {SAMPLE_RTOL:.0e})",
          flush=True)
    if not rel <= SAMPLE_RTOL:
        fail("the SLR inverse does not undo its forward")

    def plain_sample(n):
        with plain_slr():
            return flow.sample(n, gen)

    t = {n: ab_ms({"kernel": lambda n=n: flow.sample(n, gen),
                   "plain": lambda n=n: plain_sample(n)},
                  reps=1, rounds=2) for n in (BATCH, 1)}
    print(f"{label}: Flow.sample {t[BATCH]['kernel']:.3f} ms per {BATCH} "
          f"images (plain loop {t[BATCH]['plain']:.3f}), {t[1]['kernel']:.3f} "
          f"ms per image at n=1 (plain loop {t[1]['plain']:.3f}: "
          f"{t[1]['plain'] / t[1]['kernel']:.1f}x), CUDA events, medians of "
          f"2 turns {card}", flush=True)
    device_profile(label, "Flow.sample of 1", lambda: flow.sample(1, gen),
                   1, card)

    exp.cfg = exp.cfg.replace(n_samples=8, log_timing=True,
                              save_images=False)
    exp.sample_time = type(exp.sample_time)()
    act.reset_slr_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = exp.sample(1)
    torch.cuda.synchronize()
    whole = 1e3 * (time.perf_counter() - t0)
    launches = act.slr_inverse.launches
    print(f"{label}: Experiment.sample: Sample Time Mean "
          f"{exp.sample_time.mean:.3f} ms, Std {exp.sample_time.std:.3f} ms "
          f"(the middle 6 of 8 one-image samples); the whole call "
          f"{whole:.1f} ms; SLR-kernel launches {launches} {card}",
          flush=True)
    if samples.shape != (8, 3, 32, 32) or launches != 144 * 10:
        fail(f"Experiment.sample gave {tuple(samples.shape)}, {launches} "
             f"SLR-kernel launches (expected 1440)")
    return slr_launches


def artifact(name):
    """The TPU artifact's rows of a real-data run (results/<name>.jsonl):
    per-epoch rows, and the final row."""
    with open(os.path.join(HERE, "results", f"{name}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return rows[:-1], rows[-1]


def real_data_phase(name, epochs, dev, card, torch):
    """``name`` (``real_digits_glow`` or ``real_patches_glow``) through
    ``Experiment.run()`` for ``epochs`` epochs with the real-data script's
    overrides, then the test split (:mod:`experiments.real_data`): val BPD
    per epoch, seconds per epoch and ms per train step (host clock, synced
    around each ``train_epoch``), chain launches by variant with each
    launch shape's variant, SLR-kernel launches (the samples of epochs 1-4
    and 10), the peak memory of any epoch; then the trained model's
    ``Flow.sample`` of 100 (finite, and the SLR kernel against the plain
    loop on the same draws) and two more train steps profiled. Fails
    unless every BPD is finite and the last val BPD is at least 1.0 below
    the first. Returns (rows, final)."""
    from inverse_flow_tpu_torch.experiments.real_data import (
        real_data_experiment, run_real_data)
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.ops import activations as act
    from inverse_flow_tpu_torch.ops import fused_chain

    out = os.path.join(HERE, "chiprun_out", "real_data")
    exp = real_data_experiment(name, epochs, dev, seed=0, out_dir=out)
    exp.logger.verbose = False
    steps = len(exp.train_loader)
    epoch_s, shapes = [], set()
    train_epoch, variant_of = exp.train_epoch, fused_chain.chain_variant

    def timed_epoch(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_epoch(e)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return loss

    def recorded_variant(rcw, kcw):
        shapes.add((rcw, kcw))
        return variant_of(rcw, kcw)

    fused_chain.reset_launches()
    act.reset_slr_launches()
    t0 = time.perf_counter()
    with mock.patch.object(exp, "train_epoch", timed_epoch), \
            mock.patch.object(fused_chain, "chain_variant", recorded_variant):
        rows, final = run_real_data(exp)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    by = dict(fused_chain.chain_phases.launches_by_variant)
    slr = act.slr_inverse.launches
    with open(exp.cfg.metrics_path) as f:
        peaks = [r["value"] for r in map(json.loads, f)
                 if r["name"] == "Memory peak_mb"]
    bpds = [r["val_bpd"] for r in rows]
    n_params = sum(p.numel() for p in exp.flow.parameters())
    print(f"{name}: {exp.cfg.name}, {n_params} params, {epochs} epochs of "
          f"{steps} steps of {exp.cfg.batch_size} through run(): val BPD by "
          f"epoch "
          f"{', '.join(f'{b:.4f}' for b in bpds)}", flush=True)
    print(f"{name}: final test BPD {final['test_bpd']:.4f}, first / best / "
          f"last val BPD {final['first_val_bpd']:.4f} / "
          f"{final['best_val_bpd']:.4f} / {final['last_val_bpd']:.4f}; "
          f"train losses {rows[0]['train_loss']:.3f} -> "
          f"{rows[-1]['train_loss']:.3f}", flush=True)
    print(f"{name}: {statistics.median(epoch_s):.3f} s per train epoch "
          f"(median; first {epoch_s[0]:.3f} with data init), "
          f"{1e3 * statistics.median(epoch_s) / steps:.3f} ms per train "
          f"step, host clock synced around train_epoch; the run "
          f"{total_s:.1f} s with eval, test and samples; peak memory "
          f"{max(peaks) / 1024:.3f} GB {card}", flush=True)
    n_samples = sum(1 for e in range(1, epochs + 1) if e < 5 or e == 10)
    print(f"{name}: chain launches by variant {by}; SLR-kernel launches "
          f"{slr} (8 a sample x {n_samples} samples)", flush=True)
    for rcw, kcw in sorted(shapes):
        v = variant_of(rcw, kcw)
        why = "" if v == "cluster" else (
            f": {fused_chain._cluster_cols(rcw)} columns a CTA (at most "
            f"{fused_chain.CLUSTER_MAX_COLS}), "
            f"{fused_chain.cluster_smem_bytes(rcw, kcw)} bytes of shared "
            f"memory (at most {fused_chain.SMEM_LIMIT})")
        print(f"{name}: launch shape RCW={rcw} KCW={kcw} -> {v}{why}",
              flush=True)
    gen, dev = exp.generator, exp.device
    x = exp.flow.sample(BATCH, gen)
    body = Flow(exp.flow.base_distribution, exp.flow.layers[1:])
    noise = sample_noise(exp.flow, BATCH, gen, dev, torch)
    y = body.sample(BATCH, noise=noise)
    with plain_slr():
        y_ref = body.sample(BATCH, noise=noise)
    rel = ((y - y_ref).norm() / y_ref.norm()).item()
    print(f"{name}: the trained model's Flow.sample of {BATCH}: values "
          f"{x.min().item():.0f}..{x.max().item():.0f}, all finite "
          f"{bool(torch.isfinite(x).all())}; before the floor, SLR kernel vs "
          f"plain loop on the same draws |y - y_plain| / |y_plain| "
          f"{rel:.3e} (tol {SAMPLE_RTOL:.0e})", flush=True)
    if not (torch.isfinite(x).all() and torch.isfinite(y).all()
            and rel <= SAMPLE_RTOL):
        fail(f"{name}: the trained model's samples are not finite or "
             f"disagree with the plain loop")
    xb = exp._prep_batch(next(iter(exp.train_loader)))
    device_profile(name, "step", lambda: exp.train_step(xb), 2, card)
    if not all(map(math.isfinite, bpds + [final["test_bpd"]])):
        fail(f"{name}: a BPD is not finite")
    if not bpds[-1] <= bpds[0] - 1.0:
        fail(f"{name}: val BPD fell from {bpds[0]} to only {bpds[-1]}")
    if slr != 8 * n_samples or sum(by.values()) == 0:
        fail(f"{name}: {slr} SLR-kernel launches (expected "
             f"{8 * n_samples}), chain launches {by}")
    return rows, final


def phase_real_data(dev, card, torch):
    """Phase 10's real-data part: ``real_digits_glow`` for 40 epochs, its
    test BPD against the TPU artifact's to ``DIGITS_TEST_TOL``;
    ``real_patches_glow`` for ``PATCHES_EPOCHS``, its best val BPD against
    the artifact's (at 40 epochs; at fewer, its val BPD at that epoch
    against the artifact's line for it) to ``PATCHES_VAL_TOL``. Returns
    the digits run's rows."""
    digits_rows, final = real_data_phase("real_digits_glow", REAL_EPOCHS,
                                         dev, card, torch)
    ref = artifact("real_digits_bpd")[1]["test_bpd"]
    print(f"real_digits_glow: test BPD {final['test_bpd']:.4f} against the "
          f"TPU artifact's {ref} (results/real_digits_bpd.jsonl): "
          f"{final['test_bpd'] - ref:+.4f} (tol {DIGITS_TEST_TOL})",
          flush=True)
    if not abs(final["test_bpd"] - ref) <= DIGITS_TEST_TOL:
        fail("real_digits_glow's test BPD is off the artifact's")

    rows, final = real_data_phase("real_patches_glow", PATCHES_EPOCHS, dev,
                                  card, torch)
    ref_rows, ref_final = artifact("real_patches_bpd")
    if PATCHES_EPOCHS == 40:
        what, ours, ref = "best val BPD", final["best_val_bpd"], \
            ref_final["best_val_bpd"]
    else:
        what = f"val BPD at epoch {PATCHES_EPOCHS} (the run is cut short)"
        ours, ref = rows[-1]["val_bpd"], \
            ref_rows[PATCHES_EPOCHS - 1]["val_bpd"]
    print(f"real_patches_glow: {what} {ours:.4f} against the TPU "
          f"artifact's {ref} (results/real_patches_bpd.jsonl): "
          f"{ours - ref:+.4f} (tol {PATCHES_VAL_TOL})", flush=True)
    if not abs(ours - ref) <= PATCHES_VAL_TOL:
        fail(f"real_patches_glow's {what} is off the artifact's")
    return digits_rows


def phase_resume(dev, whole_rows, card, torch):
    """A digits run saved after epoch 2 and loaded into a fresh Experiment
    with the generator's state copied over and the train loader advanced
    by the 2 epochs it served (its shuffle runs on the native prefetcher's
    own thread, whose state cannot be copied): epoch
    3's mean loss against that of the 40-epoch run, which did not stop
    (``whole_rows``; its first epochs do the same work, since the epoch
    count changes nothing before the last), to ``RESUME_RTOL``; data init
    does not run again."""
    from inverse_flow_tpu_torch.experiments.real_data import (
        real_data_experiment)

    out = os.path.join(HERE, "chiprun_out", "real_data")

    def make(epochs, tag):
        exp = real_data_experiment("real_digits_glow", epochs, dev, 0, out,
                                   tag)
        exp.logger.verbose = False
        return exp

    def losses(exp):
        exp.logger.close()
        with open(exp.cfg.metrics_path) as f:
            return [r["value"] for r in map(json.loads, f)
                    if r["name"] == "Train Avg Loss"]

    first = make(2, "_first")
    first.run()
    first.save()
    resumed = make(3, "_resumed")
    resumed.load(first.checkpoint_path)
    resumed.generator.set_state(first.generator.get_state())
    for _ in range(2):
        for _ in resumed.train_loader:
            pass
    resumed.flow.data_init = None                 # must not run again
    resumed.run()
    whole = [r["train_loss"] for r in whole_rows[:3]]
    a, b = losses(resumed)[-1], whole[2]
    rel = abs(a - b) / abs(b)
    print(f"resume: real_digits_glow saved after epoch 2 and resumed: epoch "
          f"3 mean loss {a:.6f} against {b:.6f} without a stop (rel "
          f"{rel:.3e}, tol {RESUME_RTOL:.0e}); epochs 1-2 "
          f"{', '.join(f'{v:.6f}' for v in losses(first))} against "
          f"{', '.join(f'{v:.6f}' for v in whole[:2])} {card}", flush=True)
    if not rel <= RESUME_RTOL or resumed.summary["Epoch"] != 3:
        fail("the resumed run does not continue the run")


def phase_cli(card, name="real_digits_glow"):
    """``cli.main(["--name", name, "--smoke"])`` on the card, in
    ``chiprun_out/cli``: it must finish and print its summary JSON
    last."""
    import io

    from inverse_flow_tpu_torch import cli

    out = os.path.join(HERE, "chiprun_out", "cli")
    os.makedirs(out, exist_ok=True)
    buf = io.StringIO()
    with contextlib.chdir(out), contextlib.redirect_stdout(buf):
        rc = cli.main(["--name", name, "--smoke"])
    last = buf.getvalue().strip().splitlines()[-1]
    summary = json.loads(last)
    print(f"cli: --name {name} --smoke: exit {rc}, summary {last} {card}",
          flush=True)
    if rc != 0 or summary.get("Epoch") != 2 or not math.isfinite(
            summary.get("Test BPD", float("nan"))):
        fail("the CLI's smoke run did not finish")


def tall_model(dev, torch):
    """W1's model as the JAX sweep builds it
    (``inverse_flow_tpu/experiments/timescaling.py``):
    ``Flow(GaussianPrior((1, 4160, 1)), 2 x InvFlowNoPad(1, (2, 2)))``,
    weights from seed 0 at the layer's init plus normal(0, 0.05), so that
    each solve moves x (the init alone is near the identity)."""
    from inverse_flow_tpu_torch.distributions import GaussianPrior
    from inverse_flow_tpu_torch.layers import Flow, InvFlowNoPad

    gen = torch.Generator(dev).manual_seed(0)
    chw = WIDE_SHAPES["W1"][0]
    flow = Flow(GaussianPrior(chw), [
        InvFlowNoPad(1, (2, 2), generator=gen, device=dev)
        for _ in range(2)])
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen, device=dev))
    return flow, gen


def phase_tall(dev, card, torch):
    """W1's model at (128, 1, 4160, 1): one loss and backward with the
    launch counts set to 0 just before and read just after (2 solves
    forward, 2 in the backward, every one on the wide cluster kernel);
    log p(x) and the gradients against the same model on the plain chain,
    to ``LOGPX_RTOL`` and ``GRAD_RTOL``; ms per loss and backward against
    the plain chain and the streaming kernel forced. Returns the
    (forward, backward) launches."""
    from inverse_flow_tpu_torch.ops import fused_chain

    label = "tall"
    flow, gen = tall_model(dev, torch)
    chw, _, b = WIDE_SHAPES["W1"]
    x = torch.randn((b,) + chw, generator=gen, device=dev)
    params = list(flow.parameters())
    solve_bwd = fused_chain.FusedChainSolve.backward
    bwd = [0]

    def counted_backward(ctx, gy):
        before = fused_chain.chain_phases.launches
        out = solve_bwd(ctx, gy)
        bwd[0] += fused_chain.chain_phases.launches - before
        return out

    def step():
        _, lp = flow(x)
        return lp.detach(), torch.autograd.grad(-lp.mean(), params)

    with mock.patch.object(fused_chain.FusedChainSolve, "backward",
                           staticmethod(counted_backward)):
        fused_chain.reset_launches()
        lp, grads = step()
        torch.cuda.synchronize()
        by = dict(fused_chain.chain_phases.launches_by_variant)
    launches = fused_chain.chain_phases.launches
    print(f"{label}: loss and backward at ({b},1,4160,1): {launches} chain "
          f"launches ({bwd[0]} in the backward), by variant {by}", flush=True)
    if by != {"cluster": 0, "cluster_wide": 4, "streaming": 0} or bwd[0] != 2:
        fail(f"W1's model: expected 4 chain launches, 2 of them backward, "
             f"all on the wide cluster kernel; got {by}, {bwd[0]} backward")
    with plain_chain(fused_chain):
        lp_ref, g_ref = step()
    lp_rel = ((lp - lp_ref).abs() / lp_ref.abs()).max().item()
    g_rel = max(((a - r).norm() / r.norm()).item()
                for a, r in zip(grads, g_ref))
    print(f"{label}: log p(x) vs plain chain max rel err {lp_rel:.3e} (tol "
          f"{LOGPX_RTOL:.0e}); gradients max |g - g_plain| / |g_plain| "
          f"{g_rel:.3e} (tol {GRAD_RTOL:.0e}); mean log p(x) "
          f"{lp.mean().item():.4f}", flush=True)
    if not (torch.isfinite(lp).all() and lp_rel <= LOGPX_RTOL
            and g_rel <= GRAD_RTOL):
        fail("W1's model on the wide cluster kernel disagrees with the "
             "plain chain")

    def plain():
        with plain_chain(fused_chain):
            step()

    def streaming():
        with mock.patch.object(fused_chain, "chain_variant",
                               lambda rcw, kcw: "streaming"):
            step()

    t = ab_ms({"kernel": step, "plain": plain, "streaming": streaming},
              reps=3, rounds=4)
    print(f"{label}: {t['kernel']:.3f} ms per loss and backward of {b} on "
          f"the wide cluster kernel (plain chain {t['plain']:.3f}, streaming "
          f"kernel forced {t['streaming']:.3f}), CUDA events, median of 4 "
          f"turns of 3 {card}", flush=True)
    return launches - bwd[0], bwd[0]


def phase_wide(dev, gen, card, torch):
    """Phase 11: the wide cluster kernel. At W1 and W2 (``WIDE_SHAPES``),
    forward and the backward's launch, against its plain version (and dx,
    dW through ``FusedChainSolve``) and timed beside the streaming kernel
    forced, the plain version, the library call and the bound; at the
    edges (``WIDE_EDGES``) checked, not timed; then W1's model
    (:func:`phase_tall`). Returns the summary entries' times and errors
    (means over W1 and W2) and the model's launches."""
    label = "wide"
    on = dict(gen=gen, dev=dev, torch=torch)
    rows, errs = {False: [], True: []}, {False: 0.0, True: 0.0}
    for name, (chw, kernel, b) in WIDE_SHAPES.items():
        shape = dict(b=b, kernel=kernel)
        errs[False] = max(errs[False], check_forward(
            [(chw, ("TL",))], f"{label}: {name}", variant="cluster_wide",
            **shape, **on))
        errs[True] = max(errs[True], check_backward(
            [(chw, ("TL",))], f"{label}: {name} backward", **shape, **on))
        for backward in (False, True):
            row = time_rows([chw], ("TL",), backward, 10, 4,
                            f"{label}: {name}", card=card,
                            variant="cluster_wide", **shape, **on)
            rows[backward].append(row)
    for chw, b in WIDE_EDGES:
        check_forward([(chw, ("TL", "BR"))], f"{label}: edge",
                      variant="cluster_wide", b=b, **on)
        check_backward([(chw, ("TL",))], f"{label}: edge backward", b=b,
                       **on)
    launches = phase_tall(dev, card, torch)

    def mean(rs):
        out = {k: statistics.fmean(r[k] for r in rs)
               for k in rs[0] if k != "bound_by"}
        return dict(out, bound_by=max(rs, key=lambda r: r["bound_ms"])[
            "bound_by"])

    return [dict(mean(rows[bwd]), max_abs_err=errs[bwd], launches=n)
            for bwd, n in ((False, launches[0]), (True, launches[1]))]


# ---------------------------------------------------------------------------
# Phase 12: the paper's comparison baselines
# ---------------------------------------------------------------------------

# the exact log p against the cheap one plus the dense correction, per
# sample (float32 slogdets of 784- and 392-dim operators)
EXACT_RTOL = 1e-4
# exact_cnn_mnist's batch: 125 clusters of 8 rows against about 15
# resident (phase 2 prints the count)
CNN_BATCH = 1000
EMERGING_SHAPES = [(1, 28, 28), (4, 14, 14)]


def emerging_operands(chw, orders, gen, dev, torch, b=BATCH, kernel=(2, 2)):
    """``b`` inputs (C, H, W) and one Emerging autoregressive kernel per
    order (the centre tap lower triangular, ``layers/emerging.py``), its
    diagonal drawn in [0.5, 2] with mixed signs, a non-unit triangle,
    which the masked kernels never give the chain; the other taps of
    :func:`solve_operands`' std 0.1 / sqrt(C), so that the solve stays
    well conditioned (at the layer's init scale, 1 / (2C), one channel's
    inverse can amplify round-off by 1e10)."""
    from inverse_flow_tpu_torch.layers.emerging import square_ar_mask

    c = chw[0]
    x = torch.randn((b,) + chw, generator=gen, device=dev)
    ws = []
    for _ in orders:
        w = 0.1 / math.sqrt(c) * torch.randn((c, c) + tuple(kernel),
                                             generator=gen, device=dev)
        d = 0.5 + 1.5 * torch.rand(c, generator=gen, device=dev)
        sign = torch.randint(0, 2, (c,), generator=gen, device=dev) * 2 - 1
        w[torch.arange(c), torch.arange(c), -1, -1] = d * sign
        ws.append(w * square_ar_mask(c, *kernel, device=dev))
    return x, ws


def baseline(name, dev, torch, n_train, **config):
    """The registry's experiment ``name`` on the card, as a user builds
    it: its model from seed 0 and its config (``config`` overrides it;
    image grids and recon plots off, metrics to ``chiprun_out/``), its
    loaders (synthetic images where the dataset is absent), the train
    split cut to its first ``n_train`` examples. Returns the Experiment
    and its first train batch."""
    from inverse_flow_tpu_torch.data import ArrayLoader
    from inverse_flow_tpu_torch.experiments.registry import get_experiment
    from inverse_flow_tpu_torch.train.experiment import Experiment

    spec = get_experiment(name)
    cfg = spec.config.replace(
        save_images=False, plot_recon=False, seed=0,
        metrics_path=os.path.join(HERE, "chiprun_out",
                                  f"{name}_metrics.jsonl"), **config)
    with warnings.catch_warnings(record=True):   # phase 5 printed it
        warnings.simplefilter("always")
        train, val, test = spec.load_data(batch_size=cfg.batch_size,
                                          seed=cfg.seed)
    train = ArrayLoader(train.data[:n_train], cfg.batch_size, shuffle=True,
                        seed=cfg.seed)
    flow = spec.build_model(device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    return Experiment(flow, train, val, test, cfg, device=dev), \
        train.data[:cfg.batch_size]


def train_baseline(label, exp, first, torch, launches_per_step=0,
                   init_passes=0):
    """``maybe_data_init(first)`` (a no-op when it ran) and one
    ``train_epoch`` over the cut train split, the chain's launch counts
    set to 0 just before and read just after (:func:`counted_epoch`: every
    launch on the cluster kernel): every loss finite, and
    ``launches_per_step`` chain launches a step forward and as many
    backward, beside the data init's ``init_passes`` forward passes (2
    through a Glow's blocks, 1 through a CNN or FC flow). Returns (losses,
    the state after data init)."""
    values, _, launches, bwd, init_state = counted_epoch(exp, first, torch)
    steps = len(values)
    fwd_need = launches_per_step * (init_passes + steps)
    print(f"{label}: {exp.cfg.name}, data init + {steps} steps of "
          f"{exp.cfg.batch_size}: losses "
          f"{', '.join(f'{v:.4f}' for v in values)}; chain kernel launches "
          f"{launches - bwd} forward + {bwd} backward", flush=True)
    if not steps or not all(map(math.isfinite, values)):
        fail(f"{label}: expected finite losses, got {values}")
    if (launches - bwd, bwd) != (fwd_need, launches_per_step * steps):
        fail(f"{label}: expected {fwd_need} + "
             f"{launches_per_step * steps} chain launches, got "
             f"{launches - bwd} + {bwd}")
    return values, init_state


def finite_sample(label, flow, gen, torch, what="Flow.sample"):
    """A ``Flow.sample`` of 100 on the card, cheap and exact, with the
    chain's launches counted; returns whether both are finite."""
    from inverse_flow_tpu_torch.ops import fused_chain

    out = []
    for exact in (False, True):
        fused_chain.reset_launches()
        x = flow.sample(BATCH, gen, exact=exact)
        torch.cuda.synchronize()
        out.append((x, fused_chain.chain_phases.launches))
    print(f"{label}: {what} of {BATCH}, cheap / exact inverses: values "
          + " / ".join(f"{x.min().item():.0f}..{x.max().item():.0f}, "
                       f"finite {bool(torch.isfinite(x).all())}, {n} chain "
                       f"launches" for x, n in out), flush=True)
    return all(bool(torch.isfinite(x).all()) and x.shape[0] == BATCH
               for x, _ in out)


def phase_snf(dev, gen, card, torch):
    """``selfnorm_glow_mnist``, the slice's main path, at its full config
    (L=2 x K=16 SelfNorm 1x1 steps, width 512, no activation, B=100,
    recon weight 100, clamp 0.01, modified gradient): data init and 5
    steps with the recon term (no chain launch); an eval of 2 batches
    with the exact correction, and its time; the exact log p against the
    cheap one plus the correction on one batch; on the data-initialised
    weights ``Flow.sample`` cheap and exact and ``reconstruct(exact=True)``
    (after the steps the registry's clamp of 0.01 leaves W with entries
    of 0.01, whose inverse overflows float32 through 32 layers in any
    implementation: printed, not checked); train ms/step, device busy and
    launch calls per step."""
    from inverse_flow_tpu_torch.layers import Flow

    label = "snf"
    exp, first = baseline("selfnorm_glow_mnist", dev, torch, 5 * BATCH,
                          max_eval_ex=2 * BATCH)
    flow = exp.flow
    values, init_state = train_baseline(label, exp, first, torch)
    print(f"{label}: recon loss of the last step {exp.last_recon.item():.4f} "
          f"(weight {exp.recon_weight.item():.1f}, symmetric "
          f"{exp.cfg.sym_recon_grad})", flush=True)

    logpx = exp.eval_epoch(exp.val_loader)
    corr_ms = ab_ms({"corr": lambda: flow.exact_ldj_correction(
        exp.data_shape)}, reps=1, rounds=2)["corr"]
    with torch.inference_mode():
        corr = flow.exact_ldj_correction(exp.data_shape).item()
    print(f"{label}: eval over 2 batches of {BATCH}: log p(x) {logpx:.4f}, "
          f"BPD {exp.to_bpd(logpx):.4f}, exact correction {corr:.4f} (16 "
          f"dense slogdets of 784^2 and 16 of 392^2, one batched slogdet a "
          f"block: {corr_ms:.3f} ms) {card}", flush=True)
    if not (math.isfinite(logpx) and math.isfinite(corr)):
        fail("selfnorm_glow_mnist eval or its correction is not finite")

    body = Flow(flow.base_distribution, flow.layers[1:])
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    with torch.inference_mode():
        cheap = body(x + u)[1]
        exact = body(x + u, exact=True)[1]
    rel = ((exact - (cheap + corr)).abs() / exact.abs()).max().item()
    print(f"{label}: exact log p(x) vs cheap + correction on one batch: max "
          f"rel err {rel:.3e} (tol {EXACT_RTOL:.0e})", flush=True)
    if not (torch.isfinite(exact).all() and rel <= EXACT_RTOL):
        fail("the exact log p(x) is not the cheap one plus the correction")

    trained = copy.deepcopy(flow.state_dict())
    flow.load_state_dict(init_state)
    if not finite_sample(label, flow, gen, torch,
                         "Flow.sample on the data-initialised weights"):
        fail("selfnorm_glow_mnist samples are not finite")
    rec = flow.reconstruct(x, gen, exact=True)
    print(f"{label}: reconstruct(exact=True) on the data-initialised "
          f"weights: max |x - x_rec| {(rec - x).abs().max().item():.3e}, "
          f"{(rec == x).float().mean().item():.4f} of the pixels equal "
          f"(the SplitPrior's half is drawn anew, as in JAX)", flush=True)
    flow.load_state_dict(trained)
    finite_sample(label, flow, gen, torch,
                  f"Flow.sample after {len(values)} steps under clamp "
                  f"{exp.cfg.weight_clamp}")

    def step():
        exp.train_step(x)

    t = ab_ms({"step": step}, reps=2, rounds=3)
    busy, calls, _ = device_profile("train_snf", "step", step, 1, card)
    print(f"{label}: train {t['step']:.3f} ms/step of {BATCH} (CUDA events, "
          f"median of 3 turns of 2); device busy {busy:.3f} ms and {calls:.0f}"
          f" kernel launch calls per step {card}", flush=True)


def phase_geco(dev, torch):
    """``geco_selfnorm_glow_mnist``: data init and 3 steps, the GECO
    weight after each; every loss finite, the weight finite and rising."""
    label = "geco"
    exp, first = baseline("geco_selfnorm_glow_mnist", dev, torch,
                          3 * BATCH)
    exp.maybe_data_init(first)
    losses, weights = [], []
    for xb in exp.train_loader:
        losses.append(exp.train_step(exp._prep_batch(xb)).item())
        weights.append(exp.recon_weight.item())
    print(f"{label}: {len(losses)} steps: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; recon_weight after "
          f"each {', '.join(f'{w:.9f}' for w in weights)} (lr "
          f"{exp.cfg.recon_loss_lr}, alpha {exp.cfg.recon_alpha}; recon_ema "
          f"{exp.recon_ema.item():.6f})", flush=True)
    if not (all(map(math.isfinite, losses + weights))
            and weights[-1] > 1.0):
        fail("GECO: a loss or the weight is not finite, or the weight did "
             "not move")


def phase_snf_imagenet(dev, card, torch):
    """``selfnorm_glow_imagenet`` at its full config (L=3 x K=48 SelfNorm
    1x1, width 512, B=100) on synthetic (3, 32, 32): data init and one
    step; the exact correction, 48 dense operators of 3072^2 floats at
    the first level (1.8 GB), timed and its peak memory read."""
    label = "snf_imagenet32"
    exp, first = baseline("selfnorm_glow_imagenet", dev, torch, BATCH)
    train_baseline(label, exp, first, torch)
    times = []
    for _ in range(2):                  # the first call loads cuSOLVER
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.inference_mode():
            corr = exp.flow.exact_ldj_correction(exp.data_shape)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    print(f"{label}: exact correction {corr.item():.4f}: {times[0]:.3f} ms "
          f"first call, {times[1]:.3f} ms second (3 x 48 dense slogdets of "
          f"3072^2, 1536^2, 768^2), peak memory above the model's "
          f"{peak_gb:.3f} GB {card}", flush=True)
    if not math.isfinite(corr.item()):
        fail("selfnorm_glow_imagenet's exact correction is not finite")


def phase_conv1x1(dev, gen, torch):
    """``conv1x1_glow_mnist`` (no chain) and ``if_conv1x1_glow_mnist``
    (``InvFlow`` TL 3x3: 32 solves a pass on the cluster kernel): one
    ``Flow.sample`` on the data-initialised weights, then 3 steps each."""
    for name, per_step in (("conv1x1_glow_mnist", 0),
                           ("if_conv1x1_glow_mnist", 32)):
        exp, first = baseline(name, dev, torch, 3 * BATCH)
        exp.maybe_data_init(first)
        if not finite_sample(name, exp.flow, gen, torch,
                             "Flow.sample on the data-initialised weights"):
            fail(f"{name} samples are not finite")
        train_baseline(name, exp, first, torch, per_step)


def phase_emerging(dev, gen, card, torch):
    """``emerging_cnn_mnist`` at its full config (2 blocks x 4 Emerging
    layers, RQ spline 10 bins, tail 70, B=100): the chain kernel on
    Emerging operands (a non-unit diagonal in [0.5, 2]) at the two solve
    shapes against its plain version, timed beside the streaming kernel,
    the plain version, the library call and the bound; data init and 3
    steps (the forward is the masked conv: no launch); ``Flow.sample`` of
    100 with its launches counted (16: 8 layers x 2 AR convs, all
    ``cluster``) and the sample against the plain chain on the same
    draws; each AR conv's round trip ``inverse(forward(x))`` on its input
    in a forward pass, by the kernel and the plain chain, the kernel held
    to 1e-4 wherever the plain chain meets it. Returns the summary
    entry."""
    from inverse_flow_tpu_torch.layers import (Flow,
                                               SquareAutoRegressiveConv2d)
    from inverse_flow_tpu_torch.ops import fused_chain

    label = "emerging"
    on = dict(gen=gen, dev=dev, torch=torch, kernel=(2, 2),
              operands=emerging_operands)
    err = check_forward([(chw, ("TL",)) for chw in EMERGING_SHAPES],
                        f"{label}: kernel", **on)
    row = time_rows(EMERGING_SHAPES, ("TL",), False, 100, 4, label,
                    card=card, **on)

    exp, first = baseline("emerging_cnn_mnist", dev, torch, 3 * BATCH)
    flow = exp.flow
    train_baseline(label, exp, first, torch)

    fused_chain.reset_launches()
    x = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} Flow.sample", launches)
    print(f"{label}: Flow.sample of {BATCH}: {launches} chain kernel launches "
          f"(8 Emerging layers x 2 AR convs), values "
          f"{x.min().item():.0f}..{x.max().item():.0f}", flush=True)
    if launches != 16 or not torch.isfinite(x).all():
        fail(f"expected 16 chain launches and finite Emerging samples, got "
             f"{launches}")

    noise = sample_noise(flow, BATCH, gen, dev, torch)
    body = Flow(flow.base_distribution, flow.layers[1:])
    states = sample_states(body, noise, torch)
    with plain_chain(fused_chain):
        states_ref = sample_states(body, noise, torch)
    y, y_ref = states[-1][1], states_ref[-1][1]
    rel = ((y - y_ref).double().norm() / y_ref.double().norm()).item()
    saturated = ((y_ref <= 0) | (y_ref >= 256)).float().mean().item()
    print(f"{label}: samples before the floor, kernel vs plain chain on the "
          f"same draws: |y - y_plain| / |y_plain| {rel:.3e} (tol "
          f"{SAMPLE_RTOL:.0e}); max abs diff "
          f"{(y - y_ref).abs().max().item():.3e}; {saturated:.4f} of the "
          f"pixels at the sigmoid's ends (0 or 256); after each Emerging "
          f"layer's inverse, in sampling order: " + ", ".join(
              f"{((a - b).double().norm() / b.double().norm()).item():.2e} "
              f"(max|z| {b.abs().max().item():.3g})"
              for (name, a), (_, b) in zip(states, states_ref)
              if name == "Emerging"), flush=True)
    if not (torch.isfinite(y).all() and rel <= SAMPLE_RTOL):
        fail("Emerging samples through the kernel disagree with the plain "
             "chain")

    # round trips: each AR conv on its input in a forward pass of a batch
    trips = []
    with torch.inference_mode():
        h = torch.as_tensor(first, device=dev)
        h = h + torch.rand(h.shape, generator=gen, device=dev)
        for layer in body.layers:
            v = h
            for t in getattr(layer, "t", ()):
                if isinstance(t, SquareAutoRegressiveConv2d):
                    z = t(v)[0]
                    with plain_chain(fused_chain):
                        plain = t.inverse(z)
                    trips.append(tuple(((back - v).norm() / v.norm()).item()
                                       for back in (t.inverse(z), plain)))
                v = t(v)[0]
            h = layer(h)[0]
    stable = [(k, p) for k, p in trips if p <= SAMPLE_RTOL]
    print(f"{label}: round trips |inverse(forward(x)) - x| / |x| of the 16 AR "
          f"convs, kernel (plain chain): " + ", ".join(
              f"{k:.2e} ({p:.2e})" for k, p in trips)
          + f"; {len(stable)} of 16 within {SAMPLE_RTOL:.0e} on the plain "
          f"chain: the others' inverses amplify float32 round-off past it "
          f"in any implementation (the reference init's diagonal 1 + "
          f"N(0, 1/4) comes near 0 at one channel)", flush=True)
    if not all(k <= SAMPLE_RTOL for k, _ in stable):
        fail("an AR conv's inverse on the kernel does not undo its forward "
             "where the plain chain does")
    return dict(row, max_abs_err=err, launches=launches)


def sample_states(body, noise, torch):
    """``body.sample`` on ``noise`` with the output of every layer's
    inverse kept: [(layer type, z)] in sampling order."""
    seen = []

    def recorded(layer):
        inverse = layer.inverse

        def wrapper(*args, **kwargs):
            z = inverse(*args, **kwargs)
            seen.append((type(layer).__name__, z))
            return z
        return wrapper

    with contextlib.ExitStack() as stack:
        for layer in body.layers:
            stack.enter_context(mock.patch.object(layer, "inverse",
                                                  recorded(layer)))
        body.sample(noise["base"].shape[0], noise=noise)
    return seen


def counted_launches(fn, torch):
    """``fn()`` with the chain's launch counts set to 0 just before and
    read just after: (launches, by variant)."""
    from inverse_flow_tpu_torch.ops import fused_chain

    fused_chain.reset_launches()
    fn()
    torch.cuda.synchronize()
    return (fused_chain.chain_phases.launches,
            dict(fused_chain.chain_phases.launches_by_variant))


def phase_cnn(dev, gen, card, torch, _build):
    """``if_cnn_mnist`` (B=100: 48 ``InvFlowNoPad`` 2x2 layers, 2 steps, 48
    forward and 48 backward launches a step) and ``exact_cnn_mnist`` at
    its B=1000 (9 layers 3x3; 125 clusters of 8 rows): the kernel forward
    and backward against the plain version at B=1000 at its three solve
    shapes (the third, (16, 7, 7), is a 560-wide block: the wide cluster
    kernel), the B=1000 forward at (1, 28, 28) timed beside the plain
    version, the library call and the bound; data init and one step with
    9 + 9 launches, its step-1 gradients against the plain chain. Returns
    the summary entry (launches: the step's)."""
    label = "cnn"
    exp, first = baseline("if_cnn_mnist", dev, torch, 2 * BATCH)
    train_baseline(label, exp, first, torch, 48, init_passes=1)

    label = "cnn_b1000"
    active = _build.cluster_occupancy(dev.index, CNN_BATCH, 392, 56)
    print(f"{label}: cluster kernel at RCW=392 KCW=56 B={CNN_BATCH}: "
          f"{active} clusters resident at once, "
          f"{-(-CNN_BATCH // 8)} needed", flush=True)
    on = dict(gen=gen, dev=dev, torch=torch, b=CNN_BATCH, kernel=(3, 3))
    cases = [((1, 28, 28), ("TL",)), ((4, 14, 14), ("TL",))]
    err = max(check_forward(cases, f"{label}: kernel", **on),
              check_forward([((16, 7, 7), ("TL",))], f"{label}: kernel",
                            variant="cluster_wide", **on))
    check_backward(cases + [((16, 7, 7), ("TL",))], f"{label}: backward",
                   **on)
    row = time_rows([(1, 28, 28)], ("TL",), False, 20, 4, label, card=card,
                    **on)

    exp, first = baseline("exact_cnn_mnist", dev, torch, CNN_BATCH)
    exp.maybe_data_init(first)
    xb = exp._prep_batch(first)
    init_state = copy.deepcopy(exp.flow.state_dict())
    losses = []
    launches, by = counted_launches(
        lambda: losses.append(exp.train_step(xb).item()), torch)
    print(f"{label}: {exp.cfg.name}, one step of {CNN_BATCH}: loss "
          f"{losses[0]:.4f}; chain kernel launches {launches} (9 forward + 9 "
          f"backward), by variant {by}", flush=True)
    if launches != 18 or not math.isfinite(losses[0]):
        fail(f"exact_cnn_mnist: {launches} chain launches, loss {losses}")
    exp.flow.load_state_dict(init_state)
    check_grads(label, exp.flow, first, gen, dev, torch)
    return dict(row, max_abs_err=err, launches=launches,
                launches_by_variant=by)


def phase_baselines(dev, gen, card, torch, _build):
    """Phase 12: the paper's comparison baselines from the registry, at
    their full configs with weights from seed 0 on synthetic MNIST and
    ImageNet32 (the embedded real digits for ``real_digits_fc``): SelfNorm
    (:func:`phase_snf`, :func:`phase_geco`, :func:`phase_snf_imagenet`),
    Glow's 1x1 conv (:func:`phase_conv1x1`), Emerging, whose inverse runs
    on the chain kernel (:func:`phase_emerging`), the CNN flows
    (:func:`phase_cnn`) and two steps each of the other CNN and FC flows.
    Returns the summary entries of the Emerging launch and the B=1000
    launch."""
    t0 = time.perf_counter()
    phase_snf(dev, gen, card, torch)
    phase_geco(dev, torch)
    phase_snf_imagenet(dev, card, torch)
    phase_conv1x1(dev, gen, torch)
    emerging = phase_emerging(dev, gen, card, torch)
    cnn = phase_cnn(dev, gen, card, torch, _build)
    for name, per_step in (("selfnorm_cnn_mnist", 0), ("selfnorm_fc_mnist", 0),
                           ("exact_fc_mnist", 2), ("real_digits_fc", 2)):
        exp, first = baseline(name, dev, torch, 2 * BATCH)
        train_baseline(name, exp, first, torch, per_step, init_passes=1)
    print(f"baselines: phase 12 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return emerging, cnn


# ---------------------------------------------------------------------------
# Phase 13: the paper's Fig. 4 timescaling sweeps and solver='auto'
# ---------------------------------------------------------------------------

# the sweeps' batch (the JAX sweep's 128), and the chained loss-and-backward
# steps of a trial (its 20): one untimed trial and 4 timed ones a size
TIMESCALE_BATCH = 128
TIMESCALE_ITERS = 20
# the Jacobi arm (12 Neumann terms, or 'auto''s guarded solve) against the
# exact arm on the same weights: log p relative and gradients by norm, as
# the JAX package's tests/test_solver_policy.py holds 'auto' to 'exact'
JACOBI_RTOL = 1e-4
# every masked tap at this weight: a bare 12-term truncation on a (1, H, 1)
# image errs by about 0.7^13 ~ 1e-2, so the guard must fall back
GUARD_WEIGHT = 0.7
# the step-difference floor: Jacobi iterations from x (far past
# convergence), and the last ones whose largest step difference it is
FLOOR_ITERS = 200
FLOOR_TAIL = 16


def solve_block(chw, kernel=(2, 2)):
    """(RCW, KCW, the variant ``chain_variant`` names) of the chain solve at
    (C, H, W), as ``fused_chain.chain_inputs`` blocks it."""
    from inverse_flow_tpu_torch.ops import fused_chain

    c, h, w = chw
    r, _ = fused_chain.choose_block_rows_fused(h, c * w, kernel[0]) or (h, 0)
    rcw = r * c * w
    kcw = min((kernel[0] - 1) * c * w, rcw)
    return rcw, kcw, fused_chain.chain_variant(rcw, kcw)


@contextlib.contextmanager
def solve_counts(torch):
    """Counts from 0, for the body: the chain launches, by variant and
    those of ``FusedChainSolve.backward``, and the Jacobi solves' host
    syncs and guard fallbacks; the yielded dict is filled in on exit,
    after a sync."""
    from inverse_flow_tpu_torch.ops import fused_chain, inv_conv

    solve_bwd = fused_chain.FusedChainSolve.backward
    bwd = [0]

    def counted_backward(ctx, gy):
        before = fused_chain.chain_phases.launches
        out = solve_bwd(ctx, gy)
        bwd[0] += fused_chain.chain_phases.launches - before
        return out

    counts = {}
    with mock.patch.object(fused_chain.FusedChainSolve, "backward",
                           staticmethod(counted_backward)):
        fused_chain.reset_launches()
        inv_conv.reset_jacobi_counts()
        yield counts
        torch.cuda.synchronize()
    counts.update(
        launches=fused_chain.chain_phases.launches, backward=bwd[0],
        by_variant=dict(fused_chain.chain_phases.launches_by_variant),
        syncs=(inv_conv.inv_conv_solve_jacobi.syncs
               + inv_conv.inv_conv_solve_jacobi_guarded.syncs),
        fallbacks=inv_conv.inv_conv_solve_jacobi_guarded.fallbacks)


def timescale_flow(name, shape, dev, torch, weight=None):
    """The sweep's model of experiment ``name`` at ``shape`` (C, H, W) and a
    batch of inputs, weights from seed 0 at the layer's init plus
    normal(0, 0.05) (so that each solve moves x; the same weights for
    every arm at one shape), or every entry ``weight``."""
    from inverse_flow_tpu_torch.experiments.timescaling import timescale_model

    gen = torch.Generator(dev).manual_seed(0)
    flow = timescale_model(name, shape, device=dev, generator=gen)
    with torch.no_grad():
        for p in flow.parameters():
            if weight is None:
                p.add_(0.05 * torch.randn(p.shape, generator=gen, device=dev))
            else:
                p.fill_(weight)
    x = torch.randn((TIMESCALE_BATCH,) + shape, generator=gen, device=dev)
    return flow, x


def rel_errs(a, b):
    """(max relative log p difference, max norm-relative gradient
    difference) of two ``loss_and_logp`` results against ``b``."""
    lp_rel = ((a[0] - b[0]).abs() / b[0].abs()).max().item()
    g_rel = max(((x - r).norm() / r.norm()).item()
                for x, r in zip(a[1], b[1]))
    return lp_rel, g_rel


def loss_and_logp(flow, x, torch):
    """log p(x) (detached) and the gradients of its negated mean: the
    sweep's step, with log p kept per sample."""
    lp = flow(x)[1]
    return lp.detach(), torch.autograd.grad(-lp.mean(),
                                            list(flow.parameters()))


def check_arms(shape, card, torch, dev):
    """At one sweep shape: the exact, Jacobi and auto arms on the same
    weights; Jacobi and auto against exact to ``JACOBI_RTOL``; auto's
    route from the port's window, its chain launches (2 forward + 2
    backward on ``chain_variant``'s kernel where it routes exact, none
    where it routes Jacobi) and guard syncs (2 + 2). Returns auto's
    route."""
    from inverse_flow_tpu_torch.ops.solver_policy import resolve_auto

    b = TIMESCALE_BATCH
    arms = {}
    for name in ("if_timescaling", "if_jacobi_timescaling",
                 "if_auto_timescaling"):
        flow, x = timescale_flow(name, shape, dev, torch)
        with solve_counts(torch) as n:
            arms[name] = loss_and_logp(flow, x, torch)
        arms[name + ":counts"] = n
    route = resolve_auto((b,) + shape, (2, 2))
    _, _, variant = solve_block(shape)
    n = arms["if_auto_timescaling:counts"]
    want = ({"launches": 0, "syncs": 4} if route == "jacobi" else
            {"launches": 4, "backward": 2, "syncs": 0,
             "by_variant": dict(dict.fromkeys(n["by_variant"], 0),
                                **{variant: 4})})
    errs = {k: rel_errs(arms[k], arms["if_timescaling"])
            for k in ("if_jacobi_timescaling", "if_auto_timescaling")}
    print(f"timescaling: check ({b},{','.join(map(str, shape))}): auto routes "
          f"{route}; auto's chain launches {n['launches']} ({n['backward']} "
          f"backward, by variant {n['by_variant']}), guard syncs "
          f"{n['syncs']}, fallbacks {n['fallbacks']}; vs the exact arm, "
          f"log p max rel / gradients max norm rel: jacobi "
          f"{errs['if_jacobi_timescaling'][0]:.3e} / "
          f"{errs['if_jacobi_timescaling'][1]:.3e}, auto "
          f"{errs['if_auto_timescaling'][0]:.3e} / "
          f"{errs['if_auto_timescaling'][1]:.3e} (tol {JACOBI_RTOL:.0e})",
          flush=True)
    if any(n[k] != v for k, v in want.items()) or n["fallbacks"]:
        fail(f"timescaling: auto at {shape}: expected {want} and no "
             f"fallback, got {n}")
    if not all(e <= JACOBI_RTOL for pair in errs.values() for e in pair):
        fail(f"timescaling: the Jacobi or auto arm disagrees with the exact "
             f"arm at {shape}")
    return route


def check_exact_vs_plain(shape, card, torch, dev):
    """The exact arm through the chain kernel against the plain chain on
    the same weights, to ``LOGPX_RTOL`` and ``GRAD_RTOL``; every launch on
    ``chain_variant``'s kernel."""
    from inverse_flow_tpu_torch.ops import fused_chain

    flow, x = timescale_flow("if_timescaling", shape, dev, torch)
    with solve_counts(torch) as n:
        got = loss_and_logp(flow, x, torch)
    with plain_chain(fused_chain):
        ref = loss_and_logp(flow, x, torch)
    lp_rel, g_rel = rel_errs(got, ref)
    _, _, variant = solve_block(shape)
    print(f"timescaling: exact arm at ({TIMESCALE_BATCH},"
          f"{','.join(map(str, shape))}) vs the plain chain: log p max rel "
          f"{lp_rel:.3e} (tol {LOGPX_RTOL:.0e}), gradients max norm rel "
          f"{g_rel:.3e} (tol {GRAD_RTOL:.0e}); {n['launches']} launches, by "
          f"variant {n['by_variant']} (expected {variant})", flush=True)
    if n["launches"] != 4 or n["by_variant"][variant] != 4:
        fail(f"timescaling: exact arm at {shape}: launches {n}")
    if not (lp_rel <= LOGPX_RTOL and g_rel <= GRAD_RTOL):
        fail(f"timescaling: exact arm at {shape} disagrees with the plain "
             f"chain")


def check_guard(tall_sizes, card, torch, dev):
    """The guard at every masked tap ``GUARD_WEIGHT``, at the smallest tall
    size that 'auto' routes to Jacobi (or at H = 512, the policy's window
    forced there, when the port's window is empty): the fallback fires
    (syncs and fallbacks at least 1), and auto's log p and gradients
    agree with the exact arm's to ``JACOBI_RTOL`` while the bare 12-term
    arm's do not. Returns one layer's bare 12-term error against the
    exact solve, relative to 1 + max|x|: the truncation error the guard
    must catch."""
    from inverse_flow_tpu_torch.ops import inv_conv, solver_policy

    routed = [h for h in tall_sizes if solver_policy.resolve_auto(
        (TIMESCALE_BATCH, 1, h, 1), (2, 2)) == "jacobi"]
    h = routed[0] if routed else 512
    shape = (1, h, 1)
    force = contextlib.ExitStack()
    if not routed:
        for const in ("JACOBI_LONG_MIN", "JACOBI_LONG_MAX"):
            force.enter_context(mock.patch.object(solver_policy, const, h))
    with force:
        arms, flows = {}, {}
        for name in ("if_timescaling", "if_jacobi_timescaling",
                     "if_auto_timescaling"):
            flows[name], x = timescale_flow(name, shape, dev, torch,
                                            weight=GUARD_WEIGHT)
            with solve_counts(torch) as n:
                arms[name] = loss_and_logp(flows[name], x, torch)
            arms[name + ":counts"] = n
    n = arms["if_auto_timescaling:counts"]
    auto = rel_errs(arms["if_auto_timescaling"], arms["if_timescaling"])
    bare = rel_errs(arms["if_jacobi_timescaling"], arms["if_timescaling"])
    # one layer: the bare solve's residual after its 12 iterations (what
    # the guard reads) and its error against the exact solve
    layer = flows["if_jacobi_timescaling"].layers[0]
    w_eff = layer._w_eff(dict(layer.named_parameters()))
    with torch.no_grad(), inv_conv._fp32_convs():
        scale = (1 + x.abs().max()).item()
        y = x
        for _ in range(12):
            y = inv_conv._jacobi_step(x, y, w_eff, 1)
        resid = (inv_conv._jacobi_step(x, y, w_eff, 1) - y).abs().max()
        y_exact = flows["if_timescaling"].layers[0](x)[0]
        trunc = (y - y_exact).abs().max().item() / scale
        resid = resid.item() / scale
    print(f"timescaling: guard at every tap {GUARD_WEIGHT}, ({TIMESCALE_BATCH}"
          f",1,{h},1){'' if routed else ' (window forced there)'}: auto's "
          f"syncs {n['syncs']}, fallbacks {n['fallbacks']}; vs the exact "
          f"arm: auto log p {auto[0]:.3e} / gradients {auto[1]:.3e} (tol "
          f"{JACOBI_RTOL:.0e}), bare 12-term arm {bare[0]:.3e} / "
          f"{bare[1]:.3e}; one layer's bare 12-term solve: residual "
          f"{resid:.3e} and error {trunc:.3e} of 1 + max|x|", flush=True)
    if n["syncs"] < 1 or n["fallbacks"] < 1:
        fail(f"timescaling: the guard did not fall back at weight "
             f"{GUARD_WEIGHT}: {n}")
    if not (auto[0] <= JACOBI_RTOL and auto[1] <= JACOBI_RTOL):
        fail("timescaling: the guarded auto solve disagrees with the exact "
             "arm where the fallback fires")
    return trunc


def step_floor(shape, weight, torch, dev):
    """The largest step difference ``max|y_{k+1} - y_k| / (1 + max|x|)``
    over the last ``FLOOR_TAIL`` of ``FLOOR_ITERS`` Jacobi iterations (far
    past convergence) of the sweep's first layer at ``shape``, float32
    with TF32 off: the noise the guard's residual cannot go below."""
    from inverse_flow_tpu_torch.ops import inv_conv

    flow, x = timescale_flow("if_jacobi_timescaling", shape, dev, torch,
                             weight=weight)
    layer = flow.layers[0]
    w_eff = layer._w_eff(dict(layer.named_parameters()))
    diffs = []
    with torch.no_grad(), inv_conv._fp32_convs():
        scale = 1 + x.abs().max()
        y = x
        for k in range(FLOOR_ITERS):
            y_next = inv_conv._jacobi_step(x, y, w_eff, 1)
            if k >= FLOOR_ITERS - FLOOR_TAIL:
                diffs.append((y_next - y).abs().max() / scale)
            y = y_next
    return max(d.item() for d in diffs)


def phase_timescaling(dev, card, torch):
    """Phase 13: the paper's Fig. 4 sweeps through the port's
    ``run_timescaling``, at the registry's sizes and batch 128, every
    record appended to ``chiprun_out/timescaling/<name>_timescale.jsonl``;
    for each size the chain launches by variant and the Jacobi syncs per
    step, checked against the arm and 'auto''s route; the arms' values
    (:func:`check_arms`, :func:`check_exact_vs_plain`), the guard
    (:func:`check_guard`), the step-difference floor beside the policy's
    tolerances, the exact and Jacobi arms' device busy share at the
    largest sizes, and ``memory_speed`` at its full configuration."""
    from inverse_flow_tpu_torch.experiments import registry
    from inverse_flow_tpu_torch.experiments.memory_speed import \
        run_memory_speed
    from inverse_flow_tpu_torch.experiments.timescaling import (
        default_sizes, run_timescaling)
    from inverse_flow_tpu_torch.ops import solver_policy as sp

    t0 = time.perf_counter()
    label = "timescaling"
    squares, talls = default_sizes(False), default_sizes(True)
    shapes = [(1, s, s) for s in squares] + [(1, h, 1) for h in talls]

    # ---- values: every arm against the exact one, the guard, the floor
    routes = {shape: check_arms(shape, card, torch, dev) for shape in shapes}
    check_exact_vs_plain((1, squares[-1], squares[-1]), card, torch, dev)
    check_exact_vs_plain((1, talls[-1], 1), card, torch, dev)
    trunc = check_guard(talls, card, torch, dev)
    # tall images at both weights; the square at the init only (at every
    # tap 0.7 its series grows for hundreds of terms before it dies out)
    floors = {(shape, w): step_floor(shape, w, torch, dev)
              for shape, ws in (((1, 512, 1), (None, GUARD_WEIGHT)),
                                ((1, talls[-1], 1), (None, GUARD_WEIGHT)),
                                ((1, squares[-1], squares[-1]), (None,)))
              for w in ws}
    floor = max(floors.values())
    print(f"{label}: step-difference floor (float32, TF32 off; the largest "
          f"|y_k+1 - y_k| / (1 + max|x|) over iterations "
          f"{FLOOR_ITERS - FLOOR_TAIL + 1}-{FLOOR_ITERS}): " + ", ".join(
              f"({TIMESCALE_BATCH},{','.join(map(str, s))}) "
              f"{'init+N(0,0.05)' if w is None else f'all {w}'} {v:.3e}"
              for (s, w), v in floors.items())
          + f"; max {floor:.3e} {card}", flush=True)
    print(f"{label}: policy tolerances: JACOBI_AUTO_TOL {sp.JACOBI_AUTO_TOL:g}"
          f" = {sp.JACOBI_AUTO_TOL / floor:.0f}x the floor and "
          f"{trunc / sp.JACOBI_AUTO_TOL:.1f}x below the truncation error "
          f"{trunc:.3e}; JACOBI_TOL_MIN {sp.JACOBI_TOL_MIN:g} = "
          f"{sp.JACOBI_TOL_MIN / floor:.0f}x the floor", flush=True)
    if not (sp.JACOBI_AUTO_TOL >= 10 * floor and sp.JACOBI_TOL_MIN > floor
            and 10 * sp.JACOBI_AUTO_TOL <= trunc):
        fail("timescaling: the policy's tolerances do not sit above the "
             "floor (JACOBI_AUTO_TOL 10x) and 10x below the truncation "
             "error")

    # ---- the sweeps, one size a call, counted
    out = os.path.join(HERE, "chiprun_out", "timescaling")
    os.makedirs(out, exist_ok=True)
    steps = 5 * TIMESCALE_ITERS + 1
    rows = {}
    print(f"{label}: sweeps at batch {TIMESCALE_BATCH}, {TIMESCALE_ITERS} "
          f"steps a trial ({steps} steps a size with the untimed trial)",
          flush=True)
    for name in registry.TIMESCALING:
        tall = "tall" in name
        for s in default_sizes(tall):
            shape = (1, s, 1) if tall else (1, s, s)
            route = ("snf" if name.startswith("snf") else
                     "jacobi" if "jacobi" in name else
                     routes[shape] if "auto" in name else "exact")
            with contextlib.chdir(out), solve_counts(torch) as n:
                run_timescaling(name, sizes=[s], iters=TIMESCALE_ITERS,
                                device=dev)
            with open(os.path.join(out, f"{name}_timescale.jsonl")) as f:
                rec = json.loads(f.readlines()[-1])
            _, _, variant = solve_block(shape)
            per_step = {k: v / steps for k, v in n["by_variant"].items()
                        if v}
            print(f"{label}: {name} size {s} ({TIMESCALE_BATCH},"
                  f"{','.join(map(str, shape))}): ms_best "
                  f"{rec['ms_best']:.3f}, ms_mean {rec['ms_mean']:.3f} "
                  f"(std {rec['ms_std']:.3f}); route {route}; chain launches "
                  f"a step {n['launches'] / steps:g} ({n['backward'] / steps:g}"
                  f" backward) by variant {per_step}; guard syncs a step "
                  f"{n['syncs'] / steps:g}, fallbacks {n['fallbacks']} {card}",
                  flush=True)
            want = ((4 * steps, 2 * steps, 0) if route == "exact" else
                    (0, 0, 4 * steps if "auto" in name else 0))
            if ((n["launches"], n["backward"], n["syncs"]) != want
                    or n["fallbacks"]
                    or (route == "exact"
                        and n["by_variant"][variant] != 4 * steps)):
                fail(f"{label}: {name} at {shape}: counts {n}, expected "
                     f"(launches, backward, syncs) {want} on {variant}")
            rows[name, s] = rec["ms_best"]

    # ---- the crossover the policy's window is read from
    for tall, sizes in ((False, squares), (True, talls)):
        pre = "_tall" if tall else ""
        print(f"{label}: ms_best by size, {'tall (1,H,1)' if tall else 'square (1,s,s)'}: "
              + "; ".join(
                  f"{s}: exact {rows['if' + pre + '_timescaling', s]:.3f}, "
                  f"jacobi {rows['if_jacobi' + pre + '_timescaling', s]:.3f}, "
                  f"auto {rows['if_auto' + pre + '_timescaling', s]:.3f} "
                  f"({routes[(1, s, 1) if tall else (1, s, s)]})"
                  + ("" if tall else
                     f", snf {rows['snf_timescaling', s]:.3f}")
                  for s in sizes) + f" {card}", flush=True)
    wins = [h for h in talls if rows["if_jacobi_tall_timescaling", h]
            < rows["if_tall_timescaling", h]]
    print(f"{label}: the Jacobi arm beats the exact arm at tall sizes {wins}; "
          f"the port's window: H in [{sp.JACOBI_LONG_MIN}, "
          f"{sp.JACOBI_LONG_MAX}], short axis x channels <= "
          f"{sp.JACOBI_THIN_MAX}, kernels <= {sp.JACOBI_KERNEL_MAX}", flush=True)

    # ---- where a step's time goes at the largest sizes
    for name, shape in (("if_timescaling", (1, squares[-1], squares[-1])),
                        ("if_tall_timescaling", (1, talls[-1], 1)),
                        ("if_jacobi_timescaling", (1, squares[-1],
                                                   squares[-1])),
                        ("if_jacobi_tall_timescaling", (1, talls[-1], 1))):
        flow, x = timescale_flow(name, shape, dev, torch)
        loss_and_logp(flow, x, torch)
        device_profile(f"timescale_{name}_{shape[1]}", "step",
                       lambda: loss_and_logp(flow, x, torch), 3, card)

    # ---- memory_speed at its full configuration
    with contextlib.chdir(out), solve_counts(torch) as n:
        run_memory_speed(device=dev)
    with open(os.path.join(out, "memory_speed.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    print(f"memory_speed: {json.dumps(rec)}; chain launches {n['launches']} "
          f"({n['backward']} backward) by variant {n['by_variant']} for data "
          f"init and 21 steps {card}", flush=True)
    if not (math.isfinite(rec["loss"]) and "memory_peak_mb" in rec
            and n["launches"] == n["by_variant"]["cluster"]):
        fail(f"memory_speed: {rec}, launches {n}")
    print(f"{label}: phase 13 in {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 14: the layer zoo
# ---------------------------------------------------------------------------

# SmoothTanh's default beta, and a flat tail where f' falls to 0.01
TANH_BETAS = (0.1, 0.01)
# special-function (MUFU) instructions in a TanhStep Newton step, the
# function's least: tanhf's EX2 and RCP, and __fdividef's RCP (f' is taken
# from the same tanh); phase 2 fails unless its kernel's loop holds these
TANH_MUFU_PER_STEP = 3
# ConvExp's cheap eval leaves the series tail sum_{k>6} s^k/k! of |x| a
# layer, s the normalized conv's norm: within 1.3 x coeff^7/7! where the
# power iterations' sigma sits up to 2% under s (tests/test_torch_convexp.py)
CONVEXP_TAIL = 1.3 * 0.9 ** 7 / math.factorial(7)
# the B-spline inverse: 20 bisections and 5 Newton steps on [0, 1], mapped
# back over 2 x tail_bound
BSPLINE_RTOL = 1e-4
ROUND_TRIP_RTOL = 1e-3


def tanh_bound(n, steps):
    """(bound_ms, bound_by) of one SmoothTanh inverse on ``n`` elements
    over ``steps`` Newton steps in all: bytes (8 an element) at the HBM
    rate or ``TANH_MUFU_PER_STEP`` MUFU operations a step at the SFU
    rate."""
    bytes_ms = 8 * n / PEAK_BYTES_PER_S * 1e3
    ops_ms = TANH_MUFU_PER_STEP * steps / PEAK_MUFU_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def check_smooth_tanh(gen, dev, card, torch):
    """The SmoothTanh-inverse kernel (K2, ``lane_exit``) and its first
    design (``step_exit``, forced) against the plain loop at imagenet32's
    three shapes, B=100 and B=1, y uniform in [-40, 40], at alpha 1 and
    beta 0.1 and 0.01: every element of both within
    ``smooth_tanh_inverse_limit``; the steps each exit rule needs on the
    plain loop (:func:`~inverse_flow_tpu_torch.ops.activations.
    smooth_tanh_inverse_steps`: the kernel's, mean, maximum and warp
    maximum; the first design's step test, mean, warp maximum and the
    elements whose iterate never settles); the times of both and of the
    plain loop beside the bound on the steps these inputs need by the
    kernel's rule and on 100 (:func:`tanh_bound`), and the launches a
    call. No PyTorch call computes the function. Returns the summary
    entry's numbers (means over the three shapes at B=100, beta 0.1)."""
    from inverse_flow_tpu_torch.ops import activations as act

    rows, max_err = [], 0.0
    shapes = [(b,) + s[1:] for b in (BATCH, 1) for s in SLR_SHAPES[:3]]

    def warp_max(steps):
        pad = (-steps.numel()) % 32
        warps = torch.cat([steps, steps.new_zeros(pad)]).view(-1, 32)
        return warps.max(1).values.float().mean().item()

    for beta in TANH_BETAS:
        for shape in shapes:
            y = slr_inputs(shape, gen, dev, torch)
            with torch.inference_mode():
                hist = act.smooth_tanh_inverse_history(y, 1.0, beta)
                limit = act.smooth_tanh_inverse_limit(y, hist, 1.0, beta)
                errs, inside, res, launches, stray = {}, {}, {}, {}, 0
                for v in act.TANH_VARIANTS:
                    act.reset_smooth_tanh_launches()
                    x = act.smooth_tanh_inverse(y, 1.0, beta, variant=v)
                    torch.cuda.synchronize()
                    by = act.smooth_tanh_inverse.launches_by_variant
                    launches[v] = by[v]
                    stray += sum(by.values()) - by[v]
                    off = (x - hist[-1]).abs()
                    errs[v] = off.max().item()
                    inside[v] = bool((off <= limit).all())
                    res[v] = (act.smooth_tanh(x, 1.0, beta) - y).abs().max(
                        ).item()
                steps = {rule: act.smooth_tanh_inverse_steps(
                    y.reshape(-1), 1.0, beta, tol=act.SLR_EXIT_TOL,
                    rule=rule) for rule in act.TANH_EXIT_RULES}
                lane, first = steps["residual"], steps["step"]
                never = int((first == act.NEWTON_ITERS).sum())
                t = dict(ab_ms({v: lambda v=v: act.smooth_tanh_inverse(
                    y, 1.0, beta, variant=v) for v in act.TANH_VARIANTS},
                    reps=50, rounds=4, ahead=True), **ab_ms(
                    {"plain": lambda: act.smooth_tanh_inverse_reference(
                        y, 1.0, beta)}, reps=3, rounds=2))
            bound, bound_by = tanh_bound(y.numel(), int(lane.sum()))
            bound_100, _ = tanh_bound(y.numel(), 100 * y.numel())
            kernel, design = t["lane_exit"], t["step_exit"]
            print(f"smooth_tanh: {shape} beta {beta}: kernel "
                  f"{1e3 * kernel:.2f} us, first design (step_exit) "
                  f"{1e3 * design:.2f} us, plain loop {1e3 * t['plain']:.2f} "
                  f"us per call, {launches} launches a call; bound "
                  f"{1e3 * bound:.3f} us on the steps these inputs need "
                  f"({bound_by}; the kernel at {bound / kernel:.2%} of it, "
                  f"the first design at {bound / design:.2%}), "
                  f"{1e3 * bound_100:.3f} us on 100 steps; steps by the "
                  f"kernel's exit mean {lane.float().mean().item():.3f}, "
                  f"maximum {int(lane.max())}, warp maximum mean "
                  f"{warp_max(lane):.3f}; by the step test alone mean "
                  f"{first.float().mean().item():.3f}, warp maximum mean "
                  f"{warp_max(first):.3f}, {never} elements never settle "
                  f"({never / y.numel():.3%}); max abs err vs plain "
                  f"{errs['lane_exit']:.3e} (first design "
                  f"{errs['step_exit']:.3e}), all within the limit "
                  f"{inside['lane_exit']} ({inside['step_exit']}); |f(x) - "
                  f"y| {res['lane_exit']:.3e} {card}", flush=True)
            if not all(inside.values()):
                fail(f"the SmoothTanh-inverse kernels land outside the plain "
                     f"loop's limit at {shape} beta {beta}: {inside}")
            if launches != dict.fromkeys(act.TANH_VARIANTS, 1) or stray:
                fail(f"smooth_tanh_inverse made {launches} launches a call "
                     f"of each variant ({stray} of another)")
            max_err = max(max_err, errs["lane_exit"])
            if beta == TANH_BETAS[0] and shape[0] == BATCH:
                rows.append((kernel, design, t["plain"], bound, bound_100,
                             lane.float().mean().item(), int(lane.max()),
                             warp_max(lane)))
                row_bound_by = bound_by
    (ms, design_ms, plain_ms, bound_ms, bound_100, mean, most,
     warp) = (statistics.fmean(c) for c in zip(*rows))
    return dict(max_abs_err=max_err, ms=ms, step_exit_ms=design_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=row_bound_by,
                bound_100_steps_ms=bound_100, steps_mean=mean,
                steps_max=most, steps_warp_max=warp, library_ms=None)


def smooth_tanh_path(gen, dev, torch):
    """The SmoothTanh layer's inverse, its entry point, at imagenet32's
    three shapes on B=100, the kernel's launch count set to 0 just before
    and read just after (one launch a call); each round trip within
    ``SAMPLE_RTOL`` by norm. Returns the launches."""
    from inverse_flow_tpu_torch.layers import SmoothTanh
    from inverse_flow_tpu_torch.ops import activations as act

    layer = SmoothTanh()
    xs = [3 * torch.randn((BATCH,) + s[1:], generator=gen, device=dev)
          for s in SLR_SHAPES[:3]]
    with torch.inference_mode():
        zs = [layer(x)[0] for x in xs]
        act.reset_smooth_tanh_launches()
        back = [layer.inverse(z) for z in zs]
        torch.cuda.synchronize()
        launches = act.smooth_tanh_inverse.launches
        rel = max(((b - x).norm() / x.norm()).item()
                  for b, x in zip(back, xs))
    print(f"smooth_tanh: SmoothTanh.inverse at {len(xs)} shapes of B="
          f"{BATCH}: {launches} kernel launches; round trip |inverse("
          f"forward(x)) - x| / |x| {rel:.3e} (tol {SAMPLE_RTOL:.0e})",
          flush=True)
    by = act.smooth_tanh_inverse.launches_by_variant
    if launches != len(xs) or by["lane_exit"] != launches \
            or not rel <= SAMPLE_RTOL:
        fail(f"SmoothTanh.inverse: {launches} launches ({by}), round trip "
             f"{rel}")
    return launches


def launch_calls(fn, torch):
    """Kernel launch calls of one ``fn()`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunch"))


# the B-spline inverse's least operations an element, for the plain
# version's algorithm, with the bin's cubic in power form by Horner's rule
# (3 FMAs for its value, 2 for its slope): a bisection step is the midpoint
# and the value; a Newton step the value, the slope and t -= (value - y) /
# slope; the finish the midpoint, (i + t) / k and the log-det's slope x k
BSPLINE_BISECT_FLOPS = 2 + 6
BSPLINE_NEWTON_FLOPS = 6 + 4 + 3
BSPLINE_FINISH_FLOPS = 2 + 2 + 5
BSPLINE_ELEMENT_FLOPS = (20 * BSPLINE_BISECT_FLOPS + 5 * BSPLINE_NEWTON_FLOPS
                         + BSPLINE_FINISH_FLOPS)


def bspline_flops(n, k, own_coeffs):
    """The least floating-point operations of one B-spline inverse on ``n``
    elements at ``k`` bins, for the plain version's algorithm (the bin, 20
    bisections, 5 Newton steps): each add, subtract, multiply and division
    one, an FMA two; exp, log, max and comparisons not counted. Once per
    coefficient set (each element's own, or one set shared by every
    element): the softmax, floor and cumsum 6 (k + 3) + 2, the knots 10 and
    the normalized knot values 6 (k + 1), as ``csrc/bspline_inverse.cu``
    does them; the power form's two scales 2, and its 13 for each bin
    taken, the element's own (own) or all k (shared). Then
    ``BSPLINE_ELEMENT_FLOPS`` (234) an element."""
    sets, bins = (n, 1) if own_coeffs else (1, k)
    per_set = 6 * (k + 3) + 2 + 10 + 6 * (k + 1) + 2 + 13 * bins
    return sets * per_set + n * BSPLINE_ELEMENT_FLOPS


def bspline_bound(n, k, own_coeffs):
    """(bound_ms, bound_by) of one B-spline inverse on ``n`` elements at
    ``k`` bins: bytes (y read, x and the log-det written, 12 an element,
    and the (k + 3) coefficients, each element's own or one shared set) at
    the HBM rate, or operations: :func:`bspline_flops` at the float32
    rate, or the k + 3 exps of each coefficient set and one log an element
    at the SFU rate, whichever is larger."""
    sets = n if own_coeffs else 1
    bytes_ms = (12 * n + 4 * (k + 3) * sets) / PEAK_BYTES_PER_S * 1e3
    ops_ms = max(bspline_flops(n, k, own_coeffs) / PEAK_FP32_FLOPS,
                 ((k + 3) * sets + n) / PEAK_MUFU_PER_S) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def check_bspline_kernel(label, y, coeffs, layout, card, torch):
    """The B-spline-inverse kernel against its plain version on ``y`` and
    ``coeffs`` in ``layout``: x within ``1e-5 * max(1, max|x|)``; the
    log-det against the plain forward's log-det at the kernel's own x
    within ``1e-5 * max(1, max|log-det|)`` (the log-det moves by its slope
    times x's own rounding: that difference is printed beside); one launch
    a call, of the new kernel only; its Newton steps (mean, maximum, from
    the kernel's own count); the first design, forced, held to the same x
    rule; the kernel's time beside the first design's, the plain
    version's, the bound (:func:`bspline_bound`). No single PyTorch call
    computes the function. Returns the row's numbers."""
    from inverse_flow_tpu_torch.ops import bspline as ob

    with torch.inference_mode():
        ob.reset_bspline_launches()
        x, ld = ob.bspline_inverse(y, coeffs, layout)
        torch.cuda.synchronize()
        by_variant = dict(ob.bspline_inverse.launches_by_variant)
        x_ref, ld_ref = ob.bspline_inverse_reference(y, coeffs, layout)
        last = ob.last_dim_coeffs(y, coeffs, layout)
        ld_fwd = ob.monotone_cubic_b_spline(x, last)[1]
        err = (x - x_ref).abs().max().item()
        tol = 1e-5 * max(1.0, x_ref.abs().max().item())
        ld_diff = (ld - ld_ref).abs().max().item()
        ld_err = (ld + ld_fwd).abs().max().item()
        ld_tol = 1e-5 * max(1.0, ld_ref.abs().max().item())
        x_steps, _, steps = ob.bspline_inverse(y, coeffs, layout, steps=True)
        first_err = (ob.bspline_inverse(y, coeffs, layout, variant="first")[0]
                     - x_ref).abs().max().item()
        # the sleep-ahead at 4x: a wrapper call takes 29-46 us of a host's
        # time (scripts/bspline_probe.py host), near the 50 us a call of
        # the sleep, and a slower host read 19 us for an 8 us launch
        t = dict(ab_ms({"kernel": lambda: ob.bspline_inverse(
            y, coeffs, layout), "first": lambda: ob.bspline_inverse(
            y, coeffs, layout, variant="first")}, reps=50, rounds=4,
            ahead=4),
            **ab_ms({"plain": lambda: ob.bspline_inverse_reference(
                y, coeffs, layout)}, reps=3, rounds=2))
    k = last.shape[-1] - 3
    steps_mean, steps_max = steps.float().mean().item(), int(steps.max())
    bound, bound_by = bspline_bound(y.numel(), k, layout != "shared")
    print(f"{label}: bspline_inverse {layout} {tuple(y.shape)} K={k}: "
          f"kernel {1e3 * t['kernel']:.2f} us, first design "
          f"{1e3 * t['first']:.2f} us, plain {1e3 * t['plain']:.2f} us per "
          f"call, launches a call {by_variant}; Newton steps mean "
          f"{steps_mean:.3f}, max {steps_max} (cap "
          f"{ob.BSPLINE_MAX_STEPS}); bound {1e3 * bound:.3f} us ({bound_by}; "
          f"the kernel at {bound / t['kernel']:.2%} of it, the first design "
          f"at {bound / t['first']:.2%}); max abs err x {err:.3e} (first "
          f"design {first_err:.3e}; tol {tol:.1e}), log-det vs the plain "
          f"forward's at the kernel's x {ld_err:.3e} (tol {ld_tol:.1e}), vs "
          f"the plain inverse's {ld_diff:.3e} {card}", flush=True)
    if not (err <= tol and first_err <= tol and ld_err <= ld_tol
            and by_variant == {"bracketed": 1, "first": 0}
            and torch.equal(x_steps, x)
            and steps_max <= ob.BSPLINE_MAX_STEPS):
        fail(f"the B-spline-inverse kernel disagrees with its plain version "
             f"({layout}, {tuple(y.shape)}) or made launches {by_variant}")
    return dict(ms=t["kernel"], first_design_ms=t["first"],
                plain_ms=t["plain"], bound_ms=bound, bound_by=bound_by,
                max_abs_err=err, steps_mean=steps_mean, steps_max=steps_max)


def check_bspline_wide(y, coeffs, layout, card, torch):
    """The kernel on wide draws (coefficients at std 3: some bins at
    min_step, the root ill-conditioned): its x no farther from the float64
    plain inverse than the float32 plain version's is, plus 1e-6; the plain
    forward in float64 at its x returns y to within the float32 plain
    inverse's residual there plus 2 ulp of 1 (the float32 forward's own
    rounding reaches 1e-4 of y where a set's knots span 1e-3, and favours
    the x found on that rounding); its Newton steps within the cap."""
    from inverse_flow_tpu_torch.ops import bspline as ob

    with torch.inference_mode():
        x, _, steps = ob.bspline_inverse(y, coeffs, layout, steps=True)
        last = ob.last_dim_coeffs(y, coeffs, layout)
        x32, _ = ob.monotone_cubic_b_spline(y, last, inverse=True)
        x64, _ = ob.monotone_cubic_b_spline(y.double(), last.double(),
                                            inverse=True)
        err = (x.double() - x64).abs().max().item()
        err32 = (x32.double() - x64).abs().max().item()
        res, res32 = (
            (ob.monotone_cubic_b_spline(v.double(), last.double())[0]
             - y.double()).abs().max().item() for v in (x, x32))
    k = last.shape[-1] - 3
    print(f"bspline: wide draws (std 3) {layout} {tuple(y.shape)} K={k}: "
          f"max |x - x_f64| kernel {err:.3e}, plain float32 {err32:.3e} "
          f"(rule: kernel <= plain + 1e-6); float64 residual |f(x) - y| "
          f"kernel {res:.3e}, plain {res32:.3e} (rule: <= plain + 2.4e-7); "
          f"Newton "
          f"steps mean {steps.float().mean().item():.3f}, max "
          f"{int(steps.max())} (cap {ob.BSPLINE_MAX_STEPS}) {card}",
          flush=True)
    if not (err <= err32 + 1e-6 and res <= res32 + 2 * 2.0 ** -23
            and int(steps.max()) <= ob.BSPLINE_MAX_STEPS):
        fail(f"the B-spline-inverse kernel misses the wide-draw rule "
             f"({layout}, K={k})")


def plain_bspline():
    """A context in which every B-spline layer's inverse runs the plain
    version (the layers call ``ops.bspline.bspline_inverse`` through its
    module)."""
    from inverse_flow_tpu_torch.ops import bspline as ob

    return mock.patch.object(ob, "bspline_inverse",
                             ob.bspline_inverse_reference)


def phase_bspline(gen, dev, card, torch):
    """The B-spline-inverse kernel against its plain version in its three
    layouts (:func:`check_bspline_kernel`) at imagenet32's three shapes,
    B=100 and B=1, y uniform in [0, 1], 8 bins: ``"shared"`` coefficients
    drawn at std 0.5; ``"channels"``, the net output of a
    ``BSplineCoupling`` (width 512; its zero-initialized last conv drawn
    at std 0.01, so that the spline is not the identity) on 3 x N(0, 1)
    inputs, for the coupling's second half; ``"last"`` drawn at std 0.5.
    Then ``BSplineActivation`` (8 bins, tail bound 10, coefficients at std
    0.5) and that ``BSplineCoupling`` at the same shapes, inputs 3 x N(0,
    1): the forward and the inverse on the card, ms per call with the
    kernel and with the plain inverse, launch calls an inverse both ways
    (a ``BSplineActivation`` inverse at most 2: the maps and tails are in
    the launch), and the round trip within ``BSPLINE_RTOL`` x max(1,
    max|x|). Last, the wide draws (:func:`check_bspline_wide`) at
    (100, 12, 16, 16), 5 and 8 bins, in every layout."""
    from inverse_flow_tpu_torch.layers import (BSplineActivation,
                                               BSplineCoupling)

    act = BSplineActivation(n_bins=8, tail_bound=10.0, generator=gen,
                            device=dev)
    with torch.no_grad():
        act.coeffs.copy_(0.5 * torch.randn(act.coeffs.shape, generator=gen,
                                           device=dev))
    for b in (BATCH, 1):
        for s in SLR_SHAPES[:3]:
            chw = s[1:]
            cpl = BSplineCoupling(chw, width=512, generator=gen, device=dev)
            with torch.no_grad():
                cpl.w3.copy_(0.01 * torch.randn(cpl.w3.shape, generator=gen,
                                                device=dev))
            x = 3 * torch.randn((b,) + chw, generator=gen, device=dev)
            half = (b, chw[0] - chw[0] // 2) + chw[1:]
            with torch.inference_mode():
                net = cpl._net(cpl.own_params(), x[:, :chw[0] // 2])
            for layout, y, coeffs in (
                    ("shared", (b,) + chw, act.coeffs.detach()),
                    ("channels", half, net),
                    ("last", (b,) + chw, 0.5 * torch.randn(
                        (b,) + chw + (11,), generator=gen, device=dev))):
                check_bspline_kernel("bspline", torch.rand(
                    y, generator=gen, device=dev), coeffs, layout, card,
                    torch)
            for name, layer in (("BSplineActivation", act),
                                ("BSplineCoupling", cpl)):
                with torch.inference_mode():
                    z, ldj = layer(x)
                    back = layer.inverse(z)
                    err = (back - x).abs().max().item()
                    tol = BSPLINE_RTOL * max(1.0, x.abs().max().item())

                    def plain_inverse():
                        with plain_bspline():
                            return layer.inverse(z)

                    t = ab_ms({"forward": lambda: layer(x),
                               "inverse": lambda: layer.inverse(z),
                               "plain": plain_inverse},
                              reps=3, rounds=2)
                    calls = launch_calls(lambda: layer.inverse(z), torch)
                    plain_calls = launch_calls(plain_inverse, torch)
                print(f"bspline: {name} {(b,) + chw}: forward "
                      f"{t['forward']:.3f} ms, inverse {t['inverse']:.3f} ms "
                      f"per call (plain inverse {t['plain']:.3f}), {calls} "
                      f"kernel launch calls an inverse (plain "
                      f"{plain_calls}); round trip max abs err {err:.3e} "
                      f"(tol {tol:.1e}); ldj finite "
                      f"{bool(torch.isfinite(ldj).all())} {card}",
                      flush=True)
                if not (err <= tol and torch.isfinite(ldj).all()):
                    fail(f"{name} does not round-trip at {(b,) + chw}")
                if name == "BSplineActivation" and calls > 2:
                    fail(f"a BSplineActivation inverse made {calls} launch "
                         f"calls (at most 2)")
    shape = SLR_SHAPES[0]
    for k in (5, 8):
        for layout, c_shape in (
                ("shared", (k + 3,)),
                ("channels", (shape[0], shape[1] * (k + 3)) + shape[2:]),
                ("last", shape + (k + 3,))):
            check_bspline_wide(
                torch.rand(shape, generator=gen, device=dev),
                3 * torch.randn(c_shape, generator=gen, device=dev), layout,
                card, torch)


def convexp_carry_check(convexps, errs, torch):
    """A ``train_step`` wrapper factory: after the step every ConvExp's u
    must be one power iteration, against the step's new kernel, from the
    u before it (``errs`` collects the max abs differences)."""
    from inverse_flow_tpu_torch.layers.convexp import spectral_normalize

    def wrap(step_fn):
        def step(xb):
            prev = [layer.u.detach().clone() for layer in convexps]
            loss = step_fn(xb)
            with torch.no_grad():
                for layer, u0 in zip(convexps, prev):
                    want = spectral_normalize(layer.kernel, u0,
                                              layer.input_size,
                                              layer.coeff)[1]
                    errs.append((layer.u - want).abs().max().item())
            return loss
        return step
    return wrap


def phase_exponential(dev, gen, card, torch):
    """``exponential_cnn_mnist`` at its registry config (9 ConvExp layers
    at (1,28,28), (4,14,14), (16,7,7); the RQ spline, 10 bins, tail 10;
    Adam lr 1e-3, no scheduler; no modified gradient, so training takes
    the 13-term series): data init and 10 steps, every loss finite and
    after each step every u one power iteration of the new kernel from
    the u before (within 1e-6; u is in no optimizer group); one eval
    batch, and the exact log p against the cheap one within the series
    tail, 9 x ``CONVEXP_TAIL`` relatively; ``Flow.sample`` of 100 and the
    round trip through the layers after the preprocessing; train ms/step
    and a profiled step; the CLI's smoke run of the name."""
    from inverse_flow_tpu_torch.layers import ConvExp, Flow

    label = "exponential"
    exp, first = baseline("exponential_cnn_mnist", dev, torch,
                          TRAIN_EXAMPLES, batch_size=BATCH,
                          max_eval_ex=BATCH)
    flow = exp.flow
    convexps = [l for l in flow.layers if isinstance(l, ConvExp)]
    shapes = sorted({l.input_size for l in convexps})
    errs = []
    wrap = convexp_carry_check(convexps, errs, torch)
    with mock.patch.object(exp, "train_step", wrap(exp.train_step)):
        values, mean_loss, _, _, _ = counted_epoch(exp, first, torch)
    in_opt = {id(p) for g in exp.optimizer.param_groups for p in g["params"]}
    carried = [l.u for l in convexps]
    print(f"{label}: {exp.cfg.name}, {len(convexps)} ConvExp at "
          f"{shapes}; data init + {len(values)} steps of {BATCH}: losses "
          f"{', '.join(f'{v:.4f}' for v in values)}; u after each step vs "
          f"one power iteration of the new kernel: max abs diff "
          f"{max(errs):.3e} over {len(errs)} checks (tol 1e-6); u in the "
          f"optimizer: {any(id(u) in in_opt for u in carried)}", flush=True)
    if len(convexps) != 9 or len(values) != TRAIN_EXAMPLES // BATCH or \
            not all(map(math.isfinite, values)):
        fail(f"{label}: {len(convexps)} ConvExp layers, losses {values}")
    if not max(errs) <= 1e-6 or any(id(u) in in_opt for u in carried) or \
            len(errs) != 9 * len(values):
        fail(f"{label}: the carried u does not follow the carry rule")

    logpx = exp.eval_epoch(exp.val_loader)
    body = Flow(flow.base_distribution, flow.layers[1:])
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    with torch.inference_mode():
        cheap = body(x + u)[1]
        exact = body(x + u, exact=True)[1]
        corr = flow.exact_ldj_correction((1, 28, 28)).item()
    gap = ((exact - cheap).abs() / cheap.abs()).max().item()
    bound = len(convexps) * CONVEXP_TAIL
    print(f"{label}: eval over 1 batch: log p(x) {logpx:.4f}, BPD "
          f"{exp.to_bpd(logpx):.4f}; exact log p (13 terms) vs cheap (6), "
          f"same noise: max rel gap {gap:.3e} (the series tail bound "
          f"{bound:.3e}), exact correction {corr}", flush=True)
    if not (math.isfinite(logpx) and gap <= bound and corr == 0.0):
        fail(f"{label}: eval {logpx}, exact gap {gap} > {bound}")

    with torch.inference_mode():
        s = flow.sample(BATCH, gen)
        tail = Flow(flow.base_distribution, flow.layers[4:])
        z, _ = flow.base_distribution.sample(gen, BATCH, device=dev)
        y = tail.sample(BATCH, noise={"base": z})
        z_back = tail(y, exact=True)[0]
        rt = ((z_back - z).abs().max() / z.abs().max().clamp(min=1)).item()
    print(f"{label}: Flow.sample of {BATCH}: shape {tuple(s.shape)}, values "
          f"{s.min().item():.0f}..{s.max().item():.0f}, finite "
          f"{bool(torch.isfinite(s).all())}; round trip through the layers "
          f"after the logit, forward(sample(z)) vs z: max abs err / "
          f"max(1, max|z|) {rt:.3e} (tol {ROUND_TRIP_RTOL:.0e})", flush=True)
    if not (torch.isfinite(s).all() and s.shape == (BATCH, 1, 28, 28)
            and rt <= ROUND_TRIP_RTOL):
        fail(f"{label}: samples not finite or round trip {rt}")

    def step():
        exp.train_step(x + u)

    t = ab_ms({"step": step}, reps=3, rounds=2)
    print(f"{label}: train {t['step']:.3f} ms/step of {BATCH}, CUDA events, "
          f"median of 2 turns of 3 steps {card}", flush=True)
    device_profile(label, "step", step, 2, card)
    phase_cli(card, "exponential_cnn_mnist")


def phase_fastflow(dev, gen, card, torch):
    """The paper's FastFlow ImageNet32 model (``if_imagenet_multi_gpu``'s
    spec: 3 levels x 48 steps of [``InvFlow`` TL 3x3, ``Conv1x1``,
    ``Coupling`` width 512], ``GaussianizeSplit`` between levels) at its
    registry config with ``data_parallel=False`` (Adam lr 1e-5, no
    scheduler), B=100, on synthetic ImageNet32: the N=1 TL launch at its
    three solve shapes, forward and backward, against the plain version
    and timed beside it, the library call and the bound (rows L, Lb); data
    init and one eval batch (144 launches a pass, 3 passes); log p(x)
    against the plain chain; 3 train steps (144 forward and 144 backward
    launches a step, all ``cluster``); step-1 gradients against the plain
    chain; train ms/step against the plain chain, peak memory, a profiled
    step; ``Flow.sample`` of 100. Returns the forward and backward rows of
    the summary line."""
    from inverse_flow_tpu_torch.data import ArrayLoader
    from inverse_flow_tpu_torch.experiments.registry import \
        FASTFLOW_IMAGENET32 as spec
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.train.experiment import Experiment

    label = "fastflow"
    on = dict(gen=gen, dev=dev, torch=torch)
    cases = [(chw, ("TL",)) for chw in UNIT_SHAPES]
    errs = (check_forward(cases, f"{label}: kernel", **on),
            check_backward(cases, f"{label}: backward", **on))
    rows = [dict(time_rows(UNIT_SHAPES, ("TL",), backward, 50, 4, label,
                           card=card, **on), max_abs_err=err)
            for backward, err in ((False, errs[0]), (True, errs[1]))]

    cfg = spec.config.replace(
        data_parallel=False, batch_size=BATCH, max_eval_ex=BATCH,
        save_images=False, plot_recon=False, seed=0,
        metrics_path=os.path.join(HERE, "chiprun_out",
                                  "fastflow_metrics.jsonl"))
    with warnings.catch_warnings(record=True):   # phase 8 printed it
        warnings.simplefilter("always")
        train, val, test = spec.load_data(batch_size=BATCH, seed=cfg.seed)
    train = ArrayLoader(train.data[:UNIT_TRAIN_EXAMPLES], BATCH,
                        shuffle=True, seed=cfg.seed)
    first = train.data[:BATCH]
    flow = spec.build_model(device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    n_params = sum(p.numel() for p in flow.parameters())

    fused_chain.reset_launches()
    t0 = time.perf_counter()
    exp.maybe_data_init(first)
    logpx = exp.eval_epoch(val)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} data init + eval", launches)
    eval_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    print(f"{label}: {cfg.name} with data_parallel=False, {n_params} params;"
          f" data init + eval over 1 batch of {BATCH}: log p(x) "
          f"{logpx:.4f}, BPD {exp.to_bpd(logpx):.4f}; chain kernel launches "
          f"{launches} for 3 passes (144 per pass); {host_s:.1f} s; peak "
          f"memory {eval_gb:.3f} GB", flush=True)
    if not math.isfinite(logpx) or launches != 144 * 3:
        fail(f"{label}: log p {logpx}, {launches} launches (expected "
             f"{DP_PASS * 3})")

    body = Flow(flow.base_distribution, flow.layers[1:])
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    with torch.inference_mode():
        z, lp = body(x + u)
        with plain_chain(fused_chain):
            _, lp_ref = body(x + u)
    rel = ((lp - lp_ref).abs() / lp_ref.abs()).max().item()
    print(f"{label}: log p(x) kernel vs plain chain on one batch, same "
          f"noise: max rel err {rel:.3e} (tol {LOGPX_RTOL:.0e}); z "
          f"{tuple(z.shape)}", flush=True)
    if z.shape != (BATCH, 48, 4, 4) or not rel <= LOGPX_RTOL:
        fail(f"{label}: output {tuple(z.shape)}, log p rel err {rel}")
    del z, lp, lp_ref

    values, mean_loss, launches, bwd, init_state = counted_epoch(
        exp, first, torch)
    by = dict(fused_chain.chain_phases.launches_by_variant)
    peak_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    steps = len(values)
    print(f"{label}: {steps} steps of {BATCH} (Adam lr {cfg.lr}, no "
          f"scheduler): losses {', '.join(f'{v:.4f}' for v in values)}; "
          f"chain kernel launches {launches - bwd} forward + {bwd} backward "
          f"(by variant {by}); peak memory {peak_gb:.3f} GB {card}",
          flush=True)
    if steps != UNIT_TRAIN_EXAMPLES // BATCH or \
            not all(map(math.isfinite, values)):
        fail(f"{label}: losses {values}")
    if (launches - bwd, bwd) != (144 * steps, 144 * steps):
        fail(f"{label}: expected 144 + 144 chain launches a step, got "
             f"{launches - bwd} + {bwd} in {steps} steps")

    flow.load_state_dict(init_state)
    x = check_grads(label, flow, first, gen, dev, torch)[0]
    step = time_steps(label, exp, x, 1, 2, card, torch)
    device_profile(label, "step", step, 1, card)

    fused_chain.reset_launches()
    with torch.inference_mode():
        s = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    print(f"{label}: Flow.sample of {BATCH}: shape {tuple(s.shape)}, values "
          f"{s.min().item():.0f}..{s.max().item():.0f}, finite "
          f"{bool(torch.isfinite(s).all())}, "
          f"{fused_chain.chain_phases.launches} chain launches (InvFlow's "
          f"inverse is its masked conv)", flush=True)
    if not torch.isfinite(s).all() or s.shape != (BATCH, 3, 32, 32):
        fail(f"{label}: samples not finite")
    return [dict(r, launches=n) for r, n in zip(rows, (launches - bwd, bwd))]


def check_grouped_invflow(gen, dev, card, torch):
    """``InvFlow(12, (3, 3), groups=2)`` at (100, 12, 16, 16), forward and
    backward through the chain kernel (one launch each, ``cluster``),
    against the same layer on the plain chain: y and dx within ``1e-5 *
    max(1, max|.|)``, dW within 1e-4 of max|dW|; then the launch on the
    expanded block-diagonal kernel timed beside the plain version, the
    library call and the bound. Returns the summary entry."""
    from inverse_flow_tpu_torch.layers import InvFlow
    from inverse_flow_tpu_torch.ops import fused_chain

    chw = UNIT_SHAPES[0]
    layer = InvFlow(chw[0], (3, 3), groups=2, generator=gen, device=dev)
    x = torch.randn((BATCH,) + chw, generator=gen, device=dev)
    gy = torch.randn(x.shape, generator=gen, device=dev)

    def run():
        xr = x.clone().requires_grad_()
        y = layer(xr)[0]
        return (y.detach(),) + torch.autograd.grad(y, [xr, layer.w], gy)

    fused_chain.reset_launches()
    y, dx, dw = run()
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only("grouped InvFlow forward + backward", launches)
    with plain_chain(fused_chain):
        y_ref, dx_ref, dw_ref = run()
    err = (y - y_ref).abs().max().item()
    dx_err = (dx - dx_ref).abs().max().item()
    dw_rel = ((dw - dw_ref).abs().max() / dw_ref.abs().max()).item()
    tol = 1e-5 * max(1.0, y_ref.abs().max().item())
    dx_tol = 1e-5 * max(1.0, dx_ref.abs().max().item())
    w = fused_chain.expand_grouped_kernel(
        layer._w_eff(layer.own_params()).detach(), 2)
    t, (bound, bound_by, fma), lib_err = time_launch(
        x, [w], ("TL",), False, 50, 4, torch)
    print(f"grouped: InvFlow groups=2 {(BATCH,) + chw}: {launches} chain "
          f"launches (forward + backward); y max abs err {err:.3e} (tol "
          f"{tol:.3e}), dx {dx_err:.3e} (tol {dx_tol:.3e}), dW max err / "
          f"max|dW| {dw_rel:.3e} (tol 1e-4); "
          f"{launch_times(t, bound, bound_by, fma)}; library vs kernel max "
          f"abs diff {lib_err:.3e} {card}", flush=True)
    if launches != 2 or not (err <= tol and dx_err <= dx_tol
                             and dw_rel <= 1e-4):
        fail("the grouped InvFlow through the kernel disagrees with the "
             "plain chain")
    return dict(mean_row([(t["kernel"], t["streaming"], t["plain"],
                           t["library"], bound)], bound_by),
                max_abs_err=max(err, dx_err), launches=launches)


def phase_zoo(dev, gen, card, torch):
    """Phase 14: ``exponential_cnn_mnist`` (:func:`phase_exponential`),
    FastFlow ImageNet32 (:func:`phase_fastflow`), the grouped ``InvFlow``
    on the card (:func:`check_grouped_invflow`), the SmoothTanh-inverse
    kernel (:func:`check_smooth_tanh`, :func:`smooth_tanh_path`) and the
    B-spline layers (:func:`phase_bspline`). Returns the summary line's
    new entries."""
    t0 = time.perf_counter()
    phase_exponential(dev, gen, card, torch)
    fastflow_rows = phase_fastflow(dev, gen, card, torch)
    torch.cuda.empty_cache()
    grouped_row = check_grouped_invflow(gen, dev, card, torch)
    tanh_row = check_smooth_tanh(gen, dev, card, torch)
    tanh_row["launches"] = smooth_tanh_path(gen, dev, torch)
    phase_bspline(gen, dev, card, torch)
    print(f"zoo: phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)
    return fastflow_rows, grouped_row, tanh_row


# ---- 15. the CIFAR-10 family and the bf16-coupling configurations ------

CIFAR_SHAPES = [(12, 16, 16), (24, 8, 8)]
CIFAR_STEPS = 3
BF16_BATCHES = (1024, 4096)
BF16_STEPS = 2
# the bf16 value check runs on weights that have left their init (there
# w3, b3 and logs3 are 0 and the net's output is exactly 0 in either
# dtype): after train steps, then with every coupling's w3, b3 and logs3
# moved by this much normal noise (about 100 Adam steps at lr 1e-5; at
# random init the model's latents are so large that 0.05 overflows
# float32 and 0.005 moves its bpd of about 54 by 0.05 on the CPU); the
# bounds on the bpd of each example and on the gradient's relative norm
BF16_PERTURB = 1e-3
BF16_BPD_TOL = 0.01
BF16_GRAD_RTOL = 0.05


def cluster_waves(label, shapes, orders, b, gen, dev, torch, _build):
    """Prints, at each shape, the clusters of 8 rows a launch at batch
    ``b`` needs against those resident at once, the waves that makes, and
    the rows of the last cluster."""
    from inverse_flow_tpu_torch.ops import fused_chain

    for chw in shapes:
        args = fused_chain.chain_inputs(*solve_operands(
            chw, orders, gen, dev, torch, b), orders)
        rcw, kcw = args[0].shape[2], args[4]
        active = _build.cluster_occupancy(dev.index, b, rcw, kcw)
        need = -(-b // fused_chain.CLUSTER_ROWS)
        print(f"{label}: ({b},{','.join(map(str, chw))}) {'-'.join(orders)} "
              f"RCW={rcw} KCW={kcw}: {need} clusters of "
              f"{fused_chain.CLUSTER_ROWS} rows needed, {active} resident at "
              f"once: {-(-need // active)} waves; the last cluster has "
              f"{b - fused_chain.CLUSTER_ROWS * (need - 1)} rows", flush=True)


def rows_at(label, shapes, orders, b, reps, rounds, gen, dev, card, torch,
            _build):
    """The chain kernel at batch ``b``, forward and the backward's launch,
    at each shape: against its plain version (:func:`check_forward`,
    :func:`check_backward`), its clusters and waves
    (:func:`cluster_waves`), and timed beside the streaming kernel, the
    plain version, the library call and the bound (:func:`time_rows`).
    Returns the forward and backward summary entries without launches."""
    on = dict(gen=gen, dev=dev, torch=torch)
    cases = [(chw, orders) for chw in shapes]
    errs = (check_forward(cases, f"{label}: kernel", b=b, **on),
            check_backward(cases, f"{label}: backward", b=b, **on))
    cluster_waves(label, shapes, orders, b, gen, dev, torch, _build)
    return [dict(time_rows(shapes, orders, backward, reps, rounds, label,
                           card=card, b=b, **on), max_abs_err=err)
            for backward, err in ((False, errs[0]), (True, errs[1]))]


def step_ms(label, exp, first, card, torch, profiled=True):
    """Train ms/step of ``exp`` on the batch ``first``, the median of 2
    turns after a warm-up step, and samples/s; then, if ``profiled``, one
    step under the profiler (device busy, idle share, launch calls)."""
    x = torch.as_tensor(first, device=exp.device)
    t = ab_ms({"step": lambda: exp.train_step(x)}, reps=1,
              rounds=2)["step"]
    print(f"{label}: {t:.3f} ms/step of {exp.cfg.batch_size}, "
          f"{1e3 * exp.cfg.batch_size / t:.1f} samples/s, median of 2 {card}",
          flush=True)
    if profiled:
        device_profile(label, "step", lambda: exp.train_step(x), 1, card)


def phase_if_glow_cifar(dev, gen, card, torch, _build):
    """``if_glow_cifar`` through the registry and ``Experiment`` (L=2 x
    K=16 ``InvFlowNoPad`` 3x3, width 128, no ActNorm, RQ spline, batch
    140, synthetic CIFAR-10): the N=1 TL launch at B=140, forward and
    backward, at its two shapes (18 clusters, the last of 4 rows) against
    its plain version and timed (:func:`rows_at`); data init and 3 train
    steps (32 + 32 launches a step, all ``cluster``); eval over one batch
    (32 launches); ``Flow.sample`` of 100 (no launch: the inverse is the
    masked conv); the step-1 gradients against the plain chain; ms/step
    against the plain chain and a profiled step. Returns the forward and
    backward summary entries."""
    from inverse_flow_tpu_torch.experiments.registry import get_experiment
    from inverse_flow_tpu_torch.ops import fused_chain

    label = "if_glow_cifar"
    b = get_experiment(label).config.batch_size
    rows = rows_at(label, CIFAR_SHAPES, ("TL",), b, 50, 4, gen, dev, card,
                   torch, _build)
    exp, first = baseline(label, dev, torch, CIFAR_STEPS * b, max_eval_ex=b)
    n_params = sum(p.numel() for p in exp.flow.parameters())
    values, init_state = train_baseline(label, exp, first, torch,
                                        launches_per_step=32, init_passes=2)
    launches = fused_chain.chain_phases.launches
    by = dict(fused_chain.chain_phases.launches_by_variant)
    bwd = 32 * len(values)
    fused_chain.reset_launches()
    bpd = exp.to_bpd(exp.eval_epoch(exp.val_loader))
    torch.cuda.synchronize()
    eval_launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} eval", eval_launches)
    fused_chain.reset_launches()
    with torch.inference_mode():
        s = exp.flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    sample_launches = fused_chain.chain_phases.launches
    print(f"{label}: {n_params} params; chain launches by variant {by} for "
          f"data init + {len(values)} steps; eval over 1 batch of {b}: BPD "
          f"{bpd:.4f}, {eval_launches} chain launches; Flow.sample of "
          f"{BATCH}: {tuple(s.shape)}, values {s.min().item():.0f}.."
          f"{s.max().item():.0f}, {sample_launches} chain launches",
          flush=True)
    if not math.isfinite(bpd) or eval_launches != 32:
        fail(f"{label} eval: BPD {bpd}, {eval_launches} launches (32)")
    if sample_launches or s.shape != (BATCH, 3, 32, 32) \
            or not torch.isfinite(s).all():
        fail(f"{label}: samples not finite or {sample_launches} launches")
    exp.flow.load_state_dict(init_state)
    x = check_grads(label, exp.flow, first, gen, dev, torch)[0]
    step = time_steps(label, exp, x, 1, 2, card, torch)
    device_profile(label, "step", step, 1, card)
    return [dict(rows[0], launches=launches - bwd),
            dict(rows[1], launches=bwd)]


def phase_ff_cifar(dev, gen, card, torch):
    """``ff_glow_cifar`` through the registry (L=2 x K=16 ``FincFlowUnit``,
    width 512, RQ spline, recon weight 10, batch 100): data init and 3
    train steps (no launch: the forward is a grouped conv), ms/step; then
    ``Flow.sample`` of 100, FincFlow's level 2 on the chain kernel: 32
    launches, all ``cluster``, finite, and kernel against plain chain on
    the same draws; the grouped launch at CIFAR's two shapes against its
    plain version and timed (:func:`grouped_rows`). Returns the summary
    entry, its launches those of the ``Flow.sample``."""
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.ops import fused_chain

    label = "ff_glow_cifar"
    exp, first = baseline(label, dev, torch, CIFAR_STEPS * BATCH,
                          max_eval_ex=BATCH)
    train_baseline(label, exp, first, torch)
    step_ms(label, exp, first, card, torch)
    flow = exp.flow
    fused_chain.reset_launches()
    with torch.inference_mode():
        s = flow.sample(BATCH, gen)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} Flow.sample", launches)
    noise = sample_noise(flow, BATCH, gen, dev, torch)
    body = Flow(flow.base_distribution, flow.layers[1:])
    with torch.inference_mode():
        y = body.sample(BATCH, noise=noise)
        with plain_chain(fused_chain):
            y_ref = body.sample(BATCH, noise=noise)
    rel = ((y - y_ref).norm() / y_ref.norm()).item()
    print(f"{label}: Flow.sample of {BATCH}: {launches} chain launches (one "
          f"per FincFlowUnit), values {s.min().item():.0f}.."
          f"{s.max().item():.0f}; before the floor, kernel vs plain chain on "
          f"the same draws |y - y_plain| / |y_plain| {rel:.3e} (tol "
          f"{SAMPLE_RTOL:.0e})", flush=True)
    if launches != 32 or s.shape != (BATCH, 3, 32, 32) \
            or not torch.isfinite(s).all():
        fail(f"{label}: {launches} launches (32) or samples not finite")
    if not (torch.isfinite(y).all() and rel <= SAMPLE_RTOL):
        fail(f"{label}: samples through the kernel disagree with the plain "
             f"chain")
    row = grouped_rows(gen, dev, card, torch, CIFAR_SHAPES, (BATCH,), label)
    return dict(row, launches=launches)


def phase_cifar_baselines(dev, torch, card):
    """``selfnorm_glow_cifar`` (L=2 x K=4 SelfNorm 1x1, width 512, recon
    weight 1000, clamp 0.001) and ``conv1x1_glow_cifar`` (L=2 x K=16
    Conv1x1, width 512) at their registry configs: data init and 3 train
    steps each (finite losses, no chain launch) and ms/step."""
    for name in ("selfnorm_glow_cifar", "conv1x1_glow_cifar"):
        exp, first = baseline(name, dev, torch, CIFAR_STEPS * BATCH,
                              max_eval_ex=BATCH)
        train_baseline(name, exp, first, torch)
        step_ms(name, exp, first, card, torch, profiled=False)
        del exp
        torch.cuda.empty_cache()


def bf16_run(name, steps, dev, card, torch):
    """``bench.py``'s config ``name`` through ``bench_configs`` at its
    batch, weights from seed 0, with ``imagenet32``'s training config (Adam
    lr 1e-5, no scheduler, no clamp) on ``steps`` batches of synthetic
    (3, 32, 32) images: data init and one epoch (a forward launch a unit a
    pass, 144 at L=3 x K=48, and as many more a step when every step is
    checkpointed; 144 backward a step; all ``cluster``), finite losses,
    peak memory; then ms/step,
    samples/s and a profiled step (:func:`step_ms`). Returns ((forward,
    backward) launches, the Experiment, its first batch)."""
    from inverse_flow_tpu_torch.data import ArrayLoader, synthetic
    from inverse_flow_tpu_torch.experiments import bench_configs
    from inverse_flow_tpu_torch.layers import RepeatedBlock
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    flow, shape, b = bench_configs.build(
        name, device=dev, generator=torch.Generator(dev).manual_seed(0))
    blocks = [m for m in flow.modules() if isinstance(m, RepeatedBlock)]
    remat = all(m.remat for m in blocks)
    per_pass = sum(m.n_repeats for m in blocks)        # 144 at K=48, L=3
    images = synthetic.smooth_images(steps * b, shape, seed=0)
    train = ArrayLoader(images, b, shuffle=True, seed=0)
    cfg = ExperimentConfig(
        name=name, lr=1e-5, batch_size=b, warmup_epochs=0,
        scheduler_name="None", weight_clamp=None, add_recon_grad=False,
        plot_recon=False, save_images=False, seed=0,
        metrics_path=os.path.join(HERE, "chiprun_out",
                                  f"{name}_metrics.jsonl"))
    exp = Experiment(flow, train, train, train, cfg, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    values, _, launches, bwd, _ = counted_epoch(exp, images[:b], torch)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    fwd_need = per_pass * (2 + (1 + remat) * steps)
    print(f"{name}: batch {b}, bf16 couplings, every step checkpointed "
          f"{remat}: data init + {len(values)} steps: losses "
          f"{', '.join(f'{v:.4f}' for v in values)}; chain kernel launches "
          f"{launches - bwd} forward + {bwd} backward (all cluster); peak "
          f"memory {peak_gb:.3f} GB {card}", flush=True)
    if len(values) != steps or not all(map(math.isfinite, values)):
        fail(f"{name}: losses {values}")
    if (launches - bwd, bwd) != (fwd_need, per_pass * steps):
        fail(f"{name}: expected {fwd_need} + {per_pass * steps} chain "
             f"launches, got {launches - bwd} + {bwd}")
    step_ms(name, exp, images[:b], card, torch)
    return (launches - bwd, bwd), exp, images[:b]


def bf16_value_check(flow, name, first, trained, card, torch):
    """``flow`` (config ``name``'s model with bf16 coupling nets, in the
    state ``trained`` says) against the same model with float32 coupling
    nets on the same weights: log p(x) of the batch ``first`` and the
    gradients of its mean, through the kernel, on the same dequantization
    noise; then again with every coupling's ``w3``, ``b3`` and ``logs3``
    moved by ``BF16_PERTURB`` normal noise in both. Fails unless every
    example's bpd is within ``BF16_BPD_TOL`` and the gradient within
    ``BF16_GRAD_RTOL`` by relative norm."""
    from inverse_flow_tpu_torch.experiments import bench_configs
    from inverse_flow_tpu_torch.layers import Flow

    dev = next(flow.parameters()).device
    gen = torch.Generator(dev).manual_seed(1)
    flows = [bench_configs.build(name, device=dev, generator=gen)[0], flow]
    flows[0].load_state_dict(flow.state_dict())
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    dim = x[0].numel()
    for what, noise in ((trained, 0.0),
                        (f"w3, b3, logs3 then moved by {BF16_PERTURB} noise",
                         BF16_PERTURB)):
        if noise:
            with torch.no_grad():
                for n, p in flows[0].named_parameters():
                    if n.rsplit(".", 1)[-1] in ("w3", "b3", "logs3"):
                        p.add_(noise * torch.randn(p.shape, generator=gen,
                                                   device=dev))
            flows[1].load_state_dict(flows[0].state_dict())
        out = []
        for f in flows:
            body = Flow(f.base_distribution, f.layers[1:])
            lp = body(x + u)[1]
            g = torch.autograd.grad((-lp).mean(), list(body.parameters()))
            out.append((lp.detach(), torch.cat([t.reshape(-1) for t in g])))
        (lp32, g32), (lpbf, gbf) = out
        dbpd = ((lp32 - lpbf).abs() / (math.log(2.0) * dim)).max().item()
        bpd = (-lp32.mean() / (math.log(2.0) * dim)).item()
        grel = ((gbf - g32).norm() / g32.norm()).item()
        print(f"bf16: value check, {name} (B={x.shape[0]}) with float32 "
              f"vs bf16 coupling nets on the same weights ({what}) and "
              f"noise: bpd {bpd:.4f}; max |dbpd| over the examples "
              f"{dbpd:.3e} (bound {BF16_BPD_TOL}); gradient |g_bf16 - g| / "
              f"|g| {grel:.3e} (bound {BF16_GRAD_RTOL}) {card}", flush=True)
        if not (math.isfinite(bpd) and dbpd <= BF16_BPD_TOL
                and grel <= BF16_GRAD_RTOL):
            fail(f"bf16 couplings move the {name} model's bpd or "
                 f"gradients past their bounds")


def phase_cifar_bf16(dev, gen, card, torch, _build):
    """Phase 15: the CIFAR-10 family (:func:`phase_if_glow_cifar`,
    :func:`phase_ff_cifar`, :func:`phase_cifar_baselines`), and the
    bf16-coupling configurations of ``bench.py`` at batch 100, 1024 and
    4096 (:func:`bf16_run`), the first with the bf16 value check
    (:func:`bf16_value_check`), the others with the four-order chain
    kernel at their batch (:func:`rows_at`). Returns the summary line's
    new entries by name."""
    t0 = lap = time.perf_counter()

    def part(what):
        nonlocal lap
        now = time.perf_counter()
        print(f"cifar_bf16: {what} in {now - lap:.1f} s", flush=True)
        lap = now
        torch.cuda.empty_cache()

    cifar_rows = phase_if_glow_cifar(dev, gen, card, torch, _build)
    part("if_glow_cifar")
    ff_row = phase_ff_cifar(dev, gen, card, torch)
    part("ff_glow_cifar")
    phase_cifar_baselines(dev, torch, card)
    part("selfnorm_glow_cifar and conv1x1_glow_cifar")
    _, exp, first = bf16_run("imagenet32_bf16_couplings", 3, dev, card, torch)
    bf16_value_check(exp.flow, "imagenet32", first,
                     f"after data init and {exp.step} steps", card, torch)
    del exp
    part("imagenet32_bf16_couplings and the value check")
    entries = {"chain_phases:cifar": cifar_rows[0],
               "chain_phases:cifar_backward": cifar_rows[1],
               "chain_phases:ff_cifar": ff_row}
    for b, name in zip(BF16_BATCHES, ("imagenet32_b1024",
                                      "imagenet32_b4096")):
        rows = rows_at(f"imagenet32 B={b}", UNIT_SHAPES, UNIT, b, 2, 2, gen,
                       dev, card, torch, _build)
        (fwd, bwd), _, _ = bf16_run(name, BF16_STEPS, dev, card, torch)
        entries[f"chain_phases:unit_b{b}"] = dict(rows[0], launches=fwd)
        entries[f"chain_phases:unit_b{b}_backward"] = dict(rows[1],
                                                           launches=bwd)
        part(name)
    print(f"cifar_bf16: phase 15 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return entries


# the Newton kernels of csrc/slr_inverse.cu whose loops phase 2 reads,
# by the names in their SASS, and the MUFU instructions a step of each
NEWTON_KERNELS = {
    ("newton_inverse_kernel", "SlrStep"): SLR_MUFU_PER_STEP,
    ("newton_inverse_kernel", "TanhStep"): TANH_MUFU_PER_STEP,
    ("newton_lane_exit_kernel", "TanhStep"): TANH_MUFU_PER_STEP}


def newton_loop_mufu(lib):
    """Per step of each of ``NEWTON_KERNELS`` in the built library
    ``lib``, keyed ``"kernel<Step>"``, the MUFU instructions and the calls
    in its Newton loop: the SASS (``cuobjdump -sass``) between the target
    of the backward branch that closes the loop (the one after the warp
    vote) and that branch."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found, key, code = {}, None, []
    for line in sass.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if key is not None:
                found[key] = _loop_mufu(code)
            name = line.split("Function :")[1]
            key = next((f"{kernel}<{step}>" for kernel, step in NEWTON_KERNELS
                        if kernel in name and step in name), None)
            code = []
        elif key is not None and line.strip().startswith("/*"):
            addr, _, rest = line.strip()[2:].partition("*/")
            code.append((int(addr, 16), rest.split(";")[0].strip()))
    return found


def _loop_mufu(code):
    """(MUFU instructions, calls) between a loop's backward branch, the
    first after the kernel's VOTE, and its target."""
    vote = next(a for a, ins in code if ins.startswith("VOTE"))
    end, start = next(
        (a, int(ins.split()[-1], 16)) for a, ins in code
        if a > vote and "BRA" in ins and int(ins.split()[-1], 16) < a)
    body = [ins for a, ins in code if start <= a <= end]
    return (sum(ins.startswith("MUFU") for ins in body),
            sum(ins.startswith("CALL") for ins in body))


# ---------------------------------------------------------------------------
# Phase 16: data parallelism and the native library
# ---------------------------------------------------------------------------
DP_NAME = "if_multiGPU_imagenet32"
DP_BATCH = 250
DP_STEPS = 3
FASTFLOW_NAME = "if_imagenet_multi_gpu"
# chain launches a pass through either model: 3 levels x 48 N=1 TL solves
DP_PASS = 144
# the spawned ranks' deadline: a rank that hangs fails the phase
DP_TIMEOUT = 600.0
NATIVE_SHAPE = (100, 4, 14, 14)


def _dp_rank_start(torch, rank):
    """A spawned rank's set-up: the card (every rank on card 0: the phase
    runs on one H100), TF32 off as in the parent, the chain kernel
    loaded."""
    from inverse_flow_tpu_torch.ops import _build

    # cuBLAS is deterministic under use_deterministic_algorithms only with
    # this workspace, set before its first handle
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.chain_solve_lib(dev.index)
    return dev


def _dp_experiment(name, dev, torch, n_train, **config):
    """The registry's ``name`` as :func:`baseline` builds it, data
    parallelism on (a group of one or more ranks)."""
    exp, first = baseline(name, dev, torch, n_train, **config)
    if not exp.cfg.data_parallel or not exp.distributed:
        fail(f"{name}: the Experiment is not data parallel in its group")
    return exp, first


def _replicated(exp, what):
    if not exp.replicas_equal():
        fail(f"{exp.cfg.name}: the replicas differ {what}")


def dp_one_rank(rank, size, card):
    """Phase 16's world of one over NCCL (a spawned process): the main
    path of ``if_multiGPU_imagenet32`` at its registry config (L=3 x K=48
    ``InvFlowNoPad``, width 256, RQ spline, B=250, Adam lr 1e-5) on
    synthetic ImageNet32, with every count set to 0 just before and read
    just after: data init and one eval batch (144 launches a pass), 3
    train steps (144 + 144 launches a step, all ``cluster``); the step-1
    gradients against the plain chain; ms/step, device busy and peak
    memory; then the same weights and batch trained 2 steps with and
    without data parallelism, bit for bit; then FastFlow's 2 steps.
    Returns the main path's launches and the timings."""
    import torch

    from inverse_flow_tpu_torch.ops import fused_chain

    dev = _dp_rank_start(torch, rank)
    label = "dp W=1"
    exp, first = _dp_experiment(DP_NAME, dev, torch, DP_STEPS * DP_BATCH,
                                max_eval_ex=DP_BATCH)
    n_params = sum(p.numel() for p in exp.params)
    fused_chain.reset_launches()
    exp.maybe_data_init(first)
    logpx = exp.eval_epoch(exp.val_loader)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only(f"{label} data init + eval", launches)
    print(f"{label}: {exp.cfg.name} (NCCL, rank {rank} of {size}), "
          f"{n_params} params; data init + eval over 1 batch of "
          f"{DP_BATCH}: log p(x) {logpx:.4f}, BPD {exp.to_bpd(logpx):.4f}; "
          f"chain kernel launches {launches} for 3 passes ({DP_PASS} a pass)",
          flush=True)
    if not math.isfinite(logpx) or launches != DP_PASS * 3:
        fail(f"{label}: log p {logpx}, {launches} launches (expected "
             f"{DP_PASS * 3})")

    values, _, launches, bwd, init_state = counted_epoch(exp, first, torch)
    by = dict(fused_chain.chain_phases.launches_by_variant)
    peak_gb = exp.memory_tracker.snapshot()["peak_mb"] / 1024
    print(f"{label}: {len(values)} steps of {DP_BATCH}: losses "
          f"{', '.join(f'{v:.4f}' for v in values)}; chain kernel launches "
          f"{launches - bwd} forward + {bwd} backward (by variant {by}); "
          f"replicas equal {exp.replicas_equal()}; peak memory "
          f"{peak_gb:.3f} GB {card}", flush=True)
    if len(values) != DP_STEPS or not all(map(math.isfinite, values)):
        fail(f"{label}: losses {values}")
    if (launches - bwd, bwd) != (DP_PASS * DP_STEPS, DP_PASS * DP_STEPS):
        fail(f"{label}: expected {DP_PASS} + {DP_PASS} chain launches a "
             f"step, got {launches - bwd} + {bwd} in {DP_STEPS} steps")
    main_launches = (launches - bwd, bwd)

    exp.flow.load_state_dict(init_state)
    x = check_grads(label, exp.flow, first, exp.generator, dev, torch)[0]
    t = ab_ms({"step": lambda: exp.train_step(x)}, reps=1,
              rounds=2)["step"]
    print(f"{label}: {t:.3f} ms/step of {DP_BATCH} (one rank, NCCL "
          f"all-reduce of {n_params} gradients a step), median of 2 {card}",
          flush=True)
    busy, calls, _ = device_profile("dp_w1", "step",
                                    lambda: exp.train_step(x), 1, card)
    del exp, x
    torch.cuda.empty_cache()

    same = one_rank_bitwise(init_state, first, dev, torch)
    print(f"{label}: data_parallel=True in a group of one against "
          f"data_parallel=False, same weights and batch, deterministic "
          f"algorithms: losses and every parameter bitwise equal after "
          f"each of 2 steps: {same}", flush=True)
    if same != [True, True]:
        fail(f"{label}: a world of one is not the one-device run: {same}")
    torch.cuda.empty_cache()

    exp, first = _dp_experiment(FASTFLOW_NAME, dev, torch, 2 * BATCH)
    values, _, launches, bwd, _ = counted_epoch(exp, first, torch)
    print(f"{label}: {exp.cfg.name}, data init + {len(values)} steps of "
          f"{BATCH}: losses {', '.join(f'{v:.4f}' for v in values)}; chain "
          f"kernel launches {launches - bwd} forward + {bwd} backward",
          flush=True)
    if not all(map(math.isfinite, values)) or (launches - bwd, bwd) != (
            DP_PASS * (2 + len(values)), DP_PASS * len(values)):
        fail(f"{label}: FastFlow losses {values}, {launches - bwd} + {bwd} "
             f"launches (expected {DP_PASS} x 2 + {DP_PASS} and {DP_PASS} "
             f"a step)")
    return dict(launches=main_launches, ms=t, busy=busy, calls=calls,
                n_params=n_params, peak_gb=peak_gb)


def one_rank_bitwise(state, first, dev, torch):
    """Two Experiments of ``if_multiGPU_imagenet32`` on the weights
    ``state`` (after data init), one with data parallelism in the group of
    one and one without, 2 train steps each on the batch ``first`` under
    ``torch.use_deterministic_algorithms`` (cuDNN's and the scatters'
    backward otherwise sum in no fixed order): whether the losses and
    every parameter are bitwise equal after each step."""
    exps = []
    for data_parallel in (True, False):
        exp, _ = baseline(DP_NAME, dev, torch, DP_BATCH,
                          data_parallel=data_parallel)
        exp.flow.load_state_dict(state)
        exp._data_initialized = True
        exps.append(exp)
    if not exps[0].distributed or exps[1].distributed:
        fail("one_rank_bitwise: the two Experiments are not DP and one-device")
    x = torch.as_tensor(first, device=dev)
    same = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                losses = [exp.train_step(x) for exp in exps]
                same.append(torch.equal(*losses) and all(
                    torch.equal(a, b) for a, b in zip(
                        exps[0].flow.parameters(),
                        exps[1].flow.parameters())))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    for w in {str(w.message) for w in caught}:
        print(f"dp W=1: nondeterministic under the check: {w}", flush=True)
    return same


def dp_two_ranks(rank, size, card):
    """Phase 16's world of two over gloo, both ranks on the one H100 (their
    clusters share its SMs: no two-card number): ``if_multiGPU_imagenet32``
    at B=250, 125 a rank, 2 steps. At step 1 the averaged gradient against
    the mean of two one-process gradients (rank 0, on slice 0 with rank
    0's generator state and on slice 1 with rank 1's, data parallelism
    off), within ``GRAD_RTOL``; the replicas bitwise equal after every
    step; ms/step, and the all-reduce's ms on the gradients alone. Then
    FastFlow (B=100, 50 a rank) 2 steps: finite losses, replicas equal."""
    import torch
    import torch.distributed as dist

    from inverse_flow_tpu_torch import parallel as dp
    from inverse_flow_tpu_torch.train import experiment as texperiment

    dev = _dp_rank_start(torch, rank)
    label = f"dp W=2 rank {rank}"
    exp, first = _dp_experiment(DP_NAME, dev, torch, 2 * DP_BATCH)
    exp.maybe_data_init(first)
    _replicated(exp, "after data init")
    state = copy.deepcopy(exp.flow.state_dict())
    gen_states = [None] * size
    dist.all_gather_object(gen_states, exp.generator.get_state())
    seen = {}
    apply = texperiment.apply_grads

    def recorded(cfg, optimizer, scheduler, params):
        seen["grads"] = [p.grad.clone() for p in params]
        return apply(cfg, optimizer, scheduler, params)

    with mock.patch.object(texperiment, "apply_grads", recorded):
        loss = exp.train_step(torch.as_tensor(exp.shard(first), device=dev))
    _replicated(exp, "after step 1")
    rel = None
    if rank == 0:
        rel = dp_grad_reference(state, first, gen_states, seen["grads"],
                                dev, torch)
    dp.barrier()
    x = torch.as_tensor(exp.shard(first), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss2 = exp.train_step(x)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    _replicated(exp, "after step 2")
    grads = [p.grad for p in exp.params]
    dp.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dp.all_reduce_mean_(grads)
    torch.cuda.synchronize()
    reduce_ms = 1e3 * (time.perf_counter() - t0) / 3
    n = sum(g.numel() for g in grads)
    if rank == 0:
        print(f"{label}: {exp.cfg.name} over gloo, {DP_BATCH // size} a "
              f"rank: losses {float(loss):.4f}, {float(loss2):.4f}; replicas "
              f"equal after each step; step 2 {step_ms:.3f} ms (host clock, "
              f"synced); all-reduce of {n} gradients {reduce_ms:.3f} ms (one "
              f"flat float32 buffer, through the host) {card}", flush=True)
    if not (math.isfinite(float(loss)) and math.isfinite(float(loss2))):
        fail(f"{label}: losses {float(loss)}, {float(loss2)}")
    del exp, x, grads, seen, state
    torch.cuda.empty_cache()

    exp, first = _dp_experiment(FASTFLOW_NAME, dev, torch, 2 * BATCH)
    exp.maybe_data_init(first)
    losses = []
    for i in range(2):
        losses.append(float(exp.train_step(torch.as_tensor(
            exp.shard(train_batch(exp, i)), device=dev))))
        _replicated(exp, f"after FastFlow step {i + 1}")
    if rank == 0:
        print(f"{label}: {exp.cfg.name} over gloo, {BATCH // size} a rank: "
              f"losses {', '.join(f'{v:.4f}' for v in losses)}; replicas "
              f"equal after each step", flush=True)
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: FastFlow losses {losses}")
    return dict(rel=rel, step_ms=step_ms, reduce_ms=reduce_ms, n=n)


def train_batch(exp, i):
    """The ``i``-th global batch of ``exp``'s (cut) train split."""
    b = exp.cfg.batch_size
    return exp.train_loader.data[i * b:(i + 1) * b]


def dp_grad_reference(state, first, gen_states, grads, dev, torch):
    """The mean of two one-process gradients of ``if_multiGPU_imagenet32``
    on the weights ``state``: slice r of ``first`` with generator state
    ``gen_states[r]``, data parallelism off; returns the largest
    norm-relative difference of ``grads`` (the all-reduced ones) from
    it."""
    from inverse_flow_tpu_torch import parallel as dp
    from inverse_flow_tpu_torch.train import experiment as texperiment

    exp, _ = baseline(DP_NAME, dev, torch, DP_BATCH, data_parallel=False)
    exp._data_initialized = True
    ref = []

    def recorded(cfg, optimizer, scheduler, params):
        ref.append([p.grad.clone() for p in params])

    for r, gen_state in enumerate(gen_states):
        exp.flow.load_state_dict(state)
        exp.generator.set_state(gen_state)
        with mock.patch.object(texperiment, "apply_grads", recorded):
            exp.train_step(torch.as_tensor(
                dp.shard_batch(first, r, len(gen_states)), device=dev))
    rel = max(((g - (a + b) / 2).norm() / ((a + b) / 2).norm()).item()
              for g, a, b in zip(grads, *ref) if ((a + b) / 2).norm() > 0)
    print(f"dp W=2: step-1 all-reduced gradients against the mean of two "
          f"one-process gradients (each slice with its rank's generator "
          f"state): max over {len(grads)} tensors of |g - g_mean| / "
          f"|g_mean| {rel:.3e} (tol {GRAD_RTOL:.0e})", flush=True)
    if not rel <= GRAD_RTOL:
        fail("the all-reduced gradients disagree with the one-process mean")
    return rel


def check_native(dev, gen, card, torch):
    """The port's native library: built from ``native/src`` into
    ``build/native`` (g++); ``inv_conv_solve``'s float64 oracle against
    the chain kernel's float32 solve at (100, 4, 14, 14) TL, within
    ``1e-5 * max(1, max|y|)``; the native prefetcher against the numpy
    loader on ``if_multiGPU_imagenet32``'s synthetic train split, host ms
    per batch of 250."""
    from inverse_flow_tpu_torch import native
    from inverse_flow_tpu_torch.data import ArrayLoader
    from inverse_flow_tpu_torch.experiments.registry import get_experiment
    from inverse_flow_tpu_torch.ops import fused_chain

    t0 = time.perf_counter()
    path = native.build()
    if not native.available():
        fail("the native library does not load")
    print(f"native: {os.path.relpath(path, HERE)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    x, (w,) = solve_operands(NATIVE_SHAPE[1:], ("TL",), gen, dev, torch,
                             NATIVE_SHAPE[0])
    with torch.inference_mode():
        y = fused_chain.fused_chain_solve(x, [w], ("TL",))
    torch.cuda.synchronize()
    ref = native.inv_conv_solve(x.double().cpu().numpy(),
                                w.double().cpu().numpy())
    err = float(abs(y.double().cpu().numpy() - ref).max())
    scale = float(abs(ref).max())
    print(f"native: inv_conv_solve (float64, C++) against the chain kernel "
          f"(float32) at {NATIVE_SHAPE} TL: max abs err {err:.3e}, max rel "
          f"err {err / scale:.3e} (tol {1e-5 * max(1.0, scale):.3e})",
          flush=True)
    if not err <= 1e-5 * max(1.0, scale):
        fail("the chain kernel disagrees with the float64 oracle")

    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        data = get_experiment(DP_NAME).load_data(batch_size=DP_BATCH)[0].data
    times = {}
    for prefetch in (True, False):
        loader = ArrayLoader(data, DP_BATCH, shuffle=True, seed=0,
                             native_prefetch=prefetch)
        for _ in loader:                # one warm-up epoch
            pass
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        times[prefetch] = 1e3 * (time.perf_counter() - t0) / n
    print(f"native: train split {data.shape}, batches of {DP_BATCH}: native "
          f"prefetcher {times[True]:.3f} ms/batch, numpy loader "
          f"{times[False]:.3f} ms/batch (host clock, the step's host time "
          f"not overlapped) {card}", flush=True)
    return err / scale


def phase_data_parallel(dev, gen, card, torch, _build):
    """Phase 16: ``if_multiGPU_imagenet32``'s N=1 TL launch at B=250 (32
    clusters in 3 waves, the last cluster of 2 rows), forward and
    backward, against its plain version and timed (rows P, Pb,
    :func:`rows_at`); the registry's two data-parallel names through
    ``Experiment`` in spawned processes: a world of one over NCCL
    (:func:`dp_one_rank`) and a world of two over gloo on the one card
    (:func:`dp_two_ranks`); the native library (:func:`check_native`).
    Returns the summary entries of rows P and Pb."""
    from inverse_flow_tpu_torch import parallel as dp

    t0 = time.perf_counter()
    rows = rows_at(f"{DP_NAME} B={DP_BATCH}", UNIT_SHAPES, ("TL",),
                   DP_BATCH, 20, 4, gen, dev, card, torch, _build)
    torch.cuda.empty_cache()
    out = os.path.join(HERE, "build", "dp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    runs = {}
    for name, fn, size, backend in (("w1", dp_one_rank, 1, "nccl"),
                                    ("w2", dp_two_ranks, 2, "gloo")):
        t1 = time.perf_counter()
        try:
            runs[name] = dp.spawn(fn, size, f"file://{out}/{name}",
                                  backend=backend, args=(card,),
                                  timeout=DP_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"data parallel {name}: {e}")
        print(f"dp: world of {size} over {backend} in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    w1, w2 = runs["w1"][0], runs["w2"][0]
    print(f"dp: {DP_NAME} ms/step at B={DP_BATCH}: {w1['ms']:.3f} at a "
          f"world of one (NCCL; busy {w1['busy']:.3f} ms, "
          f"{w1['calls']:.0f} launch calls, peak {w1['peak_gb']:.3f} GB), "
          f"{w2['step_ms']:.3f} at two ranks on one card (gloo); all-reduce "
          f"of {w2['n']} gradients {w2['reduce_ms']:.3f} ms; step-1 "
          f"gradient rel err {w2['rel']:.3e} {card}", flush=True)
    oracle = check_native(dev, gen, card, torch)
    print(f"dp: phase 16 in {time.perf_counter() - t0:.1f} s (oracle rel "
          f"err {oracle:.3e})", flush=True)
    fwd, bwd = w1["launches"]
    return [dict(rows[0], launches=fwd), dict(rows[1], launches=bwd)]


# ---------------------------------------------------------------------------
# Phase 18: the (data, model) mesh on the flagship
# ---------------------------------------------------------------------------
MESH_NAME = "if_glow_mnist"
MESH_SHAPE = (2, 2)
MESH_STEPS = 3
# the step-1 loss against the one-process step (the JAX test's bound)
MESH_LOSS_RTOL = 1e-5
# every coupling's w3, b3 and logs3 moved by this much normal noise before
# the steps: at init they are 0, the nets' output is 0 whatever w1 and w2
# hold, and the sharded weights would get no gradient
MESH_PERTURB = 1e-3
# chain launches a step on each rank: 32 solves forward, 32 backward
MESH_STEP_LAUNCHES = (32, 32)


def mesh_reference(flow, x, seed, n_data, torch):
    """The one-process step of the unsharded ``flow`` on the global batch
    ``x``: the mean over the data rows of the loss and of the gradients on
    each row's slice with that row's generator (``rank_seed(seed, d)``),
    the noise the mesh's ranks draw. Returns (loss, gradients by name)."""
    from inverse_flow_tpu_torch import parallel as dp

    named = [(n, p) for n, p in flow.named_parameters() if p.requires_grad]
    loss, grads = 0.0, None
    for d in range(n_data):
        gen = torch.Generator(x.device).manual_seed(dp.rank_seed(seed, d))
        l = -flow(dp.shard_batch(x, d, n_data), gen)[1].mean()
        g = torch.autograd.grad(l, [p for _, p in named])
        loss = loss + l.item() / n_data
        grads = [a / n_data for a in g] if grads is None else \
            [a + b / n_data for a, b in zip(grads, g)]
    return loss, dict(zip((n for n, _ in named), grads))


def mesh_flagship(dev, card):
    """One rank of the flagship ``if_glow_mnist`` (L=2 x K=16
    ``InvFlowNoPad``, coupling width 512, RQ spline; the registry's
    training config: Adam lr 1e-5, warmup, ExponentialLR, clamp 0.01) on
    a 2 x 2 (data, model) mesh of the world's 4 ranks: built from seed 0,
    data init on the whole batch of 100 with the shared seed, every
    coupling's ``w3``, ``b3``, ``logs3`` moved by ``MESH_PERTURB`` noise,
    the nets sharded (``coupling_tp_shardings``: each width of 512 split
    256 a rank); then ``MESH_STEPS`` steps, each on this data row's 50
    with its own noise: forward and backward (the model group's
    all-reduces in the nets), ``all_reduce_grads_``, ``apply_grads``.
    Rank 0 holds step 1's loss within ``MESH_LOSS_RTOL`` and the gathered
    gradients within ``GRAD_RTOL`` by norm against the one-process step
    (:func:`mesh_reference`). After every step the replicated weights and
    their Adam state must be bitwise equal on all ranks, each shard's in
    its data group. Counts each rank's chain launches (forward and
    backward, by variant, the counts set to 0 just before step 1), times
    step 2 (host clock, synced), and in step 3 the model group's
    all-reduces (3 for each sharded net: forward, the backward's recompute,
    backward) and the gradient collectives (each synced). Returns them."""
    import torch
    import torch.distributed as dist

    from inverse_flow_tpu_torch import parallel as dp
    from inverse_flow_tpu_torch.experiments.registry import get_experiment
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.parallel import mesh as tp
    from inverse_flow_tpu_torch.train.optim import apply_grads, make_optimizer

    rank = dist.get_rank()
    label = f"mesh rank {rank}"
    spec = get_experiment(MESH_NAME)
    cfg = spec.config.replace(seed=0)
    with warnings.catch_warnings(record=True):   # phase 5 printed it
        warnings.simplefilter("always")
        train = spec.load_data(batch_size=cfg.batch_size, seed=cfg.seed)[0]
    x = torch.as_tensor(train.data[:cfg.batch_size], device=dev)
    flow = spec.build_model(device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    mesh = dp.make_mesh_2d(*MESH_SHAPE)
    n_data = MESH_SHAPE[0]
    flow.data_init(x, torch.Generator(dev).manual_seed(cfg.seed))
    gen = torch.Generator(dev).manual_seed(1)
    with torch.no_grad():
        for n, p in flow.named_parameters():
            if n.rsplit(".", 1)[-1] in ("w3", "b3", "logs3"):
                p.add_(MESH_PERTURB * torch.randn(p.shape, generator=gen,
                                                  device=dev))
    ref = mesh_reference(flow, x, cfg.seed, n_data, torch) if rank == 0 \
        else None
    specs = dp.coupling_tp_shardings(flow, mesh)
    dp.apply_shardings(flow, specs, mesh)
    params = [p for p in flow.parameters() if p.requires_grad]
    shards = [p for p in params if dp.is_sharded(p)]
    n_full = sum(p.numel() for p in params) + sum(
        p.numel() * (mesh.shape["model"] - 1) for p in shards)
    optimizer, scheduler = make_optimizer(cfg, params, len(train))
    d = mesh.index("data")
    gen = torch.Generator(dev).manual_seed(dp.rank_seed(cfg.seed, d))
    xb = dp.shard_batch(x, d, n_data)
    timing = {}

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = -flow(xb, gen)[1].mean()
        loss.backward()
        loss = loss.detach().reshape(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp.all_reduce_grads_(params, mesh, extra=[loss])
        torch.cuda.synchronize()
        timing["grads_ms"] = 1e3 * (time.perf_counter() - t0)
        apply_grads(cfg, optimizer, scheduler, params,
                    model_group=mesh.model_group)
        return loss.item()

    bwd = [0]
    solve_bwd = fused_chain.FusedChainSolve.backward

    def counted_backward(ctx, gy):
        before = fused_chain.chain_phases.launches
        out = solve_bwd(ctx, gy)
        bwd[0] += fused_chain.chain_phases.launches - before
        return out

    reduce_sum, reduces = tp._all_reduce_sum, {"n": 0, "s": 0.0}

    def timed_reduce(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce_sum(t, group)
        torch.cuda.synchronize()
        reduces["n"] += 1
        reduces["s"] += time.perf_counter() - t0
        return out

    losses = []
    with mock.patch.object(fused_chain.FusedChainSolve, "backward",
                           staticmethod(counted_backward)):
        fused_chain.reset_launches()
        for i in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 2:
                with mock.patch.object(tp, "_all_reduce_sum", timed_reduce):
                    losses.append(step())
            else:
                losses.append(step())
            torch.cuda.synchronize()
            if i == 1:
                step_ms = 1e3 * (time.perf_counter() - t0)
            if i == 0:
                grads = {n: dp.gather_shard(p.grad, p.sharded_dim,
                                            mesh.model_group)
                         if dp.is_sharded(p) else p.grad
                         for n, p in flow.named_parameters()
                         if p.requires_grad}
            if not dp.mesh_replicas_equal(params, mesh, optimizer):
                fail(f"{label}: the replicas differ after step {i + 1}")
        launches = fused_chain.chain_phases.launches
    by = dict(fused_chain.chain_phases.launches_by_variant)
    cluster_only(f"{label} {MESH_STEPS} steps", launches)
    fwd_bwd = (launches - bwd[0], bwd[0])
    if fwd_bwd != tuple(n * MESH_STEPS for n in MESH_STEP_LAUNCHES):
        fail(f"{label}: {fwd_bwd[0]} + {fwd_bwd[1]} chain launches in "
             f"{MESH_STEPS} steps, expected {MESH_STEP_LAUNCHES} a step")
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: losses {losses}")
    # each sharded net (32 couplings, the SplitPrior's; a RepeatedBlock's
    # coupling runs K nets on its stacked weights) sums over its model
    # group in the forward, in the backward's recompute and in the backward
    nets = sum(m.w1.shape[0] if m.w1.ndim == 5 else 1
               for m in flow.modules()
               if getattr(m, "model_group", None) is not None)
    if reduces["n"] != 3 * nets:
        fail(f"{label}: {reduces['n']} model-group all-reduces in a step, "
             f"expected 3 for each of {nets} sharded nets")
    out = dict(losses=losses, batch=cfg.batch_size, launches=fwd_bwd, by=by,
               step_ms=step_ms, nets=nets, reduces=reduces["n"], reduce_ms=1e3 * reduces["s"],
               grads_ms=timing["grads_ms"], n_params=n_full,
               n_shard=sum(p.numel() for p in shards))
    if rank == 0:
        ref_loss, ref_grads = ref
        out["loss_rel"] = abs(losses[0] - ref_loss) / abs(ref_loss)
        out["grad_rel"] = max(
            ((g - ref_grads[n]).norm() / ref_grads[n].norm()).item()
            for n, g in grads.items() if ref_grads[n].norm() > 0)
        print(f"mesh: {MESH_NAME} at {MESH_SHAPE[0]} x {MESH_SHAPE[1]} "
              f"(data x model), {n_full} params, {out['n_shard']} of them "
              f"in this rank's shards; step-1 loss {losses[0]:.6f} against "
              f"the one-process step's {ref_loss:.6f} (same weights and "
              f"noise): rel err {out['loss_rel']:.3e} (tol "
              f"{MESH_LOSS_RTOL:.0e}); gathered gradients: max over "
              f"{len(grads)} tensors of |g - g_ref| / |g_ref| "
              f"{out['grad_rel']:.3e} (tol {GRAD_RTOL:.0e})", flush=True)
        if not (out["loss_rel"] <= MESH_LOSS_RTOL
                and out["grad_rel"] <= GRAD_RTOL):
            fail("the mesh's step-1 loss or gradients disagree with the "
                 "one-process step")
    return out


def mesh_summary(ranks, how, card):
    """Prints what :func:`mesh_flagship` returned on every rank (``how``:
    the backend and cards) and fails unless every rank holds rank 0's
    data-averaged losses; returns rank 0's (forward, backward) chain
    launches."""
    r0, size = ranks[0], len(ranks)
    for rank, r in enumerate(ranks):
        if any(abs(a - b) > 1e-6 * abs(b) for a, b in zip(r["losses"],
                                                          r0["losses"])):
            fail(f"mesh: rank {rank}'s losses {r['losses']} are not rank "
                 f"0's {r0['losses']}")
    fwd, bwd = r0["launches"]
    print(f"mesh: {MESH_STEPS} steps of {r0['batch']} "
          f"({r0['batch'] // MESH_SHAPE[0]} a data row): losses "
          f"{', '.join(f'{v:.4f}' for v in r0['losses'])}; replicated "
          f"weights and Adam state bitwise equal on all {size} ranks and "
          f"each shard's in its data group after every step; chain kernel "
          f"launches a step on each rank {fwd // MESH_STEPS} forward + "
          f"{bwd // MESH_STEPS} backward (by variant over the {MESH_STEPS} "
          f"steps: {r0['by']}) {card}", flush=True)
    print(f"mesh: step 2 {statistics.fmean(r['step_ms'] for r in ranks):.3f} "
          f"ms (host clock, synced; mean over the {size} ranks, rank 0 "
          f"{r0['step_ms']:.3f}); in step 3 the model groups' all-reduces "
          f"({r0['reduces']} a step on each rank: forward, recompute and "
          f"backward of {r0['nets']} nets) {r0['reduce_ms']:.3f} ms and the "
          f"gradient collectives {r0['grads_ms']:.3f} ms on rank 0, each "
          f"synced; {how} {card}", flush=True)
    return fwd, bwd


def mesh_rank(rank, size, card):
    """A spawned rank of phase 18: every rank on card 0
    (:func:`_dp_rank_start`), :func:`mesh_flagship`."""
    import torch

    return mesh_flagship(_dp_rank_start(torch, rank), card)


def phase_mesh(dev, gen, card, torch, _build):
    """Phase 18: the flagship on a 2 x 2 (data, model) mesh of 4 ranks
    spawned over gloo on the one card (NCCL refuses two ranks on one
    device; gloo all-reduces CUDA tensors through the host), 50 examples a
    data row: :func:`mesh_flagship` on every rank. First the chain kernel
    at the ranks' launch shapes, B=50, forward and backward, against its
    plain version and timed (:func:`rows_at`). Prints the launches a step
    by variant, ms/step and the all-reduce ms; returns the summary entries
    of the B=50 rows with rank 0's launches."""
    from inverse_flow_tpu_torch import parallel as dp

    t0 = time.perf_counter()
    b = BATCH // MESH_SHAPE[0]
    rows = rows_at(f"mesh B={b}", FLAGSHIP_SHAPES, ("TL",), b, 20, 4, gen,
                   dev, card, torch, _build)
    torch.cuda.empty_cache()
    out = os.path.join(HERE, "build", "mesh")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    size = MESH_SHAPE[0] * MESH_SHAPE[1]
    t1 = time.perf_counter()
    try:
        ranks = dp.spawn(mesh_rank, size, f"file://{out}/pg",
                         backend="gloo", args=(card,), timeout=DP_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"mesh: {e}")
    spawn_s = time.perf_counter() - t1
    fwd, bwd = mesh_summary(ranks, "gloo, 4 ranks on one card", card)
    print(f"mesh: world of {size} in {spawn_s:.1f} s; phase 18 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return [dict(rows[0], launches=fwd), dict(rows[1], launches=bwd)]


# ---------------------------------------------------------------------------
# Phase 17: the B-spline Glow-MNIST's sampling path
# ---------------------------------------------------------------------------

def phase_bspline_glow(dev, card, torch):
    """Phase 17: the flagship Glow-MNIST with ``activation="BSpline"``
    (``build_glow((1, 28, 28), step_kind="inv_conv_no_pad",
    activation="BSpline")``: L=2 x K=16, coupling width 512, a
    ``BSplineActivation`` of 5 bins and tail bound 20 in every step), seed
    0, B=100, with the flagship's training config. Data init and one
    ``Experiment.train_step`` (64 + 32 + 32 chain launches, all
    ``cluster``, no B-spline launch: the forward is plain torch), then
    ``Experiment.sample`` of 100 with both counts set to 0 just before and
    read just after: 32 B-spline-kernel launches, one per
    ``BSplineActivation``, and no chain launch (``InvFlowNoPad``'s inverse
    is its masked conv); finite samples of (100, 1, 28, 28), written to
    ``chiprun_out/samples_bspline/1.png``. Then ``Flow.sample`` on the
    same draws with the kernel and with the plain inverse (within
    ``SAMPLE_RTOL`` by norm before the floor), both timed in turns, and
    their launch calls; each block's round trip within ``BSPLINE_RTOL``
    by norm; and the kernel against its plain version at the path's two
    shapes, on the model's own coefficients (:func:`check_bspline_kernel`).
    Returns (the kernel's summary row, its launches in the sample)."""
    from inverse_flow_tpu_torch.data import mnist
    from inverse_flow_tpu_torch.layers import (BSplineActivation, Flow,
                                               RepeatedBlock)
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.ops import bspline as ob
    from inverse_flow_tpu_torch.ops import fused_chain
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    label, t0 = "bspline_glow", time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    flow = build_glow((1, 28, 28), step_kind="inv_conv_no_pad", num_blocks=2,
                      block_size=16, coupling_width=512, actnorm=True,
                      split_prior=True, activation="BSpline", n_bins=5,
                      tail_bound=20.0, generator=gen, device=dev)
    out = os.path.join(HERE, "chiprun_out")
    cfg = ExperimentConfig(
        name="2L-16K_IF_Glow_MNIST_BSpline", lr=1e-5, batch_size=BATCH,
        warmup_epochs=1, gamma=0.96170, scheduler_name="ExponentialLR",
        weight_clamp=0.01, modified_grad=True, add_recon_grad=True,
        sym_recon_grad=True, recon_loss_weight=0.0, n_samples=BATCH,
        log_timing=False, plot_recon=False,
        sample_dir=os.path.join(out, "samples_bspline"),
        metrics_path=os.path.join(out, "bspline_glow_metrics.jsonl"), seed=0)
    with warnings.catch_warnings(record=True):   # phase 5 printed it
        warnings.simplefilter("always")
        train, val, test = mnist.load_data(batch_size=BATCH, seed=cfg.seed)
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    first = train.data[:BATCH]

    fused_chain.reset_launches()
    ob.reset_bspline_launches()
    exp.maybe_data_init(first)
    loss = float(exp.train_step(torch.as_tensor(first, device=dev)))
    torch.cuda.synchronize()
    train_chain, train_bspline = (fused_chain.chain_phases.launches,
                                  ob.bspline_inverse.launches)
    cluster_only(f"{label} data init + train step", train_chain)
    fused_chain.reset_launches()
    ob.reset_bspline_launches()
    samples = exp.sample(1)
    torch.cuda.synchronize()
    bspline = ob.bspline_inverse.launches
    chain = fused_chain.chain_phases.launches
    n_params = sum(p.numel() for p in flow.parameters())
    print(f"{label}: {cfg.name} {n_params} params; data init + 1 train step "
          f"of {BATCH}: loss {loss:.4f}, {train_chain} chain launches (32 x "
          f"2 + 32 + 32), {train_bspline} B-spline launches; "
          f"Experiment.sample of {BATCH}: {bspline} B-spline-kernel "
          f"launches, {chain} chain launches; shape "
          f"{tuple(samples.shape)}, values {samples.min().item():.0f}.."
          f"{samples.max().item():.0f}, finite "
          f"{bool(torch.isfinite(samples).all())}; grid "
          f"chiprun_out/samples_bspline/1.png", flush=True)
    if not (math.isfinite(loss) and train_chain == 128
            and train_bspline == 0):
        fail(f"{label}: train step loss {loss}, {train_chain} chain and "
             f"{train_bspline} B-spline launches (expected 128 and 0)")
    if bspline != 32 or chain != 0 or samples.shape != (BATCH, 1, 28, 28) \
            or not torch.isfinite(samples).all():
        fail(f"{label}: Experiment.sample made {bspline} B-spline and "
             f"{chain} chain launches (expected 32 and 0) or its samples "
             f"are not finite")

    body = Flow(flow.base_distribution, flow.layers[1:])
    noise = sample_noise(flow, BATCH, gen, dev, torch)

    def plain_sample():
        with plain_bspline():
            return body.sample(BATCH, noise=noise)

    y, y_plain = body.sample(BATCH, noise=noise), plain_sample()
    rel = ((y - y_plain).norm() / y_plain.norm()).item()
    t = ab_ms({"kernel": lambda: body.sample(BATCH, noise=noise),
               "plain": plain_sample}, reps=1, rounds=4)
    calls = launch_calls(lambda: body.sample(BATCH, noise=noise), torch)
    plain_calls = launch_calls(plain_sample, torch)
    print(f"{label}: Flow.sample of {BATCH} on the same draws, kernel vs "
          f"plain inverse before the floor: |y - y_plain| / |y_plain| "
          f"{rel:.3e} (tol {SAMPLE_RTOL:.0e}); {t['kernel']:.3f} ms per "
          f"{BATCH} images (plain inverse {t['plain']:.3f}: "
          f"{t['plain'] / t['kernel']:.1f}x), {calls} kernel launch calls a "
          f"Flow.sample (plain {plain_calls}), CUDA events, medians of 4 "
          f"turns "
          f"{card}", flush=True)
    if not rel <= SAMPLE_RTOL:
        fail(f"{label}: samples through the kernel disagree with the plain "
             f"inverse")

    x = torch.as_tensor(first, device=dev)
    h = x + torch.rand(x.shape, generator=gen, device=dev)
    trips, rows = [], []
    with torch.inference_mode():
        for layer in flow.layers[1:]:
            if isinstance(layer, RepeatedBlock):
                back = layer.inverse(layer(h)[0])
                trips.append(((back - h).norm() / h.norm()).item())
                act = next(m for m in layer.steps
                           if isinstance(m, BSplineActivation))
                # the block's first step's coefficients, at its input shape
                coeffs = act.own_params()["coeffs"].detach()
                coeffs = coeffs[0] if coeffs.ndim == 2 else coeffs
                rows.append(check_bspline_kernel(
                    label, torch.rand(h.shape, generator=gen, device=dev),
                    coeffs.contiguous(), "shared", card, torch))
            h = layer(h)[0]
    print(f"{label}: each block's round trip |inverse(forward(x)) - x| / |x| "
          f"{', '.join(f'{r:.3e}' for r in trips)} (tol {BSPLINE_RTOL:.0e}); "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    if len(trips) != 2 or not max(trips) <= BSPLINE_RTOL:
        fail(f"{label}: a block does not round-trip: {trips}")
    row = {k: statistics.fmean(r[k] for r in rows)
           for k in ("ms", "first_design_ms", "plain_ms", "bound_ms",
                     "steps_mean")}
    row.update(bound_by=rows[0]["bound_by"], library_ms=None,
               steps_max=max(r["steps_max"] for r in rows),
               max_abs_err=max(r["max_abs_err"] for r in rows))
    return row, bspline


# phase 19: bench.py's configurations that no other phase builds, and the
# chain launches a step that each must make (a unit of four orders per
# flow step of the fused units, one solve per step elsewhere; each forward
# and backward), all on the cluster kernel
BENCH_NEW = {"glow_mnist_fused_units": 64, "glow_mnist_bf16_couplings": 64,
             "imagenet32_exact": 288, "timescale_s64": 4,
             "timescale_s128": 4}
# loss and gradients of imagenet32_exact against imagenet32 on the same
# weights: the same solves (exact, fused and auto outside the Jacobi
# window each run one fused_chain_solve a unit), so under deterministic
# algorithms (cuDNN's backward otherwise sums in no fixed order) they are
# bitwise equal
BENCH_EXACT_RTOL = 0.0
# kernel against plain chain through bf16 coupling nets: the two chains
# part by float32 round-off, which a net input near a bf16 rounding
# boundary turns into a bf16 unit (2^-8). scripts/bench_parity_floor.py
# read 2.373e-04 to 4.754e-04 over four noise draws on an H100 80GB HBM3,
# the same under deterministic algorithms, against a run-to-run floor of
# 1.5e-07 to 1.7e-07 (0 under deterministic algorithms); about twice the
# largest reading
BF16_GRAD_PARITY = 1e-3
BENCH_ROUNDS, BENCH_DRAWS = 2, 3
BENCH_TIMEOUT = 900


def bench_model(name, dev, torch):
    """Config ``name`` of ``bench.py`` at full width and depth through
    ``bench_configs.build``, weights from seed 0, with its data init on
    its batch ``smooth_images(batch, size)``, as the bench builds it;
    returns (flow, the batch, the generator)."""
    from inverse_flow_tpu_torch.data import synthetic
    from inverse_flow_tpu_torch.experiments import bench_configs

    gen = torch.Generator(dev).manual_seed(0)
    flow, shape, b = bench_configs.build(name, dev, gen)
    x = torch.as_tensor(synthetic.smooth_images(b, shape), device=dev)
    flow.data_init(x, gen)
    return flow, x, gen


def step_vs_plain(name, flow, x, gen, dev, card, torch, tol=GRAD_RTOL):
    """:func:`check_grads` on config ``name`` of ``BENCH_NEW``, the
    gradients within ``tol``; the kernel run's launches must be
    ``BENCH_NEW[name]``, all ``cluster``. Returns (forward, backward)
    launches."""
    _, (_, fwd, by), _ = check_grads(f"bench: {name}", flow, x, gen, dev,
                                     torch, tol)
    n = sum(by.values())
    print(f"bench: {name}: chain launches {fwd} forward + {n - fwd} "
          f"backward, by variant {by} {card}", flush=True)
    if n != BENCH_NEW[name] or by["cluster"] != n:
        fail(f"{name}: expected {BENCH_NEW[name]} chain launches a step, "
             f"all cluster, got {by}")
    return fwd, n - fwd


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's and the scatters' backward in a fixed summation order."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def exact_vs_unit(dev, card, torch):
    """``imagenet32_exact`` against ``imagenet32`` with the exact model's
    weights (:func:`check_grads` with a reference, under deterministic
    algorithms): loss and gradients on the same batch and noise within
    ``BENCH_EXACT_RTOL``, 288 ``cluster`` launches a step each."""
    from inverse_flow_tpu_torch.experiments import bench_configs

    flow, x, gen = bench_model("imagenet32_exact", dev, torch)
    unit = bench_configs.build("imagenet32", dev,
                               torch.Generator(dev).manual_seed(1))[0]
    unit.load_state_dict(flow.state_dict())
    with deterministic(torch):
        _, ours, ref = check_grads("bench: imagenet32_exact vs imagenet32",
                                   flow, x, gen, dev, torch,
                                   BENCH_EXACT_RTOL, reference=unit)
    by, by_u = ours[2], ref[2]
    print(f"bench: imagenet32_exact vs imagenet32: chain launches by variant "
          f"{by} and {by_u} {card}", flush=True)
    want = BENCH_NEW["imagenet32_exact"]
    if by != by_u or by["cluster"] != want or sum(by.values()) != want:
        fail(f"imagenet32_exact: expected {want} cluster launches a step, "
             f"got {by} (imagenet32 {by_u})")


def phase_bench(dev, gen, card, torch, _build):
    """Phase 19: ``python -m inverse_flow_tpu_torch.bench`` and the five
    configurations of ``bench.py`` that no other phase builds, each at
    full width and depth through ``bench_configs.build`` with the bench's
    data init. ``glow_mnist_fused_units``: the N=4 unit at the flagship's
    shapes (row E0), forward and backward, against its plain version and
    timed (:func:`rows_at`), and a step against the plain chain
    (:func:`step_vs_plain`: 64 launches); ``glow_mnist_bf16_couplings``: a
    step against the plain chain (``BF16_GRAD_PARITY``) and against the
    same step through the kernel (the run-to-run floor), and the bf16
    value check against float32 nets; ``imagenet32_exact`` against
    ``imagenet32``
    (:func:`exact_vs_unit`); ``timescale_s64`` and ``_s128``: a step
    against the plain chain (4 launches). Then ``bench_config`` on each
    with 2 rounds of 1 step (its row: no error, every chain launch on the
    cluster kernel, the step's chain calls those of the check), and the
    bench with no argument in a subprocess: its last line the flagship's,
    ms > 0 on this card. Returns the forward and backward summary entries
    of the fused units' launch."""
    from inverse_flow_tpu_torch import bench

    t0 = lap = time.perf_counter()

    def part(what):
        nonlocal lap
        now = time.perf_counter()
        print(f"bench: {what} in {now - lap:.1f} s", flush=True)
        lap = now
        torch.cuda.empty_cache()

    rows = rows_at("fused_units", FLAGSHIP_SHAPES, UNIT, BATCH, 50, 4, gen,
                   dev, card, torch, _build)
    flow, x, g = bench_model("glow_mnist_fused_units", dev, torch)
    launches = step_vs_plain("glow_mnist_fused_units", flow, x, g, dev,
                             card, torch)
    del flow
    part("glow_mnist_fused_units")
    name = "glow_mnist_bf16_couplings"
    flow, x, g = bench_model(name, dev, torch)
    step_vs_plain(name, flow, x, g, dev, card, torch, BF16_GRAD_PARITY)
    # the run-to-run floor beside it: the same step through the kernel
    # twice
    check_grads(f"bench: {name} run to run", flow, x, g, dev, torch,
                BF16_GRAD_PARITY, reference=flow)
    bf16_value_check(flow, "glow_mnist", x, "after data init", card, torch)
    del flow
    part(name)
    exact_vs_unit(dev, card, torch)
    part("imagenet32_exact")
    for name in ("timescale_s64", "timescale_s128"):
        flow, x, g = bench_model(name, dev, torch)
        step_vs_plain(name, flow, x, g, dev, card, torch)
        del flow
    part("timescale_s64 and timescale_s128")

    for name in BENCH_NEW:
        row = bench.bench_config(name, dev, rounds=BENCH_ROUNDS, steps=1,
                                 draws=BENCH_DRAWS)
        by = row.get("chain_launches_by_variant")
        print(f"bench: {name}: {json.dumps(row)}", flush=True)
        if row.get("error") or not row["train_step_ms"] > 0 \
                or by["cluster"] != BENCH_NEW[name] \
                or sum(by.values()) != BENCH_NEW[name] \
                or row["chain_calls_per_step"] != BENCH_NEW[name] \
                or not row["train_step_gflops"] > row["chain_gflops"] > 0:
            fail(f"bench_config({name!r}) gave {row}")
    part("bench_config on the five")

    run = subprocess.run([sys.executable, "-m",
                          "inverse_flow_tpu_torch.bench"], cwd=HERE,
                         capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    last = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    print(f"bench: python -m inverse_flow_tpu_torch.bench: exit "
          f"{run.returncode}, last line {last}", flush=True)
    try:
        line = json.loads(last)
    except json.JSONDecodeError:
        line = {}
    kind = torch.cuda.get_device_name(0)
    if run.returncode != 0 or line.get("metric") != "glow_mnist_train_step" \
            or line.get("unit") != "ms/batch" \
            or not (line.get("value") or 0) > 0 \
            or line.get("extra", {}).get("device") != kind:
        fail(f"the bench's flagship line is not right: {run.stderr[-2000:]}")
    part("the bench's flagship line")
    print(f"bench: phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)
    return [dict(rows[0], launches=launches[0]),
            dict(rows[1], launches=launches[1])]


def print_build(dev, _build, fused_chain):
    """Phase 2's report: each kernel's registers, shared memory and spills
    as ``ptxas -v`` gave them; and, at every solve shape of the main paths
    at batch 100 and 1, the cluster kernel's shared memory and how many of
    its clusters can be resident at once against the ceil(B / 8) a launch
    needs (one wave when they all fit)."""
    for line in _build.build_log("chain_solve").splitlines():
        if "Compiling entry" in line:
            name = ("cluster_wide" if "cluster_wide_kernel" in line else
                    "cluster" if "cluster_kernel" in line else "streaming")
        elif "registers" in line or "spill" in line:
            print(f"build: {name} kernel: {line.strip()}", flush=True)
    for line in _build.build_log("slr_inverse").splitlines():
        if "Compiling entry" in line:
            name = ("slr_inverse fixed" if "fixed_kernel" in line else
                    "smooth_tanh_inverse lane_exit" if "lane_exit" in line
                    else "smooth_tanh_inverse step_exit" if "TanhStep" in line
                    else "slr_inverse early_exit")
        elif "registers" in line or "spill" in line:
            print(f"build: {name} kernel: {line.strip()}", flush=True)
    for line in _build.build_log("bspline_inverse").splitlines():
        if "Compiling entry" in line:
            name = next(k for k in ("newton_shared", "newton_channels",
                                    "newton_last", "inverse_first")
                        if f"bspline_{k}_kernel" in line)
        elif "registers" in line or "spill" in line:
            print(f"build: bspline_{name} kernel: {line.strip()}",
                  flush=True)
    loops = newton_loop_mufu(_build.build("slr_inverse"))
    want = {f"{kernel}<{step}>": n
            for (kernel, step), n in NEWTON_KERNELS.items()}
    for key, (mufu, calls) in loops.items():
        print(f"build: {key}: {mufu} MUFU instructions and {calls} calls in "
              f"its Newton loop's SASS (the bound takes {want[key]})",
              flush=True)
    if loops != {key: (n, 0) for key, n in want.items()}:
        fail(f"the Newton loops' SASS holds {loops} MUFU instructions and "
             f"calls, not the {want} MUFU and no calls that the bounds of "
             f"rows H and H2 take")
    for rcw, kcw in ((392, 112), (336, 112), (384, 384)):
        for b in (BATCH, 1):
            active = _build.cluster_occupancy(dev.index, b, rcw, kcw)
            need = -(-b // fused_chain.CLUSTER_ROWS)
            print(f"build: cluster kernel at RCW={rcw} KCW={kcw} B={b}: "
                  f"{fused_chain.cluster_smem_bytes(rcw, kcw)} bytes of "
                  f"shared memory a CTA; {active} clusters of "
                  f"{fused_chain.CLUSTER_SIZE} resident at once, {need} "
                  f"needed: {'one wave' if need <= active else 'waves'}",
                  flush=True)
    for name, (chw, kernel, b) in list(WIDE_SHAPES.items()) + [
            (f"edge {e[0]}", (e[0], (3, 3), e[1])) for e in WIDE_EDGES]:
        c, h, w = chw
        r, _ = fused_chain.choose_block_rows_fused(h, c * w, kernel[0])
        rcw, kcw = r * c * w, min((kernel[0] - 1) * c * w, r * c * w)
        plan = _build.cluster_wide_plan(dev.index, b, rcw, kcw)
        print(f"build: cluster_wide kernel at {name} RCW={rcw} KCW={kcw} "
              f"B={b}: {plan['groups']} row groups of "
              f"{fused_chain.CLUSTER_ROWS} a cluster, "
              f"{'resident slices' if plan['stages'] == 0 else str(plan['stages']) + ' chunk buffers of ' + str(plan['chunk']) + ' k-columns'}, "
              f"{plan['smem']} bytes of shared memory a CTA; "
              f"{plan['active']} clusters of {fused_chain.WIDE_CLUSTER_SIZE} "
              f"resident at once, {plan['needed']} needed: "
              f"{'one wave' if plan['needed'] <= plan['active'] else 'waves'}",
              flush=True)


def plain_sample(flow, n, gen):
    """``flow.sample`` with every solve on the kernel's plain version."""
    from inverse_flow_tpu_torch.ops import fused_chain

    with plain_chain(fused_chain):
        return flow.sample(n, gen)


# the coupling nets that phase 20 checks and times, each at its
# configuration's batch: (what, B, Cin, H, W, width N, C). The flagship's
# two at the benchmark's batch, then every distinct float32 net of
# bench.py's configurations (glow_mnist and glow_mnist_fused_units;
# imagenet32 and imagenet32_exact), if_glow_cifar's, FastFlow's (and the
# width-512 CIFAR Glows'), the flagship's level 1 on a 2-way model mesh's
# slice of the width at a data row's batch, and the zoo's SplitPriorFC
NET_CASES = [
    ("glow_mnist l1 B8192", 8192, 2, 14, 14, 512, 4),
    ("glow_mnist l2 B8192", 8192, 4, 7, 7, 512, 8),
    ("glow_mnist l1", 100, 2, 14, 14, 512, 4),
    ("glow_mnist l2", 100, 4, 7, 7, 512, 8),
    ("imagenet32 l1", 100, 6, 16, 16, 128, 12),
    ("imagenet32 l2", 100, 12, 8, 8, 128, 24),
    ("imagenet32 l3", 100, 24, 4, 4, 128, 48),
    ("if_glow_cifar l1", 140, 6, 16, 16, 128, 12),
    ("if_glow_cifar l2", 140, 12, 8, 8, 128, 24),
    ("fastflow l1", 100, 6, 16, 16, 512, 12),
    ("fastflow l2", 100, 12, 8, 8, 512, 24),
    ("fastflow l3", 100, 24, 4, 4, 512, 48),
    ("mesh slice", 50, 2, 14, 14, 256, 4),
    ("SplitPriorFC", 100, 6, 1, 1, 16, 12),
]


def net_flops(cin, n, c, pixels):
    """(forward, backward) FLOPs of one coupling net's conv3x3 -> ReLU ->
    conv1x1 on ``pixels`` pixels: 2 (K + C) N and 2 (3K + 2C) N a pixel
    (K = 9 Cin; the backward recomputes the hidden activation, then dh,
    dW2, dW1 and the patch gradient)."""
    k = 9 * cin
    return 2 * (k + c) * n * pixels, 2 * (3 * k + 2 * c) * n * pixels


def phase_coupling_net(dev, card, torch):
    """Phase 20: ``csrc/coupling_net.cu``'s registers, and at each of
    :data:`NET_CASES` the plan, the forward and the backward (its launch
    and the reduction's) against the float64 composition (output and dx1
    to 2e-5 of the largest entry, dW1 and dW2 to 1e-4: float32 sums of
    K + N terms and of up to 1.6M pixels), two backward runs bitwise
    equal, and the times of the kernels, of the cuDNN composition (the
    op's plain version on the card, forward; its autograd backward on a
    kept graph) and the bound. Returns the rows."""
    from inverse_flow_tpu_torch.ops import _build
    from inverse_flow_tpu_torch.ops import coupling_net as tcn

    name = None
    for line in _build.build_log("coupling_net").splitlines():
        if "Compiling entry" in line:
            # the instance's template arguments, from the mangled name
            kind = next(k for k in ("fwd", "bwd", "reduce")
                        if f"coupling_net_{k}_kernel" in line)
            args = re.findall(r"L[ib](\d+)E", line.split("_kernel", 1)[1])
            name = f"{kind}<{','.join(args)}>" if args else kind
        elif "registers" in line or "spill" in line:
            print(f"build: coupling_net {name}: {line.strip()}", flush=True)
    gen = torch.Generator(dev).manual_seed(0)
    rows = []
    for what, b, cin, h, w, n, c in NET_CASES:
        tag = f"{what} ({b},{cin},{h},{w}) -> {n} -> {c}"
        # x1 and w1 on the grids of 1/8 and 1/64: the hidden
        # pre-activations are exact in float32, so the ReLU masks the same
        # entries as in the float64 reference
        x1 = (8 * torch.randn(b, cin, h, w, generator=gen,
                              device=dev)).round().clamp(-31, 31) / 8
        w1 = (64 * (2 * torch.rand(n, cin, 3, 3, generator=gen, device=dev)
                    - 1) / math.sqrt(9 * cin)).round() / 64
        w2 = (2 * torch.rand(c, n, 1, 1, generator=gen, device=dev) - 1) \
            / math.sqrt(n)
        g = torch.randn(b, c, h, w, generator=gen, device=dev)
        plan = tcn.plan(x1, w1, w2)
        print(f"coupling_net: {tag} plan {plan}", flush=True)
        tcn.reset_launches()
        with torch.no_grad():
            out = tcn.coupling_net_hidden(x1, w1, w2)
        grads = tcn._backward(x1, w1, w2, g, True)
        again = tcn._backward(x1, w1, w2, g, True)
        torch.cuda.synchronize()
        launches = dict(tcn.coupling_net_hidden.launches_by_kind)
        if launches != {"forward": plan["fwd_launches"], "backward": 2,
                        "reduce": 2}:
            fail(f"coupling_net {tag}: launches {launches}")
        if not all(torch.equal(a, r) for a, r in zip(grads, again)):
            fail(f"coupling_net {tag}: two backward runs differ")
        ref = [t.double().requires_grad_(True) for t in (x1, w1, w2)]
        ref_out = tcn.coupling_net_reference(*ref)
        ref_grads = torch.autograd.grad(ref_out, ref, g.double())
        errs = {}
        for key, a, r in zip(("out", "dx1", "dw1", "dw2"),
                             (out, *grads), (ref_out, *ref_grads)):
            errs[key] = ((a.double() - r).abs().max()
                         / r.abs().max()).item()
        del ref, ref_out, ref_grads, again
        torch.cuda.empty_cache()
        print(f"coupling_net: {tag} error / max|ref|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)
        if max(errs["out"], errs["dx1"]) > 2e-5 or max(
                errs["dw1"], errs["dw2"]) > 1e-4:
            fail(f"coupling_net {tag}: error {errs}")
        # the cuDNN composition: forward; backward on a kept graph
        lx = [t.clone().requires_grad_(True) for t in (x1, w1, w2)]
        lib_out = tcn.coupling_net_reference(*lx)

        def lib_fwd():
            with torch.no_grad():
                tcn.coupling_net_reference(x1, w1, w2)

        def lib_bwd():
            torch.autograd.grad(lib_out, lx, g, retain_graph=True)

        def ker_fwd():
            with torch.no_grad():
                tcn._forward(x1, w1, w2)

        def ker_bwd():
            tcn._backward(x1, w1, w2, g, True)

        big = b * h * w > 100_000
        t = ab_ms({"kernel_fwd": ker_fwd, "library_fwd": lib_fwd},
                  10 if big else 50, 4, ahead=20)
        t.update(ab_ms({"kernel_bwd": ker_bwd, "library_bwd": lib_bwd},
                       5 if big else 50, 4, ahead=60))
        del lx, lib_out
        torch.cuda.empty_cache()
        fl_f, fl_b = net_flops(cin, n, c, b * h * w)
        row = dict(shape=tag, **{k: round(v, 4) for k, v in t.items()},
                   bound_fwd=round(fl_f / PEAK_FP32_FLOPS * 1e3, 4),
                   bound_bwd=round(fl_b / PEAK_FP32_FLOPS * 1e3, 4),
                   errors=errs, plan=plan)
        for d in ("fwd", "bwd"):
            row[f"share_{d}"] = round(100 * row[f"bound_{d}"]
                                      / row[f"kernel_{d}"], 2)
            row[f"speedup_{d}"] = round(row[f"library_{d}"]
                                        / row[f"kernel_{d}"], 2)
        print(f"coupling_net: {tag} ms: kernel fwd {row['kernel_fwd']} "
              f"bwd {row['kernel_bwd']}; cuDNN composition (plain) fwd "
              f"{row['library_fwd']} bwd {row['library_bwd']}; bound fwd "
              f"{row['bound_fwd']} bwd {row['bound_bwd']}; share of bound "
              f"{row['share_fwd']}% / {row['share_bwd']}%; speedup "
              f"{row['speedup_fwd']}x / {row['speedup_bwd']}x {card}",
              flush=True)
        rows.append(row)
    return rows


def main():
    import torch

    t_start = time.perf_counter()

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run "
             "needs a CUDA card")
    sys.path.insert(0, HERE)
    import inverse_flow_tpu_torch
    if os.path.dirname(os.path.abspath(inverse_flow_tpu_torch.__file__)) \
            != os.path.join(HERE, "inverse_flow_tpu_torch"):
        fail("inverse_flow_tpu_torch is not the checkout's own package")
    from inverse_flow_tpu_torch.data import mnist
    from inverse_flow_tpu_torch.layers import Flow
    from inverse_flow_tpu_torch.models.glow import build_glow
    from inverse_flow_tpu_torch.ops import _build, fused_chain
    from inverse_flow_tpu_torch.train.config import ExperimentConfig
    from inverse_flow_tpu_torch.train.experiment import Experiment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)

    lap = [time.perf_counter()]

    def phase_done(n):
        now = time.perf_counter()
        print(f"smoke: phase {n} in {now - lap[0]:.1f} s", flush=True)
        lap[0] = now

    phase_done(1)

    # ---- 2. build: one nvcc for each source, all started together -------
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(_build.build, ("chain_solve", "slr_inverse",
                                            "bspline_inverse",
                                            "coupling_net")))
    _build.chain_solve_lib(dev.index)
    _build.slr_inverse_lib()
    _build.bspline_inverse_lib()
    _build.coupling_net_lib()
    print(f"build: {', '.join(os.path.relpath(p, HERE) for p in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_build(dev, _build, fused_chain)
    phase_done(2)

    # ---- 3. kernel vs plain --------------------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    on = dict(gen=gen, dev=dev, torch=torch)
    max_err = check_forward(KERNEL_CASES, "kernel", **on)
    fwd_times = time_rows(FLAGSHIP_SHAPES, ("TL",), False, 200, 6, "kernel",
                          card=card, **on)

    # ---- 4. backward vs plain ------------------------------------------
    phase_done(3)
    bwd_err = check_backward(KERNEL_CASES, "backward", **on)
    # the backward's launch of a TL solve: BR, transposed kernel
    bwd_times = time_rows(FLAGSHIP_SHAPES, ("TL",), True, 200, 6,
                          "backward", card=card, **on)
    phase_done(4)

    # ---- 5. the slice ---------------------------------------------------
    flow = build_glow((1, 28, 28), step_kind="inv_conv_no_pad", num_blocks=2,
                      block_size=16, coupling_width=512, actnorm=True,
                      split_prior=True, activation="Spline", n_bins=5,
                      tail_bound=20.0, generator=gen, device=dev)
    cfg = ExperimentConfig(name="2L-16K_IF_Glow_MNIST", batch_size=BATCH,
                           max_eval_ex=EVAL_EXAMPLES, seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        train, val, test = mnist.load_data(batch_size=cfg.batch_size,
                                           seed=cfg.seed)
    for w in caught:
        print(f"data: {w.message}", flush=True)
    exp = Experiment(flow, train, val, test, cfg, device=dev)
    n_params = sum(p.numel() for p in flow.parameters())
    n_eval, seen = 0, 0
    for xb in val:
        n_eval, seen = n_eval + 1, seen + xb.shape[0]
        if seen >= EVAL_EXAMPLES:
            break
    first = next(iter(val))

    fused_chain.reset_launches()
    exp.maybe_data_init(first)
    logpx = exp.eval_epoch(val)
    torch.cuda.synchronize()
    launches = fused_chain.chain_phases.launches
    cluster_only("slice data init + eval", launches)
    bpd = exp.to_bpd(logpx)
    # data init runs every block twice, as the JAX Flow.data_init does:
    # its step-by-step init pass, then the block's forward
    passes = 2 + n_eval
    print(f"slice: {cfg.name} {n_params} params, data init + eval over "
          f"{n_eval} batches of {BATCH}: log p(x) {logpx:.4f}, BPD "
          f"{bpd:.4f}", flush=True)
    print(f"slice: chain kernel launches {launches} for {passes} passes "
          f"through the blocks (2 for data init, 1 per eval batch; 32 "
          f"per pass)", flush=True)
    if not math.isfinite(bpd):
        fail("BPD is not finite")
    if launches != 32 * passes:
        fail(f"expected {32 * passes} chain kernel launches, got {launches}")

    body = Flow(flow.base_distribution, flow.layers[1:])
    x = torch.as_tensor(first, device=dev)
    u = torch.rand(x.shape, generator=gen, device=dev)
    with torch.inference_mode():
        z, lp = body(x + u)
        with plain_chain(fused_chain):
            z_ref, lp_ref = body(x + u)
    rel = ((lp - lp_ref).abs() / lp_ref.abs()).max().item()
    print(f"slice: log p(x) kernel vs plain chain on one batch, same noise: "
          f"max rel err {rel:.3e} (tol {LOGPX_RTOL:.0e}); z {tuple(z.shape)} "
          f"max abs diff {(z - z_ref).abs().max().item():.3e}", flush=True)
    if z.shape != (BATCH, 8, 7, 7) or not torch.isfinite(lp).all():
        fail("flow output has the wrong shape or is not finite")
    if not rel <= LOGPX_RTOL:
        fail("log p(x) through the kernel disagrees with the plain chain")

    def eval_batch():
        return flow.cheap_log_prob(x, exp.generator)

    def eval_batch_plain():
        with plain_chain(fused_chain):
            return flow.cheap_log_prob(x, exp.generator)

    with torch.inference_mode():
        t = ab_ms({"kernel": eval_batch, "plain": eval_batch_plain},
                  reps=3, rounds=8)
    print(f"slice: eval {t['kernel']:.3f} ms/batch of {BATCH} (plain chain "
          f"{t['plain']:.3f} ms/batch) {card}", flush=True)
    phase_done(5)

    # ---- 6. profile -----------------------------------------------------
    profile_eval(flow, x, exp.generator, card, torch)
    draw_nets = flagship_sample(flow, gen, card, torch)
    phase_done(6)

    # ---- 7. train -------------------------------------------------------
    fwd_launches, bwd_launches, step_nets = phase_train(dev, card, torch)
    phase_done(7)

    # ---- 8. imagenet32 --------------------------------------------------
    unit_rows, unit_exp = phase_imagenet32(dev, gen, card, torch)
    phase_done(8)

    # ---- 9. ff ----------------------------------------------------------
    grouped_row = phase_ff(dev, gen, card, torch)
    phase_done(9)

    # ---- 10. SLR inverse, imagenet32 sampling, real data, resume, CLI ---
    slr_row = check_slr(gen, dev, card, torch)
    slr_launches = sample_imagenet32(unit_exp, gen, card, torch)
    del unit_exp
    torch.cuda.empty_cache()
    digits_rows = phase_real_data(dev, card, torch)
    phase_resume(dev, digits_rows, card, torch)
    phase_cli(card)
    phase_done(10)

    # ---- 11. the wide cluster kernel, W1's model ------------------------
    wide_rows = phase_wide(dev, gen, card, torch)
    phase_done(11)

    # ---- 12. the comparison baselines -----------------------------------
    emerging_row, cnn_row = phase_baselines(dev, gen, card, torch, _build)
    phase_done(12)

    # ---- 13. the Fig. 4 timescaling sweeps, solver='auto', memory_speed -
    phase_timescaling(dev, card, torch)
    phase_done(13)

    # ---- 14. the layer zoo: ConvExp, FastFlow, SmoothTanh, B-spline -----
    fastflow_rows, grouped_invflow_row, tanh_row = phase_zoo(dev, gen, card,
                                                             torch)
    phase_done(14)

    # ---- 15. the CIFAR-10 family, the bf16 couplings at B=100-4096 -----
    cifar_bf16 = phase_cifar_bf16(dev, gen, card, torch, _build)
    phase_done(15)

    # ---- 16. data parallelism and the native library -------------------
    dp_rows = phase_data_parallel(dev, gen, card, torch, _build)
    phase_done(16)

    # ---- 17. the B-spline Glow-MNIST's sampling path -------------------
    bspline_row, bspline_launches = phase_bspline_glow(dev, card, torch)
    phase_done(17)

    # ---- 18. the flagship on the (data, model) mesh ---------------------
    mesh_rows = phase_mesh(dev, gen, card, torch, _build)
    phase_done(18)

    # ---- 19. the bench entry point, bench.py's five new configurations --
    bench_rows = phase_bench(dev, gen, card, torch, _build)
    phase_done(19)

    # ---- 20. the coupling nets' kernels ---------------------------------
    net_rows = phase_coupling_net(dev, card, torch)
    phase_done(20)

    print(f"smoke: phases 1-20 in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    cnn_by_variant = cnn_row.pop("launches_by_variant")

    def entry(name, launches, variant="cluster", **row):
        # every main-path launch went to the cluster kernel (cluster_only),
        # every launch of W1's model to the wide one (phase_tall)
        return dict(name=name, route="cuda", variant=variant,
                    source="inverse_flow_tpu_torch/csrc/chain_solve.cu",
                    replaces="inverse_flow_tpu/ops/fused_chain.py:209",
                    launches=launches, launches_by_variant=dict(
                        dict.fromkeys(fused_chain.VARIANTS, 0),
                        **{variant: launches}), **row)

    # times and bounds: means over each path's solve shapes, which it
    # launches equally often (ms: the cluster kernel, streaming_ms: the
    # streaming kernel forced); launches: each path's train run (phases 7
    # and 8, the counts set to 0 just before), and for the grouped launch
    # one Flow.sample of ff_glow_mnist (phase 9)
    print(json.dumps({"kernels": [
        entry("chain_phases", fwd_launches, max_abs_err=max_err,
              **fwd_times),
        entry("chain_phases:backward", bwd_launches, max_abs_err=bwd_err,
              **bwd_times),
        entry("chain_phases:unit", **unit_rows[0]),
        entry("chain_phases:unit_backward", **unit_rows[1]),
        entry("chain_phases:grouped", **grouped_row),
        # W1 and W2 (means), the wide cluster kernel; launches: one loss
        # and backward of W1's model (phase 11, the counts set to 0 just
        # before)
        entry("chain_phases:wide", variant="cluster_wide", **wide_rows[0]),
        entry("chain_phases:wide_backward", variant="cluster_wide",
              **wide_rows[1]),
        # phase 12: the Emerging AR convs' inverse (a non-unit diagonal) at
        # its two shapes, launches: one emerging_cnn_mnist Flow.sample of
        # 100; exact_cnn_mnist's B=1000 forward at (1, 28, 28), launches:
        # its one train step, 9 forward and 9 backward (a third of them on
        # the wide kernel, at (16, 7, 7)); the counts set to 0 just before
        entry("chain_phases:emerging", **emerging_row),
        dict(entry("chain_phases:cnn_b1000", **cnn_row),
             launches_by_variant=cnn_by_variant),
        # launches: one imagenet32 Flow.sample of 100 (phase 10, the
        # counts set to 0 just before)
        dict(name="slr_inverse", route="cuda",
             source="inverse_flow_tpu_torch/csrc/slr_inverse.cu",
             replaces="inverse_flow_tpu/layers/activations.py:38",
             launches=slr_launches, **slr_row),
        # phase 14: FastFlow's N=1 TL launch at its three shapes, launches:
        # its 3 train steps; the grouped InvFlow, launches: its forward and
        # backward; SmoothTanh.inverse at imagenet32's three shapes
        entry("chain_phases:fastflow", **fastflow_rows[0]),
        entry("chain_phases:fastflow_backward", **fastflow_rows[1]),
        entry("chain_phases:grouped_invflow", **grouped_invflow_row),
        # (ms: newton_lane_exit_kernel, step_exit_ms: the first design
        # forced)
        dict(name="smooth_tanh_inverse", route="cuda",
             source="inverse_flow_tpu_torch/csrc/slr_inverse.cu",
             replaces="inverse_flow_tpu/layers/activations.py:38",
             **tanh_row),
        # phase 17: the kernel at the B-spline Glow-MNIST's two shapes (means;
        # first_design_ms: bspline_inverse_first_kernel forced), launches:
        # its Experiment.sample of 100 (the counts set to 0 just before)
        dict(name="bspline_inverse", route="cuda",
             source="inverse_flow_tpu_torch/csrc/bspline_inverse.cu",
             replaces="inverse_flow_tpu/layers/splines.py:227",
             launches=bspline_launches, **bspline_row)] + [
        # phase 15: if_glow_cifar's N=1 TL launch at B=140, launches: its 3
        # train steps; ff_glow_cifar's grouped launch at CIFAR's shapes,
        # launches: one Flow.sample of 100; the four-order launch at B=1024
        # and 4096, launches: the 2 train steps of imagenet32_b1024 and
        # imagenet32_b4096 (bf16 couplings)
        entry(name, **row) for name, row in cifar_bf16.items()] + [
        # phase 16: if_multiGPU_imagenet32's N=1 TL launch at B=250 (rows
        # P, Pb), launches: its 3 train steps at a world of one over NCCL
        # (in its spawned process, the counts set to 0 just before)
        entry("chain_phases:dp_b250", **dp_rows[0]),
        entry("chain_phases:dp_b250_backward", **dp_rows[1]),
        # phase 18: the flagship's N=1 TL launch at a data row's B=50,
        # launches: rank 0's 3 steps on the 2 x 2 mesh (in its spawned
        # process, the counts set to 0 just before)
        entry("chain_phases:mesh_b50", **mesh_rows[0]),
        entry("chain_phases:mesh_b50_backward", **mesh_rows[1]),
        # phase 19: glow_mnist_fused_units' N=4 launch at the flagship's
        # shapes (row E0), launches: its step through the kernel (the
        # counts set to 0 just before)
        entry("chain_phases:fused_units", **bench_rows[0]),
        entry("chain_phases:fused_units_backward", **bench_rows[1]),
        # phase 20: the coupling nets' kernels (ms and bound_ms: each
        # case's, NET_CASES), launches: the flagship's train epoch (phase
        # 7, a step's; the counts set to 0 just before) and its draw of
        # 100 (phase 6)
        dict(name="coupling_net", route="cuda",
             source="inverse_flow_tpu_torch/csrc/coupling_net.cu",
             replaces="inverse_flow_tpu/layers/coupling.py:95",
             launches=sum(step_nets.values()), launches_by_kind=step_nets,
             draw_launches_by_kind=draw_nets, ms={
                 r["shape"]: [r["kernel_fwd"], r["kernel_bwd"]]
                 for r in net_rows},
             bound_ms={r["shape"]: [r["bound_fwd"], r["bound_bwd"]]
                       for r in net_rows},
             library_ms={r["shape"]: [r["library_fwd"], r["library_bwd"]]
                         for r in net_rows})]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
