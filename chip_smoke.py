#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GS2D, GS3D and Burgers Stage-1 serving and
training paths, their fallback routes, ensemble training and spatially
decomposed training, once on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py [--sass-against CSRC_DIR]

It builds the port's CUDA kernels from the checkout's sources with nvcc,
holds them against the committed golden models, against their plain PyTorch
versions and against f64 autograd, serves GS2D, GS3D and Burgers requests
through ``build_serving_fn``, trains GS2D (100 x 100), GS3D (48^3) and
Burgers Stage-1 (100 x 100, 5x5 Pi cell) through ``run_experiment`` at full
width, drives the fallback routes (``bptt="fused"`` of the 1x1 and 3D cells,
``bptt="two_phase"``, the MXU switches off) through the same entry points,
trains GS2D and Burgers ensembles through ``run_ensemble``, runs the
domain decomposition (``sharded_rollout_nd``, ``run_experiment(mesh=...)``)
on meshes that repeat cuda:0, and times the kernels.  Phases, one JSON line each with the seconds
since start:

  env          card name and power limit (nvidia-smi), torch and CUDA versions
  build        nvcc builds of percnn_tpu_torch/ops/kernels/csrc/*.cu, in parallel,
               ptxas's registers and spills, the one-launch kernels'
               plans at GS2D's, GS3D's and Burgers' shapes (cluster size,
               co-resident grid, threads, bytes) beside what the card holds
               of them (the ensemble's at M = 4 and 8, and the clusters of
               16 and of 8 CTAs the card holds; the streaming sweeps'
               adj_plan at GS2D's shape and adj_b_plan at Burgers' for
               M = 1 (the single model's k x k sweep), 2, 4 and 8,
               adj1_b_plan at GS2D's for M = 4 and 8), the k = 5 FFMA
               kernels' instruction mix
               (cuobjdump: FFMA and shared-memory loads), and the registers
               and spills of the streaming sweeps' one-launch kernels and of
               rows 1 (k = 5), 5 and 7, the instances the main paths run;
               row 11's k x k plan (rollout_b_plan at Burgers' shape for
               M = 1, 2, 4, 8) and row 9's (adj3d_plan at GS3D's) beside what
               the card holds, the registers and spills of their kernels
               (rollout2d_ffma_persistent_kernel<5, 3, true>,
               adj3d_persistent_kernel<3, 2>) and of their siblings; row
               14's one-launch plan (blocks_plan for four 50 x 50 blocks of
               the GS2D and Burgers cells) beside what the card holds, the
               registers and spills of step2d_blocks_kernel and
               rollout2d_blocks_kernel at k = 1 and 5; with --sass-against
               CSRC_DIR, every kernel of the libraries that share their code
               (cell2d, sharded_step2d and batched2d, which include
               cell2d_step.cuh; cell2d_ffma, backward3d, backward2d, adj2d)
               against a build of CSRC_DIR's sources (the parent commit's
               csrc/), instruction for instruction
  golden       ISG and kernel rollout against tests/golden/pt_gs2d.npz
  golden3d     the 3D ISG and rollout3d_persistent_kernel (one launch, 6
               steps) against tests/golden/pt_gs3d.npz
  golden_burgers  the Burgers ISG and rollout2d_kxk_persistent_kernel (one
               launch, 8 steps) against tests/golden/pt_burgers_s1.npz
  kernels      the forward kernels against their plain versions, 100 x 100,
               T = 200: rollout2d_cluster_kernel (the frames rollout's route
               at that shape) also against rollout2d_kernel, the per-step
               route, to the bit; its final-state mode (the final state's
               route) against the frames' last frame (to the bit) and
               final2d_kernel; both through the entry points on a field of
               17 rows (strips of 2 and 3) and one past the cluster's
               capacity (449 x 449, the per-step routes by the rule),
               launches and steps counted
  grads        pg2d_persistent_kernel (the sweep's route at 100 x 100)
               against its plain version and against pg2d_kernel, the
               per-step route (T = 200, golden cell, data-loss cotangent),
               on a field past its capacity (195 x 195, pg2d_kernel by the
               rule), and the fused gradients against f64 autograd
  kernels3d    at 48^3: rollout3d_persistent_kernel (rollout3d_plan's
               route) and rollout3d_kernel (the per-step route) against
               their plain version (frames and final state, T = 300) and
               each other (to the bit), pg3d_persistent_kernel (pg3d_plan's
               route) and pg3d_kernel against their plain sweep and each
               other (T = 50, golden cell, a standard-normal cotangent), both
               per-step routes through the entry points past the plans'
               capacity (92^3 forward, 52^3 sweep) and the forward on 60^3
               (more cells a block than threads), launches and steps
               counted, and the fused 3D gradients against f64 autograd
               (random-init cell, random target, 12 steps)
  kernels_kxk  rollout2d_kxk_persistent_kernel (kxk_plan's route at
               100 x 100) and rollout2d_kxk_kernel (the per-step route)
               against their plain version and each other at 100 x 100,
               C = 16, k = 5, T = 200, golden Burgers cell, Burgers IC; both
               routes through the entry point on 17 x 9 and past the plan's
               capacity (1453 x 1453), launches and steps counted; its
               final-state mode over the 1200-step serving horizon from the
               ISG's answer to a request against plain and the frames' last
               frame (to the bit), and through the entry point on 17 x 9
               and 1453 x 1453 (final2d_kernel<5>), counted
  grads_kxk    adj2d_kxk_persistent_kernel and adj2d_kxk_kernel against
               their plain sweep and each other (the same, a standard-normal
               cotangent), on 17 x 9 and past the plan's capacity (846 x
               846), counted; the fused k x k gradients (counted) and those
               of remat (eager autograd) against f64 autograd (random-init
               cell, random target, 12 steps, 100 x 100)
  kernels_fallback  the MXU-off route of the 5x5 cell on the golden Burgers
               cell: rollout2d_ffma_persistent_kernel (ffma_plan's route at
               100 x 100) and rollout2d_kernel<5> (the per-step route) against
               their plain version and each other (T = 200, Burgers IC),
               adj2d_ys_persistent_kernel (ys_plan's) and adj2d_ys_kernel
               against their plain sweep and each other (a standard-normal
               cotangent); the final state over 1200 steps through the entry
               point with the MXU switch off (one launch, the FFMA kernel's
               final-state mode) against plain and the frames route's last
               frame (to the bit), final2d_kernel<5> against plain; each
               route through the entry points on 17 x 9 and past the plans
               (1407 x 1407 forward and final state, 149 x 149 sweep), exact
               launches and steps; both routes of row 4 at k = 5 (T = 200):
               adj2d_batched_ffma_persistent_kernel on a one-member batch
               (adj_b_plan's route at M = 1, backward2d's wrapper) and
               adj2d_kernel's pair against plain and each other, the
               wrapper's outputs against the ensemble wrapper's at M = 1 to
               the bit, through the entry point on 17 x 9 and past the plan
               (769 x 769), counted; both
               routes of row 4 at k = 1 (T = 200, golden GS2D cell, data-loss
               cotangent): adj2d_persistent_kernel (adj_plan's route) and
               adj2d_kernel (the per-step route) against plain and each
               other, its g0 against pg2d_persistent_kernel's on the same
               inputs to the bit, both through the entry point on 17 x 9
               and past the plan (449 x 449), counted; both routes of row 9
               (48^3, T = 50, golden GS3D cell, a standard-normal
               cotangent): adj3d_persistent_kernel (adj3d_plan's route) and
               adj3d_kernel against plain and each other, its g0 against
               pg3d_persistent_kernel's on the same inputs to the bit, the
               entry point at 48^3 and past the plan (52^3), counted
  grads_fallback  the gradients of bptt="fused" (GS2D: one launch of
               adj2d_persistent_kernel; GS3D: one launch of
               adj3d_persistent_kernel; Burgers with the MXU switches
               off, and with YS_PATH_ENABLED off too: one launch of
               adj2d_batched_ffma_persistent_kernel on a one-member batch) and
               of bptt="two_phase" (the three cells) against f64 autograd on
               the referee setup, each route's launches counted
  serve        one uncounted warm-up request of each kind, then three frames
               requests and one final-state request, 2500 steps, one launch
               a request, with the kernels' launch and step counters set to
               0 just before
  train        run_experiment(GS2D_RECON): truth, ISG pretrain, 10 iterations
               at each of T = 200, 400, 800, a 2500-step evaluation, with the
               launch counters set to 0 just before
  train_parity train() on the card against train() on the CPU (plain
               versions), 32 x 32, T = 40, 5 iterations
  train3d      run_experiment(GS3D_RECON): the 1000-frame truth, ISG pretrain,
               10 iterations at each of T = 150, 300 with the watchdog family
               and the stability probe at each stage's end, candidate
               selection and the 1000-step evaluation, with the launch
               counters set to 0 just before
  train3d_parity  as train_parity for GS3D: 16^3, T = 20, 5 iterations,
               watchdog on
  serve3d      one uncounted warm-up request of each kind, then one frames
               request and one final-state request, 1000 steps, on the
               trained GS3D model, with the launch counter set to 0 just before
  serve_burgers  one uncounted warm-up request of each kind, then three
               frames requests and one final-state request, 1200 steps, one
               launch a request, on the golden Burgers model, with the
               launch counters set to 0 just before
  train_burgers  run_experiment(BURGERS_STAGE1): the 1200-frame truth (kept
               in a temp cache for train_fallback), ISG pretrain, 10
               iterations at T = 200 with best-val selection, the 1200-step
               evaluation, with the launch counters set to 0 just before
  train_burgers_parity  as train_parity for Burgers: 32 x 32, T = 20,
               5 iterations
  train_fallback  run_experiment(BURGERS_STAGE1) with the MXU switches off
               (10 iterations at T = 200, the cached truth, the evaluation:
               one launch a rollout and a sweep, ms per iteration),
               and build_loss_fn(bptt="fused") + train for 5 iterations of
               GS2D at T = 800 and of GS3D at T = 300 and 3 of Burgers with
               YS_PATH_ENABLED off, every launch counted
  step_breakdown  one training iteration at each T after a warm-up: host
               and device ms of the whole, the same split into ISG and
               forward, losses, backward (and pg2d_kernel in it), Adam, and
               the device's idle share from a torch.profiler trace
  step_breakdown3d  the same for GS3D at T = 150, 300
               (pg3d_persistent_kernel); each step_breakdown* also counts
               the launches and steps of one iteration
  step_breakdown_kxk  the same for Burgers at T = 200
               (adj2d_kxk_persistent_kernel)
  kernels_batched  the ensemble's kernels against their plain versions at
               M = 4 and M = 8, 100 x 100, T = 200 (the golden GS2D cell
               and seeded perturbations of it, a standard-normal
               cotangent): the forward by both routes,
               rollout2d_cluster_kernel with a member axis (rollout_b_plan's
               route: 16-CTA clusters at M = 4, 8-CTA ones at M = 8) and
               rollout2d_batched_kernel, to the bit of each other and of the
               single cluster kernel on each member; the fused sweep by
               both routes, pg2d_batched_persistent_kernel (pg_b_plan's)
               and pg2d_batched_kernel, g0 and each member's gradient sums
               leaf by leaf against plain, each other and the single
               model's sweep; the streaming sweep by both routes,
               adj2d_batched_persistent_kernel (adj1_b_plan's) and
               adj2d_batched_kernel, against plain and each other, each
               member's g0 and g_ins against adj2d_persistent_kernel's to
               the bit (M = 4 and 8); on the golden Burgers cell both routes
               of the k = 5 forward (M = 2 and 4),
               rollout2d_ffma_persistent_kernel with the member axis
               (rollout_b_plan's) and rollout2d_batched_kernel, against
               plain and each other, each member against the single model's
               rollout2d_ffma_persistent_kernel to the bit, and both routes
               of its streaming sweep (M = 2),
               adj2d_batched_ffma_persistent_kernel (adj_b_plan's) and
               adj2d_batched_kernel, against plain and each other; the k = 5
               forward's entry point on 17 x 9 (M = 3) and past its plan
               (M = 2 at 1057 x 1057), counted; then both GS2D entry points
               on 17 x 9 (the
               one-launch routes) and past the plans (449 x 449, and M = 8
               at 156 x 156 for the sweep), and the streaming sweep's on
               17 x 9 (M = 3, k = 1 and 5) and past its plans (M = 4 at
               225 x 225 for k = 1, M = 2 at 571 x 571 for k = 5), counted
  grads_batched  the gradients of bptt="batched" and "batched_pg" against
               f64 autograd on the referee setup (random-init cells, random
               targets, 12 steps, full width, M = 4; "batched" by one launch
               of adj2d_batched_persistent_kernel), and "batched" of the
               5x5 cell (M = 2: one launch of
               rollout2d_ffma_persistent_kernel[batched] and one of
               adj2d_batched_ffma_persistent_kernel), each route's launches
               and steps counted
  kernels_sharded  step2d_haloed_kernel against its plain version on the
               haloed blocks of a 2 x 2 mesh of cuda:0 (four 50 x 50 blocks
               of 100 x 100, and a 6 x 10 block) for the golden GS2D (k = 1)
               and Burgers (k = 5) cells, and its entry point
               (step_haloed_2d) on the four blocks, counted; at the same
               shapes (four 50 x 50 and four 6 x 10 blocks)
               step2d_blocks_kernel against its plain version with all
               blocks one device's state and with every block its own
               device (the strip path), the two to the bit, and
               rollout2d_blocks_kernel against its plain version (20 steps)
               and its first step against step2d_blocks_kernel's to the bit;
               then sharded_rollout_nd (impl="pallas", T = 200, no
               gradient: one launch a call, counted) against the
               single-device frames rollout, against impl="jnp" and, to the
               bit, against one launch a step in both groupings, and on a
               field past blocks_plan (400 x 400: one launch a step)
  grads_sharded  the gradients of sharded_rollout_nd, impl="pallas" (one
               launch of step2d_blocks_kernel a step, 48 in all) and "jnp",
               against f64 autograd on the referee setup (k = 1 and k = 5,
               12 steps, full width), launches counted
  sharded3d    GS3D's sharded_rollout_nd on a (2, 2, 2) mesh of cuda:0 at
               48^3, T = 50, against rollout3d_persistent_kernel
  train_ensemble  run_ensemble(GS2D_RECON, 4) in "batched_pg", "batched" and
               "auto": ISG pretrain, 2 iterations at each of T = 200, 400,
               800, each member's 2500-step evaluation, on the train phase's
               cached truth; then run_ensemble(BURGERS_STAGE1, 2, "batched"),
               2 iterations, on train_burgers' cached truth; every launch
               counted
  train_mesh   run_experiment(GS2D_RECON, mesh=<2 x 2 of cuda:0>) and the
               same run without a mesh on the train phase's cached truth:
               ISG pretrain, one iteration at each of T = 200, 400, 800 (a
               decomposed iteration is paced by the host: PERF.md), the
               2500-step evaluation; the losses held to each other at rtol
               1e-4, each run's ms per iteration, launches counted
  train_ensemble_parity  run_ensemble on the card against the CPU (plain
               versions), 32 x 32, T = 20, M = 2, 3 iterations, both batched
               modes
  step_breakdown_ensemble  one ensemble iteration at T = 800, M = 4, for
               "batched_pg" (one launch of each batched kernel) and for
               "auto" (the per-member loop): host and device ms, enqueue,
               launches and steps, and the device's idle share from a
               torch.profiler trace
  times        each kernel's and its plain version's ms at the main path's
               shapes, beside the card's bound for the same work (rows 1
               (k = 1 and 5), 2 (k = 1, and k = 5 by both MXU routes), 3, 4
               (k = 1 and 5), 5, 6, 7, 8, 9, 10, 11 (k = 1 and 5), 12 (k = 1
               and 5) and 13 also by their per-step routes, in turns in the
               same call, rows 11, 13 and 12 at k = 1 at M = 4 and 8, rows 11
               and 12 at k = 5 at M = 2 and 4, row 9 also built for two
               blocks an SM (__launch_bounds__(512, 2), 264 blocks), row 11 at M = 8 by
               both cluster sizes; rows 2 at k = 5, 3 and 6 with the bound
               in 3xTF32 and all in FFMA),
               one grid barrier of an empty cooperative kernel alone, one
               bptt="two_phase" GS2D backward at T = 800, and a T = 200
               decomposed rollout (four 50 x 50 blocks) by row 14's three
               routes in turns (rollout2d_blocks_kernel, step2d_blocks_kernel
               a step, PR 10's step_haloed_2d a block and step), each with
               its profiler trace

Then a ``{"kernels": [...]}`` line (38 entries: the 14 ported TPU kernels,
row 1 at k = 5 by rollout2d_ffma_persistent_kernel, row 2 by its three
one-launch routes, rollout2d_cluster_kernel[final],
rollout2d_kxk_persistent_kernel[final] and
rollout2d_ffma_persistent_kernel[final], row 4 at k = 1 by
adj2d_persistent_kernel and at k = 5 by
adj2d_batched_ffma_persistent_kernel[M=1], row
11 at k = 1 by rollout2d_cluster_kernel[batched], row 12 at k = 1 by
adj2d_batched_persistent_kernel and at k = 5 by
adj2d_batched_ffma_persistent_kernel, row 11 at k = 5 by
rollout2d_ffma_persistent_kernel[batched], row 9 by
adj3d_persistent_kernel, row 14 by rollout2d_blocks_kernel and
step2d_blocks_kernel (step2d_haloed_kernel, PR 10's, its entry for the
one-block step), and the per-step routes of rows 1 at k = 5
(rollout2d_kernel[k=5]), 2 (final2d_kernel, final2d_kernel[k=5]), 3, 4 at
k = 1 and 5, 5, 6, 8, 9, 10, 11 at k = 1 and 5, 12 at k = 1 and 5 and 13
(rollout2d_kxk_kernel, adj2d_kernel, adj2d_kernel[k=5], adj2d_ys_kernel,
adj2d_kxk_kernel, rollout3d_kernel, adj3d_kernel, pg3d_kernel,
rollout2d_batched_kernel, rollout2d_batched_kernel[k=5],
adj2d_batched_kernel, adj2d_batched_kernel[k=5], pg2d_batched_kernel) listed
apart), the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check ends the run with a
non-zero exit and no last line; so does a machine without a CUDA device, or
a directory without the percnn_tpu_torch package beside this script.  The
script imports neither jax nor percnn_tpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "pt_gs2d.npz")
GOLDEN3D = os.path.join(ROOT, "tests", "golden", "pt_gs3d.npz")
GOLDEN_BURGERS = os.path.join(ROOT, "tests", "golden", "pt_burgers_s1.npz")

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bandwidth, float32 outside the tensor cores (an FMA counts as 2) and
# dense TF32 on them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12   # dense, on the tensor cores

SERVE_STEPS = 2500
CHECK_STEPS = 200
SEEDS = (66, 67, 68)
TRAIN_ITERS = 30          # 10 at each of T = 200, 400, 800
ISG_PRETRAIN_ITERS = 200
TIME_BACKWARD_STEPS = 800
BREAKDOWN_REPS = 5
CHECK3D_STEPS = 300       # both routes of row 8 against their plain version
PG3D_CHECK_STEPS = 50     # both routes of row 10 against their plain sweep
TRAIN3D_ITERS = 20        # 10 at each of T = 150, 300
TIME_BACKWARD3D_STEPS = 300
CHECK_KXK_STEPS = 200     # the k x k kernels against their plain versions
TRAIN_BURGERS_ITERS = 10  # of BURGERS_STAGE1's 10000, at T = 200
FALLBACK_ITERS = 5        # GS2D at T = 800 and GS3D at T = 300 through bptt="fused"
FALLBACK_YS_OFF_ITERS = 3  # Burgers at T = 200, the k x k sweep in one launch
ENS_MEMBERS = 4           # the ensemble's M, the CLI's default
ENS_KXK_MEMBERS = 2       # the 5x5 cell's ensemble (kernels_batched, grads_batched)
ENS_ITERS = 6             # 2 at each of T = 200, 400, 800
ENS_BURGERS_ITERS = 2     # at T = 200
MESH_ITERS = 3            # train_mesh: 1 at each of T = 200, 400, 800
SHARDED3D_STEPS = 50      # the GS3D decomposed rollout on a (2, 2, 2) mesh
GRID_BARRIERS = 1000      # grid.sync()s of the empty cooperative kernel timed in times


class CheckFailed(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(name: str, **fields) -> None:
    emit({"phase": name, "elapsed_s": round(time.perf_counter() - T0, 3), **fields})


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def allclose(got, want, rtol: float, atol: float) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def flops_per_cell_step(cfg) -> int:
    """Flops of one Euler step at one cell, counted from the kernel: per
    channel 12 for the Laplacian and 4 for the update; per equation
    hidden * (5 * n_branches + 1) + 1 for the Pi block."""
    return 2 * (12 + 4 + cfg.hidden * (5 * cfg.n_branches + 1) + 1)


def flops_per_cell_step_3d() -> int:
    """Flops of one expanded-cubic Euler step (rollout3d_kernel and
    rollout3d_persistent_kernel) at one
    cell: 5 adds for each of the four neighbour sums (s1, s2 of u and v), 7
    multiplies for the shared monomials, and per equation 11 multiplies and
    12 adds for the update."""
    return 4 * 5 + 7 + 2 * (11 + 12)


def pg_flops_per_cell_step(cfg) -> int:
    """Flops that one reverse step of pg2d_kernel or pg3d_kernel needs at one
    cell: per equation and hidden channel, 4 per branch activation, the
    fewest multiplies giving the full product and the nb leave-one-out
    products (3 nb - 5 by prefix and suffix products: 4 at nb = 3), 2 for
    the w_out plane and, per branch, 1 for zz, 4 for the dw planes, 1 for
    the db plane and 4 for the Jacobian (w_i * w_out depends on the
    parameters only, so it is not counted per cell); plus 2 adds a stencil
    point forming g_in (9 points in 2D, 13 in 3D), four Laplacians (12
    flops in 2D, 16 in 3D), 6 for the diffusion and b_out planes and 8 for
    the update."""
    nb, per_branch = cfg.n_branches, 1 + 4 + 1 + 4
    pi = 2 * cfg.hidden * (4 * nb + max(3 * nb - 5, 0) + 2 + nb * per_branch)
    points = 4 * cfg.ndim + 1
    return pi + 2 * points + 4 * (4 * cfg.ndim + 4) + 6 + 8


def flops_per_cell_step_kxk(cfg) -> int:
    """Flops of one k x k Euler step at one cell that the function needs:
    per activation row k*k*2 multiplies and as many adds (the bias
    included), per equation and hidden channel nb - 1 multiplies for the
    product and 2 for the aggregation, 1 per equation for b_out, and per
    channel 12 for the Laplacian and 4 for the update."""
    taps, rows = cfg.kernel_size ** 2 * 2, 2 * cfg.n_branches * cfg.hidden
    return 2 * taps * rows + 2 * cfg.hidden * (cfg.n_branches - 1 + 2) + 2 + 2 * (12 + 4)


def adj_flops_per_cell_step_kxk(cfg) -> int:
    """Flops of one reverse step of adj2d_kxk_kernel at one cell that the
    function needs: the activations (2 k*k*2 a row), and the same again for
    zw; per equation and hidden channel the leave-one-out products (3 nb - 6
    multiplies by prefix and suffix products, none for nb <= 2), 1 for
    w_out g and nb for the z; k*k adds a channel for the gather, 2 for g_in,
    two Laplacians (12 each) and 8 for the update."""
    k, nb = cfg.kernel_size, cfg.n_branches
    taps, rows = k * k * 2, 2 * nb * cfg.hidden
    z = 2 * cfg.hidden * (max(3 * nb - 6, 0) + 1 + nb)
    return 2 * taps * rows + z + 2 * taps * rows + 2 * k * k + 2 + 24 + 8


def adj_flops_per_cell_step_1x1(cfg) -> int:
    """Flops that one reverse step of adj2d_kernel at k = 1 or adj3d_kernel
    needs at one cell: pg_flops_per_cell_step without the accumulators (per
    equation and hidden channel, 4 per branch activation, 3 nb - 5 for the
    leave-one-out products and, per branch, 1 for zz and 4 for the
    Jacobian; 2 adds a stencil point forming g_in, two Laplacians of g_in
    and 8 for the update)."""
    nb = cfg.n_branches
    pi = 2 * cfg.hidden * (4 * nb + max(3 * nb - 5, 0) + nb * 5)
    points = 4 * cfg.ndim + 1
    return pi + 2 * points + 2 * (4 * cfg.ndim + 4) + 8


def kxk_product_flops_per_cell_step(cfg) -> int:
    """Flops of one branch-matrix product at one cell and step, the part of
    flops_per_cell_step_kxk (once) and adj_flops_per_cell_step_kxk (twice: y
    and zw) that the one-launch kernels run on the tensor cores."""
    return 2 * cfg.kernel_size ** 2 * 2 * 2 * cfg.n_branches * cfg.hidden


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_3xtf32_ms(bytes_moved: float, mma_flops: float, other_flops: float) -> tuple:
    """bound_ms with mma_flops run on the tensor cores in 3xTF32 (three
    passes at the dense TF32 peak) and other_flops at the f32 peak."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = 3 * mma_flops / PEAK_TF32_FLOP_PER_S + other_flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _cuobjdump():
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return tool if os.path.exists(tool) else None


def sass_functions(lib_path) -> dict | None:
    """The library's machine code (cuobjdump -sass) by kernel, each keyed
    by its name and integer template arguments (a `false` member flag
    dropped: the single model's instance keeps its key) and holding its
    instructions' text without addresses or encodings; None where the
    toolkit has no cuobjdump."""
    import re

    tool = _cuobjdump()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    fns = {}
    for chunk in out.split("Function : ")[1:]:
        mangled = chunk.split(None, 1)[0]
        key = mangled
        for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
            start = m.start() + len(m.group(1))
            name = mangled[start:start + int(m.group(1))]
            if name.endswith("_kernel") and name.isidentifier():
                args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[start + len(name):])
                targs = re.findall(r"L([ib])(\d+)E", args.group(1)) if args else []
                key = name + "<" + ", ".join(
                    {"b": lambda v: "true" if v == "1" else "", "i": str}[t](v)
                    for t, v in targs if not (t == "b" and v == "0")) + ">"
                break
        fns[key] = [" ".join(i.split()) for i in
                    re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", chunk)]
    return fns


def sass_mix(lib_path, names) -> dict | None:
    """Per kernel of `names` (its k = 5, 3-branch instance, and the
    member-axis instance as name[batched]) in the library's machine code:
    the instructions, the FFMAs and the shared-memory loads (all, and
    16-byte ones) as they stand in the code, a loop's body once; None where
    the toolkit has no cuobjdump."""
    import re

    fns = sass_functions(lib_path)
    if fns is None:
        return None
    mix = {}
    for key, ins in fns.items():
        for n in names:
            label = {f"{n}<5, 3>": n, f"{n}<5, 3, true>": f"{n}[batched]"}.get(key)
            if label is None:
                continue
            ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0] for i in ins if i]
            mix[label] = {"instructions": len(ops),
                          "FFMA": sum(o.startswith("FFMA") for o in ops),
                          "LDS": sum(o.startswith("LDS") for o in ops),
                          "LDS.128": sum(o.startswith("LDS.128") for o in ops)}
    return mix


def _without_registers(ins):
    """Instructions with register and predicate numbers and reuse flags
    taken out: what is left when only the register assignment differs."""
    import re

    return [re.sub(r"\bU?P\d\b", "P", re.sub(r"\bU?R\d+\b", "R", i.replace(".reuse", "")))
            for i in ins]


def sass_against(parent_csrc, libs, out_dir) -> tuple[dict, dict]:
    """Build `libs` from the sources in parent_csrc (another checkout's
    csrc/, say the parent commit's) into out_dir with the port's nvcc
    flags, in parallel, and compare every kernel of each with this
    checkout's build: per library the kernels the same instruction for
    instruction, those the same but for the register assignment, those
    that differ otherwise, those missing here and those new here; and the
    paths of the libraries built."""
    from percnn_tpu_torch.ops.kernels import _build

    def build(name):
        path = os.path.join(out_dir, f"lib{name}.so")
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", path,
                        os.path.join(parent_csrc, f"{name}.cu")], check=True,
                       capture_output=True)
        return path

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        paths = dict(zip(libs, pool.map(build, libs)))
    result = {}
    for name in libs:
        new = sass_functions(_build.BUILD_DIR / f"lib{name}.so")
        old = sass_functions(paths[name])
        common = [k for k in old if k in new]
        result[name] = {
            "same": sorted(k for k in common if new[k] == old[k]),
            "registers_only": sorted(k for k in common if new[k] != old[k] and
                                     _without_registers(new[k]) == _without_registers(old[k])),
            "differ": sorted(k for k in common
                             if _without_registers(new[k]) != _without_registers(old[k])),
            "missing": sorted(k for k in old if k not in new),
            "new": sorted(k for k in new if k not in old)}
    return result, paths


def ptxas_of(lines, name, targs) -> dict | None:
    """Registers and spill-store bytes of kernel `name` at the template
    arguments targs (ints, or bools for a flag), from ptxas's report of its
    library (the entry line, then its stack and spill line, then its
    registers)."""
    import re

    key = f"{len(name)}{name}I" + "".join(
        f"Lb{int(a)}E" if isinstance(a, bool) else f"Li{a}E" for a in targs) + "E"
    for i, line in enumerate(lines[:-2]):
        if "entry function" in line and key in line:
            spill = re.search(r"(\d+) bytes spill stores", lines[i + 1])
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            if spill and regs:
                return {"registers": int(regs.group(1)), "spill_store_bytes": int(spill.group(1))}
    return None


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean device ms of fn() over reps calls, by CUDA events, after one
    warm-up (none for a plain version, which builds nothing and has run in
    the checks before)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_busy(torch, fn) -> dict:
    """fn() once under torch.profiler, ended by a synchronise.  From its
    trace: the window (first host op to the last event's end), the device's
    busy ms (the union of its kernels, copies and sets), the idle share of
    the window and the kernel ms of the port's kernels.  The profiler's own
    host cost lengthens the window, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, reach = 0.0, -float("inf")
    for a, b in device:
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
              - min(float(e["ts"]) for e in events))
    kernels = {name: [float(e["dur"]) for e in events
                      if e.get("cat") == "kernel" and name in e.get("name", "")]
               for name in ("rollout2d_cluster_kernel", "pg2d_persistent_kernel",
                            "rollout2d_kernel", "pg2d_kernel", "rollout3d_kernel",
                            "pg3d_kernel", "rollout3d_persistent_kernel",
                            "pg3d_persistent_kernel", "rollout2d_kxk_kernel",
                            "adj2d_kxk_act_kernel",
                            "adj2d_kxk_gather_kernel", "rollout2d_kxk_persistent_kernel",
                            "adj2d_kxk_persistent_kernel", "rollout2d_batched_kernel",
                            "adj2d_batched_kernel", "pg2d_batched_kernel",
                            "adj2d_persistent_kernel", "adj2d_batched_ffma_persistent_kernel",
                            "adj2d_batched_persistent_kernel", "step2d_haloed_kernel",
                            "step2d_blocks_kernel", "rollout2d_blocks_kernel")}
    return {"window_ms": 1e-3 * window, "device_busy_ms": 1e-3 * busy,
            "device_idle_share": 1.0 - busy / window if device else None,
            "device_events": len(device),
            "kernel_ms": {name: 1e-3 * sum(d) for name, d in kernels.items()},
            "kernel_us_per_launch": {name: sum(d) / len(d) if d else None
                                     for name, d in kernels.items()}}


def main() -> int:
    import numpy as np
    import torch

    args = sys.argv[1:]
    sass_parent = None
    if args[:1] == ["--sass-against"] and len(args) == 2:
        sass_parent = os.path.abspath(args[1])
    elif args:
        print("usage: python3 chip_smoke.py [--sass-against CSRC_DIR]", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import percnn_tpu_torch
    except ImportError:
        percnn_tpu_torch = None
    if percnn_tpu_torch is None or not os.path.abspath(
            percnn_tpu_torch.__file__).startswith(os.path.join(ROOT, "")):
        print("chip_smoke: the percnn_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2

    from percnn_tpu_torch.bridge import params_from_numpy, params_to_numpy, unflatten_dotted
    from percnn_tpu_torch.core.cell import init_pi_cell, pi_cell_step
    from percnn_tpu_torch.core.checkpoint import flatten_with_paths, load_checkpoint_tree
    from percnn_tpu_torch.core.isg import isg_apply
    from percnn_tpu_torch.core.losses import data_loss, subsample
    from percnn_tpu_torch.core.rollout import rollout, rollout_tp
    from percnn_tpu_torch.core.train import train
    from percnn_tpu_torch.data.noise import add_noise
    from percnn_tpu_torch.data.simulate import default_ic, simulate
    from percnn_tpu_torch.experiments import ensemble, runner
    from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1, GS2D_RECON, GS3D_RECON
    from percnn_tpu_torch.ops.kernels import (_build, backward2d, backward3d, batched2d, cell2d,
                                              cell3d, sharded_step2d)
    from percnn_tpu_torch.parallel import halo_exchange, make_mesh, sharded, sharded_rollout_nd
    from percnn_tpu_torch.parallel.halo import object_grid
    from percnn_tpu_torch.serving import build_serving_fn

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        [shutil.which("nvidia-smi") or "nvidia-smi",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
          torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0])
    # The serving path runs in full float32 (it sets these flags itself);
    # the checks below that call the ISG directly do the same.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def build(name):
        t = time.perf_counter()
        _build.load_library(name)
        return time.perf_counter() - t

    sources = ("cell2d", "backward2d", "cell3d", "backward3d", "cell2d_kxk", "backward2d_kxk",
               "adj2d", "batched2d", "sharded_step2d", "cell2d_ffma")
    def build_adj3d_two_blocks():
        """backward3d.cu with adj3d_persistent_kernel's __launch_bounds__
        asking for two blocks an SM (at most 64 registers a thread), built
        into a temp dir for row 9's timing at 2 n_sm blocks in times:
        (dir, library path, ptxas's lines of that kernel)."""
        tmp = tempfile.mkdtemp(prefix="chip_smoke_adj3d_")
        shutil.copytree(str(_build.CSRC), tmp, dirs_exist_ok=True)
        path = os.path.join(tmp, "backward3d.cu")
        with open(path) as f:
            src = f.read()
        key = "__launch_bounds__(kPersistentThreads)\n    adj3d_persistent_kernel("
        check(key in src, "backward3d.cu: adj3d_persistent_kernel's launch bounds not found")
        with open(path, "w") as f:
            f.write(src.replace(key, key.replace("Threads)", "Threads, 2)")))
        lib = os.path.join(tmp, "libbackward3d_two_blocks.so")
        proc = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib, path],
                              capture_output=True, text=True)
        check(proc.returncode == 0, f"nvcc failed on the two-blocks build: {proc.stderr}")
        lines = [line.split(":", 1)[-1].strip() for line in proc.stderr.splitlines()
                 if "entry function" in line or "registers" in line or "spill" in line]
        return tmp, lib, ptxas_of(lines, "adj3d_persistent_kernel", (3, 2))

    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        two_blocks = pool.submit(build_adj3d_two_blocks)
        build_s = dict(zip(sources, pool.map(build, sources)))
        adj3d_two_dir, adj3d_two_lib, adj3d_two_ptxas = two_blocks.result()
    n_gs2d = GS2D_RECON.grid
    one_launch = {
        "rollout2d_cluster_kernel": {
            **cell2d.rollout_plan(n_gs2d, n_gs2d, GS2D_RECON.cell),
            "clusters_the_card_holds": cell2d.cluster_occupancy(GS2D_RECON.cell, n_gs2d,
                                                                n_gs2d)},
        "pg2d_persistent_kernel": {
            **backward2d.pg_plan(n_gs2d, n_gs2d, GS2D_RECON.cell, backward2d._sm_count(dev)),
            "blocks_an_sm_holds": backward2d.pg_occupancy(GS2D_RECON.cell, n_gs2d, n_gs2d,
                                                          dev),
            "sms": backward2d._sm_count(dev)},
        "rollout2d_kxk_persistent_kernel": {
            **cell2d.kxk_plan(BURGERS_STAGE1.grid, BURGERS_STAGE1.grid, BURGERS_STAGE1.cell,
                              cell2d._sm_count(dev)),
            "blocks_an_sm_holds": cell2d.kxk_occupancy(BURGERS_STAGE1.cell, BURGERS_STAGE1.grid,
                                                       BURGERS_STAGE1.grid, dev)},
        "adj2d_kxk_persistent_kernel": {
            **backward2d.kxk_adj_plan(BURGERS_STAGE1.grid, BURGERS_STAGE1.grid,
                                      BURGERS_STAGE1.cell, cell2d._sm_count(dev)),
            "blocks_an_sm_holds": backward2d.kxk_adj_occupancy(
                BURGERS_STAGE1.cell, BURGERS_STAGE1.grid, BURGERS_STAGE1.grid, dev)},
        "rollout2d_ffma_persistent_kernel": {
            **cell2d.ffma_plan(BURGERS_STAGE1.grid, BURGERS_STAGE1.grid, BURGERS_STAGE1.cell,
                               cell2d._sm_count(dev)),
            "blocks_an_sm_holds": cell2d.ffma_occupancy(BURGERS_STAGE1.cell, BURGERS_STAGE1.grid,
                                                        BURGERS_STAGE1.grid, dev)},
        "adj2d_ys_persistent_kernel": {
            **backward2d.ys_plan(BURGERS_STAGE1.grid, BURGERS_STAGE1.grid, BURGERS_STAGE1.cell,
                                 cell2d._sm_count(dev)),
            "blocks_an_sm_holds": backward2d.ys_occupancy(BURGERS_STAGE1.cell, BURGERS_STAGE1.grid,
                                                          BURGERS_STAGE1.grid, dev)},
        "rollout3d_persistent_kernel": {
            **cell3d.rollout3d_plan(*(GS3D_RECON.grid,) * 3, cell2d._sm_count(dev)),
            "blocks_an_sm_holds": cell3d.rollout3d_occupancy(*(GS3D_RECON.grid,) * 3, dev)},
        "pg3d_persistent_kernel": {
            **backward3d.pg3d_plan(*(GS3D_RECON.grid,) * 3, GS3D_RECON.cell,
                                   cell2d._sm_count(dev)),
            "blocks_an_sm_holds": backward3d.pg3d_occupancy(GS3D_RECON.cell,
                                                            *(GS3D_RECON.grid,) * 3, dev)}}
    # the ensemble's one-launch kernels at M = 4 and 8: the plans, and what
    # the card holds of clusters of 16 and of 8 CTAs and of the sweep's blocks
    held16 = one_launch["rollout2d_cluster_kernel"]["clusters_the_card_holds"]
    one_launch["rollout2d_cluster_kernel[batched]"] = {
        **{f"M={n}": batched2d.rollout_b_plan(n, n_gs2d, n_gs2d, GS2D_RECON.cell, held16)
           for n in (ENS_MEMBERS, 2 * ENS_MEMBERS)},
        "clusters_the_card_holds": {"16": held16, "8": cell2d.cluster_occupancy(
            GS2D_RECON.cell, n_gs2d, n_gs2d, 8)}}
    one_launch["pg2d_batched_persistent_kernel"] = {
        f"M={n}": {**batched2d.pg_b_plan(n, n_gs2d, n_gs2d, GS2D_RECON.cell,
                                         backward2d._sm_count(dev)),
                   "blocks_an_sm_holds": batched2d.pg_b_occupancy(GS2D_RECON.cell, n, n_gs2d,
                                                                  n_gs2d, dev)}
        for n in (ENS_MEMBERS, 2 * ENS_MEMBERS)}
    # the streaming sweeps' one-launch kernels: row 4 at k = 1 at GS2D's
    # shape, rows 4 and 12 at k = 5 at Burgers' for M = 1 (row 4) and
    # M = 2, 4 and 8 (row 12)
    one_launch["adj2d_persistent_kernel"] = {
        **backward2d.adj_plan(n_gs2d, n_gs2d, GS2D_RECON.cell, backward2d._sm_count(dev)),
        "blocks_an_sm_holds": backward2d.adj_occupancy(GS2D_RECON.cell, n_gs2d, n_gs2d, dev)}
    nb_grid = BURGERS_STAGE1.grid
    one_launch["adj2d_batched_ffma_persistent_kernel"] = {
        f"M={n}": {**batched2d.adj_b_plan(n, nb_grid, nb_grid, BURGERS_STAGE1.cell,
                                          backward2d._sm_count(dev)),
                   "blocks_an_sm_holds": batched2d.adj_b_occupancy(BURGERS_STAGE1.cell, n,
                                                                   nb_grid, nb_grid, dev)}
        for n in (1, ENS_KXK_MEMBERS, 2 * ENS_KXK_MEMBERS, 4 * ENS_KXK_MEMBERS)}
    # row 12 at k = 1 at GS2D's shape for M = 4 and 8
    one_launch["adj2d_batched_persistent_kernel"] = {
        f"M={n}": {**batched2d.adj1_b_plan(n, n_gs2d, n_gs2d, GS2D_RECON.cell,
                                           backward2d._sm_count(dev)),
                   "blocks_an_sm_holds": batched2d.adj1_b_occupancy(GS2D_RECON.cell, n, n_gs2d,
                                                                    n_gs2d, dev)}
        for n in (ENS_MEMBERS, 2 * ENS_MEMBERS)}
    # row 11 at k = 5 at Burgers' shape for M = 1, 2, 4 and 8, and row 9 at
    # GS3D's: the one-launch routes this slice adds
    one_launch["rollout2d_ffma_persistent_kernel[batched]"] = {
        f"M={n}": {**batched2d.rollout_b_plan(n, nb_grid, nb_grid, BURGERS_STAGE1.cell,
                                              n_sm=cell2d._sm_count(dev)),
                   "blocks_an_sm_holds": batched2d.rollout_b_occupancy(
                       BURGERS_STAGE1.cell, n, nb_grid, nb_grid, dev)}
        for n in (1, ENS_KXK_MEMBERS, 2 * ENS_KXK_MEMBERS, 4 * ENS_KXK_MEMBERS)}
    one_launch["adj3d_persistent_kernel"] = {
        **backward3d.adj3d_plan(*(GS3D_RECON.grid,) * 3, GS3D_RECON.cell, cell2d._sm_count(dev)),
        "blocks_an_sm_holds": backward3d.adj3d_occupancy(GS3D_RECON.cell,
                                                         *(GS3D_RECON.grid,) * 3, dev)}
    # row 14's one-launch route at GS2D's and Burgers' shapes on a 2 x 2 mesh
    # (four 50 x 50 blocks): blocks_plan beside what the card holds
    one_launch["rollout2d_blocks_kernel"] = {
        label: {**sharded_step2d.blocks_plan(4, n_ // 2, n_ // 2, cell_, cell2d._sm_count(dev)),
                **sharded_step2d.blocks_occupancy(4, n_ // 2, n_ // 2, cell_, dev)}
        for label, cell_, n_ in (("gs2d", GS2D_RECON.cell, n_gs2d),
                                 ("burgers", BURGERS_STAGE1.cell, BURGERS_STAGE1.grid))}
    check(all(v["route"] == "one_launch" and v["fits"]
              for v in one_launch["rollout2d_blocks_kernel"].values()),
          f"the card holds none of row 14's one-launch grids: "
          f"{one_launch['rollout2d_blocks_kernel']}")
    check(one_launch["adj3d_persistent_kernel"]["blocks_an_sm_holds"] >= 1
          and all(v["route"] == "persistent" and v["blocks_an_sm_holds"] >= 1 for v in
                  one_launch["rollout2d_ffma_persistent_kernel[batched]"].values()),
          f"the card holds none of rows 9's and 11's one-launch grids: {one_launch}")
    check(one_launch["adj2d_persistent_kernel"]["blocks_an_sm_holds"] >= 1
          and all(v["blocks_an_sm_holds"] >= 1 for name in (
              "adj2d_batched_ffma_persistent_kernel", "adj2d_batched_persistent_kernel")
              for v in one_launch[name].values()),
          f"the card holds none of a streaming sweep's one-launch grid: {one_launch}")
    check(min(one_launch["rollout2d_cluster_kernel[batched]"]["clusters_the_card_holds"].values())
          >= 1 and all(v["blocks_an_sm_holds"] >= 1 for v in
                       one_launch["pg2d_batched_persistent_kernel"].values()),
          f"the card holds none of an ensemble's one-launch grid: {one_launch}")
    check(one_launch["rollout2d_cluster_kernel"]["clusters_the_card_holds"] >= 1
          and all(one_launch[k]["blocks_an_sm_holds"] >= 1
                  for k in ("pg2d_persistent_kernel", "rollout2d_kxk_persistent_kernel",
                            "adj2d_kxk_persistent_kernel", "rollout2d_ffma_persistent_kernel",
                            "adj2d_ys_persistent_kernel", "rollout3d_persistent_kernel",
                            "pg3d_persistent_kernel")),
          f"the card holds none of a one-launch kernel's grid: {one_launch}")
    # the k = 5, 3-branch instances of the FFMA kernels on the MXU-off route,
    # and row 3's per-step kernel beside them: FFMA and shared-memory loads
    # in each one's machine code
    sass = {lib: sass_mix(_build.BUILD_DIR / f"lib{lib}.so", names) for lib, names in (
        ("cell2d", ("rollout2d_kernel", "final2d_kernel")),
        ("cell2d_kxk", ("rollout2d_kxk_kernel",)),
        ("cell2d_ffma", ("rollout2d_ffma_persistent_kernel",)),
        ("adj2d", ("adj2d_act_kernel", "adj2d_ys_act_kernel", "adj2d_ys_persistent_kernel")),
        ("batched2d", ("adj2d_batched_ffma_persistent_kernel",)))}
    # registers and spills of the instances the main paths run: the
    # streaming sweeps' one-launch kernels (GS2D's 3 branches, the Burgers
    # cell's k = 5 and 3 branches) and rows 1 (k = 5), 5 and 7, which share
    # their code
    ptxas_main = {f"{name}<{', '.join(map(str, targs))}>": ptxas_of(_build.PTXAS.get(lib, []),
                                                                   name, targs)
                  for lib, name, targs in (
                      ("adj2d", "adj2d_persistent_kernel", (3,)),
                      ("batched2d", "adj2d_batched_persistent_kernel", (3,)),
                      ("batched2d", "adj2d_batched_ffma_persistent_kernel", (5, 3)),
                      ("backward2d", "pg2d_persistent_kernel", (3,)),
                      ("cell2d_ffma", "rollout2d_ffma_persistent_kernel", (5, 3, False)),
                      ("cell2d_ffma", "rollout2d_ffma_persistent_kernel", (5, 3, True)),
                      ("adj2d", "adj2d_ys_persistent_kernel", (5, 3)),
                      ("backward3d", "adj3d_persistent_kernel", (3, 2)),
                      ("backward3d", "pg3d_persistent_kernel", (3, 2)),
                      ("sharded_step2d", "step2d_blocks_kernel", (1, 0)),
                      ("sharded_step2d", "step2d_blocks_kernel", (5, 3)),
                      ("sharded_step2d", "rollout2d_blocks_kernel", (1, 0)),
                      ("sharded_step2d", "rollout2d_blocks_kernel", (5, 3)))}
    check(all(v is not None for v in ptxas_main.values()),
          f"ptxas reported no registers for {ptxas_main}")
    # the siblings of the one-launch kernels, which share their code or
    # headers (every kernel that includes cell2d_step.cuh: rows 1, 2, 11 and
    # 14's step2d_haloed_kernel; the single model's FFMA forward,
    # pg3d_persistent_kernel and every kernel that includes pg_common.cuh):
    # with --sass-against DIR, their machine code against a build of DIR's
    # sources (the parent commit's csrc/), every kernel instruction for
    # instruction
    sass_libs = ("cell2d", "sharded_step2d", "cell2d_ffma", "backward3d", "backward2d",
                 "batched2d", "adj2d")
    sass_vs_parent = None
    if sass_parent is not None and _cuobjdump() is not None:
        parent_dir = tempfile.mkdtemp(prefix="chip_smoke_parent_")
        try:
            sass_vs_parent, parent_libs = sass_against(sass_parent, sass_libs, parent_dir)
            check(all(not v["differ"] and not v["missing"] for v in sass_vs_parent.values()),
                  f"the siblings' machine code differs from {sass_parent}'s: "
                  f"{ {k: (v['differ'], v['missing']) for k, v in sass_vs_parent.items()} }")
            # pg3d_persistent_kernel (its body now shared with
            # adj3d_persistent_kernel) against the parent build's on the same
            # random inputs (a random-init GS3D cell, 48^3, 20 steps): g0 and
            # the accumulator planes to the bit
            cfg3_, n3_, t3_ = GS3D_RECON.cell, GS3D_RECON.grid, 20
            rs = np.random.RandomState(0)
            packed3_ = cell3d.pack_pi_params_3d(init_pi_cell(
                torch.Generator().manual_seed(0), cfg3_, device="cpu"), cfg3_).detach().to(
                    dev).contiguous()
            frames3_ = torch.as_tensor(rs.uniform(0.0, 1.0, (t3_ + 1, n3_, n3_, n3_, 2)),
                                       dtype=torch.float32, device=dev)
            fbar3_ = torch.as_tensor(rs.standard_normal(tuple(frames3_.shape)),
                                     dtype=torch.float32, device=dev)
            counts_ = (backward3d.fused_rollout_tp_3d_pg.launches,
                       backward3d.fused_rollout_tp_3d_pg.steps)
            new_ = backward3d._pg_persistent_cuda(packed3_, frames3_, fbar3_, cfg3_)
            (backward3d.fused_rollout_tp_3d_pg.launches,
             backward3d.fused_rollout_tp_3d_pg.steps) = counts_
            fn_ = ctypes.CDLL(parent_libs["backward3d"]).backward3d_pg_persistent
            fn_.argtypes, fn_.restype = backward3d._PERSISTENT_SIGNATURE, ctypes.c_int
            old_ = (torch.zeros_like(new_[0]), torch.empty_like(new_[1]))
            scratch_ = torch.zeros_like(new_[0])
            check(fn_(packed3_.data_ptr(), packed3_.numel(), frames3_.data_ptr(),
                      fbar3_.data_ptr(), old_[0].data_ptr(), scratch_.data_ptr(),
                      old_[1].data_ptr(), t3_, n3_, n3_, n3_, cfg3_.hidden, cfg3_.n_branches,
                      cfg3_.dt, 1.0 / (cfg3_.dx * cfg3_.dx),
                      backward3d.pg3d_plan(n3_, n3_, n3_, cfg3_, cell2d._sm_count(dev))["blocks"],
                      torch.cuda.current_stream().cuda_stream,
                      ctypes.byref(ctypes.c_int(0))) == 0, "the parent's pg3d_persistent_kernel")
            torch.cuda.synchronize()
            pg3d_bits = {"g0": bool(torch.equal(new_[0], old_[0])),
                         "planes": bool(torch.equal(new_[1], old_[1]))}
            check(all(pg3d_bits.values()),
                  f"pg3d_persistent_kernel's outputs vs the parent build's: {pg3d_bits}")
            del packed3_, frames3_, fbar3_, new_, old_, scratch_
        finally:
            shutil.rmtree(parent_dir, ignore_errors=True)
        sass_vs_parent = {k: {"same": len(v["same"]), "registers_only": v["registers_only"],
                              "differ": v["differ"], "missing": v["missing"], "new": v["new"]}
                          for k, v in sass_vs_parent.items()}
        sass_vs_parent["pg3d_persistent_kernel_outputs_vs_parent_build_equal_bits"] = pg3d_bits
    phase("build", sources={f"percnn_tpu_torch/ops/kernels/csrc/{n}.cu": round(build_s[n], 3)
                            for n in sources},
          ptxas={n: _build.PTXAS.get(n) for n in sources}, one_launch=one_launch,
          ptxas_main_instances=ptxas_main, sass_k5_nb3=sass,
          sass_vs_parent=sass_vs_parent or "not asked (--sass-against DIR)")

    cfg, isg_cfg = GS2D_RECON.cell, GS2D_RECON.isg
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    model = {"cell": unflatten_dotted(golden, "cell."),
             "isg": unflatten_dotted(golden, "isg.")}
    params = params_from_numpy(model, device=dev, dtype=torch.float32)

    # golden: the reference's trained GS2D model, 64 x 64, 8 steps
    isg_out = isg_apply(params["isg"], torch.as_tensor(golden["isg_in"], device=dev), isg_cfg)
    isg_want = torch.as_tensor(golden["isg_out"], device=dev)
    isg_err = max_abs(isg_out, isg_want)
    check(allclose(isg_out, isg_want, rtol=1e-5, atol=2e-6),
          f"golden ISG: max |diff| {isg_err} over atol 2e-6")
    frames_want = torch.as_tensor(golden["frames"], device=dev)
    n_golden = frames_want.shape[0] - 1
    frames = cell2d.fused_rollout_2d(params["cell"], frames_want[0], cfg, n_golden)
    torch.cuda.synchronize()
    step_err = [max_abs(frames[k], frames_want[k]) for k in range(1, n_golden + 1)]
    for k, err in enumerate(step_err, start=1):
        check(err <= 2e-5 * k, f"golden rollout step {k}: max |diff| {err} over {2e-5 * k}")
    phase("golden", isg_max_abs_err=isg_err, isg_atol=2e-6,
          rollout_max_abs_err_per_step=step_err, rollout_bar="2e-5 * t")

    # golden3d: the reference's trained GS3D model, ISG 12^3 -> 24^3, 6 steps
    cfg3, isg3 = GS3D_RECON.cell, GS3D_RECON.isg
    with np.load(GOLDEN3D) as z:
        golden3 = {k: z[k] for k in z.files}
    model3 = {"cell": unflatten_dotted(golden3, "cell."), "isg": unflatten_dotted(golden3, "isg.")}
    params3 = params_from_numpy(model3, device=dev, dtype=torch.float32)
    isg3_out = isg_apply(params3["isg"], torch.as_tensor(golden3["isg_in"], device=dev), isg3)
    isg3_want = torch.as_tensor(golden3["isg_out"], device=dev)
    isg3_err = max_abs(isg3_out, isg3_want)
    check(allclose(isg3_out, isg3_want, rtol=1e-5, atol=2e-6),
          f"golden 3D ISG: max |diff| {isg3_err} over atol 2e-6")
    frames3_want = torch.as_tensor(golden3["frames"], device=dev)
    n_golden3 = frames3_want.shape[0] - 1
    cell3d.fused_rollout_3d.launches = cell3d.fused_rollout_3d.steps = 0
    frames3 = cell3d.fused_rollout_3d(params3["cell"], frames3_want[0], cfg3, n_golden3)
    torch.cuda.synchronize()
    golden3_counts = (cell3d.fused_rollout_3d.launches, cell3d.fused_rollout_3d.steps)
    check(golden3_counts == (1, n_golden3),
          f"golden 3D rollout: (launches, steps) {golden3_counts}, expected "
          f"(1, {n_golden3}) of rollout3d_persistent_kernel")
    step3_err = [max_abs(frames3[k], frames3_want[k]) for k in range(1, n_golden3 + 1)]
    for k, e in enumerate(step3_err, start=1):
        check(e <= 2e-5 * k, f"golden 3D rollout step {k}: max |diff| {e} over {2e-5 * k}")
    phase("golden3d", isg_max_abs_err=isg3_err, isg_atol=2e-6, shape=list(frames3.shape[1:]),
          launches_and_steps=golden3_counts, rollout_max_abs_err_per_step=step3_err,
          rollout_bar="2e-5 * t")

    # golden_burgers: the reference's trained Burgers Stage-1 model (5x5 Pi
    # cell, C = 16), ISG 32^2 -> 64^2, 8 steps through the frames rollout's
    # route at 64 x 64, rollout2d_kxk_persistent_kernel
    cfgb, isgb = BURGERS_STAGE1.cell, BURGERS_STAGE1.isg
    with np.load(GOLDEN_BURGERS) as z:
        goldenb = {k: z[k] for k in z.files}
    modelb = {"cell": unflatten_dotted(goldenb, "cell."), "isg": unflatten_dotted(goldenb, "isg.")}
    paramsb = params_from_numpy(modelb, device=dev, dtype=torch.float32)
    isgb_out = isg_apply(paramsb["isg"], torch.as_tensor(goldenb["isg_in"], device=dev), isgb)
    isgb_want = torch.as_tensor(goldenb["isg_out"], device=dev)
    isgb_err = max_abs(isgb_out, isgb_want)
    check(allclose(isgb_out, isgb_want, rtol=1e-5, atol=2e-6),
          f"golden Burgers ISG: max |diff| {isgb_err} over atol 2e-6")
    framesb_want = torch.as_tensor(goldenb["frames"], device=dev)
    n_goldenb = framesb_want.shape[0] - 1
    cell2d.fused_rollout_kxk_2d.launches = cell2d.fused_rollout_kxk_2d.steps = 0
    framesb = cell2d.fused_rollout_2d(paramsb["cell"], framesb_want[0], cfgb, n_goldenb)
    torch.cuda.synchronize()
    goldenb_counts = (cell2d.fused_rollout_kxk_2d.launches, cell2d.fused_rollout_kxk_2d.steps)
    check(goldenb_counts == (1, n_goldenb),
          f"golden Burgers rollout: (launches, steps) {goldenb_counts}, expected "
          f"(1, {n_goldenb}) of rollout2d_kxk_persistent_kernel")
    stepb_err = [max_abs(framesb[k], framesb_want[k]) for k in range(1, n_goldenb + 1)]
    for k, e in enumerate(stepb_err, start=1):
        check(e <= 2e-5 * k, f"golden Burgers rollout step {k}: max |diff| {e} over {2e-5 * k}")
    phase("golden_burgers", isg_max_abs_err=isgb_err, isg_atol=2e-6,
          shape=list(framesb.shape[1:]), launches_and_steps=goldenb_counts,
          rollout_max_abs_err_per_step=stepb_err,
          rollout_bar="2e-5 * t")

    # kernels: full width, trained weights, against the plain versions
    h0 = torch.as_tensor(default_ic("gray_scott_2d", GS2D_RECON.grid), dtype=torch.float32,
                         device=dev)
    packed = cell2d.pack_pi_params_2d(params["cell"], cfg)
    got = cell2d.fused_rollout_2d(params["cell"], h0, cfg, CHECK_STEPS)
    want = cell2d.fused_rollout_2d_plain(packed, h0, cfg, CHECK_STEPS)
    # row 2 at k = 1: final_plan takes the cluster kernel's final-state mode
    # at 100 x 100, one launch; it runs the frames path's arithmetic, so it
    # equals the last frame from the same h0 to the bit.  Beside it the
    # per-step route, final2d_kernel
    final_fn = cell2d.fused_rollout_final_2d
    check(cell2d.final_plan(*h0.shape[:2], cfg, cell2d._sm_count(dev))["route"] == "cluster",
          f"final_plan at {tuple(h0.shape)}: {cell2d.final_plan(*h0.shape[:2], cfg, 0)}")
    zero = (final_fn.launches, final_fn.steps)
    got_final = final_fn(params["cell"], h0, cfg, CHECK_STEPS)
    torch.cuda.synchronize()
    final_counts = (final_fn.launches - zero[0], final_fn.steps - zero[1])
    check(final_counts == (1, CHECK_STEPS),
          f"final state at 100 x 100: (launches, steps) {final_counts}, expected "
          f"(1, {CHECK_STEPS}) of rollout2d_cluster_kernel")
    want_final = cell2d.fused_rollout_final_2d_plain(packed, h0, cfg, CHECK_STEPS)
    got_final_steps = cell2d._final_steps_cuda(packed, h0, cfg, CHECK_STEPS)
    torch.cuda.synchronize()
    err = {"rollout2d_cluster_kernel": max_abs(got, want),
           "rollout2d_cluster_kernel[final]": max_abs(got_final, want_final),
           "final2d_kernel": max_abs(got_final_steps, want_final)}
    check(allclose(got, want, rtol=2e-4, atol=1e-5),
          f"rollout2d_cluster_kernel vs plain: max |diff| {err['rollout2d_cluster_kernel']}")
    for label, a, b in (("rollout2d_cluster_kernel[final] vs plain", got_final, want_final),
                        ("final2d_kernel vs plain", got_final_steps, want_final),
                        ("rollout2d_cluster_kernel[final] vs final2d_kernel", got_final,
                         got_final_steps)):
        check(allclose(a, b, rtol=2e-4, atol=1e-5), f"{label}: max |diff| {max_abs(a, b)}")
    final_vs_frame = max_abs(got_final, got[-1])
    final_routes_err = max_abs(got_final, got_final_steps)
    check(torch.equal(got_final, got[-1]),
          f"rollout2d_cluster_kernel[final] vs the frames' last frame: max |diff| {final_vs_frame}")
    del got_final_steps
    # the frames rollout's two routes: rollout_plan takes the cluster at
    # 100 x 100; the per-step kernel runs the same step arithmetic, so the
    # two agree to the bit
    check(cell2d.rollout_plan(*h0.shape[:2], cfg)["route"] == "cluster",
          f"rollout_plan at {tuple(h0.shape)}: {cell2d.rollout_plan(*h0.shape[:2], cfg)}")
    got_steps = cell2d._rollout_steps_cuda(packed, h0, cfg, CHECK_STEPS)
    torch.cuda.synchronize()
    err["rollout2d_kernel[per_step]"] = max_abs(got_steps, want)
    check(allclose(got_steps, want, rtol=2e-4, atol=1e-5),
          f"rollout2d_kernel vs plain: max |diff| {err['rollout2d_kernel[per_step]']}")
    check(torch.equal(got, got_steps),
          f"rollout2d_cluster_kernel vs rollout2d_kernel: max |diff| {max_abs(got, got_steps)}")
    del got_steps
    # the cluster on 17 rows (8 CTAs, strips of 3 and 2 rows: the smallest
    # the plan makes, where a cell is in both halos it feeds) and the
    # per-step route past the cluster's capacity (449 x 449), random fields
    # the same for the final state (final_plan: the cluster's final-state
    # mode, or final2d_kernel past the cluster's capacity), counted
    route_checks, final_steps_launches = {}, {}
    for shape, steps_, route in (((17, 9), 30, "cluster"), ((449, 449), 20, "per_step")):
        x = torch.as_tensor(0.5 + 0.1 * np.random.RandomState(5).standard_normal(shape + (2,)),
                            dtype=torch.float32, device=dev)
        plan = cell2d.rollout_plan(*shape, cfg)
        check(plan["route"] == route, f"rollout_plan at {shape}: {plan}, expected {route}")
        check(cell2d.final_plan(*shape, cfg, cell2d._sm_count(dev)) == plan,
              f"final_plan at {shape}: {cell2d.final_plan(*shape, cfg, 0)}, expected {plan}")
        zero = (cell2d.fused_rollout_2d.launches, cell2d.fused_rollout_2d.steps,
                final_fn.launches, final_fn.steps)
        g_ = cell2d.fused_rollout_2d(params["cell"], x, cfg, steps_)
        f_ = final_fn(params["cell"], x, cfg, steps_)
        w_ = cell2d.fused_rollout_2d_plain(packed, x, cfg, steps_)
        torch.cuda.synchronize()
        moved = (cell2d.fused_rollout_2d.launches - zero[0],
                 cell2d.fused_rollout_2d.steps - zero[1],
                 final_fn.launches - zero[2], final_fn.steps - zero[3])
        n_launch = 1 if route == "cluster" else steps_
        check(moved == (n_launch, steps_, n_launch, steps_),
              f"rollout and final state at {shape}: (launches, steps) {moved}")
        route_checks[f"{shape[0]}x{shape[1]}"] = {
            "route": route, "steps": steps_, "launches": moved[0],
            "max_abs_err": max_abs(g_, w_),
            "final": {"launches": moved[2], "max_abs_err": max_abs(f_, w_[-1]),
                      "vs_last_frame": max_abs(f_, g_[-1])}}
        if route == "per_step":
            final_steps_launches["kernels (449 x 449)"] = moved[2]
        check(allclose(g_, w_, rtol=2e-4, atol=1e-5),
              f"rollout at {shape} ({route}) vs plain: max |diff| {max_abs(g_, w_)}")
        check(allclose(f_, w_[-1], rtol=2e-4, atol=1e-5),
              f"final state at {shape} ({route}) vs plain: max |diff| {max_abs(f_, w_[-1])}")
    del g_, f_, w_, x
    phase("kernels", shape=[GS2D_RECON.grid, GS2D_RECON.grid, 2], steps=CHECK_STEPS,
          max_abs_err=err, rtol=2e-4, atol=1e-5,
          cluster_vs_per_step="equal to the bit", final_launches_and_steps=final_counts,
          final_vs_last_frame_max_abs_err=final_vs_frame,
          final_cluster_vs_final2d_max_abs_err=final_routes_err, route_checks=route_checks)

    # grads: the backward kernel and the fused gradients at full width
    def data_term(frames, meas, exp=GS2D_RECON):
        return (exp.loss_weights["data"]
                * data_loss(frames, meas, exp.data, exp.cell.ndim)[0])

    def cotangent(frames, exp=GS2D_RECON):
        """Measurements (a noisy copy of the frames) and the cotangent of the
        weighted data loss at the frames (40 * data_loss for GS2D)."""
        meas = subsample(torch.as_tensor(add_noise(frames.cpu().numpy(), exp.noise_pct),
                                         device=dev), exp.data, exp.cell.ndim)
        fr = frames.clone().requires_grad_(True)
        (fbar,) = torch.autograd.grad(data_term(fr, meas, exp), fr)
        return meas, fbar

    frames = cell2d._rollout_cuda(packed, h0, cfg, CHECK_STEPS)
    meas, fbar = cotangent(frames)
    g0_k, acc_k = backward2d._pg_cuda(packed, frames, fbar, cfg)
    g0_p, acc_p = backward2d.fused_phase1_pg_2d_plain(packed, frames, fbar.contiguous(), cfg)
    torch.cuda.synchronize()
    sums_k, sums_p = acc_k.sum((1, 2)), acc_p.sum((1, 2))
    lay, C, nb = backward2d._pg_layout(cfg), cfg.hidden, cfg.n_branches
    groups = {"diff": (lay["diff"], 2)}
    for o in range(2):
        for i in range(nb):
            groups[f"pi[{o}].w{i}"] = (lay["dw"] + (o * nb + i) * 2 * C, 2 * C)
            groups[f"pi[{o}].b{i}"] = (lay["db"] + (o * nb + i) * C, C)
        groups[f"pi[{o}].w_out"] = (lay["wout"] + o * C, C)
        groups[f"pi[{o}].b_out"] = (lay["bout"] + o, 1)
    leaf_err = {"g0": (max_abs(g0_k, g0_p), float(g0_p.abs().max()))}
    for name, (start, n) in groups.items():
        leaf_err[name] = (max_abs(sums_k[start:start + n], sums_p[start:start + n]),
                          float(sums_p[start:start + n].abs().max()))
    for name, (e, scale) in leaf_err.items():
        check(e <= 2e-4 * scale + 2e-6,
              f"pg2d_persistent_kernel vs plain, {name}: max |diff| {e} over "
              f"2e-4 * {scale} + 2e-6")
    err["pg2d_persistent_kernel"] = max(e for e, _ in leaf_err.values())

    def pg_leaf_errs(g0_a, acc_a, g0_b, acc_b):
        """Per leaf: (max |diff| of a from b, max |b|)."""
        sa, sb = acc_a.sum((1, 2)), acc_b.sum((1, 2))
        out = {"g0": (max_abs(g0_a, g0_b), float(g0_b.abs().max()))}
        for name, (start, n) in groups.items():
            out[name] = (max_abs(sa[start:start + n], sb[start:start + n]),
                         float(sb[start:start + n].abs().max()))
        return out

    # the sweep's two routes at 100 x 100: pg_plan takes the persistent
    # kernel; the per-step kernel sums the Jacobian's transpose in another
    # order (branch by branch over (o, c), against per (o, c) and then over
    # them), so the two agree to rounding, held at the kernel's bar
    check(backward2d.pg_plan(*h0.shape[:2], cfg, backward2d._sm_count(dev))["route"]
          == "persistent", "pg_plan does not take the persistent sweep at 100 x 100")
    g0_s, acc_s = backward2d._pg_steps_cuda(packed, frames, fbar, cfg)
    torch.cuda.synchronize()
    steps_err = pg_leaf_errs(g0_s, acc_s, g0_p, acc_p)
    routes_err = pg_leaf_errs(g0_k, acc_k, g0_s, acc_s)
    for label, errs in (("pg2d_kernel vs plain", steps_err),
                        ("pg2d_persistent_kernel vs pg2d_kernel", routes_err)):
        for name, (e, scale) in errs.items():
            check(e <= 2e-4 * scale + 2e-6,
                  f"{label}, {name}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
    err["pg2d_kernel[per_step]"] = max(e for e, _ in steps_err.values())
    routes_rel = max(e / sc for e, sc in routes_err.values() if sc > 0)
    del g0_s, acc_s
    # past the persistent sweep's capacity: 195 x 195 by pg_plan's rule
    # takes pg2d_kernel (a random field and cotangent, 10 steps)
    rng_pg = np.random.RandomState(6)
    x_pg = torch.as_tensor(0.5 + 0.1 * rng_pg.standard_normal((195, 195, 2)),
                           dtype=torch.float32, device=dev)
    check(backward2d.pg_plan(195, 195, cfg, backward2d._sm_count(dev))["route"] == "per_step",
          "pg_plan takes the persistent sweep at 195 x 195")
    fr_pg = cell2d._rollout_cuda(packed, x_pg, cfg, 10)
    fb_pg = torch.as_tensor(rng_pg.standard_normal(tuple(fr_pg.shape)), dtype=torch.float32,
                            device=dev)
    zero = (backward2d.fused_rollout_tp_2d_pg.launches, backward2d.fused_rollout_tp_2d_pg.steps)
    big_err = pg_leaf_errs(*backward2d.fused_phase1_pg_2d(packed, fr_pg, fb_pg, cfg),
                           *backward2d.fused_phase1_pg_2d_plain(packed, fr_pg, fb_pg, cfg))
    moved = (backward2d.fused_rollout_tp_2d_pg.launches - zero[0],
             backward2d.fused_rollout_tp_2d_pg.steps - zero[1])
    check(moved == (10, 10), f"sweep at 195 x 195: (launches, steps) {moved}")
    for name, (e, scale) in big_err.items():
        check(e <= 2e-4 * scale + 2e-6,
              f"pg2d_kernel vs plain at 195 x 195, {name}: max |diff| {e} over "
              f"2e-4 * {scale} + 2e-6")
    del x_pg, fr_pg, fb_pg

    def rel_errs_vs_f64(cell_np, x0, steps, loss, cfg=cfg, routes=None):
        """Worst |g - g64| / max|g64| per leaf (cell leaves and dh0) of each
        route's f32 gradients (routes: name -> fn(params, h0, cfg, steps),
        by default the fused pg rollout) and of plain f32 autograd through
        rollout(pi_cell_step) (remat), against f64 autograd through the
        same, all on the card."""
        routes = routes or {"fused": backward2d.fused_rollout_tp_2d_pg}
        grads = {}
        kinds = [(k, torch.float32) for k in routes] + [("autograd_f32", torch.float32),
                                                        ("f64", torch.float64)]
        for kind, dtype in kinds:
            p = params_from_numpy(cell_np, device=dev, dtype=dtype)
            leaves = [p["diff"]] + [br[k] for br in p["pi"] for k in sorted(br)]
            x = x0.to(dtype).clone()
            for leaf in leaves + [x]:
                leaf.requires_grad_(True)
            if kind in routes:
                fr = routes[kind](p, x, cfg, steps)
            else:
                fr = rollout(lambda h: pi_cell_step(p, h, cfg), x, steps)
            grads[kind] = torch.autograd.grad(loss(fr), leaves + [x])
        names = ["diff"] + [f"pi[{o}].{k}" for o in range(2) for k in sorted(cell_np["pi"][o])]
        return {kind: {n: float((a.double() - b).abs().max() / b.abs().max())
                       for n, a, b in zip(names + ["h0"], grads[kind], grads["f64"])}
                for kind, _ in kinds[:-1]}

    # (b1) the measure of the JAX package's gradient referee (random-init
    # cell, random targets, 12 steps, full width): held to 1e-4
    rng = np.random.RandomState(1)
    ref_cell = params_to_numpy(init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu"))
    x_ref = torch.as_tensor(0.3 * rng.standard_normal((GS2D_RECON.grid,) * 2 + (2,)),
                            dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(rng.standard_normal((13,) + tuple(x_ref.shape)), device=dev)
    rel_ref = rel_errs_vs_f64(ref_cell, x_ref, 12, lambda fr: ((fr - tgt.to(fr.dtype)) ** 2).mean())
    worst_ref = max(rel_ref["fused"], key=rel_ref["fused"].get)
    check(rel_ref["fused"][worst_ref] <= 1e-4,
          f"fused gradients vs f64 autograd: {worst_ref} at "
          f"{rel_ref['fused'][worst_ref]} over 1e-4")
    # (b2) the trained cell at T = 200 with the data-loss cotangent: the
    # f32 forward's rounding sets the floor of this measure for any f32
    # path, so the fused gradients are held to plain f32 autograd's error
    rel_gold = rel_errs_vs_f64(model["cell"], h0, CHECK_STEPS,
                               lambda fr: data_term(fr, meas.to(fr.dtype)))
    worst_gold = {k: max(v.values()) for k, v in rel_gold.items()}
    check(worst_gold["fused"] <= 2 * worst_gold["autograd_f32"],
          f"fused gradients vs f64 autograd on the trained cell: {worst_gold['fused']} over "
          f"2 x plain f32 autograd's {worst_gold['autograd_f32']}")
    phase("grads", shape=[GS2D_RECON.grid, GS2D_RECON.grid, 2], steps=CHECK_STEPS,
          pg2d_persistent_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                     in leaf_err.items()},
          pg2d_per_step_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                   in steps_err.items()},
          persistent_vs_per_step_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                   in routes_err.items()},
          persistent_vs_per_step_worst_rel=routes_rel,
          per_step_195x195_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                      in big_err.items()},
          pg2d_bar="2e-4 * max|leaf| + 2e-6",
          f64_random_cell_12_steps={"worst_leaf": worst_ref, "bar": 1e-4, **rel_ref},
          f64_trained_cell_200_steps={"worst": worst_gold, "bar": "2 x autograd_f32",
                                      **rel_gold})

    # kernels3d: the 3D kernels at full width against their plain versions,
    # both routes of rows 8 and 10 at 48^3 (the plans' one-launch kernels and
    # the per-step kernels) against each other too, and the per-step routes
    # through the entry points past the plans' capacity
    n3 = GS3D_RECON.grid
    n_sm = cell2d._sm_count(dev)
    h03 = torch.as_tensor(default_ic("gray_scott_3d", n3), dtype=torch.float32, device=dev)
    expanded3 = cell3d.pack_pi_expanded_3d(params3["cell"], cfg3).contiguous()
    packed3 = cell3d.pack_pi_params_3d(params3["cell"], cfg3)
    check(cell3d.rollout3d_plan(n3, n3, n3, n_sm)["route"] == "persistent",
          f"rollout3d_plan at {n3}^3: {cell3d.rollout3d_plan(n3, n3, n3, n_sm)}")
    check(backward3d.pg3d_plan(n3, n3, n3, cfg3, n_sm)["route"] == "persistent",
          f"pg3d_plan at {n3}^3: {backward3d.pg3d_plan(n3, n3, n3, cfg3, n_sm)}")
    fwd3_err = {}
    for final_only in (False, True):
        form = "final_state" if final_only else "frames"
        got = cell3d._rollout_persistent_cuda(expanded3, h03, CHECK3D_STEPS, final_only=final_only)
        got_steps = cell3d._rollout_steps_cuda(expanded3, h03, CHECK3D_STEPS,
                                               final_only=final_only)
        want = cell3d.fused_rollout_3d_plain(expanded3, h03, CHECK3D_STEPS, final_only=final_only)
        torch.cuda.synchronize()
        fwd3_err[form] = {"persistent_vs_plain": max_abs(got, want),
                          "per_step_vs_plain": max_abs(got_steps, want),
                          "persistent_vs_per_step": max_abs(got, got_steps)}
        for label, a, b in (("rollout3d_persistent_kernel vs plain", got, want),
                            ("rollout3d_kernel vs plain", got_steps, want),
                            ("rollout3d_persistent_kernel vs rollout3d_kernel", got, got_steps)):
            check(allclose(a, b, rtol=2e-4, atol=1e-5),
                  f"{label}, {form}: max |diff| {max_abs(a, b)}")
    del got, got_steps, want
    err["rollout3d_persistent_kernel"] = max(v["persistent_vs_plain"] for v in fwd3_err.values())
    err["rollout3d_kernel"] = max(v["per_step_vs_plain"] for v in fwd3_err.values())
    # through the entry point: a field whose blocks own more cells than the
    # one-launch kernel's 896 threads (60^3, 1637 a block) and one past the
    # forward's capacity (92^3, rollout3d_kernel by the rule); random fields,
    # 3 steps, launches and steps counted
    rng3k = np.random.RandomState(7)
    big3_err, steps3d_launches = {}, {}
    for n_, route in ((60, "persistent"), (92, "per_step")):
        x_ = torch.as_tensor(0.5 + 0.1 * rng3k.standard_normal((n_,) * 3 + (2,)),
                             dtype=torch.float32, device=dev)
        check(cell3d.rollout3d_plan(n_, n_, n_, n_sm)["route"] == route,
              f"rollout3d_plan at {n_}^3: expected {route}")
        zero = (cell3d.fused_rollout_3d.launches, cell3d.fused_rollout_3d.steps)
        g_ = cell3d.fused_rollout_3d(params3["cell"], x_, cfg3, 3)
        torch.cuda.synchronize()
        moved = (cell3d.fused_rollout_3d.launches - zero[0],
                 cell3d.fused_rollout_3d.steps - zero[1])
        want_moved = (1 if route == "persistent" else 3, 3)
        check(moved == want_moved, f"rollout at {n_}^3: (launches, steps) {moved}, "
                                   f"expected {want_moved}")
        w_ = cell3d.fused_rollout_3d_plain(expanded3, x_, 3)
        big3_err[f"{n_}^3 ({route})"] = max_abs(g_, w_)
        check(allclose(g_, w_, rtol=2e-4, atol=1e-5),
              f"rollout at {n_}^3 ({route}) vs plain: max |diff| {max_abs(g_, w_)}")
        if route == "per_step":
            steps3d_launches["rollout3d_kernel"] = moved[0]
    del x_, g_, w_
    frames3 = cell3d._rollout_cuda(expanded3, h03, PG3D_CHECK_STEPS)
    # a cotangent of O(1) in every cell (GS3D's data-loss cotangent is near
    # 5e-7 a cell, which would put every leaf under the bar's 2e-6 floor)
    fbar3 = torch.as_tensor(np.random.RandomState(3).standard_normal(tuple(frames3.shape)),
                            dtype=torch.float32, device=dev)
    pg3 = {"persistent": backward3d._pg_persistent_cuda(packed3, frames3, fbar3, cfg3),
           "per_step": backward3d._pg_steps_cuda(packed3, frames3, fbar3, cfg3),
           "plain": backward3d.fused_phase1_pg_3d_plain(packed3, frames3, fbar3.contiguous(),
                                                        cfg3)}
    torch.cuda.synchronize()
    lay3 = backward2d._pg_layout(cfg3)
    groups3 = {"diff": (lay3["diff"], 2)}
    for o in range(2):
        for i in range(cfg3.n_branches):
            groups3[f"pi[{o}].w{i}"] = (lay3["dw"] + (o * cfg3.n_branches + i) * 2 * cfg3.hidden,
                                        2 * cfg3.hidden)
            groups3[f"pi[{o}].b{i}"] = (lay3["db"] + (o * cfg3.n_branches + i) * cfg3.hidden,
                                        cfg3.hidden)
        groups3[f"pi[{o}].w_out"] = (lay3["wout"] + o * cfg3.hidden, cfg3.hidden)
        groups3[f"pi[{o}].b_out"] = (lay3["bout"] + o, 1)

    def pg3_leaf_errs(g0_a, acc_a, g0_b, acc_b):
        """Per leaf: (max |diff| of a from b, max |b|)."""
        sa, sb = acc_a.sum((1, 2, 3)), acc_b.sum((1, 2, 3))
        out = {"g0": (max_abs(g0_a, g0_b), float(g0_b.abs().max()))}
        for name, (start, n) in groups3.items():
            out[name] = (max_abs(sa[start:start + n], sb[start:start + n]),
                         float(sb[start:start + n].abs().max()))
        return out

    leaf3_err = pg3_leaf_errs(*pg3["persistent"], *pg3["plain"])
    steps3_err = pg3_leaf_errs(*pg3["per_step"], *pg3["plain"])
    routes3_err = pg3_leaf_errs(*pg3["persistent"], *pg3["per_step"])
    for name, (e, scale) in leaf3_err.items():
        check(2e-6 <= 0.01 * 2e-4 * scale,
              f"pg3d vs plain, {name}: the floor 2e-6 sets the bar (max|leaf| {scale})")
    for label, errs in (("pg3d_persistent_kernel vs plain", leaf3_err),
                        ("pg3d_kernel vs plain", steps3_err),
                        ("pg3d_persistent_kernel vs pg3d_kernel", routes3_err)):
        for name, (e, scale) in errs.items():
            check(e <= 2e-4 * scale + 2e-6,
                  f"{label}, {name}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
    err["pg3d_persistent_kernel"] = max(e for e, _ in leaf3_err.values())
    err["pg3d_kernel"] = max(e for e, _ in steps3_err.values())
    del pg3
    # past the sweep's capacity: 52^3 by pg3d_plan's rule takes pg3d_kernel
    # (a random field and cotangent, 5 steps, through the entry point)
    check(backward3d.pg3d_plan(52, 52, 52, cfg3, n_sm)["route"] == "per_step",
          "pg3d_plan takes the persistent sweep at 52^3")
    x52 = torch.as_tensor(0.5 + 0.1 * rng3k.standard_normal((52, 52, 52, 2)),
                          dtype=torch.float32, device=dev)
    fr52 = cell3d._rollout_cuda(expanded3, x52, 5)
    fb52 = torch.as_tensor(rng3k.standard_normal(tuple(fr52.shape)), dtype=torch.float32,
                           device=dev)
    zero = (backward3d.fused_rollout_tp_3d_pg.launches, backward3d.fused_rollout_tp_3d_pg.steps)
    big3_pg = pg3_leaf_errs(*backward3d.fused_phase1_pg_3d(packed3, fr52, fb52, cfg3),
                            *backward3d.fused_phase1_pg_3d_plain(packed3, fr52, fb52, cfg3))
    moved = (backward3d.fused_rollout_tp_3d_pg.launches - zero[0],
             backward3d.fused_rollout_tp_3d_pg.steps - zero[1])
    check(moved == (5, 5), f"sweep at 52^3: (launches, steps) {moved}")
    for name, (e, scale) in big3_pg.items():
        check(e <= 2e-4 * scale + 2e-6,
              f"pg3d_kernel vs plain at 52^3, {name}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
    steps3d_launches["pg3d_kernel"] = moved[0]
    del x52, fr52, fb52
    # the measure of the gradient referee at GS3D's shape: random-init cell,
    # random target, 12 steps, 48^3, held to 1e-4
    rng3 = np.random.RandomState(2)
    ref3_cell = params_to_numpy(init_pi_cell(torch.Generator().manual_seed(0), cfg3,
                                             device="cpu"))
    x3_ref = torch.as_tensor(0.5 + 0.2 * rng3.standard_normal((n3,) * 3 + (2,)),
                             dtype=torch.float32, device=dev)
    tgt3 = torch.as_tensor(rng3.standard_normal((13,) + tuple(x3_ref.shape)), device=dev)
    rel3 = rel_errs_vs_f64(ref3_cell, x3_ref, 12,
                           lambda fr: ((fr - tgt3.to(fr.dtype)) ** 2).mean(), cfg=cfg3,
                           routes={"fused": backward3d.fused_rollout_tp_3d_pg})
    worst3 = max(rel3["fused"], key=rel3["fused"].get)
    check(rel3["fused"][worst3] <= 1e-4,
          f"fused 3D gradients vs f64 autograd: {worst3} at {rel3['fused'][worst3]} over 1e-4")
    phase("kernels3d", shape=[n3, n3, n3, 2], rollout_steps=CHECK3D_STEPS,
          rollout3d_max_abs_err=fwd3_err, rollout_rtol=2e-4, rollout_atol=1e-5,
          persistent_vs_per_step_expected=0.0, entry_point_3_steps=big3_err,
          pg_steps=PG3D_CHECK_STEPS,
          pg3d_cotangent="standard normal, seed 3",
          pg3d_persistent_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                     in leaf3_err.items()},
          pg3d_per_step_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                   in steps3_err.items()},
          pg3d_persistent_vs_per_step_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                        in routes3_err.items()},
          pg3d_per_step_52_cubed_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                            in big3_pg.items()},
          pg3d_bar="2e-4 * max|leaf| + 2e-6", per_step_launches=steps3d_launches,
          f64_random_cell_12_steps={"worst_leaf": worst3, "bar": 1e-4, **rel3})

    # every launch and step counter of the port's kernels
    counters = [(cell2d.fused_rollout_2d, "launches"), (cell2d.fused_rollout_2d, "steps"),
                (cell2d.fused_rollout_2d, "launches_kxk"),
                (cell2d.fused_rollout_2d, "steps_kxk"),
                (cell2d.fused_rollout_final_2d, "launches"),
                (cell2d.fused_rollout_final_2d, "steps"),
                (cell2d.fused_rollout_final_2d, "launches_kxk"),
                (cell2d.fused_rollout_final_2d, "steps_kxk"),
                (cell2d.fused_rollout_kxk_2d, "launches"), (cell2d.fused_rollout_kxk_2d, "steps"),
                (cell3d.fused_rollout_3d, "launches"), (cell3d.fused_rollout_3d, "steps"),
                (backward3d.fused_rollout_tp_3d_pg, "launches"),
                (backward3d.fused_rollout_tp_3d_pg, "steps"),
                (backward2d.fused_rollout_tp_2d, "launches"),
                (backward2d.fused_rollout_tp_2d, "steps"),
                (backward2d.fused_phase1_2d, "launches"),
                (backward2d.fused_phase1_2d, "steps"),
                (backward2d.fused_phase1_ys_2d, "launches"),
                (backward2d.fused_phase1_ys_2d, "steps"),
                (backward3d.fused_phase1_3d, "launches"),
                (backward3d.fused_phase1_3d, "steps"),
                (backward2d.fused_rollout_tp_2d_pg, "launches"),
                (backward2d.fused_rollout_tp_2d_pg, "steps"),
                (batched2d.fused_rollout_2d_batched, "launches"),
                (batched2d.fused_rollout_2d_batched, "steps"),
                (batched2d.fused_rollout_2d_batched, "launches_kxk"),
                (batched2d.fused_rollout_2d_batched, "steps_kxk"),
                (batched2d.fused_phase1_2d_batched, "launches"),
                (batched2d.fused_phase1_2d_batched, "launches_kxk"),
                (batched2d.fused_phase1_2d_batched, "steps"),
                (batched2d.fused_phase1_pg_2d_batched, "launches"),
                (batched2d.fused_phase1_pg_2d_batched, "steps"),
                (sharded_step2d.step_haloed_2d, "launches"),
                (sharded_step2d.step_blocks_2d, "launches"),
                (sharded_step2d.rollout_blocks_2d, "launches")]

    def zero_counts():
        for obj, attr in counters:
            setattr(obj, attr, 0)

    def read_counts():
        return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in counters
                if getattr(obj, attr)}

    # kernels_kxk: the k x k forward at Burgers' full width (golden cell,
    # Burgers IC, T = 200): rollout2d_kxk_persistent_kernel (kxk_plan's route
    # at 100 x 100) and rollout2d_kxk_kernel (the per-step route) against the
    # plain version, and against each other at the same bar (3xTF32 on the
    # tensor cores against FFMA: not bitwise); then through the entry point
    # on a 17 x 9 field (the one-launch route) and on one past the plan's
    # capacity (1453 x 1453, the per-step route), launches and steps counted
    nb_grid = BURGERS_STAGE1.grid
    n_sm = cell2d._sm_count(dev)
    h0b = torch.as_tensor(default_ic("burgers", nb_grid), dtype=torch.float32, device=dev)
    wmatb = cell2d.pack_pi_matrix_2d(paramsb["cell"], cfgb).contiguous()
    tailb = cell2d.pi_tail_2d(paramsb["cell"], cfgb)
    check(cell2d.kxk_plan(nb_grid, nb_grid, cfgb, n_sm)["route"] == "persistent",
          f"kxk_plan at {nb_grid}: {cell2d.kxk_plan(nb_grid, nb_grid, cfgb, n_sm)}")
    got = cell2d._rollout_kxk_persistent_cuda(wmatb, tailb, h0b, cfgb, CHECK_KXK_STEPS)
    got_steps = cell2d._rollout_kxk_steps_cuda(wmatb, tailb, h0b, cfgb, CHECK_KXK_STEPS)
    want = cell2d.fused_rollout_kxk_2d_plain(wmatb, tailb, h0b, cfgb, CHECK_KXK_STEPS)
    torch.cuda.synchronize()
    err["rollout2d_kxk_persistent_kernel"] = max_abs(got, want)
    err["rollout2d_kxk_kernel"] = max_abs(got_steps, want)
    kxk_fwd_routes_err = max_abs(got, got_steps)
    for label, a, b in (("rollout2d_kxk_persistent_kernel vs plain", got, want),
                        ("rollout2d_kxk_kernel vs plain", got_steps, want),
                        ("rollout2d_kxk_persistent_kernel vs rollout2d_kxk_kernel", got,
                         got_steps)):
        check(allclose(a, b, rtol=2e-4, atol=1e-5), f"{label}: max |diff| {max_abs(a, b)}")
    del got_steps
    kxk_fwd_checks, kxk_steps_launches = {}, {}
    for shape, steps_, route in (((17, 9), 30, "persistent"), ((1453, 1453), 3, "per_step")):
        x = torch.as_tensor(0.5 * np.random.RandomState(5).standard_normal(shape + (2,)),
                            dtype=torch.float32, device=dev)
        plan = cell2d.kxk_plan(*shape, cfgb, n_sm)
        check(plan["route"] == route, f"kxk_plan at {shape}: {plan}, expected {route}")
        zero_counts()
        g_ = cell2d.fused_rollout_2d(paramsb["cell"], x, cfgb, steps_)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {"fused_rollout_kxk_2d.launches": 1 if route == "persistent" else steps_,
                       "fused_rollout_kxk_2d.steps": steps_}
        check(counts == want_counts, f"k x k rollout at {shape}: counts {counts}, "
                                     f"expected {want_counts}")
        w_ = cell2d.fused_rollout_kxk_2d_plain(wmatb, tailb, x, cfgb, steps_)
        torch.cuda.synchronize()
        kxk_fwd_checks[f"{shape[0]}x{shape[1]}"] = {"route": route, "steps": steps_,
                                                   "launches": counts, "plan": plan,
                                                   "max_abs_err": max_abs(g_, w_)}
        check(allclose(g_, w_, rtol=2e-4, atol=1e-5),
              f"k x k rollout at {shape} ({route}) vs plain: max |diff| {max_abs(g_, w_)}")
        if route == "per_step":
            kxk_steps_launches["kernels_kxk"] = counts["fused_rollout_kxk_2d.launches"]
        del g_, w_, x
    # row 2 at k = 5: final_plan takes the persistent kernel's final-state
    # mode at 100 x 100, one launch, the branch product in 3xTF32 as row 3's.
    # Over the 1200-step serving horizon from what serving rolls out, the
    # ISG's answer to a Burgers request: against plain (the tap-by-tap FFMA
    # final state) at the forward bar, and to the bit against the frames
    # route's last frame from the same h0 (the same arithmetic); then through
    # the entry point on 17 x 9 and past the plan's capacity (1453 x 1453,
    # final2d_kernel<5>), counted
    horizon = BURGERS_STAGE1.infer_steps
    requestb = add_noise(default_ic("burgers", nb_grid, seed=SEEDS[0])[None],
                         BURGERS_STAGE1.noise_pct, seed=SEEDS[0])[0][::isgb.scale, ::isgb.scale]
    with torch.inference_mode():
        h0s = isg_apply(paramsb["isg"], torch.as_tensor(requestb, dtype=torch.float32,
                                                        device=dev)[None], isgb)[0].contiguous()
    packedb = cell2d.pack_pi_params_2d(paramsb["cell"], cfgb)
    check(cell2d.final_plan(nb_grid, nb_grid, cfgb, n_sm)["route"] == "persistent",
          f"final_plan at {nb_grid}: {cell2d.final_plan(nb_grid, nb_grid, cfgb, n_sm)}")
    zero_counts()
    final5 = cell2d.fused_rollout_final_2d(paramsb["cell"], h0s, cfgb, horizon)
    torch.cuda.synchronize()
    final5_counts = read_counts()
    final5_want_counts = {"fused_rollout_final_2d.launches_kxk": 1,
                          "fused_rollout_final_2d.steps_kxk": horizon}
    check(final5_counts == final5_want_counts,
          f"k x k final state: counts {final5_counts}, expected {final5_want_counts}")
    final5_want = cell2d.fused_rollout_final_2d_plain(packedb, h0s, cfgb, horizon)
    final5_frame = cell2d._rollout_kxk_persistent_cuda(wmatb, tailb, h0s, cfgb, horizon)[-1]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(final5).all() and torch.isfinite(final5_want).all()),
          f"k x k final state over {horizon} steps: finite {bool(torch.isfinite(final5).all())}, "
          f"plain finite {bool(torch.isfinite(final5_want).all())}")
    err["rollout2d_kxk_persistent_kernel[final]"] = max_abs(final5, final5_want)
    check(allclose(final5, final5_want, rtol=2e-4, atol=1e-5),
          f"rollout2d_kxk_persistent_kernel[final] vs plain: max |diff| "
          f"{err['rollout2d_kxk_persistent_kernel[final]']}")
    final5_vs_frame = max_abs(final5, final5_frame)
    check(torch.equal(final5, final5_frame),
          f"rollout2d_kxk_persistent_kernel[final] vs the frames' last frame: max |diff| "
          f"{final5_vs_frame}")
    del final5_frame
    kxk_final_checks = {}
    for shape, steps_, route in (((17, 9), 30, "persistent"), ((1453, 1453), 3, "per_step")):
        x = torch.as_tensor(0.5 * np.random.RandomState(5).standard_normal(shape + (2,)),
                            dtype=torch.float32, device=dev)
        plan = cell2d.final_plan(*shape, cfgb, n_sm)
        check(plan["route"] == route, f"final_plan at {shape}: {plan}, expected {route}")
        zero_counts()
        f_ = cell2d.fused_rollout_final_2d(paramsb["cell"], x, cfgb, steps_)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {"fused_rollout_final_2d.launches_kxk":
                           1 if route == "persistent" else steps_,
                       "fused_rollout_final_2d.steps_kxk": steps_}
        check(counts == want_counts, f"k x k final state at {shape}: counts {counts}, "
                                     f"expected {want_counts}")
        w_ = cell2d.fused_rollout_final_2d_plain(packedb, x, cfgb, steps_)
        torch.cuda.synchronize()
        kxk_final_checks[f"{shape[0]}x{shape[1]}"] = {"route": route, "steps": steps_,
                                                     "launches": counts, "plan": plan,
                                                     "max_abs_err": max_abs(f_, w_)}
        check(allclose(f_, w_, rtol=2e-4, atol=1e-5),
              f"k x k final state at {shape} ({route}) vs plain: max |diff| {max_abs(f_, w_)}")
        if route == "per_step":
            final_steps_launches["kernels_kxk (1453 x 1453)"] = counts[
                "fused_rollout_final_2d.launches_kxk"]
        del f_, w_, x
    phase("kernels_kxk", shape=[nb_grid, nb_grid, 2], hidden=cfgb.hidden,
          kernel_size=cfgb.kernel_size, steps=CHECK_KXK_STEPS,
          max_abs_err={k: err[k] for k in ("rollout2d_kxk_persistent_kernel",
                                           "rollout2d_kxk_kernel")},
          persistent_vs_per_step_max_abs_err=kxk_fwd_routes_err,
          max_abs_frame=float(want.abs().max()), rtol=2e-4, atol=1e-5,
          route_checks=kxk_fwd_checks, final_steps=horizon,
          final_max_abs_err=err["rollout2d_kxk_persistent_kernel[final]"],
          final_counts=final5_counts, final_vs_last_frame_max_abs_err=final5_vs_frame,
          max_abs_final=float(final5_want.abs().max()), final_route_checks=kxk_final_checks)

    # grads_kxk: the k x k sweep on those frames (a standard-normal
    # cotangent): adj2d_kxk_persistent_kernel (kxk_adj_plan's route at
    # 100 x 100) and adj2d_kxk_kernel (the per-step route) against the plain
    # sweep and against each other, each output at the backward bar; both
    # routes through the wrapper on 17 x 9 and past the plan's capacity
    # (846 x 846), counted; and the fused k x k gradients against f64 autograd
    def sweep_leaf_errs(a_out, b_out):
        """Per output (g_ins, g0, ys): (max |diff| of a from b, max |b|)."""
        return {name: (max_abs(a, b), float(b.abs().max()))
                for name, a, b in zip(("g_ins", "g0", "ys"), a_out, b_out)}

    def hold_sweep(label, errs):
        for name, (e, scale) in errs.items():
            check(e <= 2e-4 * scale + 2e-6,
                  f"{label}, {name}: max |diff| {e} over 2e-4 * {scale} + 2e-6")

    fbarb = torch.as_tensor(np.random.RandomState(4).standard_normal(tuple(got.shape)),
                            dtype=torch.float32, device=dev)
    check(backward2d.kxk_adj_plan(nb_grid, nb_grid, cfgb, n_sm)["route"] == "persistent",
          f"kxk_adj_plan at {nb_grid}: {backward2d.kxk_adj_plan(nb_grid, nb_grid, cfgb, n_sm)}")
    out_k = backward2d._phase1_kxk_persistent_cuda(wmatb, tailb, got, fbarb, cfgb)
    out_s = backward2d._phase1_kxk_steps_cuda(wmatb, tailb, got, fbarb, cfgb)
    out_p = backward2d.fused_phase1_kxk_2d_plain(wmatb, tailb, got, fbarb, cfgb)
    torch.cuda.synchronize()
    kxk_err = sweep_leaf_errs(out_k, out_p)
    kxk_steps_err = sweep_leaf_errs(out_s, out_p)
    kxk_routes_err = sweep_leaf_errs(out_k, out_s)
    hold_sweep("adj2d_kxk_persistent_kernel vs plain", kxk_err)
    hold_sweep("adj2d_kxk_kernel vs plain", kxk_steps_err)
    hold_sweep("adj2d_kxk_persistent_kernel vs adj2d_kxk_kernel", kxk_routes_err)
    err["adj2d_kxk_persistent_kernel"] = max(e for e, _ in kxk_err.values())
    err["adj2d_kxk_kernel"] = max(e for e, _ in kxk_steps_err.values())
    del got, want, out_k, out_s, out_p
    kxk_adj_checks = {}
    for shape, steps_, route in (((17, 9), 30, "persistent"), ((846, 846), 3, "per_step")):
        x = torch.as_tensor(0.5 * np.random.RandomState(5).standard_normal(shape + (2,)),
                            dtype=torch.float32, device=dev)
        plan = backward2d.kxk_adj_plan(*shape, cfgb, n_sm)
        check(plan["route"] == route, f"kxk_adj_plan at {shape}: {plan}, expected {route}")
        fr_ = cell2d._rollout_kxk_cuda(wmatb, tailb, x, cfgb, steps_)
        fb_ = torch.as_tensor(np.random.RandomState(6).standard_normal(tuple(fr_.shape)),
                              dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        zero_counts()
        a_out = backward2d.fused_phase1_kxk_2d(wmatb, tailb, fr_, fb_, cfgb)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {"fused_rollout_tp_2d.launches": 1 if route == "persistent" else 2 * steps_,
                       "fused_rollout_tp_2d.steps": steps_}
        check(counts == want_counts, f"k x k sweep at {shape}: counts {counts}, "
                                     f"expected {want_counts}")
        errs = sweep_leaf_errs(a_out, backward2d.fused_phase1_kxk_2d_plain(wmatb, tailb, fr_,
                                                                           fb_, cfgb))
        hold_sweep(f"k x k sweep at {shape} ({route}) vs plain", errs)
        kxk_adj_checks[f"{shape[0]}x{shape[1]}"] = {
            "route": route, "steps": steps_, "launches": counts, "plan": plan,
            "err_and_max": {k: list(v) for k, v in errs.items()}}
        if route == "per_step":
            kxk_steps_launches["grads_kxk"] = counts["fused_rollout_tp_2d.launches"]
        del x, fr_, fb_, a_out
    # the measure of the gradient referee at Burgers' shape: random-init
    # cell, random target, 12 steps, 100 x 100, held to 1e-4
    rngb = np.random.RandomState(5)
    refb_cell = params_to_numpy(init_pi_cell(torch.Generator().manual_seed(0), cfgb,
                                             device="cpu"))
    xb_ref = torch.as_tensor(0.5 * rngb.standard_normal((nb_grid,) * 2 + (2,)),
                             dtype=torch.float32, device=dev)
    tgtb = torch.as_tensor(rngb.standard_normal((13,) + tuple(xb_ref.shape)), device=dev)
    zero_counts()
    relb = rel_errs_vs_f64(refb_cell, xb_ref, 12,
                           lambda fr: ((fr - tgtb.to(fr.dtype)) ** 2).mean(), cfg=cfgb,
                           routes={"fused": backward2d.fused_rollout_tp_2d})
    torch.cuda.synchronize()
    relb_counts = read_counts()
    relb_want = {"fused_rollout_kxk_2d.launches": 1, "fused_rollout_kxk_2d.steps": 12,
                 "fused_rollout_tp_2d.launches": 1, "fused_rollout_tp_2d.steps": 12}
    check(relb_counts == relb_want,
          f"fused k x k gradients: counts {relb_counts}, expected {relb_want}")
    worstb = {kind: max(v, key=v.get) for kind, v in relb.items()}
    check(relb["fused"][worstb["fused"]] <= 1e-4,
          f"fused k x k gradients vs f64 autograd: {worstb['fused']} at "
          f"{relb['fused'][worstb['fused']]} over 1e-4")
    # remat through the k x k cell, whose branch-weight gradients are the
    # FFMA matmul of ops/convs.py's _Conv2d (cuDNN's weight-grad
    # convolution measured 2.2e-4 here, ROADMAP.md C2)
    check(relb["autograd_f32"][worstb["autograd_f32"]] <= 1e-4,
          f"remat k x k gradients vs f64 autograd: {worstb['autograd_f32']} at "
          f"{relb['autograd_f32'][worstb['autograd_f32']]} over 1e-4")
    phase("grads_kxk", shape=[nb_grid, nb_grid, 2], steps=CHECK_KXK_STEPS,
          cotangent="standard normal, seed 4",
          adj_persistent_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                    in kxk_err.items()},
          adj_per_step_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                  in kxk_steps_err.items()},
          persistent_vs_per_step_err_and_max_leaf={k: [e, sc] for k, (e, sc)
                                                   in kxk_routes_err.items()},
          adj_bar="2e-4 * max|leaf| + 2e-6", route_checks=kxk_adj_checks,
          f64_random_cell_12_steps={"worst_leaf": worstb, "bar": 1e-4, "launches": relb_counts,
                                    **relb})

    # kernels_fallback: the fallback slice's kernels at full width against
    # their plain versions
    def sweep_errs(name, got_, want_):
        """(max |diff|, max |plain|) of g_ins and g0, each held to the
        backward bar 2e-4 * max|plain| + 2e-6."""
        out = {}
        for key, a, b in zip(("g_ins", "g0"), got_, want_):
            e, scale = max_abs(a, b), float(b.abs().max())
            check(e <= 2e-4 * scale + 2e-6,
                  f"{name} vs plain, {key}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
            out[key] = [e, scale]
        err[name] = max(e for e, _ in out.values())
        return out

    @contextlib.contextmanager
    def switches(fwd, bwd, ys):
        """cell2d.MXU_FWD_ENABLED, backward2d.MXU_BWD_ENABLED and
        backward2d.YS_PATH_ENABLED for the forward and the backward inside."""
        saved = (cell2d.MXU_FWD_ENABLED, backward2d.MXU_BWD_ENABLED, backward2d.YS_PATH_ENABLED)
        cell2d.MXU_FWD_ENABLED, backward2d.MXU_BWD_ENABLED, backward2d.YS_PATH_ENABLED = (
            fwd, bwd, ys)
        try:
            yield
        finally:
            (cell2d.MXU_FWD_ENABLED, backward2d.MXU_BWD_ENABLED,
             backward2d.YS_PATH_ENABLED) = saved

    # the MXU-off route of the 5x5 cell (PERCNN_DISABLE_MXU=1's) on the golden
    # Burgers cell.  Frames from the Burgers IC (as rollout2d_kxk_kernel's
    # check) by rollout2d_ffma_persistent_kernel (ffma_plan's route at
    # 100 x 100) and rollout2d_kernel<5> (the per-step route), against the
    # plain version and each other (another summation order: not bitwise)
    check(cell2d.ffma_plan(nb_grid, nb_grid, cfgb, n_sm)["route"] == "persistent",
          f"ffma_plan at {nb_grid}: {cell2d.ffma_plan(nb_grid, nb_grid, cfgb, n_sm)}")
    framesb = cell2d._rollout_ffma_persistent_cuda(packedb, h0b, cfgb, CHECK_KXK_STEPS)
    framesb_steps = cell2d._rollout_steps_cuda(packedb, h0b, cfgb, CHECK_KXK_STEPS)
    want = cell2d.fused_rollout_2d_plain(packedb, h0b, cfgb, CHECK_KXK_STEPS)
    torch.cuda.synchronize()
    err["rollout2d_ffma_persistent_kernel"] = max_abs(framesb, want)
    err["rollout2d_kernel[k=5]"] = max_abs(framesb_steps, want)
    ffma_routes_err = max_abs(framesb, framesb_steps)
    ffma_routes_equal = bool(torch.equal(framesb, framesb_steps))
    for label, a, b in (("rollout2d_ffma_persistent_kernel vs plain", framesb, want),
                        ("rollout2d_kernel k = 5 vs plain", framesb_steps, want),
                        ("rollout2d_ffma_persistent_kernel vs rollout2d_kernel k = 5", framesb,
                         framesb_steps)):
        check(allclose(a, b, rtol=2e-4, atol=1e-5), f"{label}: max |diff| {max_abs(a, b)}")
    del framesb_steps, want
    # the final state over the serving horizon from kernels_kxk's h0 (the
    # ISG's answer to a Burgers request) through the entry point with the MXU
    # switch off: one launch of the FFMA kernel's final-state mode, against
    # plain and, to the bit, the frames route's last frame from the same h0;
    # final2d_kernel<5> (the route past the plan) against plain on that input
    check(cell2d.final_plan(nb_grid, nb_grid, cfgb, n_sm, mxu=False)["route"] == "persistent",
          "final_plan with the MXU switch off takes no one-launch route at "
          f"{nb_grid}: {cell2d.final_plan(nb_grid, nb_grid, cfgb, n_sm, mxu=False)}")
    zero_counts()
    with switches(False, False, True):
        final5 = cell2d.fused_rollout_final_2d(paramsb["cell"], h0s, cfgb, horizon)
    torch.cuda.synchronize()
    final5_off_counts = read_counts()
    check(final5_off_counts == {"fused_rollout_final_2d.launches_kxk": 1,
                                "fused_rollout_final_2d.steps_kxk": horizon},
          f"k = 5 final state with the MXU switch off: counts {final5_off_counts}")
    final5_frame = cell2d._rollout_ffma_persistent_cuda(packedb, h0s, cfgb, horizon)[-1]
    final5_steps = cell2d._final_steps_cuda(packedb, h0s, cfgb, horizon)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(final5).all() and torch.isfinite(final5_steps).all()),
          f"k = 5 final states over {horizon} steps with the MXU switch off: finite "
          f"{bool(torch.isfinite(final5).all())}, {bool(torch.isfinite(final5_steps).all())}")
    err["rollout2d_ffma_persistent_kernel[final]"] = max_abs(final5, final5_want)
    err["final2d_kernel[k=5]"] = max_abs(final5_steps, final5_want)
    check(allclose(final5, final5_want, rtol=2e-4, atol=1e-5),
          f"rollout2d_ffma_persistent_kernel[final] vs plain: max |diff| "
          f"{err['rollout2d_ffma_persistent_kernel[final]']}")
    check(allclose(final5_steps, final5_want, rtol=2e-4, atol=1e-5),
          f"final2d_kernel k = 5 vs plain: max |diff| {err['final2d_kernel[k=5]']}")
    final5_off_vs_frame = max_abs(final5, final5_frame)
    check(torch.equal(final5, final5_frame),
          f"rollout2d_ffma_persistent_kernel[final] vs the frames' last frame: max |diff| "
          f"{final5_off_vs_frame}")
    del final5_frame, final5_steps
    # the ys sweep on those frames, a standard-normal cotangent (as
    # adj2d_kxk_kernel's check): adj2d_ys_persistent_kernel (ys_plan's route
    # at 100 x 100) and adj2d_ys_kernel against the plain sweep and each
    # other; adj2d_kernel at k = 5 against its plain sweep
    fbarb = torch.as_tensor(np.random.RandomState(4).standard_normal(tuple(framesb.shape)),
                            dtype=torch.float32, device=dev)
    ysb = backward2d._precompute_ys(paramsb["cell"], framesb[:-1], cfgb)
    check(backward2d.ys_plan(nb_grid, nb_grid, cfgb, n_sm)["route"] == "persistent",
          f"ys_plan at {nb_grid}: {backward2d.ys_plan(nb_grid, nb_grid, cfgb, n_sm)}")
    ys_plain = backward2d.fused_phase1_ys_2d_plain(packedb, fbarb, ysb, cfgb)
    ys_one = backward2d._phase1_ys_persistent_cuda(packedb, fbarb, ysb, cfgb)
    ys_steps = backward2d._phase1_ys_steps_cuda(packedb, fbarb, ysb, cfgb)
    # row 4 at k = 5 on the same frames and cotangent:
    # adj2d_batched_ffma_persistent_kernel on a one-member batch (adj_b_plan's
    # route at M = 1 and 100 x 100, through backward2d's wrapper) and
    # adj2d_kernel's pair (the per-step route) against the plain sweep and
    # each other; the wrapper's outputs against the ensemble wrapper's on
    # the one-member batch, to the bit (the same kernel on the same operands)
    plan4k = backward2d.adj_b_plan(1, nb_grid, nb_grid, cfgb, n_sm)
    check(plan4k["route"] == "persistent", f"adj_b_plan at M = 1, {nb_grid}: {plan4k}")
    adjk_plain = backward2d.fused_phase1_2d_plain(packedb, framesb, fbarb, cfgb)
    adjk_one = backward2d._phase1_ffma_cuda(packedb, framesb, fbarb, cfgb)
    adjk_steps = backward2d._phase1_steps_cuda(packedb, framesb, fbarb, cfgb)
    adjk_b1 = batched2d._phase1_b_ffma_persistent_cuda(
        packedb[None].contiguous(), framesb[None].contiguous(), fbarb[None].contiguous(), cfgb)
    torch.cuda.synchronize()
    fallback_errs = {
        "adj2d_ys_persistent_kernel": sweep_errs("adj2d_ys_persistent_kernel", ys_one, ys_plain),
        "adj2d_ys_kernel": sweep_errs("adj2d_ys_kernel", ys_steps, ys_plain),
        "adj2d_batched_ffma_persistent_kernel[M=1]": sweep_errs("adj2d_batched_ffma_persistent_kernel[M=1]", adjk_one, adjk_plain),
        "adj2d_kernel[k=5]": sweep_errs("adj2d_kernel[k=5]", adjk_steps, adjk_plain),
    }
    ys_routes_err, adjk_routes_err = {}, {}
    for label, errs_, one_, steps_ in (("adj2d_ys_persistent_kernel vs adj2d_ys_kernel",
                                        ys_routes_err, ys_one, ys_steps),
                                       ("adj2d_batched_ffma_persistent_kernel[M=1] vs adj2d_kernel k = 5",
                                        adjk_routes_err, adjk_one, adjk_steps)):
        for key, a, b in zip(("g_ins", "g0"), one_, steps_):
            e, scale = max_abs(a, b), float(b.abs().max())
            check(e <= 2e-4 * scale + 2e-6, f"{label}, {key}: max |diff| {e} over 2e-4 * "
                                            f"{scale} + 2e-6")
            errs_[key] = [e, scale]
    adjk_vs_batched = {key: max_abs(a, b[0]) for key, a, b in zip(("g_ins", "g0"), adjk_one,
                                                                   adjk_b1)}
    check(all(torch.equal(a, b[0]) for a, b in zip(adjk_one, adjk_b1)),
          "the single model's k x k sweep vs the ensemble's at M = 1: max "
          f"|diff| {adjk_vs_batched}")
    del ysb, ys_plain, ys_one, ys_steps, adjk_plain, adjk_one, adjk_steps, adjk_b1
    # each MXU-off route through its entry point on 17 x 9 (the one-launch
    # kernels) and past its plan (1407 x 1407 forward and final state,
    # 149 x 149 sweep: the per-step kernels), launches and steps counted,
    # against plain
    ffma_route_checks, ffma_steps_launches = {}, {}
    ffma_final_launches = {"kernels_fallback (100 x 100, 1200 steps)":
                           final5_off_counts["fused_rollout_final_2d.launches_kxk"]}
    for call, shape, steps_, route in (
            ("frames", (17, 9), 30, "persistent"), ("frames", (1407, 1407), 3, "per_step"),
            ("final", (17, 9), 30, "persistent"), ("final", (1407, 1407), 3, "per_step"),
            ("ys", (17, 9), 30, "persistent"), ("ys", (149, 149), 3, "per_step")):
        x = torch.as_tensor(0.5 * np.random.RandomState(5).standard_normal(shape + (2,)),
                            dtype=torch.float32, device=dev)
        where = f"kernels_fallback ({shape[0]} x {shape[1]})"
        if call == "ys":
            plan = backward2d.ys_plan(*shape, cfgb, n_sm)
            fr_ = cell2d._rollout_cuda(packedb, x, cfgb, steps_)
            fb_ = torch.as_tensor(np.random.RandomState(6).standard_normal(tuple(fr_.shape)),
                                  dtype=torch.float32, device=dev)
            ys_ = backward2d._precompute_ys(paramsb["cell"], fr_[:-1], cfgb)
            torch.cuda.synchronize()
            zero_counts()
            got_ = backward2d.fused_phase1_ys_2d(packedb, fb_, ys_, cfgb)
            torch.cuda.synchronize()
            counts = read_counts()
            want_counts = {"fused_phase1_ys_2d.launches": 1 if route == "persistent" else 2 * steps_,
                           "fused_phase1_ys_2d.steps": steps_}
            errs = {}
            for key, a, b in zip(("g_ins", "g0"), got_,
                                 backward2d.fused_phase1_ys_2d_plain(packedb, fb_, ys_, cfgb)):
                errs[key] = [max_abs(a, b), float(b.abs().max())]
                check(errs[key][0] <= 2e-4 * errs[key][1] + 2e-6,
                      f"ys sweep at {shape} ({route}) vs plain, {key}: {errs[key]}")
            del fr_, fb_, ys_
            if route == "per_step":
                ffma_steps_launches["adj2d_ys_kernel"] = {where: counts["fused_phase1_ys_2d.launches"]}
        else:
            plan = (cell2d.ffma_plan(*shape, cfgb, n_sm) if call == "frames"
                    else cell2d.final_plan(*shape, cfgb, n_sm, mxu=False))
            fn_, plain_ = ((cell2d.fused_rollout_2d, cell2d.fused_rollout_2d_plain)
                           if call == "frames" else
                           (cell2d.fused_rollout_final_2d, cell2d.fused_rollout_final_2d_plain))
            counter = "fused_rollout_2d" if call == "frames" else "fused_rollout_final_2d"
            zero_counts()
            with switches(False, False, True):
                got_ = fn_(paramsb["cell"], x, cfgb, steps_)
            torch.cuda.synchronize()
            counts = read_counts()
            want_counts = {f"{counter}.launches_kxk": 1 if route == "persistent" else steps_,
                           f"{counter}.steps_kxk": steps_}
            w_ = plain_(packedb, x, cfgb, steps_)
            torch.cuda.synchronize()
            errs = max_abs(got_, w_)
            check(allclose(got_, w_, rtol=2e-4, atol=1e-5),
                  f"MXU-off {call} at {shape} ({route}) vs plain: max |diff| {errs}")
            del w_
            if route == "per_step":
                if call == "frames":
                    ffma_steps_launches["rollout2d_kernel[k=5]"] = {
                        where: counts["fused_rollout_2d.launches_kxk"]}
                else:
                    final_steps_launches[where] = counts["fused_rollout_final_2d.launches_kxk"]
            elif call == "final":
                ffma_final_launches[where] = counts["fused_rollout_final_2d.launches_kxk"]
        check(plan["route"] == route, f"{call} plan at {shape}: {plan}, expected {route}")
        check(counts == want_counts, f"MXU-off {call} at {shape}: counts {counts}, "
                                     f"expected {want_counts}")
        ffma_route_checks[f"{call} {shape[0]}x{shape[1]}"] = {
            "route": route, "steps": steps_, "launches": counts, "plan": plan, "err": errs}
        del x, got_
    # row 4 at k = 1 on the golden GS2D cell, the data-loss cotangent:
    # adj2d_persistent_kernel (adj_plan's route at 100 x 100) and adj2d_kernel
    # (the per-step route) against plain and each other; g0 against
    # pg2d_persistent_kernel's on the same inputs, to the bit (the same
    # passes, without the accumulators)
    check(backward2d.adj_plan(*h0.shape[:2], cfg, n_sm)["route"] == "persistent",
          f"adj_plan at {h0.shape[0]}: {backward2d.adj_plan(*h0.shape[:2], cfg, n_sm)}")
    frames1 = cell2d._rollout_cuda(packed, h0, cfg, CHECK_STEPS)
    fbar1 = cotangent(frames1)[1].contiguous()
    plain1 = backward2d.fused_phase1_2d_plain(packed, frames1, fbar1, cfg)
    adj_one = backward2d._phase1_persistent_cuda(packed, frames1, fbar1, cfg)
    adj_steps = backward2d._phase1_steps_cuda(packed, frames1, fbar1, cfg)
    g0_pg1 = backward2d._pg_persistent_cuda(packed, frames1, fbar1, cfg)[0]
    torch.cuda.synchronize()
    fallback_errs["adj2d_persistent_kernel"] = sweep_errs("adj2d_persistent_kernel", adj_one,
                                                          plain1)
    fallback_errs["adj2d_kernel"] = sweep_errs("adj2d_kernel", adj_steps, plain1)
    adj_routes_err = {}
    for key, a, b in zip(("g_ins", "g0"), adj_one, adj_steps):
        e, scale = max_abs(a, b), float(b.abs().max())
        check(e <= 2e-4 * scale + 2e-6, f"adj2d_persistent_kernel vs adj2d_kernel, {key}: "
                                        f"max |diff| {e} over 2e-4 * {scale} + 2e-6")
        adj_routes_err[key] = [e, scale]
    adj_g0_vs_pg = max_abs(adj_one[1], g0_pg1)
    check(torch.equal(adj_one[1], g0_pg1),
          f"adj2d_persistent_kernel's g0 vs pg2d_persistent_kernel's: max |diff| {adj_g0_vs_pg}")
    del plain1, adj_one, adj_steps, g0_pg1
    # through the entry point on 17 x 9 (the one-launch route; g0 again
    # against pg2d_persistent_kernel's to the bit) and past adj_plan
    # (449 x 449: one adj2d_kernel launch a step), a random field and
    # cotangent, launches and steps counted, against plain
    adj_route_checks, adj_steps_launches, adjk_steps_launches = {}, {}, {}
    for shape, steps_, route in (((17, 9), 30, "persistent"), ((449, 449), 3, "per_step")):
        rs = np.random.RandomState(8)
        x = torch.as_tensor(0.5 + 0.1 * rs.standard_normal(shape + (2,)), dtype=torch.float32,
                            device=dev)
        fr_ = cell2d._rollout_cuda(packed, x, cfg, steps_)
        fb_ = torch.as_tensor(rs.standard_normal(tuple(fr_.shape)), dtype=torch.float32,
                              device=dev)
        plan = backward2d.adj_plan(*shape, cfg, n_sm)
        zero_counts()
        got_ = backward2d.fused_phase1_2d(packed, fr_, fb_, cfg)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {"fused_phase1_2d.launches": 1 if route == "persistent" else steps_,
                       "fused_phase1_2d.steps": steps_}
        check(plan["route"] == route, f"adj_plan at {shape}: {plan}, expected {route}")
        check(counts == want_counts, f"1x1 sweep at {shape}: counts {counts}, expected "
                                     f"{want_counts}")
        errs = {}
        for key, a, b in zip(("g_ins", "g0"), got_,
                             backward2d.fused_phase1_2d_plain(packed, fr_, fb_, cfg)):
            errs[key] = [max_abs(a, b), float(b.abs().max())]
            check(errs[key][0] <= 2e-4 * errs[key][1] + 2e-6,
                  f"1x1 sweep at {shape} ({route}) vs plain, {key}: {errs[key]}")
        if route == "persistent":
            g0_pg_ = backward2d._pg_persistent_cuda(packed, fr_, fb_, cfg)[0]
            check(torch.equal(got_[1], g0_pg_),
                  f"adj2d_persistent_kernel's g0 at {shape} vs pg2d_persistent_kernel's: "
                  f"max |diff| {max_abs(got_[1], g0_pg_)}")
        else:
            adj_steps_launches[f"kernels_fallback ({shape[0]} x {shape[1]})"] = counts[
                "fused_phase1_2d.launches"]
        adj_route_checks[f"{shape[0]}x{shape[1]}"] = {"route": route, "steps": steps_,
                                                      "launches": counts, "plan": plan,
                                                      "err": errs}
        del x, fr_, fb_, got_
    # row 4 at k = 5 through the entry point on 17 x 9 (the one-launch
    # route; its outputs again against the one-member batched kernel's to the
    # bit) and past adj_b_plan at M = 1 (769 x 769: two launches a step), members
    # of the golden Burgers cell, a random field and cotangent, launches and
    # steps counted, against plain
    for shape, steps_, route in (((17, 9), 30, "persistent"), ((769, 769), 1, "per_step")):
        rs = np.random.RandomState(14)
        x = torch.as_tensor(0.5 * rs.standard_normal(shape + (2,)), dtype=torch.float32,
                            device=dev)
        fr_ = cell2d._rollout_cuda(packedb, x, cfgb, steps_)
        fb_ = torch.as_tensor(rs.standard_normal(tuple(fr_.shape)), dtype=torch.float32,
                              device=dev)
        plan = backward2d.adj_b_plan(1, *shape, cfgb, n_sm)
        zero_counts()
        got_ = backward2d.fused_phase1_2d(packedb, fr_, fb_, cfgb)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {"fused_phase1_2d.launches": 1 if route == "persistent" else 2 * steps_,
                       "fused_phase1_2d.steps": steps_}
        check(plan["route"] == route, f"adj_b_plan at M = 1, {shape}: {plan}, expected {route}")
        check(counts == want_counts, f"k = 5 sweep at {shape}: counts {counts}, expected "
                                     f"{want_counts}")
        errs = {}
        for key, a, b in zip(("g_ins", "g0"), got_,
                             backward2d.fused_phase1_2d_plain(packedb, fr_, fb_, cfgb)):
            errs[key] = [max_abs(a, b), float(b.abs().max())]
            check(errs[key][0] <= 2e-4 * errs[key][1] + 2e-6,
                  f"k = 5 sweep at {shape} ({route}) vs plain, {key}: {errs[key]}")
        if route == "persistent":
            b1_ = batched2d._phase1_b_ffma_persistent_cuda(
                packedb[None].contiguous(), fr_[None].contiguous(), fb_[None].contiguous(), cfgb)
            check(all(torch.equal(a, b[0]) for a, b in zip(got_, b1_)),
                  f"the single model's k x k sweep at {shape} vs the ensemble's at M = 1")
        else:
            adjk_steps_launches[f"kernels_fallback ({shape[0]} x {shape[1]})"] = counts[
                "fused_phase1_2d.launches"]
        adj_route_checks[f"k=5 {shape[0]}x{shape[1]}"] = {"route": route, "steps": steps_,
                                                          "launches": counts, "plan": plan,
                                                          "err": errs}
        del x, fr_, fb_, got_
    # row 9 on the golden GS3D cell at 48^3, T = 50, a standard-normal
    # cotangent (as row 10's check): adj3d_persistent_kernel (adj3d_plan's
    # route) and adj3d_kernel (the per-step route) against plain and each
    # other, the one-launch g0 against pg3d_persistent_kernel's on the same
    # inputs to the bit (the same body, with and without accumulators); then
    # the entry point within the plan and past it (52^3: adj3d_kernel),
    # launches and steps counted
    frames3 = cell3d._rollout_cuda(expanded3, h03, PG3D_CHECK_STEPS)
    fbar3 = torch.as_tensor(np.random.RandomState(3).standard_normal(tuple(frames3.shape)),
                            dtype=torch.float32, device=dev)
    check(backward3d.adj3d_plan(n3, n3, n3, cfg3, n_sm)["route"] == "persistent",
          f"adj3d_plan at {n3}^3: {backward3d.adj3d_plan(n3, n3, n3, cfg3, n_sm)}")
    adj3_one = backward3d._phase1_persistent_cuda(packed3, frames3, fbar3, cfg3)
    adj3_steps = backward3d._phase1_steps_cuda(packed3, frames3, fbar3, cfg3)
    plain3 = backward3d.fused_phase1_3d_plain(packed3, frames3, fbar3, cfg3)
    g0_pg3 = backward3d._pg_persistent_cuda(packed3, frames3, fbar3, cfg3)[0]
    torch.cuda.synchronize()
    fallback_errs["adj3d_persistent_kernel"] = sweep_errs("adj3d_persistent_kernel", adj3_one,
                                                          plain3)
    fallback_errs["adj3d_kernel"] = sweep_errs("adj3d_kernel", adj3_steps, plain3)
    adj3_routes_err = {}
    for key, a, b in zip(("g_ins", "g0"), adj3_one, adj3_steps):
        e, scale = max_abs(a, b), float(b.abs().max())
        check(e <= 2e-4 * scale + 2e-6, f"adj3d_persistent_kernel vs adj3d_kernel, {key}: "
                                        f"max |diff| {e} over 2e-4 * {scale} + 2e-6")
        adj3_routes_err[key] = [e, scale]
    adj3_g0_vs_pg = max_abs(adj3_one[1], g0_pg3)
    check(torch.equal(adj3_one[1], g0_pg3),
          f"adj3d_persistent_kernel's g0 vs pg3d_persistent_kernel's: max |diff| {adj3_g0_vs_pg}")
    del adj3_one, adj3_steps, plain3, g0_pg3
    adj3_steps_launches, adj3_route_checks = {}, {}
    for label, n_, steps_, route in (("48^3", n3, 4, "persistent"), ("52^3", 52, 3, "per_step")):
        h0_ = h03 if n_ == n3 else torch.as_tensor(default_ic("gray_scott_3d", n_),
                                                   dtype=torch.float32, device=dev)
        fr_ = cell3d._rollout_cuda(expanded3, h0_, steps_)
        fb_ = torch.as_tensor(np.random.RandomState(6).standard_normal(tuple(fr_.shape)),
                              dtype=torch.float32, device=dev)
        plan = backward3d.adj3d_plan(n_, n_, n_, cfg3, n_sm)
        zero_counts()
        got_ = backward3d.fused_phase1_3d(packed3, fr_, fb_, cfg3)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {"fused_phase1_3d.launches": 1 if route == "persistent" else steps_,
                       "fused_phase1_3d.steps": steps_}
        check(plan["route"] == route and counts == want_counts,
              f"GS3D streaming sweep at {label}: plan {plan}, counts {counts}, expected "
              f"{route}, {want_counts}")
        errs = {}
        for key, a, b in zip(("g_ins", "g0"), got_,
                             backward3d.fused_phase1_3d_plain(packed3, fr_, fb_, cfg3)):
            errs[key] = [max_abs(a, b), float(b.abs().max())]
            check(errs[key][0] <= 2e-4 * errs[key][1] + 2e-6,
                  f"GS3D streaming sweep at {label} ({route}) vs plain, {key}: {errs[key]}")
        if route == "per_step":
            adj3_steps_launches[f"kernels_fallback ({label})"] = counts["fused_phase1_3d.launches"]
        adj3_route_checks[label] = {"route": route, "steps": steps_, "launches": counts,
                                    "plan": plan, "err": errs}
        del h0_, fr_, fb_, got_
    del frames1, frames3, fbar1, fbar3
    phase("kernels_fallback", burgers_steps=CHECK_KXK_STEPS,
          burgers_final_steps=horizon, burgers_final_counts=final5_off_counts,
          gs2d_steps=CHECK_STEPS,
          gs3d_steps=PG3D_CHECK_STEPS, shape3d=[n3, n3, n3, 2],
          forward_max_abs_err={k: err[k] for k in (
              "rollout2d_ffma_persistent_kernel", "rollout2d_kernel[k=5]",
              "rollout2d_ffma_persistent_kernel[final]", "final2d_kernel[k=5]")},
          ffma_vs_per_step_max_abs_err=ffma_routes_err,
          ffma_vs_per_step_equal_bits=ffma_routes_equal,
          final_vs_last_frame_max_abs_err=final5_off_vs_frame,
          ys_persistent_vs_per_step_err_and_max=ys_routes_err, route_checks=ffma_route_checks,
          adj_persistent_vs_per_step_err_and_max=adj_routes_err,
          adj_ffma_persistent_vs_per_step_err_and_max=adjk_routes_err,
          adj_ffma_vs_batched_m1_max_abs_diff=adjk_vs_batched,
          adj_g0_vs_pg2d_persistent_max_abs_diff=adj_g0_vs_pg, adj_route_checks=adj_route_checks,
          adj3d_persistent_vs_per_step_err_and_max=adj3_routes_err,
          adj3d_g0_vs_pg3d_persistent_max_abs_diff=adj3_g0_vs_pg,
          adj3d_route_checks=adj3_route_checks,
          forward_rtol=2e-4, forward_atol=1e-5,
          cotangents={"Burgers": "standard normal, seed 4", "GS2D": "data loss",
                      "GS3D": "standard normal, seed 3"},
          sweep_err_and_max={k: v for k, v in fallback_errs.items()},
          sweep_bar="2e-4 * max|plain| + 2e-6")

    # grads_fallback: each new route's gradients against f64 autograd on the
    # referee setup, with the launches of each route counted
    def two_phase(p, x, cfg_, steps):
        return rollout_tp(runner._cell_step_for(cfg_), p, x, steps)

    referee = {}

    def hold_to_f64(label, want_counts, cell_np, x0, loss, cfg_, routes, flags=(True, True, True)):
        zero_counts()
        with switches(*flags):
            rel = rel_errs_vs_f64(cell_np, x0, 12, loss, cfg=cfg_, routes=routes)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == want_counts, f"{label}: launch counts {counts}, expected {want_counts}")
        for kind in routes:
            worst = max(rel[kind], key=rel[kind].get)
            check(rel[kind][worst] <= 1e-4, f"{label} {kind} gradients vs f64 autograd: "
                                            f"{worst} at {rel[kind][worst]} over 1e-4")
        referee[label] = {"launches": counts, "switches": flags,
                          **{kind: rel[kind] for kind in routes}}

    # one rollout2d_cluster_kernel launch of 12 steps, then one
    # adj2d_persistent_kernel launch of 12
    hold_to_f64("gs2d", {"fused_rollout_2d.launches": 1, "fused_rollout_2d.steps": 12,
                         "fused_phase1_2d.launches": 1, "fused_phase1_2d.steps": 12},
                ref_cell, x_ref, lambda fr: ((fr - tgt.to(fr.dtype)) ** 2).mean(), cfg,
                {"fused": backward2d.fused_rollout_tp_2d, "two_phase": two_phase})
    # one rollout3d_persistent_kernel launch of 12 steps, then one
    # adj3d_persistent_kernel launch of 12
    hold_to_f64("gs3d", {"fused_rollout_3d.launches": 1, "fused_rollout_3d.steps": 12,
                         "fused_phase1_3d.launches": 1, "fused_phase1_3d.steps": 12},
                ref3_cell, x3_ref, lambda fr: ((fr - tgt3.to(fr.dtype)) ** 2).mean(), cfg3,
                {"fused": backward3d.fused_rollout_tp_3d, "two_phase": two_phase})
    lossb = lambda fr: ((fr - tgtb.to(fr.dtype)) ** 2).mean()   # noqa: E731
    hold_to_f64("burgers_mxu_off", {"fused_rollout_2d.launches_kxk": 1,
                                    "fused_rollout_2d.steps_kxk": 12,
                                    "fused_phase1_ys_2d.launches": 1,
                                    "fused_phase1_ys_2d.steps": 12},
                refb_cell, xb_ref, lossb, cfgb, {"fused": backward2d.fused_rollout_tp_2d},
                flags=(False, False, True))
    # one rollout2d_ffma_persistent_kernel launch of 12 steps, then one
    # adj2d_batched_ffma_persistent_kernel launch of 12 on a one-member batch
    hold_to_f64("burgers_ys_off", {"fused_rollout_2d.launches_kxk": 1,
                                   "fused_rollout_2d.steps_kxk": 12,
                                   "fused_phase1_2d.launches": 1,
                                   "fused_phase1_2d.steps": 12},
                refb_cell, xb_ref, lossb, cfgb, {"fused": backward2d.fused_rollout_tp_2d},
                flags=(False, False, False))
    hold_to_f64("burgers_two_phase", {}, refb_cell, xb_ref, lossb, cfgb,
                {"two_phase": two_phase})
    phase("grads_fallback", setup="random-init cell, random target, 12 steps, full width",
          bar=1e-4, routes=referee,
          remat_5x5={"worst_leaf": worstb["autograd_f32"],
                     "rel_err": relb["autograd_f32"][worstb["autograd_f32"]],
                     "from": "grads_kxk"})

    # kernels_batched: the ensemble's kernels at full width against their
    # plain versions, and each member against the single-member kernel on
    # that member (the same step, so the same bits)
    def member_cells(cell_np, n):
        """The cell and n - 1 seeded 1% perturbations of every leaf, stacked
        on the card (the members differ)."""
        def perturb(seed):
            rs = np.random.RandomState(seed)
            return {"diff": cell_np["diff"] * (1 + 0.01 * rs.standard_normal(cell_np["diff"].shape)),
                    "pi": [{k: v * (1 + 0.01 * rs.standard_normal(v.shape)) for k, v in br.items()}
                           for br in cell_np["pi"]]}
        trees = [cell_np] + [perturb(10 + m) for m in range(1, n)]
        return ensemble._stack_trees([params_from_numpy(t, device=dev, dtype=torch.float32)
                                      for t in trees])

    def member_ics(system, grid, n):
        """n initial conditions of the system, seeds 60 .. 60 + n - 1."""
        return torch.stack([torch.as_tensor(default_ic(system, grid, seed=60 + m),
                                            dtype=torch.float32, device=dev)
                            for m in range(n)]).contiguous()

    def pg_b_errs(name, g0_a, sums_a, g0_b, sums_b):
        """g0 and each member's gradient sums of a against b, leaf by leaf:
        {leaf: (max |diff|, max |b|)}, held to the sweep bar; the largest
        difference goes to err[name]."""
        out = {"g0": (max_abs(g0_a, g0_b), float(g0_b.abs().max()))}
        for m in range(sums_b.shape[0]):
            for leaf, (start, n) in groups.items():
                out[f"member{m}.{leaf}"] = (
                    max_abs(sums_a[m, start:start + n], sums_b[m, start:start + n]),
                    float(sums_b[m, start:start + n].abs().max()))
        for leaf, (e, scale) in out.items():
            check(e <= 2e-4 * scale + 2e-6,
                  f"{name}, {leaf}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
        err[name] = max(err.get(name, 0.0), max(e for e, _ in out.values()))
        return {k: list(v) for k, v in out.items()}

    batched_err, vs_single, bitwise = {}, {}, {}
    for suffix, cfg_, cell_np, exp_, n_mem in (
            ("", cfg, model["cell"], GS2D_RECON, ENS_MEMBERS),
            ("[M=8]", cfg, model["cell"], GS2D_RECON, 2 * ENS_MEMBERS),
            ("[k=5]", cfgb, modelb["cell"], BURGERS_STAGE1, ENS_KXK_MEMBERS),
            ("[k=5,M=4]", cfgb, modelb["cell"], BURGERS_STAGE1, 2 * ENS_KXK_MEMBERS)):
        packed_m = batched2d.pack_pi_params_2d_batched(member_cells(cell_np, n_mem),
                                                       cfg_).contiguous()
        h0_m = member_ics(exp_.system, exp_.grid, n_mem)
        # the forward by both routes, each against plain: at k = 1
        # rollout2d_cluster_kernel with a member axis (row 11's route,
        # rollout_b_plan's) and rollout2d_batched_kernel, the two and the
        # single cluster kernel on each member to the bit (the same step);
        # at k = 5 (M = 2 and 4) rollout2d_ffma_persistent_kernel with the
        # member axis (rollout_b_plan's route) and rollout2d_batched_kernel
        # against plain and each other, each member the single model's
        # rollout2d_ffma_persistent_kernel's to the bit
        got = batched2d._rollout_b_cuda(packed_m, h0_m, cfg_, CHECK_STEPS)
        steps_f = batched2d._rollout_b_steps_cuda(packed_m, h0_m, cfg_, CHECK_STEPS)
        want = batched2d.fused_rollout_2d_batched_plain(packed_m, h0_m, cfg_, CHECK_STEPS)
        single = [cell2d._rollout_cuda(packed_m[m].contiguous(), h0_m[m], cfg_, CHECK_STEPS)
                  for m in range(n_mem)]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(want).all()), f"plain batched frames{suffix} not finite")
        if cfg_.kernel_size > 1:
            ffma_name = "rollout2d_ffma_persistent_kernel[batched]" + (
                "" if n_mem == ENS_KXK_MEMBERS else f"[M={n_mem}]")
            plan_f = batched2d.rollout_b_plan(n_mem, *h0_m.shape[1:3], cfg_, n_sm=n_sm)
            check(plan_f["route"] == "persistent", f"{ffma_name}'s plan: {plan_f}")
            names = ((ffma_name, got), ("rollout2d_batched_kernel" + suffix, steps_f))
        else:
            names = (("rollout2d_cluster_kernel[batched]" + suffix, got),
                     ("rollout2d_batched_kernel" + suffix, steps_f))
        for name, fr in names:
            err[name] = max_abs(fr, want)
            check(allclose(fr, want, rtol=2e-4, atol=1e-5),
                  f"{name} vs plain: max |diff| {err[name]}")
            vs_single[name] = max(max_abs(fr[m], single[m]) for m in range(n_mem))
        if cfg_.kernel_size == 1:
            bitwise[f"frames{suffix}"] = {
                "cluster_vs_per_step": bool(torch.equal(got, steps_f)),
                "cluster_vs_single_cluster": all(bool(torch.equal(got[m], single[m]))
                                                 for m in range(n_mem))}
            check(all(bitwise[f"frames{suffix}"].values()),
                  f"batched frames{suffix} differ in bits: {bitwise[f'frames{suffix}']}")
        else:
            err[f"ffma_vs_per_step{suffix}"] = max_abs(got, steps_f)
            check(allclose(got, steps_f, rtol=2e-4, atol=1e-5),
                  f"{ffma_name} vs rollout2d_batched_kernel{suffix}: max |diff| "
                  f"{err[f'ffma_vs_per_step{suffix}']}")
            bitwise[f"frames{suffix}"] = {"ffma_members_vs_single_ffma": all(
                bool(torch.equal(got[m], single[m])) for m in range(n_mem))}
            check(all(bitwise[f"frames{suffix}"].values()),
                  f"{ffma_name}'s members vs rollout2d_ffma_persistent_kernel: max |diff| "
                  f"{vs_single[ffma_name]}")
            if n_mem != ENS_KXK_MEMBERS:   # M = 4: the forward alone
                continue
        fbar_m = torch.as_tensor(np.random.RandomState(9).standard_normal(tuple(got.shape)),
                                 dtype=torch.float32, device=dev)
        # the streaming sweep by both routes, against plain and each other:
        # at k = 1 (M = 4 and 8) adj2d_batched_persistent_kernel
        # (adj1_b_plan's) and adj2d_batched_kernel (one launch a step), each
        # member's g0 and g_ins also against the single model's sweep
        # (adj2d_persistent_kernel at 100 x 100) to the bit; at k = 5
        # adj2d_batched_ffma_persistent_kernel (adj_b_plan's) and
        # adj2d_batched_kernel's pair, each member against the single model's
        # sweep (the same kernel on a one-member batch)
        plain_b = batched2d.fused_phase1_2d_batched_plain(packed_m, got, fbar_m, cfg_)
        routes_b = {f"adj2d_batched_kernel{suffix}": batched2d._phase1_b_steps_cuda(
            packed_m, got, fbar_m, cfg_)}
        one_name = ("adj2d_batched_ffma_persistent_kernel" if cfg_.kernel_size > 1
                    else "adj2d_batched_persistent_kernel" + suffix)
        plan_b = (batched2d.adj_b_plan if cfg_.kernel_size > 1 else batched2d.adj1_b_plan)(
            n_mem, *got.shape[2:4], cfg_, n_sm)
        check(plan_b["route"] == "persistent", f"{one_name}'s plan at M = {n_mem}: {plan_b}")
        routes_b[one_name] = batched2d._phase1_b_cuda(packed_m, got, fbar_m, cfg_)
        single = [backward2d._phase1_cuda(packed_m[m].contiguous(), got[m].contiguous(),
                                          fbar_m[m].contiguous(), cfg_) for m in range(n_mem)]
        for name, out_k in routes_b.items():
            batched_err[name] = sweep_errs(name, out_k, plain_b)
            vs_single[name] = max(max(max_abs(out_k[0][m], single[m][0]),
                                      max_abs(out_k[1][m], single[m][1]))
                                  for m in range(n_mem))
        if cfg_.kernel_size == 1:
            bitwise[f"sweep_persistent_vs_single{suffix}"] = all(
                bool(torch.equal(routes_b[one_name][0][m], single[m][0]))
                and bool(torch.equal(routes_b[one_name][1][m], single[m][1]))
                for m in range(n_mem))
            check(bitwise[f"sweep_persistent_vs_single{suffix}"],
                  f"{one_name} vs adj2d_persistent_kernel on each member: max |diff| "
                  f"{vs_single[one_name]}")
        pair_err = {}
        for key, a, b in zip(("g_ins", "g0"), routes_b[one_name],
                             routes_b[f"adj2d_batched_kernel{suffix}"]):
            e, scale = max_abs(a, b), float(b.abs().max())
            check(e <= 2e-4 * scale + 2e-6,
                  f"{one_name} vs adj2d_batched_kernel{suffix}, {key}: "
                  f"max |diff| {e} over 2e-4 * {scale} + 2e-6")
            pair_err[key] = [e, scale]
        batched_err[("ffma_persistent_vs_per_step" if cfg_.kernel_size > 1
                     else "sweep_persistent_vs_per_step") + suffix] = pair_err
        del plain_b, routes_b, single
        if cfg_.kernel_size > 1:
            continue
        # the fused sweep: pg2d_batched_persistent_kernel (row 13's route,
        # pg_b_plan's) and pg2d_batched_kernel, g0 and each member's sums,
        # leaf by leaf, against plain and against each other; each member
        # against the single model's sweep (pg_plan's route)
        g0_k, sums_k = batched2d._pg_b_cuda(packed_m, got, fbar_m, cfg_)
        g0_s, acc_s = batched2d._pg_b_steps_cuda(packed_m, got, fbar_m, cfg_)
        g0_p, acc_p = batched2d.fused_phase1_pg_2d_batched_plain(packed_m, got, fbar_m, cfg_)
        single = [backward2d._pg_cuda(packed_m[m].contiguous(), got[m].contiguous(),
                                      fbar_m[m].contiguous(), cfg_) for m in range(n_mem)]
        torch.cuda.synchronize()
        sums_s, sums_p = acc_s.sum((2, 3)), acc_p.sum((2, 3))
        del acc_s, acc_p
        batched_err["pg2d_batched_persistent_kernel" + suffix] = pg_b_errs(
            "pg2d_batched_persistent_kernel", g0_k, sums_k, g0_p, sums_p)
        batched_err["pg2d_batched_kernel" + suffix] = pg_b_errs(
            "pg2d_batched_kernel", g0_s, sums_s, g0_p, sums_p)
        batched_err["persistent_vs_per_step" + suffix] = pg_b_errs(
            "pg2d_batched_persistent_kernel vs pg2d_batched_kernel", g0_k, sums_k, g0_s, sums_s)
        g0_1 = torch.stack([g for g, _ in single])
        sums_1 = torch.stack([a.sum((1, 2)) for _, a in single])
        batched_err["persistent_vs_single" + suffix] = pg_b_errs(
            "pg2d_batched_persistent_kernel vs the single sweep", g0_k, sums_k, g0_1, sums_1)
        vs_single["pg2d_batched_persistent_kernel" + suffix] = max(
            max(max_abs(g0_k[m], g0_1[m]), max_abs(sums_k[m], sums_1[m])) for m in range(n_mem))
        vs_single["pg2d_batched_kernel" + suffix] = max(
            max(max_abs(g0_s[m], g0_1[m]), max_abs(sums_s[m], sums_1[m])) for m in range(n_mem))
        # the same pass-1 and pass-3 arithmetic as pg2d_persistent_kernel
        bitwise[f"g0_persistent_vs_single{suffix}"] = bool(torch.equal(g0_k, g0_1))
        del single, g0_1, sums_1
    del got, want, steps_f, fbar_m
    # the entry points on a field of 17 x 9 (strips of 2 and 3 rows) by the
    # one-launch routes, and past the plans by the per-step routes (449 x
    # 449: no cluster's strips fit, nor the sweep's scratch; M = 8 at
    # 156 x 156: 8-CTA clusters, but a sweep block's scratch passes 227 KB),
    # launches and steps counted
    batched_routes = {}
    for label, n_mem, (hh, ww), steps in (("17 x 9", 3, (17, 9), 5),
                                          ("449 x 449", 2, (449, 449), 3),
                                          ("156 x 156", 8, (156, 156), 3)):
        packed_m = batched2d.pack_pi_params_2d_batched(member_cells(model["cell"], n_mem),
                                                       cfg).contiguous()
        h0_m = torch.as_tensor(0.1 * np.random.RandomState(5).standard_normal(
            (n_mem, hh, ww, 2)) + np.asarray([1.0, 0.0]), dtype=torch.float32,
            device=dev).contiguous()
        zero_counts()
        fr = batched2d.fused_rollout_2d_batched(packed_m, h0_m, cfg, steps)
        fb = torch.as_tensor(np.random.RandomState(9).standard_normal(tuple(fr.shape)),
                             dtype=torch.float32, device=dev)
        g0_k, sums_k = batched2d.fused_phase1_pg_2d_batched(packed_m, fr, fb, cfg)
        torch.cuda.synchronize()
        counts = read_counts()
        plans = {"rollout": batched2d.rollout_b_plan(n_mem, hh, ww, cfg, batched2d._clusters_held(
                     cfg, hh, ww)) if cell2d.rollout_plan(hh, ww, cfg)["route"] == "cluster"
                 else {"route": "per_step"},
                 "pg": batched2d.pg_b_plan(n_mem, hh, ww, cfg, n_sm)}
        one_f, one_b = plans["rollout"]["route"] == "cluster", plans["pg"]["route"] == "persistent"
        want_counts = {"fused_rollout_2d_batched.launches": 1 if one_f else steps,
                       "fused_rollout_2d_batched.steps": steps,
                       "fused_phase1_pg_2d_batched.launches": 1 if one_b else steps,
                       "fused_phase1_pg_2d_batched.steps": steps}
        check(counts == want_counts and one_f == (label != "449 x 449")
              and one_b == (label == "17 x 9"),
              f"batched entry points on {label}: plans {plans}, counts {counts}, expected "
              f"{want_counts}")
        fr_p = batched2d.fused_rollout_2d_batched_plain(packed_m, h0_m, cfg, steps)
        check(allclose(fr, fr_p, rtol=2e-4, atol=1e-5),
              f"batched frames on {label} vs plain: max |diff| {max_abs(fr, fr_p)}")
        g0_p, acc_p = batched2d.fused_phase1_pg_2d_batched_plain(packed_m, fr, fb, cfg)
        route_errs = pg_b_errs(f"batched sweep on {label} vs plain", g0_k, sums_k, g0_p,
                               acc_p.sum((2, 3)))
        batched_routes[label] = {"members": n_mem, "steps": steps, "plans": plans,
                                 "counts": counts,
                                 "frames_max_abs_err": max_abs(fr, fr_p),
                                 "sweep_max_abs_err": max(e for e, _ in route_errs.values())}
        del fr, fb, fr_p, acc_p
    # the streaming sweep through its entry point, members of the golden
    # cell, a random field and cotangent, launches and steps counted, against
    # plain: at k = 1 on 17 x 9 (M = 3, the one-launch route; each member's
    # outputs also against adj2d_persistent_kernel's to the bit) and past
    # adj1_b_plan (M = 4 at 225 x 225: one launch a step); at k = 5 on 17 x 9
    # (M = 3) and past adj_b_plan (M = 2 at 571 x 571: two launches a step)
    sweep_b_launches, sweep1_b_launches = {}, {}
    for k_, label, n_mem, (hh, ww), steps, route in (
            (1, "17 x 9", 3, (17, 9), 5, "persistent"),
            (1, "225 x 225", 4, (225, 225), 2, "per_step"),
            (5, "17 x 9", 3, (17, 9), 5, "persistent"),
            (5, "571 x 571", 2, (571, 571), 2, "per_step")):
        cfg_, cell_np = (cfg, model["cell"]) if k_ == 1 else (cfgb, modelb["cell"])
        packed_m = batched2d.pack_pi_params_2d_batched(member_cells(cell_np, n_mem),
                                                       cfg_).contiguous()
        rs = np.random.RandomState(12)
        h0_m = torch.as_tensor(0.5 * rs.standard_normal((n_mem, hh, ww, 2))
                               + (np.asarray([1.0, 0.0]) if k_ == 1 else 0.0),
                               dtype=torch.float32, device=dev).contiguous()
        fr = batched2d._rollout_b_cuda(packed_m, h0_m, cfg_, steps)
        fb = torch.as_tensor(rs.standard_normal(tuple(fr.shape)), dtype=torch.float32, device=dev)
        plan = (batched2d.adj1_b_plan if k_ == 1 else batched2d.adj_b_plan)(n_mem, hh, ww, cfg_,
                                                                             n_sm)
        zero_counts()
        got_b = batched2d.fused_phase1_2d_batched(packed_m, fr, fb, cfg_)
        torch.cuda.synchronize()
        counts = read_counts()
        counter = "fused_phase1_2d_batched.launches" + ("" if k_ == 1 else "_kxk")
        want_counts = {counter: 1 if route == "persistent" else (1 if k_ == 1 else 2) * steps,
                       "fused_phase1_2d_batched.steps": steps}
        check(plan["route"] == route and counts == want_counts,
              f"k = {k_} batched sweep on {label}: plan {plan}, counts {counts}, expected "
              f"{route}, {want_counts}")
        errs = {}
        for key, a, b in zip(("g_ins", "g0"), got_b,
                             batched2d.fused_phase1_2d_batched_plain(packed_m, fr, fb, cfg_)):
            errs[key] = [max_abs(a, b), float(b.abs().max())]
            check(errs[key][0] <= 2e-4 * errs[key][1] + 2e-6,
                  f"k = {k_} batched sweep on {label} ({route}) vs plain, {key}: {errs[key]}")
        if route == "per_step":
            (sweep1_b_launches if k_ == 1 else sweep_b_launches)[
                f"kernels_batched ({label})"] = counts[counter]
        elif k_ == 1:
            for m in range(n_mem):
                one_ = backward2d._phase1_persistent_cuda(
                    packed_m[m].contiguous(), fr[m].contiguous(), fb[m].contiguous(), cfg_)
                check(torch.equal(got_b[0][m], one_[0]) and torch.equal(got_b[1][m], one_[1]),
                      f"adj2d_batched_persistent_kernel on {label}, member {m}, vs "
                      "adj2d_persistent_kernel")
        batched_routes[f"sweep[k={k_}] {label}"] = {"members": n_mem, "steps": steps,
                                                    "plan": plan, "counts": counts, "err": errs}
        del fr, fb, got_b
    # the k = 5 forward through its entry point, members of the golden
    # Burgers cell, a random field, against plain: on 17 x 9 (M = 3, the
    # one-launch route, each member also against the single model's
    # rollout2d_ffma_persistent_kernel to the bit) and past rollout_b_plan
    # (M = 2 at 1057 x 1057: one rollout2d_batched_kernel launch a step),
    # launches and steps counted
    fwd5_steps_launches = {}
    for label, n_mem, (hh, ww), steps, route in (
            ("17 x 9", 3, (17, 9), 5, "persistent"),
            ("1057 x 1057", 2, (1057, 1057), 2, "per_step")):
        packed_m = batched2d.pack_pi_params_2d_batched(member_cells(modelb["cell"], n_mem),
                                                       cfgb).contiguous()
        h0_m = torch.as_tensor(0.5 * np.random.RandomState(13).standard_normal(
            (n_mem, hh, ww, 2)), dtype=torch.float32, device=dev).contiguous()
        plan = batched2d.rollout_b_plan(n_mem, hh, ww, cfgb, n_sm=n_sm)
        zero_counts()
        fr = batched2d.fused_rollout_2d_batched(packed_m, h0_m, cfgb, steps)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {"fused_rollout_2d_batched.launches_kxk": 1 if route == "persistent"
                       else steps, "fused_rollout_2d_batched.steps_kxk": steps}
        check(plan["route"] == route and counts == want_counts,
              f"k = 5 batched forward on {label}: plan {plan}, counts {counts}, expected "
              f"{route}, {want_counts}")
        fr_p = batched2d.fused_rollout_2d_batched_plain(packed_m, h0_m, cfgb, steps)
        e = max_abs(fr, fr_p)
        check(allclose(fr, fr_p, rtol=2e-4, atol=1e-5),
              f"k = 5 batched forward on {label} ({route}) vs plain: max |diff| {e}")
        if route == "per_step":
            fwd5_steps_launches[f"kernels_batched ({label})"] = counts[
                "fused_rollout_2d_batched.launches_kxk"]
        else:
            for m in range(n_mem):
                one_ = cell2d._rollout_ffma_persistent_cuda(packed_m[m].contiguous(),
                                                            h0_m[m].contiguous(), cfgb, steps)
                check(torch.equal(fr[m], one_),
                      f"rollout2d_ffma_persistent_kernel[batched] on {label}, member {m}, vs "
                      "rollout2d_ffma_persistent_kernel")
        batched_routes[f"forward[k=5] {label}"] = {"members": n_mem, "steps": steps,
                                                   "plan": plan, "counts": counts, "err": e}
        del fr, fr_p
    phase("kernels_batched", members={"gs2d": [ENS_MEMBERS, 2 * ENS_MEMBERS],
                                      "burgers": [ENS_KXK_MEMBERS, 2 * ENS_KXK_MEMBERS]},
          steps=CHECK_STEPS, shape=[GS2D_RECON.grid, GS2D_RECON.grid, 2],
          cells="golden cell and seeded 1% perturbations", ics="default_ic seeds 60..",
          cotangent="standard normal, seed 9",
          forward_max_abs_err={k: v for k, v in err.items()
                               if k.startswith(("rollout2d_batched_kernel",
                                                "rollout2d_cluster_kernel[batched]",
                                                "rollout2d_ffma_persistent_kernel[batched]",
                                                "ffma_vs_per_step"))},
          forward_rtol=2e-4, forward_atol=1e-5, bitwise=bitwise,
          sweep_err_and_max=batched_err, sweep_bar="2e-4 * max|plain| + 2e-6",
          member_vs_single_kernel_max_abs_diff=vs_single, entry_points=batched_routes)

    # grads_batched: the batched routes' gradients against f64 autograd on
    # the referee setup (random-init cells, one per member, random targets,
    # 12 steps, full width), each route's launches counted
    def batched_vs_f64(cfg_, n_mem, route, want_counts, seed):
        rs = np.random.RandomState(seed)
        cells_np = [params_to_numpy(init_pi_cell(torch.Generator().manual_seed(m), cfg_,
                                                 device="cpu")) for m in range(n_mem)]
        scale = 0.3 if cfg_.kernel_size == 1 else 0.5
        x0 = scale * rs.standard_normal((n_mem, GS2D_RECON.grid, GS2D_RECON.grid, 2))
        target = torch.as_tensor(rs.standard_normal((n_mem, 13) + x0.shape[1:]), device=dev)
        grads = {}
        for kind, dtype in ((route, torch.float32), ("f64", torch.float64)):
            p = ensemble._stack_trees([params_from_numpy(c, device=dev, dtype=dtype)
                                       for c in cells_np])
            leaves = [p["diff"]] + [br[k] for br in p["pi"] for k in sorted(br)]
            x = torch.as_tensor(x0, dtype=dtype, device=dev)
            for leaf in leaves + [x]:
                leaf.requires_grad_(True)
            zero_counts()
            if kind == "f64":
                fr = torch.stack([rollout(lambda h, m=m: pi_cell_step(
                    ensemble._member(p, m), h, cfg_), x[m], 12) for m in range(n_mem)])
            elif kind == "batched_pg":
                fr = batched2d.fused_rollout_tp_2d_batched_pg(p, x, cfg_, 12)
            else:
                fr = batched2d.fused_rollout_tp_2d_batched(p, x, cfg_, 12)
            grads[kind] = torch.autograd.grad(((fr - target.to(dtype)) ** 2).mean(), leaves + [x])
            torch.cuda.synchronize()
            if kind != "f64":
                counts = read_counts()
        check(counts == want_counts, f"{route} k = {cfg_.kernel_size}: launch counts {counts}, "
                                     f"expected {want_counts}")
        names = ["diff"] + [f"pi[{o}].{k}" for o in range(2) for k in sorted(cells_np[0]["pi"][o])]
        rel = {f"member{m}.{n}": float((a[m].double() - b[m]).abs().max() / b[m].abs().max())
               for n, a, b in zip(names + ["h0"], grads[route], grads["f64"])
               for m in range(n_mem)}
        worst = max(rel, key=rel.get)
        check(rel[worst] <= 1e-4, f"{route} k = {cfg_.kernel_size} gradients vs f64 autograd: "
                                  f"{worst} at {rel[worst]} over 1e-4")
        return {"members": n_mem, "launches": counts, "worst_leaf": worst,
                "worst_rel_err": rel[worst], "rel_err": rel}

    grads_b = {
        "batched_pg": batched_vs_f64(cfg, ENS_MEMBERS, "batched_pg",
                                     {"fused_rollout_2d_batched.launches": 1,
                                      "fused_rollout_2d_batched.steps": 12,
                                      "fused_phase1_pg_2d_batched.launches": 1,
                                      "fused_phase1_pg_2d_batched.steps": 12}, 11),
        "batched": batched_vs_f64(cfg, ENS_MEMBERS, "batched",
                                  {"fused_rollout_2d_batched.launches": 1,
                                   "fused_rollout_2d_batched.steps": 12,
                                   "fused_phase1_2d_batched.launches": 1,
                                   "fused_phase1_2d_batched.steps": 12}, 11),
        "batched[k=5]": batched_vs_f64(cfgb, ENS_KXK_MEMBERS, "batched",
                                       {"fused_rollout_2d_batched.launches_kxk": 1,
                                        "fused_rollout_2d_batched.steps_kxk": 12,
                                        "fused_phase1_2d_batched.launches_kxk": 1,
                                        "fused_phase1_2d_batched.steps": 12}, 12),
    }
    phase("grads_batched", setup="random-init cells (seeds 0..M-1), random targets, 12 steps, "
                                 "full width", bar=1e-4, routes=grads_b)

    # kernels_sharded: row 14.  PR 10's step2d_haloed_kernel on the haloed
    # blocks of a 2 x 2 mesh that repeats cuda:0 (four 50 x 50 blocks of the
    # 100 x 100 field, and 6 x 10 blocks, narrower than the k x k tile) for
    # the golden GS2D (k = 1) and Burgers (k = 5) cells against its plain
    # version, then through its entry point (step_haloed_2d) on the four
    # blocks, counted.  The blocks kernels at the same shapes:
    # step2d_blocks_kernel against its plain version in both groupings (all
    # blocks one device's state; every block its own device, its halo from
    # strips), the two equal to the bit; rollout2d_blocks_kernel against its
    # plain version (20 steps).  Then the slice's main path, the decomposed
    # rollout of impl="pallas" (T = 200, no gradient: one launch a call),
    # with its launches counted, against the single-device frames rollout
    # (cell2d._rollout_cuda: rollout2d_cluster_kernel at k = 1,
    # rollout2d_kernel at k = 5; the same step on the periodic field) and
    # against impl="jnp" (the eager step), and against route 1 (one launch a
    # step) in both groupings to the bit; and a field past blocks_plan
    # (400 x 400 on the 2 x 2 mesh), route 1 with no gradient
    axes2 = ("x", "y")
    mesh = make_mesh(axes2, shape=(2, 2), devices=[dev] * 4)

    def mesh_blocks(h):
        n, m = h.shape[0] // 2, h.shape[1] // 2
        return object_grid((2, 2), [h[i * n:(i + 1) * n, j * m:(j + 1) * m]
                                    for i in range(2) for j in range(2)])

    def haloed(grid):
        return halo_exchange(grid, mesh=mesh, axis_names=axes2, array_axes=(0, 1))

    def own_device(devices):
        """Every block its own group: the strip path on one card."""
        return [(devices[idx], [idx]) for idx in np.ndindex(devices.shape)]

    @contextlib.contextmanager
    def replaced(name, fn):
        """sharded.<name> replaced by fn inside the block."""
        old = getattr(sharded, name)
        setattr(sharded, name, fn)
        try:
            yield
        finally:
            setattr(sharded, name, old)

    def route1():
        return replaced("_one_launch", lambda *args: False)

    packedb = cell2d.pack_pi_params_2d(paramsb["cell"], cfgb)
    sharded_cells = {"gs2d_k1": (cfg, params["cell"], h0, packed),
                     "burgers_k5": (cfgb, paramsb["cell"], h0b, packedb)}
    block_err, blocks_err, rollout_err = {}, {}, {}
    devs22 = object_grid((2, 2), [dev] * 4)
    for label, (cfg_, _, x0, pk) in sharded_cells.items():
        narrow = (0.3 * torch.randn((10, 14, 2), generator=torch.Generator(device=dev)
                                    .manual_seed(10), device=dev) + x0[:1, :1])
        for name, xb in [(f"block{k}", b.contiguous()) for k, b in
                         enumerate(haloed(mesh_blocks(x0)).flat)] + [("narrow_6x10", narrow)]:
            a = sharded_step2d._step_cuda(pk, xb, cfg_)
            b = sharded_step2d.step_haloed_2d_plain(pk, xb, cfg_)
            torch.cuda.synchronize()
            block_err[f"{label}.{name}"] = max_abs(a, b)
            check(allclose(a, b, rtol=2e-4, atol=1e-5),
                  f"step2d_haloed_kernel vs plain, {label} {name}: max |diff| {max_abs(a, b)}")
        small = (0.3 * torch.randn((12, 20, 2), generator=torch.Generator(device=dev)
                                   .manual_seed(11), device=dev) + x0[:1, :1])
        for name, field in (("4_blocks_50x50", x0), ("4_blocks_6x10", small)):
            h_, w_ = field.shape[0] // 2, field.shape[1] // 2
            steps_by = {}
            for grouping, groups in (("one_device", sharded._group_blocks(devs22)),
                                     ("own_device", own_device(devs22))):
                layouts = sharded._group_layouts(groups, (2, 2), h_, w_)
                states = sharded._states(field, layouts, (2, 2), h_, w_)
                outs = []
                for g, st in zip(layouts, states):
                    strips = sharded._strips(states, g).contiguous()
                    a = sharded_step2d._step_blocks_cuda(pk, st, strips, g.layout, cfg_)
                    b = sharded_step2d.step_blocks_2d_plain(pk, st, strips, g.layout, cfg_)
                    torch.cuda.synchronize()
                    key = f"{label}.{name}.{grouping}"
                    blocks_err[key] = max(blocks_err.get(key, 0.0), max_abs(a, b))
                    check(allclose(a, b, rtol=2e-4, atol=1e-5),
                          f"step2d_blocks_kernel vs plain, {key}: max |diff| {max_abs(a, b)}")
                    outs.append(a)
                steps_by[grouping] = torch.cat(outs)
            check(torch.equal(steps_by["one_device"], steps_by["own_device"]),
                  f"step2d_blocks_kernel, {label} {name}: the groupings differ by "
                  f"{max_abs(steps_by['one_device'], steps_by['own_device'])}")
            layout = sharded._field_layout((2, 2), h_, w_)
            a = sharded_step2d._rollout_blocks_cuda(pk, field, layout, cfg_, 20)
            b = sharded_step2d.rollout_blocks_2d_plain(pk, field, layout, cfg_, 20)
            torch.cuda.synchronize()
            rollout_err[f"{label}.{name}"] = max_abs(a, b)
            check(allclose(a, b, rtol=2e-4, atol=1e-5),
                  f"rollout2d_blocks_kernel vs plain, {label} {name}: max |diff| {max_abs(a, b)}")
            check(torch.equal(a[1], steps_by["one_device"].reshape(2, 2, h_, w_, 2).transpose(1, 2)
                              .reshape(field.shape)),
                  f"rollout2d_blocks_kernel's first step vs step2d_blocks_kernel's, {label} {name}")
    err["step2d_haloed_kernel"] = max(block_err.values())
    err["step2d_blocks_kernel"] = max(blocks_err.values())
    err["rollout2d_blocks_kernel"] = max(rollout_err.values())
    sharded_counters = [(sharded_step2d.step_haloed_2d, "launches"),
                        (sharded_step2d.step_blocks_2d, "launches"),
                        (sharded_step2d.rollout_blocks_2d, "launches")]

    def zero_sharded():
        for obj, attr in sharded_counters:
            setattr(obj, attr, 0)

    def read_sharded():
        return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in sharded_counters}

    # step_haloed_2d, the one-block entry point, on the four haloed blocks
    zero_sharded()
    with torch.no_grad():
        for label, (cfg_, cell_, x0, _) in sharded_cells.items():
            for b in haloed(mesh_blocks(x0)).flat:
                sharded_step2d.step_haloed_2d(cell_, b.contiguous(), cfg_)
    sharded_launches = {"kernels_sharded.step_haloed_2d": read_sharded()}
    check(sharded_launches["kernels_sharded.step_haloed_2d"] == {
        "step_haloed_2d.launches": 4 * len(sharded_cells), "step_blocks_2d.launches": 0,
        "rollout_blocks_2d.launches": 0},
          f"step_haloed_2d through its entry point: {sharded_launches}")
    sharded_roll = {}
    with torch.no_grad():
        for label, (cfg_, cell_, x0, pk) in sharded_cells.items():
            zero_sharded()
            got = sharded_rollout_nd(cell_, x0, cfg_, CHECK_STEPS, mesh, impl="pallas")
            sharded_launches[f"kernels_sharded.{label}"] = read_sharded()
            single = cell2d._rollout_cuda(pk, x0, cfg_, CHECK_STEPS)
            eager = sharded_rollout_nd(cell_, x0, cfg_, CHECK_STEPS, mesh, impl="jnp")
            zero_sharded()
            with route1():
                one_dev = sharded_rollout_nd(cell_, x0, cfg_, CHECK_STEPS, mesh, impl="pallas")
                with replaced("_group_blocks", own_device):
                    strips = sharded_rollout_nd(cell_, x0, cfg_, CHECK_STEPS, mesh,
                                                impl="pallas")
            sharded_launches[f"kernels_sharded.{label}.route1"] = read_sharded()
            torch.cuda.synchronize()
            check(torch.equal(got, one_dev) and torch.equal(one_dev, strips),
                  f"sharded pallas rollout, {label}: the routes and groupings differ: "
                  f"{max_abs(got, one_dev)}, {max_abs(one_dev, strips)}")
            bar = 2e-5 * torch.arange(CHECK_STEPS + 1, device=dev)
            for other, ref_frames in (("single_device", single), ("jnp", eager)):
                per_step = (got - ref_frames).abs().flatten(1).amax(1)
                worst = int((per_step - bar).argmax())
                check(bool((per_step <= bar).all()),
                      f"sharded pallas rollout vs {other}, {label}: step {worst} max |diff| "
                      f"{float(per_step[worst])} over {float(bar[worst])}")
                sharded_roll[f"{label}.vs_{other}"] = {
                    "max_abs_err": float(per_step.max()),
                    "worst_step_over_bar": float((per_step[1:] / bar[1:]).max()),
                    "equal_bits": bool(torch.equal(got, ref_frames))}
            del got, single, eager, one_dev, strips
        # past blocks_plan: 400 x 400 (four 200 x 200 blocks), route 1
        big = torch.as_tensor(default_ic("gray_scott_2d", 400), dtype=torch.float32, device=dev)
        past_plan = sharded_step2d.blocks_plan(4, 200, 200, cfg, n_sm)
        zero_sharded()
        got = sharded_rollout_nd(params["cell"], big, cfg, 10, mesh, impl="pallas")
        sharded_launches["kernels_sharded.400x400"] = read_sharded()
        single = cell2d._rollout_cuda(packed, big, cfg, 10)
        torch.cuda.synchronize()
        per_step = (got - single).abs().flatten(1).amax(1)
        check(past_plan["route"] == "per_step" and
              bool((per_step <= 2e-5 * torch.arange(11, device=dev)).all()),
              f"sharded pallas rollout past the plan, 400 x 400: {past_plan}, max |diff| per "
              f"step {per_step.tolist()}")
        sharded_roll["gs2d_k1.400x400.vs_single_device"] = {
            "max_abs_err": float(per_step.max()), "plan": past_plan["route"]}
        del got, single, big
    want_counts = {f"kernels_sharded.{label}": {
        "step_haloed_2d.launches": 0, "step_blocks_2d.launches": 0,
        "rollout_blocks_2d.launches": 1} for label in sharded_cells}
    want_counts.update({f"kernels_sharded.{label}.route1": {
        "step_haloed_2d.launches": 0, "step_blocks_2d.launches": 5 * CHECK_STEPS,
        "rollout_blocks_2d.launches": 0} for label in sharded_cells})
    want_counts["kernels_sharded.400x400"] = {
        "step_haloed_2d.launches": 0, "step_blocks_2d.launches": 10,
        "rollout_blocks_2d.launches": 0}
    check(all(sharded_launches[k] == v for k, v in want_counts.items()),
          f"sharded rollouts' launches: {sharded_launches}, expected {want_counts}")
    phase("kernels_sharded", mesh=mesh.shape, devices=[str(d) for d in mesh.devices.flat],
          block=[50, 50], steps=CHECK_STEPS, step_vs_plain_max_abs_err=block_err,
          blocks_step_vs_plain_max_abs_err=blocks_err,
          blocks_rollout_vs_plain_max_abs_err=rollout_err, rtol=2e-4, atol=1e-5,
          rollouts=sharded_roll, rollout_bar="2e-5 * t", launches=sharded_launches)

    # grads_sharded: the gradients through the strips, impl="pallas" (row
    # 14's step2d_blocks_kernel forward, eager adjoint) and "jnp", against
    # f64 autograd on the referee setup of grads and grads_kxk (random-init
    # cell, random target, 12 steps, full width), launches counted: one a
    # step on the one device, and with remat each checkpointed segment runs
    # its forward twice
    def sharded_route(impl):
        return lambda p, x, cfg_, steps: sharded_rollout_nd(p, x, cfg_, steps, mesh, impl=impl)

    zero_sharded()
    routes_sh = {"pallas": sharded_route("pallas"), "jnp": sharded_route("jnp")}
    rel_sh = {
        "gs2d_k1": rel_errs_vs_f64(ref_cell, x_ref, 12,
                                   lambda fr: ((fr - tgt.to(fr.dtype)) ** 2).mean(),
                                   routes=routes_sh),
        "burgers_k5": rel_errs_vs_f64(refb_cell, xb_ref, 12,
                                      lambda fr: ((fr - tgtb.to(fr.dtype)) ** 2).mean(),
                                      cfg=cfgb, routes=routes_sh),
    }
    sharded_launches["grads_sharded"] = read_sharded()
    check(sharded_launches["grads_sharded"] == {
        "step_haloed_2d.launches": 0, "step_blocks_2d.launches": 2 * len(rel_sh) * 12,
        "rollout_blocks_2d.launches": 0},
          f"sharded gradients: {sharded_launches['grads_sharded']} launches")
    worst_sh = {}
    for label, rel in rel_sh.items():
        for route in routes_sh:
            leaf = max(rel[route], key=rel[route].get)
            worst_sh[f"{label}.{route}"] = [leaf, rel[route][leaf]]
            check(rel[route][leaf] <= 1e-4,
                  f"sharded {route} gradients vs f64, {label}: {leaf} at {rel[route][leaf]}")
    phase("grads_sharded", setup="random-init cell, random target, 12 steps, full width, "
                                 "2 x 2 mesh on cuda:0", bar=1e-4, worst_leaf=worst_sh,
          launches=sharded_launches["grads_sharded"], **rel_sh)

    # sharded3d: GS3D's decomposed rollout (eager, the only 3D route) on a
    # (2, 2, 2) mesh of cuda:0 at 48^3, golden cell, against rollout3d_persistent_kernel
    mesh3 = make_mesh(("x", "y", "z"), shape=(2, 2, 2), devices=[dev] * 8)
    t = time.perf_counter()
    with torch.no_grad():
        got3 = sharded_rollout_nd(params3["cell"], h03, cfg3, SHARDED3D_STEPS, mesh3)
        torch.cuda.synchronize()
        sharded3d_s = time.perf_counter() - t
        want3 = cell3d.fused_rollout_3d(params3["cell"], h03, cfg3, SHARDED3D_STEPS)
    per_step3 = (got3 - want3).abs().flatten(1).amax(1)
    bar3 = 2e-5 * torch.arange(SHARDED3D_STEPS + 1, device=dev)
    check(bool((per_step3 <= bar3).all()),
          f"sharded 3D rollout vs rollout3d_persistent_kernel: max |diff| per step "
          f"{per_step3.tolist()}")
    del got3, want3
    phase("sharded3d", mesh=mesh3.shape, shape=[n3, n3, n3, 2], steps=SHARDED3D_STEPS,
          max_abs_err=float(per_step3.max()),
          worst_step_over_bar=float((per_step3[1:] / bar3[1:]).max()), bar="2e-5 * t",
          seconds=sharded3d_s)

    # serve: the main path, through the entry point a user calls
    serve = build_serving_fn(model, cfg, SERVE_STEPS, isg_cfg=isg_cfg, device=dev)
    serve_final = build_serving_fn(model, cfg, SERVE_STEPS, isg_cfg=isg_cfg,
                                   final_only=True, device=dev)
    requests = [add_noise(default_ic("gray_scott_2d", GS2D_RECON.grid, seed=s)[None],
                          GS2D_RECON.noise_pct, seed=s)[0][::isg_cfg.scale, ::isg_cfg.scale]
                for s in SEEDS]
    # one request of each kind first, neither counted nor timed with the
    # rest: its time is the first-call cost of the ISG and the allocator
    warmup_s = []
    for fn in (serve, serve_final):
        t = time.perf_counter()
        fn(requests[-1])
        torch.cuda.synchronize()
        warmup_s.append(time.perf_counter() - t)
    cell2d.fused_rollout_2d.launches = 0
    cell2d.fused_rollout_2d.steps = 0
    cell2d.fused_rollout_final_2d.launches = 0
    cell2d.fused_rollout_final_2d.steps = 0
    answers, request_s, enqueue_s = [], [], []

    def timed(fn, req):
        t = time.perf_counter()
        out = fn(req)
        enqueue_s.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t)
        return out

    answers = [timed(serve, req) for req in requests]
    final = timed(serve_final, requests[0])
    launches = {"rollout2d_cluster_kernel": cell2d.fused_rollout_2d.launches,
                "rollout2d_cluster_kernel[final]": cell2d.fused_rollout_final_2d.launches}
    serve_steps = {"rollout2d_cluster_kernel": cell2d.fused_rollout_2d.steps,
                   "rollout2d_cluster_kernel[final]": cell2d.fused_rollout_final_2d.steps}
    n = GS2D_RECON.grid
    for a in answers:
        check(tuple(a.shape) == (SERVE_STEPS + 1, n, n, 2), f"frames shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite frames")
    check(tuple(final.shape) == (n, n, 2) and bool(torch.isfinite(final).all()),
          "final state not finite or of the wrong shape")
    final_err = max_abs(final, answers[0][-1])
    check(allclose(final, answers[0][-1], rtol=1e-6, atol=1e-7),
          f"final-state request vs last frame: max |diff| {final_err}")
    # one cluster launch a request, frames or final state
    check(launches == {"rollout2d_cluster_kernel": len(SEEDS),
                       "rollout2d_cluster_kernel[final]": 1}
          and serve_steps == {"rollout2d_cluster_kernel": len(SEEDS) * SERVE_STEPS,
                              "rollout2d_cluster_kernel[final]": SERVE_STEPS},
          f"launch counts {launches}, step counts {serve_steps}")
    phase("serve", requests=len(requests) + 1, steps=SERVE_STEPS, launches=launches,
          steps_run=serve_steps,
          request_seconds=request_s, enqueue_seconds=enqueue_s,
          request_order="frames x 3, then final-state",
          warmup_request_seconds=dict(zip(("frames", "final_state"), warmup_s)),
          final_vs_last_frame_max_abs_err=final_err)

    # train: the main path of training, through the entry point a user calls
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    truth_cache2d = tempfile.mkdtemp(prefix="chip_smoke_truth2d_")   # train_ensemble reuses it
    try:
        cell2d.fused_rollout_2d.launches = cell2d.fused_rollout_2d.steps = 0
        backward2d.fused_rollout_tp_2d_pg.launches = backward2d.fused_rollout_tp_2d_pg.steps = 0
        with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
            res = runner.run_experiment(GS2D_RECON, device=dev, out_dir=out_dir,
                                        cache_dir=truth_cache2d,
                                        n_iters_override=TRAIN_ITERS,
                                        isg_pretrain_override=ISG_PRETRAIN_ITERS, seed=0)
        train_launches = {"rollout2d_cluster_kernel": cell2d.fused_rollout_2d.launches,
                          "pg2d_persistent_kernel": backward2d.fused_rollout_tp_2d_pg.launches}
        train_steps = {"rollout2d_cluster_kernel": cell2d.fused_rollout_2d.steps,
                       "pg2d_persistent_kernel": backward2d.fused_rollout_tp_2d_pg.steps}
        ckpt, meta = load_checkpoint_tree(os.path.join(out_dir, f"{GS2D_RECON.name}.ckpt.npz"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    stages = list(GS2D_RECON.curriculum) + [GS2D_RECON.train_steps]
    per_stage = TRAIN_ITERS // len(stages)
    # one launch of each a training iteration, and one cluster launch for the
    # evaluation; the steps as the per-step kernels' launches were
    want = {"pg2d_persistent_kernel": TRAIN_ITERS, "rollout2d_cluster_kernel": TRAIN_ITERS + 1}
    want_steps = {"pg2d_persistent_kernel": per_stage * sum(stages),
                  "rollout2d_cluster_kernel": per_stage * sum(stages) + GS2D_RECON.infer_steps}
    hist = res["history"]
    check(len(hist) == TRAIN_ITERS and bool(np.isfinite(hist).all()), f"training losses {hist}")
    check(train_launches == want and train_steps == want_steps,
          f"training launch counts {train_launches}, expected {want}; step counts "
          f"{train_steps}, expected {want_steps}")
    check(bool(np.isfinite(res["rel_l2"])) and not res["diverged"],
          f"evaluation rel_l2 {res['rel_l2']}, diverged {res['diverged']}")
    check(meta.get("iteration") == per_stage and meta.get("stage") == len(stages) - 1
          and np.array_equal(ckpt["params"]["cell"]["diff"],
                             res["params"]["cell"]["diff"].cpu().numpy()),
          f"latest checkpoint meta {meta}")
    sec = res["seconds"]
    phase("train", experiment=GS2D_RECON.name, grid=GS2D_RECON.grid, launches=train_launches,
          steps_run=train_steps,
          truth_frames=GS2D_RECON.infer_steps, truth_s=sec["truth"],
          isg_pretrain_iters=ISG_PRETRAIN_ITERS, isg_pretrain_s=sec["isg_pretrain"],
          stages=[{**st, "ms_per_iter": 1e3 * st["seconds"] / st["iters"]} for st in sec["stages"]],
          evaluate_s=sec["evaluate"], history=hist, rel_l2=res["rel_l2"],
          rel_l2_u=res["rel_l2_u"], rel_l2_v=res["rel_l2_v"])

    # train_parity: the whole training path on the card against its plain self
    pexp = dataclasses.replace(
        GS2D_RECON, grid=32, train_steps=40, infer_steps=40, curriculum=(),
        data=dataclasses.replace(GS2D_RECON.data, time_stride=10),
        train=dataclasses.replace(GS2D_RECON.train, n_iters=5, steps_per_call=5))
    ptruth = simulate(pexp.system, default_ic(pexp.system, pexp.grid), pexp.train_steps,
                      pexp.dt, pexp.dx, device=dev)
    init = params_to_numpy(runner.init_model(pexp, torch.Generator().manual_seed(0),
                                             device="cpu"))
    parity = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        prob = runner.setup_problem(pexp, ptruth, device=d)
        with contextlib.redirect_stdout(sys.stderr):
            parity[label] = train(runner.build_loss_fn(prob, pexp.train_steps), init,
                                  pexp.train, device=d)[1]
    gpu_h, cpu_h = np.asarray(parity["card"]), np.asarray(parity["cpu"])
    parity_err = float(np.max(np.abs(gpu_h - cpu_h) / np.abs(cpu_h)))
    check(np.allclose(gpu_h, cpu_h, rtol=1e-4, atol=0),
          f"train on the card vs the CPU: {gpu_h.tolist()} vs {cpu_h.tolist()}")
    phase("train_parity", grid=pexp.grid, steps=pexp.train_steps, iters=pexp.train.n_iters,
          card=gpu_h.tolist(), cpu=cpu_h.tolist(), max_rel_err=parity_err, rtol=1e-4)

    # train3d: the main path of GS3D training, through the entry point a user
    # calls: the whole robustness family and the probe are on
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train3d_")
    try:
        zero_counts()
        with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
            res3 = runner.run_experiment(GS3D_RECON, device=dev, out_dir=out_dir, cache_dir=None,
                                         n_iters_override=TRAIN3D_ITERS,
                                         isg_pretrain_override=ISG_PRETRAIN_ITERS, seed=0)
        torch.cuda.synchronize()
        train3_counts = read_counts()
        with open(os.path.join(out_dir, f"{GS3D_RECON.name}.metrics.jsonl")) as f:
            records3 = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    stages3 = list(GS3D_RECON.curriculum) + [GS3D_RECON.train_steps]
    per_stage3 = TRAIN3D_ITERS // len(stages3)
    hist3 = res3["history"]
    scores3 = res3["probe_scores"]
    events3 = [r for r in records3 if "event" in r]
    # forward and backward of every iteration, and again of every chunk that
    # a rollback or an abort drops (the replay starts at the same iteration);
    # a probe at each stage's end, one per candidate and the evaluation, each
    # over the inference horizon.  A stage's records end with its loss line
    # at its last iteration (then its probe).
    spc = GS3D_RECON.train.steps_per_call
    iters_run, stage = [per_stage3] * len(stages3), 0
    for r in records3:
        if r.get("event") in ("nan_watchdog", "spike_watchdog", "aborted"):
            iters_run[stage] += min(spc, per_stage3 - int(r["step"]))
        elif "loss" in r and int(r["step"]) == per_stage3 - 1:
            stage += 1
    # one launch of each kernel a call: a forward and a backward an
    # iteration, a forward over the inference horizon a probe, candidate and
    # evaluation
    ran3 = sum(n * steps for n, steps in zip(iters_run, stages3))
    horizons3 = len(stages3) + len(scores3) + 1
    want3 = {"fused_rollout_3d.launches": sum(iters_run) + horizons3,
             "fused_rollout_3d.steps": ran3 + GS3D_RECON.infer_steps * horizons3,
             "fused_rollout_tp_3d_pg.launches": sum(iters_run),
             "fused_rollout_tp_3d_pg.steps": ran3}
    train3_launches = {"rollout3d_persistent_kernel": train3_counts.get(
                           "fused_rollout_3d.launches", 0),
                       "pg3d_persistent_kernel": train3_counts.get(
                           "fused_rollout_tp_3d_pg.launches", 0)}
    check(len(hist3) == TRAIN3D_ITERS and bool(np.isfinite(hist3).all()),
          f"GS3D training losses {hist3}")
    check(any(np.isfinite(v) for v in scores3.values()), f"GS3D probe scores {scores3}")
    check(bool(np.isfinite(res3["rel_l2"])), f"GS3D evaluation rel_l2 {res3['rel_l2']}")
    check(train3_counts == want3,
          f"GS3D training launch and step counts {train3_counts}, expected {want3}")
    sec3 = res3["seconds"]
    phase("train3d", experiment=GS3D_RECON.name, grid=GS3D_RECON.grid, counts=train3_counts,
          expected_counts=want3, iterations_run=iters_run, events=events3,
          truth_frames=GS3D_RECON.infer_steps, truth_s=sec3["truth"],
          isg_pretrain_iters=ISG_PRETRAIN_ITERS, isg_pretrain_s=sec3["isg_pretrain"],
          stages=[{**st, "ms_per_iter": 1e3 * st["seconds"] / st["iters"]}
                  for st in sec3["stages"]],
          select_s=sec3["select"], evaluate_s=sec3["evaluate"], history=hist3,
          candidate=res3["candidate"], probe_scores=scores3, rel_l2=res3["rel_l2"],
          rel_l2_u=res3["rel_l2_u"], rel_l2_v=res3["rel_l2_v"],
          stable_frames=res3["stable_frames"], diverged=bool(res3["diverged"]))

    # train3d_parity: GS3D training on the card against its plain self
    pexp3 = dataclasses.replace(
        GS3D_RECON, grid=16, train_steps=20, infer_steps=20, curriculum=(),
        data=dataclasses.replace(GS3D_RECON.data, time_stride=5),
        train=dataclasses.replace(GS3D_RECON.train, n_iters=5, steps_per_call=5))
    ptruth3 = simulate(pexp3.system, default_ic(pexp3.system, pexp3.grid), pexp3.train_steps,
                       pexp3.dt, pexp3.dx, device=dev)
    init3 = params_to_numpy(runner.init_model(pexp3, torch.Generator().manual_seed(0),
                                              device="cpu"))
    parity3 = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        prob = runner.setup_problem(pexp3, ptruth3, device=d)
        with contextlib.redirect_stdout(sys.stderr):
            parity3[label] = train(runner.build_loss_fn(prob, pexp3.train_steps), init3,
                                   pexp3.train, device=d)[1]
    gpu3_h, cpu3_h = np.asarray(parity3["card"]), np.asarray(parity3["cpu"])
    check(len(gpu3_h) == len(cpu3_h) == pexp3.train.n_iters,
          f"GS3D parity histories {gpu3_h.tolist()} and {cpu3_h.tolist()}")
    parity3_err = float(np.max(np.abs(gpu3_h - cpu3_h) / np.abs(cpu3_h)))
    check(np.allclose(gpu3_h, cpu3_h, rtol=1e-4, atol=0),
          f"GS3D train on the card vs the CPU: {gpu3_h.tolist()} vs {cpu3_h.tolist()}")
    phase("train3d_parity", grid=pexp3.grid, steps=pexp3.train_steps,
          iters=pexp3.train.n_iters, watchdog=pexp3.train.watchdog, card=gpu3_h.tolist(),
          cpu=cpu3_h.tolist(), max_rel_err=parity3_err, rtol=1e-4)

    # serve3d: the trained GS3D model through the entry point a user calls
    serve3 = build_serving_fn(res3["params"], cfg3, GS3D_RECON.infer_steps, isg_cfg=isg3,
                              device=dev)
    serve3_final = build_serving_fn(res3["params"], cfg3, GS3D_RECON.infer_steps, isg_cfg=isg3,
                                    final_only=True, device=dev)
    request3 = add_noise(default_ic("gray_scott_3d", n3, seed=SEEDS[0])[None],
                         GS3D_RECON.noise_pct, seed=SEEDS[0])[0][::isg3.scale, ::isg3.scale,
                                                                 ::isg3.scale]
    warmup3_s = []
    for fn in (serve3, serve3_final):
        t = time.perf_counter()
        fn(request3)
        torch.cuda.synchronize()
        warmup3_s.append(time.perf_counter() - t)
    cell3d.fused_rollout_3d.launches = cell3d.fused_rollout_3d.steps = 0
    request_s, enqueue_s = [], []
    answer3 = timed(serve3, request3)
    final3 = timed(serve3_final, request3)
    serve3_counts = (cell3d.fused_rollout_3d.launches, cell3d.fused_rollout_3d.steps)
    serve3_launches = {"rollout3d_persistent_kernel": serve3_counts[0]}
    check(tuple(answer3.shape) == (GS3D_RECON.infer_steps + 1, n3, n3, n3, 2)
          and bool(torch.isfinite(answer3).all()), "GS3D frames not finite or misshapen")
    check(tuple(final3.shape) == (n3, n3, n3, 2) and bool(torch.isfinite(final3).all()),
          "GS3D final state not finite or misshapen")
    final3_err = max_abs(final3, answer3[-1])
    check(allclose(final3, answer3[-1], rtol=1e-6, atol=1e-7),
          f"GS3D final-state request vs last frame: max |diff| {final3_err}")
    # one launch a request
    check(serve3_counts == (2, 2 * GS3D_RECON.infer_steps),
          f"GS3D serving (launches, steps) {serve3_counts}")
    phase("serve3d", requests=2, steps=GS3D_RECON.infer_steps, launches=serve3_launches,
          launches_and_steps=serve3_counts,
          request_seconds=request_s, enqueue_seconds=enqueue_s,
          request_order="frames, then final-state",
          warmup_request_seconds=dict(zip(("frames", "final_state"), warmup3_s)),
          final_vs_last_frame_max_abs_err=final3_err)

    # serve_burgers: the golden Burgers model's frames and its final state
    # (rollout2d_kxk_persistent_kernel, and the same in its final-state
    # mode), through the entry point a user calls
    serveb = build_serving_fn(modelb, cfgb, BURGERS_STAGE1.infer_steps, isg_cfg=isgb,
                              device=dev)
    serveb_final = build_serving_fn(modelb, cfgb, BURGERS_STAGE1.infer_steps, isg_cfg=isgb,
                                    final_only=True, device=dev)
    requestsb = [add_noise(default_ic("burgers", nb_grid, seed=s)[None],
                           BURGERS_STAGE1.noise_pct, seed=s)[0][::isgb.scale, ::isgb.scale]
                 for s in SEEDS]
    warmupb_s = []
    for fn in (serveb, serveb_final):
        t = time.perf_counter()
        fn(requestsb[-1])
        torch.cuda.synchronize()
        warmupb_s.append(time.perf_counter() - t)
    zero_counts()
    request_s, enqueue_s = [], []
    answersb = [timed(serveb, req) for req in requestsb]
    finalb = timed(serveb_final, requestsb[0])
    serveb_launches = {"rollout2d_kxk_persistent_kernel": cell2d.fused_rollout_kxk_2d.launches,
                       "rollout2d_kxk_persistent_kernel[final]":
                           cell2d.fused_rollout_final_2d.launches_kxk}
    serveb_steps = {"rollout2d_kxk_persistent_kernel": cell2d.fused_rollout_kxk_2d.steps,
                    "rollout2d_kxk_persistent_kernel[final]":
                        cell2d.fused_rollout_final_2d.steps_kxk}
    for a in answersb:
        check(tuple(a.shape) == (BURGERS_STAGE1.infer_steps + 1, nb_grid, nb_grid, 2)
              and bool(torch.isfinite(a).all()), "Burgers frames not finite or misshapen")
    check(tuple(finalb.shape) == (nb_grid, nb_grid, 2) and bool(torch.isfinite(finalb).all()),
          "Burgers final state not finite or misshapen")
    # the frames and the final state come from one kernel: held to each
    # other at GS2D's bar
    finalb_err = max_abs(finalb, answersb[0][-1])
    check(allclose(finalb, answersb[0][-1], rtol=1e-6, atol=1e-7),
          f"Burgers final-state request vs last frame: max |diff| {finalb_err}")
    # one launch a request, frames or final state
    check(serveb_launches == {"rollout2d_kxk_persistent_kernel": len(SEEDS),
                              "rollout2d_kxk_persistent_kernel[final]": 1}
          and serveb_steps == {"rollout2d_kxk_persistent_kernel":
                                   len(SEEDS) * BURGERS_STAGE1.infer_steps,
                               "rollout2d_kxk_persistent_kernel[final]":
                                   BURGERS_STAGE1.infer_steps},
          f"Burgers serving launch counts {serveb_launches}, steps {serveb_steps}")
    phase("serve_burgers", requests=len(requestsb) + 1, steps=BURGERS_STAGE1.infer_steps,
          launches=serveb_launches, steps_run=serveb_steps, request_seconds=request_s,
          enqueue_seconds=enqueue_s,
          request_order="frames x 3, then final-state",
          warmup_request_seconds=dict(zip(("frames", "final_state"), warmupb_s)),
          final_vs_last_frame_max_abs_err=finalb_err,
          max_abs_frame=[float(a.abs().max()) for a in answersb])

    # train_burgers: the main path of Burgers Stage-1 training, through the
    # entry point a user calls
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_burgers_")
    # train_fallback and train_ensemble reuse it
    truth_cache = tempfile.mkdtemp(prefix="chip_smoke_truth_")
    try:
        zero_counts()
        with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
            resb = runner.run_experiment(BURGERS_STAGE1, device=dev, out_dir=out_dir,
                                         cache_dir=truth_cache,
                                         n_iters_override=TRAIN_BURGERS_ITERS,
                                         isg_pretrain_override=ISG_PRETRAIN_ITERS, seed=0)
        torch.cuda.synchronize()
        trainb_counts = read_counts()
        trainb_launches = {
            "rollout2d_kxk_persistent_kernel": trainb_counts.get("fused_rollout_kxk_2d.launches"),
            "adj2d_kxk_persistent_kernel": trainb_counts.get("fused_rollout_tp_2d.launches")}
        best_tree, best_meta = load_checkpoint_tree(
            os.path.join(out_dir, f"{BURGERS_STAGE1.name}.ckpt.npz.best"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    stepsb = BURGERS_STAGE1.train_steps
    # one launch of each one-launch kernel an iteration, one for the evaluation
    wantb = {"fused_rollout_kxk_2d.launches": TRAIN_BURGERS_ITERS + 1,
             "fused_rollout_kxk_2d.steps": TRAIN_BURGERS_ITERS * stepsb
             + BURGERS_STAGE1.infer_steps,
             "fused_rollout_tp_2d.launches": TRAIN_BURGERS_ITERS,
             "fused_rollout_tp_2d.steps": TRAIN_BURGERS_ITERS * stepsb}
    histb = resb["history"]
    check(len(histb) == TRAIN_BURGERS_ITERS and bool(np.isfinite(histb).all()),
          f"Burgers training losses {histb}")
    check(trainb_counts == wantb,
          f"Burgers training launch counts {trainb_counts}, expected {wantb}")
    check(bool(np.isfinite(resb["rel_l2"])) and not resb["diverged"],
          f"Burgers evaluation rel_l2 {resb['rel_l2']}, diverged {resb['diverged']}")
    # best_val: the evaluated params are the .best checkpoint's
    for (path, a), (_, b) in zip(flatten_with_paths(resb["params"]),
                                 flatten_with_paths(best_tree["params"])):
        check(np.array_equal(a.detach().cpu().numpy(), np.asarray(b)),
              f"Burgers evaluated params differ from the best-val checkpoint at {path}")
    secb = resb["seconds"]
    phase("train_burgers", experiment=BURGERS_STAGE1.name, grid=nb_grid,
          launches=trainb_counts, expected_launches=wantb,
          truth_frames=BURGERS_STAGE1.infer_steps, truth_s=secb["truth"],
          isg_pretrain_iters=ISG_PRETRAIN_ITERS, isg_pretrain_s=secb["isg_pretrain"],
          stages=[{**st, "ms_per_iter": 1e3 * st["seconds"] / st["iters"]}
                  for st in secb["stages"]],
          evaluate_s=secb["evaluate"], history=histb, best_val=best_meta.get("best_val"),
          best_iteration=best_meta.get("iteration"), rel_l2=resb["rel_l2"],
          rel_l2_u=resb["rel_l2_u"], rel_l2_v=resb["rel_l2_v"])

    # train_burgers_parity: Burgers training on the card against its plain self
    pexpb = dataclasses.replace(
        BURGERS_STAGE1, grid=32, train_steps=20, infer_steps=20,
        train=dataclasses.replace(BURGERS_STAGE1.train, n_iters=5, steps_per_call=5))
    ptruthb = simulate(pexpb.system, default_ic(pexpb.system, pexpb.grid), pexpb.train_steps,
                       pexpb.dt, pexpb.dx, device=dev)
    initb = params_to_numpy(runner.init_model(pexpb, torch.Generator().manual_seed(0),
                                              device="cpu"))
    parityb = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        prob = runner.setup_problem(pexpb, ptruthb, device=d)
        with contextlib.redirect_stdout(sys.stderr):
            parityb[label] = train(runner.build_loss_fn(prob, pexpb.train_steps), initb,
                                   pexpb.train, device=d)[1]
    gpub_h, cpub_h = np.asarray(parityb["card"]), np.asarray(parityb["cpu"])
    parityb_err = float(np.max(np.abs(gpub_h - cpub_h) / np.abs(cpub_h)))
    check(np.allclose(gpub_h, cpub_h, rtol=1e-4, atol=0),
          f"Burgers train on the card vs the CPU: {gpub_h.tolist()} vs {cpub_h.tolist()}")
    phase("train_burgers_parity", grid=pexpb.grid, steps=pexpb.train_steps,
          iters=pexpb.train.n_iters, card=gpub_h.tolist(), cpu=cpub_h.tolist(),
          max_rel_err=parityb_err, rtol=1e-4)

    # train_fallback: the fallback routes through the entry points a user
    # calls, every launch counted: run_experiment(BURGERS_STAGE1) with the
    # MXU switches off (rollout2d_ffma_persistent_kernel,
    # adj2d_ys_persistent_kernel) on
    # train_burgers' cached truth; build_loss_fn(bptt="fused") and train for
    # GS2D at T = 800 (rollout2d_cluster_kernel, adj2d_persistent_kernel), GS3D at T = 300
    # (rollout3d_persistent_kernel, adj3d_kernel) and Burgers with YS_PATH_ENABLED off
    # too (rollout2d_ffma_persistent_kernel and adj2d_kernel at k = 5), from seeded random
    # inits, on served frames as the data
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_fallback_")
    try:
        zero_counts()
        with switches(False, False, True), contextlib.redirect_stdout(sys.stderr):
            resf = runner.run_experiment(BURGERS_STAGE1, device=dev, out_dir=out_dir,
                                         cache_dir=truth_cache,
                                         n_iters_override=TRAIN_BURGERS_ITERS,
                                         isg_pretrain_override=ISG_PRETRAIN_ITERS, seed=0)
        torch.cuda.synchronize()
        fallback_launches = {"burgers_mxu_off": read_counts()}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # one launch a rollout (10 iterations and the evaluation) and a sweep
    fallback_want = {"burgers_mxu_off": {
        "fused_rollout_2d.launches_kxk": TRAIN_BURGERS_ITERS + 1,
        "fused_rollout_2d.steps_kxk": TRAIN_BURGERS_ITERS * stepsb + BURGERS_STAGE1.infer_steps,
        "fused_phase1_ys_2d.launches": TRAIN_BURGERS_ITERS,
        "fused_phase1_ys_2d.steps": TRAIN_BURGERS_ITERS * stepsb}}
    histf = resf["history"]
    check(len(histf) == TRAIN_BURGERS_ITERS and bool(np.isfinite(histf).all()),
          f"Burgers training with the MXU switches off: losses {histf}")
    check(bool(np.isfinite(resf["rel_l2"])) and not resf["diverged"],
          f"Burgers evaluation with the MXU switches off: rel_l2 {resf['rel_l2']}")
    # the same run as train_burgers on another route: the same losses
    hist_err = float(np.max(np.abs(np.asarray(histf) - np.asarray(histb)) / np.abs(histb)))
    check(hist_err <= 1e-4, f"Burgers losses with the MXU switches off vs on: {histf} vs {histb}")
    fallback_hist = {"burgers_mxu_off": histf}

    def train_fused(label, exp, frames, steps, iters, flags, want_counts):
        prob_ = runner.setup_problem(exp, frames.cpu().numpy(), device=dev)
        init_ = params_to_numpy(runner.init_model(exp, torch.Generator().manual_seed(0),
                                                  device="cpu"))
        tcfg = dataclasses.replace(exp.train, n_iters=iters, steps_per_call=iters,
                                   watchdog=False, probe_every=0)
        zero_counts()
        with switches(*flags), contextlib.redirect_stdout(sys.stderr):
            hist_ = train(runner.build_loss_fn(prob_, steps, bptt="fused"), init_, tcfg,
                          device=dev)[1]
        torch.cuda.synchronize()
        fallback_launches[label] = read_counts()
        fallback_want[label] = want_counts
        fallback_hist[label] = hist_
        check(len(hist_) == iters and bool(np.isfinite(hist_).all()),
              f"{label} training losses {hist_}")

    t2, t3 = GS2D_RECON.train_steps, GS3D_RECON.train_steps
    train_fused("gs2d_fused", GS2D_RECON, answers[0], t2, FALLBACK_ITERS, (True, True, True),
                {"fused_rollout_2d.launches": FALLBACK_ITERS,
                 "fused_rollout_2d.steps": FALLBACK_ITERS * t2,
                 "fused_phase1_2d.launches": FALLBACK_ITERS,
                 "fused_phase1_2d.steps": FALLBACK_ITERS * t2})
    train_fused("gs3d_fused", GS3D_RECON, answer3, t3, FALLBACK_ITERS, (True, True, True),
                {"fused_rollout_3d.launches": FALLBACK_ITERS,
                 "fused_rollout_3d.steps": FALLBACK_ITERS * t3,
                 "fused_phase1_3d.launches": FALLBACK_ITERS,
                 "fused_phase1_3d.steps": FALLBACK_ITERS * t3})
    train_fused("burgers_ys_off", BURGERS_STAGE1, answersb[0], stepsb, FALLBACK_YS_OFF_ITERS,
                (False, False, False),
                {"fused_rollout_2d.launches_kxk": FALLBACK_YS_OFF_ITERS,
                 "fused_rollout_2d.steps_kxk": FALLBACK_YS_OFF_ITERS * stepsb,
                 "fused_phase1_2d.launches": FALLBACK_YS_OFF_ITERS,
                 "fused_phase1_2d.steps": FALLBACK_YS_OFF_ITERS * stepsb})
    check(fallback_launches == fallback_want,
          f"fallback training launch counts {fallback_launches}, expected {fallback_want}")
    secf = resf["seconds"]
    phase("train_fallback", launches=fallback_launches, histories=fallback_hist,
          burgers_mxu_off={"stages": [{**st, "ms_per_iter": 1e3 * st["seconds"] / st["iters"]}
                                      for st in secf["stages"]],
                           "truth_s": secf["truth"], "evaluate_s": secf["evaluate"],
                           "rel_l2": resf["rel_l2"], "rel_l2_mxu_on": resb["rel_l2"],
                           "history_max_rel_err_vs_mxu_on": hist_err},
          steps={"gs2d_fused": t2, "gs3d_fused": t3, "burgers_ys_off": stepsb},
          iterations={"gs2d_fused": FALLBACK_ITERS, "gs3d_fused": FALLBACK_ITERS,
                      "burgers_ys_off": FALLBACK_YS_OFF_ITERS})

    # train_ensemble: the ensemble's main path through the entry point a user
    # calls, at full width: run_ensemble(GS2D_RECON, 4) in the batched modes
    # (rows 11-13) and "auto" (on the card the per-member loop of
    # rollout2d_cluster_kernel and pg2d_persistent_kernel), each with its
    # members' evaluation (rollout2d_cluster_kernel); then
    # run_ensemble(BURGERS_STAGE1, 2) in "batched"
    # (row 11 at k = 5 by rollout2d_ffma_persistent_kernel[batched] and row
    # 12 at k = 5 by adj2d_batched_ffma_persistent_kernel, one launch each a
    # call; the
    # evaluation by rollout2d_kxk_persistent_kernel).  The
    # truths come from the train and train_burgers phases' caches.
    per_ens = ENS_ITERS // len(stages)
    ens_steps = per_ens * sum(stages)
    ens_eval = ENS_MEMBERS * GS2D_RECON.infer_steps
    ens_want = {
        # an iteration: one launch of each one-launch batched kernel
        "batched_pg": {"fused_rollout_2d_batched.launches": ENS_ITERS,
                       "fused_rollout_2d_batched.steps": ens_steps,
                       "fused_phase1_pg_2d_batched.launches": ENS_ITERS,
                       "fused_phase1_pg_2d_batched.steps": ens_steps,
                       "fused_rollout_2d.launches": ENS_MEMBERS,
                       "fused_rollout_2d.steps": ens_eval},
        "batched": {"fused_rollout_2d_batched.launches": ENS_ITERS,
                    "fused_rollout_2d_batched.steps": ens_steps,
                    "fused_phase1_2d_batched.launches": ENS_ITERS,
                    "fused_phase1_2d_batched.steps": ens_steps,
                    "fused_rollout_2d.launches": ENS_MEMBERS,
                    "fused_rollout_2d.steps": ens_eval},
        # a member's iteration: one launch of each one-launch kernel
        "auto": {"fused_rollout_2d.launches": ENS_MEMBERS * ENS_ITERS + ENS_MEMBERS,
                 "fused_rollout_2d.steps": ENS_MEMBERS * ens_steps + ens_eval,
                 "fused_rollout_tp_2d_pg.launches": ENS_MEMBERS * ENS_ITERS,
                 "fused_rollout_tp_2d_pg.steps": ENS_MEMBERS * ens_steps},
        "burgers_batched": {
            # one rollout2d_ffma_persistent_kernel[batched] launch a forward
            "fused_rollout_2d_batched.launches_kxk": ENS_BURGERS_ITERS,
            "fused_rollout_2d_batched.steps_kxk": ENS_BURGERS_ITERS * stepsb,
            # one adj2d_batched_ffma_persistent_kernel launch a backward
            "fused_phase1_2d_batched.launches_kxk": ENS_BURGERS_ITERS,
            "fused_phase1_2d_batched.steps": ENS_BURGERS_ITERS * stepsb,
            "fused_rollout_kxk_2d.launches": ENS_KXK_MEMBERS,
            "fused_rollout_kxk_2d.steps": ENS_KXK_MEMBERS * BURGERS_STAGE1.infer_steps},
    }
    ens_res, ens_launches, ens_s = {}, {}, {}
    try:
        for label, exp_, n_mem, n_iters, bptt, cache in (
                ("batched_pg", GS2D_RECON, ENS_MEMBERS, ENS_ITERS, "batched_pg", truth_cache2d),
                ("batched", GS2D_RECON, ENS_MEMBERS, ENS_ITERS, "batched", truth_cache2d),
                ("auto", GS2D_RECON, ENS_MEMBERS, ENS_ITERS, "auto", truth_cache2d),
                ("burgers_batched", BURGERS_STAGE1, ENS_KXK_MEMBERS, ENS_BURGERS_ITERS, "batched",
                 truth_cache)):
            out_dir = tempfile.mkdtemp(prefix="chip_smoke_ensemble_")
            try:
                zero_counts()
                t = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
                    ens_res[label] = ensemble.run_ensemble(
                        exp_, n_mem, out_dir=out_dir, cache_dir=cache, n_iters_override=n_iters,
                        isg_pretrain_override=ISG_PRETRAIN_ITERS, bptt=bptt, seed=0, device=dev)
                torch.cuda.synchronize()
                ens_s[label] = time.perf_counter() - t
                ens_launches[label] = read_counts()
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        shutil.rmtree(truth_cache, ignore_errors=True)
    check(ens_launches == ens_want,
          f"ensemble training launch counts {ens_launches}, expected {ens_want}")
    for label, r in ens_res.items():
        n_mem = ENS_KXK_MEMBERS if label.startswith("burgers") else ENS_MEMBERS
        n_iters = ENS_BURGERS_ITERS if label.startswith("burgers") else ENS_ITERS
        check(len(r["history"]) == n_iters and bool(np.isfinite(r["history"]).all()),
              f"ensemble {label}: losses {r['history']}")
        check(len(r["rel_l2_members"]) == n_mem and bool(np.isfinite(r["rel_l2_members"]).all()),
              f"ensemble {label}: members' rel_l2 {r['rel_l2_members']}")
    # the three GS2D runs train the same members on the same data by three
    # routes: the same losses
    ens_hist_err = {label: float(np.max(np.abs(np.asarray(ens_res[label]["history"])
                                               - np.asarray(ens_res["batched_pg"]["history"]))
                                        / np.abs(ens_res["batched_pg"]["history"])))
                    for label in ("batched", "auto")}
    check(max(ens_hist_err.values()) <= 1e-4,
          f"ensemble losses by route differ: {ens_hist_err} (rtol 1e-4)")
    phase("train_ensemble", members={"gs2d": ENS_MEMBERS, "burgers": ENS_KXK_MEMBERS},
          stages={"gs2d": stages, "burgers": [stepsb]},
          iterations={"gs2d": ENS_ITERS, "burgers": ENS_BURGERS_ITERS},
          isg_pretrain_iters=ISG_PRETRAIN_ITERS, launches=ens_launches,
          expected_launches=ens_want, seconds=ens_s,
          history={k: r["history"] for k, r in ens_res.items()},
          history_max_rel_err_vs_batched_pg=ens_hist_err,
          rel_l2_members={k: r["rel_l2_members"] for k, r in ens_res.items()},
          rel_l2_mean={k: r["rel_l2_mean"] for k, r in ens_res.items()},
          rel_l2_std={k: r["rel_l2_std"] for k, r in ens_res.items()})

    # train_mesh: run_experiment(GS2D_RECON) on the 2 x 2 mesh of cuda:0
    # (parallel_impl="halo": the eager valid step on each block, as
    # percnn_tpu's runner keeps it) and the same run without a mesh, on the
    # train phase's cached truth: ISG pretrain, one iteration at each of
    # T = 200, 400, 800 and the 2500-step evaluation, launches counted; the
    # losses of the two held to each other at rtol 1e-4, as
    # tests/test_parallel.py holds percnn_tpu's first five
    per_mesh = MESH_ITERS // len(stages)
    mesh_want = {
        "single": {"fused_rollout_2d.launches": MESH_ITERS + 1,
                   "fused_rollout_2d.steps": per_mesh * sum(stages) + GS2D_RECON.infer_steps,
                   "fused_rollout_tp_2d_pg.launches": MESH_ITERS,
                   "fused_rollout_tp_2d_pg.steps": per_mesh * sum(stages)},
        "mesh": {"fused_rollout_2d.launches": 1,
                 "fused_rollout_2d.steps": GS2D_RECON.infer_steps},
    }
    mesh_res, mesh_launches = {}, {}
    try:
        for label, mesh_ in (("single", None), ("mesh", mesh)):
            out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
            try:
                zero_counts()
                with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
                    mesh_res[label] = runner.run_experiment(
                        GS2D_RECON, device=dev, out_dir=out_dir, cache_dir=truth_cache2d,
                        n_iters_override=MESH_ITERS, isg_pretrain_override=ISG_PRETRAIN_ITERS,
                        seed=0, mesh=mesh_)
                torch.cuda.synchronize()
                mesh_launches[label] = read_counts()
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        shutil.rmtree(truth_cache2d, ignore_errors=True)
    check(mesh_launches == mesh_want,
          f"mesh training launch counts {mesh_launches}, expected {mesh_want}")
    hist_m, hist_s = (np.asarray(mesh_res[k]["history"]) for k in ("mesh", "single"))
    check(len(hist_m) == MESH_ITERS and bool(np.isfinite(hist_m).all()),
          f"mesh training losses {hist_m.tolist()}")
    mesh_hist_err = float(np.max(np.abs(hist_m - hist_s) / np.abs(hist_s)))
    check(mesh_hist_err <= 1e-4, f"mesh vs unsharded losses: {hist_m.tolist()} vs "
                                 f"{hist_s.tolist()} (rtol 1e-4)")
    for label, r in mesh_res.items():
        check(bool(np.isfinite(r["rel_l2"])) and not r["diverged"],
              f"{label} evaluation rel_l2 {r['rel_l2']}, diverged {r['diverged']}")
    phase("train_mesh", mesh=mesh.shape, iterations=MESH_ITERS, stages=stages,
          isg_pretrain_iters=ISG_PRETRAIN_ITERS, launches=mesh_launches,
          history={k: r["history"] for k, r in mesh_res.items()},
          history_max_rel_err=mesh_hist_err, rtol=1e-4,
          ms_per_iter={k: [1e3 * st["seconds"] / st["iters"] for st in r["seconds"]["stages"]]
                       for k, r in mesh_res.items()},
          evaluate_s={k: r["seconds"]["evaluate"] for k, r in mesh_res.items()},
          rel_l2={k: r["rel_l2"] for k, r in mesh_res.items()})

    # train_ensemble_parity: ensemble training on the card against the CPU
    # (the plain versions), both batched modes
    eexp = dataclasses.replace(
        GS2D_RECON, grid=32, train_steps=20, infer_steps=20, curriculum=(),
        data=dataclasses.replace(GS2D_RECON.data, time_stride=10),
        train=dataclasses.replace(GS2D_RECON.train, n_iters=3, steps_per_call=3))
    ens_parity = {}
    for bptt in ("batched_pg", "batched"):
        runs = {}
        for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
            out_dir = tempfile.mkdtemp(prefix="chip_smoke_ensemble_parity_")
            try:
                with contextlib.redirect_stdout(sys.stderr):
                    runs[label] = ensemble.run_ensemble(
                        eexp, ENS_KXK_MEMBERS, out_dir=out_dir, cache_dir=None,
                        isg_pretrain_override=20, bptt=bptt, seed=0, device=d)
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
        card = np.asarray(runs["card"]["history"] + runs["card"]["rel_l2_members"])
        cpu = np.asarray(runs["cpu"]["history"] + runs["cpu"]["rel_l2_members"])
        check(len(runs["card"]["history"]) == eexp.train.n_iters
              and np.allclose(card, cpu, rtol=1e-4, atol=0),
              f"ensemble {bptt} on the card vs the CPU: {card.tolist()} vs {cpu.tolist()}")
        ens_parity[bptt] = {"card": card.tolist(), "cpu": cpu.tolist(),
                            "max_rel_err": float(np.max(np.abs(card - cpu) / np.abs(cpu)))}
    phase("train_ensemble_parity", grid=eexp.grid, steps=eexp.train_steps,
          iters=eexp.train.n_iters, members=ENS_KXK_MEMBERS,
          compared="the loss history, then the members' rel_l2", rtol=1e-4, **ens_parity)

    # step_breakdown: where one training iteration's time goes at each T, with
    # the trained params; a served rollout stands in for the truth (the
    # times do not depend on the data)
    def event_ms(fn):
        """fn() and the device ms between events recorded around it, with
        the stream idle before: the segment's kernels and any gap while the
        host enqueues them."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def breakdown(exp, bprob, trained, stages, bwd_kernel, pg_name, want_counts):
        """bwd_kernel(cell params) -> run(frames, cotangent): the backward
        kernel alone, its parameters packed beforehand; want_counts(T): the
        launch and step counts of one iteration at T, checked on the
        warm-up."""
        rows_out = []
        for steps in stages:
            tp = params_from_numpy(trained, device=dev, dtype=torch.float32)
            leaves = [t.requires_grad_(True) for _, t in flatten_with_paths(tp)]
            opt = torch.optim.Adam(leaves, lr=exp.train.lr, eps=1e-8)
            loss_fn = runner.build_loss_fn(bprob, steps)

            def iteration():
                opt.zero_grad(set_to_none=True)
                total, _ = loss_fn(tp)
                total.backward()
                opt.step()

            zero_counts()
            iteration()   # warm-up, not timed: its launches and steps are counted
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts == want_counts(steps),
                  f"{exp.name} iteration at T = {steps}: counts {counts}, expected "
                  f"{want_counts(steps)}")
            rows = []
            for _ in range(BREAKDOWN_REPS):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                start.record()
                iteration()
                end.record()
                enqueue_ms = 1e3 * (time.perf_counter() - t)
                torch.cuda.synchronize()
                iteration_ms = 1e3 * (time.perf_counter() - t)
                device_ms = start.elapsed_time(end)
                opt.zero_grad(set_to_none=True)
                frames, fwd_ms = event_ms(
                    lambda: runner.forward_rollout(tp, bprob, steps, device=dev))
                (total, _), loss_ms = event_ms(
                    lambda: runner.build_loss_fn(bprob, steps, rollout_fn=lambda _: frames)(tp))
                _, bwd_ms = event_ms(total.backward)
                _, adam_ms = event_ms(opt.step)
                fr = frames.detach()
                fb = cotangent(fr, exp)[1].contiguous()
                run = bwd_kernel(tp["cell"])
                _, pg_ms = event_ms(lambda: run(fr, fb))
                rows.append([iteration_ms, enqueue_ms, device_ms, fwd_ms, loss_ms, bwd_ms,
                             pg_ms, adam_ms])
            med = np.median(np.asarray(rows), axis=0).tolist()
            rows_out.append({**dict(zip(
                ["steps", "iteration_ms", "enqueue_ms", "device_span_ms", "isg_and_forward_ms",
                 "losses_ms", "backward_ms", f"{pg_name}_ms", "adam_ms"], [steps] + med)),
                "counts_per_iteration": counts, "profiled": profile_busy(torch, iteration)})
            # the profiled busy time over the unprofiled device span
            rows_out[-1]["device_idle_share_of_span"] = (
                1.0 - rows_out[-1]["profiled"]["device_busy_ms"]
                / rows_out[-1]["device_span_ms"])
        return rows_out

    note = ("iteration_ms: host clock to the synchronised end of a whole iteration; "
            "enqueue_ms: host clock until the iteration's last op is enqueued; "
            "device_span_ms: CUDA events around the whole iteration; the segments: "
            "CUDA events around each run alone, backward_ms includes the backward kernel's "
            "ms; "
            "profiled: one more iteration under torch.profiler; "
            "device_idle_share_of_span: 1 - its busy ms / device_span_ms")
    def pg_kernel(pg_cuda, cfg_):
        def bind(cell_params):
            own = cell2d.pack_pi_params_2d(cell_params, cfg_).detach()
            return lambda fr, fb: pg_cuda(own, fr, fb, cfg_)
        return bind

    def adj_kxk_kernel(cell_params):
        wm = cell2d.pack_pi_matrix_2d(cell_params, cfgb).detach().contiguous()
        tl = cell2d.pi_tail_2d(cell_params, cfgb).detach()
        return lambda fr, fb: backward2d._phase1_kxk_cuda(wm, tl, fr, fb, cfgb)

    def one_launch_each(fwd, bwd):
        """An iteration's counts when its forward and backward run one launch
        of T steps each."""
        return lambda steps: {f"{fwd}.launches": 1, f"{fwd}.steps": steps,
                              f"{bwd}.launches": 1, f"{bwd}.steps": steps}

    bprob = runner.setup_problem(GS2D_RECON, answers[0].cpu().numpy(), device=dev)
    phase("step_breakdown", reps=BREAKDOWN_REPS, statistic="median, after one warm-up",
          rows=breakdown(GS2D_RECON, bprob, res["params"], stages,
                         pg_kernel(backward2d._pg_cuda, cfg), "pg2d_persistent_kernel",
                         one_launch_each("fused_rollout_2d", "fused_rollout_tp_2d_pg")),
          note=note)
    bprob3 = runner.setup_problem(GS3D_RECON, answer3.cpu().numpy(), device=dev)
    phase("step_breakdown3d", reps=BREAKDOWN_REPS, statistic="median, after one warm-up",
          rows=breakdown(GS3D_RECON, bprob3, res3["params"], stages3,
                         pg_kernel(backward3d._pg_cuda, cfg3), "pg3d_persistent_kernel",
                         one_launch_each("fused_rollout_3d", "fused_rollout_tp_3d_pg")),
          note=note)
    del bprob3, answer3, final3
    bprobb = runner.setup_problem(BURGERS_STAGE1, answersb[0].cpu().numpy(), device=dev)
    phase("step_breakdown_kxk", reps=BREAKDOWN_REPS, statistic="median, after one warm-up",
          rows=breakdown(BURGERS_STAGE1, bprobb, resb["params"], [BURGERS_STAGE1.train_steps],
                         adj_kxk_kernel, "adj2d_kxk_persistent_kernel",
                         one_launch_each("fused_rollout_kxk_2d", "fused_rollout_tp_2d")),
          note=note)
    del bprobb, answersb

    # step_breakdown_ensemble: one ensemble iteration at T = 800, M = 4, by
    # the batched kernels ("batched_pg") and by the per-member loop of the
    # single model's kernels ("auto", which is "fused_pg" on the card), from
    # train_ensemble's params; served frames stand in for the truth
    eprobs = [runner.setup_problem(dataclasses.replace(GS2D_RECON, seed=GS2D_RECON.seed + k),
                                   answers[0].cpu().numpy(), device=dev)
              for k in range(ENS_MEMBERS)]
    ens_rows = {}
    for label, mode in (("batched_pg", "batched_pg"), ("auto", ensemble.auto_bptt(GS2D_RECON))):
        tp = params_from_numpy(params_to_numpy(ens_res["batched_pg"]["params"]), device=dev,
                               dtype=torch.float32)
        leaves = [t.requires_grad_(True) for _, t in flatten_with_paths(tp)]
        opt = torch.optim.Adam(leaves, lr=GS2D_RECON.train.lr, eps=1e-8)
        loss_fn = ensemble.build_ensemble_loss_fn(GS2D_RECON, eprobs, GS2D_RECON.train_steps, mode)

        def ens_iteration():
            opt.zero_grad(set_to_none=True)
            total, _ = loss_fn(tp)
            total.backward()
            opt.step()

        zero_counts()
        ens_iteration()   # warm-up, not timed: its launches and steps are counted
        torch.cuda.synchronize()
        ens_counts = read_counts()
        t_ens = GS2D_RECON.train_steps
        want_ens = ({"fused_rollout_2d_batched.launches": 1, "fused_rollout_2d_batched.steps": t_ens,
                     "fused_phase1_pg_2d_batched.launches": 1,
                     "fused_phase1_pg_2d_batched.steps": t_ens} if mode == "batched_pg" else
                    {"fused_rollout_2d.launches": ENS_MEMBERS,
                     "fused_rollout_2d.steps": ENS_MEMBERS * t_ens,
                     "fused_rollout_tp_2d_pg.launches": ENS_MEMBERS,
                     "fused_rollout_tp_2d_pg.steps": ENS_MEMBERS * t_ens})
        check(ens_counts == want_ens, f"ensemble iteration ({mode}): counts {ens_counts}, "
                                      f"expected {want_ens}")
        rows = []
        for _ in range(BREAKDOWN_REPS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            ens_iteration()
            end.record()
            enqueue_ms = 1e3 * (time.perf_counter() - t)
            torch.cuda.synchronize()
            rows.append([1e3 * (time.perf_counter() - t), enqueue_ms, start.elapsed_time(end)])
        med = np.median(np.asarray(rows), axis=0).tolist()
        prof = profile_busy(torch, ens_iteration)
        ens_rows[label] = {"bptt": mode, "iteration_ms": med[0], "enqueue_ms": med[1],
                           "device_span_ms": med[2], "counts_per_iteration": ens_counts,
                           "profiled": prof,
                           "device_idle_share_of_span": 1.0 - prof["device_busy_ms"] / med[2]}
    del eprobs
    phase("step_breakdown_ensemble", members=ENS_MEMBERS, steps=GS2D_RECON.train_steps,
          reps=BREAKDOWN_REPS, statistic="median, after one warm-up", rows=ens_rows,
          note="as step_breakdown, for a whole ensemble iteration (ISG, rollouts, losses, "
               "backward and Adam of every member)")

    # times: per rollout at the serving shape (the ISG output of request 0)
    with torch.inference_mode():
        h0 = isg_apply(params["isg"], torch.as_tensor(requests[0], dtype=torch.float32,
                                                      device=dev)[None], isg_cfg)[0].contiguous()
    cells = h0.shape[0] * h0.shape[1]
    flops = SERVE_STEPS * cells * flops_per_cell_step(cfg)
    state_bytes, param_bytes = 8 * cells, 4 * packed.numel()
    # rows 1 and 7 run their T steps in one launch; beside each, its per-step
    # route (rollout2d_kernel, pg2d_kernel) at the same shape, timed in turns
    # (per-step, one-launch, one-launch, per-step) in this call
    def turns(one_launch, per_step, reps):
        a1, b1 = cuda_ms(torch, per_step, reps), cuda_ms(torch, one_launch, reps)
        b2, a2 = cuda_ms(torch, one_launch, reps), cuda_ms(torch, per_step, reps)
        return (b1 + b2) / 2, (a1 + a2) / 2, {"per_step": [a1, a2], "one_launch": [b1, b2]}

    row1_ms, row1_steps_ms, row1_turns = turns(
        lambda: cell2d._rollout_cluster_cuda(packed, h0, cfg, SERVE_STEPS),
        lambda: cell2d._rollout_steps_cuda(packed, h0, cfg, SERVE_STEPS), reps=5)
    # row 2 at k = 1 the same way: the cluster's final-state mode against
    # final2d_kernel
    row2_ms, row2_steps_ms, row2_turns = turns(
        lambda: cell2d._rollout_cluster_cuda(packed, h0, cfg, SERVE_STEPS, final_only=True),
        lambda: cell2d._final_steps_cuda(packed, h0, cfg, SERVE_STEPS), reps=5)
    row2_plain_ms = cuda_ms(torch, lambda: cell2d.fused_rollout_final_2d_plain(
        packed, h0, cfg, SERVE_STEPS), reps=1, warm=False)
    b1_ms, b1_by = bound_ms(param_bytes + state_bytes + (SERVE_STEPS + 1) * state_bytes, flops)
    b2_ms, b2_by = bound_ms(param_bytes + 2 * state_bytes, flops)
    # row 1 in the ensemble: the members' evaluations, and the per-member
    # loop of "auto"
    ens_row1 = sum(c.get("fused_rollout_2d.launches", 0) for c in ens_launches.values())
    by_path1 = {"serve": launches["rollout2d_cluster_kernel"],
                "train": train_launches["rollout2d_cluster_kernel"], "ensemble": ens_row1}
    kernels = [{
        "name": "rollout2d_cluster_kernel", "jax_kernel": "cell2d._rollout_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
        "replaces": "percnn_tpu/ops/pallas/cell2d.py:332",
        "launches": sum(by_path1.values()), "launches_by_path": by_path1,
        "max_abs_err": err["rollout2d_cluster_kernel"], "ms": row1_ms,
        "plain_ms": cuda_ms(torch, lambda: cell2d.fused_rollout_2d_plain(
            packed, h0, cfg, SERVE_STEPS), reps=1, warm=False),
        "bound_ms": b1_ms, "bound_by": b1_by, "library_ms": None,
        "steps": SERVE_STEPS, "launches_per_call": 1, "us_per_step": 1e3 * row1_ms / SERVE_STEPS,
        "per_step_route": {"name": "rollout2d_kernel", "launches_per_call": SERVE_STEPS,
                           "ms": row1_steps_ms, "us_per_step": 1e3 * row1_steps_ms / SERVE_STEPS,
                           "max_abs_err": err["rollout2d_kernel[per_step]"]},
        "turns_ms": row1_turns, "plan": one_launch["rollout2d_cluster_kernel"],
    }, {
        "name": "rollout2d_cluster_kernel[final]", "jax_kernel": "cell2d._final_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
        "replaces": "percnn_tpu/ops/pallas/cell2d.py:384",
        "launches": launches["rollout2d_cluster_kernel[final]"],
        "launches_by_path": {"serve": launches["rollout2d_cluster_kernel[final]"]},
        "max_abs_err": err["rollout2d_cluster_kernel[final]"], "ms": row2_ms,
        "plain_ms": row2_plain_ms, "bound_ms": b2_ms, "bound_by": b2_by, "library_ms": None,
        "steps": SERVE_STEPS, "launches_per_call": 1, "us_per_step": 1e3 * row2_ms / SERVE_STEPS,
        "per_step_route": {"name": "final2d_kernel", "launches_per_call": SERVE_STEPS,
                           "ms": row2_steps_ms, "us_per_step": 1e3 * row2_steps_ms / SERVE_STEPS,
                           "max_abs_err": err["final2d_kernel"]},
        "turns_ms": row2_turns, "plan": one_launch["rollout2d_cluster_kernel"],
    }, {
        "name": "final2d_kernel", "jax_kernel": "cell2d._final_kernel", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
        "replaces": "percnn_tpu/ops/pallas/cell2d.py:384",
        "launches": final_steps_launches["kernels (449 x 449)"],
        "launches_by_path": {"kernels (449 x 449)": final_steps_launches["kernels (449 x 449)"]},
        "max_abs_err": err["final2d_kernel"], "steps": SERVE_STEPS, "ms": row2_steps_ms,
        "plain_ms": row2_plain_ms, "bound_ms": b2_ms, "bound_by": b2_by, "library_ms": None,
        "note": "the per-step route past the one-launch plan's capacity; ms at 100 x 100"}]
    # the backward at the longest training stage: trained cell, data-loss cotangent
    frames = cell2d._rollout_cuda(packed, h0, cfg, TIME_BACKWARD_STEPS)
    fbar = cotangent(frames)[1].contiguous()
    bw_flops = TIME_BACKWARD_STEPS * cells * pg_flops_per_cell_step(cfg)
    bw_bytes = (param_bytes + 2 * TIME_BACKWARD_STEPS * state_bytes + state_bytes
                + 4 * lay["A"] * cells)
    b_ms, b_by = bound_ms(bw_bytes, bw_flops)
    row7_ms, row7_steps_ms, row7_turns = turns(
        lambda: backward2d._pg_persistent_cuda(packed, frames, fbar, cfg),
        lambda: backward2d._pg_steps_cuda(packed, frames, fbar, cfg), reps=5)
    kernels.append({
        "name": "pg2d_persistent_kernel", "jax_kernel": "backward2d._phase1_pg_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/backward2d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:902",
        "launches": train_launches["pg2d_persistent_kernel"]
        + ens_launches["auto"]["fused_rollout_tp_2d_pg.launches"],
        "launches_by_path": {"serve": 0, "train": train_launches["pg2d_persistent_kernel"],
                             "ensemble": ens_launches["auto"]["fused_rollout_tp_2d_pg.launches"]},
        "max_abs_err": err["pg2d_persistent_kernel"], "ms": row7_ms,
        "plain_ms": cuda_ms(torch, lambda: backward2d.fused_phase1_pg_2d_plain(
            packed, frames, fbar, cfg), reps=1, warm=False),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "steps": TIME_BACKWARD_STEPS, "launches_per_call": 1,
        "us_per_step": 1e3 * row7_ms / TIME_BACKWARD_STEPS,
        "per_step_route": {"name": "pg2d_kernel", "launches_per_call": TIME_BACKWARD_STEPS,
                           "ms": row7_steps_ms,
                           "us_per_step": 1e3 * row7_steps_ms / TIME_BACKWARD_STEPS,
                           "max_abs_err": err["pg2d_kernel[per_step]"]},
        "turns_ms": row7_turns, "plan": one_launch["pg2d_persistent_kernel"],
    })
    # row 4 at k = 1 on the same frames and cotangent: adj2d_persistent_kernel
    # beside adj2d_kernel (its per-step route), timed in turns; the sweep
    # reads the T step inputs and cotangents and writes the T g_ins and g0
    row4_ms, row4_steps_ms, row4_turns = turns(
        lambda: backward2d._phase1_persistent_cuda(packed, frames, fbar, cfg),
        lambda: backward2d._phase1_steps_cuda(packed, frames, fbar, cfg), reps=5)
    row4_plain_ms = cuda_ms(torch, lambda: backward2d.fused_phase1_2d_plain(
        packed, frames, fbar, cfg), reps=1, warm=False)
    row4_work = {"steps": TIME_BACKWARD_STEPS,
                 "bytes": param_bytes + 3 * TIME_BACKWARD_STEPS * state_bytes + state_bytes,
                 "flops": TIME_BACKWARD_STEPS * cells * adj_flops_per_cell_step_1x1(cfg)}
    b4_ms, b4_by = bound_ms(row4_work["bytes"], row4_work["flops"])
    row4_by_path = {"train": fallback_launches["gs2d_fused"]["fused_phase1_2d.launches"]}
    kernels.append({
        "name": "adj2d_persistent_kernel", "jax_kernel": "backward2d._phase1_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/adj2d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:184",
        "launches": sum(row4_by_path.values()), "launches_by_path": row4_by_path,
        "max_abs_err": err["adj2d_persistent_kernel"], "steps": TIME_BACKWARD_STEPS,
        "ms": row4_ms, "plain_ms": row4_plain_ms, "bound_ms": b4_ms, "bound_by": b4_by,
        "library_ms": None, "launches_per_call": 1,
        "us_per_step": 1e3 * row4_ms / TIME_BACKWARD_STEPS,
        "per_step_route": {"name": "adj2d_kernel", "launches_per_call": TIME_BACKWARD_STEPS,
                           "ms": row4_steps_ms,
                           "us_per_step": 1e3 * row4_steps_ms / TIME_BACKWARD_STEPS,
                           "max_abs_err": err["adj2d_kernel"]},
        "turns_ms": row4_turns, "plan": one_launch["adj2d_persistent_kernel"],
    })
    kernels.append({
        "name": "adj2d_kernel", "jax_kernel": "backward2d._phase1_kernel", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/adj2d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:184",
        "launches": sum(adj_steps_launches.values()), "launches_by_path": adj_steps_launches,
        "max_abs_err": err["adj2d_kernel"], "steps": TIME_BACKWARD_STEPS, "ms": row4_steps_ms,
        "plain_ms": row4_plain_ms, "bound_ms": b4_ms, "bound_by": b4_by, "library_ms": None,
        "note": "the per-step route past the one-launch plan's capacity; ms at 100 x 100, "
                "timed in turns with it"})
    # GS3D at 48^3: a rollout over the inference horizon, frames and final
    # state, and the backward at the longest training stage; golden cell,
    # data-loss cotangent
    steps3 = GS3D_RECON.infer_steps
    cells3, state3_bytes = n3 ** 3, 8 * n3 ** 3
    flops3 = steps3 * cells3 * flops_per_cell_step_3d()
    coef_bytes = 4 * expanded3.numel()
    b_ms, b_by = bound_ms(coef_bytes + state3_bytes + (steps3 + 1) * state3_bytes, flops3)
    bf_ms, bf_by = bound_ms(coef_bytes + 2 * state3_bytes, flops3)
    by_path3 = {"serve": serve3_launches["rollout3d_persistent_kernel"],
                "train": train3_launches["rollout3d_persistent_kernel"]}
    # rows 8 and 10 run their T steps in one launch; beside each, its
    # per-step route (rollout3d_kernel, pg3d_kernel) at the same shape, timed
    # in turns, before the plain versions load the host
    row8_ms, row8_steps_ms, row8_turns = turns(
        lambda: cell3d._rollout_persistent_cuda(expanded3, h03, steps3),
        lambda: cell3d._rollout_steps_cuda(expanded3, h03, steps3), reps=5)
    row8f_ms, row8f_steps_ms, row8f_turns = turns(
        lambda: cell3d._rollout_persistent_cuda(expanded3, h03, steps3, final_only=True),
        lambda: cell3d._rollout_steps_cuda(expanded3, h03, steps3, final_only=True), reps=5)
    row8_plain_ms = cuda_ms(torch, lambda: cell3d.fused_rollout_3d_plain(
        expanded3, h03, steps3), reps=1, warm=False)
    row8f_plain_ms = cuda_ms(torch, lambda: cell3d.fused_rollout_3d_plain(
        expanded3, h03, steps3, final_only=True), reps=1, warm=False)
    kernels.append({
        "name": "rollout3d_persistent_kernel", "jax_kernel": "cell3d._rollout3d_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/cell3d.cu",
        "replaces": "percnn_tpu/ops/pallas/cell3d.py:225",
        "launches": sum(by_path3.values()), "launches_by_path": by_path3,
        "max_abs_err": err["rollout3d_persistent_kernel"], "steps": steps3, "ms": row8_ms,
        "plain_ms": row8_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * row8_ms / steps3,
        "per_step_route": {"name": "rollout3d_kernel", "launches_per_call": steps3,
                           "ms": row8_steps_ms, "us_per_step": 1e3 * row8_steps_ms / steps3,
                           "max_abs_err": err["rollout3d_kernel"]},
        "turns_ms": row8_turns, "plan": one_launch["rollout3d_persistent_kernel"],
        "final_only": {"ms": row8f_ms, "us_per_step": 1e3 * row8f_ms / steps3,
                       "per_step_ms": row8f_steps_ms, "turns_ms": row8f_turns,
                       "plain_ms": row8f_plain_ms, "bound_ms": bf_ms, "bound_by": bf_by},
    })
    kernels.append({
        "name": "rollout3d_kernel", "jax_kernel": "cell3d._rollout3d_kernel", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/cell3d.cu",
        "replaces": "percnn_tpu/ops/pallas/cell3d.py:225",
        "launches": steps3d_launches["rollout3d_kernel"],
        "launches_by_path": {"kernels3d (92^3)": steps3d_launches["rollout3d_kernel"]},
        "max_abs_err": err["rollout3d_kernel"], "steps": steps3, "ms": row8_steps_ms,
        "plain_ms": row8_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "final_only": {"ms": row8f_steps_ms, "plain_ms": row8f_plain_ms, "bound_ms": bf_ms,
                       "bound_by": bf_by},
        "note": "the per-step route past the one-launch plan's capacity; ms at 48^3"})
    frames3 = cell3d._rollout_cuda(expanded3, h03, TIME_BACKWARD3D_STEPS)
    fbar3 = cotangent(frames3, GS3D_RECON)[1].contiguous()
    bw3_flops = TIME_BACKWARD3D_STEPS * cells3 * pg_flops_per_cell_step(cfg3)
    bw3_bytes = (4 * packed3.numel() + 2 * TIME_BACKWARD3D_STEPS * state3_bytes + state3_bytes
                 + 4 * lay3["A"] * cells3)
    b_ms, b_by = bound_ms(bw3_bytes, bw3_flops)
    row10_ms, row10_steps_ms, row10_turns = turns(
        lambda: backward3d._pg_persistent_cuda(packed3, frames3, fbar3, cfg3),
        lambda: backward3d._pg_steps_cuda(packed3, frames3, fbar3, cfg3), reps=5)
    row10_plain_ms = cuda_ms(torch, lambda: backward3d.fused_phase1_pg_3d_plain(
        packed3, frames3, fbar3, cfg3), reps=1, warm=False)
    kernels.append({
        "name": "pg3d_persistent_kernel", "jax_kernel": "backward3d._phase1_pg_kernel3d",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/backward3d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward3d.py:227",
        "launches": train3_launches["pg3d_persistent_kernel"],
        "launches_by_path": {"serve": 0, "train": train3_launches["pg3d_persistent_kernel"]},
        "max_abs_err": err["pg3d_persistent_kernel"], "steps": TIME_BACKWARD3D_STEPS,
        "ms": row10_ms, "plain_ms": row10_plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "launches_per_call": 1,
        "us_per_step": 1e3 * row10_ms / TIME_BACKWARD3D_STEPS,
        "per_step_route": {"name": "pg3d_kernel", "launches_per_call": TIME_BACKWARD3D_STEPS,
                           "ms": row10_steps_ms,
                           "us_per_step": 1e3 * row10_steps_ms / TIME_BACKWARD3D_STEPS,
                           "max_abs_err": err["pg3d_kernel"]},
        "turns_ms": row10_turns, "plan": one_launch["pg3d_persistent_kernel"],
    })
    kernels.append({
        "name": "pg3d_kernel", "jax_kernel": "backward3d._phase1_pg_kernel3d", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/backward3d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward3d.py:227",
        "launches": steps3d_launches["pg3d_kernel"],
        "launches_by_path": {"kernels3d (52^3)": steps3d_launches["pg3d_kernel"]},
        "max_abs_err": err["pg3d_kernel"], "steps": TIME_BACKWARD3D_STEPS,
        "ms": row10_steps_ms, "plain_ms": row10_plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "note": "the per-step route past the one-launch plan's capacity; ms at 48^3"})
    # Burgers at 100 x 100, golden cell: rows 3 and 6 at the training T = 200
    # (the backward with the data-loss cotangent), row 3 also over the
    # 1200-step serving and evaluation horizon; each one-launch kernel beside
    # its per-step route, timed in turns, and the bound both with the branch
    # products on the tensor cores in 3xTF32 (the row's) and all in FFMA
    cellsb, stateb_bytes = nb_grid ** 2, 8 * nb_grid ** 2
    mat_bytes = 4 * (wmatb.numel() + tailb.numel())

    def kxk_bounds(nbytes, steps, flops_fn, products):
        """(3xTF32 bound, its side, FFMA-only bound, its side) of `steps`
        steps at 100 x 100."""
        flops = steps * cellsb * flops_fn(cfgb)
        mma = steps * cellsb * products * kxk_product_flops_per_cell_step(cfgb)
        return bound_3xtf32_ms(nbytes, mma, flops - mma) + bound_ms(nbytes, flops)

    fwdb_flops = stepsb * cellsb * flops_per_cell_step_kxk(cfgb)
    fwdb_bytes = mat_bytes + stateb_bytes + (stepsb + 1) * stateb_bytes
    b3_ms, b3_by, bf3_ms, bf3_by = kxk_bounds(fwdb_bytes, stepsb, flops_per_cell_step_kxk, 1)
    hb3_ms, hb3_by, hbf3_ms, hbf3_by = kxk_bounds(
        mat_bytes + stateb_bytes + (horizon + 1) * stateb_bytes, horizon,
        flops_per_cell_step_kxk, 1)
    row3_ms, row3_steps_ms, row3_turns = turns(
        lambda: cell2d._rollout_kxk_persistent_cuda(wmatb, tailb, h0b, cfgb, stepsb),
        lambda: cell2d._rollout_kxk_steps_cuda(wmatb, tailb, h0b, cfgb, stepsb), reps=5)
    row3h_ms, row3h_steps_ms, row3h_turns = turns(
        lambda: cell2d._rollout_kxk_persistent_cuda(wmatb, tailb, h0b, cfgb, horizon),
        lambda: cell2d._rollout_kxk_steps_cuda(wmatb, tailb, h0b, cfgb, horizon), reps=3)
    row3_plain_ms = cuda_ms(torch, lambda: cell2d.fused_rollout_kxk_2d_plain(
        wmatb, tailb, h0b, cfgb, stepsb), reps=1, warm=False)
    by_pathb = {"serve": serveb_launches["rollout2d_kxk_persistent_kernel"],
                "train": trainb_counts["fused_rollout_kxk_2d.launches"],
                "ensemble": ens_launches["burgers_batched"]["fused_rollout_kxk_2d.launches"]}
    kernels.append({
        "name": "rollout2d_kxk_persistent_kernel", "jax_kernel": "cell2d._rollout_kernel_mxu",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d_kxk.cu",
        "replaces": "percnn_tpu/ops/pallas/cell2d.py:193",
        "launches": sum(by_pathb.values()), "launches_by_path": by_pathb,
        "max_abs_err": err["rollout2d_kxk_persistent_kernel"], "steps": stepsb,
        "ms": row3_ms, "plain_ms": row3_plain_ms, "bound_ms": b3_ms, "bound_by": b3_by,
        "bound_precision": "3xTF32 products at 495 TFLOP/s, the rest at 67",
        "bound_ms_ffma": bf3_ms, "bound_by_ffma": bf3_by, "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * row3_ms / stepsb,
        "per_step_route": {"name": "rollout2d_kxk_kernel", "launches_per_call": stepsb,
                           "ms": row3_steps_ms, "us_per_step": 1e3 * row3_steps_ms / stepsb,
                           "max_abs_err": err["rollout2d_kxk_kernel"]},
        "turns_ms": row3_turns, "plan": one_launch["rollout2d_kxk_persistent_kernel"],
        "horizon": {"steps": horizon, "ms": row3h_ms, "us_per_step": 1e3 * row3h_ms / horizon,
                    "per_step_ms": row3h_steps_ms, "turns_ms": row3h_turns,
                    "bound_ms": hb3_ms, "bound_by": hb3_by, "bound_ms_ffma": hbf3_ms,
                    "bound_by_ffma": hbf3_by},
    })
    # row 2 at k = 5 over the 1200-step serving horizon from kernels_kxk's h0
    # (the ISG's answer to a request): the persistent kernel's final-state
    # mode against final2d_kernel<5> (the MXU-off and past-the-plan route),
    # in turns; the bound reads h0 and writes the final state
    b2k_ms, b2k_by, bf2k_ms, bf2k_by = kxk_bounds(mat_bytes + 2 * stateb_bytes, horizon,
                                                  flops_per_cell_step_kxk, 1)
    bs2k_ms, bs2k_by = bound_ms(4 * packedb.numel() + 2 * stateb_bytes,
                                horizon * cellsb * flops_per_cell_step_kxk(cfgb))
    row2k_ms, row2k_steps_ms, row2k_turns = turns(
        lambda: cell2d._rollout_kxk_persistent_cuda(wmatb, tailb, h0s, cfgb, horizon,
                                                    final_only=True),
        lambda: cell2d._final_steps_cuda(packedb, h0s, cfgb, horizon), reps=3)
    row2k_plain_ms = cuda_ms(torch, lambda: cell2d.fused_rollout_final_2d_plain(
        packedb, h0s, cfgb, horizon), reps=1, warm=False)
    kernels.append({
        "name": "rollout2d_kxk_persistent_kernel[final]", "jax_kernel": "cell2d._final_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d_kxk.cu",
        "replaces": "percnn_tpu/ops/pallas/cell2d.py:384",
        "launches": serveb_launches["rollout2d_kxk_persistent_kernel[final]"],
        "launches_by_path": {"serve": serveb_launches["rollout2d_kxk_persistent_kernel[final]"]},
        "max_abs_err": err["rollout2d_kxk_persistent_kernel[final]"], "steps": horizon,
        "ms": row2k_ms, "plain_ms": row2k_plain_ms, "bound_ms": b2k_ms, "bound_by": b2k_by,
        "bound_precision": "3xTF32 products at 495 TFLOP/s, the rest at 67",
        "bound_ms_ffma": bf2k_ms, "bound_by_ffma": bf2k_by, "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * row2k_ms / horizon,
        "per_step_route": {"name": "final2d_kernel[k=5]", "launches_per_call": horizon,
                           "ms": row2k_steps_ms, "us_per_step": 1e3 * row2k_steps_ms / horizon,
                           "max_abs_err": err["final2d_kernel[k=5]"]},
        "turns_ms": row2k_turns, "plan": one_launch["rollout2d_kxk_persistent_kernel"],
    })
    by_path2k = {k: v for k, v in final_steps_launches.items() if k != "kernels (449 x 449)"}
    kernels.append({
        "name": "final2d_kernel[k=5]", "jax_kernel": "cell2d._final_kernel", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
        "replaces": "percnn_tpu/ops/pallas/cell2d.py:384",
        "launches": sum(by_path2k.values()), "launches_by_path": by_path2k,
        "max_abs_err": err["final2d_kernel[k=5]"], "steps": horizon, "ms": row2k_steps_ms,
        "plain_ms": row2k_plain_ms, "bound_ms": bs2k_ms, "bound_by": bs2k_by, "library_ms": None,
        "note": "the per-step route with the MXU switch off and past the one-launch plan's "
                "capacity; tap by tap in FFMA, as the TPU's _final_kernel; ms at 100 x 100"})
    framesb = cell2d._rollout_kxk_cuda(wmatb, tailb, h0b, cfgb, stepsb)
    fbarb = cotangent(framesb, BURGERS_STAGE1)[1].contiguous()
    bwb_flops = stepsb * cellsb * adj_flops_per_cell_step_kxk(cfgb)
    bwb_bytes = (mat_bytes + 2 * stepsb * stateb_bytes + stepsb * stateb_bytes + stateb_bytes
                 + 4 * stepsb * cell2d.mxu_rows(cfgb) * cellsb)
    b6_ms, b6_by, bf6_ms, bf6_by = kxk_bounds(bwb_bytes, stepsb, adj_flops_per_cell_step_kxk, 2)
    row6_ms, row6_steps_ms, row6_turns = turns(
        lambda: backward2d._phase1_kxk_persistent_cuda(wmatb, tailb, framesb, fbarb, cfgb),
        lambda: backward2d._phase1_kxk_steps_cuda(wmatb, tailb, framesb, fbarb, cfgb), reps=5)
    row6_plain_ms = cuda_ms(torch, lambda: backward2d.fused_phase1_kxk_2d_plain(
        wmatb, tailb, framesb, fbarb, cfgb), reps=1, warm=False)
    kernels.append({
        "name": "adj2d_kxk_persistent_kernel", "jax_kernel": "backward2d._phase1_mxu_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/backward2d_kxk.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:370",
        "launches": trainb_counts["fused_rollout_tp_2d.launches"],
        "launches_by_path": {"serve": 0, "train": trainb_counts["fused_rollout_tp_2d.launches"]},
        "max_abs_err": err["adj2d_kxk_persistent_kernel"], "steps": stepsb,
        "ms": row6_ms, "plain_ms": row6_plain_ms, "bound_ms": b6_ms, "bound_by": b6_by,
        "bound_precision": "3xTF32 products at 495 TFLOP/s, the rest at 67",
        "bound_ms_ffma": bf6_ms, "bound_by_ffma": bf6_by, "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * row6_ms / stepsb,
        "per_step_route": {"name": "adj2d_kxk_kernel", "launches_per_call": 2 * stepsb,
                           "ms": row6_steps_ms, "us_per_step": 1e3 * row6_steps_ms / stepsb,
                           "max_abs_err": err["adj2d_kxk_kernel"]},
        "turns_ms": row6_turns, "plan": one_launch["adj2d_kxk_persistent_kernel"],
    })
    # the per-step kernels of rows 3 and 6, the route past the plans'
    # capacity: their launches are kernels_kxk's and grads_kxk's runs past
    # it, their ms the turns above at 100 x 100, their bound all in FFMA
    for name, jax_name, source, replaces, ms, plain_ms, (b_ms, b_by), n_launches, where in (
            ("rollout2d_kxk_kernel", "cell2d._rollout_kernel_mxu", "cell2d_kxk.cu",
             "percnn_tpu/ops/pallas/cell2d.py:193", row3_steps_ms, row3_plain_ms,
             (bf3_ms, bf3_by), kxk_steps_launches["kernels_kxk"], "kernels_kxk (1453 x 1453)"),
            ("adj2d_kxk_kernel", "backward2d._phase1_mxu_kernel", "backward2d_kxk.cu",
             "percnn_tpu/ops/pallas/backward2d.py:370", row6_steps_ms, row6_plain_ms,
             (bf6_ms, bf6_by), kxk_steps_launches["grads_kxk"], "grads_kxk (846 x 846)")):
        kernels.append({
            "name": name, "jax_kernel": jax_name, "route": "cuda",
            "source": f"percnn_tpu_torch/ops/kernels/csrc/{source}", "replaces": replaces,
            "launches": n_launches, "launches_by_path": {where: n_launches},
            "max_abs_err": err[name], "steps": stepsb, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "note": "the per-step route past the one-launch plan's capacity; ms at 100 x 100"})
    # one grid barrier alone: an empty cooperative kernel of one block an SM
    # doing GRID_BARRIERS grid.sync()s, at the k x k kernels' 320 threads and
    # pg2d_persistent_kernel's 512
    barrier_fn = _build.load_library("cell2d_kxk").kxk_grid_barrier
    barrier_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    barrier_fn.restype = ctypes.c_int
    grid_barrier = {"barriers": GRID_BARRIERS, "blocks": n_sm, "us_per_barrier": {}}
    for threads in (one_launch["rollout2d_kxk_persistent_kernel"]["threads"], 512):
        def barriers(threads=threads):
            check(barrier_fn(GRID_BARRIERS, n_sm, threads,
                             torch.cuda.current_stream().cuda_stream) == 0,
                  "grid_barrier_kernel failed")
        grid_barrier["us_per_barrier"][threads] = 1e3 * cuda_ms(torch, barriers, 5) / GRID_BARRIERS
    # rows 1 (k = 5) and 5 on the MXU-off route and row 2 at k = 5 with the
    # switch off, golden Burgers cell at 100 x 100: each one-launch FFMA
    # kernel beside its per-step route (rollout2d_kernel<5>, adj2d_ys_kernel,
    # final2d_kernel<5>), timed in turns; row 1 at T = 200 from the Burgers IC
    # and over the evaluation's 1200 steps from kernels_kxk's h0 (the ISG's
    # answer to a request), row 2 over the same 1200 steps, row 5 at T = 200
    # on row 6's frames and cotangent (the ys made outside the timing, as
    # _precompute_ys makes them); the bounds all in FFMA.  Then the fallback
    # slice's other kernels at their main paths' shapes: adj2d_kernel at
    # k = 1 (the GS2D backward above: T = 800, data-loss cotangent) and k = 5
    # (the Burgers backward above: T = 200) and adj3d_kernel (the GS3D
    # backward above: 48^3, T = 300); each sweep reads the T step inputs and
    # cotangents and writes the T g_ins and g0
    packedb_bytes = 4 * packedb.numel()
    ysb = backward2d._precompute_ys(paramsb["cell"], framesb[:-1], cfgb)
    taps_rows = 2 * cfgb.kernel_size ** 2 * 2 * cell2d.mxu_rows(cfgb)
    row1k_ms, row1k_steps_ms, row1k_turns = turns(
        lambda: cell2d._rollout_ffma_persistent_cuda(packedb, h0b, cfgb, stepsb),
        lambda: cell2d._rollout_steps_cuda(packedb, h0b, cfgb, stepsb), reps=5)
    row1kh_ms, row1kh_steps_ms, row1kh_turns = turns(
        lambda: cell2d._rollout_ffma_persistent_cuda(packedb, h0s, cfgb, horizon),
        lambda: cell2d._rollout_steps_cuda(packedb, h0s, cfgb, horizon), reps=3)
    row2kf_ms, row2kf_steps_ms, row2kf_turns = turns(
        lambda: cell2d._rollout_ffma_persistent_cuda(packedb, h0s, cfgb, horizon,
                                                     final_only=True),
        lambda: cell2d._final_steps_cuda(packedb, h0s, cfgb, horizon), reps=3)
    row5_ms, row5_steps_ms, row5_turns = turns(
        lambda: backward2d._phase1_ys_persistent_cuda(packedb, fbarb, ysb, cfgb),
        lambda: backward2d._phase1_ys_steps_cuda(packedb, fbarb, ysb, cfgb), reps=5)
    row1k_plain_ms = cuda_ms(torch, lambda: cell2d.fused_rollout_2d_plain(
        packedb, h0b, cfgb, stepsb), reps=1, warm=False)
    row5_plain_ms = cuda_ms(torch, lambda: backward2d.fused_phase1_ys_2d_plain(
        packedb, fbarb, ysb, cfgb), reps=1, warm=False)
    b1k = bound_ms(packedb_bytes + stateb_bytes + (stepsb + 1) * stateb_bytes, fwdb_flops)
    b1kh = bound_ms(packedb_bytes + stateb_bytes + (horizon + 1) * stateb_bytes,
                    horizon * cellsb * flops_per_cell_step_kxk(cfgb))
    b5 = bound_ms(packedb_bytes + 2 * stepsb * stateb_bytes + stateb_bytes + 4 * ysb.numel(),
                  bwb_flops - stepsb * cellsb * taps_rows)
    fallback_work = {"rollout2d_ffma_persistent_kernel": {"steps": stepsb, "flops": fwdb_flops},
                     "adj2d_ys_persistent_kernel": {
                         "steps": stepsb, "bytes": packedb_bytes + 2 * stepsb * stateb_bytes
                         + stateb_bytes + 4 * ysb.numel(),
                         "flops": bwb_flops - stepsb * cellsb * taps_rows}}
    del ysb
    train_ffma = {"train": fallback_launches["burgers_mxu_off"]["fused_rollout_2d.launches_kxk"]
                  + fallback_launches["burgers_ys_off"]["fused_rollout_2d.launches_kxk"]}
    train_ys = {"train": fallback_launches["burgers_mxu_off"]["fused_phase1_ys_2d.launches"]}
    for name, route_name, replaces, source, jax_name, by_path, ms, steps_ms, turns_, plain_ms, (
            b_ms, b_by), per_step_by_path, extra in (
            ("rollout2d_ffma_persistent_kernel", "rollout2d_kernel[k=5]",
             "percnn_tpu/ops/pallas/cell2d.py:332", "cell2d_ffma.cu", "cell2d._rollout_kernel",
             train_ffma, row1k_ms, row1k_steps_ms, row1k_turns, row1k_plain_ms, b1k,
             ffma_steps_launches["rollout2d_kernel[k=5]"],
             {"horizon": {"steps": horizon, "ms": row1kh_ms, "us_per_step": 1e3 * row1kh_ms / horizon,
                          "per_step_ms": row1kh_steps_ms, "turns_ms": row1kh_turns,
                          "bound_ms": b1kh[0], "bound_by": b1kh[1]}}),
            ("rollout2d_ffma_persistent_kernel[final]", "final2d_kernel[k=5]",
             "percnn_tpu/ops/pallas/cell2d.py:384", "cell2d_ffma.cu", "cell2d._final_kernel",
             ffma_final_launches, row2kf_ms, row2kf_steps_ms, row2kf_turns, row2k_plain_ms,
             (bs2k_ms, bs2k_by), None, {}),
            ("adj2d_ys_persistent_kernel", "adj2d_ys_kernel",
             "percnn_tpu/ops/pallas/backward2d.py:260", "adj2d.cu", "backward2d._phase1_ys_kernel",
             train_ys, row5_ms, row5_steps_ms, row5_turns, row5_plain_ms, b5,
             ffma_steps_launches["adj2d_ys_kernel"], {})):
        steps_ = horizon if name.endswith("[final]") else stepsb
        per_call = {"rollout2d_kernel[k=5]": steps_, "final2d_kernel[k=5]": steps_,
                    "adj2d_ys_kernel": 2 * steps_}[route_name]
        kernels.append({
            "name": name, "jax_kernel": jax_name, "route": "cuda",
            "source": f"percnn_tpu_torch/ops/kernels/csrc/{source}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err[name], "steps": steps_, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "launches_per_call": 1,
            "us_per_step": 1e3 * ms / steps_,
            "per_step_route": {"name": route_name, "launches_per_call": per_call, "ms": steps_ms,
                               "us_per_step": 1e3 * steps_ms / steps_,
                               "max_abs_err": err[route_name]},
            "turns_ms": turns_, "plan": one_launch[name.removesuffix("[final]")], **extra})
        if per_step_by_path is not None:
            step_source = "cell2d.cu" if route_name.startswith("rollout") else "adj2d.cu"
            kernels.append({
                "name": route_name, "jax_kernel": jax_name, "route": "cuda",
                "source": f"percnn_tpu_torch/ops/kernels/csrc/{step_source}", "replaces": replaces, "launches": sum(per_step_by_path.values()),
                "launches_by_path": per_step_by_path, "max_abs_err": err[route_name],
                "steps": steps_, "ms": steps_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "note": "the per-step route past the one-launch plan's capacity; ms at 100 x 100"})
    fallback_work["adj2d_persistent_kernel"] = row4_work
    # row 4 at k = 5 on row 6's frames and cotangent (T = 200):
    # adj2d_batched_ffma_persistent_kernel on a one-member batch beside
    # adj2d_kernel's pair (its per-step route), timed in turns; the sweep
    # reads the T step inputs and cotangents and writes the T g_ins and g0
    row4k_ms, row4k_steps_ms, row4k_turns = turns(
        lambda: backward2d._phase1_ffma_cuda(packedb, framesb, fbarb, cfgb),
        lambda: backward2d._phase1_steps_cuda(packedb, framesb, fbarb, cfgb), reps=5)
    row4k_plain_ms = cuda_ms(torch, lambda: backward2d.fused_phase1_2d_plain(
        packedb, framesb, fbarb, cfgb), reps=1, warm=False)
    fallback_work["adj2d_batched_ffma_persistent_kernel[M=1]"] = {
        "steps": stepsb, "bytes": packedb_bytes + 3 * stepsb * stateb_bytes + stateb_bytes,
        "flops": bwb_flops}
    b4k_ms, b4k_by = bound_ms(fallback_work["adj2d_batched_ffma_persistent_kernel[M=1]"]["bytes"], bwb_flops)
    row4k_by_path = {"train": fallback_launches["burgers_ys_off"]["fused_phase1_2d.launches"]}
    kernels.extend([{
        "name": "adj2d_batched_ffma_persistent_kernel[M=1]", "jax_kernel": "backward2d._phase1_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:184",
        "launches": sum(row4k_by_path.values()), "launches_by_path": row4k_by_path,
        "max_abs_err": err["adj2d_batched_ffma_persistent_kernel[M=1]"], "steps": stepsb, "ms": row4k_ms,
        "plain_ms": row4k_plain_ms, "bound_ms": b4k_ms, "bound_by": b4k_by, "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * row4k_ms / stepsb,
        "per_step_route": {"name": "adj2d_kernel[k=5]", "launches_per_call": 2 * stepsb,
                           "ms": row4k_steps_ms, "us_per_step": 1e3 * row4k_steps_ms / stepsb,
                           "max_abs_err": err["adj2d_kernel[k=5]"]},
        "turns_ms": row4k_turns,
        "plan": one_launch["adj2d_batched_ffma_persistent_kernel"]["M=1"],
    }, {
        "name": "adj2d_kernel[k=5]", "jax_kernel": "backward2d._phase1_kernel", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/adj2d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:184",
        "launches": sum(adjk_steps_launches.values()), "launches_by_path": adjk_steps_launches,
        "max_abs_err": err["adj2d_kernel[k=5]"], "steps": stepsb, "ms": row4k_steps_ms,
        "plain_ms": row4k_plain_ms, "bound_ms": b4k_ms, "bound_by": b4k_by, "library_ms": None,
        "note": "the per-step route past the one-launch plan's capacity; ms at 100 x 100, "
                "timed in turns with it"}])
    # row 9 at 48^3, T = 300 (the GS3D backward above): adj3d_persistent_kernel
    # beside adj3d_kernel, its per-step route, timed in turns; each sweep
    # reads the T step inputs and cotangents and writes the T g_ins and g0
    row9_ms, row9_steps_ms, row9_turns = turns(
        lambda: backward3d._phase1_persistent_cuda(packed3, frames3, fbar3, cfg3),
        lambda: backward3d._phase1_steps_cuda(packed3, frames3, fbar3, cfg3), reps=5)
    row9_plain_ms = cuda_ms(torch, lambda: backward3d.fused_phase1_3d_plain(
        packed3, frames3, fbar3, cfg3), reps=1, warm=False)
    # the same kernel built for two blocks an SM (build_adj3d_two_blocks), on
    # 2 n_sm blocks of half the cells, in turns with the plan's one block an
    # SM; its outputs held to the plan's at the backward bar
    fn_two = ctypes.CDLL(adj3d_two_lib).backward3d_adj_persistent
    fn_two.argtypes, fn_two.restype = backward3d._ADJ_PERSISTENT_SIGNATURE, ctypes.c_int
    per_sm_two = ctypes.c_int(0)

    def adj3d_two_blocks():
        g0_ = torch.zeros(frames3.shape[1:], dtype=torch.float32, device=dev)
        scratch_ = torch.zeros_like(g0_)
        g_ins_ = torch.empty((TIME_BACKWARD3D_STEPS,) + tuple(frames3.shape[1:]),
                             dtype=torch.float32, device=dev)
        check(fn_two(packed3.data_ptr(), packed3.numel(), frames3.data_ptr(), fbar3.data_ptr(),
                     g0_.data_ptr(), scratch_.data_ptr(), g_ins_.data_ptr(),
                     TIME_BACKWARD3D_STEPS, n3, n3, n3, cfg3.hidden, cfg3.n_branches, cfg3.dt,
                     1.0 / (cfg3.dx * cfg3.dx), 2 * n_sm,
                     torch.cuda.current_stream().cuda_stream, ctypes.byref(per_sm_two)) == 0,
              f"adj3d_persistent_kernel on {2 * n_sm} blocks failed ({per_sm_two.value} an SM)")
        return g_ins_, g0_

    two_out = adj3d_two_blocks()
    one_out = backward3d._phase1_persistent_cuda(packed3, frames3, fbar3, cfg3)
    two_err = {key: [max_abs(a, b), float(b.abs().max())]
               for key, a, b in zip(("g_ins", "g0"), two_out, one_out)}
    for key, (e, scale) in two_err.items():
        check(e <= 2e-4 * scale + 2e-6, f"adj3d_persistent_kernel on two blocks an SM vs one, "
                                        f"{key}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
    del two_out, one_out
    row9_two_ms, row9_one_ms, row9_two_turns = turns(
        adj3d_two_blocks,
        lambda: backward3d._phase1_persistent_cuda(packed3, frames3, fbar3, cfg3), reps=5)
    shutil.rmtree(adj3d_two_dir, ignore_errors=True)
    row9_two_blocks = {"blocks": 2 * n_sm, "blocks_an_sm_holds": per_sm_two.value,
                       "ptxas": adj3d_two_ptxas, "ms": row9_two_ms,
                       "one_block_an_sm_ms": row9_one_ms, "turns_ms": row9_two_turns,
                       "err_and_max_vs_one_block_an_sm": two_err}
    row9_work = {"steps": TIME_BACKWARD3D_STEPS,
                 "bytes": 4 * packed3.numel() + 3 * TIME_BACKWARD3D_STEPS * state3_bytes
                 + state3_bytes,
                 "flops": TIME_BACKWARD3D_STEPS * cells3 * adj_flops_per_cell_step_1x1(cfg3)}
    fallback_work["adj3d_persistent_kernel"] = row9_work
    b9_ms, b9_by = bound_ms(row9_work["bytes"], row9_work["flops"])
    row9_by_path = {"train": fallback_launches["gs3d_fused"]["fused_phase1_3d.launches"]}
    kernels.extend([{
        "name": "adj3d_persistent_kernel", "jax_kernel": "backward3d._phase1_kernel3d",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/backward3d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward3d.py:60",
        "launches": sum(row9_by_path.values()), "launches_by_path": row9_by_path,
        "max_abs_err": err["adj3d_persistent_kernel"], "steps": TIME_BACKWARD3D_STEPS,
        "ms": row9_ms, "plain_ms": row9_plain_ms, "bound_ms": b9_ms, "bound_by": b9_by,
        "library_ms": None, "launches_per_call": 1,
        "us_per_step": 1e3 * row9_ms / TIME_BACKWARD3D_STEPS,
        "per_step_route": {"name": "adj3d_kernel", "launches_per_call": TIME_BACKWARD3D_STEPS,
                           "ms": row9_steps_ms,
                           "us_per_step": 1e3 * row9_steps_ms / TIME_BACKWARD3D_STEPS,
                           "max_abs_err": err["adj3d_kernel"]},
        "turns_ms": row9_turns, "plan": one_launch["adj3d_persistent_kernel"],
        "two_blocks_an_sm": row9_two_blocks,
    }, {
        "name": "adj3d_kernel", "jax_kernel": "backward3d._phase1_kernel3d", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/backward3d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward3d.py:60",
        "launches": sum(adj3_steps_launches.values()), "launches_by_path": adj3_steps_launches,
        "max_abs_err": err["adj3d_kernel"], "steps": TIME_BACKWARD3D_STEPS,
        "ms": row9_steps_ms, "plain_ms": row9_plain_ms, "bound_ms": b9_ms, "bound_by": b9_by,
        "library_ms": None,
        "note": "the per-step route past the one-launch plan's capacity; ms at 48^3, timed in "
                "turns with it"}])
    # the ensemble's kernels at its main paths' shapes: M = 4, 100 x 100,
    # C = 8, k = 1, T = 800 (the golden GS2D cell and its perturbations, as
    # kernels_batched; a standard-normal cotangent); pg2d_batched_kernel also
    # at M = 8, where its accumulator planes (52 MB) pass the 50 MB L2; the
    # k = 5 contracts of rows 11-12 at M = 2, T = 200 on the golden Burgers
    # cell.  The bounds are M times the single model's work.
    gen = torch.Generator(device=dev).manual_seed(9)
    packed4 = batched2d.pack_pi_params_2d_batched(member_cells(model["cell"], ENS_MEMBERS),
                                                  cfg).contiguous()
    h04 = member_ics(GS2D_RECON.system, GS2D_RECON.grid, ENS_MEMBERS)
    frames4 = batched2d._rollout_b_cuda(packed4, h04, cfg, TIME_BACKWARD_STEPS)
    fbar4 = torch.randn(frames4.shape, generator=gen, device=dev)
    packed2 = batched2d.pack_pi_params_2d_batched(member_cells(modelb["cell"], ENS_KXK_MEMBERS),
                                                  cfgb).contiguous()
    h02 = member_ics(BURGERS_STAGE1.system, BURGERS_STAGE1.grid, ENS_KXK_MEMBERS)
    frames2 = batched2d._rollout_b_cuda(packed2, h02, cfgb, stepsb)
    fbar2 = torch.randn(frames2.shape, generator=gen, device=dev)
    m4, m2, t8 = ENS_MEMBERS, ENS_KXK_MEMBERS, TIME_BACKWARD_STEPS
    pg_in_bytes = param_bytes + 2 * t8 * state_bytes + state_bytes
    pg_flops = lambda n: n * t8 * cells * pg_flops_per_cell_step(cfg)
    # rows 11 (k = 1) and 13 run T steps of every member in one launch;
    # beside each, its per-step route (rollout2d_batched_kernel,
    # pg2d_batched_kernel) timed in turns in this call, at M = 4 and M = 8,
    # and the forward by both cluster sizes in turns (16, 8, 8, 16)
    batched_times = {}
    for n_mem in (m4, 2 * m4):
        if n_mem == m4:
            pk, h0m, frm, fbm = packed4, h04, frames4, fbar4
        else:
            pk = batched2d.pack_pi_params_2d_batched(member_cells(model["cell"], n_mem),
                                                     cfg).contiguous()
            h0m = member_ics(GS2D_RECON.system, GS2D_RECON.grid, n_mem)
            frm = batched2d._rollout_b_cuda(pk, h0m, cfg, t8)
            fbm = torch.randn(frm.shape, generator=gen, device=dev)
        fwd = dict(zip(("ms", "per_step_ms", "turns_ms"), turns(
            lambda: batched2d._rollout_b_cluster_cuda(pk, h0m, cfg, t8),
            lambda: batched2d._rollout_b_steps_cuda(pk, h0m, cfg, t8), reps=5)))
        pg = dict(zip(("ms", "per_step_ms", "turns_ms"), turns(
            lambda: batched2d._pg_b_persistent_cuda(pk, frm, fbm, cfg),
            lambda: batched2d._pg_b_steps_cuda(pk, frm, fbm, cfg), reps=3)))
        adj = dict(zip(("ms", "per_step_ms", "turns_ms"), turns(
            lambda: batched2d._phase1_b_persistent_cuda(pk, frm, fbm, cfg),
            lambda: batched2d._phase1_b_steps_cuda(pk, frm, fbm, cfg), reps=5)))
        fwd["ms_by_cluster_size"] = {}
        for n in (16, 8, 8, 16):
            fwd["ms_by_cluster_size"].setdefault(f"n_cta={n}", []).append(cuda_ms(
                torch, lambda: batched2d._rollout_b_cluster_cuda(pk, h0m, cfg, t8, n_cta=n),
                reps=5))
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(
            n_mem * (param_bytes + state_bytes + (t8 + 1) * state_bytes),
            n_mem * t8 * cells * flops_per_cell_step(cfg))
        pg["bound_ms"], pg["bound_by"] = bound_ms(n_mem * (pg_in_bytes + 4 * lay["A"]),
                                                  pg_flops(n_mem))
        adj["bound_ms"], adj["bound_by"] = bound_ms(
            n_mem * (param_bytes + 3 * t8 * state_bytes + state_bytes),
            n_mem * t8 * cells * adj_flops_per_cell_step_1x1(cfg))
        fwd["plan"] = one_launch["rollout2d_cluster_kernel[batched]"][f"M={n_mem}"]
        pg["plan"] = one_launch["pg2d_batched_persistent_kernel"][f"M={n_mem}"]
        adj["plan"] = one_launch["adj2d_batched_persistent_kernel"][f"M={n_mem}"]
        batched_times[n_mem] = {"fwd": fwd, "pg": pg, "adj": adj}
        if n_mem > m4:
            del pk, h0m, frm, fbm
    fwd4, pg4, adj4 = (batched_times[m4][kind] for kind in ("fwd", "pg", "adj"))
    m8 = lambda kind: {"members": 2 * m4, "steps": t8, **batched_times[2 * m4][kind]}
    ens_fwd_launches = (ens_launches["batched_pg"]["fused_rollout_2d_batched.launches"]
                        + ens_launches["batched"]["fused_rollout_2d_batched.launches"])
    kernels.extend([{
        "name": "rollout2d_cluster_kernel[batched]", "jax_kernel": "batched2d._rollout_kernel_b",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
        "replaces": "percnn_tpu/ops/pallas/batched2d.py:63",
        "launches": ens_fwd_launches, "launches_by_path": {"ensemble": ens_fwd_launches},
        "max_abs_err": err["rollout2d_cluster_kernel[batched]"], "members": m4, "steps": t8,
        "ms": fwd4["ms"], "plain_ms": cuda_ms(
            torch, lambda: batched2d.fused_rollout_2d_batched_plain(packed4, h04, cfg, t8), reps=1, warm=False),
        "bound_ms": fwd4["bound_ms"], "bound_by": fwd4["bound_by"], "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * fwd4["ms"] / t8,
        "per_step_route": {"name": "rollout2d_batched_kernel", "launches_per_call": t8,
                           "ms": fwd4["per_step_ms"], "us_per_step": 1e3 * fwd4["per_step_ms"] / t8},
        "turns_ms": fwd4["turns_ms"], "ms_by_cluster_size": fwd4["ms_by_cluster_size"],
        "plan": fwd4["plan"], "m8": m8("fwd"),
    }, {
        "name": "pg2d_batched_persistent_kernel", "jax_kernel": "batched2d._phase1_pg_kernel_b",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
        "replaces": "percnn_tpu/ops/pallas/batched2d.py:272",
        "launches": ens_launches["batched_pg"]["fused_phase1_pg_2d_batched.launches"],
        "launches_by_path": {
            "ensemble": ens_launches["batched_pg"]["fused_phase1_pg_2d_batched.launches"]},
        "max_abs_err": err["pg2d_batched_persistent_kernel"], "members": m4, "steps": t8,
        "ms": pg4["ms"], "plain_ms": cuda_ms(
            torch, lambda: batched2d.fused_phase1_pg_2d_batched_plain(packed4, frames4, fbar4,
                                                                      cfg), reps=1, warm=False),
        "bound_ms": pg4["bound_ms"], "bound_by": pg4["bound_by"], "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * pg4["ms"] / t8,
        "per_step_route": {"name": "pg2d_batched_kernel", "launches_per_call": t8,
                           "ms": pg4["per_step_ms"], "us_per_step": 1e3 * pg4["per_step_ms"] / t8},
        "turns_ms": pg4["turns_ms"], "plan": pg4["plan"], "m8": m8("pg"),
    }, {
        "name": "adj2d_batched_persistent_kernel", "jax_kernel": "batched2d._phase1_kernel_b",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
        "replaces": "percnn_tpu/ops/pallas/batched2d.py:117",
        "launches": ens_launches["batched"]["fused_phase1_2d_batched.launches"],
        "launches_by_path": {
            "ensemble": ens_launches["batched"]["fused_phase1_2d_batched.launches"]},
        "max_abs_err": err["adj2d_batched_persistent_kernel"], "members": m4, "steps": t8,
        "ms": adj4["ms"], "plain_ms": cuda_ms(
            torch, lambda: batched2d.fused_phase1_2d_batched_plain(packed4, frames4, fbar4, cfg),
            reps=1, warm=False),
        "bound_ms": adj4["bound_ms"], "bound_by": adj4["bound_by"], "library_ms": None,
        "launches_per_call": 1, "us_per_step": 1e3 * adj4["ms"] / t8,
        "per_step_route": {"name": "adj2d_batched_kernel", "launches_per_call": t8,
                           "ms": adj4["per_step_ms"],
                           "us_per_step": 1e3 * adj4["per_step_ms"] / t8,
                           "max_abs_err": err["adj2d_batched_kernel"]},
        "turns_ms": adj4["turns_ms"], "plan": adj4["plan"], "m8": m8("adj"),
    }])
    batched_rows = {
        "rollout2d_batched_kernel": (
            None, lambda: batched2d.fused_rollout_2d_batched_plain(packed4, h04, cfg, t8),
            m4 * (param_bytes + state_bytes + (t8 + 1) * state_bytes),
            m4 * t8 * cells * flops_per_cell_step(cfg), t8, m4,
            "batched2d._rollout_kernel_b", ":63",
            {"kernels_batched (449 x 449)":
             batched_routes["449 x 449"]["counts"]["fused_rollout_2d_batched.launches"]}),
        "adj2d_batched_kernel": (
            None, None, m4 * (param_bytes + 3 * t8 * state_bytes + state_bytes),
            m4 * t8 * cells * adj_flops_per_cell_step_1x1(cfg), t8, m4,
            "batched2d._phase1_kernel_b", ":117", sweep1_b_launches),
        "pg2d_batched_kernel": (
            None, None, m4 * (pg_in_bytes + 4 * lay["A"] * cells), pg_flops(m4), t8, m4,
            "batched2d._phase1_pg_kernel_b", ":272",
            {f"kernels_batched ({k})":
             batched_routes[k]["counts"]["fused_phase1_pg_2d_batched.launches"]
             for k in ("449 x 449", "156 x 156")}),
    }
    # the per-step rows' ms are their turns above; their plain versions the
    # one-launch rows' (the same function)
    per_step_ms = {"rollout2d_batched_kernel": fwd4["per_step_ms"],
                   "pg2d_batched_kernel": pg4["per_step_ms"],
                   "adj2d_batched_kernel": adj4["per_step_ms"]}
    plain_of = {name: next(k["plain_ms"] for k in kernels if k["name"] == one)
                for name, one in (("rollout2d_batched_kernel", "rollout2d_cluster_kernel[batched]"),
                                  ("pg2d_batched_kernel", "pg2d_batched_persistent_kernel"),
                                  ("adj2d_batched_kernel", "adj2d_batched_persistent_kernel"))}
    kind_of = {"rollout2d_batched_kernel": "fwd", "pg2d_batched_kernel": "pg",
               "adj2d_batched_kernel": "adj"}
    batched_work = {}
    for name, (kernel, plain, nbytes, nflops, steps, n_mem, jax_name, line,
               by_path) in batched_rows.items():
        b_ms, b_by = bound_ms(nbytes, nflops)
        batched_work[name] = {"members": n_mem, "steps": steps, "bytes": nbytes, "flops": nflops}
        entry = {
            "name": name, "jax_kernel": jax_name, "route": "cuda",
            "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
            "replaces": f"percnn_tpu/ops/pallas/batched2d.py{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err[name], "members": n_mem, "steps": steps,
            "ms": per_step_ms[name] if kernel is None else cuda_ms(torch, kernel, reps=5),
            "plain_ms": plain_of[name] if plain is None else cuda_ms(torch, plain, reps=1, warm=False),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        if name in per_step_ms:
            entry["note"] = ("the per-step route past the one-launch plan; ms at 100 x 100, "
                             "M = 4, timed in turns with it")
            entry["m8"] = {"ms": m8(kind_of[name])["per_step_ms"]}
        kernels.append(entry)
    # row 11 at k = 5: rollout2d_ffma_persistent_kernel with the member axis
    # beside rollout2d_batched_kernel (its per-step route), timed in turns at
    # M = 2 (the ensemble's) and M = 4, 100 x 100, T = 200, on the golden
    # Burgers cell's members and their Burgers ICs
    row11k = {}
    for n_mem in (m2, 2 * m2):
        if n_mem == m2:
            pk, h0m = packed2, h02
        else:
            pk = batched2d.pack_pi_params_2d_batched(member_cells(modelb["cell"], n_mem),
                                                     cfgb).contiguous()
            h0m = member_ics(BURGERS_STAGE1.system, BURGERS_STAGE1.grid, n_mem)
        one_ms, per_ms, tr = turns(
            lambda: batched2d._rollout_b_ffma_cuda(pk, h0m, cfgb, stepsb),
            lambda: batched2d._rollout_b_steps_cuda(pk, h0m, cfgb, stepsb), reps=5)
        work = {"members": n_mem, "steps": stepsb,
                "bytes": n_mem * (packedb_bytes + stateb_bytes + (stepsb + 1) * stateb_bytes),
                "flops": n_mem * fwdb_flops}
        b_ms, b_by = bound_ms(work["bytes"], work["flops"])
        row11k[n_mem] = {"members": n_mem, "steps": stepsb, "ms": one_ms, "per_step_ms": per_ms,
                         "us_per_step": 1e3 * one_ms / stepsb, "turns_ms": tr,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "plan": one_launch["rollout2d_ffma_persistent_kernel[batched]"][
                             f"M={n_mem}"]}
        batched_work[f"rollout2d_ffma_persistent_kernel[batched][M={n_mem}]"] = work
        if n_mem > m2:
            row11k[n_mem]["max_abs_err"] = err["rollout2d_ffma_persistent_kernel[batched][M=4]"]
            del pk, h0m
    r11 = row11k[m2]
    row11k_plain_ms = cuda_ms(torch, lambda: batched2d.fused_rollout_2d_batched_plain(
        packed2, h02, cfgb, stepsb), reps=1, warm=False)
    row11k_by_path = {
        "ensemble": ens_launches["burgers_batched"]["fused_rollout_2d_batched.launches_kxk"]}
    kernels.extend([{
        "name": "rollout2d_ffma_persistent_kernel[batched]",
        "jax_kernel": "batched2d._rollout_kernel_b", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d_ffma.cu",
        "replaces": "percnn_tpu/ops/pallas/batched2d.py:63",
        "launches": sum(row11k_by_path.values()), "launches_by_path": row11k_by_path,
        "max_abs_err": err["rollout2d_ffma_persistent_kernel[batched]"], "members": m2,
        "steps": stepsb, "ms": r11["ms"], "plain_ms": row11k_plain_ms,
        "bound_ms": r11["bound_ms"], "bound_by": r11["bound_by"], "library_ms": None,
        "launches_per_call": 1, "us_per_step": r11["us_per_step"],
        "per_step_route": {"name": "rollout2d_batched_kernel[k=5]", "launches_per_call": stepsb,
                           "ms": r11["per_step_ms"],
                           "us_per_step": 1e3 * r11["per_step_ms"] / stepsb,
                           "max_abs_err": err["rollout2d_batched_kernel[k=5]"]},
        "turns_ms": r11["turns_ms"], "plan": r11["plan"], "m4": row11k[2 * m2],
    }, {
        "name": "rollout2d_batched_kernel[k=5]", "jax_kernel": "batched2d._rollout_kernel_b",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
        "replaces": "percnn_tpu/ops/pallas/batched2d.py:63",
        "launches": sum(fwd5_steps_launches.values()), "launches_by_path": fwd5_steps_launches,
        "max_abs_err": err["rollout2d_batched_kernel[k=5]"], "members": m2, "steps": stepsb,
        "ms": r11["per_step_ms"], "plain_ms": row11k_plain_ms, "bound_ms": r11["bound_ms"],
        "bound_by": r11["bound_by"], "library_ms": None,
        "note": "the per-step route past the one-launch plan; ms at 100 x 100, M = 2, timed in "
                "turns with it", "m4": {"ms": row11k[2 * m2]["per_step_ms"]}}])
    # row 12 at k = 5: adj2d_batched_ffma_persistent_kernel beside
    # adj2d_batched_kernel's pair (its per-step route), timed in turns at
    # M = 2 (the ensemble's) and M = 4, 100 x 100, T = 200, on the golden
    # Burgers cell's members and a standard-normal cotangent; M = 4 also
    # against plain
    row12 = {}
    for n_mem in (m2, 2 * m2):
        if n_mem == m2:
            pk, frm, fbm = packed2, frames2, fbar2
        else:
            pk = batched2d.pack_pi_params_2d_batched(member_cells(modelb["cell"], n_mem),
                                                     cfgb).contiguous()
            frm = batched2d._rollout_b_cuda(pk, member_ics(BURGERS_STAGE1.system,
                                                           BURGERS_STAGE1.grid, n_mem),
                                            cfgb, stepsb)
            fbm = torch.randn(frm.shape, generator=gen, device=dev)
        one_ms, per_ms, tr = turns(
            lambda: batched2d._phase1_b_ffma_persistent_cuda(pk, frm, fbm, cfgb),
            lambda: batched2d._phase1_b_steps_cuda(pk, frm, fbm, cfgb), reps=3)
        work = {"members": n_mem, "steps": stepsb,
                "bytes": n_mem * (packedb_bytes + 3 * stepsb * stateb_bytes + stateb_bytes),
                "flops": n_mem * bwb_flops}
        b_ms, b_by = bound_ms(work["bytes"], work["flops"])
        row12[n_mem] = {"members": n_mem, "steps": stepsb, "ms": one_ms, "per_step_ms": per_ms,
                        "us_per_step": 1e3 * one_ms / stepsb, "turns_ms": tr, "bound_ms": b_ms,
                        "bound_by": b_by,
                        "plan": one_launch["adj2d_batched_ffma_persistent_kernel"][f"M={n_mem}"]}
        batched_work[f"adj2d_batched_ffma_persistent_kernel[M={n_mem}]"] = work
        if n_mem > m2:
            errs = sweep_errs("adj2d_batched_ffma_persistent_kernel[M=4]",
                              batched2d._phase1_b_ffma_persistent_cuda(pk, frm, fbm, cfgb),
                              batched2d.fused_phase1_2d_batched_plain(pk, frm, fbm, cfgb))
            row12[n_mem]["max_abs_err"] = max(e for e, _ in errs.values())
            del pk, frm, fbm
    r12 = row12[m2]
    row12_plain_ms = cuda_ms(torch, lambda: batched2d.fused_phase1_2d_batched_plain(
        packed2, frames2, fbar2, cfgb), reps=1, warm=False)
    row12_by_path = {
        "ensemble": ens_launches["burgers_batched"]["fused_phase1_2d_batched.launches_kxk"]}
    kernels.extend([{
        "name": "adj2d_batched_ffma_persistent_kernel", "jax_kernel": "batched2d._phase1_kernel_b",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
        "replaces": "percnn_tpu/ops/pallas/batched2d.py:117",
        "launches": sum(row12_by_path.values()), "launches_by_path": row12_by_path,
        "max_abs_err": err["adj2d_batched_ffma_persistent_kernel"], "members": m2,
        "steps": stepsb, "ms": r12["ms"], "plain_ms": row12_plain_ms,
        "bound_ms": r12["bound_ms"], "bound_by": r12["bound_by"], "library_ms": None,
        "launches_per_call": 1, "us_per_step": r12["us_per_step"],
        "per_step_route": {"name": "adj2d_batched_kernel[k=5]", "launches_per_call": 2 * stepsb,
                           "ms": r12["per_step_ms"], "us_per_step": 1e3 * r12["per_step_ms"] / stepsb,
                           "max_abs_err": err["adj2d_batched_kernel[k=5]"]},
        "turns_ms": r12["turns_ms"], "plan": r12["plan"], "m4": row12[2 * m2],
    }, {
        "name": "adj2d_batched_kernel[k=5]", "jax_kernel": "batched2d._phase1_kernel_b",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
        "replaces": "percnn_tpu/ops/pallas/batched2d.py:117",
        "launches": sum(sweep_b_launches.values()), "launches_by_path": sweep_b_launches,
        "max_abs_err": err["adj2d_batched_kernel[k=5]"], "members": m2, "steps": stepsb,
        "ms": r12["per_step_ms"], "plain_ms": row12_plain_ms, "bound_ms": r12["bound_ms"],
        "bound_by": r12["bound_by"], "library_ms": None,
        "note": "the per-step route past the one-launch plan; ms at 100 x 100, M = 2, timed in "
                "turns with it", "m4": {"ms": row12[2 * m2]["per_step_ms"]}}])
    del frames4, fbar4, frames2, fbar2
    # one "two_phase" backward of GS2D at T = 800 (rollout_tp: one
    # autograd.grad a step, then the parameter gradients), trained cell,
    # data-loss cotangent: the forward and the backward by CUDA events
    tp2 = params_from_numpy(model["cell"], device=dev, dtype=torch.float32)
    tp2_leaves = [tp2["diff"]] + [br[k] for br in tp2["pi"] for k in sorted(br)]
    for leaf in tp2_leaves:
        leaf.requires_grad_(True)
    two_phase_ms = []
    for _ in range(2):   # a warm-up, then the reading
        fr2, fwd2_ms = event_ms(lambda: rollout_tp(runner._cell_step_for(cfg), tp2, h0,
                                                   TIME_BACKWARD_STEPS))
        _, bwd2_ms = event_ms(lambda: torch.autograd.grad((fr2 * fbar).sum(), tp2_leaves))
        two_phase_ms.append({"forward_ms": fwd2_ms, "backward_ms": bwd2_ms})
    del fr2
    # row 14: a T = 200 decomposed rollout of the golden GS2D cell on the
    # 2 x 2 mesh (four 50 x 50 blocks) by CUDA events, three ways in turns:
    # route 2, impl="pallas" as a user calls it (rollout2d_blocks_kernel, one
    # launch); route 1 (step2d_blocks_kernel, one launch a step); and PR
    # 10's per-block route (the exchange by halo_exchange, then
    # step_haloed_2d on each block, 4 launches a step, the blocks stacked
    # and joined at the end).  Beside them the plain versions (the blocks
    # rollout's, and PR 10's with step_haloed_2d_plain in the kernel's
    # place), one launch alone of each step kernel, and a profiler trace of
    # each route for its kernels' device time and the time outside them.
    # The bounds: the rollout's work counted once, as row 1's (h0 and the
    # parameters in, T + 1 frames out); a route 1 step reads and writes the
    # state; PR 10's step reads 4 haloed 54^2 blocks and writes 4 50^2 ones
    def sharded_plain(pk, x0, cfg_, steps):
        grid = mesh_blocks(x0)
        for _ in range(steps):
            grid = object_grid((2, 2), [sharded_step2d.step_haloed_2d_plain(pk, b.contiguous(), cfg_)
                                        for b in haloed(grid).flat])
        return grid

    def per_block_rollout(cell_, x0, cfg_, steps):
        """PR 10's decomposed rollout: a halo exchange and a step_haloed_2d
        launch a block and step, the frames stacked a block and joined."""
        grid = mesh_blocks(x0)
        frames = [[b[None]] for b in grid.flat]
        for _ in range(steps):
            grid = object_grid((2, 2), [sharded_step2d.step_haloed_2d(cell_, b, cfg_)
                                        for b in haloed(grid).flat])
            for k, b in enumerate(grid.flat):
                frames[k].append(b[None])
        rows = [torch.cat([torch.cat(frames[2 * i + j]) for j in range(2)], dim=2)
                for i in range(2)]
        return torch.cat(rows, dim=1)

    blk = GS2D_RECON.grid // 2
    field_layout = sharded._field_layout((2, 2), blk, blk)
    b14_ms, b14_by = bound_ms(
        CHECK_STEPS * 4 * (param_bytes + 8 * (blk + 4) ** 2 + 8 * blk ** 2),
        CHECK_STEPS * 4 * blk ** 2 * flops_per_cell_step(cfg))
    b14r_ms, b14r_by = bound_ms(param_bytes + (CHECK_STEPS + 2) * state_bytes,
                                CHECK_STEPS * cells * flops_per_cell_step(cfg))
    b14s_ms, b14s_by = bound_ms(CHECK_STEPS * (param_bytes + 2 * state_bytes),
                                CHECK_STEPS * cells * flops_per_cell_step(cfg))
    row14 = {}
    with torch.no_grad():
        old14 = per_block_rollout(params["cell"], h0, cfg, 20)
        new14 = sharded_rollout_nd(params["cell"], h0, cfg, 20, mesh, impl="pallas")
        per_block_vs_route2 = {"max_abs_err": max_abs(old14, new14),
                               "equal_bits": bool(torch.equal(old14, new14))}
        check(bool(((old14 - new14).abs().flatten(1).amax(1)
                    <= 2e-5 * torch.arange(21, device=dev)).all()),
              f"PR 10's per-block route vs the blocks rollout: {per_block_vs_route2}")
        del old14, new14
        route2_fn = lambda: sharded_rollout_nd(params["cell"], h0, cfg, CHECK_STEPS, mesh,
                                               impl="pallas")
        per_block_fn = lambda: per_block_rollout(params["cell"], h0, cfg, CHECK_STEPS)

        def route1_fn():
            with route1():
                return sharded_rollout_nd(params["cell"], h0, cfg, CHECK_STEPS, mesh,
                                          impl="pallas")

        # in turns: PR 10's, route 2, route 1, route 1, route 2, PR 10's
        order = (("per_block", per_block_fn, 3), ("route2", route2_fn, 20),
                 ("route1", route1_fn, 5))
        for name, fn, reps in order + order[::-1]:
            row14.setdefault(name, []).append(cuda_ms(torch, fn, reps=reps))
        traces = {name: profile_busy(torch, fn) for name, fn, _ in order}
    group14 = sharded._group_layouts(sharded._group_blocks(devs22), (2, 2), blk, blk)[0]
    state14 = sharded._states(h0, [group14], (2, 2), blk, blk)[0]
    none14, layout14 = group14.no_strips, group14.layout
    xb14 = haloed(mesh_blocks(h0))[0, 0].contiguous()
    kernel_of = {"per_block": "step2d_haloed_kernel", "route2": "rollout2d_blocks_kernel",
                 "route1": "step2d_blocks_kernel"}

    def trace14(name):
        tr = traces[name]
        k_ms = tr["kernel_ms"][kernel_of[name]]
        return {"window_ms": tr["window_ms"], "device_busy_ms": tr["device_busy_ms"],
                "kernel_ms": k_ms, "kernel_us_per_launch": tr["kernel_us_per_launch"][kernel_of[name]],
                "outside_kernel_share": 1.0 - k_ms / tr["window_ms"],
                "device_idle_share": tr["device_idle_share"]}

    def mean(v):
        return sum(v) / len(v)

    row14_launches = {k: v for k, v in sharded_launches.items()}
    blocks_plain_ms = cuda_ms(torch, lambda: sharded_step2d.rollout_blocks_2d_plain(
        packed, h0, field_layout, cfg, CHECK_STEPS), reps=1, warm=False)
    kernels.extend([{
        "name": "step2d_haloed_kernel", "jax_kernel": "sharded_step2d._step_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/sharded_step2d.cu",
        "replaces": "percnn_tpu/ops/pallas/sharded_step2d.py:37",
        "launches": sum(v["step_haloed_2d.launches"] for v in row14_launches.values()),
        "launches_by_path": {k: v["step_haloed_2d.launches"] for k, v in row14_launches.items()},
        "max_abs_err": err["step2d_haloed_kernel"], "steps": CHECK_STEPS, "blocks": 4,
        "ms": mean(row14["per_block"]), "turns_ms": row14["per_block"],
        "plain_ms": cuda_ms(torch, lambda: sharded_plain(packed, h0, cfg, CHECK_STEPS), reps=1, warm=False),
        "bound_ms": b14_ms, "bound_by": b14_by, "library_ms": None,
        "one_launch_ms": cuda_ms(torch, lambda: sharded_step2d._step_cuda(packed, xb14, cfg),
                                 reps=200),
        "trace": trace14("per_block"), "vs_route2_20_steps": per_block_vs_route2,
        "note": "PR 10's per-block route (step_haloed_2d a block and step, the exchange on the "
                "host), timed in turns with the blocks kernels' routes; launches from "
                "step_haloed_2d's entry point",
    }, {
        "name": "rollout2d_blocks_kernel", "jax_kernel": "sharded_step2d._step_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/sharded_step2d.cu",
        "replaces": "percnn_tpu/ops/pallas/sharded_step2d.py:37",
        "launches": sum(v["rollout_blocks_2d.launches"] for v in row14_launches.values()),
        "launches_by_path": {k: v["rollout_blocks_2d.launches"] for k, v in row14_launches.items()},
        "max_abs_err": err["rollout2d_blocks_kernel"], "steps": CHECK_STEPS, "blocks": 4,
        "ms": mean(row14["route2"]), "turns_ms": row14["route2"], "plain_ms": blocks_plain_ms,
        "bound_ms": b14r_ms, "bound_by": b14r_by, "library_ms": None,
        "plan": sharded_step2d.blocks_plan(4, blk, blk, cfg, n_sm),
        "occupancy": sharded_step2d.blocks_occupancy(4, blk, blk, cfg, dev),
        "trace": trace14("route2"),
        "note": "route 2: the whole decomposed rollout in one cooperative launch, every block "
                "on one card, no gradient",
    }, {
        "name": "step2d_blocks_kernel", "jax_kernel": "sharded_step2d._step_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/sharded_step2d.cu",
        "replaces": "percnn_tpu/ops/pallas/sharded_step2d.py:37",
        "launches": sum(v["step_blocks_2d.launches"] for v in row14_launches.values()),
        "launches_by_path": {k: v["step_blocks_2d.launches"] for k, v in row14_launches.items()},
        "max_abs_err": err["step2d_blocks_kernel"], "steps": CHECK_STEPS, "blocks": 4,
        "ms": mean(row14["route1"]), "turns_ms": row14["route1"], "plain_ms": blocks_plain_ms,
        "bound_ms": b14s_ms, "bound_by": b14s_by, "library_ms": None,
        "one_launch_ms": cuda_ms(torch, lambda: sharded_step2d._step_blocks_cuda(
            packed, state14, none14, layout14, cfg), reps=200),
        "trace": trace14("route1"),
        "note": "route 1: one launch a device and step (with a gradient, with blocks on more "
                "than one device, or past blocks_plan); plain_ms the blocks rollout's plain "
                "version, the same steps",
    }])
    phase("times", shape=list(h0.shape), steps=SERVE_STEPS, flops_per_rollout=flops,
          backward_steps=TIME_BACKWARD_STEPS, flops_per_backward=bw_flops,
          bytes_per_backward=bw_bytes, shape3d=list(h03.shape), steps3d=steps3,
          flops_per_rollout3d=flops3, backward_steps3d=TIME_BACKWARD3D_STEPS,
          flops_per_backward3d=bw3_flops, bytes_per_backward3d=bw3_bytes,
          burgers_shape=list(h0b.shape), burgers_steps=stepsb, flops_per_rollout_kxk=fwdb_flops,
          flops_per_backward_kxk=bwb_flops, bytes_per_backward_kxk=bwb_bytes,
          fallback_work=fallback_work, batched_work=batched_work, grid_barrier=grid_barrier,
          two_phase_gs2d_t800=two_phase_ms[-1], nvidia_smi=smi)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
