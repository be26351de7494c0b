#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GS2D, GS3D and Burgers Stage-1 serving and
training paths, their fallback routes, ensemble training and spatially
decomposed training, once on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

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
  build        nvcc builds of percnn_tpu_torch/ops/kernels/csrc/*.cu, in parallel
  golden       ISG and kernel rollout against tests/golden/pt_gs2d.npz
  golden3d     the 3D ISG and rollout3d_kernel against tests/golden/pt_gs3d.npz
  golden_burgers  the Burgers ISG and rollout2d_kxk_kernel against
               tests/golden/pt_burgers_s1.npz
  kernels      the forward kernels against their plain versions, 100 x 100, T = 200
  grads        pg2d_kernel against its plain version (100 x 100, T = 200,
               golden cell, data-loss cotangent), and the fused gradients
               against f64 autograd
  kernels3d    at 48^3: rollout3d_kernel against its plain version (frames
               and final state, T = 300), pg3d_kernel against its plain
               sweep (T = 50, golden cell, data-loss cotangent), and the
               fused 3D gradients against f64 autograd (random-init cell,
               random target, 12 steps)
  kernels_kxk  rollout2d_kxk_kernel against its plain version at 100 x 100,
               C = 16, k = 5, T = 200, golden Burgers cell, Burgers IC
  grads_kxk    adj2d_kxk_kernel against its plain sweep (the same, a
               standard-normal cotangent), and the fused k x k gradients
               and those of remat (eager autograd) against f64 autograd
               (random-init cell, random target, 12 steps, 100 x 100)
  kernels_fallback  rollout2d_kernel (T = 200) and final2d_kernel (1200
               steps) at k = 5, adj2d_ys_kernel and adj2d_kernel at k = 5
               (T = 200) on the golden Burgers cell, adj2d_kernel at k = 1
               (T = 200, golden GS2D cell, data-loss cotangent) and
               adj3d_kernel (48^3, T = 50, golden GS3D cell) against their
               plain versions
  grads_fallback  the gradients of bptt="fused" (GS2D, GS3D, Burgers with
               the MXU switches off, and with YS_PATH_ENABLED off too) and
               of bptt="two_phase" (the three cells) against f64 autograd on
               the referee setup, each route's launches counted
  serve        one uncounted warm-up request of each kind, then three frames
               requests and one final-state request, 2500 steps, with the
               kernels' launch counters set to 0 just before
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
               frames requests and one final-state request (final2d_kernel
               at k = 5), 1200 steps, on the golden Burgers model, with the
               launch counters set to 0 just before
  train_burgers  run_experiment(BURGERS_STAGE1): the 1200-frame truth (kept
               in a temp cache for train_fallback), ISG pretrain, 10
               iterations at T = 200 with best-val selection, the 1200-step
               evaluation, with the launch counters set to 0 just before
  train_burgers_parity  as train_parity for Burgers: 32 x 32, T = 20,
               5 iterations
  train_fallback  run_experiment(BURGERS_STAGE1) with the MXU switches off
               (10 iterations at T = 200, the cached truth, the evaluation),
               and build_loss_fn(bptt="fused") + train for 5 iterations of
               GS2D at T = 800 and of GS3D at T = 300 and 3 of Burgers with
               YS_PATH_ENABLED off, every launch counted
  step_breakdown  one training iteration at each T after a warm-up: host
               and device ms of the whole, the same split into ISG and
               forward, losses, backward (and pg2d_kernel in it), Adam, and
               the device's idle share from a torch.profiler trace
  step_breakdown3d  the same for GS3D at T = 150, 300 (pg3d_kernel)
  step_breakdown_kxk  the same for Burgers at T = 200 (adj2d_kxk_kernel)
  kernels_batched  the ensemble's kernels (rollout2d_batched_kernel,
               adj2d_batched_kernel, pg2d_batched_kernel) against their plain
               versions at M = 4, 100 x 100, T = 200 (the golden GS2D cell
               and three seeded perturbations of it, a standard-normal
               cotangent), each member against the single-member kernel on
               that member, and the k = 5 contracts of the first two on the
               golden Burgers cell (M = 2)
  grads_batched  the gradients of bptt="batched" and "batched_pg" against
               f64 autograd on the referee setup (random-init cells, random
               targets, 12 steps, full width, M = 4), and "batched" of the
               5x5 cell (M = 2), each route's launches counted
  kernels_sharded  step2d_haloed_kernel against its plain version on the
               haloed blocks of a 2 x 2 mesh of cuda:0 (four 50 x 50 blocks
               of 100 x 100, and a 6 x 10 block) for the golden GS2D (k = 1)
               and Burgers (k = 5) cells; then sharded_rollout_nd
               (impl="pallas", T = 200, launches counted) against the
               single-device rollout2d_kernel and against impl="jnp"
  grads_sharded  the gradients of sharded_rollout_nd, impl="pallas" and
               "jnp", against f64 autograd on the referee setup (k = 1 and
               k = 5, 12 steps, full width), launches counted
  sharded3d    GS3D's sharded_rollout_nd on a (2, 2, 2) mesh of cuda:0 at
               48^3, T = 50, against rollout3d_kernel
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
               "batched_pg" and for "auto" (the per-member loop): host and
               device ms, enqueue, and the device's idle share from a
               torch.profiler trace
  times        each kernel's and its plain version's ms at the main path's
               shapes, beside the card's bound for the same work, one
               bptt="two_phase" GS2D backward at T = 800, and a T = 200
               decomposed rollout through row 14 with its profiler trace

Then a ``{"kernels": [...]}`` line (19 entries: the 14 ported TPU kernels,
with the k = 5 contracts of rollout2d_kernel, final2d_kernel, adj2d_kernel,
rollout2d_batched_kernel and adj2d_batched_kernel listed apart), the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check ends the run with a
non-zero exit and no last line; so does a machine without a CUDA device, or
a directory without the percnn_tpu_torch package beside this script.  The
script imports neither jax nor percnn_tpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
# HBM3 bandwidth and float32 outside the tensor cores (an FMA counts as 2).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

SERVE_STEPS = 2500
CHECK_STEPS = 200
SEEDS = (66, 67, 68)
TRAIN_ITERS = 30          # 10 at each of T = 200, 400, 800
ISG_PRETRAIN_ITERS = 200
TIME_BACKWARD_STEPS = 800
BREAKDOWN_REPS = 5
CHECK3D_STEPS = 300       # rollout3d_kernel against its plain version
PG3D_CHECK_STEPS = 50     # pg3d_kernel against its plain sweep
TRAIN3D_ITERS = 20        # 10 at each of T = 150, 300
TIME_BACKWARD3D_STEPS = 300
CHECK_KXK_STEPS = 200     # the k x k kernels against their plain versions
TRAIN_BURGERS_ITERS = 10  # of BURGERS_STAGE1's 10000, at T = 200
FALLBACK_ITERS = 5        # GS2D at T = 800 and GS3D at T = 300 through bptt="fused"
FALLBACK_YS_OFF_ITERS = 3  # Burgers at T = 200 through adj2d_kernel at k = 5
ENS_MEMBERS = 4           # the ensemble's M, the CLI's default
ENS_KXK_MEMBERS = 2       # the 5x5 cell's ensemble (kernels_batched, grads_batched)
ENS_ITERS = 6             # 2 at each of T = 200, 400, 800
ENS_BURGERS_ITERS = 2     # at T = 200
MESH_ITERS = 3            # train_mesh: 1 at each of T = 200, 400, 800
SHARDED3D_STEPS = 50      # the GS3D decomposed rollout on a (2, 2, 2) mesh


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
    """Flops of one expanded-cubic Euler step (rollout3d_kernel) at one
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


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device ms of fn() over reps calls, by CUDA events, after one warm-up."""
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
               for name in ("rollout2d_kernel", "pg2d_kernel", "rollout3d_kernel",
                            "pg3d_kernel", "rollout2d_kxk_kernel", "adj2d_kxk_act_kernel",
                            "adj2d_kxk_gather_kernel", "rollout2d_batched_kernel",
                            "adj2d_batched_kernel", "pg2d_batched_kernel",
                            "step2d_haloed_kernel")}
    return {"window_ms": 1e-3 * window, "device_busy_ms": 1e-3 * busy,
            "device_idle_share": 1.0 - busy / window if device else None,
            "device_events": len(device),
            "kernel_ms": {name: 1e-3 * sum(d) for name, d in kernels.items()},
            "kernel_us_per_launch": {name: sum(d) / len(d) if d else None
                                     for name, d in kernels.items()}}


def main() -> int:
    import numpy as np
    import torch

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
    from percnn_tpu_torch.parallel import halo_exchange, make_mesh, sharded_rollout_nd
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
               "adj2d", "batched2d", "sharded_step2d")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        build_s = dict(zip(sources, pool.map(build, sources)))
    phase("build", sources={f"percnn_tpu_torch/ops/kernels/csrc/{n}.cu": round(build_s[n], 3)
                            for n in sources},
          ptxas={n: _build.PTXAS.get(n) for n in sources})

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
    frames3 = cell3d.fused_rollout_3d(params3["cell"], frames3_want[0], cfg3, n_golden3)
    torch.cuda.synchronize()
    step3_err = [max_abs(frames3[k], frames3_want[k]) for k in range(1, n_golden3 + 1)]
    for k, e in enumerate(step3_err, start=1):
        check(e <= 2e-5 * k, f"golden 3D rollout step {k}: max |diff| {e} over {2e-5 * k}")
    phase("golden3d", isg_max_abs_err=isg3_err, isg_atol=2e-6, shape=list(frames3.shape[1:]),
          rollout_max_abs_err_per_step=step3_err, rollout_bar="2e-5 * t")

    # golden_burgers: the reference's trained Burgers Stage-1 model (5x5 Pi
    # cell, C = 16), ISG 32^2 -> 64^2, 8 steps through rollout2d_kxk_kernel
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
    cell2d.fused_rollout_kxk_2d.launches = 0
    framesb = cell2d.fused_rollout_2d(paramsb["cell"], framesb_want[0], cfgb, n_goldenb)
    torch.cuda.synchronize()
    check(cell2d.fused_rollout_kxk_2d.launches == n_goldenb,
          f"golden Burgers rollout: {cell2d.fused_rollout_kxk_2d.launches} kernel launches")
    stepb_err = [max_abs(framesb[k], framesb_want[k]) for k in range(1, n_goldenb + 1)]
    for k, e in enumerate(stepb_err, start=1):
        check(e <= 2e-5 * k, f"golden Burgers rollout step {k}: max |diff| {e} over {2e-5 * k}")
    phase("golden_burgers", isg_max_abs_err=isgb_err, isg_atol=2e-6,
          shape=list(framesb.shape[1:]), rollout_max_abs_err_per_step=stepb_err,
          rollout_bar="2e-5 * t")

    # kernels: full width, trained weights, against the plain versions
    h0 = torch.as_tensor(default_ic("gray_scott_2d", GS2D_RECON.grid), dtype=torch.float32,
                         device=dev)
    packed = cell2d.pack_pi_params_2d(params["cell"], cfg)
    got = cell2d.fused_rollout_2d(params["cell"], h0, cfg, CHECK_STEPS)
    want = cell2d.fused_rollout_2d_plain(packed, h0, cfg, CHECK_STEPS)
    got_final = cell2d.fused_rollout_final_2d(params["cell"], h0, cfg, CHECK_STEPS)
    want_final = cell2d.fused_rollout_final_2d_plain(packed, h0, cfg, CHECK_STEPS)
    torch.cuda.synchronize()
    err = {"rollout2d_kernel": max_abs(got, want), "final2d_kernel": max_abs(got_final, want_final)}
    check(allclose(got, want, rtol=2e-4, atol=1e-5),
          f"rollout2d_kernel vs plain: max |diff| {err['rollout2d_kernel']}")
    check(allclose(got_final, want_final, rtol=2e-4, atol=1e-5),
          f"final2d_kernel vs plain: max |diff| {err['final2d_kernel']}")
    phase("kernels", shape=[GS2D_RECON.grid, GS2D_RECON.grid, 2], steps=CHECK_STEPS,
          max_abs_err=err, rtol=2e-4, atol=1e-5)

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
              f"pg2d_kernel vs plain, {name}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
    err["pg2d_kernel"] = max(e for e, _ in leaf_err.values())

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
          pg2d_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc) in leaf_err.items()},
          pg2d_bar="2e-4 * max|leaf| + 2e-6",
          f64_random_cell_12_steps={"worst_leaf": worst_ref, "bar": 1e-4, **rel_ref},
          f64_trained_cell_200_steps={"worst": worst_gold, "bar": "2 x autograd_f32",
                                      **rel_gold})

    # kernels3d: the 3D kernels at full width against their plain versions
    n3 = GS3D_RECON.grid
    h03 = torch.as_tensor(default_ic("gray_scott_3d", n3), dtype=torch.float32, device=dev)
    expanded3 = cell3d.pack_pi_expanded_3d(params3["cell"], cfg3).contiguous()
    packed3 = cell3d.pack_pi_params_3d(params3["cell"], cfg3)
    got = cell3d._rollout_cuda(expanded3, h03, CHECK3D_STEPS)
    want = cell3d.fused_rollout_3d_plain(expanded3, h03, CHECK3D_STEPS)
    got_final = cell3d._rollout_cuda(expanded3, h03, CHECK3D_STEPS, final_only=True)
    want_final = cell3d.fused_rollout_3d_plain(expanded3, h03, CHECK3D_STEPS, final_only=True)
    torch.cuda.synchronize()
    err["rollout3d_kernel"] = max(max_abs(got, want), max_abs(got_final, want_final))
    check(allclose(got, want, rtol=2e-4, atol=1e-5),
          f"rollout3d_kernel vs plain, frames: max |diff| {max_abs(got, want)}")
    check(allclose(got_final, want_final, rtol=2e-4, atol=1e-5),
          f"rollout3d_kernel vs plain, final state: max |diff| {max_abs(got_final, want_final)}")
    del got, want
    frames3 = cell3d._rollout_cuda(expanded3, h03, PG3D_CHECK_STEPS)
    # a cotangent of O(1) in every cell (GS3D's data-loss cotangent is near
    # 5e-7 a cell, which would put every leaf under the bar's 2e-6 floor)
    fbar3 = torch.as_tensor(np.random.RandomState(3).standard_normal(tuple(frames3.shape)),
                            dtype=torch.float32, device=dev)
    g0_k, acc_k = backward3d._pg_cuda(packed3, frames3, fbar3, cfg3)
    g0_p, acc_p = backward3d.fused_phase1_pg_3d_plain(packed3, frames3, fbar3.contiguous(), cfg3)
    torch.cuda.synchronize()
    sums_k, sums_p = acc_k.sum((1, 2, 3)), acc_p.sum((1, 2, 3))
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
    leaf3_err = {"g0": (max_abs(g0_k, g0_p), float(g0_p.abs().max()))}
    for name, (start, n) in groups3.items():
        leaf3_err[name] = (max_abs(sums_k[start:start + n], sums_p[start:start + n]),
                           float(sums_p[start:start + n].abs().max()))
    for name, (e, scale) in leaf3_err.items():
        check(2e-6 <= 0.01 * 2e-4 * scale,
              f"pg3d_kernel vs plain, {name}: the floor 2e-6 sets the bar (max|leaf| {scale})")
        check(e <= 2e-4 * scale + 2e-6,
              f"pg3d_kernel vs plain, {name}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
    err["pg3d_kernel"] = max(e for e, _ in leaf3_err.values())
    del acc_k, acc_p
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
          rollout3d_max_abs_err=err["rollout3d_kernel"], rollout_rtol=2e-4, rollout_atol=1e-5,
          pg_steps=PG3D_CHECK_STEPS,
          pg3d_cotangent="standard normal, seed 3",
          pg3d_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc) in leaf3_err.items()},
          pg3d_bar="2e-4 * max|leaf| + 2e-6",
          f64_random_cell_12_steps={"worst_leaf": worst3, "bar": 1e-4, **rel3})

    # kernels_kxk: rollout2d_kxk_kernel at Burgers' full width, golden cell,
    # against its plain version
    nb_grid = BURGERS_STAGE1.grid
    h0b = torch.as_tensor(default_ic("burgers", nb_grid), dtype=torch.float32, device=dev)
    wmatb = cell2d.pack_pi_matrix_2d(paramsb["cell"], cfgb).contiguous()
    tailb = cell2d.pi_tail_2d(paramsb["cell"], cfgb)
    got = cell2d._rollout_kxk_cuda(wmatb, tailb, h0b, cfgb, CHECK_KXK_STEPS)
    want = cell2d.fused_rollout_kxk_2d_plain(wmatb, tailb, h0b, cfgb, CHECK_KXK_STEPS)
    torch.cuda.synchronize()
    err["rollout2d_kxk_kernel"] = max_abs(got, want)
    check(allclose(got, want, rtol=2e-4, atol=1e-5),
          f"rollout2d_kxk_kernel vs plain: max |diff| {err['rollout2d_kxk_kernel']}")
    phase("kernels_kxk", shape=[nb_grid, nb_grid, 2], hidden=cfgb.hidden,
          kernel_size=cfgb.kernel_size, steps=CHECK_KXK_STEPS,
          max_abs_err=err["rollout2d_kxk_kernel"], max_abs_frame=float(want.abs().max()),
          rtol=2e-4, atol=1e-5)

    # grads_kxk: adj2d_kxk_kernel against its plain sweep on those frames, and
    # the fused k x k gradients against f64 autograd
    fbarb = torch.as_tensor(np.random.RandomState(4).standard_normal(tuple(got.shape)),
                            dtype=torch.float32, device=dev)
    out_k = backward2d._phase1_kxk_cuda(wmatb, tailb, got, fbarb, cfgb)
    out_p = backward2d.fused_phase1_kxk_2d_plain(wmatb, tailb, got, fbarb, cfgb)
    torch.cuda.synchronize()
    kxk_err = {name: (max_abs(a, b), float(b.abs().max()))
               for name, a, b in zip(("g_ins", "g0", "ys"), out_k, out_p)}
    for name, (e, scale) in kxk_err.items():
        check(e <= 2e-4 * scale + 2e-6,
              f"adj2d_kxk_kernel vs plain, {name}: max |diff| {e} over 2e-4 * {scale} + 2e-6")
    err["adj2d_kxk_kernel"] = max(e for e, _ in kxk_err.values())
    del got, want, out_k, out_p
    # the measure of the gradient referee at Burgers' shape: random-init
    # cell, random target, 12 steps, 100 x 100, held to 1e-4
    rngb = np.random.RandomState(5)
    refb_cell = params_to_numpy(init_pi_cell(torch.Generator().manual_seed(0), cfgb,
                                             device="cpu"))
    xb_ref = torch.as_tensor(0.5 * rngb.standard_normal((nb_grid,) * 2 + (2,)),
                             dtype=torch.float32, device=dev)
    tgtb = torch.as_tensor(rngb.standard_normal((13,) + tuple(xb_ref.shape)), device=dev)
    relb = rel_errs_vs_f64(refb_cell, xb_ref, 12,
                           lambda fr: ((fr - tgtb.to(fr.dtype)) ** 2).mean(), cfg=cfgb,
                           routes={"fused": backward2d.fused_rollout_tp_2d})
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
          adj_vs_plain_err_and_max_leaf={k: [e, sc] for k, (e, sc) in kxk_err.items()},
          adj_bar="2e-4 * max|leaf| + 2e-6",
          f64_random_cell_12_steps={"worst_leaf": worstb, "bar": 1e-4, **relb})

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

    # rollout2d_kernel and final2d_kernel at k = 5 on the golden Burgers cell:
    # frames from the Burgers IC, as rollout2d_kxk_kernel's check; the final
    # state over the serving horizon from what serving rolls out, the ISG's
    # answer to a Burgers request
    packedb = cell2d.pack_pi_params_2d(paramsb["cell"], cfgb)
    framesb = cell2d._rollout_cuda(packedb, h0b, cfgb, CHECK_KXK_STEPS)
    want = cell2d.fused_rollout_2d_plain(packedb, h0b, cfgb, CHECK_KXK_STEPS)
    requestb = add_noise(default_ic("burgers", nb_grid, seed=SEEDS[0])[None],
                         BURGERS_STAGE1.noise_pct, seed=SEEDS[0])[0][::isgb.scale, ::isgb.scale]
    with torch.inference_mode():
        h0s = isg_apply(paramsb["isg"], torch.as_tensor(requestb, dtype=torch.float32,
                                                        device=dev)[None], isgb)[0].contiguous()
    final5 = cell2d._final_cuda(packedb, h0s, cfgb, BURGERS_STAGE1.infer_steps)
    final5_want = cell2d.fused_rollout_final_2d_plain(packedb, h0s, cfgb,
                                                      BURGERS_STAGE1.infer_steps)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(final5).all() and torch.isfinite(final5_want).all()),
          f"final2d_kernel k = 5 over {BURGERS_STAGE1.infer_steps} steps: finite "
          f"{bool(torch.isfinite(final5).all())}, plain finite "
          f"{bool(torch.isfinite(final5_want).all())}")
    err["rollout2d_kernel[k=5]"] = max_abs(framesb, want)
    err["final2d_kernel[k=5]"] = max_abs(final5, final5_want)
    check(allclose(framesb, want, rtol=2e-4, atol=1e-5),
          f"rollout2d_kernel k = 5 vs plain: max |diff| {err['rollout2d_kernel[k=5]']}")
    check(allclose(final5, final5_want, rtol=2e-4, atol=1e-5),
          f"final2d_kernel k = 5 vs plain: max |diff| {err['final2d_kernel[k=5]']}")
    # adj2d_ys_kernel and adj2d_kernel at k = 5 on those frames, a
    # standard-normal cotangent (as adj2d_kxk_kernel's check)
    fbarb = torch.as_tensor(np.random.RandomState(4).standard_normal(tuple(framesb.shape)),
                            dtype=torch.float32, device=dev)
    ysb = backward2d._precompute_ys(paramsb["cell"], framesb[:-1], cfgb)
    fallback_errs = {
        "adj2d_ys_kernel": sweep_errs(
            "adj2d_ys_kernel", backward2d._phase1_ys_cuda(packedb, fbarb, ysb, cfgb),
            backward2d.fused_phase1_ys_2d_plain(packedb, fbarb, ysb, cfgb)),
        "adj2d_kernel[k=5]": sweep_errs(
            "adj2d_kernel[k=5]", backward2d._phase1_cuda(packedb, framesb, fbarb, cfgb),
            backward2d.fused_phase1_2d_plain(packedb, framesb, fbarb, cfgb)),
    }
    del ysb, want
    # adj2d_kernel at k = 1 on the golden GS2D cell, the data-loss cotangent
    frames1 = cell2d._rollout_cuda(packed, h0, cfg, CHECK_STEPS)
    fbar1 = cotangent(frames1)[1].contiguous()
    fallback_errs["adj2d_kernel"] = sweep_errs(
        "adj2d_kernel", backward2d._phase1_cuda(packed, frames1, fbar1, cfg),
        backward2d.fused_phase1_2d_plain(packed, frames1, fbar1, cfg))
    # adj3d_kernel on the golden GS3D cell at 48^3, a standard-normal
    # cotangent (as pg3d_kernel's check)
    frames3 = cell3d._rollout_cuda(expanded3, h03, PG3D_CHECK_STEPS)
    fbar3 = torch.as_tensor(np.random.RandomState(3).standard_normal(tuple(frames3.shape)),
                            dtype=torch.float32, device=dev)
    fallback_errs["adj3d_kernel"] = sweep_errs(
        "adj3d_kernel", backward3d._phase1_cuda(packed3, frames3, fbar3, cfg3),
        backward3d.fused_phase1_3d_plain(packed3, frames3, fbar3, cfg3))
    torch.cuda.synchronize()
    del frames1, frames3, fbar1, fbar3
    phase("kernels_fallback", burgers_steps=CHECK_KXK_STEPS,
          burgers_final_steps=BURGERS_STAGE1.infer_steps, gs2d_steps=CHECK_STEPS,
          gs3d_steps=PG3D_CHECK_STEPS, shape3d=[n3, n3, n3, 2],
          forward_max_abs_err={k: err[k] for k in ("rollout2d_kernel[k=5]",
                                                   "final2d_kernel[k=5]")},
          forward_rtol=2e-4, forward_atol=1e-5,
          cotangents={"Burgers": "standard normal, seed 4", "GS2D": "data loss",
                      "GS3D": "standard normal, seed 3"},
          sweep_err_and_max={k: v for k, v in fallback_errs.items()},
          sweep_bar="2e-4 * max|plain| + 2e-6")

    # grads_fallback: each new route's gradients against f64 autograd on the
    # referee setup, with the launches of each route counted
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

    counters = [(cell2d.fused_rollout_2d, "launches"), (cell2d.fused_rollout_2d, "launches_kxk"),
                (cell2d.fused_rollout_final_2d, "launches_kxk"),
                (cell2d.fused_rollout_kxk_2d, "launches"), (cell3d.fused_rollout_3d, "launches"),
                (backward2d.fused_rollout_tp_2d, "launches"),
                (backward2d.fused_phase1_2d, "launches"),
                (backward2d.fused_phase1_ys_2d, "launches"),
                (backward3d.fused_phase1_3d, "launches"),
                (backward2d.fused_rollout_tp_2d_pg, "launches"),
                (batched2d.fused_rollout_2d_batched, "launches"),
                (batched2d.fused_rollout_2d_batched, "launches_kxk"),
                (batched2d.fused_phase1_2d_batched, "launches"),
                (batched2d.fused_phase1_2d_batched, "launches_kxk"),
                (batched2d.fused_phase1_pg_2d_batched, "launches"),
                (sharded_step2d.step_haloed_2d, "launches")]

    def zero_counts():
        for obj, attr in counters:
            setattr(obj, attr, 0)

    def read_counts():
        return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in counters
                if getattr(obj, attr)}

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

    hold_to_f64("gs2d", {"fused_rollout_2d.launches": 12, "fused_phase1_2d.launches": 12},
                ref_cell, x_ref, lambda fr: ((fr - tgt.to(fr.dtype)) ** 2).mean(), cfg,
                {"fused": backward2d.fused_rollout_tp_2d, "two_phase": two_phase})
    hold_to_f64("gs3d", {"fused_rollout_3d.launches": 12, "fused_phase1_3d.launches": 12},
                ref3_cell, x3_ref, lambda fr: ((fr - tgt3.to(fr.dtype)) ** 2).mean(), cfg3,
                {"fused": backward3d.fused_rollout_tp_3d, "two_phase": two_phase})
    lossb = lambda fr: ((fr - tgtb.to(fr.dtype)) ** 2).mean()   # noqa: E731
    hold_to_f64("burgers_mxu_off", {"fused_rollout_2d.launches_kxk": 12,
                                    "fused_phase1_ys_2d.launches": 24},
                refb_cell, xb_ref, lossb, cfgb, {"fused": backward2d.fused_rollout_tp_2d},
                flags=(False, False, True))
    hold_to_f64("burgers_ys_off", {"fused_rollout_2d.launches_kxk": 12,
                                   "fused_phase1_2d.launches": 24},
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

    batched_err, vs_single = {}, {}
    for suffix, cfg_, cell_np, exp_, n_mem in (
            ("", cfg, model["cell"], GS2D_RECON, ENS_MEMBERS),
            ("[k=5]", cfgb, modelb["cell"], BURGERS_STAGE1, ENS_KXK_MEMBERS)):
        packed_m = batched2d.pack_pi_params_2d_batched(member_cells(cell_np, n_mem),
                                                       cfg_).contiguous()
        h0_m = member_ics(exp_.system, exp_.grid, n_mem)
        got = batched2d._rollout_b_cuda(packed_m, h0_m, cfg_, CHECK_STEPS)
        want = batched2d.fused_rollout_2d_batched_plain(packed_m, h0_m, cfg_, CHECK_STEPS)
        single = [cell2d._rollout_cuda(packed_m[m].contiguous(), h0_m[m], cfg_, CHECK_STEPS)
                  for m in range(n_mem)]
        torch.cuda.synchronize()
        name = f"rollout2d_batched_kernel{suffix}"
        err[name] = max_abs(got, want)
        check(bool(torch.isfinite(want).all()) and allclose(got, want, rtol=2e-4, atol=1e-5),
              f"{name} vs plain: max |diff| {err[name]}")
        vs_single[name] = max(max_abs(got[m], single[m]) for m in range(n_mem))
        fbar_m = torch.as_tensor(np.random.RandomState(9).standard_normal(tuple(got.shape)),
                                 dtype=torch.float32, device=dev)
        name = f"adj2d_batched_kernel{suffix}"
        out_k = batched2d._phase1_b_cuda(packed_m, got, fbar_m, cfg_)
        batched_err[name] = sweep_errs(
            name, out_k, batched2d.fused_phase1_2d_batched_plain(packed_m, got, fbar_m, cfg_))
        single = [backward2d._phase1_cuda(packed_m[m].contiguous(), got[m].contiguous(),
                                          fbar_m[m].contiguous(), cfg_) for m in range(n_mem)]
        vs_single[name] = max(max(max_abs(out_k[0][m], single[m][0]),
                                  max_abs(out_k[1][m], single[m][1])) for m in range(n_mem))
        if cfg_.kernel_size > 1:
            continue
        # pg2d_batched_kernel: g0 and each member's plane sums, leaf by leaf
        g0_k, acc_k = batched2d._pg_b_cuda(packed_m, got, fbar_m, cfg_)
        g0_p, acc_p = batched2d.fused_phase1_pg_2d_batched_plain(packed_m, got, fbar_m, cfg_)
        single = [backward2d._pg_cuda(packed_m[m].contiguous(), got[m].contiguous(),
                                      fbar_m[m].contiguous(), cfg_) for m in range(n_mem)]
        torch.cuda.synchronize()
        sums_k, sums_p = acc_k.sum((2, 3)), acc_p.sum((2, 3))
        pg_err = {"g0": (max_abs(g0_k, g0_p), float(g0_p.abs().max()))}
        for m in range(n_mem):
            for leaf, (start, n) in groups.items():
                pg_err[f"member{m}.{leaf}"] = (
                    max_abs(sums_k[m, start:start + n], sums_p[m, start:start + n]),
                    float(sums_p[m, start:start + n].abs().max()))
        for leaf, (e, scale) in pg_err.items():
            check(e <= 2e-4 * scale + 2e-6, f"pg2d_batched_kernel vs plain, {leaf}: max |diff| "
                                            f"{e} over 2e-4 * {scale} + 2e-6")
        err["pg2d_batched_kernel"] = max(e for e, _ in pg_err.values())
        batched_err["pg2d_batched_kernel"] = {k: list(v) for k, v in pg_err.items()}
        vs_single["pg2d_batched_kernel"] = max(max(max_abs(g0_k[m], single[m][0]),
                                                   max_abs(acc_k[m], single[m][1]))
                                               for m in range(n_mem))
        del acc_k, acc_p
    del got, want, single, out_k, fbar_m
    phase("kernels_batched", members={"gs2d": ENS_MEMBERS, "burgers": ENS_KXK_MEMBERS},
          steps=CHECK_STEPS, shape=[GS2D_RECON.grid, GS2D_RECON.grid, 2],
          cells="golden cell and seeded 1% perturbations", ics="default_ic seeds 60..",
          cotangent="standard normal, seed 9",
          forward_max_abs_err={k: err[k] for k in ("rollout2d_batched_kernel",
                                                   "rollout2d_batched_kernel[k=5]")},
          forward_rtol=2e-4, forward_atol=1e-5, sweep_err_and_max=batched_err,
          sweep_bar="2e-4 * max|plain| + 2e-6",
          member_vs_single_kernel_max_abs_diff=vs_single)

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
                                     {"fused_rollout_2d_batched.launches": 12,
                                      "fused_phase1_pg_2d_batched.launches": 12}, 11),
        "batched": batched_vs_f64(cfg, ENS_MEMBERS, "batched",
                                  {"fused_rollout_2d_batched.launches": 12,
                                   "fused_phase1_2d_batched.launches": 12}, 11),
        "batched[k=5]": batched_vs_f64(cfgb, ENS_KXK_MEMBERS, "batched",
                                       {"fused_rollout_2d_batched.launches_kxk": 12,
                                        "fused_phase1_2d_batched.launches_kxk": 24}, 12),
    }
    phase("grads_batched", setup="random-init cells (seeds 0..M-1), random targets, 12 steps, "
                                 "full width", bar=1e-4, routes=grads_b)

    # kernels_sharded: row 14 on the haloed blocks of a 2 x 2 mesh that
    # repeats cuda:0 (four 50 x 50 blocks of the 100 x 100 field, and a
    # 6 x 10 block narrower than the k x k tile) for the golden GS2D (k = 1)
    # and Burgers (k = 5) cells against its plain version; then the
    # decomposed rollout of impl="pallas", the slice's main path with its
    # launches counted, against the single-device rollout2d_kernel (the same
    # step on the periodic field) and against impl="jnp" (the eager step)
    axes2 = ("x", "y")
    mesh = make_mesh(axes2, shape=(2, 2), devices=[dev] * 4)

    def mesh_blocks(h):
        n, m = h.shape[0] // 2, h.shape[1] // 2
        return object_grid((2, 2), [h[i * n:(i + 1) * n, j * m:(j + 1) * m]
                                    for i in range(2) for j in range(2)])

    def haloed(grid):
        return halo_exchange(grid, mesh=mesh, axis_names=axes2, array_axes=(0, 1))

    packedb = cell2d.pack_pi_params_2d(paramsb["cell"], cfgb)
    sharded_cells = {"gs2d_k1": (cfg, params["cell"], h0, packed),
                     "burgers_k5": (cfgb, paramsb["cell"], h0b, packedb)}
    block_err = {}
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
    err["step2d_haloed_kernel"] = max(block_err.values())
    sharded_step2d.step_haloed_2d.launches = 0
    sharded_roll = {}
    with torch.no_grad():
        for label, (cfg_, cell_, x0, pk) in sharded_cells.items():
            got = sharded_rollout_nd(cell_, x0, cfg_, CHECK_STEPS, mesh, impl="pallas")
            single = cell2d._rollout_cuda(pk, x0, cfg_, CHECK_STEPS)
            eager = sharded_rollout_nd(cell_, x0, cfg_, CHECK_STEPS, mesh, impl="jnp")
            torch.cuda.synchronize()
            bar = 2e-5 * torch.arange(CHECK_STEPS + 1, device=dev)
            for other, ref_frames in (("single_rollout2d_kernel", single), ("jnp", eager)):
                per_step = (got - ref_frames).abs().flatten(1).amax(1)
                worst = int((per_step - bar).argmax())
                check(bool((per_step <= bar).all()),
                      f"sharded pallas rollout vs {other}, {label}: step {worst} max |diff| "
                      f"{float(per_step[worst])} over {float(bar[worst])}")
                sharded_roll[f"{label}.vs_{other}"] = {
                    "max_abs_err": float(per_step.max()),
                    "worst_step_over_bar": float((per_step[1:] / bar[1:]).max())}
            del got, single, eager
    sharded_launches = {"kernels_sharded": sharded_step2d.step_haloed_2d.launches}
    check(sharded_launches["kernels_sharded"] == len(sharded_cells) * 4 * CHECK_STEPS,
          f"sharded rollouts: {sharded_launches} launches of step2d_haloed_kernel")
    phase("kernels_sharded", mesh=mesh.shape, devices=[str(d) for d in mesh.devices.flat],
          block=[50, 50], steps=CHECK_STEPS, step_vs_plain_max_abs_err=block_err,
          rtol=2e-4, atol=1e-5, rollouts=sharded_roll, rollout_bar="2e-5 * t",
          launches=sharded_launches["kernels_sharded"])

    # grads_sharded: the gradients through the exchange, impl="pallas" (row
    # 14 forward, eager adjoint) and "jnp", against f64 autograd on the
    # referee setup of grads and grads_kxk (random-init cell, random target,
    # 12 steps, full width), launches counted: with remat each checkpointed
    # segment runs its forward twice
    def sharded_route(impl):
        return lambda p, x, cfg_, steps: sharded_rollout_nd(p, x, cfg_, steps, mesh, impl=impl)

    sharded_step2d.step_haloed_2d.launches = 0
    routes_sh = {"pallas": sharded_route("pallas"), "jnp": sharded_route("jnp")}
    rel_sh = {
        "gs2d_k1": rel_errs_vs_f64(ref_cell, x_ref, 12,
                                   lambda fr: ((fr - tgt.to(fr.dtype)) ** 2).mean(),
                                   routes=routes_sh),
        "burgers_k5": rel_errs_vs_f64(refb_cell, xb_ref, 12,
                                      lambda fr: ((fr - tgtb.to(fr.dtype)) ** 2).mean(),
                                      cfg=cfgb, routes=routes_sh),
    }
    sharded_launches["grads_sharded"] = sharded_step2d.step_haloed_2d.launches
    check(sharded_launches["grads_sharded"] == 2 * len(rel_sh) * 4 * 12,
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
    # (2, 2, 2) mesh of cuda:0 at 48^3, golden cell, against rollout3d_kernel
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
          f"sharded 3D rollout vs rollout3d_kernel: max |diff| per step {per_step3.tolist()}")
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
    cell2d.fused_rollout_final_2d.launches = 0
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
    launches = {"rollout2d_kernel": cell2d.fused_rollout_2d.launches,
                "final2d_kernel": cell2d.fused_rollout_final_2d.launches}
    n = GS2D_RECON.grid
    for a in answers:
        check(tuple(a.shape) == (SERVE_STEPS + 1, n, n, 2), f"frames shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite frames")
    check(tuple(final.shape) == (n, n, 2) and bool(torch.isfinite(final).all()),
          "final state not finite or of the wrong shape")
    final_err = max_abs(final, answers[0][-1])
    check(allclose(final, answers[0][-1], rtol=1e-6, atol=1e-7),
          f"final-state request vs last frame: max |diff| {final_err}")
    check(launches == {"rollout2d_kernel": len(SEEDS) * SERVE_STEPS,
                       "final2d_kernel": SERVE_STEPS}, f"launch counts {launches}")
    phase("serve", requests=len(requests) + 1, steps=SERVE_STEPS, launches=launches,
          request_seconds=request_s, enqueue_seconds=enqueue_s,
          request_order="frames x 3, then final-state",
          warmup_request_seconds=dict(zip(("frames", "final_state"), warmup_s)),
          final_vs_last_frame_max_abs_err=final_err)

    # train: the main path of training, through the entry point a user calls
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    truth_cache2d = tempfile.mkdtemp(prefix="chip_smoke_truth2d_")   # train_ensemble reuses it
    try:
        cell2d.fused_rollout_2d.launches = 0
        backward2d.fused_rollout_tp_2d_pg.launches = 0
        with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
            res = runner.run_experiment(GS2D_RECON, device=dev, out_dir=out_dir,
                                        cache_dir=truth_cache2d,
                                        n_iters_override=TRAIN_ITERS,
                                        isg_pretrain_override=ISG_PRETRAIN_ITERS, seed=0)
        train_launches = {"rollout2d_kernel": cell2d.fused_rollout_2d.launches,
                          "pg2d_kernel": backward2d.fused_rollout_tp_2d_pg.launches}
        ckpt, meta = load_checkpoint_tree(os.path.join(out_dir, f"{GS2D_RECON.name}.ckpt.npz"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    stages = list(GS2D_RECON.curriculum) + [GS2D_RECON.train_steps]
    per_stage = TRAIN_ITERS // len(stages)
    want = {"pg2d_kernel": per_stage * sum(stages),
            "rollout2d_kernel": per_stage * sum(stages) + GS2D_RECON.infer_steps}
    hist = res["history"]
    check(len(hist) == TRAIN_ITERS and bool(np.isfinite(hist).all()), f"training losses {hist}")
    check(train_launches == want, f"training launch counts {train_launches}, expected {want}")
    check(bool(np.isfinite(res["rel_l2"])) and not res["diverged"],
          f"evaluation rel_l2 {res['rel_l2']}, diverged {res['diverged']}")
    check(meta.get("iteration") == per_stage and meta.get("stage") == len(stages) - 1
          and np.array_equal(ckpt["params"]["cell"]["diff"],
                             res["params"]["cell"]["diff"].cpu().numpy()),
          f"latest checkpoint meta {meta}")
    sec = res["seconds"]
    phase("train", experiment=GS2D_RECON.name, grid=GS2D_RECON.grid, launches=train_launches,
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
        cell3d.fused_rollout_3d.launches = 0
        backward3d.fused_rollout_tp_3d_pg.launches = 0
        with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
            res3 = runner.run_experiment(GS3D_RECON, device=dev, out_dir=out_dir, cache_dir=None,
                                         n_iters_override=TRAIN3D_ITERS,
                                         isg_pretrain_override=ISG_PRETRAIN_ITERS, seed=0)
        train3_launches = {"rollout3d_kernel": cell3d.fused_rollout_3d.launches,
                           "pg3d_kernel": backward3d.fused_rollout_tp_3d_pg.launches}
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
    ran3 = sum(n * steps for n, steps in zip(iters_run, stages3))
    want3 = {"pg3d_kernel": ran3,
             "rollout3d_kernel": ran3 + GS3D_RECON.infer_steps * (len(stages3) + len(scores3) + 1)}
    check(len(hist3) == TRAIN3D_ITERS and bool(np.isfinite(hist3).all()),
          f"GS3D training losses {hist3}")
    check(any(np.isfinite(v) for v in scores3.values()), f"GS3D probe scores {scores3}")
    check(bool(np.isfinite(res3["rel_l2"])), f"GS3D evaluation rel_l2 {res3['rel_l2']}")
    check(train3_launches == want3,
          f"GS3D training launch counts {train3_launches}, expected {want3}")
    sec3 = res3["seconds"]
    phase("train3d", experiment=GS3D_RECON.name, grid=GS3D_RECON.grid, launches=train3_launches,
          expected_launches=want3, iterations_run=iters_run, events=events3,
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
    cell3d.fused_rollout_3d.launches = 0
    request_s, enqueue_s = [], []
    answer3 = timed(serve3, request3)
    final3 = timed(serve3_final, request3)
    serve3_launches = {"rollout3d_kernel": cell3d.fused_rollout_3d.launches}
    check(tuple(answer3.shape) == (GS3D_RECON.infer_steps + 1, n3, n3, n3, 2)
          and bool(torch.isfinite(answer3).all()), "GS3D frames not finite or misshapen")
    check(tuple(final3.shape) == (n3, n3, n3, 2) and bool(torch.isfinite(final3).all()),
          "GS3D final state not finite or misshapen")
    final3_err = max_abs(final3, answer3[-1])
    check(allclose(final3, answer3[-1], rtol=1e-6, atol=1e-7),
          f"GS3D final-state request vs last frame: max |diff| {final3_err}")
    check(serve3_launches == {"rollout3d_kernel": 2 * GS3D_RECON.infer_steps},
          f"GS3D serving launch counts {serve3_launches}")
    phase("serve3d", requests=2, steps=GS3D_RECON.infer_steps, launches=serve3_launches,
          request_seconds=request_s, enqueue_seconds=enqueue_s,
          request_order="frames, then final-state",
          warmup_request_seconds=dict(zip(("frames", "final_state"), warmup3_s)),
          final_vs_last_frame_max_abs_err=final3_err)

    # serve_burgers: the golden Burgers model's frames (rollout2d_kxk_kernel)
    # and its final state (final2d_kernel at k = 5), through the entry point
    # a user calls
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
    cell2d.fused_rollout_kxk_2d.launches = 0
    cell2d.fused_rollout_final_2d.launches_kxk = 0
    request_s, enqueue_s = [], []
    answersb = [timed(serveb, req) for req in requestsb]
    finalb = timed(serveb_final, requestsb[0])
    serveb_launches = {"rollout2d_kxk_kernel": cell2d.fused_rollout_kxk_2d.launches,
                       "final2d_kernel[k=5]": cell2d.fused_rollout_final_2d.launches_kxk}
    for a in answersb:
        check(tuple(a.shape) == (BURGERS_STAGE1.infer_steps + 1, nb_grid, nb_grid, 2)
              and bool(torch.isfinite(a).all()), "Burgers frames not finite or misshapen")
    check(tuple(finalb.shape) == (nb_grid, nb_grid, 2) and bool(torch.isfinite(finalb).all()),
          "Burgers final state not finite or misshapen")
    # the frames come from the branch-matrix form and the final state from
    # the tap-by-tap form: held to each other at the forward bar
    finalb_err = max_abs(finalb, answersb[0][-1])
    check(allclose(finalb, answersb[0][-1], rtol=2e-4, atol=1e-5),
          f"Burgers final-state request vs last frame: max |diff| {finalb_err}")
    check(serveb_launches == {"rollout2d_kxk_kernel": len(SEEDS) * BURGERS_STAGE1.infer_steps,
                              "final2d_kernel[k=5]": BURGERS_STAGE1.infer_steps},
          f"Burgers serving launch counts {serveb_launches}")
    phase("serve_burgers", requests=len(requestsb) + 1, steps=BURGERS_STAGE1.infer_steps,
          launches=serveb_launches, request_seconds=request_s, enqueue_seconds=enqueue_s,
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
        cell2d.fused_rollout_kxk_2d.launches = 0
        backward2d.fused_rollout_tp_2d.launches = 0
        with contextlib.redirect_stdout(sys.stderr):   # the trainer's log echo
            resb = runner.run_experiment(BURGERS_STAGE1, device=dev, out_dir=out_dir,
                                         cache_dir=truth_cache,
                                         n_iters_override=TRAIN_BURGERS_ITERS,
                                         isg_pretrain_override=ISG_PRETRAIN_ITERS, seed=0)
        trainb_launches = {"rollout2d_kxk_kernel": cell2d.fused_rollout_kxk_2d.launches,
                           "adj2d_kxk_kernel": backward2d.fused_rollout_tp_2d.launches}
        best_tree, best_meta = load_checkpoint_tree(
            os.path.join(out_dir, f"{BURGERS_STAGE1.name}.ckpt.npz.best"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    stepsb = BURGERS_STAGE1.train_steps
    wantb = {"rollout2d_kxk_kernel": TRAIN_BURGERS_ITERS * stepsb + BURGERS_STAGE1.infer_steps,
             "adj2d_kxk_kernel": 2 * TRAIN_BURGERS_ITERS * stepsb}
    histb = resb["history"]
    check(len(histb) == TRAIN_BURGERS_ITERS and bool(np.isfinite(histb).all()),
          f"Burgers training losses {histb}")
    check(trainb_launches == wantb,
          f"Burgers training launch counts {trainb_launches}, expected {wantb}")
    check(bool(np.isfinite(resb["rel_l2"])) and not resb["diverged"],
          f"Burgers evaluation rel_l2 {resb['rel_l2']}, diverged {resb['diverged']}")
    # best_val: the evaluated params are the .best checkpoint's
    for (path, a), (_, b) in zip(flatten_with_paths(resb["params"]),
                                 flatten_with_paths(best_tree["params"])):
        check(np.array_equal(a.detach().cpu().numpy(), np.asarray(b)),
              f"Burgers evaluated params differ from the best-val checkpoint at {path}")
    secb = resb["seconds"]
    phase("train_burgers", experiment=BURGERS_STAGE1.name, grid=nb_grid,
          launches=trainb_launches, expected_launches=wantb,
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
    # MXU switches off (rollout2d_kernel at k = 5, adj2d_ys_kernel) on
    # train_burgers' cached truth; build_loss_fn(bptt="fused") and train for
    # GS2D at T = 800 (rollout2d_kernel, adj2d_kernel), GS3D at T = 300
    # (rollout3d_kernel, adj3d_kernel) and Burgers with YS_PATH_ENABLED off
    # too (rollout2d_kernel and adj2d_kernel at k = 5), from seeded random
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
    fallback_want = {"burgers_mxu_off": {
        "fused_rollout_2d.launches_kxk": TRAIN_BURGERS_ITERS * stepsb + BURGERS_STAGE1.infer_steps,
        "fused_phase1_ys_2d.launches": 2 * TRAIN_BURGERS_ITERS * stepsb}}
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
                {"fused_rollout_2d.launches": FALLBACK_ITERS * t2,
                 "fused_phase1_2d.launches": FALLBACK_ITERS * t2})
    train_fused("gs3d_fused", GS3D_RECON, answer3, t3, FALLBACK_ITERS, (True, True, True),
                {"fused_rollout_3d.launches": FALLBACK_ITERS * t3,
                 "fused_phase1_3d.launches": FALLBACK_ITERS * t3})
    train_fused("burgers_ys_off", BURGERS_STAGE1, answersb[0], stepsb, FALLBACK_YS_OFF_ITERS,
                (False, False, False),
                {"fused_rollout_2d.launches_kxk": FALLBACK_YS_OFF_ITERS * stepsb,
                 "fused_phase1_2d.launches": 2 * FALLBACK_YS_OFF_ITERS * stepsb})
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
    # rollout2d_kernel and pg2d_kernel), each with its members' evaluation
    # (rollout2d_kernel); then run_ensemble(BURGERS_STAGE1, 2) in "batched"
    # (rows 11-12 at k = 5; the evaluation by rollout2d_kxk_kernel).  The
    # truths come from the train and train_burgers phases' caches.
    per_ens = ENS_ITERS // len(stages)
    ens_steps = per_ens * sum(stages)
    ens_eval = ENS_MEMBERS * GS2D_RECON.infer_steps
    ens_want = {
        "batched_pg": {"fused_rollout_2d_batched.launches": ens_steps,
                       "fused_phase1_pg_2d_batched.launches": ens_steps,
                       "fused_rollout_2d.launches": ens_eval},
        "batched": {"fused_rollout_2d_batched.launches": ens_steps,
                    "fused_phase1_2d_batched.launches": ens_steps,
                    "fused_rollout_2d.launches": ens_eval},
        "auto": {"fused_rollout_2d.launches": ENS_MEMBERS * ens_steps + ens_eval,
                 "fused_rollout_tp_2d_pg.launches": ENS_MEMBERS * ens_steps},
        "burgers_batched": {
            "fused_rollout_2d_batched.launches_kxk": ENS_BURGERS_ITERS * stepsb,
            "fused_phase1_2d_batched.launches_kxk": 2 * ENS_BURGERS_ITERS * stepsb,
            "fused_rollout_kxk_2d.launches": ENS_KXK_MEMBERS * BURGERS_STAGE1.infer_steps},
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
        "single": {"fused_rollout_2d.launches": per_mesh * sum(stages) + GS2D_RECON.infer_steps,
                   "fused_rollout_tp_2d_pg.launches": per_mesh * sum(stages)},
        "mesh": {"fused_rollout_2d.launches": GS2D_RECON.infer_steps},
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

    def breakdown(exp, bprob, trained, stages, bwd_kernel, pg_name):
        """bwd_kernel(cell params) -> run(frames, cotangent): the backward
        kernel alone, its parameters packed beforehand."""
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

            iteration()   # warm-up, not counted
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
                "profiled": profile_busy(torch, iteration)})
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

    bprob = runner.setup_problem(GS2D_RECON, answers[0].cpu().numpy(), device=dev)
    phase("step_breakdown", reps=BREAKDOWN_REPS, statistic="median, after one warm-up",
          rows=breakdown(GS2D_RECON, bprob, res["params"], stages,
                         pg_kernel(backward2d._pg_cuda, cfg), "pg2d_kernel"), note=note)
    bprob3 = runner.setup_problem(GS3D_RECON, answer3.cpu().numpy(), device=dev)
    phase("step_breakdown3d", reps=BREAKDOWN_REPS, statistic="median, after one warm-up",
          rows=breakdown(GS3D_RECON, bprob3, res3["params"], stages3,
                         pg_kernel(backward3d._pg_cuda, cfg3), "pg3d_kernel"), note=note)
    del bprob3, answer3, final3
    bprobb = runner.setup_problem(BURGERS_STAGE1, answersb[0].cpu().numpy(), device=dev)
    phase("step_breakdown_kxk", reps=BREAKDOWN_REPS, statistic="median, after one warm-up",
          rows=breakdown(BURGERS_STAGE1, bprobb, resb["params"], [BURGERS_STAGE1.train_steps],
                         adj_kxk_kernel, "adj2d_kxk_kernel"), note=note)
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

        ens_iteration()   # warm-up, not counted
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
                           "device_span_ms": med[2], "profiled": prof,
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
    runs = {
        "rollout2d_kernel": (
            lambda: cell2d._rollout_cuda(packed, h0, cfg, SERVE_STEPS),
            lambda: cell2d.fused_rollout_2d_plain(packed, h0, cfg, SERVE_STEPS),
            param_bytes + state_bytes + (SERVE_STEPS + 1) * state_bytes,
            "cell2d._rollout_kernel", "percnn_tpu/ops/pallas/cell2d.py:332"),
        "final2d_kernel": (
            lambda: cell2d._final_cuda(packed, h0, cfg, SERVE_STEPS),
            lambda: cell2d.fused_rollout_final_2d_plain(packed, h0, cfg, SERVE_STEPS),
            param_bytes + 2 * state_bytes,
            "cell2d._final_kernel", "percnn_tpu/ops/pallas/cell2d.py:384"),
    }
    # rollout2d_kernel in the ensemble: the members' evaluations, and the
    # per-member loop of "auto"
    ens_row1 = {"rollout2d_kernel": sum(c.get("fused_rollout_2d.launches", 0)
                                        for c in ens_launches.values())}
    kernels = []
    for name, (kernel, plain, nbytes, jax_name, replaces) in runs.items():
        b_ms, b_by = bound_ms(nbytes, flops)
        kernels.append({
            "name": name, "jax_kernel": jax_name, "route": "cuda",
            "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
            "replaces": replaces,
            "launches": launches[name] + train_launches.get(name, 0) + ens_row1.get(name, 0),
            "launches_by_path": {"serve": launches[name],
                                 "train": train_launches.get(name, 0),
                                 "ensemble": ens_row1.get(name, 0)},
            "max_abs_err": err[name], "ms": cuda_ms(torch, kernel, reps=5),
            "plain_ms": cuda_ms(torch, plain, reps=1), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
    # the backward at the longest training stage: trained cell, data-loss cotangent
    frames = cell2d._rollout_cuda(packed, h0, cfg, TIME_BACKWARD_STEPS)
    fbar = cotangent(frames)[1].contiguous()
    bw_flops = TIME_BACKWARD_STEPS * cells * pg_flops_per_cell_step(cfg)
    bw_bytes = (param_bytes + 2 * TIME_BACKWARD_STEPS * state_bytes + state_bytes
                + 4 * lay["A"] * cells)
    b_ms, b_by = bound_ms(bw_bytes, bw_flops)
    kernels.append({
        "name": "pg2d_kernel", "jax_kernel": "backward2d._phase1_pg_kernel", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/backward2d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:902",
        "launches": train_launches["pg2d_kernel"]
        + ens_launches["auto"]["fused_rollout_tp_2d_pg.launches"],
        "launches_by_path": {"serve": 0, "train": train_launches["pg2d_kernel"],
                             "ensemble": ens_launches["auto"]["fused_rollout_tp_2d_pg.launches"]},
        "max_abs_err": err["pg2d_kernel"],
        "ms": cuda_ms(torch, lambda: backward2d._pg_cuda(packed, frames, fbar, cfg), reps=5),
        "plain_ms": cuda_ms(torch, lambda: backward2d.fused_phase1_pg_2d_plain(
            packed, frames, fbar, cfg), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    # GS3D at 48^3: a rollout over the inference horizon, frames and final
    # state, and the backward at the longest training stage; golden cell,
    # data-loss cotangent
    steps3 = GS3D_RECON.infer_steps
    cells3, state3_bytes = n3 ** 3, 8 * n3 ** 3
    flops3 = steps3 * cells3 * flops_per_cell_step_3d()
    coef_bytes = 4 * expanded3.numel()
    b_ms, b_by = bound_ms(coef_bytes + state3_bytes + (steps3 + 1) * state3_bytes, flops3)
    bf_ms, bf_by = bound_ms(coef_bytes + 2 * state3_bytes, flops3)
    by_path3 = {"serve": serve3_launches["rollout3d_kernel"],
                "train": train3_launches["rollout3d_kernel"]}
    # the two forms in turns (frames, final, final, frames), before the
    # plain versions load the host
    turns = [cuda_ms(torch, lambda: cell3d._rollout_cuda(expanded3, h03, steps3,
                                                         final_only=final_only), reps=5)
             for final_only in (False, True, True, False)]
    kernels.append({
        "name": "rollout3d_kernel", "jax_kernel": "cell3d._rollout3d_kernel", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/cell3d.cu",
        "replaces": "percnn_tpu/ops/pallas/cell3d.py:225",
        "launches": sum(by_path3.values()), "launches_by_path": by_path3,
        "max_abs_err": err["rollout3d_kernel"], "ms": (turns[0] + turns[3]) / 2,
        "ms_turns": {"frames": [turns[0], turns[3]], "final_only": [turns[1], turns[2]]},
        "plain_ms": cuda_ms(torch, lambda: cell3d.fused_rollout_3d_plain(
            expanded3, h03, steps3), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "final_only": {
            "ms": (turns[1] + turns[2]) / 2,
            "plain_ms": cuda_ms(torch, lambda: cell3d.fused_rollout_3d_plain(
                expanded3, h03, steps3, final_only=True), reps=1),
            "bound_ms": bf_ms, "bound_by": bf_by},
    })
    frames3 = cell3d._rollout_cuda(expanded3, h03, TIME_BACKWARD3D_STEPS)
    fbar3 = cotangent(frames3, GS3D_RECON)[1].contiguous()
    bw3_flops = TIME_BACKWARD3D_STEPS * cells3 * pg_flops_per_cell_step(cfg3)
    bw3_bytes = (4 * packed3.numel() + 2 * TIME_BACKWARD3D_STEPS * state3_bytes + state3_bytes
                 + 4 * lay3["A"] * cells3)
    b_ms, b_by = bound_ms(bw3_bytes, bw3_flops)
    kernels.append({
        "name": "pg3d_kernel", "jax_kernel": "backward3d._phase1_pg_kernel3d", "route": "cuda",
        "source": "percnn_tpu_torch/ops/kernels/csrc/backward3d.cu",
        "replaces": "percnn_tpu/ops/pallas/backward3d.py:227",
        "launches": train3_launches["pg3d_kernel"],
        "launches_by_path": {"serve": 0, "train": train3_launches["pg3d_kernel"]},
        "max_abs_err": err["pg3d_kernel"],
        "ms": cuda_ms(torch, lambda: backward3d._pg_cuda(packed3, frames3, fbar3, cfg3), reps=5),
        "plain_ms": cuda_ms(torch, lambda: backward3d.fused_phase1_pg_3d_plain(
            packed3, frames3, fbar3, cfg3), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    # Burgers at 100 x 100, golden cell: the forward and the backward at the
    # training T = 200 (data-loss cotangent), and the forward over the
    # 1200-step serving and evaluation horizon
    cellsb, stateb_bytes = nb_grid ** 2, 8 * nb_grid ** 2
    mat_bytes = 4 * (wmatb.numel() + tailb.numel())
    fwdb_flops = stepsb * cellsb * flops_per_cell_step_kxk(cfgb)
    b_ms, b_by = bound_ms(mat_bytes + stateb_bytes + (stepsb + 1) * stateb_bytes, fwdb_flops)
    horizon = BURGERS_STAGE1.infer_steps
    hb_ms, hb_by = bound_ms(mat_bytes + stateb_bytes + (horizon + 1) * stateb_bytes,
                            horizon * cellsb * flops_per_cell_step_kxk(cfgb))
    by_pathb = {"serve": serveb_launches["rollout2d_kxk_kernel"],
                "train": trainb_launches["rollout2d_kxk_kernel"],
                "ensemble": ens_launches["burgers_batched"]["fused_rollout_kxk_2d.launches"]}
    kernels.append({
        "name": "rollout2d_kxk_kernel", "jax_kernel": "cell2d._rollout_kernel_mxu",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d_kxk.cu",
        "replaces": "percnn_tpu/ops/pallas/cell2d.py:193",
        "launches": sum(by_pathb.values()), "launches_by_path": by_pathb,
        "max_abs_err": err["rollout2d_kxk_kernel"], "steps": stepsb,
        "ms": cuda_ms(torch, lambda: cell2d._rollout_kxk_cuda(wmatb, tailb, h0b, cfgb, stepsb),
                      reps=5),
        "plain_ms": cuda_ms(torch, lambda: cell2d.fused_rollout_kxk_2d_plain(
            wmatb, tailb, h0b, cfgb, stepsb), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "horizon": {
            "steps": horizon,
            "ms": cuda_ms(torch, lambda: cell2d._rollout_kxk_cuda(wmatb, tailb, h0b, cfgb,
                                                                  horizon), reps=3),
            "bound_ms": hb_ms, "bound_by": hb_by},
    })
    framesb = cell2d._rollout_kxk_cuda(wmatb, tailb, h0b, cfgb, stepsb)
    fbarb = cotangent(framesb, BURGERS_STAGE1)[1].contiguous()
    bwb_flops = stepsb * cellsb * adj_flops_per_cell_step_kxk(cfgb)
    bwb_bytes = (mat_bytes + 2 * stepsb * stateb_bytes + stepsb * stateb_bytes + stateb_bytes
                 + 4 * stepsb * cell2d.mxu_rows(cfgb) * cellsb)
    b_ms, b_by = bound_ms(bwb_bytes, bwb_flops)
    kernels.append({
        "name": "adj2d_kxk_kernel", "jax_kernel": "backward2d._phase1_mxu_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/backward2d_kxk.cu",
        "replaces": "percnn_tpu/ops/pallas/backward2d.py:370",
        "launches": trainb_launches["adj2d_kxk_kernel"],
        "launches_by_path": {"serve": 0, "train": trainb_launches["adj2d_kxk_kernel"]},
        "max_abs_err": err["adj2d_kxk_kernel"], "steps": stepsb,
        "ms": cuda_ms(torch, lambda: backward2d._phase1_kxk_cuda(wmatb, tailb, framesb, fbarb,
                                                                 cfgb), reps=5),
        "plain_ms": cuda_ms(torch, lambda: backward2d.fused_phase1_kxk_2d_plain(
            wmatb, tailb, framesb, fbarb, cfgb), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })
    # the fallback slice at its main paths' shapes: rollout2d_kernel and
    # final2d_kernel at k = 5 (golden Burgers cell; T = 200 frames from the
    # Burgers IC as row 3, the final state over the 1200-step serving horizon
    # from the ISG's answer to a request),
    # adj2d_kernel at k = 1 (the GS2D backward above: T = 800, data-loss
    # cotangent), adj2d_kernel at k = 5 and adj2d_ys_kernel (the Burgers
    # backward above: T = 200), adj3d_kernel (the GS3D backward above: 48^3,
    # T = 300); each sweep reads the T step inputs and cotangents and writes
    # the T g_ins and g0, adj2d_ys_kernel reads the [T, 96, H, W] activations
    # (made outside the timing, as _precompute_ys makes them) instead of the
    # frames
    packedb_bytes = 4 * packedb.numel()
    ysb = backward2d._precompute_ys(paramsb["cell"], framesb[:-1], cfgb)
    taps_rows = 2 * cfgb.kernel_size ** 2 * 2 * cell2d.mxu_rows(cfgb)
    fallback_rows = {
        "rollout2d_kernel[k=5]": (
            lambda: cell2d._rollout_cuda(packedb, h0b, cfgb, stepsb),
            lambda: cell2d.fused_rollout_2d_plain(packedb, h0b, cfgb, stepsb),
            packedb_bytes + stateb_bytes + (stepsb + 1) * stateb_bytes, fwdb_flops, stepsb,
            "cell2d._rollout_kernel", "percnn_tpu/ops/pallas/cell2d.py:332", "cell2d.cu",
            {"train": fallback_launches["burgers_mxu_off"]["fused_rollout_2d.launches_kxk"]
             + fallback_launches["burgers_ys_off"]["fused_rollout_2d.launches_kxk"]}),
        "final2d_kernel[k=5]": (
            lambda: cell2d._final_cuda(packedb, h0s, cfgb, horizon),
            lambda: cell2d.fused_rollout_final_2d_plain(packedb, h0s, cfgb, horizon),
            packedb_bytes + 2 * stateb_bytes, horizon * cellsb * flops_per_cell_step_kxk(cfgb),
            horizon, "cell2d._final_kernel", "percnn_tpu/ops/pallas/cell2d.py:384", "cell2d.cu",
            {"serve": serveb_launches["final2d_kernel[k=5]"]}),
        "adj2d_kernel": (
            lambda: backward2d._phase1_cuda(packed, frames, fbar, cfg),
            lambda: backward2d.fused_phase1_2d_plain(packed, frames, fbar, cfg),
            param_bytes + 3 * TIME_BACKWARD_STEPS * state_bytes + state_bytes,
            TIME_BACKWARD_STEPS * cells * adj_flops_per_cell_step_1x1(cfg), TIME_BACKWARD_STEPS,
            "backward2d._phase1_kernel", "percnn_tpu/ops/pallas/backward2d.py:184", "adj2d.cu",
            {"train": fallback_launches["gs2d_fused"]["fused_phase1_2d.launches"]}),
        "adj2d_kernel[k=5]": (
            lambda: backward2d._phase1_cuda(packedb, framesb, fbarb, cfgb),
            lambda: backward2d.fused_phase1_2d_plain(packedb, framesb, fbarb, cfgb),
            packedb_bytes + 3 * stepsb * stateb_bytes + stateb_bytes, bwb_flops, stepsb,
            "backward2d._phase1_kernel", "percnn_tpu/ops/pallas/backward2d.py:184", "adj2d.cu",
            {"train": fallback_launches["burgers_ys_off"]["fused_phase1_2d.launches"]}),
        "adj2d_ys_kernel": (
            lambda: backward2d._phase1_ys_cuda(packedb, fbarb, ysb, cfgb),
            lambda: backward2d.fused_phase1_ys_2d_plain(packedb, fbarb, ysb, cfgb),
            packedb_bytes + 2 * stepsb * stateb_bytes + stateb_bytes + 4 * ysb.numel(),
            bwb_flops - stepsb * cellsb * taps_rows, stepsb,
            "backward2d._phase1_ys_kernel", "percnn_tpu/ops/pallas/backward2d.py:260",
            "adj2d.cu",
            {"train": fallback_launches["burgers_mxu_off"]["fused_phase1_ys_2d.launches"]}),
        "adj3d_kernel": (
            lambda: backward3d._phase1_cuda(packed3, frames3, fbar3, cfg3),
            lambda: backward3d.fused_phase1_3d_plain(packed3, frames3, fbar3, cfg3),
            4 * packed3.numel() + 3 * TIME_BACKWARD3D_STEPS * state3_bytes + state3_bytes,
            TIME_BACKWARD3D_STEPS * cells3 * adj_flops_per_cell_step_1x1(cfg3),
            TIME_BACKWARD3D_STEPS,
            "backward3d._phase1_kernel3d", "percnn_tpu/ops/pallas/backward3d.py:60",
            "backward3d.cu",
            {"train": fallback_launches["gs3d_fused"]["fused_phase1_3d.launches"]}),
    }
    fallback_work = {}
    for name, (kernel, plain, nbytes, nflops, steps, jax_name, replaces, source,
               by_path) in fallback_rows.items():
        b_ms, b_by = bound_ms(nbytes, nflops)
        fallback_work[name] = {"steps": steps, "bytes": nbytes, "flops": nflops}
        kernels.append({
            "name": name, "jax_kernel": jax_name, "route": "cuda",
            "source": f"percnn_tpu_torch/ops/kernels/csrc/{source}", "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err[name], "steps": steps,
            "ms": cuda_ms(torch, kernel, reps=3 if steps > 1000 else 5),
            "plain_ms": cuda_ms(torch, plain, reps=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    del ysb
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
    pg_bytes = param_bytes + 2 * t8 * state_bytes + state_bytes + 4 * lay["A"] * cells
    batched_rows = {
        "rollout2d_batched_kernel": (
            lambda: batched2d._rollout_b_cuda(packed4, h04, cfg, t8),
            lambda: batched2d.fused_rollout_2d_batched_plain(packed4, h04, cfg, t8),
            m4 * (param_bytes + state_bytes + (t8 + 1) * state_bytes),
            m4 * t8 * cells * flops_per_cell_step(cfg), t8, m4,
            "batched2d._rollout_kernel_b", ":63",
            ens_launches["batched_pg"]["fused_rollout_2d_batched.launches"]
            + ens_launches["batched"]["fused_rollout_2d_batched.launches"]),
        "adj2d_batched_kernel": (
            lambda: batched2d._phase1_b_cuda(packed4, frames4, fbar4, cfg),
            lambda: batched2d.fused_phase1_2d_batched_plain(packed4, frames4, fbar4, cfg),
            m4 * (param_bytes + 3 * t8 * state_bytes + state_bytes),
            m4 * t8 * cells * adj_flops_per_cell_step_1x1(cfg), t8, m4,
            "batched2d._phase1_kernel_b", ":117",
            ens_launches["batched"]["fused_phase1_2d_batched.launches"]),
        "pg2d_batched_kernel": (
            lambda: batched2d._pg_b_cuda(packed4, frames4, fbar4, cfg),
            lambda: batched2d.fused_phase1_pg_2d_batched_plain(packed4, frames4, fbar4, cfg),
            m4 * pg_bytes, m4 * t8 * cells * pg_flops_per_cell_step(cfg), t8, m4,
            "batched2d._phase1_pg_kernel_b", ":272",
            ens_launches["batched_pg"]["fused_phase1_pg_2d_batched.launches"]),
        "rollout2d_batched_kernel[k=5]": (
            lambda: batched2d._rollout_b_cuda(packed2, h02, cfgb, stepsb),
            lambda: batched2d.fused_rollout_2d_batched_plain(packed2, h02, cfgb, stepsb),
            m2 * (packedb_bytes + stateb_bytes + (stepsb + 1) * stateb_bytes), m2 * fwdb_flops,
            stepsb, m2, "batched2d._rollout_kernel_b", ":63",
            ens_launches["burgers_batched"]["fused_rollout_2d_batched.launches_kxk"]),
        "adj2d_batched_kernel[k=5]": (
            lambda: batched2d._phase1_b_cuda(packed2, frames2, fbar2, cfgb),
            lambda: batched2d.fused_phase1_2d_batched_plain(packed2, frames2, fbar2, cfgb),
            m2 * (packedb_bytes + 3 * stepsb * stateb_bytes + stateb_bytes), m2 * bwb_flops,
            stepsb, m2, "batched2d._phase1_kernel_b", ":117",
            ens_launches["burgers_batched"]["fused_phase1_2d_batched.launches_kxk"]),
    }
    batched_work = {}
    for name, (kernel, plain, nbytes, nflops, steps, n_mem, jax_name, line,
               n_launches) in batched_rows.items():
        b_ms, b_by = bound_ms(nbytes, nflops)
        batched_work[name] = {"members": n_mem, "steps": steps, "bytes": nbytes, "flops": nflops}
        kernels.append({
            "name": name, "jax_kernel": jax_name, "route": "cuda",
            "source": "percnn_tpu_torch/ops/kernels/csrc/batched2d.cu",
            "replaces": f"percnn_tpu/ops/pallas/batched2d.py{line}",
            "launches": n_launches, "launches_by_path": {"ensemble": n_launches},
            "max_abs_err": err[name], "members": n_mem, "steps": steps,
            "ms": cuda_ms(torch, kernel, reps=5), "plain_ms": cuda_ms(torch, plain, reps=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    del frames4, fbar4, frames2, fbar2
    # pg2d_batched_kernel at M = 8
    m8 = 2 * ENS_MEMBERS
    packed8 = batched2d.pack_pi_params_2d_batched(member_cells(model["cell"], m8),
                                                  cfg).contiguous()
    frames8 = batched2d._rollout_b_cuda(packed8, member_ics(GS2D_RECON.system, GS2D_RECON.grid,
                                                            m8), cfg, t8)
    fbar8 = torch.randn(frames8.shape, generator=gen, device=dev)
    b_ms, b_by = bound_ms(m8 * pg_bytes, m8 * t8 * cells * pg_flops_per_cell_step(cfg))
    next(k for k in kernels if k["name"] == "pg2d_batched_kernel")["m8"] = {"members": m8, "steps": t8, "bound_ms": b_ms, "bound_by": b_by,
                         "ms": cuda_ms(torch, lambda: batched2d._pg_b_cuda(packed8, frames8,
                                                                           fbar8, cfg), reps=3)}
    del frames8, fbar8
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
    # 2 x 2 mesh (impl="pallas", four 50 x 50 blocks, 4 launches a step) by
    # CUDA events, beside the same rollout with the plain version in the
    # kernel's place, one launch alone, and a profiler trace of the rollout
    # for the kernel's device time and the time outside it (the exchange:
    # slices, copies and cats, and the host's enqueue); the bound is the
    # kernel's work, per step 4 haloed 54^2 blocks in and 4 50^2 out
    def sharded_plain(pk, x0, cfg_, steps):
        grid = mesh_blocks(x0)
        for _ in range(steps):
            grid = object_grid((2, 2), [sharded_step2d.step_haloed_2d_plain(pk, b.contiguous(), cfg_)
                                        for b in haloed(grid).flat])
        return grid

    blk = GS2D_RECON.grid // 2
    b14_ms, b14_by = bound_ms(
        CHECK_STEPS * 4 * (param_bytes + 8 * (blk + 4) ** 2 + 8 * blk ** 2),
        CHECK_STEPS * 4 * blk ** 2 * flops_per_cell_step(cfg))
    with torch.no_grad():
        sharded_fn = lambda: sharded_rollout_nd(params["cell"], h0, cfg, CHECK_STEPS, mesh,
                                                impl="pallas")
        row14_ms = cuda_ms(torch, sharded_fn, reps=3)
        row14_trace = profile_busy(torch, sharded_fn)
    xb14 = haloed(mesh_blocks(h0))[0, 0].contiguous()
    kernel14_ms = row14_trace["kernel_ms"]["step2d_haloed_kernel"]
    kernels.append({
        "name": "step2d_haloed_kernel", "jax_kernel": "sharded_step2d._step_kernel",
        "route": "cuda", "source": "percnn_tpu_torch/ops/kernels/csrc/sharded_step2d.cu",
        "replaces": "percnn_tpu/ops/pallas/sharded_step2d.py:37",
        "launches": sum(sharded_launches.values()), "launches_by_path": sharded_launches,
        "max_abs_err": err["step2d_haloed_kernel"], "steps": CHECK_STEPS, "blocks": 4,
        "ms": row14_ms,
        "plain_ms": cuda_ms(torch, lambda: sharded_plain(packed, h0, cfg, CHECK_STEPS), reps=1),
        "bound_ms": b14_ms, "bound_by": b14_by, "library_ms": None,
        "one_launch_ms": cuda_ms(torch, lambda: sharded_step2d._step_cuda(packed, xb14, cfg),
                                 reps=200),
        "trace": {"window_ms": row14_trace["window_ms"],
                  "device_busy_ms": row14_trace["device_busy_ms"],
                  "kernel_ms": kernel14_ms,
                  "kernel_us_per_launch": row14_trace["kernel_us_per_launch"][
                      "step2d_haloed_kernel"],
                  "outside_kernel_share": 1.0 - kernel14_ms / row14_trace["window_ms"],
                  "device_idle_share": row14_trace["device_idle_share"]},
    })
    phase("times", shape=list(h0.shape), steps=SERVE_STEPS, flops_per_rollout=flops,
          backward_steps=TIME_BACKWARD_STEPS, flops_per_backward=bw_flops,
          bytes_per_backward=bw_bytes, shape3d=list(h03.shape), steps3d=steps3,
          flops_per_rollout3d=flops3, backward_steps3d=TIME_BACKWARD3D_STEPS,
          flops_per_backward3d=bw3_flops, bytes_per_backward3d=bw3_bytes,
          burgers_shape=list(h0b.shape), burgers_steps=stepsb, flops_per_rollout_kxk=fwdb_flops,
          flops_per_backward_kxk=bwb_flops, bytes_per_backward_kxk=bwb_bytes,
          fallback_work=fallback_work, batched_work=batched_work,
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
