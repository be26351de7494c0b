"""Experiment runner: composes data, model, losses and trainer per config.

Counterpart of percnn_tpu/experiments/runner.py for the data-driven
paths (GS2D, GS3D, and the 5x5-Pi Stage-1 reconstructions of Burgers and
lambda-omega): truth (RK4 on the device), noise, ISG pretrain, the
curriculum of training stages with the stability probe, the selection of
a stable candidate, and the evaluation rollout scored by rel-L2; and
``run_experiment_with_restarts`` around it.  ``inference_rollout`` takes
the request (the low-res IC, or the full-res IC when the model has no ISG)
directly, instead of a truth-carrying Problem.

``run_experiment(mesh=...)`` trains on a spatially decomposed field
(``make_mesh_rollout_fn``: parallel.sharded_rollout_nd, a halo exchange
a step).

Not ported yet: the GSPMD mesh route (``parallel_impl="gspmd"``), a shared
ISG pretrain file, the visual exports and the closed-form Pi expressions
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
import zipfile

import numpy as np
import torch

from percnn_tpu_torch._device import full_f32, resolve_device
from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import init_pi_cell, pi_cell_step
from percnn_tpu_torch.core.checkpoint import (
    flatten_with_paths,
    load_checkpoint_tree,
    peek_meta,
)
from percnn_tpu_torch.core.isg import init_isg, isg_apply
from percnn_tpu_torch.core.losses import DataLossConfig, data_loss, ic_loss, phys_loss
from percnn_tpu_torch.core.rollout import rollout, rollout_tp
from percnn_tpu_torch.core.train import pretrain_isg, train
from percnn_tpu_torch.data.noise import add_noise
from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.experiments.configs import ExperimentConfig
from percnn_tpu_torch.ops.kernels.backward2d import fused_rollout_tp_2d, fused_rollout_tp_2d_pg
from percnn_tpu_torch.ops.kernels.backward3d import fused_rollout_tp_3d, fused_rollout_tp_3d_pg
from percnn_tpu_torch.ops.kernels.cell2d import fused_rollout_2d
from percnn_tpu_torch.ops.kernels.cell3d import fused_rollout_3d
from percnn_tpu_torch.parallel import sharded_rollout_nd
from percnn_tpu_torch.parallel.mesh import canonical_device
from percnn_tpu_torch.pde.systems import PDE_SYSTEMS
from percnn_tpu_torch.utils.metrics import MetricsLogger, rel_l2


def make_dataset(exp: ExperimentConfig, *, n_frames: int | None = None,
                 warmup: int = 0, oversample: int = 4, cache_dir: str | None = None,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Ground-truth rollout [T+1, *spatial, 2] f64 for the experiment's system.

    The cache file has the JAX package's name and ``truth`` key, so both
    packages share a cache directory.  warmup: initial steps discarded.
    """
    dev = resolve_device(device)
    n = exp.grid
    n_frames = n_frames if n_frames is not None else max(exp.train_steps, exp.infer_steps)
    cache = None
    if cache_dir:
        cache = os.path.join(
            cache_dir,
            f"{exp.system}_{n}_{n_frames}_{warmup}_{oversample}"
            f"_dt{exp.dt}_dx{round(exp.dx, 8)}_s{exp.seed}_v2.npz",
        )
        if os.path.exists(cache):
            try:
                with np.load(cache) as z:
                    return z["truth"]
            except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
                # a half-written cache (process killed mid-save): rebuild
                os.remove(cache)
    h0 = default_ic(exp.system, n, seed=exp.seed)
    if warmup:
        h0 = simulate(exp.system, h0, warmup, exp.dt, exp.dx, oversample=oversample,
                      device=dev)[-1]
    truth = simulate(exp.system, h0, n_frames, exp.dt, exp.dx, oversample=oversample,
                     device=dev)
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache + f".tmp{os.getpid()}.npz"  # .npz: savez won't re-suffix
        np.savez_compressed(tmp, truth=truth)
        os.replace(tmp, cache)  # atomic: readers never see a partial file
    return truth


@dataclasses.dataclass
class Problem:
    """Everything the loss needs, on the device."""

    exp: ExperimentConfig
    truth: np.ndarray                   # [T+1, *spatial, 2] clean (for eval)
    h0: torch.Tensor | None             # full-res IC (no ISG) or None
    ic_low: torch.Tensor | None         # low-res noisy IC [1, *low, 2] or None
    measurement: torch.Tensor | None    # subsampled noisy truth or None


def setup_problem(exp: ExperimentConfig, truth: np.ndarray, dtype=torch.float32, *,
                  device: str | torch.device = "cuda") -> Problem:
    dev = resolve_device(device)
    noisy = add_noise(truth, exp.noise_pct, seed=exp.seed)
    nd = exp.cell.ndim

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    if exp.isg is None:
        return Problem(exp, truth, put(truth[0]), None, None)
    down = (slice(None, None, exp.isg.scale),) * nd
    ic_low = put(noisy[0][down])[None]
    meas = None
    if exp.data is not None:
        t_sl = slice(0, -1 if exp.data.drop_last_frame else None, exp.data.time_stride)
        idx = (t_sl,) + (slice(None, None, exp.data.space_stride),) * nd
        meas = put(noisy[: exp.train_steps + 1][idx])
    return Problem(exp, truth, None, ic_low, meas)


def init_model(exp: ExperimentConfig, gen: torch.Generator, dtype=torch.float32,
               *, device: str | torch.device = "cuda") -> dict:
    """Random model parameters {'cell', 'isg'} drawn from `gen` (CPU)."""
    dev = resolve_device(device)
    params = {"cell": init_pi_cell(gen, exp.cell, dtype, device=dev)}
    if exp.isg is not None:
        params["isg"] = init_isg(gen, exp.isg, dtype, device=dev)
    return params


def forward_rollout(params: dict, prob: Problem, n_steps: int, *, remat: bool = True,
                    bptt: str = "auto", ic_low=None, h0=None,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """ISG (if present) then rollout on `device`, where the params live;
    returns frames [n_steps+1, *spatial, 2].  ic_low/h0 override the
    Problem's.

    bptt:
      'auto'     -- for a two-channel cell with a float32 state (kernels on
                    the card, their plain versions on the CPU): 'fused_pg'
                    for a kernel_size-1 cell, 2D or 3D with three branches;
                    'fused' for a 2D cell with odd kernel_size 3 or 5; else
                    'remat';
      'fused_pg' -- rollout2d_kernel forward, pg2d_kernel backward
                    (ops/kernels/backward2d.py) in 2D; rollout3d_kernel
                    forward, pg3d_kernel backward (ops/kernels/backward3d.py)
                    in 3D;
      'fused'    -- the streaming adjoints: a 2D cell (any odd kernel_size
                    <= 5) through backward2d.fused_rollout_tp_2d, whose
                    routes the MXU switches and the activation budget pick
                    (rollout2d_kxk_kernel or rollout2d_kernel forward;
                    adj2d_kxk_kernel, adj2d_ys_kernel or adj2d_kernel
                    backward); a 3D cell through
                    backward3d.fused_rollout_tp_3d (rollout3d_kernel,
                    adj3d_kernel); the parameter gradients outside the
                    kernels;
      'two_phase' -- core.rollout.rollout_tp around the cell step: a reverse
                    sweep of autograd through the state, then the parameter
                    gradients batched over time;
      'remat'    -- autograd through the cell step, checkpointed segments.
    """
    dev = resolve_device(device)
    exp = prob.exp
    if exp.isg is not None:
        ic_low = prob.ic_low if ic_low is None else ic_low
        h0 = isg_apply(params["isg"], ic_low.to(dev), exp.isg)[0]
    else:
        h0 = (prob.h0 if h0 is None else h0).to(dev)
    cell = exp.cell
    if bptt == "auto":
        k = cell.kernel_size
        pg_ok = k == 1 and (cell.ndim == 2 or (cell.ndim == 3 and cell.n_branches == 3))
        fused_ok = cell.ndim == 2 and k in (3, 5)
        f32 = cell.channels == 2 and h0.dtype == torch.float32
        bptt = ("fused_pg" if f32 and pg_ok else "fused" if f32 and fused_ok else "remat")
    if bptt == "fused_pg":
        fused = fused_rollout_tp_2d_pg if cell.ndim == 2 else fused_rollout_tp_3d_pg
        return fused(params["cell"], h0, cell, n_steps)
    if bptt == "fused":
        fused = fused_rollout_tp_2d if cell.ndim == 2 else fused_rollout_tp_3d
        return fused(params["cell"], h0, cell, n_steps)
    if bptt == "two_phase":
        return rollout_tp(_cell_step_for(cell), params["cell"], h0, n_steps)
    if bptt != "remat":
        raise ValueError(f"unknown bptt {bptt!r}")
    return rollout(lambda h: pi_cell_step(params["cell"], h, cell), h0, n_steps, remat=remat)


@functools.lru_cache(maxsize=None)
def _cell_step_for(cell_cfg):
    """The step closure (params, h) -> h_next of a cell config, one per
    config, as percnn_tpu keeps it."""
    return lambda p, h: pi_cell_step(p, h, cell_cfg)


def make_mesh_rollout_fn(prob: Problem, n_steps: int, mesh, *, impl: str = "halo"):
    """The rollout of ``build_loss_fn`` on a spatially decomposed field:
    rollout_fn(params) -> frames [n_steps + 1, *spatial, 2] on the mesh's
    first device.

    impl:
      'halo'  -- explicit domain decomposition: parallel.sharded_rollout_nd
                 over the mesh's first ndim axes, a 2-cell halo exchange a
                 step, the eager valid-region step on each block (its
                 default impl, as percnn_tpu's runner keeps); autograd
                 crosses the exchange;
      'gspmd' -- not ported (ROADMAP.md A10): PyTorch has no GSPMD; its
                 counterpart is DTensor over a process group.
    """
    exp = prob.exp
    nd = exp.cell.ndim
    axis_names = tuple(mesh.axis_names)[:nd]
    if len(axis_names) != nd:
        raise ValueError(
            f"mesh {tuple(mesh.axis_names)} has fewer axes than the "
            f"{nd}D experiment {exp.name!r}")
    spatial = prob.truth.shape[1:1 + nd]
    for n, a in zip(spatial, axis_names):
        if n % mesh.shape[a]:
            raise ValueError(
                f"grid axis {a}={n} not divisible by mesh axis "
                f"{a}={mesh.shape[a]} for experiment {exp.name!r}")
    if impl == "gspmd":
        raise NotImplementedError("parallel_impl='gspmd' is not ported: PyTorch has no "
                                  "GSPMD; DTensor over a process group is its "
                                  "counterpart (ROADMAP.md A10)")
    if impl != "halo":
        raise ValueError(f"unknown parallel impl {impl!r} (expected 'halo' or 'gspmd')")

    def rollout_fn(params):
        if exp.isg is not None:
            h0 = isg_apply(params["isg"], prob.ic_low, exp.isg)[0]
        else:
            h0 = prob.h0
        return sharded_rollout_nd(params["cell"], h0, exp.cell, n_steps, mesh,
                                  axis_names=axis_names)

    return rollout_fn


def _n_meas(n_frames: int, dcfg: DataLossConfig) -> int:
    return len(range(n_frames)[slice(0, -1 if dcfg.drop_last_frame else None,
                                     dcfg.time_stride)])


def build_loss_fn(prob: Problem, n_steps: int, *, bptt: str = "auto", rollout_fn=None):
    """Composite loss per the experiment's weights; aux carries every
    component plus 'val' (holdout data MSE) and 'phy' (residual metric).

    loss_fn(params) -> (total, aux).  rollout_fn(params) -> frames
    overrides forward_rollout.  When 'phy' has no weight it is a metric
    only, computed without autograd.
    """
    exp = prob.exp
    w = exp.loss_weights
    system = PDE_SYSTEMS[exp.system]
    nd = exp.cell.ndim
    dev = (prob.ic_low if prob.ic_low is not None else prob.h0).device
    if "data" in w and prob.measurement is None:
        raise ValueError(
            f"experiment {exp.name!r} weights the data loss but the problem "
            "has no measurement (no data config / ISG-free setup)")

    def loss_fn(params):
        frames = (rollout_fn(params) if rollout_fn is not None
                  else forward_rollout(params, prob, n_steps, bptt=bptt, device=dev))
        total = torch.zeros((), dtype=frames.dtype, device=frames.device)
        aux = {}
        if prob.measurement is not None:
            # the measurement covers train_steps+1 frames; a curriculum
            # stage's rollout is shorter
            meas = prob.measurement[: _n_meas(frames.shape[0], exp.data)]
            tr, va = data_loss(frames, meas, exp.data, nd)
            aux["data"] = tr
            aux["val"] = va
            if "data" in w:
                total = total + w["data"] * tr
        if exp.isg is not None:
            out = isg_apply(params["isg"], prob.ic_low, exp.isg)
            icl = ic_loss(out, prob.ic_low, nd, exp.interp_method,
                          align_corners=exp.interp_align_corners,
                          periodic_extend=exp.interp_periodic_extend)
            aux["ic"] = icl
            if "ic" in w:
                total = total + w["ic"] * icl
        if "phy" in w:
            pl = phys_loss(system, frames, exp.dt, exp.dx)
            total = total + w["phy"] * pl
            aux.setdefault("val", pl)
        else:
            with torch.no_grad():
                pl = phys_loss(system, frames.detach(), exp.dt, exp.dx)
        aux["phy"] = pl
        return total, aux

    return loss_fn


def build_isg_pretrain_loss(prob: Problem):
    exp = prob.exp

    def loss_fn(isg_params):
        out = isg_apply(isg_params, prob.ic_low, exp.isg)
        return ic_loss(out, prob.ic_low, exp.cell.ndim, exp.interp_method,
                       align_corners=exp.interp_align_corners,
                       periodic_extend=exp.interp_periodic_extend)

    return loss_fn


def inference_rollout(params: dict, exp: ExperimentConfig, x, n_steps: int, *,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """ISG (if the model has one), then the fused rollout (2D or 3D):
    [n_steps+1, *spatial, 2] f32 frames on `device`.

    x: the low-res IC [*spatial/s, 2] when ``exp.isg`` is set, else the IC.
    A cell the fused kernels do not take raises; nothing falls back.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    roll = fused_rollout_2d if exp.cell.ndim == 2 else fused_rollout_3d
    with torch.inference_mode(), full_f32():
        h0 = isg_apply(params["isg"], x[None], exp.isg)[0] if exp.isg else x
        return roll(params["cell"], h0, exp.cell, n_steps)


def make_stability_probe(prob: Problem, n_steps: int):
    """Stability probe over the inference horizon (``train(probe=...)``).

    Rolls the model out autonomously for ``n_steps`` (the evaluation
    horizon, not the training segment) and returns the measurement data-fit
    (train + holdout MSE) if every frame is finite, else +inf.  Only the
    noisy measurements the model trains on are consulted, never the truth.
    """
    exp = prob.exp
    x = prob.ic_low[0] if exp.isg is not None else prob.h0

    def probe(params) -> float:
        frames = inference_rollout(params, exp, x, n_steps, device=x.device)
        if not bool(torch.isfinite(frames).all()):
            return float("inf")
        tr, va = data_loss(frames[: exp.train_steps + 1], prob.measurement, exp.data,
                           exp.cell.ndim)
        return float(tr + va)

    return probe


def select_stable_candidate(params: dict, ckpt_path: str, probe) -> tuple[dict, dict]:
    """Among the trainer's params ('best'), the latest checkpoint ('latest')
    and the probe's '.stable' checkpoint ('stable'), keep the one with the
    lowest finite probe score; if none probes finite, keep the trainer's.

    Checkpointed candidates are loaded onto the device of `params`.  The
    JAX package's signature also takes the Problem, which it does not read.
    Returns (chosen params, {'candidate', 'probe_scores'}).
    """
    first = flatten_with_paths(params)[0][1]
    dev = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
    candidates = {"best": params}
    for tag, suffix in (("latest", ""), ("stable", ".stable")):
        path = ckpt_path + suffix
        if os.path.exists(path):
            try:
                tree = load_checkpoint_tree(path)[0]["params"]
            except (OSError, KeyError, ValueError, zipfile.BadZipFile):
                continue   # an unreadable candidate is no candidate
            candidates[tag] = params_from_numpy(tree, device=dev, dtype=torch.float32)
    scores = {tag: float(probe(p)) for tag, p in candidates.items()}
    stable = {t: s for t, s in scores.items() if np.isfinite(s)}
    choice = min(stable, key=stable.get) if stable else "best"
    return candidates[choice], {"candidate": choice, "probe_scores": scores}


def evaluate(params: dict, prob: Problem, n_steps: int) -> dict:
    """Inference rollout + rel-L2 against the clean truth.

    If the rollout goes non-finite, the headline ``rel_l2*`` keys are NaN;
    the finite prefix is scored under ``rel_l2*_stable`` beside
    ``stable_frames`` and ``diverged``.
    """
    exp = prob.exp
    x = prob.ic_low[0] if exp.isg is not None else prob.h0
    frames = inference_rollout(params, exp, x, n_steps, device=x.device).cpu().numpy()
    t = min(frames.shape[0], prob.truth.shape[0])
    finite = np.isfinite(frames[:t]).all(axis=tuple(range(1, frames.ndim)))
    bad = np.flatnonzero(~finite)
    stable = int(bad[0]) if bad.size else t
    s = max(stable, 1)  # frame 0 is the IC; keep metrics well-defined
    diff = (frames[:s] - prob.truth[:s]).reshape(s, -1).astype(np.float64)
    ref = prob.truth[:s].reshape(s, -1).astype(np.float64)
    per_frame = np.linalg.norm(diff, axis=1) / np.maximum(np.linalg.norm(ref, axis=1), 1e-30)
    diverged = stable < t
    prefix = {
        "rel_l2_stable": rel_l2(frames[:s], prob.truth[:s]),
        "rel_l2_u_stable": rel_l2(frames[:s, ..., 0], prob.truth[:s, ..., 0]),
        "rel_l2_v_stable": rel_l2(frames[:s, ..., 1], prob.truth[:s, ..., 1]),
    }
    return {
        "rel_l2": np.nan if diverged else prefix["rel_l2_stable"],
        "rel_l2_u": np.nan if diverged else prefix["rel_l2_u_stable"],
        "rel_l2_v": np.nan if diverged else prefix["rel_l2_v_stable"],
        **prefix,
        "rel_l2_per_frame": per_frame,
        "stable_frames": stable,
        "diverged": diverged,
        "frames": frames,
    }


def run_experiment(exp: ExperimentConfig, *, out_dir: str = "runs",
                   cache_dir: str | None = "data_cache", dtype=torch.float32,
                   n_iters_override: int | None = None,
                   isg_pretrain_override: int | None = None, warmup: int | None = None,
                   steps_per_call: int | None = None, resume: bool = False,
                   seed: int = 0, device: str | torch.device = "cuda", mesh=None,
                   parallel_impl: str = "halo") -> dict:
    """Full pipeline on `device`: data -> (ISG pretrain) -> curriculum train -> eval.

    resume=True reloads params and optimizer from the experiment checkpoint
    and re-enters the curriculum stage it records; the ISG pretrain is
    skipped then.  When the config sets ``train.probe_every``, every stage
    runs the stability probe over the inference horizon and the evaluated
    params are the stable candidate (``select_stable_candidate``); the
    result then holds ``candidate`` and ``probe_scores``.  Besides the JAX
    package's result keys, ``seconds`` holds the host seconds of each phase
    (truth, ISG pretrain, each stage, candidate selection, evaluation).

    mesh: a parallel.Mesh whose first device is `device` -- training runs
    spatially decomposed over its devices (``make_mesh_rollout_fn`` with
    `parallel_impl`), without the stability probe, as in percnn_tpu.  The
    parameters stay on `device` throughout (each rollout copies them to the
    other mesh devices), so evaluation and serving take them as they are.
    """
    dev = resolve_device(device)
    if mesh is not None and mesh.devices.flat[0] != canonical_device(dev):
        raise ValueError(f"the mesh's first device {mesh.devices.flat[0]} is not the "
                         f"run's device {dev}; pass device={mesh.devices.flat[0]!s}")
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, f"{exp.name}.metrics.jsonl"),
                           echo_every=exp.train.log_every)
    seconds: dict = {"stages": []}
    if warmup is None:
        warmup = 100 if exp.system == "lambda_omega" else 0
    t0 = time.perf_counter()
    truth = make_dataset(exp, warmup=warmup, cache_dir=cache_dir, device=dev)
    seconds["truth"] = time.perf_counter() - t0
    prob = setup_problem(exp, truth, dtype, device=dev)
    params = init_model(exp, torch.Generator().manual_seed(seed), dtype, device=dev)

    if exp.isg is not None and not resume:
        t0 = time.perf_counter()
        n_pre = isg_pretrain_override if isg_pretrain_override is not None \
            else exp.isg_pretrain_iters
        params["isg"] = pretrain_isg(build_isg_pretrain_loss(prob), params["isg"],
                                     n_iters=n_pre, logger=logger, device=dev)
        seconds["isg_pretrain"] = time.perf_counter() - t0

    stages = list(exp.curriculum) + [exp.train_steps]
    n_total = n_iters_override if n_iters_override is not None else exp.train.n_iters
    per_stage = max(1, n_total // len(stages))
    ckpt_path = os.path.join(out_dir, f"{exp.name}.ckpt.npz")
    start_stage = 0
    if resume and os.path.exists(ckpt_path):
        start_stage = min(int(peek_meta(ckpt_path).get("stage", 0)), len(stages) - 1)
    probe = None
    if exp.train.probe_every > 0 and prob.measurement is not None and mesh is None:
        probe = make_stability_probe(prob, min(exp.infer_steps, truth.shape[0] - 1))
        if not resume and os.path.exists(ckpt_path + ".stable"):
            os.remove(ckpt_path + ".stable")   # stale: another run's params
    history: list = []
    last_stage_history: list = []
    for i, steps in enumerate(stages):
        if i < start_stage:
            continue
        tcfg = dataclasses.replace(
            exp.train,
            n_iters=per_stage if i < len(stages) - 1 else n_total - per_stage * (len(stages) - 1),
            ckpt_path=ckpt_path,
            log_path=None,
            **({"steps_per_call": steps_per_call} if steps_per_call else {}),
        )
        t0 = time.perf_counter()
        rollout_fn = (make_mesh_rollout_fn(prob, steps, mesh, impl=parallel_impl)
                      if mesh is not None else None)
        params, h = train(build_loss_fn(prob, steps, rollout_fn=rollout_fn), params, tcfg,
                          logger=logger,
                          resume=resume and i == start_stage, extra_meta={"stage": i},
                          probe=probe, device=dev)
        seconds["stages"].append({"steps": steps, "iters": tcfg.n_iters,
                                  "seconds": time.perf_counter() - t0})
        history.extend(h)
        last_stage_history = h

    selection: dict = {}
    if probe is not None:
        t0 = time.perf_counter()
        params, selection = select_stable_candidate(params, ckpt_path, probe)
        logger.log(n_total, candidate=selection["candidate"],
                   **{f"probe_{t}": s for t, s in selection["probe_scores"].items()})
        seconds["select"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = evaluate(params, prob, min(exp.infer_steps, truth.shape[0] - 1))
    seconds["evaluate"] = time.perf_counter() - t0
    logger.log(n_total, final_rel_l2=metrics["rel_l2"],
               **({"stable_frames": metrics["stable_frames"],
                   "rel_l2_stable": metrics["rel_l2_stable"],
                   "diverged": True} if metrics["diverged"] else {}))
    logger.close()
    result = {"params": params, "history": history, **metrics, **selection,
              "seconds": seconds}
    # truth-free convergence telemetry: the minimum training loss of the
    # final curriculum stage (loss scales compare only within a stage)
    finite_tail = [x for x in last_stage_history if math.isfinite(x)]
    result["final_stage_min_loss"] = min(finite_tail) if finite_tail else None
    return result


def run_experiment_with_restarts(exp: ExperimentConfig, *, out_dir: str = "runs",
                                 seed: int = 0, max_restarts: int = 2,
                                 seed_stride: int = 1000, loss_gate: float | None = None,
                                 **kw) -> dict:
    """run_experiment, retried with the init seed shifted by ``seed_stride``
    (the data and noise untouched) when a truth-free gate trips:

    - training raised FloatingPointError (the watchdog under
      abort_policy="raise");
    - the selected candidate's inference rollout diverged (evaluate's
      finiteness scan);
    - ``loss_gate`` is set and the final curriculum stage never reached a
      training loss below it.

    Among completed attempts the one with the lowest final-stage training
    loss is returned, with the attempt log under ``result["attempts"]``;
    attempt n > 0 keeps its artifacts in ``<out_dir>.retry<n>``.  An attempt
    whose directory already holds a checkpoint is resumed, not restarted.
    kw goes to run_experiment (device, cache_dir, overrides).
    """
    attempts = []
    best = None
    for attempt in range(max_restarts + 1):
        s = seed + attempt * seed_stride
        d = out_dir if attempt == 0 else f"{out_dir}.retry{attempt}"
        rec = {"attempt": attempt, "init_seed": s, "out_dir": d}
        # resume only when the checkpoint exists: resume=True skips the ISG
        # pretrain
        akw = kw
        if "resume" not in kw and os.path.exists(os.path.join(d, f"{exp.name}.ckpt.npz")):
            akw = dict(kw, resume=True)
        try:
            res = run_experiment(exp, out_dir=d, seed=s, **akw)
        except FloatingPointError as e:
            rec.update(error=str(e)[:200])
            attempts.append(rec)
            continue
        ml = res.get("final_stage_min_loss")
        rec.update(rel_l2=res.get("rel_l2"), diverged=res.get("diverged"),
                   final_stage_min_loss=ml, candidate=res.get("candidate"))
        attempts.append(rec)
        best_ml = (best or {}).get("final_stage_min_loss")
        if best is None or (ml is not None
                            and ml < (math.inf if best_ml is None else best_ml)):
            best = res
        # a missing final-stage loss (a resumed run whose training had
        # finished) trips the gate only when a loss_gate is in use
        gated = (res.get("diverged")
                 or (loss_gate is not None and (ml is None or ml > loss_gate)))
        if not gated:
            break
    if best is None:
        raise FloatingPointError(f"all {max_restarts + 1} attempts aborted: {attempts}")
    best["attempts"] = attempts
    return best
