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
(``make_mesh_rollout_fn``): by default the halo route
(parallel.sharded_rollout_nd, a halo exchange a step, one process), or
with ``parallel_impl="gspmd"`` GSPMD's counterpart, the eager model on
DTensors over a process group of one rank a mesh position
(parallel/spmd.py), the whole run on every rank.
``run_experiment(isg_params_path=...)`` shares one ISG pretrain between
runs, and every run writes the reference's post-processing figures
(``_export_viz``) when matplotlib is installed.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import math
import os
import time
import zipfile

import numpy as np
import torch

from percnn_tpu_torch._device import full_f32, resolve_device
from percnn_tpu_torch.bridge import params_from_numpy, params_to_numpy
from percnn_tpu_torch.core.cell import init_pi_cell, pi_cell_step
from percnn_tpu_torch.core.checkpoint import (
    flatten_with_paths,
    load_checkpoint,
    load_checkpoint_tree,
    peek_meta,
    save_checkpoint,
)
from percnn_tpu_torch.core.isg import init_isg, isg_apply
from percnn_tpu_torch.core.losses import (
    DataLossConfig,
    data_loss,
    ic_loss,
    ic_target,
    phys_loss,
)
from percnn_tpu_torch.core.rollout import rollout, rollout_tp
from percnn_tpu_torch.core.train import pretrain_isg, train
from percnn_tpu_torch.data.noise import add_noise
from percnn_tpu_torch.data.simulate import default_ic, simulate
from percnn_tpu_torch.experiments.configs import ExperimentConfig
from percnn_tpu_torch.ops import spmd_halo
from percnn_tpu_torch.ops.stencils import STENCIL_HALO
from percnn_tpu_torch.ops.kernels.backward2d import fused_rollout_tp_2d, fused_rollout_tp_2d_pg
from percnn_tpu_torch.ops.kernels.backward3d import fused_rollout_tp_3d, fused_rollout_tp_3d_pg
from percnn_tpu_torch.ops.kernels.cell2d import fused_rollout_2d
from percnn_tpu_torch.ops.kernels.cell3d import fused_rollout_3d
from percnn_tpu_torch.parallel import replicate, sharded_rollout_nd, spmd
from percnn_tpu_torch.parallel.mesh import canonical_device
from percnn_tpu_torch.parallel.spmd import P
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
                    'two_phase', as percnn_tpu (an f64 state, such as
                    FORWARD_SIM_LO's, takes no kernel);
      'fused_pg' -- rollout2d_kernel forward, pg2d_kernel backward
                    (ops/kernels/backward2d.py) in 2D; rollout3d_kernel
                    forward, pg3d_kernel backward (ops/kernels/backward3d.py)
                    in 3D;
      'fused'    -- the streaming adjoints: a 2D cell (any odd kernel_size
                    <= 5) through backward2d.fused_rollout_tp_2d, whose
                    routes the MXU switches and the activation budget pick
                    (the branch-matrix kernels or the FFMA ones forward:
                    cell2d.kxk_plan's or ffma_plan's; kxk_adj_plan's or
                    ys_plan's sweep, or adj2d_kernel, backward); a 3D cell
                    through backward3d.fused_rollout_tp_3d
                    (rollout3d_kernel, adj3d_kernel); the parameter
                    gradients outside the kernels;
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
        bptt = ("fused_pg" if f32 and pg_ok else "fused" if f32 and fused_ok
                else "two_phase")
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
    rollout_fn(params) -> frames [n_steps + 1, *spatial, 2].

    impl:
      'halo'  -- explicit domain decomposition: parallel.sharded_rollout_nd
                 over the mesh's first ndim axes, a 2-cell halo exchange a
                 step, the eager valid-region step on each block (its
                 default impl, as percnn_tpu's runner keeps); autograd
                 crosses the exchange; the frames on the mesh's first device;
      'gspmd' -- the eager model on DTensors, run on every rank of a process
                 group of one rank a mesh position: the initial state placed
                 P(*axes, None), the rollout of pi_cell_step with remat, the
                 frames P(None, *axes, None).  Any cell: the periodic
                 rolls and the k x k branches' circular pads trade halos
                 with the neighbouring ranks (ops/spmd_halo.py, XLA's
                 collective-permute), and DTensor reduces the loss's means
                 across ranks.  The Problem's arrays
                 become DTensors on the mesh here, once (``spmd_problem``),
                 unless they already are.  Outside a process group,
                 rollout_fn(params) runs the rollout on the mesh's ranks
                 (parallel.launch) and returns the whole frames, without
                 gradient.  rollout_fn.placements records the frames'
                 placements as DTensor left them, before the constraint.
    """
    exp = prob.exp
    axis_names = _mesh_axes(exp, prob.truth.shape[1:1 + exp.cell.ndim], mesh)
    if impl not in ("halo", "gspmd"):
        raise ValueError(f"unknown parallel impl {impl!r} (expected 'halo' or 'gspmd')")

    if impl == "halo":
        def rollout_fn(params):
            h0 = (isg_apply(params["isg"], prob.ic_low, exp.isg)[0] if exp.isg is not None
                  else prob.h0)
            return sharded_rollout_nd(params["cell"], h0, exp.cell, n_steps, mesh,
                                      axis_names=axis_names)

        return rollout_fn
    if not spmd.in_group():
        host_prob = _problem_to(prob, torch.device("cpu"))

        def rollout_fn(params):
            params = spmd.tree_map(lambda t: t.detach().cpu(), params)
            return spmd.launch(_gspmd_frames, mesh, host_prob, n_steps, mesh, params)

        return rollout_fn
    return gspmd_rollout_fn(spmd_problem(prob, mesh), n_steps, spmd.device_mesh(mesh),
                            spmd.placements(mesh, P(*axis_names, None)),
                            spmd.placements(mesh, P(None, *axis_names, None)))


def _mesh_axes(exp: ExperimentConfig, spatial: tuple, mesh) -> tuple:
    """The mesh axes that cut the grid dims `spatial` (its first ndim);
    each must divide its dim into blocks at least as thick as the halo a
    block hands on (the stencils' 2 cells, a k x k branch's k // 2)."""
    nd = exp.cell.ndim
    axis_names = tuple(mesh.axis_names)[:nd]
    if len(axis_names) != nd:
        raise ValueError(
            f"mesh {tuple(mesh.axis_names)} has fewer axes than the "
            f"{nd}D experiment {exp.name!r}")
    halo = max(STENCIL_HALO, exp.cell.kernel_size // 2)
    for n, a in zip(spatial, axis_names):
        if n % mesh.shape[a]:
            raise ValueError(
                f"grid axis {a}={n} not divisible by mesh axis "
                f"{a}={mesh.shape[a]} for experiment {exp.name!r}")
        if n // mesh.shape[a] < halo:
            raise ValueError(
                f"grid axis {a}={n} cut by mesh axis {a}={mesh.shape[a]} leaves blocks of "
                f"{n // mesh.shape[a]} cells, thinner than the {halo}-cell halo each "
                f"hands on, for experiment {exp.name!r}")
    return axis_names


def gspmd_rollout_fn(dprob: Problem, n_steps: int, dmesh, state_p: tuple, frames_p: tuple):
    """make_mesh_rollout_fn's 'gspmd' rollout on a DeviceMesh: the initial
    state (the ISG's output, or the full-res IC) placed `state_p`, the
    rollout of pi_cell_step with remat, the frames placed `frames_p`.
    dprob's arrays are DTensors on `dmesh`."""
    exp = dprob.exp

    def rollout_fn(params):
        h0 = (replicated_isg(params["isg"], dprob.ic_low, exp.isg)[0] if exp.isg is not None
              else dprob.h0)
        h0 = spmd.distribute(h0, dmesh, state_p)
        frames = rollout(lambda h: pi_cell_step(params["cell"], h, exp.cell), h0, n_steps,
                         remat=True)
        rollout_fn.placements = str(tuple(frames.placements))
        return spmd.distribute(frames, dmesh, frames_p)

    rollout_fn.placements = None
    return rollout_fn


def replicated_isg(params: dict, h_low, cfg) -> torch.Tensor:
    """isg_apply on DTensors, run whole on every rank
    (spmd.replicated_local): a replicated DTensor out.  Its input, the
    low-res IC, is replicated (``spmd_problem``) and it runs once an
    iteration, off the rollout's T steps: run whole, its forward needs no
    collective, where cutting it would need halos of the coarse grid
    through its transposed convs, which ops/spmd_halo does not move."""
    return spmd.replicated_local(lambda p, x: isg_apply(p, x, cfg), params, h_low)


def _problem_to(prob: Problem, dev: torch.device) -> Problem:
    """The Problem's arrays on `dev` (plain tensors)."""
    return dataclasses.replace(prob, **{
        k: getattr(prob, k).to(dev) for k in ("h0", "ic_low", "measurement")
        if getattr(prob, k) is not None})


def spmd_problem(prob: Problem, mesh) -> Problem:
    """The Problem with its arrays DTensors on the mesh (on every rank):
    the full-res IC placed as the gspmd rollout's state, P(*axes, None);
    the low-res IC and the measurement replicated (percnn_tpu closes over
    them as constants, which XLA may place as it likes).  Arrays that are
    DTensors already stay as they are."""
    dmesh = spmd.device_mesh(mesh)
    dev = spmd.rank_device(mesh)
    axes = tuple(mesh.axis_names)[:prob.exp.cell.ndim]
    specs = {"h0": P(*axes, None), "ic_low": P(), "measurement": P()}
    out = {}
    for name, spec in specs.items():
        x = getattr(prob, name)
        if x is not None and not spmd.is_dtensor(x):
            out[name] = spmd.distribute(x.to(dev), dmesh, spmd.placements(mesh, spec))
    return dataclasses.replace(prob, **out)


def _gspmd_frames(prob: Problem, n_steps: int, mesh, params: dict) -> torch.Tensor:
    """On every rank: the gspmd rollout of `params` (replicated), whole."""
    dev = spmd.rank_device(mesh)
    params = spmd.tree_map(lambda t: t.to(dev), params)
    with torch.no_grad(), full_f32():
        rollout_fn = make_mesh_rollout_fn(_problem_to(prob, dev), n_steps, mesh, impl="gspmd")
        frames = spmd.implicitly_replicated(rollout_fn)(replicate(params, mesh))
        return spmd.full(frames)


def _mesh_libraries(mesh, names: tuple) -> tuple:
    """The kernel libraries to build before a launch on a CUDA mesh."""
    return names if mesh.devices.flat[0].type == "cuda" else ()


def _n_meas(n_frames: int, dcfg: DataLossConfig) -> int:
    return len(range(n_frames)[slice(0, -1 if dcfg.drop_last_frame else None,
                                     dcfg.time_stride)])


def build_loss_fn(prob: Problem, n_steps: int, *, bptt: str = "auto", rollout_fn=None,
                  isg_fn=isg_apply):
    """Composite loss per the experiment's weights; aux carries every
    component plus 'val' (holdout data MSE) and 'phy' (residual metric).

    loss_fn(params) -> (total, aux).  rollout_fn(params) -> frames
    overrides forward_rollout, and isg_fn the ISG of the IC loss (the
    gspmd route's is ``replicated_isg``).  When 'phy' has no weight it is
    a metric only, computed without autograd.
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
            out = isg_fn(params["isg"], prob.ic_low, exp.isg)
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
    """ISG (if the model has one), then the rollout: [n_steps+1, *spatial, 2]
    frames on `device`, in the dtype of `x`.

    x: the low-res IC [*spatial/s, 2] when ``exp.isg`` is set, else the IC.
    The dispatch is by dtype, as in percnn_tpu: an f32 input takes the
    fused rollout (2D or 3D), and a cell the fused kernels do not take
    raises; any other floating input (an f64 run's problem) takes the eager
    ``core.rollout`` of the cell's step in that dtype, with the parameters
    cast to it, since no kernel takes f64.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    with torch.inference_mode(), full_f32():
        if x.dtype != torch.float32:
            params = params_from_numpy(params, device=dev, dtype=x.dtype)
        h0 = isg_apply(params["isg"], x[None], exp.isg)[0] if exp.isg else x
        if x.dtype != torch.float32:
            return rollout(lambda h: pi_cell_step(params["cell"], h, exp.cell), h0, n_steps,
                           remat=False)
        roll = fused_rollout_2d if exp.cell.ndim == 2 else fused_rollout_3d
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

    Checkpointed candidates are loaded onto the device of `params`, in the
    dtype they were saved in (an f64 run's stay f64).  The JAX package's
    signature also takes the Problem, which it does not read.
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
            candidates[tag] = params_from_numpy(tree, device=dev)
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


def _export_viz(exp: ExperimentConfig, prob: Problem, params: dict, metrics: dict,
                truth: np.ndarray, out_dir: str) -> None:
    """The reference's post-processing figures, in ``out_dir``:

    - the 2x3 panel with the noisy-measurement column (train_2drd.py:445-521),
      or pred / truth / |err| without a measurement: ``{name}.panel.png``;
    - the every-N-steps image series (percnn_LO_eqn.py:526-543):
      ``{name}_frames/{name}_NNN.png``;
    - in 3D, u and v isosurfaces of prediction and truth (Plot3D.py:6-29):
      ``{name}.iso.{u,v}.{pred,truth}.html`` (a ``.png`` montage without
      plotly), and the mid-depth slice's panel;
    - with an ISG, its output against the interpolation target and the
      measurement (rcnn_Burgers...py:489-578): ``{name}.ic_panel.png``.
    """
    from percnn_tpu_torch.viz.plots import (comparison_panel, frame_series, ic_panel,
                                            isosurface_pair, measurement_panel)

    frames = metrics["frames"]
    mid = frames.shape[0] // 2
    if exp.cell.ndim == 3:
        isosurface_pair(frames[mid], np.asarray(truth[mid]),
                        os.path.join(out_dir, f"{exp.name}.iso"))
        comparison_panel(frames[mid][frames.shape[1] // 2],
                         np.asarray(truth[mid][truth.shape[1] // 2]),
                         os.path.join(out_dir, f"{exp.name}.panel.png"),
                         title=f"{exp.name} t={mid} (mid-depth slice)")
        return
    if prob.measurement is not None:
        meas = prob.measurement.cpu().numpy()
        tm = meas.shape[0] // 2
        t_frame = min(tm * exp.data.time_stride, frames.shape[0] - 1)
        measurement_panel(frames[t_frame], np.asarray(truth[t_frame]), meas[tm],
                          os.path.join(out_dir, f"{exp.name}.panel.png"),
                          title=f"{exp.name} t={t_frame}")
    else:
        comparison_panel(frames[mid], np.asarray(truth[mid]),
                         os.path.join(out_dir, f"{exp.name}.panel.png"),
                         title=f"{exp.name} t={mid}")
    frame_series(frames, np.asarray(truth[: frames.shape[0]]),
                 os.path.join(out_dir, f"{exp.name}_frames"), name=exp.name)
    if exp.isg is not None:
        with torch.no_grad(), full_f32():
            out = isg_apply(params["isg"], prob.ic_low, exp.isg)
            tgt = ic_target(prob.ic_low, tuple(out.shape[1:-1]), exp.cell.ndim,
                            exp.interp_method, align_corners=exp.interp_align_corners,
                            periodic_extend=exp.interp_periodic_extend)
        ic_panel(out[0].cpu().numpy(), tgt[0].cpu().numpy(),
                 os.path.join(out_dir, f"{exp.name}.ic_panel.png"),
                 low_res=prob.ic_low[0].cpu().numpy())


def _recording(rollout_fn, dprob: Problem, n_steps: int, seen: dict):
    """The gspmd stage's loss, plain tensors taken as replicated; its first
    call records in `seen` the placements of the frames (as DTensor left
    them) and of the loss."""
    loss_fn = spmd.implicitly_replicated(build_loss_fn(dprob, n_steps, rollout_fn=rollout_fn,
                                                       isg_fn=replicated_isg))

    def call(params):
        total, aux = loss_fn(params)
        if not seen:
            seen.update(frames=rollout_fn.placements, loss=str(tuple(total.placements)))
        return total, aux

    return call


def run_experiment(exp: ExperimentConfig, *, out_dir: str = "runs",
                   cache_dir: str | None = "data_cache", dtype=torch.float32,
                   n_iters_override: int | None = None,
                   isg_pretrain_override: int | None = None, warmup: int | None = None,
                   steps_per_call: int | None = None, resume: bool = False,
                   seed: int = 0, device: str | torch.device = "cuda", mesh=None,
                   parallel_impl: str = "halo", isg_params_path: str | None = None,
                   graph: bool = True) -> dict:
    """Full pipeline on `device`: data -> (ISG pretrain) -> curriculum train -> eval.

    resume=True reloads params and optimizer from the experiment checkpoint
    and re-enters the curriculum stage it records; the ISG pretrain is
    skipped then.  When the config sets ``train.probe_every``, every stage
    runs the stability probe over the inference horizon and the evaluated
    params are the stable candidate (``select_stable_candidate``); the
    result then holds ``candidate`` and ``probe_scores``.  Besides the JAX
    package's result keys, ``seconds`` holds the host seconds of each phase
    (truth, ISG pretrain, each stage, candidate selection, evaluation).
    For a kernel_size-1 cell the result holds ``pi_expressions``, the
    closed-form polynomial each trained Pi block represents
    (discovery.symbolic), when sympy is installed; without sympy the key is
    left out.  Unlike percnn_tpu, whose bare ``except`` hides any failure
    there, an error in the expansion propagates.

    mesh: a parallel.Mesh whose first device is `device` -- training runs
    spatially decomposed over its devices (``make_mesh_rollout_fn`` with
    `parallel_impl`), without the stability probe, as in percnn_tpu.  With
    'halo' the parameters stay on `device` throughout (each rollout copies
    them to the other mesh devices).  With 'gspmd' the whole run goes
    through parallel.launch: every rank makes the truth (rank 0 first, into
    the cache), pretrains the ISG and trains on replicated DTensor
    parameters and DTensor data; every host read is made on every rank and
    only rank 0 writes the log, checkpoints and figures; after training
    each rank gathers the parameters and evaluates, and rank 0's result
    comes back (under torchrun, each rank's) with the parameters on
    `device`, the placements DTensor gave the frames and the loss under
    ``placements``, and the rank's halo sends and bytes in training
    (ops/spmd_halo.py) under ``halo_exchange``.  Either way evaluation and
    serving take the returned parameters as they are.

    graph: on CUDA the ISG pretrain and every training iteration replay a
    captured CUDA graph (core/train.py), on every rank of a gspmd run too;
    graph=False runs them eagerly.  The 'halo' route's iterations run
    eagerly whatever `graph` says (its strips move between the devices of
    one process).

    isg_params_path: a checkpoint of the ISG alone (``save_checkpoint``'s
    format, which both packages read).  When the file exists, the ISG is
    loaded from it instead of pretrained; otherwise the pretrained ISG is
    saved there.  The ISG sees only the seeded noisy IC, so runs of the
    same experiment and seed can share one pretrain.

    After the evaluation the reference's figures are written to `out_dir`
    (``_export_viz``) when matplotlib is installed; without it they are
    skipped.  Unlike percnn_tpu, whose bare ``except`` hides any failure
    there, an error in drawing them propagates.
    """
    dev = resolve_device(device)
    if mesh is not None and mesh.devices.flat[0] != canonical_device(dev):
        raise ValueError(f"the mesh's first device {mesh.devices.flat[0]} is not the "
                         f"run's device {dev}; pass device={mesh.devices.flat[0]!s}")
    gspmd = mesh is not None and parallel_impl == "gspmd"
    if gspmd and not spmd.in_group():
        _mesh_axes(exp, (exp.grid,) * exp.cell.ndim, mesh)   # refused before any rank starts
        run = functools.partial(
            _run_experiment, out_dir=out_dir, cache_dir=cache_dir, dtype=dtype,
            n_iters_override=n_iters_override, isg_pretrain_override=isg_pretrain_override,
            warmup=warmup, steps_per_call=steps_per_call, resume=resume, seed=seed,
            device=dev, mesh=mesh, parallel_impl=parallel_impl,
            isg_params_path=isg_params_path, graph=graph, expressions=False)
        evaluation = ("cell3d" if exp.cell.ndim == 3 else
                      "cell2d" if exp.cell.kernel_size == 1 else "cell2d_kxk")
        result = spmd.launch(run, mesh, exp, libraries=_mesh_libraries(mesh, (evaluation,)))
        result["params"] = params_from_numpy(result["params"], device=dev)
        result.update(_pi_expressions(exp, result["params"]))
        return result
    return _run_experiment(exp, out_dir=out_dir, cache_dir=cache_dir, dtype=dtype,
                           n_iters_override=n_iters_override,
                           isg_pretrain_override=isg_pretrain_override, warmup=warmup,
                           steps_per_call=steps_per_call, resume=resume, seed=seed,
                           device=dev, mesh=mesh, parallel_impl=parallel_impl,
                           isg_params_path=isg_params_path, graph=graph)


def _pi_expressions(exp: ExperimentConfig, params: dict) -> dict:
    """{'pi_expressions': the closed form of each trained Pi block} for a
    kernel_size-1 cell when sympy is installed, else {}."""
    if exp.cell.kernel_size != 1 or importlib.util.find_spec("sympy") is None:
        return {}
    from percnn_tpu_torch.discovery.symbolic import pi_block_expression

    pi = params_to_numpy(params["cell"])["pi"]
    return {"pi_expressions": [str(pi_block_expression(pi[c]))
                               for c in range(exp.cell.channels)]}


def _run_experiment(exp: ExperimentConfig, *, out_dir: str, cache_dir: str | None, dtype,
                    n_iters_override: int | None, isg_pretrain_override: int | None,
                    warmup: int | None, steps_per_call: int | None, resume: bool, seed: int,
                    device: torch.device, mesh, parallel_impl: str,
                    isg_params_path: str | None, graph: bool, expressions: bool = True) -> dict:
    """run_experiment's body, in this process (on each rank of a gspmd run,
    where the launching process adds the pi_expressions)."""
    dev = device
    gspmd = mesh is not None and parallel_impl == "gspmd"
    if gspmd:
        dev = spmd.rank_device(mesh)
        spmd.device_mesh(mesh)
    writer = spmd.is_writer()
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, f"{exp.name}.metrics.jsonl") if writer else None,
                           echo_every=exp.train.log_every if writer else 0)
    seconds: dict = {"stages": []}
    if warmup is None:
        warmup = 100 if exp.system == "lambda_omega" else 0
    t0 = time.perf_counter()
    truth = (make_dataset(exp, warmup=warmup, cache_dir=cache_dir, device=dev)
             if writer else None)
    spmd.barrier()   # rank 0 made the cache file, which the other ranks read
    if truth is None:
        truth = make_dataset(exp, warmup=warmup, cache_dir=cache_dir, device=dev)
    seconds["truth"] = time.perf_counter() - t0
    prob = setup_problem(exp, truth, dtype, device=dev)
    params = init_model(exp, torch.Generator().manual_seed(seed), dtype, device=dev)

    if exp.isg is not None and not resume:
        t0 = time.perf_counter()
        if isg_params_path is not None and os.path.exists(isg_params_path):
            params["isg"] = load_checkpoint(isg_params_path, params["isg"])[0]
        else:
            n_pre = isg_pretrain_override if isg_pretrain_override is not None \
                else exp.isg_pretrain_iters
            params["isg"] = pretrain_isg(build_isg_pretrain_loss(prob), params["isg"],
                                         n_iters=n_pre, logger=logger, device=dev, graph=graph)
            if isg_params_path is not None and writer:
                save_checkpoint(isg_params_path, params["isg"],
                                {"experiment": exp.name, "seed": seed})
            spmd.barrier()
        seconds["isg_pretrain"] = time.perf_counter() - t0
    if gspmd:
        # replicated from rank 0's copy, so every rank starts from the same
        # parameters whatever its own ISG pretrain gave
        params = replicate(params, mesh)
        dprob = spmd_problem(prob, mesh)

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
    placements: dict = {}   # gspmd: what DTensor gave the frames and the loss
    if gspmd:
        spmd_halo.sends = spmd_halo.bytes_sent = 0   # the result counts training's
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
        if gspmd:
            loss_fn = _recording(make_mesh_rollout_fn(dprob, steps, mesh, impl="gspmd"),
                                 dprob, steps, placements)
        else:
            rollout_fn = (make_mesh_rollout_fn(prob, steps, mesh, impl=parallel_impl)
                          if mesh is not None else None)
            loss_fn = build_loss_fn(prob, steps, rollout_fn=rollout_fn)
        # the 'halo' route runs eagerly: its strips move between the mesh's
        # devices by .to(device) within this process, and one stream's
        # capture holds no copy to another device's stream.  A gspmd rank
        # holds one device, and its graph its collectives.
        params, h = train(loss_fn, params, tcfg, logger=logger,
                          resume=resume and i == start_stage, extra_meta={"stage": i},
                          probe=probe, device=dev, graph=graph and (mesh is None or gspmd))
        seconds["stages"].append({"steps": steps, "iters": tcfg.n_iters,
                                  "seconds": time.perf_counter() - t0})
        history.extend(h)
        last_stage_history = h
        if gspmd and i == start_stage and placements:
            logger.log(len(history) - 1, event="gspmd_placements", **placements)
    if gspmd:
        params = spmd.tree_map(spmd.full, params)

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
    if writer and importlib.util.find_spec("matplotlib") is not None:
        t0 = time.perf_counter()
        _export_viz(exp, prob, params, metrics, truth, out_dir)
        seconds["viz"] = time.perf_counter() - t0
    result = {"params": params, "history": history, **metrics, **selection,
              "seconds": seconds,
              **({"placements": placements,
                  "halo_exchange": {"sends": spmd_halo.sends, "bytes": spmd_halo.bytes_sent}}
                 if gspmd else {})}
    if expressions:
        result.update(_pi_expressions(exp, params))
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
