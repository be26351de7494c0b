"""Stage-3: fine-tune the coefficients of the discovered symbolic PDE.

Counterpart of percnn_tpu/experiments/stage3.py (reference flow:
fine_tuning_[5%noise,41x51x51].py): take the Stage-2 STRidge coefficients as
initialisation of an explicit-PDE cell (``SymbolicCellConfig``), roll it out
from the ISG-generated IC, and train coefficients + ISG against data + IC
losses (Adam 5e-4, StepLR(100, .95), 1000-3000 iterations).  The
coefficients flow in through ``Stage3Config.coef_init``.

``run_stage3`` runs on `device` (the card unless told "cpu"): the ISG
pretrain and the trainer are the Stage-1 ones, and the symbolic rollout and
the gradient through it are eager autograd, checkpointed in segments.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from percnn_tpu_torch._device import full_f32, resolve_device
from percnn_tpu_torch.core.cell import SymbolicCellConfig, init_symbolic_cell, symbolic_cell_step
from percnn_tpu_torch.core.isg import init_isg, isg_apply
from percnn_tpu_torch.core.losses import data_loss, ic_loss
from percnn_tpu_torch.core.rollout import rollout
from percnn_tpu_torch.core.train import TrainConfig, pretrain_isg, train
from percnn_tpu_torch.experiments.configs import ExperimentConfig
from percnn_tpu_torch.utils.metrics import MetricsLogger, rel_l2


@dataclasses.dataclass(frozen=True)
class Stage3Config:
    """Symbolic fine-tune on top of a Stage-1 experiment's data setup."""

    base: ExperimentConfig            # reuse grid/dt/dx/isg/data/noise
    cell: SymbolicCellConfig = None
    coef_init: tuple = ()             # per-channel coefficient tuples (Stage-2)
    nu_init: tuple = (0.005, 0.005)
    truth_coef: dict | None = None    # {channel: {term: value}} for reporting
    train: TrainConfig = None


# The two reference Stage-3 setups (fine_tuning_[5%noise...].py:123-130 /
# fine_tuning_LO_[0%noise...].py:123-137).
def burgers_stage3(base: ExperimentConfig, coef_init=None, nu_init=None) -> Stage3Config:
    cell = SymbolicCellConfig(
        ndim=2, dt=base.dt, dx=base.dx,
        terms=(("u*u_x", "v*u_y"), ("u*v_x", "v*v_y")),
        integrator="euler", diffusion="raw",
    )
    return Stage3Config(
        base=base,
        cell=cell,
        coef_init=coef_init if coef_init is not None else ((-1.0, -1.0), (-1.0, -1.0)),
        nu_init=nu_init if nu_init is not None else (0.005, 0.005),
        truth_coef={
            0: {"lap": 0.005, "u*u_x": -1.0, "v*u_y": -1.0},
            1: {"lap": 0.005, "u*v_x": -1.0, "v*v_y": -1.0},
        },
        train=TrainConfig(n_iters=1000, lr=5e-4, lr_step=100, lr_gamma=0.95,
                          best_val=True),
    )


def lambda_omega_stage3(base: ExperimentConfig, coef_init=None, nu_init=None) -> Stage3Config:
    cell = SymbolicCellConfig(
        ndim=2, dt=base.dt, dx=base.dx,
        terms=(
            ("u", "u**3", "u**2*v", "u*v**2", "v**3"),
            ("v", "v**3", "u**3", "u*v**2", "u**2*v"),
        ),
        integrator="euler", diffusion="raw",
    )
    return Stage3Config(
        base=base,
        cell=cell,
        coef_init=coef_init if coef_init is not None else
        ((1.0, -1.0, 1.0, -1.0, 1.0), (1.0, -1.0, -1.0, -1.0, -1.0)),
        nu_init=nu_init if nu_init is not None else (0.1, 0.1),
        truth_coef={
            0: {"lap": 0.1, "u": 1.0, "u**3": -1.0, "u**2*v": 1.0,
                "u*v**2": -1.0, "v**3": 1.0},
            1: {"lap": 0.1, "v": 1.0, "v**3": -1.0, "u**3": -1.0,
                "u*v**2": -1.0, "u**2*v": -1.0},
        },
        train=TrainConfig(n_iters=1000, lr=5e-4, lr_step=100, lr_gamma=0.95,
                          best_val=True),
    )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def show_coef(params: dict, cfg: Stage3Config) -> str:
    """Identified-vs-truth coefficient table (reference `show_coef`,
    fine_tuning_[5%...].py:231-240)."""
    lines = [f"{'eq':<4}{'term':<10}{'identified':>14}{'truth':>10}"]
    names = ["u", "v"]
    nu = _host(params["cell"]["nu"])
    for c in range(cfg.cell.channels):
        truth = cfg.truth_coef.get(c, {}) if cfg.truth_coef else {}
        lines.append(f"{names[c]:<4}{'lap':<10}{float(nu[c]):>14.6f}"
                     f"{truth.get('lap', float('nan')):>10.4f}")
        for t, v in zip(cfg.cell.terms[c], _host(params["cell"]["coef"][c])):
            lines.append(f"{names[c]:<4}{t:<10}{float(v):>14.6f}"
                         f"{truth.get(t, float('nan')):>10.4f}")
    return "\n".join(lines)


def coef_errors(params: dict, cfg: Stage3Config) -> dict:
    """Max relative coefficient error vs truth (headline Stage-3 metric)."""
    errs = {}
    nu = _host(params["cell"]["nu"])
    for c in range(cfg.cell.channels):
        truth = cfg.truth_coef.get(c, {}) if cfg.truth_coef else {}
        if "lap" in truth:
            errs[f"nu_{c}"] = abs(float(nu[c]) - truth["lap"]) / abs(truth["lap"])
        for t, v in zip(cfg.cell.terms[c], _host(params["cell"]["coef"][c])):
            if t in truth:
                # truth 0.0 marks a known-spurious term (the reference's
                # C6_v, fine_tuning_LO_[10%noise...].py:137): report its
                # absolute magnitude, which fine-tuning should shrink.
                denom = abs(truth[t]) if truth[t] != 0.0 else 1.0
                errs[f"{t}_{c}"] = abs(float(v) - truth[t]) / denom
    return errs


def build_stage3_loss_fn(cfg: Stage3Config):
    """loss_fn(params, data) -> (total, {'data', 'val', 'ic'}): the ISG's
    answer to data['ic_low'] rolled out by the symbolic cell over
    base.train_steps, against data['meas'], plus the IC loss, weighted by
    base.loss_weights."""
    base = cfg.base
    nd = cfg.cell.ndim

    def loss_fn(params, data):
        d_ic, d_meas = data["ic_low"], data["meas"]
        isg_out = isg_apply(params["isg"], d_ic, base.isg)
        frames = rollout(lambda h: symbolic_cell_step(params["cell"], h, cfg.cell),
                         isg_out[0], base.train_steps)
        tr, va = data_loss(frames, d_meas, base.data, nd)
        icl = ic_loss(isg_out, d_ic, nd, base.interp_method,
                      align_corners=base.interp_align_corners,
                      periodic_extend=base.interp_periodic_extend)
        total = base.loss_weights.get("data", 1.0) * tr + base.loss_weights.get("ic", 1.0) * icl
        return total, {"data": tr, "val": va, "ic": icl}

    return loss_fn


def run_stage3(cfg: Stage3Config, truth: np.ndarray, *, out_dir: str = "runs",
               dtype=torch.float32, n_iters_override: int | None = None,
               isg_pretrain_iters: int = 2000, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """Train the symbolic cell + ISG on the Stage-1 data setup, on `device`.

    The ISG is drawn from ``torch.Generator().manual_seed(seed)``; the cell
    starts at cfg.coef_init and cfg.nu_init.  Returns {'params', 'history',
    'rel_l2', 'coef_table', 'coef_errors', 'frames'}, the frames a numpy
    rollout over the inference horizon.
    """
    from percnn_tpu_torch.experiments.runner import setup_problem

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    base = cfg.base
    logger = MetricsLogger(os.path.join(out_dir, "stage3.metrics.jsonl"),
                           echo_every=cfg.train.log_every)
    nd = cfg.cell.ndim
    # the noisy-IC / measurement setup of Stage 1
    prob = setup_problem(base, truth, dtype, device=dev)
    ic_low, meas = prob.ic_low, prob.measurement

    gen = torch.Generator().manual_seed(seed)
    params = {
        "cell": init_symbolic_cell(gen, cfg.cell, coef_init=cfg.coef_init,
                                   nu_init=cfg.nu_init, dtype=dtype, device=dev),
        "isg": init_isg(gen, base.isg, dtype, device=dev),
    }

    def isg_loss(isg_params):
        out = isg_apply(isg_params, ic_low, base.isg)
        return ic_loss(out, ic_low, nd, base.interp_method,
                       align_corners=base.interp_align_corners,
                       periodic_extend=base.interp_periodic_extend)

    params["isg"] = pretrain_isg(isg_loss, params["isg"], n_iters=isg_pretrain_iters,
                                 logger=logger, device=dev)

    tcfg = dataclasses.replace(
        cfg.train,
        n_iters=n_iters_override if n_iters_override is not None else cfg.train.n_iters,
        ckpt_path=os.path.join(out_dir, "stage3.ckpt.npz"),
    )
    params, history = train(build_stage3_loss_fn(cfg), params, tcfg, logger=logger,
                            loss_args=({"ic_low": ic_low, "meas": meas},), device=dev)

    with torch.inference_mode(), full_f32():
        h0 = isg_apply(params["isg"], ic_low, base.isg)[0]
        frames = rollout(lambda h: symbolic_cell_step(params["cell"], h, cfg.cell),
                         h0, min(base.infer_steps, truth.shape[0] - 1),
                         remat=False).cpu().numpy()
    result = {
        "params": params,
        "history": history,
        "rel_l2": rel_l2(frames, truth[: frames.shape[0]]),
        "coef_table": show_coef(params, cfg),
        "coef_errors": coef_errors(params, cfg),
        "frames": frames,
    }
    logger.log(tcfg.n_iters, final_rel_l2=result["rel_l2"])
    logger.close()
    return result
