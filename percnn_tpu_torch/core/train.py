"""Training loop: Adam with a StepLR staircase, atomic checkpoints and resume,
best-validation selection, the NaN/spike watchdog family and the stability
probe.

Counterpart of percnn_tpu/core/train.py.  ``torch.optim.Adam(eps=1e-8)``
takes the place of ``optax.scale_by_adam`` scaled by -lr: the two compute
the same update.  The learning rate lr * gamma^(it // lr_step) * lr_scale
is set on the parameter group before every step.  ``steps_per_call`` is
the number of steps between host reads of the losses: one device
synchronisation per chunk, where the watchdog judges the chunk.  Every step
runs in full float32 (``_device.full_f32``).

The JAX trainer computes a chunk functionally and drops a failed chunk's
new params and optimizer state.  Here ``opt.step()`` updates in place, so
with the watchdog on the trainer snapshots the params and the Adam state
before each chunk and restores that snapshot when the chunk fails, before
it reloads the checkpoint (if one exists): the same replay as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable

import numpy as np
import torch

from percnn_tpu_torch._device import full_f32, resolve_device
from percnn_tpu_torch.bridge import _map_tree
from percnn_tpu_torch.core.checkpoint import (
    flatten_with_paths,
    load_checkpoint,
    peek_meta,
    save_checkpoint,
)
from percnn_tpu_torch.utils.metrics import MetricsLogger


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer settings, fields and defaults as in percnn_tpu."""

    n_iters: int = 1000
    lr: float = 1e-3
    lr_step: int = 200        # StepLR step_size (iterations)
    lr_gamma: float = 0.985   # StepLR decay
    ckpt_path: str | None = None
    ckpt_every: int = 100
    best_val: bool = False    # checkpoint on best validation metric
    val_key: str = "val"      # aux key used for best-val
    watchdog: bool = False    # NaN watchdog: restore, LR * 0.9, replay
    watchdog_key: str = "phy"
    spike_mult: float | None = None  # a finite jump past spike_mult x the EMA
                                     # of watchdog_key also rolls back
    spike_warmup: int = 500   # iterations before spike checks arm
    spike_max_retries: int = 5  # then the spike is accepted, EMA rebased
    lr_recover: float = 1.0   # lr_scale *= lr_recover per clean iteration, to 1
    best_key: str | None = None  # return the params with the lowest aux metric
    spike_reset_opt: bool = False  # fresh Adam state on the 2nd+ rollback in a row
    abort_policy: str = "raise"    # after 50 failed chunks: "raise" or "stop"
    probe_every: int = 0      # stability-probe cadence (iterations); 0 = off
    log_path: str | None = None
    log_every: int = 50
    steps_per_call: int = 1   # optimizer steps between host reads of the losses


def _leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _trainable(params, dev: torch.device):
    """Fresh leaf tensors on `dev` that require grad (the caller's stay as they are)."""
    def leaf(t):
        t = t.detach() if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
        return t.to(dev).clone().requires_grad_(True)

    return _map_tree(leaf, params)


def _snapshot(tree):
    return _map_tree(lambda t: t.detach().clone(), tree)


class TrainState:
    """params + Adam state + host-side schedule bookkeeping (resumable)."""

    def __init__(self, params, lr: float):
        self.params = params
        self.opt = torch.optim.Adam(_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.iteration = 0
        self.lr_scale = 1.0
        self.best_val = math.inf

    def _moment(self, name: str):
        return _map_tree(lambda p: self.opt.state[p][name] if self.opt.state[p]
                         else torch.zeros_like(p), self.params)

    def as_tree(self) -> dict:
        """{'params', 'opt_state': {'step', 'exp_avg', 'exp_avg_sq'}} (the
        port's own keys for the Adam moments)."""
        first = self.opt.state[_leaves(self.params)[0]]
        step = float(first["step"]) if first else 0.0
        return {"params": self.params,
                "opt_state": {"step": np.asarray(step, np.float32),
                              "exp_avg": self._moment("exp_avg"),
                              "exp_avg_sq": self._moment("exp_avg_sq")}}

    def load_tree(self, tree: dict) -> None:
        with torch.no_grad():
            for p, v in zip(_leaves(self.params), _leaves(tree["params"])):
                p.copy_(v)
        opt = tree["opt_state"]
        step = float(opt["step"])
        for p, m, v in zip(_leaves(self.params), _leaves(opt["exp_avg"]),
                           _leaves(opt["exp_avg_sq"])):
            self.opt.state[p] = ({"step": torch.tensor(step), "exp_avg": m.clone(),
                                  "exp_avg_sq": v.clone()} if step > 0 else {})

    def capture(self) -> tuple:
        """Copies of the params and the Adam state, for ``restore``."""
        leaves = _leaves(self.params)
        return ([p.detach().clone() for p in leaves],
                [{k: v.clone() for k, v in self.opt.state[p].items()} for p in leaves])

    def restore(self, snap: tuple) -> None:
        """Put back what ``capture`` copied (the copies are taken over, not
        copied again: each chunk takes a fresh capture)."""
        values, opt_states = snap
        with torch.no_grad():
            for p, v in zip(_leaves(self.params), values):
                p.copy_(v)
        for p, st in zip(_leaves(self.params), opt_states):
            self.opt.state[p] = st

    def reset_opt(self) -> None:
        """Fresh Adam state: zero moments and step 0, so the bias correction
        restarts (optax's ``tx.init``)."""
        for p in _leaves(self.params):
            self.opt.state[p] = {}

    def meta(self) -> dict:
        return {"iteration": self.iteration, "lr_scale": self.lr_scale,
                "best_val": None if math.isinf(self.best_val) else self.best_val}

    def load_meta(self, meta: dict) -> None:
        self.iteration = int(meta.get("iteration", 0))
        self.lr_scale = float(meta.get("lr_scale", 1.0))
        bv = meta.get("best_val")
        self.best_val = math.inf if bv is None else float(bv)


def train(loss_fn: Callable, params, cfg: TrainConfig, *, resume: bool = False,
          logger: MetricsLogger | None = None, extra_meta: dict | None = None,
          loss_args: tuple = (), probe: Callable | None = None,
          device: str | torch.device = "cuda") -> tuple:
    """Run the training loop on `device`.

    loss_fn(params, *loss_args) -> (total_loss, aux dict of scalar tensors).
    params: a tree of tensors or numpy arrays; the trainer works on its own
    copies on `device`.  extra_meta is merged into every checkpoint's
    metadata (the curriculum stage, so a resume re-enters the right stage).
    probe(params) -> float, lower is better and non-finite marks the iterate
    unstable; it fires every cfg.probe_every iterations and at the end, and
    each finite improvement is checkpointed to ``cfg.ckpt_path + '.stable'``
    with its ``probe_score``.  Returns (best-or-final params, loss history
    list); under best_val/best_key the best params start as the starting
    params (after any resume), so a run that never sees a finite best
    returns those.
    """
    if cfg.best_val and cfg.best_key is not None:
        raise ValueError("best_val and best_key are mutually exclusive selection "
                         "policies: they would race for best_params/.best")
    dev = resolve_device(device)
    state = TrainState(_trainable(params, dev), cfg.lr)
    if resume and cfg.ckpt_path and os.path.exists(cfg.ckpt_path):
        tree, meta = load_checkpoint(cfg.ckpt_path, state.as_tree())
        state.load_tree(tree)
        state.load_meta(meta)

    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(cfg.log_path, echo_every=cfg.log_every)
    history: list = []
    best_params = _snapshot(state.params)
    nan_streak = 0
    spike_streak = 0
    watch_ema = None
    best_metric = math.inf
    last_best_write = -10 ** 9
    best_unflushed = None  # (tree, meta) of a best improvement not yet on disk
    best_probe = math.inf
    if probe is not None and cfg.ckpt_path and os.path.exists(cfg.ckpt_path + ".stable"):
        # the probe competition carries across curriculum stages and resumes
        # (callers delete a stale file on a fresh run)
        prev = peek_meta(cfg.ckpt_path + ".stable").get("probe_score")
        if prev is not None:
            best_probe = float(prev)

    def save(path_suffix: str = "", extra: dict | None = None) -> None:
        if cfg.ckpt_path:
            save_checkpoint(cfg.ckpt_path + path_suffix, state.as_tree(),
                            {**state.meta(), **(extra_meta or {}), **(extra or {})})

    try:
        with full_f32():
            while state.iteration < cfg.n_iters:
                it = state.iteration
                n_sub = min(cfg.steps_per_call, cfg.n_iters - it)
                before = state.capture() if cfg.watchdog else None
                totals, auxs, lrs = [], [], []
                for k in range(n_sub):
                    lr = cfg.lr * cfg.lr_gamma ** ((it + k) // cfg.lr_step) * state.lr_scale
                    for group in state.opt.param_groups:
                        group["lr"] = lr
                    state.opt.zero_grad(set_to_none=True)
                    total, aux = loss_fn(state.params, *loss_args)
                    total.backward()
                    state.opt.step()
                    totals.append(total.detach())
                    auxs.append({name: v.detach() for name, v in aux.items()})
                    lrs.append(lr)
                # one host read per chunk
                totals = torch.stack(totals).cpu().numpy()
                auxs = {name: torch.stack([a[name] for a in auxs]).cpu().numpy()
                        for name in auxs[0]}
                watch = auxs.get(cfg.watchdog_key, totals) if cfg.watchdog else totals

                bad = bool(np.isnan(watch).any() or np.isnan(totals).any())
                spiked = (not bad and cfg.watchdog and cfg.spike_mult is not None
                          and watch_ema is not None and it >= cfg.spike_warmup
                          and float(np.max(watch)) > cfg.spike_mult * watch_ema)
                if spiked and spike_streak >= cfg.spike_max_retries:
                    # a rollback replays deterministically and is not escaping
                    # this: accept the new regime, rebasing the EMA to finite
                    # values only (0.9 * inf stays inf)
                    spiked = False
                    spike_streak = 0
                    w_new = float(np.max(watch))
                    watch_ema = w_new if math.isfinite(w_new) else None
                    logger.log(it, event="spike_accepted", ema=watch_ema)
                if cfg.watchdog and (bad or spiked):
                    # drop the chunk, as the JAX trainer does, then reload the
                    # checkpoint if there is one; LR * 0.9; replay the same
                    # iterations
                    state.restore(before)
                    if bad:
                        nan_streak += 1
                        if nan_streak > 50:
                            if cfg.abort_policy == "stop":
                                logger.log(it, event="aborted",
                                           reason="50 consecutive failed chunks")
                                break
                            raise FloatingPointError(
                                "watchdog: 50 consecutive failed chunks "
                                f"(iteration {it}); aborting")
                    else:
                        spike_streak += 1
                    state.lr_scale *= 0.9
                    if cfg.ckpt_path and os.path.exists(cfg.ckpt_path):
                        tree, _ = load_checkpoint(cfg.ckpt_path, state.as_tree())
                        state.load_tree(tree)
                    opt_reset = cfg.spike_reset_opt and nan_streak + spike_streak >= 2
                    if opt_reset:
                        state.reset_opt()
                    logger.log(it, event="spike_watchdog" if spiked else "nan_watchdog",
                               lr_scale=state.lr_scale,
                               **({"opt_reset": True} if opt_reset else {}),
                               **({"watch": float(np.max(watch)), "ema": watch_ema}
                                  if spiked else {}))
                    continue
                nan_streak = 0
                spike_streak = 0
                if cfg.lr_recover > 1.0 and state.lr_scale < 1.0:
                    state.lr_scale = min(1.0, state.lr_scale * cfg.lr_recover ** n_sub)
                w_last = float(watch[-1])
                if np.isfinite(w_last):
                    watch_ema = w_last if watch_ema is None else 0.9 * watch_ema + 0.1 * w_last

                state.iteration += n_sub
                history.extend(totals.tolist())

                last = state.iteration - 1
                every = max(1, cfg.log_every)
                if it == 0 or it // every != state.iteration // every \
                        or state.iteration >= cfg.n_iters:
                    logger.log(last, loss=float(totals[-1]), lr=float(lrs[-1]),
                               **{name: float(v[-1]) for name, v in auxs.items()})

                val = float(auxs.get(cfg.val_key, [np.nan])[-1])
                if cfg.best_val and not math.isnan(val) and val < state.best_val:
                    state.best_val = val
                    best_params = _snapshot(state.params)
                    save(".best")
                if cfg.best_key is not None:
                    if cfg.best_key != "loss" and cfg.best_key not in auxs:
                        raise KeyError(
                            f"best_key={cfg.best_key!r} is not a loss aux (have "
                            f"{sorted(auxs)}); the returned params would silently "
                            "stay at their initialization")
                    bm = float(totals[-1]) if cfg.best_key == "loss" \
                        else float(auxs[cfg.best_key][-1])
                    if not math.isnan(bm) and bm < best_metric:
                        best_metric = bm
                        best_params = _snapshot(state.params)
                        # throttle .best writes; the in-memory best is exact
                        if (state.iteration - last_best_write >= cfg.ckpt_every
                                or state.iteration >= cfg.n_iters):
                            save(".best")
                            last_best_write = state.iteration
                            best_unflushed = None
                        else:
                            best_unflushed = (
                                _map_tree(lambda t: np.array(t.detach().cpu())
                                          if isinstance(t, torch.Tensor) else t,
                                          state.as_tree()),
                                {**state.meta(), **(extra_meta or {})})

                if (probe is not None and cfg.probe_every > 0
                        and (state.iteration % cfg.probe_every < n_sub
                             or state.iteration >= cfg.n_iters)):
                    score = float(probe(state.params))
                    if math.isfinite(score) and score < best_probe:
                        best_probe = score
                        save(".stable", {"probe_score": score})
                    if not math.isfinite(score) or state.iteration >= cfg.n_iters:
                        logger.log(last, event="probe", score=score, best=best_probe)

                if cfg.ckpt_path and (state.iteration % cfg.ckpt_every < n_sub
                                      or state.iteration >= cfg.n_iters):
                    save()
    finally:
        # an improvement inside the last throttle window reaches disk too
        if best_unflushed is not None and cfg.ckpt_path:
            save_checkpoint(cfg.ckpt_path + ".best", *best_unflushed)
        if own_logger:
            logger.close()

    if cfg.best_val or cfg.best_key is not None:
        return best_params, history
    return _snapshot(state.params), history


def pretrain_isg(isg_loss_fn: Callable, params, *, n_iters: int = 4000,
                 lr: float = 0.02, log_every: int = 500, steps_per_call: int = 100,
                 logger: MetricsLogger | None = None,
                 device: str | torch.device = "cuda"):
    """Pre-fit the ISG alone against the interpolated IC (the reference's
    pretrain_upscaler: Adam, lr 0.02).  isg_loss_fn(isg_params) -> loss.
    The losses are read back every steps_per_call steps, when logged."""
    dev = resolve_device(device)
    params = _trainable(params, dev)
    opt = torch.optim.Adam(_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    it = 0
    with full_f32():
        while it < n_iters:
            n_sub = min(steps_per_call, n_iters - it)
            for _ in range(n_sub):
                opt.zero_grad(set_to_none=True)
                loss = isg_loss_fn(params)
                loss.backward()
                opt.step()
            it += n_sub
            if logger and (it % log_every < n_sub or it >= n_iters):
                logger.log(it - 1, isg_loss=float(loss.detach()))
    return _snapshot(params)
