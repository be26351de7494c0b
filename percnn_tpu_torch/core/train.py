"""Training loop: Adam with a StepLR staircase, atomic checkpoints and resume,
best-validation selection, the NaN/spike watchdog family and the stability
probe.

Counterpart of percnn_tpu/core/train.py.  One iteration is one call of
``TrainStep``: the learning rate lr * gamma^(it // lr_step) * lr_scale in
float32 from device scalars, the loss and its gradients, the Adam update
(``adam_update``, optax's ``scale_by_adam`` scaled by -lr) and the losses
written into device buffers at a device-side index, all in place over
tensors whose addresses never change.  ``steps_per_call`` iterations make a
chunk, read back by one host read, where the watchdog judges the chunk: on
CUDA (``graph=True``) the chunk replays one captured CUDA graph of the
iteration (core/graph.py), the counterpart of the JAX trainer's jit of a
scan; elsewhere, and where a caller passes ``graph=False``, the same step
runs eagerly.  Every step runs in full float32 (``_device.full_f32``).

Under a process group (parallel/spmd.py) the params may be DTensors, the
GSPMD route's counterpart, and on CUDA each rank replays its own graph of
the iteration, the collectives in it (the JAX package's jitted chunk under
GSPMD): each gradient is reduced to its parameter's placement before the
update (a replicated parameter's comes back a partial sum), and the update
writes the DTensors' local blocks in place; every host read (losses, the
watchdog's metric, the log) is made on every rank, outside the step, and
gives every rank rank 0's value, so every rank takes the same decisions;
checkpoints hold full tensors and only rank 0 writes them, then every rank
waits for the file.

The JAX trainer computes a chunk functionally and drops a failed chunk's
new params and optimizer state.  Here the step updates in place, so with
the watchdog on the trainer copies the params and the Adam state before
each chunk and copies them back when the chunk fails, before it reloads the
checkpoint (if one exists): the same replay as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable

import numpy as np
import torch

from percnn_tpu_torch import _device
from percnn_tpu_torch._device import full_f32, resolve_device
from percnn_tpu_torch.bridge import _map_tree
from percnn_tpu_torch.core.checkpoint import (
    flatten_with_paths,
    load_checkpoint,
    peek_meta,
    save_checkpoint,
)
from percnn_tpu_torch.core.graph import Replayer
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
    """Fresh leaf tensors on `dev` that require grad (the caller's stay as
    they are); a DTensor stays on its mesh."""
    def leaf(t):
        t = t.detach() if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
        return (t if _device.is_dtensor(t) else t.to(dev)).clone().requires_grad_(True)

    return _map_tree(leaf, params)


def _snapshot(tree):
    return _map_tree(lambda t: t.detach().clone(), tree)


def _grads(total: torch.Tensor, leaves: list) -> list:
    """The gradient of `total` for each leaf (zeros for a leaf it does not
    read, as in JAX); each DTensor gradient reduced to its parameter's
    placement (the JAX step's sharding constraint on the gradients)."""
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    out = []
    for p, g in zip(leaves, grads):
        g = torch.zeros_like(p) if g is None else g
        if _device.is_dtensor(p):
            g = _device.distribute(g, p.device_mesh, p.placements)
        out.append(g)
    return out


def _full_tree(tree):
    """Full tensors of a tree's DTensors (on every rank), for a checkpoint."""
    return _map_tree(lambda t: _device.full(t) if isinstance(t, torch.Tensor) else t, tree)


def _save(path: str, tree, meta: dict) -> None:
    """save_checkpoint of full tensors, by rank 0; every rank then waits
    for the file, so their next look at it agrees."""
    tree = _full_tree(tree)
    if _device.is_writer():
        save_checkpoint(path, tree, meta)
    _device.barrier()


B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.scale_by_adam's defaults


class TrainState:
    """params + Adam state + host-side schedule bookkeeping (resumable).

    The Adam state is the first and second moments of every leaf and one
    update count, as optax keeps them; it is made with the params and only
    ever written in place (a DTensor's local block too), so a captured
    graph of the step stays valid through a rollback, a fresh Adam state
    and a checkpoint load."""

    def __init__(self, params, device: torch.device):
        self.params = params
        self.leaves = _leaves(params)
        with torch.no_grad():
            self.exp_avg = [torch.zeros_like(p) for p in self.leaves]
            self.exp_avg_sq = [torch.zeros_like(p) for p in self.leaves]
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.iteration = 0
        self.lr_scale = 1.0
        self.best_val = math.inf

    def adam_update(self, grads: list, lr: torch.Tensor) -> None:
        """One Adam step in place: optax's ``scale_by_adam`` scaled by -lr,
        in torch.optim.Adam's arrangement (which the port's trainer used
        before it kept its own state): m = lerp(m, g, 1 - b1), v = b2 v +
        (1 - b2) g^2, p -= (lr / (1 - b1^t)) m / (sqrt(v) / sqrt(1 - b2^t)
        + eps), the bias corrections in float64 from the count t, and no
        host read."""
        with torch.no_grad():
            self.count.add_(1)
            torch._foreach_lerp_(self.exp_avg, grads, 1 - B1)
            torch._foreach_mul_(self.exp_avg_sq, B2)
            torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1 - B2)
            count = self.count.to(torch.float64)
            dtype = self.leaves[0].dtype   # a model's leaves share one dtype
            step_size = (lr.to(torch.float64) / (1 - B1 ** count)).to(dtype)
            den = torch._foreach_sqrt(self.exp_avg_sq)
            torch._foreach_div_(den, torch.sqrt(1 - B2 ** count).to(dtype))
            torch._foreach_add_(den, EPS)
            upd = torch._foreach_mul(self.exp_avg, step_size)
            torch._foreach_div_(upd, den)
            torch._foreach_sub_(self.leaves, upd)

    def _tree(self, values: list):
        by_leaf = {id(p): v for p, v in zip(self.leaves, values)}
        return _map_tree(lambda p: by_leaf[id(p)], self.params)

    def as_tree(self) -> dict:
        """{'params', 'opt_state': {'step', 'exp_avg', 'exp_avg_sq'}} (the
        port's own keys for the Adam moments)."""
        return {"params": self.params,
                "opt_state": {"step": np.asarray(float(self.count), np.float32),
                              "exp_avg": self._tree(self.exp_avg),
                              "exp_avg_sq": self._tree(self.exp_avg_sq)}}

    def load_tree(self, tree: dict) -> None:
        """Copy a checkpoint's tree (plain tensors) into the params and the
        Adam state, laid out as the params are."""
        opt = tree["opt_state"]
        with torch.no_grad():
            for dst, src in ((self.leaves, tree["params"]), (self.exp_avg, opt["exp_avg"]),
                             (self.exp_avg_sq, opt["exp_avg_sq"])):
                for d, v in zip(dst, _leaves(src)):
                    d.copy_(_device.local_like(v, d))
            self.count.fill_(int(float(opt["step"])))

    def snapshot(self) -> tuple:
        """Copies of the params and the Adam state, for ``restore``."""
        with torch.no_grad():
            return tuple([t.clone() for t in ts] for ts in
                         (self.leaves, self.exp_avg, self.exp_avg_sq, [self.count]))

    def restore(self, snap: tuple) -> None:
        """Copy back what ``snapshot`` copied."""
        with torch.no_grad():
            for dst, src in zip((self.leaves, self.exp_avg, self.exp_avg_sq, [self.count]), snap):
                for d, v in zip(dst, src):
                    d.copy_(v)

    def reset_opt(self) -> None:
        """Fresh Adam state: zero moments and step 0, so the bias correction
        restarts (optax's ``tx.init``)."""
        with torch.no_grad():
            for t in self.exp_avg + self.exp_avg_sq:
                t.zero_()
            self.count.zero_()

    def meta(self) -> dict:
        return {"iteration": self.iteration, "lr_scale": self.lr_scale,
                "best_val": None if math.isinf(self.best_val) else self.best_val}

    def load_meta(self, meta: dict) -> None:
        self.iteration = int(meta.get("iteration", 0))
        self.lr_scale = float(meta.get("lr_scale", 1.0))
        bv = meta.get("best_val")
        self.best_val = math.inf if bv is None else float(bv)


class TrainStep:
    """One training iteration, in place (the JAX trainer's scan body,
    percnn_tpu/core/train.py:186-196): lr = lr0 * gamma^(it // lr_step) *
    lr_scale in float32 from the device scalars ``it`` and ``lr_scale``,
    the loss and its gradients, the Adam update, and the total, the lr and
    every aux written into [n_buf] device buffers at the device index
    ``slot``; then ``it`` and ``slot`` advance.  ``begin`` sets the scalars
    for a chunk and ``read`` reads its buffers back.  The buffers are made
    at the first call, whose loss gives their names and dtypes."""

    def __init__(self, loss_fn: Callable, loss_args: tuple, state: TrainState,
                 cfg: TrainConfig, device: torch.device, n_buf: int):
        self.loss_fn, self.loss_args, self.state, self.cfg = loss_fn, loss_args, state, cfg
        self.it = torch.zeros((), dtype=torch.int64, device=device)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=device)
        self.lr_scale = torch.ones((), dtype=torch.float32, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.lrs = torch.zeros((n_buf,), dtype=torch.float32, device=device)
        self.totals = None
        self.auxs: dict = {}

    def begin(self, it: int, lr_scale: float) -> None:
        self.it.fill_(it)
        self.lr_scale.fill_(lr_scale)
        self.slot.zero_()

    def __call__(self) -> None:
        cfg, state = self.cfg, self.state
        with torch.no_grad():
            decay = torch.pow(cfg.lr_gamma, torch.div(self.it, cfg.lr_step, rounding_mode="floor")
                              .to(torch.float32))
            self.lr.copy_(cfg.lr * decay * self.lr_scale)
        total, aux = self.loss_fn(state.params, *self.loss_args)
        state.adam_update(_grads(total, state.leaves), self.lr)
        with torch.no_grad():
            values = {name: _device.full(v).detach() for name, v in aux.items()}
            total = _device.full(total).detach()
            if self.totals is None:
                n = self.lrs.shape[0]
                self.totals = self.lrs.new_zeros((n,), dtype=total.dtype)
                self.auxs = {name: self.lrs.new_zeros((n,), dtype=v.dtype)
                             for name, v in values.items()}
            for buf, v in [(self.totals, total), (self.lrs, self.lr),
                           *((self.auxs[name], v) for name, v in values.items())]:
                buf.index_copy_(0, self.slot, v.reshape(1))
            self.it.add_(1)
            self.slot.add_(1)

    def read(self, n: int) -> tuple:
        """(totals, lrs, {aux: values}) of the chunk's n iterations, float64
        numpy arrays, by one host read."""
        bufs = [self.totals, self.lrs, *self.auxs.values()]
        flat = _device.host(torch.stack([b[:n].to(torch.float64) for b in bufs]))
        return flat[0], flat[1], dict(zip(self.auxs, flat[2:]))


def train(loss_fn: Callable, params, cfg: TrainConfig, *, resume: bool = False,
          logger: MetricsLogger | None = None, extra_meta: dict | None = None,
          loss_args: tuple = (), probe: Callable | None = None,
          device: str | torch.device = "cuda", graph: bool = True) -> tuple:
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

    graph: on CUDA run each chunk by replaying a CUDA graph of one
    iteration, captured once per call after one eager warm-up iteration and
    freed on return (core/graph.py), on DTensor params too (each rank of the
    group its own graph); a step that cannot be captured raises.
    graph=False runs the same step eagerly, for callers whose loss moves
    tensors between devices within the process (``run_experiment(mesh=...)``
    without gspmd) and for comparisons.
    """
    if cfg.best_val and cfg.best_key is not None:
        raise ValueError("best_val and best_key are mutually exclusive selection "
                         "policies: they would race for best_params/.best")
    dev = resolve_device(device)
    state = TrainState(_trainable(params, dev), dev)

    def load(path: str) -> dict:
        tree, meta = load_checkpoint(path, _full_tree(state.as_tree()))
        state.load_tree(tree)
        return meta

    if resume and cfg.ckpt_path and os.path.exists(cfg.ckpt_path):
        state.load_meta(load(cfg.ckpt_path))

    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(cfg.log_path if _device.is_writer() else None,
                               echo_every=cfg.log_every if _device.is_writer() else 0)
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
            _save(cfg.ckpt_path + path_suffix, state.as_tree(),
                  {**state.meta(), **(extra_meta or {}), **(extra or {})})

    step = TrainStep(loss_fn, loss_args, state, cfg, dev, cfg.steps_per_call)
    run = Replayer(step, dev, graph)
    try:
        with full_f32():
            while state.iteration < cfg.n_iters:
                it = state.iteration
                n_sub = min(cfg.steps_per_call, cfg.n_iters - it)
                before = state.snapshot() if cfg.watchdog else None
                step.begin(it, state.lr_scale)
                for _ in range(n_sub):
                    run()
                # one host read per chunk, the same on every rank
                totals, lrs, auxs = step.read(n_sub)
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
                        load(cfg.ckpt_path)
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
                                          _full_tree(state.as_tree())),
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
        run.close()
        # an improvement inside the last throttle window reaches disk too
        if best_unflushed is not None and cfg.ckpt_path and _device.is_writer():
            save_checkpoint(cfg.ckpt_path + ".best", *best_unflushed)
        if own_logger:
            logger.close()

    if cfg.best_val or cfg.best_key is not None:
        return best_params, history
    return _snapshot(state.params), history


def pretrain_isg(isg_loss_fn: Callable, params, *, n_iters: int = 4000,
                 lr: float = 0.02, log_every: int = 500, steps_per_call: int = 100,
                 logger: MetricsLogger | None = None,
                 device: str | torch.device = "cuda", graph: bool = True):
    """Pre-fit the ISG alone against the interpolated IC (the reference's
    pretrain_upscaler: Adam, lr 0.02).  isg_loss_fn(isg_params) -> loss.
    One step is the loss, its gradients and the Adam update in place, run
    as train() runs its iteration (graphed on CUDA unless graph=False); the
    loss is read back every steps_per_call steps, when logged."""
    dev = resolve_device(device)
    state = TrainState(_trainable(params, dev), dev)
    lr_t = torch.full((), lr, dtype=torch.float32, device=dev)
    last = torch.zeros((), dtype=torch.float64, device=dev)

    def step():
        loss = isg_loss_fn(state.params)
        state.adam_update(_grads(loss, state.leaves), lr_t)
        with torch.no_grad():
            last.copy_(_device.full(loss).detach())

    run = Replayer(step, dev, graph)
    it = 0
    try:
        with full_f32():
            while it < n_iters:
                n_sub = min(steps_per_call, n_iters - it)
                for _ in range(n_sub):
                    run()
                it += n_sub
                if logger and (it % log_every < n_sub or it >= n_iters):
                    logger.log(it - 1, isg_loss=float(_device.host(last)))
    finally:
        run.close()
    return _snapshot(state.params)
