"""STRidge sparse regression (PDE-FIND family) with the reference's outer
tolerance search, must-have column protection, and Pareto sweep.

Algorithm parity with the reference trainer (Stage-2/PDE_FIND_u.py:8-182):
- column p-norm normalisation in the outer wrapper (normalize=2),
- random Bernoulli(split_ratio) train/holdout split, seed 0,
- outer loop: start at tol=d_tol; accept tol if holdout
  err_f + gamma*||w||_0 improves, then tol += d_tol; else back off
  (tol = max(0, tol - 2 d_tol), d_tol = 2 d_tol / (maxit - iter)),
- inner STRidge: ridge init (lstsq on X'X + lam I), iterative
  threshold-at-tol + refit on surviving columns, `must_have` column never
  dropped (Burgers keeps 'ones*lap_u' / index 5), final plain lstsq refit
  on the support,
- returned coefficients unnormalised via Mreg.

This is a from-scratch implementation of the published algorithm — the
structure (not the code) follows the reference.  A copy of
percnn_tpu/discovery/stridge.py (numpy only), so both packages select the
same supports from the same matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _lstsq(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.lstsq(A, b, rcond=None)[0]


def _ridge(X: np.ndarray, y: np.ndarray, lam: float) -> np.ndarray:
    if lam == 0:
        return _lstsq(X, y)
    d = X.shape[1]
    return _lstsq(X.T @ X + lam * np.eye(d), X.T @ y)


class _GramSolver:
    """Normal-equation solver over precomputed Gram matrices.

    For the tolerance/Pareto searches STRidge performs thousands of
    ridge/lstsq solves on column subsets of the same [n, d] matrix with
    n >> d (e.g. 160k x 70).  Precomputing G = X'X and b = X'y once turns
    each solve into an O(d^3) subproblem and each holdout error into an
    O(d^2) form — the full-size LO Pareto sweep drops from hours to
    seconds, bit-comparable at f64 (the reference's own ridge step already
    solves the normal equations, PDE_FIND_u.py:110-182)."""

    def __init__(self, X: np.ndarray, y: np.ndarray):
        self.n, self.d = X.shape
        self.G = X.T @ X
        self.b = X.T @ y
        self.yty = (y.T @ y).item()

    def ridge(self, lam: float, idx=None) -> np.ndarray:
        G, b = (self.G, self.b) if idx is None else \
            (self.G[np.ix_(idx, idx)], self.b[idx])
        if lam:
            G = G + lam * np.eye(len(b))
        return _lstsq(G, b)

    def mse(self, w: np.ndarray) -> float:
        """mean((y - X w)^2) via the quadratic form."""
        return ((self.yty - 2.0 * (w.T @ self.b)
                 + w.T @ (self.G @ w)) / self.n).item()


def _must_have_set(must_have) -> set:
    """Normalise the must_have argument (None | int | iterable of ints)."""
    if must_have is None:
        return set()
    if isinstance(must_have, (int, np.integer)):
        return {int(must_have)}
    return {int(i) for i in must_have}


def _stridge_inner(
    train: _GramSolver,
    lam: float,
    n_iters: int,
    tol: float,
    must_have,
) -> np.ndarray:
    """Sequential threshold ridge on an already-normalised design."""
    d = train.d
    forced = _must_have_set(must_have)
    w = train.ridge(lam)
    biginds = list(np.where(np.abs(w) > tol)[0])
    num_relevant = d
    for j in range(n_iters):
        smallinds = np.where(np.abs(w) < tol)[0]
        new_biginds = [i for i in range(d) if i not in set(smallinds)]
        missing = forced - set(new_biginds)
        if missing:
            new_biginds = sorted(new_biginds + list(missing))
        if num_relevant == len(new_biginds):
            break
        num_relevant = len(new_biginds)
        if not new_biginds:
            if j == 0:
                return w * 0.0
            break
        biginds = new_biginds
        w[smallinds] = 0
        w[biginds] = train.ridge(lam, biginds)
    if biginds:
        w_final = np.zeros_like(w)
        w_final[biginds] = train.ridge(0.0, biginds)
        return w_final
    return w


@dataclasses.dataclass
class STRidge:
    """Outer tolerance-search wrapper over the sequential-threshold core."""

    R0: np.ndarray                 # [n, d] raw design matrix
    Ut: np.ndarray                 # [n, 1] targets
    normalize: int = 2             # column p-norm (0 = off)
    split_ratio: float = 0.8
    seed: int = 0

    def __post_init__(self):
        n, d = self.R0.shape
        if self.normalize != 0:
            norms = np.linalg.norm(self.R0, self.normalize, axis=0)
            self.Mreg = (1.0 / norms).reshape(d, 1)
            R = self.R0 * self.Mreg.T
        else:
            self.Mreg = np.ones((d, 1))
            R = self.R0
        rng = np.random.RandomState(self.seed)
        mask = rng.rand(n) < self.split_ratio
        self.TrainR, self.TestR = R[mask], R[~mask]
        self.TrainY, self.TestY = self.Ut[mask], self.Ut[~mask]
        self._train = _GramSolver(self.TrainR, self.TrainY)
        self._test = _GramSolver(self.TestR, self.TestY)
        # dense initial solution: exact lstsq on X (NOT the Gram — the
        # cubic library is collinear enough that kappa(G)=kappa(X)^2
        # matters), constant across train() calls so computed once
        self._w_dense = _lstsq(self.TrainR, self.TrainY)

    def train(
        self,
        maxit: int = 100,
        stridge_iters: int = 40,
        lam: float = 0.01,
        d_tol: float = 20.0,
        l0_penalty: float | None = None,
        kappa: float = 1.0,
        must_have: "int | list[int] | None" = None,
        verbose: bool = False,
    ) -> np.ndarray:
        """Returns the de-normalised coefficient vector [d, 1]."""
        tol = d_tol
        w_best = self._w_dense.copy()
        err_f = self._test.mse(w_best)
        if l0_penalty is None:
            l0_penalty = kappa * err_f
        err_best = err_f + l0_penalty * np.count_nonzero(w_best)

        for it in range(maxit):
            w = _stridge_inner(self._train, lam, stridge_iters, tol, must_have)
            err_f = self._test.mse(w)
            err = err_f + l0_penalty * np.count_nonzero(w)
            if verbose:
                print(f"iter {it}: tol={tol:.6f} err_f={err_f:.3e} nnz={np.count_nonzero(w)}")
            if err <= err_best:
                err_best, w_best = err, w
                tol = tol + d_tol
            else:
                tol = max(0.0, tol - 2 * d_tol)
                d_tol = 2 * d_tol / (maxit - it)
                tol = tol + d_tol

        # exact (non-Gram) lstsq refit of the returned support so published
        # coefficients keep full lstsq conditioning
        support = np.where(np.abs(w_best[:, 0]) > 0)[0]
        if 0 < len(support) < self._train.d:
            w_best = np.zeros_like(w_best)
            w_best[support] = _lstsq(self.TrainR[:, support], self.TrainY)
        return self.Mreg * w_best


def discovery_metrics(w: np.ndarray, coef_true: np.ndarray) -> dict:
    """Reference evaluation (PDE_FIND_u.py:269-274): coefficient rel-L2,
    precision (identified terms that are true), recall (true terms found)."""
    w = w.reshape(-1, 1)
    coef_true = coef_true.reshape(-1, 1)
    nz_w = np.count_nonzero(w)
    nz_t = np.count_nonzero(coef_true)
    both = np.count_nonzero(w * coef_true)
    return {
        "rel_l2": float(np.linalg.norm(w - coef_true) / np.linalg.norm(coef_true)),
        "precision": float(both / nz_w) if nz_w else 0.0,
        "recall": float(both / nz_t) if nz_t else 0.0,
    }


def pareto_sweep(
    trainer: STRidge,
    *,
    gammas: np.ndarray | None = None,
    maxit: int = 20,
    stridge_iters: int = 20,
    lam: float = 1e-4,
    d_tol: float = 5.0,
    must_have: "int | list[int] | None" = None,
):
    """Sweep the l0 weight gamma = 0.01 * 1.2^i, i < 45 (LO stage-2
    PDE_FIND_u.py:297-335); returns (gammas, ls_loss, l0_count, ws)."""
    if gammas is None:
        gammas = np.array([0.01 * 1.2**i for i in range(45)])
    R_full = trainer.R0
    y_full = trainer.Ut
    ls_loss, l0_count, ws = [], [], []
    for g in gammas:
        w = trainer.train(maxit=maxit, stridge_iters=stridge_iters, lam=lam,
                          d_tol=d_tol, kappa=float(g), must_have=must_have)
        ws.append(w)
        ls_loss.append(float(np.mean((y_full - R_full @ w) ** 2)))
        l0_count.append(int(np.count_nonzero(w)))
    return np.asarray(gammas), np.asarray(ls_loss), np.asarray(l0_count), ws


def pareto_knee(ls_loss: np.ndarray, l0_count: np.ndarray) -> int:
    """Index of the Pareto-front knee of (||w||_0, LS loss).

    The reference selects gamma by eye from the front plot (LO Stage-2
    PDE_FIND_u.py:297-335 saves select_gamma_u.png) — the human picks the
    sparsest model after which the loss stops improving dramatically.

    Automated analog (elbow criterion): collapse the Pareto-efficient
    points to distinct support sizes and pick the sparsity level whose
    FURTHER sparsification causes the largest relative LS jump — removing
    a *true* term blows the loss up (the λ–Ω fronts show 14× at the
    6-term edge), while adding redundant collinear terms only shaves it
    gently (≤3×).  This is scale-free in the loss floor, which matters:
    the previous "sparsest within alpha×min(ls)" rule broke as Stage-1
    reconstructions improved — a near-perfect reconstruction drives the
    dense-solution floor *down*, so the fixed-alpha band excluded the
    true 6-term plateau (measured round 3: 0–5%-noise λ–Ω picked 10-term
    supports while γ∈[0.95, 14.7] all held the exact equation)."""
    ls = np.asarray(ls_loss, float)
    l0 = np.asarray(l0_count, float)
    eff = []
    for i in range(len(ls)):
        if l0[i] == 0:
            continue
        dominated = np.any((ls <= ls[i]) & (l0 <= l0[i])
                           & ((ls < ls[i]) | (l0 < l0[i])) & (l0 > 0))
        if not dominated:
            eff.append(i)
    if not eff:
        return int(np.argmin(ls))
    levels = {}  # support size -> index of its best (lowest-ls) point
    for i in eff:
        k = int(l0[i])
        if k not in levels or ls[i] < ls[levels[k]]:
            levels[k] = i
    order = sorted(levels, reverse=True)  # dense -> sparse
    if len(order) == 1:
        return levels[order[0]]
    best, best_ratio = order[0], -1.0
    for a, b in zip(order[:-1], order[1:]):  # a denser, b sparser
        ratio = ls[levels[b]] / max(ls[levels[a]], 1e-300)
        if ratio >= best_ratio:  # ties -> prefer the sparser elbow
            best, best_ratio = a, ratio
    return levels[best]


def pareto_select(trainer: STRidge, **sweep_kwargs):
    """Full reference LO Stage-2 protocol: gamma sweep + knee selection.

    Returns (w, info) where info carries the sweep arrays and the selected
    gamma for reporting/plotting."""
    gammas, ls_loss, l0_count, ws = pareto_sweep(trainer, **sweep_kwargs)
    i = pareto_knee(ls_loss, l0_count)
    info = {"gammas": gammas, "ls_loss": ls_loss, "l0_count": l0_count,
            "selected_gamma": float(gammas[i]), "selected_index": i}
    return ws[i], info
