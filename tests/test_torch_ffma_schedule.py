"""PyTorch models of the one-launch FFMA kernels of a k x k cell, on the CPU:
rollout2d_ffma_persistent_kernel (csrc/cell2d_ffma.cu) and
adj2d_ys_persistent_kernel (csrc/adj2d.cu).  Each model runs the kernel's
schedule and lane layout with tensor ops: the blocks' runs of cells
(split_evenly, the kernels' share_of), the rounds of 16-cell tiles, the
operands packed in the kernels' lane order (cell2d.pack_ffma_fwd_2d,
pack_ffma_adj_2d, pack_ffma_tail_2d) and read at the indices the kernels
read them, and for the sweep phase A, then phase B, the two zw buffers and
one barrier a step, the blocks run one after another in the live buffers, so
a block that read what another wrote in the same step would see a
different value, or NaN, which every buffer holds until it is written.  The
models are held to the plain versions (fused_rollout_2d_plain,
fused_phase1_ys_2d_plain) at the bars chip_smoke.py holds the kernels to.
The kernels themselves run only on the card.  No JAX here."""

import dataclasses

import numpy as np
import pytest
import torch

from percnn_tpu_torch.core.cell import init_pi_cell
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1
from percnn_tpu_torch.ops.kernels import backward2d, cell2d

BURGERS = BURGERS_STAGE1.cell   # 5x5, C = 16, 3 branches


def _cfg(k=5, nb=3, hidden=16):
    return dataclasses.replace(BURGERS, kernel_size=k, n_branches=nb, hidden=hidden)


def _packed(cfg, seed=0):
    """The packed vector of a random-init cell."""
    params = init_pi_cell(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return cell2d.pack_pi_params_2d(params, cfg)


def _field(H, W, seed):
    return torch.as_tensor(0.5 * np.random.RandomState(seed).standard_normal((H, W, 2)),
                           dtype=torch.float32)


def _neighbour(flat, H, W, idx, di, dj):
    """flat [H W, ...] at the cells idx shifted by (di, dj), wrapped."""
    i, j = idx // W, idx % W
    return flat[((i + di) % H) * W + (j + dj) % W]


def _lap(flat, H, W, idx, inv_dx2):
    """The kernels' 4th-order Laplacian of flat [H W, ...] at the cells idx."""
    at = lambda di, dj: _neighbour(flat, H, W, idx, di, dj)   # noqa: E731
    s1 = at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1)
    s2 = at(2, 0) + at(-2, 0) + at(0, 2) + at(0, -2)
    return (-5.0 * at(0, 0) + (4.0 / 3.0) * s1 - (1.0 / 12.0) * s2) * inv_dx2


def _im2col(flat, H, W, idx, k):
    """[taps, len(idx)]: tap q = (ki k + kj) 2 + cin of each cell, as the
    kernel's im2col stack (kxk_mma::tap_base + tap_offset)."""
    r = k // 2
    return torch.stack([_neighbour(flat, H, W, idx, ki - r, kj - r)[:, cin]
                        for ki in range(k) for kj in range(k) for cin in range(2)])


def ffma_forward_step(h, wf, tail, cfg, n_sm):
    """One step of rollout2d_ffma_persistent_kernel: each block of ffma_grid,
    each round, warp (tile tl, equation o), lane (pair p, group g) as the
    kernel computes them.  Returns the next state; a cell no lane writes
    stays NaN."""
    H, W = h.shape[:2]
    k, nb = cfg.kernel_size, cfg.n_branches
    taps = k * k * 2
    grid = cell2d.ffma_grid(H, W, n_sm)
    rc, tiles = grid["rc"], grid["threads"] // 64
    flat = h.reshape(H * W, 2)
    out = torch.full((H * W, 2), float("nan"))
    for first, n_own in cell2d.split_evenly(H * W, grid["blocks"]):
        for base in range(0, n_own, rc):
            xs = _im2col(flat, H, W, first + torch.clamp(base + torch.arange(rc), max=n_own - 1),
                         k)                                              # [taps, rc]
            x = xs.reshape(taps, tiles, 4, 4)                            # [q, tl, g, m]
            for o in range(2):
                w = wf[:, o].permute(0, 2, 1, 3).reshape(taps + 1, 8, -1)   # [q, p, f]
                acc = w[taps][None, None, None] + torch.einsum("qpf,qtgm->tgmpf", w[:taps], x)
                acc = acc[..., :2 * nb].unflatten(-1, (2, nb))           # [tl, g, m, p, cl, i]
                w_out = tail[2 + 16 * o: 18 + 16 * o].reshape(8, 2)      # [p, cl]
                p = (w_out * acc.prod(-1)).sum(-1).sum(-1)               # [tl, g, m]
                kk = base + torch.arange(rc).reshape(tiles, 4, 4)        # the lanes' cells
                mine = kk < n_own
                idx = first + kk[mine]
                lap = _lap(flat[:, o], H, W, idx, 1.0 / cfg.dx ** 2)
                pi = p[mine] + tail[34 + o]
                out[idx, o] = flat[idx, o] + cfg.dt * (tail[o] * lap + pi)
    return out.reshape(H, W, 2)


@pytest.mark.parametrize("H, W, n_sm", [(17, 9, 7), (8, 10, 7), (32, 32, 7), (12, 12, 132),
                                        (20, 24, 1)])
@pytest.mark.parametrize("k, nb, hidden", [(5, 3, 16), (3, 2, 5), (5, 4, 8), (3, 1, 16)])
def test_forward_model_matches_plain(H, W, n_sm, k, nb, hidden):
    """Three steps of the forward's model from the packed operand: every cell
    written once a step, the frames at the forward bars of the plain
    version (n_sm = 1 and 7 make a block span rows and take several rounds)."""
    cfg = _cfg(k, nb, hidden)
    packed = _packed(cfg)
    wf, tail = cell2d.pack_ffma_fwd_2d(packed, cfg), cell2d.pack_ffma_tail_2d(packed, cfg)
    h = _field(H, W, 1)
    want = cell2d.fused_rollout_2d_plain(packed, h, cfg, 3)
    for s in range(3):
        h = ffma_forward_step(h, wf, tail, cfg, n_sm)
        assert not torch.isnan(h).any()
        torch.testing.assert_close(h, want[s + 1], rtol=2e-4, atol=1e-5)


def ys_sweep_model(packed, frames_bar, ys, cfg, n_sm, order=1):
    """adj2d_ys_persistent_kernel's schedule: per iteration s (t = T - 1 - s),
    each block (in `order`: 1 forward, -1 reversed) runs phase A (the gather
    of step t + 1 from zw and g_ins at the neighbours, then g_in into its
    shared memory and g_ins[t]) and phase B (z of its cells from ys[t],
    which the previous iteration copied into buffer s & 1, and zw_t into
    buffer s & 1) in the live buffers; then the barrier.  After the loop,
    step 0's gather gives g_0.  Returns (g_ins, g0)."""
    T, H, W = frames_bar.shape[0] - 1, frames_bar.shape[1], frames_bar.shape[2]
    k, nb, C = cfg.kernel_size, cfg.n_branches, cfg.hidden
    taps, M, r = k * k * 2, 2 * nb * C, cell2d._ffma_adj_taps(cfg)
    grid = cell2d.ffma_grid(H, W, n_sm)
    rc, tiles = grid["rc"], grid["threads"] // 64
    wa = cell2d.pack_ffma_adj_2d(packed, cfg)                   # [M, h, tg, 4]
    wt = wa.permute(0, 2, 1, 3).reshape(M, 8, -1)[..., :r]      # [m, tg, j]
    tail = cell2d.pack_ffma_tail_2d(packed, cfg)
    w_out = tail[2:34].reshape(2, 16)
    inv_dx2 = 1.0 / cfg.dx ** 2
    nan = float("nan")
    zw = torch.full((2, taps, H * W), nan)
    g_ins = torch.full((T, H * W, 2), nan)
    fb = frames_bar.reshape(T + 1, H * W, 2)
    ysf = ys.reshape(T, M, H * W)
    shares = cell2d.split_evenly(H * W, grid["blocks"])[::order]
    gin = {first: None for first, _ in shares}                   # each block's shared memory
    ybuf = {first: [None, None] for first, _ in shares}
    rr = k // 2

    def gather(t, zsrc, idx, c):
        jt = sum(_neighbour(zsrc[(ki * k + kj) * 2 + c], H, W, idx, rr - ki, rr - kj)
                 for ki in range(k) for kj in range(k))
        lap_parts = [_neighbour(g_ins[t][:, c], H, W, idx, di, dj)
                     for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1))]
        far = [_neighbour(g_ins[t][:, c], H, W, idx, di, dj)
               for di, dj in ((2, 0), (-2, 0), (0, 2), (0, -2))]
        return lap_parts, far, jt

    for first, n_own in shares:
        own = torch.arange(first, first + n_own)
        ybuf[first][0] = ysf[T - 1][:, own].clone()
    for s in range(T):
        t = T - 1 - s
        for first, n_own in shares:
            own = torch.arange(first, first + n_own)
            if t > 0:
                ybuf[first][(s + 1) % 2] = ysf[t - 1][:, own].clone()
            # A
            g = torch.empty(n_own, 2)
            for c in range(2):
                v = fb[t + 1][own, c].clone()
                if s > 0:
                    near, far, jt = gather(t + 1, zw[(s + 1) % 2], own, c)
                    ctr = gin[first][:, c]
                    lap = (-5.0 * ctr + (4.0 / 3.0) * sum(near) - (1.0 / 12.0) * sum(far)) * inv_dx2
                    v = v + (ctr + cfg.dt * (tail[c] * lap + jt))
                g[:, c] = v
            gin[first] = g
            g_ins[t][own] = g
            # B
            yb = ybuf[first][s % 2]                                  # [M, n_own]
            for base in range(0, n_own, rc):
                kk = base + torch.arange(rc)
                mine = kk < n_own
                kc = torch.clamp(kk, max=n_own - 1)
                y = yb[:, kc].reshape(2, nb, C, rc)
                others = backward2d._leave_one_out_prod(y, 1)
                z = (w_out[:, :C, None] * gin[first][kc].T[:, None])[:, None] * others
                z = torch.where(mine, z, torch.zeros(()))
                zt = z.reshape(M, tiles, 4, 4)                       # [m, tl, g, e]
                acc = torch.einsum("mqj,mtge->tgeqj", wt, zt)        # both equations' rows
                q = torch.arange(8)[:, None] * r + torch.arange(r)   # [tg, j]
                cells = kk.reshape(tiles, 4, 4)
                for tl in range(tiles):
                    for gg in range(4):
                        for e in range(4):
                            if cells[tl, gg, e] < n_own:
                                valid = q < taps
                                zw[s % 2, q[valid], first + cells[tl, gg, e]] = acc[tl, gg, e][valid]
    g0 = torch.empty(H * W, 2)
    for first, n_own in shares:
        own = torch.arange(first, first + n_own)
        for c in range(2):
            near, far, jt = gather(0, zw[(T - 1) % 2], own, c)
            ctr = gin[first][:, c]
            lap = (-5.0 * ctr + (4.0 / 3.0) * sum(near) - (1.0 / 12.0) * sum(far)) * inv_dx2
            g0[own, c] = ctr + cfg.dt * (tail[c] * lap + jt)
    return g_ins.reshape(T, H, W, 2), g0.reshape(H, W, 2)


@pytest.mark.parametrize("H, W, n_sm", [(17, 9, 7), (8, 10, 7), (32, 32, 7), (16, 12, 132)])
@pytest.mark.parametrize("k, nb, hidden", [(5, 3, 16), (3, 2, 6)])
def test_ys_sweep_model_matches_plain(H, W, n_sm, k, nb, hidden):
    """The sweep's model on a 6-step rollout's frames and ys, a
    standard-normal cotangent: g_ins and g0 at the backward bar of the plain
    sweep, every value written before it is read, whichever order the
    blocks run in within a step, and the same bits in either order."""
    cfg = _cfg(k, nb, hidden)
    packed = _packed(cfg, seed=1)
    params = init_pi_cell(torch.Generator().manual_seed(1), cfg, device="cpu")
    frames = cell2d.fused_rollout_2d_plain(packed, _field(H, W, 2), cfg, 6)
    ys = backward2d._precompute_ys(params, frames[:-1], cfg)
    fbar = torch.as_tensor(np.random.RandomState(3).standard_normal(tuple(frames.shape)),
                           dtype=torch.float32)
    want = backward2d.fused_phase1_ys_2d_plain(packed, fbar, ys, cfg)
    got = ys_sweep_model(packed, fbar, ys, cfg, n_sm)
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max()) + 2e-6
    for a, b in zip(ys_sweep_model(packed, fbar, ys, cfg, n_sm, order=-1), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("H, W, n_sm", [(100, 100, 132), (17, 9, 132), (32, 32, 7),
                                        (1000, 1000, 132), (148, 148, 132)])
def test_every_lane_writes_its_cells_once(H, W, n_sm):
    """The forward's output lanes (pairs 0..3 of each group, round by round)
    and the sweep's (group g, its 4 cells) cover each block's cells once,
    and the im2col threads (cell xc of a round, taps xq0, xq0 + 4, ...) fill
    every (tap, cell) entry of a round once (blockDim = 4 rc)."""
    grid = cell2d.ffma_grid(H, W, n_sm)
    rc, threads = grid["rc"], grid["threads"]
    assert threads == 4 * rc and threads % 64 == 0 and threads <= 512
    lanes = np.arange(threads)
    warp, lane = lanes // 32, lanes % 32
    tl, pair, grp = warp // 2, lane // 4, lane % 4
    fwd_cells = (tl * 16 + grp * 4 + pair)[(pair < 4) & (warp % 2 == 0)]
    assert sorted(fwd_cells) == list(range(rc))
    taps = 50
    filled = np.zeros((taps, rc), dtype=int)
    for x in lanes:
        for q in range(x // rc, taps, 4):
            filled[q, x % rc] += 1
    assert (filled == 1).all()
    for _, n_own in cell2d.split_evenly(H * W, grid["blocks"]):
        assert n_own <= grid["cap"]
        written = np.zeros(n_own, dtype=int)
        for base in range(0, n_own, rc):
            kk = base + fwd_cells
            np.add.at(written, kk[kk < n_own], 1)
        assert (written == 1).all()
