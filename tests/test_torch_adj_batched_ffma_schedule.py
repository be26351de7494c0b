"""A PyTorch model of adj2d_batched_ffma_persistent_kernel's schedule (the
ensemble's k x k streaming sweep in one cooperative launch,
csrc/batched2d.cu), on the CPU: adj_b_plan's split of the blocks by member
(n_sm // M blocks a member), each block's run of its member's cells
(split_evenly), the rounds of 16-cell tiles, each member's operands packed
in the kernel's lane order (cell2d.pack_ffma_fwd_2d, pack_ffma_adj_2d,
pack_ffma_tail_2d) and read at the indices the kernel reads them: phase A
(step t + 1's gather from zw and g_ins at the neighbours, then g_in into
the block's shared memory and g_ins[t]), then per round the im2col stack of
frame t, the forward's product y = Wf im2col + b in its lanes, z of each
lane's channels and branches into Z, and the adjoint's product zw^T =
Wtaps^T Z, the o = 0 warps' rows plus the o = 1 warps', into the member's
zw buffer s & 1; one barrier a step, step 0's gather into g0 after the
loop.  The blocks run one after another in live buffers, each filled with
NaN until it is written, so a block that read what another wrote in the
same step would see a different value, or NaN.  The model is held to the
plain sweep (fused_phase1_2d_batched_plain) and to percnn_tpu's
``_fused_phase1_b`` (its (M, T)-grid Pallas kernel in interpret mode) at the
gradient bars, rtol 2e-4 / atol 2e-6.  One shape (M = 2, k = 5, 16 x 16,
T = 4), so the Pallas kernel compiles once.  The kernel itself runs only on
the card: ``python3 chip_smoke.py`` holds it there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import batched2d as jbatched2d
from percnn_tpu.ops.pallas import cell2d as jcell2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import backward2d, batched2d, cell2d

M, N, T = 2, 16, 4
RTOL, ATOL = 2e-4, 2e-6
CFG = dict(ndim=2, hidden=4, kernel_size=5, dt=0.05, dx=0.5, diffusion="sigmoid",
           mu_up=0.1, init_scale=0.3)
# SMs of the modelled card: 2 (one block a member: 256 cells, two rounds of
# 128), 7 (3 blocks a member of 85 or 86 cells, one round of 96; one SM
# idle) and 132 (66 blocks a member of 3 or 4 cells, a round of one tile)
N_SMS = (2, 7, 132)


def _neighbour(flat, W, H, idx, di, dj):
    """flat [H W, ...] at the cells idx shifted by (di, dj), wrapped."""
    i, j = idx // W, idx % W
    return flat[((i + di) % H) * W + (j + dj) % W]


def batched_ffma_model(packed, frames, frames_bar, cfg, n_sm, order=1):
    """(g_ins [M, T, H, W, 2], g0 [M, H, W, 2]) as
    adj2d_batched_ffma_persistent_kernel forms them, the blocks of a step
    (every member's) run one after another (order 1) or in reverse."""
    n_mem, n_steps, H, W = frames.shape[0], frames.shape[1] - 1, frames.shape[2], frames.shape[3]
    plan = batched2d.adj_b_plan(n_mem, H, W, cfg, n_sm)
    assert plan["route"] == "persistent"
    per = plan["blocks_a_member"]
    grid = backward2d.adj_b_grid(H, W, per)
    rc, tiles = grid["rc"], grid["threads"] // 64
    assert grid["threads"] == plan["threads"]
    k, nb, C = cfg.kernel_size, cfg.n_branches, cfg.hidden
    taps, rows, r, rr = k * k * 2, 2 * nb * C, cell2d._ffma_adj_taps(cfg), k // 2
    cells = H * W
    inv_dx2 = 1.0 / cfg.dx ** 2
    nan = float("nan")
    ops = []
    for m in range(n_mem):
        wf = cell2d.pack_ffma_fwd_2d(packed[m], cfg)
        wa = cell2d.pack_ffma_adj_2d(packed[m], cfg)
        ops.append({"wf": [wf[:, o].permute(0, 2, 1, 3).reshape(taps + 1, 8, -1)
                           for o in range(2)],                          # [q, p, f]
                    "wt": wa.permute(0, 2, 1, 3).reshape(rows, 8, -1)[..., :r],   # [m, tg, j]
                    "tail": cell2d.pack_ffma_tail_2d(packed[m], cfg)})
    zw = torch.full((n_mem, 2, taps, cells), nan)
    g_ins = torch.full((n_mem, n_steps, cells, 2), nan)
    g0 = torch.full((n_mem, cells, 2), nan)
    blocks = [(m, first, n_own) for m in range(n_mem)
              for first, n_own in cell2d.split_evenly(cells, per)][::order]
    gin = {}                                                         # each block's shared g_in

    def gather(m, t, zsrc, own, ctr, c):
        jt = sum(_neighbour(zsrc[(ki * k + kj) * 2 + c], W, H, own, rr - ki, rr - kj)
                 for ki in range(k) for kj in range(k))
        at = lambda di, dj: _neighbour(g_ins[m, t][:, c], W, H, own, di, dj)   # noqa: E731
        s1 = at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1)
        s2 = at(2, 0) + at(-2, 0) + at(0, 2) + at(0, -2)
        lap = (-5.0 * ctr + (4.0 / 3.0) * s1 - (1.0 / 12.0) * s2) * inv_dx2
        return ctr + cfg.dt * (ops[m]["tail"][c] * lap + jt)

    for s in range(n_steps):
        t = n_steps - 1 - s
        for m, first, n_own in blocks:
            op, own = ops[m], torch.arange(first, first + n_own)
            # A
            g = torch.empty(n_own, 2)
            for c in range(2):
                v = frames_bar[m, t + 1].reshape(cells, 2)[own, c].clone()
                if s > 0:
                    v = v + gather(m, t + 1, zw[m, (s + 1) % 2], own,
                                   gin[(m, first)][:, c], c)
                g[:, c] = v
            gin[(m, first)] = g
            g_ins[m, t, own] = g
            # B
            flat = frames[m, t].reshape(cells, 2)
            for base in range(0, n_own, rc):
                kk = base + torch.arange(rc)
                mine = kk < n_own
                kc = first + torch.clamp(kk, max=n_own - 1)
                xs = torch.stack([_neighbour(flat, W, H, kc, ki - rr, kj - rr)[:, cin]
                                  for ki in range(k) for kj in range(k) for cin in range(2)])
                x = xs.reshape(taps, tiles, 4, 4)                         # [q, tl, g, e]
                z = torch.zeros(rows, rc)
                for o in range(2):
                    w = op["wf"][o]
                    acc = w[taps][None, None, None] + torch.einsum("qpf,qtge->tgepf", w[:taps], x)
                    y = acc[..., :2 * nb].unflatten(-1, (2, nb))         # [tl, g, e, p, cl, i]
                    y = y.reshape(rc, 16, nb)[:, :C]                     # [cell, c, i]
                    others = backward2d._leave_one_out_prod(y, -1)
                    gw = op["tail"][2 + 16 * o: 2 + 16 * o + C] * gin[(m, first)][
                        torch.clamp(kk, max=n_own - 1), o][:, None]      # [cell, c]
                    zo = torch.where(mine[:, None, None], gw[..., None] * others,
                                     torch.zeros(()))
                    z[o * nb * C:(o + 1) * nb * C] = zo.permute(2, 1, 0).reshape(nb * C, rc)
                zt = z.reshape(rows, tiles, 4, 4)                          # [m, tl, g, e]
                half = nb * C
                parts = [torch.einsum("mqj,mtge->tgeqj", op["wt"][o * half:(o + 1) * half],
                                      zt[o * half:(o + 1) * half]) for o in range(2)]
                acc = parts[0] + parts[1]                                  # [tl, g, e, q, j]
                q = torch.arange(8)[:, None] * r + torch.arange(r)        # [tg, j]
                valid = q < taps
                out = acc.reshape(rc, 8, r)
                for col in range(rc):
                    if mine[col]:
                        zw[m, s % 2, q[valid], first + base + col] = out[col][valid]
    for m, first, n_own in blocks:
        own = torch.arange(first, first + n_own)
        for c in range(2):
            g0[m, own, c] = gather(m, 0, zw[m, (n_steps - 1) % 2], own, gin[(m, first)][:, c], c)
    return g_ins.reshape(n_mem, n_steps, H, W, 2), g0.reshape(n_mem, H, W, 2)


def _assert_at_bar(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * float(np.abs(np.asarray(want)).max()))


@pytest.fixture(scope="module")
def setup():
    """Per-member percnn_tpu inits (seeds 7, 8), stacked; h0 and a
    standard-normal cotangent from seeds 9, 10; the frames of the plain
    batched rollout; percnn_tpu's _fused_phase1_b on them."""
    jcfg = JPiCellConfig(**CFG)
    members = [j_init_pi_cell(jax.random.PRNGKey(7 + m), jcfg) for m in range(M)]
    jp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs).astype(jnp.float32), *members)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    cfg = PiCellConfig(**CFG)
    packed = batched2d.pack_pi_params_2d_batched(params_from_numpy(npp, device="cpu"), cfg)
    h0 = torch.as_tensor(0.5 * np.random.RandomState(9).standard_normal((M, N, N, 2)),
                         dtype=torch.float32)
    frames = batched2d.fused_rollout_2d_batched_plain(packed, h0, cfg, T)
    fbar = torch.as_tensor(np.random.RandomState(10).standard_normal((M, T + 1, N, N, 2)),
                           dtype=torch.float32)
    frames_pad = jnp.stack([jnp.stack([jcell2d.pad_state_2d(jnp.asarray(f.numpy()))
                                       for f in frames[m, :-1]]) for m in range(M)])
    hp, wp = frames_pad.shape[3], frames_pad.shape[4]
    fbar_pad = jnp.zeros((M, T, 2, hp, wp), jnp.float32).at[:, :, :, 2:2 + N, 2:2 + N].set(
        jnp.moveaxis(jnp.asarray(fbar[:, 1:].numpy()), -1, 2))
    packed_j = jax.vmap(lambda p: jcell2d.pack_pi_params_2d(p, jcfg))(jp)
    gins_j, g0_j = jbatched2d._fused_phase1_b(packed_j, frames_pad, fbar_pad, cfg=jcfg,
                                              n_steps=T, H=N, W=N, interpret=True)
    want_j = (np.moveaxis(np.asarray(gins_j)[:, :, :, 2:2 + N, 2:2 + N], 2, -1),
              np.moveaxis(np.asarray(g0_j)[:, :, 2:2 + N, 2:2 + N], 1, -1))
    return cfg, packed, frames, fbar, want_j


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_matches_the_plain_sweep(setup, n_sm):
    """g_ins and g0 of every member at the gradient bars of the plain sweep,
    every entry written (no NaN left), whichever order the blocks of a step
    run in, and the same bits in either order."""
    cfg, packed, frames, fbar, _ = setup
    got = batched_ffma_model(packed, frames, fbar, cfg, n_sm)
    want = batched2d.fused_phase1_2d_batched_plain(packed, frames, fbar, cfg)
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        _assert_at_bar(a, b)
    for a, b in zip(batched_ffma_model(packed, frames, fbar, cfg, n_sm, order=-1), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_gives_percnn_tpu_sweep(setup, n_sm):
    cfg, packed, frames, fbar, want_j = setup
    got = batched_ffma_model(packed, frames, fbar, cfg, n_sm)
    assert got[0].shape == (M, T, N, N, 2) and got[1].shape == (M, N, N, 2)
    for a, b in zip(got, want_j):
        _assert_at_bar(a, b)
