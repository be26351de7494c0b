"""A PyTorch model of pg2d_batched_persistent_kernel's schedule
(csrc/batched2d.cu), on the CPU: the blocks split by member (pg_b_plan's
blocks_a_member), each block's share of its member's cells
(split_evenly), each thread's fixed (equation, hidden channel) group and
cells, its gradient sums kept over the whole sweep in place of accumulator
planes, the three passes of a reverse step with the Jacobian's shares summed
in group order, the g ping-pong that ends in g0, and the block's reduction
at the end (a butterfly of shuffles in each warp, then the warps in order,
one partial sum a block).  The model runs that ownership and that order of
summation from the same inputs as the plain sweep and is held to the plain
version's summed planes and to percnn_tpu's
``fused_rollout_tp_2d_batched_pg`` (its (M, T)-grid Pallas kernels in
interpret mode) at the gradient bars, rtol 2e-4 / atol 2e-6.  One shape
(M = 2, 16 x 16, T = 6), so the Pallas kernels compile once.  The kernel
itself runs only on the card: ``python3 chip_smoke.py`` holds it there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import batched2d as jbatched2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import backward2d, batched2d, cell2d
from percnn_tpu_torch.ops.stencils import laplacian_2d

M, N, T = 2, 16, 6
CFG = dict(ndim=2, hidden=4, kernel_size=1, dt=0.05, dx=0.2, diffusion="sigmoid",
           mu_up=0.1, init_scale=0.3)
# SMs of the modelled card: 4 gives 2 blocks a member of 128 cells, 2 cells
# a thread in pass 2; 132 gives 66 blocks a member of 3 or 4 cells
N_SMS = (4, 132)


def _kernel_schedule(packed, frames, frames_bar, cfg, n_sm):
    """(g0 [M, H, W, 2], sums [M, A]) as pg2d_batched_persistent_kernel forms
    them, and the partial sums [M, A, blocks a member]."""
    n_mem, n_steps, H, W = frames.shape[0], frames.shape[1] - 1, frames.shape[2], frames.shape[3]
    plan = batched2d.pg_b_plan(n_mem, H, W, cfg, n_sm)
    assert plan["route"] == "persistent"
    per, threads = plan["blocks_a_member"], plan["threads"]
    C, nb, cells = cfg.hidden, cfg.n_branches, H * W
    G = 2 * C
    L, warps = threads // G, threads // 32
    lay, block = backward2d._pg_layout(cfg), cell2d._param_block(cfg)
    shares = cell2d.split_evenly(cells, per)
    n_sums = 1 + 3 * nb                # w_out, dw (u, v) per branch, db per branch
    partial = torch.empty(n_mem, lay["A"], per)
    g0s = []
    for m in range(n_mem):
        p = packed[m]
        # each thread's registers, for the whole sweep
        reg_cell = torch.zeros(per, threads, 4)           # diff (2), b_out (2)
        reg_grp = torch.zeros(per, threads, n_sums)
        bufs = {"g0": torch.zeros(cells, 2), "scratch": torch.zeros(cells, 2)}
        # the groups' weights: wu, wv, wb [G, nb], wo [G]
        eqs = [p[2 + o * block: 2 + (o + 1) * block] for o in range(2)]
        brs = [pe[: nb * 3 * C].reshape(nb, 3, C) for pe in eqs]
        wu, wv, wb = (torch.cat([br[:, i].T for br in brs]) for i in range(3))
        wo = torch.cat([pe[nb * 3 * C: nb * 3 * C + C] for pe in eqs])
        for s in range(n_steps):
            t = n_steps - 1 - s
            dst, src = ("g0", "scratch") if t % 2 == 0 else ("scratch", "g0")
            h = frames[m, t]
            g_in = bufs[src].reshape(H, W, 2) + frames_bar[m, t + 1]
            lap_h = laplacian_2d(h, cfg.dx).reshape(cells, 2)
            lap_g = laplacian_2d(g_in, cfg.dx).reshape(cells, 2)
            h, g_in = h.reshape(cells, 2), g_in.reshape(cells, 2)
            # pass 1: thread tid's cells are first + tid, + tid + threads, ...
            cell_vals = torch.stack([g_in[:, 0] * lap_h[:, 0], g_in[:, 1] * lap_h[:, 1],
                                     g_in[:, 0], g_in[:, 1]], dim=-1)
            # pass 2: the (o, c, cell) items of every group, then each thread's
            u, v = h[:, 0, None, None], h[:, 1, None, None]
            g = torch.cat([g_in[:, :1].expand(cells, C), g_in[:, 1:].expand(cells, C)], 1)
            y = wu * u + wv * v + wb                                  # [cells, G, nb]
            pre = [torch.ones(cells, G)]
            for e in range(nb):
                pre.append(pre[-1] * y[..., e])
            suf = [torch.ones(cells, G)]
            for e in range(nb - 1, -1, -1):
                suf.insert(0, suf[0] * y[..., e])
            zz = torch.stack([g * (pre[e] * suf[e + 1]) for e in range(nb)], dim=-1)
            grp_vals = torch.cat([(g * pre[nb])[..., None],
                                  torch.stack([zz * u, zz * v], dim=-1).reshape(cells, G, 2 * nb),
                                  zz], dim=-1)                       # [cells, G, n_sums]
            du, dv = torch.zeros(cells, G), torch.zeros(cells, G)
            for e in range(nb):
                du = du + (wu[:, e] * wo) * zz[..., e]
                dv = dv + (wv[:, e] * wo) * zz[..., e]
            for b, (first, n_own) in enumerate(shares):
                for j in range(0, n_own, threads):
                    k = torch.arange(j, min(n_own, j + threads))
                    reg_cell[b, k - j] += cell_vals[first + k]
                for j in range(0, n_own, L):
                    k = torch.arange(j, min(n_own, j + L))
                    view = reg_grp[b].view(G, L, n_sums)
                    view[:, k - j] += grp_vals[first + k].transpose(0, 1)
            # pass 3: the shares summed in group order
            su, sv = torch.zeros(cells), torch.zeros(cells)
            for gg in range(G):
                su, sv = su + du[:, gg], sv + dv[:, gg]
            bufs[dst] = g_in + cfg.dt * (p[:2] * lap_g + torch.stack([su, sv], -1))
        g0s.append(bufs["g0"].reshape(H, W, 2))
        # the block's reduction: a butterfly in each warp, then the warps in order
        lanes = torch.arange(32)
        for b in range(per):
            x = torch.cat([reg_cell[b], reg_grp[b]], dim=-1).reshape(warps, 32, 4 + n_sums)
            for d in (16, 8, 4, 2, 1):
                x = x + x[:, lanes ^ d]
            red = x[:, 0]                                             # [warps, 5 + 3 nb]
            per_group = L // 32

            def over(w0, nw, j):
                total = torch.zeros(())
                for w in range(w0, w0 + nw):
                    total = total + red[w, j]
                return total

            for o in range(2):
                partial[m, lay["diff"] + o, b] = over(0, warps, o)
                partial[m, lay["bout"] + o, b] = over(0, warps, 2 + o)
                for c in range(C):
                    w0 = (o * C + c) * per_group
                    partial[m, lay["wout"] + o * C + c, b] = over(w0, per_group, 4)
                    for e in range(nb):
                        q = (o * nb + e) * C + c
                        for cin in range(2):
                            partial[m, lay["dw"] + 2 * q + cin, b] = over(w0, per_group,
                                                                          5 + 2 * e + cin)
                        partial[m, lay["db"] + q, b] = over(w0, per_group, 5 + 2 * nb + e)
    return torch.stack(g0s), partial.sum(-1), partial


def _leaves(p):
    return [p["diff"]] + [p["pi"][o][k] for o in range(2) for k in sorted(p["pi"][o])]


@pytest.fixture(scope="module")
def setup():
    """Per-member percnn_tpu inits (seeds 3, 4), stacked; h0 and the
    cotangent from seeds 5, 6; percnn_tpu's frames and gradients."""
    jcfg = JPiCellConfig(**CFG)
    members = [j_init_pi_cell(jax.random.PRNGKey(3 + m), jcfg) for m in range(M)]
    jp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs).astype(jnp.float32), *members)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    h0 = (0.3 * np.random.RandomState(5).standard_normal((M, N, N, 2))).astype(np.float32)
    cot = np.random.RandomState(6).standard_normal((M, T + 1, N, N, 2)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jbatched2d.fused_rollout_tp_2d_batched_pg(p, x, jcfg, T) * cot)

    jg_p, jg_h0 = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h0))
    want = [np.asarray(w) for w in _leaves(jg_p)] + [np.asarray(jg_h0)]
    return npp, h0, cot, want


def _model_grads(npp, h0, cot, n_sm):
    cfg = PiCellConfig(**CFG)
    tp = params_from_numpy(npp, device="cpu", dtype=torch.float32)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    packed = batched2d.pack_pi_params_2d_batched(tp, cfg)
    frames = batched2d.fused_rollout_2d_batched_plain(packed.detach(), torch.from_numpy(h0),
                                                      cfg, T)
    cot_t = torch.from_numpy(cot)
    with torch.no_grad():
        g0, sums, partial = _kernel_schedule(packed.detach(), frames, cot_t, cfg, n_sm)
        g0_p, acc_p = batched2d.fused_phase1_pg_2d_batched_plain(packed.detach(), frames,
                                                                 cot_t, cfg)
    d_packed = torch.stack([backward2d._pg_unpack(sums[m], packed[m].detach(), cfg)
                            for m in range(M)])
    grads = torch.autograd.grad(packed, leaves, d_packed)
    return (g0, sums, partial), (g0_p, acc_p.sum((2, 3))), list(grads) + [g0 + cot_t[:, 0]]


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_matches_the_plain_sums(setup, n_sm):
    npp, h0, cot, _ = setup
    (g0, sums, partial), (g0_p, sums_p), _ = _model_grads(npp, h0, cot, n_sm)
    per = batched2d.pg_b_plan(M, N, N, PiCellConfig(**CFG), n_sm)["blocks_a_member"]
    assert tuple(partial.shape) == (M, backward2d._pg_layout(PiCellConfig(**CFG))["A"], per)
    assert per == min(n_sm // M, N * N)
    np.testing.assert_allclose(g0.numpy(), g0_p.numpy(), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(sums.numpy(), sums_p.numpy(), rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_gives_percnn_tpu_gradients(setup, n_sm):
    """The parameter gradients from the model's sums (unpacked per member and
    pulled back through the packing) and h0's from its g0, against
    percnn_tpu's batched pg route in interpret mode."""
    npp, h0, cot, want = setup
    _, _, grads = _model_grads(npp, h0, cot, n_sm)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-6)
