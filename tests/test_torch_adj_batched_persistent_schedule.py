"""A PyTorch model of adj2d_batched_persistent_kernel's schedule (every
member's 1x1 streaming sweep in one cooperative launch, csrc/batched2d.cu
and adj2d_step.cuh's persistent_sweep with the member axis), on the CPU:
adj1_b_plan's split of the blocks by member (n_sm // M blocks a member),
each block's share of its member's cells (split_evenly), its row of the
[M, P] parameter table, the three passes of a reverse step (g_in at the
9-point cross and its Laplacian, the (equation, hidden channel, cell)
items' shares of the Jacobian's transpose, the shares summed in (o, c)
order), g_in streamed to the member's g_ins[t], and each member's g
ping-pong that makes step 0 write its g0.  The blocks of a step (every
member's) run one after another in live buffers (g_ins filled with NaN
until written, the g buffers with the wrapper's zeros), so a block that
read what another wrote in the same step would read a different value.
The model is held to the plain sweep (fused_phase1_2d_batched_plain) and to
percnn_tpu's ``_fused_phase1_b`` (its (M, T)-grid Pallas kernel in
interpret mode) at the gradient bars, rtol 2e-4 / atol 2e-6, and each
member to the single model's schedule (test_torch_adj_persistent_schedule)
on that member, to the bit: a cell's arithmetic does not depend on the
split.  One shape (M = 2, 16 x 16, T = 5), so the Pallas kernel compiles
once.  The kernel itself runs only on the card: ``python3 chip_smoke.py``
holds it there, each member's g0 and g_ins to adj2d_persistent_kernel's to
the bit."""

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
from percnn_tpu_torch.ops.kernels import batched2d, cell2d
from test_torch_adj_persistent_schedule import CROSS, _lap5, adj_persistent_model

M, N, T = 2, 16, 5
RTOL, ATOL = 2e-4, 2e-6
CFG = dict(ndim=2, hidden=4, kernel_size=1, dt=0.05, dx=0.2, diffusion="sigmoid",
           mu_up=0.1, init_scale=0.3)
# SMs of the modelled card: 2 (one block a member: 256 cells), 7 (3 blocks
# a member of 85 or 86 cells, runs that span rows; one SM idle) and 40 (20
# blocks a member of 12 or 13 cells)
N_SMS = (2, 7, 40)


def _block_step(p, cfg, h, fbar, src, dst, g_ins_t, first, n_own, W, H):
    """One block's three passes at reverse step t on its member's buffers:
    p its member's packed row, h frame t and fbar the cotangent of frame
    t + 1 ([H W, 2]), src g_{t+1} and dst g_t (live), g_ins_t its g_ins[t]."""
    C, nb = cfg.hidden, cfg.n_branches
    block, stride = cell2d._param_block(cfg), 3 * C
    own = torch.arange(first, first + n_own)
    i, j = own // W, own % W
    nbr = [((i + di) % H) * W + (j + dj) % W for di, dj in CROSS]
    # pass 1
    gs = [src[n] + fbar[n] for n in nbr]
    g_in, lap_g = gs[0], _lap5(gs, 1.0 / (cfg.dx * cfg.dx))
    u, v = h[own, 0], h[own, 1]
    g_ins_t[own] = g_in
    # pass 2: each (o, c) group's share of the Jacobian's transpose
    parts = []
    for o in range(2):
        q = p[2 + o * block: 2 + (o + 1) * block]
        for c in range(C):
            y = [q[e * stride + c] * u + q[e * stride + C + c] * v + q[e * stride + 2 * C + c]
                 for e in range(nb)]
            pre, suf = [torch.ones(n_own)], [torch.ones(n_own)]
            for e in range(nb):
                pre.append(pre[-1] * y[e])
            for e in range(nb - 1, -1, -1):
                suf.insert(0, suf[0] * y[e])
            wo = q[nb * stride + c]
            du, dv = torch.zeros(n_own), torch.zeros(n_own)
            for e in range(nb):
                zz = g_in[:, o] * (pre[e] * suf[e + 1])
                du = du + (q[e * stride + c] * wo) * zz
                dv = dv + (q[e * stride + C + c] * wo) * zz
            parts.append((du, dv))
    # pass 3: the shares summed in (o, c) order
    su, sv = torch.zeros(n_own), torch.zeros(n_own)
    for du, dv in parts:
        su, sv = su + du, sv + dv
    dst[own] = torch.stack([g_in[:, 0] + cfg.dt * (p[0] * lap_g[:, 0] + su),
                            g_in[:, 1] + cfg.dt * (p[1] * lap_g[:, 1] + sv)], dim=-1)


def batched_persistent_model(packed, frames, frames_bar, cfg, n_sm, order=1):
    """(g_ins [M, T, H, W, 2], g0 [M, H, W, 2]) as
    adj2d_batched_persistent_kernel forms them, the blocks of a step (every
    member's) run one after another (order 1) or in reverse (order -1)."""
    n_mem, n_steps, H, W = frames.shape[0], frames.shape[1] - 1, frames.shape[2], frames.shape[3]
    plan = batched2d.adj1_b_plan(n_mem, H, W, cfg, n_sm)
    assert plan["route"] == "persistent"
    per, cells = plan["blocks_a_member"], H * W
    assert plan["blocks"] == n_mem * per <= n_sm
    bufs = {"g0": torch.zeros(n_mem, cells, 2), "scratch": torch.zeros(n_mem, cells, 2)}
    g_ins = torch.full((n_mem, n_steps, cells, 2), float("nan"))
    blocks = [(m, first, n_own) for m in range(n_mem)
              for first, n_own in cell2d.split_evenly(cells, per)][::order]
    for s in range(n_steps):
        t = n_steps - 1 - s
        dst, src = ("g0", "scratch") if t % 2 == 0 else ("scratch", "g0")
        for m, first, n_own in blocks:
            _block_step(packed[m], cfg, frames[m, t].reshape(cells, 2),
                        frames_bar[m, t + 1].reshape(cells, 2), bufs[src][m], bufs[dst][m],
                        g_ins[m, t], first, n_own, W, H)
    return g_ins.reshape(n_mem, n_steps, H, W, 2), bufs["g0"].reshape(n_mem, H, W, 2)


def _assert_at_bar(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * float(np.abs(np.asarray(want)).max()))


@pytest.fixture(scope="module")
def setup():
    """Per-member percnn_tpu inits (seeds 3, 4), stacked; h0 and a
    standard-normal cotangent from seeds 5, 6; the frames of the plain
    batched rollout; percnn_tpu's _fused_phase1_b on them."""
    jcfg = JPiCellConfig(**CFG)
    members = [j_init_pi_cell(jax.random.PRNGKey(3 + m), jcfg) for m in range(M)]
    jp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs).astype(jnp.float32), *members)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    cfg = PiCellConfig(**CFG)
    packed = batched2d.pack_pi_params_2d_batched(params_from_numpy(npp, device="cpu"), cfg)
    h0 = torch.as_tensor(0.5 + 0.2 * np.random.RandomState(5).standard_normal((M, N, N, 2)),
                         dtype=torch.float32)
    frames = batched2d.fused_rollout_2d_batched_plain(packed, h0, cfg, T)
    fbar = torch.as_tensor(np.random.RandomState(6).standard_normal((M, T + 1, N, N, 2)),
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
    got = batched_persistent_model(packed, frames, fbar, cfg, n_sm)
    want = batched2d.fused_phase1_2d_batched_plain(packed, frames, fbar, cfg)
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        _assert_at_bar(a, b)
    for a, b in zip(batched_persistent_model(packed, frames, fbar, cfg, n_sm, order=-1), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_gives_percnn_tpu_sweep(setup, n_sm):
    cfg, packed, frames, fbar, want_j = setup
    got = batched_persistent_model(packed, frames, fbar, cfg, n_sm)
    assert got[0].shape == (M, T, N, N, 2) and got[1].shape == (M, N, N, 2)
    for a, b in zip(got, want_j):
        _assert_at_bar(a, b)


@pytest.fixture(scope="module")
def single(setup):
    """The single model's one-launch schedule on each member alone, on 3
    blocks."""
    cfg, packed, frames, fbar, _ = setup
    return [adj_persistent_model(packed[m], frames[m], fbar[m], cfg, 3) for m in range(M)]


@pytest.mark.parametrize("n_sm", N_SMS)
def test_each_member_is_the_single_models_sweep_to_the_bit(setup, single, n_sm):
    """Member m's g_ins and g0 equal the single model's one-launch schedule
    on member m alone (on 3 blocks, against n_sm // M here), bit for bit."""
    cfg, packed, frames, fbar, _ = setup
    got = batched_persistent_model(packed, frames, fbar, cfg, n_sm)
    for m in range(M):
        assert torch.equal(got[0][m], single[m][0]) and torch.equal(got[1][m], single[m][1])
