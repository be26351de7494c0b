"""A PyTorch model of adj2d_persistent_kernel's schedule (the 1x1 streaming
sweep in one cooperative launch, csrc/adj2d.cu and adj2d_step.cuh's
persistent_sweep), on the CPU: adj_plan's blocks, each block's share of the
cells (split_evenly), the three passes of a reverse step (g_in at the
9-point cross and its Laplacian, then the (equation, hidden channel, cell)
items' shares of the Jacobian's transpose, then the shares summed in
(o, c) order), g_in streamed to g_ins[t], and the g ping-pong that makes
step 0 write g0.  The blocks run one after another in live buffers (g0,
scratch and g_ins filled with NaN until written, except the two g buffers'
zeros that the wrapper writes), so a block that read what another wrote in
the same step would read a different value.  The model is held to the
plain sweep (fused_phase1_2d_plain) and to percnn_tpu's ``_fused_phase1``
(its Pallas kernel in interpret mode) at the gradient bars, rtol 2e-4 /
atol 2e-6.  One shape (16 x 16, T = 6), so the Pallas kernel compiles
once.  The kernel itself runs only on the card: ``python3 chip_smoke.py``
holds it there, and its g0 to pg2d_persistent_kernel's to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import backward2d as jbackward2d
from percnn_tpu.ops.pallas import cell2d as jcell2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import backward2d, cell2d

N, T = 16, 6
RTOL, ATOL = 2e-4, 2e-6
CFG = dict(ndim=2, hidden=4, kernel_size=1, dt=0.05, dx=0.2, diffusion="sigmoid",
           mu_up=0.1, init_scale=0.3)
# SMs of the modelled card: 3 blocks of 85 or 86 cells (runs that span
# rows), 132 blocks of 1 or 2 cells
N_SMS = (3, 132)
CROSS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (2, 0), (-2, 0), (0, 2), (0, -2))


def _lap5(v, inv_dx2):
    """adj2d::lap5 over the 9 cross values v[0..8] (centre first)."""
    return (-5.0 * v[0] + (4.0 / 3.0) * (v[1] + v[2] + v[3] + v[4])
            - (1.0 / 12.0) * (v[5] + v[6] + v[7] + v[8])) * inv_dx2


def adj_persistent_model(packed, frames, frames_bar, cfg, n_sm, order=1):
    """(g_ins [T, H, W, 2], g0 [H, W, 2]) as adj2d_persistent_kernel forms
    them, the blocks of each step run one after another (order 1) or in
    reverse (order -1)."""
    n_steps, H, W = frames.shape[0] - 1, frames.shape[1], frames.shape[2]
    plan = backward2d.adj_plan(H, W, cfg, n_sm)
    assert plan["route"] == "persistent"
    C, nb, cells = cfg.hidden, cfg.n_branches, H * W
    block = cell2d._param_block(cfg)
    stride = 3 * C
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    nan = float("nan")
    bufs = {"g0": torch.zeros(cells, 2), "scratch": torch.zeros(cells, 2)}
    g_ins = torch.full((n_steps, cells, 2), nan)
    shares = cell2d.split_evenly(cells, plan["blocks"])[::order]
    for s in range(n_steps):
        t = n_steps - 1 - s
        dst, src = ("g0", "scratch") if t % 2 == 0 else ("scratch", "g0")
        h = frames[t].reshape(cells, 2)
        fbar = frames_bar[t + 1].reshape(cells, 2)
        for first, n_own in shares:
            own = torch.arange(first, first + n_own)
            i, j = own // W, own % W
            nbr = [((i + di) % H) * W + (j + dj) % W for di, dj in CROSS]
            # pass 1: g_in at the cross from the live src buffer
            gs = [bufs[src][n] + fbar[n] for n in nbr]
            g_in = gs[0]
            lap_g = _lap5(gs, inv_dx2)
            u, v = h[own, 0], h[own, 1]
            g_ins[t, own] = g_in
            # pass 2: each (o, c) group's share of the Jacobian's transpose
            parts = []
            for o in range(2):
                p = packed[2 + o * block: 2 + (o + 1) * block]
                g = g_in[:, o]
                for c in range(C):
                    y = [p[e * stride + c] * u + p[e * stride + C + c] * v
                         + p[e * stride + 2 * C + c] for e in range(nb)]
                    pre, suf = [torch.ones(n_own)], [torch.ones(n_own)]
                    for e in range(nb):
                        pre.append(pre[-1] * y[e])
                    for e in range(nb - 1, -1, -1):
                        suf.insert(0, suf[0] * y[e])
                    wo = p[nb * stride + c]
                    du, dv = torch.zeros(n_own), torch.zeros(n_own)
                    for e in range(nb):
                        zz = g * (pre[e] * suf[e + 1])
                        du = du + (p[e * stride + c] * wo) * zz
                        dv = dv + (p[e * stride + C + c] * wo) * zz
                    parts.append((du, dv))
            # pass 3: the shares summed in (o, c) order
            su, sv = torch.zeros(n_own), torch.zeros(n_own)
            for du, dv in parts:
                su, sv = su + du, sv + dv
            bufs[dst][own] = torch.stack([g_in[:, 0] + cfg.dt * (packed[0] * lap_g[:, 0] + su),
                                          g_in[:, 1] + cfg.dt * (packed[1] * lap_g[:, 1] + sv)],
                                         dim=-1)
    return g_ins.reshape(n_steps, H, W, 2), bufs["g0"].reshape(H, W, 2)


def _inputs(n_steps, seed):
    """The cell (percnn_tpu's init), frames of its plain rollout and a
    standard-normal cotangent, as numpy and as the port's tensors."""
    jcfg = JPiCellConfig(**CFG)
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    cfg = PiCellConfig(**CFG)
    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    h0 = torch.as_tensor(0.5 + 0.2 * np.random.RandomState(seed + 1).standard_normal(
        (N, N, 2)), dtype=torch.float32)
    frames = cell2d.fused_rollout_2d_plain(packed, h0, cfg, n_steps)
    fbar = torch.as_tensor(np.random.RandomState(seed + 2).standard_normal(
        (n_steps + 1, N, N, 2)), dtype=torch.float32)
    return jcfg, jp, cfg, packed, frames, fbar


def _assert_at_bar(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("n_steps", [5, T])
@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_matches_the_plain_sweep(n_sm, n_steps):
    """g_ins and g0 at the gradient bars of the plain sweep, every entry
    written (no NaN left), whichever order the blocks of a step run in, and
    the same bits in either order (an odd and an even T: the ping-pong ends
    in g0 both ways)."""
    _, _, cfg, packed, frames, fbar = _inputs(n_steps, 3)
    got = adj_persistent_model(packed, frames, fbar, cfg, n_sm)
    want = backward2d.fused_phase1_2d_plain(packed, frames, fbar, cfg)
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        _assert_at_bar(a, b)
    for a, b in zip(adj_persistent_model(packed, frames, fbar, cfg, n_sm, order=-1), got):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_sweep():
    """percnn_tpu's _fused_phase1 (interpret mode) on the inputs of seed 7."""
    jcfg, jp, cfg, packed, frames, fbar = _inputs(T, 7)
    frames_pad = jnp.stack([jcell2d.pad_state_2d(jnp.asarray(f.numpy())) for f in frames[:-1]])
    hp, wp = frames_pad.shape[2], frames_pad.shape[3]
    fbar_pad = jnp.zeros((T, 2, hp, wp), jnp.float32).at[:, :, 2:2 + N, 2:2 + N].set(
        jnp.moveaxis(jnp.asarray(fbar[1:].numpy()), -1, 1))
    gins_j, g0_j = jbackward2d._fused_phase1(jcell2d.pack_pi_params_2d(jp, jcfg), frames_pad,
                                             fbar_pad, cfg=jcfg, n_steps=T, H=N, W=N,
                                             interpret=True)
    want = (np.asarray(jcell2d.unpad_frames_2d(gins_j, N, N)),
            np.moveaxis(np.asarray(g0_j)[:, 2:2 + N, 2:2 + N], 0, -1))
    return (cfg, packed, frames, fbar), want


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_gives_percnn_tpu_sweep(jax_sweep, n_sm):
    (cfg, packed, frames, fbar), want = jax_sweep
    got = adj_persistent_model(packed, frames, fbar, cfg, n_sm)
    assert got[0].shape == (T, N, N, 2) and got[1].shape == (N, N, 2)
    for a, b in zip(got, want):
        _assert_at_bar(a, b)
