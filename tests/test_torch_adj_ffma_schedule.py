"""A PyTorch model of the single model's k x k streaming sweep in one
cooperative launch (backward2d._phase1_ffma_cuda: the ensemble's
adj2d_batched_ffma_persistent_kernel, csrc/batched2d.cu, on a one-member
batch), on the CPU.  Its model is that kernel's
(test_torch_adj_batched_ffma_schedule) on a one-member batch, by the grid
adj_b_plan gives at M = 1: each block's run of the cells (split_evenly),
the rounds of 16-cell tiles, the operands packed in lane order and read at
the kernel's indices, phase A (step t + 1's gather, g_in into shared memory
and g_ins[t]), the two products of each round, the two zw buffers, one
barrier a step and step 0's gather into g0, the blocks run one after
another in live NaN-filled buffers.  The model is held to the plain sweep
(fused_phase1_2d_plain) and to percnn_tpu's single-model ``_fused_phase1``
(its Pallas kernel in interpret mode) at the gradient bars, rtol 2e-4 /
atol 2e-6.  One shape (k = 5, 16 x 16, T = 4), so the Pallas kernel
compiles once.  The kernel itself runs only on the card:
``python3 chip_smoke.py`` holds it there."""

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
from test_torch_adj_batched_ffma_schedule import batched_ffma_model

N, T = 16, 4
RTOL, ATOL = 2e-4, 2e-6
CFG = dict(ndim=2, hidden=4, kernel_size=5, dt=0.05, dx=0.5, diffusion="sigmoid",
           mu_up=0.1, init_scale=0.3)
# SMs of the modelled card: 1 (one block: 256 cells, two rounds of 128), 3
# (85 or 86 cells, one round of 96) and 40 (6 or 7 cells, a round of one
# tile)
N_SMS = (1, 3, 40)


def ffma_model(packed, frames, frames_bar, cfg, n_sm, order=1):
    """(g_ins [T, H, W, 2], g0 [H, W, 2]) as the single model's one-launch
    sweep forms them, the blocks of a step run one after another (order 1)
    or in reverse (order -1)."""
    H, W = frames.shape[1], frames.shape[2]
    assert backward2d.adj_b_plan(1, H, W, cfg, n_sm)["route"] == "persistent"
    g_ins, g0 = batched_ffma_model(packed[None], frames[None], frames_bar[None], cfg, n_sm,
                                   order)
    return g_ins[0], g0[0]


def _assert_at_bar(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * float(np.abs(np.asarray(want)).max()))


@pytest.fixture(scope="module")
def setup():
    """The cell (percnn_tpu's init, seed 11), h0 and a standard-normal
    cotangent from seeds 12, 13, the frames of the plain rollout, and
    percnn_tpu's _fused_phase1 on them."""
    jcfg = JPiCellConfig(**CFG)
    jp = j_init_pi_cell(jax.random.PRNGKey(11), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    cfg = PiCellConfig(**CFG)
    packed = cell2d.pack_pi_params_2d(params_from_numpy(npp, device="cpu"), cfg)
    h0 = torch.as_tensor(0.5 * np.random.RandomState(12).standard_normal((N, N, 2)),
                         dtype=torch.float32)
    frames = cell2d.fused_rollout_2d_plain(packed, h0, cfg, T)
    fbar = torch.as_tensor(np.random.RandomState(13).standard_normal((T + 1, N, N, 2)),
                           dtype=torch.float32)
    frames_pad = jnp.stack([jcell2d.pad_state_2d(jnp.asarray(f.numpy())) for f in frames[:-1]])
    hp, wp = frames_pad.shape[2], frames_pad.shape[3]
    fbar_pad = jnp.zeros((T, 2, hp, wp), jnp.float32).at[:, :, 2:2 + N, 2:2 + N].set(
        jnp.moveaxis(jnp.asarray(fbar[1:].numpy()), -1, 1))
    gins_j, g0_j = jbackward2d._fused_phase1(jcell2d.pack_pi_params_2d(jp, jcfg), frames_pad,
                                             fbar_pad, cfg=jcfg, n_steps=T, H=N, W=N,
                                             interpret=True)
    want_j = (np.asarray(jcell2d.unpad_frames_2d(gins_j, N, N)),
              np.moveaxis(np.asarray(g0_j)[:, 2:2 + N, 2:2 + N], 0, -1))
    return cfg, packed, frames, fbar, want_j


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_matches_the_plain_sweep(setup, n_sm):
    """g_ins and g0 at the gradient bars of the plain sweep, every entry
    written (no NaN left), whichever order the blocks of a step run in, and
    the same bits in either order."""
    cfg, packed, frames, fbar, _ = setup
    got = ffma_model(packed, frames, fbar, cfg, n_sm)
    want = backward2d.fused_phase1_2d_plain(packed, frames, fbar, cfg)
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        _assert_at_bar(a, b)
    for a, b in zip(ffma_model(packed, frames, fbar, cfg, n_sm, order=-1), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_gives_percnn_tpu_sweep(setup, n_sm):
    cfg, packed, frames, fbar, want_j = setup
    got = ffma_model(packed, frames, fbar, cfg, n_sm)
    assert got[0].shape == (T, N, N, 2) and got[1].shape == (N, N, 2)
    for a, b in zip(got, want_j):
        _assert_at_bar(a, b)
