"""The pure-Python side of the one-launch k x k kernels, on the CPU:
rollout2d_kxk_persistent_kernel's and adj2d_kxk_persistent_kernel's grid
(cell2d.kxk_plan, backward2d.kxk_adj_plan), the capacity rules that pick
them, their shared-memory bytes, the operands packed in the fragment order
of mma.sync.aligned.m16n8k8 (cell2d.pack_mma_fwd_2d, pack_mma_adj_2d), and
the counters of the wrappers that use them.  The fragment layouts below are
written from the PTX ISA's tables for m16n8k8 .tf32 (A: rows g, g + 8 and
columns t, t + 4; B: rows t, t + 4 and column g; C: rows g, g + 8 and
columns 2 t, 2 t + 1, with g = lane // 4 and t = lane % 4), independently
of the packing code.  The kernels themselves run only on the card:
``python3 chip_smoke.py`` holds them against their plain versions there."""

import numpy as np
import pytest
import torch

from percnn_tpu_torch.core.cell import PiCellConfig, init_pi_cell
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1
from percnn_tpu_torch.ops.kernels import _build, backward2d, cell2d

CFG = BURGERS_STAGE1.cell      # C = 16, 3 branches, 5x5
N_SM = 132                     # an H100 SXM


def _cfg(k=5, nb=3, hidden=16):
    return PiCellConfig(ndim=2, hidden=hidden, kernel_size=k, n_branches=nb, dt=0.01, dx=0.1)


def _owned(H, W, blocks):
    seen = np.zeros(H * W, dtype=int)
    for start, count in cell2d.split_evenly(H * W, blocks):
        seen[start:start + count] += 1
    return seen


@pytest.mark.parametrize("H, W", [(100, 100), (17, 9), (5, 5), (64, 64), (846, 846)])
def test_every_cell_owned_once(H, W):
    for plan in (cell2d.kxk_plan(H, W, CFG, N_SM), backward2d.kxk_adj_plan(H, W, CFG, N_SM)):
        grid = cell2d.kxk_grid(H, W, N_SM)
        assert grid["blocks"] == min(N_SM, H * W)
        assert (_owned(H, W, grid["blocks"]) == 1).all()
        if plan["route"] == "persistent":
            assert plan["blocks"] == grid["blocks"] and plan["threads"] == grid["threads"]
    # 846 x 846 is past the sweep's rule, not the forward's
    assert backward2d.kxk_adj_plan(846, 846, CFG, N_SM)["route"] == "per_step"
    assert cell2d.kxk_plan(846, 846, CFG, N_SM)["route"] == "persistent"


def test_plans_at_burgers_shape():
    # 132 blocks of 75 or 76 cells: 5 tiles of 16, a warp pair each
    assert cell2d.kxk_plan(100, 100, CFG, N_SM) == {
        "route": "persistent", "blocks": 132, "threads": 320, "smem": 48144}
    assert backward2d.kxk_adj_plan(100, 100, CFG, N_SM) == {
        "route": "persistent", "blocks": 132, "threads": 320, "smem": 109680}


def test_shared_memory_bytes():
    """The forward: 7 k-steps x 12 n-tiles x 32 lanes of 16-byte split
    fragment pairs, the tail (2 + 2 x 16 + 2 floats), 6 staged rows of 104
    float2; the sweep adds the adjoint operand (12 x 7 x 32 pairs), g_in of
    76 cells, the zw exchange of 5 pairs (7 x 4 x 32 floats each)."""
    fwd = 16 * 7 * 12 * 32 + 4 * 36 + 8 * 6 * 104
    assert cell2d.kxk_smem_bytes(CFG, 100, 100, N_SM) == fwd == 48144
    adj = fwd + 16 * 12 * 7 * 32 + 8 * 76 + 4 * 5 * 7 * 4 * 32
    assert backward2d.kxk_adj_smem_bytes(CFG, 100, 100, N_SM) == adj == 109680


@pytest.mark.parametrize("H, W", [(100, 100), (17, 9), (5, 5), (3, 40), (1452, 1452), (50, 200)])
def test_staged_rows_hold_every_neighbourhood(H, W):
    """Each block's cells and their 2-cell neighbourhoods lie in the rows the
    plan's bytes hold: the rows the cells span plus 2 on each side."""
    grid = cell2d.kxk_grid(H, W, N_SM)
    rows_max = grid["tile_bytes"] // (8 * (W + 4))
    for start, count in cell2d.split_evenly(H * W, grid["blocks"]):
        span = (start + count - 1) // W - start // W + 1
        assert span + 4 <= rows_max


@pytest.mark.parametrize("H, fwd, adj", [(1452, "persistent", "per_step"),
                                         (1453, "per_step", "per_step"),
                                         (845, "persistent", "persistent"),
                                         (846, "persistent", "per_step")])
def test_capacity_rules_just_under_and_over(H, fwd, adj):
    f, a = cell2d.kxk_plan(H, H, CFG, N_SM), backward2d.kxk_adj_plan(H, H, CFG, N_SM)
    assert (f["route"], a["route"]) == (fwd, adj)
    assert (cell2d.kxk_smem_bytes(CFG, H, H, N_SM) <= cell2d._MAX_SMEM) == (fwd == "persistent")
    assert (backward2d.kxk_adj_smem_bytes(CFG, H, H, N_SM) <= cell2d._MAX_SMEM) == (
        adj == "persistent")
    # a wide field of few rows stages whole rows: past both rules
    assert cell2d.kxk_plan(8, 8192, CFG, N_SM)["route"] == "per_step"


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("hidden", [4, 16])
def test_widths_the_kernels_are_built_for(k, nb, hidden):
    cfg = _cfg(k, nb, hidden)
    for plan in (cell2d.kxk_plan(100, 100, cfg, N_SM),
                 backward2d.kxk_adj_plan(100, 100, cfg, N_SM)):
        assert plan["route"] == "persistent" and plan["smem"] <= cell2d._MAX_SMEM
    m = cell2d._mma_shape(cfg)
    assert m["ch"] == (1 if hidden <= 8 else 2) and m["nt2"] == 2 * nb * m["ch"]
    assert m["k8"] == (7 if k == 5 else 3) and m["qt"] == (7 if k == 5 else 3)


def test_other_widths_take_the_per_step_route():
    for cfg in (_cfg(hidden=24), _cfg(nb=5), _cfg(k=1), _cfg(k=7)):
        assert cell2d.kxk_plan(100, 100, cfg, N_SM) == {"route": "per_step"}
        assert backward2d.kxk_adj_plan(100, 100, cfg, N_SM) == {"route": "per_step"}


# --- the fragment order -----------------------------------------------------

def _dense_b(frag: np.ndarray) -> np.ndarray:
    """[steps, n-tiles, 32, 2] B fragments -> the dense [8 steps, 8 n-tiles]
    matrix: b0 of lane (g, t) is row t, column g; b1 is row t + 4."""
    steps, tiles = frag.shape[:2]
    out = np.full((8 * steps, 8 * tiles), np.nan)
    for s in range(steps):
        for n in range(tiles):
            for lane in range(32):
                g, t = divmod(lane, 4)
                out[8 * s + t, 8 * n + g] = frag[s, n, lane, 0]
                out[8 * s + t + 4, 8 * n + g] = frag[s, n, lane, 1]
    return out


def _mma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One m16n8k8 product, fragment in, fragment out: a [32, 4], b [32, 2]
    -> d [32, 4], in f64."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
    Dm = A @ B
    d = np.zeros((32, 4))
    for lane in range(32):
        g, t = divmod(lane, 4)
        d[lane] = Dm[g, 2 * t], Dm[g, 2 * t + 1], Dm[g + 8, 2 * t], Dm[g + 8, 2 * t + 1]
    return d


def _random_cell(cfg, seed=0):
    params = init_pi_cell(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return cell2d.pack_pi_matrix_2d(params, cfg).double(), cell2d.pi_tail_2d(params, cfg).double()


@pytest.mark.parametrize("k, nb, hidden", [(5, 3, 16), (3, 2, 5), (5, 1, 8), (3, 4, 12)])
def test_fragments_are_a_permutation_of_the_branch_matrix(k, nb, hidden):
    cfg = _cfg(k, nb, hidden)
    wmat, _ = _random_cell(cfg)
    C8, taps = -(-hidden // 8) * 8, k * k * 2
    fwd = cell2d.pack_mma_fwd_2d(wmat, cfg).numpy()
    adj = cell2d.pack_mma_adj_2d(wmat, cfg).numpy()
    K = wmat.shape[1]
    assert fwd.shape == (K // 8, 2 * nb * C8 // 8, 32, 2)
    assert adj.shape == (2 * nb * C8 // 8, -(-taps // 8), 32, 2)
    pad_rows = np.zeros((2 * nb * C8 - 2 * nb * hidden) * K)
    np.testing.assert_array_equal(np.sort(fwd.ravel()),
                                  np.sort(np.concatenate([wmat.numpy().ravel(), pad_rows])))
    n_adj = 2 * nb * C8 * -(-taps // 8) * 8
    want_adj = np.concatenate([wmat[:, :taps].numpy().ravel(),
                               np.zeros(n_adj - 2 * nb * hidden * taps)])
    np.testing.assert_array_equal(np.sort(adj.ravel()), np.sort(want_adj))
    # and each entry where the layout puts it: Wm^T (rows padded) for the
    # forward; for the adjoint Wm's tap columns with the rows of each group
    # of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7
    w_pad = np.zeros((2, nb, C8, K))
    w_pad[:, :, :hidden] = wmat.numpy().reshape(2, nb, hidden, K)
    w_pad = w_pad.reshape(2 * nb * C8, K)
    np.testing.assert_array_equal(_dense_b(fwd), w_pad.T)
    perm = np.concatenate([8 * s + np.array([0, 2, 4, 6, 1, 3, 5, 7])
                           for s in range(2 * nb * C8 // 8)])
    q_pad = np.zeros((2 * nb * C8, adj.shape[1] * 8))
    q_pad[:, :taps] = w_pad[:, :taps]
    np.testing.assert_array_equal(_dense_b(adj), q_pad[perm])


@pytest.mark.parametrize("k, nb, hidden", [(5, 3, 16), (3, 2, 5)])
def test_fragments_reproduce_y_and_zw(k, nb, hidden):
    """One 16-cell tile of a random field through the kernels' fragment
    flow, in f64: A from im2col (columns t, t + 4 of each k-step), y in the
    accumulator, z formed there, A of the second product taken from the
    accumulator as (c0, c2, c1, c3); y against im2col @ Wm^T and zw against
    z @ Wm_taps through torch.matmul."""
    cfg = _cfg(k, nb, hidden)
    wmat, tail = _random_cell(cfg, seed=1)
    C8, taps = -(-hidden // 8) * 8, k * k * 2
    fwd = cell2d.pack_mma_fwd_2d(wmat, cfg).numpy()
    adj = cell2d.pack_mma_adj_2d(wmat, cfg).numpy()
    h = torch.as_tensor(np.random.RandomState(2).standard_normal((6, 7, 2)))
    cols = cell2d.im2col_2d(h, cfg).reshape(-1, wmat.shape[1])[:16].numpy()   # [16 cells, K]
    g_in = np.random.RandomState(3).standard_normal((16, 2))
    nt = nb * C8 // 8                       # n-tiles of one equation
    y_want = cols @ wmat.numpy().T          # [16, M]
    w_out = tail[2:2 + 2 * hidden].numpy().reshape(2, hidden)
    zw_want = np.zeros((16, taps))
    y_got = np.zeros((16, 2, nb, C8))
    for o in range(2):
        acc = [np.zeros((32, 4)) for _ in range(nt)]
        for ks in range(fwd.shape[0]):
            a = np.zeros((32, 4))
            for lane in range(32):
                g, t = divmod(lane, 4)
                a[lane] = cols[g, 8 * ks + t], cols[g + 8, 8 * ks + t], \
                    cols[g, 8 * ks + t + 4], cols[g + 8, 8 * ks + t + 4]
            for n in range(nt):
                acc[n] += _mma(a, fwd[ks, o * nt + n])
        # accumulator element e of n-tile i ch + c8: cell g + 8 (e // 2),
        # channel 8 ch + 2 t + e % 2
        for n in range(nt):
            i, chn = divmod(n, C8 // 8)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for e in range(4):
                    y_got[g + 8 * (e // 2), o, i, 8 * chn + 2 * t + e % 2] = acc[n][lane, e]
        # z in the accumulator, then the second product
        z = [np.zeros((32, 4)) for _ in range(nt)]
        for n in range(nt):
            i, chn = divmod(n, C8 // 8)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for e in range(4):
                    cell, c = g + 8 * (e // 2), 8 * chn + 2 * t + e % 2
                    others = np.prod([acc[j * (C8 // 8) + chn][lane, e]
                                      for j in range(nb) if j != i])
                    wo = w_out[o, c] if c < hidden else 0.0
                    z[n][lane, e] = wo * g_in[cell, o] * others
        zacc = [np.zeros((32, 4)) for _ in range(adj.shape[1])]
        for n in range(nt):
            a = z[n][:, [0, 2, 1, 3]]
            for q in range(adj.shape[1]):
                zacc[q] += _mma(a, adj[o * nt + n, q])
        for q in range(adj.shape[1]):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for e in range(4):
                    col = 8 * q + 2 * t + e % 2
                    if col < taps:
                        zw_want_cell = g + 8 * (e // 2)
                        zw_want[zw_want_cell, col] += zacc[q][lane, e]
    np.testing.assert_allclose(y_got[..., :hidden].reshape(16, -1), y_want, rtol=1e-12,
                               atol=1e-12)
    assert (y_got[..., hidden:] == 0).all()
    # zw = z @ Wm_taps with z from y_want (w_out g_in prod_{j != i} y_j)
    y4 = torch.as_tensor(y_want).reshape(16, 2, nb, hidden)
    z_ref = backward2d._leave_one_out_prod(y4, 2) * (
        torch.as_tensor(g_in)[:, :, None, None] * torch.as_tensor(w_out)[None, :, None, :])
    zw_ref = torch.matmul(z_ref.reshape(16, -1), wmat[:, :taps])
    np.testing.assert_allclose(zw_want, zw_ref.numpy(), rtol=1e-10, atol=1e-12)


def test_cpu_calls_move_no_counter(monkeypatch):
    """The plain route launches nothing: neither launches nor steps move,
    and no kernel is built."""
    for fn in (cell2d.fused_rollout_kxk_2d, backward2d.fused_rollout_tp_2d):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "steps", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    cfg = PiCellConfig(ndim=2, hidden=4, kernel_size=5, dt=0.01, dx=0.1)
    params = init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu")
    h0 = torch.rand(9, 8, 2, generator=torch.Generator().manual_seed(1))
    cell2d.fused_rollout_2d(params, h0, cfg, 3)
    for leaf in [params["diff"]] + [t for br in params["pi"] for t in br.values()]:
        leaf.requires_grad_(True)
    backward2d.fused_rollout_tp_2d(params, h0, cfg, 3).sum().backward()
    assert params["pi"][0]["w0"].grad is not None
    for fn in (cell2d.fused_rollout_kxk_2d, backward2d.fused_rollout_tp_2d):
        assert fn.launches == 0 and fn.steps == 0
