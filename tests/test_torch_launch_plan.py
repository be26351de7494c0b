"""The pure-Python launch plans of the one-launch kernels, on the CPU:
rollout2d_cluster_kernel's strips of rows (cell2d.rollout_plan) and
pg2d_persistent_kernel's co-resident grid (backward2d.pg_plan), the
capacity rules that pick them, and the counters of the wrappers that use
them.  The CUDA sources compute the same splits (strip_of and the
persistent kernel's cell ranges)."""

import numpy as np
import pytest
import torch

from percnn_tpu_torch.core.cell import PiCellConfig, init_pi_cell
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.ops.kernels import _build, backward2d, cell2d

CFG = GS2D_RECON.cell          # C = 8, 3 branches, 1x1: 164 packed floats, A = 164
N_SM = 132                     # an H100 SXM


def _covers_once(parts, n):
    seen = np.zeros(n, dtype=int)
    for start, count in parts:
        seen[start:start + count] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("H, n", [(100, 8), (100, 16), (17, 8), (16, 8), (5, 2), (448, 16),
                                  (2, 1), (3, 1)])
def test_strip_split_covers_every_row_once(H, n):
    parts = cell2d.split_evenly(H, n)
    assert len(parts) == n and _covers_once(parts, H)
    counts = [c for _, c in parts]
    assert max(counts) - min(counts) <= 1 and counts == sorted(counts, reverse=True)


@pytest.mark.parametrize("H", [100, 33, 17, 16, 5, 4, 3, 2])
def test_halo_rows_come_from_the_neighbours_and_wrap(H):
    """The plan's strips have at least 2 rows, so the 2-row halos above and
    below strip r (rows start - 2, start - 1 and start + rows,
    start + rows + 1, mod H) are the last two rows of strip r - 1 and the
    first two of strip r + 1, mod n: the rows the kernel puts there.  The
    first strip's upper halo is the field's last two rows, the last strip's
    lower halo its first two."""
    n = cell2d.rollout_plan(H, 9, CFG)["n_cta"]
    assert n == min(16, H // 2)
    parts = cell2d.split_evenly(H, n)
    assert min(c for _, c in parts) >= 2
    for r, (start, rows) in enumerate(parts):
        up_start, up_rows = parts[(r - 1) % n]
        down_start, _ = parts[(r + 1) % n]
        assert [(start - 2) % H, (start - 1) % H] == [up_start + up_rows - 2,
                                                       up_start + up_rows - 1]
        assert [(start + rows) % H, (start + rows + 1) % H] == [down_start, down_start + 1]
    assert [(parts[0][0] - k) % H for k in (2, 1)] == [H - 2, H - 1]
    last_start, last_rows = parts[-1]
    assert [(last_start + last_rows + k) % H for k in (0, 1)] == [0, 1]


def test_cluster_plan_of_gs2d_and_of_small_fields():
    plan = cell2d.rollout_plan(100, 100, CFG)
    # 7 rows of 100 cells, two a thread; the parameters padded to 172 floats
    assert plan == {"route": "cluster", "n_cta": 16, "threads": 352,
                    "smem": 4 * 172 + 2 * (7 + 4) * 100 * 8}
    # a field with fewer than 32 rows: a CTA every 2 rows, a strip of 2 or 3
    for H, n_cta in ((2, 1), (3, 1), (5, 2), (15, 7), (31, 15)):
        small = cell2d.rollout_plan(H, 9, CFG)
        assert small["route"] == "cluster" and small["n_cta"] == n_cta
        assert small["threads"] == 32   # at most 27 cells a strip, one warp takes them
    assert cell2d.rollout_plan(1, 9, CFG) == {"route": "per_step"}
    # the kernel is compiled for the GS2D cell's widths alone
    for other in (PiCellConfig(ndim=2, hidden=4, kernel_size=5),
                  PiCellConfig(ndim=2, hidden=4, kernel_size=1),
                  PiCellConfig(ndim=2, hidden=8, n_branches=2, kernel_size=1)):
        assert cell2d.rollout_plan(100, 100, other) == {"route": "per_step"}


@pytest.mark.parametrize("H, route", [(100, "cluster"), (448, "cluster"), (449, "per_step"),
                                      (512, "per_step")])
def test_cluster_capacity_rule(H, route):
    plan = cell2d.rollout_plan(H, H, CFG)
    assert plan["route"] == route
    smem = cell2d.cluster_smem_bytes(CFG, H, H, 16)
    assert (smem <= cell2d._MAX_SMEM) == (route == "cluster")
    if route == "cluster":
        cells = -(-H // 16) * H   # the most cells a strip holds
        assert plan["smem"] == smem and plan["threads"] == min(512, 32 * -(-cells // 64))


def test_persistent_grid_owns_every_cell_once():
    for H, W, n_sm in ((100, 100, N_SM), (7, 9, N_SM), (194, 194, N_SM), (100, 100, 114)):
        plan = backward2d.pg_plan(H, W, CFG, n_sm)
        assert plan["route"] == "persistent" and plan["blocks"] == min(n_sm, H * W)
        parts = cell2d.split_evenly(H * W, plan["blocks"])
        assert _covers_once(parts, H * W) and all(c >= 1 for _, c in parts)


def test_persistent_accumulator_bytes():
    A = backward2d._pg_layout(CFG)["A"]
    assert A == 164
    cap = -(-100 * 100 // N_SM)
    assert cap == 76
    want = 4 * (164 + (A + 6 + 4 * CFG.hidden) * cap)
    assert backward2d.persistent_smem_bytes(CFG, 100, 100, N_SM) == want == 62064
    assert backward2d.pg_plan(100, 100, CFG, N_SM) == {"route": "persistent", "blocks": N_SM,
                                                       "smem": want}
    assert backward2d.persistent_smem_bytes(CFG, 194, 194, N_SM) <= cell2d._MAX_SMEM
    assert backward2d.persistent_smem_bytes(CFG, 195, 195, N_SM) > cell2d._MAX_SMEM


@pytest.mark.parametrize("H, route", [(100, "persistent"), (194, "persistent"),
                                      (195, "per_step"), (256, "per_step")])
def test_persistent_capacity_rule(H, route):
    assert backward2d.pg_plan(H, H, CFG, N_SM)["route"] == route


def test_cpu_calls_move_no_counter(monkeypatch):
    """The plain route launches nothing: neither launches nor steps move."""
    for fn in (cell2d.fused_rollout_2d, backward2d.fused_rollout_tp_2d_pg):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "steps", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    cfg = PiCellConfig(ndim=2, hidden=4, kernel_size=1, dt=0.5, dx=0.01)
    params = init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu")
    h0 = torch.rand(8, 8, 2, generator=torch.Generator().manual_seed(1))
    cell2d.fused_rollout_2d(params, h0, cfg, 3)
    for leaf in [params["diff"]] + [t for br in params["pi"] for t in br.values()]:
        leaf.requires_grad_(True)
    backward2d.fused_rollout_tp_2d_pg(params, h0, cfg, 3).sum().backward()
    for fn in (cell2d.fused_rollout_2d, backward2d.fused_rollout_tp_2d_pg):
        assert fn.launches == 0 and fn.steps == 0


def test_split_rejects_no_parts():
    with pytest.raises(ValueError):
        cell2d.split_evenly(4, 0)
