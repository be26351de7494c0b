"""The rules that pick the two newest one-launch streaming sweeps, on the
CPU: batched2d.adj1_b_plan (adj2d_batched_persistent_kernel, every member's
1x1 sweep in one cooperative launch) and backward2d.adj_b_plan at one
member (adj2d_batched_ffma_persistent_kernel on a one-member batch, the
single model's k x k sweep in one), their shared-memory bytes written out
as their csrc counterparts add them up (adj2d::persistent_smem,
batched2d.cu's adj_b_smem), their capacities at the edges, and the widths
and member counts that go to the per-step routes.  The kernels run only on
the card (``python3 chip_smoke.py``).  No JAX here."""

import dataclasses

import pytest

from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1, GS2D_RECON
from percnn_tpu_torch.ops.kernels import backward2d, batched2d, cell2d

GS2D = GS2D_RECON.cell         # C = 8, 3 branches, 1x1
BURGERS = BURGERS_STAGE1.cell  # C = 16, 3 branches, 5x5
N_SM = 132                     # an H100 SXM


# --- adj1_b_plan ----------------------------------------------------------------

@pytest.mark.parametrize("M, per, cap", [(1, 132, 76), (2, 66, 152), (4, 33, 304),
                                         (8, 16, 625)])
def test_adj1_b_plan_at_gs2d_shape(M, per, cap):
    """n_sm // M blocks a member of 512 threads; a block's bytes: the 164
    packed parameters, then 6 + 4 C floats a cell of its share."""
    assert max(c for _, c in cell2d.split_evenly(100 * 100, per)) == cap
    assert batched2d.adj1_b_plan(M, 100, 100, GS2D, N_SM) == {
        "route": "persistent", "blocks": M * per, "blocks_a_member": per, "threads": 512,
        "smem": 4 * (164 + (6 + 4 * 8) * cap)}


def test_adj1_b_plan_bytes_at_the_ensembles_widths():
    """46 864 bytes at M = 4 and 95 656 at M = 8, 100 x 100."""
    assert [batched2d.adj1_b_plan(M, 100, 100, GS2D, N_SM)["smem"] for M in (4, 8)] == [
        46864, 95656]


@pytest.mark.parametrize("M, n, route", [(1, 448, "persistent"), (1, 449, "per_step"),
                                         (4, 224, "persistent"), (4, 225, "per_step"),
                                         (8, 156, "persistent"), (8, 157, "per_step"),
                                         (132, 10, "persistent"), (133, 10, "per_step")])
def test_adj1_b_capacity(M, n, route):
    plan = batched2d.adj1_b_plan(M, n, n, GS2D, N_SM)
    assert plan["route"] == route
    if route == "persistent":
        assert plan["smem"] <= cell2d._MAX_SMEM and plan["blocks"] <= N_SM
    elif M <= N_SM:
        assert backward2d.adj_smem_bytes(GS2D, n, n, N_SM // M) > cell2d._MAX_SMEM


@pytest.mark.parametrize("n", [1, 3, 17, 100, 448])
def test_adj1_b_plan_at_one_member_is_adj_plan(n):
    """One member takes the single model's blocks and bytes."""
    plan, single = batched2d.adj1_b_plan(1, n, n, GS2D, N_SM), backward2d.adj_plan(n, n, GS2D,
                                                                                   N_SM)
    assert (plan["blocks_a_member"], plan["smem"]) == (single["blocks"], single["smem"])


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("hidden", [1, 8, 16, 32])
def test_adj1_b_plan_takes_every_1x1_width_built(nb, hidden):
    cfg = dataclasses.replace(GS2D, n_branches=nb, hidden=hidden)
    plan = batched2d.adj1_b_plan(4, 100, 100, cfg, N_SM)
    assert plan["route"] == "persistent"
    assert plan["smem"] == 4 * (cell2d._round_up(2 + 2 * cell2d._param_block(cfg), 4)
                                + (6 + 4 * hidden) * 304)


@pytest.mark.parametrize("hidden, route", [(256, "persistent"), (257, "per_step")])
def test_adj1_b_plan_takes_a_thread_a_group(hidden, route):
    """Pass 2 keeps a thread of the block's 512 for each of the 2 C
    (equation, hidden channel) groups: C <= 256."""
    cfg = dataclasses.replace(GS2D, hidden=hidden)
    assert batched2d.adj1_b_plan(4, 8, 8, cfg, N_SM)["route"] == route


@pytest.mark.parametrize("cfg", [dataclasses.replace(GS2D, n_branches=5),
                                 dataclasses.replace(GS2D, kernel_size=3), BURGERS])
def test_adj1_b_plan_other_widths_take_the_per_step_route(cfg):
    assert batched2d.adj1_b_plan(4, 100, 100, cfg, N_SM) == {"route": "per_step"}


# --- adj_b_plan at one member (the single model's k x k sweep) --------------------

def test_adj_b_plan_at_one_member_burgers_shape():
    """132 blocks of 75 or 76 cells, one round of 5 tiles (320 threads); a
    block's bytes: the forward operand (51 rows x 2 equations x 8 pairs x 8
    floats), the adjoint operand (96 rows x 8 tap groups x 8 floats), the
    tail (36), the exchange (5 tiles x 7 taps x 4 cells x 32 lanes, more
    than the 50 x 80 im2col stack), Z of a round (96 rows x 80), g_in (2
    floats a cell) and the 6 staged rows of 104 float2."""
    smem = 4 * (51 * 2 * 8 * 8 + 96 * 8 * 8 + 36 + max(50 * 80, 5 * 28 * 32) + 96 * 80
                + 2 * 76) + 8 * 6 * (100 + 4)
    assert smem == 105072
    assert backward2d.adj_b_plan(1, 100, 100, BURGERS, N_SM) == {
        "route": "persistent", "blocks": 132, "blocks_a_member": 132, "threads": 320,
        "smem": smem}


@pytest.mark.parametrize("n", [5, 17, 100, 300, 768])
@pytest.mark.parametrize("k", [3, 5])
def test_adj_b_plan_at_one_member_takes_a_block_an_sm(n, k):
    """One member gets every SM (at most a block a cell), adj_b_grid's
    rounds and adj_b_smem_bytes' bytes on that many blocks."""
    cfg = dataclasses.replace(BURGERS, kernel_size=k)
    plan, blocks = backward2d.adj_b_plan(1, n, n, cfg, N_SM), min(N_SM, n * n)
    assert plan == {"route": "persistent", "blocks": blocks, "blocks_a_member": blocks,
                    "threads": backward2d.adj_b_grid(n, n, blocks)["threads"],
                    "smem": backward2d.adj_b_smem_bytes(cfg, n, n, blocks)}


@pytest.mark.parametrize("n, route", [(768, "persistent"), (769, "per_step")])
def test_adj_b_capacity_at_one_member(n, route):
    plan = backward2d.adj_b_plan(1, n, n, BURGERS, N_SM)
    assert plan["route"] == route
    assert (backward2d.adj_b_smem_bytes(BURGERS, n, n, N_SM) <= cell2d._MAX_SMEM) == (
        route == "persistent")


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("hidden", [1, 16])
def test_adj_b_plan_at_one_member_takes_every_width_built(k, nb, hidden):
    cfg = dataclasses.replace(BURGERS, kernel_size=k, n_branches=nb, hidden=hidden)
    plan = backward2d.adj_b_plan(1, 100, 100, cfg, N_SM)
    assert plan["route"] == "persistent" and plan["threads"] == 320
    assert plan["smem"] == backward2d.adj_b_smem_bytes(cfg, 100, 100, N_SM)


@pytest.mark.parametrize("cfg", [GS2D, dataclasses.replace(BURGERS, hidden=17),
                                 dataclasses.replace(BURGERS, n_branches=5),
                                 dataclasses.replace(BURGERS, kernel_size=7)])
def test_adj_b_plan_at_one_member_other_widths_take_the_per_step_route(cfg):
    assert backward2d.adj_b_plan(1, 100, 100, cfg, N_SM) == {"route": "per_step"}


def test_the_plans_live_in_backward2d():
    """batched2d uses backward2d's k x k plan, launcher and 1x1 bytes (no
    import cycle)."""
    assert batched2d.adj_b_plan is backward2d.adj_b_plan
    assert batched2d._ffma_sweep_b is backward2d._ffma_sweep_b
    assert batched2d.adj_smem_bytes is backward2d.adj_smem_bytes
