"""The pure-Python side of the streaming sweeps that take one launch a
call, on the CPU: the rules that pick adj2d_persistent_kernel
(backward2d.adj_plan, the 1x1 sweep) and adj2d_batched_ffma_persistent_kernel
(backward2d.adj_b_plan, the ensemble's k x k sweep, and at one member the
single model's), their grids and shared-memory bytes (each written out here
as its csrc counterpart adds it up), the routes a tensor on the card takes
(also that of adj2d_batched_persistent_kernel, whose plan
test_torch_adj_one_launch_plans.py holds), the counters the wrappers
move, and that a CPU tensor takes the plain versions.  The kernels themselves run
only on the card: ``python3 chip_smoke.py`` holds them to the plain
versions and to the per-step kernels there.  No JAX here."""

import contextlib
import dataclasses
import types

import pytest
import torch

from percnn_tpu_torch.core.cell import init_pi_cell
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1, GS2D_RECON
from percnn_tpu_torch.ops.kernels import _build, backward2d, batched2d, cell2d

GS2D = GS2D_RECON.cell         # C = 8, 3 branches, 1x1
BURGERS = BURGERS_STAGE1.cell  # C = 16, 3 branches, 5x5
N_SM = 132                     # an H100 SXM


# --- adj_plan -----------------------------------------------------------------

def test_adj_plan_at_gs2d_shape():
    """132 blocks of 75 or 76 cells; a block's bytes: the 164 parameters,
    then 6 + 4 C floats a cell of its share (csrc persistent_smem_bytes)
    and, against pg_plan's, no A = 164 accumulators a cell."""
    assert backward2d.adj_plan(100, 100, GS2D, N_SM) == {
        "route": "persistent", "blocks": 132, "smem": 12208}
    cap = max(c for _, c in cell2d.split_evenly(100 * 100, 132))
    assert cap == 76
    assert backward2d.adj_smem_bytes(GS2D, 100, 100, 132) == 4 * (164 + (6 + 4 * 8) * cap)
    assert (backward2d.persistent_smem_bytes(GS2D, 100, 100, 132)
            - backward2d.adj_smem_bytes(GS2D, 100, 100, 132)) == 4 * 164 * cap


@pytest.mark.parametrize("n, route", [(194, "persistent"), (195, "persistent"),
                                      (448, "persistent"), (449, "per_step")])
def test_adj_capacity(n, route):
    """Up to 448 x 448 on 132 SMs (152 bytes a cell), where pg_plan stops at
    194 x 194."""
    plan = backward2d.adj_plan(n, n, GS2D, N_SM)
    assert plan["route"] == route
    assert (backward2d.adj_smem_bytes(GS2D, n, n, N_SM) <= cell2d._MAX_SMEM) == (
        route == "persistent")
    assert backward2d.pg_plan(n, n, GS2D, N_SM)["route"] == (
        "persistent" if n <= 194 else "per_step")


@pytest.mark.parametrize("n, blocks", [(5, 25), (3, 9), (1, 1)])
def test_adj_plan_takes_a_block_a_cell_at_most(n, blocks):
    assert backward2d.adj_plan(n, n, GS2D, N_SM)["blocks"] == blocks


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("hidden", [1, 8, 16])
def test_adj_plan_takes_every_1x1_width_built(nb, hidden):
    cfg = dataclasses.replace(GS2D, n_branches=nb, hidden=hidden)
    plan = backward2d.adj_plan(100, 100, cfg, N_SM)
    assert plan["route"] == "persistent"
    assert plan["smem"] == 4 * (cell2d._round_up(2 + 2 * cell2d._param_block(cfg), 4)
                                + (6 + 4 * hidden) * 76)


@pytest.mark.parametrize("cfg", [dataclasses.replace(GS2D, n_branches=5),
                                 dataclasses.replace(GS2D, kernel_size=3), BURGERS])
def test_adj_plan_other_widths_take_the_per_step_route(cfg):
    assert backward2d.adj_plan(100, 100, cfg, N_SM) == {"route": "per_step"}


# --- adj_b_plan ---------------------------------------------------------------

@pytest.mark.parametrize("M, per, cap, rounds, tiles", [
    (1, 132, 76, 1, 5), (2, 66, 152, 2, 5), (4, 33, 304, 3, 7), (8, 16, 625, 5, 8)])
def test_adj_b_plan_at_burgers_shape(M, per, cap, rounds, tiles):
    """n_sm // M blocks a member; the block's cap / 16 tiles in the fewest
    rounds of at most 8, the same number each; a block's bytes: the forward
    operand (51 rows x 2 equations x 8 pairs x 8 floats), the adjoint
    operand (96 rows x 8 tap groups x 8 floats), the tail (36), the im2col
    stack of a round or the exchange (7 taps x 4 cells x 32 lanes a tile),
    Z of a round (96 rows), g_in (2 floats a cell) and the staged rows
    (csrc adj_b_smem)."""
    plan = batched2d.adj_b_plan(M, 100, 100, BURGERS, N_SM)
    rc = 16 * tiles
    assert max(c for _, c in cell2d.split_evenly(100 * 100, per)) == cap
    assert rounds == -(-cap // rc) and (rounds - 1) * rc < cap
    rows = (cap + 100 - 2) // 100 + 1 + 4       # the rows a run spans, 2 halo rows a side
    smem = 4 * (51 * 2 * 8 * 8 + 96 * 8 * 8 + 36 + max(50 * rc, tiles * 28 * 32) + 96 * rc
                + 2 * cap) + 8 * rows * (100 + 4)
    assert plan == {"route": "persistent", "blocks": M * per, "blocks_a_member": per,
                    "threads": 64 * tiles, "smem": smem}
    assert backward2d.adj_b_smem_bytes(BURGERS, 100, 100, per) == smem


@pytest.mark.parametrize("cap", [1, 15, 16, 17, 76, 128, 129, 152, 304, 625, 1000, 4000])
def test_adj_b_rounds_waste_under_a_tile_each(cap):
    """The rounds cover the block's cells, no round is empty, and the tiles
    that hold none of its cells are fewer than the rounds."""
    g = backward2d.adj_b_grid(cap, 1, 1)
    tiles, rc = g["threads"] // 64, g["rc"]
    assert g["cap"] == cap and 1 <= tiles <= 8 and rc == 16 * tiles
    rounds = -(-cap // rc)
    assert (rounds - 1) * rc < cap <= rounds * rc
    assert rounds * tiles - -(-cap // 16) < rounds


@pytest.mark.parametrize("M, n, route", [(2, 570, "persistent"), (2, 571, "per_step"),
                                         (4, 419, "persistent"), (4, 420, "per_step"),
                                         (8, 300, "persistent"), (8, 301, "per_step"),
                                         (132, 10, "persistent"), (133, 10, "per_step")])
def test_adj_b_capacity(M, n, route):
    plan = batched2d.adj_b_plan(M, n, n, BURGERS, N_SM)
    assert plan["route"] == route
    if route == "persistent":
        assert plan["smem"] <= cell2d._MAX_SMEM and plan["blocks"] <= N_SM
    elif M <= N_SM:
        assert backward2d.adj_b_smem_bytes(BURGERS, n, n, N_SM // M) > cell2d._MAX_SMEM


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("hidden", [1, 16])
def test_adj_b_plan_takes_every_width_built(k, nb, hidden):
    cfg = dataclasses.replace(BURGERS, kernel_size=k, n_branches=nb, hidden=hidden)
    plan = batched2d.adj_b_plan(2, 100, 100, cfg, N_SM)
    assert plan["route"] == "persistent" and plan["threads"] == 320


@pytest.mark.parametrize("cfg", [GS2D, dataclasses.replace(BURGERS, hidden=17),
                                 dataclasses.replace(BURGERS, n_branches=5),
                                 dataclasses.replace(BURGERS, kernel_size=7)])
def test_adj_b_plan_other_widths_take_the_per_step_route(cfg):
    assert batched2d.adj_b_plan(2, 100, 100, cfg, N_SM) == {"route": "per_step"}


# --- routes on the card -------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: to the wrappers, whose
    routing reads nothing but .device, it is a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


COUNTERS = [(backward2d.fused_phase1_2d, "launches"), (backward2d.fused_phase1_2d, "steps"),
            (batched2d.fused_phase1_2d_batched, "launches"),
            (batched2d.fused_phase1_2d_batched, "launches_kxk"),
            (batched2d.fused_phase1_2d_batched, "steps")]


def _counts():
    return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in COUNTERS
            if getattr(obj, attr)}


@pytest.fixture
def card(monkeypatch):
    """The libraries replaced by one that records each entry point called
    with its arguments and launches nothing, a card of 132 SMs, allocations
    on the card made on the CPU as _OnCard tensors, every counter at 0 and
    the plain versions refused.  Returns the calls."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    def on_card(make):
        def alloc(*args, device=None, **kw):
            t = make(*args, **kw)
            return t.as_subclass(_OnCard) if torch.device(device or "cpu").type == "cuda" else t
        return alloc

    monkeypatch.setattr(_build, "load_library", lambda name: Library())
    for mod in (cell2d, backward2d):
        monkeypatch.setattr(mod, "_sm_count", lambda device: N_SM)
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, on_card(getattr(torch, name)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    for mod, name in ((backward2d, "fused_phase1_2d_plain"),
                      (batched2d, "fused_phase1_2d_batched_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)
    return calls


def _packed(cfg, M=None):
    def one(seed):
        return cell2d.pack_pi_params_2d(init_pi_cell(torch.Generator().manual_seed(seed), cfg,
                                                     device="cpu"), cfg)
    out = one(0) if M is None else torch.stack([one(m) for m in range(M)])
    return out.contiguous().as_subclass(_OnCard)


@pytest.mark.parametrize("cfg, n, steps, entry, counts", [
    (GS2D, 100, 6, "adj2d_persistent",
     {"fused_phase1_2d.launches": 1, "fused_phase1_2d.steps": 6}),
    (GS2D, 17, 3, "adj2d_persistent",
     {"fused_phase1_2d.launches": 1, "fused_phase1_2d.steps": 3}),
    (GS2D, 100, 0, "adj2d_persistent", {}),
    (GS2D, 449, 2, "adj2d_sweep", {"fused_phase1_2d.launches": 2, "fused_phase1_2d.steps": 2}),
    (BURGERS, 100, 3, "batched2d_adj_ffma_persistent",
     {"fused_phase1_2d.launches": 1, "fused_phase1_2d.steps": 3}),
    (BURGERS, 17, 2, "batched2d_adj_ffma_persistent",
     {"fused_phase1_2d.launches": 1, "fused_phase1_2d.steps": 2}),
    (BURGERS, 100, 0, "batched2d_adj_ffma_persistent", {}),
    (BURGERS, 769, 1, "adj2d_sweep",
     {"fused_phase1_2d.launches": 2, "fused_phase1_2d.steps": 1}),
])
def test_the_1x1_sweep_takes_the_planned_route(card, cfg, n, steps, entry, counts):
    """At k = 1 one adj2d_persistent_kernel launch a sweep within adj_plan
    (none for no steps), one adj2d_kernel launch a step past it; at k = 5
    one adj2d_batched_ffma_persistent_kernel launch a sweep on a one-member
    batch within adj_b_plan at M = 1 (none for no steps), with the operands
    packed in lane order, and the activation and gather kernels, two a
    step, past it."""
    packed = _packed(cfg)
    frames = torch.zeros(steps + 1, n, n, 2).as_subclass(_OnCard)
    g_ins, g0 = backward2d.fused_phase1_2d(packed, frames, frames, cfg)
    assert [name for name, _ in card] == [entry]
    assert tuple(g_ins.shape) == (steps, n, n, 2) and tuple(g0.shape) == (n, n, 2)
    args = card[0][1]
    if entry == "adj2d_persistent":
        assert args[7:12] == (steps, n, n, cfg.hidden, cfg.n_branches)
        assert args[14] == backward2d.adj_plan(n, n, cfg, N_SM)["blocks"]
    elif entry == "batched2d_adj_ffma_persistent":
        plan = backward2d.adj_b_plan(1, n, n, cfg, N_SM)
        assert args[8:15] == (1, steps, n, n, cfg.hidden, cfg.n_branches, cfg.kernel_size)
        assert args[17:20] == (plan["blocks_a_member"], plan["threads"], plan["smem"])
    assert _counts() == counts


@pytest.mark.parametrize("cfg, M, n, steps, entry, counts", [
    (BURGERS, 2, 100, 5, "batched2d_adj_ffma_persistent",
     {"fused_phase1_2d_batched.launches_kxk": 1, "fused_phase1_2d_batched.steps": 5}),
    (BURGERS, 3, 17, 2, "batched2d_adj_ffma_persistent",
     {"fused_phase1_2d_batched.launches_kxk": 1, "fused_phase1_2d_batched.steps": 2}),
    (BURGERS, 2, 100, 0, "batched2d_adj_ffma_persistent", {}),
    (BURGERS, 2, 571, 1, "batched2d_adj_sweep",
     {"fused_phase1_2d_batched.launches_kxk": 2, "fused_phase1_2d_batched.steps": 1}),
    (GS2D, 4, 100, 3, "batched2d_adj_persistent",
     {"fused_phase1_2d_batched.launches": 1, "fused_phase1_2d_batched.steps": 3}),
    (GS2D, 3, 17, 4, "batched2d_adj_persistent",
     {"fused_phase1_2d_batched.launches": 1, "fused_phase1_2d_batched.steps": 4}),
    (GS2D, 8, 100, 0, "batched2d_adj_persistent", {}),
    (GS2D, 4, 225, 2, "batched2d_adj_sweep",
     {"fused_phase1_2d_batched.launches": 2, "fused_phase1_2d_batched.steps": 2}),
    (GS2D, 133, 3, 1, "batched2d_adj_sweep",
     {"fused_phase1_2d_batched.launches": 1, "fused_phase1_2d_batched.steps": 1}),
])
def test_the_batched_sweep_takes_the_planned_route(card, cfg, M, n, steps, entry, counts):
    """At k > 1 one adj2d_batched_ffma_persistent_kernel launch a sweep for
    every member within adj_b_plan (none for no steps), with each member's
    operands packed in lane order; two launches a step past it; at k = 1
    one adj2d_batched_persistent_kernel launch a sweep for every member
    within adj1_b_plan (none for no steps), and adj2d_batched_kernel, one a
    step, past it (a field over 224 x 224 at M = 4, more members than SMs)."""
    packed = _packed(cfg, M)
    frames = torch.zeros(M, steps + 1, n, n, 2).as_subclass(_OnCard)
    g_ins, g0 = batched2d.fused_phase1_2d_batched(packed, frames, frames, cfg)
    assert [name for name, _ in card] == [entry]
    assert tuple(g_ins.shape) == (M, steps, n, n, 2) and tuple(g0.shape) == (M, n, n, 2)
    args = card[0][1]
    if entry == "batched2d_adj_ffma_persistent":
        plan = batched2d.adj_b_plan(M, n, n, cfg, N_SM)
        assert args[8:15] == (M, steps, n, n, cfg.hidden, cfg.n_branches, cfg.kernel_size)
        assert args[17:20] == (plan["blocks_a_member"], plan["threads"], plan["smem"])
    elif entry == "batched2d_adj_persistent":
        plan = batched2d.adj1_b_plan(M, n, n, cfg, N_SM)
        assert args[1] == packed.shape[1]
        assert args[7:13] == (M, steps, n, n, cfg.hidden, cfg.n_branches)
        assert args[15] == plan["blocks_a_member"]
    assert _counts() == counts


def test_the_batched_operands_are_each_members(monkeypatch, card):
    """The operands handed to the kernel are the members' lane-order packs,
    stacked: [M, ...] of pack_ffma_fwd_2d, pack_ffma_adj_2d and
    pack_ffma_tail_2d, each member's own."""
    seen = []
    real = torch.Tensor.data_ptr

    def data_ptr(self):
        if not any(t is self for t in seen):
            seen.append(self)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    packed = _packed(BURGERS, 2)
    frames = torch.zeros(2, 3, 17, 9, 2).as_subclass(_OnCard)
    batched2d.fused_phase1_2d_batched(packed, frames, frames, BURGERS)
    wf, wa, tail = seen[0], seen[1], seen[2]
    for m in range(2):
        p = packed[m].as_subclass(torch.Tensor)
        assert torch.equal(wf[m], cell2d.pack_ffma_fwd_2d(p, BURGERS))
        assert torch.equal(wa[m], cell2d.pack_ffma_adj_2d(p, BURGERS))
        assert torch.equal(tail[m], cell2d.pack_ffma_tail_2d(p, BURGERS))
    assert not torch.equal(wf[0], wf[1])


def test_cpu_calls_move_no_counter(monkeypatch):
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    for cfg in (GS2D, BURGERS):
        packed = cell2d.pack_pi_params_2d(init_pi_cell(torch.Generator().manual_seed(0), cfg,
                                                       device="cpu"), cfg)
        frames = torch.rand(3, 8, 8, 2)
        backward2d.fused_phase1_2d(packed, frames, frames, cfg)
        batched2d.fused_phase1_2d_batched(torch.stack([packed, packed]),
                                          torch.stack([frames, frames]),
                                          torch.stack([frames, frames]), cfg)
    assert _counts() == {}


@pytest.mark.parametrize("call", ["adj", "adj_past_plan", "batched", "batched_past_plan",
                                  "adj_k5", "adj_k5_past_plan", "batched_k1",
                                  "batched_k1_past_plan"])
def test_a_loader_error_propagates(monkeypatch, card, call):
    """Whatever the route, a kernel that cannot be loaded raises; nothing
    gives way to another route or to the plain version."""
    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(_build, "load_library", fail_load)
    past = call.endswith("plan")
    with pytest.raises(RuntimeError, match="loader disabled"):
        if call.startswith("adj_k5"):
            n = 769 if past else 100
            frames = torch.zeros(2, n, n, 2).as_subclass(_OnCard)
            backward2d.fused_phase1_2d(_packed(BURGERS), frames, frames, BURGERS)
        elif call.startswith("adj"):
            n = 449 if past else 100
            frames = torch.zeros(3, n, n, 2).as_subclass(_OnCard)
            backward2d.fused_phase1_2d(_packed(GS2D), frames, frames, GS2D)
        elif call.startswith("batched_k1"):
            n = 225 if past else 100
            frames = torch.zeros(4, 2, n, n, 2).as_subclass(_OnCard)
            batched2d.fused_phase1_2d_batched(_packed(GS2D, 4), frames, frames, GS2D)
        else:
            n = 571 if past else 100
            frames = torch.zeros(2, 2, n, n, 2).as_subclass(_OnCard)
            batched2d.fused_phase1_2d_batched(_packed(BURGERS, 2), frames, frames, BURGERS)
    assert card == [] and _counts() == {}
