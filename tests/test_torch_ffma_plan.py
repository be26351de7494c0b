"""The pure-Python side of the one-launch FFMA kernels of a k x k cell (the
MXU switches off), on the CPU: the capacity rules that pick
rollout2d_ffma_persistent_kernel (cell2d.ffma_plan, for frames and, through
final_plan, for the final state) and adj2d_ys_persistent_kernel
(backward2d.ys_plan), their grid and shared-memory bytes, the routes a
tensor on the card takes, the counters the wrappers move, and that the
switches are read at every call.  The kernels themselves run only on the
card: ``python3 chip_smoke.py`` holds them to the plain versions and to the
per-step kernels there.  No JAX here."""

import contextlib
import dataclasses
import types

import pytest
import torch

from percnn_tpu_torch.core.cell import init_pi_cell
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1
from percnn_tpu_torch.ops.kernels import _build, backward2d, cell2d

CFG = BURGERS_STAGE1.cell      # C = 16, 3 branches, 5x5
N_SM = 132                     # an H100 SXM


def _cfg(k=5, nb=3, hidden=16):
    return dataclasses.replace(CFG, kernel_size=k, n_branches=nb, hidden=hidden)


def test_plans_at_burgers_shape():
    # 132 blocks of 75 or 76 cells: 5 tiles of 16, a warp pair each
    assert cell2d.ffma_plan(100, 100, CFG, N_SM) == {
        "route": "persistent", "blocks": 132, "threads": 320, "smem": 47248}
    assert backward2d.ys_plan(100, 100, CFG, N_SM) == {
        "route": "persistent", "blocks": 132, "threads": 320, "smem": 132336}
    assert cell2d.final_plan(100, 100, CFG, N_SM, mxu=False) == cell2d.ffma_plan(
        100, 100, CFG, N_SM)


def test_shared_memory_bytes():
    """The forward: the operand (51 taps and biases x 2 equations x 8 pairs
    x 8 floats), the tail (36 floats), the im2col stack of 50 taps x 80
    cells and 6 staged rows of 104 float2; the sweep: the operand (96 rows
    x 8 tap groups x 8 floats), z of 96 rows x 80 cells, the tail, 5 pairs'
    exchange (28 floats a lane), g_in of 76 cells and two [96][76] buffers
    of ys."""
    fwd = 4 * (51 * 2 * 8 * 8 + 36 + 50 * 80) + 8 * 6 * 104
    assert cell2d.ffma_smem_bytes(CFG, 100, 100, N_SM) == fwd == 47248
    ys = 4 * (96 * 8 * 8 + 96 * 80 + 36 + 5 * 28 * 32 + 2 * 76 + 2 * 96 * 76)
    assert backward2d.ys_smem_bytes(CFG, 100, 100, N_SM) == ys == 132336


@pytest.mark.parametrize("n, fwd, ys", [(148, "persistent", "persistent"),
                                        (149, "persistent", "per_step"),
                                        (1406, "persistent", "per_step"),
                                        (1407, "per_step", "per_step")])
def test_capacity_rules_just_under_and_over(n, fwd, ys):
    f, y = cell2d.ffma_plan(n, n, CFG, N_SM), backward2d.ys_plan(n, n, CFG, N_SM)
    assert (f["route"], y["route"]) == (fwd, ys)
    assert (cell2d.ffma_smem_bytes(CFG, n, n, N_SM) <= cell2d._MAX_SMEM) == (fwd == "persistent")
    assert (backward2d.ys_smem_bytes(CFG, n, n, N_SM) <= cell2d._MAX_SMEM) == (
        ys == "persistent")
    if f["route"] == "persistent":
        assert f["threads"] == 512           # 8 tiles a round: a block owns over 128 cells


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("hidden", [4, 16])
def test_widths_the_kernels_are_built_for(k, nb, hidden):
    cfg = _cfg(k, nb, hidden)
    for plan in (cell2d.ffma_plan(100, 100, cfg, N_SM), backward2d.ys_plan(100, 100, cfg, N_SM),
                 cell2d.final_plan(100, 100, cfg, N_SM, mxu=False)):
        assert plan["route"] == "persistent" and plan["smem"] <= cell2d._MAX_SMEM
        assert plan["blocks"] == 132 and plan["threads"] == 320
    r = cell2d._ffma_adj_taps(cfg)
    assert r == (7 if k == 5 else 3)
    assert cell2d.pack_ffma_fwd_2d(torch.zeros(2 + 2 * cell2d._param_block(cfg)), cfg).shape == (
        k * k * 2 + 1, 2, 2 if nb > 2 else 1, 8, 4)


@pytest.mark.parametrize("cfg", [_cfg(hidden=24), _cfg(nb=5), _cfg(k=1, nb=3, hidden=8),
                                 _cfg(k=7)])
def test_other_widths_take_the_per_step_route(cfg):
    assert cell2d.ffma_plan(100, 100, cfg, N_SM) == {"route": "per_step"}
    assert backward2d.ys_plan(100, 100, cfg, N_SM) == {"route": "per_step"}


def test_a_block_owns_at_most_cap_cells_and_rounds_cover_them():
    for n, n_sm in ((100, 132), (17, 132), (5, 132), (1406, 132), (32, 7)):
        grid = cell2d.ffma_grid(n, n, n_sm)
        shares = cell2d.split_evenly(n * n, grid["blocks"])
        assert max(c for _, c in shares) == grid["cap"]
        assert grid["rc"] == 16 * (grid["threads"] // 64)
        assert grid["rc"] >= min(grid["cap"], 128)


# --- routes on the card -------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: to the wrappers, whose
    routing reads nothing but .device, it is a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(tree):
    if isinstance(tree, dict):
        return {k: _on_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_card(v) for v in tree]
    return tree.as_subclass(_OnCard)


COUNTERS = [(cell2d.fused_rollout_2d, "launches_kxk"), (cell2d.fused_rollout_2d, "steps_kxk"),
            (cell2d.fused_rollout_final_2d, "launches_kxk"),
            (cell2d.fused_rollout_final_2d, "steps_kxk"),
            (cell2d.fused_rollout_kxk_2d, "launches"), (cell2d.fused_rollout_kxk_2d, "steps"),
            (backward2d.fused_phase1_ys_2d, "launches"), (backward2d.fused_phase1_ys_2d, "steps")]


def _counts():
    return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in COUNTERS
            if getattr(obj, attr)}


@pytest.fixture
def card(monkeypatch):
    """The library replaced by one that records each entry point called with
    its arguments and launches nothing, a card of 132 SMs, allocations on
    the card made on the CPU as _OnCard tensors, every counter at 0 and the
    plain versions refused.  Returns the calls."""
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

    for mod, name in ((cell2d, "fused_rollout_2d_plain"), (cell2d, "fused_rollout_final_2d_plain"),
                      (cell2d, "fused_rollout_kxk_2d_plain"),
                      (backward2d, "fused_phase1_ys_2d_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", False)
    monkeypatch.setattr(backward2d, "MXU_BWD_ENABLED", False)
    return calls


def _params(cfg=CFG):
    return _on_card(init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu"))


@pytest.mark.parametrize("shape, steps, entry, counts", [
    ((100, 100), 7, "cell2d_ffma_rollout_persistent",
     {"fused_rollout_2d.launches_kxk": 1, "fused_rollout_2d.steps_kxk": 7}),
    ((17, 9), 3, "cell2d_ffma_rollout_persistent",
     {"fused_rollout_2d.launches_kxk": 1, "fused_rollout_2d.steps_kxk": 3}),
    ((100, 100), 0, "cell2d_ffma_rollout_persistent", {}),
    ((1407, 1407), 2, "cell2d_rollout",
     {"fused_rollout_2d.launches_kxk": 2, "fused_rollout_2d.steps_kxk": 2}),
])
def test_frames_take_the_planned_route(card, shape, steps, entry, counts):
    """One launch a rollout within ffma_plan (none for no steps: the entry
    copies h0), one rollout2d_kernel launch a step past it."""
    out = cell2d.fused_rollout_2d(_params(), torch.zeros(shape + (2,)).as_subclass(_OnCard),
                                  CFG, steps)
    assert [name for name, _ in card] == [entry]
    assert out.device.type == "cuda" and tuple(out.shape) == (steps + 1,) + shape + (2,)
    if entry == "cell2d_ffma_rollout_persistent":
        args = card[0][1]
        assert args[5:9] == (steps, 0) + shape             # n_steps, final_only, H, W
        assert args[13:16] == tuple(cell2d.ffma_plan(*shape, CFG, N_SM)[k]
                                    for k in ("blocks", "threads", "smem"))
    assert _counts() == counts


@pytest.mark.parametrize("shape, steps, entry, counts", [
    ((100, 100), 5, "cell2d_ffma_rollout_persistent",
     {"fused_rollout_final_2d.launches_kxk": 1, "fused_rollout_final_2d.steps_kxk": 5}),
    ((100, 100), 0, "cell2d_ffma_rollout_persistent", {}),
    ((1407, 1407), 2, "cell2d_final",
     {"fused_rollout_final_2d.launches_kxk": 2, "fused_rollout_final_2d.steps_kxk": 2}),
])
def test_final_state_takes_the_planned_route(card, shape, steps, entry, counts):
    """With the MXU switch off, the final state takes the FFMA kernel's
    final-state mode within ffma_plan (the flag and a scratch buffer for
    the ping-pong), final2d_kernel past it."""
    out = cell2d.fused_rollout_final_2d(_params(), torch.zeros(shape + (2,)).as_subclass(_OnCard),
                                        CFG, steps)
    assert [name for name, _ in card] == [entry]
    assert tuple(out.shape) == shape + (2,)
    if entry == "cell2d_ffma_rollout_persistent":
        args = card[0][1]
        assert args[5:7] == (steps, 1) and args[4] is not None
    assert _counts() == counts


@pytest.mark.parametrize("n, steps, entry, counts", [
    (100, 6, "adj2d_ys_persistent",
     {"fused_phase1_ys_2d.launches": 1, "fused_phase1_ys_2d.steps": 6}),
    (100, 0, "adj2d_ys_persistent", {}),
    (149, 3, "adj2d_ys_sweep", {"fused_phase1_ys_2d.launches": 6, "fused_phase1_ys_2d.steps": 3}),
])
def test_ys_sweep_takes_the_planned_route(card, n, steps, entry, counts):
    """One adj2d_ys_persistent_kernel launch a sweep within ys_plan (none for
    no steps), two adj2d_ys_kernel launches a step past it."""
    packed = cell2d.pack_pi_params_2d(_params(), CFG).as_subclass(_OnCard)
    fbar = torch.zeros(steps + 1, n, n, 2).as_subclass(_OnCard)
    ys = torch.zeros(steps, cell2d.mxu_rows(CFG), n, n).as_subclass(_OnCard)
    g_ins, g0 = backward2d.fused_phase1_ys_2d(packed, fbar, ys, CFG)
    assert [name for name, _ in card] == [entry]
    assert tuple(g_ins.shape) == (steps, n, n, 2) and tuple(g0.shape) == (n, n, 2)
    if entry == "adj2d_ys_persistent":
        args = card[0][1]
        assert args[7:10] == (steps, n, n)
        assert args[15:18] == tuple(backward2d.ys_plan(n, n, CFG, N_SM)[k]
                                    for k in ("blocks", "threads", "smem"))
    assert _counts() == counts


def test_the_switches_are_read_at_every_call(monkeypatch, card):
    """fused_rollout_2d and fused_rollout_final_2d follow MXU_FWD_ENABLED
    and backward_route MXU_BWD_ENABLED as they stand at each call."""
    h0 = torch.zeros(100, 100, 2).as_subclass(_OnCard)
    for mxu, fwd_entry in ((True, "cell2d_kxk_rollout_persistent"),
                           (False, "cell2d_ffma_rollout_persistent"),
                           (True, "cell2d_kxk_rollout_persistent")):
        monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", mxu)
        card.clear()
        cell2d.fused_rollout_2d(_params(), h0, CFG, 2)
        cell2d.fused_rollout_final_2d(_params(), h0, CFG, 2)
        assert [name for name, _ in card] == [fwd_entry] * 2
    for mxu, route in ((True, "mxu"), (False, "ys"), (True, "mxu")):
        monkeypatch.setattr(backward2d, "MXU_BWD_ENABLED", mxu)
        assert backward2d.backward_route(CFG, 200, 100, 100) == route


def test_cpu_calls_move_no_counter(monkeypatch):
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", False)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    params = init_pi_cell(torch.Generator().manual_seed(0), CFG, device="cpu")
    h0 = torch.rand(8, 8, 2)
    frames = cell2d.fused_rollout_2d(params, h0, CFG, 3)
    cell2d.fused_rollout_final_2d(params, h0, CFG, 3)
    ys = backward2d._precompute_ys(params, frames[:-1], CFG)
    backward2d.fused_phase1_ys_2d(cell2d.pack_pi_params_2d(params, CFG), torch.rand(4, 8, 8, 2),
                                  ys, CFG)
    assert _counts() == {}


@pytest.mark.parametrize("call", ["frames", "final", "ys", "frames_past_plan"])
def test_a_loader_error_propagates(monkeypatch, card, call):
    """Whatever the route, a kernel that cannot be loaded raises; nothing
    gives way to another route or to the plain version."""
    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(_build, "load_library", fail_load)
    n = 1407 if call == "frames_past_plan" else 100
    h0 = torch.zeros(n, n, 2).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="loader disabled"):
        if call == "ys":
            backward2d.fused_phase1_ys_2d(
                cell2d.pack_pi_params_2d(_params(), CFG).as_subclass(_OnCard),
                torch.zeros(3, n, n, 2).as_subclass(_OnCard),
                torch.zeros(2, cell2d.mxu_rows(CFG), n, n).as_subclass(_OnCard), CFG)
        elif call == "final":
            cell2d.fused_rollout_final_2d(_params(), h0, CFG, 2)
        else:
            cell2d.fused_rollout_2d(_params(), h0, CFG, 2)
    assert card == [] and _counts() == {}
