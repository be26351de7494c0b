"""The pure-Python side of the final-state request (row 2) on the CPU: the
route rule (cell2d.final_plan), the order in which the steps ping-pong
between two buffers (cell2d.final_schedule, which the C code keeps), the
route a tensor on the card takes through fused_rollout_final_2d, and the
counters the wrappers move.  The kernels themselves run only on the card:
``python3 chip_smoke.py`` holds each final state to its route's last frame
and to the plain version there."""

import contextlib
import dataclasses
import types

import pytest
import torch

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, init_pi_cell
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1, GS2D_RECON
from percnn_tpu_torch.ops.kernels import _build, cell2d

GS2D = GS2D_RECON.cell          # 1x1, C = 8, 3 branches
BURGERS = BURGERS_STAGE1.cell   # 5x5, C = 16, 3 branches
LO = PiCellConfig(ndim=2, hidden=4, kernel_size=1, dt=0.0125, dx=0.2, diffusion="raw",
                  diff_init=0.2, init="fanin", init_scale=0.5)
N_SM = 132                      # an H100 SXM


def test_gs2d_takes_the_cluster_up_to_448():
    assert cell2d.final_plan(100, 100, GS2D, N_SM) == {
        "route": "cluster", "n_cta": 16, "threads": 352, "smem": 18288}
    assert cell2d.final_plan(100, 100, GS2D, N_SM) == cell2d.rollout_plan(100, 100, GS2D)
    assert cell2d.final_plan(448, 448, GS2D, N_SM)["route"] == "cluster"
    assert cell2d.final_plan(449, 449, GS2D, N_SM) == {"route": "per_step"}


def test_other_1x1_cells_take_the_per_step_kernel():
    for cfg in (LO, dataclasses.replace(GS2D, n_branches=2)):
        assert cell2d.final_plan(100, 100, cfg, N_SM) == {"route": "per_step"}
    # the MXU switch is about k x k cells alone
    assert cell2d.final_plan(100, 100, GS2D, N_SM, mxu=False)["route"] == "cluster"


def test_kxk_cells_take_the_persistent_kernel_with_the_mxu_switch_on():
    assert cell2d.final_plan(100, 100, BURGERS, N_SM, mxu=True) == {
        "route": "persistent", "blocks": 132, "threads": 320, "smem": 48144}
    assert cell2d.final_plan(100, 100, BURGERS, N_SM, mxu=True) == cell2d.kxk_plan(
        100, 100, BURGERS, N_SM)
    k3 = dataclasses.replace(BURGERS, kernel_size=3)
    assert cell2d.final_plan(100, 100, k3, N_SM, mxu=True)["route"] == "persistent"
    assert cell2d.final_plan(1452, 1452, BURGERS, N_SM, mxu=True)["route"] == "persistent"
    assert cell2d.final_plan(1453, 1453, BURGERS, N_SM, mxu=True) == {"route": "per_step"}
    # with the switch off, the FFMA one-launch kernel's rule
    assert cell2d.final_plan(100, 100, BURGERS, N_SM, mxu=False) == cell2d.ffma_plan(
        100, 100, BURGERS, N_SM) == {"route": "persistent", "blocks": 132, "threads": 320,
                                     "smem": 47248}
    assert cell2d.final_plan(1407, 1407, BURGERS, N_SM, mxu=False) == {"route": "per_step"}


def test_the_switch_is_read_at_every_call(monkeypatch):
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", False)
    assert cell2d.final_plan(100, 100, BURGERS, N_SM) == cell2d.ffma_plan(100, 100, BURGERS, N_SM)
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", True)
    assert cell2d.final_plan(100, 100, BURGERS, N_SM) == cell2d.kxk_plan(100, 100, BURGERS, N_SM)


@pytest.mark.parametrize("n_steps", range(1, 8))
def test_ping_pong_ends_in_out_and_never_writes_what_it_reads(n_steps):
    order = cell2d.final_schedule(n_steps)
    assert len(order) == n_steps
    assert order[0][0] == "h0" and order[-1][1] == "out"
    for s, (src, dst) in enumerate(order):
        assert dst in ("out", "scratch") and src != dst
        if s:
            # step s reads what step s - 1 wrote, and writes what it read
            assert src == order[s - 1][1]
            if s >= 2:
                assert dst == order[s - 1][0]
    assert {dst for _, dst in order} == ({"out"} if n_steps == 1 else {"out", "scratch"})


def test_no_steps_is_one_copy():
    assert cell2d.final_schedule(0) == [("h0", "out")]
    with pytest.raises(ValueError):
        cell2d.final_schedule(-1)


@pytest.mark.parametrize("n_steps", [0, 1, 2, 5])
def test_the_schedule_gives_the_plain_final_state_to_the_bit(n_steps):
    """Two buffers written in place by the schedule: what 'out' holds at the
    end is the plain final state, bit for bit."""
    params = init_pi_cell(torch.Generator().manual_seed(3), GS2D, device="cpu")
    packed = cell2d.pack_pi_params_2d(params, GS2D)
    h0 = 0.5 + 0.1 * torch.randn(12, 10, 2, generator=torch.Generator().manual_seed(4))
    bufs = {"h0": h0, "out": torch.full_like(h0, float("nan")),
            "scratch": torch.full_like(h0, float("nan"))}
    for src, dst in cell2d.final_schedule(n_steps):
        bufs[dst].copy_(bufs[src] if n_steps == 0 else
                        cell2d._plain_step(packed, bufs[src], GS2D))
    want = cell2d.fused_rollout_final_2d_plain(packed, h0, GS2D, n_steps)
    assert torch.equal(bufs["out"], want)


def _meta_params(cfg, seed=0):
    params = init_pi_cell(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return params_from_numpy(params, device="meta", dtype=torch.float32)


# (cell, shape, MXU switch, final_plan's route, the launcher it calls)
ROUTES = [(GS2D, (100, 100), True, "cluster", "cluster"),
          (GS2D, (449, 449), True, "per_step", "per_step"),
          (LO, (20, 24), True, "per_step", "per_step"),
          (BURGERS, (100, 100), True, "persistent", "persistent"),
          (BURGERS, (17, 9), True, "persistent", "persistent"),
          (BURGERS, (1453, 1453), True, "per_step", "per_step"),
          (BURGERS, (100, 100), False, "persistent", "ffma")]


@pytest.mark.parametrize("cfg, shape, mxu, route, launcher_name", ROUTES)
def test_a_tensor_off_the_cpu_takes_the_planned_route(monkeypatch, cfg, shape, mxu, route,
                                                      launcher_name):
    """fused_rollout_final_2d calls the launcher of final_plan's route, with
    final_only for the one-launch kernels, and never the plain version: with
    the MXU switch off, a k x k cell's one-launch route is the FFMA kernel's."""
    calls = []

    def launcher(name):
        def launch(*args, **kw):
            calls.append((name, kw))
            return torch.empty(args[-3].shape, device="meta")   # h0's
        return launch

    def no_plain(*args, **kw):
        raise AssertionError("a tensor off the CPU took the plain version")

    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", mxu)
    monkeypatch.setattr(cell2d, "_sm_count", lambda device: N_SM)
    monkeypatch.setattr(cell2d, "_rollout_cluster_cuda", launcher("cluster"))
    monkeypatch.setattr(cell2d, "_rollout_kxk_persistent_cuda", launcher("persistent"))
    monkeypatch.setattr(cell2d, "_rollout_ffma_persistent_cuda", launcher("ffma"))
    monkeypatch.setattr(cell2d, "_final_steps_cuda", launcher("per_step"))
    monkeypatch.setattr(cell2d, "fused_rollout_final_2d_plain", no_plain)
    monkeypatch.setattr(cell2d, "fused_rollout_kxk_2d_plain", no_plain)
    assert cell2d.final_plan(*shape, cfg, N_SM)["route"] == route
    h0 = torch.empty(shape + (2,), device="meta")
    out = cell2d.fused_rollout_final_2d(_meta_params(cfg), h0, cfg, 4)
    assert calls == [(launcher_name, {} if route == "per_step" else {"final_only": True})]
    assert tuple(out.shape) == shape + (2,)


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


@pytest.fixture
def card(monkeypatch):
    """The library replaced by one that records each entry point called with
    its arguments and launches nothing, a card of 132 SMs, and allocations
    on the card made on the CPU as _OnCard tensors.  Returns the calls."""
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
    monkeypatch.setattr(cell2d, "_sm_count", lambda device: N_SM)
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, on_card(getattr(torch, name)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(cell2d, "fused_rollout_final_2d_plain", no_plain)
    for attr in ("launches", "steps", "launches_kxk", "steps_kxk"):
        monkeypatch.setattr(cell2d.fused_rollout_final_2d, attr, 0)
    return calls


@pytest.mark.parametrize("cfg, n, steps, mxu, entry, counts", [
    (GS2D, 100, 7, True, "cell2d_rollout_cluster", (1, 7, 0, 0)),
    (GS2D, 100, 0, True, "cell2d_rollout_cluster", (0, 0, 0, 0)),
    (GS2D, 449, 3, True, "cell2d_final", (3, 3, 0, 0)),
    (LO, 20, 3, True, "cell2d_final", (3, 3, 0, 0)),
    (BURGERS, 100, 5, True, "cell2d_kxk_rollout_persistent", (0, 0, 1, 5)),
    (BURGERS, 100, 1, True, "cell2d_kxk_rollout_persistent", (0, 0, 1, 1)),
    (BURGERS, 100, 0, True, "cell2d_kxk_rollout_persistent", (0, 0, 0, 0)),
    (BURGERS, 1453, 2, True, "cell2d_final", (0, 0, 2, 2)),
    (BURGERS, 100, 4, False, "cell2d_ffma_rollout_persistent", (0, 0, 1, 4)),
])
def test_cuda_final_state_takes_the_planned_route(monkeypatch, card, cfg, n, steps, mxu, entry,
                                                   counts):
    """One launch a request by the one-launch kernels in their final-state
    mode (none for no steps: the entry copies h0), one a step by
    final2d_kernel; the entry point gets the flag and, for the k x k
    kernel's ping-pong, a scratch buffer."""
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", mxu)
    params = _on_card(init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu"))
    h0 = torch.zeros(n, n, 2).as_subclass(_OnCard)
    out = cell2d.fused_rollout_final_2d(params, h0, cfg, steps)
    assert [name for name, _ in card] == [entry]
    assert out.device.type == "cuda" and tuple(out.shape) == (n, n, 2)
    args = card[0][1]
    if entry == "cell2d_rollout_cluster":
        assert args[4:6] == (steps, 1)                       # n_steps, final_only
    elif entry in ("cell2d_kxk_rollout_persistent", "cell2d_ffma_rollout_persistent"):
        assert args[5:7] == (steps, 1)
        assert args[4] is not None                           # the scratch buffer
    f = cell2d.fused_rollout_final_2d
    assert (f.launches, f.steps, f.launches_kxk, f.steps_kxk) == counts


@pytest.mark.parametrize("cfg, n, mxu", [(GS2D, 100, True), (GS2D, 449, True),
                                         (BURGERS, 100, True), (BURGERS, 100, False)])
def test_a_loader_error_propagates(monkeypatch, card, cfg, n, mxu):
    """Whatever the route, a kernel that cannot be loaded raises; nothing
    gives way to another route or to the plain version."""
    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", mxu)
    monkeypatch.setattr(_build, "load_library", fail_load)
    params = _on_card(init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="loader disabled"):
        cell2d.fused_rollout_final_2d(params, torch.zeros(n, n, 2).as_subclass(_OnCard), cfg, 3)
    assert card == []


def test_cpu_calls_move_no_counter(monkeypatch):
    for attr in ("launches", "steps", "launches_kxk", "steps_kxk"):
        monkeypatch.setattr(cell2d.fused_rollout_final_2d, attr, 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    for cfg in (GS2D, BURGERS):
        params = init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu")
        cell2d.fused_rollout_final_2d(params, torch.rand(8, 8, 2), cfg, 3)
    f = cell2d.fused_rollout_final_2d
    assert (f.launches, f.steps, f.launches_kxk, f.steps_kxk) == (0, 0, 0, 0)
