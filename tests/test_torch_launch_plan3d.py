"""The pure-Python side of GS3D's one-launch kernels, on the CPU:
rollout3d_persistent_kernel's and pg3d_persistent_kernel's co-resident grid
(cell3d.rollout3d_plan, backward3d.pg3d_plan), the capacity rules that pick
them, their shared-memory bytes, the routes the wrappers take and the
counters they move, and a model of the persistent forward's schedule (the
cells a block owns, the planes it stages, the buffers it reads and writes)
held to the plain version bit for bit.  The kernels themselves run only on
the card: ``python3 chip_smoke.py`` holds them against their plain versions
and against the per-step kernels there."""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from percnn_tpu_torch.core.cell import init_pi_cell
from percnn_tpu_torch.experiments.configs import GS3D_RECON
from percnn_tpu_torch.ops.kernels import _build, backward2d, backward3d, cell2d, cell3d

CFG = GS3D_RECON.cell          # C = 2, 3 branches, 1x1: 44 packed floats, A = 44
N_SM = 132                     # an H100 SXM


def _owned(cells, blocks):
    seen = np.zeros(cells, dtype=int)
    for start, count in cell2d.split_evenly(cells, blocks):
        seen[start:start + count] += 1
    return seen


@pytest.mark.parametrize("n", [48, 16, 9, 5])
def test_every_cell_owned_once(n):
    cells = n ** 3
    for n_sm in range(1, N_SM + 1):
        blocks = min(n_sm, cells)
        for plan in (cell3d.rollout3d_plan(n, n, n, n_sm),
                     backward3d.pg3d_plan(n, n, n, CFG, n_sm)):
            # on few SMs a block of 48^3 or 16^3 holds too many cells
            assert plan.get("blocks", blocks) == blocks
        parts = cell2d.split_evenly(cells, blocks)
        assert (_owned(cells, blocks) == 1).all()
        counts = [c for _, c in parts]
        assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_plans_at_gs3d_shape():
    n = GS3D_RECON.grid
    assert n == 48
    # 132 blocks of 837 or 838 cells
    assert sorted({c for _, c in cell2d.split_evenly(n ** 3, N_SM)}) == [837, 838]
    assert cell3d.rollout3d_plan(n, n, n, N_SM) == {
        "route": "persistent", "blocks": 132, "threads": 864, "smem": 35152}
    assert backward3d.pg3d_plan(n, n, n, CFG, N_SM) == {
        "route": "persistent", "blocks": 132, "smem": 155904}


def test_shared_memory_bytes():
    """The sweep: 44 parameters, then the A = 44 accumulators of each of the
    838 cells a block holds at most, then g's run with two rows on each
    side, as float2; the forward: 24 coefficients, then the run with two
    rows on each side and four shifted runs, as float2."""
    assert backward2d._pg_layout(CFG)["A"] == 44
    assert backward3d.pg3d_smem_bytes(CFG, 48, 48, 48, N_SM) == (
        4 * (44 + 44 * 838) + 8 * (838 + 4 * 48)) == 155904
    assert cell3d.rollout3d_smem_bytes(48, 48, 48, N_SM) == 4 * 24 + 8 * (5 * 838 + 4 * 48)
    # 51^3 holds at most 1005 cells a block, two a thread of 512; 52^3 1066
    assert backward3d.pg3d_smem_bytes(CFG, 51, 51, 51, N_SM) <= cell2d._MAX_SMEM
    assert -(-51 ** 3 // N_SM) == 1005 and -(-52 ** 3 // N_SM) == 1066


@pytest.mark.parametrize("n, route", [(48, "persistent"), (51, "persistent"),
                                      (52, "per_step"), (64, "per_step")])
def test_sweep_capacity_rule(n, route):
    assert backward3d.pg3d_plan(n, n, n, CFG, N_SM)["route"] == route


@pytest.mark.parametrize("hidden, n_branches", [(4, 3), (1, 3), (2, 2)])
def test_sweep_kernel_is_built_for_the_gs3d_widths(hidden, n_branches):
    """pg3d_persistent_kernel is compiled for C = 2 and 3 branches; any other
    cell takes pg3d_kernel, whatever the shape."""
    cfg = dataclasses.replace(CFG, hidden=hidden, n_branches=n_branches)
    assert backward3d.pg3d_plan(16, 16, 16, cfg, N_SM) == {"route": "per_step"}


@pytest.mark.parametrize("n, route", [(48, "persistent"), (91, "persistent"),
                                      (92, "per_step"), (5, "persistent")])
def test_rollout_capacity_rule(n, route):
    plan = cell3d.rollout3d_plan(n, n, n, N_SM)
    assert plan["route"] == route
    if route == "persistent":
        cap = -(-n ** 3 // plan["blocks"])
        assert plan["threads"] == min(896, 32 * -(-cap // 32))
        assert plan["smem"] == cell3d.rollout3d_smem_bytes(n, n, n, plan["blocks"])


def test_cpu_calls_move_no_counter(monkeypatch):
    """The plain route launches nothing: neither launches nor steps move."""
    for fn in (cell3d.fused_rollout_3d, backward3d.fused_rollout_tp_3d_pg):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "steps", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    params = init_pi_cell(torch.Generator().manual_seed(0), CFG, device="cpu")
    h0 = torch.rand(6, 6, 6, 2, generator=torch.Generator().manual_seed(1))
    cell3d.fused_rollout_3d(params, h0, CFG, 3)
    cell3d.fused_rollout_3d(params, h0, CFG, 3, final_only=True)
    for leaf in [params["diff"]] + [t for br in params["pi"] for t in br.values()]:
        leaf.requires_grad_(True)
    backward3d.fused_rollout_tp_3d_pg(params, h0, CFG, 3).sum().backward()
    for fn in (cell3d.fused_rollout_3d, backward3d.fused_rollout_tp_3d_pg):
        assert fn.launches == 0 and fn.steps == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: to the wrappers, whose
    routing reads nothing but .device, it is a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def card(monkeypatch):
    """The library replaced by one that records the entry point called and
    launches nothing, a card of 132 SMs, and allocations on the card made on
    the CPU as _OnCard tensors.  Returns the list of calls."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append(name)
                return 0
            return entry

    def on_card(make):
        def alloc(*args, device=None, **kw):
            t = make(*args, **kw)
            return t.as_subclass(_OnCard) if torch.device(device or "cpu").type == "cuda" else t
        return alloc

    monkeypatch.setattr(_build, "load_library", lambda name: Library())
    for module in (cell3d, backward3d):
        monkeypatch.setattr(module, "_sm_count", lambda device: N_SM)
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, on_card(getattr(torch, name)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    for module, name in ((cell3d, "fused_rollout_3d_plain"),
                         (backward3d, "fused_rollout_3d_plain"),
                         (backward3d, "fused_phase1_pg_3d_plain")):
        monkeypatch.setattr(module, name, no_plain)
    for fn in (cell3d.fused_rollout_3d, backward3d.fused_rollout_tp_3d_pg):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "steps", 0)
    return calls


def _params_on_card():
    params = init_pi_cell(torch.Generator().manual_seed(0), CFG, device="cpu")
    return {"diff": params["diff"].as_subclass(_OnCard),
            "pi": [{k: v.as_subclass(_OnCard) for k, v in br.items()} for br in params["pi"]]}


@pytest.mark.parametrize("n, steps, final_only, entry, launches", [
    (48, 7, False, "cell3d_rollout_persistent", 1),
    (48, 7, True, "cell3d_rollout_persistent", 1),
    (9, 0, False, "cell3d_rollout_persistent", 0),
    (92, 3, True, "cell3d_rollout", 3),
])
def test_cuda_rollout_takes_the_planned_route(card, n, steps, final_only, entry, launches):
    assert cell3d.rollout3d_plan(n, n, n, N_SM)["route"] == (
        "persistent" if entry.endswith("persistent") else "per_step")
    h0 = torch.zeros(n, n, n, 2).as_subclass(_OnCard)
    out = cell3d.fused_rollout_3d(_params_on_card(), h0, CFG, steps, final_only=final_only)
    assert card == [entry]
    assert out.device.type == "cuda"
    assert tuple(out.shape) == ((n, n, n, 2) if final_only else (steps + 1, n, n, n, 2))
    assert (cell3d.fused_rollout_3d.launches, cell3d.fused_rollout_3d.steps) == (launches, steps)


@pytest.mark.parametrize("n, entry, launches", [(48, "backward3d_pg_persistent", 1),
                                                (51, "backward3d_pg_persistent", 1),
                                                (52, "backward3d_pg", 4)])
def test_cuda_sweep_takes_the_planned_route(card, n, entry, launches):
    packed = cell3d.pack_pi_params_3d(_params_on_card(), CFG).detach()
    frames = torch.zeros(5, n, n, n, 2).as_subclass(_OnCard)
    g0, acc = backward3d.fused_phase1_pg_3d(packed, frames, frames, CFG)
    assert card == [entry]
    assert g0.device.type == acc.device.type == "cuda"
    assert tuple(acc.shape) == (44, n, n, n)
    assert (backward3d.fused_rollout_tp_3d_pg.launches,
            backward3d.fused_rollout_tp_3d_pg.steps) == (launches, 4)


def test_training_forward_takes_the_planned_route(card):
    """FusedRolloutTP3dPG's forward, the training path's, by the plan."""
    h0 = torch.zeros(16, 16, 16, 2).as_subclass(_OnCard)
    frames = backward3d.fused_rollout_tp_3d_pg(_params_on_card(), h0, CFG, 6)
    assert card == ["cell3d_rollout_persistent"] and tuple(frames.shape) == (7, 16, 16, 16, 2)
    assert (cell3d.fused_rollout_3d.launches, cell3d.fused_rollout_3d.steps) == (1, 6)


def _wrap(i, n):
    return torch.remainder(i, n)


def _persistent_rollout_model(e, h0, n_steps, blocks, final_only):
    """rollout3d_persistent_kernel's schedule in PyTorch (csrc/cell3d.cu):
    block b owns split_evenly's run [first, first + n) of the flat field;
    a step stages from the previous buffer `mid` (the run with 2 W cells on
    each side) and `side` (the run shifted by +1, -1, +2, -2 planes), takes
    every stencil point from them except a height neighbour that wraps
    around its plane (read from the buffer itself), and writes the run of
    the next buffer: frames t + 1, or out and scratch in the order that
    makes the last step write out.  The blocks run in reverse order, and
    every buffer starts as NaN, so a read of anything but the previous
    buffer's finished cells shows."""
    D, H, W = h0.shape[:3]
    HW, cells = H * W, D * H * W
    src = h0.reshape(cells, 2)
    nan = torch.full((cells, 2), float("nan"))
    frames = [src.clone()] + [nan.clone() for _ in range(n_steps)]
    out, scratch = nan.clone(), nan.clone()
    parts = cell2d.split_evenly(cells, blocks)
    for t in range(n_steps):
        dst = frames[t + 1] if not final_only else (out if (n_steps - 1 - t) % 2 == 0
                                                    else scratch)
        for first, n in reversed(parts):
            mid = src[_wrap(first - 2 * W + torch.arange(n + 4 * W), cells)]
            own = torch.arange(n)
            side = [src[_wrap(first + own + s, cells)] for s in (HW, -HW, 2 * HW, -2 * HW)]
            idx = first + own
            i = (idx % HW) // W
            j = idx % W
            c = own + 2 * W

            def height(di):
                inside = (i + di >= 0) & (i + di < H)
                wrapped = src[_wrap(idx + di * W - int(np.sign(di)) * HW, cells)]
                return torch.where(inside[:, None], mid[c + di * W], wrapped)

            def width(dj):
                step = torch.where((j + dj >= 0) & (j + dj < W), dj, dj - int(np.sign(dj)) * W)
                return mid[c + step]

            x = [mid[c], side[0], side[1], height(1), height(-1), width(1), width(-1),
                 side[2], side[3], height(2), height(-2), width(2), width(-2)]
            dst[idx] = cell3d._step_from_points(e, x)
        src = dst
    shape = tuple(h0.shape)
    if final_only:
        return (out if n_steps else src).reshape(shape)
    return torch.stack(frames).reshape((n_steps + 1,) + shape)


@pytest.mark.parametrize("blocks", [2, 3, 4, 5, 6, 7])
def test_persistent_schedule_equals_plain_to_the_bit(blocks):
    n, steps = 9, 6
    params = init_pi_cell(torch.Generator().manual_seed(2), CFG, device="cpu")
    e = cell3d.pack_pi_expanded_3d(params, CFG).detach()
    rng = np.random.RandomState(blocks)
    h0 = torch.as_tensor(0.5 + 0.2 * rng.standard_normal((n, n, n, 2)), dtype=torch.float32)
    want = cell3d.fused_rollout_3d_plain(e, h0, steps)
    got = _persistent_rollout_model(e, h0, steps, blocks, final_only=False)
    assert torch.equal(got, want)
    for t in (steps, steps - 1):   # the last step written to out, an even and an odd count
        got_final = _persistent_rollout_model(e, h0, t, blocks, final_only=True)
        assert torch.equal(got_final, cell3d.fused_rollout_3d_plain(e, h0, t, final_only=True))
