"""The pure-Python side of the ensemble's one-launch kernels, on the CPU: the
rules that pick rollout2d_cluster_kernel with a member axis
(batched2d.rollout_b_plan) and pg2d_batched_persistent_kernel
(batched2d.pg_b_plan), their bytes, the map of clusters and blocks onto
members, the routes a tensor on the card takes and the counters the
wrappers move, and the (g0, sums) contract of the fused sweep.  The kernels
themselves run only on the card: ``python3 chip_smoke.py`` holds them to the
plain versions and to the per-step kernels there.  No JAX here."""

import contextlib
import dataclasses
import types

import pytest
import torch

from percnn_tpu_torch.core.cell import init_pi_cell
from percnn_tpu_torch.experiments import ensemble
from percnn_tpu_torch.experiments.configs import GS2D_RECON
from percnn_tpu_torch.ops.kernels import _build, backward2d, batched2d, cell2d

CFG = GS2D_RECON.cell        # C = 8, 3 branches, 1x1
N_SM = 132                   # an H100 SXM
HELD16 = 7                   # 16-CTA clusters an H100 80GB HBM3 holds at 100 x 100


def _cfg(**kw):
    return dataclasses.replace(CFG, **kw)


# --- plans --------------------------------------------------------------------

@pytest.mark.parametrize("M, n_cta, threads, smem", [
    (1, 16, 352, 18288), (4, 16, 352, 18288), (7, 16, 352, 18288), (8, 8, 512, 27888),
    (30, 8, 512, 27888)])
def test_rollout_plan_at_gs2d_shape(M, n_cta, threads, smem):
    """16-CTA clusters (rollout_plan's) while the card holds all M at once,
    8-CTA clusters (strips of 12 or 13 rows) past that."""
    assert batched2d.rollout_b_plan(M, 100, 100, CFG, HELD16) == {
        "route": "cluster", "n_cta": n_cta, "threads": threads, "smem": smem, "members": M}
    assert smem == 4 * 172 + 2 * (-(-100 // n_cta) + 4) * 100 * 8


@pytest.mark.parametrize("M, per_member, cap, smem", [
    (1, 132, 76, 13296), (4, 33, 304, 47952), (8, 16, 625, 96744)])
def test_pg_plan_at_gs2d_shape(M, per_member, cap, smem):
    """n_sm // M blocks a member, one an SM; a block's bytes: the 164
    parameters, 6 + 4 C floats a cell of its share, the 272-float
    reduction scratch."""
    assert batched2d.pg_b_plan(M, 100, 100, CFG, N_SM) == {
        "route": "persistent", "blocks": M * per_member, "blocks_a_member": per_member,
        "threads": 512, "smem": smem}
    assert max(c for _, c in cell2d.split_evenly(100 * 100, per_member)) == cap
    assert smem == batched2d.pg_b_smem_bytes(CFG, 100, 100, per_member) == \
        4 * (164 + (6 + 32) * cap + 272)


@pytest.mark.parametrize("n, route16, route8", [(224, "cluster", "cluster"),
                                                (321, "cluster", "cluster"),
                                                (322, "cluster", "cluster"),
                                                (448, "cluster", "cluster"),
                                                (449, "per_step", "per_step")])
def test_rollout_capacity(n, route16, route8):
    """Within rollout_plan's 448 x 448 the batched forward takes clusters;
    where strips of 8 no longer fit (322 x 322 on), past what the card
    holds of 16-CTA clusters the plan keeps 16 and its waves."""
    few, many = (batched2d.rollout_b_plan(M, n, n, CFG, HELD16) for M in (4, 8))
    assert (few["route"], many["route"]) == (route16, route8)
    if route8 == "cluster":
        assert few["n_cta"] == 16
        assert many["n_cta"] == (8 if cell2d.cluster_shape(CFG, n, n, 8) else 16)
        assert (cell2d.cluster_shape(CFG, n, n, 8) is None) == (n >= 322)


@pytest.mark.parametrize("M, n, route", [(8, 155, "persistent"), (8, 156, "per_step"),
                                         (4, 223, "persistent"), (4, 224, "per_step"),
                                         (1, 447, "persistent"), (1, 448, "per_step"),
                                         (132, 2, "persistent"),
                                         (133, 100, "per_step")])
def test_pg_capacity(M, n, route):
    plan = batched2d.pg_b_plan(M, n, n, CFG, N_SM)
    assert plan["route"] == route
    if route == "persistent":
        assert plan["smem"] <= cell2d._MAX_SMEM and plan["blocks"] <= N_SM
    elif M <= N_SM:
        assert batched2d.pg_b_smem_bytes(CFG, n, n, N_SM // M) > cell2d._MAX_SMEM


@pytest.mark.parametrize("hidden, threads", [(1, 512), (2, 512), (3, 384), (4, 512),
                                             (5, 320), (8, 512)])
def test_pg_threads_spread_groups_over_whole_warps(hidden, threads):
    cfg = _cfg(hidden=hidden)
    assert batched2d.pg_b_threads(cfg) == threads
    assert (threads // (2 * hidden)) % 32 == 0
    assert batched2d.pg_b_plan(4, 100, 100, cfg, N_SM)["threads"] == threads


@pytest.mark.parametrize("cfg", [_cfg(hidden=4), _cfg(hidden=16), _cfg(n_branches=2),
                                 _cfg(kernel_size=3, n_branches=5),
                                 _cfg(kernel_size=5, hidden=17)])
def test_other_widths_take_the_per_step_forward(cfg):
    """1x1 cells of other widths than the cluster kernel's, and k x k cells
    past the FFMA kernels' (1 to 4 branches, C <= 16; the k x k widths within
    them take the one-launch FFMA forward: test_torch_batched_ffma_forward_schedule.py)."""
    assert batched2d.rollout_b_plan(4, 100, 100, cfg, HELD16, n_sm=N_SM) == {"route": "per_step"}


@pytest.mark.parametrize("cfg", [_cfg(hidden=9), _cfg(hidden=16), _cfg(n_branches=5),
                                 _cfg(kernel_size=3)])
def test_other_widths_take_the_per_step_sweep(cfg):
    assert batched2d.pg_b_plan(4, 100, 100, cfg, N_SM) == {"route": "per_step"}


@pytest.mark.parametrize("M, H, W, n_cta", [(4, 100, 100, 16), (8, 100, 100, 8),
                                            (3, 17, 9, 8), (2, 5, 7, 2)])
def test_clusters_cover_every_members_frames_once(M, H, W, n_cta):
    """Block x of the launch (M n_cta blocks, clusters of n_cta) is CTA
    x % n_cta of member x // n_cta's cluster, which writes its strip of
    rows (split_evenly) of every frame: every cell of frames[M, T+1, H, W,
    2] is written by one CTA."""
    writes = torch.zeros(M, H, W, dtype=torch.int64)
    strips = cell2d.split_evenly(H, n_cta)
    for x in range(M * n_cta):
        mem, rank = divmod(x, n_cta)
        start, rows = strips[rank]
        assert rows >= 2
        writes[mem, start:start + rows] += 1
    assert bool((writes == 1).all())


@pytest.mark.parametrize("M, H, W", [(4, 100, 100), (8, 100, 100), (3, 17, 9), (2, 16, 16)])
def test_sweep_blocks_cover_every_members_cells_and_partials_once(M, H, W):
    plan = batched2d.pg_b_plan(M, H, W, CFG, N_SM)
    per = plan["blocks_a_member"]
    cells = torch.zeros(M, H * W, dtype=torch.int64)
    partial = torch.zeros(M, per, dtype=torch.int64)
    shares = cell2d.split_evenly(H * W, per)
    for x in range(plan["blocks"]):
        mem, b = divmod(x, per)
        start, n = shares[b]
        cells[mem, start:start + n] += 1
        partial[mem, b] += 1
    assert bool((cells == 1).all()) and bool((partial == 1).all())


# --- routes on the card -------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: to the wrappers, whose
    routing reads nothing but .device, it is a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


COUNTERS = [(batched2d.fused_rollout_2d_batched, "launches"),
            (batched2d.fused_rollout_2d_batched, "steps"),
            (batched2d.fused_rollout_2d_batched, "launches_kxk"),
            (batched2d.fused_phase1_pg_2d_batched, "launches"),
            (batched2d.fused_phase1_pg_2d_batched, "steps")]


def _counts():
    return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in COUNTERS
            if getattr(obj, attr)}


@pytest.fixture
def card(monkeypatch):
    """The library replaced by one that records each entry point called with
    its arguments and launches nothing, a card of 132 SMs that holds 7
    clusters of 16 CTAs, allocations on the card made on the CPU as _OnCard
    tensors, every counter at 0 and the plain versions refused.  Returns
    the calls."""
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
    monkeypatch.setattr(batched2d, "_clusters_held", lambda cfg, H, W: HELD16)
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, on_card(getattr(torch, name)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("fused_rollout_2d_batched_plain", "fused_phase1_pg_2d_batched_plain"):
        monkeypatch.setattr(batched2d, name, no_plain)
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)
    return calls


def _packed(M, cfg=CFG):
    members = [init_pi_cell(torch.Generator().manual_seed(m), cfg, device="cpu")
               for m in range(M)]
    return batched2d.pack_pi_params_2d_batched(ensemble._stack_trees(members),
                                               cfg).as_subclass(_OnCard)


@pytest.mark.parametrize("M, n, steps, entry, n_cta, counts", [
    (4, 100, 7, "cell2d_rollout_cluster", 16,
     {"fused_rollout_2d_batched.launches": 1, "fused_rollout_2d_batched.steps": 7}),
    (8, 100, 7, "cell2d_rollout_cluster", 8,
     {"fused_rollout_2d_batched.launches": 1, "fused_rollout_2d_batched.steps": 7}),
    (4, 100, 0, None, None, {}),
    (2, 449, 3, "batched2d_rollout", None,
     {"fused_rollout_2d_batched.launches": 3, "fused_rollout_2d_batched.steps": 3}),
])
def test_forward_takes_the_planned_route(card, M, n, steps, entry, n_cta, counts):
    """One launch of M clusters a rollout within the plan (none for no
    steps: frame 0 is h0), one rollout2d_batched_kernel launch a step past
    it."""
    h0 = torch.rand(M, n, n, 2).as_subclass(_OnCard)
    frames = batched2d.fused_rollout_2d_batched(_packed(M), h0, CFG, steps)
    assert [name for name, _ in card] == ([entry] if entry else [])
    assert frames.device.type == "cuda" and tuple(frames.shape) == (M, steps + 1, n, n, 2)
    if entry == "cell2d_rollout_cluster":
        args = card[0][1]
        assert args[4:8] == (steps, 0, n, n)                    # n_steps, final_only, H, W
        assert args[12:15] == (n_cta, batched2d.rollout_b_plan(M, n, n, CFG, HELD16)["threads"],
                               M)                              # n_cta, threads, members
    if steps == 0:
        assert torch.equal(frames[:, 0].as_subclass(torch.Tensor), h0.as_subclass(torch.Tensor))
    assert _counts() == counts


@pytest.mark.parametrize("M, n, steps, entry, counts", [
    (4, 100, 6, "batched2d_pg_persistent",
     {"fused_phase1_pg_2d_batched.launches": 1, "fused_phase1_pg_2d_batched.steps": 6}),
    (8, 100, 6, "batched2d_pg_persistent",
     {"fused_phase1_pg_2d_batched.launches": 1, "fused_phase1_pg_2d_batched.steps": 6}),
    (4, 100, 0, "batched2d_pg_persistent", {}),
    (8, 156, 3, "batched2d_pg",
     {"fused_phase1_pg_2d_batched.launches": 3, "fused_phase1_pg_2d_batched.steps": 3}),
])
def test_sweep_takes_the_planned_route(card, M, n, steps, entry, counts):
    """One pg2d_batched_persistent_kernel launch a sweep within pg_b_plan
    (none for no steps: the entry zeroes the partial sums), one
    pg2d_batched_kernel launch a step past it; (g0, sums [M, A]) either
    way."""
    frames = torch.zeros(M, steps + 1, n, n, 2).as_subclass(_OnCard)
    g0, sums = batched2d.fused_phase1_pg_2d_batched(_packed(M), frames, frames, CFG)
    assert [name for name, _ in card] == [entry]
    assert tuple(g0.shape) == (M, n, n, 2) and tuple(sums.shape) == (M, 164)
    if entry == "batched2d_pg_persistent":
        args = card[0][1]
        plan = batched2d.pg_b_plan(M, n, n, CFG, N_SM)
        assert args[7:11] == (M, steps, n, n)
        assert args[15:17] == (plan["blocks_a_member"], plan["threads"])
    assert _counts() == counts


def test_a_cuda_tensor_no_route_takes_raises(card):
    """Five branches: neither the persistent sweep nor pg2d_batched_kernel
    (1 to 4) takes them; the call raises before any entry is reached."""
    cfg = _cfg(n_branches=5)
    frames = torch.zeros(2, 3, 16, 16, 2).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="1 to 4 branches"):
        batched2d.fused_phase1_pg_2d_batched(_packed(2, cfg), frames, frames, cfg)
    assert card == [] and _counts() == {}


@pytest.mark.parametrize("call", ["forward", "sweep", "forward_past_plan", "sweep_past_plan"])
def test_a_loader_error_propagates(monkeypatch, card, call):
    """Whatever the route, a kernel that cannot be loaded raises; nothing
    gives way to another route or to the plain version."""
    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(_build, "load_library", fail_load)
    M, n = (8, 156) if call == "sweep_past_plan" else (2, 449) if call.endswith("plan") else (4, 100)
    frames = torch.zeros(M, 3, n, n, 2).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="loader disabled"):
        if call.startswith("sweep"):
            batched2d.fused_phase1_pg_2d_batched(_packed(M), frames, frames, CFG)
        else:
            batched2d.fused_rollout_2d_batched(_packed(M), frames[:, 0], CFG, 2)
    assert card == [] and _counts() == {}


# --- the (g0, sums) contract on the CPU ---------------------------------------

def _members(M=2, cfg=CFG):
    trees = [init_pi_cell(torch.Generator().manual_seed(3 + m), cfg, device="cpu")
             for m in range(M)]
    return ensemble._stack_trees(trees)


def test_cpu_sweep_returns_the_plain_planes_summed(monkeypatch):
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    g = torch.Generator().manual_seed(1)
    packed = batched2d.pack_pi_params_2d_batched(_members(), CFG)
    h0 = 0.3 * torch.randn(2, 16, 16, 2, generator=g)
    frames = batched2d.fused_rollout_2d_batched(packed, h0, CFG, 6)
    fbar = torch.randn(frames.shape, generator=g)
    g0, sums = batched2d.fused_phase1_pg_2d_batched(packed, frames, fbar, CFG)
    g0_p, acc_p = batched2d.fused_phase1_pg_2d_batched_plain(packed, frames, fbar, CFG)
    assert tuple(acc_p.shape) == (2, 164, 16, 16)
    assert torch.equal(g0, g0_p) and torch.equal(sums, acc_p.sum((2, 3)))
    assert _counts() == {}


def test_sums_give_the_gradients_the_planes_gave():
    """FusedRolloutTP2dBatchedPG's gradients from the sums equal, bit for
    bit, those of the planes summed and unpacked member by member, pulled
    back through the packing."""
    g = torch.Generator().manual_seed(2)
    params = _members()
    leaves = backward2d._cell_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    h0 = (0.3 * torch.randn(2, 16, 16, 2, generator=g)).requires_grad_(True)
    cot = torch.randn(2, 7, 16, 16, 2, generator=g)
    frames = batched2d.fused_rollout_tp_2d_batched_pg(params, h0, CFG, 6)
    got = torch.autograd.grad((frames * cot).sum(), leaves + [h0])

    packed = batched2d.pack_pi_params_2d_batched(params, CFG)
    fr = batched2d.fused_rollout_2d_batched_plain(packed.detach(), h0.detach(), CFG, 6)
    g0, acc = batched2d.fused_phase1_pg_2d_batched_plain(packed.detach(), fr, cot, CFG)
    planes = acc.sum((2, 3))
    d_packed = torch.stack([backward2d._pg_unpack(planes[m], packed[m].detach(), CFG)
                            for m in range(2)])
    want = torch.autograd.grad(packed, leaves, d_packed)
    for a, b in zip(got, list(want) + [g0 + cot[:, 0]]):
        assert torch.equal(a, b)
