"""A PyTorch model of rollout2d_ffma_persistent_kernel with the member axis
(the ensemble's k x k forward in one cooperative launch,
csrc/cell2d_ffma.cu), on the CPU, and the pure-Python side around it:
batched2d.rollout_b_plan's split of the blocks by member (n_sm // M blocks
a member), each block's run of its member's cells (split_evenly), the
rounds of 16-cell tiles balanced as backward2d.adj_b_grid balances them,
each member's operands packed in the kernel's lane order
(cell2d.pack_ffma_fwd_2d, pack_ffma_tail_2d) and read at the indices the
kernel reads them (warp 2 tl + o, lane (pair p, group g): channels 2 p,
2 p + 1 of every branch at the 4 cells 4 g .. 4 g + 3 of tile tl), the
pairs' sums meeting in the kernel's shfl_xor order, frame t + 1 of each
member written by the block that owns the cell.  Each frame starts as NaN,
so a cell no lane writes shows.  The model forms each cell's value by
elementwise tensor ops alone (one chain a tap from the bias, as the
kernel's lanes run), so a cell's arithmetic does not depend on the split;
each member's frames equal the single model's (the same model on
cell2d.ffma_grid's split of one field) to the bit, as the kernel's do on
the card.  The model is held to the plain version
(fused_rollout_2d_batched_plain) and to percnn_tpu's
``_fused_rollout_padded_b`` (its (M, T)-grid Pallas kernel in interpret
mode) at the forward bars, rtol 2e-4 / atol 1e-5: one shape (M = 2,
16 x 16, hidden 4, T = 4), so the Pallas kernel compiles once.  Then the
plan at Burgers' shape, its bytes and capacity, and the routes and counters
of tensors that report a CUDA device with the library faked.  The kernel
itself runs only on the card: ``python3 chip_smoke.py`` holds it there."""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import batched2d as jbatched2d
from percnn_tpu.ops.pallas import cell2d as jcell2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, init_pi_cell
from percnn_tpu_torch.experiments import ensemble
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1
from percnn_tpu_torch.ops.kernels import _build, backward2d, batched2d, cell2d

from test_torch_ffma_schedule import _im2col, _lap, ffma_forward_step

BURGERS = BURGERS_STAGE1.cell   # 5x5, C = 16, 3 branches
N_SM = 132                      # an H100 SXM
M_J, N_J, T_J = 2, 16, 4
CFG_J = dict(ndim=2, hidden=4, kernel_size=5, dt=0.05, dx=0.5, diffusion="sigmoid",
             mu_up=0.1, init_scale=0.3)


def _cfg(k=5, nb=3, hidden=16):
    return dataclasses.replace(BURGERS, kernel_size=k, n_branches=nb, hidden=hidden)


def _packed(cfg, M, seed=0):
    """[M, P]: M random-init cells, packed."""
    trees = [init_pi_cell(torch.Generator().manual_seed(seed + m), cfg, device="cpu")
             for m in range(M)]
    return batched2d.pack_pi_params_2d_batched(ensemble._stack_trees(trees), cfg).detach()


def _fields(M, H, W, seed):
    return torch.as_tensor(0.5 * np.random.RandomState(seed).standard_normal((M, H, W, 2)),
                           dtype=torch.float32)


def _pair_sum(p):
    """The kernel's three shfl_xor steps over the 8 pairs (lane bits 2, 3,
    4 flip pair bits 0, 1, 2), as pair 0 ends them."""
    s01, s23, s45, s67 = p[0] + p[1], p[2] + p[3], p[4] + p[5], p[6] + p[7]
    return (s01 + s23) + (s45 + s67)


def block_step(flat, out, wf, tail, cfg, H, W, first, n_own, rc):
    """One block's step: its rounds of rc cells (rc / 16 tiles), each lane's
    chain over the taps from the bias, the branch products, the w_out sums
    over the lane's 2 channels and then over the 8 pairs, and equation o of
    its own cells of `out` written.  flat, out [H W, 2]; wf, tail one
    member's operands."""
    k, nb = cfg.kernel_size, cfg.n_branches
    taps = k * k * 2
    for base in range(0, n_own, rc):
        cells = base + torch.arange(rc)
        x = _im2col(flat, H, W, first + torch.clamp(cells, max=n_own - 1), k)   # [taps, rc]
        for o in range(2):
            w = wf[:, o].permute(0, 2, 1, 3).reshape(taps + 1, 8, -1)[..., :2 * nb]  # [q, p, f]
            acc = w[taps][:, :, None].expand(8, 2 * nb, rc).clone()             # [p, f, cell]
            for q in range(taps):
                acc = acc + w[q][:, :, None] * x[q][None, None, :]
            acc = acc.unflatten(1, (2, nb))                                     # [p, cl, i, cell]
            prod = acc[:, :, 0]
            for i in range(1, nb):
                prod = prod * acc[:, :, i]
            w_out = tail[2 + 16 * o: 18 + 16 * o].reshape(8, 2)                 # [p, cl]
            p = w_out[:, 1, None] * prod[:, 1] + w_out[:, 0, None] * prod[:, 0]  # [p, cell]
            mine = cells < n_own
            idx = first + cells[mine]
            lap = _lap(flat[:, o], H, W, idx, 1.0 / cfg.dx ** 2)
            pi = _pair_sum(p[:, mine]) + tail[34 + o]
            out[idx, o] = flat[idx, o] + cfg.dt * (tail[o] * lap + pi)


def member_rollout_model(packed, h0, cfg, n_steps, n_sm, order=1):
    """Frames [M, n_steps + 1, H, W, 2] as the member-axis kernel forms them
    on a card of n_sm SMs, rollout_b_plan's blocks of each step run one
    after another (order 1) or in reverse (order -1)."""
    M, H, W = h0.shape[:3]
    plan = batched2d.rollout_b_plan(M, H, W, cfg, n_sm=n_sm)
    assert plan["route"] == "persistent"
    per = plan["blocks_a_member"]
    rc = 16 * (plan["threads"] // 64)
    assert rc == backward2d.adj_b_grid(H, W, per)["rc"]
    wf = torch.stack([cell2d.pack_ffma_fwd_2d(packed[m], cfg) for m in range(M)])
    tail = torch.stack([cell2d.pack_ffma_tail_2d(packed[m], cfg) for m in range(M)])
    frames = torch.full((M, n_steps + 1, H * W, 2), float("nan"))
    frames[:, 0] = h0.reshape(M, H * W, 2)
    shares = cell2d.split_evenly(H * W, per)
    blocks = list(range(plan["blocks"]))[::order]
    for t in range(n_steps):
        for x in blocks:
            mem, b = divmod(x, per)
            first, n_own = shares[b]
            block_step(frames[mem, t], frames[mem, t + 1], wf[mem], tail[mem], cfg, H, W,
                       first, n_own, rc)
    return frames.reshape(M, n_steps + 1, H, W, 2)


def single_rollout_model(packed, h0, cfg, n_steps, n_sm):
    """rollout2d_ffma_persistent_kernel's single model: the same block step
    on cell2d.ffma_grid's split of one field (rounds of up to 8 tiles)."""
    H, W = h0.shape[:2]
    grid = cell2d.ffma_grid(H, W, n_sm)
    wf, tail = cell2d.pack_ffma_fwd_2d(packed, cfg), cell2d.pack_ffma_tail_2d(packed, cfg)
    frames = torch.full((n_steps + 1, H * W, 2), float("nan"))
    frames[0] = h0.reshape(H * W, 2)
    for t in range(n_steps):
        for first, n_own in cell2d.split_evenly(H * W, grid["blocks"]):
            block_step(frames[t], frames[t + 1], wf, tail, cfg, H, W, first, n_own, grid["rc"])
    return frames.reshape(n_steps + 1, H, W, 2)


# --- the model --------------------------------------------------------------

@pytest.mark.parametrize("M, H, W, n_sm", [(2, 17, 9, 7), (3, 12, 10, 132), (2, 20, 24, 4),
                                           (1, 16, 16, 3)])
@pytest.mark.parametrize("k, nb, hidden", [(5, 3, 16), (3, 2, 5), (5, 4, 8)])
def test_member_model_matches_plain_and_the_single_model(M, H, W, n_sm, k, nb, hidden):
    """Three steps: every cell of every member written once a step, the
    frames at the forward bars of the plain version, each member the single
    model's frames to the bit (n_sm = 4 and 7 make a member's block span
    rows and take several rounds; 132 leaves members a block of one or two
    tiles), and the same bits whichever order the blocks run in."""
    cfg = _cfg(k, nb, hidden)
    packed, h0 = _packed(cfg, M), _fields(M, H, W, 1)
    got = member_rollout_model(packed, h0, cfg, 3, n_sm)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, batched2d.fused_rollout_2d_batched_plain(packed, h0, cfg, 3),
                               rtol=2e-4, atol=1e-5)
    for m in range(M):
        assert torch.equal(got[m], single_rollout_model(packed[m], h0[m], cfg, 3, n_sm))
    assert torch.equal(member_rollout_model(packed, h0, cfg, 3, n_sm, order=-1), got)


@pytest.mark.parametrize("H, W, n_sm", [(17, 9, 7), (12, 12, 132)])
def test_single_model_is_the_lane_layout_of_the_ffma_schedule(H, W, n_sm):
    """The chain-of-taps single model and the einsum model of
    tests/test_torch_ffma_schedule.py (the same lanes) agree at the forward
    bars."""
    cfg = _cfg()
    packed, h0 = _packed(cfg, 1)[0], _fields(1, H, W, 2)[0]
    got = single_rollout_model(packed, h0, cfg, 1, n_sm)[1]
    want = ffma_forward_step(h0, cell2d.pack_ffma_fwd_2d(packed, cfg),
                             cell2d.pack_ffma_tail_2d(packed, cfg), cfg, n_sm)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jax_frames():
    """percnn_tpu's _fused_rollout_padded_b (interpret mode): M = 2 members of
    percnn_tpu's init, 16 x 16, T = 4."""
    jcfg = JPiCellConfig(**CFG_J)
    members = [j_init_pi_cell(jax.random.PRNGKey(21 + m), jcfg) for m in range(M_J)]
    jp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs).astype(jnp.float32), *members)
    h0 = (0.3 * np.random.RandomState(22).standard_normal((M_J, N_J, N_J, 2))).astype(np.float32)
    packed_j = jax.vmap(lambda p: jcell2d.pack_pi_params_2d(p, jcfg))(jp)
    h0_pad = jax.vmap(jcell2d.pad_state_2d)(jnp.asarray(h0))
    frames_pad = jbatched2d._fused_rollout_padded_b(packed_j, h0_pad, cfg=jcfg, n_steps=T_J,
                                                    H=N_J, W=N_J, interpret=True)
    want = np.asarray(jax.vmap(lambda f: jcell2d.unpad_frames_2d(f, N_J, N_J))(frames_pad))
    cfg = PiCellConfig(**CFG_J)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    packed = batched2d.pack_pi_params_2d_batched(params, cfg)
    return cfg, packed, torch.from_numpy(h0), want


@pytest.mark.parametrize("n_sm", [2, 7, 132])
def test_member_model_gives_percnn_tpu_frames(jax_frames, n_sm):
    """Frames 1 .. T at the forward bars of percnn_tpu's (M, T)-grid kernel:
    one block a member at n_sm = 2 (two rounds of 128 cells), 3 a member at
    7, 66 a member of 3 or 4 cells at 132."""
    cfg, packed, h0, want = jax_frames
    got = member_rollout_model(packed, h0, cfg, T_J, n_sm)
    assert torch.equal(got[:, 0], h0)
    np.testing.assert_allclose(got[:, 1:].numpy(), want, rtol=2e-4, atol=1e-5)


# --- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("M, per_member, cap, threads, smem", [
    (1, 132, 76, 320, 47248), (2, 66, 152, 320, 48080), (4, 33, 304, 448, 56144),
    (8, 16, 625, 512, 61840)])
def test_plan_at_burgers_shape(M, per_member, cap, threads, smem):
    """n_sm // M blocks a member, one an SM; a block's cap / 16 tiles in the
    fewest rounds of at most 8, the same number each (152 cells: 2 rounds
    of 5 tiles, not 8 + 2); at M = 1 the single model's grid (ffma_plan)."""
    plan = batched2d.rollout_b_plan(M, 100, 100, BURGERS, n_sm=N_SM)
    assert plan == {"route": "persistent", "blocks": M * per_member,
                    "blocks_a_member": per_member, "threads": threads, "smem": smem}
    assert max(c for _, c in cell2d.split_evenly(100 * 100, per_member)) == cap
    tiles, rounds = threads // 64, -(-cap // (16 * (threads // 64)))
    assert rounds == -(-(-(-cap // 16)) // 8) and tiles * rounds * 16 - cap < 16 * rounds
    grid = backward2d.adj_b_grid(100, 100, per_member)
    assert smem == batched2d.rollout_b_smem_bytes(BURGERS, 100, 100, per_member) == (
        4 * (51 * 2 * 8 * 8 + 36 + 50 * 16 * tiles) + grid["tile_bytes"])
    if M == 1:
        assert {k: plan[k] for k in ("blocks", "threads", "smem")} == {
            k: v for k, v in cell2d.ffma_plan(100, 100, BURGERS, N_SM).items() if k != "route"}


@pytest.mark.parametrize("M, n, route", [(2, 1056, "persistent"), (2, 1057, "per_step"),
                                         (4, 774, "persistent"), (4, 775, "per_step"),
                                         (132, 16, "persistent"), (133, 16, "per_step"),
                                         (8, 3, "persistent")])
def test_plan_capacity(M, n, route):
    """The largest square fields the plan admits at M = 2 and 4 (the
    docstring's), every member at least one block, at most one a cell."""
    plan = batched2d.rollout_b_plan(M, n, n, BURGERS, n_sm=N_SM)
    assert plan["route"] == route
    if route == "persistent":
        assert plan["smem"] <= cell2d._MAX_SMEM and plan["blocks"] <= N_SM
        assert plan["blocks_a_member"] <= n * n
    elif M <= N_SM:
        assert batched2d.rollout_b_smem_bytes(BURGERS, n, n, N_SM // M) > cell2d._MAX_SMEM


@pytest.mark.parametrize("cfg, route", [(_cfg(3, 1, 4), "persistent"), (_cfg(5, 4, 16), "persistent"),
                                        (_cfg(5, 3, 17), "per_step"), (_cfg(5, 5, 8), "per_step"),
                                        (_cfg(7, 3, 8), "per_step")])
def test_plan_other_widths(cfg, route):
    """The FFMA kernels are built for k = 3 or 5, 1 to 4 branches, C <= 16."""
    assert batched2d.rollout_b_plan(2, 100, 100, cfg, n_sm=N_SM)["route"] == route


# --- routes and counters on a faked card -------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: to the wrappers, whose
    routing reads nothing but .device, it is a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


COUNTERS = [(batched2d.fused_rollout_2d_batched, a) for a in ("launches", "steps",
                                                              "launches_kxk", "steps_kxk")]


def _counts():
    return {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in COUNTERS
            if getattr(obj, attr)}


@pytest.fixture
def card(monkeypatch):
    """The libraries replaced by one that records each entry point called
    with its arguments and launches nothing, a card of 132 SMs, allocations
    on the card made on the CPU as _OnCard tensors, every counter at 0 and
    the plain version refused.  Returns the calls."""
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

    monkeypatch.setattr(batched2d, "fused_rollout_2d_batched_plain", no_plain)
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)
    return calls


@pytest.mark.parametrize("M, n, steps, mxu, entry, counts", [
    (2, 100, 7, True, "cell2d_ffma_rollout_members",
     {"fused_rollout_2d_batched.launches_kxk": 1, "fused_rollout_2d_batched.steps_kxk": 7}),
    (4, 100, 5, False, "cell2d_ffma_rollout_members",
     {"fused_rollout_2d_batched.launches_kxk": 1, "fused_rollout_2d_batched.steps_kxk": 5}),
    (3, 17, 0, True, "cell2d_ffma_rollout_members", {}),
    (2, 1057, 3, True, "batched2d_rollout",
     {"fused_rollout_2d_batched.launches_kxk": 3, "fused_rollout_2d_batched.steps_kxk": 3}),
    (133, 8, 2, True, "batched2d_rollout",
     {"fused_rollout_2d_batched.launches_kxk": 2, "fused_rollout_2d_batched.steps_kxk": 2}),
])
def test_forward_takes_the_planned_route(monkeypatch, card, M, n, steps, mxu, entry, counts):
    """One launch a rollout within rollout_b_plan, whatever the MXU switch
    says (none for no steps: the entry copies frame 0 and launches
    nothing), one rollout2d_batched_kernel launch a step past it; each
    member's packed operands stacked [M, ...]."""
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", mxu)
    packed = _packed(BURGERS, M).as_subclass(_OnCard)
    h0 = torch.rand(M, n, n, 2).as_subclass(_OnCard)
    frames = batched2d.fused_rollout_2d_batched(packed, h0, BURGERS, steps)
    assert [name for name, _ in card] == [entry]
    assert frames.device.type == "cuda" and tuple(frames.shape) == (M, steps + 1, n, n, 2)
    args = card[0][1]
    if entry == "cell2d_ffma_rollout_members":
        plan = batched2d.rollout_b_plan(M, n, n, BURGERS, n_sm=N_SM)
        assert args[4:10] == (M, steps, n, n, 3, 5)      # M, n_steps, H, W, n_branches, k
        assert args[12:15] == (plan["blocks_a_member"], plan["threads"], plan["smem"])
    else:
        assert args[4:6] == (M, steps)
    assert _counts() == counts


def test_the_operands_are_each_members_stacked(monkeypatch, card):
    """wf and tail reach the entry as [M, ...] stacks of each member's
    pack_ffma_fwd_2d and pack_ffma_tail_2d, in member order."""
    seen = {}

    def data_ptr(self):
        seen[id(self)] = self
        return id(self)

    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    packed = _packed(BURGERS, 3)
    batched2d.fused_rollout_2d_batched(packed.as_subclass(_OnCard),
                                       torch.rand(3, 17, 9, 2).as_subclass(_OnCard), BURGERS, 2)
    wf, tail = (seen[a].as_subclass(torch.Tensor) for a in card[0][1][:2])
    assert tuple(wf.shape) == (3, 51, 2, 2, 8, 4) and tuple(tail.shape) == (3, 36)
    for m in range(3):
        assert torch.equal(wf[m], cell2d.pack_ffma_fwd_2d(packed[m], BURGERS))
        assert torch.equal(tail[m], cell2d.pack_ffma_tail_2d(packed[m], BURGERS))


@pytest.mark.parametrize("n", [100, 1057])
def test_a_loader_error_propagates(monkeypatch, card, n):
    """Within the plan or past it, a kernel that cannot be loaded raises;
    nothing gives way to another route or to the plain version."""
    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(_build, "load_library", fail_load)
    with pytest.raises(RuntimeError, match="loader disabled"):
        batched2d.fused_rollout_2d_batched(_packed(BURGERS, 2).as_subclass(_OnCard),
                                           torch.rand(2, n, n, 2).as_subclass(_OnCard),
                                           BURGERS, 2)
    assert card == [] and _counts() == {}


def test_cpu_rollout_moves_no_counter(monkeypatch):
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    packed, h0 = _packed(BURGERS, 2), _fields(2, 12, 12, 3)
    frames = batched2d.fused_rollout_2d_batched(packed, h0, BURGERS, 2)
    assert torch.equal(frames, batched2d.fused_rollout_2d_batched_plain(packed, h0, BURGERS, 2))
    assert _counts() == {}
