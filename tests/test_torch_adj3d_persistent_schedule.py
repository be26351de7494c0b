"""A PyTorch model of adj3d_persistent_kernel's schedule (GS3D's streaming
sweep in one cooperative launch: csrc/backward3d.cu's persistent_sweep3d
without the accumulators), on the CPU, and the pure-Python side around it:
backward3d.adj3d_plan's blocks, each block's run of the flat D H W field
(split_evenly), a reverse step's window of g_{t+1} (the run with two rows
of W cells on each side, staged from the live buffer), the depth
neighbours and a height neighbour that wraps around its plane read from
the live buffer itself, the Laplacians as the kernel splits them
(Lap g_{t+1} + Lap fbar_{t+1}, 13 points each, in stencil13's order), the
Jacobian's transpose in pg_accumulate's order, g_in streamed to g_ins[t],
and the g ping-pong that makes step 0 write g0.  The blocks run one after
another in live buffers (g_ins filled with NaN until written, the two g
buffers zeroed as the wrapper zeroes them), so a block that read what
another wrote in the same step would read a different value.  The model
is held to the plain sweep (fused_phase1_3d_plain) and to percnn_tpu's
``_fused_phase1_3d`` (its Pallas kernel in interpret mode) at the gradient
bars, rtol 2e-4 / atol 2e-6, on 8 x 16 x 8 with T <= 6 (the JAX 3D kernels
need D % 8 == 0 and H W % 128 == 0; one shape, so the Pallas kernel
compiles once).  Then the plan at GS3D's shape, its bytes, its capacity
rule and the other widths, and the routes and counters of tensors that
report a CUDA device with the library faked.  The kernel itself runs only
on the card: ``python3 chip_smoke.py`` holds it there, and its g0 to
pg3d_persistent_kernel's to the bit."""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas import backward3d as jbackward3d
from percnn_tpu.ops.pallas import cell3d as jcell3d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, init_pi_cell
from percnn_tpu_torch.experiments.configs import GS3D_RECON
from percnn_tpu_torch.ops.kernels import _build, backward2d, backward3d, cell2d, cell3d

RTOL, ATOL = 2e-4, 2e-6
D, H, W = 8, 16, 8
T = 6
KW = dict(ndim=3, hidden=2, kernel_size=1, dt=0.05, dx=2.08, diffusion="sigmoid",
          mu_up=0.3, init_scale=0.3)
CFG = GS3D_RECON.cell          # C = 2, 3 branches: the widths the kernel is built for
N_SM = 132                     # an H100 SXM
# SMs of the modelled card: 1 block of 1024 cells (two a thread), 3 of 341
# or 342, 7 of 146 or 147, 132 of 7 or 8 (runs much shorter than a row)
N_SMS = (1, 3, 7, 132)
THREADS = 512


def _lap13(x, inv_dx2):
    """backward3d.cu's lap13 over the 13 points (centre, the six at
    distance 1, the six at distance 2)."""
    s1 = x[1] + x[2] + x[3] + x[4] + x[5] + x[6]
    s2 = x[7] + x[8] + x[9] + x[10] + x[11] + x[12]
    return (-7.5 * x[0] + (4.0 / 3.0) * s1 - (1.0 / 12.0) * s2) * inv_dx2


def _stencil13(idx, d_, h_, w_):
    """stencil13's points of the cells idx, in its order, wrapped."""
    hw = h_ * w_
    d, r = idx // hw, idx % hw
    i, j = r // w_, r % w_
    at = lambda dd, di, dj: ((d + dd) % d_) * hw + ((i + di) % h_) * w_ + (j + dj) % w_  # noqa: E731
    return [at(0, 0, 0), at(1, 0, 0), at(-1, 0, 0), at(0, 1, 0), at(0, -1, 0), at(0, 0, 1),
            at(0, 0, -1), at(2, 0, 0), at(-2, 0, 0), at(0, 2, 0), at(0, -2, 0), at(0, 0, 2),
            at(0, 0, -2)]


def _jacobian_t(packed, u, v, gin, cfg):
    """pg_accumulate's (du, dv): per equation o, hidden channel c, branch
    b, (w_b[0, c] w_out[c]) zz and (w_b[1, c] w_out[c]) zz added in that
    order, zz = g_o (prod_{j < b} y_j prod_{j > b} y_j)."""
    C, nb = cfg.hidden, cfg.n_branches
    stride, block = 3 * C, cell2d._param_block(cfg)
    du, dv = torch.zeros_like(u), torch.zeros_like(u)
    for o in range(2):
        p = packed[2 + o * block: 2 + (o + 1) * block]
        g = gin[:, o]
        for c in range(C):
            y = [p[b * stride + c] * u + p[b * stride + C + c] * v + p[b * stride + 2 * C + c]
                 for b in range(nb)]
            pre, suf = [torch.ones_like(u)], [torch.ones_like(u)]
            for b in range(nb):
                pre.append(pre[-1] * y[b])
            for b in range(nb - 1, -1, -1):
                suf.insert(0, suf[0] * y[b])
            wo = p[nb * stride + c]
            for b in range(nb):
                zz = g * (pre[b] * suf[b + 1])
                du = du + (p[b * stride + c] * wo) * zz
                dv = dv + (p[b * stride + C + c] * wo) * zz
    return du, dv


def adj3d_persistent_model(packed, frames, frames_bar, cfg, n_sm, order=1):
    """(g_ins [T, D, H, W, 2], g0 [D, H, W, 2]) as adj3d_persistent_kernel
    forms them on a card of n_sm SMs, the blocks of each step run one after
    another (order 1) or in reverse (order -1)."""
    n_steps, d_, h_, w_ = frames.shape[0] - 1, *frames.shape[1:4]
    plan = backward3d.adj3d_plan(d_, h_, w_, cfg, n_sm)
    assert plan["route"] == "persistent"
    hw, cells = h_ * w_, d_ * h_ * w_
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    bufs = {"g0": torch.zeros(cells, 2), "scratch": torch.zeros(cells, 2)}
    g_ins = torch.full((n_steps, cells, 2), float("nan"))
    shares = cell2d.split_evenly(cells, plan["blocks"])
    assert max(n for _, n in shares) <= 2 * THREADS
    for s in range(n_steps):
        t = n_steps - 1 - s
        dst, src = ("g0", "scratch") if t % 2 == 0 else ("scratch", "g0")
        h = frames[t].reshape(cells, 2)
        fbar = frames_bar[t + 1].reshape(cells, 2)
        for first, n_own in shares[::order]:
            live = bufs[src]
            # the window: the run with 2 W cells on each side, staged at the
            # step's start
            mid = live[(first - 2 * w_ + torch.arange(n_own + 4 * w_)) % cells].clone()
            own = torch.arange(n_own)
            idx = first + own
            i, j = (idx % hw) // w_, idx % w_
            c = own + 2 * w_

            def height(di):
                inside = (i + di >= 0) & (i + di < h_)
                wrapped = live[(idx + di * w_ - int(np.sign(di)) * hw) % cells]
                return torch.where(inside[:, None], mid[(c + di * w_).clamp(0, len(mid) - 1)],
                                   wrapped)

            def width(dj):
                step = torch.where((j + dj >= 0) & (j + dj < w_), dj, dj - int(np.sign(dj)) * w_)
                return mid[c + step]

            def plane(shift):
                return live[(idx + shift) % cells]

            x = [mid[c], plane(hw), plane(-hw), height(1), height(-1), width(1), width(-1),
                 plane(2 * hw), plane(-2 * hw), height(2), height(-2), width(2), width(-2)]
            fb = [fbar[n] for n in _stencil13(idx, d_, h_, w_)]
            gin = x[0] + fb[0]
            lap = torch.stack([_lap13([p[:, e] for p in x], inv_dx2)
                               + _lap13([p[:, e] for p in fb], inv_dx2) for e in range(2)], -1)
            du, dv = _jacobian_t(packed, h[idx, 0], h[idx, 1], gin, cfg)
            g_ins[t, idx] = gin
            bufs[dst][idx] = torch.stack([gin[:, 0] + cfg.dt * (packed[0] * lap[:, 0] + du),
                                          gin[:, 1] + cfg.dt * (packed[1] * lap[:, 1] + dv)], -1)
    return (g_ins.reshape(n_steps, d_, h_, w_, 2), bufs["g0"].reshape(d_, h_, w_, 2))


def _inputs(n_steps, seed):
    """The GS3D-width cell (percnn_tpu's init), frames of its plain rollout
    and a standard-normal cotangent."""
    jcfg = JPiCellConfig(**KW)
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    cfg = PiCellConfig(**KW)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    packed = cell3d.pack_pi_params_3d(params, cfg).detach()
    expanded = cell3d.pack_pi_expanded_3d(params, cfg).detach()
    h0 = torch.as_tensor(0.5 + 0.2 * np.random.RandomState(seed + 1).standard_normal(
        (D, H, W, 2)), dtype=torch.float32)
    frames = cell3d.fused_rollout_3d_plain(expanded, h0, n_steps)
    fbar = torch.as_tensor(np.random.RandomState(seed + 2).standard_normal(
        (n_steps + 1, D, H, W, 2)), dtype=torch.float32)
    return jcfg, jp, cfg, packed, frames, fbar


def _assert_at_bar(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("n_steps", [5, T])
@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_matches_the_plain_sweep(n_sm, n_steps):
    """g_ins and g0 at the gradient bars of the plain sweep, every entry
    written (no NaN left), and the same bits whichever order the blocks of
    a step run in (an odd and an even T: the ping-pong ends in g0 both
    ways)."""
    _, _, cfg, packed, frames, fbar = _inputs(n_steps, 3)
    got = adj3d_persistent_model(packed, frames, fbar, cfg, n_sm)
    want = backward3d.fused_phase1_3d_plain(packed, frames, fbar, cfg)
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        _assert_at_bar(a, b)
    for a, b in zip(adj3d_persistent_model(packed, frames, fbar, cfg, n_sm, order=-1), got):
        assert torch.equal(a, b)


def test_schedule_does_not_depend_on_the_split():
    """The model's arithmetic at a cell is the same whichever block owns it:
    its outputs on 3, 7 and 132 blocks are one another's to the bit."""
    _, _, cfg, packed, frames, fbar = _inputs(4, 5)
    outs = [adj3d_persistent_model(packed, frames, fbar, cfg, n) for n in (3, 7, 132)]
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            assert torch.equal(a, b)


def _flat3(a):
    return jnp.moveaxis(jnp.asarray(a), -1, 1).reshape(a.shape[0], 2, D, H * W)


def _unflat3(a):
    return np.moveaxis(np.asarray(a).reshape(-1, 2, D, H, W), 1, -1)


@pytest.fixture(scope="module")
def jax_sweep():
    """percnn_tpu's _fused_phase1_3d (interpret mode, flat [D, H W] layout)
    on the inputs of seed 7."""
    jcfg, jp, cfg, packed, frames, fbar = _inputs(T, 7)
    gins_j, g0_j = jbackward3d._fused_phase1_3d(
        jcell3d.pack_pi_params_3d(jp, jcfg), _flat3(frames[:-1].numpy()),
        _flat3(fbar[1:].numpy()), cfg=jcfg, n_steps=T, D=D, H=H, W=W, interpret=True)
    return (cfg, packed, frames, fbar), (_unflat3(gins_j), _unflat3(g0_j)[0])


@pytest.mark.parametrize("n_sm", N_SMS)
def test_schedule_gives_percnn_tpu_sweep(jax_sweep, n_sm):
    (cfg, packed, frames, fbar), want = jax_sweep
    got = adj3d_persistent_model(packed, frames, fbar, cfg, n_sm)
    assert got[0].shape == (T, D, H, W, 2) and got[1].shape == (D, H, W, 2)
    for a, b in zip(got, want):
        _assert_at_bar(a, b)


# --- the plan -----------------------------------------------------------------

def test_plan_at_gs3d_shape():
    """pg3d_plan's blocks (132 of 837 or 838 cells) and 512 threads, a
    block's bytes the 44 parameters and g's window alone: 8 416 against
    pg3d_plan's 155 904."""
    n = GS3D_RECON.grid
    assert backward3d.adj3d_plan(n, n, n, CFG, N_SM) == {
        "route": "persistent", "blocks": 132, "smem": 8416}
    assert backward3d.adj3d_smem_bytes(CFG, n, n, n, N_SM) == 4 * 44 + 8 * (838 + 4 * 48)
    pg = backward3d.pg3d_plan(n, n, n, CFG, N_SM)
    assert pg["blocks"] == 132 and pg["smem"] - 8416 == 4 * 44 * 838


@pytest.mark.parametrize("n, route", [(48, "persistent"), (51, "persistent"),
                                      (52, "per_step"), (64, "per_step"), (5, "persistent")])
def test_capacity_rule(n, route):
    """A thread takes at most two cells (1024 a block of 512): 51^3 on 132
    SMs, what pg3d_plan takes; the bytes, 9 848 at 51^3, bind no more."""
    plan = backward3d.adj3d_plan(n, n, n, CFG, N_SM)
    assert plan["route"] == route
    assert (-(-n ** 3 // min(N_SM, n ** 3)) <= 2 * THREADS) == (route == "persistent")
    assert backward3d.pg3d_plan(n, n, n, CFG, N_SM)["route"] == route
    assert backward3d.adj3d_smem_bytes(CFG, n, n, n, N_SM) <= cell2d._MAX_SMEM


@pytest.mark.parametrize("hidden, n_branches", [(4, 3), (1, 3), (2, 2), (2, 4)])
def test_other_widths_take_the_per_step_sweep(hidden, n_branches):
    """adj3d_persistent_kernel is compiled for C = 2 and 3 branches; any
    other cell takes adj3d_kernel, whatever the shape."""
    cfg = dataclasses.replace(CFG, hidden=hidden, n_branches=n_branches)
    assert backward3d.adj3d_plan(16, 16, 16, cfg, N_SM) == {"route": "per_step"}


@pytest.mark.parametrize("n", [48, 16, 5])
def test_every_cell_owned_once(n):
    cells = n ** 3
    for n_sm in (1, 7, 64, N_SM):
        plan = backward3d.adj3d_plan(n, n, n, CFG, n_sm)
        if plan["route"] != "persistent":
            continue
        seen = np.zeros(cells, dtype=int)
        for start, count in cell2d.split_evenly(cells, plan["blocks"]):
            seen[start:start + count] += 1
        assert (seen == 1).all() and plan["blocks"] == min(n_sm, cells)


# --- routes and counters on a faked card -------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: to the wrappers, whose
    routing reads nothing but .device, it is a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


COUNTERS = [(backward3d.fused_phase1_3d, "launches"), (backward3d.fused_phase1_3d, "steps")]


@pytest.fixture
def card(monkeypatch):
    """The library replaced by one that records each entry point called
    with its arguments and launches nothing, a card of 132 SMs, allocations
    on the card made on the CPU as _OnCard tensors, the counters at 0 and
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
    monkeypatch.setattr(backward3d, "_sm_count", lambda device: N_SM)
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, on_card(getattr(torch, name)))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(backward3d, "fused_phase1_3d_plain", no_plain)
    for obj, attr in COUNTERS:
        monkeypatch.setattr(obj, attr, 0)
    return calls


def _packed_on_card(cfg=CFG):
    params = init_pi_cell(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cell3d.pack_pi_params_3d(params, cfg).detach().as_subclass(_OnCard)


@pytest.mark.parametrize("shape, steps, entry, launches", [
    ((48, 48, 48), 12, "backward3d_adj_persistent", 1),
    ((51, 51, 51), 4, "backward3d_adj_persistent", 1),
    ((5, 6, 7), 0, "backward3d_adj_persistent", 0),
    ((52, 52, 52), 3, "backward3d_adj", 3),
])
def test_cuda_sweep_takes_the_planned_route(card, shape, steps, entry, launches):
    """One adj3d_persistent_kernel launch a sweep within adj3d_plan (none
    for no steps: g0 stays zeroed), one adj3d_kernel launch a step past
    it; (g_ins, g0) either way, the steps counted."""
    frames = torch.zeros((steps + 1,) + shape + (2,)).as_subclass(_OnCard)
    g_ins, g0 = backward3d.fused_phase1_3d(_packed_on_card(), frames, frames, CFG)
    assert [name for name, _ in card] == [entry]
    assert g_ins.device.type == g0.device.type == "cuda"
    assert tuple(g_ins.shape) == (steps,) + shape + (2,) and tuple(g0.shape) == shape + (2,)
    args = card[0][1]
    assert args[7:13] == (steps,) + shape + (2, 3)       # n_steps, D, H, W, hidden, n_branches
    if entry == "backward3d_adj_persistent":
        assert args[15] == backward3d.adj3d_plan(*shape, CFG, N_SM)["blocks"]
    assert (backward3d.fused_phase1_3d.launches, backward3d.fused_phase1_3d.steps) == (
        launches, steps)


def test_other_widths_take_adj3d_kernel_on_the_card(card):
    cfg = dataclasses.replace(CFG, hidden=4)
    frames = torch.zeros(4, 16, 16, 16, 2).as_subclass(_OnCard)
    backward3d.fused_phase1_3d(_packed_on_card(cfg), frames, frames, cfg)
    assert [name for name, _ in card] == ["backward3d_adj"]
    assert (backward3d.fused_phase1_3d.launches, backward3d.fused_phase1_3d.steps) == (3, 3)


@pytest.mark.parametrize("n", [48, 52])
def test_a_loader_error_propagates(monkeypatch, card, n):
    """Within the plan or past it, a kernel that cannot be loaded raises;
    nothing gives way to another route or to the plain version."""
    def fail_load(name):
        raise RuntimeError(f"loader disabled ({name})")

    monkeypatch.setattr(_build, "load_library", fail_load)
    frames = torch.zeros(3, n, n, n, 2).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="loader disabled"):
        backward3d.fused_phase1_3d(_packed_on_card(), frames, frames, CFG)
    assert card == [] and backward3d.fused_phase1_3d.launches == 0
