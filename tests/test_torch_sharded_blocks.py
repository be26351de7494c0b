"""The decomposed rollout's one-launch routes on the CPU: step_blocks_2d (every
block of a device in one launch) and rollout_blocks_2d (every block on one
device through the whole rollout in one launch), through
sharded_rollout_nd(impl="pallas") against percnn_tpu's on the 8 virtual
host devices, in two groupings of the blocks: all on one device, and every
block its own device (the strip path: each device reads its neighbours'
edge rows, columns and corners from strips).  Their plain versions against
step_haloed_2d_plain on halo_exchange's blocks, the route rule, and the
dispatch rule (a CPU tensor launches nothing, a CUDA one never reaches a
plain version).

Every block is 6 x 10, narrower than the k x k kernels' 8 x 16 tile.  The
CUDA kernels run only on the card: ``python3 chip_smoke.py`` holds them to
their plain versions there, as the last test does when a card is present.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from percnn_tpu.parallel.sharded import sharded_rollout_nd as j_sharded_rollout_nd

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import _build, cell2d, sharded_step2d
from percnn_tpu_torch.parallel import (
    halo_exchange,
    make_mesh,
    pi_cell_step_haloed,
    sharded,
    sharded_rollout_nd,
)
from percnn_tpu_torch.parallel.halo import object_grid

MESH = (2, 4)
FIELD = (12, 40, 2)          # 6 x 10 blocks on the (2, 4) mesh
STEPS = 4


def _kw(k):
    return dict(ndim=2, hidden=4, kernel_size=k, dt=0.01, dx=0.1, diffusion="raw",
                diff_init=0.05, init_scale=0.1)


def _pair(k, seed=0):
    jcfg = JPiCellConfig(**_kw(k))
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, PiCellConfig(**_kw(k)), tp


def _field(shape, seed):
    return (0.3 * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _leaves(tp):
    """The port's leaves in jax.tree_util's order (dict keys sorted)."""
    return [tp["diff"]] + [br[k] for br in tp["pi"] for k in sorted(br)]


def _own_device(devices):
    """Every block its own group: the strip path, on one device."""
    return [(devices[idx], [idx]) for idx in np.ndindex(devices.shape)]


@pytest.fixture
def grouping(request, monkeypatch):
    if request.param == "own_device":
        monkeypatch.setattr(sharded, "_group_blocks", _own_device)
    return request.param


def _mesh(shape):
    return make_mesh(("x", "y"), shape=shape, devices=["cpu"] * int(np.prod(shape)))


@functools.cache
def _jax_reference(k):
    """percnn_tpu's impl="pallas" rollout on the (2, 4) mesh: frames, the
    loss and the gradient of every leaf and of h0."""
    jcfg, jp, _, _ = _pair(k, seed=3)
    h0, tgt = _field(FIELD, 5), _field((STEPS + 1,) + FIELD, 6)
    jmesh = j_make_mesh(("x", "y"), shape=MESH)

    def jloss(p, h):
        fr = j_sharded_rollout_nd(p, h, jcfg, STEPS, jmesh, impl="pallas")
        return jnp.mean((fr - tgt) ** 2), fr

    (jl, jfr), (jgp, jgh) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(h0))
    grads = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgp)] + [np.asarray(jgh)]
    return np.asarray(jfr), float(jl), grads


@pytest.mark.parametrize("grouping", ["one_device", "own_device"], indirect=True)
@pytest.mark.parametrize("k", [1, 5])
def test_rollout_matches_jax(k, grouping):
    """Frames without a gradient (one launch a call on one device; one a
    device and step with strips), then frames, loss and the gradient of every
    leaf and of h0 (one launch a device and step) against percnn_tpu's."""
    jfr, jl, jgrads = _jax_reference(k)
    _, _, cfg, tp = _pair(k, seed=3)
    h0, tgt = _field(FIELD, 5), torch.from_numpy(_field((STEPS + 1,) + FIELD, 6))
    mesh = _mesh(MESH)
    with torch.no_grad():
        fr = sharded_rollout_nd(tp, torch.from_numpy(h0), cfg, STEPS, mesh, impl="pallas")
    np.testing.assert_allclose(fr.numpy(), jfr, rtol=2e-4, atol=1e-5)
    leaves = _leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(h0).requires_grad_(True)
    fr_g = sharded_rollout_nd(tp, x, cfg, STEPS, mesh, impl="pallas")
    loss = ((fr_g - tgt) ** 2).mean()
    got = torch.autograd.grad(loss, leaves + [x])
    assert torch.equal(fr_g.detach(), fr)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=2e-4)
    for a, b in zip(got, jgrads):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-6)


def _rollouts(tp, h0, cfg, mesh, monkeypatch):
    """Frames by route 2 (one group, no gradient), by route 1 on one group,
    and by route 1 with every block its own group."""
    with torch.no_grad():
        one_launch = sharded_rollout_nd(tp, h0, cfg, STEPS, mesh, impl="pallas")
        with monkeypatch.context() as m:
            m.setattr(sharded, "_one_launch", lambda *args: False)
            per_step = sharded_rollout_nd(tp, h0, cfg, STEPS, mesh, impl="pallas")
            m.setattr(sharded, "_group_blocks", _own_device)
            strips = sharded_rollout_nd(tp, h0, cfg, STEPS, mesh, impl="pallas")
    return one_launch, per_step, strips


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 1), (2, 2), (1, 1)])
def test_routes_and_groupings_equal_exactly(k, mesh_shape, monkeypatch):
    """Mesh axes of one block (the halo wraps onto the block itself) and of
    two (the same neighbour on both sides): the three ways equal to the bit,
    and the periodic single-field rollout to rounding."""
    _, _, cfg, tp = _pair(k, seed=4)
    h0 = torch.from_numpy(_field((6 * mesh_shape[0], 10 * mesh_shape[1], 2), 7))
    one_launch, per_step, strips = _rollouts(tp, h0, cfg, _mesh(mesh_shape), monkeypatch)
    assert one_launch.shape == (STEPS + 1,) + tuple(h0.shape)
    assert torch.equal(one_launch, per_step) and torch.equal(per_step, strips)
    want = cell2d.fused_rollout_2d_plain(cell2d.pack_pi_params_2d(tp, cfg), h0, cfg, STEPS)
    torch.testing.assert_close(one_launch, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("k", [1, 5])
def test_plain_versions_match_the_exchange(k):
    """Every layout's haloed blocks are halo_exchange's to the bit, corners
    included, and the plain step on them is step_haloed_2d_plain's."""
    _, _, cfg, tp = _pair(k, seed=5)
    packed = cell2d.pack_pi_params_2d(tp, cfg)
    h0 = torch.from_numpy(_field(FIELD, 8))
    h, w = 6, 10
    blocks = object_grid(MESH, [h0[i * h:(i + 1) * h, j * w:(j + 1) * w]
                                for i in range(MESH[0]) for j in range(MESH[1])])
    xp = halo_exchange(blocks, mesh=_mesh(MESH), axis_names=("x", "y"), array_axes=(0, 1))
    want_xp = torch.stack(list(xp.flat))
    want = torch.stack([sharded_step2d.step_haloed_2d_plain(packed, x, cfg) for x in xp.flat])
    # the one-launch layout: the blocks read from and written to the field
    field = sharded._field_layout(MESH, h, w)
    none = h0.new_empty((0, 2))
    assert torch.equal(sharded_step2d.haloed_blocks(h0, none, field), want_xp)
    frames = sharded_step2d.rollout_blocks_2d_plain(packed, h0, field, cfg, 1)
    assert torch.equal(frames[0], h0)
    assert torch.equal(frames[1], torch.cat([torch.cat(list(want[r * 4:(r + 1) * 4]), 1)
                                             for r in range(2)]))
    # the per-device layouts, one group and one group a block
    devices = object_grid(MESH, [torch.device("cpu")] * 8)
    for groups in (sharded._group_blocks(devices), _own_device(devices)):
        layouts = sharded._group_layouts(groups, MESH, h, w)
        states = sharded._states(h0, layouts, MESH, h, w)
        for g, s in zip(layouts, states):
            st = sharded._strips(states, g)
            assert st.shape == (g.layout.strip_cells, 2)
            rows = [i * MESH[1] + j for i, j in g.positions]
            assert torch.equal(sharded_step2d.haloed_blocks(s, st, g.layout), want_xp[rows])
            assert torch.equal(sharded_step2d.step_blocks_2d_plain(packed, s, st, g.layout, cfg),
                               want[rows])


@pytest.mark.parametrize("k", [1, 5])
def test_pi_cell_step_haloed_pallas(k, monkeypatch):
    """One step of a grid of blocks, impl="pallas" in both groupings, against
    impl="jnp"."""
    _, _, cfg, tp = _pair(k, seed=6)
    mesh = _mesh((2, 2))
    h0 = torch.from_numpy(_field((12, 20, 2), 9))
    blocks = object_grid((2, 2), [h0[i * 6:(i + 1) * 6, j * 10:(j + 1) * 10]
                                  for i in range(2) for j in range(2)])
    kw = dict(mesh=mesh, axis_names=("x", "y"))
    want = pi_cell_step_haloed(tp, blocks, cfg, **kw)
    got = pi_cell_step_haloed(tp, blocks, cfg, impl="pallas", **kw)
    monkeypatch.setattr(sharded, "_group_blocks", _own_device)
    own = pi_cell_step_haloed(tp, blocks, cfg, impl="pallas", **kw)
    for a, b, c in zip(got.flat, own.flat, want.flat):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=2e-4, atol=1e-5)


def test_route_rule():
    """One launch a call only with every block on one device and no
    gradient, and on a card only within blocks_plan."""
    _, _, cfg, _ = _pair(1)
    cpu = torch.device("cpu")
    one = [(cpu, [(0, 0), (0, 1)])]
    two = [(cpu, [(0, 0)]), (cpu, [(0, 1)])]
    assert sharded._one_launch(one, False, (1, 2), 6, 10, cfg)
    assert not sharded._one_launch(one, True, (1, 2), 6, 10, cfg)
    assert not sharded._one_launch(two, False, (1, 2), 6, 10, cfg)
    assert not sharded._one_launch(two, True, (1, 2), 6, 10, cfg)
    gs2d = PiCellConfig(ndim=2, hidden=8, n_branches=3, kernel_size=1)
    plan = sharded_step2d.blocks_plan(4, 50, 50, gs2d, 132)
    assert plan["route"] == "one_launch"
    assert plan["grid"] == (1, 50, 4) and plan["threads"] == 64
    burgers = PiCellConfig(ndim=2, hidden=16, n_branches=3, kernel_size=5)
    plan = sharded_step2d.blocks_plan(4, 50, 50, burgers, 132)
    assert plan["route"] == "one_launch" and plan["grid"] == (4, 7, 4)
    assert plan["threads"] == 256
    assert sharded_step2d.blocks_plan(4, 500, 500, gs2d, 132)["route"] == "per_step"
    assert sharded_step2d.blocks_plan(4, 600, 50, gs2d, 132)["route"] == "per_step"


@pytest.mark.parametrize("grouping", ["one_device", "own_device"], indirect=True)
def test_cpu_path_launches_no_kernel(grouping, monkeypatch):
    monkeypatch.setattr(sharded_step2d.step_blocks_2d, "launches", 0)
    monkeypatch.setattr(sharded_step2d.rollout_blocks_2d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, tp = _pair(1)
    x = torch.from_numpy(_field(FIELD, 10))
    with torch.no_grad():
        sharded_rollout_nd(tp, x, cfg, 2, _mesh(MESH), impl="pallas")
    fr = sharded_rollout_nd(tp, x.requires_grad_(True), cfg, 2, _mesh(MESH), impl="pallas")
    fr.sum().backward()
    assert sharded_step2d.step_blocks_2d.launches == 0
    assert sharded_step2d.rollout_blocks_2d.launches == 0


def test_non_cpu_tensors_never_reach_plain(monkeypatch):
    """A state that is not on the CPU goes to the kernels' wrappers, which
    raise where they cannot launch; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("a plain version was reached")

    for name in ("step_blocks_2d_plain", "rollout_blocks_2d_plain", "step_haloed_2d_plain"):
        monkeypatch.setattr(sharded_step2d, name, fail_plain)
    _, _, cfg, tp = _pair(1)
    meta = params_from_numpy(tp, device="meta")
    packed = torch.empty(2 + 2 * cell2d._param_block(cfg), device="meta")
    layouts = sharded._group_layouts(_own_device(object_grid((1, 2), [torch.device("meta")] * 2)),
                                     (1, 2), 6, 10)
    state = torch.empty((1, 6, 10, 2), device="meta")
    strips = torch.empty((layouts[0].layout.strip_cells, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        sharded_step2d.step_blocks_2d(meta, state, strips, layouts[0].layout, cfg)
    field = sharded._field_layout((1, 2), 6, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sharded_step2d.rollout_blocks_2d(packed, torch.empty((6, 20, 2), device="meta"), field,
                                         cfg, 3)


def test_layouts_are_checked():
    _, _, cfg, tp = _pair(1)
    field = sharded._field_layout((2, 2), 6, 10)
    table = field.table.copy()
    table[1, 4, 1] = field.src_cells - 5          # the block's centre past the field
    with pytest.raises(ValueError, match="outside its buffer"):
        sharded_step2d.BlockLayout(table, 6, 10, src_cells=field.src_cells, strip_cells=0,
                                   out_cells=field.out_cells)
    with pytest.raises(ValueError, match="block table"):
        sharded_step2d.BlockLayout(field.table, 1, 10, src_cells=field.src_cells,
                                   strip_cells=0, out_cells=field.out_cells)
    layouts = sharded._group_layouts(_own_device(object_grid((1, 2), [torch.device("cpu")] * 2)),
                                     (1, 2), 6, 10)
    packed = cell2d.pack_pi_params_2d(tp, cfg)
    with pytest.raises(ValueError, match="frames of the layout"):
        sharded_step2d.rollout_blocks_2d(packed, torch.zeros(6, 10, 2), layouts[0].layout, cfg, 1)
    with pytest.raises(ValueError, match="strip cells"):
        sharded_step2d.step_blocks_2d(tp, torch.zeros(1, 6, 10, 2), torch.zeros(3, 2),
                                      layouts[0].layout, cfg)
    with pytest.raises(ValueError, match="does not split"):
        sharded_rollout_nd(tp, torch.zeros(12, 20, 2), cfg, 1, _mesh((1, 3)), impl="pallas")
    with pytest.raises(ValueError, match="at least 2 cells"):
        sharded_rollout_nd(tp, torch.zeros(4, 20, 2), cfg, 1, _mesh((4, 1)), impl="pallas")


@pytest.mark.parametrize("k", [1, 5])
def test_blocks_kernels_match_plain_on_the_card(k):
    """step2d_blocks_kernel (both groupings) and rollout2d_blocks_kernel
    against their plain versions, and the two routes to the bit; skipped
    where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blocks kernels run only on the card")
    dev = torch.device("cuda", 0)
    _, _, cfg, tp = _pair(k)
    packed = cell2d.pack_pi_params_2d(params_from_numpy(tp, device=dev), cfg)
    h0 = torch.from_numpy(_field(FIELD, 11)).to(dev)
    h, w = 6, 10
    field = sharded._field_layout(MESH, h, w)
    got = sharded_step2d._rollout_blocks_cuda(packed, h0, field, cfg, STEPS)
    want = sharded_step2d.rollout_blocks_2d_plain(packed, h0, field, cfg, STEPS)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)
    devices = object_grid(MESH, [dev] * 8)
    for groups in (sharded._group_blocks(devices), _own_device(devices)):
        layouts = sharded._group_layouts(groups, MESH, h, w)
        states = sharded._states(h0, layouts, MESH, h, w)
        outs = []
        for g, s in zip(layouts, states):
            st = sharded._strips(states, g).contiguous()
            outs.append(sharded_step2d._step_blocks_cuda(packed, s, st, g.layout, cfg))
            torch.testing.assert_close(
                outs[-1], sharded_step2d.step_blocks_2d_plain(packed, s, st, g.layout, cfg),
                rtol=2e-4, atol=1e-5)
        one_step = torch.cat(outs).reshape(2, 4, h, w, 2).transpose(1, 2).reshape(FIELD)
        assert torch.equal(one_step, got[1])
