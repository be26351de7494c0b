"""percnn_tpu_torch.parallel on the CPU: the mesh, the halo exchange and the
domain-decomposed rollout against percnn_tpu's on the 8 virtual host
devices of conftest.py, the valid-region step against percnn_tpu's, and the
gradients through the exchange against the port's single-device autograd.

The port's mesh repeats "cpu" as JAX's tests repeat host devices; the same
code runs on a card with a mesh that repeats cuda:0 (chip_smoke.py).
Inputs are made with numpy and cast to float32 (x64 is on for JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import (
    PiCellConfig as JPiCellConfig,
    init_pi_cell as j_init_pi_cell,
    pi_cell_step_valid as j_pi_cell_step_valid,
)
from percnn_tpu.ops import stencils as jstencils
from percnn_tpu.parallel.mesh import factor_devices as j_factor_devices, make_mesh as j_make_mesh
from percnn_tpu.parallel.sharded import sharded_rollout_nd as j_sharded_rollout_nd

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step, pi_cell_step_valid
from percnn_tpu_torch.core.rollout import _flatten, rollout
from percnn_tpu_torch.ops import stencils
from percnn_tpu_torch.parallel import (
    Mesh,
    factor_devices,
    halo_exchange,
    make_mesh,
    pi_cell_step_haloed,
    sharded_rollout_nd,
)
from percnn_tpu_torch.parallel.halo import object_grid


def _kw(ndim=2, k=1):
    return dict(ndim=ndim, hidden=4, kernel_size=k, dt=0.01, dx=0.1, diffusion="raw",
                diff_init=0.05, init_scale=0.1)


def _pair(ndim=2, k=1, seed=0):
    jcfg = JPiCellConfig(**_kw(ndim, k))
    jp = j_init_pi_cell(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, PiCellConfig(**_kw(ndim, k)), tp


def _field(shape, seed):
    return (0.3 * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _cpu_mesh(axes, shape):
    return make_mesh(axes, shape=shape, devices=["cpu"] * int(np.prod(shape)))


def _blocks(h, shape):
    """h cut into a grid of `shape` blocks, in mesh order."""
    sizes = [n // s for n, s in zip(h.shape, shape)]
    return object_grid(shape, [h[tuple(slice(i * b, (i + 1) * b) for i, b in zip(idx, sizes))]
                               for idx in np.ndindex(shape)])


@pytest.mark.parametrize("n,n_axes", [(8, 2), (8, 3), (7, 2), (1, 2), (12, 2), (16, 3), (6, 1)])
def test_factor_devices_matches_jax(n, n_axes):
    assert factor_devices(n, n_axes) == j_factor_devices(n, n_axes)


def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = make_mesh(("x", "y"), devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.shape == {"x": 4, "y": 2}
    assert mesh.shape == dict(j_make_mesh(("x", "y"), shape=(4, 2)).shape)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(("x", "y", "z"), shape=(2, 2, 2), devices=["cpu"] * 8).devices.shape == (2, 2, 2)
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(("x", "y"), shape=(2, 3), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.empty((2, 2), dtype=object), ("x",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(("x", "y"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(("x", "y"), shape=(1, 1), devices=["cuda"])


@pytest.mark.parametrize("axes,mesh_shape,field", [
    (("x", "y"), (2, 4), (8, 16, 2)),
    (("x", "y", "z"), (2, 2, 2), (8, 6, 10, 2)),
])
def test_halo_exchange_is_a_periodic_pad(axes, mesh_shape, field):
    """Every extended block equals its window of the wrap-padded global
    field, corners included (the axes go in turn)."""
    mesh = _cpu_mesh(axes, mesh_shape)
    h = torch.from_numpy(_field(field, 3))
    nd = len(axes)
    xp = halo_exchange(_blocks(h, mesh_shape), halo=2, mesh=mesh, axis_names=axes,
                       array_axes=tuple(range(nd)))
    pad = stencils.periodic_pad(h, 2, tuple(range(nd)))
    sizes = [n // s for n, s in zip(field, mesh_shape)]
    for idx in np.ndindex(mesh_shape):
        want = pad[tuple(slice(i * b, i * b + b + 4) for i, b in zip(idx, sizes))]
        assert torch.equal(xp[idx], want), idx
    with pytest.raises(ValueError, match="grid of"):
        halo_exchange(_blocks(h, mesh_shape)[:1], mesh=mesh, axis_names=axes,
                      array_axes=tuple(range(nd)))


def test_halo_exchange_refuses_thin_blocks():
    mesh = _cpu_mesh(("x", "y"), (2, 4))
    h = torch.zeros(8, 4, 2)   # blocks of 4 x 1
    with pytest.raises(ValueError, match="at least 2 cells"):
        halo_exchange(_blocks(h, (2, 4)), mesh=mesh, axis_names=("x", "y"), array_axes=(0, 1))


@pytest.mark.parametrize("ndim,shape", [(2, (12, 14, 2)), (3, (7, 8, 9, 2))])
def test_laplacian_and_grad_valid_match_jax(ndim, shape):
    xp = _field(shape, 4)
    dims = tuple(range(ndim))
    want = np.asarray(jstencils.laplacian_valid(jnp.asarray(xp), 0.1, axes=dims))
    got = stencils.laplacian_valid(torch.from_numpy(xp), 0.1, dims).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    want = np.asarray(jstencils.grad_axis_valid(jnp.asarray(xp), 0.1, 1, axes=dims))
    got = stencils.grad_axis_valid(torch.from_numpy(xp), 0.1, 1, dims).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    assert np.array_equal(stencils.interior(torch.from_numpy(xp), dims).numpy(),
                          np.asarray(jstencils.interior(jnp.asarray(xp), dims)))


@pytest.mark.parametrize("ndim,k,shape", [(2, 1, (10, 13, 2)), (2, 5, (10, 13, 2)),
                                          (3, 1, (7, 8, 9, 2))])
def test_pi_cell_step_valid_matches_jax(ndim, k, shape):
    jcfg, jp, cfg, tp = _pair(ndim, k)
    xp = _field(shape, 5)
    want = np.asarray(j_pi_cell_step_valid(jp, jnp.asarray(xp), jcfg))
    got = pi_cell_step_valid(tp, torch.from_numpy(xp), cfg).numpy()
    assert got.shape == tuple(n - 4 for n in shape[:-1]) + (2,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("k", [1, 5])
def test_valid_step_on_a_wrap_pad_is_the_periodic_step(k):
    """The valid-region step of the wrap-padded field is the cell step."""
    _, _, cfg, tp = _pair(2, k, seed=1)
    h = torch.from_numpy(_field((9, 11, 2), 6))
    got = pi_cell_step_valid(tp, stencils.periodic_pad(h, 2, (0, 1)), cfg)
    torch.testing.assert_close(got, pi_cell_step(tp, h, cfg), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["k1", "k5", "uneven", "3d"])
def test_sharded_rollout_matches_jax(case):
    """The port's decomposed rollout (eager valid step) against percnn_tpu's
    shard_map rollout on the same mesh shape and parameters."""
    ndim, k, axes, mesh_shape, field, steps = {
        "k1": (2, 1, ("x", "y"), (2, 4), (16, 32, 2), 5),
        "k5": (2, 5, ("x", "y"), (2, 4), (16, 32, 2), 5),
        "uneven": (2, 1, ("x", "y"), (4, 2), (24, 16, 2), 4),
        "3d": (3, 1, ("x", "y", "z"), (2, 2, 2), (8, 12, 16, 2), 3),
    }[case]
    jcfg, jp, cfg, tp = _pair(ndim, k)
    h0 = _field(field, 7)
    want = np.asarray(j_sharded_rollout_nd(jp, jnp.asarray(h0), jcfg, steps,
                                           j_make_mesh(axes, shape=mesh_shape)))
    got = sharded_rollout_nd(tp, torch.from_numpy(h0), cfg, steps, _cpu_mesh(axes, mesh_shape))
    assert got.shape == (steps + 1,) + field
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("ndim,k", [(2, 1), (2, 5), (3, 1)])
@pytest.mark.parametrize("remat", [True, False])
def test_sharded_rollout_grads_match_single_device(ndim, k, remat):
    """Autograd through the exchange (and the checkpointed segments) equals
    the port's single-device autograd: every cell leaf and dh0."""
    _, _, cfg, tp = _pair(ndim, k, seed=2)
    field = (8, 16, 2) if ndim == 2 else (8, 8, 8, 2)
    mesh_shape = (2, 4) if ndim == 2 else (2, 2, 2)
    mesh = _cpu_mesh(("x", "y", "z")[:ndim], mesh_shape)
    steps = 7
    tgt = torch.from_numpy(_field((steps + 1,) + field, 8))
    leaves = _flatten(tp)

    def grads(run):
        x = torch.from_numpy(_field(field, 9)).requires_grad_(True)
        for t in leaves:
            t.requires_grad_(True)
        return torch.autograd.grad(((run(x) - tgt) ** 2).mean(), leaves + [x])

    want = grads(lambda x: rollout(lambda h: pi_cell_step(tp, h, cfg), x, steps))
    got = grads(lambda x: sharded_rollout_nd(tp, x, cfg, steps, mesh, remat=remat))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-6)


def test_sharded_rollout_defaults_and_errors():
    _, _, cfg, tp = _pair(2, 1)
    h0 = torch.from_numpy(_field((8, 8, 2), 10))
    # extra mesh axes are ignored: blocks over ('x', 'y') of an (x, y, z) mesh
    mesh3 = _cpu_mesh(("x", "y", "z"), (2, 2, 2))
    ref = rollout(lambda h: pi_cell_step(tp, h, cfg), h0, 3, remat=False)
    torch.testing.assert_close(sharded_rollout_nd(tp, h0, cfg, 3, mesh3), ref,
                               rtol=2e-4, atol=1e-5)
    assert sharded_rollout_nd(tp, h0, cfg, 0, mesh3).shape == (1, 8, 8, 2)
    with pytest.raises(ValueError, match="need 2 mesh axes"):
        sharded_rollout_nd(tp, h0, cfg, 3, mesh3, axis_names=("x",))
    with pytest.raises(ValueError, match="does not split"):
        sharded_rollout_nd(tp, h0, cfg, 3, _cpu_mesh(("x", "y"), (3, 1)))
    with pytest.raises(ValueError, match="unknown impl"):
        sharded_rollout_nd(tp, h0, cfg, 3, mesh3, impl="gspmd")
    mesh = _cpu_mesh(("x", "y"), (2, 2))
    one = pi_cell_step_haloed(tp, _blocks(h0, (2, 2)), cfg, mesh=mesh, axis_names=("x", "y"))
    torch.testing.assert_close(torch.cat([torch.cat(list(r), 1) for r in one], 0), ref[1],
                               rtol=2e-4, atol=1e-5)
