"""percnn_tpu_torch.ops.kernels.sharded_step2d on the CPU: the plain version
of step2d_haloed_kernel against percnn_tpu's Pallas step in interpret mode,
its VJP against percnn_tpu's custom VJP, the decomposed rollout of
impl="pallas" (values and gradients) against percnn_tpu's on the 8 virtual
host devices, and the dispatch rule (a CUDA tensor never reaches the plain
version).

Every block here has a 6 x 10 interior, narrower than the k x k kernels'
8 x 16 tile, and one interpret shape serves the whole file.  The CUDA
kernel runs only on the card: ``python3 chip_smoke.py`` holds it against
the plain version there, as the last test does when a card is present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.ops.pallas.sharded_step2d import pallas_step_haloed
from percnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from percnn_tpu.parallel.sharded import sharded_rollout_nd as j_sharded_rollout_nd

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step_valid
from percnn_tpu_torch.core.rollout import _flatten
from percnn_tpu_torch.ops.kernels import _build, cell2d, sharded_step2d
from percnn_tpu_torch.parallel import make_mesh, sharded_rollout_nd

BLOCK = (10, 14, 2)          # a haloed 6 x 10 block
FIELD = (12, 40, 2)          # 6 x 10 blocks on a (2, 4) mesh
MESH = (2, 4)


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


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _torch_leaves_in_jax_order(tp):
    """The port's leaves in jax.tree_util's order (dict keys sorted)."""
    return [tp["diff"]] + [br[k] for br in tp["pi"] for k in sorted(br)]


@pytest.mark.parametrize("k", [1, 5])
def test_step_matches_pallas(k):
    jcfg, jp, cfg, tp = _pair(k)
    xp = _field(BLOCK, 1)
    want = np.asarray(pallas_step_haloed(jp, jnp.asarray(xp), jcfg))
    got = sharded_step2d.step_haloed_2d(tp, torch.from_numpy(xp), cfg)
    assert got.shape == (6, 10, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("k", [1, 5])
def test_step_vjp_matches_pallas_custom_vjp(k):
    """The Function's backward (autograd through pi_cell_step_valid) against
    percnn_tpu's custom VJP: every cell leaf and the whole haloed block."""
    jcfg, jp, cfg, tp = _pair(k, seed=1)
    xp = _field(BLOCK, 2)
    g = _field((6, 10, 2), 3)
    _, vjp = jax.vjp(lambda p, x: pallas_step_haloed(p, x, jcfg), jp, jnp.asarray(xp))
    jgp, jgx = vjp(jnp.asarray(g))
    leaves = _torch_leaves_in_jax_order(tp)
    x = torch.from_numpy(xp).requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    out = sharded_step2d.step_haloed_2d(tp, x, cfg)
    got = torch.autograd.grad(out, leaves + [x], torch.from_numpy(g))
    for a, b in zip(got, _np_leaves(jgp) + [np.asarray(jgx)]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("k", [1, 5])
def test_plain_equals_valid_step(k):
    """The plain version, read from the packed vector, is the eager
    valid-region step (the backward's template)."""
    _, _, cfg, tp = _pair(k, seed=2)
    xp = torch.from_numpy(_field(BLOCK, 4))
    packed = cell2d.pack_pi_params_2d(tp, cfg)
    torch.testing.assert_close(sharded_step2d.step_haloed_2d_plain(packed, xp, cfg),
                               pi_cell_step_valid(tp, xp, cfg), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("k", [1, 5])
def test_sharded_rollout_pallas_matches_jax(k):
    """impl="pallas" on a (2, 4) mesh against percnn_tpu's: frames, the loss
    and the gradient of every leaf and of h0 (as tests/test_parallel.py)."""
    jcfg, jp, cfg, tp = _pair(k, seed=3)
    h0 = _field(FIELD, 5)
    tgt = _field((5,) + FIELD, 6)
    jmesh = j_make_mesh(("x", "y"), shape=MESH)

    def jloss(p, h):
        fr = j_sharded_rollout_nd(p, h, jcfg, 4, jmesh, impl="pallas")
        return jnp.mean((fr - tgt) ** 2), fr

    (jl, jfr), (jgp, jgh) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(h0))
    leaves = _torch_leaves_in_jax_order(tp)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(h0).requires_grad_(True)
    mesh = make_mesh(("x", "y"), shape=MESH, devices=["cpu"] * 8)
    fr = sharded_rollout_nd(tp, x, cfg, 4, mesh, impl="pallas")
    loss = ((fr - torch.from_numpy(tgt)) ** 2).mean()
    got = torch.autograd.grad(loss, leaves + [x])
    np.testing.assert_allclose(fr.detach().numpy(), np.asarray(jfr), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-4)
    for a, b in zip(got, _np_leaves(jgp) + [np.asarray(jgh)]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-6)


def test_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(sharded_step2d.step_haloed_2d, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not build or load a kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, _, cfg, tp = _pair(1)
    mesh = make_mesh(("x", "y"), shape=MESH, devices=["cpu"] * 8)
    sharded_rollout_nd(tp, torch.from_numpy(_field(FIELD, 7)), cfg, 2, mesh, impl="pallas")
    assert sharded_step2d.step_haloed_2d.launches == 0


def test_non_cpu_tensor_never_reaches_plain(monkeypatch):
    """A block that is not on the CPU goes to the kernel's wrapper, which
    raises where it cannot launch; nothing falls back."""
    def fail_plain(*args, **kwargs):
        raise AssertionError("the plain version was reached")

    monkeypatch.setattr(sharded_step2d, "step_haloed_2d_plain", fail_plain)
    _, _, cfg, tp = _pair(1)
    meta = params_from_numpy(tp, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        sharded_step2d.step_haloed_2d(meta, torch.empty(BLOCK, device="meta"), cfg)


def test_inputs_are_checked():
    _, _, cfg, tp = _pair(1)
    with pytest.raises(ValueError, match="haloed block"):
        sharded_step2d.step_haloed_2d(tp, torch.zeros(5, 14, 2), cfg)
    with pytest.raises(NotImplementedError, match="odd kernel_size"):
        sharded_step2d.step_haloed_2d(tp, torch.zeros(BLOCK), PiCellConfig(**_kw(4)))
    packed = cell2d.pack_pi_params_2d(tp, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sharded_step2d._step_cuda(packed, torch.zeros(BLOCK), cfg)
    assert len(_flatten(tp)) == 1 + 2 * 8


@pytest.mark.parametrize("k", [1, 5])
def test_kernel_matches_plain_on_the_card(k):
    """step2d_haloed_kernel against its plain version on a narrow block and
    a full one; skipped where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: step2d_haloed_kernel runs only on the card")
    dev = torch.device("cuda", 0)
    _, _, cfg, tp = _pair(k)
    packed = cell2d.pack_pi_params_2d(params_from_numpy(tp, device=dev), cfg)
    for shape in (BLOCK, (54, 54, 2)):
        xp = torch.from_numpy(_field(shape, 8)).to(dev)
        got = sharded_step2d._step_cuda(packed, xp, cfg)
        torch.testing.assert_close(got, sharded_step2d.step_haloed_2d_plain(packed, xp, cfg),
                                   rtol=2e-4, atol=1e-5)
