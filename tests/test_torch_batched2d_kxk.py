"""percnn_tpu_torch.ops.kernels.batched2d on the CPU at k = 5: the contract of
rollout2d_batched_kernel and adj2d_batched_kernel for a 5x5 Pi cell, the
member-batched streaming rollout (``fused_rollout_tp_2d_batched``), against
percnn_tpu's jnp path (``jax.vmap`` over members of the rolled-out
``core.cell.pi_cell_step``, and its ``jax.grad``) and against percnn_tpu's
member-batched Pallas kernels in interpret mode.

The kernels run only on the card (``python3 chip_smoke.py``).  Bars as in
tests/test_pallas.py: forward rtol 2e-4 / atol 1e-5, gradients rtol 2e-4 /
atol 2e-6.  One shape (M = 2, 16 x 16, hidden 4, T = 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percnn_tpu.core.cell import PiCellConfig as JPiCellConfig, init_pi_cell as j_init_pi_cell
from percnn_tpu.core.cell import pi_cell_step as j_pi_cell_step
from percnn_tpu.core.rollout import rollout as j_rollout
from percnn_tpu.ops.pallas import batched2d as jbatched2d

from percnn_tpu_torch.bridge import params_from_numpy
from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.ops.kernels import batched2d, cell2d

M, N, T = 2, 16, 4
CFG = dict(ndim=2, hidden=4, kernel_size=5, dt=0.05, dx=0.5, diffusion="sigmoid",
           mu_up=0.1, init_scale=0.3)


def _leaves(p):
    return [p["diff"]] + [p["pi"][o][k] for o in range(2) for k in sorted(p["pi"][o])]


@pytest.fixture(scope="module")
def setup():
    members = [j_init_pi_cell(jax.random.PRNGKey(7 + m), JPiCellConfig(**CFG)) for m in range(M)]
    jp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs).astype(jnp.float32), *members)
    rs = np.random.RandomState(8)
    h0 = (0.3 * rs.standard_normal((M, N, N, 2))).astype(np.float32)
    cot = rs.standard_normal((M, T + 1, N, N, 2)).astype(np.float32)
    return jp, jax.tree_util.tree_map(np.asarray, jp), h0, cot


def _port(npp, h0, cot):
    """Frames and the gradients of <frames, cot> (every leaf, then h0)."""
    tp = params_from_numpy(npp, device="cpu", dtype=torch.float32)
    for t in _leaves(tp):
        t.requires_grad_(True)
    x = torch.from_numpy(h0).requires_grad_(True)
    frames = batched2d.fused_rollout_tp_2d_batched(tp, x, PiCellConfig(**CFG), T)
    grads = torch.autograd.grad((frames * torch.from_numpy(cot)).sum(), _leaves(tp) + [x])
    return frames.detach().numpy(), [g.numpy() for g in grads]


def _check(port, frames_want, grads_want):
    frames, grads = port
    np.testing.assert_allclose(frames, frames_want, rtol=2e-4, atol=1e-5)
    for got, want in zip(grads, grads_want):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-6)


def test_batched_kxk_matches_jnp_path(setup):
    jp, npp, h0, cot = setup
    jcfg = JPiCellConfig(**CFG)

    def roll(p, x):
        return jax.vmap(lambda pm, xm: j_rollout(lambda h: j_pi_cell_step(pm, h, jcfg), xm, T))(p, x)

    jframes = roll(jp, jnp.asarray(h0))
    jg_p, jg_h0 = jax.grad(lambda p, x: jnp.sum(roll(p, x) * cot), argnums=(0, 1))(
        jp, jnp.asarray(h0))
    _check(_port(npp, h0, cot), np.asarray(jframes), _leaves(jg_p) + [jg_h0])


def test_batched_kxk_matches_pallas_batched_kernels(setup):
    jp, npp, h0, cot = setup
    jcfg = JPiCellConfig(**CFG)
    fn = jbatched2d.fused_rollout_tp_2d_batched
    jframes = fn(jp, jnp.asarray(h0), jcfg, T)
    jg_p, jg_h0 = jax.grad(lambda p, x: jnp.sum(fn(p, x, jcfg, T) * cot), argnums=(0, 1))(
        jp, jnp.asarray(h0))
    _check(_port(npp, h0, cot), np.asarray(jframes), _leaves(jg_p) + [jg_h0])


def test_batched_kxk_ignores_the_mxu_switch(monkeypatch, setup):
    """The batched route takes the tap-by-tap step whatever MXU_FWD_ENABLED
    says, as percnn_tpu's batched kernels use _pi_poly: the frames agree
    with and without it, and the branch-matrix kernel's counter stays."""
    _, npp, h0, cot = setup
    monkeypatch.setattr(cell2d.fused_rollout_kxk_2d, "launches", 0)
    on = _port(npp, h0, cot)
    monkeypatch.setattr(cell2d, "MXU_FWD_ENABLED", False)
    off = _port(npp, h0, cot)
    np.testing.assert_array_equal(on[0], off[0])
    assert cell2d.fused_rollout_kxk_2d.launches == 0
