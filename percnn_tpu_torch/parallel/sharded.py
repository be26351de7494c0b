"""Sharded execution: the halo-exchange rollout and the GSPMD train step.

Counterpart of percnn_tpu/parallel/sharded.py, both paths.  The GSPMD
helpers (``shard_array``, ``replicate``, ``make_train_step_spmd``, and
``scale_by_adam``, optax's Adam for them) run on every rank of a process
group, one rank a mesh position, on DTensors (parallel/spmd.py), and keep
the JAX package's names and signatures.  The explicit path:
``sharded_rollout_nd`` cuts the field into one block per mesh position
(the first ``cfg.ndim`` mesh axes cut the spatial dims in order), puts
each block on its mesh device with a copy of the parameters there, and
advances all blocks together.  With ``remat`` the blocks' steps are
checkpointed in segments of about sqrt(T) steps, as
``core.rollout.rollout`` does for one field.

impl (the JAX package's names, so a caller moves between the packages
unchanged):
  'jnp'    -- each step exchanges the 2-cell halo (parallel/halo.py) and
              runs the eager valid-region step (core.cell.pi_cell_step_valid)
              on every block; any spatial rank, any kernel_size;
  'pallas' -- the CUDA kernels of ops/kernels/sharded_step2d.py (their plain
              versions on the CPU), 2D two-channel cells of odd kernel_size
              <= 5.  The blocks of one device are one state [nb, h, w, 2]:
              each step copies only the 2-cell edge rows, columns and
              corners that a device's blocks read from other devices into
              its strips, then steps all its blocks in one launch
              (step_blocks_2d).  When every block is on one device and no
              gradient is taken, the whole rollout is one cooperative
              launch writing the assembled frames (rollout_blocks_2d),
              within blocks_plan.  The halo cells are those the exchange
              puts there, and the gradient is the eager step's adjoint.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from percnn_tpu_torch._device import full_f32
from percnn_tpu_torch.core.cell import PiCellConfig, pi_cell_step_valid
from percnn_tpu_torch.core.rollout import _flatten, _pick_segment, _unflatten
from percnn_tpu_torch.ops.kernels.cell2d import _check_fusable, _sm_count, pack_pi_params_2d
from percnn_tpu_torch.ops.kernels.sharded_step2d import (
    REGIONS,
    BlockLayout,
    blocks_plan,
    rollout_blocks_2d,
    step_blocks_2d,
)
from percnn_tpu_torch.ops.stencils import STENCIL_HALO
from percnn_tpu_torch.parallel.halo import halo_exchange, object_grid
from percnn_tpu_torch.parallel.spmd import (
    P,
    device_mesh,
    distribute,
    implicitly_replicated,
    placements,
    tree_map,
)

_IMPLS = ("jnp", "pallas")


def _tree_to(tree, dev: torch.device):
    """The parameter tree on `dev` (the same tensors where they already are)."""
    return _unflatten(tree, iter([t.to(dev) for t in _flatten(tree)]))


def _block_devices(mesh, axis_names: Sequence[str]) -> np.ndarray:
    """The device of each block: grid axis k along mesh axis axis_names[k];
    a mesh axis that cuts no dim contributes its first position."""
    names = mesh.axis_names
    sub = mesh.devices[tuple(slice(None) if n in axis_names else 0 for n in names)]
    kept = [n for n in names if n in axis_names]
    return np.transpose(sub, [kept.index(a) for a in axis_names])


def _step_blocks(replicas: dict, blocks: np.ndarray, cfg: PiCellConfig, mesh,
                 axis_names: Sequence[str]) -> np.ndarray:
    """impl='jnp': the halo exchange, then the eager valid step on each block."""
    xp = halo_exchange(blocks, halo=STENCIL_HALO, mesh=mesh, axis_names=axis_names,
                       array_axes=tuple(range(cfg.ndim)))
    return object_grid(xp.shape, [pi_cell_step_valid(replicas[b.device], b, cfg)
                                  for b in xp.flat])


# ---------------------------------------------------------------------------
# impl='pallas': the blocks of each device as one state, stepped in one launch


def _group_blocks(devices: np.ndarray) -> list[tuple[torch.device, list[tuple[int, ...]]]]:
    """The grid's blocks grouped by device, each group's positions in mesh
    order: the blocks one launch steps together.  (Tests replace this so
    that every block counts as its own device, which runs the strip path on
    one device.)"""
    groups: dict = {}
    for idx in np.ndindex(devices.shape):
        groups.setdefault(devices[idx], []).append(idx)
    return list(groups.items())


def _neighbour(idx: tuple, ri: int, rj: int, grid: tuple, h: int, w: int) -> tuple:
    """Region (ri, rj) of block idx's haloed block (rows: the 2 above, its h,
    the 2 below; columns likewise): the block it lies in, and its first row
    and column there.  The ring's wrap-around is the periodic boundary; an
    axis of one block wraps onto the block itself."""
    q = ((idx[0] + ri - 1) % grid[0], (idx[1] + rj - 1) % grid[1])
    return q, (h - STENCIL_HALO, 0, 0)[ri], (w - STENCIL_HALO, 0, 0)[rj]


def _region_shape(ri: int, rj: int, h: int, w: int) -> tuple[int, int]:
    return (STENCIL_HALO, h, STENCIL_HALO)[ri], (STENCIL_HALO, w, STENCIL_HALO)[rj]


def _field_layout(grid: tuple, h: int, w: int) -> BlockLayout:
    """Every block of the grid read from and written to one assembled field
    [H, W]: the layout of the one-launch rollout."""
    W = grid[1] * w
    table = np.zeros((grid[0] * grid[1], REGIONS, 4), np.int32)
    for b, idx in enumerate(np.ndindex(grid)):
        for k in range(9):
            q, r0, c0 = _neighbour(idx, k // 3, k % 3, grid, h, w)
            table[b, k] = (0, (q[0] * h + r0) * W + q[1] * w + c0, W, 0)
        table[b, 9] = (0, idx[0] * h * W + idx[1] * w, W, 0)
    cells = grid[0] * h * W
    return BlockLayout(table, h, w, src_cells=cells, strip_cells=0, out_cells=cells)


class _Group:
    """One launch's blocks: their device, positions (mesh order) and layout
    in the group's state [nb, h, w, 2], and the strips it reads, as (source
    group, index of the cells in that group's state) in the strips' order."""

    def __init__(self, device, positions, layout, sources):
        self.device, self.positions, self.layout, self.sources = (device, positions, layout,
                                                                  sources)
        self.no_strips = torch.empty((0, 2), dtype=torch.float32, device=device)


def _group_layouts(groups: list, grid: tuple, h: int, w: int) -> list[_Group]:
    """Each group's layout: a neighbour in the group is read in the group's
    state; one in another group from the strips, which hold the regions
    read from each other group in turn (by source group, then block and
    region), each row-major."""
    where = {pos: (g, b) for g, (_, positions) in enumerate(groups)
             for b, pos in enumerate(positions)}
    out = []
    for g, (device, positions) in enumerate(groups):
        table = np.zeros((len(positions), REGIONS, 4), np.int32)
        remote: dict = {}
        for b, idx in enumerate(positions):
            for k in range(9):
                q, r0, c0 = _neighbour(idx, k // 3, k % 3, grid, h, w)
                sg, sb = where[q]
                if sg == g:
                    table[b, k] = (0, (sb * h + r0) * w + c0, w, 0)
                else:
                    remote.setdefault(sg, []).append((b, k, sb, r0, c0))
            table[b, 9] = (0, b * h * w, w, 0)
        sources, off = [], 0
        for sg in sorted(remote):
            cells = []
            for b, k, sb, r0, c0 in remote[sg]:
                nr, nc = _region_shape(k // 3, k % 3, h, w)
                table[b, k] = (1, off, nc, 0)
                rows = (sb * h + r0 + np.arange(nr))[:, None] * w
                cells.append((rows + c0 + np.arange(nc)[None, :]).ravel())
                off += nr * nc
            sources.append((sg, torch.from_numpy(np.concatenate(cells)).to(groups[sg][0])))
        layout = BlockLayout(table, h, w, src_cells=len(positions) * h * w, strip_cells=off,
                             out_cells=len(positions) * h * w)
        out.append(_Group(device, positions, layout, sources))
    return out


def _strips(states: list, group: _Group) -> torch.Tensor:
    """The cells the group's blocks read from other groups' states, copied
    to its device: one gather and one copy a source group."""
    if not group.sources:
        return group.no_strips
    parts = [states[sg].reshape(-1, 2)[index].to(group.device) for sg, index in group.sources]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _states(x0: torch.Tensor, groups: list[_Group], grid: tuple, h: int, w: int) -> list:
    """Each group's state [nb, h, w, 2]: field x0 [H, W, 2] cut into the
    grid's blocks, the group's in mesh order, on its device."""
    blocks = x0.reshape(grid[0], h, grid[1], w, 2).transpose(1, 2).reshape(-1, h, w, 2)
    return [blocks[[i * grid[1] + j for i, j in g.positions]].to(g.device) for g in groups]


def _step_groups(states: list, groups: list[_Group], replicas: dict, packed: dict,
                 cfg: PiCellConfig) -> list:
    """One step of every group: its strips, then one launch of its blocks."""
    strips = [_strips(states, g) for g in groups]
    return [step_blocks_2d(replicas[g.device], s, st, g.layout, cfg, packed=packed[g.device])
            for g, s, st in zip(groups, states, strips)]


def _block_shape(shape: tuple, grid: tuple) -> tuple:
    """The block of a field of `shape` [*spatial, C] cut into `grid`."""
    sizes = []
    for d, n in enumerate(grid):
        if shape[d] % n:
            raise ValueError(f"spatial dim {d} of size {shape[d]} does not split "
                             f"into {n} blocks")
        sizes.append(shape[d] // n)
    if min(sizes) < STENCIL_HALO:
        raise ValueError(f"each block needs at least {STENCIL_HALO} cells along every dim "
                         f"for a {STENCIL_HALO}-cell halo, got {tuple(sizes)}")
    return tuple(sizes)


def _one_launch(groups: list, needs_grad: bool, grid: tuple, h: int, w: int,
                cfg: PiCellConfig) -> bool:
    """Whether a 'pallas' rollout takes one launch for the whole call: every
    block on one device, no gradient, and on a card within blocks_plan."""
    if len(groups) != 1 or needs_grad:
        return False
    device = groups[0][0]
    return device.type != "cuda" or blocks_plan(
        grid[0] * grid[1], h, w, cfg, _sm_count(device))["route"] == "one_launch"


def _pallas_step_haloed(params: dict, blocks: np.ndarray, cfg: PiCellConfig) -> np.ndarray:
    """One step of the grid of blocks, one launch a device."""
    _check_fusable(cfg)
    h, w = blocks.flat[0].shape[:2]
    if any(tuple(b.shape) != (h, w, 2) for b in blocks.flat):
        raise ValueError(f"the blocks of a grid share one shape [h, w, 2], got "
                         f"{[tuple(b.shape) for b in blocks.flat]}")
    devices = object_grid(blocks.shape, [b.device for b in blocks.flat])
    groups = _group_layouts(_group_blocks(devices), blocks.shape, h, w)
    replicas = {g.device: _tree_to(params, g.device) for g in groups}
    packed = {d: pack_pi_params_2d(r, cfg) for d, r in replicas.items()}
    states = [torch.stack([blocks[idx].to(torch.float32) for idx in g.positions])
              for g in groups]
    out = np.empty(blocks.shape, dtype=object)
    for g, s in zip(groups, _step_groups(states, groups, replicas, packed, cfg)):
        for b, idx in enumerate(g.positions):
            out[idx] = s[b]
    return out


def pi_cell_step_haloed(params: dict, blocks: np.ndarray, cfg: PiCellConfig, *, mesh,
                        axis_names: Sequence[str], impl: str = "jnp") -> np.ndarray:
    """One Euler step of every block of the grid (an object array of
    [*local_spatial, C] tensors in mesh order, as halo_exchange takes):
    with 'jnp' the halo exchange, then the eager valid step on each block;
    with 'pallas' (2D) the strips each device reads from the others, then
    one launch of step_blocks_2d a device.  1x1 and k x k cells alike: the
    halo's corners hold the diagonal neighbours' cells, which the k x k
    branches read."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {_IMPLS})")
    want = tuple(mesh.shape[a] for a in axis_names)
    if blocks.shape != want:
        raise ValueError(f"a grid of {blocks.shape} blocks for mesh axes "
                         f"{tuple(axis_names)} of sizes {want}")
    if impl == "pallas":
        return _pallas_step_haloed(params, blocks, cfg)
    replicas = {d: _tree_to(params, d) for d in {b.device for b in blocks.flat}}
    return _step_blocks(replicas, blocks, cfg, mesh, axis_names)


def _split(h0: torch.Tensor, devices: np.ndarray) -> np.ndarray:
    """h0 [*spatial, C] cut into the grid of blocks, each on its device."""
    sizes = _block_shape(tuple(h0.shape), devices.shape)
    blocks = []
    for idx in np.ndindex(devices.shape):
        sl = tuple(slice(i * s, (i + 1) * s) for i, s in zip(idx, sizes))
        blocks.append(h0[sl].to(devices[idx]))
    return object_grid(devices.shape, blocks)


def _assemble(blocks: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The grid of [T, *local_spatial, C] blocks joined into one tensor on
    `dev`: grid axis k along tensor dim 1 + k, the last grid axis first."""
    grid = object_grid(blocks.shape, [b.to(dev) for b in blocks.flat])
    while grid.ndim:
        k = grid.ndim - 1
        grid = object_grid(grid.shape[:k], [torch.cat(list(grid[idx]), dim=1 + k)
                                            for idx in np.ndindex(grid.shape[:k])])
    return grid[()]


def _segments(n_steps: int, remat: bool) -> list[int]:
    """Step counts of the checkpointed segments: about sqrt(T) each; a prime
    T first takes one step alone so the rest divides."""
    if n_steps == 0:
        return []
    if not remat:
        return [n_steps]
    if n_steps > 4 and _pick_segment(n_steps) == 1:
        return [1] + _segments(n_steps - 1, remat)
    seg = _pick_segment(n_steps)
    return [seg] * (n_steps // seg)


def _pallas_rollout(params: dict, h0: torch.Tensor, cfg: PiCellConfig, n_steps: int,
                    mesh, devices: np.ndarray, remat: bool) -> torch.Tensor:
    """impl='pallas' of sharded_rollout_nd (2D)."""
    _check_fusable(cfg)
    grid = devices.shape
    h, w = _block_shape(tuple(h0.shape), grid)
    H, W = grid[0] * h, grid[1] * w
    first = mesh.devices.flat[0]
    leaves = _flatten(params)
    needs_grad = torch.is_grad_enabled() and (
        h0.requires_grad or any(t.requires_grad for t in leaves))
    groups = _group_blocks(devices)
    x0 = h0.to(torch.float32)
    if _one_launch(groups, needs_grad, grid, h, w, cfg):
        device = groups[0][0]
        packed = pack_pi_params_2d(_tree_to(params, device), cfg)
        frames = rollout_blocks_2d(packed, x0.to(device).contiguous(), _field_layout(grid, h, w),
                                   cfg, n_steps)
        return frames.to(first)
    groups = _group_layouts(groups, grid, h, w)
    replicas = {g.device: _tree_to(params, g.device) for g in groups}
    packed = {d: pack_pi_params_2d(r, cfg) for d, r in replicas.items()}
    states = _states(x0, groups, grid, h, w)

    def advance(n: int, *flat: torch.Tensor) -> tuple:
        """n steps of every group: per group its n states, stacked."""
        cur, out = list(flat), [[] for _ in flat]
        for _ in range(n):
            cur = _step_groups(cur, groups, replicas, packed, cfg)
            for k, s in enumerate(cur):
                out[k].append(s)
        return tuple(torch.stack(s) for s in out)

    remat = remat and torch.is_grad_enabled()
    frames = [[s[None]] for s in states]
    for n in _segments(n_steps, remat):
        part = (checkpoint(advance, n, *states, use_reentrant=False, preserve_rng_state=False)
                if remat else advance(n, *states))
        for k, p in enumerate(part):
            frames[k].append(p)
        states = [p[-1] for p in part]
    frames = [torch.cat(f).to(first) for f in frames]
    if len(groups) == 1:
        blocks = frames[0]
    else:
        at = {pos: (k, b) for k, g in enumerate(groups) for b, pos in enumerate(g.positions)}
        blocks = torch.stack([frames[at[pos][0]][:, at[pos][1]] for pos in np.ndindex(grid)],
                             dim=1)
    return blocks.reshape(-1, grid[0], grid[1], h, w, 2).transpose(2, 3).reshape(-1, H, W, 2)


def sharded_rollout_nd(params: dict, h0: torch.Tensor, cfg: PiCellConfig, n_steps: int,
                       mesh, *, axis_names: Sequence[str] | None = None, remat: bool = True,
                       impl: str = "jnp") -> torch.Tensor:
    """Domain-decomposed rollout: h0 [*spatial, C] -> frames
    [n_steps + 1, *spatial, C] on the mesh's first device.

    Any spatial rank matching ``cfg.ndim``: 2D over ('x', 'y'), 3D over
    ('x', 'y', 'z'); ``axis_names`` defaults to the first ``cfg.ndim`` mesh
    axes, and each spatial dim must divide by its axis' size, into blocks of
    at least 2 cells.  Differentiable in ``params`` and ``h0``: autograd
    crosses the exchange, and the blocks' parameter gradients sum on
    ``params``.  impl='pallas' (2D cells of odd kernel_size <= 5, f32
    frames) steps each device's blocks in one launch of
    ops/kernels/sharded_step2d.py's kernel a step, and with every block on
    one device and no gradient runs the whole rollout in one launch; 'jnp'
    steps each block through the eager valid-region step.
    """
    if axis_names is None:
        axis_names = tuple(mesh.axis_names)[:cfg.ndim]
    axis_names = tuple(axis_names)
    if len(axis_names) != cfg.ndim:
        raise ValueError(f"need {cfg.ndim} mesh axes for a {cfg.ndim}D rollout, "
                         f"got {axis_names}")
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {_IMPLS})")
    devices = _block_devices(mesh, axis_names)
    if impl == "pallas":
        return _pallas_rollout(params, h0, cfg, n_steps, mesh, devices, remat)
    replicas = {d: _tree_to(params, d) for d in set(devices.flat)}
    blocks = _split(h0, devices)
    shape = blocks.shape

    def advance(n: int, *flat: torch.Tensor) -> tuple:
        """n steps of the blocks: per block its n states, stacked."""
        grid = object_grid(shape, flat)
        states = [[] for _ in flat]
        for _ in range(n):
            grid = _step_blocks(replicas, grid, cfg, mesh, axis_names)
            for k, b in enumerate(grid.flat):
                states[k].append(b)
        return tuple(torch.stack(s) for s in states)

    remat = remat and torch.is_grad_enabled()
    frames = [[b[None]] for b in blocks.flat]
    flat = list(blocks.flat)
    for n in _segments(n_steps, remat):
        part = (checkpoint(advance, n, *flat, use_reentrant=False, preserve_rng_state=False)
                if remat else advance(n, *flat))
        for k, p in enumerate(part):
            frames[k].append(p)
        flat = [p[-1] for p in part]
    joined = object_grid(shape, [torch.cat(f, dim=0) for f in frames])
    return _assemble(joined, mesh.devices.flat[0])


# ---------------------------------------------------------------------------
# GSPMD's counterparts: DTensor over a process group (parallel/spmd.py)


def shard_array(x, mesh, spec: P) -> torch.Tensor:
    """`x` placed on the mesh as `spec` says (GSPMD's input annotation): a
    DTensor whose data is rank 0's.  Call it on every rank."""
    return distribute(torch.as_tensor(x), device_mesh(mesh), placements(mesh, spec))


def replicate(tree, mesh):
    """Every tensor (or array) leaf of `tree` replicated over the mesh."""
    dmesh = device_mesh(mesh)
    place = placements(mesh, P())
    return tree_map(lambda x: distribute(torch.as_tensor(x), dmesh, place), tree)


class ScaleByAdamState(NamedTuple):
    """optax.ScaleByAdamState: the step count and the two moments."""

    count: int
    mu: Any
    nu: Any


class GradientTransformation(NamedTuple):
    """optax's contract: init(params) -> state; update(updates, state,
    params=None) -> (updates, state)."""

    init: Callable
    update: Callable


def _zip_map(fn, *trees):
    """fn over the leaves of trees of one structure (dicts and lists)."""
    return _unflatten(trees[0], iter([fn(*xs) for xs in zip(*map(_flatten, trees))]))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax.scale_by_adam written out in torch: the moments' exponential
    averages, their bias corrections at the incremented count, and
    mu_hat / (sqrt(nu_hat + eps_root) + eps) as the update (a descent
    direction: the caller scales it by -lr).  Elementwise, so DTensor
    leaves keep their placements."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p)
        return ScaleByAdamState(0, _zip_map(zeros, params), _zip_map(zeros, params))

    def update(updates, state: ScaleByAdamState, params=None):
        mu = _zip_map(lambda g, m: b1 * m + (1 - b1) * g, updates, state.mu)
        nu = _zip_map(lambda g, v: b2 * v + (1 - b2) * g * g, updates, state.nu)
        count = state.count + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        out = _zip_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2 + eps_root) + eps), mu, nu)
        return out, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def make_train_step_spmd(loss_fn, tx, mesh, *, param_spec: P = P()):
    """An SPMD train step: step(params, opt_state, batch, lr) ->
    (params, opt_state, total, aux), run on every rank.

    loss_fn(params, batch) -> (loss, aux), the plain model on DTensor
    inputs (the batch placed by shard_array): DTensor partitions it, and
    plain tensors it makes are taken as replicated.  Params, gradients and
    optimizer state are pinned to ``param_spec`` (replicated by default),
    as the JAX step's sharding constraints pin them: the gradient of a
    replicated parameter comes back a partial sum and is reduced to the
    parameter's placement before ``tx`` sees it.  tx follows optax's
    init/update contract (``scale_by_adam``); the update is params - lr * u.
    """
    def step(params, opt_state, batch, lr):
        dmesh = device_mesh(mesh)
        place = placements(mesh, param_spec)

        def pin(tree):
            return tree_map(lambda x: distribute(x, dmesh, place)
                            if isinstance(x, torch.Tensor) else x, tree)

        params = pin(params)
        leaves = [p.detach().requires_grad_(True) for p in _flatten(params)]
        with full_f32():
            total, aux = implicitly_replicated(loss_fn)(_unflatten(params, iter(leaves)), batch)
            grads = pin(_unflatten(params, iter(torch.autograd.grad(total, leaves))))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            params = pin(_zip_map(lambda p, u: p - lr * u, params, updates))
        aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, aux)
        return params, pin(opt_state), total.detach(), aux

    return step
