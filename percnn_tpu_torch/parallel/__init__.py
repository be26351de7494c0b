"""Spatial domain decomposition in one process.

Counterpart of percnn_tpu/parallel for its explicit halo path: the grid
axes of the field are cut into blocks over a mesh of devices, and every
step each block takes a 2-cell halo from its ring neighbours, whose
wrap-around is the global periodic boundary.  Where JAX runs the blocks
under ``shard_map`` and moves the halos with ``lax.ppermute``, the port
keeps one controller: a ``Mesh`` is an array of ``torch.device``s, each
block a tensor on its mesh device, and a halo strip moves by
``.to(device)``, a peer copy between two GPUs and a local copy on one.
Autograd carries a halo's cotangent back to the block it came from (the
transpose of the exchange), and the blocks' parameter gradients sum on the
one parameter tree.

Not here yet: the GSPMD helpers ``make_train_step_spmd``, ``shard_array``
and ``replicate`` (ROADMAP.md A10).
"""

from percnn_tpu_torch.parallel.halo import halo_exchange
from percnn_tpu_torch.parallel.mesh import Mesh, factor_devices, make_mesh
from percnn_tpu_torch.parallel.sharded import pi_cell_step_haloed, sharded_rollout_nd

__all__ = ["Mesh", "factor_devices", "halo_exchange", "make_mesh", "pi_cell_step_haloed",
           "sharded_rollout_nd"]
