"""Mesh parallelism: the halo-exchange decomposition and GSPMD's counterpart.

Counterpart of percnn_tpu/parallel.  Its explicit halo path keeps one
controller: a ``Mesh`` is an array of ``torch.device``s, each block a tensor
on its mesh device, and a halo strip moves by ``.to(device)``, a peer copy
between two GPUs and a local copy on one.  Autograd carries a halo's
cotangent back to the block it came from (the transpose of the exchange),
and the blocks' parameter gradients sum on the one parameter tree.

Its GSPMD path (``shard_array``, ``replicate``, ``make_train_step_spmd``)
runs one process a mesh position, joined in a torch.distributed process
group, on DTensors: ``launch`` starts the ranks (or runs in place under
torchrun), ``P`` is the partition spec (parallel/spmd.py).
"""

from percnn_tpu_torch.parallel.halo import halo_exchange
from percnn_tpu_torch.parallel.mesh import Mesh, factor_devices, make_mesh
from percnn_tpu_torch.parallel.sharded import (
    make_train_step_spmd,
    pi_cell_step_haloed,
    replicate,
    scale_by_adam,
    shard_array,
    sharded_rollout_nd,
)
from percnn_tpu_torch.parallel.spmd import P, launch

__all__ = ["Mesh", "P", "factor_devices", "halo_exchange", "launch", "make_mesh",
           "make_train_step_spmd", "pi_cell_step_haloed", "replicate", "scale_by_adam",
           "shard_array", "sharded_rollout_nd"]
