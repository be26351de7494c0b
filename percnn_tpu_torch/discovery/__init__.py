"""Stage-2/3 PDE discovery: candidate library, STRidge sparse regression,
Pareto analysis, and symbolic extraction of the learned Pi polynomial.

Counterpart of percnn_tpu/discovery; importing it needs no sympy
(discovery.symbolic imports sympy when called)."""

from percnn_tpu_torch.discovery.library import build_design_matrix
from percnn_tpu_torch.discovery.stridge import STRidge, discovery_metrics, pareto_sweep
from percnn_tpu_torch.discovery.symbolic import pi_block_expression
