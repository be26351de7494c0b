"""Shared utilities: metrics logging, parameter counting, timing and
numerical checks."""

from percnn_tpu_torch.utils.metrics import MetricsLogger, rel_l2
from percnn_tpu_torch.utils.params import count_parameters, summary_parameters
