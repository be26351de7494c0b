"""Experiment configs and runners for the five reference configurations
(SURVEY §2.2): lambda-omega forward sim, 2D/3D Gray-Scott reconstruction,
Burgers & lambda-omega Stage-1 -> Stage-2 -> Stage-3 discovery.
Counterpart of percnn_tpu/experiments."""

from percnn_tpu_torch.experiments.configs import (
    ExperimentConfig,
    FORWARD_SIM_LO,
    GS2D_RECON,
    GS3D_RECON,
    BURGERS_STAGE1,
    LO_STAGE1,
    EXPERIMENTS,
)
