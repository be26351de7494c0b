"""Experiment configurations: the GS2D reconstruction model.

Counterpart of percnn_tpu/experiments/configs.py, with the same field
values.  The other experiments come with the slices that run them.
"""

from __future__ import annotations

import dataclasses

from percnn_tpu_torch.core.cell import PiCellConfig
from percnn_tpu_torch.core.isg import ISGConfig
from percnn_tpu_torch.core.losses import DataLossConfig
from percnn_tpu_torch.core.train import TrainConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    system: str                     # PDE system name
    grid: int                       # per-axis grid points
    dt: float
    dx: float
    train_steps: int                # rollout steps during (final) training
    infer_steps: int                # rollout steps at inference
    curriculum: tuple = ()          # earlier shorter-T stages
    cell: PiCellConfig = None
    isg: ISGConfig | None = None    # None => IC taken from truth (forward sim)
    data: DataLossConfig | None = None
    train: TrainConfig = None
    loss_weights: dict = None       # {'data': w, 'ic': w, 'phy': w}
    noise_pct: float = 0.1
    interp_method: str = "cubic"    # IC-loss target interpolation
    interp_align_corners: bool = False
    interp_periodic_extend: bool = False
    isg_pretrain_iters: int = 4000
    seed: int = 66


# 2D Gray-Scott reconstruction (train_2drd.py:594-670): ISG 4x, Pi C=8 k=1,
# bounded diffusion mu_up=3.99e-5, 40*data + 0.25*ic, Adam 1e-3
# StepLR(200, .985) x6000, T curriculum 200->400->800, 2500-step inference.
GS2D_RECON = ExperimentConfig(
    name="gs2d_recon",
    system="gray_scott_2d",
    grid=100,
    dt=0.5,
    dx=0.01,
    train_steps=800,
    infer_steps=2500,
    curriculum=(200, 400),
    cell=PiCellConfig(
        ndim=2, hidden=8, kernel_size=1, dt=0.5, dx=0.01,
        diffusion="sigmoid", mu_up=3.99e-5, init="xavier", init_scale=0.02,
    ),
    isg=ISGConfig(ndim=2, hidden=8, strides=(2, 2), activation="sigmoid"),
    data=DataLossConfig(time_stride=20, space_stride=4, val_frac=0.1),
    train=TrainConfig(n_iters=6000, lr=1e-3, lr_step=200, lr_gamma=0.985,
                      watchdog=False, steps_per_call=10),
    loss_weights={"data": 40.0, "ic": 0.25},
    noise_pct=0.1,
    interp_method="cubic",
)
