"""Experiment configurations: the forward simulation of lambda-omega, the
GS2D and GS3D reconstruction models and the 5x5-Pi Stage-1 reconstructions
of Burgers and lambda-omega.

Counterpart of percnn_tpu/experiments/configs.py, with the same field
values.
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


# 2D lambda-omega forward solve (percnn_LO_eqn.py:474-543): physics loss only,
# raw learnable diffusion, Pi C=4 k=1, f64, Adam 1e-2 StepLR(25, .98) x2000.
FORWARD_SIM_LO = ExperimentConfig(
    name="forward_sim_lo",
    system="lambda_omega",
    grid=100,
    dt=0.0125,
    dx=0.2,
    train_steps=400,
    infer_steps=800,
    cell=PiCellConfig(
        ndim=2, hidden=4, kernel_size=1, dt=0.0125, dx=0.2,
        diffusion="raw", diff_init=0.2, init="fanin", init_scale=0.5,
    ),
    isg=None,
    data=None,
    train=TrainConfig(n_iters=2000, lr=1e-2, lr_step=25, lr_gamma=0.98,
                      watchdog=False, steps_per_call=25),
    loss_weights={"phy": 1.0},
    noise_pct=0.0,
)

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


# 3D Gray-Scott reconstruction (train_3drd.py:494-558): ISG 2x trilinear,
# Pi C=2 k=1, mu_up=0.274, 10*data + 5*ic, Adam 2e-3 StepLR(250, .975)
# x12000, T curriculum 150->300, 1000-step inference.  The trainer's whole
# robustness family is on: NaN and spike watchdog, lr_recover,
# spike_reset_opt, best-by-loss, abort_policy="stop" and the stability
# probe every 250 iterations (percnn_tpu/experiments/configs.py gives the
# runs that motivated each).
GS3D_RECON = ExperimentConfig(
    name="gs3d_recon",
    system="gray_scott_3d",
    grid=48,
    dt=0.5,
    dx=100.0 / 48.0,
    train_steps=300,
    infer_steps=1000,
    curriculum=(150,),
    cell=PiCellConfig(
        ndim=3, hidden=2, kernel_size=1, dt=0.5, dx=100.0 / 48.0,
        diffusion="sigmoid", mu_up=0.274, init="xavier", init_scale=0.01,
    ),
    isg=ISGConfig(ndim=3, hidden=8, strides=(2, 1), activation="sigmoid"),
    data=DataLossConfig(time_stride=15, space_stride=2, val_frac=0.0,
                        drop_last_frame=True),
    train=TrainConfig(n_iters=12000, lr=2e-3, lr_step=250, lr_gamma=0.975,
                      watchdog=True, watchdog_key="phy", steps_per_call=10,
                      spike_mult=10.0, best_key="loss", lr_recover=1.002,
                      spike_reset_opt=True, probe_every=250,
                      abort_policy="stop"),
    loss_weights={"data": 10.0, "ic": 5.0},
    noise_pct=0.1,
    interp_method="linear",
)


# 2D Burgers Stage-1 reconstruction (rcnn_Burgers...py:911-1015): ISG 2x
# Tanh C=16, Pi 5x5 C=16, bounded diffusion mu_up=0.01 (nu=1/200 true),
# 1*data + 1*ic, best-val checkpoint, Adam 2e-3 StepLR(200, .97) x10000,
# 1200-step inference; the IC target is wrap-extended, bicubic with
# align_corners=True.
BURGERS_STAGE1 = ExperimentConfig(
    name="burgers_stage1",
    system="burgers",
    grid=100,
    dt=0.00025,
    dx=0.01,
    train_steps=200,
    infer_steps=1200,
    cell=PiCellConfig(
        ndim=2, hidden=16, kernel_size=5, dt=0.00025, dx=0.01,
        diffusion="sigmoid", mu_up=0.01, init="xavier", init_scale=0.02,
    ),
    isg=ISGConfig(ndim=2, hidden=16, strides=(2,), activation="tanh"),
    data=DataLossConfig(time_stride=5, space_stride=2, val_frac=0.1),
    train=TrainConfig(n_iters=10000, lr=2e-3, lr_step=200, lr_gamma=0.97,
                      best_val=True, steps_per_call=5),
    loss_weights={"data": 1.0, "ic": 1.0},
    noise_pct=0.05,
    interp_method="cubic",
    interp_align_corners=True,
    interp_periodic_extend=True,
)

# 2D lambda-omega Stage-1 reconstruction (rcnn_LO...py): like Burgers
# Stage-1 with lambda-omega dynamics, 15000 iterations, 400-step inference.
LO_STAGE1 = ExperimentConfig(
    name="lo_stage1",
    system="lambda_omega",
    grid=100,
    dt=0.0125,
    dx=0.2,
    train_steps=200,
    infer_steps=400,
    cell=PiCellConfig(
        ndim=2, hidden=16, kernel_size=5, dt=0.0125, dx=0.2,
        diffusion="sigmoid", mu_up=0.2, init="xavier", init_scale=0.02,
    ),
    isg=ISGConfig(ndim=2, hidden=16, strides=(2,), activation="tanh"),
    data=DataLossConfig(time_stride=5, space_stride=2, val_frac=0.1),
    train=TrainConfig(n_iters=15000, lr=2e-3, lr_step=200, lr_gamma=0.97,
                      best_val=True, steps_per_call=5),
    loss_weights={"data": 1.0, "ic": 1.0},
    noise_pct=0.1,
    interp_method="cubic",
    interp_align_corners=True,
    interp_periodic_extend=True,
)

# name -> config, in percnn_tpu's order
EXPERIMENTS = {
    e.name: e
    for e in (FORWARD_SIM_LO, GS2D_RECON, GS3D_RECON, BURGERS_STAGE1, LO_STAGE1)
}
