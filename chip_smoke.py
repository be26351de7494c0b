#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GS2D serving path once on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources with nvcc,
holds them against the committed golden model and against their plain
PyTorch versions, serves GS2D requests through ``build_serving_fn`` at full
width (100 x 100, 2500 steps), and times the kernels.  Phases, one JSON line
each with the seconds since start:

  env      card name and power limit (nvidia-smi), torch and CUDA versions
  build    nvcc build of percnn_tpu_torch/ops/kernels/csrc/cell2d.cu
  golden   ISG and kernel rollout against tests/golden/pt_gs2d.npz
  kernels  each kernel against its plain version at 100 x 100, T = 200
  serve    three frames requests and one final-state request, 2500 steps,
           with the kernels' launch counters set to 0 just before
  times    each kernel's and its plain version's ms per rollout at the
           serving shape, beside the card's bound for the same work

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check ends the run with a
non-zero exit and no last line; so does a machine without a CUDA device, or
a directory without the percnn_tpu_torch package beside this script.  The
script imports neither jax nor percnn_tpu.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "pt_gs2d.npz")

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bandwidth and float32 outside the tensor cores (an FMA counts as 2).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

SERVE_STEPS = 2500
CHECK_STEPS = 200
SEEDS = (66, 67, 68)


class CheckFailed(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(name: str, **fields) -> None:
    emit({"phase": name, "elapsed_s": round(time.perf_counter() - T0, 3), **fields})


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def allclose(got, want, rtol: float, atol: float) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def flops_per_cell_step(cfg) -> int:
    """Flops of one Euler step at one cell, counted from the kernel: per
    channel 12 for the Laplacian and 4 for the update; per equation
    hidden * (5 * n_branches + 1) + 1 for the Pi block."""
    return 2 * (12 + 4 + cfg.hidden * (5 * cfg.n_branches + 1) + 1)


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device ms of fn() over reps calls, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import percnn_tpu_torch
    except ImportError:
        percnn_tpu_torch = None
    if percnn_tpu_torch is None or not os.path.abspath(
            percnn_tpu_torch.__file__).startswith(os.path.join(ROOT, "")):
        print("chip_smoke: the percnn_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2

    from percnn_tpu_torch.bridge import params_from_numpy, unflatten_dotted
    from percnn_tpu_torch.core.isg import isg_apply
    from percnn_tpu_torch.data.noise import add_noise
    from percnn_tpu_torch.data.simulate import default_ic
    from percnn_tpu_torch.experiments.configs import GS2D_RECON
    from percnn_tpu_torch.ops.kernels import _build, cell2d
    from percnn_tpu_torch.serving import build_serving_fn

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        [shutil.which("nvidia-smi") or "nvidia-smi",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
          torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0])
    # The serving path runs in full float32 (it sets these flags itself);
    # the checks below that call the ISG directly do the same.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t = time.perf_counter()
    _build.load_library("cell2d")
    phase("build", source="percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
          seconds=round(time.perf_counter() - t, 3))

    cfg, isg_cfg = GS2D_RECON.cell, GS2D_RECON.isg
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    model = {"cell": unflatten_dotted(golden, "cell."),
             "isg": unflatten_dotted(golden, "isg.")}
    params = params_from_numpy(model, device=dev, dtype=torch.float32)

    # golden: the reference's trained GS2D model, 64 x 64, 8 steps
    isg_out = isg_apply(params["isg"], torch.as_tensor(golden["isg_in"], device=dev), isg_cfg)
    isg_want = torch.as_tensor(golden["isg_out"], device=dev)
    isg_err = max_abs(isg_out, isg_want)
    check(allclose(isg_out, isg_want, rtol=1e-5, atol=2e-6),
          f"golden ISG: max |diff| {isg_err} over atol 2e-6")
    frames_want = torch.as_tensor(golden["frames"], device=dev)
    n_golden = frames_want.shape[0] - 1
    frames = cell2d.fused_rollout_2d(params["cell"], frames_want[0], cfg, n_golden)
    torch.cuda.synchronize()
    step_err = [max_abs(frames[k], frames_want[k]) for k in range(1, n_golden + 1)]
    for k, err in enumerate(step_err, start=1):
        check(err <= 2e-5 * k, f"golden rollout step {k}: max |diff| {err} over {2e-5 * k}")
    phase("golden", isg_max_abs_err=isg_err, isg_atol=2e-6,
          rollout_max_abs_err_per_step=step_err, rollout_bar="2e-5 * t")

    # kernels: full width, trained weights, against the plain versions
    h0 = torch.as_tensor(default_ic("gray_scott_2d", GS2D_RECON.grid), dtype=torch.float32,
                         device=dev)
    packed = cell2d.pack_pi_params_2d(params["cell"], cfg)
    got = cell2d.fused_rollout_2d(params["cell"], h0, cfg, CHECK_STEPS)
    want = cell2d.fused_rollout_2d_plain(packed, h0, cfg, CHECK_STEPS)
    got_final = cell2d.fused_rollout_final_2d(params["cell"], h0, cfg, CHECK_STEPS)
    want_final = cell2d.fused_rollout_final_2d_plain(packed, h0, cfg, CHECK_STEPS)
    torch.cuda.synchronize()
    err = {"rollout2d_kernel": max_abs(got, want), "final2d_kernel": max_abs(got_final, want_final)}
    check(allclose(got, want, rtol=2e-4, atol=1e-5),
          f"rollout2d_kernel vs plain: max |diff| {err['rollout2d_kernel']}")
    check(allclose(got_final, want_final, rtol=2e-4, atol=1e-5),
          f"final2d_kernel vs plain: max |diff| {err['final2d_kernel']}")
    phase("kernels", shape=[GS2D_RECON.grid, GS2D_RECON.grid, 2], steps=CHECK_STEPS,
          max_abs_err=err, rtol=2e-4, atol=1e-5)

    # serve: the main path, through the entry point a user calls
    serve = build_serving_fn(model, cfg, SERVE_STEPS, isg_cfg=isg_cfg, device=dev)
    serve_final = build_serving_fn(model, cfg, SERVE_STEPS, isg_cfg=isg_cfg,
                                   final_only=True, device=dev)
    requests = [add_noise(default_ic("gray_scott_2d", GS2D_RECON.grid, seed=s)[None],
                          GS2D_RECON.noise_pct, seed=s)[0][::isg_cfg.scale, ::isg_cfg.scale]
                for s in SEEDS]
    cell2d.fused_rollout_2d.launches = 0
    cell2d.fused_rollout_final_2d.launches = 0
    answers, request_s = [], []
    for req in requests:
        t = time.perf_counter()
        answers.append(serve(req))
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    final = serve_final(requests[0])
    torch.cuda.synchronize()
    request_s.append(time.perf_counter() - t)
    launches = {"rollout2d_kernel": cell2d.fused_rollout_2d.launches,
                "final2d_kernel": cell2d.fused_rollout_final_2d.launches}
    n = GS2D_RECON.grid
    for a in answers:
        check(tuple(a.shape) == (SERVE_STEPS + 1, n, n, 2), f"frames shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite frames")
    check(tuple(final.shape) == (n, n, 2) and bool(torch.isfinite(final).all()),
          "final state not finite or of the wrong shape")
    final_err = max_abs(final, answers[0][-1])
    check(allclose(final, answers[0][-1], rtol=1e-6, atol=1e-7),
          f"final-state request vs last frame: max |diff| {final_err}")
    check(launches == {"rollout2d_kernel": len(SEEDS) * SERVE_STEPS,
                       "final2d_kernel": SERVE_STEPS}, f"launch counts {launches}")
    phase("serve", requests=len(requests) + 1, steps=SERVE_STEPS, launches=launches,
          request_seconds=request_s, final_vs_last_frame_max_abs_err=final_err)

    # times: per rollout at the serving shape (the ISG output of request 0)
    with torch.inference_mode():
        h0 = isg_apply(params["isg"], torch.as_tensor(requests[0], dtype=torch.float32,
                                                      device=dev)[None], isg_cfg)[0].contiguous()
    cells = h0.shape[0] * h0.shape[1]
    flops = SERVE_STEPS * cells * flops_per_cell_step(cfg)
    state_bytes, param_bytes = 8 * cells, 4 * packed.numel()
    runs = {
        "rollout2d_kernel": (
            lambda: cell2d._rollout_cuda(packed, h0, cfg, SERVE_STEPS),
            lambda: cell2d.fused_rollout_2d_plain(packed, h0, cfg, SERVE_STEPS),
            param_bytes + state_bytes + (SERVE_STEPS + 1) * state_bytes,
            "cell2d._rollout_kernel", "percnn_tpu/ops/pallas/cell2d.py:332"),
        "final2d_kernel": (
            lambda: cell2d._final_cuda(packed, h0, cfg, SERVE_STEPS),
            lambda: cell2d.fused_rollout_final_2d_plain(packed, h0, cfg, SERVE_STEPS),
            param_bytes + 2 * state_bytes,
            "cell2d._final_kernel", "percnn_tpu/ops/pallas/cell2d.py:384"),
    }
    kernels = []
    for name, (kernel, plain, nbytes, jax_name, replaces) in runs.items():
        b_ms, b_by = bound_ms(nbytes, flops)
        kernels.append({
            "name": name, "jax_kernel": jax_name, "route": "cuda",
            "source": "percnn_tpu_torch/ops/kernels/csrc/cell2d.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": cuda_ms(torch, kernel, reps=5),
            "plain_ms": cuda_ms(torch, plain, reps=1), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
    phase("times", shape=list(h0.shape), steps=SERVE_STEPS,
          flops_per_rollout=flops, nvidia_smi=smi)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
