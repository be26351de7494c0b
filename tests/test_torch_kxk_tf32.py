"""The arithmetic of the one-launch k x k kernels (csrc/kxk_mma.cuh), emulated
on the CPU: their branch products run on the tensor cores in 3xTF32, each
f32 operand a split into hi = tf32(a) (cvt.rna: round to nearest, ties away,
of the low 13 mantissa bits) and lo = tf32(a - hi), a product being
lo_a hi_b + hi_a lo_b + hi_a hi_b.  The emulation lives here, not in the
package: the rollout and the reverse sweep of the committed Burgers Stage-1
cell (C = 16, 3 branches, 5x5) on a 16 x 16 field for T = 20, with both
products (y = im2col Wm^T and zw = z Wm_taps) emulated, held to the f32
plain versions at the kernels' bars: the forward rtol 2e-4 / atol 1e-5,
each sweep output 2e-4 * max|plain| + 2e-6.  One TF32 pass alone errs at
least 10 times as much, so the bars would catch it."""

import os

import numpy as np
import pytest
import torch

from percnn_tpu_torch.bridge import params_from_numpy, unflatten_dotted
from percnn_tpu_torch.experiments.configs import BURGERS_STAGE1
from percnn_tpu_torch.ops.kernels import backward2d, cell2d
from percnn_tpu_torch.ops.stencils import laplacian_2d

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pt_burgers_s1.npz")
CFG = BURGERS_STAGE1.cell
STEPS = 20


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: an f32 tensor rounded to 10 mantissa bits, ties
    away from zero (half an ulp of tf32 added to the magnitude bits, then
    the low 13 bits cleared)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    hi = tf32(x)
    return hi, tf32(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32 product with exact products (as the tensor cores' TF32 ones)."""
    return (a.double() @ b.double()).float()


def mm_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ah, al), (bh, bl) = split(a), split(b)
    return (_mm(al, bh) + _mm(ah, bl)) + _mm(ah, bh)


def mm_1x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _mm(tf32(a), tf32(b))


def rollout_emulated(wmat, tail, h0, cfg, n_steps, mm):
    """fused_rollout_kxk_2d_plain with the branch product y = im2col Wm^T
    (the ones column folding in the biases) taken by mm."""
    H, W = h0.shape[:2]
    frames = [h0]
    for _ in range(n_steps):
        h = frames[-1]
        y = mm(cell2d.im2col_2d(h, cfg).reshape(H * W, -1), wmat.T).reshape(H, W, -1)
        frames.append(h + cfg.dt * (tail[:2] * laplacian_2d(h, cfg.dx)
                                    + cell2d.pi_from_activations(y, tail, cfg)))
    return torch.stack(frames)


def sweep_emulated(wmat, tail, frames, frames_bar, cfg, mm):
    """fused_phase1_kxk_2d_plain with both products taken by mm: (g_ins,
    g0, ys [T, M, H, W])."""
    C, nb, k = cfg.hidden, cfg.n_branches, cfg.kernel_size
    taps, r = k * k * 2, k // 2
    H, W = frames.shape[1:3]
    w_out = tail[2:2 + 2 * C].reshape(2, C)
    n_steps = frames.shape[0] - 1
    g = torch.zeros_like(frames_bar[0])
    g_ins, ys = [None] * n_steps, [None] * n_steps
    for t in range(n_steps - 1, -1, -1):
        g_in = g + frames_bar[t + 1]
        y = mm(cell2d.im2col_2d(frames[t], cfg).reshape(H * W, -1), wmat.T).reshape(H, W, -1)
        ys[t] = y.movedim(-1, 0)
        gw = g_in[..., :, None, None] * w_out[:, None, :]
        z = gw * backward2d._leave_one_out_prod(y.unflatten(-1, (2, nb, C)), -2)
        zw = mm(z.reshape(H * W, -1), wmat[:, :taps]).reshape(H, W, taps)
        jt = 0.0
        for ki in range(k):
            for kj in range(k):
                tap = ki * k + kj
                jt = jt + torch.roll(zw[..., 2 * tap: 2 * tap + 2], shifts=(ki - r, kj - r),
                                     dims=(0, 1))
        g_ins[t] = g_in
        g = g_in + cfg.dt * (tail[:2] * laplacian_2d(g_in, cfg.dx) + jt)
    return torch.stack(g_ins), g, torch.stack(ys)


@pytest.fixture(scope="module")
def burgers():
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    params = params_from_numpy(unflatten_dotted(golden, "cell."), device="cpu",
                               dtype=torch.float32)
    wmat = cell2d.pack_pi_matrix_2d(params, CFG)
    tail = cell2d.pi_tail_2d(params, CFG)
    h0 = torch.as_tensor(golden["frames"][0][::4, ::4], dtype=torch.float32).contiguous()
    frames = cell2d.fused_rollout_kxk_2d_plain(wmat, tail, h0, CFG, STEPS)
    fbar = torch.as_tensor(np.random.RandomState(4).standard_normal(tuple(frames.shape)),
                           dtype=torch.float32)
    return wmat, tail, h0, frames, fbar


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # tf32's spacing above 1
    x = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                      -(one + 0.5 * ulp), one + 1.5 * ulp, 3.0e-3, -7.123456], dtype=torch.float32)
    got = tf32(x)
    assert got[:4].tolist() == [one, one + ulp, one + ulp, -(one + ulp)]
    assert got[4].item() == one + 2 * ulp              # ties away, not to even
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # the nearest 10-bit mantissa, elsewhere: within half an ulp of x
    m, e = np.frexp(x.double().numpy())
    assert (np.abs(got.double().numpy() - x.double().numpy()) <= 2.0 ** (e - 12) + 0).all()


def test_three_term_split_keeps_f32():
    x = torch.as_tensor(np.random.RandomState(0).standard_normal(10000), dtype=torch.float32)
    hi, lo = split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21                # hi + lo holds 22 of f32's 24 bits
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max().item() > 2.0 ** -13
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    # the ones column of im2col splits exactly: hi 1, lo 0
    assert split(torch.ones(1))[0].item() == 1.0 and split(torch.ones(1))[1].item() == 0.0


def test_rollout_in_3xtf32_holds_the_forward_bar(burgers):
    wmat, tail, h0, want, _ = burgers
    got3 = rollout_emulated(wmat, tail, h0, CFG, STEPS, mm_3x)
    got1 = rollout_emulated(wmat, tail, h0, CFG, STEPS, mm_1x)
    err3, err1 = (got3 - want).abs().max().item(), (got1 - want).abs().max().item()
    assert bool(((got3 - want).abs() <= 1e-5 + 2e-4 * want.abs()).all()), err3
    assert err1 >= 10 * err3, (err1, err3)


def test_sweep_in_3xtf32_holds_the_gradient_bar(burgers):
    wmat, tail, _, frames, fbar = burgers
    want = backward2d.fused_phase1_kxk_2d_plain(wmat, tail, frames, fbar, CFG)
    got3 = sweep_emulated(wmat, tail, frames, fbar, CFG, mm_3x)
    got1 = sweep_emulated(wmat, tail, frames, fbar, CFG, mm_1x)
    for name, a3, a1, b in zip(("g_ins", "g0", "ys"), got3, got1, want):
        assert a3.shape == b.shape
        scale = b.abs().max().item()
        err3, err1 = (a3 - b).abs().max().item(), (a1 - b).abs().max().item()
        assert err3 <= 2e-4 * scale + 2e-6, (name, err3, scale)
        assert err1 >= 10 * err3, (name, err1, err3)
