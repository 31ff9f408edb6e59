"""The CUDA kernels of audio_inpainting_torch/ops/bn_leaky.py (train-mode
BatchNorm + LeakyReLU) against the plain formula computed in float64, at
every BatchNorm site of the GAN cell. These tests need a GPU and skip
without one.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_bn_leaky_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_inpainting_torch.methods import neural
from audio_inpainting_torch.models.unet import BN_EPS, BN_MOMENTUM, LEAKY_SLOPE
from audio_inpainting_torch.ops import bn_leaky
from audio_inpainting_torch.utils.profiling import prime_session

torch.set_num_threads(1)

STEP = 1.0 - BN_MOMENTUM
# fp32 statistics over up to 114 M elements, summed in the kernels' tree,
# sit within a few 1e-7 of float64 relative to the channel's spread; the
# normalization, the affine and each output's rounding add a few ulp
STATS_RTOL = 1e-5
# of the output's peak (or the input gradient's): the statistics' error
# scaled by |xhat| <= ~6, and the rounding of each fp32 step
OUT_RTOL_OF_PEAK = 1e-5
# of sum |term| over the channel: fp32 partial sums of up to ~1e5 terms a
# block, then tree and chunk sums, each term off by a few ulp
SUM_RTOL_OF_ABS = 1e-5
# one bf16 rounding of dx, which the float64 reference does not make:
# half a step of 8 significant bits
BF16_HALF_STEP = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    """Conv-output-like x (a mean and a spread per channel), the affine
    and running averages of a trained BatchNorm, and an output gradient."""
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    loc = torch.randn(1, c, 1, 1, generator=g)
    scale = 0.2 + torch.rand(1, c, 1, 1, generator=g) * 3
    x = torch.randn(shape, generator=g) * scale + loc
    weight = 1.0 + 0.3 * torch.randn(c, generator=g)
    bias = 0.2 * torch.randn(c, generator=g)
    rm, rv = 0.1 * torch.randn(c, generator=g), 1.0 + torch.rand(c, generator=g)
    dy = torch.randn(shape, generator=g) * 1e-3
    return ([x.to(dtype).to(device)]
            + [t.to(device) for t in (weight, bias, rm, rv, dy)])


def _run(x, weight, bias, rm, rv, dy):
    """The kernels forward and backward: y, mean, rstd, the moved running
    averages, dx, dweight, dbias."""
    rm, rv = rm.clone(), rv.clone()
    y, mean, rstd = bn_leaky.bn_leaky_forward_cuda(x, weight, bias, rm, rv, STEP, BN_EPS,
                                                   LEAKY_SLOPE)
    dx, dw, db = bn_leaky.bn_leaky_backward_cuda(dy, x, weight, bias, mean, rstd,
                                                 LEAKY_SLOPE)
    torch.cuda.synchronize()
    return y, mean, rstd, rm, rv, dx, dw, db


def _col(v):
    return v.view(1, -1, 1, 1)


# (N, C, H, W): the generator's sites at the cell's (516, 1728) (blocks 0
# and 4, 1 and 3, 2), the discriminator's bn0 and bn1, eight clips' block 0
# and D bn1 (G = 8), a small grid, a ragged one (one element a load), and
# N = 2
SITES = [(1, 16, 516, 1728), (1, 32, 258, 864), (1, 64, 129, 432), (1, 32, 129, 432),
         (1, 64, 64, 216), (1, 128, 516, 1728), (1, 512, 64, 216), (1, 16, 64, 128),
         (1, 3, 63, 127), (2, 8, 32, 48)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", SITES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_match_the_plain_formula_in_float64(cuda, shape, dtype):
    x, weight, bias, rm, rv, dy = _inputs(shape, dtype, cuda)
    y, mean, rstd, rm1, rv1, dx, dw, db = _run(x, weight, bias, rm, rv, dy)
    assert y.dtype == torch.float32 and dx.dtype == dtype
    x64, w64, b64, dy64 = (t.double() for t in (x, weight, bias, dy))
    var64, mean64 = torch.var_mean(x64, dim=(0, 2, 3), correction=0)
    rstd64 = 1.0 / torch.sqrt(var64 + BN_EPS)
    xhat = (x64 - _col(mean64)) * _col(rstd64)
    z = xhat * _col(w64) + _col(b64)
    y64 = torch.where(z > 0, z, z * LEAKY_SLOPE)

    spread = var64.sqrt()
    assert ((mean.double() - mean64).abs() <= STATS_RTOL * spread).all()
    torch.testing.assert_close(rstd.double(), rstd64, rtol=STATS_RTOL, atol=0)
    want_rm = rm.double() + STEP * (mean64 - rm.double())
    want_rv = rv.double() + STEP * (var64 - rv.double())
    assert ((rm1.double() - want_rm).abs() <= STATS_RTOL * (spread + want_rm.abs())).all()
    torch.testing.assert_close(rv1.double(), want_rv, rtol=STATS_RTOL, atol=0)
    assert (y.double() - y64).abs().max() <= OUT_RTOL_OF_PEAK * y64.abs().max()

    # the branch where the kernel's own forward output is positive: at
    # |z| ~ 1e-7 fp32 and float64 may take the two sides of the kink
    dz = torch.where(y > 0, dy64, dy64 * LEAKY_SLOPE)
    count = x.numel() // x.shape[1]
    db64 = dz.sum(dim=(0, 2, 3))
    dw64 = (dz * xhat).sum(dim=(0, 2, 3))
    dx64 = _col(w64 * rstd64) * (dz - _col(db64 / count) - xhat * _col(dw64 / count))
    assert ((db.double() - db64).abs()
            <= SUM_RTOL_OF_ABS * dz.abs().sum(dim=(0, 2, 3))).all()
    assert ((dw.double() - dw64).abs()
            <= SUM_RTOL_OF_ABS * (dz * xhat).abs().sum(dim=(0, 2, 3))).all()
    half_step = BF16_HALF_STEP if dtype == torch.bfloat16 else 0.0
    bound = half_step * dx64.abs() + OUT_RTOL_OF_PEAK * dx64.abs().max()
    assert ((dx.double() - dx64).abs() <= bound).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(1, 16, 516, 1728), (1, 64, 64, 216), (1, 3, 63, 127)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_calls_give_the_same_bytes(cuda, shape, dtype):
    args = _inputs(shape, dtype, cuda, seed=1)
    first, second = _run(*args), _run(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _gan(cuda, bf16):
    v = torch.rand(60, 200, generator=torch.Generator().manual_seed(2))
    mask = torch.ones(60, 200)
    mask[:, 80:100] = 0.0
    real = v * 2.0 - 1.0
    return neural.GANTrainer(real * mask - (1.0 - mask), real, mask,
                             neural.GANTrainConfig(epochs=3, bf16=bf16), 0, device=cuda)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_launches_count_the_gan_epoch_and_not_the_unet_epoch(cuda, bf16):
    """A GAN epoch runs 16 train-mode passes forward (the generator's 10
    BatchNorms, D's 2 in each of its three forwards) and 16 backward (D's
    step through two forwards, the G step through D's third and the
    generator), two launches each; the U-Net has no BatchNorm."""
    gan = _gan(cuda, bf16)
    assert gan.d_live
    before = bn_leaky.LAUNCHES
    gan.epoch()
    torch.cuda.synchronize()
    assert bn_leaky.LAUNCHES - before == 64
    unet = neural.UNetTrainer(torch.rand(60, 200), torch.ones(60, 200),
                              neural.UNetTrainConfig(epochs=3, bf16=bf16), 0, device=cuda)
    before = bn_leaky.LAUNCHES
    unet.epoch()
    torch.cuda.synchronize()
    assert bn_leaky.LAUNCHES == before


@pytest.mark.requires_cuda
def test_gan_epoch_launches_no_library_batchnorm(cuda):
    """Train mode on the card: no aten or cuDNN BatchNorm, the kernels in
    their place; the only LeakyReLU ops left are those after D's first conv,
    which has no BatchNorm (one in each of D's three forwards)."""
    gan = _gan(cuda, True)
    gan.epoch()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prime_session()
        gan.epoch()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    names = list(counts)
    assert not [n for n in names if "batch_norm" in n]
    assert counts.get("aten::leaky_relu") == 3
    assert not [n for n in names if "bn_fw" in n or "bn_bw" in n]
    for kernel in ("bn_leaky_fwd_stats", "bn_leaky_fwd_apply", "bn_leaky_bwd_sums",
                   "bn_leaky_bwd_apply"):
        assert [n for n in names if kernel in n], kernel


@pytest.mark.requires_cuda
def test_the_wrapper_raises_on_what_the_kernels_do_not_take(cuda):
    x, weight, bias, rm, rv, dy = _inputs((1, 4, 16, 24), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bn_leaky.bn_leaky_forward_cuda(x.transpose(2, 3), weight, bias, rm, rv, STEP,
                                       BN_EPS, LEAKY_SLOPE)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn_leaky.bn_leaky_forward_cuda(x.half(), weight, bias, rm, rv, STEP, BN_EPS,
                                       LEAKY_SLOPE)
    with pytest.raises(TypeError, match="weight must be float32"):
        bn_leaky.bn_leaky_forward_cuda(x, weight.double(), bias, rm, rv, STEP, BN_EPS,
                                       LEAKY_SLOPE)
    with pytest.raises(ValueError, match="running_mean is on cpu"):
        bn_leaky.bn_leaky_forward_cuda(x, weight, bias, rm.cpu(), rv, STEP, BN_EPS,
                                       LEAKY_SLOPE)
    y, mean, rstd = bn_leaky.bn_leaky_forward_cuda(x, weight, bias, rm, rv, STEP, BN_EPS,
                                                   LEAKY_SLOPE)
    with pytest.raises(ValueError, match="dy is on cpu"):
        bn_leaky.bn_leaky_backward_cuda(dy.cpu(), x, weight, bias, mean, rstd, LEAKY_SLOPE)
    with pytest.raises(ValueError, match="contiguous float32"):
        bn_leaky.bn_leaky_backward_cuda(dy.half(), x, weight, bias, mean, rstd, LEAKY_SLOPE)
    assert np.isfinite(y.cpu().numpy()).all()
