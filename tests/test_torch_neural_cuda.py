"""The port's spectrogram models and training loops on the GPU against the
same functions on the CPU, from the same initial weights (drawn from a
seeded CPU generator), fp32 with TF32 off. These tests need a GPU and skip
without one.

cuDNN's convolutions sum in another order than the CPU's (the package
runs cuDNN's deterministic algorithms, so a GPU run repeats itself bit for
bit, but not the CPU's sums), so the bounds are the CPU tests' against
the JAX package (tests/test_torch_neural.py): losses within 1e-4
relative, the U-Net composite within 1e-4 of its peak, the GAN's within
1e-3 (its eval-mode readout reads the pre-BatchNorm conv biases, whose
Adam steps are rounding noise).

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_neural_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_inpainting_torch import restore
from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.methods import neural
from audio_inpainting_torch.models import Discriminator, GeneratorUNet, SimpleUNet

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
UNET_RTOL_OF_PEAK = 1e-4
GAN_RTOL_OF_PEAK = 1e-3
FORWARD_RTOL_OF_PEAK = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spec(f=60, t=200, seed=0):
    rng = np.random.RandomState(seed)
    v = np.abs(rng.randn(f, 4)) @ np.abs(rng.randn(4, t))
    mask = np.ones((f, t), np.float32)
    mask[:, 80:100] = 0.0
    return torch.tensor((v / v.max()).astype(np.float32)), torch.tensor(mask)


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cls", [SimpleUNet, GeneratorUNet, Discriminator])
@pytest.mark.parametrize("train", [True, False])
def test_model_forward_on_gpu_matches_cpu(cuda, cls, train):
    model = cls(generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 1, 64, 128, generator=torch.Generator().manual_seed(2))
    args = () if cls is SimpleUNet else (train,)
    with torch.no_grad():
        want = model(x, *args)
        got = model.to(cuda)(x.to(cuda), *args)
    assert _rel(got, want) <= FORWARD_RTOL_OF_PEAK


@pytest.mark.requires_cuda
def test_unet_epochs_on_gpu_match_cpu(cuda):
    v, mask = _spec()
    cfg = neural.UNetTrainConfig(epochs=2)
    gf, gp, gl = neural.unet_train_restore(v, mask, cfg, 0, device=cuda)
    cf, cp, cl = neural.unet_train_restore(v, mask, cfg, 0, device="cpu")
    assert gf.device.type == "cuda" and gl.shape == (2,)
    assert _rel(gl, cl) <= LOSS_RTOL
    assert _rel(gf, cf) <= UNET_RTOL_OF_PEAK and _rel(gp, cp) <= UNET_RTOL_OF_PEAK


@pytest.mark.requires_cuda
def test_gan_epochs_on_gpu_match_cpu(cuda):
    v, mask = _spec(seed=3)
    real = v * 2.0 - 1.0
    inp = real * mask - (1.0 - mask)
    cfg = neural.GANTrainConfig(epochs=2, ema_decay=0.9, ema_scope="gap")
    gf, (gd, gg), _ = neural.gan_train_restore(inp, real, mask, cfg, 0, device=cuda)
    cf, (cd, cg), _ = neural.gan_train_restore(inp, real, mask, cfg, 0, device="cpu")
    assert _rel(gd, cd) <= LOSS_RTOL and _rel(gg, cg) <= LOSS_RTOL
    assert _rel(gf, cf) <= GAN_RTOL_OF_PEAK


@pytest.mark.requires_cuda
def test_bf16_training_on_gpu_is_finite(cuda):
    v, mask = _spec(seed=4)
    final, _, losses = neural.unet_train_restore(
        v.to(cuda), mask.to(cuda), neural.UNetTrainConfig(epochs=3, bf16=True), 0)
    assert final.device.type == "cuda" and torch.isfinite(final).all()
    assert torch.isfinite(losses).all() and final.dtype == torch.float32
    real = v.to(cuda) * 2.0 - 1.0
    gan, (dl, gl), _ = neural.gan_train_restore(
        real * mask.to(cuda) - (1.0 - mask.to(cuda)), real, mask.to(cuda),
        neural.GANTrainConfig(epochs=3, bf16=True, ema_decay=0.99, ema_scope="gap"), 0)
    assert torch.isfinite(gan).all() and torch.isfinite(gl).all()


@pytest.mark.requires_cuda
def test_facade_neural_methods_run_on_the_gpu_by_default(cuda):
    sr = 8000
    clean = synth_music_clip(0, sr, 2.0)
    damaged = clean.copy()
    damaged[6000:9000] = 0.0
    for method, kw in (("unet", {}), ("gan", {"original": clean})):
        out = restore(damaged, sr, method, epochs=2, **kw)
        assert out.shape == damaged.shape and np.isfinite(out).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_seeded_training_repeats_itself_on_the_gpu(cuda, bf16):
    """Two seeded U-Net and GAN fits on the card give the same bytes: the
    package runs cuDNN's deterministic algorithms, as the JAX package's
    seeded runs repeat themselves."""
    v, mask = _spec(f=256, t=512, seed=5)
    real = v * 2.0 - 1.0
    inp = real * mask - (1.0 - mask)
    unets = [neural.unet_train_restore(v, mask, neural.UNetTrainConfig(
        epochs=20, bf16=bf16), 0, device=cuda) for _ in range(2)]
    gans = [neural.gan_train_restore(inp, real, mask, neural.GANTrainConfig(
        epochs=10, bf16=bf16, ema_decay=0.99, ema_scope="gap"), 0, device=cuda)
        for _ in range(2)]
    (uf, up, ul), (uf2, up2, ul2) = unets
    (gf, (gd, gg), _), (gf2, (gd2, gg2), _) = gans
    assert torch.equal(uf, uf2) and torch.equal(up, up2) and torch.equal(ul, ul2)
    assert torch.equal(gf, gf2) and torch.equal(gd, gd2) and torch.equal(gg, gg2)


@pytest.mark.requires_cuda
def test_persistent_stream_unet_is_chunk_invariant_on_the_gpu(cuda):
    """The bench's persistent U-Net stream program, cut to a 4 s clip at
    16 kHz and 40 cold / 10 adapt epochs: the same bytes at sr // 10 and
    sr chunks, and every gap filled."""
    from audio_inpainting_torch.tools import bench

    sr = 16000
    damaged, spans = bench.unet_stream_program(synth_music_clip(1, sr, 4.0), sr)
    a, _ = bench.stream_pass(damaged, sr, sr // 10, cuda, "unet", epochs=40, adapt_epochs=10)
    b, _ = bench.stream_pass(damaged, sr, sr, cuda, "unet", epochs=40, adapt_epochs=10)
    assert np.array_equal(a, b)
    assert all(np.abs(b[s:e]).max() > 1e-3 for s, e in spans)
