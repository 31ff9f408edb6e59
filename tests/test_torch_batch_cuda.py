"""The port's grouped models, batched per-clip training and serving on the
GPU. These tests need a GPU and skip without one.

- Batch against single on the card: each clip of ``restore_clips_unet`` /
  ``restore_clips_gan`` against ``unet_train_restore`` /
  ``gan_train_restore`` from the same init, fp32 with TF32 off, by the
  CPU tests' bounds (losses 1e-4 relative; composites 1e-4 (U-Net) and
  1e-3 (GAN) of peak): cuDNN's grouped and plain convolutions sum in
  other orders.
- A batch in several groups (a cap of 2 over 3 clips) against one group,
  by the same bounds (the package runs cuDNN's deterministic algorithms);
  at this size the card's own cap holds all three in one.
- The grouped BatchNorm keeps each clip's statistics: a grouped
  generator's outputs and running statistics against each clip's own net.
- ``run_serve(method="ar")`` writes, clip by clip, the bytes of the
  facade's restore of that clip.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_batch_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_inpainting_torch import restore
from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16
from audio_inpainting_torch.methods import neural
from audio_inpainting_torch.models import GeneratorUNet, stack_states, unstack_states
from audio_inpainting_torch.parallel import batch, restore_clips_gan, restore_clips_unet
from audio_inpainting_torch.pipelines.serve import run_serve

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
UNET_RTOL_OF_PEAK = 1e-4
GAN_RTOL_OF_PEAK = 1e-3
FORWARD_RTOL_OF_PEAK = 1e-5
STATS_ATOL = 1e-6
G = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _specs(g=G, f=60, t=200, seed=0):
    rng = np.random.RandomState(seed)
    v = np.einsum("gfo,got->gft", np.abs(rng.randn(g, f, 4)), np.abs(rng.randn(g, 4, t)))
    mask = np.ones((g, f, t), np.float32)
    for i in range(g):
        mask[i, :, 80 + 10 * i:100 + 10 * i] = 0.0
    return (v / v.max(axis=(1, 2), keepdims=True)).astype(np.float32), mask


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.requires_cuda
def test_restore_clips_unet_equals_single_on_gpu(cuda):
    v, mask = _specs()
    seeds = [1, 2, 3]
    cfg = neural.UNetTrainConfig(epochs=10)
    out, loss = restore_clips_unet(v[..., None], mask[..., None], cfg, seeds, device=cuda)
    assert out.device.type == "cuda"
    for g in range(G):
        final, _, losses = neural.unet_train_restore(v[g], mask[g], cfg, seeds[g],
                                                     device=cuda)
        assert _rel(loss[g], losses[-1]) <= LOSS_RTOL
        assert _rel(out[g, ..., 0], final) <= UNET_RTOL_OF_PEAK


@pytest.mark.requires_cuda
def test_restore_clips_gan_equals_single_on_gpu(cuda):
    v, mask = _specs(seed=1)
    real = v * 2 - 1
    inp = real * mask - (1 - mask)
    seeds = [4, 5, 6]
    cfg = neural.GANTrainConfig(epochs=5, ema_decay=0.99, ema_scope="gap")
    out, (dl, gl) = restore_clips_gan(inp, real, mask, cfg, seeds, device=cuda)
    for g in range(G):
        final, (d, gg), _ = neural.gan_train_restore(inp[g], real[g], mask[g], cfg,
                                                     seeds[g], device=cuda)
        assert _rel(dl[g], d[-1]) <= LOSS_RTOL and _rel(gl[g], gg[-1]) <= LOSS_RTOL
        assert _rel(out[g], final) <= GAN_RTOL_OF_PEAK


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["unet", "gan"])
def test_groups_by_memory_equal_one_group_on_gpu(cuda, kind, monkeypatch):
    v, mask = _specs(seed=2)
    seeds = [7, 8, 9]
    assert batch.clip_groups(G, batch.clip_bytes(kind, False, *v.shape[1:]),
                             cuda) == [slice(0, G)]
    if kind == "unet":
        def run():
            return restore_clips_unet(v[..., None], mask[..., None],
                                      neural.UNetTrainConfig(epochs=10), seeds,
                                      device=cuda)
    else:
        real = v * 2 - 1
        inp = real * mask - (1 - mask)

        def run():
            out, (dl, gl) = restore_clips_gan(
                inp, real, mask, neural.GANTrainConfig(epochs=5, ema_decay=0.99,
                                                       ema_scope="gap"),
                seeds, device=cuda)
            return out, torch.stack([dl, gl])

    one_out, one_loss = run()
    monkeypatch.setattr(batch, "group_cap", lambda per_clip, device: 2)
    out, loss = run()
    assert _rel(loss, one_loss) <= LOSS_RTOL
    assert _rel(out, one_out) <= (UNET_RTOL_OF_PEAK if kind == "unet" else GAN_RTOL_OF_PEAK)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_batchnorm_keeps_each_clips_statistics_on_gpu(cuda, dtype):
    states = [GeneratorUNet(generator=torch.Generator().manual_seed(10 + g)).state_dict()
              for g in range(G)]
    grouped = GeneratorUNet(dtype, groups=G)
    grouped.load_state_dict(stack_states(states))
    grouped.to(cuda)
    x = torch.tensor(np.random.RandomState(1).randn(1, G, 64, 128).astype(np.float32),
                     device=cuda)
    with torch.no_grad():
        got = grouped(x, True)
    after = unstack_states(grouped.state_dict(), G)
    for g, state in enumerate(states):
        single = GeneratorUNet(dtype)
        single.load_state_dict(state)
        single.to(cuda)
        with torch.no_grad():
            want = single(x[:, g:g + 1], True)
        if dtype == torch.float32:
            assert _rel(got[:, g:g + 1], want) <= FORWARD_RTOL_OF_PEAK
        for k, v in single.state_dict().items():
            if "running" in k and dtype == torch.float32:
                torch.testing.assert_close(after[g][k], v, atol=STATS_ATOL, rtol=0)
        # a clip's statistics are its own: another clip's input moves them
        if g:
            assert not torch.equal(after[g]["block0.bn0.running_mean"],
                                   after[0]["block0.bn0.running_mean"])


@pytest.mark.requires_cuda
def test_serve_ar_is_the_facade_on_gpu(cuda, tmp_path):
    from audio_inpainting_torch.corrupt import random_dropout_mask, synth_music_clip

    din, dout = tmp_path / "in", tmp_path / "out"
    din.mkdir()
    sr = 16000
    for i in range(2):
        clean = synth_music_clip(10 + i, sr, 2.0)
        mask = random_dropout_mask(torch.Generator().manual_seed(i), len(clean)).numpy()
        save_wav_int16(clean * mask, sr, str(din / f"c{i}.wav"))
    run_serve(str(din), str(dout), method="ar", device=cuda)
    for i in range(2):
        _, x = load_mono_normalized(str(din / f"c{i}.wav"))
        save_wav_int16(restore(x, sr, method="ar"), sr, str(tmp_path / "f.wav"))
        assert (dout / f"c{i}.wav").read_bytes() == (tmp_path / "f.wav").read_bytes()
