"""The port's diffusion method on the GPU against the same functions on the
CPU, with the same draws (seeded CPU generators), fp32 with TF32 off. These
tests need a GPU and skip without one.

The bounds are the CPU tests' against the JAX package
(tests/test_torch_diffusion.py): Griffin-Lim agreement >= 80 dB, the
U-Net forward within 1e-5 of its peak, training losses within 1e-5
relative and parameters within 2e-5, DDIM samples within 5e-5.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_diffusion_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_inpainting_torch import restore
from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.methods import diffusion as diff
from audio_inpainting_torch.ops.griffin_lim import griffin_lim
from audio_inpainting_torch.utils import load_params

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

GL_AGREEMENT_DB = 80.0
FORWARD_RTOL_OF_PEAK = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
DDIM_ATOL = 5e-5
CFG = diff.DiffusionConfig(train_steps=3, batch=2, patch=16, sample_steps=4,
                           base_channels=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(seed=0):
    rng = np.random.RandomState(seed)
    img = torch.tensor((rng.rand(40, 48) * 2.0 - 1.0).astype(np.float32))
    keep = torch.ones(40, 48)
    keep[:, 20:30] = 0.0
    return img, keep


def _agreement_snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


@pytest.mark.requires_cuda
def test_griffin_lim_on_gpu_matches_cpu(cuda):
    x = synth_music_clip(0, 16000, 1.0)
    img, smin, smax = diff.logspec_to_image(diff.wav_to_logspec(torch.tensor(x)).numpy())
    mag = diff.image_to_linear_spec(img, smin, smax)
    got = griffin_lim(mag, length=len(x), seed=3, device=cuda)
    want = griffin_lim(mag, length=len(x), seed=3, device="cpu")
    assert got.device.type == "cuda"
    assert _agreement_snr(want.numpy(), got.cpu().numpy()) >= GL_AGREEMENT_DB


@pytest.mark.requires_cuda
def test_prior_loads_onto_the_gpu_and_its_forward_matches_cpu(cuda):
    state = load_params(diff.PRIOR_DIR)
    assert all(v.device.type == "cuda" for v in state.values())
    x = torch.randn(2, 1, 64, 48, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([3.0, 871.0])
    with torch.no_grad():
        got = diff.new_model(state, 32, cuda)(x.to(cuda), t.to(cuda))
        want = diff.new_model(state, 32, "cpu")(x, t)
    assert float((got.cpu() - want).abs().max()) <= FORWARD_RTOL_OF_PEAK * float(
        want.abs().max())


@pytest.mark.requires_cuda
def test_training_steps_on_gpu_match_cpu(cuda):
    img, keep = _image()
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = diff.new_model(diff._draw_init(0, "clip", 8), 8, dev)
        losses = diff.train_steps(model, diff._adam_for(model, CFG), img.to(dev),
                                  keep.to(dev), CFG, 0, "clip", range(CFG.train_steps))
        out.append((losses.cpu(), {k: v.cpu() for k, v in model.state_dict().items()}))
    (gl, gp), (cl, cp) = out
    assert float((gl - cl).abs().max()) <= LOSS_RTOL * float(cl.abs().max())
    for name, val in gp.items():
        assert float((val - cp[name]).abs().max()) <= PARAM_ATOL, name


@pytest.mark.requires_cuda
def test_ddim_on_gpu_matches_cpu(cuda):
    img, keep = _image(1)
    state = load_params(diff.PRIOR_DIR, "cpu")
    cfg = diff.DiffusionConfig(sample_steps=4)
    got = diff.ddim_repaint(diff.new_model(state, 32, cuda), img.to(cuda), keep.to(cuda),
                            0, cfg)
    want = diff.ddim_repaint(diff.new_model(state, 32, "cpu"), img, keep, 0, cfg)
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= DDIM_ATOL
    assert torch.equal(got.cpu()[keep == 1], img[keep == 1])


@pytest.mark.requires_cuda
def test_facade_diffusion_runs_on_the_gpu_by_default(cuda):
    sr = 8000
    damaged = synth_music_clip(0, sr, 2.0)
    damaged[6000:9000] = 0.0
    kw = {"batch": 2, "patch": 16, "sample_steps": 2, "base_channels": 8}
    for extra in ({"train_steps": 2}, {"checkpoint_dir": diff.PRIOR_DIR,
                                       "base_channels": 32}):
        out = restore(damaged, sr, "diffusion", **{**kw, **extra})
        assert out.shape == damaged.shape and np.isfinite(out).all()
        assert not np.array_equal(out[6000:9000], damaged[6000:9000])
