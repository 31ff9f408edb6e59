"""The corpus-prior trainer (audio_inpainting_torch/tools/
train_diffusion_prior.py) against the JAX package's tool
(tools/train_diffusion_prior.py), on the CPU at small sizes."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.io import save_wav_int16
from audio_inpainting_torch.tools import train_diffusion_prior as tool
from audio_inpainting_torch.utils import load_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import train_diffusion_prior as jax_tool  # noqa: E402

torch.set_num_threads(1)

# the codec's bound (tests/test_torch_diffusion.py::test_codec_matches_jax):
# the port's FFT against JAX's DFT matmul moves a pixel by one uint8
# level, on 2.6e-4 to 3.7e-4 of a 10 s clip's pixels here
PIXEL_SHARE = 1e-3


def test_build_corpus_matches_jax():
    """Two clips at 8 kHz: the clean images and the even clip's corrupted
    variant in the same order; images within one uint8 level on at most
    PIXEL_SHARE of the pixels; masks equal but where a pixel's level
    differs across the mask's threshold (mask_from_image's 10)."""
    images, masks = tool.build_corpus(2, 8000, "cpu")
    jimages, jmasks = jax_tool.build_corpus(2, 8000)
    assert len(images) == len(jimages) == 3
    for img, jimg, m, jm in zip(images, jimages, masks, jmasks):
        assert img.dtype == jimg.dtype == np.uint8 and img.shape == jimg.shape
        diff = np.abs(img.astype(np.int16) - jimg.astype(np.int16))
        assert diff.max() <= 1 and np.count_nonzero(diff) <= PIXEL_SHARE * diff.size
        across = (diff > 0) & (np.minimum(img, jimg) == 9)
        np.testing.assert_array_equal(m[~across], jm[~across])
    assert not masks[0].any() and masks[1].any() and not masks[2].any()


def test_main_trains_writes_and_evaluates_on_the_cpu(tmp_path, capsys):
    """The command line at a tiny config (2 clips, 4 steps, base width 16)
    writes a prior that load_params reads back, and prints the JAX
    tool's keys; --eval-only then evaluates that prior to the same
    numbers."""
    wav = save_wav_int16(synth_music_clip(1, 8000, 3.0), 8000, str(tmp_path / "eval.wav"))
    out = str(tmp_path / "prior")
    small = dict(base_channels=16, batch=2, patch=16, sample_steps=2)
    argv = ["--clips", "2", "--steps", "4", "--out", out, "--device", "cpu",
            "--skip-adapted", "--eval-wav", wav]
    assert tool.main(argv, **small) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"corpus_prior", "train_steps", "checkpoint"} <= trained.keys()
    assert trained["train_steps"] == 4 and trained["checkpoint"] == out
    assert trained["train"]["images"] == 3 and trained["train"]["losses_finite"]
    assert len(trained["train"]["loss_curve"]) == 1
    state = load_params(out, "cpu")
    assert len(state) == 82 and all(torch.isfinite(v).all() for v in state.values())
    with open(os.path.join(out, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["train_steps"] == 4 and manifest["base_channels"] == 16
    assert manifest["images"] == 3

    assert tool.main(argv + ["--eval-only"], **small) == 0
    evaluated = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "train" not in evaluated
    for key in ("snr_db", "local_snr_db", "lsd_db"):
        assert np.isfinite(evaluated["corpus_prior"][key])
        assert evaluated["corpus_prior"][key] == trained["corpus_prior"][key]


def test_loss_curve_means_each_stretch():
    losses = torch.arange(2500, dtype=torch.float32)
    assert tool.loss_curve(losses) == [499.5, 1499.5, 2249.5]


def test_main_needs_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tool.main(["--clips", "1", "--steps", "1", "--out", str(tmp_path / "p")])
