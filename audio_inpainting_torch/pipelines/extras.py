"""Extra (non-demo-contract) scenario drivers.

The port of audio_inpainting_tpu/pipelines/extras.py.
``run_generate_part1`` reproduces generate_part1_data.py: random
time-domain dropouts (gaps of 50-400 samples, ratio 0.25) and the inline
linear fill, writing damaged_random / fixed_linear_random / original WAVs
and spectrograms under the assets root. Its mask comes from a seeded CPU
generator behind ``_draw_mask`` (the tests inject the JAX package's).
``run_unet_gap`` reproduces main5_UNet_gap.py: the Part-2 style deterministic 2D STFT
gap (frames 40-60%), the MSE over the whole spectrogram (the overfitting
demonstration, main5_UNet_gap.py:142), 600 epochs, writing
``dl_corrupted.wav`` / ``dl_restored.wav`` and ``spec_dl_restored_gap.png``
under the assets root. These artifacts are not in ASSET_REGISTRY: the demo
does not read them.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..corrupt import frame_gap_mask_2d, random_dropout_mask
from ..device import resolve_device
from ..io import load_mono_normalized, save_spectrogram_png, save_wav_int16
from ..methods import linear_interp_masked
from ..methods.neural import UNetTrainConfig, unet_train_restore
from ..metrics import snr_db
from ..ops import istft, magphase, polar, stft, torch_stft_config

_CFG = torch_stft_config(1024, 256)


def _draw_mask(seed: int, n: int, mask_ratio: float) -> np.ndarray:
    """The dropout mask (True = valid) of ``n`` samples, from a CPU
    generator seeded with ``seed``."""
    return random_dropout_mask(torch.Generator().manual_seed(seed), n,
                               mask_ratio=mask_ratio).numpy()


def run_generate_part1(input_file: str, assets_dir: str = "demo_assets",
                       mask_ratio: float = 0.25, seed: int = 0,
                       device=None) -> dict:
    """Time-domain random-dropout corruption and the inline linear fill of
    the reference's generate_part1_data.py (np.interp fill), seeded here.
    Writes damaged_random / fixed_linear_random / original (WAV and
    spectrogram PNG) under the assets root, as the reference did, and
    returns the SNRs and the lost fraction. Runs on ``device`` (cuda by
    default)."""
    dev = resolve_device(device)
    sr, data = load_mono_normalized(input_file)
    mask = np.array(_draw_mask(seed, len(data), mask_ratio), bool)
    corrupted = data.copy()
    corrupted[~mask] = 0.0
    fixed = linear_interp_masked(corrupted, mask, device=dev).cpu().numpy()
    for name, audio in [("damaged_random", corrupted),
                        ("fixed_linear_random", fixed),
                        ("original", data)]:
        save_wav_int16(audio, sr, os.path.join(assets_dir, f"{name}.wav"))
        save_spectrogram_png(audio, sr, os.path.join(assets_dir, f"spec_{name}.png"))
    return {"damaged_snr_db": float(snr_db(data, corrupted, dev)),
            "linear_snr_db": float(snr_db(data, fixed, dev)),
            "lost_fraction": float(1 - mask.mean())}


def run_unet_gap(input_file: str, assets_dir: str = "demo_assets",
                 duration: float = 10.0, epochs: int = 600, seed: int = 0,
                 device=None) -> dict:
    """Train the U-Net over a centred frame gap of the first ``duration``
    seconds of ``input_file``; write the artifacts and return the SNR, the
    final loss and the training wall time. Runs on ``device`` (cuda by
    default)."""
    dev = resolve_device(device)
    sr, data = load_mono_normalized(input_file)
    n = min(len(data), int(duration * sr))
    data = data[:n]

    mag, phase = magphase(stft(torch.tensor(data, device=dev), _CFG))
    mag_max = mag.max()
    mag_norm = mag / mag_max
    mask = frame_gap_mask_2d(mag.shape[0], mag.shape[1], device=dev)
    corrupted = istft(polar(mag_norm * mask * mag_max, phase), _CFG, n).cpu().numpy()

    t0 = time.time()
    final_norm, _, losses = unet_train_restore(
        mag_norm, mask, UNetTrainConfig(epochs=epochs, masked_loss=False, bf16=True),
        seed)
    restored = istft(polar(final_norm * mag_max, phase), _CFG, n).cpu().numpy()
    wall = time.time() - t0

    save_wav_int16(corrupted, sr, os.path.join(assets_dir, "dl_corrupted.wav"),
                   clip=0.99)
    save_wav_int16(restored, sr, os.path.join(assets_dir, "dl_restored.wav"),
                   clip=0.99)
    save_spectrogram_png(restored, sr,
                         os.path.join(assets_dir, "spec_dl_restored_gap.png"))
    return {"snr_db": float(snr_db(data, restored, dev)),
            "final_loss": float(losses[-1]), "wall_s": wall}
