"""Extra (non-demo-contract) scenario drivers.

The port of audio_inpainting_tpu/pipelines/extras.py's ``run_unet_gap``,
which reproduces main5_UNet_gap.py: the Part-2 style deterministic 2D STFT
gap (frames 40-60%), the MSE over the whole spectrogram (the overfitting
demonstration, main5_UNet_gap.py:142), 600 epochs, writing
``dl_corrupted.wav`` / ``dl_restored.wav`` and ``spec_dl_restored_gap.png``
under the assets root. These artifacts are not in ASSET_REGISTRY: the demo
does not read them.
"""

from __future__ import annotations

import os
import time

import torch

from ..corrupt import frame_gap_mask_2d
from ..device import resolve_device
from ..io import load_mono_normalized, save_spectrogram_png, save_wav_int16
from ..methods.neural import UNetTrainConfig, unet_train_restore
from ..metrics import snr_db
from ..ops import istft, magphase, polar, stft, torch_stft_config

_CFG = torch_stft_config(1024, 256)


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
