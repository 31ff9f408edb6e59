"""Part 1: random STFT-frame dropouts over the full 10 s clip.

The port's slice of audio_inpainting_tpu/pipelines/part1.py (replicating
the reference's inter-script WAV chaining):

1. corrupt: STFT (1024/256) -> SpecAugment-style random frame mask ->
   iSTFT with the original phase -> publish ``damaged_random.wav`` as the
   common baseline (main5_UNet_mask.py:111-156). Seeded, unlike the
   reference.
2. linear: reload the damaged WAV (int16 chain), detect by |x| > 0.01,
   fill with np.interp semantics (linear_interp_part1.py).
3. AR: reload, blind-detect the dropped STFT columns, invert the OLA
   attenuation where it is invertible (methods/ola_eq.py), then
   bidirectional texture AR over the residual deep gaps, all batched
   (reference family: main3_AR_text_mask.py). This leg runs the CUDA AR
   kernel.
4. NMF: reload, per-column silent-fraction mask (0.01 / 80%), one-shot
   masked NMF (main4_NMF_mask.py).
5. U-Net: per-clip masked-MSE training (400 epochs, bf16 convs) on the
   clip's normalized magnitude, composite, iSTFT with the original phase
   (main5_UNet_mask.py:158-193); the input / prediction / ground truth
   panels go to ``spectrogram_comparison.png``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..corrupt import random_frame_mask, silent_frame_columns
from ..device import resolve_device
from ..io import load_mono_normalized, unet_panels_viz
from ..methods import ARConfig, ar_restore_gaps, linear_interp_masked
from ..methods.neural import UNetTrainConfig, unet_train_restore
from ..methods.nmf import NMFConfig, nmf_inpaint_columns
from ..methods.ola_eq import equalize_dropped_frames
from ..metrics import lsd_db, snr_db
from ..ops import istft, magphase, polar, stft, torch_stft_config
from .registry import asset_path, write_artifacts

_CFG = torch_stft_config(1024, 256)


def _metrics(name, original, restored, t0, results, device):
    results[name] = {
        "snr_db": float(snr_db(original, restored, device)),
        "lsd_db": float(lsd_db(original, restored, device=device)),
        "wall_s": time.time() - t0,
    }


def _draw_frame_mask(seed: int, n_freq: int, n_frames: int, mask_ratio: float,
                     device: torch.device) -> torch.Tensor:
    """The corruption's frame mask, drawn from a CPU generator seeded with
    ``seed`` (the same mask on every device) and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return random_frame_mask(gen, n_freq, n_frames,
                             mask_ratio=mask_ratio).to(device)


def run_part1(input_file: str, assets_dir: str = "demo_assets", seed: int = 0,
              unet_epochs: int = 400, mask_ratio: float = 0.3,
              device=None) -> dict:
    """Run the corruption and the linear, AR, NMF and U-Net legs on
    ``input_file``; write their artifacts under ``assets_dir`` and return
    their metrics. Runs on ``device`` (cuda by default)."""
    dev = resolve_device(device)
    sr, data = load_mono_normalized(input_file)
    n = len(data)
    results: dict = {"sr": sr}

    # --- 1. corruption + publish baseline -------------------------------
    t0 = time.time()
    mag, phase = magphase(stft(torch.tensor(data, device=dev), _CFG))
    mag_max = mag.max()
    mag_norm = mag / mag_max
    mask = _draw_frame_mask(seed, mag.shape[0], mag.shape[1], mask_ratio, dev)
    input_mag = mag_norm * mask
    corrupted = istft(polar(input_mag * mag_max, phase), _CFG, n).cpu().numpy()
    _metrics("damaged", data, corrupted, t0, results, dev)
    write_artifacts(corrupted, sr, assets_dir, "part1", "damaged")
    write_artifacts(data, sr, assets_dir, "part1", "original")

    # reload through the int16 chain, as the downstream scripts do
    _, damaged = load_mono_normalized(asset_path(assets_dir, "part1", "damaged"))

    # --- 2. linear interpolation -----------------------------------------
    # threshold 0.01, not linear_interp_part1.py's 1e-4, which misses the
    # iSTFT's near-silence; the sibling scripts use 0.01 for this input
    # (main3_AR_text_mask.py:33, main4_NMF_mask.py:31)
    t0 = time.time()
    lin = linear_interp_masked(damaged, np.abs(damaged) > 0.01,
                               device=dev).cpu().numpy()
    _metrics("linear", data, lin, t0, results, dev)
    write_artifacts(lin, sr, assets_dir, "part1", "linear")

    # --- 3. AR multi-gap: OLA gain equalization + texture AR fill ---------
    # texture_scale=0.1 keeps the texture's fill at a tenth of the
    # residual sigma, as the JAX package measured best for this input
    t0 = time.time()
    eq, gaps, _ = equalize_dropped_frames(damaged, mag.shape[1], device=dev)
    results["n_gaps"] = len(gaps)
    results["ar_max_len"] = max((e - s for s, e in gaps), default=0)
    ar = ar_restore_gaps(eq, gaps,
                         ARConfig(order=30, alpha=0.5, texture=True,
                                  texture_scale=0.1, context_len=1000,
                                  passes=2),
                         seed + 1, device=dev).cpu().numpy()
    ar = np.clip(ar, -1.0, 1.0)
    _metrics("ar", data, ar, t0, results, dev)
    write_artifacts(ar, sr, assets_dir, "part1", "ar")

    # --- 4. one-shot NMF over detected bad columns -----------------------
    t0 = time.time()
    mag_d, phase_d = magphase(stft(torch.tensor(damaged, device=dev), _CFG))
    bad = np.zeros(mag_d.shape[1], bool)
    bad[silent_frame_columns(damaged, mag_d.shape[1], 256, threshold=0.01,
                             silent_fraction=0.8, device=dev)] = True
    out_mag = nmf_inpaint_columns(mag_d, torch.as_tensor(bad, device=dev),
                                  NMFConfig(n_components=40, n_iter=200), 42)
    nmf = istft(polar(out_mag, phase_d), _CFG, n).cpu().numpy()
    _metrics("nmf", data, nmf, t0, results, dev)
    results["nmf"]["bad_cols"] = int(bad.sum())
    write_artifacts(nmf, sr, assets_dir, "part1", "nmf")

    # --- 5. U-Net self-supervised inpainting ----------------------------
    t0 = time.time()
    final_norm, pred, losses = unet_train_restore(
        mag_norm, mask, UNetTrainConfig(epochs=unet_epochs, masked_loss=True,
                                        bf16=True), seed)
    unet = istft(polar(final_norm * mag_max, phase), _CFG, n).cpu().numpy()
    _metrics("unet", data, unet, t0, results, dev)
    results["unet"]["final_loss"] = float(losses[-1])
    write_artifacts(unet, sr, assets_dir, "part1", "unet", clip=0.99)
    unet_panels_viz(input_mag.cpu().numpy(), pred.cpu().numpy(),
                    mag_norm.cpu().numpy(),
                    os.path.join(assets_dir, "part1", "spectrogram_comparison.png"))
    return results
