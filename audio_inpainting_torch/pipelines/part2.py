"""Part 2: one 2-second hole in the middle of the 10 s clip.

The port of audio_inpainting_tpu/pipelines/part2.py (reference
generate_part2_data.py, main3_AR_text_gap.py, main4_NMF_gap.py,
main_gan_gap.py, main_diffusion_gap.py):

1. corrupt: zero the centered 2 s window; write damaged + linear baseline +
   original.
2. AR: reload the damaged clip through the int16 chain, blind-detect the
   hole as the longest silent run (the reference's first-to-last-silent
   detector spans nearly the whole clip on real music), and fill it with
   order-100 texture AR over 5000-sample contexts, chunked 128 samples
   per step.
3. NMF: per-column silent-fraction mask (1e-4 / 90%), one-shot masked NMF.
4. GAN: min-max [-1, 1] normalized magnitude, mask = norm > -0.95, 1500
   adversarial epochs against the ground-truth clip's spectrogram, read out
   through the gap-scoped weight EMA, with one retrain on the mode-collapse
   signature.
5. Diffusion: log-spec image codec, DDPM (per-clip training unless
   pretrained weights are given), DDIM RePaint, Griffin-Lim, fill-energy
   calibration and the time-domain composite.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..corrupt import center_gap_bounds, find_gaps, silent_frame_columns
from ..device import resolve_device
from ..io import load_mono_normalized
from ..methods import ARConfig, ar_restore_gap, linear_fill_gap
from ..methods.diffusion import DiffusionConfig, diffusion_restore_audio
from ..methods.neural import GANTrainConfig, gan_train_restore
from ..methods.nmf import NMFConfig, nmf_inpaint_columns
from ..metrics import local_snr_db, lsd_db, snr_db
from ..ops import istft, magphase, polar, stft, torch_stft_config
from .registry import asset_path, write_artifacts

_CFG = torch_stft_config(1024, 256)


def _metrics(name, original, restored, gs, ge, t0, results, device):
    results[name] = {
        "snr_db": float(snr_db(original, restored, device)),
        "local_snr_db": float(local_snr_db(original, restored, gs, ge, device)),
        "lsd_db": float(lsd_db(original, restored, device=device)),
        "wall_s": time.time() - t0,
    }


def detect_main_gap(damaged: np.ndarray, threshold: float = 1e-4,
                    min_len: int = 1000) -> tuple[int, int] | None:
    """Longest sub-threshold run — robust single-gap detection."""
    gaps = find_gaps(damaged, threshold=threshold, min_len=min_len)
    if not gaps:
        return None
    return max(gaps, key=lambda g: g[1] - g[0])


def run_part2(input_file: str, assets_dir: str = "demo_assets", seed: int = 0,
              gan_epochs: int = 1500,
              diffusion_cfg: DiffusionConfig | None = None,
              diffusion_checkpoint: str | None = None,
              diffusion_params=None, device=None) -> dict:
    """Run the linear, AR, NMF, GAN and diffusion legs on ``input_file``;
    write their artifacts under ``assets_dir`` and return their metrics.
    The diffusion leg trains per clip unless ``diffusion_params`` (a
    DiffusionUNet state dict) or ``diffusion_checkpoint`` (a ``save_params``
    directory) is given. Runs on ``device`` (cuda by default)."""
    dev = resolve_device(device)
    sr, data = load_mono_normalized(input_file)
    n_target = 10 * sr
    if len(data) > n_target:
        data = data[:n_target]
    n = len(data)
    results: dict = {"sr": sr}

    # --- 1. corruption + linear baseline ---------------------------------
    gs, ge = center_gap_bounds(n, sr)
    results["gap"] = (gs, ge)
    corrupted = data.copy()
    corrupted[gs:ge] = 0.0
    write_artifacts(corrupted, sr, assets_dir, "part2", "damaged")
    write_artifacts(data, sr, assets_dir, "part2", "original")
    t0 = time.time()
    lin = linear_fill_gap(data, gs, ge, device=dev).cpu().numpy()
    _metrics("linear", data, lin, gs, ge, t0, results, dev)
    write_artifacts(lin, sr, assets_dir, "part2", "linear")

    # downstream methods reload through the int16 chain, like the reference
    _, damaged = load_mono_normalized(asset_path(assets_dir, "part2", "damaged"))

    # --- 2. AR order-100 with texture ------------------------------------
    t0 = time.time()
    gap = detect_main_gap(damaged) or (gs, ge)
    results["detected_gap"] = gap
    cfg = ARConfig(order=100, alpha=0.5, texture=True, context_len=5000,
                   chunk=128)
    ar = ar_restore_gap(damaged, gap, cfg, seed, device=dev).cpu().numpy()
    ar = np.clip(ar, -1.0, 1.0)
    _metrics("ar", data, ar, gs, ge, t0, results, dev)
    write_artifacts(ar, sr, assets_dir, "part2", "ar")

    # --- 3. one-shot NMF --------------------------------------------------
    t0 = time.time()
    mag_d, phase_d = magphase(stft(torch.tensor(damaged, device=dev), _CFG))
    bad = np.zeros(mag_d.shape[1], bool)
    bad[silent_frame_columns(damaged, mag_d.shape[1], 256, threshold=1e-4,
                             silent_fraction=0.9, device=dev)] = True
    out_mag = nmf_inpaint_columns(mag_d, torch.as_tensor(bad, device=dev),
                                  NMFConfig(n_components=40, n_iter=200), 42)
    nmf = istft(polar(out_mag, phase_d), _CFG, n).cpu().numpy()
    _metrics("nmf", data, nmf, gs, ge, t0, results, dev)
    write_artifacts(nmf, sr, assets_dir, "part2", "nmf")

    # --- 4. GAN ------------------------------------------------------------
    t0 = time.time()
    mag_min, mag_max = mag_d.min(), mag_d.max()
    norm = (mag_d - mag_min) / (mag_max - mag_min) * 2.0 - 1.0
    keep = (norm > -0.95).to(torch.float32)          # main_gan_gap.py:97
    real_mag, _ = magphase(stft(torch.tensor(data, device=dev), _CFG))
    real_norm = (real_mag - mag_min) / (mag_max - mag_min) * 2.0 - 1.0
    # the JAX package's production readout: the gap-scoped weight EMA, and
    # one retrain on the hole-L1 mode-collapse signature, which is
    # calibrated at convergence and so armed only from 1500 epochs on
    final_norm, _, attempts = gan_train_restore(
        norm, real_norm, keep,
        GANTrainConfig(epochs=gan_epochs, bf16=True, ema_decay=0.99,
                       ema_scope="gap",
                       retry_l1=0.04 if gan_epochs >= 1500 else 0.0),
        seed)
    final_mag = (final_norm + 1.0) / 2.0 * (mag_max - mag_min) + mag_min
    gan = istft(polar(final_mag, phase_d), _CFG, n).cpu().numpy()
    _metrics("gan", data, gan, gs, ge, t0, results, dev)
    results["gan"]["attempts"] = attempts
    write_artifacts(gan, sr, assets_dir, "part2", "gan")

    # --- 5. diffusion ------------------------------------------------------
    t0 = time.time()
    diff = diffusion_restore_audio(damaged, sr, diffusion_cfg or DiffusionConfig(),
                                   key=seed, checkpoint_dir=diffusion_checkpoint,
                                   params=diffusion_params, device=dev)
    diff = np.clip(diff, -1.0, 1.0)
    _metrics("diffusion", data, diff, gs, ge, t0, results, dev)
    results["diffusion"]["pretrained"] = (diffusion_params is not None
                                          or diffusion_checkpoint is not None)
    write_artifacts(diff, sr, assets_dir, "part2", "diffusion")
    return results
