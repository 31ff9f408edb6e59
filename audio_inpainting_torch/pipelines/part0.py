"""Part 0: tiny contiguous gap in a 0.05 s mid-clip segment.

The port of audio_inpainting_tpu/pipelines/part0.py: a 20% gap at 40% of
the segment, restored by a Gaussian process (main1_gp.py, on the segment
and on the synthetic 200 + 450 Hz signal), bidirectional AR without
texture (main2_AR.py) and with texture injection (main3_AR_text.py), and
iterative NMF (main4_NMF.py); each leg also draws its waveform figure
(io/viz.py) where matplotlib is installed.
"""

from __future__ import annotations

import os
import time

import numpy as np

import torch

from ..corrupt import contiguous_gap_mask
from ..device import resolve_device
from ..io import load_mono_normalized
from ..io.viz import (ar_texture_waveform_viz, ar_waveform_viz, gp_waveform_viz,
                      nmf_waveform_viz)
from ..methods import ARConfig, ar_restore_gap, ar_restore_gap_detailed
from ..methods.gp import GPConfig, gp_restore
from ..methods.nmf import NMFConfig, nmf_inpaint_iterative
from ..metrics import local_snr_db, snr_db
from ..ops import istft, magphase, polar, scipy_stft_config, stft
from .registry import write_artifacts


def _metrics(name, original, restored, gs, ge, t0, results, device):
    results[name] = {
        "snr_db": float(snr_db(original, restored, device)),
        "local_snr_db": float(local_snr_db(original, restored, gs, ge, device)),
        "wall_s": time.time() - t0,
    }


def synthetic_signal(duration: float = 0.05, sr: int = 16000,
                     seed: int = 0) -> tuple[int, np.ndarray]:
    """The reference's synthetic fallback: 200 + 450 Hz sines + noise at
    16 kHz, used when no input file exists (main1_gp.py:53-59; reference is
    unseeded — seeded here)."""
    t = np.linspace(0, duration, int(duration * sr), dtype=np.float32)
    rng = np.random.RandomState(seed)
    sig = (0.5 * np.sin(2 * np.pi * 200 * t)
           + 0.3 * np.sin(2 * np.pi * 450 * t)
           + 0.02 * rng.randn(len(t)))
    return sr, sig.astype(np.float32)


def run_part0(input_file: str | None, assets_dir: str = "demo_assets",
              duration: float = 0.05, gap_ratio: float = 0.2,
              seed: int = 0, gp_cfg: GPConfig | None = None,
              device=None) -> dict:
    """Run the GP, synthetic GP, AR, AR+texture and NMF legs; write their
    artifacts under ``assets_dir`` and return their metrics. Runs on
    ``device`` (cuda by default)."""
    dev = resolve_device(device)
    if input_file is None or not os.path.exists(input_file):
        # reference behavior: synthesize when the clip is missing
        sr, signal = synthetic_signal(duration, seed=seed)
        n = len(signal)
    else:
        sr, data = load_mono_normalized(input_file)
        n = int(duration * sr)
        start = len(data) // 2
        signal = data[start : start + n]
    mask, (gs, ge) = contiguous_gap_mask(n, gap_ratio)
    corrupted = signal.copy()
    corrupted[gs:ge] = 0.0
    results: dict = {"gap": (gs, ge), "sr": sr}
    t_axis = np.arange(n, dtype=np.float32) / sr

    # --- GP (main1_gp.py) ---
    t0 = time.time()
    gp_out, sigma = gp_restore(signal, mask, sr, gp_cfg or GPConfig(), seed,
                               device=dev)
    _metrics("gp", signal, gp_out, gs, ge, t0, results, dev)
    write_artifacts(corrupted, sr, assets_dir, "part0", "gp_corrupted")
    write_artifacts(gp_out, sr, assets_dir, "part0", "gp")
    write_artifacts(signal, sr, assets_dir, "part0", "gp_original")
    gp_waveform_viz(t_axis, signal, gp_out, sigma, (gs, ge),
                    os.path.join(assets_dir, "part0", "gp_waveform_viz.png"))

    # --- synthetic GP demo: the main1_gp.py fallback on its 200 + 450 Hz
    # synthetic signal, shipped beside the real-clip assets ---
    t0 = time.time()
    syn_sr, syn_sig = synthetic_signal(duration, seed=seed)
    syn_mask, (ss, se) = contiguous_gap_mask(len(syn_sig), gap_ratio)
    syn_out, syn_sigma = gp_restore(syn_sig, syn_mask, syn_sr, gp_cfg or GPConfig(),
                                    seed, device=dev)
    gp_waveform_viz(np.arange(len(syn_sig), dtype=np.float32) / syn_sr,
                    syn_sig, syn_out, syn_sigma, (ss, se),
                    os.path.join(assets_dir, "part0", "synthetic_gp_restoration.png"))
    _metrics("gp_synthetic", syn_sig, syn_out, ss, se, t0, results, dev)

    # --- Bidirectional AR, order 30, no texture (main2_AR.py) ---
    t0 = time.time()
    cfg = ARConfig(order=30, alpha=0.1, texture=False, context_len=max(gs, n - ge))
    ar_t, fwd, bwd = ar_restore_gap_detailed(corrupted, (gs, ge), cfg, seed,
                                             device=dev)
    ar_out = ar_t.cpu().numpy()
    _metrics("ar", signal, ar_out, gs, ge, t0, results, dev)
    write_artifacts(corrupted, sr, assets_dir, "part0", "ar_corrupted")
    write_artifacts(ar_out, sr, assets_dir, "part0", "ar")
    write_artifacts(signal, sr, assets_dir, "part0", "ar_original")
    ar_waveform_viz(t_axis, signal, ar_out, fwd, bwd, (gs, ge),
                    os.path.join(assets_dir, "part0", "ar_waveform_viz.png"), order=30)

    # --- AR + texture injection (main3_AR_text.py) ---
    # The reference's noise injection is unseeded (main3_AR_text.py:74), so
    # a single run is one draw of a spread of about 1 dB: run n_seeds
    # draws, report mean and std, and ship the median-SNR draw.
    t0 = time.time()
    cfg = ARConfig(order=30, alpha=0.5, texture=True, context_len=max(gs, n - ge))
    n_seeds = 5
    draws = [ar_restore_gap(corrupted, (gs, ge), cfg, seed + 1000 * i,
                            device=dev).cpu().numpy()
             for i in range(n_seeds)]
    snrs = np.array([float(snr_db(signal, d, dev)) for d in draws])
    med = int(np.argsort(snrs)[len(snrs) // 2])
    art_out = draws[med]
    _metrics("ar_texture", signal, art_out, gs, ge, t0, results, dev)
    results["ar_texture"]["snr_db_mean"] = float(np.mean(snrs))
    results["ar_texture"]["snr_db_std"] = float(np.std(snrs))
    results["ar_texture"]["n_seeds"] = n_seeds
    write_artifacts(corrupted, sr, assets_dir, "part0", "ar_texture_corrupted")
    write_artifacts(art_out, sr, assets_dir, "part0", "ar_texture")
    write_artifacts(signal, sr, assets_dir, "part0", "ar_texture_original")
    ar_texture_waveform_viz(t_axis, signal, art_out, (gs, ge),
                            os.path.join(assets_dir, "part0", "ar_texture_waveform_viz.png"))

    # --- Iterative NMF (main4_NMF.py): 512/384 STFT, faded gap, 50 refits ---
    t0 = time.time()
    nmf_corr = signal.copy()
    fade_len = min(100, gs, n - ge)
    if fade_len > 0:  # the reference fades into the gap (main4_NMF.py:53-58)
        window = np.linspace(1, 0, fade_len, dtype=np.float32)
        nmf_corr[gs - fade_len : gs] *= window
        nmf_corr[ge : ge + fade_len] *= window[::-1]
    nmf_corr[gs:ge] = 0.0
    scfg = scipy_stft_config(512, 384)
    mag, phase = magphase(stft(torch.tensor(nmf_corr, device=dev), scfg))
    t_step = 128 / sr  # hop/sr: scipy stft frame spacing
    col_start = int(gs / sr / t_step)
    col_end = int(ge / sr / t_step)
    out_mag = nmf_inpaint_iterative(
        mag, col_start, col_end,
        NMFConfig(n_components=40, n_iter=200, outer_iters=50), seed)
    nmf_out = istft(polar(out_mag, phase), scfg, n).cpu().numpy()
    # boundary crossfade back into the clean signal (main4_NMF.py:114-126)
    final = signal.copy()
    bw = 50
    ramp = np.linspace(0, 1, bw, dtype=np.float32)
    final[gs:ge] = nmf_out[gs:ge]
    final[gs - bw : gs] = final[gs - bw : gs] * (1 - ramp) + nmf_out[gs - bw : gs] * ramp
    final[ge : ge + bw] = final[ge : ge + bw] * ramp + nmf_out[ge : ge + bw] * (1 - ramp)
    _metrics("nmf", signal, final, gs, ge, t0, results, dev)
    write_artifacts(nmf_corr, sr, assets_dir, "part0", "nmf_corrupted")
    write_artifacts(final, sr, assets_dir, "part0", "nmf")
    write_artifacts(signal, sr, assets_dir, "part0", "nmf_original")
    restored_mag = stft(torch.tensor(final, device=dev), scfg).abs().cpu().numpy()
    nmf_waveform_viz(signal, final, (gs, ge), sr, restored_mag,
                     os.path.join(assets_dir, "part0", "nmf_waveform_viz.png"))
    return results
