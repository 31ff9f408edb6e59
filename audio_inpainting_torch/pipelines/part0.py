"""Part 0: tiny contiguous gap in a 0.05 s mid-clip segment.

The port's slice of audio_inpainting_tpu/pipelines/part0.py: a 20% gap at
40% of the segment, restored by bidirectional AR without texture
(main2_AR.py) and with texture injection (main3_AR_text.py). The GP and
NMF legs and the waveform figures wait for later slices (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..corrupt import contiguous_gap_mask
from ..device import resolve_device
from ..io import load_mono_normalized
from ..methods import ARConfig, ar_restore_gap
from ..metrics import local_snr_db, snr_db
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
              seed: int = 0, device=None) -> dict:
    """Run the AR and AR+texture legs; write their artifacts under
    ``assets_dir`` and return their metrics. Runs on ``device`` (cuda by
    default)."""
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
    _, (gs, ge) = contiguous_gap_mask(n, gap_ratio)
    corrupted = signal.copy()
    corrupted[gs:ge] = 0.0
    results: dict = {"gap": (gs, ge), "sr": sr}

    # --- Bidirectional AR, order 30, no texture (main2_AR.py) ---
    t0 = time.time()
    cfg = ARConfig(order=30, alpha=0.1, texture=False, context_len=max(gs, n - ge))
    ar_out = ar_restore_gap(corrupted, (gs, ge), cfg, seed,
                            device=dev).cpu().numpy()
    _metrics("ar", signal, ar_out, gs, ge, t0, results, dev)
    write_artifacts(corrupted, sr, assets_dir, "part0", "ar_corrupted")
    write_artifacts(ar_out, sr, assets_dir, "part0", "ar")
    write_artifacts(signal, sr, assets_dir, "part0", "ar_original")

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
    return results
