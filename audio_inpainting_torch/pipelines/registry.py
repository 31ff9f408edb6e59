"""Canonical demo_assets artifact registry, copied from the JAX package.

Every artifact has exactly one canonical path. Keys are
(part, method) -> dict(audio=..., image=...), relative to the assets root.
"""

from __future__ import annotations

import os

import numpy as np

from ..io import save_spectrogram_png, save_wav_int16

ASSET_REGISTRY: dict[str, dict[str, dict[str, str]]] = {
    "part0": {
        "gp": {"audio": "part0/gp_restored.wav", "image": "part0/spec_gp_restored.png"},
        "gp_corrupted": {"audio": "part0/gp_corrupted.wav", "image": "part0/spec_gp_corrupted.png"},
        "gp_original": {"audio": "part0/gp_original.wav", "image": "part0/spec_gp_original.png"},
        "ar": {"audio": "part0/ar_restored.wav", "image": "part0/spec_ar_restored.png"},
        "ar_corrupted": {"audio": "part0/ar_corrupted.wav", "image": "part0/spec_ar_corrupted.png"},
        "ar_original": {"audio": "part0/ar_original.wav", "image": "part0/spec_ar_original.png"},
        "ar_texture": {"audio": "part0/ar_texture_restored.wav", "image": "part0/spec_ar_texture_restored.png"},
        "ar_texture_corrupted": {"audio": "part0/ar_texture_corrupted.wav", "image": "part0/spec_ar_texture_corrupted.png"},
        "ar_texture_original": {"audio": "part0/ar_texture_original.wav", "image": "part0/spec_ar_texture_original.png"},
        "nmf": {"audio": "part0/nmf_restored.wav", "image": "part0/spec_nmf_restored.png"},
        "nmf_corrupted": {"audio": "part0/nmf_corrupted.wav", "image": "part0/spec_nmf_corrupted.png"},
        "nmf_original": {"audio": "part0/nmf_original.wav", "image": "part0/spec_nmf_original.png"},
    },
    "part1": {
        "damaged": {"audio": "part1/damaged_random.wav", "image": "part1/spec_damaged_random.png"},
        "linear": {"audio": "part1/fixed_linear_random.wav", "image": "part1/spec_linear_random.png"},
        "ar": {"audio": "part1/fixed_ar_random.wav", "image": "part1/spec_ar_random.png"},
        "nmf": {"audio": "part1/fixed_nmf_random.wav", "image": "part1/spec_nmf_random.png"},
        "unet": {"audio": "part1/dl_long_restored.wav", "image": "part1/dl_long_restored_spec.png"},
        "original": {"audio": "part1/original.wav", "image": "part1/spec_original.png"},
    },
    "part2": {
        "damaged": {"audio": "part2/damaged_gap.wav", "image": "part2/spec_damaged_gap.png"},
        "linear": {"audio": "part2/fixed_linear_gap.wav", "image": "part2/spec_linear_gap.png"},
        "ar": {"audio": "part2/fixed_ar_gap.wav", "image": "part2/spec_ar_gap.png"},
        "nmf": {"audio": "part2/fixed_nmf_gap.wav", "image": "part2/spec_nmf_gap.png"},
        "gan": {"audio": "part2/fixed_gan_gap.wav", "image": "part2/spec_gan_gap.png"},
        "diffusion": {"audio": "part2/fixed_riffusion_gap.wav", "image": "part2/spec_riffusion_gap.png"},
        "original": {"audio": "part2/original.wav", "image": "part2/spec_original.png"},
    },
}


# Diagnostic figures (the reference's per-method visualize() outputs), also
# written by the pipelines where matplotlib is installed; checked beside
# the audio/spectrogram pairs. main3_AR_text.py:138 /
# main5_UNet_mask.py:220-222 counterparts.
VIZ_ARTIFACTS: list[str] = [
    "part0/gp_waveform_viz.png",
    # the reference ships this under demo_assets/part0: the main1_gp.py
    # synthetic-fallback run (200+450 Hz sines, main1_gp.py:53-59)
    # visualized; run_part0 emits it beside the real-clip GP assets
    "part0/synthetic_gp_restoration.png",
    "part0/ar_waveform_viz.png",
    "part0/ar_texture_waveform_viz.png",
    "part0/nmf_waveform_viz.png",
    "part1/spectrogram_comparison.png",
    "part1/spectrogram_comparison.pdf",
]

# Radio labels used by the demo UI, matching the reference (demo.py:6-63)
DEMO_LABELS = {
    # part0 is a framework addition: the reference demo shows only
    # part1/part2, but the part-0 pipelines publish full artifacts too.
    "part0": [
        ("gp_corrupted", "🤕 Damaged (Missing Segments)"),
        ("gp", "🌊 Gaussian Process (GP)"),
        ("ar", "📈 Autoregressive (AR)"),
        ("ar_texture", "🎛️ AR + Texture Noise"),
        ("nmf", "🧩 Spectral Factorization (NMF)"),
        ("gp_original", "✅ Ground Truth"),
    ],
    "part1": [
        ("damaged", "🤕 Damaged (Random Mask)"),
        ("linear", "📏 Linear Interpolation"),
        ("ar", "📈 Autoregressive (AR)"),
        ("nmf", "🧩 Spectral Factorization (NMF)"),
        ("unet", "🧠 Deep Learning (U-Net)"),
        ("original", "✅ Ground Truth"),
    ],
    "part2": [
        ("damaged", "🕳️ Damaged (2s Gap)"),
        ("linear", "📏 Linear Interpolation"),
        ("ar", "📈 Autoregressive (AR)"),
        ("nmf", "🧩 Spectral Factorization (NMF)"),
        ("gan", "🎨 Generative Adversarial Network (GAN)"),
        ("diffusion", "☢️ Diffusion Model (Riffusion)"),
        ("original", "✅ Ground Truth"),
    ],
}


def asset_path(assets_dir: str, part: str, method: str, kind: str = "audio") -> str:
    return os.path.join(assets_dir, ASSET_REGISTRY[part][method][kind])


def write_artifacts(audio, sr: int, assets_dir: str, part: str, method: str,
                    clip: float = 1.0) -> tuple[str, str]:
    """Write the (wav, spectrogram png) pair for one registry entry."""
    audio = np.asarray(audio, dtype=np.float32)
    wav = save_wav_int16(audio, sr, asset_path(assets_dir, part, method, "audio"), clip)
    png = save_spectrogram_png(audio, sr, asset_path(assets_dir, part, method, "image"))
    return wav, png
