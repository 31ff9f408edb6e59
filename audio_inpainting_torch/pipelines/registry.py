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


def asset_path(assets_dir: str, part: str, method: str, kind: str = "audio") -> str:
    return os.path.join(assets_dir, ASSET_REGISTRY[part][method][kind])


def write_artifacts(audio, sr: int, assets_dir: str, part: str, method: str,
                    clip: float = 1.0) -> tuple[str, str]:
    """Write the (wav, spectrogram png) pair for one registry entry."""
    audio = np.asarray(audio, dtype=np.float32)
    wav = save_wav_int16(audio, sr, asset_path(assets_dir, part, method, "audio"), clip)
    png = save_spectrogram_png(audio, sr, asset_path(assets_dir, part, method, "image"))
    return wav, png
