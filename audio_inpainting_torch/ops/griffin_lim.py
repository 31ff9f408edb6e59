"""Griffin-Lim phase reconstruction on torch.stft / torch.istft.

The port of audio_inpainting_tpu/ops/griffin_lim.py: the behaviour of
``torchaudio.transforms.GriffinLim(n_fft=2048, hop_length=512, power=1.0)``
that the diffusion pipeline uses (reference main_diffusion_gap.py:73-74):
32 iterations, momentum 0.99, a random initial phase. Each iteration is one
iSTFT and one STFT (cuFFT on the GPU); the JAX package's fused row-space
round trip is a TPU layout of the same arithmetic and is not carried over.

The initial phase comes from ``_draw_phase``, a seeded CPU generator, so
every device starts from the same numbers; the tests replace it with the
JAX package's draw.
"""

from __future__ import annotations

import math

import torch

from ..device import as_f32
from .stft import istft, polar, stft, torch_stft_config


def _draw_phase(seed: int, shape: tuple[int, int]) -> torch.Tensor:
    """The initial phase, uniform in [-pi, pi), as a CPU tensor of
    ``shape``: a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=gen) * (2.0 * math.pi) - math.pi


def griffin_lim(mag, n_fft: int = 2048, hop: int = 512, n_iter: int = 32,
                momentum: float = 0.99, length: int | None = None,
                power: float = 1.0, seed: int = 0, device=None) -> torch.Tensor:
    """Reconstruct a waveform from a (n_bins, n_frames) magnitude
    spectrogram. ``power``: exponent of the input spectrogram; 1.0 means
    ``mag`` is already linear magnitude (the diffusion codec's convention).
    Runs where ``as_f32`` puts ``mag``; returns a (length,) float32 tensor
    there (length defaults to hop * (n_frames - 1))."""
    mag = as_f32(mag, device)
    if power != 1.0:
        mag = mag ** (1.0 / power)
    n_frames = mag.shape[1]
    if length is None:
        length = hop * (n_frames - 1)
    cfg = torch_stft_config(n_fft, hop)
    z = polar(mag, _draw_phase(seed, tuple(mag.shape)).to(mag.device))
    prev = torch.zeros_like(z)
    m = momentum / (1.0 + momentum)
    for _ in range(n_iter):
        # rebuild with the current phase estimate, cropped to mag's frames
        rebuilt = stft(istft(z, cfg, length), cfg)[:, :n_frames]
        accel = rebuilt - m * prev
        prev = rebuilt
        z = mag * (accel / accel.abs().clamp_min(1e-16))
    return istft(z, cfg, length)
