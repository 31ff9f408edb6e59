"""STFT and iSTFT of the reference nets' convention: ``torch.stft`` with a
periodic Hann window (computed in float64, rounded once), centre-padded
by reflection, unscaled (reference main5_UNet_mask.py:77-82,
main_gan_gap.py:86). Spectra are (n_bins, n_frames)."""

from __future__ import annotations

import numpy as np
import torch


def hann(n_fft: int, device=None) -> torch.Tensor:
    k = np.arange(n_fft)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft),
                           dtype=torch.float32, device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """complex64 (n_fft // 2 + 1, frames) of the float32 signal ``x``."""
    return torch.stft(x.to(torch.float32), n_fft, hop, window=hann(n_fft, x.device),
                      center=True, pad_mode="reflect", return_complex=True)


def istft(z: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """The inverse of ``stft``, ``length`` samples."""
    return torch.istft(z, n_fft, hop, window=hann(n_fft, z.device), center=True,
                       length=length)
