"""L1 time-frequency transforms on torch.stft / torch.istft.

The reference uses two STFT conventions:

- scipy convention: ``scipy.signal.stft(x, fs, nperseg, noverlap)`` —
  periodic Hann, zero boundary extension of nperseg//2, end-padding to a
  whole frame count, spectrum scaling 1/win.sum()
  (reference main4_NMF.py:69, main4_NMF_gap.py:45-47).
- torch convention: ``torch.stft(x, n_fft, hop, window=hann, center=True)``
  — reflect center padding, no scaling
  (reference main5_UNet_mask.py:77-82, main_gan_gap.py:86).

Both go through ``torch.stft`` (cuFFT on the GPU). The scipy convention
pads explicitly and runs uncentred; its inverse is an explicit windowed
overlap-add, since ``torch.istft`` refuses an uncentred Hann whose
envelope is zero at the first sample. Spectra are (n_bins, n_frames), the
JAX package's orientation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window (scipy get_window('hann') / torch.hann_window),
    computed in float64 and rounded once, as the JAX package does."""
    k = np.arange(n)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * k / n),
                           dtype=dtype, device=device)


@dataclass(frozen=True)
class StftConfig:
    n_fft: int
    hop: int
    # 'zeros'  -> scipy-style: pad n_fft//2 zeros both ends, then pad the end
    #             so the signal tiles into whole frames
    # 'reflect'-> torch-style center padding (n_fft//2 reflect both ends)
    pad_mode: str = "reflect"
    # Forward scale applied to the complex STFT. scipy uses 1/sum(win),
    # torch uses 1.0.
    scale: float = 1.0

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


def scipy_stft_config(nperseg: int, noverlap: int) -> StftConfig:
    """Config equivalent to scipy.signal.stft(x, fs, nperseg, noverlap)."""
    win_sum = float(np.sum(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)))
    return StftConfig(n_fft=nperseg, hop=nperseg - noverlap, pad_mode="zeros",
                      scale=1.0 / win_sum)


def torch_stft_config(n_fft: int, hop: int) -> StftConfig:
    """Config equivalent to torch.stft(x, n_fft, hop, window=hann, center=True)."""
    return StftConfig(n_fft=n_fft, hop=hop, pad_mode="reflect", scale=1.0)


def _pad_zeros(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """scipy's padding: n_fft//2 zeros at both ends, then zeros at the end
    so that (len - n_fft) % hop == 0 (scipy's padded=True)."""
    half = cfg.n_fft // 2
    x = F.pad(x, (half, half))
    rem = (x.shape[0] - cfg.n_fft) % cfg.hop
    if rem:
        x = F.pad(x, (0, cfg.hop - rem))
    return x


def _pad_reflect_repeated(x: torch.Tensor, half: int) -> torch.Tensor:
    """``half`` samples of reflection at both ends, reflecting again where
    the pad is longer than the signal (numpy's and jnp.pad's "reflect";
    torch's reflect pad refuses a pad that is not shorter than the
    signal)."""
    n = x.shape[0]
    idx = torch.arange(-half, n + half, device=x.device)
    if n == 1:
        return x[torch.zeros_like(idx)]
    r = idx.remainder(2 * (n - 1))
    return x[torch.where(r < n, r, 2 * (n - 1) - r)]


def _check_pad_mode(cfg: StftConfig) -> None:
    if cfg.pad_mode not in ("reflect", "zeros"):
        raise ValueError(f"unknown pad_mode {cfg.pad_mode!r}")


def stft(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """STFT -> complex64 (n_bins, n_frames), on x's device."""
    _check_pad_mode(cfg)
    x = x.to(torch.float32)
    win = hann_window(cfg.n_fft, x.device)
    if cfg.pad_mode == "reflect" and x.shape[0] <= cfg.n_fft // 2:
        # a signal no longer than the centre pad (Griffin-Lim on a few frames)
        z = torch.stft(_pad_reflect_repeated(x, cfg.n_fft // 2), cfg.n_fft,
                       cfg.hop, window=win, center=False, return_complex=True)
    elif cfg.pad_mode == "reflect":
        z = torch.stft(x, cfg.n_fft, cfg.hop, window=win, center=True,
                       pad_mode="reflect", return_complex=True)
    else:
        z = torch.stft(_pad_zeros(x, cfg), cfg.n_fft, cfg.hop, window=win,
                       center=False, return_complex=True)
    return z * cfg.scale


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Strided framing -> (n_frames, frame_len), a view of x: frame i is
    x[i * hop : i * hop + frame_len]. ValueError where x is shorter than
    one frame."""
    if x.shape[0] < frame_len:
        raise ValueError(
            f"signal of {x.shape[0]} samples is shorter than one "
            f"{frame_len}-sample frame; pad it (see StftConfig.pad_mode)")
    return x.unfold(0, frame_len, hop)


def power_spectrogram(x: torch.Tensor, n_fft: int, hop: int,
                      power: float = 2.0) -> torch.Tensor:
    """torchaudio.transforms.Spectrogram's |STFT|^power (centre reflect
    pad, periodic Hann, no scaling), (n_bins, n_frames) on x's device: the
    diffusion codec's spectrogram (reference main_diffusion_gap.py:22-27)."""
    return stft(x, torch_stft_config(n_fft, hop)).abs() ** power


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add of (n_frames, frame_len) frames at stride ``hop``."""
    n_frames, frame_len = frames.shape
    total = (n_frames - 1) * hop + frame_len
    return F.fold(frames.T[None], output_size=(1, total),
                  kernel_size=(1, frame_len), stride=(1, hop)).reshape(total)


def istft(z: torch.Tensor, cfg: StftConfig, length: int) -> torch.Tensor:
    """iSTFT of (n_bins, n_frames) back to a length-``length`` signal.

    Matches scipy.signal.istft (pad_mode='zeros') / torch.istft
    (pad_mode='reflect'): windowed overlap-add normalized by the OLA of the
    squared window, then boundary trim + cut to ``length``.
    """
    _check_pad_mode(cfg)
    z = z / cfg.scale
    win = hann_window(cfg.n_fft, z.device)
    if cfg.pad_mode == "reflect":
        return torch.istft(z, cfg.n_fft, cfg.hop, window=win, center=True,
                           length=length)
    frames = torch.fft.irfft(z.T, n=cfg.n_fft, dim=-1)
    num = overlap_add(frames * win[None, :], cfg.hop)
    den = overlap_add((win * win).expand_as(frames), cfg.hop)
    sig = num / torch.where(den > 1e-11, den, torch.ones_like(den))
    sig = sig[cfg.n_fft // 2:]
    if sig.shape[0] >= length:
        return sig[:length]
    return F.pad(sig, (0, length - sig.shape[0]))


def magphase(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split complex STFT into (magnitude, phase)."""
    return z.abs(), z.angle()


def polar(mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Recombine magnitude and phase -> complex."""
    return torch.polar(mag, phase)
