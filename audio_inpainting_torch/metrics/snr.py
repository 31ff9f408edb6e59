"""L4 quality metrics: SNR, gap-local SNR and LSD, as in the JAX package.

SNR formulas replicate the inline computations of the reference scripts
(main1_gp.py:98-109, main2_AR.py:106-116): global SNR over the full
segment and "local" SNR over the gap only, both with a 1e-10 denominator
guard. Each function returns a 0-d tensor on the inputs' device.
"""

from __future__ import annotations

import torch

from ..device import as_f32
from ..ops.stft import stft, torch_stft_config


def snr_db(reference, estimate, device=None) -> torch.Tensor:
    """Global SNR: 10*log10(sum(ref^2) / (sum((ref-est)^2) + 1e-10))."""
    reference = as_f32(reference, device)
    estimate = as_f32(estimate, reference.device)
    num = torch.sum(reference ** 2)
    den = torch.sum((reference - estimate) ** 2)
    return 10.0 * torch.log10(num / (den + 1e-10))


def local_snr_db(reference, estimate, gap_start: int, gap_end: int,
                 device=None) -> torch.Tensor:
    """SNR restricted to the gap region (reference's 'Local SNR')."""
    return snr_db(reference[gap_start:gap_end], estimate[gap_start:gap_end],
                  device)


def lsd_db(reference, estimate, n_fft: int = 1024, hop: int = 256,
           device=None) -> torch.Tensor:
    """Log-spectral distance in dB: mean over frames of the RMS over bins of
    the difference of 10*log10 power spectra."""
    cfg = torch_stft_config(n_fft, hop)
    reference = as_f32(reference, device)
    estimate = as_f32(estimate, reference.device)
    ref_p = stft(reference, cfg).abs() ** 2
    est_p = stft(estimate, cfg).abs() ** 2
    log_ref = 10.0 * torch.log10(ref_p.clamp_min(1e-10))
    log_est = 10.0 * torch.log10(est_p.clamp_min(1e-10))
    return torch.mean(torch.sqrt(torch.mean((log_ref - log_est) ** 2, dim=0)))
