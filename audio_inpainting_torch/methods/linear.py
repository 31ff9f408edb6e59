"""Linear-interpolation restoration (the reference's baseline method).

Two variants, matching the reference exactly:

- ``linear_interp_masked``: fill every masked sample by interpolating between
  the nearest valid neighbors — np.interp semantics including end clamping
  (reference generate_part1_data.py:51-58, linear_interp_part1.py:65-75).
  ``linear_interp_masked_host`` is its host-numpy twin, literally np.interp,
  which the facade uses: a zero-FLOP O(n) fill gains nothing on the GPU.
- ``linear_fill_gap``: single gap filled with a straight line between the
  samples just outside the gap — np.linspace endpoint semantics
  (reference generate_part2_data.py:48-54).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_f32


def linear_interp_masked(signal, mask, device=None) -> torch.Tensor:
    """Fill ``~mask`` samples by linear interpolation between valid neighbors.

    mask: True = valid sample. Matches np.interp(x_all[~mask], x_all[mask],
    signal[mask]) incl. clamping to the first/last valid value at the edges.
    The nearest valid neighbor on each side comes from a cummax / cummin
    sweep, with no data-dependent loop.
    """
    signal = as_f32(signal, device)
    mask = torch.as_tensor(mask, device=signal.device).to(torch.bool)
    n = signal.shape[0]
    idx = torch.arange(n, device=signal.device)

    # index of the most recent valid sample at-or-before i (-1 if none)
    prev_idx = torch.cummax(torch.where(mask, idx, -1), 0).values
    # index of the next valid sample at-or-after i (n if none)
    next_idx = torch.cummin(torch.where(mask, idx, n).flip(0), 0).values.flip(0)

    has_prev = prev_idx >= 0
    has_next = next_idx <= n - 1
    p = prev_idx.clamp(0, n - 1)
    q = next_idx.clamp(0, n - 1)
    y0 = signal[p]
    y1 = signal[q]
    denom = (q - p).clamp_min(1).to(torch.float32)
    t = (idx - p).to(torch.float32) / denom
    interp = y0 * (1.0 - t) + y1 * t
    # np.interp clamps outside the valid range
    interp = torch.where(has_prev & ~has_next, y0, interp)
    interp = torch.where(~has_prev & has_next, y1, interp)
    return torch.where(mask, signal, interp)


def linear_interp_masked_host(signal, mask) -> np.ndarray:
    """Host-numpy twin of ``linear_interp_masked`` — literally np.interp."""
    signal = np.asarray(signal, np.float32)
    mask = np.asarray(mask, bool)
    if mask.all():
        return signal.copy()
    out = signal.copy()
    if not mask.any():
        return out
    idx = np.arange(len(signal))
    out[~mask] = np.interp(idx[~mask], idx[mask],
                           signal[mask]).astype(np.float32)
    return out


def linear_fill_gap(signal, gap_start: int, gap_end: int,
                    device=None) -> torch.Tensor:
    """Fill [gap_start, gap_end) with np.linspace(signal[gap_start-1],
    signal[gap_end], gap_len) — reference generate_part2_data.py:48-54."""
    signal = as_f32(signal, device)
    y0 = signal[gap_start - 1]
    y1 = signal[min(gap_end, signal.shape[0] - 1)]
    num = gap_end - gap_start
    # start * (1 - s) + stop * s with s = i / (num - 1), the endpoint exact
    s = torch.arange(num, device=signal.device, dtype=torch.float32)
    s = s / max(num - 1, 1)
    fill = y0 * (1.0 - s) + y1 * s
    out = signal.clone()
    out[gap_start:gap_end] = fill
    return out
