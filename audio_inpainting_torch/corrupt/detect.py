"""L2 blind damage detection: threshold scans over the damaged signal.

The reference detects masks *from the signal* when chaining methods through
WAV files: amplitude threshold 1e-4 for hard zeros
(main3_AR_text_gap.py:34-49, linear_interp_part1.py:52-57) or 0.01 for
iSTFT-produced near-silence (main3_AR_text_mask.py:30-52), run-length
extraction via np.diff, and per-STFT-column silent-fraction tests
(main4_NMF_gap.py:28-40, main4_NMF_mask.py:28-45).

The gap lists are host numpy (they shape the batch that follows); the
per-sample and per-column scans are torch on the signal's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_f32


def silence_mask(signal, threshold: float = 1e-4, device=None) -> torch.Tensor:
    """True where |signal| < threshold (candidate damaged samples)."""
    return as_f32(signal, device).abs() < threshold


def find_main_gap(signal: np.ndarray, threshold: float = 1e-4) -> tuple[int, int] | None:
    """Single-gap detector: first and last sub-threshold sample.

    Matches reference main3_AR_text_gap.py:34-49 (returns None if no gap).
    """
    is_gap = np.abs(np.asarray(signal)) < threshold
    idx = np.flatnonzero(is_gap)
    if idx.size == 0:
        return None
    return int(idx[0]), int(idx[-1]) + 1


def find_gaps(signal: np.ndarray, threshold: float = 0.01,
              min_len: int = 100) -> list[tuple[int, int]]:
    """Multi-gap detector: run-length extraction of sub-threshold runs,
    keeping runs longer than ``min_len`` samples.

    Matches reference main3_AR_text_mask.py:30-52 (diff-based starts/ends
    with boundary handling, >100-sample filter).
    """
    is_gap = (np.abs(np.asarray(signal)) < threshold).astype(np.int8)
    if is_gap.size == 0:
        return []
    diff = np.diff(is_gap)
    starts = np.flatnonzero(diff == 1) + 1
    ends = np.flatnonzero(diff == -1) + 1
    if is_gap[0]:
        starts = np.insert(starts, 0, 0)
    if is_gap[-1]:
        ends = np.append(ends, len(is_gap))
    return [(int(s), int(e)) for s, e in zip(starts, ends) if (e - s) > min_len]


def _silent_fraction_per_column(is_gap: torch.Tensor, n_frames: int,
                                hop: int) -> torch.Tensor:
    n = is_gap.shape[0]
    centers = torch.arange(n_frames, device=is_gap.device) * hop
    # clamped to n as JAX's gather clamps: a column past the end is 0 silent
    w0 = (centers - hop // 2).clamp(0, n)
    w1 = (centers + hop // 2).clamp_max(n)
    # windowed means via prefix sums: O(n) instead of per-column slicing
    csum = torch.cat([is_gap.new_zeros(1, dtype=torch.float32),
                      torch.cumsum(is_gap.to(torch.float32), 0)])
    counts = csum[w1] - csum[w0]
    widths = (w1 - w0).clamp_min(1).to(torch.float32)
    return counts / widths


def silent_frame_columns(signal, n_frames: int, hop: int,
                         threshold: float = 1e-4,
                         silent_fraction: float = 0.9,
                         device=None) -> np.ndarray:
    """Indices of STFT columns whose hop-window around the frame center is
    more than ``silent_fraction`` sub-threshold samples.

    Matches reference main4_NMF_gap.py:28-40 (threshold 1e-4, fraction 0.9)
    and main4_NMF_mask.py:28-45 (threshold 0.01, fraction 0.8).
    """
    frac = _silent_fraction_per_column(silence_mask(signal, threshold, device),
                                       n_frames, hop)
    return np.flatnonzero(frac.cpu().numpy() > silent_fraction)


def mask_to_bad_columns(sample_mask, n_frames: int, hop: int,
                        device=None) -> np.ndarray:
    """Explicit-gap column mapping: scan a per-sample validity mask
    (1/True = valid) as a 0/1 pseudo-signal through the SAME hop-window
    silent-fraction criterion the blind path uses — a column is bad when
    >= 80% of its window covers damaged samples. Returns bool (n_frames,),
    True = bad."""
    bad = np.zeros(n_frames, bool)
    bad[silent_frame_columns(np.asarray(sample_mask, np.float32), n_frames,
                             hop, threshold=0.5, silent_fraction=0.8,
                             device=device)] = True
    return bad
