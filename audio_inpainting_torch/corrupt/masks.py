"""L2 corruption: seeded mask generators matching the reference distributions.

Every random generator takes an explicit ``torch.Generator`` and draws on
its device. Its stream is not ``jax.random``'s, so a mask matches the JAX
package's by contract (gap count, length range, start range), not sample
by sample.

Mask convention throughout: True/1 = sample kept, False/0 = lost.
"""

from __future__ import annotations

import numpy as np
import torch


def _stamp_intervals(starts: torch.Tensor, ends: torch.Tensor, n: int) -> torch.Tensor:
    """Rasterize the union of [start, end) intervals into a bool[n] via a
    +1/-1 scatter and a cumsum."""
    delta = torch.zeros(n + 1, dtype=torch.int32, device=starts.device)
    ones = torch.ones_like(starts, dtype=torch.int32)
    delta.index_add_(0, starts, ones).index_add_(0, ends, -ones)
    return torch.cumsum(delta[:-1], 0) > 0


def random_dropout_mask(generator: torch.Generator, n_samples: int,
                        mask_ratio: float = 0.25, min_gap_len: int = 50,
                        max_gap_len: int = 400) -> torch.Tensor:
    """Random short time-domain dropouts (Part 1 corruption), on the
    generator's device.

    Distribution matches reference generate_part1_data.py:26-35:
    num_gaps = n*ratio/max_len*2 gaps, each of uniform length in
    [min_gap_len, max_gap_len) at a uniform start in [0, n - length).
    """
    num_gaps = int(n_samples * mask_ratio / max_gap_len * 2)
    dev = generator.device
    lens = torch.randint(min_gap_len, max_gap_len, (num_gaps,),
                         generator=generator, device=dev)
    u = torch.rand(num_gaps, generator=generator, device=dev,
                   dtype=torch.float64)
    starts = (u * (n_samples - lens)).long()
    return ~_stamp_intervals(starts, starts + lens, n_samples)


def contiguous_gap_mask(n_samples: int, gap_ratio: float = 0.2,
                        start_frac: float = 0.4) -> tuple[np.ndarray, tuple[int, int]]:
    """Deterministic contiguous gap at 40% of the segment (Part 0).

    Matches reference main1_gp.py:61-71 / main2_AR.py:51-58. Returns
    (bool mask, (gap_start, gap_end)).
    """
    gap_len = int(n_samples * gap_ratio)
    start = int(n_samples * start_frac)
    mask = np.ones(n_samples, dtype=bool)
    mask[start : start + gap_len] = False
    return mask, (start, start + gap_len)


def center_gap_bounds(n_samples: int, sr: int, half_seconds: float = 1.0) -> tuple[int, int]:
    """The Part-2 centered 2-second hole (reference generate_part2_data.py:36-41)."""
    center = n_samples // 2
    half = int(half_seconds * sr)
    return center - half, center + half


def random_frame_mask(generator: torch.Generator, n_freq: int, n_frames: int,
                      mask_ratio: float = 0.3, min_time_mask: int = 5,
                      max_time_mask: int = 30,
                      min_segments: int = 0) -> torch.Tensor:
    """SpecAugment-style random STFT-frame dropout (Part 1 corruption), on
    the generator's device.

    Matches reference main5_UNet_mask.py:111-127: full-band stripes,
    num_segments = max(min_segments, n_frames*ratio/max*2), widths uniform
    in [min, max), starts uniform in [0, n_frames - width). Returns a
    float32 (n_freq, n_frames) mask, 1 = keep.
    """
    num_segments = max(min_segments,
                       int(n_frames * mask_ratio / max_time_mask * 2))
    dev = generator.device
    lens = torch.randint(min_time_mask, max_time_mask, (num_segments,),
                         generator=generator, device=dev)
    u = torch.rand(num_segments, generator=generator, device=dev,
                   dtype=torch.float64)
    # a stripe wider than the clip starts at 0 and is cut at its end
    starts = (u * (n_frames - lens)).long().clamp_min(0)
    ends = (starts + lens).clamp_max(n_frames)
    keep = ~_stamp_intervals(starts, ends, n_frames)
    return keep.to(torch.float32)[None, :].repeat(n_freq, 1)


def training_stripes(generator: torch.Generator, n_frames: int,
                     intact) -> np.ndarray:
    """Synthetic stripe keep-row (float32 (n_frames,), 1 = keep) for
    self-supervised U-Net training on a blindly damaged clip.

    Training against the detected damage would teach the net that holes
    hold silence (the loss targets there are the damaged columns), so
    stripes are hidden over the clip's intact columns instead and the real
    damage stays out of the loss (reference main5_UNet_mask.py:111-127:
    learn to fill columns from their context).

    Stripe widths clamp for short clips, with at least one stripe (the
    reference's count formula truncates to 0 under ~50 frames); under 4
    frames the middle column alone is hidden. Up to 8 draws are made until
    a stripe covers an intact column (a trainable cell: intact and hidden).
    """
    if n_frames < 4:
        m = np.ones(n_frames, np.float32)
        m[n_frames // 2] = 0.0
        return m
    mt = min(30, max(2, n_frames // 2))      # stripe width in [mn, mt)
    mn = max(1, min(5, mt - 1))
    intact = np.asarray(intact, bool)
    for _ in range(8):
        m = random_frame_mask(generator, 1, n_frames, min_time_mask=mn,
                              max_time_mask=mt, min_segments=1)[0].cpu().numpy()
        if ((m == 0) & intact).any() or not intact.any():
            break
    return m


def frame_gap_mask_2d(n_freq: int, n_frames: int, start_frac: float = 0.4,
                      end_frac: float = 0.6, device=None) -> torch.Tensor:
    """Deterministic 2D STFT gap over frames [40%, 60%) (reference
    main5_UNet_gap.py:98-102). Returns a float32 (n_freq, n_frames) tensor,
    1 = keep, on ``device`` (the CPU when None)."""
    gap_start = int(n_frames * start_frac)
    gap_end = int(n_frames * end_frac)
    col = torch.arange(n_frames, device=device)
    keep = ~((col >= gap_start) & (col < gap_end))
    return keep.to(torch.float32)[None, :].repeat(n_freq, 1)
