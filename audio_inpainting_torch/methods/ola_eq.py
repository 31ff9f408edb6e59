"""Overlap-add gain equalization for STFT-frame-dropout corruption.

The port of audio_inpainting_tpu/methods/ola_eq.py (a beyond-reference
stage: the reference's Part 1 AR simply fills blind-detected silent runs,
main3_AR_text_mask.py).

When corruption zeroes whole STFT columns and the damaged audio is made by
the inverse STFT (the Part 1 scenario, main5_UNet_mask.py:111-156), each
damaged sample is exactly the clean sample scaled by a computable gain:

    damaged(t) = x(t) * a(t),   a(t) = sum_{k kept} w^2(t-kh) / sum_k w^2(t-kh)

because the centred iSTFT overlap-adds synthesis-windowed frames and
normalizes by the full squared-window OLA. Dividing by a(t) where it is
bounded away from zero recovers the clean signal (up to int16
quantization); only the deep interior of each dropped run (a ~ 0) needs a
generative fill (AR).

Blind detection of the dropped columns is exact for runs of >= n_fft/hop
consecutive dropped frames: a sample is deeply silent iff every frame
covering it was dropped, so a dropped run k0..k1 predicts deep silence on
exactly [c_{k0-1}+win/2, c_{k1+1}-win/2) with c_k = k*hop. Inverting that
predicate per observed silent run gives the largest frame run consistent
with the observation.

Detection and the residual-gap scan are host numpy (they shape the AR
batch that follows); the gain ``ola_gain`` is a tensor function on the
device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..corrupt.detect import find_gaps
from ..device import resolve_device
from ..ops.stft import hann_window, overlap_add


def detect_dropped_frames(damaged: np.ndarray, n_frames: int, hop: int = 256,
                          win: int = 1024, threshold: float = 1e-3,
                          min_run: int = 50) -> np.ndarray:
    """Blind-detect dropped STFT columns from deep-silent runs.

    Returns a bool (n_frames,) array, True = dropped. Exact (given the
    frame-dropout model) for runs of >= win/hop consecutive dropped frames.
    """
    half = win // 2
    dropped = np.zeros(n_frames, bool)
    for s, e in find_gaps(damaged, threshold=threshold, min_len=min_run):
        # largest frame run whose predicted silence [c_{k0-1}+half,
        # c_{k1+1}-half) fits inside the observed silent run [s, e)
        k0 = int(np.ceil((s - half + hop) / hop))
        k1 = int(np.floor((e + half - hop) / hop))
        k0 = max(k0, 0)
        k1 = min(k1, n_frames - 1)
        if k1 >= k0:
            dropped[k0:k1 + 1] = True
    return dropped


def ola_gain(dropped: torch.Tensor, n: int, hop: int = 256,
             win: int = 1024) -> torch.Tensor:
    """Per-sample OLA attenuation a(t) implied by the dropped-column set,
    on ``dropped``'s device.

    Matches the centred iSTFT synthesis: frame k contributes w^2 over
    samples [k*hop - win/2, k*hop + win/2), what falls outside [0, n) is
    dropped; a = kept weight / full weight.
    """
    T = dropped.shape[0]
    half = win // 2
    w2 = hann_window(win, dropped.device) ** 2
    kept = 1.0 - dropped.to(torch.float32)

    def ola(frames):
        # the overlap-add covers samples [-half, (T-1)*hop + half)
        out = overlap_add(frames, hop)[half:half + n]
        return F.pad(out, (0, n - out.shape[0]))

    num = ola(w2[None, :] * kept[:, None])
    den = ola(w2.expand(T, win))
    return num / torch.clamp_min(den, 1e-12)


def equalize_dropped_frames(damaged: np.ndarray, n_frames: int,
                            hop: int = 256, win: int = 1024,
                            threshold: float = 1e-3, floor: float = 0.05,
                            min_gap: int = 8, device=None):
    """Equalize OLA attenuation; return (equalized, residual_gaps, a) as
    host numpy. The gain runs on ``device`` (cuda by default).

    ``residual_gaps`` are the sample runs with a(t) <= floor (deep interior
    of dropped runs) that still need generative fill.
    """
    damaged = np.asarray(damaged, np.float32)
    n = len(damaged)
    dropped = detect_dropped_frames(damaged, n_frames, hop, win, threshold)
    dev = resolve_device(device)
    a = ola_gain(torch.as_tensor(dropped, device=dev), n, hop, win).cpu().numpy()
    eq = np.where(a > floor, damaged / np.maximum(a, floor), damaged)
    eq = np.clip(eq, -1.0, 1.0)

    bad = (a <= floor).astype(np.int8)
    d = np.diff(np.concatenate([[0], bad, [0]]))
    gaps = [(int(s), int(e)) for s, e in
            zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1))
            if e - s >= min_gap]
    return eq, gaps, a
