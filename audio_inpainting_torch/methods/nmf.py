"""Masked NMF spectrogram inpainting, in torch.

Reference behavior (as in audio_inpainting_tpu/methods/nmf.py):

- one-shot (Part 1/2): seed damaged STFT columns with the mean spectrum of
  the good columns, fit NMF(n_components=40, init='random', max_iter=200)
  once, overwrite damaged columns with W@H
  (main4_NMF_gap.py:56-68, main4_NMF_mask.py:62-73).
- iterative (Part 0): seed gap columns with the mean spectrum of the
  *pre-gap* region, then 50 outer iterations of {refit NMF from the same
  random init, overwrite gap columns} (main4_NMF.py:79-90).

The fit is Lee-Seung multiplicative updates on the Frobenius loss, in
float32 (TF32 is off package-wide). The three-operand products contract
in the cheap order, (W^T W) H and W (H H^T), so no (f, t) product is
formed inside the loop. The init is sklearn's 'random' scheme,
|N(0,1)| * sqrt(mean(V)/k): ``_draw_wh`` makes the raw |N(0,1)| draws and
the callers scale them by the current matrix's mean. Tests replace
``_draw_wh`` with the JAX package's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_EPS = 1e-10


@dataclass(frozen=True)
class NMFConfig:
    n_components: int = 40
    n_iter: int = 200       # inner multiplicative-update iterations per fit
    outer_iters: int = 1    # refit-and-overwrite cycles (Part 0 uses 50)


def _draw_wh(seed: int, f: int, t: int, k: int,
             device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw |N(0,1)| init draws, W (f, k) then H (k, t), from a CPU
    generator seeded with ``seed``: the same numbers on every device."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((f, k), generator=gen).abs()
    h = torch.randn((k, t), generator=gen).abs()
    return w.to(device), h.to(device)


def _scale(v: torch.Tensor, k: int) -> torch.Tensor:
    """sklearn's init scale for V: sqrt(max(mean(V), eps) / k)."""
    return torch.sqrt(torch.clamp_min(v.mean(), _EPS) / k)


def _init_wh(seed: int, v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    w, h = _draw_wh(seed, v.shape[0], v.shape[1], k, v.device)
    scale = _scale(v, k)
    return w * scale, h * scale


def _mu_fit(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
            n_iter: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_iter`` Frobenius multiplicative updates of (W, H) on V."""
    for _ in range(n_iter):
        h = h * (w.T @ v) / ((w.T @ w) @ h + _EPS)
        w = w * (v @ h.T) / (w @ (h @ h.T) + _EPS)
    return w, h


def nmf_reconstruct(v: torch.Tensor, cfg: NMFConfig, seed: int = 0) -> torch.Tensor:
    """Fit NMF to a nonnegative matrix and return the low-rank model W@H."""
    w, h = _mu_fit(v, *_init_wh(seed, v, cfg.n_components), cfg.n_iter)
    return w @ h


def nmf_inpaint_columns(mag: torch.Tensor, bad_cols: torch.Tensor,
                        cfg: NMFConfig, seed: int = 0) -> torch.Tensor:
    """One-shot masked inpainting of STFT-magnitude columns.

    mag: (n_bins, n_frames) nonnegative; bad_cols: bool (n_frames,) on the
    same device. Seeds bad columns with the mean good-column spectrum, fits
    once, overwrites bad columns only: good columns come back unchanged.
    """
    bad = bad_cols[None, :]
    good_f = (~bad_cols).to(mag.dtype)[None, :]
    avg_spec = (mag * good_f).sum(1, keepdim=True) / good_f.sum().clamp_min(1.0)
    seeded = torch.where(bad, avg_spec, mag)
    return torch.where(bad, nmf_reconstruct(seeded, cfg, seed), mag)


def nmf_inpaint_iterative(mag: torch.Tensor, col_start: int, col_end: int,
                          cfg: NMFConfig, seed: int = 0) -> torch.Tensor:
    """Part-0 iterative scheme: seed gap columns with the mean *pre-gap*
    spectrum, then ``outer_iters`` x {fit from the same init, overwrite gap
    columns} (reference main4_NMF.py:79-90, which reuses one sklearn model
    whose fixed random_state re-seeds identically every refit).

    sklearn with a fixed random_state draws the same |N(0,1)| values every
    refit but scales them by the current matrix's mean: draw once, rescale
    per outer iteration.
    """
    cols = torch.arange(mag.shape[1], device=mag.device)
    bad = ((cols >= col_start) & (cols < col_end))[None, :]
    avg_spec = mag[:, :col_start].mean(1, keepdim=True)
    current = torch.where(bad, avg_spec, mag)
    k = cfg.n_components
    w_raw, h_raw = _draw_wh(seed, mag.shape[0], mag.shape[1], k, mag.device)
    for _ in range(cfg.outer_iters):
        scale = _scale(current, k)
        w, h = _mu_fit(current, w_raw * scale, h_raw * scale, cfg.n_iter)
        current = torch.where(bad, w @ h, current)
    return current
