"""Bidirectional autoregressive inpainting, batched, in torch.

Reference behavior being matched (as in audio_inpainting_tpu/methods/ar.py):

- ``main2_AR.py`` — order-30 AR via Ridge(alpha=0.1) on sliding windows,
  recursive one-step extrapolation from both gap edges, linear crossfade.
- ``main3_AR_text*.py`` — Ridge(alpha=0.5) + per-step Gaussian "texture"
  noise with sigma = std of training residuals; zero-prediction +
  one-sided-crossfade fallback when a side has an empty training set
  (``ARConfig.min_rows`` defaults to 1).
- Known reference quirk preserved: recursion starts from the *second-to-last*
  training window (``context_X[-1]`` = samples [len-order-1, len-1)), so the
  first prediction targets the last observed sample, not the first gap
  sample (main2_AR.py:65, main3_AR_text_gap.py:62).

One pass handles every gap at once: the batch B = [all gaps] x [fwd, bwd]
is gathered, fitted (masked Ridge normal equations, Cholesky) and
extrapolated together, then crossfaded and pasted. The recurrence runs in
the hand-written CUDA kernel (ops/ar_scan.py) when ``chunk == 0`` and the
tensors are on the GPU; ``chunk > 0`` takes the companion-matrix form as
batched matmuls. ``passes > 1`` re-runs the batch on the previous pass's
output.

Texture noise: pass p draws one (max_len, B) standard normal from a
``torch.Generator`` seeded from (seed, p), indexed eps[t, b]. It is not
jax.random's stream; the public functions take ``eps`` (one (max_len, B)
tensor per pass) so tests can inject the JAX package's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import as_f32
from ..ops.ar_scan import ar_extrapolate, ar_extrapolate_ref


@dataclass(frozen=True)
class ARConfig:
    order: int = 100
    alpha: float = 0.5
    texture: bool = True
    # Chunked companion-matrix extrapolation: advance the recurrence
    # ``chunk`` samples per step as three batched matmuls (see
    # _extrapolate_chunked) instead of one dot per sample. 0 = off
    # (the CUDA kernel, or the plain loop on the CPU). Requires chunk >= order.
    chunk: int = 0
    # Multiplier on the residual-sigma texture noise. 1.0 = reference
    # behavior (main3_AR_text.py:74 injects N(0, noise_std)).
    texture_scale: float = 1.0
    context_len: int = 5000
    passes: int = 1
    # A side is "valid" when it has >= min_rows training windows; invalid
    # sides get a zero prediction and the crossfade goes fully one-sided.
    min_rows: int = 1
    # Shape bucketing: pad the gap batch to the bucket_gap_count ladder
    # (8, 32, 128, ... — with zero-length dummy gaps that fit garbage
    # models but paste nothing) and round the extrapolation length up to a
    # power of two >= 1024. The JAX package uses it to bound its set of
    # compiled programs; here it only changes the batch and noise shapes.
    bucket: bool = False


_GAP_PAD_FLOOR = 8      # bucketed gap-batch sizes: 8, 32, 128, ... (x4)
_LEN_FLOOR = 1024       # bucketed extrapolation lengths: 1024, 2048, ...


def bucket_gap_count(n_gaps: int) -> int:
    """Bucketed gap-batch size: 8, then powers of FOUR (32, 128, ...)."""
    b = _GAP_PAD_FLOOR
    while b < n_gaps:
        b *= 4
    return b


def bucket_max_len(max_len: int) -> int:
    """Bucketed extrapolation length: power of two >= max(max_len, 1024)."""
    return max(_LEN_FLOOR, 1 << (max(1, max_len) - 1).bit_length())


def _fit_ridge_batched(ctxs: torch.Tensor, pad_lens: torch.Tensor, cfg: ARConfig):
    """Batched Ridge-with-intercept fit on sliding windows.

    ctxs: (B, C) contexts with time flowing toward the gap, front-padded.
    pad_lens: (B,) number of invalid leading samples per context.
    Returns (w (B, order), b (B,), noise_std (B,), valid (B,) bool).
    """
    order = cfg.order
    windows = ctxs.unfold(1, order + 1, 1)   # (B, R, order+1), a view
    X = windows[:, :, :order]                # (B, R, order)
    y = windows[:, :, order]                 # (B, R)
    R = X.shape[1]
    rows = torch.arange(R, device=ctxs.device)
    m = (rows[None, :] >= pad_lens[:, None]).to(torch.float32)   # (B, R)

    n = m.sum(1).clamp_min(1.0)                                   # (B,)
    mean_x = torch.einsum("br,bro->bo", m, X) / n[:, None]
    mean_y = (m * y).sum(1) / n
    Xc = (X - mean_x[:, None, :]) * m[:, :, None]
    yc = (y - mean_y[:, None]) * m

    A = torch.bmm(Xc.transpose(1, 2), Xc)
    A = A + cfg.alpha * torch.eye(order, dtype=A.dtype, device=A.device)[None]
    rhs = torch.bmm(Xc.transpose(1, 2), yc[..., None])
    # A is SPD (alpha > 0); cholesky_ex leaves no host sync on the GPU
    chol, _ = torch.linalg.cholesky_ex(A)
    w = torch.cholesky_solve(rhs, chol, upper=False)[..., 0]
    b = mean_y - (mean_x * w).sum(1)

    pred = torch.bmm(X, w[..., None])[..., 0] + b[:, None]
    resid = (y - pred) * m
    # np.std over the valid rows (population std, ddof=0 — reference
    # main3_AR_text_gap.py:58-60 computes np.std of all residuals)
    mean_r = resid.sum(1) / n
    noise_std = torch.sqrt(torch.clamp_min(
        (m * (resid - mean_r[:, None] * m) ** 2).sum(1) / n, 0.0))

    valid = m.sum(1) >= cfg.min_rows
    return w, b, noise_std, valid


def _state0(ctxs: torch.Tensor, order: int) -> torch.Tensor:
    """Reference quirk: start from context_X[-1] = samples [C-order-1, C-1)."""
    C = ctxs.shape[1]
    return ctxs[:, C - order - 1 : C - 1]


def _extrapolate_scan(ctxs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      noise_std: torch.Tensor, valid: torch.Tensor,
                      eps: torch.Tensor, steps: int) -> torch.Tensor:
    """Recursive AR extrapolation as the plain torch loop, on any device.

    eps: (steps, B) noise (zeros for texture off). Returns (B, steps)
    predictions (zeros for invalid models).
    """
    gain = valid.to(torch.float32)
    return ar_extrapolate_ref(_state0(ctxs, w.shape[1]), w, b, noise_std,
                              gain, eps.T, steps)


def _extrapolate_chunked(ctxs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         noise_std: torch.Tensor, valid: torch.Tensor,
                         eps: torch.Tensor, steps: int,
                         chunk: int) -> torch.Tensor:
    """Companion-matrix chunked AR extrapolation: k samples per step.

    The per-sample recurrence x_t = w . s_t + b + sigma e_t is linear, so a
    whole chunk of k outputs is an affine map of the entry state and the
    chunk's noise draws:

        x[0:k] = M s0  +  b q  +  sigma (L e[0:k])
        s'     = x[k-order:k]                      (k >= order)

    with M (k, order) the state impulse response, c the scalar impulse
    response (c_0 = 1, c_m = w . c_{m-order..m-1}), q = cumsum(c), and L the
    lower-triangular Toeplitz matrix of c. M and c come from two k-step
    loops; the main loop then runs ceil(steps/k) steps of batched matmuls.
    eps: (steps, B), the same draw the per-sample forms take.
    """
    B = ctxs.shape[0]
    p = w.shape[1]
    k = chunk
    if k < p:
        raise ValueError(f"chunk={k} must be >= order={p}")
    dev = ctxs.device
    state0 = _state0(ctxs, p)

    # scalar impulse response c (B, k): response of x_m to e_0
    z = torch.zeros((B, p), device=dev)
    z[:, -1] = 1.0
    cs = [torch.ones(B, device=dev)]
    for _ in range(k - 1):
        cm = (z * w).sum(1)
        z = torch.cat([z[:, 1:], cm[:, None]], dim=1)
        cs.append(cm)
    c = torch.stack(cs, dim=1)                                   # (B, k)

    # state response M (B, k, p): x_j = M[j] . s0 for the noiseless b=0 run
    S = torch.eye(p, device=dev).expand(B, p, p)
    ms = []
    for _ in range(k):
        m = torch.bmm(w[:, None, :], S)[:, 0]                    # (B, p)
        S = torch.cat([S[:, 1:, :], m[:, None, :]], dim=1)
        ms.append(m)
    M = torch.stack(ms, dim=1)                                   # (B, k, p)

    q = torch.cumsum(c, dim=1)                                   # (B, k)
    ii = torch.arange(k, device=dev)[:, None]
    jj = torch.arange(k, device=dev)[None, :]
    lower = ii >= jj
    L = torch.where(lower, c[:, (ii - jj).clamp_min(0)], 0.0)    # (B, k, k)

    nchunks = -(-steps // k)
    total = nchunks * k
    eps = F.pad(eps, (0, 0, 0, total - steps))                   # (total, B)
    eps = eps.reshape(nchunks, k, B).permute(0, 2, 1)            # (n, B, k)
    gain = valid.to(torch.float32)[:, None]

    s = state0
    xs = []
    for i in range(nchunks):
        x = (torch.bmm(M, s[..., None])[..., 0]
             + b[:, None] * q
             + noise_std[:, None] * torch.bmm(L, eps[i][..., None])[..., 0])
        x = x * gain
        s = x[:, k - p:]
        xs.append(x)
    return torch.stack(xs, dim=1).reshape(B, total)[:, :steps]


def _extract_contexts(signal: torch.Tensor, starts: torch.Tensor,
                      ends: torch.Tensor, context_len: int):
    """Gather (2G, C) contexts: rows [0,G) forward (left side, natural order),
    rows [G,2G) backward (right side, reversed). Front-padded with zeros
    where the clip boundary truncates the context; pad lengths returned."""
    n = signal.shape[0]
    C = context_len
    padded = F.pad(signal, (C, C))
    offs = torch.arange(C, device=signal.device)
    # fwd: original [start-C, start)  -> padded [start, start+C)
    fwd = padded[starts[:, None] + offs[None, :]]
    fwd_pad = (C - starts).clamp_min(0)
    # bwd: original [end, end+C) reversed -> padded [end+2C-1 .. end+C]
    bwd = padded[ends[:, None] + (2 * C - 1) - offs[None, :]]
    bwd_pad = (ends + C - n).clamp_min(0)
    return torch.cat([fwd, bwd]), torch.cat([fwd_pad, bwd_pad])


def _blend_and_paste(signal: torch.Tensor, starts: torch.Tensor,
                     lens: torch.Tensor, fwd: torch.Tensor, bwd: torch.Tensor,
                     fwd_valid: torch.Tensor, bwd_valid: torch.Tensor,
                     max_len: int) -> torch.Tensor:
    """Crossfade fwd/bwd predictions per gap and scatter into a copy of the
    signal.

    weights = linspace(1, 0, L) (all-ones / all-zeros when one side is
    invalid — reference main3_AR_text_gap.py:113-118).
    """
    n = signal.shape[0]
    dev = signal.device
    t = torch.arange(max_len, device=dev)[None, :]               # (1, S)
    L = lens[:, None]                                            # (G, 1)
    in_gap = t < L
    # reversed-in-gap backward prediction: bwd_rev[g, t] = bwd[g, L-1-t]
    rev_idx = (L - 1 - t).clamp(0, max_len - 1)
    bwd_rev = torch.gather(bwd, 1, rev_idx)

    ramp = 1.0 - t.to(torch.float32) / (L - 1).clamp_min(1).to(torch.float32)
    wts = torch.where(L > 1, ramp, 1.0)
    wts = torch.where(fwd_valid[:, None], wts, 0.0)
    wts = torch.where(bwd_valid[:, None], wts, 1.0)
    fill = fwd * wts + bwd_rev * (1.0 - wts)

    # positions outside the gap or past the clip end go to a sink slot at
    # index n, cut off afterwards (JAX's scatter mode="drop")
    pos = starts[:, None] + t
    pos = torch.where(in_gap & (pos < n), pos, n)
    out = torch.cat([signal, signal.new_zeros(1)])
    out.index_put_((pos.reshape(-1),), fill.reshape(-1))
    return out[:n]


def _draw_eps(seed: int, p: int, shape: tuple[int, int],
              device: torch.device) -> torch.Tensor:
    """Texture noise of pass ``p``: a standard normal from a generator
    seeded from (seed, p)."""
    mixed = np.random.SeedSequence([seed, p]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed) >> 1)
    return torch.randn(shape, generator=gen, device=device)


def _max_len(starts: np.ndarray, ends: np.ndarray, cfg: ARConfig) -> int:
    """Extrapolation length of a pass: the longest gap, bucketed if asked."""
    max_len = int(np.max(ends - starts))
    return bucket_max_len(max_len) if cfg.bucket else max_len


def _restore_once(signal: torch.Tensor, starts: np.ndarray, ends: np.ndarray,
                  cfg: ARConfig, eps: torch.Tensor | None):
    """One pass over every gap: extract, fit, extrapolate, blend.

    eps: (max_len, B) texture noise, or None for texture off.
    Returns (restored signal, (B, max_len) predictions).
    """
    max_len = _max_len(starts, ends, cfg)
    dev = signal.device
    st = torch.as_tensor(starts, dtype=torch.long, device=dev)
    en = torch.as_tensor(ends, dtype=torch.long, device=dev)
    G = len(starts)
    B = 2 * G
    if max_len == 0:
        return signal, signal.new_zeros((B, 0))
    ctxs, pads = _extract_contexts(signal, st, en, cfg.context_len)
    w, b, std, valid = _fit_ridge_batched(ctxs, pads, cfg)
    std = std * cfg.texture_scale
    if eps is None:
        eps = torch.zeros((max_len, B), device=dev)
    elif tuple(eps.shape) != (max_len, B):
        raise ValueError(f"eps must be {(max_len, B)}, got {tuple(eps.shape)}")
    if cfg.chunk > 0:
        preds = _extrapolate_chunked(ctxs, w, b, std, valid, eps, max_len,
                                     cfg.chunk)
    else:
        preds = ar_extrapolate(_state0(ctxs, cfg.order).contiguous(), w, b,
                               std, valid.to(torch.float32),
                               eps.T.contiguous(), max_len)
    out = _blend_and_paste(signal, st, en - st, preds[:G], preds[G:],
                           valid[:G], valid[G:], max_len)
    return out, preds


def _pass_eps(cfg: ARConfig, seed: int, eps, p: int, shape, device):
    if not cfg.texture:
        return None
    if eps is not None:
        return as_f32(eps[p], device)
    return _draw_eps(seed, p, shape, device)


def ar_restore_gaps(signal, gaps: list[tuple[int, int]], cfg: ARConfig,
                    seed: int = 0, *, eps=None, device=None) -> torch.Tensor:
    """Restore all gaps (list of (start, end)) bidirectionally, in parallel.

    ``cfg.passes > 1`` repeats the whole batch using the previous output as
    training context (symmetric generalization of the reference's
    progressive context reuse, main3_AR_text_mask.py:74-101).

    signal: tensor (stays on its device unless ``device`` is given) or
    array (goes to ``device``, default cuda). eps: optional list with one
    (max_len, B) noise tensor per pass, replacing the seeded draws.
    Returns the restored float32 signal on the chosen device.
    """
    signal = as_f32(signal, device)
    if not gaps:
        return signal
    starts = np.array([s for s, _ in gaps], dtype=np.int64)
    ends = np.array([e for _, e in gaps], dtype=np.int64)
    if cfg.bucket:
        # zero-length dummy gaps: their models fit on whatever sits at the
        # window start, but in_gap is empty so they paste nothing
        pad = bucket_gap_count(len(gaps)) - len(gaps)
        starts = np.pad(starts, (0, pad))
        ends = np.pad(ends, (0, pad))
    shape = (_max_len(starts, ends, cfg), 2 * len(starts))
    out = signal
    for p in range(cfg.passes):
        out, _ = _restore_once(out, starts, ends, cfg,
                               _pass_eps(cfg, seed, eps, p, shape, out.device))
    return out


def ar_restore_gap(signal, gap: tuple[int, int], cfg: ARConfig,
                   seed: int = 0, *, eps=None, device=None) -> torch.Tensor:
    """Single-gap restoration (Part 0 / Part 2)."""
    return ar_restore_gaps(signal, [gap], cfg, seed, eps=eps, device=device)


def ar_restore_gap_detailed(signal, gap: tuple[int, int], cfg: ARConfig,
                            seed: int = 0, *, eps=None, device=None):
    """Single-gap restoration also returning (pred_fwd, pred_bwd_reversed)
    as numpy, for the reference's fwd/bwd overlay visualization
    (main2_AR.py:134-152). One pass, as in the JAX package."""
    signal = as_f32(signal, device)
    s, e = gap
    L = e - s
    starts, ends = np.array([s], np.int64), np.array([e], np.int64)
    out, preds = _restore_once(
        signal, starts, ends, cfg,
        _pass_eps(cfg, seed, eps, 0, (_max_len(starts, ends, cfg), 2),
                  signal.device))
    fwd = preds[0, :L]
    bwd = preds[1, :L].flip(0)
    return out, fwd.cpu().numpy(), bwd.cpu().numpy()
