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
batched matmuls, and so do orders above the kernel's limit on the GPU
(``extrapolation_chunk``). ``passes > 1`` re-runs the batch on the
previous pass's output.

``ar_restore_gaps_windows`` runs a stack of equal-length windows the same
way: the windows' rows form one batch, so one pass is one fit and one
kernel launch for all of them (the JAX package vmaps its plain scan over
the windows instead).

Texture noise: pass p draws one (max_len, B) standard normal from a CPU
``torch.Generator`` seeded from (seed, p), indexed eps[t, b], the same
numbers on every device. It is not jax.random's stream; the public
functions take ``eps`` (one (max_len, B) tensor per pass) so tests can
inject the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import as_f32, host_to_device
from ..ops.ar_scan import MAX_ORDER, ar_extrapolate, ar_extrapolate_ref


@dataclass(frozen=True)
class ARConfig:
    order: int = 100
    alpha: float = 0.5
    texture: bool = True
    # Chunked companion-matrix extrapolation: advance the recurrence
    # ``chunk`` samples per step as three batched matmuls (see
    # _extrapolate_chunked) instead of one dot per sample. 0 = off
    # (the CUDA kernel, or the plain loop on the CPU; on the GPU orders
    # above the kernel's limit take this form anyway, see
    # extrapolation_chunk). Requires chunk >= order.
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
    where the clip boundary truncates the context; pad lengths returned.

    A window stack (W, n) with (W, G) starts and ends gives (W*2G, C) rows,
    window-major: each window's 2G rows in the order above, gathered from
    its own row of one padded (W, n + 2C) buffer."""
    if signal.dim() == 1:
        signal, starts, ends = signal[None], starts[None], ends[None]
    n = signal.shape[1]
    C = context_len
    padded = F.pad(signal, (C, C))
    offs = torch.arange(C, device=signal.device)
    row = torch.arange(signal.shape[0], device=signal.device)[:, None, None]
    # fwd: original [start-C, start)  -> padded [start, start+C)
    fwd = padded[row, starts[..., None] + offs]
    fwd_pad = (C - starts).clamp_min(0)
    # bwd: original [end, end+C) reversed -> padded [end+2C-1 .. end+C]
    bwd = padded[row, ends[..., None] + (2 * C - 1) - offs]
    bwd_pad = (ends + C - n).clamp_min(0)
    return (torch.cat([fwd, bwd], dim=1).reshape(-1, C),
            torch.cat([fwd_pad, bwd_pad], dim=1).reshape(-1))


def _blend_and_paste(signal: torch.Tensor, starts: torch.Tensor,
                     lens: torch.Tensor, fwd: torch.Tensor, bwd: torch.Tensor,
                     fwd_valid: torch.Tensor, bwd_valid: torch.Tensor,
                     max_len: int) -> torch.Tensor:
    """Crossfade fwd/bwd predictions per gap and scatter into a copy of the
    signal.

    weights = linspace(1, 0, L) (all-ones / all-zeros when one side is
    invalid — reference main3_AR_text_gap.py:113-118).

    signal (n,) with (G,) starts, lens and flags and (G, max_len)
    predictions; or a window stack (W, n) with (W, G) and (W, G, max_len).
    """
    n = signal.shape[-1]
    dev = signal.device
    t = torch.arange(max_len, device=dev)                        # (S,)
    L = lens[..., None]                                          # (..., G, 1)
    in_gap = t < L
    # reversed-in-gap backward prediction: bwd_rev[g, t] = bwd[g, L-1-t]
    rev_idx = (L - 1 - t).clamp(0, max_len - 1)
    bwd_rev = torch.gather(bwd, -1, rev_idx)

    ramp = 1.0 - t.to(torch.float32) / (L - 1).clamp_min(1).to(torch.float32)
    wts = torch.where(L > 1, ramp, 1.0)
    wts = torch.where(fwd_valid[..., None], wts, 0.0)
    wts = torch.where(bwd_valid[..., None], wts, 1.0)
    fill = fwd * wts + bwd_rev * (1.0 - wts)

    # positions outside the gap or past the clip end go to a sink slot at
    # index n of each signal's row, cut off afterwards (JAX's scatter
    # mode="drop"); row w starts at w * (n + 1) in the flat copy
    pos = starts[..., None] + t
    pos = torch.where(in_gap & (pos < n), pos, n)
    rows = signal.reshape(-1, n)
    W = rows.shape[0]
    pos = pos.reshape(W, -1) + torch.arange(W, device=dev)[:, None] * (n + 1)
    out = torch.cat([rows, rows.new_zeros(W, 1)], dim=1).reshape(-1)
    out.index_put_((pos.reshape(-1),), fill.reshape(-1))
    return out.reshape(W, n + 1)[:, :n].reshape(signal.shape)


def _draw_eps(seed: int, p: int, shape: tuple[int, int],
              device: torch.device) -> torch.Tensor:
    """Texture noise of pass ``p``: a standard normal from a CPU generator
    seeded from (seed, p), the same numbers on every device, copied to
    ``device``."""
    mixed = np.random.SeedSequence([seed, p]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(mixed) >> 1)
    return host_to_device(torch.randn(shape, generator=gen), device)


def _max_len(starts: np.ndarray, ends: np.ndarray, cfg: ARConfig) -> int:
    """Extrapolation length of a pass: the longest gap, bucketed if asked."""
    max_len = int(np.max(ends - starts))
    return bucket_max_len(max_len) if cfg.bucket else max_len


def extrapolation_chunk(order: int, chunk: int, device_type: str) -> int:
    """The chunk length the recurrence of a pass runs at: 0 for
    ``ar_extrapolate`` (the CUDA kernel on the GPU, the plain loop on the
    CPU), else the companion-matrix form's. An order above the kernel's
    ``MAX_ORDER`` takes that form on the GPU, at the order rounded up to a
    multiple of 32, as the JAX package takes its plain scan above its
    kernel's limit (JAX methods/ar.py:351)."""
    if chunk > 0:
        return chunk
    if device_type == "cuda" and order > MAX_ORDER:
        return 32 * -(-order // 32)
    return 0


def _restore_windows_once(signals: torch.Tensor, starts: np.ndarray,
                          ends: np.ndarray, cfg: ARConfig,
                          eps: torch.Tensor | None):
    """One pass over every gap of a stack of equal-length windows: extract,
    fit, extrapolate, blend, with the windows' rows as one batch.

    signals: (W, n); starts, ends: (W, G) window-local spans (zero-length
    rows paste nothing). eps: (max_len, W*2G) texture noise with window w's
    rows at [w*2G, (w+1)*2G), or None for texture off.
    Returns (restored (W, n), (W*2G, max_len) predictions).
    """
    max_len = _max_len(starts, ends, cfg)
    dev = signals.device
    st = torch.as_tensor(starts, dtype=torch.long, device=dev)
    en = torch.as_tensor(ends, dtype=torch.long, device=dev)
    W, G = starts.shape
    B = W * 2 * G
    if max_len == 0:
        return signals, signals.new_zeros((B, 0))
    ctxs, pads = _extract_contexts(signals, st, en, cfg.context_len)
    w, b, std, valid = _fit_ridge_batched(ctxs, pads, cfg)
    std = std * cfg.texture_scale
    if eps is None:
        eps = torch.zeros((max_len, B), device=dev)
    elif tuple(eps.shape) != (max_len, B):
        raise ValueError(f"eps must be {(max_len, B)}, got {tuple(eps.shape)}")
    chunk = extrapolation_chunk(cfg.order, cfg.chunk, dev.type)
    if chunk > 0:
        preds = _extrapolate_chunked(ctxs, w, b, std, valid, eps, max_len,
                                     chunk)
    else:
        preds = ar_extrapolate(_state0(ctxs, cfg.order).contiguous(), w, b,
                               std, valid.to(torch.float32),
                               eps.T.contiguous(), max_len)
    sides = preds.reshape(W, 2, G, max_len)
    ok = valid.reshape(W, 2, G)
    out = _blend_and_paste(signals, st, en - st, sides[:, 0], sides[:, 1],
                           ok[:, 0], ok[:, 1], max_len)
    return out, preds


def _restore_once(signal: torch.Tensor, starts: np.ndarray, ends: np.ndarray,
                  cfg: ARConfig, eps: torch.Tensor | None):
    """One pass over every gap of one signal: a stack of one window.

    eps: (max_len, B) texture noise, or None for texture off.
    Returns (restored signal, (B, max_len) predictions).
    """
    out, preds = _restore_windows_once(signal[None], starts[None], ends[None],
                                       cfg, eps)
    return out[0], preds


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


def windows_prep(gaps_list, cfg: ARConfig):
    """Validate the batched windows' single-bucket contract and build the
    padded (W, gpad) start/end arrays. Returns (cfg with bucket forced on,
    starts, ends, gpad, max_len)."""
    if any(not g for g in gaps_list):
        raise ValueError("every window must have at least one gap")
    cfg = dataclasses.replace(cfg, bucket=True)
    gpads = {bucket_gap_count(len(g)) for g in gaps_list}
    lens = {bucket_max_len(max(e - s for s, e in g)) for g in gaps_list}
    if len(gpads) != 1 or len(lens) != 1:
        raise ValueError(
            f"windows span multiple shape buckets (gap counts {gpads}, "
            f"max lens {lens}); group by bucket first")
    gpad, max_len = gpads.pop(), lens.pop()
    W = len(gaps_list)
    starts = np.zeros((W, gpad), np.int64)
    ends = np.zeros((W, gpad), np.int64)
    for i, g in enumerate(gaps_list):
        starts[i, :len(g)] = [s for s, _ in g]
        ends[i, :len(g)] = [e for _, e in g]
    return cfg, starts, ends, gpad, max_len


def ar_restore_gaps_windows(signals, gaps_list, cfg: ARConfig, seed: int = 0,
                            *, eps=None, device=None) -> torch.Tensor:
    """Restore the gaps of a stack of equal-length windows as one batch.

    signals: (W, n) float32 windows; gaps_list: per-window window-local
    [(s, e)] spans, every list non-empty. Bucketing is forced on, and all
    windows must land in the same (gap-count, max-len) bucket: callers
    group windows by (size, bucket_gap_count, bucket_max_len) first
    (methods/windowed.py). A pass is one fit, one extrapolation (one
    kernel launch on the GPU) and one paste over all W*2*gpad rows.

    Every window adds the noise the sequential path (``ar_restore_gaps``
    with bucketing, one window at a time) adds with the same seed: pass
    p's (max_len, 2*gpad) draw, tiled over the windows. So batched ==
    sequential up to the batch's summation order. eps: optional list with
    one (max_len, 2*gpad) noise tensor per pass, replacing the draws.
    Returns the restored (W, n) float32 windows on the chosen device.
    """
    cfg, starts, ends, gpad, max_len = windows_prep(gaps_list, cfg)
    out = as_f32(signals, device)
    W = out.shape[0]
    for p in range(cfg.passes):
        e = _pass_eps(cfg, seed, eps, p, (max_len, 2 * gpad), out.device)
        out, _ = _restore_windows_once(out, starts, ends, cfg,
                                       None if e is None else e.repeat(1, W))
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
