"""Windowed long-clip restoration: O(damage) work on arbitrarily long files.

The port of audio_inpainting_tpu/methods/windowed.py. Every method of the
facade works on the whole clip it is given (the U-Net trains on the full
spectrogram, reference main5_UNet_mask.py:77-98), so its memory and time
grow with the clip. This module restores only fixed-size windows around
the detected damage instead:

- damage detection runs once over the full signal (a threshold scan);
- nearby gaps are grouped so each group gets ONE window of a static size,
  the base window or a power-of-two multiple for oversized groups;
- clean audio passes through bit-identical; restored samples are composited
  back over the gaps with the reference's boundary-crossfade idiom
  (reference main4_NMF.py:114-126, 50-sample linear blend).

This also makes GP practical on long files (the window bounds its O(n^3)
fit, the reference's own trick of confining GP to 0.05 s segments,
main1_gp.py:46-49) and keeps per-window seeds deterministic.
"""

from __future__ import annotations

import numpy as np



def _merge_close(gaps: list[tuple[int, int]], min_sep: int) -> list[tuple[int, int]]:
    """Merge gaps separated by < min_sep samples into one span, so two
    windows never crossfade into each other's composite region."""
    if not gaps:
        return []
    gaps = sorted(gaps)
    out = [list(gaps[0])]
    for s, e in gaps[1:]:
        if s - out[-1][1] < min_sep:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def plan_windows(gaps: list[tuple[int, int]], n: int, window: int,
                 context: int) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """Group gaps into static-size restore windows.

    Returns [(w0, size, group_gaps)] with every gap inside
    [w0 + context, w0 + size - context] where possible (file edges excepted).
    ``size`` is ``window`` or a power-of-two multiple of it (an oversized
    group doubles until its span + 2*context fits).
    """
    if not gaps:
        return []
    gaps = sorted(gaps)
    groups: list[list[tuple[int, int]]] = [[gaps[0]]]
    for g in gaps[1:]:
        span0 = groups[-1][0][0]
        if g[1] - span0 + 2 * context <= window:
            groups[-1].append(g)
        else:
            groups.append([g])

    plan = []
    for group in groups:
        s0, e1 = group[0][0], group[-1][1]
        size = window
        while e1 - s0 + 2 * context > size and size < (n + window):
            size *= 2
        # center the span; clamp into the file (short files keep w0 = 0 and
        # the caller pads the extraction up to ``size``)
        w0 = s0 - (size - (e1 - s0)) // 2
        w0 = max(0, min(w0, max(0, n - size)))
        plan.append((w0, size, group))
    return plan


def window_spans(sub: np.ndarray, mask: np.ndarray, size: int):
    """A window's samples, validity mask and local damage spans, reflect-
    padded up to ``size`` where the signal ends first.

    The tail stays at natural signal amplitude, so the methods' silence
    detectors don't mistake padding for damage. The validity mask is
    mirrored ALONGSIDE the samples: a pad position whose mirror source sits
    inside a gap carries that gap's zeros, and marking it valid would hand
    the methods fake silence as anchor/fit context. The local spans are
    the mask's invalid runs, mirrored gap copies included. Shared with the
    streaming engine (methods/streaming.py)."""
    if len(sub) < size:
        pad = size - len(sub)
        sub = np.pad(sub, (0, pad), mode="reflect")
        mask = np.pad(mask, (0, pad), mode="reflect")
    flips = np.diff(mask.astype(np.int8))
    starts = (np.flatnonzero(flips == -1) + 1).tolist()
    ends = (np.flatnonzero(flips == 1) + 1).tolist()
    if not mask[0]:
        starts.insert(0, 0)
    if not mask[-1]:
        ends.append(size)
    return sub, mask, list(zip(starts, ends))


def restore_windowed(damaged, sr: int, method: str = "ar", *,
                     window_s: float = 10.0, context: int = 5000,
                     margin: int = 50, threshold: float = 1e-4,
                     gaps=None, seed: int = 0, original=None,
                     batch_windows: bool = False,
                     max_window: int | None = None, device=None, ranks=None,
                     **cfg_kwargs) -> np.ndarray:
    """Restore a long mono signal by windowing `api.restore` over the damage.

    Clean samples outside gap +- ``margin`` are returned bit-identical;
    each detected gap is filled from a ``window_s``-second window around it
    and composited back with ``margin``-sample linear crossfades at the gap
    boundaries (the reference's blend idiom, main4_NMF.py:114-126).

    gaps: optional [(start, end)] damaged spans; blind-detected otherwise
    (spans poking past the clip are clamped, like `api.restore`'s mask).
    original: clean reference signal (GAN only), windowed alongside.
    max_window: refuse (ValueError) any planned window beyond this many
    samples, since an oversized damage group doubles the base window until
    it fits. device: where every window is restored, cuda by default.
    Remaining kwargs flow to the method config via `api.restore`: the
    facade's AR defaults (order=30, context_len=1000) target the
    reference's 50-400-sample dropouts; for gaps beyond ~1000 samples pass
    the part-2 scale (order=100, context_len=5000) or use a spectral method.

    batch_windows (methods "ar" and "unet"): restore the windows of a
    class as ONE batch. ar: one class per (size, gap-count bucket, max-len
    bucket) (methods.ar.ar_restore_gaps_windows), one fit and one kernel
    launch per pass and class instead of per window. unet: one class per
    window size, one grouped net per class (parallel/batch.py
    ``restore_clips_unet``). Every window keeps the sequential path's
    seed and preprocessing, so batched == per-window up to the batch's
    summation order (the tests pin the bounds).

    ranks (parallel/mesh.py; default one rank on ``device``): the
    windows shared over the ranks, each restoring its slice on its own
    device: the U-Net's window batch of a size as one batch split over
    the ranks (``restore_clips_unet``), the AR classes by
    ``ar_restore_windows_dp``, other windows one by one. Every rank
    returns the whole restored signal.
    """
    from .. import api
    from ..corrupt import find_gaps
    from ..parallel.mesh import gather_objects, ranks_on, shard_range

    ranks = ranks_on(ranks, device)
    dev = ranks.device
    damaged = np.asarray(damaged, np.float32)
    n = len(damaged)
    window = max(int(round(window_s * sr)), 256)
    if method == "ar":
        # shape bucketing on by default inside the engines, as in the JAX
        # package: one batch class per (window size, gap-count bucket,
        # max-len bucket) instead of one per novel gap length
        cfg_kwargs.setdefault("bucket", True)
    if gaps is None:
        gaps = find_gaps(damaged, threshold=max(threshold, 0.01), min_len=100)
    # clamp explicit spans into the clip (same semantics as api.restore's
    # _mask slice clamp) rather than dropping a span that pokes past the end
    gaps = _merge_close([(max(0, int(s)), min(n, int(e))) for s, e in gaps
                         if int(s) < n and int(e) > 0 and int(s) < int(e)],
                        2 * margin)
    out = damaged.copy()
    if not gaps:
        return out

    ctx = max(min(context, window // 8), 1)
    orig = None if original is None else np.asarray(original, np.float32)[:n]

    prepped = []
    for w0, size, group in plan_windows(gaps, n, window, ctx):
        if max_window is not None and size > max_window:
            raise ValueError(
                f"a damage span near sample {group[0][0]} needs a "
                f"{size}-sample window ({size / sr:.2f} s — oversized groups "
                f"double the base window until they fit), over the "
                f"{max_window}-sample limit for method {method!r}; pick "
                "another method for damage this large")
        hi = min(w0 + size, n)
        # the method must know about EVERY gap inside the window, including
        # a neighboring group's, or it would fit/train on that gap's
        # silence as if it were signal (the reference's fit-on-zeros defect,
        # main3_AR_text_gap.py:34-49 detecting the whole file). Composite
        # back only THIS group's gaps; the neighbor's window owns the rest.
        mask = np.ones(hi - w0, bool)
        for s, e in gaps:
            ls, le = max(s, w0) - w0, min(e, hi) - w0
            if ls < le:
                mask[ls:le] = False
        sub, mask, local = window_spans(damaged[w0:hi], mask, size)
        sub_orig = (None if orig is None else
                    np.pad(orig[w0:hi], (0, size - (hi - w0)), mode="reflect"))
        prepped.append((w0, size, group, hi, sub, sub_orig, local, mask))

    if batch_windows and method == "unet" and len(prepped) > 1:
        restored_all = _restore_windows_unet_batched(prepped, seed=seed,
                                                     ranks=ranks, **cfg_kwargs)
    elif batch_windows and method == "ar" and len(prepped) > 1:
        restored_all = _restore_windows_ar_batched(prepped, seed=seed, ranks=ranks,
                                                   **cfg_kwargs)
    else:
        def one(i):
            _, _, _, _, sub, sub_orig, local, mask = prepped[i]
            return np.asarray(api.restore(
                sub, sr, method=method, gaps=local, mask=mask,
                threshold=threshold, seed=seed, original=sub_orig, device=dev,
                **cfg_kwargs), np.float32)

        mine = range(len(prepped))[shard_range(len(prepped), ranks, exact=False)]
        restored_all = sum(gather_objects([one(i) for i in mine], ranks), [])

    for (w0, size, group, hi, *_), restored in zip(prepped, restored_all):
        w = composite_weight(size, [(s - w0, e - w0) for s, e in group],
                             margin)
        m = hi - w0
        out[w0:hi] = (1.0 - w[:m]) * out[w0:hi] + w[:m] * restored[:m]
    return out


def composite_weight(size: int, rel_gaps: list[tuple[int, int]],
                     margin: int) -> np.ndarray:
    """Composite weight over a window: 1 inside each gap, linear ramps of up
    to ``margin`` samples just outside, 0 elsewhere (the reference's
    boundary-blend idiom, main4_NMF.py:114-126). Shared with the streaming
    engine (methods/streaming.py)."""
    w = np.zeros(size, np.float32)
    for s, e in rel_gaps:
        lo_r = max(s - margin, 0)
        hi_r = min(e + margin, size)
        if lo_r < s:
            w[lo_r:s] = np.maximum(w[lo_r:s],
                                   np.linspace(0.0, 1.0, s - lo_r,
                                               endpoint=False))
        w[s:e] = 1.0
        if e < hi_r:
            w[e:hi_r] = np.maximum(w[e:hi_r],
                                   np.linspace(1.0, 0.0, hi_r - e,
                                               endpoint=False))
    return w


def _restore_windows_ar_batched(prepped, *, seed: int, ranks, **cfg_kwargs):
    """Batch AR over same-shape-bucket windows via ar_restore_gaps_windows.

    Groups the prepped windows by (size, bucketed gap count, bucketed max
    run length), classes that are logarithmic in window and damage scale,
    and restores each class as one batch. Every window keeps the
    sequential path's config (api.AR_DEFAULTS) and seed, so batched ==
    sequential. Each class is split over ``ranks``
    (``ar_restore_windows_dp``). Returns the restored windows in
    ``prepped`` order.
    """
    from ..api import AR_DEFAULTS
    from ..parallel.engines import ar_restore_windows_dp
    from .ar import ARConfig, bucket_gap_count, bucket_max_len

    cfg = ARConfig(**{**AR_DEFAULTS, "bucket": True, **cfg_kwargs})
    by_class: dict[tuple[int, int, int], list[int]] = {}
    for i, (_, size, _, _, _, _, local, _) in enumerate(prepped):
        key = (size, bucket_gap_count(len(local)),
               bucket_max_len(max(e - s for s, e in local)))
        by_class.setdefault(key, []).append(i)

    results: list = [None] * len(prepped)
    for idxs in by_class.values():
        subs = np.stack([prepped[i][4] for i in idxs])
        gaps_list = [prepped[i][6] for i in idxs]
        out = ar_restore_windows_dp(subs, gaps_list, cfg, ranks, seed).cpu().numpy()
        for j, i in enumerate(idxs):
            results[i] = out[j]
    return results


def _restore_windows_unet_batched(prepped, *, seed: int, ranks, **cfg_kwargs):
    """Batch the U-Net over same-size windows via ``restore_clips_unet``.

    Every window gets what the facade's U-Net branch (api.py) computes for
    it: the peak normalization, the keep mask from ``mask_to_bad_columns``
    on the window's sample mask, and the stripes of a CPU generator seeded
    with ``seed``, the same for every window, as is the init seed. Each
    size class is one grouped net; every window is then iSTFT'd with its
    own phase. A size's batch is split over the ``ranks``' ``dp``
    axis, padded to a multiple of it with copies of its last window, which
    are dropped. Returns the restored windows in ``prepped`` order.
    """
    import torch

    from ..corrupt import mask_to_bad_columns, training_stripes
    from ..ops import istft, magphase, polar, stft, torch_stft_config
    from ..parallel.batch import restore_clips_unet
    from ..parallel.mesh import pad_repeat_last
    from .neural import UNetTrainConfig

    device = ranks.device
    scfg = torch_stft_config(1024, 256)
    by_size: dict[int, list[int]] = {}
    for i, (_, size, *_rest) in enumerate(prepped):
        by_size.setdefault(size, []).append(i)

    results: list = [None] * len(prepped)
    for size, idxs in by_size.items():
        norms, phases, peaks, keeps, trains = [], [], [], [], []
        for i in idxs:
            sub, sample_mask = prepped[i][4], prepped[i][7]
            mag, phase = magphase(stft(torch.tensor(sub, device=device), scfg))
            bad = mask_to_bad_columns(sample_mask, mag.shape[1], scfg.hop, device=device)
            keep = torch.as_tensor(~bad, dtype=torch.float32,
                                   device=device)[None, :].expand(mag.shape)
            syn = training_stripes(torch.Generator().manual_seed(seed), mag.shape[1], ~bad)
            peak = mag.max().clamp_min(1e-12)     # all-silent window: no NaN
            norms.append(mag / peak)
            phases.append(phase)
            peaks.append(peak)
            keeps.append(keep)
            trains.append(keep * torch.as_tensor(syn, device=device)[None, :])
        rows = torch.as_tensor(pad_repeat_last(len(idxs), ranks.n_dp), device=device)
        keepb = torch.stack(keeps)[rows, ..., None]
        final, _ = restore_clips_unet(
            torch.stack(norms)[rows, ..., None], torch.stack(trains)[rows, ..., None],
            UNetTrainConfig(**cfg_kwargs), [seed] * len(rows), valid_batch=keepb,
            composite_mask_batch=keepb, ranks=ranks)
        for j, i in enumerate(idxs):
            results[i] = istft(polar(final[j, ..., 0] * peaks[j], phases[j]), scfg,
                               size).cpu().numpy()
    return results
