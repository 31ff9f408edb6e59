"""Batch serving: restore a directory of damaged WAVs.

The port of audio_inpainting_tpu/pipelines/serve.py, the corpus-scale
path: every clip's per-clip network trains at once, the G clips' nets as
one grouped net on the GPU (parallel/batch.py for the U-Net,
parallel/gan_batch.py for the GAN), in several groups one after another
when the corpus is larger than the card's memory holds.

Per clip: STFT (1024/256, the reference neural methods' convention), blind
damage detection from silent STFT columns (>= 90% of the hop window under
1e-4, main4_NMF_gap.py:28-40 semantics), batched restore, composite,
iSTFT with the damaged clip's phase, int16 WAV out. Every other method
restores clip by clip through the facade.

Unequal lengths are handled by padding every spectrogram to the batch's
max frame count with silence marked KEPT (pad columns never train or
composite into the output, which is trimmed to each clip's true length).

Several GPUs: ``devices`` = N serves on N ranks, one process per card
(parallel/mesh.py ``launch``, NCCL), clamped to the cards there are as the
JAX package clamps to its devices (on the CPU: to the clips there are,
over gloo). Every rank reads every clip; the unet and gan batches split
their clips over the ranks, the other methods' clips are shared out
whole, and under ``window_s`` each clip's windows are shared. Each rank
writes the WAVs of its share of the clips, and rank 0 merges the results.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from ..corrupt import silent_frame_columns, training_stripes
from ..device import resolve_device
from ..io import load_mono_normalized, save_wav_int16
from ..ops import istft, magphase, polar, stft, torch_stft_config
from ..parallel.batch import clip_seed
from ..parallel.mesh import Ranks, gather_objects, launch, pad_repeat_last, shard_range
from ..utils.profiling import span

_CFG = torch_stft_config(1024, 256)


def _analyze(path: str, device):
    """(sr, signal, magnitude (F, T) on the host, phase on ``device``,
    bad columns (T,) bool)."""
    sr, x = load_mono_normalized(path)
    mag, phase = magphase(stft(torch.tensor(x, device=device), _CFG))
    n_frames = int(mag.shape[1])
    bad = np.zeros(n_frames, bool)
    bad[silent_frame_columns(x, n_frames, _CFG.hop, threshold=1e-4,
                             silent_fraction=0.9, device=device)] = True
    return sr, x, mag.cpu().numpy(), phase, bad


def _pad_to(a: np.ndarray, t: int, value: float) -> np.ndarray:
    if a.shape[1] >= t:          # longer than the batch frame: truncate
        return a[:, :t]
    return np.pad(a, ((0, 0), (0, t - a.shape[1])), constant_values=value)


def _true_extent_mask(shape, f: int, clips) -> np.ndarray:
    """1 over each clip's true (f, t_i) extent of the padded batch array
    (shared by the unet and gan branches: pad cells must never enter a
    reconstruction loss)."""
    valid = np.zeros(shape, np.float32)
    for i, c in enumerate(clips):
        valid[i, :f, :min(c[2].shape[1], shape[2])] = 1.0
    return valid


def _synthetic_train_masks(seed: int, clips, masks: np.ndarray) -> np.ndarray:
    """Per-clip synthetic stripe masks for serving-mode U-Net training
    (1 = keep), drawn over each clip's TRUE frame extent, never the batch
    or divisor padding: ``training_stripes`` (shared with the facade's
    U-Net branch) on a CPU generator seeded with ``clip_seed(seed, i)``."""
    _, _, t_pad = masks.shape
    syn = np.ones_like(masks)
    for i, c in enumerate(clips):
        t_i = min(c[2].shape[1], t_pad)
        intact = masks[i, 0, :t_i] > 0       # full-band stripes: row 0 view
        syn[i, :, :t_i] = training_stripes(
            torch.Generator().manual_seed(clip_seed(seed, i)), t_i, intact)[None, :]
    return syn


def run_serve(input_dir: str, output_dir: str, method: str = "unet",
              epochs: int = 400, originals_dir: str | None = None,
              seed: int = 0, devices: int = 1,
              window_s: float | None = None, device=None) -> dict:
    """Restore every WAV under input_dir into output_dir; returns metrics.

    unet and gan train all clips as one batch (gan needs ``originals_dir``,
    clean WAVs of the same names: the reference GAN trains against the
    clean clip); every other method runs the per-clip facade. window_s:
    long-file mode, each clip restores only fixed windows around its
    detected damage (methods/windowed.py; unet windows batch per window
    size). devices: ranks to serve on (>= 1), one per card (cuda:0 ..
    cuda:N-1), clamped to the cards present; on the CPU to the clips.
    device: cuda unless "cpu" is named.
    """
    if devices < 1:
        raise ValueError(f"--devices must be >= 1, got {devices}")
    dev = resolve_device(device)
    paths = sorted(glob.glob(os.path.join(input_dir, "*.wav")))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {input_dir}")
    n = min(devices, torch.cuda.device_count() if dev.type == "cuda" else len(paths))
    args = (input_dir, output_dir, method, epochs, originals_dir, seed, window_s)
    if n == 1:
        return serve_ranks(Ranks.solo(dev), *args)
    return launch(serve_ranks, n, devices="cpu" if dev.type == "cpu" else None, args=args)


def serve_ranks(ranks: Ranks, input_dir: str, output_dir: str, method: str = "unet",
                epochs: int = 400, originals_dir: str | None = None, seed: int = 0,
                window_s: float | None = None) -> dict:
    """``run_serve``'s work on one rank of ``ranks`` (every rank calls it):
    the same arguments, on the rank's device; the results of every rank,
    merged, on every rank."""
    dev = ranks.device
    paths = sorted(glob.glob(os.path.join(input_dir, "*.wav")))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {input_dir}")
    os.makedirs(output_dir, exist_ok=True)
    t0 = time.time()

    clips, kept_paths, skipped = [], [], []
    for p in paths:
        try:
            clips.append(_analyze(p, dev))
            kept_paths.append(p)
        except Exception as e:  # unreadable/corrupt container: skip, don't
            skipped.append({"file": os.path.basename(p),   # kill the batch
                            "error": f"{type(e).__name__}: {e}"})
    if not clips:
        raise ValueError(f"no readable .wav files under {input_dir}: "
                         f"{skipped}")
    paths = kept_paths

    orig_clips = None
    if method == "gan":
        if originals_dir is None:
            raise ValueError("gan serving needs --originals (the reference "
                             "GAN trains against the clean clip, "
                             "main_gan_gap.py:103-108)")
        kept2, orig_clips = [], []
        for p, c in zip(paths, clips):
            op = os.path.join(originals_dir, os.path.basename(p))
            try:
                orig_clips.append(_analyze(op, dev))
                kept2.append((p, c))
            except Exception as e:   # missing/corrupt original: skip clip
                skipped.append({"file": os.path.basename(p),
                                "error": f"original: "
                                         f"{type(e).__name__}: {e}"})
        if not kept2:
            raise ValueError(f"no clip under {input_dir} has a readable "
                             f"original in {originals_dir}: {skipped}")
        paths = [p for p, _ in kept2]
        clips = [c for _, c in kept2]

    results = {"method": method, "clips": len(clips), "epochs": epochs}
    files = {}
    # the clips whose WAVs this rank writes
    mine = range(len(clips))[shard_range(len(clips), ranks, exact=False)]

    def write(i: int, y) -> None:
        sr, _, mag, _, cols = clips[i]
        name = os.path.basename(paths[i])
        save_wav_int16(y, sr, os.path.join(output_dir, name))
        files[name] = {"frames": int(mag.shape[1]), "damaged_cols": int(cols.sum())}

    if window_s is not None:
        from ..methods.windowed import restore_windowed

        results.update(window_s=window_s)
        for i, (sr, x, mag, _phase, cols) in enumerate(clips):
            kw = {}
            if method in ("unet", "gan"):
                kw["epochs"] = epochs
            elif method == "diffusion":
                kw["train_steps"] = epochs
            y = restore_windowed(
                x, sr, method=method, window_s=window_s, seed=seed,
                original=orig_clips[i][1] if method == "gan" else None,
                batch_windows=(method == "unet"), ranks=ranks, **kw)
            if i in mine:
                write(i, y)
    elif method not in ("unet", "gan"):
        # every other method runs through the per-clip facade (these are
        # sub-second methods where batching buys nothing)
        from ..api import restore as api_restore

        for i in mine:
            sr, x = clips[i][:2]
            write(i, api_restore(x, sr, method=method, seed=seed, device=dev))
    else:
        final = _restore_batch(clips, orig_clips, method, epochs, seed, ranks)
        for i in mine:
            sr, x, mag, phase, cols = clips[i]
            t_i = mag.shape[1]
            out_mag = torch.as_tensor(final[i, :mag.shape[0], :t_i], dtype=torch.float32,
                                      device=dev)
            write(i, istft(polar(out_mag, phase), _CFG, len(x)).cpu().numpy())

    merged = {}
    for part in gather_objects(files, ranks):
        merged.update(part)
    results.update(skipped=skipped,
                   files={os.path.basename(p): merged[os.path.basename(p)] for p in paths},
                   wall_s=round(time.time() - t0, 2))
    return results


def _restore_batch(clips, orig_clips, method: str, epochs: int, seed: int,
                   ranks: Ranks) -> np.ndarray:
    """The unet or gan batch over every clip, split over ``ranks``: the
    restored magnitudes (G, F4, T_pad) on the host; one ``serve.batch``
    span (utils/profiling.py) with its ``method`` and ``clips``."""
    with span("serve.batch", method=method, clips=len(clips)):
        from ..methods.neural import GANTrainConfig, UNetTrainConfig
        from ..parallel import restore_clips_gan, restore_clips_unet

        f = clips[0][2].shape[0]
        g = len(clips)
        # frame count: the batch's max, padded to the models' T % 32
        t_max = max(c[2].shape[1] for c in clips)
        t_pad = t_max + ((-t_max) % 32)
        mags = np.stack([_pad_to(c[2], t_pad, 0.0) for c in clips])
        col_keep = np.stack(
            [np.pad(~c[4], (0, t_pad - len(c[4])), constant_values=True)
             for c in clips]).astype(np.float32)          # 1 = kept
        masks = np.broadcast_to(col_keep[:, None, :], mags.shape).copy()
        fpad = (-f) % 4
        if fpad:
            mags = np.pad(mags, ((0, 0), (0, fpad), (0, 0)))
            masks = np.pad(masks, ((0, 0), (0, fpad), (0, 0)), constant_values=1.0)
        # the ranks' divisor: repeat the last clip, drop its outputs (the
        # copies' seeds follow on, clip_seed(seed, i) for i >= g; the real
        # clips keep theirs)
        rows = pad_repeat_last(g, ranks.n_dp)

        if method == "unet":
            peak = np.maximum(mags.max(axis=(1, 2), keepdims=True), 1e-12)
            norm = (mags / peak).astype(np.float32)
            # Train on SYNTHETIC frame dropouts over the intact content
            # (reference main5_UNet_mask.py:111-127 semantics: the net learns to
            # fill columns from context), then composite over the REAL damage.
            # Training directly against the detected-damage mask would teach
            # the net that holes contain silence: its targets there ARE the
            # damaged (silent) columns.
            syn = _synthetic_train_masks(seed, clips, masks)
            train_mask = (masks * syn).astype(np.float32)  # real damage AND syn
            # loss only where content is real: synthetic holes inside intact,
            # true-extent cells (real holes have no target and stay out)
            valid = _true_extent_mask(norm.shape, f, clips) * masks
            out, _ = restore_clips_unet(
                norm[rows, ..., None], train_mask[rows, ..., None],
                UNetTrainConfig(epochs=epochs), seed, valid_batch=valid[rows, ..., None],
                composite_mask_batch=masks[rows, ..., None], ranks=ranks)
            return out[:g, ..., 0].cpu().numpy() * peak
        rmags = np.stack([_pad_to(c[2], t_pad, 0.0) for c in orig_clips])
        if fpad:
            rmags = np.pad(rmags, ((0, 0), (0, fpad), (0, 0)))
        lo = mags.min(axis=(1, 2), keepdims=True)
        hi = np.maximum(mags.max(axis=(1, 2), keepdims=True), lo + 1e-12)
        norm = (2 * (mags - lo) / (hi - lo) - 1).astype(np.float32)
        rnorm = (2 * (rmags - lo) / (hi - lo) - 1).astype(np.float32)
        # each clip's true (f, t_i) extent: pad cells must not enter the L1
        # reconstruction term
        valid = _true_extent_mask(norm.shape, f, clips)
        # the readout policy of Part 2's GAN leg (gap-scoped weight EMA and
        # the collapse retry); the 0.04 collapse signature is calibrated at
        # convergence, so the retry only arms at the full budget
        cfg = GANTrainConfig(epochs=epochs, bf16=True, ema_decay=0.99, ema_scope="gap",
                             retry_l1=0.04 if epochs >= 1500 else 0.0)
        # the copies never gate the retry
        pads = {"n_real": g} if len(rows) > g else {}
        out, _ = restore_clips_gan(norm[rows], rnorm[rows], masks[rows], cfg, seed,
                                   valid_batch=valid[rows], ranks=ranks, **pads)
        return (out[:g].cpu().numpy() + 1) / 2 * (hi - lo) + lo
