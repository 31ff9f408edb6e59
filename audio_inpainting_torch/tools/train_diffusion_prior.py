"""Train the corpus diffusion prior, on the card by default.

The port of tools/train_diffusion_prior.py, the JAX package's trainer of
its committed prior (checkpoints/diffusion_prior: 48 procedural clips
plus the corrupted variants of the even ones, 24,000 steps). It trains
the spectrogram DDPM (``train_spectrogram_ddpm``: 250 steps per image,
one save at the end) on ``synth_music_clip`` spectrograms, a corpus
that never holds the evaluation clip, writes the prior with
``save_params``, and reports the diffusion leg on a clip with Part 2's
centre 2 s hole: with the prior, over a sweep of ``fill_energy_ratio``
(``--sweep-fill``), and with a DDPM trained on the damaged clip alone
(the on-clip-adapted leg, unless ``--skip-adapted``).

    python -m audio_inpainting_torch.tools.train_diffusion_prior
        [--clips 16] [--steps 12000] [--out runs/diffusion_prior]
        [--eval-only] [--sweep-fill] [--skip-adapted]
        [--eval-wav PATH] [--device cuda]

The evaluation clip is Part 2's synthetic one, ``synth_music_clip(1,
44100, 10.0)`` through the int16 WAV chain, unless ``--eval-wav`` names a
WAV (its first 10 s). ``--eval-only`` evaluates the prior in ``--out``
(the converted one: ``--out audio_inpainting_torch/weights/
diffusion_prior``). Progress goes to standard error; the last line of
standard output is one JSON object with the JAX tool's keys, plus
``train`` (steps, wall, ms per step, peak memory, the mean loss of each
1,000 steps) after a training run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..corrupt import center_gap_bounds, synth_music_clip
from ..device import resolve_device
from ..io import load_mono_normalized, save_wav_int16
from ..methods.diffusion import (DiffusionConfig, diffusion_restore_audio, logspec_to_image,
                                 mask_from_image, train_spectrogram_ddpm, wav_to_logspec)
from ..metrics import local_snr_db, lsd_db, snr_db
from ..utils import load_params

EVAL_SR = 44100
LOSS_CURVE_EVERY = 1000


def _image(clip: np.ndarray, dev) -> np.ndarray:
    return logspec_to_image(wav_to_logspec(torch.as_tensor(clip, device=dev)).cpu().numpy())[0]


def build_corpus(n_clips: int, sr: int, device=None):
    """Clean clips, ``synth_music_clip(1000 + i)``, each an image with an
    all-zero loss mask, and after every even-indexed one its corrupted
    variant (Part 2's centre 2 s gap) with the hole masked from the loss.
    Returns (images, masks), uint8 (1025, frames) lists."""
    dev = resolve_device(device)
    images, masks = [], []
    for i in range(n_clips):
        clip = synth_music_clip(1000 + i, sr=sr, seconds=10.0)
        img = _image(clip, dev)
        images.append(img)
        masks.append(np.zeros_like(img))
        if i % 2 == 0:      # corrupted variant: intact regions only in the loss
            dmg = clip.copy()
            gs, ge = center_gap_bounds(len(dmg), sr)
            dmg[gs:ge] = 0.0
            dimg = _image(dmg, dev)
            images.append(dimg)
            masks.append(mask_from_image(dimg))
    return images, masks


def eval_clip(path: str | None) -> tuple[int, np.ndarray]:
    """(sr, the first 10 s) of the WAV at ``path``, or without one Part 2's
    synthetic clip through the int16 WAV chain."""
    if path is None:
        with tempfile.TemporaryDirectory() as tmp:
            path = save_wav_int16(synth_music_clip(1, EVAL_SR, 10.0), EVAL_SR,
                                  os.path.join(tmp, "part2.wav"))
            sr, data = load_mono_normalized(path)
    else:
        sr, data = load_mono_normalized(path)
    return sr, data[:10 * sr]


def eval_on_bench(params, cfg: DiffusionConfig, tag: str, clip, device=None) -> dict:
    """Part 2's diffusion leg on ``clip`` = (sr, data) with its centre 2 s
    zeroed: SNR, local SNR, LSD and the wall."""
    dev = resolve_device(device)
    sr, data = clip
    gs, ge = center_gap_bounds(len(data), sr)
    damaged = data.copy()
    damaged[gs:ge] = 0.0
    t0 = time.time()
    out = diffusion_restore_audio(damaged, sr, cfg, key=0, params=params, device=dev)
    wall = time.time() - t0
    res = {"snr_db": float(snr_db(data, out, dev)),
           "local_snr_db": float(local_snr_db(data, out, gs, ge, dev)),
           "lsd_db": float(lsd_db(data, out, device=dev)),
           "wall_s": round(wall, 2)}
    print(f"[eval:{tag}] {json.dumps(res)}", file=sys.stderr)
    return res


def loss_curve(losses: torch.Tensor, every: int = LOSS_CURVE_EVERY) -> list[float]:
    """The mean loss of each ``every`` consecutive steps (the last stretch
    may be shorter)."""
    return [float(c.mean()) for c in losses.split(every)]


def train(args, cfg: DiffusionConfig, dev) -> tuple[dict, dict]:
    """Build the corpus and train on it; (params, the run's numbers)."""
    t0 = time.time()
    images, masks = build_corpus(args.clips, EVAL_SR, dev)
    print(f"[corpus] {len(images)} spectrogram images ({args.clips} clips + corrupted "
          f"variants) in {time.time() - t0:.1f}s", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    t0 = time.time()
    params = train_spectrogram_ddpm(images, cfg, key=0, checkpoint_dir=args.out,
                                    masks_u8=masks, device=dev, losses=runs)
    losses = torch.cat(runs).cpu()         # waits for the last step
    wall = time.time() - t0
    print(f"[train] {args.steps} steps in {wall:.1f}s -> {args.out}", file=sys.stderr)
    return params, {
        "images": len(images), "steps": args.steps, "wall_s": wall,
        "ms_per_step": 1e3 * wall / max(args.steps, 1),
        "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
                    else None),
        "losses_finite": bool(torch.isfinite(losses).all()),
        "loss_curve_every": LOSS_CURVE_EVERY, "loss_curve": loss_curve(losses)}


def main(argv: list[str] | None = None, **cfg_fields) -> int:
    """The command line; ``cfg_fields`` override DiffusionConfig's other
    fields (small models in tests)."""
    ap = argparse.ArgumentParser(prog="python -m audio_inpainting_torch.tools."
                                      "train_diffusion_prior")
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--out", default=os.path.join("runs", "diffusion_prior"))
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate the prior in --out")
    ap.add_argument("--sweep-fill", action="store_true",
                    help="after training, sweep fill_energy_ratio on the "
                         "evaluation clip and print the curve")
    ap.add_argument("--skip-adapted", action="store_true",
                    help="skip the on-clip-adapted baseline leg")
    ap.add_argument("--eval-wav", default=None,
                    help="the evaluation WAV (default: Part 2's synthetic clip)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = DiffusionConfig(**{**cfg_fields, "train_steps": args.steps})
    summary = {}
    if args.eval_only:
        params = load_params(args.out, dev)
    else:
        params, summary["train"] = train(args, cfg, dev)
    clip = eval_clip(args.eval_wav)
    corpus_res = eval_on_bench(params, cfg, "corpus-prior", clip, dev)

    if args.sweep_fill:
        # the fill power target depends on the prior: measure it again
        # whenever the corpus changes
        sweep = {str(r): eval_on_bench(params, dataclasses.replace(cfg, fill_energy_ratio=r),
                                       f"fill={r}", clip, dev)
                 for r in (0.08, 0.12, 0.15, 0.20, 0.30, 0.50)}
        print(json.dumps({"fill_sweep": sweep}))

    summary.update(corpus_prior=corpus_res, train_steps=args.steps, checkpoint=args.out,
                   device=str(dev))
    if not args.skip_adapted:
        # the on-clip-adapted baseline: a DDPM trained on the damaged clip,
        # its hole masked from the loss
        sr, data = clip
        gs, ge = center_gap_bounds(len(data), sr)
        damaged = data.copy()
        damaged[gs:ge] = 0.0
        img = _image(damaged, dev)
        adapt_cfg = DiffusionConfig(**{**cfg_fields, "train_steps": 1500})
        t0 = time.time()
        adapted = train_spectrogram_ddpm([img], adapt_cfg, key=0,
                                         masks_u8=[mask_from_image(img)], device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"[train] on-clip adaptation 1500 steps in {time.time() - t0:.1f}s",
              file=sys.stderr)
        summary["on_clip_adapted"] = eval_on_bench(adapted, adapt_cfg, "on-clip-adapted",
                                                   clip, dev)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
