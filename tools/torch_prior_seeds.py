#!/usr/bin/env python3
"""The seed spread of the corpus diffusion prior trained on one CUDA GPU.

    python3 tools/torch_prior_seeds.py --seed 1 [--clips 48] [--steps 24000]

Trains the port's corpus prior as
``audio_inpainting_torch.tools.train_diffusion_prior`` does (its
``build_corpus``, then ``train_spectrogram_ddpm`` on the default
DiffusionConfig with ``train_steps=--steps``), but from the key ``--seed``
where the trainer hard-codes 0, and evaluates it by the trainer's protocol
(``eval_on_bench``: Part 2's synthetic clip through the int16 chain, its
centre 2 s zeroed, SNR, local SNR and LSD at the default fill ratio). The
prior is not written anywhere. Progress goes to standard error; the last
line of standard output is one JSON object. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from audio_inpainting_torch.device import resolve_device  # noqa: E402
from audio_inpainting_torch.methods.diffusion import (DiffusionConfig,  # noqa: E402
                                                      train_spectrogram_ddpm)
from audio_inpainting_torch.tools.train_diffusion_prior import (EVAL_SR,  # noqa: E402
                                                                build_corpus, eval_clip,
                                                                eval_on_bench, loss_curve)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="tools/torch_prior_seeds.py")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--steps", type=int, default=24000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = DiffusionConfig(train_steps=args.steps)
    images, masks = build_corpus(args.clips, EVAL_SR, dev)
    runs = []
    t0 = time.time()
    params = train_spectrogram_ddpm(images, cfg, key=args.seed, masks_u8=masks, device=dev,
                                    losses=runs)
    losses = torch.cat(runs).cpu()         # waits for the last step
    wall = time.time() - t0
    print(f"[train] key {args.seed}: {args.steps} steps on {len(images)} images in "
          f"{wall:.1f}s", file=sys.stderr)
    res = eval_on_bench(params, cfg, f"key={args.seed}", eval_clip(None), dev)
    print(json.dumps({"seed": args.seed, "clips": args.clips, "images": len(images),
                      "steps": args.steps, "train_wall_s": wall,
                      "ms_per_step": 1e3 * wall / max(args.steps, 1),
                      "loss_curve": loss_curve(losses), "eval": res,
                      "device": str(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
