"""Multi-clip serving throughput on one GPU: the counterpart of the JAX
package's ``tools/serve_throughput.py``.

    python -m audio_inpainting_torch.tools.serve_throughput [epochs] [sizes...] [--device cuda]
    SERVE_METHOD=gan python -m audio_inpainting_torch.tools.serve_throughput [epochs] [sizes...]

It measures the batched per-clip path: B independent nets (the U-Net by
default, the GAN pair with ``SERVE_METHOD=gan``), one per clip, trained
as grouped nets and composited by ``parallel.batch.restore_clips_unet``
(fp32, the serve default) or ``parallel.gan_batch.restore_clips_gan``
(bf16), on Part 1's (513, 1723) spectrogram of a 10 s clip, from the JAX
tool's seeded inputs. Each batch size runs twice: a warm-up pass (cuDNN's
set-up, the allocator's first blocks; its wall goes to standard error),
then the measured pass. One JSON line per batch size: the JAX tool's
``method``, ``batch``, ``epochs``, ``wall_s``, ``clips_per_s`` and
``rtf`` (seconds of audio restored per second of wall), plus ``groups``
(the group sizes ``clip_groups`` gives at the call's start: on the card a
batch splits by memory) and ``device``.

The JAX tool's ``projected_8chip_clips_per_s`` is left out: it multiplied
one chip's rate by 8, which is a multiplication, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..methods.neural import GANTrainConfig, UNetTrainConfig
from ..parallel.batch import clip_bytes, clip_groups, restore_clips_unet
from ..parallel.gan_batch import restore_clips_gan
from .bench import device_label

# Part 1's magnitude of a 10 s clip at 44.1 kHz: 1,723 STFT columns
PART1_SHAPE = (513, 1723)
PART1_SECONDS = 10.0


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(method: str, epochs: int, sizes, f: int, t: int, device) -> list[dict]:
    """Serve batches of ``sizes`` clips of (f, t) with ``method`` ("unet"
    or "gan") for ``epochs`` epochs; prints and returns one row a size.
    A clip of t columns holds PART1_SECONDS * t / 1723 s of audio."""
    dev = resolve_device(device)
    clip_seconds = PART1_SECONDS * t / PART1_SHAPE[1]
    label = device_label(dev)
    rng = np.random.RandomState(0)
    rows = []
    for n in sizes:
        for tag in ("warmup", "steady"):
            if method == "gan":
                real = (rng.rand(n, f, t) * 2 - 1).astype(np.float32)
                msk = (rng.rand(n, f, t).astype(np.float32) > 0.2).astype(np.float32)
                norm = real * msk - (1 - msk)
                cfg = GANTrainConfig(epochs=epochs, bf16=True)
                args = (norm, real, msk, cfg)
                serve = restore_clips_gan
            else:
                mag = rng.rand(n, f, t, 1).astype(np.float32)
                msk = (rng.rand(n, f, t, 1).astype(np.float32) > 0.3).astype(np.float32)
                cfg = UNetTrainConfig(epochs=epochs)
                args = (mag, msk, cfg)
                serve = restore_clips_unet
            groups = [g.stop - g.start for g in clip_groups(
                n, clip_bytes(method, cfg.bf16, f, t), dev)]
            _synchronize(dev)
            t0 = time.perf_counter()
            restored, _ = serve(*args, device=dev)
            float(restored.sum())                  # the result on the host
            wall = time.perf_counter() - t0
            if tag == "warmup":
                print(f"[warmup] batch={n} {wall:.1f}s", file=sys.stderr)
                continue
            row = {"method": method, "batch": n, "epochs": epochs, "wall_s": wall,
                   "clips_per_s": n / wall, "rtf": n * clip_seconds / wall,
                   "groups": groups, "device": label}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m audio_inpainting_torch.tools.serve_throughput")
    ap.add_argument("epochs", nargs="?", type=int, default=400)
    ap.add_argument("sizes", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(os.environ.get("SERVE_METHOD", "unet"), args.epochs, args.sizes or [1, 2, 4, 8],
        *PART1_SHAPE, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
