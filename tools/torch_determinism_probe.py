#!/usr/bin/env python3
"""Whether the port's seeded neural training repeats itself on one CUDA GPU,
what in it does not, and what cuDNN's deterministic algorithms cost.

    python3 tools/torch_determinism_probe.py              # every part
    python3 tools/torch_determinism_probe.py restore stream  # some parts

The package runs cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic``, set when it is imported). Each
part sets the flag itself, ``free`` (False: cuDNN picks its algorithms by
its heuristics, as before the package set it) and ``deterministic``
(True), and restores the package's value after.

- ``restore``: ``restore(damaged, sr, method="unet", seed=0)`` (400 fp32
  epochs) and ``method="gan"`` (300 fp32 epochs, the clean clip as the
  original) twice each, on chip_smoke.py's 10 s facade clip: whether the
  two runs give the same bytes, their max abs difference and the SNR of one
  against the other.
- ``stream``: the port bench's persistent U-Net stream program (a 30 s
  tile, three 300 ms gaps, 400 cold and 100 adapt epochs, after
  ``warmup(max_gap_s=0.5)``), fed ``sr // 10`` and ``sr`` chunks: whether
  the bytes are equal, and the warm realtime factor.
- ``ops``: in a child process with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``,
  under ``torch.use_deterministic_algorithms(True, warn_only=True)``, every
  operation that PyTorch reports as having no deterministic implementation
  in one U-Net fp32, one U-Net bf16 and one GAN bf16 epoch at (516, 1728),
  one diffusion training step (batch 8 x 128^2), and 2-epoch facade U-Net
  and GAN restores. That mode also forces cuDNN's deterministic choice, so
  it names the operations outside cuDNN. Each case then runs again in the
  mode from its start, and its losses (two epochs of a fresh trainer) or
  output are compared with the first run's.
- ``cost``: ms per call by CUDA events with the flag off and on, in turns
  (free, deterministic, deterministic, free): the U-Net fp32 and bf16 and
  the GAN bf16 epochs at (516, 1728), the same three as one grouped net of
  G = 4 clips, the DDIM step and the training step of the diffusion U-Net
  at (1028, 864) and 8 x 128^2, and the full-width SD-v1 UNet's CFG forward
  (2 x 4 x 64^2 latents, default-initialised weights).
- ``profile``: the top device kernels of five U-Net epochs at (516, 1728),
  fp32 and bf16, with the flag off and on.

Each part prints one JSON line; the last line is the card's name and power
limit. It needs a GPU; it imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from audio_inpainting_torch.io import load_mono_normalized  # noqa: E402
from audio_inpainting_torch.tools import bench  # noqa: E402

PARTS = ("restore", "stream", "ops", "cost", "profile")
STATES = {"free": False, "deterministic": True}


def run_with(deterministic: bool, fn):
    """``fn()`` with cuDNN's deterministic flag set as given."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = old


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return {"equal": bool(np.array_equal(a, b)), "max_abs_diff": float(diff.max()),
            "snr_db": cs.agreement_snr_db(torch.as_tensor(a), torch.as_tensor(b))}


def part_restore(dev) -> dict:
    from audio_inpainting_torch import restore

    with tempfile.TemporaryDirectory() as tmp:
        clean, damaged = cs.damaged_clip(Path(tmp))
    out = {}
    for state, det in STATES.items():
        for method, kw in (("unet", {}), ("gan", {"epochs": 300, "original": clean})):
            runs, walls = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                runs.append(run_with(det, lambda: restore(damaged, cs.SR, method=method,
                                                          seed=0, **kw)))
                walls.append(time.perf_counter() - t0)
            out[f"{method}_{state}"] = {**compare(*runs), "wall_s": walls}
    return out


def part_stream(dev) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        sr, clip = load_mono_normalized(bench.bench_input(tmp)[0])
    damaged, spans = bench.unet_stream_program(clip, sr)
    out = {}
    for state, det in STATES.items():
        a, _ = run_with(det, lambda: bench.stream_pass(damaged, sr, sr // 10, dev, "unet"))
        b, wall = run_with(det, lambda: bench.stream_pass(damaged, sr, sr, dev, "unet"))
        out[state] = {**compare(a, b), "rtf_warm": len(damaged) / sr / wall,
                      "feed_wall_s": wall}
    return out


def neural_trainers(dev, groups: int = 1) -> dict:
    """Fresh U-Net fp32, U-Net bf16 and GAN bf16 trainers on Part 1's
    spectrogram (groups=1) or on G serve-corpus spectrograms."""
    from audio_inpainting_torch.methods import neural

    if groups == 1:
        mag, mask = (t.to(dev) for t in cs.part1_spectrogram())
        seed = 0
    else:
        mag, mask = (t.to(dev) for t in cs.corpus_spectrograms(groups))
        seed = list(range(groups))
    return {
        "unet_fp32": lambda: neural.UNetTrainer(mag, mask, neural.UNetTrainConfig(bf16=False),
                                                seed),
        "unet_bf16": lambda: neural.UNetTrainer(mag, mask, neural.UNetTrainConfig(bf16=True),
                                                seed),
        "gan_bf16": lambda: neural.GANTrainer(
            *cs.gan_inputs(mag, mask), neural.GANTrainConfig(
                bf16=True, ema_decay=0.99, ema_scope="gap"), seed)}


def diffusion_parts(dev) -> dict:
    """The diffusion U-Net's DDIM sampler with the committed prior at
    Part 2's (1028, 864), and a training step at batch 8 x 128^2."""
    from audio_inpainting_torch.methods import diffusion as diff
    from audio_inpainting_torch.utils import load_params

    _, img_u8, mask_u8, _, _ = cs.diffusion_image()
    pad = ((0, -img_u8.shape[0] % 4), (0, -img_u8.shape[1] % 4))
    full = torch.tensor(np.pad(img_u8, pad), dtype=torch.float32, device=dev) / 127.5 - 1.0
    keep = torch.tensor(np.pad(mask_u8 == 0, pad), dtype=torch.float32, device=dev)
    prior = diff.new_model(load_params(diff.PRIOR_DIR, dev), 32, dev)
    cfg = diff.DiffusionConfig()
    tmodel = diff.new_model(diff._draw_init(0, "clip", 32), 32, dev)
    opt = diff._adam_for(tmodel, cfg)
    counter = itertools.count()

    def train():
        i = next(counter)
        return diff.train_steps(tmodel, opt, full, keep, cfg, 0, "clip", range(i, i + 1))

    return {"ddim": lambda steps: diff.ddim_repaint(
                prior, full, keep, 0, diff.DiffusionConfig(sample_steps=steps)),
            "train": train}


def part_ops(dev) -> dict:
    """Runs in a child process (the cuBLAS workspace setting and the
    deterministic mode stay out of the other parts)."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        done = subprocess.run([sys.executable, __file__, "ops-child"], env=env,
                              capture_output=True, text=True)
        sys.stderr.write(done.stderr[-4000:])
        if done.returncode:
            raise RuntimeError(f"the ops child exited {done.returncode}")
        return json.loads(done.stdout.strip().splitlines()[-1])
    from audio_inpainting_torch import restore

    trainers = neural_trainers(dev)
    dparts = diffusion_parts(dev)
    with tempfile.TemporaryDirectory() as tmp:
        clean, damaged = cs.damaged_clip(Path(tmp))

    def loss_of(x):
        x = x if isinstance(x, tuple) else (x,)
        return [float(v.float().sum()) for v in x]

    def two_epochs(make):
        """A fresh trainer's losses over two epochs: the second's depend on
        the first's backward."""
        trainer = make()
        return loss_of(trainer.epoch()) + loss_of(trainer.epoch())

    cases = {name: (lambda make=make: two_epochs(make)) for name, make in trainers.items()}
    cases["diffusion_train_step"] = lambda: loss_of(dparts["train"]())
    cases["restore_unet_2_epochs"] = lambda: [float(np.abs(restore(
        damaged, cs.SR, method="unet", seed=0, epochs=2)).sum())]
    cases["restore_gan_2_epochs"] = lambda: [float(np.abs(restore(
        damaged, cs.SR, method="gan", seed=0, epochs=2, original=clean)).sum())]
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        for name, fn in cases.items():
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                first = fn()
                torch.cuda.synchronize()
            second = fn()
            msgs = sorted({str(w.message).split("\n")[0][:200] for w in seen
                           if "deterministic" in str(w.message)})
            # the diffusion step's model carries on: no rerun to compare
            out[name] = {"nondeterministic_ops": msgs,
                         "rerun_equal": None if name == "diffusion_train_step"
                         else first == second}
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def part_cost(dev) -> dict:
    from audio_inpainting_torch.models import sd

    made = {}
    for g in (1, 4):
        for name, make in neural_trainers(dev, g).items():
            trainer = make()
            for _ in range(3):
                trainer.epoch()
            made[f"{name}_G{g}"] = trainer
    dparts = diffusion_parts(dev)
    dparts["train"]()
    dparts["ddim"](2)
    with torch.device(dev):
        unet = sd.UNet2DCondition(sd.UNetConfig()).eval()
    g = torch.Generator().manual_seed(0)
    x2 = torch.randn((2, 4, 64, 64), generator=g).to(dev)
    t2 = torch.full((2,), 501.0, device=dev)
    ctx = torch.randn((2, cs.SD_CTX_LEN, sd.UNetConfig().cross_attention_dim),
                      generator=g).to(dev)

    def sd_forward():
        with torch.no_grad():
            unet(x2, t2, ctx)

    ddim_steps = 10
    timers = {**{f"{k}_epoch": (lambda t=t: t.epoch(), 10) for k, t in made.items()},
              "ddim_step": (lambda: dparts["ddim"](ddim_steps), 1),
              "diffusion_train_step": (dparts["train"], 10),
              "sd_cfg_forward": (sd_forward, 3)}
    rows = {k: {"free": [], "deterministic": []} for k in timers}
    for state in ("free", "deterministic", "deterministic", "free"):
        for name, (fn, calls) in timers.items():
            ms = run_with(STATES[state], lambda: cs.cuda_ms(fn, calls=calls, rounds=3))
            rows[name][state].append(ms / (ddim_steps if name == "ddim_step" else 1))
    for row in rows.values():
        row["ratio"] = float(np.median(row["deterministic"]) / np.median(row["free"]))
    return rows


def part_profile(dev) -> dict:
    """Where the deterministic algorithms cost: the top device kernels of
    five U-Net epochs at (516, 1728), fp32 and bf16, in each state."""
    out = {}
    for name, make in neural_trainers(dev).items():
        if name == "gan_bf16":
            continue
        trainer = make()
        for state, det in STATES.items():
            for _ in range(3):
                run_with(det, trainer.epoch)
            prof = run_with(det, lambda: cs.device_profile(
                lambda: [trainer.epoch() for _ in range(5)], top=8, kernel="conv"))
            out[f"{name}_{state}"] = {"device_busy_ms_per_epoch": prof["device_busy_ms"] / 5,
                                      "top": prof["top"]}
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_determinism_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if argv == ["ops-child"]:
        print(json.dumps(part_ops(dev)))
        return 0
    for part in argv or PARTS:
        t0 = time.perf_counter()
        res = globals()[f"part_{part}"](dev)
        print(json.dumps({"part": part, "s": time.perf_counter() - t0, **res}), flush=True)
    print(cs.gpu_name_and_power(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
