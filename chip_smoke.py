#!/usr/bin/env python3
"""Smoke test of audio_inpainting_torch on one CUDA GPU (an H100 here).

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py multi      # phase multi alone, no result lines
    python3 chip_smoke.py prior      # phase prior alone, no result lines

It builds the port's CUDA kernel from csrc/, holds it against its plain
torch version at the shapes the restore path gives it, times both, then
drives the port's paths: the masked NMF at Part 1's and Part 0's shapes
(GPU against CPU), the U-Net and GAN training loops (GPU against CPU on a
cropped spectrogram, then epochs timed and profiled at Part 1's full
(513, 1723)), the diffusion method (the committed prior; Griffin-Lim at
Part 2's full (1025, 862), the U-Net forward, training and DDIM steps GPU
against CPU on a crop, then timed and profiled at the full (1028, 864)),
the ``restore`` facade (ar, nmf, unet, gan and diffusion on a 10 s, 44.1
kHz clip with Part-1-style dropouts, gp on a 0.05 s segment), the Part 1
pipeline, the Part 2 / Part 0 pipelines, the windowed engine (ar over a
60 s clip, window by window and batched per window class), the
streaming engine (linear, ar and the persistent U-Net fed 4,096-sample
chunks) and the corpus path (phase ``serve``: ``run_serve`` over four
10 s clips with ar, the U-Net and the GAN, the batched per-clip trainers
against single clips and timed against the group size, the U-Net's
window batch, and the live HTTP API) and Stable Diffusion v1 / Riffusion
at full width (phase ``riffusion``: seeded random weights written as
safetensors and loaded by ``load_riffusion``, held to the SD-v1 key
manifest, ``riffusion_restore_audio`` on Part 2's clip at 512^2 with 50
PLMS steps and CFG 7.5, the UNet, VAE and loop timed beside their FLOP
bounds, GPU against CPU) and the multi-device layer (phase ``multi``: one
rank on NCCL, two and four ranks sharing the card over gloo, spawned by
``parallel.launch``; the shared U-Net at (4, 516, 1728) and, on a 2 x 2
mesh, on two 60 s spectrograms; the per-clip U-Nets and GANs, the 60 s
clip's AR window classes, GP restarts, the frame-parallel STFT and
serve's rank body over the ranks, each against one rank; on two cards,
the same on NCCL and run_serve(devices=2)). Each phase prints one JSON line;
any failed check raises. The last three lines are the kernel table,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.

It exits non-zero, and prints no result, without a CUDA device or outside
a checkout of the repository. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.server
import io
import itertools
import json
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SR = 44100
# the bound the CPU tests hold the port's NMF to against the JAX package
# (tests/test_torch_nmf.py): filled columns within 1e-5 of their peak
NMF_RTOL_OF_PEAK = 1e-5
# local SNR a GP restoration may fall short of its reference by, in dB
# (tests/test_torch_gp.py, tests/test_torch_part1.py)
GP_MARGIN_DB = 3.0
# pipeline metrics of the GPU run against the CPU run with the same draws
DB_TOL = 0.05
# the neural loops, GPU against CPU from the same init, fp32 with TF32 off:
# the CPU tests' bounds against the JAX package (tests/test_torch_neural.py).
# cuDNN's convolutions sum in another order than the CPU's (the backward
# not deterministically); the GAN's eval-mode readout reads the
# pre-BatchNorm conv biases, whose gradient is zero up to rounding and
# whose Adam steps are therefore rounding noise scaled up to lr
NEURAL_LOSS_RTOL = 1e-4
UNET_COMPOSITE_TOL = 1e-4      # of the composite's peak
GAN_COMPOSITE_TOL = 1e-3
# the facade's neural legs: unet at its default 400 epochs; gan cut from
# its default 1500 to 300 epochs (~7 s of fp32 epochs instead of ~34 s),
# so the smoke stays near 300 s: Part 2's GAN leg already runs 1500
# epochs, twice when its retry fires
FACADE_UNET_EPOCHS = 400
FACADE_GAN_EPOCHS = 300
# the diffusion method, GPU against CPU from the same draws: the CPU
# tests' bounds against the JAX package (tests/test_torch_diffusion.py)
GL_AGREEMENT_DB = 80.0
DIFF_FORWARD_RTOL = 1e-5       # of the output's peak
DIFF_LOSS_RTOL = 1e-5
DIFF_PARAM_ATOL = 2e-5
DDIM_ATOL = 5e-5
# the facade's diffusion: per-clip training at its default step count
FACADE_DIFFUSION_STEPS = 1500
# the windowed and streaming engines: a 60 s clip, 2 s windows, the
# facade's 50-sample composite margin. GPU against CPU by the facade's
# agreement bound. Batched against window by window: a window restored as
# a batch of one is bit-equal to its facade call, and the kernel's rows
# do not depend on the batch, but the fit of a window's rows moves in the
# last bits with the batch size (phase windowed shows each), and the
# recurrence carries that. The bounds sit 4x and 7.7 dB outside the
# reading on an H100 (2.58e-4 of peak, 87.7 dB)
ENGINE_SECONDS = 60.0
WINDOW_S = 2.0
MARGIN = 50
AR_AGREEMENT_DB = 60.0
BATCH_ERR_OF_PEAK = 1e-3
BATCH_AGREEMENT_DB = 80.0
ENGINE_CPU_SECONDS = 10.0
STREAM_CHUNK = 4096
UNET_STREAM_SECONDS = 20.0
# the corpus path: four 10 s clips at 44.1 kHz, (513, 1723) magnitudes
# padded to (516, 1728), the full U-Net and GAN; the GAN at 300 of its
# 1500 epochs, as the facade's (FACADE_GAN_EPOCHS). Group sizes of the
# epoch sweep: the GAN's bf16 epoch at G = 8 would hold ~11 GB.
#
# Batch against single: the CPU tests' bounds against the JAX package
# (NEURAL_LOSS_RTOL, UNET_COMPOSITE_TOL, GAN_COMPOSITE_TOL; a bf16 GAN fill
# 1 dB, ROADMAP Queue 3; the U-Net window batch 60 dB), held at the
# CPU tests' epochs (U-Net 10, GAN 5: tests/test_torch_neural.py), with
# cuDNN's deterministic kernels. Training amplifies rounding: the grouped
# and the plain kernels round differently, and cuDNN's default kernels
# differ from run to run, so over longer runs the single path parts from
# a rerun of itself (tools/torch_batch_spread.py measures that spread).
# The serve GAN's 300 epochs and the window batch's 100 run with the
# default kernels and are printed. Each grouped epoch's peak memory is
# held under the footprint that sizes the groups (parallel/batch.py,
# clip_bytes).
SERVE_CLIPS = 4
SERVE_UNET_EPOCHS = 400
SERVE_GAN_EPOCHS = 300
BF16_GAN_FILL_DB = 1.0
UNET_HELD_EPOCHS = 10
GAN_HELD_EPOCHS = 5
BATCH_VS_SINGLE_CLIPS = (0, 3)
UNET_GROUP_SIZES = (1, 2, 4, 8)
GAN_GROUP_SIZES = (1, 2, 4)
WINDOW_BATCH_SECONDS = 20.0
WINDOW_BATCH_EPOCHS = 100
WINDOW_BATCH_AGREEMENT_DB = 60.0
# phase riffusion: SD v1 at full width on random weights made from a seed
SD_SEED = 0
SD_STEPS = 50                  # the reference's num_inference_steps
SD_CANVAS = 512                # the reference's resize
SD_CTX_LEN = 77                # CLIP's context length
SD_FORWARD_RTOL = 1e-4         # GPU vs CPU, of the output's peak
SD_LATENT_RTOL = 1e-4          # the tiny inpaint's latents, of their peak
SD_VS_CPU_CANVAS = 256         # the VAE's GPU-vs-CPU size
SD_PROFILE_STEPS = 10          # the profiled loop: 11 evaluations
# phase prior (the corpus-prior trainer)
PRIOR_CLIPS = 4                # 6 full-size images with the corrupted variants
PRIOR_STEPS = 500
PRIOR_LOSS_WINDOW = 100        # the last steps' mean loss below the first's
PRIOR_VS_CPU_STEPS = 3
PRIOR_TRACE_STEPS = 10
# phase multi (the multi-device layer)
MULTI_SHAPE = (4, 516, 1728)   # mode 1: the shared U-Net's batch
MULTI_STEPS = 3
MULTI_UNET_EPOCHS = 20         # modes 2 and 5 on the serve corpus
MULTI_GAN_EPOCHS = 20
MULTI_SPATIAL_STEPS = 2        # mode 3 on two 60 s spectrograms
RANKS_ATOL = 1e-5              # ranks against one rank (of peak for outputs)
GP_RANKS_ATOL = 5e-5
GP_THETA_RTOL = 1e-4           # the ranks' winner against one rank's
STFT_RTOL_OF_PEAK = 1e-4
MULTI_DEVICE = "cuda:0"        # the card the gloo ranks share


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, calls: int, rounds: int = 5, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current stream: CUDA events
    around ``calls`` back-to-back calls, the median of ``rounds`` rounds.
    Each round first queues a spin of about 1 ms per call on the device,
    so the host has queued the calls before the device reaches them: a
    call whose device work is shorter than its host overhead is timed by
    its device work. A call whose host side takes longer than that is
    timed by its host side, as it runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000 * calls)   # ~1 ms per call at ~2 GHz
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def union_ms(intervals) -> float:
    """The length of the union of (start, end) intervals in µs, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def device_profile(fn, top: int = 8, kernel: str = "ar_scan") -> dict:
    """torch.profiler over one call of ``fn``: device busy time (the union
    of the device entries' intervals: cuDNN runs some kernels side by side
    on its own streams, so their sum, ``device_sum_ms``, may pass the
    wall), the wall time, the number of device calls (kernels, copies),
    the ``top`` device entries by self time, and the device time of the
    entries whose name holds ``kernel``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): an operator's own entry
    # would count its kernels' time a second time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    sum_ms = sum(e.self_device_time_total for e in events) / 1e3
    busy_ms = union_ms((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    kernel_ms = sum(e.self_device_time_total for e in events if kernel in e.key) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_sum_ms": sum_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_calls": sum(e.count for e in events),
            "kernel_device_ms": kernel_ms,
            "kernel_share_of_busy": kernel_ms / busy_ms if busy_ms else None,
            "top": [{"name": e.key[:60], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in events[:top]]}


def agreement_snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    err = float(((ref - got) ** 2).sum())
    return float(10 * np.log10(float((ref ** 2).sum()) / max(err, 1e-300)))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| as a share of max |want|, on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def bound_ms(B: int, p: int, steps: int) -> tuple[float, str]:
    """Least time for the recurrence's work: FLOPs over the fp32 peak or
    bytes (eps in, out, parameters) over HBM bandwidth, the larger."""
    flops = 2.0 * B * p * steps
    nbytes = 4.0 * B * steps * 2 + 4.0 * B * (2 * p + 3)
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def small_inputs(B, p, steps, dev):
    """The inputs of tests/test_pallas_ar.py, made from a numpy seed (w
    scaled down past order 128, as in tests/test_torch_ar_scan_cuda.py)."""
    rng = np.random.RandomState(B + p)
    arrays = [rng.randn(B, p) * (0.01 if p > 128 else 0.05), rng.randn(B) * 0.01,
              np.abs(rng.randn(B)) * 0.1, (rng.rand(B) > 0.2) * 1.0,
              rng.randn(B, p), rng.randn(B, steps)]
    w, b, std, gain, state0, eps = (torch.as_tensor(a.astype(np.float32), device=dev)
                                    for a in arrays)
    return state0, w, b, std, gain, eps


def fitted_inputs(n_gaps, p, context_len, steps, dev, seed):
    """Recurrence inputs as the restore path makes them: Ridge fits on
    contexts of a synthetic music clip, eps a seeded standard normal."""
    from audio_inpainting_torch.corrupt import synth_music_clip
    from audio_inpainting_torch.methods import ar

    clip = torch.as_tensor(synth_music_clip(seed, SR, 10.0), device=dev)
    n = clip.shape[0]
    starts = torch.linspace(context_len, n - context_len - steps, n_gaps,
                            device=dev).long()
    cfg = ar.ARConfig(order=p, alpha=0.5, context_len=context_len)
    ctxs, pads = ar._extract_contexts(clip, starts, starts + steps, context_len)
    w, b, std, valid = ar._fit_ridge_batched(ctxs, pads, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    eps = torch.randn((steps, 2 * n_gaps), generator=gen, device=dev)
    return ctxs, w, b, std, valid, eps


def phase_env(dev):
    from audio_inpainting_torch.kernels import build

    t0 = time.perf_counter()
    so = build.build("ar_scan")
    build_s = time.perf_counter() - t0
    log = so.with_suffix(".log").read_text().splitlines()
    emit({"phase": "env", "gpu": gpu_name_and_power(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(dev),
          "kernel_build_s": build_s,
          "ptxas": [line.strip() for line in log if "Used" in line]})


def phase_kernel(dev):
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.ops import ar_scan

    rows = []
    for B, p, steps in [(5, 30, 300), (2, 100, 700), (9, 7, 129), (3, 200, 500)]:
        args = small_inputs(B, p, steps, dev)
        got = ar_scan.ar_extrapolate(*args, steps)
        torch.cuda.synchronize()
        err = float((got - ar_scan.ar_extrapolate_ref(*args, steps)).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"kernel vs plain at {(B, p, steps)}: {err} > 1e-4")
        rows.append({"B": B, "p": p, "steps": steps, "max_abs_err": err,
                     "tolerance": "atol 1e-4"})

    # the facade's shape (~736 rows of order 30, ~1024 steps), Part 2's
    # (2 rows of order 100, 88,200 steps) and Part 0's (2 rows of order 30,
    # 441 steps, 882-sample contexts), on fitted models
    for path, n_gaps, p, context_len, steps, plain_reps in [
            ("facade", 368, 30, 1000, 1024, 10), ("part2", 1, 100, 5000, 88200, 1),
            ("part0", 1, 30, 882, 441, 5)]:
        ctxs, w, b, std, valid, eps_tb = fitted_inputs(n_gaps, p, context_len,
                                                       steps, dev, seed=0)
        B = 2 * n_gaps
        state0 = ar._state0(ctxs, p).contiguous()
        gain = valid.to(torch.float32)
        eps = eps_tb.T.contiguous()
        args = (state0, w, b, std, gain, eps, steps)
        got = ar_scan.ar_extrapolate(*args)
        torch.cuda.synchronize()
        plain_times = []
        for _ in range(plain_reps):
            t0 = time.perf_counter()
            ref = ar_scan.ar_extrapolate_ref(*args)
            torch.cuda.synchronize()
            plain_times.append((time.perf_counter() - t0) * 1e3)
        snr = agreement_snr_db(ref, got)
        if not snr >= 60.0:
            raise AssertionError(f"kernel vs plain at {(B, p, steps)}: "
                                 f"agreement {snr} dB < 60 dB")
        chunked = ar._extrapolate_chunked(ctxs, w, b, std, valid, eps_tb, steps, 128)
        torch.cuda.synchronize()
        bms, bound_by = bound_ms(B, p, steps)
        rows.append({
            "path": path, "B": B, "p": p, "steps": steps,
            "tolerance": "agreement SNR >= 60 dB",
            "agreement_snr_db": snr,
            "max_abs_err": float((got - ref).abs().max()),
            "chunked_agreement_snr_db": agreement_snr_db(ref, chunked),
            "ms": cuda_ms(lambda: ar_scan.ar_extrapolate(*args), calls=10),
            "plain_ms": float(np.median(plain_times)), "plain_runs": plain_reps,
            "chunked_ms": cuda_ms(lambda: ar._extrapolate_chunked(
                ctxs, w, b, std, valid, eps_tb, steps, 128), calls=2),
            "bound_ms": bms, "bound_by": bound_by})
    emit({"phase": "kernel", "shapes": rows})
    return rows


def damaged_clip(tmp: Path):
    """A 10 s synthetic clip with Part-1-style dropouts (ratio 0.25,
    50-400 samples), through the int16 WAV chain."""
    from audio_inpainting_torch.corrupt import random_dropout_mask, synth_music_clip
    from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16

    clean = synth_music_clip(0, SR, 10.0)
    mask = random_dropout_mask(torch.Generator().manual_seed(0), len(clean),
                               0.25, 50, 400).numpy()
    path = str(tmp / "damaged.wav")
    save_wav_int16(clean * mask, SR, path)
    return clean, load_mono_normalized(path)[1]


def diffusion_image():
    """Part 2's damaged clip as the diffusion codec sees it, on the CPU:
    (damaged (441000,), image (1025, 862) uint8, mask (255 = damaged),
    smin, smax)."""
    from audio_inpainting_torch.corrupt import center_gap_bounds, synth_music_clip
    from audio_inpainting_torch.methods import diffusion as diff

    damaged = synth_music_clip(1, SR, 10.0)
    gs, ge = center_gap_bounds(len(damaged), SR)
    damaged[gs:ge] = 0.0
    img, smin, smax = diff.logspec_to_image(
        diff.wav_to_logspec(torch.tensor(damaged)).numpy())
    return damaged, img, diff.mask_from_image(img), smin, smax


def unet_macs(model, shape) -> int:
    """Multiply-accumulates of one forward of ``model`` at input ``shape``,
    from the shapes its convolutions and dense layers see (forward hooks);
    GroupNorm, SiLU and the adds are not counted."""
    from torch import nn

    from audio_inpainting_torch.models.unet import Conv

    total = 0

    def hook(mod, args, out):
        nonlocal total
        if isinstance(mod, Conv):            # weight (Co, Ci, k, k); transposed (Ci, Co, k, k)
            taps = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
            total += (args[0].numel() if mod.transpose else out.numel()) * taps
        else:
            total += out.numel() * mod.in_features

    dev = next(model.parameters()).device
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(shape, device=dev), torch.zeros(shape[0], device=dev))
    for h in handles:
        h.remove()
    return total


def flop_bound(flops: float, nbytes: float) -> dict:
    """The least time for ``flops`` fp32 operations moving ``nbytes``."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"gflop": flops / 1e9, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_diffusion(dev):
    """The diffusion method with the committed prior. GPU against CPU with
    the same draws: Griffin-Lim at Part 2's full (1025, 862); the U-Net
    forward, 3 training steps and 3 DDIM steps on a 172-column crop across
    the hole's edge. Then on the GPU at the full (1028, 864): one forward, the
    50-step sample and 10-step profile, training steps at batch 8 x 128^2,
    Griffin-Lim; each with its FLOP bound."""
    from audio_inpainting_torch.methods import diffusion as diff
    from audio_inpainting_torch.ops.griffin_lim import griffin_lim
    from audio_inpainting_torch.utils import load_params

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prior = load_params(diff.PRIOR_DIR, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prior_cpu = {k: v.cpu() for k, v in prior.items()}
    n_params = sum(v.numel() for v in prior_cpu.values())
    damaged, img_u8, mask_u8, smin, smax = diffusion_image()
    linear = diff.image_to_linear_spec(img_u8, smin, smax)
    n = len(damaged)

    # Griffin-Lim, 32 iterations at full size
    gl_gpu = griffin_lim(linear, length=n, seed=0, device=dev)
    t0 = time.perf_counter()
    gl_cpu = griffin_lim(linear, length=n, seed=0, device="cpu")
    gl_cpu_ms = (time.perf_counter() - t0) * 1e3
    gl = {"shape": list(linear.shape), "n_iter": 32,
          "agreement_snr_db": agreement_snr_db(gl_cpu, gl_gpu.cpu()),
          "ms": cuda_ms(lambda: griffin_lim(linear, length=n, seed=0, device=dev),
                        calls=1, rounds=3),
          "cpu_ms": gl_cpu_ms,
          "profile": device_profile(lambda: griffin_lim(linear, length=n, seed=0,
                                                        device=dev), kernel="fft")}

    # a crop across the hole's left edge, half known and half hole, small
    # enough for the CPU
    bad = np.flatnonzero((mask_u8 == 255).mean(axis=0) > 0.95)
    c0 = int(bad.min()) - 86

    def as_input(u8):
        """Padded to multiples of 4, as diffusion_inpaint_image pads."""
        return np.pad(u8, ((0, -u8.shape[0] % 4), (0, -u8.shape[1] % 4)))

    img = torch.tensor(as_input(img_u8[:, c0:c0 + 172]), dtype=torch.float32) / 127.5 - 1.0
    keep = torch.tensor(as_input(mask_u8[:, c0:c0 + 172] == 0), dtype=torch.float32)
    t = torch.tensor([500.0])
    with torch.no_grad():
        fwd_err = rel_err(diff.new_model(prior, 32, dev)(img[None, None].to(dev), t.to(dev)),
                          diff.new_model(prior_cpu, 32, "cpu")(img[None, None], t))
    cfg = diff.DiffusionConfig()
    trained = []
    for d in (dev, torch.device("cpu")):
        model = diff.new_model(diff._draw_init(0, "clip", 32), 32, d)
        losses = diff.train_steps(model, diff._adam_for(model, cfg), img.to(d), keep.to(d),
                                  cfg, 0, "clip", range(3))
        trained.append((losses.cpu(), {k: v.cpu() for k, v in model.state_dict().items()}))
    (g_loss, g_state), (c_loss, c_state) = trained
    scfg = diff.DiffusionConfig(sample_steps=3)
    g_ddim = diff.ddim_repaint(diff.new_model(prior, 32, dev), img.to(dev), keep.to(dev), 0,
                               scfg)
    c_ddim = diff.ddim_repaint(diff.new_model(prior_cpu, 32, "cpu"), img, keep, 0, scfg)
    vs_cpu = {"crop": list(img.shape), "tolerance":
              f"Griffin-Lim >= {GL_AGREEMENT_DB:g} dB; forward within "
              f"{DIFF_FORWARD_RTOL:g} of its peak; 3 training steps: losses within "
              f"{DIFF_LOSS_RTOL:g} relative, parameters within {DIFF_PARAM_ATOL:g}; "
              f"3 DDIM steps within {DDIM_ATOL:g}",
              "griffin_lim_agreement_snr_db": gl["agreement_snr_db"],
              "forward_err_of_peak": fwd_err,
              "train_loss_rel_err": rel_err(g_loss, c_loss),
              "train_param_max_abs_err": max(float((v - c_state[k]).abs().max())
                                             for k, v in g_state.items()),
              "ddim_max_abs_err": float((g_ddim.cpu() - c_ddim).abs().max())}
    for key, ok in (("griffin_lim_agreement_snr_db",
                     vs_cpu["griffin_lim_agreement_snr_db"] >= GL_AGREEMENT_DB),
                    ("forward_err_of_peak", fwd_err <= DIFF_FORWARD_RTOL),
                    ("train_loss_rel_err", vs_cpu["train_loss_rel_err"] <= DIFF_LOSS_RTOL),
                    ("train_param_max_abs_err",
                     vs_cpu["train_param_max_abs_err"] <= DIFF_PARAM_ATOL),
                    ("ddim_max_abs_err", vs_cpu["ddim_max_abs_err"] <= DDIM_ATOL)):
        if not ok:
            raise AssertionError(f"diffusion GPU vs CPU: {key} {vs_cpu[key]}")

    # full size on the GPU: Part 2's image padded to (1028, 864)
    full = torch.tensor(as_input(img_u8), dtype=torch.float32, device=dev) / 127.5 - 1.0
    full_keep = torch.tensor(as_input(mask_u8 == 0), dtype=torch.float32, device=dev)
    model = diff.new_model(prior, 32, dev)
    x_full = full[None, None]
    t_full = torch.tensor([500.0], device=dev)
    fwd_macs = unet_macs(model, tuple(x_full.shape))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(x_full, t_full), calls=5, rounds=3)
    forward = {"shape": list(x_full.shape), "ms": fwd_ms, "gmac": fwd_macs / 1e9,
               **flop_bound(2.0 * fwd_macs, 4.0 * (2 * x_full.numel() + n_params))}
    forward["tflops"] = forward["gflop"] / fwd_ms

    sample_cfg = diff.DiffusionConfig()
    diff.ddim_repaint(model, full, full_keep, 0, diff.DiffusionConfig(sample_steps=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sample_ms = cuda_ms(lambda: diff.ddim_repaint(model, full, full_keep, 0, sample_cfg),
                        calls=1, rounds=3, warmup=0)
    out = diff.ddim_repaint(model, full, full_keep, 0, sample_cfg)
    if not bool(torch.isfinite(out).all()) or not torch.equal(out[full_keep == 1],
                                                              full[full_keep == 1]):
        raise AssertionError("DDIM sample is not finite or changed a known pixel")
    n_prof = 10
    prof = device_profile(lambda: diff.ddim_repaint(
        model, full, full_keep, 0, diff.DiffusionConfig(sample_steps=n_prof)),
        top=10, kernel="conv")
    step_ms = sample_ms / sample_cfg.sample_steps
    ddim = {"steps": sample_cfg.sample_steps, "sample_ms": sample_ms, "ms_per_step": step_ms,
            "device_calls_per_step": prof["device_calls"] / n_prof,
            "device_busy_ms_per_step": prof["device_busy_ms"] / n_prof,
            "device_idle_share": prof["device_idle_share"],
            "device_idle_share_unprofiled": 1.0 - prof["device_busy_ms"] / n_prof / step_ms,
            "top": prof["top"], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            **flop_bound(2.0 * fwd_macs * sample_cfg.sample_steps,
                         4.0 * (2 * x_full.numel() + n_params))}

    # per-clip training's step: batch 8 x 128^2 patches of the full image
    tmodel = diff.new_model(diff._draw_init(0, "clip", 32), 32, dev)
    opt = diff._adam_for(tmodel, cfg)
    counter = itertools.count()
    block = 20

    def steps(k):
        i = next(counter) * block
        return diff.train_steps(tmodel, opt, full, full_keep, cfg, 0, "clip", range(i, i + k))

    steps(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_ms = cuda_ms(lambda: steps(block), calls=1, rounds=3, warmup=0) / block
    prof = device_profile(lambda: steps(n_prof), top=10, kernel="conv")
    losses = steps(block)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("diffusion training: a loss is not finite")
    train_macs = unet_macs(tmodel, (cfg.batch, 1, cfg.patch, cfg.patch))
    train = {"batch": cfg.batch, "patch": cfg.patch, "ms_per_step": train_ms,
             "device_calls_per_step": prof["device_calls"] / n_prof,
             "device_busy_ms_per_step": prof["device_busy_ms"] / n_prof,
             "device_idle_share": prof["device_idle_share"],
             "device_idle_share_unprofiled": 1.0 - prof["device_busy_ms"] / n_prof / train_ms,
             "top": prof["top"], "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "forward_gmac": train_macs / 1e9,
             # forward and backward: about three forwards of work
             **flop_bound(3 * 2.0 * train_macs,
                          4.0 * (2 * cfg.batch * cfg.patch ** 2 + 4 * n_params))}
    emit({"phase": "diffusion", "prior": {"tensors": len(prior), "parameters": n_params,
                                         "load_s": load_s},
          "gpu_vs_cpu": vs_cpu, "griffin_lim": gl,
          "full_size": {"forward": forward, "ddim": ddim, "train_step": train}})


def phase_prior(dev, tmp: Path) -> int:
    """The corpus-prior trainer's path (audio_inpainting_torch/tools/
    train_diffusion_prior.py): ``build_corpus`` of PRIOR_CLIPS full-size
    clips, PRIOR_STEPS steps of ``train_spectrogram_ddpm`` at full width
    (finite losses, the last PRIOR_LOSS_WINDOW steps' mean below the
    first's), PRIOR_VS_CPU_STEPS steps GPU against CPU on the same draws
    (phase diffusion's bounds), ``save_params`` -> ``latest_checkpoint`` ->
    ``load_params`` bit-equal, and a ``device_trace`` of PRIOR_TRACE_STEPS
    steps that must write a trace holding kernels. Returns the CUDA
    kernel's launches on the path (none: the trainer has no hand kernel)."""
    from audio_inpainting_torch.methods import diffusion as diff
    from audio_inpainting_torch.ops import ar_scan
    from audio_inpainting_torch.tools.train_diffusion_prior import build_corpus, loss_curve
    from audio_inpainting_torch.utils import (Timer, device_trace, latest_checkpoint,
                                              load_params, save_params)

    ar_scan.LAUNCHES = 0
    timer = Timer()
    images, masks = build_corpus(PRIOR_CLIPS, SR, dev)
    corpus_s = timer.lap("corpus")
    cfg = diff.DiffusionConfig(train_steps=PRIOR_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    timer.lap("setup")
    state = diff.train_spectrogram_ddpm(images, cfg, key=0, masks_u8=masks, device=dev,
                                        losses=runs)
    train_s = timer.lap("train", runs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = ar_scan.LAUNCHES
    losses = torch.cat(runs).cpu()
    first = float(losses[:PRIOR_LOSS_WINDOW].mean())
    last = float(losses[-PRIOR_LOSS_WINDOW:].mean())
    if not (bool(torch.isfinite(losses).all()) and last < first):
        raise AssertionError(f"prior: losses not finite or not falling ({first} -> {last})")

    # the same draws on the CPU
    small = diff.DiffusionConfig(train_steps=PRIOR_VS_CPU_STEPS)
    got = []
    for d in (dev, torch.device("cpu")):
        runs_d = []
        st = diff.train_spectrogram_ddpm(images, small, key=0, masks_u8=masks, device=d,
                                         losses=runs_d)
        got.append((torch.cat(runs_d).cpu(), {k: v.cpu() for k, v in st.items()}))
    (g_loss, g_state), (c_loss, c_state) = got
    vs_cpu = {"steps": PRIOR_VS_CPU_STEPS, "loss_rel_err": rel_err(g_loss, c_loss),
              "param_max_abs_err": max(float((v - c_state[k]).abs().max())
                                       for k, v in g_state.items()),
              "tolerance": f"losses within {DIFF_LOSS_RTOL:g} relative, parameters "
                           f"within {DIFF_PARAM_ATOL:g}"}
    if not (vs_cpu["loss_rel_err"] <= DIFF_LOSS_RTOL
            and vs_cpu["param_max_abs_err"] <= DIFF_PARAM_ATOL):
        raise AssertionError(f"prior GPU vs CPU: {vs_cpu}")

    # the checkpoint round trip through the newest step's directory
    root = tmp / "prior_checkpoints"
    save_params(g_state, str(root / f"step_{PRIOR_VS_CPU_STEPS}"))
    saved = save_params(state, str(root / f"step_{PRIOR_STEPS}"))
    found = latest_checkpoint(str(root))
    back = load_params(found, dev)
    if found != saved or back.keys() != state.keys() or not all(
            torch.equal(back[k], v) for k, v in state.items()):
        raise AssertionError(f"prior: {found} did not give back the {saved} state")

    # a trace of a few steps
    trace_dir = tmp / "prior_trace"
    with device_trace(str(trace_dir)):
        diff.train_spectrogram_ddpm(images, diff.DiffusionConfig(train_steps=PRIOR_TRACE_STEPS),
                                    key=0, masks_u8=masks, device=dev)
        torch.cuda.synchronize()
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    kernels = sum(1 for f in traces for e in json.loads(f.read_text()).get("traceEvents", [])
                  if e.get("cat") == "kernel")
    if not traces or not kernels:
        raise AssertionError(f"prior: device_trace wrote {traces} with {kernels} kernels")
    emit({"phase": "prior", "gpu": gpu_name_and_power(), "clips": PRIOR_CLIPS,
          "images": [len(images), list(images[0].shape)], "corpus_s": corpus_s,
          "steps": PRIOR_STEPS, "batch": cfg.batch, "patch": cfg.patch,
          "base_channels": cfg.base_channels, "train_s": train_s,
          "ms_per_step": 1e3 * train_s / PRIOR_STEPS, "peak_memory_gb": peak_gb,
          "loss_first_mean": first, "loss_last_mean": last,
          "loss_curve_per_100": loss_curve(losses, PRIOR_LOSS_WINDOW),
          "gpu_vs_cpu": vs_cpu, "checkpoint": {"latest": Path(found).name, "bit_equal": True},
          "trace": {"files": [f.name for f in traces], "bytes": sum(f.stat().st_size
                                                                     for f in traces),
                    "kernels": kernels, "steps": PRIOR_TRACE_STEPS},
          "launches": launches})
    return launches


def seeded_sd_state(model, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Random float32 CPU weights for every entry of ``model``'s state dict
    (a meta-device model gives the keys and shapes): matrices and kernels
    normal at 1/sqrt(fan-in), norm weights near 1, biases small."""
    out = {}
    for key, ref in model.state_dict().items():
        a = torch.randn(ref.shape, generator=gen)
        if ref.ndim >= 2:
            a /= float(np.sqrt(ref[0].numel()))
        elif key.endswith("weight"):
            a = 1.0 + 0.05 * a
        else:
            a *= 0.02
        out[key] = a
    return out


def write_safetensors(path: Path, state: dict[str, torch.Tensor]) -> None:
    """``state`` (float32 CPU tensors) as a ``.safetensors`` file: an 8-byte
    little-endian header length, the JSON header padded to 8 bytes, then
    the raw buffers in header order."""
    header, offset = {}, 0
    for key, t in state.items():
        n = t.numel() * 4
        header[key] = {"dtype": "F32", "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in state.values():
            f.write(t.contiguous().numpy().tobytes())


class SmokeTokenizer:
    """Stands in for CLIP's tokenizer: SD_CTX_LEN ids per text."""

    model_max_length = SD_CTX_LEN

    def __call__(self, texts, **kw):
        return types.SimpleNamespace(input_ids=torch.zeros((len(texts), SD_CTX_LEN),
                                                           dtype=torch.long))


class SmokeTextEncoder:
    """Stands in for CLIP's text encoder, as tests/test_sd.py's does: a
    seeded normal context of the ids' shape (2, 77, dim)."""

    def __init__(self, dim: int):
        self.dim = dim

    def __call__(self, ids):
        ctx = np.random.default_rng(3).normal(size=(ids.shape[0], ids.shape[1], self.dim))
        return types.SimpleNamespace(last_hidden_state=torch.tensor(ctx, dtype=torch.float32))


def sd_macs(model, call) -> int:
    """Multiply-accumulates of ``call()`` through ``model``: its
    convolutions, dense layers and attention products (q k^T and p v),
    from the shapes they see (forward hooks). Norms, activations, the
    softmax and the adds are not counted."""
    from torch import nn

    from audio_inpainting_torch.models.sd.unet2d import Attention
    from audio_inpainting_torch.models.sd.vae import VAEAttention

    total = 0

    def hook(mod, args, out):
        nonlocal total
        if isinstance(mod, nn.Conv2d):
            total += out.numel() * mod.weight[0].numel()
        elif isinstance(mod, nn.Linear):
            total += out.numel() * mod.in_features
        elif isinstance(mod, Attention):
            ctx = args[1] if len(args) > 1 else args[0]
            total += 2 * args[0].shape[0] * args[0].shape[1] * ctx.shape[1] * mod.to_q.out_features
        else:                                   # VAEAttention: one head over H x W
            b, c, h, w = args[0].shape
            total += 2 * b * (h * w) ** 2 * c

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear, Attention, VAEAttention))]
    with torch.no_grad():
        call()
    for h in handles:
        h.remove()
    return total


def timed_bound(fn, model, call_bytes: float, calls: int = 3) -> dict:
    """``fn``'s device ms (CUDA events) beside its FLOP bound: 2 x its MACs
    over the fp32 peak, or the weights and ``call_bytes`` over HBM."""
    macs = sd_macs(model, fn)
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        ms = cuda_ms(fn, calls=calls, rounds=3)
    out = {"ms": ms, "gmac": macs / 1e9,
           **flop_bound(2.0 * macs, 4.0 * n_params + call_bytes)}
    out["tflops"] = out["gflop"] / ms
    return out


def phase_riffusion(dev, tmp: Path):
    """Stable Diffusion v1 / Riffusion at full width: seeded random weights
    written in the diffusers layout and loaded by ``load_riffusion``; their
    keys and shapes against the frozen SD-v1 manifest; then
    ``riffusion_restore_audio`` on Part 2's clip (512^2 canvas, 50 PLMS
    steps, CFG 7.5, float32), cold and warm, held to the composite
    contract; the UNet's CFG forward, the VAE and the 51-evaluation loop
    timed beside their FLOP bounds and profiled; GPU against CPU: one
    full-width UNet forward, the VAE at 256^2, and the tiny inpaint with
    the same draws."""
    from audio_inpainting_torch.corrupt import center_gap_bounds, synth_music_clip
    from audio_inpainting_torch.methods.diffusion import riffusion_restore_audio
    from audio_inpainting_torch.models import sd
    from audio_inpainting_torch.models.sd import pipeline
    from audio_inpainting_torch.ops import ar_scan

    # weights: written as safetensors, loaded through the entry point
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SD_SEED)
    root = tmp / "riffusion"
    n_params = {}
    for sub, cls, cfg in (("unet", sd.UNet2DCondition, sd.UNetConfig()),
                          ("vae", sd.AutoencoderKL, sd.VAEConfig())):
        with torch.device("meta"):
            model = cls(cfg)
        state = seeded_sd_state(model, gen)
        n_params[sub] = sum(t.numel() for t in state.values())
        write_safetensors(root / sub / "diffusion_pytorch_model.safetensors", state)
        del state
    make_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = sd.load_riffusion(str(root), load_text=False, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    unet, vae = bundle["unet_params"], bundle["vae_params"]
    with open(Path(__file__).resolve().parent / "tests" / "golden" / "sd_v1_manifest.json") as f:
        manifest = json.load(f)
    for name, model in (("unet", unet), ("vae", vae)):
        got = {k: list(v.shape) for k, v in model.state_dict().items()}
        if got != manifest[name]:
            raise AssertionError(f"{name}: state_dict keys/shapes differ from the manifest")
    ctx_dim = bundle["unet_cfg"].cross_attention_dim
    bundle.update(tokenizer=SmokeTokenizer(), text_encoder=SmokeTextEncoder(ctx_dim))

    # the full path on Part 2's clip, cold then warm
    damaged = synth_music_clip(1, SR, 10.0)
    gs, ge = center_gap_bounds(len(damaged), SR)
    damaged[gs:ge] = 0.0

    def restore():
        out = riffusion_restore_audio(damaged, SR, steps=SD_STEPS, bundle=bundle,
                                      image_size=SD_CANVAS, device=dev)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    restore()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ar_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    out = restore()
    warm_s = time.perf_counter() - t0
    launches = ar_scan.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if out.shape != damaged.shape or out.dtype != np.float32 or not np.isfinite(out).all():
        raise AssertionError("riffusion: output has the wrong shape or type, or is not finite")
    keep = np.ones(len(out), bool)
    keep[gs - 2048:ge + 2048] = False
    outside_err = float(np.abs(out[keep] - damaged[keep]).max())
    hole_peak = float(np.abs(out[gs + 2048:ge - 2048]).max())
    if outside_err > 1e-6 or not hole_peak > 1e-4:
        raise AssertionError(f"riffusion composite: outside error {outside_err}, "
                             f"hole peak {hole_peak}")

    # the layers at full width, each beside its bound
    lat = SD_CANVAS // 2 ** (len(bundle["vae_cfg"].block_out_channels) - 1)
    g = torch.Generator().manual_seed(SD_SEED + 1)
    x2 = torch.randn((2, 4, lat, lat), generator=g).to(dev)
    t2 = torch.full((2,), 501.0, device=dev)
    ctx = SmokeTextEncoder(ctx_dim)(torch.zeros(2, SD_CTX_LEN)).last_hidden_state.to(dev)
    img = (torch.rand((1, 3, SD_CANVAS, SD_CANVAS), generator=g) * 2 - 1).to(dev)
    z = torch.randn((1, 4, lat, lat), generator=g).to(dev)
    layers = {
        "unet_cfg_forward": timed_bound(lambda: unet(x2, t2, ctx), unet,
                                        4.0 * (2 * x2.numel() + ctx.numel())),
        "vae_encode": timed_bound(lambda: vae.encode(img), vae,
                                  4.0 * (img.numel() + 2 * z.numel())),
        "vae_decode": timed_bound(lambda: vae.decode(z), vae, 4.0 * (z.numel() + img.numel())),
    }
    layers["unet_cfg_forward"]["shape"] = [list(x2.shape), list(ctx.shape)]
    with torch.no_grad():
        layers["vae_decode"]["profile"] = device_profile(lambda: vae.decode(z), top=6,
                                                         kernel="RowwiseMoments")

    # the 51-evaluation loop, as the restore runs it, then profiled at 11
    cfg = sd.InpaintConfig(steps=SD_STEPS, unet=bundle["unet_cfg"], vae=bundle["vae_cfg"])
    init = torch.randn((1, 4, lat, lat), generator=g).to(dev)
    hole = torch.zeros((1, 1, lat, lat), device=dev)
    hole[..., lat // 3:2 * lat // 3] = 1.0
    pipeline._denoise_loop(unet, init, hole, ctx, 0, sd.InpaintConfig(
        steps=2, unet=cfg.unet, vae=cfg.vae))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline._denoise_loop(unet, init, hole, ctx, 0, cfg)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    prof = device_profile(lambda: pipeline._denoise_loop(unet, init, hole, ctx, 0, sd.InpaintConfig(
        steps=SD_PROFILE_STEPS, unet=cfg.unet, vae=cfg.vae)), top=10, kernel="RowwiseMoments")
    n_evals = SD_STEPS + 1
    loop = {"evaluations": n_evals, "wall_s": loop_s, "ms_per_evaluation": loop_s * 1e3 / n_evals,
            "profiled_evaluations": SD_PROFILE_STEPS + 1, "profile": prof,
            "bound_ms": layers["unet_cfg_forward"]["bound_ms"] * n_evals}

    vs_cpu = sd_vs_cpu(unet, vae, ctx, lat, g, dev)
    del bundle, unet, vae
    torch.cuda.empty_cache()
    emit({"phase": "riffusion", "gpu": gpu_name_and_power(),
          "weights": {"parameters": n_params, "make_and_write_s": make_s, "load_s": load_s,
                      "manifest": "equal"},
          "restore": {"samples": len(out), "gap": [gs, ge], "steps": SD_STEPS,
                      "canvas": SD_CANVAS, "guidance_scale": cfg.guidance_scale,
                      "cold_s": cold_s, "warm_s": warm_s, "peak_memory_gb": peak_gb,
                      "outside_max_abs_err": outside_err, "hole_peak": hole_peak,
                      "kernel_launches": launches},
          "layers": layers, "loop": loop, "gpu_vs_cpu": vs_cpu})
    return launches


def sd_vs_cpu(unet, vae, ctx, lat: int, g: torch.Generator, dev) -> dict:
    """GPU against CPU with the same weights and inputs: one full-width UNet
    forward (batch 1), the VAE's encode and decode at SD_VS_CPU_CANVAS^2,
    and riffusion_inpaint_image at tiny() width, 4 steps, the same draws."""
    from audio_inpainting_torch.models import sd
    from audio_inpainting_torch.models.sd import pipeline

    def cpu_copy(model):
        return sd.load_module(type(model), model.cfg,
                              {k: v.cpu() for k, v in model.state_dict().items()}, "cpu")

    x = torch.randn((1, 4, lat, lat), generator=g)
    t = torch.tensor([501.0])
    img = torch.rand((1, 3, SD_VS_CPU_CANVAS, SD_VS_CPU_CANVAS), generator=g) * 2 - 1
    with torch.no_grad():
        unet_err = rel_err(unet(x.to(dev), t.to(dev), ctx[1:]),
                           cpu_copy(unet)(x, t, ctx[1:].cpu()))
        vae_cpu = cpu_copy(vae)
        g_mean, g_logvar = vae.encode(img.to(dev))
        c_mean, c_logvar = vae_cpu.encode(img)
        enc_err = max(rel_err(g_mean, c_mean), rel_err(g_logvar, c_logvar))
        dec_err = rel_err(vae.decode(c_mean.to(dev)), vae_cpu.decode(c_mean))

    # the tiny inpaint: weights from a seed, the same on both devices
    ucfg, vcfg = sd.UNetConfig.tiny(), sd.VAEConfig.tiny()
    tiny_gen = torch.Generator().manual_seed(SD_SEED + 2)
    states = {}
    for name, cls, cfg in (("unet", sd.UNet2DCondition, ucfg), ("vae", sd.AutoencoderKL, vcfg)):
        with torch.device("meta"):
            model = cls(cfg)
        states[name] = seeded_sd_state(model, tiny_gen)
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    mask = np.zeros((32, 32), np.uint8)
    mask[:, 12:20] = 255
    runs = []
    loop = pipeline._denoise_loop
    for d in (dev, torch.device("cpu")):
        b = {"unet_params": sd.load_module(sd.UNet2DCondition, ucfg, states["unet"], d),
             "vae_params": sd.load_module(sd.AutoencoderKL, vcfg, states["vae"], d),
             "unet_cfg": ucfg, "vae_cfg": vcfg, "tokenizer": SmokeTokenizer(),
             "text_encoder": SmokeTextEncoder(ucfg.cross_attention_dim)}
        seen = []
        pipeline._denoise_loop = lambda *a, **k: seen.append(loop(*a, **k)) or seen[-1]
        try:
            u8 = sd.riffusion_inpaint_image(b, image, mask, cfg=sd.InpaintConfig(steps=4), key=0)
        finally:
            pipeline._denoise_loop = loop
        runs.append((seen[0].cpu(), u8))
    (g_lat, g_u8), (c_lat, c_u8) = runs
    latent_err = rel_err(g_lat, c_lat)
    u8_levels = int(np.abs(g_u8.astype(int) - c_u8).max())
    res = {"tolerance": f"UNet and VAE within {SD_FORWARD_RTOL:g} of the output's peak; "
                        f"tiny inpaint latents within {SD_LATENT_RTOL:g} of their peak, "
                        "image within 1 uint8 level",
           "unet_forward_err_of_peak": unet_err, "vae_encode_err_of_peak": enc_err,
           "vae_decode_err_of_peak": dec_err, "tiny_inpaint_latent_err_of_peak": latent_err,
           "tiny_inpaint_uint8_levels": u8_levels}
    if (max(unet_err, enc_err, dec_err) > SD_FORWARD_RTOL or latent_err > SD_LATENT_RTOL
            or u8_levels > 1):
        raise AssertionError(f"riffusion GPU vs CPU: {res}")
    return res


def phase_facade(dev, tmp: Path):
    from audio_inpainting_torch import restore
    from audio_inpainting_torch.corrupt import find_gaps
    from audio_inpainting_torch.metrics import lsd_db, snr_db
    from audio_inpainting_torch.ops import ar_scan

    clean, damaged = damaged_clip(tmp)
    gaps = find_gaps(damaged, 0.01, 100)
    t0 = time.perf_counter()
    restore(damaged, SR, method="ar")                        # cold
    cold_s = time.perf_counter() - t0

    ar_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    out = restore(damaged, SR, method="ar")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ar_scan.LAUNCHES

    if launches != 2:
        raise AssertionError(f"facade launched the kernel {launches} times, not 2")
    if out.shape != damaged.shape or not np.isfinite(out).all():
        raise AssertionError("facade output has the wrong shape or is not finite")
    outside = np.ones(len(damaged), bool)
    for s, e in gaps:
        outside[s:e] = False
    if not np.array_equal(out[outside], damaged[outside]):
        raise AssertionError("facade changed samples outside the detected gaps")

    profiled = device_profile(lambda: restore(damaged, SR, method="ar"))

    # the facade on the GPU and on the CPU (plain loop), with the texture
    # noise (the same draws on both: a seeded CPU generator) and without
    agree = {}
    for texture in (True, False):
        gpu = restore(damaged, SR, method="ar", texture=texture)
        cpu = restore(damaged, SR, method="ar", texture=texture, device="cpu")
        agree[texture] = agreement_snr_db(torch.as_tensor(cpu[~outside]),
                                          torch.as_tensor(gpu[~outside]))
        if not agree[texture] >= 60.0:
            raise AssertionError(f"GPU vs CPU facade (texture {texture}): "
                                 f"agreement {agree[texture]} dB < 60 dB")

    emit({"phase": "facade", "samples": len(damaged), "gaps": len(gaps),
          "B": 2 * len(gaps), "max_len": max(e - s for s, e in gaps),
          "launches": launches, "cold_s": cold_s, "wall_s": wall_s,
          "gpu_vs_cpu_agreement_snr_db": agree[False],
          "gpu_vs_cpu_agreement_snr_db_texture": agree[True],
          "profile": profiled,
          "damaged": {"snr_db": float(snr_db(clean, damaged)),
                      "lsd_db": float(lsd_db(clean, damaged))},
          "restored": {"snr_db": float(snr_db(clean, out)),
                       "lsd_db": float(lsd_db(clean, out))},
          "nmf": facade_nmf(clean, damaged),
          "gp": facade_gp(clean),
          **facade_neural(clean, damaged),
          "diffusion": facade_diffusion()})
    return launches


def facade_nmf(clean, damaged) -> dict:
    """restore(method="nmf") on the 10 s clip, on the GPU and on the CPU
    (the same init draws: both come from a seeded CPU generator)."""
    from audio_inpainting_torch import restore
    from audio_inpainting_torch.metrics import lsd_db, snr_db

    restore(damaged, SR, method="nmf")                       # cold
    t0 = time.perf_counter()
    gpu = restore(damaged, SR, method="nmf")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    cpu = restore(damaged, SR, method="nmf", device="cpu")
    if gpu.shape != damaged.shape or not np.isfinite(gpu).all():
        raise AssertionError("nmf facade output has the wrong shape or is not finite")
    agree = agreement_snr_db(torch.as_tensor(cpu), torch.as_tensor(gpu))
    if not agree >= 60.0:
        raise AssertionError(f"GPU vs CPU nmf facade: agreement {agree} dB < 60 dB")
    return {"wall_s": wall_s, "gpu_vs_cpu_agreement_snr_db": agree,
            "snr_db": float(snr_db(clean, gpu)), "lsd_db": float(lsd_db(clean, gpu))}


def facade_neural(clean, damaged) -> dict:
    """restore(method="unet") and restore(method="gan", original=clean) on
    the 10 s clip, once each, on the GPU; the gan run's epochs are cut
    (FACADE_GAN_EPOCHS), as its JSON says."""
    from audio_inpainting_torch import restore
    from audio_inpainting_torch.metrics import lsd_db, snr_db

    default = {"unet": 400, "gan": 1500}
    out = {}
    for method, kw in (("unet", {"epochs": FACADE_UNET_EPOCHS}),
                       ("gan", {"epochs": FACADE_GAN_EPOCHS, "original": clean})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore(damaged, SR, method=method, **kw)
        wall_s = time.perf_counter() - t0
        if got.shape != damaged.shape or not np.isfinite(got).all():
            raise AssertionError(f"{method} facade output has the wrong shape "
                                 "or is not finite")
        out[method] = {"epochs": kw["epochs"], "default_epochs": default[method],
                       "wall_s": wall_s,
                       "snr_db": float(snr_db(clean, got)),
                       "lsd_db": float(lsd_db(clean, got))}
    return out


def facade_diffusion() -> dict:
    """restore(method="diffusion") on the GPU: per-clip training at its
    default step count (no checkpoint), 50 DDIM steps, Griffin-Lim, the
    composite. On Part 2's 10 s clip with its 2 s hole: the facade's
    dropouts darken no whole image column (hop 512), so there the
    composite would change no sample."""
    from audio_inpainting_torch import restore
    from audio_inpainting_torch.corrupt import center_gap_bounds, synth_music_clip
    from audio_inpainting_torch.metrics import local_snr_db, lsd_db, snr_db

    clean = synth_music_clip(1, SR, 10.0)
    damaged = diffusion_image()[0]
    gs, ge = center_gap_bounds(len(clean), SR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = restore(damaged, SR, method="diffusion", train_steps=FACADE_DIFFUSION_STEPS)
    wall_s = time.perf_counter() - t0
    changed = got != damaged
    if got.shape != damaged.shape or not np.isfinite(got).all() or not changed[gs:ge].all():
        raise AssertionError("diffusion facade output has the wrong shape, is not "
                             "finite or left part of the hole as it was")
    return {"clip": "Part 2's, a centred 2 s hole", "train_steps": FACADE_DIFFUSION_STEPS,
            "default_train_steps": 1500, "wall_s": wall_s,
            "samples_changed": int(np.count_nonzero(changed)),
            "snr_db": float(snr_db(clean, got)),
            "local_snr_db": float(local_snr_db(clean, got, gs, ge)),
            "lsd_db": float(lsd_db(clean, got))}


def facade_gp(clean) -> dict:
    """restore(method="gp") on Part 0's segment (0.05 s mid-clip, a 20%
    gap at 40%): GP is O(n^3), so not on the 10 s clip."""
    from audio_inpainting_torch import restore
    from audio_inpainting_torch.corrupt import contiguous_gap_mask
    from audio_inpainting_torch.metrics import local_snr_db

    n = int(0.05 * SR)
    seg = clean[len(clean) // 2:len(clean) // 2 + n]
    _, (gs, ge) = contiguous_gap_mask(n, 0.2)
    damaged = seg.copy()
    damaged[gs:ge] = 0.0
    restore(damaged, SR, method="gp", gaps=[(gs, ge)])       # cold
    t0 = time.perf_counter()
    gpu = restore(damaged, SR, method="gp", gaps=[(gs, ge)])
    wall_s = time.perf_counter() - t0
    profiled = device_profile(lambda: restore(damaged, SR, method="gp",
                                              gaps=[(gs, ge)]), kernel="potrf")
    t0 = time.perf_counter()
    cpu = restore(damaged, SR, method="gp", gaps=[(gs, ge)], device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.isfinite(gpu).all() or not np.array_equal(gpu[:gs], damaged[:gs]) \
            or not np.array_equal(gpu[ge:], damaged[ge:]):
        raise AssertionError("gp facade output is not finite or changed clean samples")
    snr = float(local_snr_db(seg, gpu, gs, ge))
    snr_cpu = float(local_snr_db(seg, cpu, gs, ge))
    if not snr >= snr_cpu - GP_MARGIN_DB:
        raise AssertionError(f"gp facade: GPU local SNR {snr} dB is more than "
                             f"{GP_MARGIN_DB} dB below the CPU's {snr_cpu} dB")
    return {"samples": n, "gap": [gs, ge], "fit_points": (n - (ge - gs) + 3) // 4,
            "wall_s": wall_s, "cpu_wall_s": cpu_s, "local_snr_db": snr,
            "cpu_local_snr_db": snr_cpu, "profile": profiled}


def phase_nmf(dev):
    """The masked NMF at Part 1's one-shot shape (513, 1723) and Part 0's
    iterative one, on the GPU and on the CPU with the same init draws."""
    from audio_inpainting_torch.corrupt import random_frame_mask, synth_music_clip
    from audio_inpainting_torch.methods.nmf import (NMFConfig, nmf_inpaint_columns,
                                                    nmf_inpaint_iterative)
    from audio_inpainting_torch.ops import (magphase, scipy_stft_config, stft,
                                            torch_stft_config)

    clip = torch.as_tensor(synth_music_clip(2, SR, 10.0))
    mag, _ = magphase(stft(clip, torch_stft_config(1024, 256)))
    bad = random_frame_mask(torch.Generator().manual_seed(0), 1, mag.shape[1])[0] == 0
    cfg = NMFConfig(n_components=40, n_iter=200)
    mag_d, bad_d = mag.to(dev), bad.to(dev)
    gpu = nmf_inpaint_columns(mag_d, bad_d, cfg, 42)
    t0 = time.perf_counter()
    cpu = nmf_inpaint_columns(mag, bad, cfg, 42)
    cpu_s = time.perf_counter() - t0
    if not torch.equal(gpu[:, ~bad_d].cpu(), mag[:, ~bad]):
        raise AssertionError("NMF on the GPU changed a good column")
    one_err = rel_err(gpu[:, bad_d], cpu[:, bad])
    one_shot = {"shape": list(mag.shape), "k": 40, "n_iter": 200,
                "bad_cols": int(bad.sum()), "max_rel_err_vs_cpu": one_err,
                "ms": cuda_ms(lambda: nmf_inpaint_columns(mag_d, bad_d, cfg, 42),
                              calls=2),
                "cpu_ms": cpu_s * 1e3,
                "profile": device_profile(
                    lambda: nmf_inpaint_columns(mag_d, bad_d, cfg, 42), kernel="gemm")}

    # Part 0: the mid-clip 0.05 s segment, faded 20% gap at 40%, scipy STFT
    n = int(0.05 * SR)
    seg = clip[len(clip) // 2:len(clip) // 2 + n].clone()
    gs, ge = int(0.4 * n), int(0.4 * n) + int(0.2 * n)
    seg[gs:ge] = 0.0
    pmag, _ = magphase(stft(seg, scipy_stft_config(512, 384)))
    cs, ce = int(gs / 128), int(ge / 128)
    icfg = NMFConfig(n_components=40, n_iter=200, outer_iters=50)
    pmag_d = pmag.to(dev)
    nmf_inpaint_iterative(pmag_d, cs, ce, icfg, 0)             # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    igpu = nmf_inpaint_iterative(pmag_d, cs, ce, icfg, 0)
    torch.cuda.synchronize()
    it_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    icpu = nmf_inpaint_iterative(pmag, cs, ce, icfg, 0)
    icpu_s = time.perf_counter() - t0
    it_err = rel_err(igpu[:, cs:ce], icpu[:, cs:ce])
    iterative = {"shape": list(pmag.shape), "cols": [cs, ce], "k": 40,
                 "n_iter": 200, "outer_iters": 50, "max_rel_err_vs_cpu": it_err,
                 "wall_s": it_s, "cpu_wall_s": icpu_s,
                 "profile": device_profile(
                     lambda: nmf_inpaint_iterative(pmag_d, cs, ce, icfg, 0),
                     kernel="gemm")}
    for name, err in (("one-shot", one_err), ("iterative", it_err)):
        if not err <= NMF_RTOL_OF_PEAK:
            raise AssertionError(f"NMF {name}: GPU vs CPU {err} of peak > "
                                 f"{NMF_RTOL_OF_PEAK}")
    emit({"phase": "nmf", "tolerance": f"filled columns within "
          f"{NMF_RTOL_OF_PEAK:g} of their peak", "draws": "CPU generator, "
          "the same on both devices", "one_shot": one_shot, "iterative": iterative})


def part1_spectrogram():
    """Part 1's normalized STFT magnitude (513, 1723) of
    synth_music_clip(2, ...) and a seeded frame mask, on the CPU."""
    from audio_inpainting_torch.corrupt import random_frame_mask, synth_music_clip
    from audio_inpainting_torch.ops import magphase, stft, torch_stft_config

    clip = torch.as_tensor(synth_music_clip(2, SR, 10.0))
    mag, _ = magphase(stft(clip, torch_stft_config(1024, 256)))
    mask = random_frame_mask(torch.Generator().manual_seed(0), *mag.shape)
    return mag / mag.max(), mask


def gan_inputs(mag_norm, mask):
    """Part 2's form: [-1, 1] magnitudes, the hidden cells at the floor."""
    real = mag_norm * 2.0 - 1.0
    return real * mask - (1.0 - mask), real, mask


def phase_neural(dev):
    """The U-Net and GAN training loops. GPU against CPU: 5 fp32 epochs
    from the same init (the draws come from a seeded CPU generator) on
    Part 1's magnitude cropped to 256 frames. Then at full size, (513,
    1723) padded to (516, 1728): ms per epoch by CUDA events, and one
    profiled stretch of epochs, for the U-Net in fp32 and bf16 and the GAN
    in bf16."""
    from audio_inpainting_torch.methods import neural

    mag_norm, mask = part1_spectrogram()
    m, k = mag_norm[:, :256].contiguous(), mask[:, :256].contiguous()
    ucfg = neural.UNetTrainConfig(epochs=5, masked_loss=True)
    g_final, _, g_loss = neural.unet_train_restore(m, k, ucfg, 0, device=dev)
    c_final, _, c_loss = neural.unet_train_restore(m, k, ucfg, 0, device="cpu")
    gcfg = neural.GANTrainConfig(epochs=5, ema_decay=0.99)
    gg_final, (gg_d, gg_g), _ = neural.gan_train_restore(*gan_inputs(m, k), gcfg, 0,
                                                         device=dev)
    cg_final, (cg_d, cg_g), _ = neural.gan_train_restore(*gan_inputs(m, k), gcfg, 0,
                                                         device="cpu")
    vs_cpu = {"shape": list(m.shape), "epochs": 5, "dtype": "fp32, TF32 off",
              "tolerance": f"losses within {NEURAL_LOSS_RTOL:g} relative; "
                           f"composites within {UNET_COMPOSITE_TOL:g} (U-Net) and "
                           f"{GAN_COMPOSITE_TOL:g} (GAN) of their peak",
              "unet_loss_rel_err": rel_err(g_loss, c_loss),
              "unet_composite_err": rel_err(g_final, c_final),
              "gan_d_loss_rel_err": rel_err(gg_d, cg_d),
              "gan_g_loss_rel_err": rel_err(gg_g, cg_g),
              "gan_composite_err": rel_err(gg_final, cg_final)}
    for key, tol in (("unet_loss_rel_err", NEURAL_LOSS_RTOL),
                     ("gan_d_loss_rel_err", NEURAL_LOSS_RTOL),
                     ("gan_g_loss_rel_err", NEURAL_LOSS_RTOL),
                     ("unet_composite_err", UNET_COMPOSITE_TOL),
                     ("gan_composite_err", GAN_COMPOSITE_TOL)):
        if not vs_cpu[key] <= tol:
            raise AssertionError(f"neural GPU vs CPU: {key} {vs_cpu[key]} > {tol}")

    full, fmask = mag_norm.to(dev), mask.to(dev)
    timed = {}
    for name, make in (
            ("unet_fp32", lambda: neural.UNetTrainer(
                full, fmask, neural.UNetTrainConfig(bf16=False), 0)),
            ("unet_bf16", lambda: neural.UNetTrainer(
                full, fmask, neural.UNetTrainConfig(bf16=True), 0)),
            ("gan_bf16", lambda: neural.GANTrainer(
                *gan_inputs(full, fmask), neural.GANTrainConfig(
                    bf16=True, ema_decay=0.99, ema_scope="gap"), 0))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = make()
        losses = [trainer.epoch() for _ in range(3)]           # warm
        ms = cuda_ms(trainer.epoch, calls=20, rounds=3, warmup=0)
        n_prof = 10
        prof = device_profile(lambda: [trainer.epoch() for _ in range(n_prof)],
                              top=10, kernel="conv")
        losses.append(trainer.epoch())
        flat = [v for x in losses for v in (x if isinstance(x, tuple) else (x,))]
        if not bool(torch.isfinite(torch.stack(flat)).all()):
            raise AssertionError(f"neural {name}: a loss is not finite")
        timed[name] = {
            "padded": list(trainer.inp.shape[2:]), "ms_per_epoch": ms,
            "device_calls_per_epoch": prof["device_calls"] / n_prof,
            "device_busy_ms_per_epoch": prof["device_busy_ms"] / n_prof,
            "wall_ms_per_epoch_profiled": prof["wall_ms"] / n_prof,
            # the profiler stretches the wall it measures: the idle share
            # of the profiled epochs and of the unprofiled epoch time
            "device_idle_share": prof["device_idle_share"],
            "device_idle_share_unprofiled": 1.0 - prof["device_busy_ms"] / n_prof / ms,
            "top": prof["top"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del trainer
    emit({"phase": "neural", "gpu_vs_cpu": vs_cpu,
          "full_size": {"shape": list(mag_norm.shape), **timed}})


def check_artifacts(assets: str, part: str, methods, sr: int):
    from audio_inpainting_torch.io import read_wav
    from audio_inpainting_torch.pipelines import asset_path

    for m in methods:
        wav_sr, data = read_wav(asset_path(assets, part, m))
        if wav_sr != sr or data.dtype != np.int16 or not len(data):
            raise AssertionError(f"{part}/{m}: bad WAV ({wav_sr} Hz, {data.dtype})")
        check_png(asset_path(assets, part, m, "image"))


def check_png(path: str) -> None:
    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{path}: not a PNG")


def finite_metrics(name: str, res: dict) -> None:
    for leg, vals in res.items():
        if isinstance(vals, dict) and not all(
                np.isfinite(v) for k, v in vals.items() if k.endswith("db")):
            raise AssertionError(f"{name}/{leg}: metric not finite: {vals}")


def phase_part1(dev, tmp: Path):
    """run_part1 on a 10 s, 44.1 kHz clip: the corruption, the linear, AR
    (OLA equalization, then the CUDA kernel over the residual gaps) and
    NMF legs, on the GPU; then on the CPU for the legs whose draws are the
    same on both devices."""
    from audio_inpainting_torch.corrupt import synth_music_clip
    from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16
    from audio_inpainting_torch.methods import ARConfig, ar_restore_gaps
    from audio_inpainting_torch.methods.ola_eq import equalize_dropped_frames
    from audio_inpainting_torch.ops import ar_scan
    from audio_inpainting_torch.pipelines import asset_path, run_part1

    clip = str(tmp / "part1_clip.wav")
    save_wav_int16(synth_music_clip(2, SR, 10.0), SR, clip)
    assets = str(tmp / "assets")
    t0 = time.perf_counter()
    run_part1(clip, assets, seed=0, unet_epochs=1)            # cold
    cold_s = time.perf_counter() - t0

    ar_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_part1(clip, assets, seed=0)                     # 400 U-Net epochs
    wall_s = time.perf_counter() - t0
    launches = ar_scan.LAUNCHES
    passes = 2
    if res["n_gaps"] == 0 or launches != passes:
        raise AssertionError(f"Part 1's AR leg launched the kernel {launches} "
                             f"times over {res['n_gaps']} gaps, not {passes}")
    check_artifacts(assets, "part1",
                    ["damaged", "original", "linear", "ar", "nmf", "unet"], SR)
    check_png(str(Path(assets) / "part1" / "spectrogram_comparison.png"))
    finite_metrics("part1", res)

    # the AR leg alone, on its own inputs, under the profiler
    _, damaged = load_mono_normalized(asset_path(assets, "part1", "damaged"))
    eq, gaps, _ = equalize_dropped_frames(damaged, len(damaged) // 256 + 1)
    cfg = ARConfig(order=30, alpha=0.5, texture=True, texture_scale=0.1,
                   context_len=1000, passes=passes)
    ar_profile = device_profile(lambda: ar_restore_gaps(eq, gaps, cfg, 1))
    kernel_row = part1_kernel_row(dev, eq, gaps, cfg)
    whole_profile = device_profile(lambda: run_part1(clip, str(tmp / "prof"), seed=0,
                                                     unet_epochs=1))

    t0 = time.perf_counter()
    cpu = run_part1(clip, str(tmp / "cpu"), seed=0, unet_epochs=1, device="cpu")
    cpu_s = time.perf_counter() - t0
    deltas = {leg: {k: res[leg][k] - cpu[leg][k] for k in ("snr_db", "lsd_db")}
              for leg in ("damaged", "linear", "nmf")}
    if cpu["n_gaps"] != res["n_gaps"] or not all(
            abs(d) <= DB_TOL for leg in deltas.values() for d in leg.values()):
        raise AssertionError(f"Part 1 GPU vs CPU: {deltas}, gaps "
                             f"{res['n_gaps']} / {cpu['n_gaps']}")
    emit({"phase": "part1", "samples": len(damaged), "n_gaps": res["n_gaps"],
          "B": 2 * res["n_gaps"], "max_len": res["ar_max_len"],
          "launches": launches, "cold_s": cold_s, "wall_s": wall_s,
          "unet_epochs": 400, "cold_profiled_cpu_unet_epochs": 1,
          "legs": {leg: res[leg] for leg in ("damaged", "linear", "ar", "nmf", "unet")},
          "cpu_wall_s": cpu_s, "gpu_minus_cpu_db": deltas,
          "cpu_ar": cpu["ar"], "kernel": kernel_row, "ar_profile": ar_profile,
          "profile": whole_profile})
    return launches, kernel_row


def part1_kernel_row(dev, eq, gaps, cfg) -> dict:
    """The kernel at the shape Part 1's AR leg gives it: the leg's first
    pass fitted on the equalized clip, eps a seeded standard normal."""
    from audio_inpainting_torch.methods import ar

    sig = torch.as_tensor(eq, device=dev)
    starts = torch.tensor([s for s, _ in gaps], device=dev)
    ends = torch.tensor([e for _, e in gaps], device=dev)
    ctxs, pads = ar._extract_contexts(sig, starts, ends, cfg.context_len)
    w, b, std, valid = ar._fit_ridge_batched(ctxs, pads, cfg)
    B, steps = 2 * len(gaps), max(e - s for s, e in gaps)
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = torch.randn((B, steps), generator=gen, device=dev)
    args = (ar._state0(ctxs, cfg.order).contiguous(), w, b,
            std * cfg.texture_scale, valid.to(torch.float32), eps, steps)
    return kernel_row("part1", args)


def phase_pipelines(dev, tmp: Path):
    from audio_inpainting_torch.corrupt import synth_music_clip
    from audio_inpainting_torch.io import save_wav_int16
    from audio_inpainting_torch.methods.diffusion import PRIOR_DIR
    from audio_inpainting_torch.ops import ar_scan
    from audio_inpainting_torch.pipelines import run_part0, run_part2
    from audio_inpainting_torch.utils import load_params

    clip = str(tmp / "clip.wav")
    save_wav_int16(synth_music_clip(1, SR, 10.0), SR, clip)
    assets = str(tmp / "assets")
    # the diffusion leg samples from the committed prior, as the CLI does
    prior = load_params(PRIOR_DIR, dev)

    t0 = time.perf_counter()
    run_part2(clip, assets, seed=0, gan_epochs=10, diffusion_params=prior)   # cold
    cold_s = time.perf_counter() - t0
    ar_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    # 1500 GAN epochs, retry armed
    part2 = run_part2(clip, assets, seed=0, diffusion_params=prior)
    part2_s = time.perf_counter() - t0
    part2_launches = ar_scan.LAUNCHES
    check_artifacts(assets, "part2", ["damaged", "original", "linear", "ar", "nmf", "gan",
                                      "diffusion"], SR)
    if not part2["diffusion"]["pretrained"]:
        raise AssertionError("Part 2's diffusion leg did not take the prior")

    ar_scan.LAUNCHES = 0
    t0 = time.perf_counter()
    part0 = run_part0(clip, assets, seed=0)
    part0_s = time.perf_counter() - t0
    part0_launches = ar_scan.LAUNCHES
    if part0_launches != 6:   # the AR leg once, the texture leg five times
        raise AssertionError(f"Part 0 launched the kernel {part0_launches} times, not 6")
    check_artifacts(assets, "part0", [
        f"{leg}{kind}" for leg in ("gp", "ar", "ar_texture", "nmf")
        for kind in ("", "_corrupted", "_original")], SR)
    for name, res in (("part2", part2), ("part0", part0)):
        finite_metrics(name, res)
    emit({"phase": "pipelines",
          "part2": {**part2, "cold_s": cold_s, "cold_gan_epochs": 10,
                    "wall_s": part2_s, "gan_epochs": 1500,
                    "gan_retry_fired": part2["gan"]["attempts"] == 2,
                    "launches": part2_launches},
          "part0": {**part0, "wall_s": part0_s, "launches": part0_launches}})
    return {"part2": part2_launches, "part0": part0_launches}


def engine_clip(tmp: Path):
    """A 60 s synthetic clip with Part-1-style dropouts (ratio 0.25, 50-400
    samples), through the int16 WAV chain; the gap mask widened by the
    composite margin (the samples the engines may change)."""
    from audio_inpainting_torch.corrupt import (find_gaps, random_dropout_mask,
                                                synth_music_clip)
    from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16

    clean = synth_music_clip(3, SR, ENGINE_SECONDS)
    mask = random_dropout_mask(torch.Generator().manual_seed(3), len(clean),
                               0.25, 50, 400).numpy()
    path = str(tmp / "engine.wav")
    save_wav_int16(clean * mask, SR, path)
    damaged = load_mono_normalized(path)[1]
    touched = np.zeros(len(damaged), bool)
    for s, e in find_gaps(damaged, 0.01, 100):
        touched[max(s - MARGIN, 0):e + MARGIN] = True
    return clean, damaged, touched


class Spy:
    """Counts (and records the arguments of) the calls of ``module.name``
    while in a ``with`` block; the wrapped function runs as it would."""

    def __init__(self, module, name, keep=None):
        self.module, self.name, self.keep = module, name, keep
        self.calls = []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            self.calls.append(self.keep(*args, **kwargs) if self.keep else None)
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def keep_kernel_args(*args):
    """A Spy's record of one ar_extrapolate call: its arguments, copied."""
    return [t.clone() for t in args[:6]] + [args[6]]


def phase_windowed(dev, clip):
    """restore_windowed(method="ar", window_s=2.0) over the 60 s clip,
    window by window (one facade call each) and batched (one batch per
    (size, gap-count bucket, max-len bucket) class); where the two part;
    GPU against CPU on a 10 s crop, both ways; the kernel alone at every
    shape either way gave it."""
    from audio_inpainting_torch import api
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.methods.windowed import restore_windowed
    from audio_inpainting_torch.metrics import lsd_db, snr_db
    from audio_inpainting_torch.ops import ar_scan

    clean, damaged, touched = clip
    passes = api.AR_DEFAULTS["passes"]
    kw = dict(method="ar", window_s=WINDOW_S, margin=MARGIN, seed=0)
    runs = {}
    for batch in (False, True):
        # cold: the first call, which also records the kernel's arguments,
        # the facade calls and the class batches
        with Spy(ar, "ar_extrapolate", keep=keep_kernel_args) as spy, \
                Spy(api, "restore", keep=lambda *a, **k: (a, k)) as facade_args, \
                Spy(ar, "ar_restore_gaps_windows",
                    keep=lambda *a, **k: (a, k)) as batch_args:
            t0 = time.perf_counter()
            restore_windowed(damaged, SR, batch_windows=batch, **kw)
            cold_s = time.perf_counter() - t0
        with Spy(api, "restore") as facade_calls, \
                Spy(ar, "ar_restore_gaps_windows",
                    keep=lambda s, g, *a, **k: (len(g), len(s[0]))) as batches:
            ar_scan.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = restore_windowed(damaged, SR, batch_windows=batch, **kw)
            wall_s = time.perf_counter() - t0
            launches = ar_scan.LAUNCHES
        units = len(batches.calls) if batch else len(facade_calls.calls)
        if launches != passes * units:
            raise AssertionError(f"windowed (batch {batch}): {launches} launches "
                                 f"for {units} {'classes' if batch else 'windows'}")
        if out.shape != damaged.shape or not np.array_equal(out[~touched],
                                                             damaged[~touched]):
            raise AssertionError(f"windowed (batch {batch}) changed samples "
                                 "outside the gaps +- margin")
        runs[batch] = {"out": out, "cold_s": cold_s, "wall_s": wall_s,
                       "launches": launches, "units": units,
                       "kernel_args": spy.calls, "classes": batches.calls,
                       "facade_args": facade_args.calls,
                       "batch_args": batch_args.calls}
    seq, bat = runs[False], runs[True]
    batch_err = float(np.abs(bat["out"] - seq["out"]).max() / np.abs(seq["out"]).max())
    batch_snr = agreement_snr_db(torch.as_tensor(seq["out"][touched]),
                                 torch.as_tensor(bat["out"][touched]))
    if not (batch_err <= BATCH_ERR_OF_PEAK and batch_snr >= BATCH_AGREEMENT_DB):
        raise AssertionError(f"windowed: batched vs sequential {batch_snr} dB, max "
                             f"error {batch_err} of peak (bounds {BATCH_AGREEMENT_DB} "
                             f"dB, {BATCH_ERR_OF_PEAK})")
    effect = batch_size_effect(dev, max(bat["batch_args"], key=lambda c: len(c[0][1])),
                               seq["facade_args"])
    profiled = device_profile(lambda: restore_windowed(damaged, SR, batch_windows=True,
                                                       **kw))

    # GPU against CPU on the first 10 s (the CPU's plain loop), both ways
    crop = damaged[:int(ENGINE_CPU_SECONDS * SR)]
    hole = touched[:len(crop)]
    vs_cpu = {}
    for batch in (False, True):
        gpu = restore_windowed(crop, SR, batch_windows=batch, **kw)
        t0 = time.perf_counter()
        cpu = restore_windowed(crop, SR, batch_windows=batch, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        snr = agreement_snr_db(torch.as_tensor(cpu[hole]), torch.as_tensor(gpu[hole]))
        if not snr >= AR_AGREEMENT_DB:
            raise AssertionError(f"windowed (batch {batch}) GPU vs CPU: agreement "
                                 f"{snr} dB")
        vs_cpu["batched" if batch else "sequential"] = {
            "agreement_snr_db": snr, "cpu_wall_s": cpu_s}

    rows = (kernel_rows("windowed", bat["kernel_args"])
            + kernel_rows("windowed_sequential", seq["kernel_args"]))
    emit({"phase": "windowed", "samples": len(damaged), "window_s": WINDOW_S,
          "windows": seq["units"], "classes": bat["units"],
          "class_shapes": [{"windows": w, "size": n} for w, n in bat["classes"]],
          "launches_sequential": seq["launches"], "launches_batched": bat["launches"],
          "cold_s_sequential": seq["cold_s"], "cold_s_batched": bat["cold_s"],
          "wall_s_sequential": seq["wall_s"], "wall_s_batched": bat["wall_s"],
          "batched_vs_sequential_err_of_peak": batch_err,
          "batched_vs_sequential_agreement_snr_db": batch_snr,
          "batch_size_effect": effect,
          "gpu_vs_cpu_10s": vs_cpu, "profile_batched": profiled, "kernels": rows,
          "restored": {"snr_db": float(snr_db(clean, bat["out"])),
                       "lsd_db": float(lsd_db(clean, bat["out"]))},
          "damaged": {"snr_db": float(snr_db(clean, damaged)),
                      "lsd_db": float(lsd_db(clean, damaged))}})
    return {"windowed": bat["launches"], "windowed_sequential": seq["launches"]}, rows


def batch_size_effect(dev, batch_call, facade_calls) -> dict:
    """Where batched and window by window part, on the first window of the
    largest class: the window restored as a batch of one against its
    facade call (the same code, so bit-equal); the class's batch against
    that; the fit of the window's rows within the class's batch against
    alone, and the kernel on the class's rows against on the window's rows
    alone, both on pass 0's inputs. Raises unless the first and the kernel
    are bit-equal."""
    from audio_inpainting_torch import api
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.ops import ar_scan

    (signals, gaps_list, cfg, seed), kwargs = batch_call
    signals = torch.as_tensor(signals).cpu().numpy()
    (fargs, fkw), = [c for c in facade_calls if np.array_equal(c[0][0], signals[0])]
    facade = api.restore(*fargs, **fkw)
    alone = ar.ar_restore_gaps_windows(signals[:1], gaps_list[:1], cfg, seed,
                                       **kwargs).cpu().numpy()[0]
    in_batch = ar.ar_restore_gaps_windows(signals, gaps_list, cfg, seed,
                                          **kwargs).cpu().numpy()[0]

    cfg, starts, ends, gpad, max_len = ar.windows_prep(gaps_list, cfg)
    sig = torch.as_tensor(np.asarray(signals, np.float32), device=dev)
    st, en = (torch.as_tensor(a, device=dev) for a in (starts, ends))
    rows = 2 * gpad

    def fit(k):   # pass 0 over the first k windows
        ctxs, pads = ar._extract_contexts(sig[:k], st[:k], en[:k], cfg.context_len)
        return ctxs, ar._fit_ridge_batched(ctxs, pads, cfg)

    ctxs, (w, b, std, valid) = fit(len(gaps_list))
    _, one = fit(1)
    eps = ar._draw_eps(seed, 0, (max_len, rows), dev).T.contiguous()
    args = (ar._state0(ctxs, cfg.order).contiguous(), w, b, std * cfg.texture_scale,
            valid.to(torch.float32), eps.repeat(len(gaps_list), 1))
    full = ar_scan.ar_extrapolate(*args, max_len)
    head = ar_scan.ar_extrapolate(*(a[:rows].contiguous() for a in args), max_len)
    res = {"windows": len(gaps_list), "rows_per_window": rows, "steps": max_len,
           "alone_vs_facade_bit_equal": bool(np.array_equal(alone, facade)),
           "in_batch_vs_alone_err_of_peak":
               float(np.abs(in_batch - alone).max() / np.abs(alone).max()),
           "fit_in_batch_vs_alone_rel_err": {
               name: rel_err(x[:rows], y) for name, x, y in
               (("w", w, one[0]), ("b", b, one[1]), ("noise_std", std, one[2]))},
           "fit_valid_equal": bool(torch.equal(valid[:rows], one[3])),
           "kernel_rows_bit_equal": bool(torch.equal(full[:rows], head))}
    if not (res["alone_vs_facade_bit_equal"] and res["kernel_rows_bit_equal"]):
        raise AssertionError(f"windowed: the batch of one or the kernel's rows "
                             f"depend on more than the batch size: {res}")
    return res


def kernel_rows(path: str, calls) -> list[dict]:
    """The kernel at each distinct shape a path gave it, on the first
    arguments of that shape."""
    first = {}
    for args in calls:
        first.setdefault((*args[1].shape, args[6]), args)
    return [kernel_row(path, args) for _, args in sorted(first.items())]


def kernel_row(path: str, args) -> dict:
    """The kernel on the arguments a path gave it, against the plain loop
    and the bound."""
    from audio_inpainting_torch.ops import ar_scan

    B, p = args[1].shape
    steps = args[6]
    got = ar_scan.ar_extrapolate(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ar_scan.ar_extrapolate_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    snr = agreement_snr_db(ref, got)
    if not snr >= 60.0:
        raise AssertionError(f"kernel vs plain on {path} at {(B, p, steps)}: {snr} dB")
    bms, bound_by = bound_ms(B, p, steps)
    return {"path": path, "B": B, "p": p, "steps": steps, "agreement_snr_db": snr,
            "max_abs_err": float((got - ref).abs().max()),
            "ms": cuda_ms(lambda: ar_scan.ar_extrapolate(*args), calls=10),
            "plain_ms": plain_ms, "plain_runs": 1, "chunked_ms": None,
            "bound_ms": bms, "bound_by": bound_by}


def stream_run(damaged, method: str, chunk: int, dev, warm: bool,
               kernel_args=None) -> dict:
    """Feed ``damaged`` to a StreamRestorer in ``chunk``-sample pieces.

    It first unloads the kernel's library (drops the caches of
    ops.ar_scan._library and kernels.build.load), so that the first call
    that needs the kernel loads it again and shows as a miss of
    build.load: ``loads_warmup`` and ``loads_feed`` count the misses of
    warmup and of the feeds. kernel_args: a list that gets the arguments
    of every kernel call of the feeds."""
    from audio_inpainting_torch.kernels import build
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.methods.streaming import StreamRestorer
    from audio_inpainting_torch.ops import ar_scan

    ar_scan._library.cache_clear()
    build.load.cache_clear()
    rest = StreamRestorer(SR, method=method, margin=MARGIN, device=dev)
    warm_s = warmed = None
    if warm:
        t0 = time.perf_counter()
        # the dropouts are at most 400 samples; the clip's 2 s windows
        # hold up to ~90 runs: gap-count buckets 8, 32 and 128
        warmed = rest.warmup(max_gap_s=0.01, max_runs=128)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    loads_warmup = build.load.cache_info().misses
    windows, piece_ms = [], []
    real_piece = rest._restore_piece

    def timed_piece(*a):
        windows.append(a[2])
        t0 = time.perf_counter()
        real_piece(*a)                     # syncs: the fill comes to the host
        piece_ms.append((time.perf_counter() - t0) * 1e3)

    rest._restore_piece = timed_piece
    pending, parts = [], []
    spy = Spy(ar, "ar_extrapolate", keep=keep_kernel_args)
    with spy if kernel_args is not None else contextlib.nullcontext():
        ar_scan.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(damaged), chunk):
            parts.append(rest.feed(damaged[i:i + chunk]))
            pending.append(rest.pending)
        parts.append(rest.flush())
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if kernel_args is not None:
        kernel_args.extend(spy.calls)
    pend = np.asarray(pending, np.float64) / SR
    return {"out": np.concatenate(parts), "wall_s": wall_s,
            "realtime_factor": len(damaged) / SR / wall_s,
            "pending_p50_s": float(np.percentile(pend, 50)),
            "pending_p99_s": float(np.percentile(pend, 99)),
            "warmup_s": warm_s, "warmup_windows": warmed,
            "loads_warmup": loads_warmup,
            "loads_feed": build.load.cache_info().misses - loads_warmup,
            "first_window_ms": piece_ms[0] if piece_ms else None,
            "window_ms_p50": float(np.median(piece_ms)) if piece_ms else None,
            "windows": len(windows), "window_sizes": sorted(set(windows)),
            "launches": ar_scan.LAUNCHES}


def phase_stream(dev, clip):
    """The 60 s clip through StreamRestorer in 4,096-sample chunks (~93 ms
    at 44.1 kHz): linear, ar (after warmup), and the persistent U-Net on
    the first 20 s (400 cold, 100 adapt epochs). linear and ar fed again,
    without warmup, in 44,100-sample chunks must give the same bytes; ar
    on the GPU against the CPU on the first 10 s; the kernel alone at
    every shape the ar stream gave it. Warmup must load the kernel's
    library and leave the feeds nothing to load, and without warmup the
    feeds must load it once."""
    from audio_inpainting_torch import api
    from audio_inpainting_torch.metrics import lsd_db, snr_db

    clean, damaged, touched = clip
    res, launches, kernel_args = {}, 0, []
    for method, n in (("linear", len(damaged)), ("ar", len(damaged)),
                      ("unet", int(UNET_STREAM_SECONDS * SR))):
        run = stream_run(damaged[:n], method, STREAM_CHUNK, dev, warm=True)
        out = run.pop("out")
        if out.shape != (n,) or not np.array_equal(out[~touched[:n]],
                                                   damaged[:n][~touched[:n]]):
            raise AssertionError(f"stream {method}: wrong length or changed "
                                 "samples outside the gaps +- margin")
        loads = (1, 0) if method == "ar" else (0, 0)
        if (run["loads_warmup"], run["loads_feed"]) != loads:
            raise AssertionError(f"stream {method}: warmup loaded the kernel "
                                 f"{run['loads_warmup']} times and the feeds "
                                 f"{run['loads_feed']} times, not {loads}")
        if method != "unet":
            again = stream_run(damaged, method, SR, dev, warm=False,
                               kernel_args=kernel_args if method == "ar" else None)
            if not np.array_equal(out, again.pop("out")):
                raise AssertionError(f"stream {method}: 4,096- and 44,100-sample "
                                     "chunks gave different bytes")
            if again["loads_feed"] != loads[0]:
                raise AssertionError(f"stream {method} without warmup: the feeds "
                                     f"loaded the kernel {again['loads_feed']} times")
            run["unwarmed_44100"] = {k: again[k] for k in (
                "wall_s", "loads_feed", "first_window_ms", "window_ms_p50")}
        want = api.AR_DEFAULTS["passes"] * run["windows"] if method == "ar" else 0
        if run["launches"] != want:
            raise AssertionError(f"stream {method}: {run['launches']} launches, "
                                 f"not {want}")
        if method == "ar":
            launches = run["launches"]
            run["gpu_vs_cpu_10s"] = stream_vs_cpu(damaged, touched, dev)
        res[method] = {**run, "seconds": n / SR,
                       "snr_db": float(snr_db(clean[:n], out)),
                       "lsd_db": float(lsd_db(clean[:n], out))}
    rows = kernel_rows("stream", kernel_args)
    emit({"phase": "stream", "chunk": STREAM_CHUNK, "margin": MARGIN, **res,
          "kernels": rows})
    return {"stream": launches}, rows


def stream_vs_cpu(damaged, touched, dev) -> dict:
    """The ar stream over the first 10 s on the GPU and on the CPU (the
    plain loop), both fed 4,096-sample chunks without warmup."""
    crop = damaged[:int(ENGINE_CPU_SECONDS * SR)]
    hole = touched[:len(crop)]
    gpu = stream_run(crop, "ar", STREAM_CHUNK, dev, warm=False)["out"]
    cpu_run = stream_run(crop, "ar", STREAM_CHUNK, "cpu", warm=False)
    snr = agreement_snr_db(torch.as_tensor(cpu_run["out"][hole]),
                           torch.as_tensor(gpu[hole]))
    if not snr >= AR_AGREEMENT_DB:
        raise AssertionError(f"stream ar GPU vs CPU: agreement {snr} dB")
    return {"agreement_snr_db": snr, "cpu_wall_s": cpu_run["wall_s"]}


def serve_corpus(tmp: Path):
    """SERVE_CLIPS 10 s clips, synth_music_clip(10 + i), with the facade's
    Part-1-style dropouts, as damaged and clean int16 WAVs of the same
    names in two directories."""
    from audio_inpainting_torch.corrupt import random_dropout_mask, synth_music_clip
    from audio_inpainting_torch.io import save_wav_int16

    din, dclean = tmp / "serve_in", tmp / "serve_clean"
    din.mkdir()
    dclean.mkdir()
    for i in range(SERVE_CLIPS):
        clean = synth_music_clip(10 + i, SR, 10.0)
        mask = random_dropout_mask(torch.Generator().manual_seed(10 + i), len(clean),
                                   0.25, 50, 400).numpy()
        save_wav_int16(clean * mask, SR, str(din / f"clip{i}.wav"))
        save_wav_int16(clean, SR, str(dclean / f"clip{i}.wav"))
    return din, dclean


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic kernels inside the block: each path then
    repeats itself bit for bit, so a comparison shows only what differs
    between the two paths."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def timed(fn):
    """(fn's result, wall seconds to the end of its device work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(dev, tmp: Path, clip):
    """The corpus path at full width (serve_corpus): run_serve with ar (each
    WAV the facade's bytes, 2 launches per clip), the U-Net (400 fp32
    epochs, scored by the CLI's ``score``) and the GAN (300 bf16 epochs,
    each fill against its single-clip run); the batched trainers against
    single clips; ms per epoch against the group size G; the U-Net's
    window batch against window by window; the live HTTP API."""
    din, dclean = serve_corpus(tmp)
    ar_res, ar_rows, ar_launches = serve_ar(din, tmp)
    unet = serve_unet(din, dclean, tmp)
    gan = serve_gan(dev, din, dclean, tmp)
    vs_single = batch_vs_single(dev)
    sweep = group_sweep(dev)
    windows = window_batch(clip)
    live, live_rows, live_launches = live_api(dev, tmp)
    emit({"phase": "serve", "clips": SERVE_CLIPS, "seconds_per_clip": 10.0,
          "ar": ar_res, "unet": unet, "gan": gan, "batch_vs_single": vs_single,
          "ms_per_epoch_by_group": sweep, "unet_window_batch": windows,
          "live": live, "kernels": ar_rows + live_rows})
    return {"serve": ar_launches, "live": live_launches}, ar_rows + live_rows


def serve_ar(din: Path, tmp: Path):
    """run_serve(method="ar"): one facade call per clip, each WAV
    byte-equal to the facade's restore of that clip on the card, clean
    samples bit-identical, 2 launches per clip."""
    from audio_inpainting_torch import api
    from audio_inpainting_torch.corrupt import find_gaps
    from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.ops import ar_scan
    from audio_inpainting_torch.pipelines.serve import run_serve

    dout = tmp / "serve_ar"
    cold_s = timed(lambda: run_serve(str(din), str(dout), method="ar"))[1]
    per_clip, real = [], api.restore

    def counted(*a, **k):
        before = ar_scan.LAUNCHES
        out = real(*a, **k)
        per_clip.append(ar_scan.LAUNCHES - before)
        return out

    api.restore = counted
    try:
        with Spy(ar, "ar_extrapolate", keep=keep_kernel_args) as spy:
            ar_scan.LAUNCHES = 0
            res, wall_s = timed(lambda: run_serve(str(din), str(dout), method="ar"))
            launches = ar_scan.LAUNCHES
    finally:
        api.restore = real
    if per_clip != [2] * SERVE_CLIPS or launches != 2 * SERVE_CLIPS:
        raise AssertionError(f"serve ar: launches {launches}, per clip {per_clip}")
    for name in sorted(res["files"]):
        _, x = load_mono_normalized(str(din / name))
        y = api.restore(x, SR, method="ar")
        outside = np.ones(len(x), bool)
        for s, e in find_gaps(x, 0.01, 100):
            outside[s:e] = False
        save_wav_int16(y, SR, str(tmp / "serve_facade.wav"))
        if not (np.array_equal(y[outside], x[outside]) and (dout / name).read_bytes()
                == (tmp / "serve_facade.wav").read_bytes()):
            raise AssertionError(f"serve ar: {name} is not the facade's restore, or "
                                 "changed clean samples")
    return ({"cold_s": cold_s, "wall_s": wall_s, "launches": launches,
             "launches_per_clip": per_clip, "files": res["files"],
             "byte_equal_to_facade": True},
            kernel_rows("serve", spy.calls), launches)


def score_dirs(restored: Path, clean: Path) -> dict:
    """The CLI's ``score`` of a directory against the clean clips."""
    from audio_inpainting_torch.cli.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(["score", str(restored), str(clean), "--json"])
    rows = json.loads(buf.getvalue())["score"]
    if not all(isinstance(r, dict) and np.isfinite([r["snr_db"], r["lsd_db"]]).all()
               for r in rows.values()):
        raise AssertionError(f"score: {rows}")
    return rows


def serve_unet(din: Path, dclean: Path, tmp: Path) -> dict:
    """run_serve(method="unet") at 400 fp32 epochs: the wall (one run, so
    cuDNN's first calls at the grouped shapes are in it), the peak memory,
    the most clips a group could hold now, and the CLI's score of the
    damaged and the restored clips."""
    from audio_inpainting_torch.parallel.batch import clip_bytes, group_cap
    from audio_inpainting_torch.pipelines.serve import run_serve

    dout = tmp / "serve_unet"
    torch.cuda.reset_peak_memory_stats()
    res, wall_s = timed(lambda: run_serve(str(din), str(dout), method="unet",
                                          epochs=SERVE_UNET_EPOCHS))
    frames = next(iter(res["files"].values()))["frames"]
    return {"epochs": SERVE_UNET_EPOCHS, "wall_s": wall_s, "files": res["files"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "group_cap_now": group_cap(clip_bytes("unet", False, 513, frames),
                                       torch.device("cuda")),
            "score_damaged": score_dirs(din, dclean),
            "score_restored": score_dirs(dout, dclean)}


def fill_snr_db(final, real, mask) -> float:
    """SNR of a fill against the real magnitudes over the hidden cells."""
    final, real, mask = (torch.as_tensor(a).double().cpu() for a in (final, real, mask))
    hole = mask == 0
    return float(10 * torch.log10((real[hole] ** 2).sum()
                                  / ((final[hole] - real[hole]) ** 2).sum()))


def serve_gan(dev, din: Path, dclean: Path, tmp: Path) -> dict:
    """run_serve(method="gan", 300 epochs): serve's normalization and
    config (bf16, the gap-scoped EMA; the retry arms only at 1500) into
    restore_clips_gan, whose inputs and output are kept. On those inputs
    each clip alone through gan_train_restore, from the same init: at 300
    epochs printed; at GAN_HELD_EPOCHS, with cuDNN's deterministic
    kernels, the batch's fill may fall BF16_GAN_FILL_DB short of the single
    run's."""
    import audio_inpainting_torch.parallel as parallel
    from audio_inpainting_torch.methods import neural
    from audio_inpainting_torch.pipelines.serve import run_serve

    seen, real = {}, parallel.restore_clips_gan

    def keep(norm, rnorm, masks, cfg, seed, **kw):
        out = real(norm, rnorm, masks, cfg, seed, **kw)
        seen.update(norm=norm, rnorm=rnorm, masks=masks, cfg=cfg, seed=seed, kw=kw,
                    out=out[0])
        return out

    parallel.restore_clips_gan = keep
    torch.cuda.reset_peak_memory_stats()
    try:
        res, wall_s = timed(lambda: run_serve(
            str(din), str(tmp / "serve_gan"), method="gan", epochs=SERVE_GAN_EPOCHS,
            originals_dir=str(dclean)))
    finally:
        parallel.restore_clips_gan = real
    peak = torch.cuda.max_memory_allocated() / 1e9
    seeds = parallel.clip_seeds(seen["seed"], SERVE_CLIPS)
    f, t = 513, next(iter(res["files"].values()))["frames"]
    clip_args = [[seen[k][g, :f, :t] for k in ("norm", "rnorm", "masks")]
                 for g in range(SERVE_CLIPS)]
    held_cfg = dataclasses.replace(seen["cfg"], epochs=GAN_HELD_EPOCHS)
    with cudnn_deterministic():
        held_out, _ = real(seen["norm"], seen["rnorm"], seen["masks"], held_cfg,
                           seen["seed"], **seen["kw"])
        held_one = [neural.gan_train_restore(*args, held_cfg, seeds[g], device=dev)[0]
                    for g, args in enumerate(clip_args)]
    clips, single_s = [], 0.0
    for g, args in enumerate(clip_args):
        (one, _, _), s = timed(lambda: neural.gan_train_restore(
            *args, seen["cfg"], seeds[g], device=dev))
        single_s += s
        clips.append({
            "fill_snr_db_batch": fill_snr_db(seen["out"][g, :f, :t], *args[1:]),
            "fill_snr_db_single": fill_snr_db(one, *args[1:]),
            "held_fill_snr_db_batch": fill_snr_db(held_out[g, :f, :t], *args[1:]),
            "held_fill_snr_db_single": fill_snr_db(held_one[g], *args[1:])})
    if not all(c["held_fill_snr_db_batch"] >= c["held_fill_snr_db_single"] - BF16_GAN_FILL_DB
               for c in clips):
        raise AssertionError(f"serve gan at {GAN_HELD_EPOCHS} epochs: a batched fill is "
                             f"more than {BF16_GAN_FILL_DB} dB under its single run: {clips}")
    return {"epochs": SERVE_GAN_EPOCHS, "default_epochs": 1500, "bf16": True,
            "wall_s": wall_s, "peak_memory_gb": peak,
            "single_clip_runs_wall_s": single_s, "held_epochs": GAN_HELD_EPOCHS,
            "clips": clips,
            "tolerance": f"at {GAN_HELD_EPOCHS} epochs, batch fill >= single fill - "
                         f"{BF16_GAN_FILL_DB} dB; at {SERVE_GAN_EPOCHS} printed"}


def corpus_spectrograms(n: int):
    """n Part-1-style inputs: the normalized (513, 1723) magnitudes of the
    serve corpus's clean clips (cycled), each with its own frame mask."""
    from audio_inpainting_torch.corrupt import random_frame_mask, synth_music_clip
    from audio_inpainting_torch.ops import magphase, stft, torch_stft_config

    mags, masks = [], []
    for i in range(n):
        clip = torch.as_tensor(synth_music_clip(10 + i % SERVE_CLIPS, SR, 10.0))
        mag, _ = magphase(stft(clip, torch_stft_config(1024, 256)))
        mags.append(mag / mag.max())
        masks.append(random_frame_mask(torch.Generator().manual_seed(i), *mag.shape))
    return torch.stack(mags), torch.stack(masks)


def batch_vs_single(dev) -> dict:
    """restore_clips_unet and restore_clips_gan (fp32) on the four corpus
    spectrograms against unet_train_restore and gan_train_restore on
    clips 0 and 3, from the same init, at UNET_HELD_EPOCHS and
    GAN_HELD_EPOCHS with cuDNN's deterministic kernels."""
    from audio_inpainting_torch.methods import neural
    from audio_inpainting_torch.parallel import restore_clips_gan, restore_clips_unet

    mags, masks = corpus_spectrograms(SERVE_CLIPS)
    inp, real, msk = gan_inputs(mags, masks)
    seeds = [100 + g for g in range(SERVE_CLIPS)]

    def unet(epochs):
        cfg = neural.UNetTrainConfig(epochs=epochs)
        out, loss = restore_clips_unet(mags[..., None], masks[..., None], cfg, seeds,
                                       device=dev)
        singles = {g: neural.unet_train_restore(mags[g], masks[g], cfg, seeds[g],
                                                device=dev)
                   for g in BATCH_VS_SINGLE_CLIPS}
        return {g: {"unet_loss_rel_err": rel_err(loss[g], one[2][-1]),
                    "unet_composite_err": rel_err(out[g, ..., 0], one[0])}
                for g, one in singles.items()}

    def gan(epochs):
        cfg = neural.GANTrainConfig(epochs=epochs, ema_decay=0.99, ema_scope="gap")
        out, (dl, gl) = restore_clips_gan(inp, real, msk, cfg, seeds, device=dev)
        singles = {g: neural.gan_train_restore(inp[g], real[g], msk[g], cfg, seeds[g],
                                               device=dev)
                   for g in BATCH_VS_SINGLE_CLIPS}
        return {g: {"gan_d_loss_rel_err": rel_err(dl[g], one[1][0][-1]),
                    "gan_g_loss_rel_err": rel_err(gl[g], one[1][1][-1]),
                    "gan_composite_err": rel_err(out[g], one[0])}
                for g, one in singles.items()}

    with cudnn_deterministic():
        held = {"unet": unet(UNET_HELD_EPOCHS), "gan": gan(GAN_HELD_EPOCHS)}
    for g in BATCH_VS_SINGLE_CLIPS:
        for key, tol in (("unet_loss_rel_err", NEURAL_LOSS_RTOL),
                         ("unet_composite_err", UNET_COMPOSITE_TOL)):
            if not held["unet"][g][key] <= tol:
                raise AssertionError(f"batch vs single, clip {g}, {UNET_HELD_EPOCHS} "
                                     f"epochs: {key} {held['unet'][g][key]} > {tol}")
        for key, tol in (("gan_d_loss_rel_err", NEURAL_LOSS_RTOL),
                         ("gan_g_loss_rel_err", NEURAL_LOSS_RTOL),
                         ("gan_composite_err", GAN_COMPOSITE_TOL)):
            if not held["gan"][g][key] <= tol:
                raise AssertionError(f"batch vs single, clip {g}, {GAN_HELD_EPOCHS} "
                                     f"epochs: {key} {held['gan'][g][key]} > {tol}")
    return {"dtype": "fp32, TF32 off",
            "tolerance": f"losses within {NEURAL_LOSS_RTOL:g} relative; composites "
                         f"within {UNET_COMPOSITE_TOL:g} (U-Net) and "
                         f"{GAN_COMPOSITE_TOL:g} (GAN) of their peak, at "
                         f"{UNET_HELD_EPOCHS} (U-Net) and {GAN_HELD_EPOCHS} (GAN) epochs",
            "held_epochs": {"unet": UNET_HELD_EPOCHS, "gan": GAN_HELD_EPOCHS},
            "held": held}


def group_sweep(dev) -> dict:
    """ms per epoch of G clips as one grouped net (CUDA events, 20 epochs a
    round, the median of 3 rounds after 3 warm epochs), device calls and
    busy share over 10 profiled epochs, peak memory; each set against
    G x the G = 1 epoch. The peak that a group adds may not pass G clips'
    footprint (parallel/batch.py, clip_bytes), which sizes serving's
    groups."""
    from audio_inpainting_torch.methods import neural
    from audio_inpainting_torch.parallel.batch import clip_bytes

    mags, masks = corpus_spectrograms(max(UNET_GROUP_SIZES))
    mags, masks = mags.to(dev), masks.to(dev)
    makers = {
        "unet_fp32": ("unet", False, UNET_GROUP_SIZES, lambda m, k, s: neural.UNetTrainer(
            m, k, neural.UNetTrainConfig(bf16=False), s)),
        "unet_bf16": ("unet", True, UNET_GROUP_SIZES, lambda m, k, s: neural.UNetTrainer(
            m, k, neural.UNetTrainConfig(bf16=True), s)),
        "gan_bf16": ("gan", True, GAN_GROUP_SIZES, lambda m, k, s: neural.GANTrainer(
            *gan_inputs(m, k), neural.GANTrainConfig(bf16=True, ema_decay=0.99,
                                                     ema_scope="gap"), s))}
    out = {}
    for name, (kind, bf16, sizes, make) in makers.items():
        rows = []
        per_clip = clip_bytes(kind, bf16, *mags.shape[1:])
        for g in sizes:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            trainer = make(mags[:g], masks[:g], list(range(g)))
            for _ in range(3):
                trainer.epoch()
            ms = cuda_ms(trainer.epoch, calls=20, rounds=3, warmup=0)
            n_prof = 10
            prof = device_profile(lambda: [trainer.epoch() for _ in range(n_prof)],
                                  top=4, kernel="conv")
            single = rows[0]["ms_per_epoch"] if rows else ms
            rows.append({"G": g, "ms_per_epoch": ms, "ms_per_clip_epoch": ms / g,
                         "vs_G_single_epochs": ms / (g * single),
                         "device_calls_per_epoch": prof["device_calls"] / n_prof,
                         "device_busy_ms_per_epoch": prof["device_busy_ms"] / n_prof,
                         "busy_share_unprofiled": prof["device_busy_ms"] / n_prof / ms,
                         "top": prof["top"],
                         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "added_peak_over_footprint":
                             (torch.cuda.max_memory_allocated() - base) / (g * per_clip)})
            del trainer
            if not rows[-1]["added_peak_over_footprint"] <= 1.0:
                raise AssertionError(f"{name}, G = {g}: the epoch's peak passes G clips' "
                                     f"footprint: {rows[-1]}")
        out[name] = {"clip_footprint_gb": per_clip / 1e9, "rows": rows}
    return out


def window_batch(clip) -> dict:
    """restore_windowed(method="unet") over the engine clip's first 20 s,
    window by window (one facade call each) and batched (one
    restore_clips_unet per window size): at 100 epochs the walls, clean
    samples bit-identical both ways, the agreement of batched and window
    by window; at UNET_HELD_EPOCHS, with cuDNN's deterministic kernels,
    batched against window by window >= 60 dB over the damage."""
    from audio_inpainting_torch import api
    from audio_inpainting_torch.methods.windowed import restore_windowed
    from audio_inpainting_torch.parallel import batch

    _, damaged, touched = clip
    n = int(WINDOW_BATCH_SECONDS * SR)
    damaged, touched = damaged[:n], touched[:n]

    def run(batched, epochs):
        kw = dict(method="unet", window_s=WINDOW_S, margin=MARGIN, seed=0, epochs=epochs)
        with Spy(api, "restore") as facade_calls, \
                Spy(batch, "restore_clips_unet",
                    keep=lambda m, *a, **k: int(m.shape[0])) as classes:
            out, wall_s = timed(lambda: restore_windowed(damaged, SR,
                                                         batch_windows=batched, **kw))
        if out.shape != damaged.shape or not np.array_equal(out[~touched],
                                                             damaged[~touched]):
            raise AssertionError(f"unet window batch ({batched}, {epochs} epochs): "
                                 "changed samples outside the gaps +- margin")
        return {"out": out, "wall_s": wall_s, "facade_calls": len(facade_calls.calls),
                "class_sizes": classes.calls}

    def agree(a, b):
        return agreement_snr_db(torch.as_tensor(a["out"][touched]),
                                torch.as_tensor(b["out"][touched]))

    seq, bat = run(False, WINDOW_BATCH_EPOCHS), run(True, WINDOW_BATCH_EPOCHS)
    with cudnn_deterministic():
        held_snr = agree(run(False, UNET_HELD_EPOCHS), run(True, UNET_HELD_EPOCHS))
    if not held_snr >= WINDOW_BATCH_AGREEMENT_DB:
        raise AssertionError(f"unet window batch vs window by window at "
                             f"{UNET_HELD_EPOCHS} epochs: {held_snr} dB")
    return {"seconds": WINDOW_BATCH_SECONDS, "window_s": WINDOW_S,
            "epochs": WINDOW_BATCH_EPOCHS, "windows": seq["facade_calls"],
            "class_sizes": bat["class_sizes"], "wall_s_window_by_window": seq["wall_s"],
            "wall_s_batched": bat["wall_s"], "agreement_snr_db": agree(seq, bat),
            "held_epochs": UNET_HELD_EPOCHS, "held_agreement_snr_db": held_snr,
            "tolerance": f">= {WINDOW_BATCH_AGREEMENT_DB} dB at {UNET_HELD_EPOCHS} "
                         f"epochs; at {WINDOW_BATCH_EPOCHS} printed"}


def live_api(dev, tmp: Path):
    """The live API on an ephemeral port, in a thread: ar on the facade's
    10 s clip, ar with window_s=2 on the 60 s engine clip, and linear;
    each response byte-equal to the facade's (or the windowed engine's)
    restore through the int16 chain; latency and launches per request."""
    from audio_inpainting_torch import api
    from audio_inpainting_torch.demo.live import make_handler
    from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.methods.windowed import restore_windowed
    from audio_inpainting_torch.ops import ar_scan

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), make_handler(str(tmp), dev))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/api/restore"
    requests = [("ar", tmp / "damaged.wav", "method=ar", None),
                ("ar_window_2s", tmp / "engine.wav", f"method=ar&window_s={WINDOW_S}",
                 WINDOW_S),
                ("linear", tmp / "damaged.wav", "method=linear", None)]
    rows, calls, total = {}, [], 0
    try:
        for name, path, query, window_s in requests:
            body = path.read_bytes()
            with Spy(ar, "ar_extrapolate", keep=keep_kernel_args) as spy, \
                    Spy(api, "restore") as facade_calls:
                ar_scan.LAUNCHES = 0
                t0 = time.perf_counter()
                with urllib.request.urlopen(urllib.request.Request(
                        f"{url}?{query}", data=body, method="POST"), timeout=600) as r:
                    got = r.read()
                latency_ms = (time.perf_counter() - t0) * 1e3
                launches = ar_scan.LAUNCHES
            calls.extend(spy.calls)
            total += launches
            _, x = load_mono_normalized(str(path))
            method = query.split("&")[0].split("=")[1]
            want = (restore_windowed(x, SR, method=method, window_s=window_s)
                    if window_s else api.restore(x, SR, method=method))
            save_wav_int16(want, SR, str(tmp / "live_want.wav"))
            if got != (tmp / "live_want.wav").read_bytes():
                raise AssertionError(f"live {name}: the response is not the "
                                     "facade's restore")
            expect = 2 * len(facade_calls.calls) if method == "ar" else 0
            if launches != expect:
                raise AssertionError(f"live {name}: {launches} launches, not {expect}")
            rows[name] = {"samples": len(x), "latency_ms": latency_ms,
                          "launches": launches, "facade_calls": len(facade_calls.calls),
                          "byte_equal": True}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    return rows, kernel_rows("live", calls), total


# ------------------------------------------------------------ phase multi --


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` replaced by ``value`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def multi_inputs():
    """Mode 1's batch at full width: (4, 516, 1728, 1) input, target and
    mask from a numpy seed."""
    rng = np.random.RandomState(0)
    shape = (*MULTI_SHAPE, 1)
    tgt = rng.rand(*shape).astype(np.float32)
    mask = (rng.rand(*shape) > 0.3).astype(np.float32)
    return tgt * mask, tgt, mask


def multi_mode1(ranks) -> dict:
    """The shared U-Net over the ranks' dp axis: a whole fit_shared_unet
    call of MULTI_STEPS steps (its loss is the one compared; its wall
    holds the uploads, the model's build and the state's copy back), then
    the steps alone: the model and the rank's shards built once, one cold
    step, and MULTI_STEPS steps timed each to the end of its device work
    (every rank's, the all-reduce waiting for the others); and the
    all-reduce alone of a buffer of the parameters' size, the sum
    checked. One rank also times steps at half the batch, the share of
    each of two ranks."""
    from audio_inpainting_torch.parallel import fit_shared_unet, init_shared_unet
    from audio_inpainting_torch.parallel.mesh import all_reduce_sum, shard_batch
    from audio_inpainting_torch.parallel.train import nchw, shared_unet_train_step

    x, y, m = multi_inputs()
    fit_shared_unet(x, y, m, ranks, steps=1)                   # cold
    (_, loss), fit_s = timed(lambda: fit_shared_unet(x, y, m, ranks, steps=MULTI_STEPS))
    (model, opt, xs, ys, ms_), setup_s = timed(lambda: (
        *init_shared_unet(ranks),
        *(shard_batch(nchw(a, ranks.device), ranks) for a in (x, y, m))))
    n_cells = x.size

    def step():
        return shared_unet_train_step(model, opt, xs, ys, ms_, ranks, n_cells)

    step()                                                     # cold
    step_ms = [timed(step)[1] * 1e3 for _ in range(MULTI_STEPS)]
    res = {}
    if ranks.world == 1:
        # one rank at half the batch: two ranks' share each
        half = [a[:len(a) // 2] for a in (xs, ys, ms_)]
        shared_unet_train_step(model, opt, *half, ranks, n_cells)     # cold
        res["half_batch_step_ms"] = [timed(lambda: shared_unet_train_step(
            model, opt, *half, ranks, n_cells))[1] * 1e3 for _ in range(MULTI_STEPS)]
    n = sum(p.numel() for p in model.parameters()) + 1
    buf = torch.ones(n, device=ranks.device)
    all_reduce_sum(buf, ranks)
    if not torch.all(buf == ranks.world):
        raise AssertionError(f"multi: the all-reduce over {ranks.world} ranks "
                             f"gave {buf.unique().tolist()}")
    reduce_ms = [timed(lambda: all_reduce_sum(buf, ranks))[1] * 1e3 for _ in range(10)]
    return {"loss": loss, "fit_call_s": fit_s, "setup_s": setup_s, "step_ms": step_ms,
            "fit_call_less_steps_s": fit_s - sum(step_ms) / 1e3, **res,
            "all_reduce_floats": n, "all_reduce_ms": reduce_ms}


def ranks_batches(fn, world: int, n: int):
    """One rank running the ranks' batches: ``fn(rows)`` for every rank's
    rows of an n-item batch (padded as the ranks pad it), concatenated on
    the CPU and cut to n."""
    from audio_inpainting_torch.parallel.mesh import split_rows

    return torch.cat([fn(rows.tolist()).cpu() for rows in split_rows(n, world)])[:n]


def multi_clips(ranks, lead: bool) -> dict:
    """Modes 2 and 5 on the serve corpus's spectrograms: the per-clip
    U-Nets (fp32) and GANs (bf16) with the clips over the ranks, against
    one rank running the ranks' batches (1e-5 of peak), and at
    UNET_HELD_EPOCHS / GAN_HELD_EPOCHS fp32 against one rank's whole
    batch by twice the batch-against-single bounds (a rank's batch and
    the whole batch each part from single clips by up to one bound);
    cuDNN deterministic."""
    from audio_inpainting_torch.methods import neural
    from audio_inpainting_torch.parallel import restore_clips_gan, restore_clips_unet

    mags, masks = corpus_spectrograms(SERVE_CLIPS)
    inp, real, msk = gan_inputs(mags, masks)
    seeds = [100 + g for g in range(SERVE_CLIPS)]
    dev, world, n = ranks.device, ranks.world, SERVE_CLIPS

    def unet(epochs, r=None):
        cfg = neural.UNetTrainConfig(epochs=epochs)
        if r is None:
            return restore_clips_unet(mags[..., None], masks[..., None], cfg, seeds,
                                      ranks=ranks)[0][..., 0]
        return restore_clips_unet(mags[r, ..., None], masks[r, ..., None], cfg,
                                  [seeds[i] for i in r], device=dev)[0][..., 0]

    def gan(epochs, bf16, r=None):
        cfg = neural.GANTrainConfig(epochs=epochs, bf16=bf16, ema_decay=0.99,
                                    ema_scope="gap")
        if r is None:
            return restore_clips_gan(inp, real, msk, cfg, seeds, ranks=ranks)[0]
        return restore_clips_gan(inp[r], real[r], msk[r], cfg, [seeds[i] for i in r],
                                 device=dev)[0]

    res = {}
    with cudnn_deterministic():
        uout, res["unet_wall_s"] = timed(lambda: unet(MULTI_UNET_EPOCHS))
        gout, res["gan_wall_s"] = timed(lambda: gan(MULTI_GAN_EPOCHS, True))
        uheld, gheld = unet(UNET_HELD_EPOCHS), gan(GAN_HELD_EPOCHS, False)
        if lead:
            res["unet_vs_ranks_batches_err"] = rel_err(uout, ranks_batches(
                lambda r: unet(MULTI_UNET_EPOCHS, r), world, n))
            res["gan_vs_ranks_batches_err"] = rel_err(gout, ranks_batches(
                lambda r: gan(MULTI_GAN_EPOCHS, True, r), world, n))
            every = list(range(n))
            res["unet_held_vs_one_rank_err"] = rel_err(uheld, unet(UNET_HELD_EPOCHS, every))
            res["gan_held_vs_one_rank_err"] = rel_err(gheld, gan(GAN_HELD_EPOCHS, False,
                                                                 every))
            for key, tol in (("unet_vs_ranks_batches_err", RANKS_ATOL),
                             ("gan_vs_ranks_batches_err", RANKS_ATOL),
                             ("unet_held_vs_one_rank_err", 2 * UNET_COMPOSITE_TOL),
                             ("gan_held_vs_one_rank_err", 2 * GAN_COMPOSITE_TOL)):
                if not res[key] <= tol:
                    raise AssertionError(f"multi at {world} ranks: {key} {res[key]} > {tol}")
    return res


def multi_windows(ranks, lead: bool, damaged, touched) -> dict:
    """Mode 6: the 60 s engine clip's batched AR classes over the ranks
    (restore_windowed, batch_windows=True), against one rank running the
    ranks' batches (1e-5 of peak) and one rank's whole classes (the
    windowed phase's batched-against-sequential bounds)."""
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.methods.windowed import restore_windowed
    from audio_inpainting_torch.ops import ar_scan

    kw = dict(method="ar", window_s=WINDOW_S, margin=MARGIN, seed=0, batch_windows=True)
    with Spy(ar, "ar_extrapolate", keep=keep_kernel_args) as spy:
        ar_scan.LAUNCHES = 0
        out, wall = timed(lambda: restore_windowed(damaged, SR, ranks=ranks, **kw))
        launches = ar_scan.LAUNCHES
    res = {"wall_s": wall, "launches": launches, "calls": spy.calls}
    if not np.array_equal(out[~touched], damaged[~touched]):
        raise AssertionError("multi windows changed samples outside the gaps +- margin")
    if lead:
        real = ar.ar_restore_gaps_windows

        def split(signals, gaps_list, cfg, seed=0, **k):
            sig = torch.as_tensor(signals)
            return ranks_batches(lambda r: real(sig[r], [gaps_list[i] for i in r], cfg,
                                                seed, **k), ranks.world, len(gaps_list))

        with patched(ar, "ar_restore_gaps_windows", split):
            same = restore_windowed(damaged, SR, device=ranks.device, **kw)
        one = restore_windowed(damaged, SR, device=ranks.device, **kw)
        peak = np.abs(one).max()
        res.update(vs_ranks_batches_err=float(np.abs(out - same).max() / peak),
                   vs_one_rank_err=float(np.abs(out - one).max() / peak),
                   vs_one_rank_agreement_db=agreement_snr_db(
                       torch.as_tensor(one[touched]), torch.as_tensor(out[touched])))
        if not (res["vs_ranks_batches_err"] <= RANKS_ATOL
                and res["vs_one_rank_err"] <= BATCH_ERR_OF_PEAK
                and res["vs_one_rank_agreement_db"] >= BATCH_AGREEMENT_DB):
            raise AssertionError(f"multi windows at {ranks.world} ranks: "
                                 f"{ {k: v for k, v in res.items() if k != 'calls'} }")
    return res


def gp_batch_probe(x, y, cfg, world: int) -> dict:
    """Where a GP restart's gradient moves with its batch on the card
    (ROADMAP Queue 3, F3), at the rows of each of ``world`` ranks, each
    reading the largest difference from the same rows of the whole batch
    over the whole batch's largest: the values and gradients in a batch
    of the rows alone (``sub_batch_*``) and as ``gp.fit_rows`` evaluates
    them, at the whole batch's shape and their own places
    (``grad_batch_rel``, ``value_batch_rel``); and, fed the whole batch's
    upstream gradients, each stage's backward in a batch of the rows
    alone: the Cholesky factorization, its solve and log-determinant
    (onto the kernel matrices), and the kernel's (onto theta)."""
    from audio_inpainting_torch.methods import gp
    from audio_inpainting_torch.parallel.mesh import split_rows

    u0, loss, to_theta = gp._restarts(x, y, cfg, 0)
    v_all, g_all = gp._value_and_grad(loss, u0)

    def stages(u, d_k=None):
        """(dL/dK, dL/dtheta) of the rows u, the latter fed d_k."""
        with torch.enable_grad():
            theta = to_theta(u).detach().requires_grad_(True)
            k = gp._kernel_matrix(theta, x, cfg.jitter)
            kk = k.detach().requires_grad_(True)
            (dk,) = torch.autograd.grad(gp._neg_mll_of(kk, y).sum(), kk)
            (dth,) = torch.autograd.grad(k, theta, grad_outputs=dk if d_k is None else d_k)
        return dk, dth

    dk_all, dth_all = stages(u0)
    res = {k: 0.0 for k in ("sub_batch_value_rel", "sub_batch_grad_rel", "value_batch_rel",
                            "grad_batch_rel", "cholesky_backward_rel",
                            "kernel_backward_rel")}

    def worst(key, got, want, scale):
        res[key] = max(res[key], float((got - want).abs().max() / scale.abs().max()))

    for rows in split_rows(len(u0), world, fill=0):
        idx = torch.as_tensor(rows, device=x.device)
        v, g = gp._value_and_grad(loss, u0[idx])
        worst("sub_batch_value_rel", v, v_all[idx], v_all)
        worst("sub_batch_grad_rel", g, g_all[idx], g_all)
        v, g = gp._value_and_grad(loss, gp.restart_layout(u0, idx))
        worst("value_batch_rel", v[idx], v_all[idx], v_all)
        worst("grad_batch_rel", g[idx], g_all[idx], g_all)
        dk, dth = stages(u0[idx], dk_all[idx])
        worst("cholesky_backward_rel", dk, dk_all[idx], dk_all)
        worst("kernel_backward_rel", dth, dth_all[idx], dth_all)
    return res


def multi_gp(ranks, lead: bool, clean) -> dict:
    """Mode 7 on Part 0's segment (facade_gp's): the restarts over the
    ranks, against one rank running the ranks' batches and one rank's
    gp_fit_predict (the posterior within GP_RANKS_ATOL, the winner's theta
    within GP_THETA_RTOL), with gp_batch_probe's readings: a restart's
    value and gradient as the ranks evaluate them must be the bits of
    the whole batch's (F3, ROADMAP Queue 3)."""
    from audio_inpainting_torch.corrupt import contiguous_gap_mask
    from audio_inpainting_torch.methods import gp
    from audio_inpainting_torch.metrics import local_snr_db
    from audio_inpainting_torch.parallel import Ranks, gp_fit_predict_mesh

    n = int(0.05 * SR)
    seg = clean[len(clean) // 2:len(clean) // 2 + n]
    _, (gs, ge) = contiguous_gap_mask(n, 0.2)
    keep = np.ones(n, bool)
    keep[gs:ge] = False
    t = np.arange(n, dtype=np.float32) / SR
    args = (t[keep], seg[keep], t[~keep], gp.GPConfig())
    (mu, sd, theta), wall = timed(lambda: gp_fit_predict_mesh(*args, ranks, 0))
    res = {"wall_s": wall, "restarts": gp.GPConfig().n_restarts + 1}
    if lead:
        def one_rank_fit(x, y):     # gp_fit_predict's fit
            res.update(gp_batch_probe(x, y, args[3], ranks.world))
            return gp._fit(x, y, args[3], 0)

        mu_s, sd_s, _ = gp_fit_predict_mesh(*args, Ranks.solo(ranks.device), 0,
                                            batches=ranks.world)
        mu_1, _, theta_1 = gp.fit_predict_with(one_rank_fit, *args, ranks.device)
        fill, fill_1 = seg.copy(), seg.copy()
        fill[gs:ge], fill_1[gs:ge] = mu.cpu().numpy(), mu_1.cpu().numpy()
        res.update(vs_ranks_batches_err=max(float((mu - mu_s).abs().max()),
                                            float((sd - sd_s).abs().max())),
                   vs_one_rank_err=float((mu - mu_1).abs().max()),
                   theta_vs_one_rank_rel=float(((theta - theta_1) / theta_1).abs().max()),
                   local_snr_db=float(local_snr_db(seg, fill, gs, ge, ranks.device)),
                   one_rank_local_snr_db=float(local_snr_db(seg, fill_1, gs, ge,
                                                            ranks.device)))
        if not (res["grad_batch_rel"] == 0.0 and res["value_batch_rel"] == 0.0
                and res["vs_ranks_batches_err"] <= GP_RANKS_ATOL
                and res["vs_one_rank_err"] <= GP_RANKS_ATOL
                and res["theta_vs_one_rank_rel"] <= GP_THETA_RTOL
                and res["local_snr_db"] >= res["one_rank_local_snr_db"] - GP_MARGIN_DB):
            raise AssertionError(f"multi gp at {ranks.world} ranks: {res}")
    return res


def multi_stft(ranks, lead: bool, damaged) -> dict:
    """The frame-parallel STFT of the 60 s clip against ops.stft."""
    from audio_inpainting_torch.ops import stft, torch_stft_config
    from audio_inpainting_torch.parallel import stft_frame_parallel

    cfg = torch_stft_config(1024, 256)
    (re, im), wall = timed(lambda: stft_frame_parallel(damaged, cfg, ranks))
    res = {"wall_s": wall, "frames": int(re.shape[0])}
    if lead:
        z = stft(torch.as_tensor(damaged, device=ranks.device), cfg).T
        res["rel_err_of_peak"] = max(rel_err(re, z.real), rel_err(im, z.imag))
        if not res["rel_err_of_peak"] <= STFT_RTOL_OF_PEAK:
            raise AssertionError(f"multi stft: {res}")
    return res


def multi_serve(ranks, lead: bool, din: Path, tmp: Path) -> dict:
    """serve_ranks over the four clips: ar (every WAV byte-equal to one
    rank's) and the U-Net at UNET_HELD_EPOCHS, cuDNN deterministic (WAVs
    within BATCH_AGREEMENT_DB of one rank's)."""
    from audio_inpainting_torch.io import load_mono_normalized
    from audio_inpainting_torch.methods import ar
    from audio_inpainting_torch.ops import ar_scan
    from audio_inpainting_torch.parallel import Ranks
    from audio_inpainting_torch.pipelines.serve import serve_ranks

    out = tmp / f"multi_serve_{ranks.world}"
    with Spy(ar, "ar_extrapolate", keep=keep_kernel_args) as spy:
        ar_scan.LAUNCHES = 0
        res_ar, wall_ar = timed(lambda: serve_ranks(ranks, str(din), str(out / "ar"), "ar"))
        launches = ar_scan.LAUNCHES
    with cudnn_deterministic():
        _, wall_unet = timed(lambda: serve_ranks(ranks, str(din), str(out / "unet"), "unet",
                                                 epochs=UNET_HELD_EPOCHS))
    res = {"ar_wall_s": wall_ar, "unet_wall_s": wall_unet, "launches": launches,
           "calls": spy.calls, "clips": res_ar["clips"]}
    if lead:
        solo = Ranks.solo(ranks.device)
        serve_ranks(solo, str(din), str(out / "ar1"), "ar")
        with cudnn_deterministic():
            serve_ranks(solo, str(din), str(out / "unet1"), "unet", epochs=UNET_HELD_EPOCHS)
        agreement = []
        for name in sorted(res_ar["files"]):
            if (out / "ar" / name).read_bytes() != (out / "ar1" / name).read_bytes():
                raise AssertionError(f"multi serve ar: {name} differs from one rank's")
            agreement.append(agreement_snr_db(
                torch.as_tensor(load_mono_normalized(str(out / "unet1" / name))[1]),
                torch.as_tensor(load_mono_normalized(str(out / "unet" / name))[1])))
        res.update(ar_byte_equal=True, unet_agreement_db=agreement)
        if not min(agreement) >= BATCH_AGREEMENT_DB:
            raise AssertionError(f"multi serve unet: agreement {agreement} dB")
    return res


def multi_rank(ranks, tmp: str, modes: tuple[str, ...]) -> dict:
    """One rank of phase ``multi``: ``modes`` of "mode1", "clips",
    "windows", "gp", "stft", "serve", in that order, each timed; rank 0
    also holds each against one rank. Returns, on rank 0, the results,
    with every rank's launch counts, peak memory and start time."""
    from audio_inpainting_torch.parallel.mesh import gather_objects

    ready = time.time()
    lead, tmp = ranks.rank == 0, Path(tmp)
    torch.cuda.reset_peak_memory_stats(ranks.device)
    res = {"backend": ranks.backend, "ranks": ranks.world}
    if "mode1" in modes:
        res["mode1"] = multi_mode1(ranks)
    if "clips" in modes:
        res["clips"] = multi_clips(ranks, lead)
    if {"windows", "gp", "stft"} & set(modes):
        engine = np.load(tmp / "engine.npz")
        damaged, touched = engine["damaged"], engine["touched"]
    if "windows" in modes:
        res["windows"] = multi_windows(ranks, lead, damaged, touched)
    if "gp" in modes:
        res["gp"] = multi_gp(ranks, lead, np.load(tmp / "facade_clean.npy"))
    if "stft" in modes:
        res["stft"] = multi_stft(ranks, lead, damaged)
    if "serve" in modes:
        res["serve"] = multi_serve(ranks, lead, tmp / "serve_in", tmp)
    launches = {k: res[k]["launches"] for k in ("windows", "serve") if k in res}
    res.update(ready_by_rank=gather_objects(ready, ranks),
               launches_by_rank=gather_objects(launches, ranks),
               peak_gb_by_rank=gather_objects(
                   torch.cuda.max_memory_allocated(ranks.device) / 1e9, ranks))
    calls = {k: res[k].pop("calls") for k in launches}
    # the kernel at rank 0's shapes, alone, against its plain loop
    res["kernel_rows"] = [row for k, c in calls.items()
                          for row in kernel_rows(f"multi_{k}", c)] if lead else []
    return res


def spatial_inputs():
    """Two 60 s spectrograms (synth_music_clip 3 and 4), normalized,
    padded to F % 4 and T % 16, a seeded 20 % of their columns hidden."""
    from audio_inpainting_torch.corrupt import synth_music_clip
    from audio_inpainting_torch.ops import magphase, stft, torch_stft_config

    mags = []
    for seed in (3, 4):
        mag, _ = magphase(stft(torch.as_tensor(synth_music_clip(seed, SR, ENGINE_SECONDS)),
                               torch_stft_config(1024, 256)))
        f, t = mag.shape
        mags.append(torch.nn.functional.pad(mag / mag.max(), (0, (-t) % 16, 0, (-f) % 4)))
    tgt = torch.stack(mags)[..., None].numpy()
    rng = np.random.RandomState(0)
    mask = np.broadcast_to((rng.rand(1, 1, tgt.shape[2], 1) > 0.2), tgt.shape)
    mask = mask.astype(np.float32)
    return tgt * mask, tgt, mask


def spatial_rank(ranks) -> dict:
    """Mode 3 on a 2 x 2 mesh: the shared U-Net with the two 60 s
    spectrograms over dp and their time axis over tp, MULTI_SPATIAL_STEPS
    Adam steps and a forward; rank 0 holds both against one rank."""
    from audio_inpainting_torch.parallel import (Ranks, fit_shared_unet_spatial,
                                                 make_mesh_2d, predict_spatial)
    from audio_inpainting_torch.parallel.mesh import gather_objects

    ready = time.time()
    torch.cuda.reset_peak_memory_stats(ranks.device)
    mesh2 = make_mesh_2d(ranks, 2, 2)
    inp, tgt, m = spatial_inputs()
    fit_shared_unet_spatial(inp, tgt, m, mesh2, steps=1)           # cold
    (state, loss), fit_s = timed(lambda: fit_shared_unet_spatial(
        inp, tgt, m, mesh2, steps=MULTI_SPATIAL_STEPS))
    fwd, fwd_s = timed(lambda: predict_spatial(state, tgt, mesh2))
    res = {"shape": list(tgt.shape[:3]), "loss": loss, "fit_wall_s": fit_s,
           "forward_wall_s": fwd_s,
           "peak_gb_by_rank": gather_objects(
               torch.cuda.max_memory_allocated(ranks.device) / 1e9, ranks),
           "ready_by_rank": gather_objects(ready, ranks)}
    if ranks.rank == 0:
        solo = Ranks.solo(ranks.device)
        fit_shared_unet_spatial(inp, tgt, m, solo, steps=1)            # cold
        (_, loss1), res["one_rank_fit_wall_s"] = timed(lambda: fit_shared_unet_spatial(
            inp, tgt, m, solo, steps=MULTI_SPATIAL_STEPS))
        fwd1, res["one_rank_forward_wall_s"] = timed(lambda: predict_spatial(state, tgt, solo))
        res.update(dloss=abs(loss - loss1), forward_err=float((fwd - fwd1).abs().max()),
                   one_rank_peak_gb=torch.cuda.max_memory_allocated(ranks.device) / 1e9)
        if not (res["dloss"] <= RANKS_ATOL and res["forward_err"] <= RANKS_ATOL):
            raise AssertionError(f"multi spatial: {res}")
    return res


def launched(fn, world: int, **kw):
    """(rank 0's result of launch(fn, world, **kw), the seconds from the
    call to the last rank's start)."""
    from audio_inpainting_torch.parallel import launch

    t0 = time.time()
    res = launch(fn, world, **kw)
    return res, max(res["ready_by_rank"]) - t0


def phase_multi(dev, tmp: Path, clip):
    """The multi-device layer: one rank on NCCL (modes 1 and 7, NCCL's
    all-reduce, broadcast and all-gather run at world 1), two ranks and
    four (dp 2 x tp 2) sharing this card over gloo (modes 1, 2, 3, 5, 6,
    7, the frame-parallel STFT, serve's rank body), each mode held
    against one rank; on a machine with two cards, the two-rank run on
    NCCL, one rank a card, and run_serve(devices=2). Ranks that share a
    card measure the layer's overhead, not scaling."""
    from audio_inpainting_torch.corrupt import synth_music_clip

    _, damaged, touched = clip
    mdir = tmp / "multi"
    mdir.mkdir()
    np.savez(mdir / "engine.npz", damaged=damaged, touched=touched)
    np.save(mdir / "facade_clean.npy", synth_music_clip(0, SR, 10.0))
    serve_corpus(mdir)
    torch.cuda.empty_cache()        # the ranks' processes share the card
    every = ("mode1", "clips", "windows", "gp", "stft", "serve")
    t0 = time.perf_counter()
    one, one_s = launched(multi_rank, 1, devices=MULTI_DEVICE,
                          args=(str(mdir), ("mode1", "gp")))
    two, two_s = launched(multi_rank, 2, devices=MULTI_DEVICE, backend="gloo",
                          args=(str(mdir), every))
    four, four_s = launched(spatial_rank, 4, devices=MULTI_DEVICE, backend="gloo")
    dloss = abs(two["mode1"]["loss"] - one["mode1"]["loss"])
    if not dloss <= RANKS_ATOL:
        raise AssertionError(f"multi mode 1: two ranks' loss {two['mode1']['loss']} "
                             f"against one rank's {one['mode1']['loss']}")
    for r, counts in enumerate(two["launches_by_rank"]):
        if not all(counts.values()):
            raise AssertionError(f"multi: rank {r} launched no kernel on a path: {counts}")
    nccl = "not run: 1 card"
    if torch.cuda.device_count() >= 2:
        nccl = multi_cards(mdir, every)
    else:
        print("multi: the multi-card NCCL path was not run on 1 card", flush=True)
    launches = sum(sum(c.values()) for c in two["launches_by_rank"])
    rows = two.pop("kernel_rows")
    emit({"phase": "multi", "wall_s": time.perf_counter() - t0,
          "launch_s": {"1_nccl": one_s, "2_gloo": two_s, "4_gloo": four_s},
          "one_rank_nccl": one, "two_ranks_gloo": two, "four_ranks_gloo_2x2": four,
          "mode1_dloss_two_vs_one": dloss, "two_cards_nccl": nccl,
          "tolerance": f"ranks against one rank's batches {RANKS_ATOL:g} (of peak); "
                       f"against one rank: losses {RANKS_ATOL:g}, GP {GP_RANKS_ATOL:g}, "
                       f"the batch-against-single and windowed bounds",
          "kernels": rows})
    return {"multi": launches}, rows


def multi_cards(mdir: Path, every: tuple[str, ...]) -> dict:
    """On two cards or more: the two-rank run on NCCL, one rank a card
    (and the 2 x 2 mesh on four cards), and run_serve(devices=2) with ar,
    byte-equal to devices=1."""
    from audio_inpainting_torch.pipelines.serve import run_serve

    two, two_s = launched(multi_rank, 2, args=(str(mdir), every))
    two.pop("kernel_rows")
    res = {"launch_s": {"2_nccl": two_s}, "two_ranks_nccl": two}
    if torch.cuda.device_count() >= 4:
        res["four_ranks_nccl_2x2"], res["launch_s"]["4_nccl"] = launched(spatial_rank, 4)
    one = run_serve(str(mdir / "serve_in"), str(mdir / "cards_1"), method="ar")
    both = run_serve(str(mdir / "serve_in"), str(mdir / "cards_2"), method="ar", devices=2)
    for name in one["files"]:
        if (mdir / "cards_1" / name).read_bytes() != (mdir / "cards_2" / name).read_bytes():
            raise AssertionError(f"run_serve(devices=2): {name} differs from devices=1")
    return {**res, "serve_devices_2_wall_s": both["wall_s"], "serve_byte_equal": True}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase_env(dev)
    if argv in (["multi"], ["prior"]):      # one phase alone, for work on it
        with tempfile.TemporaryDirectory() as tmp:
            if argv == ["multi"]:
                phase_multi(dev, Path(tmp), engine_clip(Path(tmp)))
            else:
                phase_prior(dev, Path(tmp))
        print(gpu_name_and_power(), flush=True)
        return 0
    rows = phase_kernel(dev)
    phase_nmf(dev)
    phase_neural(dev)
    phase_diffusion(dev)
    with tempfile.TemporaryDirectory() as tmp:
        prior_launches = phase_prior(dev, Path(tmp))
        launches = phase_facade(dev, Path(tmp))
        part1_launches, part1_row = phase_part1(dev, Path(tmp))
        by_path = {"facade": launches, "part1": part1_launches,
                   **phase_pipelines(dev, Path(tmp)), "prior": prior_launches}
        clip = engine_clip(Path(tmp))
        windowed_launches, windowed_rows = phase_windowed(dev, clip)
        by_path.update(windowed_launches)
        stream_launches, stream_rows = phase_stream(dev, clip)
        by_path.update(stream_launches)
        serve_launches, serve_rows = phase_serve(dev, Path(tmp), clip)
        by_path.update(serve_launches)
        by_path["riffusion"] = phase_riffusion(dev, Path(tmp))
        multi_launches, multi_rows = phase_multi(dev, Path(tmp), clip)
        by_path.update(multi_launches)
    fitted = ([r for r in rows if "ms" in r] + [part1_row] + windowed_rows + stream_rows
              + serve_rows + multi_rows)
    facade = fitted[0]
    emit({"kernels": [{
        "name": "ar_scan", "route": "cuda",
        "source": "audio_inpainting_torch/csrc/ar_scan.cu",
        "replaces": "audio_inpainting_tpu/ops/pallas/ar_scan.py:39",
        "launches": launches, "max_abs_err": facade["max_abs_err"],
        "ms": facade["ms"], "plain_ms": facade["plain_ms"],
        "bound_ms": facade["bound_ms"], "bound_by": facade["bound_by"],
        "library_ms": None, "chunked_ms": facade["chunked_ms"],
        "launches_by_path": by_path,
        "shape": [facade["B"], facade["p"], facade["steps"]],
        "shapes": [{"shape": [r["B"], r["p"], r["steps"]], "path": r["path"],
                    **{k: r[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                         "chunked_ms", "max_abs_err",
                                         "agreement_snr_db")}}
                   for r in fitted]}]})
    print(gpu_name_and_power(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
