"""Streaming-restore throughput of ``StreamRestorer`` on one GPU: the
counterpart of the JAX package's ``tools/stream_throughput.py``.

    python -m audio_inpainting_torch.tools.stream_throughput [--minutes 2]
        [--method linear|ar|unet] [--gap-every-s 7] [--gap-ms 300]
        [--chunk-ms 100] [--window-s S] [--adapt-epochs N] [--fresh-net]
        [--warmup] [--max-gap-s 1.0] [--epochs N] [--device cuda]

It tiles the input clip into a program of ``--minutes``, zeroes a
``--gap-ms`` gap every ``--gap-every-s`` seconds (seeded offsets), feeds
it to ``methods.streaming.StreamRestorer`` in ``--chunk-ms`` chunks
twice, a cold pass (after ``warmup()`` with ``--warmup``) and a warm one
on a new restorer, and prints one JSON line with the JAX tool's keys:
cold and warm realtime factors (audio seconds per wall second), the peak
and p99 latency (samples received but not yet emitted), the worst single
``feed()`` of each pass, the bit-exact passthrough check (outside every
injected gap and blind-detected quiet run, with a guard of 4x the
engine's default margin), whether every gap got a non-silent fill, and
the gaps' mean SNR and LSD; plus ``device`` and ``input``. It exits 1
if the passthrough or the fill check fails.

The input is the WAV that ``BENCH_INPUT`` names, else Part 2's synthetic
clip through the int16 chain (``tools/bench.py``'s ``bench_input``); the
JAX tool tiled the reference clip, which is on neither machine.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from ..corrupt import find_gaps
from ..device import resolve_device
from ..io import load_mono_normalized
from ..methods.streaming import StreamRestorer
from ..metrics import lsd_db
from .bench import bench_input, device_label

# the engine's default composite margin; the passthrough guard is 4x it
MARGIN = 50


def build_program(clip: np.ndarray, sr: int, minutes: float, gap_every_s: float,
                  gap_ms: float):
    """(clean, damaged, spans): ``clip`` tiled to ``minutes``, a gap of
    ``gap_ms`` zeroed every ``gap_every_s`` seconds, each at an offset of
    up to half a second drawn from seed 0, none in the last second."""
    n = int(minutes * 60 * sr)
    reps = -(-n // len(clip))
    audio = np.tile(clip, reps)[:n].astype(np.float32)
    rng = np.random.default_rng(0)
    gap_len = int(gap_ms / 1000 * sr)
    spans = []
    t = int(gap_every_s * sr)
    while t + gap_len < n - sr:
        s = t + int(rng.integers(0, sr // 2))
        spans.append((s, s + gap_len))
        t += int(gap_every_s * sr)
    damaged = audio.copy()
    for s, e in spans:
        damaged[s:e] = 0.0
    return audio, damaged, spans


def run_pass(tag: str, sr: int, damaged: np.ndarray, method: str, chunk: int,
             warmup: bool, max_gap_s: float | None, device, **kw) -> dict:
    """One restorer fed ``damaged`` in ``chunk``-sample pieces: its output,
    wall, per-feed pending samples and worst feed; warmup's wall first
    when ``warmup``."""
    rest = StreamRestorer(sr, method=method, device=device, **kw)
    warm_wall = 0.0
    if warmup:
        t0 = time.perf_counter()
        n_prog = rest.warmup(max_gap_s)
        warm_wall = time.perf_counter() - t0
        print(f"[{tag}] warmup: {n_prog} windows in {warm_wall:.1f}s", file=sys.stderr)
    outs, pendings, max_feed = [], [], 0.0
    t0 = time.perf_counter()
    for i in range(0, len(damaged), chunk):
        tf = time.perf_counter()
        outs.append(rest.feed(damaged[i:i + chunk]))      # host arrays: synced
        max_feed = max(max_feed, time.perf_counter() - tf)
        pendings.append(rest.pending)
    outs.append(rest.flush())
    wall = time.perf_counter() - t0
    res = {"out": np.concatenate(outs), "wall_s": wall, "max_feed_s": max_feed,
           "peak_pending": int(max(pendings)),
           "p99_pending": float(np.percentile(pendings, 99)), "warmup_wall_s": warm_wall}
    print(f"[{tag}] {len(damaged) / sr:.0f}s audio in {wall:.2f}s wall -> RTF "
          f"{len(damaged) / sr / wall:.1f}x, peak latency "
          f"{res['peak_pending'] / sr * 1000:.0f} ms (p99 "
          f"{res['p99_pending'] / sr * 1000:.0f} ms), max feed stall "
          f"{max_feed * 1000:.0f} ms", file=sys.stderr)
    return res


def run(clip: np.ndarray, sr: int, *, minutes: float = 2.0, method: str = "linear",
        gap_every_s: float = 7.0, gap_ms: float = 300.0, chunk_ms: float = 100.0,
        window_s: float | None = None, adapt_epochs: int | None = None,
        fresh_net: bool = False, warmup: bool = False, max_gap_s: float | None = None,
        epochs: int | None = None, device=None, input_label: str = "") -> dict:
    """The program from ``clip`` at ``sr`` through two passes and the
    checks; prints and returns the JSON line's dict."""
    dev = resolve_device(device)
    clean, damaged, spans = build_program(clip, sr, minutes, gap_every_s, gap_ms)
    chunk = int(chunk_ms / 1000 * sr)
    print(f"[setup] {minutes:.1f} min, {len(spans)} gaps of {gap_ms:.0f} ms, "
          f"chunk {chunk} samples", file=sys.stderr)
    kw = {"window_s": window_s}
    if epochs is not None:
        kw["epochs"] = epochs
    if method == "unet":
        if adapt_epochs is not None:
            kw["adapt_epochs"] = adapt_epochs
        if fresh_net:
            kw["persist"] = False
    cold = run_pass("cold", sr, damaged, method, chunk, warmup, max_gap_s, dev, **kw)
    warm = run_pass("warm", sr, damaged, method, chunk, False, None, dev, **kw)
    out = warm["out"]
    if len(out) != len(damaged):
        raise RuntimeError(f"the stream gave {len(out)} samples for {len(damaged)}")

    # Output bit-identical to the input outside every composite region:
    # the injected gaps and every blind-detected quiet run (the restorer
    # fills the clip's own sub-threshold runs too), each widened by a
    # margin-scale guard, not a window-sized one (that would leave no clean
    # samples at the default parameters).
    guard = 4 * MARGIN
    dirty = np.zeros(len(damaged), bool)
    for s, e in list(spans) + list(find_gaps(damaged, threshold=0.01, min_len=100)):
        dirty[max(0, s - guard):e + guard] = True
    if not np.any(~dirty):
        print("[check] WARNING: no clean region outside restore windows: the "
              "passthrough check is vacuous (shorten --window-s or space gaps "
              "further apart)", file=sys.stderr)
        exact = None
    else:
        exact = bool(np.array_equal(out[~dirty], damaged[~dirty]))
    filled = all(np.abs(out[s:e]).max() > 1e-3 for s, e in spans)
    snr_gaps = [10 * np.log10(np.sum(clean[s:e] ** 2)
                              / (np.sum((clean[s:e] - out[s:e]) ** 2) + 1e-10))
                for s, e in spans]
    # LSD over each gap: the waveform SNR of a plausible but uncorrelated
    # fill sits near 0 dB by construction
    lsd_gaps = [float(lsd_db(clean[s:e], out[s:e], device=dev)) for s, e in spans]
    print(f"[check] passthrough_exact={exact} all_gaps_filled={filled} gap_snr "
          f"mean={np.mean(snr_gaps):.2f} dB gap_lsd mean={np.mean(lsd_gaps):.2f} dB",
          file=sys.stderr)
    seconds = len(damaged) / sr
    res = {"method": method, "minutes": minutes, "gaps": len(spans),
           "warmup": bool(warmup), "warmup_wall_s": cold["warmup_wall_s"],
           "rtf_cold": seconds / cold["wall_s"], "rtf_warm": seconds / warm["wall_s"],
           "peak_latency_ms": warm["peak_pending"] / sr * 1000,
           "p99_latency_ms": warm["p99_pending"] / sr * 1000,
           "max_feed_stall_cold_ms": cold["max_feed_s"] * 1000,
           "max_feed_stall_warm_ms": warm["max_feed_s"] * 1000,
           "passthrough_exact": exact, "all_gaps_filled": bool(filled),
           "gap_snr_mean_db": float(np.mean(snr_gaps)),
           "gap_lsd_mean_db": float(np.mean(lsd_gaps)),
           "device": device_label(dev), "input": input_label}
    print(json.dumps(res), flush=True)
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m audio_inpainting_torch.tools.stream_throughput")
    ap.add_argument("--minutes", type=float, default=2.0)
    ap.add_argument("--method", default="linear")
    ap.add_argument("--gap-every-s", type=float, default=7.0)
    ap.add_argument("--gap-ms", type=float, default=300.0)
    ap.add_argument("--chunk-ms", type=float, default=100.0)
    ap.add_argument("--window-s", type=float, default=None,
                    help="default: the method's latency-tuned window "
                         "(streaming.DEFAULT_WINDOW_S)")
    ap.add_argument("--adapt-epochs", type=int, default=None,
                    help="unet: warm-window adaptation budget of the persistent net")
    ap.add_argument("--fresh-net", action="store_true",
                    help="unet: a fresh net per window")
    ap.add_argument("--warmup", action="store_true",
                    help="StreamRestorer.warmup() before the cold pass")
    ap.add_argument("--max-gap-s", type=float, default=None,
                    help="bound warmup's gap-length buckets (see warmup())")
    ap.add_argument("--epochs", type=int, default=None,
                    help="unet/gan training epochs per window (default: the method's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        path, label = bench_input(tmp)
        sr, clip = load_mono_normalized(path)
    res = run(clip, sr, minutes=args.minutes, method=args.method,
              gap_every_s=args.gap_every_s, gap_ms=args.gap_ms, chunk_ms=args.chunk_ms,
              window_s=args.window_s, adapt_epochs=args.adapt_epochs,
              fresh_net=args.fresh_net, warmup=args.warmup, max_gap_s=args.max_gap_s,
              epochs=args.epochs, device=dev, input_label=label)
    return 0 if res["passthrough_exact"] is not False and res["all_gaps_filled"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
