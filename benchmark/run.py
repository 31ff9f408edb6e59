#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A step is whatever the driver's ``job.epoch()`` runs: a training epoch of
the port's trainer, or, for a kind that samples, one denoising
evaluation; ``traffic["epochs"]`` counts the steps of a request. Set-up
makes the cell's requests from the seed (``gen.py``), starts the first
one through the driver that the configuration names (the entry point's
analysis and the port's trainer or sampler) and drives it through its
first three steps, which warms every shape the cell uses; it reads the
readout once. The window then runs requests back to back for
``--seconds``: steps until a request reaches the traffic's epochs, then
its readout and synthesis to audio, then the next request. Requests
repeat the set-up's ``distinct_requests`` in turn.

``audio_rtf`` is the audio restored per second of the window: clip
seconds x clip-epochs run / epochs per request / window seconds, the time
of each request's analysis, trainer build, readout and synthesis
included. ``audio_per_device_s``, in the cells that report it, is the
same audio over the seconds the device was busy in the window (the union
of its kernel, copy and memset intervals), read from one profiler
session of device activity alone over the whole window, opened and
closed on an idle device; the window's seconds end before the session
stops. ``setup_s`` runs from the process's start to the window's.
With ``--trace 1`` the window's first TRACE_SECONDS are traced with
device activity alone and the next TRACE_SECONDS with the host's ops and
ranges too (``trace.py``; half the window each where it is shorter), and
the cell's per-layer metrics are read from them (``layer_metrics/``)
instead.

After the window (and outside ``setup_s``) the check that the
configuration names (``checks/<kind>.py``; ``check.py`` says what each
exports) holds the first request's first three steps, one further step
of the request in flight, and every readout (that request's too) to the
plain reference; the states it reads are whatever the driver's
``job.states()`` gives for that kind. The numbers and their limits are
printed as the last lines of standard error and under ``checked``, the
last key of the result line.

The last line of standard output is the result's JSON. No result is
printed, and the exit code is 1, without as many GPUs as the cell asks
for, when a traced slice or the busy session lost a launch's device
record, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import check, gen, manifest, trace  # noqa: E402

TRACE_SECONDS = 10.0
FORBIDDEN = {"jax", "jaxlib", "flax", "audio_inpainting_tpu"}


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reading(kind: str, prof) -> trace.Reading:
    """The stopped session ``prof``'s reading; raises where a launch in it
    has no device record."""
    t_read = time.perf_counter()
    r = trace.Reading(trace.events(prof))
    launches, lost = r.unrecorded()
    print(f"traced {kind} slice: {len(r.events)} events, {launches} launches, "
          f"{len(lost)} with no device record, read in "
          f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    if lost:
        at = ", ".join(f"{e.name} ({e.corr}) at {e.start - r.t0:.1f} us" for e in lost[:20])
        last = max(e.start for e in r.events
                   if e.kind == "runtime" and trace.LAUNCH_CALLS.search(e.name))
        raise RuntimeError(f"{len(lost)} of {launches} launches traced in the {kind} slice "
                           f"have no device record ({at}; the slice's last launch at "
                           f"{last - r.t0:.1f} us): the slice reads short")
    return r


def run(workload: str, seed: int, seconds: float, traced: bool, device, root: str = ROOT,
        cell=None, t_start: float = T_START) -> dict:
    """One run of ``workload``; returns the result's dict (``checked``
    last). ``cell`` replaces the manifest's cell (tests)."""
    c = cell or manifest.cell(root, workload)
    cfg, traffic = c.config, c.traffic
    device = torch.device(device)
    span = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
    driver = manifest.driver(root, cfg).Driver(cfg, traffic, device, span)
    kind = manifest.check(root, cfg)
    epochs = traffic["epochs"]

    # --- set-up: the requests, the first one's trainer and three steps -----
    marks = [("imports", time.perf_counter())]
    pool = [gen.make_request(traffic, cfg, seed, r) for r in range(traffic["distinct_requests"])]
    marks.append(("requests", time.perf_counter()))
    job = driver.start(pool[0])
    _sync(device)
    marks.append(("first request's analysis and trainer", time.perf_counter()))
    s0 = job.states()
    rets = []
    for k in range(3):
        rets.append(job.epoch())
        if k == 0:
            s1 = job.states()
    start = check.Start(pool[0], [job.losses(r) for r in rets], s0, s1, job.states())
    marks.append(("three epochs", time.perf_counter()))
    job.finish()                         # warms the readout's and synthesis' shapes
    done, index = 3, 0
    _sync(device)
    marks.append(("readout", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    times = [t_start] + [t for _, t in marks]
    print("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (name, _), a, b
                                 in zip(marks, times, times[1:])), file=sys.stderr)

    # --- the window ----------------------------------------------------------
    # profiler sessions: (kind, end in seconds from the window's start), each
    # opened and closed on an idle device. Untraced, one busy session covers
    # the whole window where the cell reports a rate over device time: a
    # session stopped inside the window idles the device for the seconds the
    # stop takes, and the steps after that idle run slower by a varying share
    if traced:
        first = min(TRACE_SECONDS, seconds / 2)
        slices = [("device", first), ("ops", min(2 * first, seconds))]
    elif any(m["source"] == "device_trace" for m in c.end_to_end):
        slices = [("busy", seconds)]
    else:
        slices = []
    stopped = {}                         # kind -> (session, clip-epochs in it)
    answers, clip_epochs, attempted = [], 0, 1
    prof = trace.session(ops=False) if slices else None
    mark, t_end = 0, None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        now = time.perf_counter()
        while prof is not None and (now >= t0 + slices[0][1] or now >= deadline):
            _sync(device)
            if now >= deadline and t_end is None:
                t_end = time.perf_counter()
            trace.close(prof)
            stopped[slices.pop(0)[0]] = (prof, clip_epochs - mark)
            prof, mark = ((trace.session(ops=slices[0][0] == "ops"), clip_epochs)
                          if slices else (None, 0))
        if now >= deadline:
            break
        if done >= epochs:
            answers.append(check.Answer(job.req, job.states(clone=False), job.finish()))
            index += 1
            job, done = driver.start(pool[index % len(pool)]), 0
            attempted += 1
            continue
        with span("epoch"):
            job.epoch()
        done += 1
        clip_epochs += job.clips
    _sync(device)
    window_s = (t_end or time.perf_counter()) - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # --- after the window: the request in flight, one more step and its readout
    before = job.states()
    losses = job.losses(job.epoch())
    steps = [check.Step(job.req, before, losses, job.states())]
    answers.append(check.Answer(job.req, job.states(), job.finish()))
    del job, driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, where = kind.compare(cfg, traffic, start, steps, answers, device)
    for name, at in where.items():
        print(f"{name} read its worst at {at}", file=sys.stderr)
    correct, checked = check.judge(numbers, c.limits)

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else 1, "metrics": {}, "device": info}
    if not traced:
        clip_s = traffic["clip_seconds"]
        audio_s = clip_s * clip_epochs / epochs
        busy_s = sum(_reading(kind, prof).busy_s for kind, (prof, _) in stopped.items())
        values = {"audio_rtf": (audio_s / window_s, "audio_s/s"),
                  "audio_per_device_s": (audio_s / busy_s if busy_s > 0 else None, "audio_s/s"),
                  "setup_s": (setup_s, "s")}
        for m in c.end_to_end:
            v, unit = values[m["name"]]
            if v is not None:            # none: no device, so no busy time (the CPU)
                result["metrics"][m["name"]] = {"value": v, "unit": unit}
    else:
        readings = {kind: _reading(kind, prof) for kind, (prof, _) in stopped.items()}
        n = int(round(traffic["clip_seconds"] * traffic["sample_rate"]))
        ctx = SimpleNamespace(
            config=cfg, traffic=traffic, cell=c.name, peak_bytes=peak,
            reading=readings["device"], clip_epochs=stopped["device"][1],
            ops_reading=readings["ops"], ops_clip_epochs=stopped["ops"][1],
            clip_shape=(cfg["stft"]["n_fft"] // 2 + 1, 1 + n // cfg["stft"]["hop"]))
        for m in c.per_layer:
            v = manifest.reader(root, m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        info.update(busy_s=ctx.reading.busy_s, window_s=ctx.reading.window_s)
        result["breakdown"] = {"device_ops": ctx.reading.device_ops(),
                               "idle_gaps": ctx.ops_reading.idle_by_range()}
    result["checked"] = checked
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    need = manifest.cell(ROOT, a.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    result = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    for name, v in result["checked"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
