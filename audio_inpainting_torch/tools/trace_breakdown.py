"""Per-kernel device time of a saved torch.profiler trace: the counterpart
of the JAX package's ``tools/trace_breakdown.py``.

    python -m audio_inpainting_torch.tools.trace_breakdown TRACE [-k 25] [--exact]

TRACE is a Chrome trace as ``utils.profiling.device_trace`` writes it
(``*.pt.trace.json``, gzipped or not), or a directory, whose newest such
trace is read, without the priming that ``device_trace`` opens a GPU
session with (every event that starts before its range ends). The
device events are summed: kernels, memory copies and
memsets (``cat`` "kernel", "gpu_memcpy", "gpu_memset"). The host ops
that launched them (``cpu_op``, ``cuda_runtime``) and the annotations
drawn over the device lanes (``gpu_user_annotation``) are not, since
they would count the device time a second time. Events group by name;
unless ``--exact``, template arguments, argument lists and numeric
suffixes collapse (``void k<float, 4>(float*)`` -> ``void k<>()``), as
``fusion.123`` -> ``fusion`` does in the JAX tool. It prints the top-K
rows with their ms, share and count, the total, and the device's busy
share of the traced window (``busy_share``: the union of the device
intervals, since kernels on several streams may overlap); then the
device's idle ms in that window by the innermost of the port's spans
(``utils.profiling.PORT_SPANS``: a trainer's build, epoch or readout, an
entry point's request, a transform) that the host was in at each idle
gap's middle (``idle_by_span``, read from the spans' ``record_function``
ranges in the trace); and how many of the traced launches have no device
record (``unrecorded``): a session can lose the records of its first
launches, and its device time then falls short by theirs.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re

from ..utils.profiling import PORT_SPANS, PRIMING

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime and driver calls that queue device work
LAUNCH_CALLS = re.compile(r"Launch\w*Kernel|Memcpy|Memset")
_TRACE_GLOBS = ("*.pt.trace.json", "*.pt.trace.json.gz")
NO_SPAN = "(no port span)"


def trace_file(path: str) -> str:
    """``path`` itself, or the newest ``*.pt.trace.json[.gz]`` under the
    directory ``path``."""
    if not os.path.isdir(path):
        return path
    found = [f for g in _TRACE_GLOBS
             for f in glob.glob(os.path.join(path, "**", g), recursive=True)]
    if not found:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {path}: is this a "
                                "torch.profiler trace directory?")
    return max(found, key=os.path.getmtime)


def load_events(path: str) -> list[dict]:
    """The ``traceEvents`` of the trace at ``path`` (see ``trace_file``),
    without ``device_trace``'s priming: the complete events that start
    before the PRIMING range's end (its launches, their kernels, the range
    itself) are left out."""
    f = trace_file(path)
    opener = gzip.open if f.endswith(".gz") else open
    with opener(f, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    ends = [e["ts"] + e["dur"] for e in events
            if e.get("name") == PRIMING and e.get("cat") == "user_annotation" and "dur" in e]
    if not ends:
        return events
    cut = max(ends)
    return [e for e in events if e.get("ph") != "X" or e["ts"] >= cut]


def device_events(events: list[dict]) -> list[dict]:
    """The complete ("X") device events: kernels, copies, memsets."""
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATEGORIES]


def _strip_nested(name: str, open_: str, close: str) -> str:
    """``name`` with every outermost ``open_ ... close`` group emptied."""
    out, depth = [], 0
    for ch in name:
        if ch == open_:
            if depth == 0:
                out.append(ch)
            depth += 1
        elif ch == close and depth:
            depth -= 1
            if depth == 0:
                out.append(ch)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def collapse(name: str) -> str:
    """A kernel's name without template arguments, argument list or a
    trailing numeric suffix."""
    name = _strip_nested(_strip_nested(name, "<", ">"), "(", ")")
    return re.sub(r"[._]\d+$", "", name)


def breakdown(path: str, exact: bool = False) -> tuple[list[tuple[float, int, str]], float]:
    """(rows, total_ms): rows (ms, count, name) of the device events by
    name, largest first; names collapsed unless ``exact``."""
    groups: dict[str, list[float]] = {}
    for e in device_events(load_events(path)):
        name = e["name"] if exact else collapse(e["name"])
        groups.setdefault(name, []).append(e["dur"] / 1e3)
    rows = sorted(((sum(v), len(v), k) for k, v in groups.items()), reverse=True)
    return rows, sum(r[0] for r in rows)


def union_ms(intervals) -> float:
    """The length of the union of (start, end) intervals in µs, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def busy_share(path: str) -> dict:
    """The device's busy time (the union of the device events' intervals),
    the traced window (the first event's start to the last one's end, host
    events included) and their ratio; the share is None for an empty
    window."""
    events = [e for e in load_events(path) if e.get("ph") == "X" and "dur" in e]
    busy = union_ms((e["ts"], e["ts"] + e["dur"]) for e in device_events(events))
    window = ((max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
              if events else 0.0)
    return {"busy_ms": busy, "window_ms": window,
            "busy_share": busy / window if window else None}


def idle_by_span(path: str) -> list[tuple[float, str]]:
    """(ms, span name) of the device's idle time in the traced window (as
    ``busy_share`` takes it), summed by the innermost port span whose
    ``record_function`` range (``cat`` "user_annotation", a name in
    PORT_SPANS) holds each idle gap's middle, NO_SPAN outside them; largest
    first, empty where the trace has no device events or no port span. The
    ranges nest, as the thread that opens them does."""
    events = [e for e in load_events(path) if e.get("ph") == "X" and "dur" in e]
    dev = device_events(events)
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in PORT_SPANS)
    if not dev or not ranges:
        return []
    gaps, prev = [], min(e["ts"] for e in events)
    for s, e in sorted((d["ts"], d["ts"] + d["dur"]) for d in dev):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    end = max(e["ts"] + e["dur"] for e in events)
    if end > prev:
        gaps.append((prev, end))
    total: dict[str, float] = {}
    open_, i = [], 0
    for s, e in gaps:               # in order of their middles
        mid = (s + e) / 2
        while i < len(ranges) and ranges[i][0] <= mid:
            open_.append(ranges[i])
            i += 1
        while open_ and open_[-1][1] < mid:
            open_.pop()
        name = open_[-1][2] if open_ else NO_SPAN
        total[name] = total.get(name, 0.0) + (e - s) / 1e3
    return sorted(((ms, n) for n, ms in total.items()), reverse=True)


def unrecorded(path: str) -> dict:
    """The traced launches (the CUDA runtime or driver calls that queue a
    kernel, a copy or a memset) and how many of them no device event
    answers (by correlation id)."""
    events = load_events(path)
    recorded = {e.get("args", {}).get("correlation") for e in device_events(events)}
    launches = [e.get("args", {}).get("correlation") for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and LAUNCH_CALLS.search(e.get("name", ""))]
    return {"launches": len(launches),
            "unrecorded": sum(1 for c in launches if c not in recorded)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m audio_inpainting_torch.tools.trace_breakdown",
                                description=__doc__.splitlines()[0])
    p.add_argument("trace", help="a *.pt.trace.json[.gz] file or a directory of them")
    p.add_argument("-k", type=int, default=25, help="rows to print")
    p.add_argument("--exact", action="store_true",
                   help="keep template arguments and numeric suffixes")
    ns = p.parse_args(argv)
    rows, total = breakdown(ns.trace, ns.exact)
    print(f"{'ms':>10} {'%':>6} {'count':>7}  kernel")
    for ms, cnt, name in rows[:ns.k]:
        print(f"{ms:10.3f} {100 * ms / total:6.2f} {cnt:7d}  {name}")
    print(f"{total:10.3f} 100.00 {'':7}  TOTAL (device events)")
    busy = busy_share(ns.trace)
    share = "n/a" if busy["busy_share"] is None else f"{100 * busy['busy_share']:.2f} %"
    print(f"busy {busy['busy_ms']:.3f} ms of a {busy['window_ms']:.3f} ms window ({share})")
    idle = idle_by_span(ns.trace)
    if idle:
        print("device idle ms by the innermost port span the host was in:")
        for ms, name in idle:
            print(f"{ms:10.3f}  {name}")
    lost = unrecorded(ns.trace)
    if lost["unrecorded"]:
        print(f"{lost['unrecorded']} of {lost['launches']} launches have no device record: "
              "the device time above is short by theirs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
