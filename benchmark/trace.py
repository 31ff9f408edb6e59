"""The traced part of a run: torch.profiler sessions over slices of the
window, read in memory.

A traced run takes two slices one after the other, each opened and closed
on an idle device. The ``device`` slice records device activity alone
(kernels, copies, memsets and the CUDA calls that queued them): the
device's busy and idle time and the epochs' share of the peak are read
from it, since recording every op on the host slows a launch-bound epoch
by a quarter. The ``ops`` slice also records the host's ops and the
harness's ranges: device time by the op that launched it and idle time by
the range the host was in are read from it, with the tracer's host cost
in them.

Frozen copies of the port's trace reading (``tools/trace_breakdown.py``:
device events are kernels, copies and memsets, their busy time the union
of their intervals, kernel names collapsed, ``unrecorded`` launches) and
of its priming (``utils/profiling.prime_session``): a profiler session on
the H100 may lose the device records of its first launches, so each
session opens with 2048 launches of its own, waited for, and everything
that starts before the last of them ends is left out. The priming
launches a kernel of its own name (``torch.cuda._sleep``'s
``spin_kernel``) under the range PRIMING, so that a session without host
events can find its end too. A session may also lose the device records
of its last launches (seen once in a G = 44 U-Net slice: seven launches
within 2 ms near its end, although the stop waited for the device), so each
session closes with as many launches of that kernel under the range
TAIL, waited for, and everything from the first of them on is left out.
Reading the session's own events instead of
an exported Chrome trace keeps a long session's reading within seconds.

Events are reduced to ``Event`` tuples: ``kind`` is "device" (a kernel,
copy or memset), "runtime" (the CUDA runtime or driver call that queued
it, linked to the op that made the call), "op" (an aten or autograd op)
or "range" (a ``record_function`` range), times in µs.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import NamedTuple

import torch

PRIMING = "device_trace: priming"
TAIL = "device_trace: tail"
PRIME_LAUNCHES = 2048
PRIME_KERNEL = "spin_kernel"
PRIME_GAP_S = 0.005
LAUNCH_CALLS = re.compile(r"Launch\w*Kernel|Memcpy|Memset")
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
NO_SPAN = "(between spans)"
# the ranges that the harness and its drivers open around the port's calls
SPANS = ("analysis", "trainer_build", "epoch", "readout", "synthesis")


class Event(NamedTuple):
    kind: str
    name: str
    start: float
    end: float
    tid: int
    corr: int
    linked: int


def prime() -> None:
    """Inside a session: PRIME_LAUNCHES launches of PRIME_KERNEL under the
    range PRIMING, waited for, then PRIME_GAP_S with nothing launched, so
    that the device's clock, mapped onto the host's, cannot place the
    priming's end after the next launch."""
    _spin_launches(PRIMING)
    time.sleep(PRIME_GAP_S)


def _spin_launches(name: str) -> None:
    with torch.profiler.record_function(name):
        for _ in range(PRIME_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


def close(prof: torch.profiler.profile) -> None:
    """Stops a session that the device has caught up with: where there is a
    GPU, after PRIME_LAUNCHES launches of PRIME_KERNEL under the range
    TAIL, waited for, which take the records that a session's last
    launches may lose."""
    if torch.cuda.is_available():
        _spin_launches(TAIL)
    prof.stop()


def session(ops: bool = True) -> torch.profiler.profile:
    """A started profiler session, primed where there is a GPU: of CUDA
    activity, and with ``ops`` also of the host's ops and ranges (on the
    CPU, of those alone)."""
    acts = [torch.profiler.ProfilerActivity.CPU] if ops or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    if torch.cuda.is_available():
        prime()
    return prof


def events(prof: torch.profiler.profile) -> list[Event]:
    """The stopped session's events, without the priming and the tail."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            kind = "device"
        elif e.is_user_annotation():
            kind = "range"
        elif e.linked_correlation_id() > 0 or RUNTIME_CALL.match(e.name()):
            kind = "runtime"
        else:
            kind = "op"
        out.append(Event(kind, e.name(), start, end, e.start_thread_id(),
                         e.correlation_id(), e.linked_correlation_id()))
    return without_tail(without_priming(out))


def _spins(evs: list[Event]) -> tuple[list[Event], list[Event]]:
    """The PRIME_KERNEL device events of the priming, which end before any
    other device event starts, and of the tail, which start after every
    other one has ended (all of them the priming's where there is no
    other)."""
    spins = [e for e in evs if e.kind == "device" and PRIME_KERNEL in e.name]
    work = [e for e in evs if e.kind == "device" and PRIME_KERNEL not in e.name]
    if not work:
        return spins, []
    first, last = min(e.start for e in work), max(e.end for e in work)
    return [e for e in spins if e.end <= first], [e for e in spins if e.start >= last]


def without_priming(evs: list[Event]) -> list[Event]:
    """The events that start once the priming has ended, after the end of
    the range PRIMING and of the priming's last PRIME_KERNEL, without the
    launches that queued one of those or came before one (correlation ids
    grow with each call)."""
    prime = _spins(evs)[0]
    ends = [e.end for e in evs if e.kind == "range" and e.name == PRIMING] + [e.end for e in prime]
    if not ends:
        return evs
    cut, last = max(ends), max((e.corr for e in prime), default=-1)
    return [e for e in evs if e.start >= cut and not (e.kind == "runtime" and e.corr <= last)]


def without_tail(evs: list[Event]) -> list[Event]:
    """The events without the range TAIL and the tail: what starts once
    the tail's first recorded PRIME_KERNEL has, and the calls from its
    launch on."""
    tail = _spins(evs)[1]
    cut = min((e.start for e in tail), default=float("inf"))
    first = min((e.corr for e in tail), default=float("inf"))
    return [e for e in evs if e.start < cut and not (e.kind == "range" and e.name == TAIL)
            and not (e.kind == "runtime" and e.corr >= first)]


def _strip_nested(name: str, open_: str, close: str) -> str:
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


def _union(intervals) -> list[tuple[float, float]]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


class Reading:
    """What a traced slice shows: busy and window seconds, launches with no
    device record, device time by kernel name, the device's idle time by
    the range the host was in, and device time by the ops that launched
    it."""

    def __init__(self, evs: list[Event]):
        self.events = evs
        self.device = [e for e in evs if e.kind == "device"]
        self.ranges = sorted((e for e in evs if e.kind == "range" and e.name in SPANS),
                             key=lambda e: e.start)
        self._starts = [r.start for r in self.ranges]
        self.t0 = min((e.start for e in evs), default=0.0)
        self.t1 = max((e.end for e in evs), default=0.0)
        self.busy = _union((e.start, e.end) for e in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def unrecorded(self) -> tuple[int, list[Event]]:
        """(launches, the launches that no device event of their correlation
        answers)."""
        recorded = {e.corr for e in self.device}
        launches = [e for e in self.events
                    if e.kind == "runtime" and LAUNCH_CALLS.search(e.name)]
        return len(launches), [e for e in launches if e.corr not in recorded]

    def device_ops(self, k: int = 10) -> list[list]:
        """The k kernel names (collapsed) that took most device time, with
        their seconds."""
        total = defaultdict(float)
        for e in self.device:
            total[collapse(e.name)] += (e.end - e.start) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def _range_at(self, t: float) -> str:
        """The range open at ``t`` (the harness's ranges do not nest), or
        NO_SPAN."""
        i = bisect.bisect_right(self._starts, t) - 1
        return self.ranges[i].name if i >= 0 and self.ranges[i].end >= t else NO_SPAN

    def idle_by_range(self, k: int = 10) -> list[list]:
        """The device's idle seconds in the slice, summed by the range the
        host was in at each gap's middle, largest first."""
        gaps, prev = [], self.t0
        for s, e in self.busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        total = defaultdict(float)
        for s, e in gaps:
            total[self._range_at((s + e) / 2)] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def device_s_under(self, op_names, range_name: str) -> float:
        """Device seconds in which work launched by an op named in
        ``op_names``, or by any op nested in one (on its thread), from
        inside a ``range_name`` range ran: the union of its intervals, so
        that work overlapping on several streams counts once."""
        under, starts = set(), {}
        by_tid = defaultdict(list)
        for e in self.events:
            if e.kind == "op":
                by_tid[e.tid].append(e)
        for ops in by_tid.values():
            stack = []
            for e in sorted(ops, key=lambda e: (e.start, -e.end)):
                while stack and stack[-1][0].end <= e.start:
                    stack.pop()
                inside = e.name in op_names or (bool(stack) and stack[-1][1])
                stack.append((e, inside))
                if inside:
                    under.add(e.corr)
                    starts[e.corr] = e.start
        spans = _union((r.start, r.end) for r in self.ranges if r.name == range_name)
        ran = _union((e.start, e.end) for e in self.device
                     if e.linked in under and _within(starts[e.linked], spans))
        return sum(e - s for s, e in ran) / 1e6


def _within(t: float, spans: list[tuple[float, float]]) -> bool:
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid][1] < t:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(spans) and spans[lo][0] <= t <= spans[lo][1]
