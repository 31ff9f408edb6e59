"""Tracing and timing: the port of audio_inpainting_tpu/utils/profiling.py.

- ``device_trace``: a context manager over ``torch.profiler`` (CPU and,
  where there is one, CUDA activity) that writes a Chrome / Perfetto
  trace (``*.pt.trace.json``, which TensorBoard's profiler plugin also
  reads) into a directory. A session that traces a GPU opens with
  ``prime_session``.
- ``Timer``: a wall-clock section timer that first waits for the device
  work behind a result, as the JAX version blocks until it is ready.
- ``span``: the port's own spans at its layer boundaries (PORT_SPANS),
  kept in memory while a ``torch.profiler`` session is active and read
  back with ``spans``, on the clock of the profiler's events.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            supported_activities, tensorboard_trace_handler)

# A torch.profiler session that traces a GPU may lose the device records of
# its first launches: on an H100 with torch 2.11, none in a fresh process;
# once it had run a while, some tens in most sessions and at times more
# than 256.
# Each session therefore opens with PRIME_LAUNCHES launches of its own
# inside a PRIMING range, which tools/trace_breakdown.py leaves out of what
# it reads (about 8 ms of host time).
PRIMING = "device_trace: priming"
PRIME_LAUNCHES = 2048


def prime_session() -> None:
    """Inside a profiler session that traces CUDA: PRIME_LAUNCHES one-element
    launches under a PRIMING range, waited for, so that the records the
    session loses at its start are theirs and not the traced block's."""
    with record_function(PRIMING):
        x = torch.zeros(1, device="cuda")
        for _ in range(PRIME_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block's CPU and CUDA activity (CUDA where torch has it)
    into a ``*.pt.trace.json`` file in ``log_dir``; yields ``log_dir``.
    Where a GPU is traced, the session opens with ``prime_session``."""
    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        if ProfilerActivity.CUDA in acts and torch.cuda.is_available():
            prime_session()
        yield log_dir


def _synchronize(result) -> None:
    """Wait for the devices that hold the tensors of ``result`` (a tensor
    or nested lists, tuples and dicts of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


class Timer:
    """Wall-clock section timer; call .lap('name', result) after the work."""

    def __init__(self):
        self.t0 = time.time()
        self.laps: dict[str, float] = {}

    def lap(self, name: str, result=None) -> float:
        if result is not None:
            _synchronize(result)
        now = time.time()
        self.laps[name] = now - self.t0
        self.t0 = now
        return self.laps[name]


# ------------------------------------------------------------------ spans --
#
# The port opens a span at each boundary where a layer's work happens: an
# entry point's request, a trainer's build, epoch and readout, a transform,
# a denoising evaluation and the attention calls inside it (32 an SD-v1
# evaluation, which the attention's roofline reads). No span goes per op,
# per launch or inside an inner loop. When no session is active a span
# costs one check of torch's profiler state (0.45 us for
# the whole ``with`` on an H100's host); inside one, about 18 us (a bare
# ``record_function`` range, 10 us).
# Inside a session it is recorded in a bounded buffer of this process and
# mirrored as a ``record_function`` range of its name, which a Chrome trace
# of ``device_trace`` shows (tools/trace_breakdown.py lists the device's
# idle time by these ranges).
#
# The clock: ``time.time_ns()``, Unix nanoseconds. kineto converts the
# timestamps of the host's events and of CUPTI's runtime and device records
# to Unix time, so a span's stamps and a profiler event's ``start_ns()``
# are comparable: on the CPU a span's stamps hold its ``record_function``
# range by 3-30 us on either side (tests/test_torch_spans.py), and on an
# H100 with torch 2.11, in a session of CUDA activity alone, every launch
# made inside a span starts inside its stamps, the nearest 24-26 us from
# an edge (tests/test_torch_spans_cuda.py).

# the spans the port opens, by layer: model step (the trainers, the SD
# sampler's VAE calls and evaluations), kernels (SD's attention), entry,
# ops. tools/trace_breakdown.py reads the record_function mirrors of these.
PORT_SPANS = ("unet.build", "unet.epoch", "unet.readout",
              "gan.build", "gan.epoch", "gan.readout", "gan.run",
              "sd.encode", "sd.step", "sd.attention", "sd.decode",
              "api.restore", "serve.batch", "riffusion.analysis", "riffusion.synthesis",
              "ops.stft", "ops.istft")
SPAN_CAPACITY = 65_536


class Span(NamedTuple):
    """A closed span: ``start_ns``/``end_ns`` in Unix nanoseconds,
    ``thread`` the native id of the thread that opened it (the profiler's
    ``tid``), ``parent`` the ``id`` of the span open on that thread when it
    opened (None at the top), ``run`` the training run it belongs to (given,
    or its parent's), ``attrs`` its attributes."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    run: int | None
    attrs: dict


class SpansDropped(LookupError):
    """The buffer dropped spans that may lie in the interval read."""


class _Recorder:
    """The closed spans in the order they closed, at most ``capacity``: a
    full buffer drops the span that closed first, counts it and keeps the
    latest end of those dropped (every span that closed before it was
    dropped too)."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.closed: deque[Span] = deque(maxlen=capacity)
        self.dropped = 0
        self.dropped_until_ns = -1
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)

    def thread(self):
        """This thread's open spans (``stack``) and native id (``id``, read
        once: a system call)."""
        local = self.local
        if not hasattr(local, "stack"):
            local.stack, local.id = [], threading.get_native_id()
        return local

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.closed) == self.closed.maxlen:
                self.dropped += 1
                self.dropped_until_ns = max(self.dropped_until_ns, self.closed[0].end_ns)
            self.closed.append(span)

    def read(self, since_ns: int | None, until_ns: int | None) -> list[Span]:
        lo = 0 if since_ns is None else since_ns
        hi = float("inf") if until_ns is None else until_ns
        with self.lock:
            if self.dropped_until_ns >= lo:
                raise SpansDropped(
                    f"{self.dropped} spans were dropped from the buffer of "
                    f"{self.closed.maxlen}, the latest ending at {self.dropped_until_ns} ns, "
                    f"inside the interval read ({since_ns}, {until_ns})")
            found = [s for s in self.closed if s.end_ns >= lo and s.start_ns <= hi]
        return sorted(found, key=lambda s: s.start_ns)


_RECORDER = _Recorder()
_RUNS = itertools.count(1)
_OFF = contextlib.nullcontext()


def new_run() -> int:
    """A fresh training-run id, shared by the spans of one trainer."""
    return next(_RUNS)


class _Span:
    def __init__(self, name: str, run: int | None, attrs: dict):
        self.name, self.run, self.attrs = name, run, attrs

    def __enter__(self):
        self.thread = _RECORDER.thread()
        stack = self.thread.stack
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.run is None and parent is not None:
            self.run = parent.run
        self.id = next(_RECORDER.ids)
        stack.append(self)
        self.range = record_function(self.name)
        self.start_ns = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end_ns = time.time_ns()
        self.thread.stack.pop()
        _RECORDER.add(Span(self.name, self.start_ns, end_ns, self.thread.id,
                           self.id, self.parent, self.run, self.attrs))
        return False


def span(name: str, run: int | None = None, **attrs):
    """A context manager over one stage of the port's work, recorded only
    while a torch.profiler session is active (``torch.autograd.
    _profiler_enabled()``, which holds in a session of CUDA activity alone
    too); otherwise it does nothing. ``run`` ties the spans of one training
    run together (``new_run``); a span without one takes its parent's.
    ``attrs`` are kept as given (e.g. ``clips``, the group size)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, run, attrs)


def spans(since_ns: int | None = None, until_ns: int | None = None) -> list[Span]:
    """The recorded spans that lie within [since_ns, until_ns] (Unix ns,
    open where None), wholly or in part, by start. SpansDropped where the
    buffer dropped a span that may lie there: a reader never gets short
    data unknowingly."""
    return _RECORDER.read(since_ns, until_ns)
