"""Tracing and timing: the port of audio_inpainting_tpu/utils/profiling.py.

- ``device_trace``: a context manager over ``torch.profiler`` (CPU and,
  where there is one, CUDA activity) that writes a Chrome / Perfetto
  trace (``*.pt.trace.json``, which TensorBoard's profiler plugin also
  reads) into a directory. A session that traces a GPU opens with
  ``prime_session``.
- ``Timer``: a wall-clock section timer that first waits for the device
  work behind a result, as the JAX version blocks until it is ready.
"""

from __future__ import annotations

import contextlib
import time

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
