"""Tracing and timing: the port of audio_inpainting_tpu/utils/profiling.py.

- ``device_trace``: a context manager over ``torch.profiler`` (CPU and,
  where there is one, CUDA activity) that writes a Chrome / Perfetto
  trace (``*.pt.trace.json``, which TensorBoard's profiler plugin also
  reads) into a directory.
- ``Timer``: a wall-clock section timer that first waits for the device
  work behind a result, as the JAX version blocks until it is ready.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import (ProfilerActivity, profile, supported_activities,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block's CPU and CUDA activity (CUDA where torch has it)
    into a ``*.pt.trace.json`` file in ``log_dir``; yields ``log_dir``."""
    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
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
