"""The ``requires_cuda`` marker, and the tiny form of a cell that the CPU
tests run: 1 s clips at 8 kHz, two clips a request where the cell has
more, twelve epochs a request (the readout of a GAN trained on half its
frames parts from the reference's by 0.013 after six, 0.094 after
twelve). ``fp32`` runs the cell's convs in float32: bf16's rounding on
the CPU, at a handful of frames, reads above the limits that the cells'
bf16 readings on the card set."""

import dataclasses
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the runs are time-boxed: a few threads a test process keep parallel
# test processes from slowing each other's epochs past a request a window
torch.set_num_threads(min(2, torch.get_num_threads()))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: runs on an NVIDIA GPU; skips where none is present")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def tiny(cell, root=ROOT, fp32=False):
    """The cell ``cell`` of the manifest at ``root`` cut to a CPU test's
    size."""
    from benchmark import manifest

    c = manifest.cell(root, cell)
    t = dict(c.traffic, sample_rate=8000, clip_seconds=1.0, epochs=12,
             clips_per_request=min(c.traffic["clips_per_request"], 2), distinct_requests=2)
    cfg = dict(c.config, conv_dtype="float32") if fp32 else c.config
    return dataclasses.replace(c, traffic=t, config=cfg)
