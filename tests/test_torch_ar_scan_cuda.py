"""The CUDA kernel of audio_inpainting_torch/ops/ar_scan.py against its
plain torch loop. These tests need a GPU and skip without one.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_ar_scan_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_inpainting_torch.ops import ar_scan

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B, order, steps, device):
    """The inputs of tests/test_pallas_ar.py, on ``device``."""
    rng = np.random.RandomState(B + order)
    w = rng.randn(B, order) * 0.05
    if order > 128:
        w = w * 0.2           # keep sum|w| < 1: a stable recurrence
    b = rng.randn(B) * 0.01
    std = np.abs(rng.randn(B)) * 0.1
    gain = (rng.rand(B) > 0.2) * 1.0
    state0 = rng.randn(B, order)
    eps = rng.randn(B, steps)
    return [torch.as_tensor(a.astype(np.float32), device=device)
            for a in (state0, w, b, std, gain, eps)]


# the shapes of tests/test_pallas_ar.py, plus one past the TPU's order 128
@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,order,steps", [(5, 30, 300), (2, 100, 700),
                                           (9, 7, 129), (3, 200, 500)])
def test_cuda_kernel_matches_plain_loop(cuda, B, order, steps):
    args = _inputs(B, order, steps, cuda)
    got = ar_scan.ar_extrapolate(*args, steps)
    torch.cuda.synchronize()
    expected = ar_scan.ar_extrapolate_ref(*args, steps)
    # the kernel's butterfly sums in another order than torch's sum
    torch.testing.assert_close(got, expected, atol=1e-4, rtol=0)


@pytest.mark.requires_cuda
def test_cuda_tensor_never_reaches_the_plain_loop(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain loop ran on a CUDA tensor")

    monkeypatch.setattr(ar_scan, "ar_extrapolate_ref", refuse)
    before = ar_scan.LAUNCHES
    out = ar_scan.ar_extrapolate(*_inputs(5, 30, 300, cuda), 300)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and out.shape == (5, 300)
    assert ar_scan.LAUNCHES == before + 1
