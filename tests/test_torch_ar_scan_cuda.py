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
    # the kernel's blocked sums run in another order than the loop's
    torch.testing.assert_close(got, expected, atol=1e-4, rtol=0)


# B = 1; steps = 1 and steps below the block length L (32 for order <= 32,
# 128 for order 100); a ragged last block (1000 = 7 * 128 + 104)
@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,order,steps", [(1, 30, 300), (4, 30, 1),
                                           (3, 30, 20), (2, 100, 90),
                                           (3, 100, 1000)])
def test_cuda_kernel_edge_shapes(cuda, B, order, steps):
    args = _inputs(B, order, steps, cuda)
    got = ar_scan.ar_extrapolate(*args, steps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ar_scan.ar_extrapolate_ref(*args, steps),
                               atol=1e-4, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("order", [30, 100])
def test_cuda_kernel_gives_exact_zeros_for_gain_zero(cuda, order):
    state0, w, b, std, _, eps = _inputs(6, order, 300, cuda)
    gain = torch.tensor([0.0, 1.0, 0.0, 0.5, 0.0, 1.0], device=cuda)
    got = ar_scan.ar_extrapolate(state0, w, b, std, gain, eps, 300)
    torch.cuda.synchronize()
    assert torch.equal(got[gain == 0], torch.zeros(3, 300, device=cuda))
    torch.testing.assert_close(
        got, ar_scan.ar_extrapolate_ref(state0, w, b, std, gain, eps, 300),
        atol=1e-4, rtol=0)


@pytest.mark.requires_cuda
def test_cuda_kernel_on_fitted_part2_inputs(cuda):
    """Part 2's shape: order-100 Ridge fits on 5000-sample contexts of a
    music clip, both sides of a centred 2 s hole, 88,200 steps of texture
    noise. Over that many steps the two sum orders drift apart in the last
    bits, so the gate is an agreement SNR of 60 dB."""
    from audio_inpainting_torch.corrupt import synth_music_clip
    from audio_inpainting_torch.methods import ar

    clip = torch.as_tensor(synth_music_clip(1, 44100, 10.0), device=cuda)
    start = torch.tensor([(clip.shape[0] - 88200) // 2], device=cuda)
    ctxs, pads = ar._extract_contexts(clip, start, start + 88200, 5000)
    cfg = ar.ARConfig(order=100, alpha=0.5, context_len=5000)
    w, b, std, valid = ar._fit_ridge_batched(ctxs, pads, cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    eps = torch.randn((2, 88200), generator=gen, device=cuda)
    args = (ar._state0(ctxs, 100).contiguous(), w, b, std,
            valid.to(torch.float32), eps, 88200)
    got = ar_scan.ar_extrapolate(*args)
    torch.cuda.synchronize()
    ref = ar_scan.ar_extrapolate_ref(*args).double()
    err = float(((ref - got.double()) ** 2).sum())
    assert 10 * np.log10(float((ref ** 2).sum()) / max(err, 1e-300)) >= 60.0


@pytest.mark.requires_cuda
def test_cuda_kernel_rejects_orders_above_its_limit(cuda):
    p = ar_scan.MAX_ORDER + 1
    with pytest.raises(ValueError, match="limit"):
        ar_scan.ar_extrapolate(*_inputs(2, p, 10, cuda), 10)


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
