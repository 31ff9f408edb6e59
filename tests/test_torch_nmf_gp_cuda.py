"""The port's NMF, OLA gain and GP on the GPU against the same functions on
the CPU, with the same seeded draws (both draw from CPU generators). These
tests need a GPU and skip without one.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_nmf_gp_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_inpainting_torch.corrupt import random_frame_mask
from audio_inpainting_torch.methods import gp, nmf, ola_eq

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

# the bound the CPU tests hold the port's NMF to against the JAX package
# (tests/test_torch_nmf.py): the fitted model within 1e-5 of its peak
RTOL_OF_PEAK = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _toy_mag(f, t, k_true=5, seed=0):
    rng = np.random.RandomState(seed)
    return torch.tensor((np.abs(rng.randn(f, k_true))
                         @ np.abs(rng.randn(k_true, t))).astype(np.float32))


def _assert_close_to_peak(got, want):
    err = float((got.cpu() - want).abs().max())
    assert err <= RTOL_OF_PEAK * float(want.abs().max()), err


@pytest.mark.requires_cuda
def test_nmf_inpaint_columns_on_gpu_matches_cpu(cuda):
    v = _toy_mag(129, 300)
    bad = torch.zeros(300, dtype=torch.bool)
    bad[100:140] = True
    v[:, bad] = 0
    cfg = nmf.NMFConfig(40, 200)
    got = nmf.nmf_inpaint_columns(v.to(cuda), bad.to(cuda), cfg, 42)
    want = nmf.nmf_inpaint_columns(v, bad, cfg, 42)
    assert got.device.type == "cuda"
    assert torch.equal(got[:, ~bad.to(cuda)].cpu(), v[:, ~bad])
    _assert_close_to_peak(got[:, bad.to(cuda)], want[:, bad])


@pytest.mark.requires_cuda
def test_nmf_inpaint_iterative_on_gpu_matches_cpu(cuda):
    """Part 0's shape and schedule: (257, 19), k = 40, 50 x 200 updates."""
    v = _toy_mag(257, 19, seed=2)
    v[:, 7:12] = 0
    cfg = nmf.NMFConfig(40, 200, 50)
    got = nmf.nmf_inpaint_iterative(v.to(cuda), 7, 12, cfg, 0)
    want = nmf.nmf_inpaint_iterative(v, 7, 12, cfg, 0)
    assert torch.equal(got[:, :7].cpu(), v[:, :7])
    _assert_close_to_peak(got[:, 7:12], want[:, 7:12])


@pytest.mark.requires_cuda
def test_ola_gain_on_gpu_matches_cpu(cuda):
    dropped = torch.zeros(1723, dtype=torch.bool)
    dropped[100:130] = True
    dropped[1700:] = True
    got = ola_eq.ola_gain(dropped.to(cuda), 441000)
    torch.testing.assert_close(got.cpu(), ola_eq.ola_gain(dropped, 441000),
                               atol=1e-6, rtol=0)


@pytest.mark.requires_cuda
def test_random_frame_mask_on_a_cuda_generator(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    m = random_frame_mask(gen, 513, 1723)
    assert m.device.type == "cuda" and m.shape == (513, 1723)
    lost = (m[0] == 0).sum().item()
    # 34 stripes of 5-29 frames: at least one, at most all of them apart
    assert 5 <= lost <= 34 * 29


def _noisy_sine(n, seed=0):
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 0.05, n)).astype(np.float32)
    y = (np.sin(2 * np.pi * 200 * x) + 0.05 * rng.randn(n)).astype(np.float32)
    return x, y


@pytest.mark.requires_cuda
def test_gp_posterior_on_gpu_matches_cpu(cuda):
    x, y = _noisy_sine(441)
    xs = np.linspace(0.01, 0.04, 200).astype(np.float32)
    cfg = gp.GPConfig(n_restarts=0, opt_steps=0)
    mu, std, _ = gp.gp_fit_predict(x, y, xs, cfg, 0, device=cuda)
    cmu, cstd, _ = gp.gp_fit_predict(x, y, xs, cfg, 0, device="cpu")
    torch.testing.assert_close(mu.cpu(), cmu, atol=2e-3, rtol=0)
    torch.testing.assert_close(std.cpu(), cstd, atol=2e-3, rtol=0)


@pytest.mark.requires_cuda
def test_lbfgs_on_gpu_reaches_known_minima(cuda):
    rng = np.random.RandomState(0)
    R, d = 6, 5
    q, _ = np.linalg.qr(rng.randn(R, d, d))
    eig = np.exp(rng.uniform(0, np.log(10), (R, d)))
    A = torch.tensor(np.einsum("rij,rj,rkj->rik", q, eig, q), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.randn(R, d), dtype=torch.float32, device=cuda)

    def fun(u):
        e = u - c
        return 0.5 * torch.einsum("ri,rij,rj->r", e, A, e)

    u = gp.lbfgs_minimize(fun, torch.zeros((R, d), device=cuda), 30, 6)
    torch.testing.assert_close(u, c, atol=1e-4, rtol=0)


@pytest.mark.requires_cuda
def test_gp_restore_on_gpu_fills_a_sine_gap(cuda):
    sr, n = 16000, 800
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * 200 * t) + 0.3 * np.sin(2 * np.pi * 450 * t)
         + 0.02 * np.random.RandomState(0).randn(n)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[320:480] = False
    restored, std = gp.gp_restore(x, mask, sr, gp.GPConfig(), 0, device=cuda)
    np.testing.assert_array_equal(restored[mask], x[mask])
    assert std.shape == (160,) and np.isfinite(std).all()
    err = np.sum((restored[~mask] - x[~mask]) ** 2)
    assert 10 * np.log10(np.sum(x[~mask] ** 2) / err) > 10.0
