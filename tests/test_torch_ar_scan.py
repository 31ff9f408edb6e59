"""The port's AR recurrence (audio_inpainting_torch/ops/ar_scan.py) against
the JAX package: its plain loop and the blocked form of the CUDA kernel
against the Pallas kernel in interpret mode, and the blocked form against
the plain loop. The CUDA kernel's own tests are in
test_torch_ar_scan_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_inpainting_torch.corrupt import synth_music_clip
from audio_inpainting_torch.methods import ar as tar
from audio_inpainting_torch.ops import ar_scan
from audio_inpainting_tpu.methods.ar import _extrapolate_scan as jax_scan
from audio_inpainting_tpu.ops.pallas.ar_scan import ar_extrapolate_pallas

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

# the shapes of tests/test_pallas_ar.py
SHAPES = [(5, 30, 300), (2, 100, 700), (9, 7, 129)]


def _inputs(B, order, steps):
    """The inputs of tests/test_pallas_ar.py, as numpy."""
    rng = np.random.RandomState(B + order)
    w = rng.randn(B, order).astype(np.float32) * 0.05
    b = rng.randn(B).astype(np.float32) * 0.01
    std = np.abs(rng.randn(B)).astype(np.float32) * 0.1
    gain = (rng.rand(B) > 0.2).astype(np.float32)
    state0 = rng.randn(B, order).astype(np.float32)
    eps = rng.randn(B, steps).astype(np.float32)
    return state0, w, b, std, gain, eps


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@functools.cache
def _pallas(B, order, steps):
    arrays = _inputs(B, order, steps)
    return np.asarray(ar_extrapolate_pallas(*map(jnp.asarray, arrays), steps,
                                            interpret=True))


def _agreement_snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


@pytest.mark.parametrize("B,order,steps", SHAPES)
def test_plain_loop_matches_pallas_interpret(B, order, steps):
    expected = _pallas(B, order, steps)
    got = ar_scan.ar_extrapolate(*_torch(_inputs(B, order, steps)), steps).numpy()
    # atol 1e-4 as in tests/test_pallas_ar.py: the dot products sum in
    # another order over a few hundred dependent steps
    np.testing.assert_allclose(got, expected, atol=1e-4)


@pytest.mark.parametrize("L", [32, 128])
@pytest.mark.parametrize("B,order,steps", SHAPES)
def test_blocked_form_matches_pallas_interpret(B, order, steps, L):
    got = ar_scan.ar_extrapolate_blocked_ref(*_torch(_inputs(B, order, steps)),
                                             steps, L).numpy()
    # atol 1e-4 as in tests/test_pallas_ar.py: the blocked sums run in
    # another order than the per-sample dot products
    np.testing.assert_allclose(got, _pallas(B, order, steps), atol=1e-4)


# steps < L and steps = 1 (one ragged block), order > L (the next entry
# state reaches back past the block), and a fractional gain, which pins the
# Pallas semantics: the gained prediction is fed back into the state
@pytest.mark.parametrize("B,order,steps,L,gain", [
    (3, 30, 20, 32, None), (4, 30, 1, 32, None), (2, 100, 90, 128, None),
    (2, 100, 300, 32, None), (5, 30, 300, 32, 0.5), (2, 100, 700, 128, 0.5)])
def test_blocked_form_matches_plain_loop(B, order, steps, L, gain):
    state0, w, b, std, g, eps = _torch(_inputs(B, order, steps))
    if gain is not None:
        g = torch.full_like(g, gain)
    args = (state0, w, b, std, g, eps, steps)
    torch.testing.assert_close(ar_scan.ar_extrapolate_blocked_ref(*args, L),
                               ar_scan.ar_extrapolate_ref(*args),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("order,L", [(30, 32), (100, 128), (100, 32)])
def test_blocked_form_gives_exact_zeros_for_gain_zero(order, L):
    state0, w, b, std, gain, eps = _torch(_inputs(6, order, 300))
    gain = torch.tensor([0.0, 1.0, 0.0, 0.5, 0.0, 1.0])
    got = ar_scan.ar_extrapolate_blocked_ref(state0, w, b, std, gain, eps,
                                             300, L)
    assert torch.equal(got[gain == 0], torch.zeros(3, 300))
    assert (got[gain != 0] != 0).all()


def test_blocked_form_on_fitted_facade_inputs():
    """Ridge fits on 1000-sample contexts of a music clip, as the facade
    makes them (order 30), 16 rows, 1024 steps of texture noise."""
    clip = torch.as_tensor(synth_music_clip(0, 44100, 10.0))
    starts = torch.linspace(1000, clip.shape[0] - 2024, 8).long()
    ctxs, pads = tar._extract_contexts(clip, starts, starts + 1024, 1000)
    cfg = tar.ARConfig(order=30, alpha=0.5, context_len=1000)
    w, b, std, valid = tar._fit_ridge_batched(ctxs, pads, cfg)
    eps = torch.as_tensor(np.random.RandomState(0).randn(16, 1024).astype(np.float32))
    args = (tar._state0(ctxs, 30).contiguous(), w, b, std,
            valid.to(torch.float32), eps, 1024)
    ref = ar_scan.ar_extrapolate_ref(*args)
    assert _agreement_snr(ref, ar_scan.ar_extrapolate_blocked_ref(*args, 32)) >= 90.0


def test_plain_loop_above_order_128_matches_jax_scan():
    """Order 160 is past the Pallas kernel's 128-lane limit; the port takes
    it, so it is held to the JAX package's lax.scan form."""
    B, order, steps = 4, 160, 400
    state0, w, b, std, gain, eps = _inputs(B, order, steps)
    w = w * 0.2            # keep sum|w| < 1: a stable recurrence
    # _extrapolate_scan starts from ctxs[:, C-order-1:C-1]
    ctxs = np.concatenate([state0, np.zeros((B, 1), np.float32)], axis=1)
    key = jax.random.PRNGKey(3)
    jeps = np.asarray(jax.random.normal(key, (steps, B)))
    expected = np.asarray(jax_scan(jnp.asarray(ctxs), jnp.asarray(w),
                                   jnp.asarray(b), jnp.asarray(std),
                                   jnp.asarray(gain > 0), key, steps, True))
    got = ar_scan.ar_extrapolate(*_torch([state0, w, b, std, gain,
                                          np.ascontiguousarray(jeps.T)]),
                                 steps).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-4)


def test_cpu_call_runs_the_plain_loop_and_counts_no_launch(monkeypatch):
    arrays = _torch(_inputs(3, 5, 40))
    before = ar_scan.LAUNCHES
    calls = []
    real = ar_scan.ar_extrapolate_ref
    monkeypatch.setattr(ar_scan, "ar_extrapolate_ref",
                        lambda *a: calls.append(1) or real(*a))
    out = ar_scan.ar_extrapolate(*arrays, 40)
    assert out.shape == (3, 40) and calls == [1]
    assert ar_scan.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "steps"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    state0, w, b, std, gain, eps = _torch(_inputs(3, 5, 40))
    steps = 40
    if bad == "dtype":
        w = w.double()
    elif bad == "shape":
        eps = eps[:, :30]
    else:
        steps = 0
    with pytest.raises((TypeError, ValueError)):
        ar_scan.ar_extrapolate(state0, w, b, std, gain, eps, steps)
