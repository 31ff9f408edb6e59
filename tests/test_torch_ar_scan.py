"""The port's AR recurrence (audio_inpainting_torch/ops/ar_scan.py) against
the JAX package: its plain loop against the Pallas kernel in interpret
mode. The CUDA kernel's own tests are in test_torch_ar_scan_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("B,order,steps", SHAPES)
def test_plain_loop_matches_pallas_interpret(B, order, steps):
    arrays = _inputs(B, order, steps)
    expected = np.asarray(ar_extrapolate_pallas(
        *map(jnp.asarray, arrays), steps, interpret=True))
    got = ar_scan.ar_extrapolate(*_torch(arrays), steps).numpy()
    # atol 1e-4 as in tests/test_pallas_ar.py: the dot products sum in
    # another order over a few hundred dependent steps
    np.testing.assert_allclose(got, expected, atol=1e-4)


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
