"""The port's GP inpainting (audio_inpainting_torch/methods/gp.py) against
the JAX package's, on the CPU: the posterior exactly at fixed
hyperparameters, the batched L-BFGS against optax's, and the fitted
restoration by its quality with the JAX package's restart draws injected.

The fit itself is not held sample by sample: the kernel matrices of a
near-noise-free signal are so ill-conditioned in float32 that the two
packages' Cholesky factorizations give likelihoods apart by tens of
percent at some restarts (302.6 against 390.7 at the same point of the
sine gap's fit), and the line searches then branch apart.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import audio_inpainting_tpu.methods.gp as jgp
from audio_inpainting_torch.methods import gp as tgp
from audio_inpainting_torch.metrics import local_snr_db

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

# local SNR the port's sine-gap restoration may fall short of the JAX
# package's, in dB, and the floor both must clear (tests/test_gp.py)
GP_MARGIN_DB = 3.0
GP_FLOOR_DB = 10.0


def _jax_restarts(seed, n, device):
    """The JAX package's restart draws for key=seed:
    uniform(PRNGKey(seed), (n, 5))."""
    return torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (n, 5))), device=device)


@pytest.fixture
def jax_restarts(monkeypatch):
    monkeypatch.setattr(tgp, "_draw_restarts", _jax_restarts)


def _noisy_sine(n, seed=0):
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 0.05, n)).astype(np.float32)
    y = (np.sin(2 * np.pi * 200 * x) + 0.05 * rng.randn(n)).astype(np.float32)
    return x, y


# the data of tests/test_gp.py, and a denser one at another seed
@pytest.mark.parametrize("n,seed", [(120, 0), (300, 1)])
def test_posterior_matches_jax_at_fixed_hyperparameters(n, seed):
    x, y = _noisy_sine(n, seed)
    xs = np.linspace(0.01, 0.04, 37).astype(np.float32)
    mu, std, theta = jgp.gp_fit_predict(x, y, xs, jgp.GPConfig(n_restarts=0, opt_steps=0),
                                        key=jax.random.PRNGKey(0))
    tmu, tstd, ttheta = tgp.gp_fit_predict(
        x, y, xs, tgp.GPConfig(n_restarts=0, opt_steps=0), 0, device="cpu")
    np.testing.assert_allclose(ttheta.numpy(), np.asarray(theta), atol=1e-6)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=2e-3, rtol=0)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(std), atol=2e-3, rtol=0)


def test_kernel_and_likelihood_match_jax():
    x, y = _noisy_sine(80, 2)
    y = (y - y.mean()) / y.std()
    thetas = np.log(np.array([[1.0, 0.002, 1.0, 0.005, 0.01],
                              [0.3, 0.004, 2.0, 0.004, 0.05],
                              [3.0, 0.001, 0.5, 0.006, 0.1]], np.float32))
    got = tgp._neg_mll(torch.tensor(thetas), torch.tensor(x), torch.tensor(y), 1e-6)
    for i, th in enumerate(thetas):
        np.testing.assert_allclose(
            tgp._kernel(torch.tensor(th), torch.tensor(x), torch.tensor(x)).numpy(),
            np.asarray(jgp._kernel(th, x, x)), atol=1e-6, rtol=0)
        want = float(jgp._neg_mll(th, x, y, 1e-6))
        assert abs(float(got[i]) - want) <= 1e-3 * max(1.0, abs(want)), (i, got[i], want)


def _rosenbrock_t(u):
    return (100.0 * (u[:, 1:] - u[:, :-1] ** 2) ** 2 + (1 - u[:, :-1]) ** 2).sum(-1)


def _rosenbrock_j(u):
    return (100.0 * (u[1:] - u[:-1] ** 2) ** 2 + (1 - u[:-1]) ** 2).sum()


@pytest.mark.parametrize("n_steps", [5, 20])
def test_lbfgs_follows_optax(n_steps):
    """Row by row, the batched L-BFGS takes optax.lbfgs's steps with the
    JAX package's line search (zoom, at most 6 evaluations)."""
    starts = np.array([[-1.2, 1.0, 0.5], [0.0, 0.0, 0.0], [2.0, -1.0, 1.5]],
                      np.float32)
    opt = optax.lbfgs(linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=6))
    value_and_grad = optax.value_and_grad_from_state(_rosenbrock_j)

    def run_one(u):                       # as the JAX package's _fit_chunk
        def step(carry, _):
            u, state = carry
            v, g = value_and_grad(u, state=state)
            upd, state = opt.update(g, state, u, value=v, grad=g,
                                    value_fn=_rosenbrock_j)
            return (optax.apply_updates(u, upd), state), None

        return jax.lax.scan(step, (u, opt.init(u)), None, length=n_steps)[0][0]

    want = np.asarray(jax.jit(jax.vmap(run_one))(starts))
    got = tgp.lbfgs_minimize(_rosenbrock_t, torch.tensor(starts), n_steps, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_lbfgs_reaches_known_minima_row_by_row():
    """Five quadratics 0.5 (u - c)^T A_r (u - c) of condition up to 10,
    one per row, each minimized at its own c_r; a sixth row whose value
    is NaN everywhere spoils no other row (its own update is NaN, optax's
    0 * NaN)."""
    rng = np.random.RandomState(0)
    R, d = 6, 5
    q, _ = np.linalg.qr(rng.randn(R, d, d))
    eig = np.exp(rng.uniform(0, np.log(10), (R, d)))
    A = torch.tensor(np.einsum("rij,rj,rkj->rik", q, eig, q), dtype=torch.float32)
    c = torch.tensor(rng.randn(R, d), dtype=torch.float32)

    def fun(u):
        e = u - c
        val = 0.5 * torch.einsum("ri,rij,rj->r", e, A, e)
        return torch.where(torch.arange(R) == R - 1, torch.nan, val)

    u0 = torch.tensor(rng.randn(R, d), dtype=torch.float32)
    u = tgp.lbfgs_minimize(fun, u0, 30, 6)
    torch.testing.assert_close(u[:-1], c[:-1], atol=1e-4, rtol=0)
    assert torch.isnan(u[-1]).all()


def _sine_gap(n=320, sr=16000):
    """tests/test_gp.py's small sine gap."""
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * 200 * t)
         + 0.3 * np.sin(2 * np.pi * 450 * t)).astype(np.float32)
    mask = np.ones(n, bool)
    gs, ge = int(n * 0.4), int(n * 0.4) + int(n * 0.2)
    mask[gs:ge] = False
    return x, mask, gs, ge, sr


# tests/test_gp.py's posture (2 restarts, 60 steps) and the default's
@pytest.mark.parametrize("n_restarts,opt_steps", [(2, 60), (2, 20)])
def test_gp_restore_sine_gap_quality_matches_jax(n_restarts, opt_steps, jax_restarts):
    x, mask, gs, ge, sr = _sine_gap()
    want, _ = jgp.gp_restore(x, mask, sr, jgp.GPConfig(n_restarts=n_restarts,
                                                       opt_steps=opt_steps),
                             key=jax.random.PRNGKey(0))
    got, std = tgp.gp_restore(x, mask, sr, tgp.GPConfig(n_restarts=n_restarts,
                                                        opt_steps=opt_steps),
                              0, device="cpu")
    assert got.dtype == np.float32 and std.shape == (ge - gs,)
    assert np.isfinite(got).all() and np.isfinite(std).all()
    np.testing.assert_array_equal(got[mask], x[mask])
    snr = float(local_snr_db(x, got, gs, ge, "cpu"))
    snr_jax = float(local_snr_db(x, want, gs, ge, "cpu"))
    assert snr > GP_FLOOR_DB and snr >= snr_jax - GP_MARGIN_DB, (snr, snr_jax)


def test_predict_raises_the_jitter_where_float32_fails():
    """Hyperparameters the JAX package's fit reached on the sine gap: the
    port's float32 Cholesky of all 256 samples fails at the configured
    jitter, so the posterior retries at a raised one and stays finite."""
    x, mask, gs, ge, sr = _sine_gap()
    t = torch.tensor(np.arange(len(x), dtype=np.float32) / sr)
    y = torch.tensor(x[mask])
    y = (y - y.mean()) / y.std(correction=0)
    theta = torch.tensor([1.6321735, -4.6136427, 0.84370804, -5.402692, -11.512922])
    cfg = tgp.GPConfig()
    k = tgp._kernel(theta, t[mask], t[mask]) + tgp._noise_diag(theta, cfg.jitter) * torch.eye(256)
    assert torch.linalg.cholesky_ex(k)[1] != 0
    mu, std = tgp._predict(theta, t[mask], y, t[~mask], cfg)
    assert torch.isfinite(mu).all() and torch.isfinite(std).all()
