"""The port's masked NMF (audio_inpainting_torch/methods/nmf.py) against the
JAX package's, on the CPU, with the JAX package's init draws injected.

Tolerance: the two run the same multiplicative updates in float32 with
other summation orders; the fitted model W@H agrees to within 1e-5 of its
peak (measured 3e-7 to 3e-6 relative, the 10,000-iteration Part 0
schedule the loosest). Good columns come back bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.nmf as jnmf
from audio_inpainting_torch.methods import nmf as tnmf

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

RTOL_OF_PEAK = 1e-5


def _jax_draws(seed, f, t, k, device):
    """The JAX package's raw init draws for PRNGKey(seed): split the key,
    then |normal| for W (f, k) and H (k, t)."""
    kw, kh = jax.random.split(jax.random.PRNGKey(seed))
    return (torch.tensor(np.asarray(jnp.abs(jax.random.normal(kw, (f, k)))), device=device),
            torch.tensor(np.asarray(jnp.abs(jax.random.normal(kh, (k, t)))), device=device))


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tnmf, "_draw_wh", _jax_draws)


def _toy_mag(f=65, t=120, k_true=5, seed=0):
    rng = np.random.RandomState(seed)
    return (np.abs(rng.randn(f, k_true)) @ np.abs(rng.randn(k_true, t))).astype(np.float32)


def _assert_close_to_peak(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL_OF_PEAK * np.abs(want).max(), (err, np.abs(want).max())


# a toy rank-5 matrix, the Part 0 shape (257 bins, ~19 frames) and a wide one
@pytest.mark.parametrize("f,t,k", [(65, 120, 8), (257, 19, 40), (129, 300, 40)])
def test_mu_fit_matches_jax(f, t, k):
    v = _toy_mag(f, t, seed=f)
    w0, h0 = (np.asarray(a) for a in _jax_draws(1, f, t, k, "cpu"))
    jw, jh = jnmf._mu_fit(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 200)
    tw, th = tnmf._mu_fit(torch.tensor(v), torch.tensor(w0), torch.tensor(h0), 200)
    _assert_close_to_peak((tw @ th).numpy(), np.asarray(jw) @ np.asarray(jh))
    assert (tw >= 0).all() and (th >= 0).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_nmf_reconstruct_matches_jax(seed, jax_draws):
    v = _toy_mag(seed=3)
    cfg = jnmf.NMFConfig(n_components=8, n_iter=200)
    want = jnmf.nmf_reconstruct(jnp.asarray(v), cfg, jax.random.PRNGKey(seed))
    got = tnmf.nmf_reconstruct(torch.tensor(v), tnmf.NMFConfig(8, 200), seed)
    _assert_close_to_peak(got.numpy(), want)


def test_nmf_inpaint_columns_matches_jax(jax_draws):
    v = _toy_mag(seed=1)
    bad = np.zeros(v.shape[1], bool)
    bad[50:60] = True
    bad[100] = True
    damaged = v.copy()
    damaged[:, bad] = 0
    want = np.asarray(jnmf.nmf_inpaint_columns(
        jnp.asarray(damaged), jnp.asarray(bad), jnmf.NMFConfig(8, 200),
        jax.random.PRNGKey(0)))
    got = tnmf.nmf_inpaint_columns(torch.tensor(damaged), torch.tensor(bad),
                                   tnmf.NMFConfig(8, 200), 0).numpy()
    np.testing.assert_array_equal(got[:, ~bad], damaged[:, ~bad])
    _assert_close_to_peak(got[:, bad], want[:, bad])
    # and the fill is a fill: closer to the truth than the zeros were
    assert np.linalg.norm(v[:, bad] - got[:, bad]) < 0.6 * np.linalg.norm(v[:, bad])


# a short schedule on the toy matrix, and Part 0's own: (257, 19) at k=40,
# 50 refits of 200 updates
@pytest.mark.parametrize("f,t,cs,ce,k,n_iter,outer",
                         [(65, 120, 40, 60, 8, 100, 10),
                          (257, 19, 7, 12, 40, 200, 50)])
def test_nmf_inpaint_iterative_matches_jax(f, t, cs, ce, k, n_iter, outer,
                                           jax_draws):
    v = _toy_mag(f, t, seed=2)
    damaged = v.copy()
    damaged[:, cs:ce] = 0
    want = np.asarray(jnmf.nmf_inpaint_iterative(
        jnp.asarray(damaged), cs, ce, jnmf.NMFConfig(k, n_iter, outer),
        jax.random.PRNGKey(1)))
    got = tnmf.nmf_inpaint_iterative(torch.tensor(damaged), cs, ce,
                                     tnmf.NMFConfig(k, n_iter, outer), 1).numpy()
    np.testing.assert_array_equal(got[:, :cs], damaged[:, :cs])
    np.testing.assert_array_equal(got[:, ce:], damaged[:, ce:])
    _assert_close_to_peak(got[:, cs:ce], want[:, cs:ce])


def test_raw_draws_are_seeded_half_normals():
    w, h = tnmf._draw_wh(42, 7, 9, 3, torch.device("cpu"))
    assert w.shape == (7, 3) and h.shape == (3, 9)
    assert (w >= 0).all() and (h >= 0).all()
    w2, h2 = tnmf._draw_wh(42, 7, 9, 3, torch.device("cpu"))
    assert torch.equal(w, w2) and torch.equal(h, h2)
    assert not torch.equal(w, tnmf._draw_wh(43, 7, 9, 3, torch.device("cpu"))[0])
