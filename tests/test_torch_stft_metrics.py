"""The port's STFT (torch.stft) and metrics against the JAX package's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.metrics as jmetrics
from audio_inpainting_torch import metrics as tmetrics

# by module path: both ops packages export a function named stft
jstft = importlib.import_module("audio_inpainting_tpu.ops.stft")
tstft = importlib.import_module("audio_inpainting_torch.ops.stft")

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

CONFIGS = {"torch": ((1024, 256), "torch_stft_config"),
           "scipy": ((512, 384), "scipy_stft_config")}


def _configs(name):
    args, fn = CONFIGS[name]
    return getattr(jstft, fn)(*args), getattr(tstft, fn)(*args)


def _clip(n=12000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 8000.0
    return (0.6 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 97 * t)
            + 0.05 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("name", ["torch", "scipy"])
def test_stft_matches_jax(name):
    jcfg, tcfg = _configs(name)
    x = _clip()
    zj = np.asarray(jstft.stft(jnp.asarray(x), jcfg))
    zt = tstft.stft(torch.as_tensor(x), tcfg).numpy()
    assert zt.shape == zj.shape == (tcfg.n_bins, zj.shape[1])
    # the JAX side is a DFT matmul, the port an FFT: different rounding
    # of the same sums, bounded relative to the spectrum's peak
    assert np.abs(zt - zj).max() <= 1e-4 * np.abs(zj).max()


@pytest.mark.parametrize("name", ["torch", "scipy"])
def test_istft_roundtrip_and_matches_jax(name):
    jcfg, tcfg = _configs(name)
    x = _clip(10001)
    z = tstft.stft(torch.as_tensor(x), tcfg)
    y = tstft.istft(z, tcfg, len(x)).numpy()
    assert y.shape == x.shape
    # fp32 round trip: the analysis and synthesis round at ~1e-7
    np.testing.assert_allclose(y, x, atol=1e-5)
    yj = np.asarray(jstft.istft(jnp.asarray(z.numpy()), jcfg, len(x)))
    np.testing.assert_allclose(y, yj, atol=1e-5)


def test_magphase_polar_roundtrip():
    z = tstft.stft(torch.as_tensor(_clip()), tstft.torch_stft_config(1024, 256))
    mag, phase = tstft.magphase(z)
    mj, pj = jstft.magphase(jnp.asarray(z.numpy()))
    np.testing.assert_allclose(mag.numpy(), np.asarray(mj), rtol=1e-6)
    torch.testing.assert_close(tstft.polar(mag, phase), z, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(tstft.hann_window(512).numpy(),
                                  np.asarray(jstft.hann_window(512)))


def test_snr_and_local_snr_match_jax():
    x = _clip()
    y = x.copy()
    y[3000:5000] = 0.5 * x[3000:5000] + 0.01
    # the same float32 sums in another order: well under 1e-3 dB
    assert abs(float(tmetrics.snr_db(x, y, "cpu"))
               - float(jmetrics.snr_db(x, y))) <= 1e-3
    assert abs(float(tmetrics.local_snr_db(x, y, 3000, 5000, "cpu"))
               - float(jmetrics.local_snr_db(x, y, 3000, 5000))) <= 1e-3
    # identical signals: the 1e-10 guard keeps the SNR finite
    assert float(tmetrics.snr_db(x, x, "cpu")) == pytest.approx(
        float(jmetrics.snr_db(x, x)), rel=1e-5)


def test_lsd_matches_jax():
    x = _clip()
    y = x.copy()
    y[4000:6000] = 0.0           # silent gap columns hit the 1e-10 floor
    y += 1e-3 * np.random.RandomState(1).randn(len(y)).astype(np.float32)
    y[7000:7500] = 0.0
    # log10(max(p, 1e-10)) makes the silent columns sensitive to rounding
    # of tiny powers, hence the looser 1e-2 dB
    assert abs(float(tmetrics.lsd_db(x, y, device="cpu"))
               - float(jmetrics.lsd_db(x, y))) <= 1e-2
