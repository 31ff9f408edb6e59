"""The port's OLA gain equalization (audio_inpainting_torch/methods/ola_eq.py)
against the JAX package's ``ola_gain`` and against the exact oracle of
tests/test_ola.py, and the port's ``random_frame_mask`` by contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.ola_eq as jola
from audio_inpainting_torch.corrupt import random_frame_mask
from audio_inpainting_torch.methods import ARConfig, ar_restore_gaps
from audio_inpainting_torch.methods import ola_eq as tola
from audio_inpainting_torch.metrics import lsd_db, snr_db
from audio_inpainting_torch.ops import istft, magphase, polar, stft, torch_stft_config

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

_CFG = torch_stft_config(1024, 256)


def _ola_gain_loop(dropped, n, hop, win, wrap):
    """a(t) by a float64 loop over frames and window taps. ``wrap`` adds a
    tap at a negative position to position n + it, as the JAX package's
    ``.at[idx].add(mode="drop")`` does (it normalizes negative indices
    before dropping); without it, taps outside [0, n) are dropped, as the
    centred iSTFT drops them."""
    w2 = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)) ** 2
    num, den = np.zeros(n), np.zeros(n)
    for k, lost in enumerate(dropped):
        pos = k * hop - win // 2 + np.arange(win)
        if wrap:
            pos = np.where(pos < 0, pos + n, pos)
        keep = (pos >= 0) & (pos < n)
        np.add.at(den, pos[keep], w2[keep])
        np.add.at(num, pos[keep], w2[keep] * (not lost))
    return num / np.maximum(den, 1e-12)


# dropped runs inside, at both ends, and none; clips shorter than, equal
# to and longer than the frames' centred coverage
OLA_CASES = [(100, 25600, [(10, 20), (50, 51), (90, 100)], 256, 1024),
             (100, 25344, [(0, 7), (40, 70)], 256, 1024),
             (40, 12000, [], 256, 1024),
             (63, 8000, [(5, 30)], 128, 512)]


def _dropped(n_frames, runs):
    dropped = np.zeros(n_frames, bool)
    for s, e in runs:
        dropped[s:e] = True
    return dropped


@pytest.mark.parametrize("n_frames,n,runs,hop,win", OLA_CASES)
def test_ola_gain_matches_jax(n_frames, n, runs, hop, win):
    """Equal to the JAX package's but for its last win/2 samples (see
    test_jax_ola_gain_wraps_the_first_frame_onto_the_tail), and equal to
    the float64 loop everywhere."""
    dropped = _dropped(n_frames, runs)
    want = np.asarray(jola.ola_gain(jnp.asarray(dropped), n, hop, win))
    got = tola.ola_gain(torch.tensor(dropped), n, hop, win)
    assert got.dtype == torch.float32 and got.shape == (n,)
    got = got.numpy()
    np.testing.assert_allclose(got[:n - win // 2], want[:n - win // 2],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _ola_gain_loop(dropped, n, hop, win, False),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_frames,n,runs,hop,win", OLA_CASES)
def test_jax_ola_gain_wraps_the_first_frame_onto_the_tail(n_frames, n, runs,
                                                          hop, win):
    """The known difference: the JAX package's gain adds frame 0's left
    half to the clip's last win/2 samples; the port drops it, as the
    iSTFT that made the damage does."""
    dropped = _dropped(n_frames, runs)
    want = np.asarray(jola.ola_gain(jnp.asarray(dropped), n, hop, win))
    np.testing.assert_allclose(want, _ola_gain_loop(dropped, n, hop, win, True),
                               atol=1e-6, rtol=0)


def _damage(x, seed=0, mask_ratio=0.3):
    """The Part 1 corruption through the port: frame mask, iSTFT with the
    original phase."""
    mag, phase = magphase(stft(torch.tensor(x), _CFG))
    mask = random_frame_mask(torch.Generator().manual_seed(seed),
                             mag.shape[0], mag.shape[1], mask_ratio=mask_ratio)
    damaged = istft(polar(mag * mask, phase), _CFG, len(x)).numpy()
    return damaged, mask[0].numpy() < 0.5, mag.shape[1]


@pytest.fixture(scope="module")
def damaged_clip(ref_clip):
    _, x = ref_clip
    return (x,) + _damage(x)


def test_detect_dropped_frames_exact(damaged_clip):
    _, damaged, true_dropped, T = damaged_clip
    det = tola.detect_dropped_frames(damaged, T)
    np.testing.assert_array_equal(det, jola.detect_dropped_frames(damaged, T))
    # no false negatives; false positives only where the clip is truly quiet
    assert true_dropped.any()
    assert not np.any(true_dropped & ~det)
    assert (det & ~true_dropped).sum() <= 3


def test_ola_gain_matches_oracle(damaged_clip):
    x, damaged, true_dropped, _ = damaged_clip
    a = tola.ola_gain(torch.tensor(true_dropped), len(x)).numpy()
    # oracle: damaged / x wherever both are well-conditioned
    sel = (np.abs(x) > 1e-2) & (a > 0.05) & (a < 0.95)
    assert sel.sum() > 1000
    assert np.median(np.abs(damaged[sel] / x[sel] - a[sel])) < 1e-3


def test_ola_gain_all_kept_is_one():
    a = tola.ola_gain(torch.zeros(100, dtype=torch.bool), 25600).numpy()
    # interior samples (away from the centred-iSTFT boundary) have full gain
    assert np.allclose(a[512:-512], 1.0, atol=1e-6)


def test_equalize_recovers_shoulders(damaged_clip):
    x, damaged, _, T = damaged_clip
    eq, gaps, a = tola.equalize_dropped_frames(damaged, T, device="cpu")
    jeq, jgaps, ja = jola.equalize_dropped_frames(damaged, T)
    assert gaps == jgaps
    np.testing.assert_allclose(a, ja, atol=1e-6, rtol=0)
    np.testing.assert_allclose(eq, jeq, atol=1e-5, rtol=0)
    sel = a > 0.05
    # the equalized region matches the clean signal closely; raw damaged doesn't
    err_eq = float(np.mean((eq[sel] - x[sel]) ** 2))
    err_raw = float(np.mean((damaged[sel] - x[sel]) ** 2))
    assert err_eq < err_raw * 0.2, (err_eq, err_raw)
    assert len(gaps) >= 1
    for s, e in gaps:
        assert np.all(a[s:e] <= 0.05)


def test_part1_ar_stage_beats_damaged(damaged_clip):
    x, damaged, _, T = damaged_clip
    eq, gaps, _ = tola.equalize_dropped_frames(damaged, T, device="cpu")
    ar = ar_restore_gaps(eq, gaps,
                         ARConfig(order=30, alpha=0.5, texture=True,
                                  texture_scale=0.1, context_len=1000, passes=2),
                         1, device="cpu").numpy()
    ar = np.clip(ar, -1.0, 1.0)
    assert float(snr_db(x, ar, "cpu")) > float(snr_db(x, damaged, "cpu"))
    assert float(lsd_db(x, ar, device="cpu")) < float(lsd_db(x, damaged, device="cpu"))


def _stripes(seed, n_frames, ratio, lo, hi, min_segments=0):
    """The stripes random_frame_mask draws: the same draws, in its order."""
    count = max(min_segments, int(n_frames * ratio / hi * 2))
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(lo, hi, (count,), generator=gen)
    u = torch.rand(count, generator=gen, dtype=torch.float64)
    return count, lens, (u * (n_frames - lens)).long()


# the Part 1 shape, a short clip, other widths, and the min_segments floor
@pytest.mark.parametrize("seed,n_freq,n_frames,ratio,lo,hi,min_seg", [
    (0, 513, 1723, 0.3, 5, 30, 0), (3, 513, 188, 0.3, 5, 30, 0),
    (7, 33, 400, 0.5, 2, 10, 0), (1, 4, 40, 0.3, 5, 30, 2)])
def test_random_frame_mask_contract(seed, n_freq, n_frames, ratio, lo, hi, min_seg):
    m = random_frame_mask(torch.Generator().manual_seed(seed), n_freq, n_frames,
                          mask_ratio=ratio, min_time_mask=lo, max_time_mask=hi,
                          min_segments=min_seg)
    assert m.shape == (n_freq, n_frames) and m.dtype == torch.float32
    assert m.device.type == "cpu"
    assert torch.equal(m, m[:1].expand_as(m))                # full-band stripes
    assert set(m.unique().tolist()) <= {0.0, 1.0}
    count, lens, starts = _stripes(seed, n_frames, ratio, lo, hi, min_seg)
    assert count == max(min_seg, int(n_frames * ratio / hi * 2)) and count >= 1
    assert ((lens >= lo) & (lens < hi)).all()
    assert ((starts >= 0) & (starts < n_frames - lens)).all()
    lost = np.zeros(n_frames, bool)
    for s, w in zip(starts.tolist(), lens.tolist()):
        lost[s:s + w] = True
    np.testing.assert_array_equal(m[0].numpy(), (~lost).astype(np.float32))


def test_random_frame_mask_is_seeded():
    a = random_frame_mask(torch.Generator().manual_seed(4), 8, 500)
    b = random_frame_mask(torch.Generator().manual_seed(4), 8, 500)
    c = random_frame_mask(torch.Generator().manual_seed(5), 8, 500)
    assert torch.equal(a, b) and not torch.equal(a, c)
