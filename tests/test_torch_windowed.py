"""The port's windowed engine (audio_inpainting_torch/methods/windowed.py
and the batched window pass of methods/ar.py) against the JAX package's
(audio_inpainting_tpu/methods/windowed.py, methods/ar.py), on the CPU.
Mirrors tests/test_windowed.py."""

import jax
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.ar as jar
import audio_inpainting_tpu.methods.windowed as jwin
from audio_inpainting_torch import api as tapi
from audio_inpainting_torch.methods import ar as tar
from audio_inpainting_torch.methods import windowed as twin

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

# the linear fill is host np.interp in both packages; the composite is the
# same numpy arithmetic: equal up to float32 rounding of the weights
LINEAR_RTOL_OF_PEAK = 1e-6
# the AR facade's bound against the JAX package with its draws injected
# (tests/test_torch_ar.py): the fit's rounding carries through the
# recurrence, so the fills are held by agreement SNR over the gaps
AR_AGREEMENT_DB = 60.0
# batched against sequential: the same fits in one batch, whose sums may
# run in another order (tests/test_windowed.py's pin)
BATCH_ATOL = 1e-5


def _long_clip(sr=8000, n=64_000, gaps=((30_000, 30_500), (50_000, 51_000))):
    """A slow 2 Hz carrier + a quiet 330 Hz texture (tests/test_windowed.py):
    a sub-second gap spans a fraction of the carrier period, so a straight
    line beats zeros."""
    t = np.arange(n)
    x = (0.6 * np.sin(2 * np.pi * 2 * t / sr)
         + 0.2 * np.sin(2 * np.pi * 330 * t / sr)).astype(np.float32)
    dmg = x.copy()
    for s, e in gaps:
        dmg[s:e] = 0.0
    return x, dmg, sr, [tuple(g) for g in gaps]


def _jax_draws(seed, p, shape, device):
    """Stand-in for the port's texture draw: the JAX package's own pass-p
    draw, normal(fold_in(PRNGKey(seed), p)), the noise every JAX window
    adds (the key is closed over, not split per window)."""
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed), p), shape)), device=device)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tar, "_draw_eps", _jax_draws)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of ar_extrapolate from the AR method: on the GPU
    each is one launch of the CUDA kernel (on the CPU the plain loop)."""
    calls = []
    real = tar.ar_extrapolate

    def spy(*args):
        calls.append(args[1].shape[0])      # the batch's rows
        return real(*args)

    monkeypatch.setattr(tar, "ar_extrapolate", spy)
    return calls


def _agreement_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


def _in_gaps(n, gaps):
    m = np.zeros(n, bool)
    for s, e in gaps:
        m[s:e] = True
    return m


@pytest.mark.parametrize("gaps,min_sep,want", [
    ([], 100, []),
    ([(500, 600), (0, 100)], 100, [(0, 100), (500, 600)]),
    ([(0, 100), (150, 300)], 100, [(0, 300)]),       # 50 apart < 100: merged
    ([(0, 400), (100, 200)], 100, [(0, 400)]),       # containment collapses
])
def test_merge_close_matches_jax(gaps, min_sep, want):
    assert twin._merge_close(gaps, min_sep) == jwin._merge_close(gaps, min_sep) == want


def test_plan_groups_nearby_gaps_into_one_window():
    n, window, ctx = 1_000_000, 10_000, 1_000
    gaps = [(50_000, 50_500), (52_000, 52_300),  # 2.3k span: one window
            (500_000, 500_800)]                  # far away: its own window
    plan = twin.plan_windows(gaps, n, window, ctx)
    assert plan == jwin.plan_windows(gaps, n, window, ctx)
    (w0a, sa, ga), (w0b, sb, gb) = plan
    assert sa == sb == window and ga == gaps[:2] and gb == [gaps[2]]
    for w0, size, group in plan:
        for s, e in group:
            assert w0 + ctx <= s and e <= w0 + size - ctx


def test_plan_doubles_for_oversized_gap():
    n, window, ctx = 1_000_000, 8_000, 1_000
    plan = twin.plan_windows([(100_000, 120_000)], n, window, ctx)  # 20k gap
    assert plan == jwin.plan_windows([(100_000, 120_000)], n, window, ctx)
    w0, size, _ = plan[0]
    assert size == 32_000  # 8k -> 16k (too small: 20k+2k) -> 32k
    assert w0 + ctx <= 100_000 and 120_000 <= w0 + size - ctx


@pytest.mark.parametrize("gap,n,want", [
    ((50, 200), 100_000, (0, 10_000)),              # clamped to the start
    ((99_000, 99_500), 100_000, (90_000, 10_000)),  # clamped to the end
    ((1_000, 1_200), 5_000, (0, 10_000)),           # file shorter: caller pads
])
def test_plan_clamps_to_file_edges(gap, n, want):
    plan = twin.plan_windows([gap], n, 10_000, 1_000)
    assert plan == jwin.plan_windows([gap], n, 10_000, 1_000)
    assert plan[0][:2] == want


def test_windowed_linear_passthrough_and_fill():
    clean, dmg, sr, gaps = _long_clip()
    out = twin.restore_windowed(dmg, sr, method="linear", window_s=2.0,
                                margin=50, device="cpu")
    assert out.shape == dmg.shape and out.dtype == np.float32
    # clean audio outside gap +- margin is BIT-identical
    touched = np.zeros(len(dmg), bool)
    for s, e in gaps:
        touched[s - 50:e + 50] = True
    np.testing.assert_array_equal(out[~touched], dmg[~touched])
    for s, e in gaps:
        g = slice(s, e)
        assert (np.mean((out[g] - clean[g]) ** 2)
                < np.mean((dmg[g] - clean[g]) ** 2))


def _tail_gap_clip():
    dmg = np.full(6000, 0.5, np.float32)
    dmg[5500:] = 0.0                       # the padded window mirrors it
    return dmg, 8000, [(5500, 6000)]


# blind detection of two far gaps; a foreign gap in a window's context;
# a file shorter than the window; a tail gap mirrored by the reflect pad;
# a span poking past the clip end
LINEAR_CASES = {
    "blind": lambda: (_long_clip()[1], 8000, None, 2.0),
    "foreign_gap": lambda: (_long_clip(n=48_000, gaps=((20_000, 25_000),
                                                       (26_000, 26_200)))[1],
                            8000, [(20_000, 25_000), (26_000, 26_200)], 1.0),
    "short_file": lambda: (_long_clip(n=6_000, gaps=((2_000, 2_300),))[1],
                           8000, None, 2.0),
    "mirrored_tail": lambda: (*_tail_gap_clip(), 1.0),
    "clamped": lambda: (_long_clip(n=48_000, gaps=((47_000, 48_000),))[1],
                        8000, [(47_000, 48_100)], 1.0),
}


@pytest.mark.parametrize("case", sorted(LINEAR_CASES))
def test_windowed_linear_matches_jax(case):
    dmg, sr, gaps, window_s = LINEAR_CASES[case]()
    got = twin.restore_windowed(dmg, sr, method="linear", window_s=window_s,
                                gaps=gaps, device="cpu")
    want = jwin.restore_windowed(dmg, sr, method="linear", window_s=window_s,
                                 gaps=gaps)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= LINEAR_RTOL_OF_PEAK * peak
    assert not np.array_equal(got, dmg)


def test_windowed_reflect_pad_mirrors_gap_validity():
    """The mirrored copies of a tail gap are damage too: a fill anchored on
    mirrored zeros would ramp the tail toward 0."""
    dmg, sr, gaps = _tail_gap_clip()
    out = twin.restore_windowed(dmg, sr, method="linear", window_s=1.0,
                                gaps=gaps, device="cpu")
    assert out[5500:6000].min() > 0.4


def test_windowed_out_of_range_gap_clamped():
    clean, dmg, sr, _ = _long_clip(n=48_000, gaps=((47_000, 48_000),))
    out = twin.restore_windowed(dmg, sr, method="linear", window_s=1.0,
                                gaps=[(47_000, 48_100)], device="cpu")
    assert np.abs(out[47_000:48_000]).min() > 0.01
    np.testing.assert_array_equal(out[:46_900], dmg[:46_900])


def test_windowed_only_processes_damage(monkeypatch):
    """Two small gaps in a long clip: exactly two window-sized restores,
    never the full clip (the O(damage) contract)."""
    calls = []
    real = tapi.restore

    def spy(damaged, sr, **kw):
        calls.append((len(damaged), sorted(kw["gaps"]), kw["device"]))
        return real(damaged, sr, **kw)

    monkeypatch.setattr(tapi, "restore", spy)
    _, dmg, sr, gaps = _long_clip()
    twin.restore_windowed(dmg, sr, method="linear", window_s=2.0, device="cpu")
    assert [c[0] for c in calls] == [2 * sr, 2 * sr]
    assert all(c[2] == torch.device("cpu") for c in calls)


def test_windowed_foreign_gap_in_context_is_masked(monkeypatch):
    """A neighbouring group's gap inside this window is damage to the
    method too, while the composite writes only the owning group's."""
    seen = []
    real = tapi.restore

    def spy(damaged, sr, **kw):
        seen.append(sorted(kw["gaps"]))
        return real(damaged, sr, **kw)

    monkeypatch.setattr(tapi, "restore", spy)
    gaps = [(20_000, 25_000), (26_000, 26_200)]
    clean, dmg, sr, _ = _long_clip(n=48_000, gaps=gaps)
    out = twin.restore_windowed(dmg, sr, method="linear", window_s=1.0,
                                gaps=gaps, device="cpu")
    assert len(seen) == 2 and all(len(local) == 2 for local in seen)
    for s, e in gaps:
        assert np.abs(out[s:e]).max() > 0.01


def test_windowed_max_window_refuses_oversized_plan():
    _, dmg, sr, _ = _long_clip(n=480_000, gaps=((100_000, 140_000),))
    with pytest.raises(ValueError, match="window"):
        twin.restore_windowed(dmg, sr, method="gp", window_s=0.5,
                              gaps=[(100_000, 140_000)], max_window=20_000,
                              device="cpu")


def test_windowed_no_gaps_is_identity():
    x = (0.5 * np.sin(np.arange(10_000) * 0.1)).astype(np.float32)
    out = twin.restore_windowed(x, 8000, method="linear", device="cpu")
    np.testing.assert_array_equal(out, x)


def test_windowed_wants_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, dmg, sr, _ = _long_clip()
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.restore_windowed(dmg, sr, method="linear")


# three windows: two of 4,000 samples, one doubled to 8,000 (two classes)
UNET_GAPS = ((10_000, 10_400), (30_000, 30_500), (50_000, 53_500))
UNET_KW = dict(method="unet", window_s=0.5, epochs=3, seed=1)
# the U-Net's window batch against window by window: the same STFTs and
# phases, the grouped net against the single ones (measured: 128.5 dB
# over the gaps, 7.5e-8 of peak)
UNET_BATCH_AGREEMENT_DB = 80.0
UNET_BATCH_ERR_OF_PEAK = 1e-4
# the batched composites against the JAX package's (tests/test_torch_neural.py's
# bound for a composite mask that differs from the training mask)
UNET_COMPOSITE_RTOL_OF_PEAK = 5e-4


def _windowed_unet(dmg, sr, gaps, batch):
    return twin.restore_windowed(dmg, sr, batch_windows=batch, gaps=gaps,
                                 device="cpu", **UNET_KW)


def test_windowed_unet_batch_equals_window_by_window(monkeypatch):
    """batch_windows=True with unet: one restore_clips_unet per window
    size, every window with the facade's preprocessing and seed; the same
    restoration as one facade call per window, clean samples untouched."""
    from audio_inpainting_torch.parallel import batch as tbatch

    _, dmg, sr, gaps = _long_clip(gaps=UNET_GAPS)
    seq = _windowed_unet(dmg, sr, gaps, False)
    classes = []
    real = tbatch.restore_clips_unet

    def spy(mags, *a, **k):
        classes.append(tuple(mags.shape))
        return real(mags, *a, **k)

    monkeypatch.setattr(tbatch, "restore_clips_unet", spy)
    bat = _windowed_unet(dmg, sr, gaps, True)
    assert sorted(c[0] for c in classes) == [1, 2]
    hole = _in_gaps(len(dmg), gaps)
    near = np.convolve(hole, np.ones(101), "same") > 0      # the 50-sample ramps
    np.testing.assert_array_equal(bat[~near], dmg[~near])
    err = np.abs(bat - seq).max() / np.abs(seq).max()
    assert err <= UNET_BATCH_ERR_OF_PEAK, err
    assert _agreement_db(seq[hole], bat[hole]) >= UNET_BATCH_AGREEMENT_DB
    for s, e in gaps:
        assert np.abs(bat[s:e]).max() > 1e-4


def _jax_unet_init(kind, seed, attempt, shape):
    from audio_inpainting_tpu.methods import neural as jneural
    from audio_inpainting_tpu.models.packed_unet import PackedSimpleUNet
    from audio_inpainting_torch.convert import flax_to_state_dict

    x = jax.numpy.zeros((1, *shape, 1), jax.numpy.float32)
    return [flax_to_state_dict(jneural._jit_init(PackedSimpleUNet(),
                                                 jax.random.PRNGKey(seed), x)["params"])]


def test_windowed_unet_batch_matches_jax(monkeypatch):
    """_restore_windows_unet_batched of both packages, with the JAX
    stripes and init (PRNGKey(seed) for every window) injected: the
    batched composite of a class of two windows. (The fills inside the gaps take the phase
    of the damaged STFT there, rounding noise that differs between the
    packages, so the composites are compared, not the samples.)"""
    import audio_inpainting_tpu.parallel.batch as jbatch
    from audio_inpainting_tpu.corrupt import training_stripes as jax_stripes
    import audio_inpainting_torch.corrupt as tcorrupt
    import audio_inpainting_torch.methods.neural as tneural
    from audio_inpainting_torch.parallel import batch as tbatch

    seed = UNET_KW["seed"]
    monkeypatch.setattr(tneural, "_draw_init", _jax_unet_init)
    monkeypatch.setattr(tcorrupt, "training_stripes", lambda gen, n, intact: np.asarray(
        jax_stripes(jax.random.PRNGKey(seed), n, intact)))
    composites = {jbatch: [], tbatch: []}
    for module, got in composites.items():
        real = module.restore_clips_unet

        def spy(*a, _real=real, _got=got, **k):
            out = _real(*a, **k)
            _got.append(np.asarray(out[0]))
            return out

        monkeypatch.setattr(module, "restore_clips_unet", spy)
    # one class of two windows: each class is one more JAX compile
    _, dmg, sr, gaps = _long_clip(gaps=UNET_GAPS[:2])
    jwin.restore_windowed(dmg, sr, batch_windows=True, gaps=gaps, **UNET_KW)
    _windowed_unet(dmg, sr, gaps, True)
    want, got = composites[jbatch], composites[tbatch]
    assert [w.shape for w in want] == [g.shape for g in got] and got[0].shape[0] == 2
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= UNET_COMPOSITE_RTOL_OF_PEAK * np.abs(w).max()


AR_KW = dict(method="ar", window_s=0.5, order=16, context_len=400)


@pytest.mark.parametrize("gaps,classes", [
    # three windows of one (size, gap count, max len) class
    (((10_000, 10_400), (40_000, 40_400), (55_000, 55_200)), 1),
    # a long span doubles its window: two classes
    (((10_000, 10_300), (36_000, 39_500)), 2),
])
def test_windowed_ar_batched_equals_sequential(gaps, classes, kernel_calls):
    """batch_windows=True: each class is one batch, one extrapolation per
    pass (one kernel launch on the GPU); every window adds the sequential
    path's noise, so batched == sequential, texture on."""
    _, dmg, sr, gaps = _long_clip(gaps=gaps)
    seq = twin.restore_windowed(dmg, sr, batch_windows=False, gaps=gaps,
                                seed=1, device="cpu", **AR_KW)
    passes = tapi.AR_DEFAULTS["passes"]
    assert len(kernel_calls) == passes * len(gaps)
    del kernel_calls[:]
    bat = twin.restore_windowed(dmg, sr, batch_windows=True, gaps=gaps,
                                seed=1, device="cpu", **AR_KW)
    assert len(kernel_calls) == passes * classes
    np.testing.assert_allclose(bat, seq, atol=BATCH_ATOL, rtol=0)
    for s, e in gaps:
        assert np.abs(bat[s:e]).max() > 1e-4


@pytest.mark.parametrize("batch", [False, True])
def test_windowed_ar_matches_jax(batch, jax_noise):
    """The JAX engine (whose windows restore sequentially or as one vmapped
    program, every window with PRNGKey(seed)) and the port, sequential or
    batched, with the JAX draws injected."""
    gaps = ((10_000, 10_400), (40_000, 40_400), (55_000, 55_200))
    _, dmg, sr, gaps = _long_clip(gaps=gaps)
    kw = dict(AR_KW, gaps=gaps, seed=2)
    want = jwin.restore_windowed(dmg, sr, batch_windows=True, **kw)
    got = twin.restore_windowed(dmg, sr, batch_windows=batch, device="cpu", **kw)
    hole = _in_gaps(len(dmg), gaps)
    np.testing.assert_array_equal(got[~hole], want[~hole])
    assert _agreement_db(want[hole], got[hole]) >= AR_AGREEMENT_DB


def test_ar_restore_gaps_windows_matches_jax(jax_noise, kernel_calls):
    """The batched window pass itself against JAX's
    ar_restore_gaps_windows: mixed gap counts in one bucket, a gap at a
    window edge."""
    rng = np.random.RandomState(4)
    t = np.arange(3000)
    subs = np.stack([np.sin(t * (0.05 + 0.01 * i)) + 0.05 * rng.randn(3000)
                     for i in range(3)]).astype(np.float32)
    gaps_list = [[(500, 700)], [(100, 220), (1500, 1600), (2900, 3000)],
                 [(0, 150), (2000, 2300)]]
    for sub, gaps in zip(subs, gaps_list):
        for s, e in gaps:
            sub[s:e] = 0.0
    kw = dict(order=20, alpha=0.5, texture=True, context_len=600, passes=2)
    want = np.asarray(jar.ar_restore_gaps_windows(subs, gaps_list,
                                                  jar.ARConfig(**kw), key=5))
    got = tar.ar_restore_gaps_windows(subs, gaps_list, tar.ARConfig(**kw), 5,
                                      device="cpu").numpy()
    assert kernel_calls == [3 * 2 * 8] * 2     # W * 2 * gpad rows, per pass
    for w, gaps in enumerate(gaps_list):
        hole = _in_gaps(3000, gaps)
        np.testing.assert_array_equal(got[w, ~hole], subs[w, ~hole])
        assert _agreement_db(want[w, hole], got[w, hole]) >= AR_AGREEMENT_DB


def test_windows_prep_refuses_what_jax_refuses():
    cfg = tar.ARConfig()
    with pytest.raises(ValueError, match="at least one gap"):
        tar.windows_prep([[(0, 10)], []], cfg)
    with pytest.raises(ValueError, match="buckets"):
        tar.windows_prep([[(0, 10)], [(0, 2000)]], cfg)
    cfg2, starts, ends, gpad, max_len = tar.windows_prep(
        [[(5, 10)], [(1, 2), (3, 40)]], cfg)
    jcfg, jstarts, jends, jgpad, jmax_len = jar.windows_prep(
        [[(5, 10)], [(1, 2), (3, 40)]], jar.ARConfig())
    assert cfg2.bucket and (gpad, max_len) == (jgpad, jmax_len) == (8, 1024)
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(ends, jends)


def test_windowed_restore_cli(tmp_path):
    """`restore --window-s` end to end through the port's CLI."""
    from audio_inpainting_torch.cli.main import main
    from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16

    clean, dmg, sr, gaps = _long_clip(n=48_000, gaps=((20_000, 20_400),))
    pin, pout = tmp_path / "in.wav", tmp_path / "out.wav"
    save_wav_int16(dmg, sr, str(pin))
    rc = main(["restore", str(pin), str(pout), "--method", "linear",
               "--threshold", "0.01", "--window-s", "1.0", "--device", "cpu"])
    assert rc == 0
    sr2, x = load_mono_normalized(str(pout))
    _, damaged = load_mono_normalized(str(pin))
    want = twin.restore_windowed(damaged, sr, method="linear", window_s=1.0,
                                 threshold=0.01, device="cpu")
    assert sr2 == sr and np.abs(x[slice(*gaps[0])]).max() > 0.01
    np.testing.assert_allclose(x, want, atol=1 / 32767)
