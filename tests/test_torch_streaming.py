"""The port's streaming engine (audio_inpainting_torch/methods/streaming.py,
methods/unet_stream.py and the CLI's ``stream``) against the JAX
package's, on the CPU. Mirrors tests/test_streaming.py and
tests/test_stream_cli.py."""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.streaming as jstream
from audio_inpainting_torch import api as tapi
from audio_inpainting_torch.corrupt import find_gaps
from audio_inpainting_torch.kernels import build
from audio_inpainting_torch.methods import ar as tar
from audio_inpainting_torch.methods import neural as tneural
from audio_inpainting_torch.methods import streaming as tstream
from audio_inpainting_torch.methods.unet_stream import PersistentUNetStream
from audio_inpainting_torch.methods.windowed import _merge_close, restore_windowed

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

# the facade's bound against the JAX package with its draws injected
AR_AGREEMENT_DB = 60.0


def _clip(sr=8000, n=120_000, gaps=((30_000, 30_400), (80_000, 80_600))):
    t = np.arange(n)
    x = (0.6 * np.sin(2 * np.pi * 2 * t / sr)
         + 0.2 * np.sin(2 * np.pi * 330 * t / sr)).astype(np.float32)
    dmg = x.copy()
    for s, e in gaps:
        dmg[s:e] = 0.0
    return x, dmg, sr, [tuple(g) for g in gaps]


def _run(dmg, sr, chunk, restorer=tstream.StreamRestorer, **kw):
    if restorer is tstream.StreamRestorer:
        kw.setdefault("device", "cpu")
    rest = restorer(sr, **kw)
    parts = [rest.feed(dmg[i:i + chunk]) for i in range(0, len(dmg), chunk)]
    parts.append(rest.flush())
    return np.concatenate(parts)


def _jax_draws(seed, p, shape, device):
    """The JAX package's pass-p texture draw in place of the port's."""
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed), p), shape)), device=device)


def _agreement_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


def test_stream_clean_passthrough_bit_identical():
    x, _, sr, _ = _clip(gaps=())
    out = _run(x, sr, 7_777, method="linear", window_s=1.0)
    np.testing.assert_array_equal(out, x)


def test_stream_restores_gaps_and_preserves_clean():
    clean, dmg, sr, gaps = _clip()
    out = _run(dmg, sr, 16_000, method="linear", window_s=1.0, margin=50)
    assert out.shape == dmg.shape
    touched = np.zeros(len(dmg), bool)
    for s, e in gaps:
        touched[s - 50:e + 50] = True
    np.testing.assert_array_equal(out[~touched], dmg[~touched])
    for s, e in gaps:
        g = slice(s, e)
        assert (np.mean((out[g] - clean[g]) ** 2)
                < np.mean((dmg[g] - clean[g]) ** 2))


@pytest.mark.parametrize("chunk", [1_000, 7_777])
def test_stream_linear_matches_jax(chunk):
    """The same stream through both engines: the same windows, host
    np.interp fills and numpy composites, so the same bytes."""
    _, dmg, sr, _ = _clip()
    kw = dict(method="linear", window_s=1.0, margin=50)
    got = _run(dmg, sr, chunk, **kw)
    want = _run(dmg, sr, chunk, restorer=jstream.StreamRestorer, **kw)
    np.testing.assert_array_equal(got, want)


def test_stream_one_sample_feeds_equal_one_feed():
    _, dmg, sr, _ = _clip(n=12_000, gaps=((5_000, 5_300),))
    kw = dict(method="linear", window_s=0.5)
    np.testing.assert_array_equal(_run(dmg, sr, 1, **kw),
                                  _run(dmg, sr, len(dmg), **kw))


def test_stream_chunk_size_invariance():
    _, dmg, sr, _ = _clip(n=60_000, gaps=((20_000, 20_400),))
    outs = [_run(dmg, sr, c, method="linear", window_s=1.0)
            for c in (1_000, 7_777, 60_000)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_stream_matches_offline_windowed_fill():
    """A gap far from both stream ends gets the window the offline engine
    plans, so the fill is the same."""
    _, dmg, sr, _ = _clip(n=120_000, gaps=((60_000, 60_400),))
    out_s = _run(dmg, sr, 10_000, method="linear", window_s=1.0, margin=50)
    out_w = restore_windowed(dmg, sr, method="linear", window_s=1.0,
                             margin=50, device="cpu")
    np.testing.assert_allclose(out_s, out_w, atol=1e-7)


def test_stream_bounded_latency_on_clean_audio():
    x, _, sr, _ = _clip(n=64_000, gaps=())
    rest = tstream.StreamRestorer(sr, method="linear", window_s=1.0,
                                  margin=50, device="cpu")
    emitted = 0
    for i in range(0, len(x), 8_000):
        emitted += len(rest.feed(x[i:i + 8_000]))
        assert rest.pending <= 50 + 1 + 256  # margin + slack for quiet tail
    emitted += len(rest.flush())
    assert emitted == len(x)


def test_stream_gap_held_until_context_then_emitted():
    clean, dmg, sr, gaps = _clip(n=48_000, gaps=((24_000, 24_400),))
    rest = tstream.StreamRestorer(sr, method="linear", window_s=1.0,
                                  margin=50, device="cpu")
    out1 = rest.feed(dmg[:25_000])     # gap just arrived: must be held
    assert len(out1) < 24_000 - 50 + 1
    out = np.concatenate([out1, rest.feed(dmg[25_000:]), rest.flush()])
    g = slice(*gaps[0])
    assert (np.mean((out[g] - clean[g]) ** 2)
            < np.mean((dmg[g] - clean[g]) ** 2))


def test_stream_tail_gap_restored_at_flush():
    _, dmg, sr, _ = _clip(n=40_000, gaps=((39_000, 40_000),))
    out = _run(dmg, sr, 6_000, method="linear", window_s=1.0)
    assert len(out) == len(dmg)
    assert np.abs(out[39_000:]).min() > 0.0


def test_stream_monster_gap_tiled_bounded_memory():
    """Damage far beyond the window cap is restored in fixed tiles and the
    buffer stays O(cap + pending); the bytes are the JAX engine's."""
    sr, n = 8000, 200_000
    x = (0.5 * np.sin(2 * np.pi * 3 * np.arange(n) / sr)).astype(np.float32)
    dmg = x.copy()
    dmg[40_000:160_000] = 0.0          # 120k-sample hole, cap 16k
    kw = dict(method="linear", window_s=0.5, max_doublings=2, margin=50)
    rest = tstream.StreamRestorer(sr, device="cpu", **kw)
    held, parts = [], []
    for i in range(0, n, 8_000):
        parts.append(rest.feed(dmg[i:i + 8_000]))
        held.append(len(rest._buf))
    parts.append(rest.flush())
    out = np.concatenate(parts)
    assert len(out) == n and np.isfinite(out).all()
    assert max(held) < 4 * rest.cap + 16_000
    # the detector opens the span at 39_992 (the sine is sub-threshold for
    # ~8 samples before its zero crossing), so the ramp starts at 39_942
    np.testing.assert_array_equal(out[:39_942], dmg[:39_942])
    np.testing.assert_array_equal(
        out, _run(dmg, sr, 8_000, restorer=jstream.StreamRestorer, **kw))


def test_restore_stream_generator():
    clean, dmg, sr, gaps = _clip(n=40_000, gaps=((20_000, 20_300),))
    chunks = [dmg[i:i + 9_000] for i in range(0, len(dmg), 9_000)]
    out = np.concatenate(list(tstream.restore_stream(
        chunks, sr, method="linear", window_s=1.0, device="cpu")))
    assert out.shape == dmg.shape
    g = slice(*gaps[0])
    assert (np.mean((out[g] - clean[g]) ** 2)
            < np.mean((dmg[g] - clean[g]) ** 2))


def test_stream_feed_after_flush_raises():
    rest = tstream.StreamRestorer(8000, method="linear", device="cpu")
    rest.flush()
    with pytest.raises(RuntimeError):
        rest.feed(np.zeros(10, np.float32))


def test_stream_wants_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstream.StreamRestorer(8000, method="linear")


def test_stream_warmup_linear_is_noop():
    assert tstream.StreamRestorer(8000, method="linear",
                                  device="cpu").warmup() == 0


AR_KW = dict(method="ar", window_s=0.064, max_doublings=1, order=8,
             context_len=64, margin=20)


def test_stream_warmup_then_feed_builds_nothing(monkeypatch):
    """warmup() runs the windows the JAX package warms, through the same
    _call_method as the live path; after it a feed loads no kernel library
    (kernels.build.load misses nothing; on the CPU nothing is built at
    all, on the GPU the first window built it)."""
    sr = 4000
    _, dmg, _, gaps = _clip(sr=sr, n=24_000, gaps=((9_000, 9_120),
                                                   (17_000, 17_110)))
    rest = tstream.StreamRestorer(sr, device="cpu", **AR_KW)
    calls = []
    real = rest._call_method
    monkeypatch.setattr(rest, "_call_method",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    # the JAX package's windows: sizes 256 and 512 (one doubling), each
    # at gap-count buckets 8 and 32 and the one length bucket, 1024
    assert rest.warmup() == len(calls) == 4
    misses = build.load.cache_info().misses
    parts = [rest.feed(dmg[i:i + 3_000]) for i in range(0, len(dmg), 3_000)]
    parts.append(rest.flush())
    assert build.load.cache_info().misses == misses
    out = np.concatenate(parts)
    assert out.shape == dmg.shape
    for s, e in gaps:
        assert np.abs(out[s:e]).max() > 1e-4


def test_stream_ar_chunk_size_invariance_bucketed():
    sr = 4000
    _, dmg, _, _ = _clip(sr=sr, n=20_000, gaps=((9_000, 9_150),))
    outs = [_run(dmg, sr, c, **AR_KW) for c in (900, 5_000, 20_000)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_concurrent_streams_stay_independent():
    """Interleaved feeding of two streams changes no bytes against running
    each alone."""
    sr = 4000
    _, dmg_a, _, _ = _clip(sr=sr, n=20_000, gaps=((9_000, 9_150),))
    _, dmg_b, _, _ = _clip(sr=sr, n=20_000, gaps=((5_000, 5_200),
                                                  (14_000, 14_120)))
    solo_a = _run(dmg_a, sr, 2_000, **AR_KW)
    solo_b = _run(dmg_b, sr, 2_000, **AR_KW)
    ra = tstream.StreamRestorer(sr, device="cpu", **AR_KW)
    rb = tstream.StreamRestorer(sr, device="cpu", **AR_KW)
    ra.warmup()
    outs_a, outs_b = [], []
    for i in range(0, 20_000, 2_000):
        outs_a.append(ra.feed(dmg_a[i:i + 2_000]))
        outs_b.append(rb.feed(dmg_b[i:i + 2_000]))
    outs_a.append(ra.flush())
    outs_b.append(rb.flush())
    np.testing.assert_array_equal(np.concatenate(outs_a), solo_a)
    np.testing.assert_array_equal(np.concatenate(outs_b), solo_b)


def test_stream_waits_for_a_short_quiet_run_inside_its_window(monkeypatch):
    """The chunk-invariance hole of the JAX engine (its streaming.py:449):
    a group whose span exceeds ~window/2 - 2*min_len closes while a quiet
    run inside its window is still under min_len. JAX restores the window
    at once when a chunk ends there, with the run unmasked; fed in one
    piece the run has grown into a detected span and is masked: the AR
    fills differ (pass 2 fits on pass 1's fill of the run). The port waits
    until the run is settled, so any chunking gives the bytes JAX gives
    for one big feed."""
    monkeypatch.setattr(tar, "_draw_eps", _jax_draws)
    sr, n = 8000, 20_000
    t = np.arange(n)
    x = (0.4 + 0.2 * np.sin(2 * np.pi * 330 * t / sr)
         + 0.1 * np.sin(2 * np.pi * 1234 * t / sr)).astype(np.float32)
    # window 4000 (ctx 500): the group [10000, 12400) spans 2400 and its
    # window ends at 13200; the run [13150, 13300) is 50 samples long
    # when a chunk ends at 13200, and 150 (> min_len 100) once closed
    gaps = [(10_000, 10_150), (12_250, 12_400), (13_150, 13_300)]
    dmg = x.copy()
    for s, e in gaps:
        dmg[s:e] = 0.0
    kw = dict(method="ar", window_s=0.5, margin=50)
    jax_fine = _run(dmg, sr, 200, restorer=jstream.StreamRestorer, **kw)
    jax_whole = _run(dmg, sr, n, restorer=jstream.StreamRestorer, **kw)
    assert not np.array_equal(jax_fine, jax_whole)        # the JAX hole
    ours = [_run(dmg, sr, c, **kw) for c in (200, 1, n)]
    np.testing.assert_array_equal(ours[0], ours[2])
    np.testing.assert_array_equal(ours[1], ours[2])
    hole = np.zeros(n, bool)
    for s, e in gaps:
        hole[s:e] = True
    np.testing.assert_array_equal(ours[0][~hole], jax_whole[~hole])
    assert _agreement_db(jax_whole[hole], ours[0][hole]) >= AR_AGREEMENT_DB
    assert _agreement_db(jax_fine[hole], ours[0][hole]) < AR_AGREEMENT_DB


def _dense_dropouts(n, seed=0, sr=8000):
    """Dropouts of 110-200 samples every 120-400 loud samples on a loud
    carrier: restore groups fill their windows and chain."""
    rng = np.random.default_rng(seed)
    x = (0.4 + 0.2 * np.sin(2 * np.pi * 330 * np.arange(n) / sr)).astype(np.float32)
    pos = 500
    while pos < n - 500:
        length = int(rng.integers(110, 200))
        x[pos:pos + length] = 0.0
        pos += length + int(rng.integers(120, 400))
    return x


def _windows(restorer, dmg, chunk, **kw):
    """The (w0, size, members) of every window a stream restores, and its
    output."""
    rest = restorer(8000, **kw)
    seen = []
    real = rest._restore_piece

    def piece(members, w0, size, spans):
        seen.append((w0, size, tuple(members)))
        return real(members, w0, size, spans)

    rest._restore_piece = piece
    parts = [rest.feed(dmg[i:i + chunk]) for i in range(0, len(dmg), chunk)]
    return sorted(seen), np.concatenate(parts + [rest.flush()])


@pytest.mark.parametrize("max_doublings", [0, 1])
def test_stream_grouping_survives_history_trim(max_doublings):
    """Dense dropouts chain the restore groups; the JAX engine regroups the
    retained spans greedily from the first one after each history trim,
    so its windows depend on the chunking (here 1,000-sample chunks plan
    more windows than one feed). The port keeps the partition's origin
    across the trim: the same windows and bytes for any chunking, AR
    included."""
    dmg = _dense_dropouts(40_000)
    kw = dict(method="linear", window_s=0.25, max_doublings=max_doublings)
    jax_fine = _windows(jstream.StreamRestorer, dmg, 1_000, **kw)[0]
    jax_whole = _windows(jstream.StreamRestorer, dmg, len(dmg), **kw)[0]
    assert jax_fine != jax_whole                          # the JAX hole
    ours = [_windows(tstream.StreamRestorer, dmg, c, device="cpu", **kw)
            for c in (1_000, len(dmg))]
    assert ours[0][0] == ours[1][0] == jax_whole
    np.testing.assert_array_equal(ours[0][1], ours[1][1])
    ar_kw = dict(kw, method="ar", order=8, context_len=200, device="cpu")
    short = dmg[:16_000]
    np.testing.assert_array_equal(
        _windows(tstream.StreamRestorer, short, 700, **ar_kw)[1],
        _windows(tstream.StreamRestorer, short, len(short), **ar_kw)[1])


def test_tape_append_drop_compaction():
    rng = np.random.default_rng(0)
    tape = tstream._Tape()
    mirror = np.zeros(0, np.float32)
    for _ in range(300):
        chunk = rng.standard_normal(rng.integers(1, 5000)).astype(np.float32)
        tape.append(chunk)
        mirror = np.concatenate([mirror, chunk])
        if rng.random() < 0.5 and len(mirror) > 10:
            d = int(rng.integers(0, len(mirror)))
            tape.drop(d)
            mirror = mirror[d:]
        assert len(tape) == len(mirror)
        np.testing.assert_array_equal(tape.view(), mirror)
    # writes through the view stick (the composite relies on it)
    tape.view()[:5] = 7.0
    np.testing.assert_array_equal(tape.view()[:5], np.full(5, 7.0, np.float32))
    tape.drop(10**9)
    assert len(tape) == 0


def test_incremental_detection_matches_find_gaps_oracle():
    """The O(chunk) scanner gives EXACTLY find_gaps(x, 0.01, 100) merged by
    the 2*margin rule, however the stream is chunked."""
    rng = np.random.default_rng(7)
    n = 30_000
    x = (0.3 + 0.2 * rng.random(n)).astype(np.float32)
    x *= np.where(rng.random(n) < 0.5, -1, 1)
    runs = [(1_000, 1_100), (2_000, 2_101), (2_160, 2_400), (9_000, 9_050),
            (15_000, 16_500), (16_560, 16_700), (29_800, 30_000)]
    for s, e in runs:
        x[s:e] = 1e-4 * rng.standard_normal(e - s)
    want = _merge_close(find_gaps(x, threshold=0.01, min_len=100), 100)
    for seed in range(3):
        r2 = np.random.default_rng(seed)
        rest = tstream.StreamRestorer(8_000, method="linear", window_s=0.5,
                                      margin=50, device="cpu")
        i = 0
        while i < n:
            c = x[i:i + int(r2.integers(1, 997))]
            rest._buf.append(c)
            rest._out.append(c)
            rest._scan_chunk(c)
            rest._total += len(c)
            i += len(c)
        got, tail_start = rest._detect()
        assert got == [tuple(g) for g in want], (got, want)
        assert tail_start == 29_800


@pytest.mark.parametrize("size,frac,n_runs,margin", [
    (32_768, 0.9, 32, 20), (4_000, 0.5, 8, 50), (1_024, 0.99, 128, 20)])
def test_warm_runs_two_sided_fillers_reach_bucket(size, frac, n_runs, margin):
    runs = tstream._warm_runs(size, int(frac * size), n_runs, margin)
    assert runs == jstream._warm_runs(size, int(frac * size), n_runs, margin)
    assert runs == sorted(runs)
    assert all(0 <= s < e <= size for s, e in runs)
    for (s1, e1), (s2, _) in zip(runs, runs[1:]):
        assert s2 - e1 >= 2 * margin     # no pair merges
    if size == 32_768:
        assert len(runs) == 32           # both sides used: the bucket holds


def test_stream_default_window_is_per_method():
    sr = 8000
    assert tstream.DEFAULT_WINDOW_S == jstream.DEFAULT_WINDOW_S

    def window(method, **kw):
        return tstream.StreamRestorer(sr, method, device="cpu", **kw).window

    assert window("linear") == window("gp") == int(0.5 * sr)
    assert window("ar") == window("unet", epochs=1) == 2 * sr
    assert window("nmf") == 10 * sr
    assert window("linear", window_s=4.0) == 4 * sr


def test_stream_linear_default_window_latency():
    sr = 8000
    _, dmg, _, _ = _clip(sr=sr, n=40_000, gaps=((20_000, 20_400),))
    rest = tstream.StreamRestorer(sr, method="linear", device="cpu")
    assert rest.window == 4_000
    peak = 0
    for i in range(0, len(dmg), 800):      # 100 ms chunks
        rest.feed(dmg[i:i + 800])
        peak = max(peak, rest.pending)
    rest.flush()
    assert peak < sr, peak


# -------------------------------------------------------- persistent U-Net

def _unet_kw(**extra):
    return dict(method="unet", window_s=1.0, margin=40, epochs=3,
                adapt_epochs=2, **extra)


def _unet_window(sr=8000):
    t = np.arange(8_000)
    sub = (0.5 * np.sin(2 * np.pi * 220 * t / sr)).astype(np.float32)
    # 2000 samples: a column is damaged when >= 80% of its 1024-sample
    # window is, so a hole shorter than ~820 samples leaves none
    mask = np.ones(8_000, bool)
    mask[3_000:5_000] = False
    sub[3_000:5_000] = 0.0
    return sub, mask


def test_persistent_unet_carries_across_any_chunking():
    sr = 8000
    _, dmg, _, _ = _clip(sr=sr, n=32_000, gaps=((9_000, 10_500),
                                                (22_000, 23_500)))
    outs, rests = [], []
    for chunk in (2_500, 32_000):
        rest = tstream.StreamRestorer(sr, device="cpu", **_unet_kw())
        parts = [rest.feed(dmg[i:i + chunk]) for i in range(0, len(dmg), chunk)]
        parts.append(rest.flush())
        outs.append(np.concatenate(parts))
        rests.append(rest)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert rests[0]._unet is not None and rests[0]._unet.state is not None


def test_persistent_unet_opt_out_matches_the_facade():
    """persist=False: every window is an independent facade restore, the
    offline windowed engine's restore of the same window."""
    sr = 8000
    _, dmg, _, _ = _clip(sr=sr, n=20_000, gaps=((9_000, 11_000),))
    rest = tstream.StreamRestorer(sr, device="cpu", **_unet_kw(persist=False))
    assert rest._unet is None
    parts = [rest.feed(dmg[i:i + 4_000]) for i in range(0, len(dmg), 4_000)]
    out = np.concatenate(parts + [rest.flush()])
    want = restore_windowed(dmg, sr, method="unet", window_s=1.0, margin=40,
                            epochs=3, device="cpu")
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_persistent_unet_first_window_is_the_facade():
    """The first window trains cfg.epochs from the seeded init with the
    facade's stripes and masks: the facade's own restore of that window."""
    sub, mask = _unet_window()
    ps = PersistentUNetStream(seed=3, adapt_epochs=2, epochs=3, device="cpu")
    got = ps.restore_window(sub, mask)
    want = tapi.restore(sub, 8000, method="unet", mask=mask, seed=3, epochs=3,
                        device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_persistent_unet_adapts_and_warm_window_keeps_the_carry():
    sub, mask = _unet_window()
    ps = PersistentUNetStream(seed=0, adapt_epochs=2, epochs=3, device="cpu")
    out1 = ps.restore_window(sub, mask)
    p1 = {k: v.clone() for k, v in ps.state.items()}
    ps.warm_window(sub, mask)
    assert all(torch.equal(ps.state[k], v) for k, v in p1.items())
    out2 = ps.restore_window(sub, mask)
    assert out1.shape == out2.shape == sub.shape
    # window 2 started from window 1's weights and moved them
    assert any(not torch.equal(ps.state[k], v) for k, v in p1.items())
    assert not np.array_equal(out1, out2)
    assert ps.adapt_epochs == 2
    assert PersistentUNetStream(adapt_epochs=500, epochs=3,
                                device="cpu").adapt_epochs == 3


def test_persistent_unet_hole_content_never_reaches_the_weights():
    """The carried weights are bit-identical whatever the holes contain:
    hole columns are out of the loss, so sub-threshold garbage inside a
    gap cannot reach the weights that persist to later windows."""
    sr, n = 8000, 24_000
    t = np.arange(n)
    x = (0.6 * np.sin(2 * np.pi * 2 * t / sr)
         + 0.2 * np.sin(2 * np.pi * 330 * t / sr)).astype(np.float32)
    a = x.copy()
    a[10_000:13_000] = 0.0
    b = a.copy()
    # noise >= 1024 samples (the STFT n_fft) inside the hole: every column
    # holding it is wholly damaged, so out of the loss and the input
    b[11_024:11_976] = 1e-3 * np.random.default_rng(3).standard_normal(
        952).astype(np.float32)
    states = []
    for dmg in (a, b):
        rest = tstream.StreamRestorer(sr, device="cpu", **_unet_kw())
        for i in range(0, n, 3_000):
            rest.feed(dmg[i:i + 3_000])
        rest.flush()
        states.append(rest._unet.state)
    assert states[0].keys() == states[1].keys()
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


def test_seeded_unet_init_does_not_depend_on_the_shape():
    """The JAX package inits on a canonical shape so one compiled init
    serves every window size; the port's init ignores the shape, so the
    persistent net needs no counterpart of that."""
    small = tneural._draw_init("unet", 0, 0, (8, 32))
    window = tneural._draw_init("unet", 0, 0, (516, 64))
    assert small[0].keys() == window[0].keys()
    assert all(torch.equal(small[0][k], window[0][k]) for k in small[0])


# ------------------------------------------------------------------- CLI

def _pipe(args, body):
    return subprocess.run(
        [sys.executable, "-m", "audio_inpainting_torch", "stream", *args,
         "--device", "cpu"],
        input=body, capture_output=True, timeout=600)


def test_stream_cli_pipe_matches_engine():
    """PCM piped through the CLI comes out as the in-process engine's bytes:
    the CLI is a transport, not a second engine."""
    clean, dmg, sr, gaps = _clip(n=48_000, gaps=((20_000, 20_400),))
    proc = _pipe(["--sr", str(sr), "--method", "linear", "--window-s", "1.0",
                  "--chunk", "7777"], np.asarray(dmg, "<f4").tobytes())
    assert proc.returncode == 0, proc.stderr.decode()
    out = np.frombuffer(proc.stdout, "<f4")
    np.testing.assert_array_equal(out, _run(dmg, sr, 7777, method="linear",
                                            window_s=1.0))
    g = slice(*gaps[0])
    assert (np.mean((out[g] - clean[g]) ** 2)
            < np.mean((dmg[g] - clean[g]) ** 2))
    assert b"streamed" in proc.stderr


def test_stream_cli_partial_sample_tail_warns():
    _, dmg, sr, _ = _clip(n=8_000, gaps=((4_000, 4_100),))
    body = np.asarray(dmg, "<f4").tobytes() + b"\x01\x02"
    proc = _pipe(["--sr", str(sr), "--method", "linear", "--window-s", "1.0"],
                 body)
    assert proc.returncode == 0, proc.stderr.decode()
    assert len(np.frombuffer(proc.stdout, "<f4")) == len(dmg)
    assert b"trailing bytes" in proc.stderr
