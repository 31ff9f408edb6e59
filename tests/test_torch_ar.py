"""The port's AR method (audio_inpainting_torch/methods/ar.py) against the
JAX package's, on the CPU, stage by stage and end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_inpainting_tpu.methods.ar as jar
from audio_inpainting_torch import convert
from audio_inpainting_torch.methods import ar as tar

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)


def _signal(n=6000, seed=11):
    """Damped oscillators + noise: a textured signal an AR model fits."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    return (np.sin(t * 0.11) + 0.4 * np.sin(t * 0.037)
            + 0.05 * rng.randn(n)).astype(np.float32)


def _jax_eps(seed, p, shape):
    """The texture draw of the JAX package's pass p: normal(fold_in(key, p))."""
    return np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(seed), p), shape))


def _agreement_snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


def _contexts(x, starts, ends, C):
    jc, jp = jar._extract_contexts(jnp.asarray(x), jnp.asarray(starts),
                                   jnp.asarray(ends), C)
    tc, tp = tar._extract_contexts(torch.as_tensor(x), torch.as_tensor(starts),
                                   torch.as_tensor(ends), C)
    return (np.asarray(jc), np.asarray(jp)), (tc, tp)


# gaps at the clip start and end exercise the front padding of both sides
@pytest.mark.parametrize("gaps", [[(2500, 2800)],
                                  [(30, 200), (3000, 3100), (5900, 6000)]])
def test_extract_contexts_exactly_equal(gaps):
    x = _signal()
    starts = np.array([s for s, _ in gaps], np.int64)
    ends = np.array([e for _, e in gaps], np.int64)
    (jc, jp), (tc, tp) = _contexts(x, starts, ends, 500)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tp.numpy(), jp)


def test_fit_ridge_matches_jax():
    x = _signal()
    cfg = tar.ARConfig(order=24, alpha=0.5, context_len=1500)
    jcfg = jar.ARConfig(order=24, alpha=0.5, context_len=1500)
    starts, ends = np.array([300, 2500]), np.array([500, 2800])
    (jc, jp), (tc, tp) = _contexts(x, starts, ends, cfg.context_len)
    jw, jb, js, jv = map(np.asarray, jar._fit_ridge_batched(
        jnp.asarray(jc), jnp.asarray(jp), jcfg))
    tw, tb, ts, tv = (t.numpy() for t in tar._fit_ridge_batched(tc, tp, cfg))
    np.testing.assert_array_equal(tv, jv)
    # float32 normal equations solved in two frameworks: the Gram sums and
    # the Cholesky round differently, and the Gram of two sinusoids is
    # ill-conditioned. Measured here: |dw| / |w| per row 9e-5 .. 7e-4,
    # |db| 7e-8, |dsigma| / sigma 2e-6, one-step predictions 5e-5 of their
    # peak. The bounds below are about 3x those.
    rel_w = np.linalg.norm(tw - jw, axis=1) / np.linalg.norm(jw, axis=1)
    assert rel_w.max() <= 2e-3, rel_w
    np.testing.assert_allclose(tb, jb, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
    X = np.lib.stride_tricks.sliding_window_view(jc, 24, axis=1)[:, :-1]
    jpred = np.einsum("bro,bo->br", X, jw) + jb[:, None]
    tpred = np.einsum("bro,bo->br", X, tw) + tb[:, None]
    assert np.abs(tpred - jpred).max() <= 2e-4 * np.abs(jpred).max()


@pytest.mark.parametrize("texture", [False, True])
def test_extrapolate_forms_agree_on_the_jax_fit(texture):
    """The JAX fit and noise, carried over with convert.py, drive the port's
    plain loop and chunked form; both are held to JAX's own forms."""
    x = _signal()
    jcfg = jar.ARConfig(order=24, alpha=0.5, context_len=1500, chunk=64)
    st, en = jnp.asarray([2500]), jnp.asarray([2800])
    ctxs, pads = jar._extract_contexts(jnp.asarray(x), st, en, 1500)
    fit = jar._fit_ridge_batched(ctxs, pads, jcfg)
    key = jax.random.PRNGKey(0)
    steps = 300   # 4.7 chunks of 64: padding and trim
    jseq = np.asarray(jar._extrapolate_scan(ctxs, *fit, key, steps, texture))
    jchk = np.asarray(jar._extrapolate_chunked(ctxs, *fit, key, steps,
                                               texture, 64))
    w, b, std, valid = convert.ar_fit_from_numpy(*map(np.asarray, fit),
                                                 device="cpu")
    eps = (convert.eps_from_numpy([jax.random.normal(key, (steps, 2))],
                                  "cpu")[0]
           if texture else torch.zeros(steps, 2))
    tc = torch.as_tensor(np.asarray(ctxs))
    tseq = tar._extrapolate_scan(tc, w, b, std, valid, eps, steps).numpy()
    tchk = tar._extrapolate_chunked(tc, w, b, std, valid, eps, steps,
                                    64).numpy()
    # same fit, same noise, same op order: only sum order differs
    np.testing.assert_allclose(tseq, jseq, atol=1e-4, rtol=0)
    # chunked vs per-sample: reassociation over a multi-chunk horizon, the
    # tolerance of tests/test_ar.py's chunked-vs-scan test
    np.testing.assert_allclose(tchk, tseq, atol=2e-3, rtol=0)
    np.testing.assert_allclose(tchk, jchk, atol=2e-3, rtol=0)


def test_blend_and_paste_matches_jax():
    x = _signal(3000)
    rng = np.random.RandomState(2)
    starts, lens = np.array([100, 1000, 2950]), np.array([50, 1, 80])
    max_len = 80
    fwd = rng.randn(3, max_len).astype(np.float32)
    bwd = rng.randn(3, max_len).astype(np.float32)
    fv, bv = np.array([True, True, False]), np.array([True, False, True])
    j = np.asarray(jar._blend_and_paste(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(fwd), jnp.asarray(bwd), jnp.asarray(fv), jnp.asarray(bv),
        max_len))
    t = tar._blend_and_paste(
        torch.as_tensor(x), torch.as_tensor(starts), torch.as_tensor(lens),
        torch.as_tensor(fwd), torch.as_tensor(bwd), torch.as_tensor(fv),
        torch.as_tensor(bv), max_len).numpy()
    # the last gap runs past the clip end: those samples are dropped
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    untouched = np.ones(3000, bool)
    for s, L in zip(starts, lens):
        untouched[s:s + L] = False
    np.testing.assert_array_equal(t[untouched], x[untouched])


def test_bucketed_dummy_gaps_paste_nothing():
    x = _signal(4000)
    gaps = [(1000, 1150), (2500, 2600)]
    cfg = tar.ARConfig(order=16, alpha=0.5, texture=False, context_len=600)
    plain = tar.ar_restore_gaps(x, gaps, cfg, device="cpu").numpy()
    bucketed = tar.ar_restore_gaps(
        x, gaps, tar.ARConfig(order=16, alpha=0.5, texture=False,
                              context_len=600, bucket=True),
        device="cpu").numpy()
    mask = np.ones(4000, bool)
    for s, e in gaps:
        mask[s:e] = False
    np.testing.assert_array_equal(bucketed[mask], x[mask])
    # bucketing pads the batch and the horizon only: the real gaps' fills
    # are the unbucketed ones
    np.testing.assert_allclose(bucketed[~mask], plain[~mask], atol=1e-5)
    assert tar.bucket_gap_count(2) == jar.bucket_gap_count(2) == 8
    assert tar.bucket_max_len(150) == jar.bucket_max_len(150) == 1024


def test_gap_at_boundary_falls_back_one_sided():
    """Mirror of tests/test_ar.py's one-sided fallback test."""
    clean = np.sin(np.arange(3000) * 0.2).astype(np.float32)
    cfg = tar.ARConfig(order=20, alpha=0.1, texture=False, context_len=500)
    got = tar.ar_restore_gaps(clean, [(0, 100)], cfg, device="cpu").numpy()
    assert np.all(np.isfinite(got))
    assert _agreement_snr(clean[:100], got[:100]) > 10


@pytest.mark.parametrize("texture", [False, True])
def test_ar_restore_gaps_matches_jax_end_to_end(texture):
    x = _signal(8000, seed=5)
    gaps = [(50, 250), (1500, 1800), (4000, 4130), (7900, 8000)]
    kw = dict(order=30, alpha=0.5, texture=texture, context_len=1000,
              passes=2)
    seed = 7
    jout = np.asarray(jar.ar_restore_gaps(jnp.asarray(x), gaps,
                                          jar.ARConfig(**kw), key=seed))
    max_len, B = 300, 2 * len(gaps)
    eps = [_jax_eps(seed, p, (max_len, B)) for p in range(2)]
    tout = tar.ar_restore_gaps(x, gaps, tar.ARConfig(**kw), seed,
                               eps=convert.eps_from_numpy(eps, "cpu"),
                               device="cpu").numpy()
    mask = np.ones(len(x), bool)
    for s, e in gaps:
        mask[s:e] = False
    np.testing.assert_array_equal(tout[mask], x[mask])
    np.testing.assert_array_equal(jout[mask], x[mask])
    # the fit's rounding carries through the recurrence, so the fills are
    # held by agreement SNR, not by atol
    assert _agreement_snr(jout[~mask], tout[~mask]) >= 60.0


def test_ar_restore_gap_detailed_matches_jax():
    x = _signal(4000, seed=3)
    gap = (1700, 1900)
    kw = dict(order=30, alpha=0.1, texture=False, context_len=1700)
    jout, jf, jb = jar.ar_restore_gap_detailed(jnp.asarray(x), gap,
                                               jar.ARConfig(**kw), key=0)
    tout, tf, tb = tar.ar_restore_gap_detailed(x, gap, tar.ARConfig(**kw),
                                               device="cpu")
    assert tf.shape == tb.shape == (200,)
    assert _agreement_snr(np.asarray(jout), tout.numpy()) >= 60.0
    assert _agreement_snr(jf, tf) >= 60.0
    assert _agreement_snr(jb, tb) >= 60.0


def test_texture_draws_are_seeded_per_pass():
    x = _signal(3000, seed=4)
    cfg = tar.ARConfig(order=20, alpha=0.5, texture=True, context_len=800)
    a = tar.ar_restore_gaps(x, [(1000, 1200)], cfg, 7, device="cpu").numpy()
    b = tar.ar_restore_gaps(x, [(1000, 1200)], cfg, 7, device="cpu").numpy()
    c = tar.ar_restore_gaps(x, [(1000, 1200)], cfg, 8, device="cpu").numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a[1000:1200], c[1000:1200])


def test_texture_draws_come_from_a_cpu_generator():
    """F1: the texture noise is drawn on a seeded CPU generator and copied,
    so every device adds the same numbers. A draw for the meta device
    (which has no generator of its own) shows that no device generator is
    involved."""
    mixed = np.random.SeedSequence([7, 1]).generate_state(1, np.uint64)[0]
    want = torch.randn((40, 6), generator=torch.Generator().manual_seed(
        int(mixed) >> 1))
    torch.testing.assert_close(tar._draw_eps(7, 1, (40, 6), torch.device("cpu")),
                               want, rtol=0, atol=0)
    meta = tar._draw_eps(7, 1, (40, 6), torch.device("meta"))
    assert meta.device.type == "meta" and tuple(meta.shape) == (40, 6)


@pytest.mark.parametrize("order,chunk,device_type,want", [
    (30, 0, "cuda", 0),              # the kernel
    (tar.MAX_ORDER, 0, "cuda", 0),   # the kernel's largest order
    (225, 0, "cuda", 256),           # above it: chunked at a multiple of 32
    (256, 0, "cuda", 256),
    (300, 0, "cuda", 320),
    (256, 0, "cpu", 0),              # the CPU's plain loop takes any order
    (100, 128, "cuda", 128),         # an asked-for chunk stands
    (100, 128, "cpu", 128),
])
def test_extrapolation_routing(order, chunk, device_type, want):
    """F2: orders above the CUDA kernel's limit take the chunked
    companion-matrix form on the GPU, as JAX takes its plain scan above
    its kernel's (JAX methods/ar.py:351)."""
    assert tar.extrapolation_chunk(order, chunk, device_type) == want


@pytest.mark.parametrize("texture", [False, True])
def test_order_above_the_kernel_limit_takes_the_chunked_form(texture,
                                                             monkeypatch):
    """F2 end to end: order 256 routed as on the GPU (the chunked form at
    chunk 256) against the CPU's plain loop; measured 133 dB apart."""
    x = _signal()
    gaps = [(2500, 2800), (4000, 4100)]
    cfg = tar.ARConfig(order=256, alpha=0.5, texture=texture,
                       context_len=1500, passes=1)
    plain = tar.ar_restore_gaps(x, gaps, cfg, 3, device="cpu").numpy()
    route = tar.extrapolation_chunk
    routed = []

    def as_on_gpu(order, chunk, device_type):
        routed.append(route(order, chunk, "cuda"))
        return routed[-1]

    monkeypatch.setattr(tar, "extrapolation_chunk", as_on_gpu)
    chunked = tar.ar_restore_gaps(x, gaps, cfg, 3, device="cpu").numpy()
    assert routed == [256]
    mask = np.ones(len(x), bool)
    for s, e in gaps:
        mask[s:e] = False
    np.testing.assert_array_equal(chunked[mask], x[mask])
    assert _agreement_snr(plain[~mask], chunked[~mask]) >= 60.0
