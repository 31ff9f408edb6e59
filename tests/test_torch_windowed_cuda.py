"""The windowed and streaming engines and the AR repairs on the GPU,
against the same calls on the CPU. These tests need a GPU and skip
without one.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_windowed_cuda.py
"""

import numpy as np
import pytest
import torch

from audio_inpainting_torch import api, restore
from audio_inpainting_torch.corrupt import (find_gaps, random_dropout_mask,
                                            synth_music_clip)
from audio_inpainting_torch.kernels import build
from audio_inpainting_torch.methods import ar
from audio_inpainting_torch.methods.streaming import StreamRestorer
from audio_inpainting_torch.methods.windowed import restore_windowed
from audio_inpainting_torch.ops import ar_scan

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

SR = 8000
# GPU against CPU with the same draws: the fits' sums run in another order
# on the card, and the rounding carries through the recurrence
AGREEMENT_DB = 60.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dropout_clip(seconds=8.0, seed=0):
    clean = synth_music_clip(seed, SR, seconds)
    mask = random_dropout_mask(torch.Generator().manual_seed(seed), len(clean),
                               0.25, 50, 400).numpy()
    return (clean * mask).astype(np.float32)


def _agreement_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-300))


def _gap_mask(dmg, margin=0):
    """The detected gaps, widened by the composite's ``margin`` ramps."""
    m = np.zeros(len(dmg), bool)
    for s, e in find_gaps(dmg, 0.01, 100):
        m[max(s - margin, 0):e + margin] = True
    return m


@pytest.mark.requires_cuda
def test_draw_eps_is_the_same_on_cuda_and_cpu(cuda):
    """F1: one seed, the same texture noise on every device."""
    got = ar._draw_eps(3, 1, (940, 724), cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), ar._draw_eps(3, 1, (940, 724),
                                               torch.device("cpu")))


@pytest.mark.requires_cuda
def test_facade_ar_with_texture_on_cuda_matches_cpu(cuda):
    dmg = _dropout_clip()
    gpu = restore(dmg, SR, method="ar", device=cuda)
    cpu = restore(dmg, SR, method="ar", device="cpu")
    hole = _gap_mask(dmg)
    np.testing.assert_array_equal(gpu[~hole], dmg[~hole])
    assert _agreement_db(cpu[hole], gpu[hole]) >= AGREEMENT_DB


@pytest.mark.requires_cuda
def test_order_above_the_kernel_limit_runs_on_cuda(cuda):
    """F2: order 256 takes the chunked form on the GPU (no kernel launch)
    and matches the CPU's plain loop."""
    dmg = _dropout_clip(seconds=4.0)
    before = ar_scan.LAUNCHES
    gpu = restore(dmg, SR, method="ar", order=256, device=cuda)
    torch.cuda.synchronize()
    assert ar_scan.LAUNCHES == before
    cpu = restore(dmg, SR, method="ar", order=256, device="cpu")
    hole = _gap_mask(dmg)
    np.testing.assert_array_equal(gpu[~hole], dmg[~hole])
    assert np.isfinite(gpu).all() and hole.any()
    assert _agreement_db(cpu[hole], gpu[hole]) >= AGREEMENT_DB


@pytest.mark.requires_cuda
def test_batched_windowed_ar_launches_once_per_class(cuda):
    """The batched windowed AR on the GPU: one kernel launch per pass and
    (size, gap-count bucket, max-len bucket) class; equal to the
    sequential GPU run within 1e-5 and to the CPU run at >= 60 dB."""
    dmg = _dropout_clip(seconds=16.0)
    kw = dict(method="ar", window_s=1.0, seed=4)
    passes = api.AR_DEFAULTS["passes"]

    ar_scan.LAUNCHES = 0
    seq = restore_windowed(dmg, SR, batch_windows=False, device=cuda, **kw)
    windows = ar_scan.LAUNCHES // passes
    ar_scan.LAUNCHES = 0
    bat = restore_windowed(dmg, SR, batch_windows=True, device=cuda, **kw)
    classes = ar_scan.LAUNCHES // passes
    assert ar_scan.LAUNCHES == passes * classes and 1 <= classes < windows

    np.testing.assert_allclose(bat, seq, atol=1e-5, rtol=0)
    cpu = restore_windowed(dmg, SR, batch_windows=True, device="cpu", **kw)
    hole = _gap_mask(dmg, margin=50)
    np.testing.assert_array_equal(bat[~hole], dmg[~hole])
    assert _agreement_db(cpu[hole], bat[hole]) >= AGREEMENT_DB


def _unload_kernel():
    """Drop the loaded kernel library, so the next call that needs it
    loads it again: one miss of build.load."""
    ar_scan._library.cache_clear()
    build.load.cache_clear()


@pytest.mark.requires_cuda
def test_stream_ar_on_cuda_matches_cpu_and_warmup_builds_first(cuda):
    """On cuda, warmup loads the kernel and the feeds load nothing; without
    warmup the feeds load it once. On the CPU nothing loads it."""
    dmg = _dropout_clip(seconds=6.0)
    outs = []
    for dev, warm, loads in ((cuda, True, (1, 0)), (cuda, False, (0, 1)),
                             ("cpu", True, (0, 0))):
        _unload_kernel()
        rest = StreamRestorer(SR, method="ar", device=dev)
        if warm:
            assert rest.warmup(max_gap_s=0.05, max_runs=128) > 0
        warmed = build.load.cache_info().misses
        parts = [rest.feed(dmg[i:i + 4096]) for i in range(0, len(dmg), 4096)]
        outs.append(np.concatenate(parts + [rest.flush()]))
        assert (warmed, build.load.cache_info().misses - warmed) == loads
    gpu, unwarmed, cpu = outs
    np.testing.assert_array_equal(unwarmed, gpu)
    assert gpu.shape == cpu.shape == dmg.shape
    hole = _gap_mask(dmg, margin=50)
    np.testing.assert_array_equal(gpu[~hole], dmg[~hole])
    assert _agreement_db(cpu[hole], gpu[hole]) >= AGREEMENT_DB
