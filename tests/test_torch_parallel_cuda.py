"""The port's multi-device layer on the GPU: ranks that share one card
over gloo, and one rank on NCCL. These tests need a GPU and skip without
one.

- gloo all-reduces and broadcasts CUDA tensors (the only collectives it
  takes for them), and gathers through the host;
- the dry run (parallel/dryrun.py) at two ranks on one card meets the
  JAX dry run's bars;
- one rank on NCCL runs NCCL's all-reduce, broadcast and all-gather
  (counted, their results checked) and trains the shared U-Net as the
  in-process one rank does, bit for bit;
- on two cards or more, two ranks on NCCL, one a card: the collectives,
  the dry run, and run_serve(devices=2) writing the bytes of devices=1;
- the AR windows over two ranks launch the CUDA kernel on every rank,
  once a pass, and give the one-rank result within 1e-5;
- the GP's restarts (ROADMAP Queue 3, F3): each restart's likelihood and
  gradient at the whole batch's shape and its own row are the bits of
  the whole batch's, and two ranks pick the one-rank winner.

The GPU machine has no JAX, and tests/conftest.py imports it, so this
file imports no JAX and runs there without the conftest:

    python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_inpainting_torch.corrupt import contiguous_gap_mask, synth_music_clip
from audio_inpainting_torch.methods import gp
from audio_inpainting_torch.methods.ar import ARConfig, ar_restore_gaps_windows
from audio_inpainting_torch.ops import ar_scan
from audio_inpainting_torch.parallel import (Ranks, ar_restore_windows_dp, fit_shared_unet,
                                             gp_fit_predict_mesh, launch)
from audio_inpainting_torch.parallel import mesh
from audio_inpainting_torch.parallel.dryrun import dryrun_multichip

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

RANKS_ATOL = 1e-5
GP_RANKS_ATOL = 5e-5    # the posterior, two ranks against one
GP_THETA_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _collectives_rank(ranks: Ranks) -> dict:
    t = torch.full((3,), float(ranks.rank + 1), device=ranks.device)
    mesh.all_reduce_sum(t, ranks)
    b = torch.full((2,), float(ranks.rank), device=ranks.device)
    mesh.broadcast(b, ranks.world - 1, ranks)
    g = mesh.gather(torch.full((1, 2), float(ranks.rank), device=ranks.device), ranks)
    return {"sum": t, "bcast": b, "gather": g, "device": str(t.device)}


def _check_collectives(res: dict, world: int) -> None:
    assert res["sum"].tolist() == [world * (world + 1) / 2] * 3
    assert res["bcast"].tolist() == [world - 1.0] * 2
    assert res["gather"].tolist() == [[float(r)] * 2 for r in range(world)]


def _counted_rank(ranks: Ranks) -> dict:
    """_collectives_rank, then _fit_rank, with torch.distributed's
    collectives counted as the rank layer calls them."""
    counts = {}
    real = {n: getattr(dist, n) for n in ("all_reduce", "broadcast", "all_gather_object")}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for name in real:
        setattr(dist, name, counted(name))
    try:
        return {"collectives": _collectives_rank(ranks), "fit": _fit_rank(ranks),
                "counts": counts, "backend": dist.get_backend()}
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _fit_rank(ranks: Ranks):
    """Three steps of the shared U-Net under cuDNN's deterministic
    kernels (with the others a run parts from its own rerun)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x, y, m = _batch()
        return fit_shared_unet(x, y, m, ranks, steps=3)
    finally:
        torch.backends.cudnn.deterministic = old


def _batch():
    rng = np.random.RandomState(0)
    x, y = (rng.rand(2, 64, 128, 1).astype(np.float32) for _ in range(2))
    return x, y, (rng.rand(2, 64, 128, 1) > 0.3).astype(np.float32)


def _windows(n=5, wlen=4096):
    t = np.arange(wlen, dtype=np.float32)
    wins = np.stack([0.5 * np.sin(2 * np.pi * (3 + i) * t / wlen)
                     for i in range(n)]).astype(np.float32)
    gaps = []
    for i in range(n):
        s = 1500 + 97 * i
        wins[i, s:s + 300] = 0.0
        gaps.append([(s, s + 300)])
    return wins, gaps


CFG = ARConfig(order=30, context_len=1000, texture=True, passes=2)


def _ar_rank(ranks: Ranks):
    wins, gaps = _windows()
    ar_scan.LAUNCHES = 0
    out = ar_restore_windows_dp(wins, gaps, CFG, ranks, 2)
    torch.cuda.synchronize()
    return out, mesh.gather_objects(ar_scan.LAUNCHES, ranks)


@pytest.mark.requires_cuda
def test_gloo_collectives_on_cuda_tensors(cuda):
    res = launch(_collectives_rank, 2, devices="cuda:0", backend="gloo")
    assert res["device"] == "cuda:0"
    _check_collectives(res, 2)


@pytest.mark.requires_cuda
def test_dryrun_two_ranks_share_the_card(cuda):
    res = dryrun_multichip(2, "cuda:0", "gloo")
    assert res["device"] == "cuda:0" and res["backend"] == "gloo"


@pytest.mark.requires_cuda
def test_nccl_one_rank_is_the_in_process_rank(cuda):
    res = launch(_counted_rank, 1, devices="cuda:0")
    assert res["backend"] == "nccl"
    _check_collectives(res["collectives"], 1)
    # one all-reduce a step (gradients and loss), the collectives' own
    assert res["counts"] == {"all_reduce": 4, "broadcast": 1, "all_gather_object": 1}
    state, loss = res["fit"]
    state1, loss1 = _fit_rank(Ranks.solo(cuda))
    assert loss == loss1
    for k in state:
        assert torch.equal(state[k], state1[k]), k


@pytest.mark.requires_cuda
def test_ar_windows_launch_the_kernel_on_every_rank(cuda):
    out, launches = launch(_ar_rank, 2, devices="cuda:0", backend="gloo")
    assert launches == [CFG.passes, CFG.passes]
    wins, gaps = _windows()
    idx = mesh.pad_repeat_last(len(gaps), 2).reshape(2, -1)
    same = torch.cat([ar_restore_gaps_windows(wins[r], [gaps[i] for i in r], CFG, 2,
                                              device=cuda).cpu() for r in idx])[:len(gaps)]
    torch.testing.assert_close(out, same, atol=RANKS_ATOL, rtol=0)


def _part0_segment():
    """Part 0's GP problem: the 0.05 s mid-clip segment of
    synth_music_clip(0) at 44.1 kHz with a 20 % gap; (x, y, x_star)."""
    sr = 44100
    clean = synth_music_clip(0, sr, 10.0)
    n = int(0.05 * sr)
    seg = clean[len(clean) // 2:len(clean) // 2 + n]
    _, (gs, ge) = contiguous_gap_mask(n, 0.2)
    keep = np.ones(n, bool)
    keep[gs:ge] = False
    t = np.arange(n, dtype=np.float32) / sr
    return t[keep], seg[keep], t[~keep]


def _gp_rank(ranks: Ranks):
    mu, sd, theta = gp_fit_predict_mesh(*_part0_segment(), gp.GPConfig(), ranks, 0)
    return mu.cpu(), sd.cpu(), theta.cpu()


@pytest.mark.requires_cuda
def test_gp_restart_rows_do_not_depend_on_their_batch(cuda):
    """At the default GPConfig's fit points, every rank's restarts for 2,
    3 and 4 ranks, evaluated as gp.fit_rows evaluates them: their values
    and gradients are the bits of the same rows of the whole batch."""
    x, y, _ = (torch.as_tensor(a, device=cuda) for a in _part0_segment())
    k = gp.GPConfig().fit_subsample
    x, y = x[::k], ((y - y.mean()) / y.std(correction=0))[::k]
    u0, loss, _ = gp._restarts(x, y, gp.GPConfig(), 0)
    v_all, g_all = gp._value_and_grad(loss, u0)
    for parts in (2, 3, 4):
        for rows in mesh.split_rows(len(u0), parts, fill=0):
            idx = torch.as_tensor(rows, device=cuda)
            v, g = gp._value_and_grad(loss, gp.restart_layout(u0, idx))
            assert torch.equal(v[idx], v_all[idx]) and torch.equal(g[idx], g_all[idx]), rows


@pytest.mark.requires_cuda
def test_gp_two_ranks_pick_the_one_rank_winner(cuda):
    """gp_fit_predict_mesh on two gloo ranks sharing the card against
    gp_fit_predict on one: theta within 1e-4 relative, the posterior
    within 5e-5."""
    mu, sd, theta = launch(_gp_rank, 2, devices="cuda:0", backend="gloo")
    mu1, sd1, theta1 = (a.cpu() for a in gp.gp_fit_predict(*_part0_segment(), gp.GPConfig(),
                                                           0, device=cuda))
    assert float(((theta - theta1) / theta1).abs().max()) <= GP_THETA_RTOL
    torch.testing.assert_close(mu, mu1, atol=GP_RANKS_ATOL, rtol=0)
    torch.testing.assert_close(sd, sd1, atol=GP_RANKS_ATOL, rtol=0)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.requires_cuda
def test_nccl_two_cards_collectives_and_dryrun(two_cards):
    """Two ranks on NCCL, cuda:0 and cuda:1: the collectives, and the dry
    run's modes against one rank by its bars."""
    res = launch(_collectives_rank, 2)
    _check_collectives(res, 2)
    dry = dryrun_multichip(2, None, "nccl")
    assert dry["backend"] == "nccl" and dry["device"] == "cuda:0"


@pytest.mark.requires_cuda
def test_nccl_two_cards_serve_writes_the_bytes_of_one(two_cards, tmp_path):
    """run_serve(devices=2) with ar, one rank a card on NCCL, writes the
    WAVs of devices=1 byte for byte."""
    from audio_inpainting_torch.io import save_wav_int16
    from audio_inpainting_torch.pipelines.serve import run_serve

    sr, din = 8000, tmp_path / "in"
    din.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        t = np.arange(sr // 2 + 512 * i)
        x = (0.6 * np.sin(2 * np.pi * (220 + 60 * i) * t / sr)
             + 0.05 * rng.randn(len(t))).astype(np.float32)
        x[1000:1400] = 0.0
        save_wav_int16(x / np.abs(x).max(), sr, str(din / f"clip{i}.wav"))
    one = run_serve(str(din), str(tmp_path / "one"), method="ar")
    two = run_serve(str(din), str(tmp_path / "two"), method="ar", devices=2)
    assert two["files"] == one["files"] and two["clips"] == 3
    for name in one["files"]:
        assert (tmp_path / "two" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()
