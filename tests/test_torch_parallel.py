"""The port's multi-device layer (audio_inpainting_torch/parallel/: mesh.py,
train.py, spatial.py, engines.py, the ``ranks`` of batch.py, gan_batch.py,
methods/windowed.py and pipelines/serve.py) on the CPU: ranks are spawned
processes over gloo. Each mode at two ranks (the time-split U-Net at
2 x 2) is held against the port at one rank and against the JAX
package's parallel layer on the conftest's virtual devices at the same
mesh size (``make_mesh(2)``, ``make_mesh_2d(2, 2)``). Mirrors
tests/test_parallel.py.

The ranks import this module to find their functions, so JAX is imported
inside the tests only; the JAX package's draws reach the ranks as data
(``_Draws``), in place of the port's seeded draws.

Bounds:
- two ranks against one (the JAX package's dry-run bars): the shared
  U-Net's loss within 1e-5 and its parameters within 1e-6; the
  time-split U-Net's loss and forward within 1e-5; AR windows within
  1e-5, texture on; the GP's winner within 1e-6 relative and its
  posterior within 5e-5; the per-clip U-Nets and GANs against one rank
  running the ranks' batches within 1e-5 of peak, and against one rank's
  whole batch by the batch-against-single bounds of
  tests/test_torch_batch.py (losses 1e-4 relative, composites 1e-4 and
  1e-3 of peak: a batch's grouped convs sum in an order of its size);
  the window restores within 1e-5 of peak;
- against JAX: losses 1e-4 relative, parameters after 2 Adam steps
  within 1e-4 (a tenth of one step), the forward within 1e-5; the STFT
  within 1e-4 of peak (tests/test_torch_stft_metrics.py's bound); AR
  fills >= 60 dB with JAX's noise injected; the GP's fill within 3 dB of
  JAX's local SNR; the per-clip U-Net and GAN batches by
  tests/test_torch_batch.py's bounds.
"""

import numpy as np
import pytest
import torch

import audio_inpainting_torch.methods.gp as tgp
import audio_inpainting_torch.methods.neural as tn
from audio_inpainting_torch.convert import flax_to_state_dict
from audio_inpainting_torch.io import load_mono_normalized, save_wav_int16
from audio_inpainting_torch.methods.ar import ARConfig, ar_restore_gaps_windows
from audio_inpainting_torch.methods.windowed import restore_windowed
from audio_inpainting_torch.metrics import local_snr_db
from audio_inpainting_torch.ops import stft, torch_stft_config
from audio_inpainting_torch.parallel import (Ranks, ar_restore_windows_dp,
                                             fit_shared_unet, fit_shared_unet_spatial,
                                             gp_fit_predict_mesh, launch, make_mesh_2d,
                                             predict_spatial, restore_clips_gan,
                                             restore_clips_unet, shard_batch,
                                             stft_frame_parallel)
from audio_inpainting_torch.parallel import mesh
from audio_inpainting_torch.parallel.dryrun import dryrun_multichip
from audio_inpainting_torch.pipelines.serve import run_serve

# One intra-op thread: Tier-1 runs 6 xdist workers, and every worker
# imports this module. With more threads, torch's CPU FFT (MKL) gives
# results that differ in the last bits from process to process under
# load, which unsettles the torch oracles of other test files.
torch.set_num_threads(1)

RANKS_ATOL = 1e-5
PARAM_RANKS_ATOL = 1e-6
GP_ATOL = 5e-5
THETA_RTOL = 1e-6
LOSS_RTOL = 1e-4
PARAM_JAX_ATOL = 1e-4
FORWARD_ATOL = 1e-5
STFT_RTOL_OF_PEAK = 1e-4
AR_AGREEMENT_DB = 60.0
GP_MARGIN_DB = 3.0
UNET_RTOL_OF_PEAK = 1e-4
GAN_RTOL_OF_PEAK = 1e-3

B, F_, T_ = 2, 16, 32            # the shared U-Net's batch (mode 1)
SB, ST = 2, 96                   # the time-split batch: T over 2 tp ranks
G, GF, GT = 2, 30, 60            # per-clip nets, padded to (32, 64)
SIG_N = 8192
AR_CFG = dict(order=8, context_len=64, texture=True, passes=2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _agreement_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


class _Draws:
    """A picklable stand-in for a port draw function that returns the
    entries of a table: ``_draw_init(kind, seed, attempt, shape)`` by
    (kind, seed, attempt), ``_draw_restarts(seed, n, device)`` by seed."""

    def __init__(self, table, key):
        self.table, self.key = table, key

    def __call__(self, *args):
        if self.key == "init":
            kind, seed, attempt, _ = args
            return self.table[(kind, seed, attempt)]
        seed, _, device = args
        return self.table[seed].to(device)


# -------------------------------------------------------------- inputs ----


def _mode1_inputs():
    rng = np.random.RandomState(0)
    x, y = (rng.rand(B, F_, T_, 1).astype(np.float32) for _ in range(2))
    return x, y, (rng.rand(B, F_, T_, 1) > 0.3).astype(np.float32)


def _spatial_inputs():
    rng = np.random.RandomState(1)
    tgt = rng.rand(SB, F_, ST, 1).astype(np.float32)
    m = (rng.rand(*tgt.shape) > 0.3).astype(np.float32)
    return tgt * m, tgt, m


def _signal():
    return np.random.RandomState(3).randn(SIG_N).astype(np.float32)


def _windows(n=3, wlen=1024):
    """n same-bucket windows with one gap each (3 over 2 ranks: padded)."""
    t = np.arange(wlen, dtype=np.float32)
    wins = np.stack([0.5 * np.sin(2 * np.pi * (3 + i) * t / wlen)
                     for i in range(n)]).astype(np.float32)
    gaps = []
    for i in range(n):
        s = 300 + 29 * i
        wins[i, s:s + 110] = 0.0
        gaps.append([(s, s + 110)])
    return wins, gaps


def _sine_gap(n=320, sr=16000):
    """tests/test_gp.py's small sine gap."""
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * 200 * t) + 0.3 * np.sin(2 * np.pi * 450 * t)).astype(
        np.float32)
    mask = np.ones(n, bool)
    gs, ge = int(n * 0.4), int(n * 0.4) + int(n * 0.2)
    mask[gs:ge] = False
    return x, mask, gs, ge, sr


GP_CFG = dict(n_restarts=2, opt_steps=20)    # 3 restarts: padded to 4


def _specs(seed=0):
    rng = np.random.RandomState(seed)
    v = np.einsum("gfo,got->gft", np.abs(rng.randn(G, GF, 4)), np.abs(rng.randn(G, 4, GT)))
    v = (v / v.max(axis=(1, 2), keepdims=True)).astype(np.float32)
    mask = np.ones((G, GF, GT), np.float32)
    for i in range(G):
        mask[i, :, 20 + 6 * i:32 + 6 * i] = 0.0
    return v, mask


def _gan_case():
    v, mask = _specs(seed=9)
    real = v * 2 - 1
    return real * mask - (1 - mask), real, mask


def _long_clip(sr=8000, n=24_000):
    t = np.arange(n)
    x = (0.6 * np.sin(2 * np.pi * 2 * t / sr)
         + 0.2 * np.sin(2 * np.pi * 330 * t / sr)).astype(np.float32)
    gaps = [(4_000, 4_300), (12_000, 12_300), (20_000, 20_200)]
    for s, e in gaps:
        x[s:e] = 0.0
    return x, sr, gaps


# --------------------------------------------- the ranks' functions ----


def _world2_rank(ranks: Ranks, draws: dict) -> dict:
    """Every two-rank mode but the time split, and on rank 0 the same at
    one rank; the JAX draws installed first."""
    tn._draw_init = draws["init"]
    tgp._draw_restarts = draws["restarts"]
    solo = Ranks.solo("cpu")
    lead = ranks.rank == 0
    out = {}

    def both(name, fn):
        out[name] = fn(ranks)
        if lead:
            out[name + "_1"] = fn(solo)

    x, y, m = _mode1_inputs()
    both("dp", lambda r: fit_shared_unet(x, y, m, r, steps=2, params=draws["unet0"]))
    both("stft", lambda r: stft_frame_parallel(_signal(), torch_stft_config(1024, 256), r))
    wins, gaps = _windows()
    cfg = ARConfig(**AR_CFG)
    both("ar_jax", lambda r: ar_restore_windows_dp(wins, gaps, cfg, r, 3, eps=draws["eps"]))
    both("ar_seeded", lambda r: ar_restore_windows_dp(wins, gaps, cfg, r, 3))
    sx, mask, *_ = _sine_gap()
    t = np.arange(len(sx), dtype=np.float32) / 16000
    both("gp", lambda r: gp_fit_predict_mesh(t[mask], sx[mask], t[~mask],
                                             tgp.GPConfig(**GP_CFG), r, 0))
    if lead:        # one rank running the two ranks' restart batches
        out["gp_batches"] = gp_fit_predict_mesh(t[mask], sx[mask], t[~mask],
                                                tgp.GPConfig(**GP_CFG), solo, 0, batches=2)
    v, keep = _specs(seed=1)
    ucfg = tn.UNetTrainConfig(epochs=3)
    both("unet", lambda r: restore_clips_unet(v[..., None], keep[..., None], ucfg,
                                              list(range(G)), ranks=r))
    inp, real, gmask = _gan_case()
    gcfg = tn.GANTrainConfig(epochs=2, ema_decay=0.9, ema_scope="gap")
    both("gan", lambda r: restore_clips_gan(inp, real, gmask, gcfg, list(range(G)),
                                            ranks=r))
    if lead:        # one rank running the ranks' batches, a clip each
        out["unet_same"] = torch.cat([restore_clips_unet(
            v[g:g + 1, ..., None], keep[g:g + 1, ..., None], ucfg, [g], ranks=solo)[0]
            for g in range(G)])
        out["gan_same"] = torch.cat([restore_clips_gan(
            inp[g:g + 1], real[g:g + 1], gmask[g:g + 1], gcfg, [g], ranks=solo)[0]
            for g in range(G)])
    clip, sr, cgaps = _long_clip()
    kw = dict(window_s=0.25, gaps=cgaps, seed=1)
    both("win_unet", lambda r: restore_windowed(clip, sr, "unet", batch_windows=True,
                                                epochs=2, ranks=r, **kw))
    both("win_ar", lambda r: restore_windowed(clip, sr, "ar", batch_windows=True,
                                              order=16, context_len=400, ranks=r, **kw))
    both("win_linear", lambda r: restore_windowed(clip, sr, "linear", ranks=r, **kw))
    return out


def _world4_rank(ranks: Ranks, params: dict) -> dict:
    """The 2 x 2 mesh's forward and 2-step fit, and on rank 0 the same at
    one rank."""
    mesh2 = make_mesh_2d(ranks, 2, 2)
    solo = Ranks.solo("cpu")
    inp, tgt, m = _spatial_inputs()
    out = {"fwd": predict_spatial(params, tgt, mesh2),
           "fit": fit_shared_unet_spatial(inp, tgt, m, mesh2, steps=2, params=params)}
    if ranks.rank == 0:
        out["fwd_1"] = predict_spatial(params, tgt, solo)
        out["fit_1"] = fit_shared_unet_spatial(inp, tgt, m, solo, steps=2, params=params)
    return out


def _report_rank(ranks: Ranks) -> dict:
    """The rank's coordinates on a 2 x 2 mesh and its shards."""
    r2 = make_mesh_2d(ranks, 2, 2)
    return mesh.gather_objects((ranks.rank, r2.dp, r2.tp,
                                shard_batch(list(range(4)), r2)), ranks)


def _collectives_rank(ranks: Ranks) -> dict:
    """The rank layer's collectives, with torch.distributed's counted as
    the layer calls them: an all-reduce, a broadcast from the last rank,
    and a gather."""
    counts = {}
    real = {n: getattr(torch.distributed, n)
            for n in ("all_reduce", "broadcast", "all_gather_object")}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for name in real:
        setattr(torch.distributed, name, counted(name))
    try:
        t = mesh.all_reduce_sum(torch.full((3,), float(ranks.rank + 1)), ranks)
        b = mesh.broadcast(torch.full((2,), float(ranks.rank)), ranks.world - 1, ranks)
        g = mesh.gather(torch.full((1, 2), float(ranks.rank)), ranks)
    finally:
        for name, fn in real.items():
            setattr(torch.distributed, name, fn)
    return {"sum": t, "bcast": b, "gather": g, "counts": counts}


def _failing_rank(ranks: Ranks) -> None:
    if ranks.rank == 1:
        raise ValueError("rank one gives up")
    torch.distributed.barrier()             # rank 0 waits for ever: ended


# ------------------------------------------------------ the rank layer ----


@pytest.mark.parametrize("devices,backend,match", [
    ("cpu", "nccl", "CUDA devices only"),
    (["cuda:0", "cuda:0"], "nccl", "share a card take gloo"),
    (["cuda:0", "cuda:0"], None, "must name their backend"),
    (["cpu", "cuda:0"], None, "must name their backend"),
    ("cpu", "mpi", "unknown backend"),
])
def test_ranks_backend_rules(devices, backend, match):
    """The backend is the caller's: nccl on the CPU or with two ranks on
    one card raises, and so does a default for ranks that share a card;
    nothing is spawned."""
    with pytest.raises(ValueError, match=match):
        launch(_report_rank, 2, devices=devices, backend=backend)


def test_ranks_default_backends():
    cpu, c0, c1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))
    assert mesh.default_backend([cpu, cpu]) == "gloo"
    assert mesh.default_backend([c0, c1]) == "nccl"
    assert mesh.rank_devices(2) == [c0, c1]
    assert mesh.rank_devices(2, "cuda") == [c0, c0]
    with pytest.raises(RuntimeError, match="CUDA devices"):
        mesh.check_backend("gloo", [c0, c0])       # no card here


def test_ranks_shard_and_pad():
    """Contiguous dp slices; JAX's divisibility where it asserts it, and
    its repeat-the-last padding."""
    ranks = [Ranks(r, 4, torch.device("cpu")) for r in range(4)]
    assert [mesh.shard_range(8, r) for r in ranks] == [slice(0, 2), slice(2, 4),
                                                       slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_range(6, ranks[0])
    assert [len(range(6)[mesh.shard_range(6, r, exact=False)]) for r in ranks] == [2, 2, 1, 1]
    np.testing.assert_array_equal(mesh.pad_repeat_last(5, 4), [0, 1, 2, 3, 4, 4, 4, 4])
    np.testing.assert_array_equal(mesh.pad_repeat_last(4, 4), [0, 1, 2, 3])


def test_ranks_launch_meshes_and_failure():
    """Four spawned ranks lay JAX's reshape(n_dp, n_tp) out; a rank that
    raises fails the launch with its traceback, and the rank left waiting
    in a collective is ended."""
    got = launch(_report_rank, 4, devices="cpu")
    assert got == [(0, 0, 0, [0, 1]), (1, 0, 1, [0, 1]), (2, 1, 0, [2, 3]),
                   (3, 1, 1, [2, 3])]
    with pytest.raises(RuntimeError, match="rank one gives up"):
        launch(_failing_rank, 2, devices="cpu")


@pytest.mark.parametrize("world", [1, 2])
def test_ranks_collectives_run_wherever_a_group_is(world):
    """A launched rank has a process group, and the layer's collectives
    run on it at every world size, one rank too (they are NCCL's on a
    card); their results are the sums, the source's values and every
    rank's shard."""
    res = launch(_collectives_rank, world, devices="cpu")
    assert res["counts"] == {"all_reduce": 1, "broadcast": 1, "all_gather_object": 1}
    assert res["sum"].tolist() == [world * (world + 1) / 2] * 3
    assert res["bcast"].tolist() == [world - 1.0] * 2
    assert res["gather"].tolist() == [[float(r)] * 2 for r in range(world)]


def test_ranks_solo_has_no_group_and_rows_split():
    """Ranks.solo has no process group: gather hands back its tensor and
    gather_objects a list of one, with no collective. split_rows and
    rank_rows pad with the last index or a fill; ranks_on makes a world
    of one and refuses a device that is not the ranks'."""
    solo = mesh.ranks_on(None, "cpu")
    assert solo == Ranks.solo("cpu") and solo.backend is None
    x = torch.arange(4.0)
    assert mesh.gather(x, solo) is x and mesh.gather_objects(7, solo) == [7]
    assert mesh.make_mesh_2d(solo, 1, 1) == solo
    np.testing.assert_array_equal(mesh.split_rows(5, 2), [[0, 1, 2], [3, 4, 4]])
    np.testing.assert_array_equal(mesh.split_rows(5, 2, fill=0), [[0, 1, 2], [3, 4, 0]])
    np.testing.assert_array_equal(mesh.rank_rows(5, Ranks(1, 2, torch.device("cpu"))),
                                  [3, 4, 4])
    assert mesh.ranks_on(solo, "cpu") is solo
    with pytest.raises(ValueError, match="beside ranks"):
        mesh.ranks_on(solo, "cuda:0")


def test_ranks_dryrun_two_ranks():
    """dryrun_multichip: modes 1, 2, 3, 5, 6 and 7 at two gloo ranks
    against one, by the JAX dry run's bars (parallel/dryrun.py)."""
    res = dryrun_multichip(2, "cpu")
    assert res["backend"] == "gloo" and res["ranks"] == 2
    assert np.isfinite(res["dp_loss"]) and np.isfinite(res["tp_loss"])


# ------------------------------------------------- two ranks against JAX ----


@pytest.fixture(scope="module")
def jax_draws():
    """The JAX package's draws, converted: the shared U-Net's init, the
    per-clip nets' inits by clip index, the AR texture draws of the
    windows, the GP's restart draws."""
    import jax
    import jax.numpy as jnp

    import audio_inpainting_tpu.methods.neural as jn
    from audio_inpainting_tpu.methods.ar import ARConfig as JARConfig
    from audio_inpainting_tpu.methods.ar import windows_prep
    from audio_inpainting_tpu.models.packed_unet import (PackedDiscriminator,
                                                         PackedGeneratorUNet,
                                                         PackedSimpleUNet)
    from audio_inpainting_tpu.parallel.train import init_shared_unet

    params0, _ = init_shared_unet(jax.random.PRNGKey(0), F_, T_)
    table = {}
    x = jnp.zeros((1, GF + 2, GT + 4, 1), jnp.float32)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(4), G)):
        table[("unet", i, 0)] = [flax_to_state_dict(
            jn._jit_init(PackedSimpleUNet(), key, x)["params"])]
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(7), G)):
        kg, kd = jax.random.split(key)
        g = jn._jit_init_train(PackedGeneratorUNet(), kg, x)
        d = jn._jit_init_train(PackedDiscriminator(), kd, x)
        table[("gan", i, 0)] = [flax_to_state_dict(g["params"], g["batch_stats"]),
                                flax_to_state_dict(d["params"], d["batch_stats"])]
    _, gaps = _windows()
    _, _, _, gpad, max_len = windows_prep(gaps, JARConfig(**AR_CFG))
    eps = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(3), p), (max_len, 2 * gpad))))
        for p in range(AR_CFG["passes"])]
    restarts = {0: torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (GP_CFG["n_restarts"], 5))))}
    return {"jax_params0": params0, "unet0": flax_to_state_dict(params0),
            "init": _Draws(table, "init"), "restarts": _Draws(restarts, "restarts"),
            "eps": eps}


@pytest.fixture(scope="module")
def world2(jax_draws):
    draws = {k: v for k, v in jax_draws.items() if k != "jax_params0"}
    return launch(_world2_rank, 2, devices="cpu", args=(draws,))


def test_ranks_shared_unet_matches_one_rank_and_jax(world2, jax_draws):
    """Mode 1: two Adam steps of the shared U-Net over two dp ranks, from
    the JAX init, against one rank and against JAX's step on make_mesh(2)."""
    import jax
    import jax.numpy as jnp

    from audio_inpainting_tpu.parallel import make_mesh
    from audio_inpainting_tpu.parallel import shard_batch as jshard
    from audio_inpainting_tpu.parallel.mesh import replicated
    from audio_inpainting_tpu.parallel.train import _TX, shared_unet_train_step

    (state, loss), (state1, loss1) = world2["dp"], world2["dp_1"]
    assert abs(loss - loss1) <= RANKS_ATOL
    for k in state:
        torch.testing.assert_close(state[k], state1[k], atol=PARAM_RANKS_ATOL, rtol=0)

    jmesh = make_mesh(2)
    p = replicated(jax.tree_util.tree_map(jnp.copy, jax_draws["jax_params0"]), jmesh)
    o = replicated(_TX.init(p), jmesh)
    args = [jshard(jnp.asarray(a), jmesh) for a in _mode1_inputs()]
    for _ in range(2):
        p, o, jloss = shared_unet_train_step(p, o, *args)
    assert _rel(loss, float(jloss)) <= LOSS_RTOL
    want = flax_to_state_dict(jax.device_get(p))
    for k in want:
        torch.testing.assert_close(state[k], want[k], atol=PARAM_JAX_ATOL, rtol=0)


def test_ranks_stft_frame_parallel_matches_one_rank_and_jax(world2):
    from audio_inpainting_tpu.ops import torch_stft_config as jcfg
    from audio_inpainting_tpu.parallel import make_mesh_2d as jmesh2d
    from audio_inpainting_tpu.parallel import stft_frame_parallel as jstft

    (re, im), (re1, im1) = world2["stft"], world2["stft_1"]
    assert torch.equal(re, re1) and torch.equal(im, im1)
    z = stft(torch.tensor(_signal()), torch_stft_config(1024, 256)).T
    assert _rel(re, z.real) <= STFT_RTOL_OF_PEAK and _rel(im, z.imag) <= STFT_RTOL_OF_PEAK
    jre, jim = jstft(_signal(), jcfg(1024, 256), jmesh2d(1, 2))
    assert re.shape == np.asarray(jre).shape
    assert _rel(re, jre) <= STFT_RTOL_OF_PEAK and _rel(im, jim) <= STFT_RTOL_OF_PEAK


def test_ranks_ar_windows_match_one_rank_and_jax(world2):
    """Mode 6 with JAX's texture draws injected through ``eps``: three
    windows over two ranks (padded to four), against one rank and
    against JAX's ar_restore_windows_dp on make_mesh(2)."""
    from audio_inpainting_tpu.methods.ar import ARConfig as JARConfig
    from audio_inpainting_tpu.parallel import make_mesh
    from audio_inpainting_tpu.parallel.engines import ar_restore_windows_dp as jdp

    got, got1 = world2["ar_jax"], world2["ar_jax_1"]
    torch.testing.assert_close(got, got1, atol=RANKS_ATOL, rtol=0)
    wins, gaps = _windows()
    want = np.asarray(jdp(wins, gaps, JARConfig(**AR_CFG), make_mesh(2), key=3))
    assert got.shape == want.shape
    for w, ((s, e),) in enumerate(gaps):
        np.testing.assert_array_equal(got[w, :s].numpy(), wins[w, :s])
        assert _agreement_db(want[w, s:e], got[w, s:e].numpy()) >= AR_AGREEMENT_DB


def test_ranks_ar_texture_fill_does_not_depend_on_world_size(world2):
    """The port's own seeded texture draws: a fill at two ranks is the
    fill at one; the texture is there (it moves the fill off the
    JAX-draw fill)."""
    got, got1 = world2["ar_seeded"], world2["ar_seeded_1"]
    torch.testing.assert_close(got, got1, atol=RANKS_ATOL, rtol=0)
    _, gaps = _windows()
    for w, ((s, e),) in enumerate(gaps):
        assert float((got[w, s:e] - world2["ar_jax"][w, s:e]).abs().max()) > 1e-3


def test_ranks_gp_restarts_match_one_rank_and_jax(world2):
    """Mode 7: three restarts over two ranks (padded with the initial
    values) give the one-rank winner and posterior, and a fill within
    3 dB of JAX's gp_fit_predict_mesh on make_mesh(2)."""
    import jax

    from audio_inpainting_tpu.methods.gp import GPConfig as JGPConfig
    from audio_inpainting_tpu.parallel import make_mesh
    from audio_inpainting_tpu.parallel.engines import gp_fit_predict_mesh as jgp

    (mu, sd, theta), (mu1, sd1, theta1) = world2["gp"], world2["gp_1"]
    torch.testing.assert_close(theta, theta1, rtol=THETA_RTOL, atol=0)
    torch.testing.assert_close(mu, mu1, atol=GP_ATOL, rtol=0)
    torch.testing.assert_close(sd, sd1, atol=GP_ATOL, rtol=0)
    x, mask, gs, ge, sr = _sine_gap()
    t = np.arange(len(x), dtype=np.float32) / sr
    jmu, _, _ = jgp(t[mask], x[mask], t[~mask], JGPConfig(**GP_CFG), make_mesh(2),
                    key=jax.random.PRNGKey(0))
    got, want = x.copy(), x.copy()
    got[~mask], want[~mask] = mu.numpy(), np.asarray(jmu)
    snr = float(local_snr_db(x, got, gs, ge, "cpu"))
    assert snr >= float(local_snr_db(x, want, gs, ge, "cpu")) - GP_MARGIN_DB


def test_ranks_gp_one_rank_runs_the_ranks_batches(world2):
    """gp_fit_predict_mesh(batches=2) on one rank runs the two ranks'
    restart batches one after the other: the ranks' winner and posterior
    exactly."""
    for got, want in zip(world2["gp_batches"], world2["gp"]):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_ranks_restore_clips_unet_matches_one_rank_and_jax(world2):
    """Mode 2: one U-Net per clip, the clips over two ranks, each with its
    global clip's init, against one rank and JAX's mesh=make_mesh(2)."""
    import jax

    import audio_inpainting_tpu.methods.neural as jn
    from audio_inpainting_tpu.parallel import make_mesh
    from audio_inpainting_tpu.parallel.batch import restore_clips_unet as jbatch

    (out, loss), (out1, loss1) = world2["unet"], world2["unet_1"]
    assert _rel(out, world2["unet_same"]) <= RANKS_ATOL
    assert _rel(out, out1) <= UNET_RTOL_OF_PEAK and _rel(loss, loss1) <= LOSS_RTOL
    v, keep = _specs(seed=1)
    want, wloss = jbatch(v[..., None], keep[..., None], jn.UNetTrainConfig(epochs=3),
                         mesh=make_mesh(2), key=jax.random.split(jax.random.PRNGKey(4), G))
    for g in range(G):
        assert _rel(loss[g], np.asarray(wloss)[g]) <= LOSS_RTOL
        assert _rel(out[g], np.asarray(want)[g]) <= UNET_RTOL_OF_PEAK


def test_ranks_restore_clips_gan_matches_one_rank_and_jax(world2):
    """Mode 5: one GAN pair per clip over two ranks (EMA read out in the
    gap columns), against one rank and JAX's mesh=make_mesh(2); its
    discriminator the plain flax one (packed_d=False), as in
    tests/test_torch_batch.py."""
    import jax

    import audio_inpainting_tpu.methods.neural as jn
    from audio_inpainting_tpu.parallel import make_mesh
    from audio_inpainting_tpu.parallel import restore_clips_gan as jgan

    (out, (dl, gl)), (out1, (dl1, gl1)) = world2["gan"], world2["gan_1"]
    assert _rel(out, world2["gan_same"]) <= RANKS_ATOL
    assert _rel(out, out1) <= GAN_RTOL_OF_PEAK and _rel(dl, dl1) <= LOSS_RTOL
    inp, real, mask = _gan_case()
    want, (wdl, wgl) = jgan(inp, real, mask, jn.GANTrainConfig(
        epochs=2, ema_decay=0.9, ema_scope="gap", packed_d=False),
        mesh=make_mesh(2), key=jax.random.PRNGKey(7))
    for g in range(G):
        assert _rel(dl[g], np.asarray(wdl)[g]) <= LOSS_RTOL
        assert _rel(gl[g], np.asarray(wgl)[g]) <= LOSS_RTOL
        assert _rel(out[g], np.asarray(want)[g]) <= GAN_RTOL_OF_PEAK


@pytest.mark.parametrize("name", ["win_unet", "win_ar", "win_linear"])
def test_ranks_windowed_shares_the_windows(world2, name):
    """restore_windowed with ranks: the U-Net's window batch (three
    windows padded to four), the AR classes and the window-by-window
    facade calls split over two ranks give the one-rank restore, clean
    samples untouched."""
    got, got1 = world2[name], world2[name + "_1"]
    assert _rel(got, got1) <= RANKS_ATOL
    clip, _, gaps = _long_clip()
    hole = np.zeros(len(clip), bool)
    for s, e in gaps:
        hole[max(s - 50, 0):e + 50] = True
    np.testing.assert_array_equal(got[~hole], clip[~hole])


# ------------------------------------------ the 2 x 2 mesh against JAX ----


@pytest.fixture(scope="module")
def world4():
    import jax

    from audio_inpainting_tpu.parallel.train import init_shared_unet

    params0, _ = init_shared_unet(jax.random.PRNGKey(5), F_, ST)
    return params0, launch(_world4_rank, 4, devices="cpu",
                           args=(flax_to_state_dict(params0),))


def test_ranks_predict_spatial_matches_one_rank_and_jax(world4):
    """T split over two tp ranks and B over two dp ranks (halo columns, no
    exchange): the forward against one rank and JAX's predict_spatial on
    make_mesh_2d(2, 2)."""
    from audio_inpainting_tpu.parallel import make_mesh_2d as jmesh2d
    from audio_inpainting_tpu.parallel import predict_spatial as jpredict

    params0, res = world4
    torch.testing.assert_close(res["fwd"], res["fwd_1"], atol=RANKS_ATOL, rtol=0)
    _, tgt, _ = _spatial_inputs()
    want = np.asarray(jpredict(params0, tgt, jmesh2d(2, 2)))
    np.testing.assert_allclose(res["fwd"].numpy(), want, atol=FORWARD_ATOL, rtol=0)


def test_ranks_fit_spatial_matches_one_rank_and_jax(world4):
    """Mode 3: two Adam steps on the 2 x 2 mesh against one rank and JAX's
    fit_shared_unet_spatial on make_mesh_2d(2, 2) from the same init."""
    from audio_inpainting_tpu.parallel import fit_shared_unet_spatial as jfit
    from audio_inpainting_tpu.parallel import make_mesh_2d as jmesh2d

    _, res = world4
    (state, loss), (state1, loss1) = res["fit"], res["fit_1"]
    assert abs(loss - loss1) <= RANKS_ATOL
    for k in state:
        torch.testing.assert_close(state[k], state1[k], atol=PARAM_RANKS_ATOL, rtol=0)
    inp, tgt, m = _spatial_inputs()
    jparams, jloss = jfit(inp, tgt, m, jmesh2d(2, 2), steps=2, key=5)
    assert _rel(loss, jloss) <= LOSS_RTOL
    want = flax_to_state_dict(jparams)
    for k in want:
        torch.testing.assert_close(state[k], want[k], atol=PARAM_JAX_ATOL, rtol=0)


# ---------------------------------------------------------------- serve ----


def test_ranks_serve_two_ranks_writes_the_bytes_of_one(tmp_path):
    """run_serve(devices=2) on the CPU: two gloo ranks, each restoring and
    writing its clip with ar; the WAVs byte-equal to devices=1's."""
    sr, din = 8000, tmp_path / "in"
    din.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        t = np.arange(sr // 2 + 512 * i)
        x = (0.6 * np.sin(2 * np.pi * (220 + 60 * i) * t / sr)
             + 0.05 * rng.randn(len(t))).astype(np.float32)
        x[1000:1400] = 0.0
        save_wav_int16(x / np.abs(x).max(), sr, str(din / f"clip{i}.wav"))
    one = run_serve(str(din), str(tmp_path / "one"), method="ar", device="cpu")
    two = run_serve(str(din), str(tmp_path / "two"), method="ar", devices=2, device="cpu")
    assert two["files"] == one["files"] and two["clips"] == 3
    for name in one["files"]:
        assert (tmp_path / "one" / name).read_bytes() == (tmp_path / "two" / name).read_bytes()
        assert load_mono_normalized(str(tmp_path / "two" / name))[0] == sr
