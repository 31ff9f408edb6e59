"""The multi-device dry run: every parallel mode at N ranks against one.

The port's counterpart of ``_dryrun_body`` in the repository's
``__graft_entry__.py``: modes 1, 2, 3, 5, 6 and 7 at its small shapes,
each held against the one-rank run by its bars (loss within 1e-5 for
modes 1 and 3, outputs within 1e-5 for 2, 5 and 6, the GP posterior
within 5e-5). Mode 4, the lane-packed U-Net, is TPU layout: it shares
SimpleUNet's parameters, so modes 1 and 3 cover it.

Modes 2, 5 and 6 train or fit a batch per rank. Within a rank each clip
or window is what it is alone, but a batch's sums run in an order that
depends on its size (the grouped convs of a G-clip net, the batched
Ridge fit), and training carries rounding on. So those modes are held to
1e-5 against one rank running each rank's batch (the same batches,
where the math is the same), and against the one-rank run of the whole
batch by twice the bounds that each batch has against single clips (both
sides are batches): composites within 2e-4 (U-Net) and 2e-3 (GAN) of
their peak, AR windows within 2e-3 of peak. The ranks run cuDNN's
deterministic algorithms (the package's setting), so a GPU run repeats
itself.

    from audio_inpainting_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2, "cpu")                 # two gloo ranks on the CPU
    dryrun_multichip(2, "cuda:0", "gloo")      # two ranks sharing one card
"""

from __future__ import annotations

import numpy as np
import torch

from ..methods.ar import ARConfig, ar_restore_gaps_windows
from ..methods.gp import GPConfig, gp_fit_predict
from ..methods.neural import GANTrainConfig, UNetTrainConfig
from ..ops import stft, torch_stft_config
from .batch import clip_seeds, restore_clips_unet
from .engines import ar_restore_windows_dp, gp_fit_predict_mesh
from .gan_batch import restore_clips_gan
from .mesh import Ranks, launch, make_mesh, make_mesh_2d, shard_range, split_rows
from .spatial import fit_shared_unet_spatial, stft_frame_parallel
from .train import fit_shared_unet

LOSS_ATOL = 1e-5
OUT_ATOL = 1e-5
GP_ATOL = 5e-5
UNET_BATCH_RTOL_OF_PEAK = 2e-4
GAN_BATCH_RTOL_OF_PEAK = 2e-3
AR_BATCH_RTOL_OF_PEAK = 2e-3
STFT_RTOL_OF_PEAK = 1e-4


def _err(a, b) -> float:
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def _rel(a, b) -> float:
    return _err(a, b) / float(torch.as_tensor(b).abs().max())


def _per_rank(fn, n: int, ranks: Ranks, *arrays):
    """``fn(*slices, seeds)`` on one rank, once for every rank's slice of
    ``arrays`` (the seeds of the whole batch), the results concatenated:
    one rank running the ranks' batches."""
    seeds = clip_seeds(0, n)
    parts = []
    for r in range(ranks.world):
        sl = shard_range(n, Ranks(r, ranks.world, ranks.device))
        parts.append(fn(*(a[sl] for a in arrays), seeds[sl]))
    return torch.cat(parts)


def _dryrun_rank(ranks: Ranks) -> dict:
    """Every mode at ``ranks``; rank 0 also runs the one-rank references
    and returns the differences."""
    n, dev = ranks.world, ranks.device
    solo = Ranks.solo(dev)
    lead = ranks.rank == 0
    rng = np.random.RandomState(0)
    b, f, t = n, 16, 32
    res = {"ranks": n, "device": str(dev), "backend": ranks.backend}

    # mode 1: the shared U-Net over dp
    x, y = (rng.rand(b, f, t, 1).astype(np.float32) for _ in range(2))
    m = (rng.rand(b, f, t, 1) > 0.3).astype(np.float32)
    _, loss = fit_shared_unet(x, y, m, make_mesh(ranks), steps=2)
    if lead:
        res["dp_loss"] = loss
        res["dp_dloss"] = abs(loss - fit_shared_unet(x, y, m, solo, steps=2)[1])

    # mode 2: one U-Net per clip, the clips over dp
    mag = rng.rand(b, f, t, 1).astype(np.float32)
    msk = (rng.rand(b, f, t, 1) > 0.3).astype(np.float32)
    ucfg = UNetTrainConfig(epochs=2)
    out, _ = restore_clips_unet(mag, msk, ucfg, ranks=ranks)
    if lead:
        same = _per_rank(lambda a, c, s: restore_clips_unet(a, c, ucfg, s, device=dev)[0],
                         b, ranks, mag, msk)
        res["unet_batch_same_batches_err"] = _err(out, same)
        res["unet_batch_vs_one_rank_rel"] = _rel(
            out, restore_clips_unet(mag, msk, ucfg, device=dev)[0])

    # mode 3: dp x tp, the time axis split, and the frame-parallel STFT
    if n % 2 == 0:
        mesh2 = make_mesh_2d(ranks, n // 2, 2)
        tg = rng.rand(n // 2, f, 64, 1).astype(np.float32)
        m2 = (rng.rand(*tg.shape) > 0.3).astype(np.float32)
        _, sp_loss = fit_shared_unet_spatial(tg * m2, tg, m2, mesh2, steps=2)
        sig = rng.randn(8192).astype(np.float32)
        re, im = stft_frame_parallel(sig, torch_stft_config(1024, 256), ranks)
        if lead:
            res["tp_loss"] = sp_loss
            res["tp_dloss"] = abs(sp_loss - fit_shared_unet_spatial(
                tg * m2, tg, m2, solo, steps=2)[1])
            z = stft(torch.as_tensor(sig, device=dev), torch_stft_config(1024, 256)).T
            res["stft_rel"] = max(_rel(re, z.real), _rel(im, z.imag))

    # mode 5: one GAN pair per clip, the clips over dp; a 48 x 64 clip is
    # above the PatchGAN's receptive floor, so the adversarial path runs
    gg, gf, gt = n, 48, 64
    real = (rng.rand(gg, gf, gt) * 2 - 1).astype(np.float32)
    gm = np.ones((gg, gf, gt), np.float32)
    gm[:, :, 24:40] = 0.0
    norm = real * gm - (1 - gm)
    gcfg = GANTrainConfig(epochs=2, ema_decay=0.99, ema_scope="gap")
    gout, _ = restore_clips_gan(norm, real, gm, gcfg, ranks=ranks)
    if lead:
        same = _per_rank(lambda a, r_, c, s: restore_clips_gan(a, r_, c, gcfg, s,
                                                               device=dev)[0],
                         gg, ranks, norm, real, gm)
        res["gan_batch_same_batches_err"] = _err(gout, same)
        res["gan_batch_vs_one_rank_rel"] = _rel(
            gout, restore_clips_gan(norm, real, gm, gcfg, device=dev)[0])

    # mode 6: AR windows over ranks, texture on
    acfg = ARConfig(order=8, context_len=64, texture=True, passes=2)
    wlen = 2048
    tt = np.arange(wlen, dtype=np.float32)
    wins = np.stack([0.5 * np.sin(2 * np.pi * (3 + i) * tt / wlen)
                     for i in range(n)]).astype(np.float32)
    gaps = []
    for i in range(n):
        s = 600 + 37 * i
        wins[i, s:s + 120] = 0.0
        gaps.append([(s, s + 120)])
    aout = ar_restore_windows_dp(wins, gaps, acfg, ranks, 3)
    if lead:
        same = torch.cat([ar_restore_gaps_windows(wins[r], [gaps[i] for i in r], acfg, 3,
                                                  device=dev)
                          for r in split_rows(n, ranks.world)])[:n]
        res["ar_windows_same_batches_err"] = _err(aout, same)
        res["ar_windows_vs_one_rank_rel"] = _rel(
            aout, ar_restore_gaps_windows(wins, gaps, acfg, 3, device=dev))
        res["ar_windows_filled"] = all(float(aout[i, s:s + 120].abs().max()) > 1e-4
                                       for i, ((s, _),) in enumerate(gaps))

    # mode 7: GP restarts over ranks
    pcfg = GPConfig(n_restarts=7, opt_steps=4, fit_subsample=1)
    xg = np.linspace(0.0, 0.02, 200).astype(np.float32)
    yg = (np.sin(2 * np.pi * 400 * xg) + 0.05 * rng.randn(200)).astype(np.float32)
    keep = np.ones(200, bool)
    keep[80:120] = False
    mu, sd, _ = gp_fit_predict_mesh(xg[keep], yg[keep], xg[~keep], pcfg, ranks, 1)
    if lead:
        mu1, sd1, _ = gp_fit_predict(xg[keep], yg[keep], xg[~keep], pcfg, 1, dev)
        res["gp_err"] = max(_err(mu, mu1), _err(sd, sd1))
    return res


def check(res: dict) -> dict:
    """Raise AssertionError unless every mode of a ``_dryrun_rank`` result
    meets its bar; return the result."""
    bars = [("dp_dloss", LOSS_ATOL), ("tp_dloss", LOSS_ATOL),
            ("unet_batch_same_batches_err", OUT_ATOL),
            ("gan_batch_same_batches_err", OUT_ATOL),
            ("ar_windows_same_batches_err", OUT_ATOL),
            ("unet_batch_vs_one_rank_rel", UNET_BATCH_RTOL_OF_PEAK),
            ("gan_batch_vs_one_rank_rel", GAN_BATCH_RTOL_OF_PEAK),
            ("ar_windows_vs_one_rank_rel", AR_BATCH_RTOL_OF_PEAK),
            ("stft_rel", STFT_RTOL_OF_PEAK), ("gp_err", GP_ATOL)]
    bad = {k: (res[k], bar) for k, bar in bars if k in res and not res[k] <= bar}
    if bad or not res["ar_windows_filled"]:
        raise AssertionError(f"dry run at {res['ranks']} ranks: {bad or res}")
    return res


def dryrun_multichip(n: int = 2, device="cpu", backend: str | None = None) -> dict:
    """Every mode at ``n`` ranks on ``device`` (one device for every rank,
    e.g. "cpu" or "cuda:0", or one per rank) against one rank; returns the
    differences, raising where a bar is missed. Ranks that share a card
    take ``backend="gloo"``."""
    return check(launch(_dryrun_rank, n, devices=device, backend=backend))

