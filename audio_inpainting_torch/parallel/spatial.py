"""The spectrogram's time axis split over ranks, and a frame-parallel STFT.

The port of audio_inpainting_tpu/parallel/spatial.py. Long material (a
60 s clip is 516 x ~10,340 frames) trains the shared U-Net
(parallel/train.py) with its batch split over ``dp`` AND its time axis
over ``tp`` (``make_mesh_2d``). XLA partitioned every conv there and
exchanged the halos layer by layer; here each ``tp`` rank takes its T
columns plus ``HALO`` columns of context on each side, once, since
SimpleUNet has no BatchNorm and so no statistic that spans the axis.
Every owned output column then sees what it sees in the whole
spectrogram; the net's zero padding applies at the clip's true edges
only, and the halo's own edges stay outside the owned columns' reach.
The loss counts the owned columns, and the one gradient ``all_reduce``
of train.py over every rank gives the unsplit step: no send or receive,
which gloo lacks for CUDA tensors.

``stft_frame_parallel`` frames the signal once; each rank transforms its
frames (``torch.fft.rfft`` of the windowed frames), and the spectra are
gathered.
"""

from __future__ import annotations

import torch

from ..device import as_f32
from ..ops.stft import (StftConfig, _check_pad_mode, _pad_reflect_repeated, _pad_zeros,
                        frame_signal, hann_window)
from .mesh import Ranks, gather, rank_rows, shard_batch
from .train import init_shared_unet, nchw, shared_unet_train_step

# SimpleUNet's reach: an output column moves with inputs up to 23
# columns away (two 3x3 convs at scales 1, 2, 4, 2 and 1, and the pools'
# offsets). Rounded up to a multiple of 4, so that a shard's first
# column keeps the two 2x2 pools aligned with the unsplit ones.
HALO = 24


def shard_spatial(x: torch.Tensor, ranks: Ranks, halo: int = HALO):
    """The rank's part of an NCHW (B, C, F, T) batch: its dp slice of B,
    and its tp slice of T with ``halo`` columns beyond each side that the
    clip has. Returns (part, owned), ``owned`` the slice of the part's
    columns that are the rank's own. T must divide by 4 * n_tp."""
    t = x.shape[-1]
    if t % (4 * ranks.n_tp):
        raise ValueError(f"T = {t} must divide by 4 x {ranks.n_tp} tp ranks")
    step = t // ranks.n_tp
    a, b = ranks.tp * step, (ranks.tp + 1) * step
    lo, hi = max(a - halo, 0), min(b + halo, t)
    return shard_batch(x, ranks)[..., lo:hi], slice(a - lo, b - lo)


def fit_shared_unet_spatial(batch, target, mask, ranks: Ranks, steps: int = 100,
                            params=None, seed: int = 0):
    """``fit_shared_unet`` with T split over ``tp`` as well as B over
    ``dp`` (``make_mesh_2d``). Same arguments and result; T must divide
    by 4 * n_tp."""
    full = [nchw(a, ranks.device) for a in (batch, target, mask)]
    (x, owned), (y, _), (m, _) = (shard_spatial(a, ranks) for a in full)
    model, opt = init_shared_unet(ranks, seed, params)
    n_cells = full[0].numel()
    loss = None
    for _ in range(steps):
        loss = shared_unet_train_step(model, opt, x, y, m, ranks, n_cells, owned)
    return ({k: v.detach().cpu() for k, v in model.state_dict().items()},
            None if loss is None else float(loss))


@torch.no_grad()
def predict_spatial(params, batch, ranks: Ranks) -> torch.Tensor:
    """The shared U-Net's forward (``params`` a state dict) over a
    (B, F, T, 1) batch split over dp and tp; the whole (B, F, T, 1)
    output on every rank, on its device."""
    x, owned = shard_spatial(nchw(batch, ranks.device), ranks)
    model, _ = init_shared_unet(ranks, params=params)
    out = model(x)[..., owned]
    out = gather(gather(out, ranks, "tp", dim=-1), ranks, "dp")
    return out.permute(0, 2, 3, 1)


def stft_frame_parallel(x, cfg: StftConfig, ranks: Ranks):
    """The STFT of ``x`` with its frames split over every rank.

    Returns (re, im), each (frames, bins) on the rank's device: ``ops.stft``
    transposed. The frames are padded to a multiple of the world size with
    copies of the last, which are dropped."""
    _check_pad_mode(cfg)
    x = as_f32(x, ranks.device)
    xp = (_pad_reflect_repeated(x, cfg.n_fft // 2) if cfg.pad_mode == "reflect"
          else _pad_zeros(x, cfg))
    frames = frame_signal(xp, cfg.n_fft, cfg.hop)       # (n_frames, n_fft), a view
    n = frames.shape[0]
    mine = frames[torch.as_tensor(rank_rows(n, ranks), device=x.device)]
    z = torch.fft.rfft(mine * hann_window(cfg.n_fft, x.device), dim=-1) * cfg.scale
    z = gather(torch.view_as_real(z), ranks, None)[:n]
    return z[..., 0], z[..., 1]
