"""Data-parallel training of one shared inpainting U-Net over ranks.

The port of audio_inpainting_tpu/parallel/train.py: ONE SimpleUNet (fp32,
Adam lr 1e-3) trained on a batch of corrupted spectrograms, the batch
split over the ``dp`` axis of the ranks (parallel/mesh.py). Every rank
holds the same parameters; each computes the gradient of its own cells'
share of the global loss, ``mean(((out - target) * (1 - mask))**2)`` over
the WHOLE batch (its squared errors summed, over the global cell count),
and one ``all_reduce`` sums the gradients. N ranks therefore take the
one-rank step, up to the order of the sums.
"""

from __future__ import annotations

import torch

from ..device import as_f32
from ..methods.neural import _adam
from ..models import SimpleUNet
from .mesh import Ranks, all_reduce_sum, shard_batch

LR = 1e-3


def init_shared_unet(ranks: Ranks, seed: int = 0, params=None):
    """(model, Adam) on the rank's device: SimpleUNet from a CPU generator
    seeded with ``seed`` (the same draw on every rank), or from
    ``params``, a state dict (e.g. the JAX package's init through
    ``convert.flax_to_state_dict``)."""
    model = SimpleUNet(generator=torch.Generator().manual_seed(seed))
    if params is not None:
        model.load_state_dict(params)
    model = model.to(ranks.device)
    return model, _adam(model, LR, (0.9, 0.999), ranks.device)


def shared_unet_train_step(model, opt, batch, target, mask, ranks: Ranks,
                           n_cells: int, cols: slice = slice(None)) -> torch.Tensor:
    """One Adam step on the rank's (B, 1, F, T) share; returns the global
    masked-MSE loss before the step.

    n_cells: the global batch's cell count (the mean's denominator).
    cols: the time columns of the rank's output that are its own (the
    spatial split's halo columns are not, parallel/spatial.py). The
    gradients and the loss ride one ``all_reduce`` over every rank.
    """
    opt.zero_grad()
    inv = 1.0 - mask[..., cols]
    sq = ((model(batch)[..., cols] * inv - target[..., cols] * inv) ** 2).sum()
    (sq / n_cells).backward()
    params = list(model.parameters())
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [sq.detach()[None] / n_cells])
    all_reduce_sum(flat, ranks)
    i = 0
    for p in params:
        p.grad.copy_(flat[i:i + p.numel()].view_as(p))
        i += p.numel()
    opt.step()
    return flat[-1]


def nchw(x, device) -> torch.Tensor:
    """(B, F, T, 1) -> (B, 1, F, T) float32 on ``device``; F and T must be
    multiples of 4 (the U-Net's two pools)."""
    x = as_f32(x, device)
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f"want a (B, F, T, 1) batch, got {tuple(x.shape)}")
    if x.shape[1] % 4 or x.shape[2] % 4:
        raise ValueError(f"F and T must be multiples of 4, got {tuple(x.shape[1:3])}")
    return x.permute(0, 3, 1, 2)


def fit_shared_unet(batch, target, mask, ranks: Ranks, steps: int = 100,
                    params=None, seed: int = 0):
    """Train the shared U-Net ``steps`` Adam steps over a dp-split batch.

    batch, target, mask: the whole (B, F, T, 1) batch on every rank (mask
    1 = kept); B must divide by the dp size. params: an initial state
    dict, else the seeded init. Returns (state dict on the CPU, the last
    step's global loss, None without steps), the same on every rank.
    """
    full = [nchw(a, ranks.device) for a in (batch, target, mask)]
    x, y, m = (shard_batch(a, ranks) for a in full)
    model, opt = init_shared_unet(ranks, seed, params)
    n_cells = full[0].numel()
    loss = None
    for _ in range(steps):
        loss = shared_unet_train_step(model, opt, x, y, m, ranks, n_cells)
    return ({k: v.detach().cpu() for k, v in model.state_dict().items()},
            None if loss is None else float(loss))
