"""Parameters carried across from the JAX package.

AR has no trained weights: its parameters are the per-row Ridge fit
(w, b, noise_std, valid) and the texture draws. These converters take the
JAX package's values as numpy arrays and return the port's tensors, so the
port's extrapolation and paste can run on exactly the JAX fit and noise.

The spectrogram models' flax trees (``params`` and ``batch_stats`` of
SimpleUNet, GeneratorUNet, Discriminator, or their packed twins, which
share the tree, and the ``params`` of the diffusion DiffusionUNet) become
the port's ``state_dict``s by ``flax_to_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def ar_fit_from_numpy(w, b, noise_std, valid, device=None):
    """(w (B, order), b (B,), noise_std (B,), valid (B,)) as the port's fit
    tuple: three float32 tensors and a bool tensor on ``device``."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return (f32(w), f32(b), f32(noise_std),
            torch.tensor(np.asarray(valid, bool), device=dev))


def eps_from_numpy(arrays, device=None) -> list[torch.Tensor]:
    """Per-pass texture draws, each (max_len, B), as float32 tensors."""
    dev = resolve_device(device)
    return [torch.tensor(np.asarray(a, np.float32), device=dev)
            for a in arrays]


# flax module kind -> the port's submodule name stem (models/unet.py,
# models/diffusion_unet.py)
_MODULES = {"ConvBlock": "block", "BNLeakyConvBlock": "block",
            "ConvTranspose": "up", "Conv": "conv", "Conv3x3": "conv",
            "BatchNorm": "bn", "ResBlock": "res", "_FastConv3x3": "fconv",
            "Dense": "dense", "GroupNorm": "gn"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(params, batch_stats=None) -> dict[str, torch.Tensor]:
    """A flax model tree (nested dicts of arrays) as the port's CPU
    ``state_dict``, for SimpleUNet, GeneratorUNet, Discriminator or
    DiffusionUNet.

    Names: ``BNLeakyConvBlock_3/BatchNorm_1/var`` becomes
    ``block3.bn1.running_var``, ``ResBlock_4/_FastConv3x3_1/kernel``
    ``res4.fconv1.weight``. Layouts: a conv kernel (kh, kw, Ci, Co)
    becomes OIHW; a ConvTranspose kernel becomes (Ci, Co, kh, kw) flipped
    in both spatial axes, since flax's ConvTranspose does not flip its
    kernel and torch's conv_transpose2d does; a Dense kernel (in, out)
    becomes nn.Linear's (out, in). GroupNorm's scale is its weight.
    """
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                kind, idx = key.rsplit("_", 1)
                walk(val, path + [_MODULES[kind] + idx])
                continue
            a = torch.tensor(np.asarray(val, np.float32))
            if key == "kernel" and a.ndim == 2:
                a = a.T
            elif key == "kernel":
                a = (a.permute(2, 3, 0, 1).flip(2, 3) if path[-1].startswith("up")
                     else a.permute(3, 2, 0, 1))
            out[".".join(path + [_LEAVES[key]])] = a.contiguous()

    walk(params, [])
    walk(batch_stats or {}, [])
    return out
