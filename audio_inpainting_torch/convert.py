"""Parameters carried across from the JAX package.

AR has no trained weights: its parameters are the per-row Ridge fit
(w, b, noise_std, valid) and the texture draws. These converters take the
JAX package's values as numpy arrays and return the port's tensors, so the
port's extrapolation and paste can run on exactly the JAX fit and noise.

The spectrogram models' flax trees (``params`` and ``batch_stats`` of
SimpleUNet, GeneratorUNet, Discriminator, or their packed twins, which
share the tree, and the ``params`` of the diffusion DiffusionUNet) become
the port's ``state_dict``s by ``flax_to_state_dict``; the Stable
Diffusion UNet2DCondition's and AutoencoderKL's by ``sd_flax_to_state_dict``.
"""

from __future__ import annotations

import re

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


# Stable Diffusion. The JAX package names every flax module of
# models/sd/ after the diffusers key path, digits joined by underscores, so
# the key map is a string rule (a copy of the JAX loader's
# flax_to_torch_key): these module names keep their literal underscore ...
_SD_PROTECTED = ("linear_1", "linear_2", "group_norm", "time_emb_proj",
                 "proj_in", "proj_out", "conv_in", "conv_out", "conv_norm_out",
                 "conv_shortcut", "time_embedding", "transformer_blocks",
                 "down_blocks", "up_blocks", "mid_block", "quant_conv",
                 "post_quant_conv", "to_q", "to_k", "to_v", "to_out", "net_",
                 "attn1", "attn2", "norm1", "norm2", "norm3")
# ... and these containers follow a non-digit segment
_SD_LITERAL = {
    "mid_block_resnets": "mid_block.resnets",
    "mid_block_attentions": "mid_block.attentions",
    "net_0": "net.0",
    "net_2": "net.2",
    "to_out_0": "to_out.0",
}
_SD_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "embedding": "weight"}


def flax_to_torch_key(path: tuple[str, ...]) -> str:
    """('down_blocks_0_resnets_0', 'conv1', 'kernel') ->
    'down_blocks.0.resnets.0.conv1.weight'."""
    *mods, leaf = path
    segs = []
    for m in mods:
        if m in _SD_LITERAL:
            m = _SD_LITERAL[m]
        else:
            if m not in _SD_PROTECTED:
                m = re.sub(r"_(?=\d)", ".", m)
                m = re.sub(r"(?<=\d)_", ".", m)
            for lit, rep in _SD_LITERAL.items():
                if lit in m:
                    m = m.replace(lit, rep)
        segs.append(m)
    return ".".join(segs + [_SD_LEAVES[leaf]])


def sd_flax_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX package's UNet2DCondition or AutoencoderKL params (a flax
    tree of arrays) as the port's CPU ``state_dict``: keys by
    ``flax_to_torch_key``, conv kernels (kh, kw, I, O) as (O, I, kh, kw),
    dense kernels (I, O) as (O, I), each norm's scale as its weight."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            a = torch.tensor(np.asarray(val, np.float32))
            if key == "kernel":
                a = a.permute(3, 2, 0, 1) if a.ndim == 4 else a.T
            out[flax_to_torch_key(path + (key,))] = a.contiguous()

    walk(params, ())
    return out
