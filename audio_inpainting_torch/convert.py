"""Parameters carried across from the JAX package.

AR has no trained weights: its parameters are the per-row Ridge fit
(w, b, noise_std, valid) and the texture draws. These converters take the
JAX package's values as numpy arrays and return the port's tensors, so the
port's extrapolation and paste can run on exactly the JAX fit and noise.
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
