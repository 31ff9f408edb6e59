"""The seeded inputs of the SD kind (``drivers/riffusion.py``,
``reference/sd.py``), in place of the Riffusion checkpoint and CLIP's
encoding of the prompt, which are not in the repository.

- ``state``: weights for every key of a diffusers-layout state dict, by
  the rule of ``chip_smoke.py``'s ``seeded_sd_state``: matrices and
  kernels normal at 1/sqrt(fan-in), norm weights 1 + 0.05 x normal,
  biases 0.02 x normal.
- ``context``: the prompt's encoding [uncond; cond], (2, L, width),
  standard normal.

Each tensor is drawn on ``device`` from a generator of its own, seeded by
the run's weight seed, the part (``unet``, ``vae``) and the tensor's name,
so that a state made from the port's list of keys and one made from the
reference's agree whatever order each lists them in. A CUDA generator and
a CPU one give other numbers; the port and the reference of one run draw
on the same device.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

CONTEXT_STREAM = 0xC0


def _generator(device, *entropy: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def _crc(text: str) -> int:
    return zlib.crc32(text.encode())


def state(shapes: dict, seed: int, part: str, device) -> dict[str, torch.Tensor]:
    """float32 weights on ``device`` for ``shapes`` ({key: shape})."""
    device = torch.device(device)
    out = {}
    for key, shape in shapes.items():
        shape = tuple(shape)
        a = torch.randn(shape, generator=_generator(device, seed, _crc(part), _crc(key)),
                        device=device)
        if len(shape) >= 2:
            a /= float(np.sqrt(np.prod(shape[1:])))
        elif key.endswith("weight"):
            a = 1.0 + 0.05 * a
        else:
            a *= 0.02
        out[key] = a
    return out


def context(seed: int, length: int, width: int, device) -> torch.Tensor:
    """The prompt's encoding, (2, length, width) float32 on ``device``."""
    device = torch.device(device)
    return torch.randn((2, length, width), generator=_generator(device, seed, CONTEXT_STREAM),
                       device=device)
