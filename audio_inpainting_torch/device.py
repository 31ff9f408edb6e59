"""Device selection shared by every entry point of the port.

The port runs on the GPU unless the caller asks for the CPU. A missing GPU
is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``cuda``.

    Raises RuntimeError when CUDA is asked for and no GPU is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def host_to_device(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor moved to ``device``; to a GPU through pinned memory
    (the caching host allocator reuses the blocks) and asynchronously, so
    the host goes on while the copy runs."""
    if device.type == "cuda":
        return a.pin_memory().to(device, non_blocking=True)
    return a.to(device)


def seeded_generator(*entropy: int) -> torch.Generator:
    """A CPU generator seeded from ``entropy`` mixed by numpy's
    SeedSequence, so distinct streams of one seed do not overlap."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def as_f32(x, device=None) -> torch.Tensor:
    """float32 tensor of ``x``.

    A tensor stays on its own device unless ``device`` is given; anything
    else goes to ``resolve_device(device)``.
    """
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        return x if device is None else x.to(resolve_device(device))
    # a copy: the caller's array is never aliased, and may be read-only
    return torch.tensor(np.asarray(x, np.float32), device=resolve_device(device))
