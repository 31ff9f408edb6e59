"""Model parameters on disk: a directory with ``params.npz`` and
``MANIFEST.json``.

The port's counterpart of audio_inpainting_tpu/utils/checkpoint.py, in
numpy and torch only: no Orbax, no pickle. ``params.npz`` holds one array
per ``state_dict`` entry, under the port's names; ``MANIFEST.json`` beside
it describes where the parameters came from.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..device import resolve_device

PARAMS_FILE = "params.npz"
MANIFEST_FILE = "MANIFEST.json"


def save_params(state_dict: dict[str, torch.Tensor], path: str,
                manifest: dict | None = None) -> str:
    """Write ``state_dict`` to ``path/params.npz`` and ``manifest`` (plus
    the tensor and parameter counts) to ``path/MANIFEST.json``; returns the
    absolute path."""
    os.makedirs(path, exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    np.savez(os.path.join(path, PARAMS_FILE), **arrays)
    meta = {**(manifest or {}),
            "params": {"file": PARAMS_FILE, "tensors": len(arrays),
                       "parameters": int(sum(a.size for a in arrays.values()))}}
    with open(os.path.join(path, MANIFEST_FILE), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return os.path.abspath(path)


def load_params(path: str, device=None) -> dict[str, torch.Tensor]:
    """The ``state_dict`` saved by ``save_params`` at ``path``, on
    ``device`` (cuda by default). FileNotFoundError where ``path`` holds no
    ``params.npz``."""
    dev = resolve_device(device)
    with np.load(os.path.join(path, PARAMS_FILE), allow_pickle=False) as z:
        return {k: torch.tensor(z[k], device=dev) for k in z.files}


def latest_checkpoint(directory: str, prefix: str = "step_") -> str | None:
    """The highest-numbered ``<prefix>N`` entry of ``directory``, joined to
    it, or None where there is none (or no directory)."""
    if not os.path.isdir(directory):
        return None
    best, best_n = None, -1
    for name in os.listdir(directory):
        m = re.fullmatch(re.escape(prefix) + r"(\d+)", name)
        if m and int(m.group(1)) > best_n:
            best, best_n = os.path.join(directory, name), int(m.group(1))
    return best
