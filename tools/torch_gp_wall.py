#!/usr/bin/env python3
"""The wall of the port's GP on one CUDA GPU: ``restore(method="gp")`` on
Part 0's segment (the smoke's ``facade_gp``), and ``gp_fit_predict_mesh``
over two gloo ranks sharing the card (the smoke's mode 7).

    python3 tools/torch_gp_wall.py [ROOT]     # ROOT: the checkout to import

ROOT (default: this file's checkout) lets one call time two trees, the
parent's and a change's, with the same script. Prints one JSON line:
the warm facade walls, their median, and each rank's mesh wall. It needs
a GPU; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parent.parent))

from audio_inpainting_torch import restore  # noqa: E402
from audio_inpainting_torch.corrupt import contiguous_gap_mask, synth_music_clip  # noqa: E402
from audio_inpainting_torch.methods.gp import GPConfig  # noqa: E402
from audio_inpainting_torch.parallel import gp_fit_predict_mesh, launch  # noqa: E402
from audio_inpainting_torch.parallel.mesh import gather_objects  # noqa: E402

SR = 44100
RUNS = 7


def segment():
    """Part 0's 0.05 s mid-clip segment of synth_music_clip(0) with its
    20 % gap zeroed: (clean segment, damaged, (gs, ge))."""
    clean = synth_music_clip(0, SR, 10.0)
    n = int(0.05 * SR)
    seg = clean[len(clean) // 2:len(clean) // 2 + n]
    _, (gs, ge) = contiguous_gap_mask(n, 0.2)
    damaged = seg.copy()
    damaged[gs:ge] = 0.0
    return seg, damaged, (gs, ge)


def mesh_rank(ranks) -> list[float]:
    """Each rank's wall of gp_fit_predict_mesh, cold then warm."""
    seg, _, (gs, ge) = segment()
    keep = np.ones(len(seg), bool)
    keep[gs:ge] = False
    t = np.arange(len(seg), dtype=np.float32) / SR
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp_fit_predict_mesh(t[keep], seg[keep], t[~keep], GPConfig(), ranks, 0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return gather_objects(walls, ranks)


def main() -> int:
    _, damaged, gap = segment()
    restore(damaged, SR, method="gp", gaps=[gap])            # cold
    walls = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(damaged, SR, method="gp", gaps=[gap])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    mesh = launch(mesh_rank, 2, devices="cuda:0", backend="gloo")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"root": sys.path[0], "gpu": gpu.strip(),
                      "facade_gp_wall_s": walls, "facade_gp_median_s": float(np.median(walls)),
                      "mesh_two_ranks_wall_s_by_rank": mesh}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
