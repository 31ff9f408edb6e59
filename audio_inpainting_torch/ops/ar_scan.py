"""The AR recurrence: the hand-written CUDA kernel and its plain version.

    pred_t = ((<state_t, w> + b) + noise_std * eps_t) * gain
    state_{t+1} = state_t shifted left one sample, pred_t appended

``ar_extrapolate`` mirrors ``ar_extrapolate_pallas`` of the JAX package
(audio_inpainting_tpu/ops/pallas/ar_scan.py). On a CUDA tensor it launches
``csrc/ar_scan.cu`` (built at first use, see kernels/build.py) or raises;
on a CPU tensor it runs ``ar_extrapolate_ref``, the plain torch loop. The
kernel takes any order whose ring buffer fits in shared memory
(``MAX_ORDER``); the JAX package's order <= 128 limit was the TPU's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

# Launches of the CUDA kernel in this process. Only ar_extrapolate adds to
# it, once per kernel launch; callers reset it to 0 to count a run.
LAUNCHES = 0

# One warp's ring buffer and w, 8 bytes per tap, within the 227 KB of
# shared memory one block may take on sm_90.
MAX_ORDER = 232448 // 8


def ar_extrapolate_ref(state0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       noise_std: torch.Tensor, gain: torch.Tensor,
                       eps: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain torch loop over the steps: the recurrence as the JAX package's
    ``_extrapolate_scan`` writes it. Returns (B, steps)."""
    state = state0
    preds = []
    for t in range(steps):
        pred = (state * w).sum(1) + b
        pred = (pred + noise_std * eps[:, t]) * gain
        state = torch.cat([state[:, 1:], pred[:, None]], dim=1)
        preds.append(pred)
    return torch.stack(preds, dim=1)


def _check(state0, w, b, noise_std, gain, eps, steps):
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if w.ndim != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"w must be (B, order) with B, order >= 1, got {tuple(w.shape)}")
    B, p = w.shape
    shapes = {"state0": (state0, (B, p)), "b": (b, (B,)),
              "noise_std": (noise_std, (B,)), "gain": (gain, (B,)),
              "eps": (eps, (B, steps))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in {"w": w, **{k: v[0] for k, v in shapes.items()}}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")


def ar_extrapolate(state0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   noise_std: torch.Tensor, gain: torch.Tensor,
                   eps: torch.Tensor, steps: int) -> torch.Tensor:
    """Run the AR recurrence for ``steps`` outputs.

    state0: (B, order) initial state (the reference's second-to-last
    training window, extracted by the caller). w: (B, order); b,
    noise_std, gain: (B,); eps: (B, steps); all float32 on one device.
    Returns (B, steps) float32 predictions.
    """
    global LAUNCHES
    _check(state0, w, b, noise_std, gain, eps, steps)
    if w.device.type == "cpu":
        return ar_extrapolate_ref(state0, w, b, noise_std, gain, eps, steps)
    if w.device.type != "cuda":
        raise ValueError(f"ar_extrapolate runs on cpu or cuda, not {w.device}")
    B, p = w.shape
    if p > MAX_ORDER:
        raise ValueError(f"order {p} exceeds the kernel's shared-memory limit "
                         f"of {MAX_ORDER}")
    args = [state0, w, b, noise_std, gain, eps]
    for i, t in enumerate(args):
        if not t.is_contiguous():
            raise ValueError(f"argument {i} of ar_extrapolate is not contiguous")
    lib = _library()
    out = torch.empty((B, steps), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.ar_scan_launch(*(t.data_ptr() for t in args), out.data_ptr(),
                             B, p, steps, stream)
    if err != 0:
        raise RuntimeError(f"ar_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("ar_scan")
    fn = lib.ar_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
