"""The AR recurrence: the hand-written CUDA kernel and its plain versions.

    pred_t = ((<state_t, w> + b) + noise_std * eps_t) * gain
    state_{t+1} = state_t shifted left one sample, pred_t appended

``ar_extrapolate`` mirrors ``ar_extrapolate_pallas`` of the JAX package
(audio_inpainting_tpu/ops/pallas/ar_scan.py). On a CUDA tensor it launches
``csrc/ar_scan.cu`` (built at first use, see kernels/build.py) or raises;
on a CPU tensor it runs ``ar_extrapolate_ref``, the plain torch loop that
defines the function. The kernel is a blocked scan: it advances each row
one block of outputs per dependent update, by the algebra that
``ar_extrapolate_blocked_ref`` writes in plain torch. It takes orders up
to ``MAX_ORDER`` = 224, where its per-row state-response matrix still
fits in shared memory, and raises above; the JAX package's order <= 128
limit was the TPU's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build

# Launches of the CUDA kernel in this process. Only ar_extrapolate adds to
# it, once per kernel launch; callers reset it to 0 to count a run.
LAUNCHES = 0

# The kernel keeps a (p, 32 * ceil(p / 32) + 1) float32 matrix per row in
# shared memory; at p = 224 that and its buffers take 210 KB of the 227 KB
# one block may have on sm_90, at p = 225 they would take 244 KB.
MAX_ORDER = 224


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


def ar_extrapolate_blocked_ref(state0: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor, noise_std: torch.Tensor,
                               gain: torch.Tensor, eps: torch.Tensor,
                               steps: int, L: int) -> torch.Tensor:
    """The recurrence in blocks of ``L`` outputs, the algebra of the CUDA
    kernel in plain torch. Returns (B, steps); only tests use it.

    With w' = gain * w and u_t = gain * (b + noise_std * eps_t), the
    recurrence is y_t = <w', state_t> + u_t (the gained prediction is fed
    back, as in the Pallas kernel). A block's outputs are then

        y = G s + T(h) u

    for the block's entry state s (p samples, oldest first): h is the
    impulse response (h_0 = 1, h_n = sum_{i=1..min(n,p)} w'_{p-i} h_{n-i}),
    T(h) its lower-triangular Toeplitz matrix, and G = T(h) D with
    D[m, c] = w'_{c-m} for c >= m, the direct contribution of s_c to y_m.
    The next entry state is the last p samples of [s; y], so any L >= 1
    works here; the kernel uses L >= p.
    """
    B, p = w.shape
    wp = gain[:, None] * w
    u = gain[:, None] * (b[:, None] + noise_std[:, None] * eps[:, :steps])
    h = torch.zeros((B, L), dtype=w.dtype, device=w.device)
    h[:, 0] = 1.0
    for n in range(1, L):
        i = torch.arange(1, min(n, p) + 1, device=w.device)
        h[:, n] = (wp[:, p - i] * h[:, n - i]).sum(1)
    m = torch.arange(L, device=w.device)
    lag = m[:, None] - m[None, :]                                # j - m
    T = torch.where(lag >= 0, h[:, lag.clamp_min(0)], 0.0)       # (B, L, L)
    c = torch.arange(p, device=w.device)
    shift = c[None, :] - m[:, None]                              # c - m
    D = torch.where(shift >= 0, wp[:, shift.clamp(0, p - 1)], 0.0)  # (B, L, p)
    G = torch.bmm(T, D)                                          # (B, L, p)

    nblocks = -(-steps // L)
    u = torch.nn.functional.pad(u, (0, nblocks * L - steps))
    s = state0
    ys = []
    for k in range(nblocks):
        y = (torch.bmm(G, s[:, :, None]) + torch.bmm(T, u[:, k * L:(k + 1) * L, None]))[..., 0]
        s = torch.cat([s, y], dim=1)[:, -p:]
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :steps]


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
        raise ValueError(f"order {p} is above the kernel's limit of {MAX_ORDER}")
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
