"""Roofline accounting on one NVIDIA H100: the FLOPs and bytes of a call,
counted from its shapes, and the least time the card could take for them.

This module only counts; ``tools/mfu.py`` times the hot ops on the card.
A count comes from shapes, never from a trace or an implementation, so
it stays the same whatever computes the op, and a share of peak can only
pass 100 % if the op really ran faster than the card allows.

- ``count_flops(fn, *args)`` runs ``fn`` under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts convolutions
  and matrix products by shape formulas, forward and backward: a
  convolution 2 N Co (Ci/G) kh kw H W, H W the grid the kernel slides
  over (the output of a convolution, the input of a transposed one), and
  its backward the grad-input and grad-weight that autograd asks for (so
  not the grad-input of a first layer whose input needs no gradient), each
  the forward's count (torch's own backward formula counts a grouped
  convolution's grad-weight G times over; this module replaces it). It
  does not count FFTs, elementwise ops, reductions, BatchNorm or the Adam
  update. It works on the meta device, so a full-size count costs no
  compute.
- Closed forms where the counter is blind: ``stft_flops`` (a real FFT at
  2.5 n log2 n per frame, the least work for the function whatever
  implements it; the JAX package's row ran a DFT matmul, which does more)
  and ``ar_flops`` (the AR recurrence, 2 B p steps).
- Bytes: each input read once and each output written once; parameters
  are inputs. A training step reads and writes its parameters, both Adam
  moments and its BatchNorm running statistics once
  (``train_step_bytes``).

One known difference from XLA's cost analysis, which the JAX package's
``tools/mfu.py`` read: XLA leaves out the taps of a SAME-padded
convolution that fall on the zero padding. On (1, 16, 32, 48) with a
3x3 16 -> 16 kernel it counts 6,834,176 FLOPs, 2 Ci Co (3H - 2)(3W - 2),
where the closed form and the torch counter give 7,077,888, 2 Ci Co 9 H W.
The closed form is kept: it is the work a dense implementation does.
Matrix products agree exactly (70,711,920 for (513, 40) @ (40, 1723)).
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM, dense rates (without
# sparsity), at the part's 700 W power limit: FLOP/s per precision, and
# HBM3 bytes/s. A card set to a lower power limit runs slower under load.
H100_PEAKS = {
    "bf16": 989e12,
    "fp16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,     # outside the tensor cores
    "hbm": 3.35e12,
}

# which unit's peak bounds each precision's operations
_WALLS = {"bf16": "tensor cores", "fp16": "tensor cores", "tf32": "tensor cores",
         "fp32": "fp32 cores"}

_PRECISIONS = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}


def _precision(dtype) -> str:
    """The H100_PEAKS key of ``dtype``: a torch dtype or one of the keys.
    float32 is "fp32", never "tf32": the package turns TF32 off at import
    (audio_inpainting_torch/__init__.py), so fp32 products and
    convolutions run outside the tensor cores."""
    if isinstance(dtype, str) and dtype in _WALLS:
        return dtype
    if dtype in _PRECISIONS:
        return _PRECISIONS[dtype]
    raise ValueError(f"no H100 peak for {dtype!r}")


def peak_for(dtype) -> float:
    """The H100's peak FLOP/s for operations in ``dtype``: 989e12 for bf16
    and fp16, 67e12 for fp32 (TF32's 495e12 only when asked by name)."""
    return H100_PEAKS[_precision(dtype)]


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape, **kwargs) -> int:
    """A convolution's backward: its grad-input and its grad-weight, where
    autograd asks for them, each the forward's FLOPs. torch's own formula
    counts the grad-weight of a grouped convolution G times over (it
    contracts over every input channel, not a group's)."""
    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed=transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def count_flops(fn, *args, **kwargs) -> dict[str, int]:
    """FLOPs of ``fn(*args, **kwargs)`` by aten op ("aten.convolution",
    "aten.convolution_backward", "aten.mm", ...), from the shapes the ops
    see. ``fn`` runs once."""
    custom = {torch.ops.aten.convolution_backward: _conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=custom) as mode:
        fn(*args, **kwargs)
    return {str(op): int(n) for op, n in mode.get_flop_counts()["Global"].items()}


def stft_flops(n_fft: int, frames: int) -> float:
    """A real FFT of ``n_fft`` points per frame at 2.5 n log2 n FLOPs (half
    the 5 n log2 n of a complex FFT); the window's product is not counted."""
    return frames * 2.5 * n_fft * math.log2(n_fft)


def ar_flops(B: int, p: int, steps: int) -> float:
    """The AR recurrence: one length-p dot product per row and step."""
    return 2.0 * B * p * steps


def ar_bytes(B: int, p: int, steps: int) -> float:
    """The AR recurrence's float32 inputs and output: eps in and the
    predictions out (B x steps each), the state and weights (B x p each),
    the bias, noise scale and gain (B each)."""
    return 4.0 * B * steps * 2 + 4.0 * B * (2 * p + 3)


def tensor_bytes(tensors) -> int:
    """The bytes of ``tensors``, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def train_step_bytes(data, params, buffers=()) -> int:
    """Bytes a training step must move: ``data`` (what the step reads
    besides its state, and its outputs) once; the parameters, both Adam
    moments (each of the parameters' size) and ``buffers`` (BatchNorm's
    running statistics) read and written once. Activations and gradients
    are the step's own intermediates and are not counted."""
    return tensor_bytes(data) + 2 * (3 * tensor_bytes(params) + tensor_bytes(buffers))


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time for ``flops`` operations in ``dtype`` that move
    ``nbytes``, in ms: the larger of the operations over the peak for the
    dtype and the bytes over HBM's rate; and which of the two it is
    ("operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_for(dtype), nbytes / H100_PEAKS["hbm"]
    return max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def roofline_row(op: str, ms: float, flops: float, nbytes: float, dtype) -> dict:
    """One row of the JAX package's ``tools/mfu.py`` table for an op that
    took ``ms``: achieved TFLOP/s and their share of the dtype's peak
    (``mfu_pct``), GB/s and their share of HBM's rate (``hbm_pct``), and
    ``bound``, the wall the op is nearer: "HBM", "tensor cores" or "fp32
    cores"."""
    peak = peak_for(dtype)
    tflops = flops / (ms / 1e3) / 1e12 if ms > 0 else 0.0
    gbs = nbytes / (ms / 1e3) / 1e9 if ms > 0 else 0.0
    mfu_pct = 100 * tflops * 1e12 / peak
    hbm_pct = 100 * gbs * 1e9 / H100_PEAKS["hbm"]
    return {"op": op, "ms": ms, "gflops": flops / 1e9, "mb": nbytes / 1e6,
            "tflops": tflops, "mfu_pct": mfu_pct, "gbs": gbs, "hbm_pct": hbm_pct,
            "bound": "HBM" if hbm_pct > mfu_pct else _WALLS[_precision(dtype)],
            "peak_tflops": peak / 1e12}
