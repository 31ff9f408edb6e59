"""FLOPs, bytes and roofline bounds of one training epoch, from shapes.

A frozen copy of the counting in ``audio_inpainting_torch/tools/roofline.py``
(its closed forms, its corrected grouped-conv backward and its table of
H100 peaks), applied to the layers of ``arch.py``. A count comes from the
configuration's widths and the clip's padded (F, T), never from a trace,
so it stays the same whatever computes the epoch:

- a conv: 2 Co Ci k^2 H W FLOPs per clip, H x W the grid the kernel slides
  over (a transposed conv's input grid); its backward the grad-input and
  the grad-weight that autograd asks for, each the forward's FLOPs (not G
  times the grad-weight for a grouped conv, as torch's own formula has it);
- FFTs, elementwise work, BatchNorm, the losses and Adam are not counted,
  so a share of peak is a floor;
- bytes: each input of a conv call read once and each output written once,
  in the dtype the conv computes in.

A G-clip grouped net does G times one clip's work, so every count here is
per clip.
"""

from __future__ import annotations

from dataclasses import dataclass

from .arch import Call, calls, convs, padded

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the part's
# 700 W power limit: FLOP/s per precision and HBM3 bytes/s. Float32 is
# the rate outside the tensor cores: the port turns TF32 off.
H100_PEAKS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "hbm": 3.35e12}
_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Pass:
    """One trip through a net in an epoch: its forward, and the backward
    that the epoch takes through it (grad-weights where ``weights``;
    grad-inputs everywhere but the first conv unless ``first_input``)."""

    net: str
    backward: bool = True
    weights: bool = True
    first_input: bool = False


# The passes of one epoch by driver kind. U-Net: one forward, one backward.
# GAN (methods/neural.py's epoch order): G's forward; D on the real and on
# the detached composite, back through both for D's step; D on the live
# composite, back through it to G (grad-inputs only, the first conv's too)
# and through G for G's step.
EPOCH_PASSES = {
    "unet": [Pass("unet")],
    "gan": [Pass("g"), Pass("d"), Pass("d"), Pass("d", weights=False, first_input=True)],
}


def conv_flops(call: Call) -> int:
    """2 Co Ci k^2 over the grid the kernel slides on."""
    c = call.conv
    grid = call.h_in * call.w_in if c.transposed else call.h_out * call.w_out
    return 2 * c.cout * c.cin * c.k * c.k * grid


def _dtype(call: Call, config: dict) -> str:
    return "float32" if call.conv.head else config["conv_dtype"]


def _bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / H100_PEAKS[dtype], nbytes / H100_PEAKS["hbm"])


def _conv_costs(call: Call, config: dict, p: Pass, first: bool) -> list[tuple[int, int, str]]:
    """(FLOPs, bytes, dtype) of the forward call and of its backward call."""
    c = call.conv
    dt = _dtype(call, config)
    b = _BYTES[dt]
    x = c.cin * call.h_in * call.w_in * b
    y = c.cout * call.h_out * call.w_out * b
    w = (c.cin * c.cout * c.k * c.k + c.cout) * b
    fwd = conv_flops(call)
    out = [(fwd, x + w + y, dt)]
    if p.backward:
        grad_in = p.first_input or not first
        grad_w = p.weights
        n = int(grad_in) + int(grad_w)
        if n:
            # reads the output's gradient, the weight for a grad-input and the
            # input for a grad-weight; writes the grads it makes
            out.append((n * fwd, y + (w + x) * grad_in + (x + w) * grad_w, dt))
    return out


def epoch_costs(config: dict, f: int, t: int) -> list[tuple[int, int, str]]:
    """(FLOPs, bytes, dtype) of every conv call, forward and backward, of
    one clip's training epoch at the clip's (f, t), padded as the nets pad
    it."""
    fp, tp = padded(f, t)
    nets = {name: calls(convs(net, ""), fp, tp) for name, net in config["nets"].items()}
    out = []
    for p in EPOCH_PASSES[config["driver"]]:
        for i, call in enumerate(nets[p.net]):
            out += _conv_costs(call, config, p, i == 0)
    return out


def epoch_flops(config: dict, f: int, t: int) -> int:
    """The convolution FLOPs of one clip's training epoch."""
    return sum(fl for fl, _, _ in epoch_costs(config, f, t))


def epoch_conv_bound_s(config: dict, f: int, t: int) -> float:
    """The sum over one clip-epoch's conv calls of each call's roofline
    bound: the larger of its FLOPs over the peak of its dtype and its bytes
    over HBM's rate."""
    return sum(_bound_s(fl, nb, dt) for fl, nb, dt in epoch_costs(config, f, t))


def peak_flops(config: dict) -> float:
    """The peak FLOP/s of the configuration's conv dtype."""
    return H100_PEAKS[config["conv_dtype"]]
