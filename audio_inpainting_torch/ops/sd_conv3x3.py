"""The SD UNet's 3x3, stride-1, pad-1 fp32 convolution with bias: the
hand-written CUDA kernel and its plain version.

    y = conv2d(x, weight, bias, stride=1, padding=1)      x (N, C, H, W), fp32

``sd_conv3x3`` runs ``csrc/sd_conv3x3.cu`` (built at first use, see
kernels/build.py) on a CUDA tensor it takes, as two launches: a split-K
implicit GEMM that writes each slice's partial sums to a workspace, and a
sum of the slices in one fixed order with the bias. It raises on what the
kernel does not take; it never falls back. ``sd_conv3x3_ref`` writes the
same arithmetic in plain torch (im2col, one product a slice, the slices
summed in the kernel's order, the bias last); only tests and
``chip_smoke.py`` use it. Which convolutions take the kernel is decided by
their module (models/sd/unet2d.py ``Conv3x3``). No TPU kernel is
replaced: the JAX package left its convolutions to XLA.

The same inputs give the same bits on every call on one card: the slices
depend on the shape and the card's SM count alone (``partition``), and
nothing is summed by atomics.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernels import build

# Launches of the CUDA kernels in this process: two a call. Callers reset
# it to 0 to count a run.
LAUNCHES = 0

BM = 128             # output pixels a block, as kBM in csrc/sd_conv3x3.cu
BN = 128             # output channels a block (kBN)
CK = 4               # input channels a stage (kCK)
PATCH_FLOATS = 1600  # the largest input patch a stage holds (kPatchFloats)
FILL_STAGES = 2      # a block's fill and drain, in stages, as `partition` counts them


def tile(n: int, h: int, w: int) -> tuple[int, int] | None:
    """(th, tw): the kernel's tile of 128 pixels, 128 / (th * tw) images of
    th rows by tw columns, for a batch of n images of h x w; None where
    the kernel cannot tile such a batch."""
    tw = min(w, 32)
    if tw < 8 or tw % 8 or w % tw:
        return None
    th = min(h, BM // tw)
    if BM % (th * tw) or h % th:
        return None
    img = BM // (th * tw)
    if n % img or CK * img * (th + 2) * (tw + 12) > PATCH_FLOATS:
        return None
    return th, tw


def partition(tiles: int, c: int, sms: int) -> tuple[int, int]:
    """(slices, channels a slice): of the ways to cut the c input channels
    into slices of a multiple of CK channels, the one whose busiest SM
    runs the fewest stages, the fewest slices among equals. A launch of
    ``tiles`` output tiles x slices blocks puts ceil(blocks / sms) blocks
    on the busiest SM (two run at once, each at about half the SM's
    rate), each of them its slice's stages and FILL_STAGES more."""
    best = None
    for want in range(1, c // CK + 1):
        per = -(-c // want)
        per = -(-per // CK) * CK
        slices = -(-c // per)
        cost = -(-tiles * slices // sms) * (per // CK + FILL_STAGES)
        if best is None or cost < best[0]:
            best = (cost, slices, per)
    return best[1], best[2]


def takes(n: int, c: int, h: int, w: int) -> bool:
    """Whether the kernel computes an (n, c, h, w) input: c a multiple of
    CK and the batch tiled by ``tile``."""
    return c > 0 and c % CK == 0 and tile(n, h, w) is not None


def sd_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """conv2d(x, weight, bias, padding=1) by the kernel: x a contiguous fp32
    (N, C, H, W) CUDA tensor the kernel takes (``takes``), weight a
    contiguous fp32 (K, C, 3, 3) and bias a contiguous fp32 (K,), on x's
    card. Raises on anything else."""
    global LAUNCHES
    _check(x, weight, bias)
    n, c, h, w = x.shape
    k = weight.shape[0]
    th, tw, slices, per = _plan(n, c, h, w, k, x.get_device())
    ws = torch.empty((slices, n, k, h, w), dtype=torch.float32, device=x.device)
    y = torch.empty((n, k, h, w), dtype=torch.float32, device=x.device)
    err = _library().sd_conv3x3_forward(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), ws.data_ptr(), y.data_ptr(), n, c, h, w, k, th, tw, slices, per,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"sd_conv3x3 launch failed: CUDA error {err}")
    LAUNCHES += 2
    return y


def sd_conv3x3_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   slices: int = 1, per: int | None = None) -> torch.Tensor:
    """The kernels' arithmetic in plain torch: the (C * 9, H * W) patches of
    each image (depth c * 9 + r * 3 + s, as the weight's rows), one
    product a slice of ``per`` input channels, the slices summed in order,
    then the bias."""
    n, c, h, w = x.shape
    k = weight.shape[0]
    per = c if per is None else per
    cols = F.unfold(x, 3, padding=1)
    rows = weight.reshape(k, c * 9)
    out = None
    for z in range(slices):
        d = slice(9 * z * per, 9 * min(c, (z + 1) * per))
        part = rows[:, d] @ cols[:, d]
        out = part if out is None else out + part
    return (out + bias[:, None]).view(n, k, h, w)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise unless the kernel takes x, weight and bias (``sd_conv3x3``)."""
    if not x.dtype == weight.dtype == bias.dtype == torch.float32:
        raise TypeError("x, weight and bias must be float32, got "
                        f"{x.dtype}, {weight.dtype}, {bias.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"x must be (N, C, H, W) and weight (K, C, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    k = weight.shape[0]
    if bias.shape != (k,):
        raise ValueError(f"bias must be ({k},), got {tuple(bias.shape)}")
    if not takes(*x.shape):
        raise ValueError(f"the kernel does not take an input of {tuple(x.shape)}: C a multiple "
                         f"of {CK}, and the batch tiled by 128-pixel tiles (ops.sd_conv3x3.tile)")
    if not all(t.is_cuda and t.get_device() == x.get_device() for t in (x, weight, bias)):
        raise ValueError("the kernel runs on cuda, with x, weight and bias on one card; got "
                         f"{x.device}, {weight.device}, {bias.device}")
    if not (x.is_contiguous() and weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("x, weight and bias must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


@functools.lru_cache(maxsize=256)
def _plan(n: int, c: int, h: int, w: int, k: int, index: int) -> tuple[int, int, int, int]:
    """(th, tw, slices, channels a slice) for this shape on card ``index``."""
    th, tw = tile(n, h, w)
    tiles = (n * h * w // BM) * -(-k // BN)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (th, tw, *partition(tiles, c, sms))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("sd_conv3x3")
    lib.sd_conv3x3_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p])
    lib.sd_conv3x3_forward.restype = ctypes.c_int
    return lib
