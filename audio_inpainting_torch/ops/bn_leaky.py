"""Train-mode BatchNorm + LeakyReLU: the hand-written CUDA kernels and
their plain versions.

For each channel c, over the N * H * W elements of the batch, in fp32:

    mean, var = the batch's mean and *biased* variance
    z = weight[c] * (x - mean) / sqrt(var + eps) + bias[c]
    y = leaky_relu(z, slope)                        (fp32, any input dtype)
    running_mean, running_var moved towards mean, var by ``step``

``bn_leaky_train`` is the models' entry point. On a CUDA tensor it runs
``csrc/bn_leaky.cu`` (built at first use, see kernels/build.py) through
``BNLeakyFunction``, an autograd Function whose forward and backward are each two
kernel launches, or raises; elsewhere (the CPU, the meta device) it runs
the plain composition of torch ops that defines the function.
``bn_leaky_forward_ref`` and ``bn_leaky_backward_ref`` write the kernels'
arithmetic in plain torch; only tests use them. No TPU kernel is replaced:
the JAX package left BatchNorm to XLA.

The kernels split each (n, c) plane into chunks so that the launch covers
the card's SMs (``partition``), and sum in one fixed order: the same shape
gives the same bytes on every run.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..kernels import build

# Launches of the CUDA kernels in this process: two for each forward and
# two for each backward. Callers reset it to 0 to count a run.
LAUNCHES = 0

THREADS = 256          # threads a block, as kThreads in csrc/bn_leaky.cu
BLOCKS_PER_SM = 4      # blocks a launch aims at for each SM


def partition(hw: int, planes: int, vec: int, sms: int) -> tuple[int, int]:
    """(K, L): each of ``planes`` planes of ``hw`` elements in K chunks of
    L elements, L a multiple of ``vec``, so that planes * K blocks reach
    BLOCKS_PER_SM a SM where the planes are long enough, with no more
    chunks than a plane has passes of a block (THREADS * vec elements)."""
    want = -(-BLOCKS_PER_SM * sms // planes)
    k = max(1, min(want, -(-hw // (THREADS * vec))))
    L = -(-hw // k)
    L = -(-L // vec) * vec
    return -(-hw // L), L


def bn_leaky_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   momentum: float, eps: float, slope: float) -> torch.Tensor:
    """leaky_relu(batch_norm(x), slope) in train mode, fp32 out; moves the
    running averages in place by ``lerp(running, batch, 1 - momentum)``
    with the biased variance. x: (N, C, H, W) fp32 or bf16."""
    if x.is_cuda:
        return BNLeakyFunction.apply(x, weight, bias, running_mean, running_var,
                             1.0 - momentum, eps, slope)
    x = x.to(torch.float32)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        running_mean.lerp_(mean, 1.0 - momentum)
        running_var.lerp_(var, 1.0 - momentum)
    return F.leaky_relu(F.batch_norm(x, None, None, weight, bias, True, 0.0, eps), slope)


def bn_leaky_forward_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float, slope: float):
    """The forward kernels' arithmetic in plain torch, in x's precision
    (fp32 for bf16): (y, mean, rstd), the statistics (C,)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    rstd = 1.0 / torch.sqrt(var + eps)
    z = _affine(_normalize(x, mean, rstd), weight, bias)
    return torch.where(z > 0, z, z * slope), mean, rstd


def bn_leaky_backward_ref(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                          slope: float):
    """The backward kernels' arithmetic in plain torch: (dx in x's dtype,
    dweight, dbias) from the output gradient and what the forward saved."""
    xf = x.to(dy.dtype)
    xhat = _normalize(xf, mean, rstd)
    dz = torch.where(_affine(xhat, weight, bias) > 0, dy, dy * slope)
    dbias = dz.sum(dim=(0, 2, 3))
    dweight = (dz * xhat).sum(dim=(0, 2, 3))
    count = x.numel() // x.shape[1]
    dx = (_col(weight * rstd)
          * (dz - _col(dbias / count) - xhat * _col(dweight / count)))
    return dx.to(x.dtype), dweight, dbias


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _normalize(x, mean, rstd):
    return (x - _col(mean)) * _col(rstd)


def _affine(xhat, weight, bias):
    return xhat * _col(weight) + _col(bias)


class BNLeakyFunction(torch.autograd.Function):
    """``bn_leaky_train`` on CUDA tensors: the forward and backward kernels.
    Saves the input as it came (bf16 stays bf16) with mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, step, eps, slope):
        y, mean, rstd = bn_leaky_forward_cuda(x, weight, bias, running_mean,
                                              running_var, step, eps, slope)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dweight, dbias = bn_leaky_backward_cuda(dy.contiguous(), x, weight, bias,
                                                    mean, rstd, ctx.slope)
        return dx, dweight, dbias, None, None, None, None, None


_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, **channel: torch.Tensor):
    """Raise unless x is a contiguous fp32 or bf16 (N, C, H, W) CUDA tensor
    and each of ``channel`` a contiguous fp32 (C,) on x's device. The test
    that passes is one expression a tensor: this runs on every pass."""
    if not (x.is_cuda and x.dtype in _DTYPES and x.dim() == 4 and x.is_contiguous()):
        if x.dim() != 4:
            raise ValueError(f"x must be an (N, C, H, W) tensor, got {tuple(x.shape)}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
        if not x.is_cuda:
            raise ValueError(f"the kernels run on cuda, x is on {x.device}")
        raise ValueError("x must be contiguous (NCHW)")
    c, dev = x.shape[1], x.get_device()
    for name, t in channel.items():
        if not (t.is_cuda and t.get_device() == dev and t.dtype is torch.float32
                and t.dim() == 1 and t.shape[0] == c and t.is_contiguous()):
            if t.device != x.device:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            raise ValueError(f"{name} must be a contiguous ({c},), got {tuple(t.shape)}")


@functools.lru_cache(maxsize=256)
def _plan(shape: torch.Size, dtype: torch.dtype, index: int):
    """(N, C, H * W, K, L, vec) for an input of this shape and dtype on
    card ``index``: vec is 16 bytes in elements where H * W allows it."""
    n, c, h, w = shape
    hw = h * w
    if n * c * hw == 0:
        raise ValueError(f"x must be non-empty, got {tuple(shape)}")
    if n * c > 65535:
        raise ValueError(f"N * C = {n * c} is above the kernels' 65535 planes")
    vec = 16 // dtype.itemsize
    if hw % vec:
        vec = 1
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (n, c, hw, *partition(hw, n * c, vec, sms), vec)


def _launch_args(x: torch.Tensor, *beside: torch.Tensor):
    """The kernels' shape arguments for x: bf16 flag, vec, N, C, H * W, K,
    L; vec falls to 1 where an address is not 16-byte aligned."""
    n, c, hw, k, L, vec = _plan(x.shape, x.dtype, x.get_device())
    if vec > 1 and any(t.data_ptr() % 16 for t in (x, *beside)):
        vec = 1
    return int(x.dtype is torch.bfloat16), vec, n, c, hw, k, L


def bn_leaky_forward_cuda(x, weight, bias, running_mean, running_var,
                          step: float, eps: float, slope: float):
    """The forward kernels: (y fp32, mean, rstd); moves the running
    averages in place by ``step`` (1 - momentum)."""
    global LAUNCHES
    _check(x, weight=weight, bias=bias, running_mean=running_mean, running_var=running_var)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    args = _launch_args(x)
    n, c, k = args[2], args[3], args[5]
    stats = torch.empty(2 * c + n * c * k * 3, dtype=torch.float32, device=x.device)
    at = stats.data_ptr()
    err = _library().bn_leaky_forward(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), y.data_ptr(), at, at + 4 * c, at + 8 * c, *args,
        eps, slope, step, torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"bn_leaky forward launch failed: CUDA error {err}")
    LAUNCHES += 2
    return y, stats[:c], stats[c:2 * c]


def bn_leaky_backward_cuda(dy, x, weight, bias, mean, rstd, slope: float):
    """The backward kernels: (dx in x's dtype, dweight, dbias)."""
    global LAUNCHES
    _check(x, weight=weight, bias=bias, mean=mean, rstd=rstd)
    if not (dy.shape == x.shape and dy.dtype is torch.float32 and dy.is_contiguous()):
        raise ValueError(f"dy must be a contiguous float32 {tuple(x.shape)}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    if not dy.is_cuda or dy.get_device() != x.get_device():
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    dx = torch.empty_like(x)
    args = _launch_args(x, dy)
    n, c, k = args[2], args[3], args[5]
    dweight = torch.empty_like(mean)
    dbias = torch.empty_like(mean)
    part = torch.empty(n * c * k * 2, dtype=torch.float32, device=x.device)
    err = _library().bn_leaky_backward(
        dy.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), part.data_ptr(),
        *args, slope, torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"bn_leaky backward launch failed: CUDA error {err}")
    LAUNCHES += 2
    return dx, dweight, dbias


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("bn_leaky")
    ints = [ctypes.c_int] * 7
    lib.bn_leaky_forward.argtypes = ([ctypes.c_void_p] * 9 + ints + [ctypes.c_float] * 3
                                     + [ctypes.c_void_p])
    lib.bn_leaky_backward.argtypes = ([ctypes.c_void_p] * 10 + ints + [ctypes.c_float]
                                      + [ctypes.c_void_p])
    lib.bn_leaky_forward.restype = lib.bn_leaky_backward.restype = ctypes.c_int
    return lib
