"""The port's roofline counting (audio_inpainting_torch/tools/roofline.py)
and the rows of its mfu tool (tools/mfu.py), on the CPU.

The counts come from shapes: FlopCounterMode on a call, checked here
against closed forms (a convolution's 2 N Co (Ci/G) kh kw H W, each
layer of the U-Net and the GAN, the NMF iteration's products) and against
XLA's cost analysis, which the JAX package's tools/mfu.py read (matrix
products agree exactly; a SAME-padded convolution differs by the taps on
the padding). Every mfu row is built at a reduced size on the CPU and at
the JAX tool's full shapes on the meta device, where nothing is computed,
and its FLOPs and bytes are held to the closed forms. No time is taken:
mfu's main has no CPU mode and raises without a card.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_inpainting_torch.methods.neural import (GANTrainConfig, GANTrainer,
                                                   UNetTrainConfig, UNetTrainer)
from audio_inpainting_torch.methods.nmf import _init_wh, _mu_fit
from audio_inpainting_torch.models import Discriminator, GeneratorUNet, SimpleUNet
from audio_inpainting_torch.models.unet import Conv, init_flax_style
from audio_inpainting_torch.tools import mfu, roofline
from audio_inpainting_torch.tools.roofline import count_flops

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

SMALL = mfu.Shapes(convs=((4, 16, 24, "L0"), (8, 8, 12, "L1")), d_op=(4, 8, 16, 24),
                   g_up=(8, 4, 8, 12), stft=(4000, 256, 64), nmf=(20, 30, 4, 3),
                   epoch=(61, 100), ar=((5, 7, 33, "a"), (3, 12, 40, "b")))
FULL_NAMES = [
    "conv3x3 L0 C16 fwd", "conv3x3 L0 C16 fwd+bwd", "conv3x3 L1 C32 fwd",
    "conv3x3 L1 C32 fwd+bwd", "conv3x3 L2 C64 fwd", "conv3x3 L2 C64 fwd+bwd",
    "conv4x4s2 (D op) fwd", "conv_transpose2x2 (G up) fwd",
    "stft 1024/256 441000 samples (real FFT)", "nmf MU fit 200it (513x1723, k=40)",
    "GAN epoch (G+D step, bf16)", "U-Net epoch (masked MSE, bf16)",
    "U-Net epoch (masked MSE, fp32)", "ar_scan (736, 30, 1024) facade",
    "ar_scan (3584, 30, 2048) windowed class"]


def conv_flops(n, cin, cout, kh, kw, h, w, groups=1):
    """2 N Co (Ci/G) kh kw H W: a convolution over an H x W grid (the
    output's; for a transposed convolution the input's)."""
    return 2 * n * cout * (cin // groups) * kh * kw * h * w


def _padded(f, t):
    return f + (-f) % 4, t + (-t) % 32


def _unet_fwd(fp, tp):
    """Forward FLOPs of SimpleUNet (and GeneratorUNet, the same convs) at
    the padded (fp, tp): each conv's taps over the grid it slides on (an
    up-convolution's: its input)."""
    p0, p1, p2 = fp * tp, fp * tp // 4, fp * tp // 16
    layers = [(1, 16, 3, p0), (16, 16, 3, p0), (16, 32, 3, p1), (32, 32, 3, p1),
              (32, 64, 3, p2), (64, 64, 3, p2), (64, 32, 2, p2), (64, 32, 3, p1),
              (32, 32, 3, p1), (32, 16, 2, p1), (32, 16, 3, p0), (16, 16, 3, p0),
              (16, 1, 1, p0)]
    return sum(conv_flops(1, ci, co, k, k, cells, 1) for ci, co, k, cells in layers)


def _unet_first(fp, tp):
    return conv_flops(1, 1, 16, 3, 3, fp, tp)


def _d_fwd_and_first(fp, tp):
    """Forward FLOPs of the Discriminator at (fp, tp) (three 4x4 stride-2
    convs with padding 1, a 4x4 VALID head), and its first conv's."""
    sizes = [(fp, tp)]
    for _ in range(3):
        f, t = sizes[-1]
        sizes.append(((f - 2) // 2 + 1, (t - 2) // 2 + 1))
    (f1, t1), (f2, t2), (f3, t3) = sizes[1:]
    first = conv_flops(1, 1, 16, 4, 4, f1, t1)
    return (first + conv_flops(1, 16, 32, 4, 4, f2, t2) + conv_flops(1, 32, 64, 4, 4, f3, t3)
            + conv_flops(1, 64, 1, 4, 4, f3 - 3, t3 - 3)), first


def _epoch_counts(kind, f, t):
    """(convolution, convolution_backward) FLOPs of one epoch. U-Net: the
    forward; its backward gives every grad-weight and every grad-input but
    the first conv's (its input needs none). GAN: G's forward and D's
    three (real, detached fake, live composite); D's step back through the
    first two (grad-weights, grad-inputs past D's first conv), G's step
    back through D's third (grad-inputs only) and through G."""
    fp, tp = _padded(f, t)
    g_fwd, g_first = _unet_fwd(fp, tp), _unet_first(fp, tp)
    if kind == "unet":
        return g_fwd, 2 * g_fwd - g_first
    d_fwd, d_first = _d_fwd_and_first(fp, tp)
    return g_fwd + 3 * d_fwd, 2 * (2 * d_fwd - d_first) + d_fwd + 2 * g_fwd - g_first


def _nmf_flops(f, t, k, iters):
    """The products of ``iters`` multiplicative updates: W^T V, (W^T W) H,
    V H^T and W (H H^T)."""
    return iters * (4 * k * f * t + 4 * k * k * (f + t))


def _param_bytes(*models):
    return sum(4 * p.numel() for m in models for p in m.parameters())


def _buffer_bytes(*models):
    return sum(4 * b.numel() for m in models for b in m.buffers())


def _expected(shapes):
    """{row name: (flops, bytes)} from the closed forms at ``shapes``."""
    out = {}
    for c, h, w, level in shapes.convs:
        flops = conv_flops(1, c, c, 3, 3, h, w)
        io = 2 * c * h * w, 4 * (c * c * 9 + c)            # bf16 x (and y); fp32 params
        out[f"conv3x3 {level} C{c} fwd"] = flops, 2 * io[0] + io[1]
        out[f"conv3x3 {level} C{c} fwd+bwd"] = 3 * flops, 4 * io[0] + 2 * io[1]
    ci, co, h, w = shapes.d_op
    ho, wo = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    out["conv4x4s2 (D op) fwd"] = (conv_flops(1, ci, co, 4, 4, ho, wo),
                                   2 * ci * h * w + 4 * (co * ci * 16 + co) + 2 * co * ho * wo)
    ci, co, h, w = shapes.g_up
    out["conv_transpose2x2 (G up) fwd"] = (conv_flops(1, ci, co, 2, 2, h, w),
                                           2 * ci * h * w + 4 * (ci * co * 4 + co)
                                           + 2 * co * 4 * h * w)
    n, n_fft, hop = shapes.stft
    frames = 1 + n // hop
    out[f"stft {n_fft}/{hop} {n} samples (real FFT)"] = (
        frames * 2.5 * n_fft * math.log2(n_fft), 4 * n + 8 * (n_fft // 2 + 1) * frames)
    f, t, k, iters = shapes.nmf
    out[f"nmf MU fit {iters}it ({f}x{t}, k={k})"] = (_nmf_flops(f, t, k, iters),
                                                     4 * (f * t + 2 * (f * k + k * t)))
    f, t = shapes.epoch
    cells = 4 * np.prod(_padded(f, t))
    g, d, u = GeneratorUNet(), Discriminator(), SimpleUNet()
    out["GAN epoch (G+D step, bf16)"] = (
        sum(_epoch_counts("gan", f, t)),
        5 * cells + 2 * (3 * _param_bytes(g, d) + _buffer_bytes(g, d)))
    for dt in ("bf16", "fp32"):
        out[f"U-Net epoch (masked MSE, {dt})"] = (sum(_epoch_counts("unet", f, t)),
                                                  3 * cells + 6 * _param_bytes(u))
    for B, p, steps, where in shapes.ar:
        out[f"ar_scan ({B}, {p}, {steps}) {where}"] = (
            2 * B * p * steps, 4 * 2 * B * steps + 4 * B * (2 * p + 3))
    return out


# ------------------------------------------------------------ the peaks ----


def test_h100_peaks_and_peak_for():
    assert roofline.H100_PEAKS == {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
                                   "fp32": 67e12, "hbm": 3.35e12}
    assert roofline.peak_for(torch.bfloat16) == roofline.peak_for(torch.float16) == 989e12
    # TF32 is off package-wide: fp32 work is held to the fp32 cores' peak
    assert roofline.peak_for(torch.float32) == 67e12
    assert roofline.peak_for("tf32") == 495e12
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        roofline.peak_for(torch.float64)


# ----------------------------------------------------------- the counts ----


@pytest.mark.parametrize("case", [
    # (cin, cout, k, stride, padding, transpose, groups, (n, h, w))
    ("plain", 3, 5, 3, 1, 1, False, 1, (2, 9, 14)),
    ("grouped", 6, 4, 3, 1, 1, False, 2, (1, 10, 12)),
    ("strided", 4, 8, 4, 2, 1, False, 1, (2, 16, 22)),
    ("transposed", 6, 3, 2, 2, 0, True, 1, (1, 7, 9)),
], ids=lambda c: c[0])
def test_count_flops_matches_the_conv_closed_form(case):
    """2 N Co (Ci/G) kh kw H W over the grid the kernel slides on: the
    output of a convolution, the input of a transposed one; the backward
    (grad-input and grad-weight) twice that."""
    _, cin, cout, k, stride, pad, transpose, groups, (n, h, w) = case
    conv = init_flax_style(Conv(cin, cout, k, stride, pad, transpose=transpose,
                                groups=groups), torch.Generator().manual_seed(0))
    x = torch.randn(n, groups * cin, h, w, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y = conv(x)
    grid = (h, w) if transpose else y.shape[2:]
    want = conv_flops(n, groups * cin, groups * cout, k, k, *grid, groups=groups)
    assert count_flops(conv, x) == {"aten.convolution": want}
    counted = count_flops(lambda: conv(x).sum().backward())
    assert counted == {"aten.convolution": want, "aten.convolution_backward": 2 * want}


@pytest.mark.parametrize("kind", ["unet", "gan"])
@pytest.mark.parametrize("where", ["cpu_64x128", "meta_513x1723"])
def test_epoch_counts_match_the_layer_closed_forms(kind, where):
    """One epoch's conv FLOPs: at (64, 128) on the CPU (fp32: 396,886,016
    forward and 791,412,736 backward for the U-Net) and at Part 1's
    (513, 1723) on the meta device, the mfu rows' shape."""
    device, (f, t) = ("cpu", (64, 128)) if where.startswith("cpu") else ("meta", (513, 1723))
    rng = np.random.RandomState(0)
    mag = torch.as_tensor(rng.rand(f, t).astype(np.float32)).to(device)
    keep = torch.as_tensor((rng.rand(f, t) > 0.3).astype(np.float32)).to(device)
    if kind == "unet":
        trainer = UNetTrainer(mag, keep, UNetTrainConfig(), 0)
    else:
        trainer = GANTrainer(mag * 2 - 1, mag * 2 - 1, keep, GANTrainConfig(bf16=True), 0)
    fwd, bwd = _epoch_counts(kind, f, t)
    assert count_flops(trainer.epoch) == {"aten.convolution": fwd,
                                          "aten.convolution_backward": bwd}
    if kind == "unet" and device == "cpu":
        assert (fwd, bwd) == (396_886_016, 791_412_736)


@pytest.mark.parametrize("kind", ["unet", "gan"])
def test_grouped_epoch_counts_g_times_one_clip(kind):
    """A group of G clips (one grouped net, parallel/batch.py) counts G
    times one clip's epoch: the grouped convolutions' grad-weights are
    counted per group."""
    rng = np.random.RandomState(0)
    mag = torch.as_tensor(rng.rand(3, 64, 128).astype(np.float32))
    keep = torch.as_tensor((rng.rand(3, 64, 128) > 0.3).astype(np.float32))

    def epoch(clips):
        if kind == "unet":
            return UNetTrainer(mag[clips], keep[clips], UNetTrainConfig(), [0] * len(clips)).epoch
        return GANTrainer(mag[clips] * 2 - 1, mag[clips] * 2 - 1, keep[clips],
                          GANTrainConfig(), [0] * len(clips)).epoch

    one = count_flops(epoch([0]))
    assert count_flops(epoch([0, 1, 2])) == {k: 3 * v for k, v in one.items()}
    assert one == dict(zip(("aten.convolution", "aten.convolution_backward"),
                           _epoch_counts(kind, 64, 128)))


def test_nmf_iteration_count_is_its_products():
    rng = np.random.RandomState(0)
    v = torch.as_tensor(np.abs(rng.randn(513, 1723)).astype(np.float32), device="meta")
    w, h = _init_wh(0, v, 40)
    assert count_flops(_mu_fit, v, w, h, 2) == {"aten.mm": _nmf_flops(513, 1723, 40, 2)}


def _xla_flops(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    return (ca[0] if isinstance(ca, list) else ca)["flops"]


NMF_PRODUCTS = {                 # (m, k, n) of each product of one update, k = 40
    "WtV": (40, 513, 1723), "WtW": (40, 513, 40), "WtW_H": (40, 40, 1723),
    "VHt": (513, 1723, 40), "HHt": (40, 1723, 40), "W_HHt": (513, 40, 40)}


@pytest.mark.parametrize("name", sorted(NMF_PRODUCTS))
def test_nmf_products_equal_xla_cost_analysis(name):
    """Each matrix product of an NMF update at (513, 1723), k = 40: the
    torch counter's FLOPs equal XLA's cost analysis exactly."""
    m, k, n = NMF_PRODUCTS[name]
    xla = _xla_flops(lambda a, b: a @ b, jnp.zeros((m, k)), jnp.zeros((k, n)))
    ours = count_flops(lambda: torch.zeros(m, k, device="meta") @ torch.zeros(
        k, n, device="meta"))
    assert ours == {"aten.mm": 2 * m * k * n}
    assert xla == 2 * m * k * n


def test_conv3x3_count_relates_to_xla_by_the_padded_taps():
    """XLA leaves out the taps of a SAME conv that fall on the padding:
    2 Ci Co (3H - 2)(3W - 2) against the closed form's 2 Ci Co 9 H W."""
    ci = co = 16
    h, w = 32, 48
    xla = _xla_flops(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.zeros((1, h, w, ci)), jnp.zeros((3, 3, ci, co)))
    conv = Conv(ci, co, 3, padding=1)
    ours = count_flops(conv, torch.zeros(1, ci, h, w))["aten.convolution"]
    assert xla == 6_834_176 == 2 * ci * co * (3 * h - 2) * (3 * w - 2)
    assert ours == 7_077_888 == conv_flops(1, ci, co, 3, 3, h, w)
    # a product agrees exactly
    assert _xla_flops(lambda a, b: a @ b, jnp.zeros((513, 40)),
                      jnp.zeros((40, 1723))) == 70_711_920


# ------------------------------------------------------------- the rows ----


@pytest.mark.parametrize("where", ["cpu_reduced", "meta_full"])
def test_mfu_rows_count_their_closed_forms(where):
    """Every mfu row's FLOPs and bytes: at a reduced size on the CPU and at
    the JAX tool's full shapes on the meta device (the counts the card's
    run prints)."""
    device, shapes = ("cpu", SMALL) if where == "cpu_reduced" else ("meta", mfu.Shapes())
    ops = list(mfu.hot_ops(device, shapes))
    want = _expected(shapes)
    assert [op.op for op in ops] == list(want)
    if device == "meta":
        assert [op.op for op in ops] == FULL_NAMES
    for op in ops:
        assert (op.flops, op.nbytes) == want[op.op], op.op
        assert op.dtype == (torch.float32 if op.op.startswith(("stft", "nmf", "ar_scan"))
                            or "fp32" in op.op else torch.bfloat16)
        assert op.calls > 0


def test_mfu_rows_run_on_the_cpu_at_a_reduced_size():
    """Each reduced row's op runs (the AR rows run the plain loop)."""
    for op in mfu.hot_ops("cpu", SMALL):
        op.fn()


@pytest.mark.parametrize("case", [
    # (flops, nbytes, dtype, ms, mfu_pct, hbm_pct, bound)
    ("hbm", 989e9 * 0.1, 3.35e9 * 0.5, torch.bfloat16, 1.0, 10.0, 50.0, "HBM"),
    ("tensor_cores", 989e9 * 0.8, 3.35e9 * 0.2, torch.bfloat16, 1.0, 80.0, 20.0,
     "tensor cores"),
    ("fp32_cores", 67e9 * 0.6, 3.35e9 * 0.1, torch.float32, 2.0, 30.0, 5.0, "fp32 cores"),
], ids=lambda c: c[0])
def test_roofline_row_arithmetic(case):
    _, flops, nbytes, dtype, ms, mfu_pct, hbm_pct, bound = case
    row = roofline.roofline_row("op", ms, flops, nbytes, dtype)
    assert set(row) == {"op", "ms", "gflops", "mb", "tflops", "mfu_pct", "gbs",
                        "hbm_pct", "bound", "peak_tflops"}
    assert row["ms"] == ms and row["gflops"] == flops / 1e9 and row["mb"] == nbytes / 1e6
    assert row["tflops"] == pytest.approx(flops / ms / 1e9)
    assert row["gbs"] == pytest.approx(nbytes / ms / 1e6)
    assert row["mfu_pct"] == pytest.approx(mfu_pct)
    assert row["hbm_pct"] == pytest.approx(hbm_pct)
    assert row["bound"] == bound
    assert row["peak_tflops"] == roofline.peak_for(dtype) / 1e12
    # the same bound as bound_ms's
    bms, by = roofline.bound_ms(flops, nbytes, dtype)
    assert by == ("bytes" if bound == "HBM" else "operations")
    assert bms == pytest.approx(ms * max(mfu_pct, hbm_pct) / 100)


def test_train_step_bytes():
    data = [torch.zeros(3, 5), torch.zeros(7, dtype=torch.bfloat16)]
    params, buffers = [torch.zeros(11), torch.zeros(2, 2)], [torch.zeros(6)]
    assert roofline.train_step_bytes(data, params, buffers) == (
        4 * 15 + 2 * 7 + 2 * (3 * 4 * 15 + 4 * 6))


# ---------------------------------------------------- the smoke's bounds ----


def _smoke_bound_before(B, p, steps):
    """chip_smoke.bound_ms as it was written before it took the package's
    count: literal peaks."""
    flops = 2.0 * B * p * steps
    nbytes = 4.0 * B * steps * 2 + 4.0 * B * (2 * p + 3)
    t_ops, t_bytes = flops / 67e12, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


@pytest.mark.parametrize("shape", [(736, 30, 1024), (2, 100, 88200), (2, 30, 441),
                                   (50, 30, 14439), (3584, 30, 2048), (16, 30, 4096),
                                   (1, 224, 100000)])
def test_smoke_bound_ms_is_unchanged(shape):
    assert chip_smoke.bound_ms(*shape) == _smoke_bound_before(*shape)


@pytest.mark.parametrize("work", [(3.9e9, 1.2e8), (2e12, 5e9), (1.0, 1e9)])
def test_smoke_flop_bound_is_unchanged(work):
    flops, nbytes = work
    t_ops, t_bytes = flops / 67e12, nbytes / 3.35e12
    assert chip_smoke.flop_bound(flops, nbytes) == {
        "gflop": flops / 1e9, "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------- no card here ----


def test_mfu_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mfu.main([])
    with pytest.raises(RuntimeError):
        next(mfu.measure("cpu", SMALL))


def test_traced_reads_its_device_trace(monkeypatch):
    """mfu's trace of a row, on the CPU: the op runs the asked number of
    times under device_trace, and the trace holds no device events."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    conv = torch.nn.Conv2d(1, 4, 3)
    x = torch.randn(1, 1, 16, 16)
    ran = []
    got = mfu.traced(lambda: ran.append(conv(x)), 2)
    assert len(ran) == 2
    assert got == {"trace_ms": 0.0, "busy_share": 0.0, "unrecorded": 0, "kernels": []}


def _hook_macs(model, call):
    """The smoke's counter before it took count_flops (forward hooks on
    the convolutions, dense layers and attention products): the
    reference its counts must still equal."""
    from torch import nn

    from audio_inpainting_torch.models.sd.unet2d import Attention
    from audio_inpainting_torch.models.sd.vae import VAEAttention

    total = 0

    def hook(mod, args, out):
        nonlocal total
        if isinstance(mod, Conv):
            taps = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
            total += (args[0].numel() if mod.transpose else out.numel()) * taps
        elif isinstance(mod, nn.Conv2d):
            total += out.numel() * mod.weight[0].numel()
        elif isinstance(mod, nn.Linear):
            total += out.numel() * mod.in_features
        elif isinstance(mod, Attention):
            ctx = args[1] if len(args) > 1 else args[0]
            total += 2 * args[0].shape[0] * args[0].shape[1] * ctx.shape[1] * mod.to_q.out_features
        else:
            b, c, h, w = args[0].shape
            total += 2 * b * (h * w) ** 2 * c

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, nn.Conv2d, nn.Linear, Attention, VAEAttention))]
    with torch.no_grad():
        call()
    for h in handles:
        h.remove()
    return total


@pytest.mark.parametrize("which", ["diffusion_unet", "sd_unet", "sd_vae_encode",
                                   "sd_vae_decode"])
def test_smoke_macs_are_unchanged(which):
    """chip_smoke's FLOP bounds of the diffusion and SD-v1 forwards count
    with count_flops now; at small shapes they equal its former hooks'."""
    from audio_inpainting_torch.methods import diffusion as diff
    from audio_inpainting_torch.models import sd

    gen = torch.Generator().manual_seed(0)
    if which == "diffusion_unet":
        model = diff.new_model(diff._draw_init(0, "clip", 32), 32, "cpu")
        shape = (2, 1, 32, 48)
        assert chip_smoke.unet_macs(model, shape) == _hook_macs(
            model, lambda: model(torch.zeros(shape), torch.zeros(2)))
        return
    if which == "sd_unet":
        cfg = sd.UNetConfig.tiny()
        model = sd.UNet2DCondition(cfg)
        x = torch.randn(2, cfg.in_channels, 16, 16, generator=gen)
        ctx = torch.randn(2, 7, cfg.cross_attention_dim, generator=gen)
        call = lambda: model(x, torch.tensor([10.0, 10.0]), ctx)   # noqa: E731
    else:
        model = sd.AutoencoderKL(sd.VAEConfig.tiny())
        img = torch.randn(1, 3, 32, 32, generator=gen)
        z = torch.randn(1, 4, 4, 4, generator=gen)
        call = (lambda: model.encode(img)) if which == "sd_vae_encode" else (
            lambda: model.decode(z))
    assert chip_smoke.model_macs(call) == _hook_macs(model, call) > 0
