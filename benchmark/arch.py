"""The nets of a configuration as lists of layers, from its widths.

Both the plain reference (``reference/nets.py``) and the counting
(``counting.py``) read the nets from here, so the FLOPs and bytes counted
are those of the layers the reference computes. Layer names follow the
reference scripts' module tree as the port names it (``block0.conv0``,
``up0``, ``conv0``); a GAN's generator and discriminator are prefixed
``g.`` and ``d.``.

- ``unet`` (main5_UNet_mask.py:11-56): blocks of two 3x3 convs at widths
  w0, w1, w2 over three grid levels, 2x2 stride-2 transposed-conv ups,
  skips concatenated as [encoder, upsampled], a 1x1 head to one channel.
  With ``batchnorm`` (the GAN generator, main_gan_gap.py:14-40) each conv
  is followed by a BatchNorm.
- ``patchgan`` (main_gan_gap.py:42-52): three 4x4 stride-2 convs (padding
  1) at widths w0, w1, w2, BatchNorm after the second and third, and a 4x4
  VALID head to one channel of logits.

A head conv always computes in float32; the others in the configuration's
``conv_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    padding: int = 0
    transposed: bool = False
    head: bool = False
    # the grid level of the input (the level-l grid is (F >> l, T >> l));
    # None: the previous layer's output
    level: int | None = 0


@dataclass(frozen=True)
class Call:
    """One conv applied: its layer and the grids it reads and writes."""

    conv: Conv
    h_in: int
    w_in: int
    h_out: int
    w_out: int


def unet_convs(widths, prefix: str = "") -> list[Conv]:
    w0, w1, w2 = widths

    def block(i, cin, cout, level):
        return [Conv(f"{prefix}block{i}.conv0", cin, cout, 3, padding=1, level=level),
                Conv(f"{prefix}block{i}.conv1", cout, cout, 3, padding=1, level=level)]

    return (block(0, 1, w0, 0) + block(1, w0, w1, 1) + block(2, w1, w2, 2)
            + [Conv(f"{prefix}up0", w2, w1, 2, stride=2, transposed=True, level=2)]
            + block(3, 2 * w1, w1, 1)
            + [Conv(f"{prefix}up1", w1, w0, 2, stride=2, transposed=True, level=1)]
            + block(4, 2 * w0, w0, 0)
            + [Conv(f"{prefix}conv0", w0, 1, 1, head=True, level=0)])


def patchgan_convs(widths, prefix: str = "") -> list[Conv]:
    w0, w1, w2 = widths
    return [Conv(f"{prefix}conv0", 1, w0, 4, 2, 1, level=0),
            Conv(f"{prefix}conv1", w0, w1, 4, 2, 1, level=None),
            Conv(f"{prefix}conv2", w1, w2, 4, 2, 1, level=None),
            Conv(f"{prefix}conv3", w2, 1, 4, 1, 0, head=True, level=None)]


def batchnorms(net: dict, prefix: str = "") -> list[tuple[str, int]]:
    """(name, channels) of the BatchNorms of ``net``, in module order."""
    w0, w1, w2 = net["widths"]
    if net["kind"] == "patchgan":
        return [(f"{prefix}bn0", w1), (f"{prefix}bn1", w2)]
    if not net.get("batchnorm"):
        return []
    outs = [w0, w1, w2, w1, w0]
    return [(f"{prefix}block{i}.bn{j}", c) for i, c in enumerate(outs) for j in (0, 1)]


def convs(net: dict, prefix: str = "") -> list[Conv]:
    """The convs of ``net`` (a configuration's ``nets`` entry), in the order
    their parameters are drawn."""
    kinds = {"unet": unet_convs, "patchgan": patchgan_convs}
    return kinds[net["kind"]](net["widths"], prefix)


def calls(layers: list[Conv], f: int, t: int) -> list[Call]:
    """Each conv of one forward at the input grid (f, t)."""
    out, prev = [], (f, t)
    for c in layers:
        h, w = prev if c.level is None else (f >> c.level, t >> c.level)
        if c.transposed:
            ho, wo = h * c.stride, w * c.stride
        else:
            ho = (h + 2 * c.padding - c.k) // c.stride + 1
            wo = (w + 2 * c.padding - c.k) // c.stride + 1
        out.append(Call(c, h, w, ho, wo))
        prev = (ho, wo)
    return out


def padded(f: int, t: int) -> tuple[int, int]:
    """(F, T) padded as the nets need it: F to a multiple of 4 (two 2x
    pools), T to a multiple of 32."""
    return f + (-f) % 4, t + (-t) % 32
