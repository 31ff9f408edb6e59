"""The SD UNet's 3x3 convolution kernel on the CPU: which convolutions the
model routes to it (models/sd/unet2d.py ``takes_kernel``), that the CPU
path is F.conv2d bit for bit, that the parameter keys are the checkpoint's,
the wrapper's refusals (ops/sd_conv3x3.py), its tiling and slicing, and
the plain version's arithmetic. The kernel itself runs only on a card
(tests/test_torch_sd_cuda.py)."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from audio_inpainting_torch.models import sd
from audio_inpainting_torch.models.sd import unet2d
from audio_inpainting_torch.ops import sd_conv3x3

MANIFEST = Path(__file__).resolve().parent / "golden" / "sd_v1_manifest.json"

# the five up-path resnet convs that cuDNN ran at about 3 % of the fp32
# peak: ((N, C_in, H, W), C_out) at the CFG batch of the 512^2 canvas
WIDE = [((2, 2560, 16, 16), 1280), ((2, 1920, 16, 16), 1280), ((2, 1920, 32, 32), 640),
        ((2, 1280, 32, 32), 640)]
ON_CARD = {"cuda": True, "fp32": True, "needs_grad": False}


@pytest.fixture(scope="module")
def full_calls():
    return unet2d.conv3x3_calls(sd.UNetConfig(), 2, 64, 64)


def test_the_wide_up_path_shapes_are_routed(full_calls):
    assert full_calls[WIDE[0]] == 2 and all(full_calls[s] == 1 for s in WIDE[1:])
    assert all(unet2d.takes_kernel(shape, c_out, **ON_CARD) for shape, c_out in WIDE)


def test_routed_shapes_of_the_unet(full_calls):
    """Every resnet and upsampler conv at 32^2 and below takes the kernel
    on the card (34 + 2 calls an evaluation), the 64^2 ones stay on
    F.conv2d, and nothing is routed off the card, in another dtype or
    where autograd needs a graph."""
    assert sum(full_calls.values()) == 44 + 3
    routed = {k: n for k, n in full_calls.items() if unet2d.takes_kernel(*k, **ON_CARD)}
    assert sum(routed.values()) == 36
    assert {k[0][2] for k in routed} == {8, 16, 32}
    assert all(k[0][2] == 64 for k in full_calls if k not in routed)
    for shape, c_out in full_calls:
        for flags in ({"cuda": False}, {"fp32": False}, {"needs_grad": True}):
            assert not unet2d.takes_kernel(shape, c_out, **{**ON_CARD, **flags})


def test_only_the_unet_resnet_and_upsampler_convs_are_conv3x3():
    """The VAE's convs, the stride-2 downsamplers, the 1x1 shortcuts,
    proj_in/proj_out and conv_in/conv_out stay nn.Conv2d."""
    with torch.device("meta"):
        unet, vae = sd.UNet2DCondition(), sd.AutoencoderKL()
    assert not any(isinstance(m, unet2d.Conv3x3) for m in vae.modules())
    for name, m in unet.named_modules():
        if isinstance(m, nn.Conv2d):
            resnet = name.endswith((".conv1", ".conv2")) and ".resnets." in name
            upsampler = ".upsamplers." in name
            assert isinstance(m, unet2d.Conv3x3) == (resnet or upsampler), name
            assert m.stride == (1, 1) or not isinstance(m, unet2d.Conv3x3)


def test_state_dict_keys_unchanged():
    with open(MANIFEST) as f:
        manifest = json.load(f)
    with torch.device("meta"):
        unet = sd.UNet2DCondition()
    assert {k: list(v.shape) for k, v in unet.state_dict().items()} == manifest["unet"]


@pytest.mark.parametrize("shape,c_out", [((2, 16, 16, 16), 12), ((1, 8, 8, 8), 16),
                                         ((2, 12, 32, 32), 8), ((2, 8, 64, 64), 8)])
def test_cpu_path_is_f_conv2d_bit_for_bit(shape, c_out):
    torch.manual_seed(0)
    conv = unet2d.Conv3x3(shape[1], c_out)
    x = torch.randn(shape)
    with torch.no_grad():
        got = conv(x)
    assert torch.equal(got, F.conv2d(x, conv.weight, conv.bias, 1, 1))
    got = conv(x)                       # with grad: the same, and differentiable
    got.sum().backward()
    assert torch.equal(got.detach(), F.conv2d(x, conv.weight, conv.bias, 1, 1))
    assert conv.weight.grad is not None


def test_module_tells_the_predicate_when_a_graph_is_needed(monkeypatch):
    seen = []
    monkeypatch.setattr(unet2d, "takes_kernel",
                        lambda shape, c_out, **flags: seen.append((shape, c_out, flags)))
    conv = unet2d.Conv3x3(16, 8)
    x = torch.randn(2, 16, 16, 16)
    conv(x)
    with torch.no_grad():
        conv(x)
    conv.requires_grad_(False)
    conv(x)
    conv.double()(x.double())
    assert [f["needs_grad"] for _, _, f in seen] == [True, False, False, False]
    assert [f["fp32"] for _, _, f in seen] == [True, True, True, False]
    assert all(s == (2, 16, 16, 16) and c == 8 and not f["cuda"] for s, c, f in seen)


@pytest.mark.parametrize("make,error,match", [
    (lambda: (torch.randn(2, 16, 16, 16), torch.randn(8, 16, 3, 3), torch.randn(8)),
     ValueError, "runs on cuda"),
    (lambda: (torch.randn(2, 16, 16, 16).double(), torch.randn(8, 16, 3, 3).double(),
              torch.randn(8).double()), TypeError, "float32"),
    (lambda: (torch.randn(2, 16, 16, 16), torch.randn(8, 16, 5, 5), torch.randn(8)), ValueError,
     r"\(K, C, 3, 3\)"),
    (lambda: (torch.randn(2, 16, 12, 12), torch.randn(8, 16, 3, 3), torch.randn(8)), ValueError,
     "does not take"),
    (lambda: (torch.randn(2, 6, 16, 16), torch.randn(8, 6, 3, 3), torch.randn(8)), ValueError,
     "does not take"),
    (lambda: (torch.randn(2, 16, 16, 16), torch.randn(8, 16, 3, 3), torch.randn(4)),
     ValueError, "bias"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(make, error, match):
    before = sd_conv3x3.LAUNCHES
    with pytest.raises(error, match=match):
        sd_conv3x3.sd_conv3x3(*make())
    assert sd_conv3x3.LAUNCHES == before


def test_tiles_and_slices(full_calls):
    """Every routed UNet shape is tiled by 128 pixels; the slices cover the
    input channels with none empty, in multiples of CK; on an H100 (132
    SMs) the 16^2 and 8^2 shapes of 1,280 input channels or more split
    13 ways."""
    for (n, c, h, w), c_out in full_calls:
        if not unet2d.takes_kernel((n, c, h, w), c_out, **ON_CARD):
            continue
        th, tw = sd_conv3x3.tile(n, h, w)
        img = sd_conv3x3.BM // (th * tw)
        assert h % th == 0 and w % tw == 0 and n % img == 0 and tw % 8 == 0
        tiles = n * h * w // sd_conv3x3.BM * -(-c_out // sd_conv3x3.BN)
        slices, per = sd_conv3x3.partition(tiles, c, 132)
        assert per % sd_conv3x3.CK == 0 and (slices - 1) * per < c <= slices * per
        if h <= 16 and c >= 1280:
            assert slices == 13
    assert sd_conv3x3.partition(1, 8, 132) == (2, 4)
    assert sd_conv3x3.partition(10_000, 2560, 132) == (1, 2560)


@pytest.mark.parametrize("slices,per", [(1, None), (3, 8), (13, 200)])
def test_plain_version_is_the_convolution(slices, per):
    g = torch.Generator().manual_seed(1)
    c = 24 if per != 200 else 2560
    x = torch.randn((2, c, 8, 8), generator=g, dtype=torch.float64)
    w = torch.randn((16, c, 3, 3), generator=g, dtype=torch.float64)
    b = torch.randn(16, generator=g, dtype=torch.float64)
    got = sd_conv3x3.sd_conv3x3_ref(x, w, b, slices, per)
    want = F.conv2d(x, w, b, padding=1)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-12
