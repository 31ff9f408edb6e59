"""The benchmark's frozen counts against the port's ``tools.roofline``:
the same FLOPs for one clip-epoch of each configuration, and a grouped
epoch G times one clip's."""

import json
import os

import pytest
import torch

from audio_inpainting_torch.methods.neural import (GANTrainConfig, GANTrainer, UNetTrainConfig,
                                                   UNetTrainer)
from audio_inpainting_torch.tools import roofline
from benchmark import arch, counting

from .conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as fh:
        return json.load(fh)


def _trainer(name, clips, f, t):
    cfg = _config(name)
    shape = (clips, f, t) if clips > 1 else (f, t)
    z, one = torch.zeros(shape), torch.ones(shape)
    seeds = list(range(clips)) if clips > 1 else 0
    bf16 = cfg["conv_dtype"] == "bfloat16"
    if cfg["driver"] == "unet":
        return UNetTrainer(z, one, UNetTrainConfig(bf16=bf16), seeds, device="meta")
    return GANTrainer(z, z, one, GANTrainConfig(bf16=bf16), seeds, device="meta")


@pytest.mark.parametrize("name", ["unet_part1", "gan_part2"])
@pytest.mark.parametrize("shape", [(513, 1723), (64, 128), (61, 100)])
def test_frozen_epoch_flops_equal_the_ports_count(name, shape):
    ours = counting.epoch_flops(_config(name), *shape)
    theirs = sum(roofline.count_flops(_trainer(name, 1, *shape).epoch).values())
    assert ours == theirs


@pytest.mark.parametrize("name", ["unet_part1", "gan_part2"])
def test_a_grouped_epoch_counts_g_clip_epochs(name):
    theirs = sum(roofline.count_flops(_trainer(name, 3, 64, 128).epoch).values())
    assert theirs == 3 * counting.epoch_flops(_config(name), 64, 128)


def test_peaks_are_the_ports():
    assert counting.H100_PEAKS["bfloat16"] == roofline.H100_PEAKS["bf16"]
    assert counting.H100_PEAKS["float32"] == roofline.H100_PEAKS["fp32"]
    assert counting.H100_PEAKS["hbm"] == roofline.H100_PEAKS["hbm"]


def test_a_conv_calls_bound_by_hand():
    cfg = {"driver": "unet", "conv_dtype": "float32",
           "nets": {"unet": {"kind": "unet", "widths": [16, 32, 64]}}}
    (call,) = arch.calls([arch.Conv("c", 16, 16, 3, padding=1)], 64, 128)
    flops = 2 * 16 * 16 * 9 * 64 * 128
    assert counting.conv_flops(call) == flops
    costs = counting._conv_costs(call, cfg, counting.Pass("unet"), first=False)
    x = y = 16 * 64 * 128 * 4
    w = (16 * 16 * 9 + 16) * 4
    assert costs == [(flops, x + w + y, "float32"), (2 * flops, y + 2 * (w + x), "float32")]


@pytest.mark.parametrize("name", ["unet_part1", "gan_part2"])
def test_reference_layers_match_the_ports_parameters(name):
    """arch.py's layers have the port's parameter names and shapes."""
    from benchmark.reference.nets import Net

    t = _trainer(name, 1, 64, 128)
    nets = {"": t.model} if name == "unet_part1" else {"g.": t.g, "d.": t.d}
    port = {p + k: tuple(v.shape) for p, m in nets.items() for k, v in m.state_dict().items()}
    state = Net(_config(name)).init(0, "cpu")
    ours = {k: tuple(v.shape) for key in ("params", "buffers") for k, v in state[key].items()}
    assert ours == port
