"""The SD path's spans (utils/profiling.py): under an active profiler
session ``riffusion_restore_audio`` opens ``riffusion.analysis``,
``sd.encode``, one ``sd.step`` an evaluation with its index and timestep,
``sd.decode`` and ``riffusion.synthesis``, and one ``sd.attention`` a call
of the attention with its shape: 32 an evaluation in SD v1's block layout
(16 self- and 16 cross-attention), fewer at ``tiny()``'s. Without a
session nothing is recorded."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import audio_inpainting_torch.methods.diffusion as tdiff
from audio_inpainting_torch.models import sd
from audio_inpainting_torch.utils import profiling
from benchmark import sd_inputs

torch.set_num_threads(1)

STEPS = 2
# SD v1's block layout (four levels, two resnets a block, cross-attention
# in all but the deepest down block and the first up block) at small widths
LAYOUT = sd.UNetConfig(block_out_channels=(8, 8, 16, 16), cross_attention_dim=16,
                       attention_head_dim=2, norm_groups=4)


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling._Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _bundle(ucfg: sd.UNetConfig) -> dict:
    vcfg = sd.VAEConfig.tiny()
    out = {"unet_cfg": ucfg, "vae_cfg": vcfg,
           "context": sd_inputs.context(3, 77, ucfg.cross_attention_dim, "cpu")}
    for key, cls, cfg, part in (("unet_params", sd.UNet2DCondition, ucfg, "unet"),
                                ("vae_params", sd.AutoencoderKL, vcfg, "vae")):
        with torch.device("meta"):
            shapes = {k: tuple(t.shape) for k, t in cls(cfg).state_dict().items()}
        out[key] = sd.load_module(cls, cfg, sd_inputs.state(shapes, 3, part, "cpu"), "cpu")
    return out


def _clip():
    x = np.random.default_rng(0).standard_normal(8000).astype(np.float32) * 0.3
    x[3000:5000] = 0.0
    return x


def _restore(ucfg, size):
    return tdiff.riffusion_restore_audio(_clip(), 8000, steps=STEPS, key=1, bundle=_bundle(ucfg),
                                         image_size=size, device="cpu")


@pytest.mark.parametrize("ucfg, size, per_step", [(sd.UNetConfig.tiny(), 32, 8), (LAYOUT, 64, 32)],
                         ids=["tiny", "sd_v1_layout"])
def test_the_sd_path_opens_its_spans_with_their_attributes(recorder, ucfg, size, per_step):
    with profile(activities=[ProfilerActivity.CPU]):
        _restore(ucfg, size)
    found = profiling.spans()
    top = [s.name for s in found if s.name != "sd.attention" and not s.name.startswith("ops.")]
    assert top == (["riffusion.analysis", "sd.encode"] + ["sd.step"] * (STEPS + 1)
                   + ["sd.decode", "riffusion.synthesis"])
    steps = [s for s in found if s.name == "sd.step"]
    table = sd.plms_timesteps(STEPS)
    assert [s.attrs for s in steps] == [{"index": i, "t": int(t)} for i, t in enumerate(table)]
    (enc,) = [s for s in found if s.name == "sd.encode"]
    (dec,) = [s for s in found if s.name == "sd.decode"]
    latent = size // 2
    assert enc.attrs == {"height": size, "width": size}
    assert dec.attrs == {"height": latent, "width": latent}
    attn = [s for s in found if s.name == "sd.attention"]
    for step in steps:
        inside = [a for a in attn if a.parent == step.id]
        assert len(inside) == per_step
        d = {"batch": 2, "heads": ucfg.attention_head_dim}
        selfs = [a.attrs for a in inside if a.attrs["k_tokens"] == a.attrs["q_tokens"]]
        cross = [a.attrs for a in inside if a.attrs["k_tokens"] == 77]
        assert len(selfs) == len(cross) == per_step // 2
        assert all({k: a[k] for k in d} == d for a in selfs + cross)
        widths = {a["q_tokens"]: a["head_dim"] for a in selfs}
        assert widths[latent * latent] == ucfg.block_out_channels[0] // ucfg.attention_head_dim
    # the VAE's mid-block attention: one head over the latent grid, inside the encode and decode
    for vae_call in (enc, dec):
        (a,) = [a for a in attn if a.parent == vae_call.id]
        assert a.attrs == {"batch": 1, "heads": 1, "q_tokens": latent * latent,
                           "k_tokens": latent * latent,
                           "head_dim": sd.VAEConfig.tiny().block_out_channels[-1]}


def test_without_a_session_the_sd_path_records_nothing(recorder):
    assert not torch.autograd._profiler_enabled()
    _restore(sd.UNetConfig.tiny(), 32)
    assert profiling.spans() == []
