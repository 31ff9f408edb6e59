"""Checkpoint loader: diffusers-layout weights -> the port's SD modules.

The port of audio_inpainting_tpu/models/sd/loader.py. The reference
downloads ``riffusion/riffusion-model-v1`` from the hub
(main_diffusion_gap.py:16-19); this loader takes a LOCAL directory in the
diffusers layout::

    <root>/unet/diffusion_pytorch_model.safetensors
    <root>/vae/diffusion_pytorch_model.safetensors
    <root>/text_encoder/(model.safetensors|pytorch_model.bin)
    <root>/tokenizer/{vocab.json,merges.txt,...}

The port's modules carry diffusers' key names, so a checkpoint maps onto
them as it stands; the only renames are the legacy VAE attention names
(``query``/``key``/``value``/``proj_attn``), whose 1x1-conv weights are
squeezed into the Linear layout. ``.safetensors`` files are read by the
small reader below (the format is an 8-byte header length, a JSON header
and the raw little-endian buffers), so no ``safetensors`` package is
needed; ``.bin`` files go through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import struct
import sys

import torch
from torch import nn

from ...device import resolve_device
from .unet2d import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}

# legacy diffusers VAE attention key aliases (pre-0.15 checkpoints)
_VAE_ATTN_ALIASES = {
    "to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn",
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file (F32, F16 or BF16) as CPU
    tensors in the file's dtype, viewing one buffer read from the file."""
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors reader needs a little-endian host")
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        size = max((v["data_offsets"][1] for v in header.values()), default=0)
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: the file is shorter than its header says")
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(_DTYPES)}")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        t = (torch.frombuffer(buf, dtype=dtype, count=count, offset=start)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def load_torch_weights(model_dir: str) -> dict[str, torch.Tensor]:
    """Read every *.safetensors / *.bin in a directory into one dict of
    CPU tensors. FileNotFoundError where the directory is missing or holds
    neither."""
    state = {}
    for name in sorted(os.listdir(model_dir)):
        p = os.path.join(model_dir, name)
        if name.endswith(".safetensors"):
            state.update(read_safetensors(p))
        elif name.endswith(".bin"):
            state.update(torch.load(p, map_location="cpu", weights_only=True))
    if not state:
        raise FileNotFoundError(f"no .safetensors/.bin under {model_dir}")
    return state


def match_checkpoint(state_dict: dict, model: nn.Module,
                     strict: bool = True) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors under ``model``'s ``state_dict`` keys, as
    float32 CPU tensors (``model`` only gives the keys and shapes, so it
    may live on the meta device). Legacy VAE attention names are taken for
    the modern ones, and their (O, I, 1, 1) weights squeezed to (O, I).
    ``strict`` raises KeyError on a missing or an unused key; without it
    missing keys are left out."""
    out, used, missing = {}, set(), []
    for key, ref in model.state_dict().items():
        src = state_dict.get(key)
        src_key = key
        if src is None:
            for new, old in _VAE_ATTN_ALIASES.items():
                if new in key:
                    src = state_dict.get(key.replace(new, old))
                    if src is not None:
                        src_key = key.replace(new, old)
                        break
        if src is None:
            missing.append(key)
            continue
        used.add(src_key)
        t = torch.as_tensor(src)
        if t.shape != ref.shape and t.ndim == 4 and t.shape[2:] == (1, 1):
            t = t[:, :, 0, 0]
        if t.shape != ref.shape:
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(t.shape)} vs model {tuple(ref.shape)}")
        out[key] = t.to(torch.float32).contiguous()
    if missing and strict:
        raise KeyError(f"{len(missing)} params missing from checkpoint, "
                       f"e.g. {missing[:5]}")
    unused = [k for k in state_dict if k not in used
              and not k.endswith("num_batches_tracked")]
    if unused and strict:
        raise KeyError(f"{len(unused)} checkpoint keys unused, "
                       f"e.g. {sorted(unused)[:5]}")
    return out


def load_module(model_cls, cfg, state_dict: dict, device) -> nn.Module:
    """``model_cls(cfg)`` holding ``state_dict`` (matched strictly) on
    ``device``, in eval mode; built on the meta device, so no random
    initialisation is paid for."""
    with torch.device("meta"):
        model = model_cls(cfg)
    model.load_state_dict(match_checkpoint(state_dict, model), strict=True,
                          assign=True)
    return model.to(device).eval()


def load_riffusion(root: str, unet_cfg: UNetConfig | None = None,
                   vae_cfg: VAEConfig | None = None, load_text: bool = True,
                   device=None) -> dict:
    """Load a local diffusers-layout SD / riffusion checkpoint on
    ``device`` (cuda by default).

    Returns the JAX package's bundle keys: 'unet_params' (the
    UNet2DCondition module), 'vae_params' (the AutoencoderKL module),
    'text_encoder' (transformers' torch CLIPTextModel), 'tokenizer',
    'unet_cfg', 'vae_cfg'. Raises FileNotFoundError if the directory is
    absent. ``load_text=False`` skips the CLIP/tokenizer legs (their
    entries are None; the caller supplies the embeddings).
    """
    dev = resolve_device(device)
    unet_cfg = unet_cfg or UNetConfig()
    vae_cfg = vae_cfg or VAEConfig()
    unet = load_module(UNet2DCondition, unet_cfg,
                       load_torch_weights(os.path.join(root, "unet")), dev)
    vae = load_module(AutoencoderKL, vae_cfg,
                      load_torch_weights(os.path.join(root, "vae")), dev)
    text_encoder = tokenizer = None
    if load_text:
        from transformers import CLIPTextModel, CLIPTokenizer

        text_encoder = CLIPTextModel.from_pretrained(
            os.path.join(root, "text_encoder")).to(dev).eval()
        tokenizer = CLIPTokenizer.from_pretrained(os.path.join(root, "tokenizer"))
    return {"unet_params": unet, "vae_params": vae,
            "text_encoder": text_encoder, "tokenizer": tokenizer,
            "unet_cfg": unet_cfg, "vae_cfg": vae_cfg}
