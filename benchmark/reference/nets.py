"""The reference nets and their training step, one clip at a time, in plain
PyTorch: functional forwards over a dict of parameters, autograd for the
gradients, Adam written out.

A state is a dict: ``params`` and ``buffers`` (BatchNorm's running
statistics) by layer name, Adam's moments ``m`` and ``v``, its ``step``
count and, for a GAN read out through a weight EMA, ``ema``. Inputs are
(1, 1, F, T) tensors, F and T padded as the nets need.

``prec`` is the precision the convs other than the heads compute in: the
configuration's ``conv_dtype`` for the reference ("fp32", TF32 off;
"bf16", inputs, weights and outputs in bfloat16 with float32
parameters), or, for the control, the next lower one: "tf32" (TF32 on) or
"fp8" (each conv's input and weight rounded to float8 e4m3, straight
through in the backward, its output in bfloat16). BatchNorm, the heads,
the losses and Adam stay float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..arch import batchnorms, convs

# flax's lecun_normal: a unit normal cut at +-2 std has this std
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def precision(prec: str):
    """TF32 on for "tf32", off otherwise; restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()


def reference_precision(config: dict) -> str:
    """The reference's ``prec``: the configuration's conv dtype."""
    return {"float32": "fp32", "bfloat16": "bf16"}[config["conv_dtype"]]


def control_precision(config: dict) -> str:
    """The control's ``prec``: the precision below the configuration's."""
    return {"float32": "tf32", "bfloat16": "fp8"}[config["conv_dtype"]]


class Net:
    """The layers of one configuration, by name."""

    def __init__(self, config: dict):
        self.config = config
        self.convs = {}
        self.bns = []
        for key, net in config["nets"].items():
            prefix = "" if len(config["nets"]) == 1 else f"{key}."
            self.convs.update({c.name: c for c in convs(net, prefix)})
            self.bns += batchnorms(net, prefix)
        bn = config.get("batchnorm", {})
        self.momentum, self.eps = bn.get("momentum", 0.9), bn.get("eps", 1e-5)

    def init(self, seed: int, device) -> dict:
        """The initial state: every conv's weight a truncated normal of std
        sqrt(1 / fan_in) / 0.8796 cut at +-2 std (fan_in = Ci k^2), drawn in
        layer order from a CPU generator seeded with ``seed``; biases 0;
        BatchNorm scale 1, bias 0, running mean 0 and variance 1."""
        gen = torch.Generator().manual_seed(seed)
        params, buffers = {}, {}
        for c in self.convs.values():
            shape = (c.cin, c.cout, c.k, c.k) if c.transposed else (c.cout, c.cin, c.k, c.k)
            w = torch.empty(shape)
            std = math.sqrt(1.0 / (c.cin * c.k * c.k)) / _TRUNC_STD
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            params[f"{c.name}.weight"] = w
            params[f"{c.name}.bias"] = torch.zeros(c.cout)
        for name, ch in self.bns:
            params[f"{name}.weight"] = torch.ones(ch)
            params[f"{name}.bias"] = torch.zeros(ch)
            buffers[f"{name}.running_mean"] = torch.zeros(ch)
            buffers[f"{name}.running_var"] = torch.ones(ch)
        mv = lambda: {k: torch.zeros_like(v) for k, v in params.items()}   # noqa: E731
        to = lambda d: {k: v.to(device) for k, v in d.items()}             # noqa: E731
        return {"params": to(params), "buffers": to(buffers), "m": to(mv()), "v": to(mv()),
                "step": 0, "ema": None}

    # ------------------------------------------------------------ layers --

    def conv(self, p: dict, name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
        c = self.convs[name]
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        x = x.to(torch.float32)
        low = not c.head and prec in ("bf16", "fp8")
        if low and prec == "fp8":
            x, w = _fp8(x), _fp8(w)
        elif low:
            x, w, b = x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
        if c.transposed:
            y = F.conv_transpose2d(x, w, b, stride=c.stride)
        else:
            y = F.conv2d(x, w, b, stride=c.stride, padding=c.padding)
        return y.to(torch.bfloat16) if low else y

    def bn(self, p: dict, bufs: dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        """BatchNorm over (N, H, W) per channel; in training the batch's
        biased statistics, and the running ones moved to them by 1 -
        momentum (written into ``bufs``)."""
        rm, rv = bufs[f"{name}.running_mean"], bufs[f"{name}.running_var"]
        x = x.to(torch.float32)
        if train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            bufs[f"{name}.running_mean"] = self.momentum * rm + (1 - self.momentum) * mean.detach()
            bufs[f"{name}.running_var"] = self.momentum * rv + (1 - self.momentum) * var.detach()
        else:
            mean, var = rm, rv
        shape = (1, -1, 1, 1)
        return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + self.eps)
                * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape))

    def unet(self, p: dict, bufs: dict, x: torch.Tensor, prec: str, train: bool,
             prefix: str = "", batchnorm: bool = False) -> torch.Tensor:
        def block(i, x):
            for j in (0, 1):
                x = self.conv(p, f"{prefix}block{i}.conv{j}", x, prec)
                if batchnorm:
                    x = F.leaky_relu(self.bn(p, bufs, f"{prefix}block{i}.bn{j}", x, train), 0.2)
                else:
                    x = F.relu(x)
            return x

        e1 = block(0, x)
        e2 = block(1, F.max_pool2d(e1, 2))
        b = block(2, F.max_pool2d(e2, 2))
        d2 = block(3, torch.cat([e2, self.conv(p, f"{prefix}up0", b, prec)], 1))
        d1 = block(4, torch.cat([e1, self.conv(p, f"{prefix}up1", d2, prec)], 1))
        out = self.conv(p, f"{prefix}conv0", d1, prec)
        return torch.tanh(out) if batchnorm else out

    def patchgan(self, p: dict, bufs: dict, x: torch.Tensor, prec: str, train: bool) -> torch.Tensor:
        x = F.leaky_relu(self.conv(p, "d.conv0", x, prec), 0.2)
        x = F.leaky_relu(self.bn(p, bufs, "d.bn0", self.conv(p, "d.conv1", x, prec), train), 0.2)
        x = F.leaky_relu(self.bn(p, bufs, "d.bn1", self.conv(p, "d.conv2", x, prec), train), 0.2)
        return self.conv(p, "d.conv3", x, prec)

    def generator(self, p, bufs, x, prec, train):
        return self.unet(p, bufs, x, prec, train, "g.", batchnorm=True)

    # ------------------------------------------------------------- Adam ---

    def adam(self, state: dict, grads: dict, names) -> None:
        """One Adam step of the parameters ``names`` (optax's eps outside
        the square root), in place in ``state``."""
        o = self.config["optimizer"]
        (b1, b2), lr, eps = o["betas"], o["lr"], o["eps"]
        t = state["step"] + 1
        for k in names:
            g = grads[k]
            m = state["m"][k] = b1 * state["m"][k] + (1 - b1) * g
            v = state["v"][k] = b2 * state["v"][k] + (1 - b2) * g * g
            state["params"][k] = state["params"][k] - (lr / (1 - b1 ** t)) * m / (
                torch.sqrt(v) / math.sqrt(1 - b2 ** t) + eps)


def clone_state(state: dict) -> dict:
    """A copy of ``state`` whose tensors are detached from the step."""
    out = dict(state)
    for key in ("params", "buffers", "m", "v", "ema"):
        if state.get(key) is not None:
            out[key] = {k: v.detach().clone() for k, v in state[key].items()}
    return out


def _leaves(state: dict) -> dict:
    return {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}


def unet_step(net: Net, state: dict, x: dict, prec: str) -> tuple[list[float], dict, dict]:
    """One epoch of masked-MSE training: (the loss before the step, the
    gradients, the state after it). ``x`` holds ``inp`` (the masked
    magnitude), ``tgt``, ``inv`` ((1 - train mask) x valid) and ``denom``
    (the valid cells, at least 1)."""
    state = clone_state(state)
    p = _leaves(state)
    with precision(prec):
        out = net.unet(p, state["buffers"], x["inp"], prec, True)
        loss = ((out * x["inv"] - x["tgt"] * x["inv"]) ** 2).sum() / x["denom"]
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    net.adam(state, grads, list(p))
    state["step"] += 1
    return [float(loss.detach())], grads, state


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def gan_step(net: Net, state: dict, x: dict, prec: str) -> tuple[list[float], dict, dict]:
    """One GAN epoch (main_gan_gap.py:117-158, in the port's order): G's
    forward; D's step on the real clip and the detached composite; the
    adversarial term through the stepped D; G's step on L1 over the hole's
    valid cells plus the adversarial term; the weight EMA. Returns ([D's
    loss, G's loss], the gradients of both, the state after)."""
    cfg = net.config
    state = clone_state(state)
    bufs = state["buffers"]
    p = _leaves(state)
    gk = [k for k in p if k.startswith("g.")]
    dk = [k for k in p if k.startswith("d.")]
    with precision(prec):
        fake = net.generator(p, bufs, x["inp"], prec, True)
        completed = x["inp"] * x["msk"] + fake * x["inv"]
        d_loss = 0.5 * (_bce(net.patchgan(p, bufs, x["real"], prec, True), 1.0)
                        + _bce(net.patchgan(p, bufs, completed.detach(), prec, True), 0.0))
        grads = dict(zip(dk, torch.autograd.grad(d_loss, [p[k] for k in dk])))
    net.adam(state, grads, dk)
    stepped = {**p, **{k: state["params"][k].detach() for k in dk}}
    with precision(prec):
        adv = _bce(net.patchgan(stepped, bufs, completed, prec, True), 1.0)
        rec = (fake * x["rec_inv"] - x["real"] * x["rec_inv"]).abs().sum() / x["rec_denom"]
        loss = cfg["loss"]
        g_loss = loss["l1_weight"] * rec + loss["adv_weight"] * adv
        grads.update(zip(gk, torch.autograd.grad(g_loss, [p[k] for k in gk])))
    net.adam(state, grads, gk)
    state["step"] += 1
    ema = cfg.get("ema")
    if ema:
        d = ema["decay"]
        if state["ema"] is None:
            state["ema"] = {k: torch.zeros_like(state["params"][k]) for k in gk}
        state["ema"] = {k: d * e + (1 - d) * state["params"][k] for k, e in state["ema"].items()}
    return [float(d_loss.detach()), float(g_loss.detach())], grads, state


@torch.no_grad()
def unet_readout(net: Net, state: dict, x: dict, prec: str) -> torch.Tensor:
    """The composite (F, T) of the padded grid: the magnitude kept under the
    composite mask, the net's prediction from that input elsewhere."""
    seen = x["tgt"] * x["cmsk"]
    with precision(prec):
        pred = net.unet(state["params"], state["buffers"], seen, prec, False)
    return (seen + pred * (1 - x["cmsk"]))[0, 0]


@torch.no_grad()
def gan_readout(net: Net, state: dict, x: dict, prec: str, epochs: int) -> torch.Tensor:
    """The composite (F, T) of the padded grid from the eval-mode generator
    (running statistics). With a gap-scoped EMA: the bias-corrected EMA
    weights' fill in the columns whose valid cells are over 98 % hole, the
    last weights' fill elsewhere."""
    p, bufs = state["params"], dict(state["buffers"])
    with precision(prec):
        fake = net.generator(p, bufs, x["inp"], prec, False)
        ema = net.config.get("ema")
        if ema and state["ema"] is not None:
            corr = 1.0 - ema["decay"] ** epochs
            smooth = net.generator({**p, **{k: e / corr for k, e in state["ema"].items()}},
                                   bufs, x["inp"], prec, False)
            if ema["scope"] == "gap":
                hole = ((1 - x["msk"]) * x["vld"]).sum(dim=2, keepdim=True)
                cols = x["vld"].sum(dim=2, keepdim=True).clamp_min(1.0)
                fake = torch.where(hole > 0.98 * cols, smooth, fake)
            else:
                fake = smooth
    return (x["inp"] * x["msk"] + fake * (1 - x["msk"]))[0, 0]
