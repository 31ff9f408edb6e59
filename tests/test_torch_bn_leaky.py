"""Train-mode BatchNorm + LeakyReLU (audio_inpainting_torch/ops/bn_leaky.py)
on the CPU: the entry point against the models' former composition, the
plain formulas that the CUDA kernels implement, the kernels' partition of
a plane, and what stays of the modules (eval mode, state-dict keys).

The kernels themselves run on the card: tests/test_torch_bn_leaky_cuda.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_inpainting_torch.models import Discriminator, GeneratorUNet
from audio_inpainting_torch.models.unet import (BN_EPS, BN_MOMENTUM, LEAKY_SLOPE,
                                                BNLeaky)
from audio_inpainting_torch.ops import bn_leaky

torch.set_num_threads(1)


def _composition(x, weight, bias, running_mean, running_var):
    """models/unet.py's BatchNorm.forward in train mode and the
    F.leaky_relu after it, as the models ran them before the kernels (x
    cast to float32, float64 staying float64)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        running_mean.lerp_(mean, 1.0 - BN_MOMENTUM)
        running_var.lerp_(var, 1.0 - BN_MOMENTUM)
    y = F.batch_norm(x, None, None, weight, bias, True, 0.0, BN_EPS)
    return F.leaky_relu(y, 0.2)


def _inputs(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 1.7 + 0.4).to(dtype)
    weight = 1.0 + 0.3 * torch.randn(c, generator=g)
    bias = 0.2 * torch.randn(c, generator=g)
    running = (0.1 * torch.randn(c, generator=g), 1.0 + torch.rand(c, generator=g))
    return x, weight, bias, running


# N = 1 at one clip's 16 channels and at 3 clips' (groups = 3); N = 2
@pytest.mark.parametrize("shape", [(1, 16, 12, 20), (1, 48, 8, 12), (2, 5, 6, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry_point_is_the_former_composition_on_the_cpu(shape, dtype):
    x, weight, bias, (rm, rv) = _inputs(shape, dtype)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(9))
    outs, grads = [], []
    for fn in (_composition, lambda *a: bn_leaky.bn_leaky_train(
            *a, BN_MOMENTUM, BN_EPS, LEAKY_SLOPE)):
        leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
        stats = [rm.clone(), rv.clone()]
        y = fn(*leaves, *stats)
        y.backward(dy)
        outs.append([y.detach(), *stats])
        grads.append([t.grad for t in leaves])
    for got, want in zip(outs[1] + grads[1], outs[0] + grads[0]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert grads[1][0].dtype == dtype


class _RefFunction(torch.autograd.Function):
    """The kernels' forward and backward formulas as one autograd node."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        y, mean, rstd = bn_leaky.bn_leaky_forward_ref(x, weight, bias, BN_EPS, LEAKY_SLOPE)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        return bn_leaky.bn_leaky_backward_ref(dy, *ctx.saved_tensors, LEAKY_SLOPE)


@pytest.mark.parametrize("shape", [(1, 3, 5, 7), (2, 2, 4, 3)])
def test_backward_formula_passes_gradcheck(shape):
    x, weight, bias, _ = _inputs(shape, seed=3)
    args = [t.double().requires_grad_() for t in (x, weight, bias)]
    assert torch.autograd.gradcheck(_RefFunction.apply, args, eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(1, 16, 12, 20), (2, 5, 6, 7)])
def test_formulas_match_the_composition_in_float64(shape):
    """The plain formulas against autograd of the former composition, both
    in float64: the same function and the same gradients."""
    x, weight, bias, (rm, rv) = _inputs(shape, seed=4)
    leaves = [t.double().requires_grad_() for t in (x, weight, bias)]
    y_want = _composition(*leaves, rm.double(), rv.double())
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    want = torch.autograd.grad(y_want, leaves, dy)
    y, mean, rstd = bn_leaky.bn_leaky_forward_ref(*(t.detach() for t in leaves),
                                                  BN_EPS, LEAKY_SLOPE)
    got = bn_leaky.bn_leaky_backward_ref(dy, *(t.detach() for t in leaves), mean, rstd,
                                         LEAKY_SLOPE)
    torch.testing.assert_close(y, y_want.detach(), atol=1e-12, rtol=1e-12)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10)


def test_bf16_backward_formula_returns_the_input_dtype():
    x, weight, bias, _ = _inputs((1, 4, 6, 8), torch.bfloat16, seed=6)
    y, mean, rstd = bn_leaky.bn_leaky_forward_ref(x, weight, bias, BN_EPS, LEAKY_SLOPE)
    assert y.dtype == torch.float32
    dx, dw, db = bn_leaky.bn_leaky_backward_ref(torch.ones_like(y), x, weight, bias, mean,
                                                rstd, LEAKY_SLOPE)
    assert dx.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32


# every BatchNorm site of the GAN cell at (516, 1728), G = 1 and G = 8, a
# small grid and a ragged one; 132 SMs (an H100 SXM)
SITES = [(16, 516 * 1728), (32, 258 * 864), (64, 129 * 432), (32, 129 * 432),
         (64, 64 * 216), (128, 516 * 1728), (512, 64 * 216), (16, 64 * 128), (3, 63 * 127)]


# the wrapper takes vec = 1 where H * W is not a multiple of 8 or 4
@pytest.mark.parametrize("planes,hw,vec", [(p, hw, v) for p, hw in SITES for v in (8, 4, 1)
                                           if hw % v == 0])
def test_partition_covers_each_plane_once(planes, hw, vec):
    k, L = bn_leaky.partition(hw, planes, vec, 132)
    assert L % vec == 0 and (k - 1) * L < hw <= k * L
    per_block = bn_leaky.THREADS * vec
    assert k <= -(-hw // per_block)
    if hw >= bn_leaky.BLOCKS_PER_SM * 132 * per_block:
        assert planes * k >= bn_leaky.BLOCKS_PER_SM * 132
    assert bn_leaky.partition(hw, planes, vec, 132) == (k, L)


def test_kernel_wrappers_raise_off_the_card():
    x, weight, bias, (rm, rv) = _inputs((1, 4, 6, 8))
    with pytest.raises(ValueError, match="run on cuda"):
        bn_leaky.bn_leaky_forward_cuda(x, weight, bias, rm, rv, 0.1, BN_EPS, LEAKY_SLOPE)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn_leaky.bn_leaky_forward_cuda(x.half(), weight, bias, rm, rv, 0.1, BN_EPS,
                                       LEAKY_SLOPE)


def test_eval_mode_normalizes_with_the_running_averages():
    x, weight, bias, (rm, rv) = _inputs((1, 6, 5, 9), torch.bfloat16, seed=7)
    bn = BNLeaky(6)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(rm)
        bn.running_var.copy_(rv)
        got = bn(x, False)
    want = F.leaky_relu(F.batch_norm(x.float(), rm, rv, weight, bias, False, 0.0, BN_EPS),
                        0.2)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)


@pytest.mark.parametrize("groups", [1, 2])
def test_batchnorm_state_dict_keys_are_unchanged(groups):
    g_keys = [k for k in GeneratorUNet(groups=groups).state_dict() if ".bn" in k]
    d_keys = [k for k in Discriminator(groups=groups).state_dict() if k.startswith("bn")]
    fields = ("weight", "bias", "running_mean", "running_var")
    assert g_keys == [f"block{i}.bn{j}.{f}" for i in range(5) for j in (0, 1) for f in fields]
    assert d_keys == [f"bn{j}.{f}" for j in (0, 1) for f in fields]
    sd = GeneratorUNet(groups=groups).state_dict()
    assert sd["block2.bn1.running_var"].shape == (64 * groups,)


def test_generator_train_forward_on_the_cpu_is_the_former_composition():
    """A whole generator and discriminator in train mode on the CPU: the
    same outputs and running averages as the former composition."""
    torch.manual_seed(0)
    nets = [GeneratorUNet(generator=torch.Generator().manual_seed(1)),
            Discriminator(generator=torch.Generator().manual_seed(2))]
    x = torch.randn(1, 1, 32, 64, generator=torch.Generator().manual_seed(3))
    for net in nets:
        twin = type(net)()
        twin.load_state_dict(net.state_dict())
        for mod in twin.modules():
            if isinstance(mod, BNLeaky):
                mod.forward = (lambda m: lambda t, train: _composition(
                    t, m.weight, m.bias, m.running_mean, m.running_var))(mod)
        got, want = net(x, True), twin(x, True)
        assert torch.equal(got, want)
        for (k, a), b in zip(net.state_dict().items(), twin.state_dict().values()):
            assert torch.equal(a, b), k
    assert np.isfinite(got.detach().numpy()).all()
