"""Gaussian-process audio inpainting, in torch.

Reference behavior (main1_gp.py:73-111, as in
audio_inpainting_tpu/methods/gp.py): composite kernel
``1.0 * RBF(0.002) * ExpSineSquared(length_scale=1.0, periodicity=0.005)
+ WhiteKernel(0.01)`` with sklearn's bounds, ``n_restarts_optimizer=5``,
``normalize_y=True``; the posterior mean fills the missing samples.

The marginal likelihood is fitted for every restart at once: the
(restarts, n, n) kernels, their Cholesky factors and the gradients
(autograd through ``torch.linalg.cholesky_ex``) are batched, and the
optimizer is a batched L-BFGS written here after optax's ``lbfgs`` with
``scale_by_zoom_linesearch`` (memory 10, zoom line search capped at
``max_linesearch_steps`` evaluations), as the JAX package runs it vmapped
over the restarts. Hyperparameters live in log space behind a sigmoid onto
sklearn's bounds. The restart inits come from ``_draw_restarts``, which
tests replace with the JAX package's own draws.

One difference from the JAX package: where the fitted hyperparameters
leave the full kernel matrix not positive definite in float32, the
posterior retries at a raised jitter (``_predict``) instead of returning
NaN.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import as_f32, resolve_device

# L-BFGS memory: optax.lbfgs's default
_MEMORY = 10
# tenfold raises of the jitter the posterior may try (see _predict)
_JITTER_RETRIES = 3


@dataclass(frozen=True)
class GPConfig:
    # initial values and (low, high) bounds (main1_gp.py:80-85)
    const: float = 1.0
    const_bounds: tuple = (1e-5, 1e5)
    rbf_ls: float = 0.002
    rbf_bounds: tuple = (1e-5, 1e-2)
    per_ls: float = 1.0
    per_ls_bounds: tuple = (1e-5, 1e5)
    period: float = 0.005
    period_bounds: tuple = (1e-4, 1e-2)
    noise: float = 0.01
    noise_bounds: tuple = (1e-5, 1e5)
    n_restarts: int = 5
    # L-BFGS steps and the cap on each step's line-search evaluations
    opt_steps: int = 20
    max_linesearch_steps: int = 6
    # fit the hyperparameters on every k-th training sample (the posterior
    # still uses all of them): each likelihood evaluation is O(n^3)
    fit_subsample: int = 4
    # diagonal floor, scaled by the kernel amplitude: a float32 Cholesky
    # fails once the condition number (~c/noise) passes ~1e7 (sklearn adds
    # 1e-10 in float64)
    jitter: float = 1e-6


def _bounds(cfg: GPConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    pairs = (cfg.const_bounds, cfg.rbf_bounds, cfg.per_ls_bounds,
             cfg.period_bounds, cfg.noise_bounds)
    lo = torch.tensor([p[0] for p in pairs], dtype=torch.float32, device=device)
    hi = torch.tensor([p[1] for p in pairs], dtype=torch.float32, device=device)
    return lo.log(), hi.log()


def _theta0(cfg: GPConfig, device) -> torch.Tensor:
    return torch.tensor([cfg.const, cfg.rbf_ls, cfg.per_ls, cfg.period,
                         cfg.noise], dtype=torch.float32, device=device).log()


def _to_theta(u: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Unconstrained parameters -> log-hyperparameters inside the bounds."""
    return lo + (hi - lo) * torch.sigmoid(u)


def _from_theta(theta: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    frac = torch.clamp((theta - lo) / (hi - lo), 1e-4, 1 - 1e-4)
    return frac.log() - torch.log1p(-frac)


def _kernel(theta: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """c * RBF(l) * ExpSineSquared(l_p, p) on |x1 - x2| (no white term).

    theta: (5,) or (R, 5) log-hyperparameters; returns (n1, n2) or
    (R, n1, n2).
    """
    p = theta.exp()
    c, l_rbf, l_per, period = (p[..., i, None, None] for i in range(4))
    d = x1[:, None] - x2[None, :]
    rbf = torch.exp(-0.5 * (d / l_rbf) ** 2)
    ess = torch.exp(-2.0 * (torch.sin(math.pi * d.abs() / period) / l_per) ** 2)
    return c * rbf * ess


def _noise_diag(theta: torch.Tensor, jitter: float) -> torch.Tensor:
    """The white term plus the jitter floor, noise + jitter * (1 + c)."""
    p = theta.exp()
    return p[..., 4] + jitter * (1.0 + p[..., 0])


def _neg_mll(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             jitter: float) -> torch.Tensor:
    """Negative log marginal likelihood of each row of theta (R, 5) -> (R,);
    NaN where the kernel matrix is not positive definite in float32."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = _kernel(theta, x, x) + _noise_diag(theta, jitter)[:, None, None] * eye
    chol, info = torch.linalg.cholesky_ex(k)
    alpha = torch.cholesky_solve(y[:, None].expand(theta.shape[0], n, 1), chol)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    val = 0.5 * (alpha @ y) + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)
    return torch.where(info == 0, val, torch.nan)


# --- batched L-BFGS with optax's zoom line search -------------------------
#
# Every tensor below has one row per problem. Each row runs the algorithm
# of optax.lbfgs(linesearch=optax.scale_by_zoom_linesearch(max_ls)) on its
# own, as jax.vmap runs it in the JAX package: a row's line search stops
# when its own criteria hold, and the loop ends when every row's has.

_SLOPE_RTOL = 1e-4      # Armijo constant c1
_CURV_RTOL = 0.9        # curvature constant c2
_APPROX_DEC_RTOL = 1e-6  # Hager-Zhang approximate-decrease switch
_INTERVAL_MIN = 1e-5    # stepsize_precision


def _where(cond, a, b):
    return torch.where(cond[:, None] if a.ndim == 2 else cond, a, b)


def _value_and_grad(fun, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row values and gradients of ``fun``; NaN gradients where the
    value is NaN."""
    with torch.enable_grad():
        u = u.detach().requires_grad_(True)
        v = fun(u)
        (g,) = torch.autograd.grad(v.sum(), u)
    v = v.detach()
    return v, torch.where(torch.isnan(v)[:, None], torch.nan, g)


def _decrease_error(step, value, slope, value_init, slope_init):
    """Armijo error, or the approximate-decrease error near a minimum;
    0 when satisfied, inf for NaN."""
    armijo = value - value_init - _SLOPE_RTOL * step * slope_init
    approx = torch.maximum(slope - (2 * _SLOPE_RTOL - 1.0) * slope_init,
                           value - value_init - _APPROX_DEC_RTOL * value_init.abs())
    err = torch.clamp_min(torch.minimum(approx, armijo), 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _curvature_error(slope, slope_init):
    err = torch.clamp_min(slope.abs() - _CURV_RTOL * slope_init.abs(), 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * rb - db ** 2 * rc) / denom
    B = (-(dc ** 3) * rb + db ** 3 * rc) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _zoom_linesearch(fun, u, d, value, grad, guess, max_steps):
    """Per-row step sizes along ``d`` (Nocedal & Wright alg. 3.5 / 3.6,
    as optax.zoom_linesearch). Returns (stepsize, value, grad) at the step."""
    slope0 = (d * grad).sum(-1)
    zeros = torch.zeros_like(value)
    s = dict(step=zeros, value=value, grad=grad, slope=slope0,
             interval=zeros.bool(), done=zeros.bool(), failed=zeros.bool(),
             low=zeros, v_low=value, s_low=slope0,
             high=zeros, v_high=value, s_high=slope0,
             cubic=zeros, v_cubic=value,
             safe=zeros, v_safe=value, g_safe=grad)
    for i in range(max_steps):
        active = ~(s["done"] | s["failed"])
        if not bool(active.any()):
            break
        # zoom: a point inside [low, high] by cubic, else quadratic, else
        # bisection interpolation
        low, high = s["low"], s["high"]
        delta = (high - low).abs()
        left, right = torch.minimum(low, high), torch.maximum(low, high)
        mc = _cubicmin(low, s["v_low"], s["s_low"], high, s["v_high"],
                       s["cubic"], s["v_cubic"])
        use_c = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, s["v_low"], s["s_low"], high, s["v_high"])
        use_q = ~use_c & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
        middle = torch.where(use_c, mc, torch.where(use_q, mq, (low + high) / 2.0))
        # interval search: the guess first, then doubling
        larger = guess if i == 0 else 2.0 * s["step"]
        new_step = torch.where(s["interval"], middle, larger)

        v, g = _value_and_grad(fun, u + new_step[:, None] * d)
        slope = (g * d).sum(-1)
        dec = _decrease_error(new_step, v, slope, value, slope0)
        err = torch.maximum(dec, _curvature_error(slope, slope0))
        done = err <= 0.0
        ok_dec = dec <= 0.0
        out_of_steps = i + 1 >= max_steps

        # -- the interval search's transition --
        high_new = (dec > 0.0) | ((v >= s["value"]) & (i > 0))
        low_new = (slope >= 0.0) & ~high_new
        sr = dict(
            low=torch.where(low_new, new_step, s["step"]),
            v_low=torch.where(low_new, v, s["value"]),
            s_low=torch.where(low_new, slope, s["slope"]),
            high=torch.where(low_new, s["step"], new_step),
            v_high=torch.where(low_new, s["value"], v),
            s_high=torch.where(low_new, s["slope"], slope),
            interval=high_new | low_new | done,
            safe=torch.where(ok_dec, new_step, s["safe"]),
            v_safe=torch.where(ok_dec, v, s["v_safe"]),
            g_safe=_where(ok_dec, g, s["g_safe"]))
        sr["cubic"], sr["v_cubic"] = sr["low"], sr["v_low"]
        sr["failed"] = out_of_steps & ~done

        # -- the zoom's transition --
        upd_safe = ok_dec & (v < s["v_safe"])
        h_mid = (dec > 0.0) | (v >= s["v_low"])
        h_low = (slope * (high - low) >= 0.0) & ~h_mid
        l_mid = ~h_mid
        sz = dict(
            high=torch.where(h_low, low, torch.where(h_mid, middle, high)),
            v_high=torch.where(h_low, s["v_low"], torch.where(h_mid, v, s["v_high"])),
            s_high=torch.where(h_low, s["s_low"], torch.where(h_mid, slope, s["s_high"])),
            low=torch.where(l_mid, middle, low),
            v_low=torch.where(l_mid, v, s["v_low"]),
            s_low=torch.where(l_mid, slope, s["s_low"]),
            cubic=torch.where(h_mid | h_low, high, low),
            v_cubic=torch.where(h_mid | h_low, s["v_high"], s["v_low"]),
            interval=s["interval"],
            safe=torch.where(upd_safe, middle, s["safe"]),
            v_safe=torch.where(upd_safe, v, s["v_safe"]),
            g_safe=_where(upd_safe, g, s["g_safe"]))
        small = (delta <= _INTERVAL_MIN) & (sz["safe"] > 0.0)
        sz["failed"] = (out_of_steps | small) & ~done

        new = {k: _where(s["interval"], sz[k], sr[k]) for k in sr}
        new.update(step=new_step, value=v, grad=g, slope=slope, done=done)
        # a failed search falls back to the best step with sufficient
        # decrease, or to the start where every step left the domain
        use_safe = new["failed"] & ((new["safe"] > 0.0) | torch.isinf(dec))
        new["step"] = torch.where(use_safe, new["safe"], new["step"])
        new["value"] = torch.where(use_safe, new["v_safe"], new["value"])
        new["grad"] = _where(use_safe, new["g_safe"], new["grad"])
        s = {k: _where(active, new[k], s[k]) for k in s}
    return s["step"], s["value"], s["grad"]


def lbfgs_minimize(fun, u0: torch.Tensor, n_steps: int,
                   max_linesearch_steps: int = 6) -> torch.Tensor:
    """Minimize every row of ``u0`` (R, d) by ``n_steps`` L-BFGS steps.

    ``fun`` maps (R, d) to (R,) values, row by row, differentiable by
    autograd. Each row follows optax.lbfgs(linesearch=
    optax.scale_by_zoom_linesearch(max_linesearch_steps)): the two-loop
    recursion over the last ``_MEMORY`` pairs, the first step's scale
    capped at 1/|g|, and the line search's first guess the last accepted
    step.
    """
    u = u0
    memory = _MEMORY
    R, dim = u.shape
    S = u.new_zeros((memory, R, dim))           # parameter differences
    Y = u.new_zeros((memory, R, dim))           # gradient differences
    rho = u.new_zeros((memory, R))
    prev_u = prev_g = None
    lr = torch.ones_like(u[:, 0])
    value = torch.full_like(u[:, 0], torch.inf)
    grad = torch.zeros_like(u)
    for k in range(n_steps):
        # optax.value_and_grad_from_state: the line search's last value and
        # gradient, recomputed where they are not finite
        stale = torch.isinf(value) | torch.isnan(value)
        if bool(stale.any()):
            v, g = _value_and_grad(fun, u)
            value, grad = torch.where(stale, v, value), _where(stale, g, grad)
        if k == 0:
            gamma = torch.clamp_max(1.0 / grad.norm(dim=-1), 1.0)
        else:
            ds, dy = u - prev_u, grad - prev_g
            sy = (dy * ds).sum(-1)
            yy = (dy * dy).sum(-1)
            slot = (k - 1) % memory
            S[slot], Y[slot] = ds, dy
            rho[slot] = torch.where(sy == 0.0, 0.0, 1.0 / sy)
            gamma = torch.where(yy > 0.0, sy / yy, 1.0)
        prev_u, prev_g = u, grad
        # two-loop recursion, newest pair first
        order = [(k + j) % memory for j in range(memory)]
        q = grad
        alphas = {}
        for j in reversed(order):
            alphas[j] = rho[j] * (S[j] * q).sum(-1)
            q = q - alphas[j][:, None] * Y[j]
        q = gamma[:, None] * q
        for j in order:
            beta = rho[j] * (Y[j] * q).sum(-1)
            q = q + (alphas[j] - beta)[:, None] * S[j]
        d = -q
        lr, value, grad = _zoom_linesearch(fun, u, d, value, grad, lr,
                                           max_linesearch_steps)
        u = u + lr[:, None] * d
    return u


def _draw_restarts(seed: int, n: int, device) -> torch.Tensor:
    """Uniform [0, 1) draws (n, 5) placing the restarts inside the bounds,
    from a CPU generator seeded with ``seed``: the same on every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n, 5), generator=gen).to(device)


def _restarts(x: torch.Tensor, y: torch.Tensor, cfg: GPConfig, seed: int):
    """(u0, loss, to_theta): the restarts' unconstrained starting points
    (n_restarts + 1, 5), the initial values first, the negative marginal
    likelihood of a batch of them, and their map to log-theta."""
    lo, hi = _bounds(cfg, x.device)
    rand = _draw_restarts(seed, cfg.n_restarts, x.device)
    u0 = torch.cat([_from_theta(_theta0(cfg, x.device), lo, hi)[None],
                    _from_theta(lo + (hi - lo) * rand, lo, hi)])

    def loss(u):
        return _neg_mll(_to_theta(u, lo, hi), x, y, cfg.jitter)

    return u0, loss, lambda u: _to_theta(u, lo, hi)


def _fit(x: torch.Tensor, y: torch.Tensor, cfg: GPConfig, seed: int) -> torch.Tensor:
    """Maximize the marginal likelihood from the initial values and
    ``n_restarts`` random starts at once; return the best log-theta (5,)."""
    u0, loss, to_theta = _restarts(x, y, cfg, seed)
    u = lbfgs_minimize(loss, u0, cfg.opt_steps, cfg.max_linesearch_steps)
    return to_theta(u[torch.argmin(finite_or_inf(loss(u)))])


def finite_or_inf(losses: torch.Tensor) -> torch.Tensor:
    """Final losses with NaN and -inf as +inf: a restart that left the
    domain never wins."""
    return torch.where(torch.isfinite(losses), losses, torch.inf)


def _predict(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             x_star: torch.Tensor, cfg: GPConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and std at ``x_star`` for fixed log-theta (5,).

    The fit may end near the noise bound on hyperparameters that are
    positive definite on the fit's subsample but, in float32, not on all
    the samples (the JAX package's posterior is NaN there). Then the
    jitter is raised tenfold, up to ``_JITTER_RETRIES`` times, before the
    factorization is given up.
    """
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k_xx = _kernel(theta, x, x)
    for retry in range(_JITTER_RETRIES + 1):
        diag = _noise_diag(theta, cfg.jitter * 10.0 ** retry)
        chol, info = torch.linalg.cholesky_ex(k_xx + diag * eye)
        if int(info) == 0:
            break
    else:
        raise torch.linalg.LinAlgError(
            f"GP kernel matrix not positive definite at jitter "
            f"{cfg.jitter * 10.0 ** _JITTER_RETRIES:g}")
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    k_star = _kernel(theta, x_star, x)               # (m, n)
    mu = k_star @ alpha
    v = torch.linalg.solve_triangular(chol, k_star.T, upper=False)
    # the prior diagonal includes the white term, like sklearn's kernel_.diag
    p = theta.exp()
    var = torch.clamp_min(p[0] + p[4] - (v * v).sum(0), 1e-12)
    return mu, var.sqrt()


def gp_fit_predict(x_train, y_train, x_test, cfg: GPConfig = GPConfig(),
                   seed: int = 0, device=None):
    """Fit hyperparameters (restarts batched) and return (mu, std, theta)
    as tensors on the device.

    normalize_y=True semantics: y is standardized for fitting and the
    posterior un-standardized (sklearn GaussianProcessRegressor).
    """
    return fit_predict_with(lambda x, y: _fit(x, y, cfg, seed), x_train, y_train,
                            x_test, cfg, device)


def fit_predict_with(fit, x_train, y_train, x_test, cfg: GPConfig, device=None):
    """``gp_fit_predict`` with ``fit(x, y)`` -> log-theta (5,) as the
    hyperparameter fit on the standardized, subsampled training data
    (parallel/engines.py splits the restarts over ranks)."""
    x_train = as_f32(x_train, device)
    y_train = as_f32(y_train, x_train.device)
    x_test = as_f32(x_test, x_train.device)
    y_mean = y_train.mean()
    y_std = torch.clamp_min(y_train.std(correction=0), 1e-12)
    y_n = (y_train - y_mean) / y_std
    k = max(1, int(cfg.fit_subsample))
    with torch.no_grad():
        theta = fit(x_train[::k], y_n[::k])
        mu, std = _predict(theta, x_train, y_n, x_test, cfg)
    return mu * y_std + y_mean, std * y_std, theta


def gp_restore(signal, mask, sr: int, cfg: GPConfig = GPConfig(),
               seed: int = 0, device=None) -> tuple[np.ndarray, np.ndarray]:
    """Restore the masked samples of a (short) segment by the GP posterior
    mean, on ``device`` (cuda by default).

    Returns host numpy (restored signal, posterior std on the missing
    samples), the reference's restore_with_gaussian_process contract
    (main1_gp.py:73-111).
    """
    dev = resolve_device(device)
    signal = np.asarray(signal, np.float32)
    mask = np.asarray(mask, bool)
    t = np.arange(len(signal), dtype=np.float32) / sr
    mu, std, _ = gp_fit_predict(t[mask], signal[mask], t[~mask], cfg, seed, dev)
    restored = signal.copy()
    restored[~mask] = mu.cpu().numpy()
    return restored, std.cpu().numpy()
