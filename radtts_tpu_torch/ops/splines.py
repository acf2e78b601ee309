"""Piecewise-linear and piecewise-quadratic monotone spline transforms of
the spline couplings (radtts_tpu/ops/splines.py).

Branch-free, as the JAX package writes them: a bin is found by counting
comparisons, never by searchsorted, and out-of-range values are selected
with `where`, never by boolean compression, so every shape is static.
x is element-wise over leading dims; bin parameters are on the last axis.
"""

import numpy as np
import torch
import torch.nn.functional as F

from radtts_tpu_torch.debug import check_finite

_EPS32 = float(np.finfo(np.float32).eps)


def _take(a, idx):
    """a[..., idx] per element: a (..., K), idx (...) int64 -> (...)."""
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _left_edges(q, w):
    """The cumulative bin edges [0, w*q_0, w*(q_0+q_1), ...] without the
    last one."""
    q_left = torch.cumsum(q, dim=-1) * w
    return torch.cat([torch.zeros_like(q_left[..., :1]), q_left[..., :-1]],
                     dim=-1)


def piecewise_linear_forward(x, q_tilde):
    """x: (N, k) in [0, 1]; q_tilde: (N, k, b) unnormalized bin heights.
    Returns (y, log_j) with log_j summed over k: (N,)."""
    x = check_finite(x, "piecewise_linear_forward bin input")
    b = q_tilde.shape[-1]
    w = 1.0 / b
    q = torch.softmax(q_tilde, dim=-1) / w
    # a NaN input takes bin 0, as XLA's float-to-int conversion gives it
    # (the debug sentinel above is what reports it)
    mx = torch.clamp(torch.nan_to_num(torch.floor(b * x), nan=0.0), 0,
                     b - 1).to(torch.int64)
    alpha = x - mx * w
    slopes = _take(q, mx)
    out = alpha * slopes + _take(_left_edges(q, w), mx)
    out = torch.clamp(out, _EPS32, 1.0 - _EPS32)
    oob = (x < 0.0) | (x > 1.0)
    out = torch.where(oob, x, out)
    slopes = torch.where(oob, torch.ones_like(slopes), slopes)
    return out, torch.log(slopes).sum(1)


def piecewise_linear_inverse(y, q_tilde):
    """Inverse of piecewise_linear_forward: (x, log_j). x carries no
    gradient (the JAX package stops it)."""
    y = check_finite(y, "piecewise_linear_inverse bin input")
    b = q_tilde.shape[-1]
    w = 1.0 / b
    q = torch.softmax(q_tilde, dim=-1) / w
    q_left = _left_edges(q, w)
    gap = y[..., None] - q_left
    gap = torch.where(gap < 0, torch.full_like(gap, 2.0), gap)
    edges = torch.clamp(torch.argmin(gap, dim=-1), 0, b - 1)
    qli = _take(q_left, edges)
    slope = _take(q, edges)
    x = (y - qli) / slope + edges * w
    x = torch.clamp(x, _EPS32, 1.0 - _EPS32)
    oob = (y < 0.0) | (y > 1.0)
    x = torch.where(oob, y, x)
    slope = torch.where(oob, torch.ones_like(slope), slope)
    return x.detach(), -torch.log(slope).sum(1)


def _weighted_softmax(v, w):
    v = v - v.max(dim=-1, keepdim=True).values
    v = torch.exp(v) + 1e-8
    v_sum = ((v[..., :-1] + v[..., 1:]) / 2 * w).sum(-1, keepdim=True)
    return v / v_sum


def _last_to_one(a):
    return torch.cat([a[..., :-1], torch.ones_like(a[..., -1:])], dim=-1)


def piecewise_quadratic(x, w_tilde, v_tilde, inverse=False):
    """Monotone quadratic spline on [0, 1) (the Neural Importance Sampling
    parametrization). x: (...,); w_tilde: (..., K); v_tilde: (..., K+1).
    Returns (y, log_j); log_j is None for the inverse."""
    x = check_finite(x, "piecewise_quadratic bin input")
    eps = _EPS32
    w = torch.softmax(w_tilde, dim=-1)
    v = _weighted_softmax(v_tilde, w)
    w_cumsum = _last_to_one(torch.cumsum(w, dim=-1))
    w_cumsum_shift = F.pad(w_cumsum, (1, 0))
    cdf = _last_to_one(torch.cumsum((v[..., 1:] + v[..., :-1]) / 2 * w,
                                    dim=-1))
    cdf_shift = F.pad(cdf, (1, 0))

    K = w.shape[-1]
    ref = cdf if inverse else w_cumsum
    # searchsorted(ref, x, right=False): the first bin with ref >= x
    bin_index = (ref < x[..., None]).sum(-1).clamp(0, K - 1)
    w_b = _take(w, bin_index)
    w_bn1 = _take(w_cumsum_shift, bin_index)
    v_b = _take(v, bin_index)
    v_bp1 = _take(v, bin_index + 1)
    cdf_bn1 = _take(cdf_shift, bin_index)

    if not inverse:
        alpha = (x - w_bn1) / torch.clamp(w_b, min=eps)
        c = (alpha ** 2) / 2 * (v_bp1 - v_b) * w_b + alpha * v_b * w_b \
            + cdf_bn1
        log_j = torch.log(torch.clamp(v_b + alpha * (v_bp1 - v_b), min=eps))
        return torch.clamp(c, eps, 1.0 - eps), log_j
    a = (v_bp1 - v_b) * w_b / 2
    bb = v_b * w_b
    cc = cdf_bn1 - x
    sqrt_disc = torch.sqrt(torch.clamp(bb * bb - 4 * a * cc, min=0.0))
    # the larger root, (-bb + sqrt_disc) / 2a, in its cancellation-free
    # form -2cc / (bb + sqrt_disc): equal in exact arithmetic, but where a
    # is small (a near-uniform spline) the first loses most of its digits
    # to the subtraction; the linear solution where a ~ 0, as in the JAX
    # package
    small = a.abs() < 1e-12
    alpha_quad = -2 * cc / torch.clamp(bb + sqrt_disc, min=eps)
    alpha_lin = -cc / torch.clamp(bb, min=eps)
    alpha = torch.where(small, alpha_lin, alpha_quad)
    return torch.clamp(alpha * w_b + w_bn1, eps, 1.0 - eps), None


def unbounded_piecewise_quadratic(x, w_tilde, v_tilde, upper=1.0, lower=0.0,
                                  inverse=False):
    """Identity outside [lower, upper), the quadratic spline inside.
    Returns (y, log_j); log_j is None for the inverse."""
    _range = upper - lower
    inside = (x >= lower) & (x < upper)
    x_norm = torch.clamp((x - lower) / _range, 0.0, 1.0 - _EPS32)
    y_in, log_j_in = piecewise_quadratic(x_norm, w_tilde, v_tilde,
                                         inverse=inverse)
    y = torch.where(inside, y_in * _range + lower, x)
    if inverse:
        return y, None
    return y, torch.where(inside, log_j_in, torch.zeros_like(log_j_in))


def spline_transform(z, q_tilde, n_bins, use_quadratic, inverse):
    """The spline couplings' transform of z (N, c) by q_tilde (N, c,
    n_bins): (y, log_s) with log_s per channel (quadratic), summed over
    channels (linear forward) or None (inverse)."""
    if use_quadratic:
        return unbounded_piecewise_quadratic(
            z, q_tilde[..., : n_bins // 2], q_tilde[..., n_bins // 2:],
            inverse=inverse)
    if inverse:
        return piecewise_linear_inverse(z, q_tilde)
    return piecewise_linear_forward(z, q_tilde)
