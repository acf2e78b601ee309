"""The port's splines (ops/splines.py), couplings (SimpleConvNet, the
simple_conv AffineCoupling, SplineCoupling, SplineAR), plain LSTM,
DenseLayer and the plain-W 1x1's inference inverse against the JAX
package's functions on the CPU, from the same JAX-initialised parameters
and numpy inputs. Every zero-initialised last layer is perturbed, or the
couplings would be identities."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.coupling import (affine_coupling_apply,
                                        affine_coupling_init,
                                        spline_ar_apply, spline_ar_init,
                                        spline_coupling_apply,
                                        spline_coupling_init)
from radtts_tpu.ops import splines as jsp
from radtts_tpu.ops.invertible import (inv1x1_init, inv1x1_inverse,
                                       precompute_inverses)
from radtts_tpu.ops.linear import dense_layer_apply, dense_layer_init
from radtts_tpu.ops.lstm import (lstm_apply, lstm_cell_init,
                                 stacked_lstm_apply, stacked_lstm_init)
from tests.test_torch_synthesizer_parity import np_tree

from radtts_tpu_torch.convert import (_linear, _plain_lstm,
                                      _simple_convnet)
from radtts_tpu_torch.models.coupling import (AffineCoupling, SplineAR,
                                              SplineCoupling)
from radtts_tpu_torch.ops import splines as tsp
from radtts_tpu_torch.ops.invertible import InvConv1x1
from radtts_tpu_torch.ops.linear import DenseLayer
from radtts_tpu_torch.ops.lstm import LSTM

KEY = jax.random.PRNGKey(7)


def rnd(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def perturb_last(pred, seed, sd=0.1):
    """A SimpleConvNet's (zero-initialised) last conv drawn at sd."""
    rng = np.random.default_rng(seed)
    last = pred["last"]
    last["w"] = jnp.asarray(rng.normal(0, sd, last["w"].shape)
                            .astype(np.float32))
    last["b"] = jnp.asarray(rng.normal(0, sd, last["b"].shape)
                            .astype(np.float32))


def near(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=0, atol=atol)


def rel(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


# values inside and outside the spline's range, and on bin edges
X = np.concatenate([np.random.default_rng(1).random(40),
                    [0.0, 0.25, 0.5, 1.0 - 1e-7, -0.2, 1.3]]
                   ).astype(np.float32)


@pytest.mark.parametrize("kind", ["linear", "quadratic"])
def test_splines_match_jax_and_invert(kind):
    """Forward, inverse and log-J within 1e-5 of the JAX functions;
    inverse(forward(x)) within 1e-4 of x inside the range."""
    x = X.reshape(23, 2)
    if kind == "linear":
        q = rnd((23, 2, 6), 2)
        y, lj = tsp.piecewise_linear_forward(torch.from_numpy(x),
                                             torch.from_numpy(q))
        jy, jlj = jsp.piecewise_linear_forward(jnp.asarray(x),
                                               jnp.asarray(q))
        xi, lji = tsp.piecewise_linear_inverse(y, torch.from_numpy(q))
        jxi, jlji = jsp.piecewise_linear_inverse(jnp.asarray(jy),
                                                 jnp.asarray(q))
        near(lji, jlji, 1e-5)
        inside = (x >= 0) & (x <= 1)
    else:
        wt, vt = rnd((23, 2, 5), 3), rnd((23, 2, 6), 4)
        args = [torch.from_numpy(a) for a in (wt, vt)]
        jargs = [jnp.asarray(a) for a in (wt, vt)]
        y, lj = tsp.unbounded_piecewise_quadratic(torch.from_numpy(x), *args)
        jy, jlj = jsp.unbounded_piecewise_quadratic(jnp.asarray(x), *jargs)
        xi, _ = tsp.unbounded_piecewise_quadratic(y, *args, inverse=True)
        jxi, _ = jsp.unbounded_piecewise_quadratic(jnp.asarray(jy), *jargs,
                                                   inverse=True)
        inside = (x >= 0) & (x < 1)
    near(y, jy, 1e-5)
    near(lj, jlj, 1e-5)
    near(xi, jxi, 1e-5)
    np.testing.assert_allclose(xi.numpy()[inside], x[inside], atol=1e-4)
    np.testing.assert_array_equal(xi.numpy()[~inside], x[~inside])


def test_linear_inverse_stops_gradient():
    q = torch.from_numpy(rnd((4, 1, 5), 5)).requires_grad_(True)
    y = torch.rand(4, 1)
    x, lj = tsp.piecewise_linear_inverse(y, q)
    assert not x.requires_grad and lj.requires_grad


def _coupling_case(kind):
    """(JAX params, port module, apply fn) at 4 channels, context 6."""
    if kind == "affine":
        params = affine_coupling_init(KEY, 4, 6, 2,
                                      affine_model="simple_conv",
                                      with_dilation=True, kernel_size=5)
        mod = AffineCoupling(4, 6, 2, affine_model="simple_conv",
                             with_dilation=True, kernel_size=5)
    else:
        params = spline_coupling_init(KEY, 4, 6, 2, with_dilation=True,
                                      kernel_size=3, n_bins=5, left=-3,
                                      right=3, bottom=-3, top=3,
                                      use_quadratic=kind == "quadratic")
        mod = SplineCoupling(4, 6, 2, with_dilation=True, kernel_size=3,
                             n_bins=5, left=-3, right=3, bottom=-3, top=3,
                             use_quadratic=kind == "quadratic")
    perturb_last(params["pred"], 11)
    _simple_convnet(mod.pred, np_tree(params["pred"]))
    return params, mod


@pytest.mark.parametrize("kind", ["affine", "linear", "quadratic"])
def test_couplings_match_jax(kind):
    """The simple_conv affine and the spline couplings, forward (z and
    log_s) and inverse, with a ragged mask: within 1e-4 * max."""
    params, mod = _coupling_case(kind)
    z, ctx = rnd((2, 12, 4), 1, 1.5), rnd((2, 12, 6), 2)
    mask = np.arange(12)[None, :] < np.array([12, 7])[:, None]
    kw = {"scaling_fn": "tanh"} if kind == "affine" else {}
    jfn = affine_coupling_apply if kind == "affine" else spline_coupling_apply
    jz, jls = jfn(params, jnp.asarray(z), jnp.asarray(ctx),
                  mask=jnp.asarray(mask), **kw)
    tz, tls = mod(torch.from_numpy(z), torch.from_numpy(ctx),
                  mask=torch.from_numpy(mask), **kw)
    rel(tz, jz)
    rel(tls, jls)
    jinv = jfn(params, jz, jnp.asarray(ctx), mask=jnp.asarray(mask),
               inverse=True, **kw)
    tinv = mod.inverse(tz, torch.from_numpy(ctx),
                       mask=torch.from_numpy(mask), **kw)
    rel(tinv, jinv)
    rel(tinv, z)


@pytest.mark.parametrize("quadratic", [False, True])
def test_spline_ar_matches_jax(quadratic):
    params = spline_ar_init(KEY, 2, 8, 2, n_bins=4, use_quadratic=quadratic)
    perturb_last(params["pred"], 12)
    mod = SplineAR(2, 8, 2, n_bins=4, use_quadratic=quadratic)
    _simple_convnet(mod.pred, np_tree(params["pred"]))
    z, ctx = rnd((2, 9, 2), 3, 3.0), rnd((2, 9, 8), 4)
    jz, jls = spline_ar_apply(params, jnp.asarray(z), jnp.asarray(ctx))
    tz, tls = mod(torch.from_numpy(z), torch.from_numpy(ctx))
    rel(tz, jz)
    rel(tls, jls)
    jinv = spline_ar_apply(params, jz, jnp.asarray(ctx), inverse=True)
    tinv = mod.inverse(tz, torch.from_numpy(ctx))
    rel(tinv, jinv)


def test_lstm_dense_and_plain_inverse_match_jax():
    """The plain LSTM (one layer with h0/c0 and its final carry; two
    stacked layers over ragged lengths), DenseLayer, and the plain-W 1x1's
    precomputed inverse against the JAX functions."""
    x = rnd((3, 10, 5), 5)
    lens = np.array([10, 6, 3])
    cell = lstm_cell_init(KEY, 5, 7)
    mod = LSTM(5, 7)
    _plain_lstm(mod, [np_tree(cell)])
    h0, c0 = rnd((3, 7), 6), rnd((3, 7), 7)
    jy, (jh, jc) = lstm_apply(cell, jnp.asarray(x), jnp.asarray(lens),
                              h0=jnp.asarray(h0), c0=jnp.asarray(c0))
    ty, [(th, tc)] = mod(torch.from_numpy(x), torch.from_numpy(lens),
                         [(torch.from_numpy(h0), torch.from_numpy(c0))])
    for got, want in ((ty, jy), (th, jh), (tc, jc)):
        rel(got, want, 1e-5)
    stacked = stacked_lstm_init(KEY, 5, 7, 2)
    mod2 = LSTM(5, 7, 2)
    _plain_lstm(mod2, np_tree(stacked)["layers"])
    jy2, jcar = stacked_lstm_apply(stacked, jnp.asarray(x),
                                   jnp.asarray(lens))
    ty2, tcar = mod2(torch.from_numpy(x), torch.from_numpy(lens))
    rel(ty2, jy2, 1e-5)
    for (a, b), (c, d) in zip(tcar, jcar):
        rel(a, c, 1e-5)
        rel(b, d, 1e-5)
    dense = dense_layer_init(KEY, 5, [6, 6])
    dmod = DenseLayer(5, [6, 6])
    for layer, p in zip(dmod.layers, np_tree(dense)["layers"]):
        _linear(layer, p)
    rel(dmod(torch.from_numpy(x)), dense_layer_apply(dense, jnp.asarray(x)),
        1e-5)
    inv = inv1x1_init(KEY, 4)
    imod = InvConv1x1(4, trainable=False)
    with torch.no_grad():
        imod.w1x1.copy_(torch.from_numpy(np.asarray(inv["w1x1"])))
    imod.precompute_inverse()
    y = rnd((2, 6, 4), 8)
    rel(imod.inverse(torch.from_numpy(y)),
        inv1x1_inverse(precompute_inverses(inv), jnp.asarray(y)), 1e-5)


def test_quadratic_inverse_is_well_conditioned():
    """On a near-uniform spline (bins within 1e-3 of equal, so the
    quadratic's leading coefficient is small) the fp32 inverse stays
    within 1e-6 of the float64 one: the port takes the larger root in its
    cancellation-free form."""
    wt, vt = rnd((400, 6), 21, 1e-3), rnd((400, 7), 22, 1e-3)
    y = np.random.default_rng(23).random(400).astype(np.float32)
    got, _ = tsp.unbounded_piecewise_quadratic(
        torch.from_numpy(y), torch.from_numpy(wt), torch.from_numpy(vt),
        inverse=True)
    want, _ = tsp.unbounded_piecewise_quadratic(
        torch.from_numpy(y).double(), torch.from_numpy(wt).double(),
        torch.from_numpy(vt).double(), inverse=True)
    near(got, want.numpy(), 1e-6)


def test_simple_conv_net_runs_outside_cudnn():
    """SimpleConvNet's convolutions run with cuDNN off whether autograd
    records them (training) or not (serving), and the caller's setting is
    back after either."""
    from radtts_tpu_torch.models.coupling import SimpleConvNet

    net = SimpleConvNet(2, 3, 4, n_layers=2)
    seen = []
    net.layers[0].register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.enabled))
    x = torch.from_numpy(rnd((1, 6, 5), 3))
    before = torch.backends.cudnn.enabled
    net(x)
    with torch.no_grad():
        net(x)
    with torch.inference_mode():
        net(x)
    assert seen == [False, False, False]
    assert torch.backends.cudnn.enabled == before
