"""Parity of the PyTorch port's primitives and MRF plain path with the JAX
package on the CPU: the same numpy-seeded inputs and weights through both.

Tolerances: rtol/atol 1e-5 where both sides run the same fp32 math with
sums taken in another order; the bf16 weight storage of pallas_mrf_wide is
held to the 0.02 * max bound of tests/test_pallas_mrf.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.coupling import scaling_and_log_s as jax_scaling
from radtts_tpu.models.hifigan import _resblock1_apply
from radtts_tpu.ops.conv import conv1d_init, conv_norm_apply
from radtts_tpu.ops.fold_norms import fold_norms as jax_fold_norms
from radtts_tpu.ops.invertible import (inv1x1_lus_init, inv1x1_lus_inverse,
                                       precompute_inverses)
from radtts_tpu.ops.length_regulator import regulate_length as jax_regulate
from radtts_tpu.ops.lstm import (bilstm_apply, bilstm_init, lstm_apply,
                                 lstm_cell_init)
from radtts_tpu.ops.norms import masked_instance_norm_apply
from radtts_tpu.ops.pallas_mrf import (pallas_mrf, pallas_mrf_folded,
                                       pallas_mrf_wide)
from radtts_tpu.ops.stft import istft_reim as jax_istft_reim
from radtts_tpu.ops.stft import stft_magnitude_phase as jax_stft_mp
from radtts_tpu.ops.stft import stft_reim as jax_stft_reim

from radtts_tpu_torch import convert
from radtts_tpu_torch.models.coupling import scaling_and_log_s
from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.fold_norms import fold_norms
from radtts_tpu_torch.ops.invertible import InvConv1x1LUS
from radtts_tpu_torch.ops.length_regulator import regulate_length
from radtts_tpu_torch.ops.lstm import MaskedLSTM
from radtts_tpu_torch.ops.mrf import mrf, mrf_plain
from radtts_tpu_torch.ops.norms import masked_instance_norm
from radtts_tpu_torch.ops.stft import (istft_length, istft_reim,
                                       stft_magnitude_phase, stft_reim)

TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    """JAX params -> nested dicts/lists of numpy arrays without _meta."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()
                if k not in ("_meta", "_kind")}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("partial", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dilation", [1, 2])
def test_conv_norm_partial_padding(partial, masked, dilation):
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((3, 11, 6)).astype(np.float32)
    lens = np.array([11, 7, 2])
    mask = np.arange(11)[None] < lens[:, None] if masked else None
    p = np_tree(conv1d_init(jax.random.PRNGKey(dilation), 6, 5, 5,
                            use_weight_norm=True))
    ref = conv_norm_apply(jax_fold_norms(p), jnp.asarray(x), kernel_size=5,
                          dilation=dilation,
                          mask=None if mask is None else jnp.asarray(mask),
                          use_partial_padding=partial)
    conv = ConvNorm(6, 5, 5, dilation=dilation)
    convert._conv(conv, fold_norms(p))
    with torch.no_grad():
        got = conv(_t(x), None if mask is None else _t(mask), partial)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_masked_instance_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4)).astype(np.float32)
    mask = np.arange(9)[None] < np.array([9, 5])[:, None]
    gamma = rng.standard_normal(4).astype(np.float32)
    beta = rng.standard_normal(4).astype(np.float32)
    ref = masked_instance_norm_apply(
        {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)},
        jnp.asarray(x), jnp.asarray(mask))
    got = masked_instance_norm(_t(x), _t(mask), _t(gamma), _t(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lengths", [None, [9, 5, 1]])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_masked_lstm_ragged(lengths, bidirectional):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, 6)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    if bidirectional:
        p = np_tree(bilstm_init(key, 6, 4, norm="spectral"))
    else:
        p = np_tree(lstm_cell_init(key, 6, 4, norm="spectral"))
    lens_j = None if lengths is None else jnp.asarray(lengths)
    if bidirectional:
        ref = bilstm_apply(p, jnp.asarray(x), lens_j)
    else:
        ref, _ = lstm_apply(p, jnp.asarray(x), lens_j)
    mod = MaskedLSTM(6, 4, bidirectional=bidirectional)
    convert._lstm(mod, fold_norms(p))
    with torch.no_grad():
        got = mod(_t(x), None if lengths is None else _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_lus_inverse():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    p = np_tree(inv1x1_lus_init(jax.random.PRNGKey(4), 12))
    ref = inv1x1_lus_inverse(precompute_inverses(p), jnp.asarray(x))
    mod = InvConv1x1LUS(12)
    convert._invertible(mod, p)
    got = mod.inverse(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_length_regulator():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    dur = np.array([[1, 0, 3, 2, 1], [2, 2, 0, 0, 0]], np.int32)
    ref = jax_regulate(jnp.asarray(x), jnp.asarray(dur), 10)
    got = regulate_length(_t(x), _t(dur), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fold_norms():
    key = jax.random.PRNGKey(6)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    tree = np_tree({
        "conv": conv1d_init(k1, 4, 6, 3, use_weight_norm=True),
        "plain": conv1d_init(k2, 4, 6, 3),
        "spectral": bilstm_init(k3, 4, 3, norm="spectral"),
        "weight": lstm_cell_init(k4, 4, 3, norm="weight"),
        "list": [{"table": np.ones((2, 2), np.float32)}],
    })
    ref = jax.tree_util.tree_map(np.asarray, jax_fold_norms(tree))
    got = fold_norms(tree)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, b, **TOL)


def test_stft_round_trip():
    rng = np.random.default_rng(7)
    audio = (0.1 * rng.standard_normal((2, 3000))).astype(np.float32)
    a_j, a_t = jnp.asarray(audio), _t(audio)
    re_j, im_j = jax_stft_reim(a_j)
    re_t, im_t = stft_reim(a_t)
    # unit-scale spectra summed over 1024 taps: 1e-5 of their scale
    atol = 1e-5 * float(np.abs(np.asarray(re_j)).max())
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), atol=atol)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), atol=atol)
    back = np.asarray(jax_istft_reim(re_j, im_j))
    np.testing.assert_allclose(istft_reim(re_t, im_t).numpy(), back, **TOL)
    assert back.shape[-1] == istft_length(audio.shape[-1], 1024, 256)
    mag_j, _ = jax_stft_mp(a_j)
    mag_t, _ = stft_magnitude_phase(a_t)
    np.testing.assert_allclose(mag_t.numpy(), np.asarray(mag_j), atol=atol)


def _mrf_weights(C, seed, std=0.03):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return [{"w1": rnd(3, k, C, C), "b1": rnd(3, C), "w2": rnd(3, k, C, C),
             "b2": rnd(3, C)} for k in (3, 7, 11)]


def _torch_w(w):
    return [{k: _t(v) for k, v in wd.items()} for wd in w]


def _jax_w(w):
    return [{k: jnp.asarray(v) for k, v in wd.items()} for wd in w]


@pytest.mark.parametrize("B,T,C,kind", [
    (1, 200, 128, "pallas_mrf"),
    (2, 300, 64, "pallas_mrf"),
    (2, 512, 32, "folded"),
    (2, 997, 32, "folded"),     # ragged: T % fold != 0
])
def test_mrf_plain_matches_pallas(B, T, C, kind):
    w = _mrf_weights(C, seed=T)
    x = np.random.default_rng(C).standard_normal((B, T, C)).astype(
        np.float32)
    if kind == "folded":
        ref = pallas_mrf_folded(jnp.asarray(x), _jax_w(w), fold=4, tile=32,
                                interpret=True)
    else:
        ref = pallas_mrf(jnp.asarray(x), _jax_w(w), tile=128,
                         interpret=True)
    got = mrf_plain(_t(x), _torch_w(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_mrf_plain_matches_wide_and_resblock_c256():
    T, C = 150, 256
    w = _mrf_weights(C, seed=0, std=0.01)
    x = np.random.default_rng(1).standard_normal((1, T, C)).astype(
        np.float32)
    got = mrf_plain(_t(x), _torch_w(w)).numpy()

    # fp32 reference: the JAX package's plain resblock path
    xs = 0
    for wd, k in zip(w, (3, 7, 11)):
        block = {f"convs{i}": [{"w": jnp.asarray(wd[f"w{i}"][m]),
                                "b": jnp.asarray(wd[f"b{i}"][m])}
                               for m in range(3)] for i in (1, 2)}
        xs = xs + _resblock1_apply(block, jnp.asarray(x), k, (1, 3, 5))
    np.testing.assert_allclose(got, np.asarray(xs / 3), **TOL)

    # the TPU wide kernel stores its weights in bf16: its rounding bound
    wide = np.asarray(pallas_mrf_wide(jnp.asarray(x), _jax_w(w), tile=64,
                                      interpret=True))
    assert np.abs(got - wide).max() < 0.02 * np.abs(wide).max()


def test_mrf_cpu_tensor_takes_plain_path():
    w = _torch_w(_mrf_weights(8, seed=2))
    x = torch.randn(1, 40, 8)
    before = mrf.launches
    torch.testing.assert_close(mrf(x, w), mrf_plain(x, w), rtol=0, atol=0)
    assert mrf.launches == before


@pytest.mark.parametrize("scaling_fn", ["translate", "exp", "tanh",
                                        "sigmoid", ("exp", "tanh")])
def test_scaling_and_log_s(scaling_fn):
    x = np.random.default_rng(8).standard_normal((2, 5, 2)).astype(
        np.float32)
    ref = jax_scaling(jnp.asarray(x), scaling_fn)
    got = scaling_and_log_s(_t(x), scaling_fn)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_mrf_other_device_raises():
    """Only a CPU tensor takes the plain path; any other device launches
    the kernel (CUDA) or raises, never falls back."""
    w = [{k: v.to("meta") for k, v in wd.items()}
         for wd in _torch_w(_mrf_weights(8, seed=2))]
    with pytest.raises(ValueError, match="unsupported device"):
        mrf(torch.empty(1, 40, 8, device="meta"), w)
