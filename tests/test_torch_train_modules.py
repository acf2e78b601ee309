"""The training forms of the port's modules against the JAX package's
functions on the CPU, from the same JAX-initialised parameters and numpy
inputs: ConvAttention, the affine coupling forward with log_s, the LU and
plain invertible 1x1 forwards with log|det|, the weight-normed conv, the
spectral-normed LSTM and its power iteration; and the dropout generator."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.attention import (conv_attention_apply,
                                         conv_attention_init)
from radtts_tpu.models.coupling import (affine_coupling_apply,
                                        affine_coupling_init)
from radtts_tpu.ops.conv import conv1d_init, conv_norm_apply
from radtts_tpu.ops.invertible import (inv1x1_forward, inv1x1_init,
                                       inv1x1_lus_forward, inv1x1_lus_init)
from radtts_tpu.ops.lstm import bilstm_apply, bilstm_init
from radtts_tpu.ops.lstm import spectral_norm_update as jax_sn_update
from tests.test_torch_synthesizer_parity import np_tree

from radtts_tpu_torch.convert import _attention, _conv, _invertible, _lstm
from radtts_tpu_torch.models.attention import ConvAttention
from radtts_tpu_torch.models.coupling import AffineCoupling
from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.dropout import dropout
from radtts_tpu_torch.ops.invertible import InvConv1x1, InvConv1x1LUS
from radtts_tpu_torch.ops.lstm import MaskedLSTM, spectral_norm_update

KEY = jax.random.PRNGKey(3)


def rnd(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_conv_attention_matches_jax():
    """attn (softmax over the valid tokens) and attn_logprob with a prior,
    ragged text lengths; 1e-5 relative (fp32 convs and a matmul summed in
    another order)."""
    params = conv_attention_init(KEY, 20, 24)
    mod = ConvAttention(20, 24)
    _attention(mod, np_tree(params))
    mel, keys = rnd((2, 30, 20), 1), rnd((2, 9, 24), 2)
    in_lens = np.array([9, 5])
    prior = np.random.default_rng(3).random((2, 30, 9)).astype(np.float32)
    for p in (None, prior):
        want, want_lp = conv_attention_apply(
            params, jnp.asarray(mel), jnp.asarray(keys), jnp.asarray(in_lens),
            attn_prior=None if p is None else jnp.asarray(p))
        got, got_lp = mod(torch.from_numpy(mel), torch.from_numpy(keys),
                          torch.from_numpy(in_lens),
                          None if p is None else torch.from_numpy(p))
        close(got, want)
        close(got_lp, want_lp)
        assert float(got[1, :, 5:].abs().max()) == 0.0


@pytest.mark.parametrize("scaling_fn", ["tanh", "exp"])
def test_affine_coupling_forward_matches_jax(scaling_fn):
    """(z, log_s) of the forward with the weight-normed WN, partial padding
    and a ragged mask; the end conv perturbed (it is zero at init)."""
    params = affine_coupling_init(KEY, 10, 7, 2, affine_model="wavenet",
                                  n_hidden=16)
    params["pred"]["end"]["w"] = jnp.asarray(rnd((1, 16, 10), 4, 0.1))
    mod = AffineCoupling(10, 7, 2, "wavenet", 16, factored=True)
    tree = np_tree(params)["pred"]
    for name in ("start", "end"):
        _conv(getattr(mod.pred, name), tree[name])
    for layers, key in ((mod.pred.in_layers, "in_layers"),
                        (mod.pred.res_skip, "res_skip")):
        for conv, cp in zip(layers, tree[key]):
            _conv(conv, cp)
    assert mod.pred.start.weight_norm and "v" in tree["start"]
    z, ctx = rnd((2, 15, 10), 5), rnd((2, 15, 7), 6)
    mask = np.arange(15)[None, :] < np.array([15, 9])[:, None]
    want_z, want_ls = affine_coupling_apply(
        params, jnp.asarray(z), jnp.asarray(ctx), scaling_fn=scaling_fn,
        mask=jnp.asarray(mask), use_partial_padding=True)
    got_z, got_ls = mod(torch.from_numpy(z), torch.from_numpy(ctx),
                        scaling_fn=scaling_fn, mask=torch.from_numpy(mask),
                        use_partial_padding=True)
    close(got_z, want_z)
    close(got_ls, want_ls)
    # and the inverse undoes it
    back = mod.inverse(got_z, torch.from_numpy(ctx), scaling_fn=scaling_fn,
                       mask=torch.from_numpy(mask))
    np.testing.assert_allclose(back.detach().numpy(), z, atol=1e-5)


def test_lus_forward_and_log_det_match_jax():
    params = inv1x1_lus_init(KEY, 12)
    tree = np_tree(params)
    tree["upper_diag"] = tree["upper_diag"] * 1.7     # |det| away from 1
    mod = InvConv1x1LUS(12, trainable=True)
    _invertible(mod, tree)
    x = rnd((2, 7, 12), 7)
    want, want_ld = inv1x1_lus_forward(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))
    got, got_ld = mod(torch.from_numpy(x))
    close(got, want)
    np.testing.assert_allclose(float(got_ld), float(want_ld), rtol=1e-6)
    assert {n for n, _ in mod.named_parameters()} == {"lower", "upper",
                                                      "upper_diag"}
    folded = mod.folded()
    np.testing.assert_allclose(folded.inverse(got).detach().numpy(), x,
                               atol=1e-5)


def test_plain_invertible_forward_and_log_det_match_jax():
    params = inv1x1_init(KEY, 8)
    w = np.asarray(params["w1x1"]) * 1.3
    mod = InvConv1x1(8)
    with torch.no_grad():
        mod.w1x1.copy_(torch.from_numpy(w))
    x = rnd((2, 5, 8), 8)
    want, want_ld = inv1x1_forward({"w1x1": jnp.asarray(w)}, jnp.asarray(x))
    got, got_ld = mod(torch.from_numpy(x))
    close(got, want)
    np.testing.assert_allclose(float(got_ld), float(want_ld), rtol=1e-5)
    np.testing.assert_allclose(mod.inverse(got).detach().numpy(), x,
                               atol=1e-5)


def test_weight_norm_conv_matches_jax_and_folds():
    params = conv1d_init(KEY, 6, 5, 3, use_weight_norm=True)
    tree = np_tree(params)
    tree["g"] = tree["g"] * 0.7
    mod = ConvNorm(6, 5, 3, weight_norm=True)
    _conv(mod, tree)
    x = rnd((2, 11, 6), 9)
    want = conv_norm_apply({k: jnp.asarray(v) for k, v in tree.items()},
                           jnp.asarray(x), kernel_size=3)
    close(mod(torch.from_numpy(x)), want)
    folded = mod.folded()
    assert not folded.weight_norm
    close(folded(torch.from_numpy(x)), want)


def test_spectral_lstm_forward_and_power_iteration_match_jax():
    """The factored BiLSTM's output with sigma from the stored vectors, one
    power iteration on both sides, then the output again; ragged
    lengths."""
    params = bilstm_init(KEY, 6, 5, norm="spectral")
    mod = MaskedLSTM(6, 5, norm="spectral", factored=True)
    _lstm(mod, np_tree(params))
    x, lens = rnd((3, 9, 6), 10), np.array([9, 4, 1])
    for _ in range(2):
        want = bilstm_apply(params, jnp.asarray(x), jnp.asarray(lens))
        got = mod(torch.from_numpy(x), torch.from_numpy(lens))
        close(got, want)
        params = jax_sn_update(params)
        spectral_norm_update(mod)
        close(mod.hh[1].sn_u, params["bwd"]["hh"]["sn_u"], 1e-6)
        close(mod.hh[0].sn_v, params["fwd"]["hh"]["sn_v"], 1e-6)
    assert {n for n, _ in mod.named_buffers()} == {
        "hh.0.sn_u", "hh.0.sn_v", "hh.1.sn_u", "hh.1.sn_v"}


def test_dropout_rate_and_generator():
    """Keep rate 1 - p with kept values scaled by 1 / (1 - p); the same
    generator seed gives the same mask; no generator or p = 0 is the
    input itself."""
    x = torch.ones(200, 500)
    a = dropout(x, 0.25, torch.Generator().manual_seed(1))
    b = dropout(x, 0.25, torch.Generator().manual_seed(1))
    c = dropout(x, 0.25, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.75))
    assert dropout(x, 0.5) is x
    assert dropout(x, 0.0, torch.Generator()) is x


def test_first_order_features_match_jax():
    from radtts_tpu.models.radtts import get_first_order_features as jax_fof

    from radtts_tpu_torch.models.radtts import get_first_order_features
    x = rnd((2, 13), 12)
    for dilation in (1, 3):
        close(get_first_order_features(torch.from_numpy(x), dilation),
              jax_fof(jnp.asarray(x), dilation))
