"""Model options the port once refused, held against the JAX package on
the CPU: the decoder's plain-W invertible 1x1 (matrix_decomposition other
than "LUS") and its simple_conv coupling, through the training forward,
radtts_infer and the reference state-dict reader and writer; and an AGAP
model served with bf16-stored conv kernels (weight_dtype="bfloat16")."""

import collections
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.convert import radtts_from_torch as jax_from_torch
from radtts_tpu.export import radtts_to_torch as jax_to_torch
from radtts_tpu.models.radtts import radtts_forward as jax_radtts_forward
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.ops.fold_norms import fold_norms as jax_fold_norms
from radtts_tpu.ops.invertible import precompute_inverses
from radtts_tpu.ops.lstm import unroll_scope
from tests.small_model import MODEL_CONFIG
from tests.test_torch_checkpoint import _Recorder, assert_trees_equal
from tests.test_torch_gap_models import perturb, rel, rnd
from tests.test_torch_gap_serve_train import (IN_LENS, SPK, TEXT, gap_config,
                                              jax_params)
from tests.test_torch_synthesizer_parity import (_converge_spectral_norms,
                                                 np_tree)
from tests.test_torch_train_forward import make_batch, to_torch

from radtts_tpu_torch.convert import (radtts_from_jax, radtts_from_torch,
                                      radtts_train_from_jax)
from radtts_tpu_torch.export import radtts_to_torch
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.ops.fold_norms import store_conv_weights
from radtts_tpu_torch.ops.invertible import InvConv1x1

DECODERS = {
    "plain_w": dict(matrix_decomposition=""),
    "simple_conv": dict(affine_model="simple_conv"),
}


@pytest.fixture(autouse=True)
def _fast_compiles():
    with unroll_scope(1):
        yield


@pytest.fixture(scope="module", params=sorted(DECODERS))
def decoder(request):
    """The small model with the decoder option; every zero-initialised
    last layer perturbed, the couplings' (WN end or SimpleConvNet last)
    at sd 0.02 as tests/test_torch_gap_serve_train.py:jax_params draws
    the WN's."""
    cfg = dict(copy.deepcopy(MODEL_CONFIG), **DECODERS[request.param])
    with unroll_scope(1):
        params = perturb(_converge_spectral_norms(
            radtts_init(jax.random.PRNGKey(0), cfg)), 1)
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        pred = flow["affine"]["pred"]
        last = pred["end"] if "end" in pred else pred["last"]
        last["w"] = jnp.asarray(
            rng.normal(0, 0.02, last["w"].shape).astype(np.float32))
    return request.param, cfg, params


def test_training_forward_matches_jax(decoder):
    """The training forward (dropout off, binarized): z and every flow's
    log_det_W and log_s within 1e-4 * max of JAX's inv1x1_forward /
    LU 1x1 and coupling; the plain W is a trainable parameter."""
    name, cfg, params = decoder
    batch = make_batch()
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p: jax_radtts_forward(
        p, j["mel"], j["speaker_ids"], j["text"], j["input_lengths"],
        j["output_lengths"], binarize_attention_flag=True,
        attn_prior=j["attn_prior"], f0=j["f0"], energy_avg=j["energy_avg"],
        voiced_mask=j["voiced_mask"], training=True,
        dropout_rng=None))(params)
    model = radtts_train_from_jax(np_tree(params), cfg)
    if name == "plain_w":
        assert all(isinstance(f.inv, InvConv1x1) and f.inv.trainable
                   and f.inv.w1x1.requires_grad for f in model.flows)
    t = to_torch(batch)
    with torch.no_grad():
        got = port.radtts_forward(
            model, t["mel"], t["speaker_ids"], t["text"], t["input_lengths"],
            t["output_lengths"], binarize_attention_flag=True,
            attn_prior=t["attn_prior"], f0=t["f0"],
            energy_avg=t["energy_avg"], voiced_mask=t["voiced_mask"])
    rel(got["z_mel"], want["z_mel"])
    for g, w in zip(got["log_s_list"], want["log_s_list"]):
        rel(g, w)
    # log|det W| of a near-orthonormal W is near 0: absolute, at fp32
    # rounding of a sum of c logs
    np.testing.assert_allclose(
        [float(g) for g in got["log_det_W_list"]],
        [float(w) for w in want["log_det_W_list"]], rtol=0, atol=1e-5)


def test_radtts_infer_matches_jax(decoder):
    """The inverse flows (the plain W's inverse precomputed once in fp32
    at load) from an injected residual: mel within 1e-4 * max."""
    _, cfg, params = decoder
    model = radtts_from_jax(np_tree(params), cfg)
    dur = np.random.default_rng(1).integers(1, 4, TEXT.shape).astype(
        np.int32)
    dur[1, 8:] = 0
    frames = ((int(dur.sum(1).max()) + 31) // 32) * 32
    g, n_mel = cfg["n_group_size"], cfg["n_mel_channels"]
    args = dict(dur=dur, residual=rnd((2, frames // g, n_mel * g), 4, 0.8),
                in_lens=IN_LENS)
    want = jax_radtts_infer(params, jax.random.PRNGKey(1), jnp.asarray(SPK),
                            jnp.asarray(TEXT), 0.8, frames,
                            **{k: jnp.asarray(v) for k, v in args.items()})
    got = port.radtts_infer(model, torch.as_tensor(SPK),
                            torch.as_tensor(TEXT), 0.8, frames,
                            **{k: torch.as_tensor(v)
                               for k, v in args.items()})
    rel(got["mel"], want["mel"])


def test_reference_reader_and_writer(decoder):
    """The JAX exporter's reference state dict (invtbl_conv.conv.weight for
    a plain W; affine_param_predictor.layers.i.conv / last_layer for a
    simple_conv coupling) reads into JAX's reader tree, every key read;
    the port's writer gives JAX's keys at JAX's shapes."""
    _, cfg, params = decoder
    sd = jax_to_torch(params)
    rec = _Recorder(sd)
    got = radtts_from_torch(rec, cfg)
    assert_trees_equal(got, np_tree(jax_from_torch(sd, cfg,
                                                   template=params)))
    assert not sorted(set(sd) - rec.read)
    out = radtts_to_torch(radtts_from_jax(got, cfg))
    assert set(out) == set(sd)
    for k in sd:
        assert tuple(out[k].shape) == tuple(sd[k].shape), k


# ---------------------------------------------------------------------------
# bf16-stored weights with an AGAP
# ---------------------------------------------------------------------------


def _bf16_shapes(named):
    return collections.Counter(tuple(t.shape) for _, t in named
                               if t.dtype == torch.bfloat16)


def test_agap_bf16_weights_match_jax():
    """An AGAP model (f0 and energy) with bf16-stored conv kernels: the
    kernels store_conv_weights casts are the ones JAX's fold_norms(...,
    bfloat16) casts (the bottleneck and the spline head's SimpleConvNet of
    every step, its LSTMs fp32); the decode from injected z_f0, z_energy
    and residual gives f0 and energy within 1e-4 * max of JAX's on the
    bf16 tree as it is: the AR scan rounds each bf16 head layer's input
    to bf16, as JAX's conv1d_apply does. Where an element differs by more,
    the report gives the count of such elements and the error."""
    cfg = gap_config("agap")
    with unroll_scope(1):
        params = jax_params(cfg)
    model = store_conv_weights(radtts_from_jax(np_tree(params), cfg))
    folded = jax_fold_norms(precompute_inverses(params), jnp.bfloat16)
    for name in ("f0_pred_module", "energy_pred_module"):
        want = collections.Counter(
            tuple(leaf.shape[::-1])
            for leaf in jax.tree_util.tree_leaves(folded[name])
            if leaf.dtype == jnp.bfloat16)
        got = _bf16_shapes(getattr(model, name).named_parameters())
        assert got == want and sum(want.values()) == 1 + 2 * 3, (got, want)
    dur = np.random.default_rng(1).integers(1, 4, TEXT.shape).astype(
        np.int32)
    dur[1, 8:] = 0
    frames = ((int(dur.sum(1).max()) + 31) // 32) * 32
    g, n_mel = cfg["n_group_size"], cfg["n_mel_channels"]
    args = dict(dur=dur, residual=rnd((2, frames // g, n_mel * g), 4, 0.8),
                z_f0=rnd((2, frames, 1), 2, 0.8),
                z_energy=rnd((2, frames, 1), 3, 0.8), in_lens=IN_LENS)

    def jax_decode(tree):
        return jax_radtts_infer(tree, jax.random.PRNGKey(1),
                                jnp.asarray(SPK), jnp.asarray(TEXT), 0.8,
                                frames, **{k: jnp.asarray(v)
                                           for k, v in args.items()})

    with torch.no_grad():
        got = port.radtts_infer(model, torch.as_tensor(SPK),
                                torch.as_tensor(TEXT), 0.8, frames,
                                **{k: torch.as_tensor(v)
                                   for k, v in args.items()})
    exact, fp32 = jax_decode(folded), jax_decode(params)
    for key in ("f0", "energy_avg"):
        want = np.asarray(exact[key])
        err = np.abs(got[key].numpy() - want)
        limit = 1e-4 * np.abs(want).max()
        assert err.max() <= limit, (key, int((err > limit).sum()),
                                    float(err.max()), float(limit))
        # the limit tells bf16 from fp32: JAX's own fp32 decode is past it
        assert np.abs(np.asarray(fp32[key]) - want).max() > 2 * limit, key
