"""The port's FFTransformer and the DAPs built on it (use_transformer)
held against the JAX package on the CPU, in fp32: the module against
fft_apply in eval and in training with the dropout masks injected on both
sides in JAX's draw order; radtts_infer of a small model whose duration,
f0 and energy DAPs use the transformer; one training forward with its
gradients; the reference state-dict reader and writer; and the bf16
storage of the feed-forward convs."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.export import radtts_to_torch as jax_to_torch
from radtts_tpu.models.fftransformer import fft_apply, fft_init
from radtts_tpu.models.radtts import infer_durations as jax_infer_durations
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from radtts_tpu.ops.fold_norms import fold_norms as jax_fold_norms
from radtts_tpu.ops.lstm import unroll_scope
from tests.small_model import MODEL_CONFIG
from tests.test_torch_gap_models import rel, rnd
from tests.test_torch_gap_serve_train import IN_LENS, SPK, TEXT, jax_params
from tests.test_torch_synthesizer_parity import np_tree

from radtts_tpu_torch.convert import (_fft, radtts_from_jax,
                                      radtts_from_torch)
from radtts_tpu_torch.export import radtts_to_torch
from radtts_tpu_torch.models import fftransformer
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.ops.fold_norms import store_conv_weights

B, T, C = 2, 13, 32
LENS = np.array([13, 8])
SMALL = dict(in_dim=C, out_dim=1, n_layers=2, n_head=2, d_head=8,
             d_inner=64, kernel_size=3)


@pytest.fixture(autouse=True)
def _fast_compiles():
    with unroll_scope(1):
        yield


def fft_pair(**extra):
    params = fft_init(jax.random.PRNGKey(0), **SMALL, **extra)
    mod = fftransformer.FFTransformer(**SMALL, **extra)
    _fft(mod, np_tree(params))
    return params, mod


def fft_input():
    return np.random.default_rng(0).normal(size=(B, T, C)).astype(np.float32)


def test_fft_module_matches_jax_eval():
    params, mod = fft_pair()
    x = fft_input()
    want = np.asarray(fft_apply(params, jnp.asarray(x), jnp.asarray(LENS)))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_fft_module_matches_jax_training_with_injected_masks(monkeypatch):
    """Every dropout mask drawn once in JAX's order (the embedded input,
    then each layer's attention probabilities, attention output and
    feed-forward output) and handed to both sides: 1e-5."""
    params, mod = fft_pair(dropemb=0.2)
    H = SMALL["n_head"]
    shapes = [(B, T, C)] + [(B, H, T, T), (B, T, C), (B, T, C)] * 2
    rng = np.random.default_rng(7)
    masks = [rng.random(s) > 0.3 for s in shapes]
    jax_draws, port_draws = list(masks), list(masks)

    def bernoulli(key, p, shape):
        m = jax_draws.pop(0)
        assert m.shape == tuple(shape)
        return jnp.asarray(m)

    def dropout(x, p, generator=None):
        if generator is None or p == 0:
            return x
        m = torch.from_numpy(port_draws.pop(0))
        assert m.shape == x.shape
        return torch.where(m, x / (1.0 - p), torch.zeros_like(x))

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(fftransformer, "dropout", dropout)
    x = fft_input()
    want = np.asarray(fft_apply(params, jnp.asarray(x), jnp.asarray(LENS),
                                training=True,
                                dropout_rng=jax.random.PRNGKey(3)))
    with torch.no_grad():
        got = mod.train()(torch.from_numpy(x), torch.from_numpy(LENS),
                          generator=torch.Generator().manual_seed(0))
    assert not jax_draws and not port_draws
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the masks act: without them the output moves
    with torch.no_grad():
        plain = mod(torch.from_numpy(x), torch.from_numpy(LENS))
    assert (plain - got).abs().max() > 1e-2


def fft_config():
    """tests/small_model.py's model with the duration, f0 and energy DAPs
    on the FFTransformer, at fft_init's defaults (n_head 1, d_head 64,
    d_inner 1024) as the published DAP configs would get them."""
    cfg = copy.deepcopy(MODEL_CONFIG)
    for key in ("dur_model_config", "f0_model_config",
                "energy_model_config"):
        cfg[key] = copy.deepcopy(cfg[key])
        cfg[key]["hparams"]["use_transformer"] = True
    return cfg


@pytest.fixture(scope="module")
def case():
    cfg = fft_config()
    with unroll_scope(1):
        params = jax_params(cfg)
    return cfg, params, radtts_from_jax(np_tree(params), cfg)


def test_radtts_infer_matches_jax(case):
    """Durations from the transformer duration DAP, then a decode of a
    padded batch of two with injected noise: durations equal (the raw
    predictions within 1e-4 * max), f0, energy and mel within 1e-4 *
    max."""
    cfg, params, model = case
    scaling = 4.0
    want_dur = np.asarray(jax_infer_durations(
        params, jax.random.PRNGKey(0), jnp.asarray(SPK), jnp.asarray(TEXT),
        token_dur_scaling=scaling, in_lens=jnp.asarray(IN_LENS)))
    got_dur = port.infer_durations(
        model, torch.as_tensor(SPK), torch.as_tensor(TEXT),
        token_dur_scaling=scaling, in_lens=torch.as_tensor(IN_LENS)).numpy()
    np.testing.assert_array_equal(got_dur, want_dur)
    dur = np.clip(want_dur, 1, 3).astype(np.int32)
    dur[1, 8:] = 0
    frames = ((int(dur.sum(1).max()) + 31) // 32) * 32
    g, n_mel = cfg["n_group_size"], cfg["n_mel_channels"]
    residual = rnd((2, frames // g, n_mel * g), 4, 0.8)
    args = dict(dur=dur, residual=residual, in_lens=IN_LENS)
    ref = jax_radtts_infer(params, jax.random.PRNGKey(1), jnp.asarray(SPK),
                           jnp.asarray(TEXT), 0.8, frames,
                           **{k: jnp.asarray(v) for k, v in args.items()})
    got = port.radtts_infer(model, torch.as_tensor(SPK),
                            torch.as_tensor(TEXT), 0.8, frames,
                            **{k: torch.as_tensor(v)
                               for k, v in args.items()})
    for key in ("f0", "energy_avg", "mel"):
        rel(got[key], ref[key])


def test_training_forward_and_gradients_match_jax(case):
    """One binarized training forward with dropout off, in float64 on
    both sides: the DAP outputs within 1e-4 * max, every loss within rtol
    1e-5, every trainable gradient within 1e-4 * max|JAX gradient| of its
    tensor (the tolerances of tests/test_torch_train_forward.py). In fp32
    the energy FFT's first feed-forward conv has relu inputs within
    rounding of 0 on this batch, which take either side in sums of
    another order and move that conv's gradient past the rule."""
    from radtts_tpu.losses import radtts_loss as jax_radtts_loss
    from radtts_tpu.models.radtts import radtts_forward as jax_forward
    from tests.test_torch_train_forward import (LOSS_WEIGHTS, make_batch,
                                                to_torch)

    from radtts_tpu_torch.convert import radtts_train_from_jax
    from radtts_tpu_torch.train.trainer import compute_loss

    cfg, params, _ = case
    batch = make_batch()

    def loss_fn(p, b):
        out = jax_forward(
            p, b["mel"], b["speaker_ids"], b["text"], b["input_lengths"],
            b["output_lengths"], binarize_attention_flag=True,
            attn_prior=b["attn_prior"], f0=b["f0"],
            energy_avg=b["energy_avg"], voiced_mask=b["voiced_mask"],
            training=True, dropout_rng=None)
        loss_dict = jax_radtts_loss(
            out, b["input_lengths"], b["output_lengths"], sigma=1.0,
            n_group_size=cfg["n_group_size"],
            dur_model_config=cfg["dur_model_config"],
            f0_model_config=cfg["f0_model_config"],
            energy_model_config=cfg["energy_model_config"],
            vpred_model_config=cfg["v_model_config"],
            loss_weights=LOSS_WEIGHTS)
        total = sum(v * w for v, w in loss_dict.values() if w > 0)
        return total, ({k: v for k, (v, _) in loss_dict.items()}, out)

    def f64(a):
        return (jnp.asarray(a, jnp.float64) if a.dtype in (np.float32,
                                                             jnp.float32)
                else jnp.asarray(a))

    with jax.enable_x64(True):
        (_, (j_scalars, j_out)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
                jax.tree_util.tree_map(f64, params),
                {k: f64(v) for k, v in batch.items()})
        j_scalars, j_out, grads = jax.device_get((j_scalars, j_out, grads))
    model = radtts_train_from_jax(np_tree(params), cfg).double()
    _, loss_dict, out = compute_loss(model, to_torch(batch, torch.float64),
                                     cfg, LOSS_WEIGHTS, 1.0, True, False)
    sum(v * w for v, w in loss_dict.values() if w > 0).backward()
    for name in ("f0", "energy", "duration"):
        got = out[f"{name}_model_outputs"]["x_hat"].detach().numpy()
        want = np.asarray(j_out[f"{name}_model_outputs"]["x_hat"])
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    for k, v in j_scalars.items():
        np.testing.assert_allclose(float(loss_dict[k][0]), float(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want = dict(radtts_train_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               np_tree(grads)), cfg).double()
        .named_parameters())
    bad, n_fft = [], 0
    for name, p in model.named_parameters():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        w = want[name].detach().numpy()
        n_fft += ".feat.layers." in name
        if np.abs(g - w).max() > max(1e-4 * np.abs(w).max(), 1e-7):
            bad.append((name, np.abs(g - w).max(), np.abs(w).max()))
    assert n_fft == 3 * 2 * 11 and not bad, bad


def test_checkpoint_reader_and_writer(case):
    """The port's writer gives JAX's exporter's keys at its shapes
    (dec_attn, pos_ff, dense.linear_layer under feat_pred_fn); the
    reference reader takes the file back to the same module."""
    cfg, params, model = case
    sd = radtts_to_torch(model)
    ref = jax_to_torch(params)
    assert set(sd) == set(ref)
    fft_keys = [k for k in ref if ".feat_pred_fn.layers." in k]
    assert len(fft_keys) == 3 * 2 * 11
    for k in ref:
        assert tuple(sd[k].shape) == tuple(ref[k].shape), k
    again = radtts_from_jax(radtts_from_torch(ref, cfg), cfg).state_dict()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(again[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_bf16_storage_casts_the_feed_forward_convs(case):
    """store_conv_weights casts each FFT layer's two feed-forward convs,
    as JAX's fold_norms(..., bfloat16) casts its 3-D kernels; qkv, o, the
    layer norms and the dense layer stay fp32 on both sides."""
    cfg, params, model = case
    stored = store_conv_weights(copy.deepcopy(model))
    folded = jax_fold_norms(params, jnp.bfloat16)
    for name in ("dur_pred_layer", "f0_pred_module", "energy_pred_module"):
        feat = getattr(stored, name).feat
        jfeat = folded[name]["feat"]
        for layer, jl in zip(feat.layers, jfeat["layers"]):
            for conv in ("conv1", "conv2"):
                assert getattr(layer["ff"], conv).weight.dtype == \
                    torch.bfloat16
                assert jl["ff"][conv]["w"].dtype == jnp.bfloat16
            for lin in ("qkv", "o"):
                assert getattr(layer["attn"], lin).weight.dtype == \
                    torch.float32
                assert jl["attn"][lin]["w"].dtype == jnp.float32
        assert feat.dense.weight.dtype == torch.float32
        assert jfeat["dense"]["w"].dtype == jnp.float32
