"""Parity of the port's RADTTS training forward, losses and gradients with
the JAX package's on the CPU, at tests/small_model.py:MODEL_CONFIG widths:
the same JAX-initialised unfolded tree (carried into the training form by
radtts_train_from_jax), the same numpy batch, dropout off on both sides
(JAX: training=True, dropout_rng=None; the port: no generator).

Gradients: the JAX gradient tree is carried through radtts_train_from_jax
too, so each JAX gradient lands in the port's layout beside the port's
.grad of the same parameter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.losses import attention_binarization_loss as jax_bin_loss
from radtts_tpu.losses import radtts_loss as jax_radtts_loss
from radtts_tpu.models.radtts import radtts_forward as jax_radtts_forward
from radtts_tpu.models.radtts import radtts_init
from tests.small_model import MODEL_CONFIG
from tests.test_torch_synthesizer_parity import (_converge_spectral_norms,
                                                 np_tree)

from radtts_tpu_torch.convert import radtts_from_jax, radtts_train_from_jax
from radtts_tpu_torch.data.dataset import beta_binomial_prior_distribution
from radtts_tpu_torch.models.radtts import fold_radtts
from radtts_tpu_torch.train.trainer import compute_loss

LOSS_WEIGHTS = {"blank_logprob": -1, "ctc_loss_weight": 0.1,
                "binarization_loss_weight": 1.0, "dur_loss_weight": 1.0,
                "f0_loss_weight": 1.0, "energy_loss_weight": 1.0,
                "vpred_loss_weight": 1.0}
IN_LENS = np.array([12, 9, 7])
OUT_LENS = np.array([40, 31, 26])      # ragged, one odd (group size 2)
N, T = 12, 40


def jax_params(seed=0):
    """radtts_init's tree with converged spectral norms and the (zero at
    init) WN end convs perturbed, so that every flow acts."""
    params = _converge_spectral_norms(radtts_init(jax.random.PRNGKey(seed),
                                                  MODEL_CONFIG))
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.02, end["w"].shape).astype(np.float32))
    return params


def make_batch(seed=1, in_lens=IN_LENS, out_lens=OUT_LENS, n=N, t=T):
    """A seeded numpy batch in the collate's layout, with beta-binomial
    priors over each item's valid region."""
    rng = np.random.default_rng(seed)
    b = len(in_lens)
    prior = np.zeros((b, t, n), np.float32)
    for i, (ni, ti) in enumerate(zip(in_lens, out_lens)):
        prior[i, :ti, :ni] = beta_binomial_prior_distribution(ni, ti, 1.0)
    voiced = (rng.random((b, t)) > 0.3).astype(np.float32)
    text = rng.integers(1, 180, (b, n)).astype(np.int64)
    text[np.arange(n)[None, :] >= np.asarray(in_lens)[:, None]] = 0
    return {
        "mel": rng.normal(size=(b, t, MODEL_CONFIG["n_mel_channels"]))
        .astype(np.float32),
        "speaker_ids": np.array([0, 2, 1][:b], np.int64),
        "text": text,
        "input_lengths": np.asarray(in_lens, np.int64),
        "output_lengths": np.asarray(out_lens, np.int64),
        "attn_prior": prior,
        "f0": ((rng.random((b, t)) * 300 + 100) * voiced).astype(np.float32),
        "voiced_mask": voiced,
        "energy_avg": rng.random((b, t)).astype(np.float32),
    }


def to_torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def jax_loss(params, batch, binarize, use_kl):
    """The JAX make_train_step's loss_fn (dropout off)."""
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax_radtts_forward(
        params, j["mel"], j["speaker_ids"], j["text"], j["input_lengths"],
        j["output_lengths"], binarize_attention_flag=binarize,
        attn_prior=j["attn_prior"], f0=j["f0"], energy_avg=j["energy_avg"],
        voiced_mask=j["voiced_mask"], training=True, dropout_rng=None)
    loss_dict = jax_radtts_loss(
        out, j["input_lengths"], j["output_lengths"], sigma=1.0,
        n_group_size=MODEL_CONFIG["n_group_size"],
        dur_model_config=MODEL_CONFIG["dur_model_config"],
        f0_model_config=MODEL_CONFIG["f0_model_config"],
        energy_model_config=MODEL_CONFIG["energy_model_config"],
        vpred_model_config=MODEL_CONFIG["v_model_config"],
        loss_weights=LOSS_WEIGHTS)
    total = 0.0
    for v, w in loss_dict.values():
        if w > 0:
            total = total + v * w
    bin_loss = (jax_bin_loss(out["attn"], out["attn_soft"])
                if binarize and use_kl else jnp.zeros(()))
    total = total + bin_loss
    scalars = {k: v for k, (v, _) in loss_dict.items()}
    scalars["binarization_loss"] = bin_loss
    return total, (scalars, out)


@pytest.fixture(scope="module")
def setup():
    params = jax_params()
    batch = make_batch()
    runs = {}
    for binarize in (False, True):
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: jax_loss(p, b, binarize, binarize), has_aux=True))
        (total, (scalars, out)), grads = grad_fn(params, batch)
        runs[binarize] = (float(total), jax.device_get(scalars),
                          jax.device_get(out), np_tree(grads))
    return params, batch, runs


def port_run(params, batch, binarize):
    model = radtts_train_from_jax(np_tree(params), MODEL_CONFIG)
    total, loss_dict, out = compute_loss(
        model, to_torch(batch), MODEL_CONFIG, LOSS_WEIGHTS, 1.0, binarize,
        binarize)
    total.backward()
    return model, total, loss_dict, out


@pytest.mark.parametrize("binarize", [False, True])
def test_forward_outputs_and_losses_match_jax(setup, binarize):
    params, batch, runs = setup
    j_total, j_scalars, j_out, _ = runs[binarize]
    model, total, loss_dict, out = port_run(params, batch, binarize)
    # fp32 convs, LSTMs and 8-step flow chains summed in another order
    np.testing.assert_allclose(out["attn_soft"].detach().numpy(),
                               j_out["attn_soft"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out["attn"].detach().numpy() > 0.5
                                  if binarize else 0,
                                  np.asarray(j_out["attn"]) > 0.5
                                  if binarize else 0)
    z = out["z_mel"].detach().numpy()
    np.testing.assert_allclose(z, j_out["z_mel"], rtol=1e-4,
                               atol=1e-4 * np.abs(j_out["z_mel"]).max())
    for name in ("f0", "energy", "vpred", "duration"):
        key = f"{name}_model_outputs" if name != "duration" \
            else "duration_model_outputs"
        got = out[key]["x_hat"].detach().numpy()
        want = np.asarray(j_out[key]["x_hat"])
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    for k, (v, _) in loss_dict.items():
        np.testing.assert_allclose(float(v), float(j_scalars[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total), j_total, rtol=1e-5)


@pytest.mark.parametrize("binarize", [False, True])
def test_gradients_match_jax(setup, binarize):
    """Every trainable gradient within 1e-4 * max|JAX gradient| of its
    tensor (a tensor whose JAX gradient is 0 everywhere within 1e-7)."""
    params, batch, runs = setup
    model, *_ = port_run(params, batch, binarize)
    want = radtts_train_from_jax(runs[binarize][3], MODEL_CONFIG)
    want = dict(want.named_parameters())
    bad, n = [], 0
    for name, p in model.named_parameters():
        g = (p.grad if p.grad is not None
             else torch.zeros_like(p)).numpy()
        w = want[name].detach().numpy()
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        n += 1
        if err > max(1e-4 * scale, 1e-7):
            bad.append((name, err, scale))
    assert n > 100 and not bad, bad


def test_fold_matches_radtts_from_jax(setup):
    """The training form folded equals radtts_from_jax of the same tree:
    bit for bit (the folds run in numpy on the same layout)."""
    params = setup[0]
    folded = fold_radtts(radtts_train_from_jax(np_tree(params),
                                               MODEL_CONFIG)).state_dict()
    want = radtts_from_jax(np_tree(params), MODEL_CONFIG).state_dict()
    assert set(folded) == set(want)
    for k in want:
        np.testing.assert_array_equal(folded[k].numpy(), want[k].numpy(),
                                      err_msg=k)
