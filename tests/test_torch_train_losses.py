"""Every term of the port's radtts_loss and attention_binarization_loss
against the JAX package's (radtts_tpu/losses.py) on the CPU, on ragged
lengths, from the same numpy inputs, at 1e-5 relative (fp32 sums in
another order; the CTC by torch's F.ctc_loss against optax.ctc_loss)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radtts_tpu import losses as jax_losses
from tests.small_model import DAP_CFG, F0_CFG, V_CFG

from radtts_tpu_torch import losses

IN_LENS = np.array([11, 7, 3])
OUT_LENS = np.array([40, 25, 9])
B, T, N, C = 3, 40, 11, 8
CONFIGS = dict(dur_model_config=DAP_CFG, f0_model_config=F0_CFG,
               energy_model_config=F0_CFG, vpred_model_config=V_CFG)
WEIGHTS = {"blank_logprob": -1, "ctc_loss_weight": 0.1,
           "dur_loss_weight": 1.0, "f0_loss_weight": 0.5,
           "energy_loss_weight": 1.0, "vpred_loss_weight": 2.0}


def inputs(seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    logits = r(B, T, N, scale=2.0)
    attn_logprob = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    out = {
        "z_mel": r(B, T // 2, C),
        "log_s_list": [r(B, T // 2, C // 2, scale=0.1) for _ in range(3)],
        "log_det_W_list": [np.float32(v) for v in r(3, scale=0.3)],
        "attn_logprob": attn_logprob.astype(np.float32),
        "duration_model_outputs": {"x_hat": r(B, N, 1), "x": r(B, N)},
        "f0_model_outputs": {"x_hat": r(B, T, 1), "x": r(B, T)},
        "energy_model_outputs": {"x_hat": r(B, T, 1), "x": r(B, T)},
        "vpred_model_outputs": {
            "x_hat": r(B, T, 1, scale=2.0),
            "x": (rng.random((B, T)) > 0.4).astype(np.float32)},
    }
    return out


def as_jax(tree):
    if isinstance(tree, dict):
        return {k: as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_jax(v) for v in tree]
    return jnp.asarray(tree)


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_torch(v) for v in tree]
    return torch.as_tensor(tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_radtts_loss_terms_match_jax(seed):
    out = inputs(seed)
    want = jax_losses.radtts_loss(
        as_jax(out), jnp.asarray(IN_LENS), jnp.asarray(OUT_LENS), sigma=1.0,
        n_group_size=2, loss_weights=WEIGHTS, **CONFIGS)
    got = losses.radtts_loss(
        as_torch(out), torch.as_tensor(IN_LENS), torch.as_tensor(OUT_LENS),
        sigma=1.0, n_group_size=2, loss_weights=WEIGHTS, **CONFIGS)
    assert set(got) == set(want) and len(got) == 7
    for k, (v, w) in want.items():
        np.testing.assert_allclose(float(got[k][0]), float(v), rtol=1e-5,
                                   err_msg=k)
        assert got[k][1] == w, k


@pytest.mark.parametrize("blank", [-1.0, 0.5])
def test_attention_ctc_loss_matches_jax(blank):
    """The classes above each in_len masked before the log_softmax."""
    attn_logprob = inputs(2)["attn_logprob"]
    want = jax_losses.attention_ctc_loss(
        jnp.asarray(attn_logprob), jnp.asarray(IN_LENS),
        jnp.asarray(OUT_LENS), blank_logprob=blank)
    got = losses.attention_ctc_loss(
        torch.from_numpy(attn_logprob), torch.as_tensor(IN_LENS),
        torch.as_tensor(OUT_LENS), blank_logprob=blank)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_attention_binarization_loss_matches_jax():
    rng = np.random.default_rng(3)
    soft = rng.random((B, T, N)).astype(np.float32)
    soft[0, :3, :2] = 0.0                          # the 1e-12 clip
    hard = np.zeros_like(soft)
    for b, (ti, ni) in enumerate(zip(OUT_LENS, IN_LENS)):
        hard[b, np.arange(ti), np.minimum(np.arange(ti) * ni // ti,
                                          ni - 1)] = 1.0
    want = jax_losses.attention_binarization_loss(jnp.asarray(hard),
                                                  jnp.asarray(soft))
    got = losses.attention_binarization_loss(torch.from_numpy(hard),
                                             torch.from_numpy(soft))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
