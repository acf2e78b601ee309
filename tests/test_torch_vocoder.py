"""Parity of the PyTorch port's HiFi-GAN generator and denoiser with the JAX
package on the CPU: the JAX-initialised small vocoder carried over by
radtts_tpu_torch.convert, the same numpy-seeded mel.

Tolerance 1e-4 of the output's scale: four upsample stages of fp32 convs
(each MRF stage 18 of them) with sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.hifigan import denoiser_apply as jax_denoiser_apply
from radtts_tpu.models.hifigan import denoiser_init as jax_denoiser_init
from radtts_tpu.models.hifigan import (hifigan_generator_apply,
                                       hifigan_generator_init)

from radtts_tpu_torch.convert import hifigan_from_jax
from radtts_tpu_torch.models.hifigan import denoiser_apply, denoiser_init

H_SMALL = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 64,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()
                if k not in ("_meta", "_kind")}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree)


def close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    tol = 1e-4 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


@pytest.fixture(scope="module")
def vocoders():
    params = hifigan_generator_init(jax.random.PRNGKey(1), H_SMALL)
    gen = hifigan_from_jax(np_tree(params), H_SMALL)
    with jax.disable_jit():
        jax_den = jax_denoiser_init(params)
    with torch.no_grad():
        den = denoiser_init(gen)
    return params, gen, jax_den, den


@pytest.fixture(scope="module")
def audio(vocoders):
    params, gen, _, _ = vocoders
    mel = np.random.default_rng(0).standard_normal((2, 24, 80)).astype(
        np.float32)
    ref = hifigan_generator_apply(params, jnp.asarray(mel))
    with torch.no_grad():
        got = gen(torch.as_tensor(mel))
    return np.asarray(ref), got


def test_generator(audio):
    ref, got = audio
    assert got.shape == (2, 24 * 256)
    close(got.numpy(), ref)


def test_denoiser_bias(vocoders):
    _, _, jax_den, den = vocoders
    close(den.bias_spec.numpy(), jax_den["bias_spec"])


@pytest.mark.parametrize("strength", [0.0, 0.01])
def test_denoiser_apply(vocoders, audio, strength):
    _, _, jax_den, den = vocoders
    ref_audio, got_audio = audio
    ref = jax_denoiser_apply(jax_den, jnp.asarray(ref_audio),
                             strength=strength)
    with torch.no_grad():
        got = denoiser_apply(den, got_audio, strength=strength)
    close(got.numpy(), ref)
