"""The port's log-mel frontend against the JAX package on the CPU: the
filterbank copy, mel (mel_plain on a CPU tensor) against both the JAX
mel_spectrogram and the Pallas kernel in interpret mode, the gradient, and
the host-side constants the CUDA kernel (csrc/mel.cu) reads.

Tolerance 1e-4 absolute on the log-mel, the JAX package's own between its
two paths (tests/test_vocoder_audio.py): fp32 sums over 1024 samples in
another order (rfft against the matmul DFT), amplified by the log where the
mel is small.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.data.mel_filters import mel_filterbank as jax_mel_filterbank
from radtts_tpu.ops.pallas_mel import mel_spectrogram_pallas
from radtts_tpu.ops.stft import dynamic_range_compression as \
    jax_dynamic_range_compression
from radtts_tpu.ops.stft import mel_spectrogram as jax_mel_spectrogram

from radtts_tpu_torch.data.mel_filters import mel_filterbank
from radtts_tpu_torch.ops.mel import kernel_constants, mel, mel_plain
from radtts_tpu_torch.ops.stft import CLIP_VAL, dynamic_range_compression

MEL_KW = dict(filter_length=1024, hop_length=256, win_length=1024,
              n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
              mel_fmax=8000.0)


def _audio(shape, seed=7):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, shape).astype(
        np.float32)


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, 8000.0),
                                  (16000, 512, 40, 50.0, None)])
def test_filterbank_copy_is_exact(args):
    np.testing.assert_array_equal(mel_filterbank(*args),
                                  jax_mel_filterbank(*args))


@pytest.mark.parametrize("shape", [(2, 9000), (2, 8192), (1, 2053),
                                   (3, 4097)])
def test_mel_matches_jax(shape):
    """mel on a CPU tensor (which runs mel_plain) against the JAX
    mel_spectrogram and the Pallas kernel in interpret mode."""
    a = _audio(shape)
    ref = np.asarray(jax_mel_spectrogram(jnp.asarray(a), **MEL_KW))
    pallas = np.asarray(mel_spectrogram_pallas(jnp.asarray(a), interpret=True,
                                               **MEL_KW))
    got = mel(torch.from_numpy(a), **MEL_KW).numpy()
    assert got.shape == ref.shape == (a.shape[0], 1 + a.shape[1] // 256, 80)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)


def test_dynamic_range_compression_matches_jax():
    """log(clamp(x, CLIP_VAL)) equals the JAX package's, the floor
    included."""
    x = np.array([0.0, 1e-7, 1e-5, 3e-5, 0.5, 20.0], np.float32)
    np.testing.assert_allclose(
        dynamic_range_compression(torch.from_numpy(x)).numpy(),
        np.asarray(jax_dynamic_range_compression(jnp.asarray(x))), rtol=1e-7)
    assert CLIP_VAL == 1e-5


def test_mel_refuses_other_devices():
    """A tensor that is on neither the CPU nor a CUDA card gets no plain
    fallback."""
    with pytest.raises(ValueError, match="unsupported device"):
        mel(torch.zeros(1, 4096, device="meta"), **MEL_KW)


def test_mel_gradient_matches_jax():
    """d sum(mel * g) / d audio for a numpy cotangent g, within 1e-5 of the
    gradient's max: the same fp32 sums as the forward, backwards."""
    a = _audio((2, 4100), seed=3)
    g = np.random.default_rng(4).standard_normal((2, 17, 80)).astype(
        np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_mel_spectrogram(x, **MEL_KW) * g))(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_(True)
    (mel(x, **MEL_KW) * torch.from_numpy(g)).sum().backward()
    got = x.grad.numpy()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _kernel_emulation(a, consts, hop=256):
    """The CUDA kernel's arithmetic in float64 numpy, on its packed bases:
    reflect-indexed frames, DC and Nyquist unpacked from column 0, each
    filter summed over its nonzero range only."""
    bases, fb, ranges = consts
    n_fft, half = bases.shape[0], bases.shape[1]
    B, n = a.shape
    T = 1 + n // hop
    xp = np.pad(a.astype(np.float64), ((0, 0), (half, half)), mode="reflect")
    frames = xp[:, np.arange(T)[:, None] * hop + np.arange(n_fft)]
    re, im = frames @ bases[..., 0], frames @ bases[..., 1]
    mag = np.empty((B, T, half + 1))
    mag[..., 1:half] = np.hypot(re[..., 1:], im[..., 1:])
    mag[..., 0], mag[..., half] = np.abs(re[..., 0]), np.abs(im[..., 0])
    out = np.empty((B, T, fb.shape[0]))
    for m, (lo, hi) in enumerate(ranges):
        out[..., m] = mag[..., lo:hi] @ fb[m, lo:hi]
    return np.log(np.maximum(out, 1e-5))


def test_kernel_constants_give_the_mel():
    consts = kernel_constants(1024, 1024, 22050, 80, 0.0, 8000.0)
    bases, fb, ranges = consts
    assert bases.shape == (1024, 512, 2) and bases.dtype == np.float32
    assert ranges.shape == (80, 2) and ranges.dtype == np.int32
    # every nonzero of the filterbank lies inside its filter's range
    cols = np.arange(fb.shape[1])
    inside = (cols >= ranges[:, :1]) & (cols < ranges[:, 1:])
    assert not fb[~inside].any()
    a = _audio((3, 9001), seed=5)
    ref = mel_plain(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(_kernel_emulation(a, consts), ref, rtol=0,
                               atol=1e-4)
