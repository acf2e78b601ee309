"""The port's log-mel frontend against the JAX package on the CPU: the
filterbank copy, mel (mel_plain on a CPU tensor) against both the JAX
mel_spectrogram and the Pallas kernel in interpret mode, the gradient, and
the CUDA kernel's (csrc/mel.cu) host-side constants and FFT factorisation,
emulated in float32 numpy.

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
from radtts_tpu_torch.ops.mel import (fft_radices, kernel_constants, mel,
                                      mel_plain)
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


def _mel_float64(a):
    """The log-mel in float64 NumPy: reflect pad, periodic Hann window,
    rfft, magnitude, slaney filterbank, log(clamp(., 1e-5))."""
    n_fft, hop = MEL_KW["filter_length"], MEL_KW["hop_length"]
    x = np.pad(a.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)),
               mode="reflect")
    t = np.arange(1 + a.shape[1] // hop)[:, None] * hop + np.arange(n_fft)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    mag = np.abs(np.fft.rfft(x[:, t] * window, axis=-1))
    fb = mel_filterbank(22050, n_fft, 80, 0.0, 8000.0).astype(np.float64)
    return np.log(np.maximum(mag @ fb.T, 1e-5))


@pytest.fixture(scope="module")
def warm_paths():
    """Each compared path run once on other audio first, so that no
    comparison is a process's first JAX or torch computation."""
    a = _audio((1, 2053), seed=1)
    np.asarray(jax_mel_spectrogram(jnp.asarray(a), **MEL_KW))
    np.asarray(mel_spectrogram_pallas(jnp.asarray(a), interpret=True,
                                      **MEL_KW))
    mel(torch.from_numpy(a), **MEL_KW)


@pytest.mark.parametrize("shape", [(2, 9000), (2, 8192), (1, 2053),
                                   (3, 4097)])
def test_mel_matches_jax(shape, warm_paths):
    """mel on a CPU tensor (which runs mel_plain) against the JAX
    mel_spectrogram and the Pallas kernel in interpret mode, and all three
    against the same log-mel in float64.

    Each fp32 path lands within ~2e-6 of float64 here. Once, in a 6-worker
    run of the whole suite, the port and mel_spectrogram differed by up to
    2.3e-4 in 82 of the 5760 values at shape (2, 9000), the corner values
    of both arrays equal to their usual ones in all 7 printed digits. That
    is ~100x what a different summation order gives at these mel values
    (~0.07-1), so it is not rounding. That comparison was its worker's
    first JAX and first torch computation, and the three later shapes in
    the same process agreed; no test state, matmul precision setting,
    thread count or compilation-cache state tried brings it back
    (ROADMAP.md, section C). So the paths are run once first
    (warm_paths), and the float64 reference names the side that moves if
    it comes back."""
    a = _audio(shape)
    ref = np.asarray(jax_mel_spectrogram(jnp.asarray(a), **MEL_KW))
    pallas = np.asarray(mel_spectrogram_pallas(jnp.asarray(a), interpret=True,
                                               **MEL_KW))
    got = mel(torch.from_numpy(a), **MEL_KW).numpy()
    exact = _mel_float64(a)
    assert got.shape == ref.shape == (a.shape[0], 1 + a.shape[1] // 256, 80)
    off = {name: float(np.abs(v - exact).max())
           for name, v in (("port", got), ("jax", ref), ("pallas", pallas))}
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4,
                               err_msg=f"max |. - float64|: {off}")
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4,
                               err_msg=f"max |. - float64|: {off}")
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4)


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


def _fft_emulation(a, consts, hop=256):
    """csrc/mel.cu's arithmetic in float32 numpy: reflect-indexed frames
    windowed as they load, packed as z[m] = x[2m] + i x[2m+1], the Stockham
    stages in the kernel's order (fft_radices) with its twiddle table, the
    real-FFT unpacking with DC and Nyquist apart, each filter summed over
    its nonzero range only."""
    window, tw, fb_packed, ranges = consts
    N = window.size
    M = N // 2
    W = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    B, n = a.shape
    T = 1 + n // hop
    xp = np.pad(a, ((0, 0), (M, M)), mode="reflect")
    frames = xp[:, np.arange(T)[:, None] * hop + np.arange(N)] * window
    x = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    p = 1
    for r in fft_radices(M):
        L = M // r
        i = np.arange(L)
        k = i & (p - 1)
        e = 2 * k * (M // (p * r))
        u = [x[..., i]] + [x[..., i + q * L] * W[q * e] for q in range(1, r)]
        j = (i - k) * r + k
        y = np.empty_like(x)
        if r == 4:
            s02, d02 = u[0] + u[2], u[0] - u[2]
            s13, d13 = u[1] + u[3], u[1] - u[3]
            y[..., j], y[..., j + 2 * p] = s02 + s13, s02 - s13
            y[..., j + p], y[..., j + 3 * p] = d02 - 1j * d13, d02 + 1j * d13
        else:
            y[..., j], y[..., j + p] = u[0] + u[1], u[0] - u[1]
        x, p = y, p * r
    k = np.arange(1, M)
    zk, zc = x[..., k], np.conj(x[..., M - k])
    spec = 0.5 * (zk + zc) + W[k] * (0.5 * (zk - zc) * np.complex64(-1j))
    mag = np.empty((B, T, M + 1), np.float32)
    mag[..., 1:M] = np.abs(spec)
    mag[..., 0] = np.abs(x[..., 0].real + x[..., 0].imag)
    mag[..., M] = np.abs(x[..., 0].real - x[..., 0].imag)
    out = np.empty((B, T, len(ranges)), np.float32)
    for m, (lo, hi, off) in enumerate(ranges):
        out[..., m] = mag[..., lo:hi] @ fb_packed[off:off + hi - lo]
    return np.log(np.maximum(out, np.float32(1e-5)))


@pytest.mark.parametrize("m,radices", [(512, [4, 4, 4, 4, 2]),
                                       (256, [4, 4, 4, 4]), (8, [4, 2])])
def test_fft_radices(m, radices):
    assert fft_radices(m) == radices


def test_kernel_constants_give_the_mel():
    consts = kernel_constants(1024, 1024, 22050, 80, 0.0, 8000.0)
    window, tw, fb_packed, ranges = consts
    assert window.shape == (1024,) and window.dtype == np.float32
    assert tw.shape == (1024, 2) and tw.dtype == np.float32
    assert ranges.shape == (80, 3) and ranges.dtype == np.int32
    e = np.arange(1024) * 2 * np.pi / 1024
    np.testing.assert_array_equal(tw[:, 0], np.cos(e).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], (-np.sin(e)).astype(np.float32))
    # the packed weights rebuild the filterbank: every nonzero lies inside
    # its filter's range
    fb = mel_filterbank(22050, 1024, 80, 0.0, 8000.0)
    dense = np.zeros_like(fb)
    for m, (lo, hi, off) in enumerate(ranges):
        dense[m, lo:hi] = fb_packed[off:off + hi - lo]
    np.testing.assert_array_equal(dense, fb)
    assert fb_packed.size == np.count_nonzero(fb) == 727
    a = _audio((3, 9001), seed=5)
    ref = mel_plain(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(_fft_emulation(a, consts), ref, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 9000), (2, 8192), (1, 2053),
                                   (3, 4097)])
def test_fft_emulation_matches_plain_and_jax(shape):
    """The kernel's FFT factorisation against mel_plain (a matmul DFT) and
    the JAX mel_spectrogram, at test_mel_matches_jax's shapes, within the
    same 1e-4."""
    a = _audio(shape, seed=11)
    got = _fft_emulation(a, kernel_constants(1024, 1024, 22050, 80, 0.0,
                                             8000.0))
    plain = mel_plain(torch.from_numpy(a)).numpy()
    ref = np.asarray(jax_mel_spectrogram(jnp.asarray(a), **MEL_KW))
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, _mel_float64(a), rtol=0, atol=1e-4)
