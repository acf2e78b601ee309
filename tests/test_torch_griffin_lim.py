"""istft and griffin_lim in the port (radtts_tpu_torch/ops/stft.py) against
the JAX package's (radtts_tpu/ops/stft.py), on the CPU, from seeded numpy
inputs; JAX's own initial phase is injected into the port's griffin_lim."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.ops import stft as jax_stft

from radtts_tpu_torch.ops import precision
from radtts_tpu_torch.ops import stft

# n_fft 256, hop 64: 39 hops of audio give 40 frames
GL_KW = dict(n_fft=256, hop_length=64, win_length=256)


def _signal(n, seed, hz=(440.0, 700.0), sr=22050):
    """One row a frequency: a 0.5 sine plus noise at sd 0.05."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return np.stack([0.5 * np.sin(2 * np.pi * f * t)
                     + 0.05 * rng.standard_normal(n)
                     for f in hz]).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop_length,win_length", [
    (1024, 256, 1024),      # the hop divides n_fft: JAX's chunked overlap-add
    (1000, 256, 1000),      # it does not: JAX's scatter-add
])
def test_istft_matches_jax(n_fft, hop_length, win_length):
    """(2, 40, F) magnitudes in [0, 1) and phases in [-pi, pi): within
    1e-5 * max|JAX| (the iDFT's fp32 sums over F bins in another order;
    measured 4e-7 of max)."""
    rng = np.random.default_rng(0)
    shape = (2, 40, n_fft // 2 + 1)
    mag = rng.uniform(0, 1, shape).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    want = np.asarray(jax_stft.istft(jnp.asarray(mag), jnp.asarray(phase),
                                     n_fft, hop_length, win_length))
    got = stft.istft(torch.from_numpy(mag), torch.from_numpy(phase), n_fft,
                     hop_length, win_length).numpy()
    assert got.shape == want.shape == (2, hop_length * 39)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_iters", [0, 1, 4])
def test_griffin_lim_matches_jax(n_iters):
    """Magnitudes of two seeded sine-plus-noise rows, (2, 40, 129); the
    port starts from JAX's uniform draw (radtts_tpu/ops/stft.py:176) and
    must give JAX's waveform within 1e-4 * max|JAX|. A bin whose
    magnitude is near 0 has an ill-conditioned phase, so the two FFTs'
    fp32 differences grow with each round: 1e-7 of max at 0 rounds, up to
    7.2e-6 at 4 rounds over eight keys."""
    mag, _ = jax_stft.stft_magnitude_phase(jnp.asarray(_signal(64 * 39, 1)),
                                           **GL_KW)
    key = jax.random.PRNGKey(0)
    phase0 = jax.random.uniform(key, mag.shape, jnp.float32, -np.pi, np.pi)
    want = np.asarray(jax_stft.griffin_lim(key, mag, n_iters=n_iters,
                                           **GL_KW))
    got = stft.griffin_lim(torch.tensor(np.asarray(mag)), n_iters,
                           phase0=torch.tensor(np.asarray(phase0)),
                           **GL_KW).numpy()
    assert got.shape == want.shape == (2, 64 * 39)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_griffin_lim_converges():
    """On the seeded signal of tests/test_vocoder_audio.py (a 440 Hz sine,
    0.5 s), the spectral error after 30 rounds lies below the error of
    the initial random phase (0 rounds). Not every round lowers it: a
    random initial phase makes Griffin-Lim non-monotone."""
    t = np.arange(22050 // 2, dtype=np.float32)
    sig = torch.from_numpy(
        (0.5 * np.sin(2 * np.pi * 440 * t / 22050)).astype(np.float32))
    mag, _ = stft.stft_magnitude_phase(sig[None], 1024, 256, 1024)

    def spec_err(n_iters):
        rec = stft.griffin_lim(mag, n_iters,
                               generator=torch.Generator().manual_seed(0))
        mag2, _ = stft.stft_magnitude_phase(rec, 1024, 256, 1024)
        return float(torch.linalg.norm(mag2[:, :mag.shape[1]] - mag)
                     / torch.linalg.norm(mag))

    err0, err30 = spec_err(0), spec_err(30)
    assert err30 < err0, (err0, err30)


def test_griffin_lim_phase_from_generator_or_phase0_only():
    """The initial phase is phase0, or uniform on [-pi, pi) from the given
    generator; the global RNG is neither read nor advanced, and with
    neither argument the call raises."""
    mag = torch.from_numpy(np.abs(np.random.default_rng(2).standard_normal(
        (1, 12, 129))).astype(np.float32))
    phase0 = (torch.rand(mag.shape, generator=torch.Generator().manual_seed(
        4)) * (2 * np.pi) - np.pi)
    state = torch.get_rng_state()
    drawn = stft.griffin_lim(mag, 2, generator=torch.Generator().manual_seed(
        4), **GL_KW)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(drawn, stft.griffin_lim(mag, 2, phase0=phase0,
                                               **GL_KW))
    with pytest.raises(ValueError, match="phase0 or a generator"):
        stft.griffin_lim(mag, 2, **GL_KW)


def test_istft_and_griffin_lim_are_fp32_islands(monkeypatch):
    """Inside a "default" scope both run their transforms with TF32 off,
    as the JAX package runs its STFTs at HIGHEST."""
    seen = []

    def recording(fn):
        def wrapper(*args, **kwargs):
            seen.append((fn.__name__, torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)
        return wrapper

    for name in ("istft_reim", "stft_magnitude_phase"):
        monkeypatch.setattr(stft, name, recording(getattr(stft, name)))
    mag = torch.ones(1, 6, 129)
    with precision.scope("default"):
        stft.istft(mag, torch.zeros_like(mag), **GL_KW)
        stft.griffin_lim(mag, 1, phase0=torch.zeros_like(mag), **GL_KW)
    assert seen == [("istft_reim", False, False)] * 2 + [
        ("stft_magnitude_phase", False, False),
        ("istft_reim", False, False)]
