"""Numpy audio frontend of the data pipeline: a copy of the JAX package's
radtts_tpu/data/audio_np.py (the reference's conv1d STFT and TacotronSTFT
mel pipeline, audio_processing.py:192-255, in numpy), so that training
mels are the JAX package's bit for bit."""

import functools

import numpy as np
import scipy.signal

from radtts_tpu_torch.data.mel_filters import mel_filterbank


@functools.lru_cache(maxsize=8)
def _window(win_length, n_fft):
    w = scipy.signal.get_window("hann", win_length, fftbins=True)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _basis(sr, n_fft, n_mels, fmin, fmax):
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax)


def stft_magnitude_np(audio, n_fft=1024, hop_length=256, win_length=1024):
    """audio: (n,) -> magnitude (T, n_fft//2+1)."""
    pad = n_fft // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :])
    frames = x[idx] * _window(win_length, n_fft)[None, :]
    return np.abs(np.fft.rfft(frames, axis=1)).astype(np.float32)


def mel_spectrogram_np(audio, *, filter_length=1024, hop_length=256,
                       win_length=1024, n_mel_channels=80,
                       sampling_rate=22050, mel_fmin=0.0, mel_fmax=8000.0):
    """audio: (n,) in [-1, 1] -> log-mel (T, n_mel)."""
    assert audio.min() >= -1 and audio.max() <= 1
    mag = stft_magnitude_np(audio, filter_length, hop_length, win_length)
    basis = _basis(sampling_rate, filter_length, n_mel_channels, mel_fmin,
                   mel_fmax)
    mel = mag @ basis.T
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)
