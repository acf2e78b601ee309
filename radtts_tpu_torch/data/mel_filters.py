"""Mel filterbank construction (numpy, init-time only).

A copy of the JAX package's radtts_tpu/data/mel_filters.py, so that the port
needs neither it nor librosa: the Slaney-style mel filterbank
(librosa.filters.mel defaults: htk=False, norm='slaney') that the reference
audio frontend relies on (reference: audio_processing.py:124-127 builds
mel_basis with librosa_mel_fn(sr, n_fft, n_mels, fmin, fmax)).
"""

import numpy as np

_F_SP = 200.0 / 3.0           # slaney linear region: mels per Hz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(log_region,
                   _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ)
                   / _LOGSTEP,
                   mel)
    return mel


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region,
                 _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                 f)
    return f


def mel_frequencies(n_mels, fmin, fmax):
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels)
    return mel_to_hz(mels)


def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Returns (n_mels, 1 + n_fft//2) float32, Slaney-normalized triangles."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = np.linspace(0.0, float(sr) / 2, 1 + n_fft // 2)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    weights = np.zeros((n_mels, len(fftfreqs)), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))

    # slaney area normalization
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
