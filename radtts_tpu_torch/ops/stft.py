"""STFT / inverse STFT for the vocoder denoiser, and the log-mel frontend.

The round trip (stft_reim / istft_reim) uses the same matmul DFT bases and
overlap-add with window-sumsquare correction as the JAX package, not
torch.stft / torch.istft, so the output length and edge handling match it.
stft_magnitude_phase (the denoiser's bias spectrum) is an rfft.
istft (from magnitude and phase) and griffin_lim (phase reconstruction)
complete the JAX package's set; no path of the port calls them.
mel_basis and dynamic_range_compression are the pieces of the reference's
TacotronSTFT mel (slaney filterbank, log-clamp dynamic range compression),
which ops/mel.py assembles on the same matmul DFT. The matmul STFTs,
istft and griffin_lim are fp32 islands at every matmul precision
(ops/precision.py), as the JAX package runs them at HIGHEST.
"""

import functools

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from radtts_tpu_torch.data.mel_filters import mel_filterbank
from radtts_tpu_torch.ops import precision

_TINY = float(np.finfo(np.float32).tiny)
CLIP_VAL = 1e-5   # the log-mel's floor


@functools.lru_cache(maxsize=8)
def hann_window(win_length, n_fft):
    w = scipy.signal.get_window("hann", win_length, fftbins=True)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft):
    """(n_fft, n_freq) bases: re_k = sum_n x[n] cos(2 pi k n / N),
    im_k = -sum_n x[n] sin(2 pi k n / N)."""
    F_ = n_fft // 2 + 1
    k = (np.arange(n_fft)[:, None] * np.arange(F_)[None, :]
         * (2.0 * np.pi / n_fft))
    return np.cos(k).astype(np.float32), (-np.sin(k)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _idft_bases(n_fft):
    """(n_freq, n_fft) bases of the real iDFT:
    x[n] = sum_k w_k (re_k cos(2 pi k n / N) - im_k sin(2 pi k n / N)) / N,
    w_k = 2 except DC and (for even N) Nyquist."""
    F_ = n_fft // 2 + 1
    k = (np.arange(F_)[:, None] * np.arange(n_fft)[None, :]
         * (2.0 * np.pi / n_fft))
    w = np.full((F_, 1), 2.0, np.float64)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    return ((np.cos(k) * w / n_fft).astype(np.float32),
            (np.sin(k) * w / n_fft).astype(np.float32))


def _const(a, ref):
    return torch.from_numpy(a).to(device=ref.device, dtype=ref.dtype)


def frame_signal(audio, n_fft, hop_length):
    """audio: (B, n) -> frames (B, T, n_fft) with reflect padding n_fft//2."""
    pad = n_fft // 2
    x = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(1, n_fft, hop_length)


def istft_length(n, n_fft, hop_length):
    """Length of istft_reim(stft_reim(audio)) for an input of length n."""
    n_frames = 1 + (n + 2 * (n_fft // 2) - n_fft) // hop_length
    return n_fft + hop_length * (n_frames - 1) - 2 * (n_fft // 2)


def stft_magnitude_phase(audio, n_fft=1024, hop_length=256, win_length=1024):
    """audio: (B, n) -> (magnitude, phase), each (B, T, n_fft//2+1)."""
    frames = frame_signal(audio, n_fft, hop_length)
    spec = torch.fft.rfft(frames * _const(hann_window(win_length, n_fft),
                                          audio), dim=-1)
    return spec.abs(), spec.angle()


@precision.island
def stft_reim(audio, n_fft=1024, hop_length=256, win_length=1024):
    """audio: (B, n) -> (re, im), each (B, T, n_fft//2+1), via the matmul
    DFT bases."""
    frames = frame_signal(audio, n_fft, hop_length)
    fw = frames * _const(hann_window(win_length, n_fft), audio)
    cos_f, nsin_f = _dft_bases(n_fft)
    return fw @ _const(cos_f, audio), fw @ _const(nsin_f, audio)


@functools.lru_cache(maxsize=8)
def mel_basis(sampling_rate, n_fft, n_mels, fmin, fmax):
    """Slaney mel filterbank (n_mels, n_fft//2+1), float32 numpy."""
    return mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)


def dynamic_range_compression(x):
    return torch.log(x.clamp(min=CLIP_VAL))


@precision.island
def istft_reim(re, im, n_fft=1024, hop_length=256, win_length=1024):
    """Inverse STFT from (re, im) (B, T, F): matmul iDFT, windowed
    overlap-add, window-sumsquare correction, n_fft//2 trimmed each side."""
    B, T, _ = re.shape
    icos, isin = _idft_bases(n_fft)
    w = _const(hann_window(win_length, n_fft), re)
    frames = (re @ _const(icos, re) - im @ _const(isin, re)) * w
    n = n_fft + hop_length * (T - 1)
    # overlap-add as a transposed "fold" of the frames
    sig = F.fold(frames.transpose(1, 2), output_size=(1, n),
                 kernel_size=(1, n_fft), stride=(1, hop_length))[:, 0, 0]
    wss = F.fold((w * w)[None, :, None].expand(1, n_fft, T).contiguous(),
                 output_size=(1, n), kernel_size=(1, n_fft),
                 stride=(1, hop_length))[0, 0, 0]
    sig = torch.where(wss > _TINY, sig / wss.clamp(min=_TINY), sig)
    pad = n_fft // 2
    return sig[:, pad:-pad]


@precision.island
def istft(magnitude, phase, n_fft=1024, hop_length=256, win_length=1024):
    """Inverse STFT from (magnitude, phase), each (B, T, F)."""
    return istft_reim(magnitude * torch.cos(phase),
                      magnitude * torch.sin(phase),
                      n_fft, hop_length, win_length)


@precision.island
def griffin_lim(magnitudes, n_iters=30, n_fft=1024, hop_length=256,
                win_length=1024, *, generator=None, phase0=None):
    """Phase reconstruction from magnitudes (B, T, F) by n_iters rounds of
    stft/istft projection; returns (B, hop_length * (T - 1)). The initial
    phase is phase0 when given, else uniform on [-pi, pi) drawn from
    `generator`, a torch.Generator on the magnitudes' device: no global
    RNG is read."""
    if phase0 is None:
        if generator is None:
            raise ValueError("griffin_lim needs phase0 or a generator")
        phase0 = (torch.rand(magnitudes.shape, generator=generator,
                             device=magnitudes.device,
                             dtype=magnitudes.dtype)
                  * (2 * np.pi) - np.pi)
    signal = istft(magnitudes, phase0, n_fft, hop_length, win_length)
    for _ in range(n_iters):
        _, angle = stft_magnitude_phase(signal, n_fft, hop_length,
                                        win_length)
        signal = istft(magnitudes, angle[:, :magnitudes.shape[1]], n_fft,
                       hop_length, win_length)
    return signal
