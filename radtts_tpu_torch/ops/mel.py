"""Log-mel spectrogram of audio: reflect pad n_fft/2, frame, windowed DFT,
magnitude, slaney mel projection, log(clamp(., 1e-5)).

Port of the TPU kernel radtts_tpu/ops/pallas_mel.py:mel_spectrogram_pallas.
On the card `mel` launches the hand-written kernel in csrc/mel.cu once per
call: a real FFT of each frame in shared memory (see its header for the
design and what bounds it); `mel_plain` is the same function in plain
PyTorch (a matmul DFT), which the CPU path and the tests use, an fp32
island at every matmul precision (ops/precision.py).
Gradients with respect to the audio go through mel_plain: the kernel has no
backward, as the TPU kernel had none.
"""

import ctypes
import functools

import numpy as np
import torch

from radtts_tpu_torch.ops import flops, precision
from radtts_tpu_torch.ops.cuda_build import build_library
from radtts_tpu_torch.ops.stft import (CLIP_VAL, dynamic_range_compression,
                                       hann_window, mel_basis, stft_reim)

_lib = None


@precision.island
def mel_plain(audio, *, filter_length=1024, hop_length=256, win_length=1024,
              n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
              mel_fmax=8000.0):
    """audio: (B, n) in [-1, 1] -> log-mel (B, 1 + n//hop, n_mel), in plain
    PyTorch: the matmul DFT of stft_reim, magnitude, mel projection,
    log(clamp(., CLIP_VAL))."""
    re, im = stft_reim(audio, filter_length, hop_length, win_length)
    basis = torch.from_numpy(mel_basis(sampling_rate, filter_length,
                                       n_mel_channels, mel_fmin, mel_fmax))
    return dynamic_range_compression(
        torch.sqrt(re * re + im * im) @ basis.to(audio).T)


def build():
    """Compile csrc/mel.cu (ops/cuda_build.py) and load it. Returns
    (library, nvcc output, build seconds)."""
    global _lib
    lib, log, seconds = build_library("mel")
    fn = lib.radtts_mel
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.radtts_mel_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.radtts_mel_smem_bytes.restype = ctypes.c_int
    _lib = lib
    return lib, log, seconds


def fft_radices(m):
    """The radices of csrc/mel.cu's Stockham stages for a complex FFT of
    size m (a power of two): radix 4 while 4 divides what is left, then
    one radix 2 (m = 512: 4, 4, 4, 4, 2)."""
    radices = []
    while m % 4 == 0:
        radices.append(4)
        m //= 4
    if m == 2:
        radices.append(2)
    elif m != 1:
        raise ValueError("fft_radices: size is not a power of two")
    return radices


@functools.lru_cache(maxsize=8)
def kernel_constants(filter_length, win_length, sampling_rate, n_mels, fmin,
                     fmax):
    """The kernel's constant inputs, float32/int32 numpy, each rounded once
    from float64:

    window (n_fft,): the periodic Hann window of win_length, zero-padded
      to n_fft;
    twiddles (n_fft, 2): W^e = exp(-2 pi i e / n_fft) as (cos, -sin), e <
      n_fft, for the FFT of size n_fft/2 (W^{2e}) and the real-FFT
      unpacking (W^k);
    fb_packed (nnz,): the slaney filterbank's weights over each filter's
      nonzero bins, one filter after another;
    ranges (n_mels, 3): each filter's first and last + 1 nonzero bin and
      the offset of its weights in fb_packed."""
    n_fft = filter_length
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    twiddles = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    window = hann_window(win_length, n_fft).astype(np.float64)
    fb = mel_basis(sampling_rate, n_fft, n_mels, fmin, fmax)
    nz = fb != 0
    ranges = np.stack([nz.argmax(1), n_fft // 2 + 1 - nz[:, ::-1].argmax(1)],
                      axis=1)
    ranges[~nz.any(1)] = 0
    lengths = ranges[:, 1] - ranges[:, 0]
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    fb_packed = np.concatenate([fb[m, lo:hi] for m, (lo, hi) in
                                enumerate(ranges)]).astype(np.float32)
    return (window.astype(np.float32), twiddles.astype(np.float32),
            fb_packed, np.concatenate([ranges, offsets[:, None]],
                                      axis=1).astype(np.int32))


@functools.lru_cache(maxsize=8)
def _device_constants(device, *settings):
    return tuple(torch.from_numpy(a).to(device)
                 for a in kernel_constants(*settings))


def _launch(audio, kw):
    n_fft, hop, n_mels = (kw["filter_length"], kw["hop_length"],
                          kw["n_mel_channels"])
    B, n = audio.shape
    if audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError("mel: audio must be contiguous float32, got "
                         f"{audio.dtype}")
    if n_fft < 16 or n_fft > 4096 or n_fft & (n_fft - 1) or hop <= 0 \
            or kw["win_length"] > n_fft:
        raise ValueError(f"mel: n_fft={n_fft} must be a power of two in "
                         f"[16, 4096], hop={hop} positive, win_length <= "
                         "n_fft")
    if n <= n_fft // 2:
        raise ValueError(f"mel: {n} samples do not cover the reflect pad of "
                         f"{n_fft // 2}")
    if _lib is None:
        build()
    window, twiddles, fb, ranges = _device_constants(
        audio.device, n_fft, kw["win_length"], kw["sampling_rate"], n_mels,
        kw["mel_fmin"], kw["mel_fmax"])
    out = torch.empty(B, 1 + n // hop, n_mels, device=audio.device)
    with torch.cuda.device(audio.device):
        err = _lib.radtts_mel(
            audio.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
            fb.data_ptr(), ranges.data_ptr(), out.data_ptr(), B, n, n_fft,
            hop, n_mels, fb.numel(), CLIP_VAL,
            torch.cuda.current_stream(audio.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mel: kernel launch failed with cudaError {err} "
                           f"(B={B}, n={n}, n_fft={n_fft})")
    mel.launches += 1
    return out


class MelFunction(torch.autograd.Function):
    """Forward: the kernel. Backward: mel_plain's gradient with respect to
    the audio, recomputed under enable_grad."""

    @staticmethod
    def forward(ctx, audio, mel_kwargs):
        ctx.save_for_backward(audio)
        ctx.mel_kwargs = mel_kwargs
        return _launch(audio, mel_kwargs)

    @staticmethod
    def backward(ctx, grad_out):
        (audio,) = ctx.saved_tensors
        with torch.enable_grad():
            a = audio.detach().requires_grad_(True)
            y = mel_plain(a, **ctx.mel_kwargs)
        (grad,) = torch.autograd.grad(y, a, grad_out)
        return grad, None


def _flop_records(audio, *, filter_length=1024, hop_length=256,
                  n_mel_channels=80, **_):
    """mel's products for ops/flops.py: its plain version's matmul DFT
    (cos and sin bases) and mel projection."""
    rows = audio.shape[0] * (1 + audio.shape[-1] // hop_length)
    F = filter_length // 2 + 1
    dft = flops.record("dot", 1, rows, F, filter_length,
                       nbytes=4 * (rows * filter_length + filter_length * F
                                   + rows * F))
    return [dft, dft, flops.record(
        "dot", 1, rows, n_mel_channels, F,
        nbytes=4 * (rows * F + F * n_mel_channels + rows * n_mel_channels))]


@flops.counted(_flop_records)
def mel(audio, *, filter_length=1024, hop_length=256, win_length=1024,
        n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
        mel_fmax=8000.0):
    """audio: (B, n) float32 -> log-mel (B, 1 + n//hop, n_mel).

    A CPU tensor runs mel_plain. A CUDA tensor launches the hand-written
    kernel through MelFunction, or raises."""
    mel_kwargs = dict(filter_length=filter_length, hop_length=hop_length,
                      win_length=win_length, n_mel_channels=n_mel_channels,
                      sampling_rate=sampling_rate, mel_fmin=mel_fmin,
                      mel_fmax=mel_fmax)
    if audio.device.type == "cpu":
        return mel_plain(audio, **mel_kwargs)
    if audio.device.type != "cuda":
        raise ValueError(f"mel: unsupported device {audio.device}")
    return MelFunction.apply(audio, mel_kwargs)


mel.launches = 0
