"""HiFi-GAN vocoder (generator with ResBlock1 MRF stages) and the spectral
bias denoiser, inference side.

The generator takes and returns channels-last tensors: mel (B, T, 80) ->
waveform (B, T * prod(upsample_rates)). conv_pre, the ConvTranspose1d ups
and conv_post run as F.conv1d / F.conv_transpose1d; each stage's MRF
resblock stack runs through ops/mrf.py:mrf, the port of the TPU's Pallas
MRF kernels (a hand-written CUDA kernel on the card).
"""

import torch
import torch.nn.functional as F
from torch import nn

from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.mrf import DILATIONS, LRELU_SLOPE, mrf
from radtts_tpu_torch.ops.stft import (istft_length, istft_reim,
                                       stft_magnitude_phase, stft_reim)

_TINY = torch.finfo(torch.float32).tiny


def _normal(shape, std=0.01):
    return nn.Parameter(torch.randn(shape) * std)


class MRFBlock(nn.Module):
    """One ResBlock1: w1/w2 (3, k, C, C) taps-major, b1/b2 (3, C)."""

    def __init__(self, C, k):
        super().__init__()
        n = len(DILATIONS)
        self.w1 = _normal((n, k, C, C))
        self.w2 = _normal((n, k, C, C))
        self.b1 = nn.Parameter(torch.zeros(n, C))
        self.b2 = nn.Parameter(torch.zeros(n, C))

    def weights(self):
        return {"w1": self.w1, "b1": self.b1, "w2": self.w2, "b2": self.b2}


class Upsample(nn.Module):
    """ConvTranspose1d, weight in torch layout (C_in, C_out, K)."""

    def __init__(self, c_in, c_out, k, stride):
        super().__init__()
        self.weight = _normal((c_in, c_out, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = stride
        self.padding = (k - stride) // 2

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                               stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class Generator(nn.Module):
    """HiFi-GAN generator from a reference hifigan config `h`, with the
    reference's normal(0, 0.01) random init."""

    def __init__(self, h, n_mel=80):
        super().__init__()
        if h["resblock"] != "1" or any(
                tuple(d) != DILATIONS for d in h["resblock_dilation_sizes"]):
            raise NotImplementedError(
                "only ResBlock1 with dilations (1, 3, 5) is ported")
        ch0 = h["upsample_initial_channel"]
        self.conv_pre = ConvNorm(n_mel, ch0, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                       h["upsample_kernel_sizes"])):
            c_in, c_out = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
            self.ups.append(Upsample(c_in, c_out, k, u))
            self.resblocks.append(nn.ModuleList(
                MRFBlock(c_out, ks) for ks in h["resblock_kernel_sizes"]))
        self.conv_post = ConvNorm(c_out, 1, 7)
        for conv in (self.conv_pre, self.conv_post):
            nn.init.normal_(conv.weight, std=0.01)
            nn.init.zeros_(conv.bias)

    def forward(self, mel):
        x = self.conv_pre(mel)
        for up, stage in zip(self.ups, self.resblocks):
            x = up(F.leaky_relu(x, LRELU_SLOPE)).contiguous()
            x = mrf(x, [blk.weights() for blk in stage])
        # default torch slope 0.01 before the post conv (reference)
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[..., 0]


class Denoiser(nn.Module):
    """The vocoder's bias magnitude spectrum bias_spec (1, 1, n_fft//2+1)
    and its STFT settings; built by denoiser_init."""

    def __init__(self, bias_spec, filter_length, hop_length, win_length):
        super().__init__()
        self.register_buffer("bias_spec", bias_spec)
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length


@torch.no_grad()
def denoiser_init(generator, filter_length=1024, n_overlap=4,
                  win_length=1024):
    """Bias spectrum: the first frame of the vocoder's magnitude spectrum
    on a zeros (1, 88, 80) mel."""
    hop = filter_length // n_overlap
    device = next(generator.parameters()).device
    audio = generator(torch.zeros(1, 88, 80, device=device))
    spec, _ = stft_magnitude_phase(audio, filter_length, hop, win_length)
    return Denoiser(spec[:, 0:1, :].clone(), filter_length, hop, win_length)


def denoiser_apply(denoiser, audio, strength=0.1):
    """audio: (B, n). Subtract strength x the bias magnitude at unchanged
    phase, as a rescaling of (re, im). strength <= 0 returns the input,
    conformed to the length the STFT round trip would give."""
    n_fft, hop, win = (denoiser.filter_length, denoiser.hop_length,
                       denoiser.win_length)
    if strength <= 0:
        n_out = istft_length(audio.shape[-1], n_fft, hop)
        if n_out <= audio.shape[-1]:
            return audio[..., :n_out]
        return F.pad(audio, (0, n_out - audio.shape[-1]))
    re, im = stft_reim(audio, n_fft, hop, win)
    mag = torch.sqrt(re * re + im * im)
    scale = (mag - denoiser.bias_spec * strength).clamp(min=0.0) \
        / mag.clamp(min=_TINY)
    return istft_reim(re * scale, im * scale, n_fft, hop, win)
