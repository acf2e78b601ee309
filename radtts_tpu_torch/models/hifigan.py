"""HiFi-GAN vocoder (generator with ResBlock1 MRF stages), the spectral
bias denoiser, the mel blur augmentation of vocoder training, and the
generator's reference-format state dicts.

The generator takes and returns channels-last tensors: mel (B, T, 80) ->
waveform (B, T * prod(upsample_rates)). conv_pre, the ConvTranspose1d ups
and conv_post run as F.conv1d / F.conv_transpose1d; each stage's MRF
resblock stack runs through ops/mrf.py:mrf, the port of the TPU's Pallas
MRF kernels (hand-written CUDA kernels on the card).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.mrf import DILATIONS, LRELU_SLOPE, mrf, mrf_plain
from radtts_tpu_torch.ops.stft import (istft_length, istft_reim,
                                       stft_magnitude_phase, stft_reim)

_TINY = torch.finfo(torch.float32).tiny
# the gaussian kernels of the mel blur augmentation
BLUR_KERNEL_SIZE = (5, 5)
BLUR_SIGMAS = (0.1, 0.5, 1.0)


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

    def forward(self, mel, mrf_impl="auto"):
        """mel (B, T, 80) -> waveform (B, T * prod(upsample_rates)).

        mrf_impl: "auto" runs each MRF stage through ops/mrf.py:mrf (the
        kernel on the card, mrf_plain on the CPU); "plain" runs mrf_plain,
        which a pass that needs gradients takes, since the kernel has no
        backward (the JAX package's "xla")."""
        if mrf_impl not in ("auto", "plain"):
            raise ValueError(f"mrf_impl must be 'auto' or 'plain', got "
                             f"{mrf_impl!r}")
        mrf_fn = mrf if mrf_impl == "auto" else mrf_plain
        x = self.conv_pre(mel)
        for up, stage in zip(self.ups, self.resblocks):
            x = up(F.leaky_relu(x, LRELU_SLOPE)).contiguous()
            x = mrf_fn(x, [blk.weights() for blk in stage])
        # default torch slope 0.01 before the post conv (reference)
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[..., 0]


def gaussian_blur_kernels(kernel_size, sigmas):
    """Normalized 2D gaussian kernels, one per sigma
    (reference: hifigan_models.py:34-69). Returns (n_sigmas, kh, kw) fp32."""
    kh, kw = kernel_size
    gy = np.arange(kh, dtype=np.float32)[:, None]
    gx = np.arange(kw, dtype=np.float32)[None, :]
    kernels = []
    for s in sigmas:
        k = (np.exp(-(((gy - (kh - 1) / 2) / s) ** 2) / 2)
             * np.exp(-(((gx - (kw - 1) / 2) / s) ** 2) / 2))
        kernels.append(k / k.sum())
    return torch.from_numpy(np.stack(kernels))


def _blur(mel, index, uniform, p_blurring):
    """The blur for given draws: kernel `index` of BLUR_SIGMAS, applied
    unless uniform > p_blurring."""
    if uniform > p_blurring:
        return mel
    kernel = gaussian_blur_kernels(BLUR_KERNEL_SIZE,
                                   BLUR_SIGMAS)[index].to(mel)
    pad = (BLUR_KERNEL_SIZE[0] - 1) // 2
    x = F.pad(mel[:, None], (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(x, kernel[None, None])[:, 0]


def gaussian_blur_augmentation(mel, generator=None, p_blurring=0.0):
    """With probability p_blurring, blur the (B, T, n_mel) mel with a
    randomly chosen gaussian kernel (reference: hifigan_models.py:71-80;
    used on the generator's input mel during vocoder training). The kernel
    index and the uniform are drawn from the torch.Generator `generator`."""
    if p_blurring <= 0.0:
        return mel
    index = int(torch.randint(len(BLUR_SIGMAS), (), generator=generator))
    uniform = float(torch.rand((), generator=generator))
    return _blur(mel, index, uniform, p_blurring)


def _remap_legacy_keys(sd):
    """Old checkpoints use flat resblocks.N.*; the layout here is
    resblocks.{N//3}.{N%3}.* (reference: hifigan_models.py:186-198)."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if "resblocks" in k and len(parts) == 5:
            layer = int(parts[1])
            k = f"resblocks.{layer // 3}.{layer % 3}." + ".".join(parts[2:])
        out[k] = v
    return out


def _collapse_weight_norm(sd, prefix):
    """A weight-normed conv's kernel g * v / ||v|| (norm over every dim but
    the first), float32 numpy in the checkpoint's layout."""
    g = sd[prefix + ".weight_g"].detach().cpu().numpy()
    v = sd[prefix + ".weight_v"].detach().cpu().numpy()
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return (g * v / norm).astype(np.float32)


def generator_from_reference(state_dict, h):
    """Generator holding a reference-format HiFi-GAN state dict (weight-
    normed convs, legacy flat resblock keys accepted), as the JAX package's
    hifigan_generator_from_torch reads it. The ConvTranspose1d kernels keep
    the torch layout, so unlike the JAX package nothing is flipped."""
    sd = _remap_legacy_keys(state_dict)
    gen = Generator(h)

    def load(param, array):
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.ascontiguousarray(array)))

    def conv(mod, prefix):
        load(mod.weight, _collapse_weight_norm(sd, prefix))
        load(mod.bias, sd[prefix + ".bias"].detach().cpu().numpy())

    conv(gen.conv_pre, "conv_pre")
    conv(gen.conv_post, "conv_post")
    for i, (up, stage) in enumerate(zip(gen.ups, gen.resblocks)):
        conv(up, f"ups.{i}")
        for j, blk in enumerate(stage):
            for n in (1, 2):
                base = f"resblocks.{i}.{j}.convs{n}"
                load(getattr(blk, f"w{n}"), np.stack([
                    _collapse_weight_norm(sd, f"{base}.{m}").transpose(2, 1, 0)
                    for m in range(len(DILATIONS))]))
                load(getattr(blk, f"b{n}"), np.stack([
                    sd[f"{base}.{m}.bias"].detach().cpu().numpy()
                    for m in range(len(DILATIONS))]))
    return gen


def generator_to_reference(gen):
    """The generator as a reference-format state dict ({'generator': sd} is
    the checkpoint format): weight_v = w and weight_g = ||w|| over every dim
    but the first, a weight-norm factorization that collapses back to w.
    Equal to the JAX package's hifigan_generator_to_torch on the same
    weights."""
    sd = {}

    def entry(prefix, w, b):
        w = np.ascontiguousarray(w, np.float32)
        g = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
        sd[prefix + ".weight_g"] = torch.from_numpy(g.astype(np.float32))
        sd[prefix + ".weight_v"] = torch.from_numpy(w)
        sd[prefix + ".bias"] = torch.from_numpy(np.array(b, np.float32))

    def numpy(t):
        return t.detach().cpu().numpy()

    entry("conv_pre", numpy(gen.conv_pre.weight), numpy(gen.conv_pre.bias))
    for i, up in enumerate(gen.ups):
        entry(f"ups.{i}", numpy(up.weight), numpy(up.bias))
    for i, stage in enumerate(gen.resblocks):
        for j, blk in enumerate(stage):
            for n in (1, 2):
                w = numpy(getattr(blk, f"w{n}"))
                b = numpy(getattr(blk, f"b{n}"))
                for m in range(len(DILATIONS)):
                    entry(f"resblocks.{i}.{j}.convs{n}.{m}",
                          w[m].transpose(2, 1, 0), b[m])
    entry("conv_post", numpy(gen.conv_post.weight), numpy(gen.conv_post.bias))
    return sd


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
