"""HiFi-GAN vocoder (generator with ResBlock1 or ResBlock2 MRF stages), the
spectral bias denoiser, the mel blur augmentation of vocoder training, and
the generator's reference-format state dicts.

The generator takes and returns channels-last tensors: mel (B, T, 80) ->
waveform (B, T * prod(upsample_rates)). conv_pre, the ConvTranspose1d ups
and conv_post run as F.conv1d / F.conv_transpose1d. The MRF resblock stacks
take one of two routes, decided by the architecture alone, as the JAX
package decides between its Pallas kernels and XLA
(radtts_tpu/models/hifigan.py:253-257): a ResBlock1 generator whose kernel
sizes are a prefix of (3, 7, 11) and whose dilations are all (1, 3, 5)
runs each stage through ops/mrf.py:mrf, the port of the TPU's Pallas MRF
kernels (hand-written CUDA kernels on the card); any other generator
(ResBlock2, other kernel sizes or dilations) runs each resblock as a chain
of F.conv1d, as the JAX package runs those through XLA.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radtts_tpu_torch import tracing
from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.mrf import (DILATIONS, KERNEL_SIZES, LRELU_SLOPE,
                                      mrf, mrf_plain)
from radtts_tpu_torch.ops.stft import (istft_length, istft_reim,
                                       stft_magnitude_phase, stft_reim)

_TINY = torch.finfo(torch.float32).tiny
# the gaussian kernels of the mel blur augmentation
BLUR_KERNEL_SIZE = (5, 5)
BLUR_SIGMAS = (0.1, 0.5, 1.0)
# convs per resblock of each kind in the reference's state dicts: ResBlock1
# stores convs1.{0,1,2} and convs2.{0,1,2}, ResBlock2 convs.{0,1}
RESBLOCK_CONVS = {"1": 3, "2": 2}


def _normal(shape, std=0.01):
    return nn.Parameter(torch.randn(shape) * std)


def mrf_kernel_compatible(h):
    """Whether a generator config's MRF stages run on the hand kernels:
    the JAX package's _mrf_is_pallas_compatible (ResBlock1, kernel sizes a
    prefix of (3, 7, 11), every dilation tuple (1, 3, 5))."""
    rk = tuple(h["resblock_kernel_sizes"])
    return (h["resblock"] == "1" and rk == KERNEL_SIZES[:len(rk)]
            and all(tuple(d) == DILATIONS
                    for d in h["resblock_dilation_sizes"]))


class MRFBlock(nn.Module):
    """One resblock of kernel size k. ResBlock1 (kind "1"): w1/w2 (3, k, C,
    C) taps-major, b1/b2 (3, C), x += conv_{k,1}(lrelu(conv_{k,d}(lrelu
    x))) per dilation d; ResBlock2 (kind "2"): w1 (2, k, C, C), b1 (2, C),
    x += conv_{k,d}(lrelu x). As in the reference, the i-th conv takes the
    i-th dilation, and convs past the dilations given are not applied."""

    def __init__(self, C, k, dilations=DILATIONS, kind="1"):
        super().__init__()
        if kind not in RESBLOCK_CONVS:
            raise ValueError(f"resblock must be '1' or '2', got {kind!r}")
        n = RESBLOCK_CONVS[kind]
        self.kind = kind
        self.kernel_size = k
        self.dilations = tuple(dilations)[:n]
        self.w1 = _normal((n, k, C, C))
        self.b1 = nn.Parameter(torch.zeros(n, C))
        if kind == "1":
            self.w2 = _normal((n, k, C, C))
            self.b2 = nn.Parameter(torch.zeros(n, C))

    def weights(self):
        """The layout ops/mrf.py's kernels and mrf_plain take (ResBlock1
        with dilations (1, 3, 5) only)."""
        return {"w1": self.w1, "b1": self.b1, "w2": self.w2, "b2": self.b2}

    def conv_weights(self):
        """{name: (weight (n, k, C, C), bias (n, C))} by the reference's
        conv names (convs1/convs2, or convs)."""
        if self.kind == "1":
            return {"convs1": (self.w1, self.b1), "convs2": (self.w2, self.b2)}
        return {"convs": (self.w1, self.b1)}

    def forward(self, x):
        """x: (B, C, T) -> (B, C, T), one F.conv1d per conv."""
        k = self.kernel_size
        for i, d in enumerate(self.dilations):
            xt = _conv(F.leaky_relu(x, LRELU_SLOPE), self.w1[i], self.b1[i],
                       k, d)
            if self.kind == "1":
                xt = _conv(F.leaky_relu(xt, LRELU_SLOPE), self.w2[i],
                           self.b2[i], k, 1)
            x = xt + x
        return x


def _conv(x, w_taps, b, k, d):
    """Same-padded conv of (B, C, T) with taps-major (k, C_in, C_out)
    weights, padded as the reference's get_padding (d * (k - 1) // 2)."""
    return F.conv1d(x, w_taps.permute(2, 1, 0), b, padding=d * (k - 1) // 2,
                    dilation=d)


def mrf_chain(x, stage):
    """The MRF mean of one stage as a chain of convs: x (B, T, C) ->
    (B, T, C), the JAX package's _resblock1_apply / _resblock2_apply."""
    xc = x.transpose(1, 2)
    out = torch.zeros_like(xc)
    for blk in stage:
        out = out + blk(xc)
    return (out / len(stage)).transpose(1, 2)


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
    """HiFi-GAN generator from a reference hifigan config `h` (ResBlock1 or
    ResBlock2, any kernel sizes and dilations), with the reference's
    normal(0, 0.01) random init. `mrf_kernels` says whether its MRF stages
    take ops/mrf.py (mrf_kernel_compatible) or the conv chain."""

    def __init__(self, h, n_mel=80):
        super().__init__()
        ch0 = h["upsample_initial_channel"]
        self.mrf_kernels = mrf_kernel_compatible(h)
        self.conv_pre = ConvNorm(n_mel, ch0, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                       h["upsample_kernel_sizes"])):
            c_in, c_out = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
            self.ups.append(Upsample(c_in, c_out, k, u))
            self.resblocks.append(nn.ModuleList(
                MRFBlock(c_out, ks, d, h["resblock"])
                for ks, d in zip(h["resblock_kernel_sizes"],
                                 h["resblock_dilation_sizes"])))
        self.conv_post = ConvNorm(c_out, 1, 7)
        for conv in (self.conv_pre, self.conv_post):
            nn.init.normal_(conv.weight, std=0.01)
            nn.init.zeros_(conv.bias)

    def forward(self, mel, mrf_impl="auto"):
        """mel (B, T, 80) -> waveform (B, T * prod(upsample_rates)).

        mrf_impl, for a generator whose stages take the hand kernels:
        "auto" runs each MRF stage through ops/mrf.py:mrf (the kernel on
        the card, mrf_plain on the CPU); "plain" runs mrf_plain, which a
        pass that needs gradients takes, since the kernel has no backward
        (the JAX package's "xla"). Any other generator runs the conv
        chain (mrf_chain) either way."""
        if mrf_impl not in ("auto", "plain"):
            raise ValueError(f"mrf_impl must be 'auto' or 'plain', got "
                             f"{mrf_impl!r}")
        mrf_fn = mrf if mrf_impl == "auto" else mrf_plain
        with tracing.span("vocoder", mel.device):
            x = self.conv_pre(mel)
            for up, stage in zip(self.ups, self.resblocks):
                x = up(F.leaky_relu(x, LRELU_SLOPE)).contiguous()
                # around the call of `mrf`, not inside it: a kernel's
                # device-side annotation goes to the innermost profiler
                # range, and a caller that wraps the module's `mrf` in a
                # range of its own keeps it
                with tracing.span("mrf", x.device) as rec:
                    if rec is not None:
                        rec["attrs"].update(shape=tuple(x.shape),
                                            kernel_sizes=tuple(
                                                blk.kernel_size
                                                for blk in stage))
                    if self.mrf_kernels:
                        x = mrf_fn(x, [blk.weights() for blk in stage])
                    else:
                        x = mrf_chain(x, stage)
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
    hifigan_generator_from_torch reads it: ResBlock1's convs1.{m} and
    convs2.{m}, ResBlock2's convs.{m}. The ConvTranspose1d kernels keep
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
            for name, (w, b) in blk.conv_weights().items():
                base = f"resblocks.{i}.{j}.{name}"
                load(w, np.stack([
                    _collapse_weight_norm(sd, f"{base}.{m}").transpose(2, 1, 0)
                    for m in range(w.shape[0])]))
                load(b, np.stack([
                    sd[f"{base}.{m}.bias"].detach().cpu().numpy()
                    for m in range(w.shape[0])]))
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
            for name, (w, b) in blk.conv_weights().items():
                w, b = numpy(w), numpy(b)
                for m in range(w.shape[0]):
                    entry(f"resblocks.{i}.{j}.{name}.{m}",
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
    with tracing.span("denoiser", audio.device):
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
