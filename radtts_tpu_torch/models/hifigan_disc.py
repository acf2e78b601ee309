"""HiFi-GAN discriminators and GAN losses for vocoder training (reference
hifigan_models.py:228-384), as the JAX package's
radtts_tpu/models/hifigan_disc.py computes them.

Two places follow the JAX package where it differs from upstream HiFi-GAN:
the convs hold plain (weight, bias) with neither weight norm nor spectral
norm, and a period discriminator pads a segment whose length is not a
multiple of its period with a flipped copy of its last samples, edge sample
included (not F.pad's "reflect"). Feature maps are channels-first (NCHW and
NCT), as the convs produce them; scores are flattened per batch row.
"""

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)
# kernel height and stride of the period discriminator's first four convs
P_KERNEL, P_STRIDE = 5, 3
N_SCALES = 3
# (in, out, kernel, stride, groups, padding) of the scale discriminator
S_SPECS = [
    (1, 128, 15, 1, 1, 7),
    (128, 128, 41, 2, 4, 20),
    (128, 256, 41, 2, 16, 20),
    (256, 512, 41, 4, 16, 20),
    (512, 1024, 41, 4, 16, 20),
    (1024, 1024, 41, 1, 16, 20),
    (1024, 1024, 5, 1, 1, 2),
]


class _Conv(nn.Module):
    """A conv's weight in torch layout, normal(0, 0.01), and a zero bias."""

    def __init__(self, shape):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(shape) * 0.01)
        self.bias = nn.Parameter(torch.zeros(shape[0]))


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform folded to (T / period, period)
    and run through 2-D convs along the first axis."""

    def __init__(self, period):
        super().__init__()
        self.period = period
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
        self.convs = nn.ModuleList(_Conv((c_out, c_in, P_KERNEL, 1))
                                   for c_in, c_out in chans)
        self.post = _Conv((1, 1024, 3, 1))

    def forward(self, x):
        """x: (B, T) waveform -> (score (B, -1), feature maps)."""
        B, T = x.shape
        if T % self.period:
            n_pad = self.period - T % self.period
            x = torch.cat([x, x[:, -n_pad:].flip(1)], 1)
        h = x.reshape(B, 1, -1, self.period)
        fmap = []
        for i, conv in enumerate(self.convs):
            stride = P_STRIDE if i < len(self.convs) - 1 else 1
            h = F.leaky_relu(F.conv2d(h, conv.weight, conv.bias,
                                      stride=(stride, 1), padding=(2, 0)),
                             LRELU_SLOPE)
            fmap.append(h)
        h = F.conv2d(h, self.post.weight, self.post.bias, padding=(1, 0))
        fmap.append(h)
        return h.reshape(B, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided 1-D convs over the waveform."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(_Conv((co, ci // g, k))
                                   for ci, co, k, s, g, p in S_SPECS)
        self.post = _Conv((1, 1024, 3))

    def forward(self, x):
        """x: (B, T) waveform -> (score (B, -1), feature maps)."""
        h = x[:, None]
        fmap = []
        for conv, (ci, co, k, s, g, p) in zip(self.convs, S_SPECS):
            h = F.leaky_relu(F.conv1d(h, conv.weight, conv.bias, stride=s,
                                      padding=p, groups=g), LRELU_SLOPE)
            fmap.append(h)
        h = F.conv1d(h, self.post.weight, self.post.bias, padding=1)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


def _discriminate(discs, ys, y_hats):
    """(real scores, generated scores, real fmaps, generated fmaps)."""
    outs = ([], [], [], [])
    for d, y, y_hat in zip(discs, ys, y_hats):
        s_r, f_r = d(y)
        s_g, f_g = d(y_hat)
        for out, v in zip(outs, (s_r, s_g, f_r, f_g)):
            out.append(v)
    return outs


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discs = nn.ModuleList(DiscriminatorP(p) for p in PERIODS)

    def forward(self, y, y_hat):
        n = len(self.discs)
        return _discriminate(self.discs, [y] * n, [y_hat] * n)


def avg_pool1d(x, k=4, stride=2, pad=2):
    """(B, T) mean over windows of k, zero padding counted."""
    return F.avg_pool1d(x[:, None], k, stride, pad)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators on the waveform, then on it average-pooled
    once and twice."""

    def __init__(self):
        super().__init__()
        self.discs = nn.ModuleList(DiscriminatorS() for _ in range(N_SCALES))

    def forward(self, y, y_hat):
        ys, y_hats = [y], [y_hat]
        for _ in range(len(self.discs) - 1):
            ys.append(avg_pool1d(ys[-1]))
            y_hats.append(avg_pool1d(y_hats[-1]))
        return _discriminate(self.discs, ys, y_hats)


def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl - gl).abs().mean()
    return loss * 2


def discriminator_loss(real_outputs, generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outputs, generated_outputs):
        r_loss = (1 - dr).square().mean()
        g_loss = dg.square().mean()
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        g_loss = (1 - dg).square().mean()
        gen_losses.append(g_loss)
        loss = loss + g_loss
    return loss, gen_losses
