"""Coupling layers of the flows (radtts_tpu/models/coupling.py): the
parameter predictors (WN, the non-gated WaveNet; SimpleConvNet), the
affine coupling, the spline coupling of the BGAP
and the full-width spline step of the AGAP (SplineAR). Each has a forward
(training, which also returns log_s) and an inverse (sampling).
`factored=True` builds the WN convs in their weight-normed training form
(start, in_layers, res_skip, as the JAX package's wn_init does); the
SimpleConvNet's convs are plain in both forms, as there.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from radtts_tpu_torch.ops.amp import cast_in, cast_out
from radtts_tpu_torch.ops.conv import ConvNorm, conv1d
from radtts_tpu_torch.ops.invertible import scaling_and_log_s
from radtts_tpu_torch.ops.splines import spline_transform
from radtts_tpu_torch.parallel import collectives


class SimpleConvNet(nn.Module):
    """n_layers same-padded convs of width min(max_channels, 2 * in), the
    i-th dilated 2**i when with_dilation, each followed by a relu, then a
    1x1 conv (zero-initialised when asked). A bf16 region when `amp`
    (ops/amp.py)."""

    amp = False

    def __init__(self, n_in, n_context, final_out, n_layers=2, kernel_size=5,
                 with_dilation=True, max_channels=1024, zero_init=True):
        super().__init__()
        self.layers = nn.ModuleList()
        in_ch = n_in + n_context
        for i in range(n_layers):
            out_ch = min(max_channels, in_ch * 2)
            self.layers.append(ConvNorm(
                in_ch, out_ch, kernel_size,
                dilation=2 ** i if with_dilation else 1, gain_name="relu"))
            in_ch = out_ch
        self.last = ConvNorm(in_ch, final_out, 1, zero_init=zero_init)

    def forward(self, x, mask=None, use_partial_padding=True):
        # PyTorch's own convolutions, not cuDNN's, in every grad mode.
        # Training: each cuDNN conv here is fp32 and within 2e-6 of
        # float64, but rounds 2-7x more than PyTorch's own, and the BGAP
        # step's gradients amplify that rounding (smoothly, and in jumps
        # where a relu input changes sign): on cuDNN they were 1.2e-3 to
        # 4.3e-3 from float64 on an H100, against the CPU's 2.7e-5.
        # Serving: at batch 1 cuDNN's kernels took more of the H100's
        # time, 8.1 ms against 5.9 (PERF.md §6, cuDNN and the BGAP)
        b = torch.backends.cudnn
        with b.flags(enabled=False, benchmark=b.benchmark,
                     deterministic=b.deterministic, allow_tf32=b.allow_tf32):
            x = cast_in(x, self.amp)
            for layer in self.layers:
                x = torch.relu(layer(x, mask, use_partial_padding))
            return cast_out(self.last(x), self.amp)


class WN(nn.Module):
    """The non-gated WaveNet predictor; a bf16 region when `amp`.

    With `tp` (a parallel.mesh.ModelShard, set by parallel.shard_model)
    it holds its rank's slice of the hidden channels: start, in_layers and
    res_skip compute theirs from the whole input (weight norm per output
    channel, so local), and end contracts them into a partial sum, reduced
    over the model group before its bias is added (the JAX package's
    tensor-parallel WN, radtts_tpu/parallel/mesh.py)."""

    amp = False
    tp = None

    def __init__(self, n_in, n_context, n_layers, n_channels, kernel_size=5,
                 factored=False):
        super().__init__()
        wn = factored
        self.start = ConvNorm(n_in + n_context, n_channels, 1, weight_norm=wn)
        self.end = ConvNorm(n_channels, 2 * n_in, 1, zero_init=True)
        self.in_layers = nn.ModuleList(
            ConvNorm(n_channels, n_channels, kernel_size, dilation=2 ** i,
                     weight_norm=wn)
            for i in range(n_layers))
        self.res_skip = nn.ModuleList(
            ConvNorm(n_channels, n_channels, 1, weight_norm=wn)
            for _ in range(n_layers))

    def forward(self, z, context, mask=None, affine_activation="softplus",
                use_partial_padding=True):
        act = F.softplus if affine_activation == "softplus" else torch.relu
        if self.tp is not None:
            return self._forward_sharded(z, context, mask, act,
                                         use_partial_padding)
        z = self.start(cast_in(torch.cat([z, context], dim=-1), self.amp))
        output = torch.zeros_like(z)
        for in_layer, res_skip in zip(self.in_layers, self.res_skip):
            z = act(in_layer(z, mask, use_partial_padding))
            output = output + act(res_skip(z))
        return cast_out(self.end(output), self.amp)

    def _forward_sharded(self, z, context, mask, act, use_partial_padding):
        tp = self.tp
        x = collectives.copy_to_group(
            cast_in(torch.cat([z, context], dim=-1), self.amp), tp)
        h = collectives.gather(self.start(x), tp)
        output = 0.0
        for in_layer, res_skip in zip(self.in_layers, self.res_skip):
            h = collectives.gather(act(in_layer(h, mask, use_partial_padding)),
                                   tp)
            output = output + act(res_skip(h))
        y = collectives.reduce(conv1d(output, self.end.weight), tp)
        return cast_out(y + self.end.bias.to(y.dtype), self.amp)


class AffineCoupling(nn.Module):
    def __init__(self, n_channels_total, n_context, n_layers,
                 affine_model="wavenet", n_hidden=1024, factored=False,
                 with_dilation=True, kernel_size=5):
        super().__init__()
        self.n_half = n_channels_total // 2
        self.affine_model = affine_model
        if affine_model == "wavenet":
            self.pred = WN(self.n_half, n_context, n_layers, n_hidden,
                           kernel_size=5, factored=factored)
        elif affine_model == "simple_conv":
            self.pred = SimpleConvNet(self.n_half, n_context,
                                      n_channels_total, n_layers,
                                      kernel_size=kernel_size,
                                      with_dilation=with_dilation,
                                      zero_init=True)
        else:
            raise ValueError(f"{affine_model} affine model not supported")

    def _params(self, z0, context, mask, affine_activation,
                use_partial_padding):
        if self.affine_model == "wavenet":
            return self.pred(z0, context, mask=mask,
                             affine_activation=affine_activation,
                             use_partial_padding=use_partial_padding)
        return self.pred(torch.cat([z0, context], dim=-1), mask,
                         use_partial_padding)

    def forward(self, z, context, *, scaling_fn,
                affine_activation="softplus", mask=None,
                use_partial_padding=True):
        """(z with its second half s * z1 + b, log_s)
        (radtts_tpu/models/coupling.py:148-176)."""
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        affine_params = self._params(z0, context, mask, affine_activation,
                                     use_partial_padding)
        s, log_s = scaling_and_log_s(affine_params[..., :self.n_half],
                                     scaling_fn)
        z1 = s * z1 + affine_params[..., self.n_half:]
        return torch.cat([z0, z1], dim=-1), log_s

    def inverse(self, z, context, *, scaling_fn,
                affine_activation="softplus", mask=None,
                use_partial_padding=True):
        z0, z1 = z[..., :self.n_half], z[..., self.n_half:]
        affine_params = self._params(z0, context, mask, affine_activation,
                                     use_partial_padding)
        s, _ = scaling_and_log_s(affine_params[..., :self.n_half],
                                 scaling_fn)
        z1 = (z1 - affine_params[..., self.n_half:]) / s
        return torch.cat([z0, z1], dim=-1)


class SplineCoupling(nn.Module):
    """The BGAP's spline coupling (radtts_tpu/models/coupling.py:179-242):
    the second half through a monotone spline on [left, right] ->
    [bottom, top] whose bins a SimpleConvNet predicts from the first half
    and the context; identity outside the range."""

    def __init__(self, n_channels_total, n_context, n_layers,
                 with_dilation=True, kernel_size=5, n_bins=8, left=-4.0,
                 right=4.0, bottom=-4.0, top=4.0, use_quadratic=False):
        super().__init__()
        self.n_half = n_channels_total // 2
        self.n_bins = 2 * n_bins + 1 if use_quadratic else n_bins
        self.use_quadratic = use_quadratic
        self.left, self.right = left, right
        self.bottom, self.top = bottom, top
        self.pred = SimpleConvNet(self.n_half, n_context,
                                  self.n_half * self.n_bins, n_layers,
                                  kernel_size=kernel_size,
                                  with_dilation=with_dilation,
                                  zero_init=False)

    def _transform(self, z, context, mask, inverse):
        B, T, _ = z.shape
        n = self.n_half
        z0, z1 = z[..., :n], z[..., n:]
        if inverse:
            z1 = (z1 - self.bottom) / (self.top - self.bottom)
        else:
            z1 = (z1 - self.left) / (self.right - self.left)
        q_tilde = self.pred(torch.cat([z0, context], dim=-1), mask)
        z1, log_s = spline_transform(z1.reshape(B * T, n),
                                     q_tilde.reshape(B * T, n, self.n_bins),
                                     self.n_bins, self.use_quadratic,
                                     inverse)
        return z0, z1.reshape(B, T, n), log_s

    def forward(self, z, context, mask=None):
        B, T, _ = z.shape
        z0, z1, log_s = self._transform(z, context, mask, False)
        if self.use_quadratic:
            log_s = log_s.sum(1)
        z1 = z1 * (self.top - self.bottom) + self.bottom
        log_s = log_s.reshape(B, T, 1) + self.n_half * (
            math.log(self.top - self.bottom)
            - math.log(self.right - self.left))
        return torch.cat([z0, z1], dim=-1), log_s

    def inverse(self, z, context, mask=None):
        z0, z1, _ = self._transform(z, context, mask, True)
        z1 = z1 * (self.right - self.left) + self.left
        return torch.cat([z0, z1], dim=-1)


class SplineAR(nn.Module):
    """The AGAP's full-width spline step (radtts_tpu/models/coupling.py:
    245-299): every channel of z through a spline whose bins a 1x1
    SimpleConvNet (zero-initialised last layer) predicts from the context
    alone."""

    def __init__(self, n_in_channels, n_context_dim, n_layers, n_bins=8,
                 left=-6.0, right=6.0, bottom=-6.0, top=6.0,
                 use_quadratic=False):
        super().__init__()
        self.n_in = n_in_channels
        self.n_bins = 2 * n_bins + 1 if use_quadratic else n_bins
        self.use_quadratic = use_quadratic
        self.left, self.right = left, right
        self.bottom, self.top = bottom, top
        self.pred = SimpleConvNet(n_context_dim, 0,
                                  n_in_channels * self.n_bins, n_layers,
                                  kernel_size=1, with_dilation=False,
                                  zero_init=True)

    def bins(self, context):
        """The spline parameters (B, T, n_in * n_bins) of a context."""
        return self.pred(context, None, use_partial_padding=False)

    def transform(self, z, q_tilde, inverse):
        """The spline of z (B, T, n_in) by bins q_tilde: (y, log_s), the
        range scaling applied, log_s None for the inverse."""
        B, T, c = z.shape
        if inverse:
            z = (z - self.bottom) / (self.top - self.bottom)
        else:
            z = (z - self.left) / (self.right - self.left)
        y, log_s = spline_transform(z.reshape(B * T, c),
                                    q_tilde.reshape(B * T, c, self.n_bins),
                                    self.n_bins, self.use_quadratic, inverse)
        y = y.reshape(B, T, c)
        if inverse:
            return y * (self.right - self.left) + self.left, None
        y = y * (self.top - self.bottom) + self.bottom
        # the linear spline sums its log-J over channels already
        log_s = log_s.reshape(B, T, 1 if log_s.ndim == 1 else c)
        return y, log_s + c * (math.log(self.top - self.bottom)
                               - math.log(self.right - self.left))

    def forward(self, z, context):
        return self.transform(z, self.bins(context), False)

    def inverse(self, z, context):
        return self.transform(z, self.bins(context), True)[0]
