"""Attribute predictors for duration, f0, energy and voicing
(radtts_tpu/models/attributes.py), in three families chosen per attribute
by the config's name:

  * DAP: the deterministic regressor (bottleneck + ConvLSTMLinear, or
    with use_transformer the FFTransformer); its training forward draws
    dropout from an explicit generator;
  * BGAP: a bipartite flow over grouped frames, affine (simple_conv)
    couplings then spline couplings, each after an invertible 1x1;
  * AGAP: an autoregressive flow, forward and backward AR steps with LSTM
    conditioning. Training runs each step teacher-forced over whole
    sequences (cuDNN LSTMs); sampling runs each step's inverse frame by
    frame (ops/ar_scan.py: the csrc/ar_scan.cu kernel on the card).

`factored=True` builds the training form (weight-normed convs where the
JAX package has them, the LSTM's norm factorization, the plain 1x1's W
as a parameter).

Grouping uses torch nn.Unfold's channel ordering (c*g + j), as the JAX
package does, so grouped tensors line up channel for channel.
"""

import torch
from torch import nn

from radtts_tpu_torch import tracing
from radtts_tpu_torch.models.coupling import (AffineCoupling, SplineAR,
                                              SplineCoupling)
from radtts_tpu_torch.models.fftransformer import FFTransformer
from radtts_tpu_torch.ops.amp import cast_in, cast_out
from radtts_tpu_torch.ops.ar_scan import ar_scan, ar_scan_multi
from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.dropout import dropout
from radtts_tpu_torch.ops.invertible import InvConv1x1, scaling_and_log_s
from radtts_tpu_torch.ops.linear import DenseLayer, LinearNorm
from radtts_tpu_torch.ops.lstm import LSTM, MaskedLSTM
from radtts_tpu_torch.ops.masking import sequence_mask


def unfold_group(x, g):
    """x: (B, T, C) -> (B, T//g, C*g) with torch Unfold channel ordering."""
    if g == 1:
        return x
    B, T, C = x.shape
    Tg = T // g
    x = x[:, : Tg * g].reshape(B, Tg, g, C).transpose(2, 3)
    return x.reshape(B, Tg, C * g)


def fold_group(x, g):
    """Inverse of unfold_group. x: (B, Tg, C*g) -> (B, Tg*g, C)."""
    if g == 1:
        return x
    B, Tg, Cg = x.shape
    x = x.reshape(B, Tg, Cg // g, g).transpose(2, 3)
    return x.reshape(B, Tg * g, Cg // g)


def attr_normalize(x, take_log):
    return torch.log(x + 1.0) if take_log else x


def attr_denormalize(x, take_log):
    return torch.exp(x) - 1.0 if take_log else x


class Bottleneck(nn.Module):
    def __init__(self, in_dim, reduction_factor, norm="weightnorm",
                 non_linearity="relu", kernel_size=3,
                 use_partial_padding=False, factored=False):
        # use_partial_padding is accepted for config parity; the reference
        # never forwards it to its conv
        super().__init__()
        self.reduction_factor = reduction_factor
        self.non_linearity = non_linearity
        self.out_dim = int(in_dim / reduction_factor)
        self.proj = ConvNorm(in_dim, self.out_dim, kernel_size,
                             weight_norm=factored and norm == "weightnorm")

    def forward(self, x):
        if self.reduction_factor <= 1:
            return x
        y = self.proj(x)
        if self.non_linearity == "leakyrelu":
            return nn.functional.leaky_relu(y, 0.01)
        return torch.relu(y)


class ConvLSTMLinear(nn.Module):
    """The DAP's conv stack, LSTM and dense layer; a bf16 region when
    `amp` (the JAX package's cast sites at :147 and :180, and the fused
    DAPs' exits, :275 and :300)."""

    amp = False

    def __init__(self, in_dim, out_dim, n_layers=2, n_channels=256,
                 kernel_size=3, p_dropout=0.1, lstm_type="bilstm",
                 use_linear=True, factored=False):
        super().__init__()
        dims = [in_dim] + [n_channels] * n_layers
        self.convs = nn.ModuleList(
            ConvNorm(a, b, kernel_size, gain_name="relu",
                     weight_norm=factored)
            for a, b in zip(dims[:-1], dims[1:]))
        self.p_dropout = p_dropout
        eff = n_channels if use_linear else out_dim
        self.lstm = None
        if lstm_type == "bilstm":
            self.lstm = MaskedLSTM(eff, eff // 2, norm="spectral",
                                   factored=factored)
        elif lstm_type:
            self.lstm = MaskedLSTM(eff, eff, bidirectional=False,
                                   norm="spectral", factored=factored)
        self.dense = LinearNorm(n_channels, out_dim) if use_linear else None

    def forward(self, x, lens=None, generator=None):
        """x: (B, T, C); the conv stack is masked past each length; a
        generator draws dropout after each conv's ReLU."""
        x = cast_in(x, self.amp)
        mf = (None if lens is None
              else sequence_mask(lens, x.shape[1]).to(x.dtype)[:, :, None])
        if mf is not None:
            x = x * mf
        for conv in self.convs:
            x = dropout(torch.relu(conv(x)), self.p_dropout, generator)
            if mf is not None:
                x = x * mf
        if self.lstm is not None:
            x = self.lstm(x, lens)
        if self.dense is not None:
            x = self.dense(x)
        return cast_out(x, self.amp)


class DAP(nn.Module):
    """Deterministic attribute predictor (reference
    attribute_prediction_model.py:88-117)."""

    name = "dap"

    def __init__(self, hparams, factored=False):
        super().__init__()
        self.bottleneck = Bottleneck(**hparams["bottleneck_hparams"],
                                     factored=factored)
        arch = hparams["arch_hparams"]
        in_dim = self.bottleneck.out_dim + hparams["n_speaker_dim"]
        self.take_log_of_input = bool(hparams["take_log_of_input"])
        self.use_transformer = bool(hparams.get("use_transformer", False))
        if self.use_transformer:
            # its arch keys as fft_init takes them
            # (radtts_tpu/models/attributes.py:193-198)
            self.feat = FFTransformer(**dict(arch, in_dim=in_dim))
        else:
            self.feat = ConvLSTMLinear(
                in_dim, arch["out_dim"], n_layers=arch["n_layers"],
                n_channels=arch["n_channels"],
                kernel_size=arch["kernel_size"], p_dropout=arch["p_dropout"],
                lstm_type=arch.get("lstm_type", "bilstm"),
                use_linear=bool(arch.get("use_linear", True)),
                factored=factored)

    def context(self, txt_enc, spk_emb):
        h = self.bottleneck(txt_enc)
        spk = spk_emb[:, None, :].expand(-1, h.shape[1], -1)
        return torch.cat([h, spk], dim=-1)


def dap_infer(model, txt_enc, spk_emb, lens=None):
    """txt_enc: (B, T, C); spk_emb: (B, S). The DAP is deterministic: it
    takes no noise."""
    out = model.feat(model.context(txt_enc, spk_emb), lens)
    return attr_denormalize(out, model.take_log_of_input)


def dap_forward(model, txt_enc, spk_emb, x, lens, generator=None):
    """Training forward: {"x_hat": prediction, "x": the normalized target
    (or None)} (radtts_tpu/models/attributes.py:210)."""
    if x is not None:
        x = attr_normalize(x, model.take_log_of_input)
    x_hat = model.feat(model.context(txt_enc, spk_emb), lens, generator)
    return {"x_hat": x_hat, "x": x}


def _speaker_context(bottleneck, txt_enc, spk_emb, g):
    h = unfold_group(bottleneck(txt_enc), g)
    return torch.cat([h, spk_emb[:, None, :].expand(-1, h.shape[1], -1)],
                     dim=-1)


# ---------------------------------------------------------------------------
# BGAP (radtts_tpu/models/attributes.py:306-401)
# ---------------------------------------------------------------------------


class BGAP(nn.Module):
    """Bipartite-flow attribute predictor over frames grouped by
    n_group_size: n_flows - n_spline_steps affine (simple_conv) couplings,
    then spline couplings (+-3), each after a plain-W invertible 1x1."""

    name = "bgap"

    def __init__(self, hparams, factored=False):
        super().__init__()
        h = hparams
        g = h["n_group_size"]
        self.bottleneck = Bottleneck(**h["bottleneck_hparams"],
                                     factored=factored)
        context_dim = self.bottleneck.out_dim * g + h["n_speaker_dim"]
        self.n_flows = h["n_flows"]
        self.n_spline_steps = h.get("n_spline_steps", 2)
        self.n_group_size = g
        self.scaling_fn = h["scaling_fn"]
        self.take_log_of_input = bool(h.get("take_log_of_input", False))
        ch = h["n_in_dim"] * g
        self.convinv = nn.ModuleList(InvConv1x1(ch, trainable=factored)
                                     for _ in range(self.n_flows))
        self.transforms = nn.ModuleList()
        for k in range(self.n_flows):
            if self.is_spline(k):
                self.transforms.append(SplineCoupling(
                    ch, context_dim, h["n_layers"],
                    with_dilation=h["with_dilation"],
                    kernel_size=h["kernel_size"], n_bins=h.get("n_bins", 8),
                    left=-3, right=3, bottom=-3, top=3,
                    use_quadratic=h.get("use_quadratic", False)))
            else:
                self.transforms.append(AffineCoupling(
                    ch, context_dim, h["n_layers"],
                    affine_model="simple_conv",
                    with_dilation=h["with_dilation"],
                    kernel_size=h["kernel_size"],
                    n_hidden=h.get("n_channels", 1024)))

    def is_spline(self, k):
        return k >= self.n_flows - self.n_spline_steps

    def context(self, txt_enc, spk_emb):
        return _speaker_context(self.bottleneck, txt_enc, spk_emb,
                                self.n_group_size)


def bgap_forward(model, txt_enc, spk_emb, x, lens):
    """{"z", "log_det_W_list", "log_s_list"} of the flow over the grouped
    target x ((B, T) or (B, T, C))."""
    g = model.n_group_size
    if x.ndim == 2:
        x = x[:, :, None]
    context = model.context(txt_enc, spk_emb)
    mask = sequence_mask(lens // g, context.shape[1])
    x = unfold_group(x, g)
    log_s_list, log_det_W_list = [], []
    for k, (transform, inv) in enumerate(zip(model.transforms,
                                             model.convinv)):
        if model.is_spline(k):
            x, log_s = transform(x, context, mask=mask)
        else:
            x, log_s = transform(x, context, scaling_fn=model.scaling_fn,
                                 mask=mask)
        x, log_det_W = inv(x)
        log_det_W_list.append(log_det_W)
        log_s_list.append(log_s)
    return {"z": x, "log_det_W_list": log_det_W_list,
            "log_s_list": log_s_list}


def bgap_infer(model, z, txt_enc, spk_emb, seq_lens=None):
    """Sample from noise z (B, T, n_in_dim); seq_lens None means every item
    is txt_enc's full length."""
    g = model.n_group_size
    context = model.context(txt_enc, spk_emb)
    if seq_lens is None:
        seq_lens = torch.full((z.shape[0],), txt_enc.shape[1],
                              dtype=torch.int64, device=z.device)
    mask = sequence_mask(seq_lens // g, context.shape[1])
    z = unfold_group(z, g)
    for k in reversed(range(model.n_flows)):
        z = model.convinv[k].inverse(z)
        if model.is_spline(k):
            z = model.transforms[k].inverse(z, context, mask=mask)
        else:
            z = model.transforms[k].inverse(z, context,
                                            scaling_fn=model.scaling_fn,
                                            mask=mask)
    return fold_group(z, g)


# ---------------------------------------------------------------------------
# AGAP (radtts_tpu/models/attributes.py:405-601)
# ---------------------------------------------------------------------------


class ARStep(nn.Module):
    """One AR step: the attribute LSTM over the previous frame, a stacked
    LSTM over [its output, context], then a SplineAR or the affine head
    (two tanh dense layers and a zero-initialised 1x1)."""

    def __init__(self, n_attr_channels, n_speaker_dim, n_text_channels,
                 n_hidden, n_lstm_layers, spline_flow_params=None):
        super().__init__()
        self.n_attr = n_attr_channels
        self.attr_lstm = LSTM(n_attr_channels, n_hidden)
        self.lstm = LSTM(n_hidden + n_text_channels + n_speaker_dim,
                         n_hidden, n_lstm_layers)
        self.spline_flow = self.dense = self.conv = None
        if spline_flow_params is not None:
            sp = spline_flow_params
            self.spline_flow = SplineAR(
                sp["n_in_channels"], sp["n_context_dim"], sp["n_layers"],
                n_bins=sp.get("n_bins", 8),
                use_quadratic=sp.get("use_quadratic", False))
        else:
            self.dense = DenseLayer(n_hidden, [n_hidden, n_hidden])
            self.conv = ConvNorm(n_hidden, 2 * n_attr_channels, 1,
                                 zero_init=True)

    def params_out(self, lstm_hidden):
        """The affine head: (scale_raw, bias)."""
        out = self.conv(self.dense(lstm_hidden))
        n = out.shape[-1] // 2
        return out[..., :n], out[..., n:]

    def scan_params(self, scaling_fn):
        """The step's weights as ops/ar_scan.py takes them (layer 0's
        input projection without its context half, which ar_step_infer
        applies before the scan)."""
        w_ih, w_hh, _ = self.attr_lstm.weights(0)
        H = w_hh.shape[1]
        lstm = []
        for layer in range(self.lstm.lstm.num_layers):
            w_ih_l, w_hh_l, b_l = self.lstm.weights(layer)
            lstm.append((w_ih_l[:, :H], w_hh_l, None) if layer == 0
                        else (w_ih_l, w_hh_l, b_l))
        p = {"attr": self.attr_lstm.weights(0), "lstm": lstm}
        if self.spline_flow is not None:
            sf = self.spline_flow
            convs = list(sf.pred.layers) + [sf.pred.last]
            p["head"] = [(c.effective_weight()[:, :, 0], c.bias,
                          "relu" if c is not sf.pred.last else None)
                         for c in convs]
            p.update(kind="quadratic" if sf.use_quadratic else "linear",
                     n_bins=sf.n_bins,
                     bounds=(sf.left, sf.right, sf.bottom, sf.top))
        else:
            p["head"] = [(d.weight, d.bias, "tanh")
                         for d in self.dense.layers]
            p["head"].append((self.conv.effective_weight()[:, :, 0],
                              self.conv.bias, None))
            p.update(kind="affine", scaling_fn=scaling_fn)
        return p


def ar_step_forward(step, x, context, lens, scaling_fn):
    """The teacher-forced step over whole sequences: (z, log_s)."""
    x0 = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    mel_hidden, _ = step.attr_lstm(x0, lens)
    lstm_hidden, _ = step.lstm(torch.cat([mel_hidden, context], dim=-1),
                               lens)
    if step.spline_flow is not None:
        return step.spline_flow(x, lstm_hidden)
    scale_raw, bias = step.params_out(lstm_hidden)
    s, log_s = scaling_and_log_s(scale_raw, scaling_fn)
    return s * x + bias, log_s


def ar_step_problem(step, residual, context, scaling_fn):
    """The step's inverse as ops/ar_scan.py takes it: (scan params,
    residual, the context half of the stacked LSTM's first input
    projection with both biases, for every frame)."""
    w_ih, _, (b_ih, b_hh) = step.lstm.weights(0)
    H = step.lstm.lstm.hidden_size
    context_proj = torch.matmul(context, w_ih[:, H:].T) + (b_ih + b_hh)
    return step.scan_params(scaling_fn), residual, context_proj


def ar_step_infer(step, residual, context, scaling_fn):
    """The step's inverse, frame by frame (ops/ar_scan.py). residual,
    context: (B, T, C)."""
    return ar_scan(*ar_step_problem(step, residual, context, scaling_fn))


class AGAP(nn.Module):
    """Autoregressive-flow attribute predictor: n_flows AR steps, the odd
    ones over each item's valid frames reversed."""

    name = "agap"

    def __init__(self, hparams, factored=False):
        super().__init__()
        h = hparams
        g = h.get("n_group_size", 1)
        self.bottleneck = Bottleneck(**h["bottleneck_hparams"],
                                     factored=factored)
        spline = h.get("spline_flow_params")
        if spline is not None:
            spline = dict(spline, n_in_channels=spline["n_in_channels"] * g)
        self.flows = nn.ModuleList(
            ARStep(h["n_in_dim"] * g, h["n_speaker_dim"],
                   self.bottleneck.out_dim * g, h["n_hidden"],
                   h["n_lstm_layers"], spline_flow_params=spline)
            for _ in range(h["n_flows"]))
        self.n_group_size = g
        self.scaling_fn = h["scaling_fn"]
        self.take_log_of_input = bool(h.get("take_log_of_input", False))

    def context(self, txt_enc, spk_emb):
        return _speaker_context(self.bottleneck, txt_enc, spk_emb,
                                self.n_group_size)


def reverse_padded(x, lengths):
    """Reverse each item's first lengths[b] frames: frame t <- frame
    lengths[b] - 1 - t (frames past the length take clipped indices)."""
    T = x.shape[1]
    idx = (lengths[:, None] - 1
           - torch.arange(T, device=x.device)[None, :]).clamp(0, T - 1)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _flip_roll(x, lens):
    """The reference back step's flip + roll: each item's valid prefix
    reversed, zeros past it."""
    valid = sequence_mask(lens, x.shape[1]).to(x.dtype)[:, :, None]
    return reverse_padded(x, lens) * valid


def agap_forward(model, txt_enc, spk_emb, x, lens):
    """{"z", "log_s_list", "log_det_W_list": []} of the flow over the
    (normalized) grouped target x."""
    g = model.n_group_size
    if x.ndim == 2:
        x = x[:, :, None]
    x = attr_normalize(unfold_group(x, g), model.take_log_of_input)
    context = model.context(txt_enc, spk_emb)
    lens_g = lens // g
    log_s_list = []
    for i, step in enumerate(model.flows):
        if i % 2 == 0:
            x, log_s = ar_step_forward(step, x, context, lens_g,
                                       model.scaling_fn)
        else:
            xr, log_s_r = ar_step_forward(
                step, _flip_roll(x, lens_g), _flip_roll(context, lens_g),
                lens_g, model.scaling_fn)
            x = _flip_roll(xr, lens_g)
            log_s = _flip_roll(log_s_r, lens_g)
        log_s_list.append(log_s)
    return {"z": x, "log_s_list": log_s_list, "log_det_W_list": []}


def agap_infer(model, z, txt_enc, spk_emb, seq_lens=None):
    """Sample from noise z (B, T, n_in_dim). seq_lens (frames, before
    grouping) makes padded batches exact: the back steps reverse each
    item's valid prefix, as training does, instead of the padded axis; a
    grouped truncation is reflect-padded back to T frames."""
    return _agap_infer_multi([model], [z], [txt_enc], [spk_emb],
                             seq_lens)[0]


def agap_infer_multi(models, zs, txt_encs, spk_embs, seq_lens=None):
    """agap_infer of several AGAP models of as many flows in lock step (f0
    and energy): each flow index's steps go to ops/ar_scan.py as one
    ar_scan_multi call, one launch on the card where they fit."""
    with tracing.span("attributes", zs[0].device):
        return _agap_infer_multi(models, zs, txt_encs, spk_embs, seq_lens)


def _agap_infer_multi(models, zs, txt_encs, spk_embs, seq_lens):
    if len({len(m.flows) for m in models}) != 1:
        raise ValueError("agap_infer_multi: the models' flow counts differ")
    states = []
    for m, z, txt_enc, spk_emb in zip(models, zs, txt_encs, spk_embs):
        g = m.n_group_size
        lens_g = None if seq_lens is None else seq_lens // g
        states.append({"n_frames": z.shape[1], "z": unfold_group(z, g),
                       "context": m.context(txt_enc, spk_emb),
                       "lens": lens_g})

    def rev(t, lens_g):
        return t.flip(1) if lens_g is None else _flip_roll(t, lens_g)

    for i in reversed(range(len(models[0].flows))):
        back = i % 2 == 1
        problems = []
        for m, s in zip(models, states):
            res, ctx = s["z"], s["context"]
            if back:
                res, ctx = rev(res, s["lens"]), rev(ctx, s["lens"])
            problems.append(ar_step_problem(m.flows[i], res, ctx,
                                            m.scaling_fn))
        for s, out in zip(states, ar_scan_multi(problems)):
            s["z"] = rev(out, s["lens"]) if back else out
    outs = []
    for m, s in zip(models, states):
        x_hat = fold_group(s["z"], m.n_group_size)
        if x_hat.shape[1] < s["n_frames"]:
            pad = s["n_frames"] - x_hat.shape[1]
            x_hat = torch.cat([x_hat, x_hat[:, -pad - 1:-1].flip(1)], dim=1)
        outs.append(attr_denormalize(x_hat, m.take_log_of_input))
    return outs


# ---------------------------------------------------------------------------
# factory (radtts_tpu/models/attributes.py:604-633)
# ---------------------------------------------------------------------------

_MODELS = {"dap": DAP, "bgap": BGAP, "agap": AGAP}


def attribute_model(config, n_speaker_dim=None, factored=False):
    """Factory from a reference attribute-model config ({name, hparams})."""
    if config["name"] not in _MODELS:
        raise ValueError(f"{config['name']} model is not supported")
    hp = dict(config["hparams"])
    if n_speaker_dim is not None:
        hp["n_speaker_dim"] = n_speaker_dim
    return _MODELS[config["name"]](hp, factored=factored)


def attribute_model_forward(model, txt_enc, spk_emb, x, lens,
                            generator=None):
    """The training forward of any family (the generator draws a DAP's
    dropout; the flows have none)."""
    if model.name == "dap":
        return dap_forward(model, txt_enc, spk_emb, x, lens, generator)
    if model.name == "bgap":
        return bgap_forward(model, txt_enc, spk_emb, x, lens)
    return agap_forward(model, txt_enc, spk_emb, x, lens)


def attribute_model_infer(model, txt_enc, spk_emb, lens=None, z=None):
    """Inference of any family; z is the flows' noise (the DAP takes
    none)."""
    with tracing.span("attributes", txt_enc.device):
        if model.name == "dap":
            return dap_infer(model, txt_enc, spk_emb, lens)
        if model.name == "bgap":
            return bgap_infer(model, z, txt_enc, spk_emb, lens)
        return agap_infer(model, z, txt_enc, spk_emb, lens)
