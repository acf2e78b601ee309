"""Attribute predictors of the deterministic DAP family (bottleneck +
ConvLSTMLinear + regression): inference, and the training forward with
dropout from an explicit generator; plus the grouping helpers.
`factored=True` builds the training form (weight-normed convs where the
JAX package has them, the LSTM's norm factorization).

Grouping uses torch nn.Unfold's channel ordering (c*g + j), as the JAX
package does, so grouped tensors line up channel for channel.
"""

import torch
from torch import nn

from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.dropout import dropout
from radtts_tpu_torch.ops.linear import LinearNorm
from radtts_tpu_torch.ops.lstm import MaskedLSTM
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
        return x


class DAP(nn.Module):
    """Deterministic attribute predictor (reference
    attribute_prediction_model.py:88-117)."""

    def __init__(self, hparams, factored=False):
        super().__init__()
        if hparams.get("use_transformer", False):
            raise NotImplementedError("DAP with use_transformer is not "
                                      "ported yet")
        self.bottleneck = Bottleneck(**hparams["bottleneck_hparams"],
                                     factored=factored)
        arch = hparams["arch_hparams"]
        self.feat = ConvLSTMLinear(
            self.bottleneck.out_dim + hparams["n_speaker_dim"],
            arch["out_dim"], n_layers=arch["n_layers"],
            n_channels=arch["n_channels"], kernel_size=arch["kernel_size"],
            p_dropout=arch["p_dropout"],
            lstm_type=arch.get("lstm_type", "bilstm"),
            use_linear=bool(arch.get("use_linear", True)),
            factored=factored)
        self.take_log_of_input = bool(hparams["take_log_of_input"])

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


def dap_forward_fused(models, txt_list, spk_list, x_list, lens=None,
                      generator=None):
    """[dap_forward(...) for ...], the counterpart of the JAX package's
    dap_forward_fused (one scan there, one after the other here)."""
    return [dap_forward(m, t, s, x, lens, generator)
            for m, t, s, x in zip(models, txt_list, spk_list, x_list)]


def dap_infer_fused(models, txt_list, spk_list, lens=None):
    """[dap_infer(m, t, s, lens) for ...]; the JAX package batches the
    recurrences into one scan, here they run one after the other."""
    return [dap_infer(m, t, s, lens)
            for m, t, s in zip(models, txt_list, spk_list)]


def attribute_model(config, n_speaker_dim=None, factored=False):
    """Factory from a reference attribute-model config ({name, hparams})."""
    if config["name"] != "dap":
        raise NotImplementedError(f"{config['name']} attribute models are "
                                  "not ported yet")
    hp = dict(config["hparams"])
    if n_speaker_dim is not None:
        hp["n_speaker_dim"] = n_speaker_dim
    return DAP(hp, factored=factored)


def attribute_model_infer(model, txt_enc, spk_emb, lens=None):
    return dap_infer(model, txt_enc, spk_emb, lens)
