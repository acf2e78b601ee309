"""The port's RADTTS module -> a reference checkpoint (the JAX package's
radtts_tpu/export.py), under the names convert.radtts_from_torch reads.

The port holds every weight folded (norm factorizations collapsed at load),
so each factorization is written as one that collapses back to the weight:
a weight-normed conv as weight_v = w and weight_g = ||w|| over every dim
but the first; a spectral-normed LSTM recurrent weight as _orig = W with
_u, _v its top singular pair from a float64 SVD, v divided by sigma_1, so
that u . (W v) = 1; a weight-normed one as _v = W and _g = its row norms.
The JAX package's fold and the reference in eval mode both give back W,
up to fp32 rounding.

A DAP on the FFTransformer is written under the reference's
feat_pred_fn.layers.i.{dec_attn, pos_ff} and feat_pred_fn.dense.linear_layer
names. A decoder's plain-W 1x1 is written as invtbl_conv.conv.weight (c, c,
1), its simple_conv coupling as the SimpleConvNet below. The BGAP's
plain-W 1x1s are written as convinv.k.conv.weight (c, c, 1),
its couplings' SimpleConvNets as (affine_)param_predictor.layers.i.conv
and .last_layer; the AGAP's plain LSTMs under nn.LSTM's names, its odd
steps under flows.i.ar_step (radtts_tpu/export.py:196-238).

The alignment attention's plain convs are written as attention.key_proj.
{0,2}.conv and attention.query_proj.{0,2,4}.conv, so the reference loads
the file with strict=True. A training-form model is folded first
(models/radtts.py:fold_radtts).
"""

import numpy as np
import torch

from radtts_tpu_torch.ops.invertible import InvConv1x1LUS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _np(t):
    return t.detach().cpu().numpy().astype(np.float32)


def _conv(sd, prefix, conv, weight_norm=False):
    w = _np(conv.weight)                                  # (out, in, k)
    if weight_norm:
        sd[prefix + ".weight_g"] = _t(np.sqrt(
            (w.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True)))
        sd[prefix + ".weight_v"] = _t(w)
    else:
        sd[prefix + ".weight"] = _t(w)
    sd[prefix + ".bias"] = _t(_np(conv.bias))


def _linear(sd, prefix, linear):
    sd[prefix + ".weight"] = _t(_np(linear.weight))
    if linear.bias is not None:
        sd[prefix + ".bias"] = _t(_np(linear.bias))


def _layer_norm(sd, prefix, ln):
    sd[prefix + ".weight"] = _t(_np(ln.gamma))
    sd[prefix + ".bias"] = _t(_np(ln.beta))


def _fft(sd, prefix, fft):
    """(radtts_tpu/export.py:172-186)."""
    for i, layer in enumerate(fft.layers):
        base = f"{prefix}.layers.{i}"
        attn, ff = layer["attn"], layer["ff"]
        _linear(sd, base + ".dec_attn.qkv_net", attn.qkv)
        _linear(sd, base + ".dec_attn.o_net", attn.o)
        _layer_norm(sd, base + ".dec_attn.layer_norm", attn.ln)
        _conv(sd, base + ".pos_ff.CoreNet.0", ff.conv1)
        _conv(sd, base + ".pos_ff.CoreNet.2", ff.conv2)
        _layer_norm(sd, base + ".pos_ff.layer_norm", ff.ln)
    _linear(sd, prefix + ".dense.linear_layer", fft.dense)


def _lstm(sd, prefix, mod):
    """A MaskedLSTM, its recurrent weights factorized as mod.norm says."""
    for sfx in ("", "_reverse") if mod.lstm.bidirectional else ("",):
        for name in ("weight_ih_l0", "bias_ih_l0", "bias_hh_l0"):
            sd[f"{prefix}.{name}{sfx}"] = _t(_np(
                getattr(mod.lstm, name + sfx)))
        w = _np(getattr(mod.lstm, "weight_hh_l0" + sfx))
        base = f"{prefix}.weight_hh_l0{sfx}"
        if mod.norm == "spectral":
            u, s, vt = np.linalg.svd(w.astype(np.float64),
                                     full_matrices=False)
            sd[base + "_orig"] = _t(w)
            sd[base + "_u"] = _t(u[:, 0])
            sd[base + "_v"] = _t(vt[0] / s[0])
        elif mod.norm == "weight":
            sd[base + "_g"] = _t(np.sqrt(
                (w.astype(np.float64) ** 2).sum(axis=1, keepdims=True)))
            sd[base + "_v"] = _t(w)
        else:
            sd[base] = _t(w)


def _dap(sd, prefix, dap):
    _conv(sd, prefix + ".bottleneck_layer.projection_fn.conv",
          dap.bottleneck.proj, weight_norm=True)
    fp = prefix + ".feat_pred_fn"
    if dap.use_transformer:
        _fft(sd, fp, dap.feat)
        return
    for i, conv in enumerate(dap.feat.convs):
        _conv(sd, f"{fp}.convolutions.{i}", conv, weight_norm=True)
    if dap.feat.lstm is not None:
        _lstm(sd, fp + ".bilstm", dap.feat.lstm)
    if dap.feat.dense is not None:
        _linear(sd, fp + ".dense", dap.feat.dense)


def _plain_lstm(sd, prefix, mod):
    """An ops/lstm.py:LSTM under nn.LSTM's names (no norms)."""
    for name, t in mod.lstm.named_parameters():
        sd[f"{prefix}.{name}"] = _t(_np(t))


def _simple_convnet(sd, prefix, net):
    for i, conv in enumerate(net.layers):
        _conv(sd, f"{prefix}.layers.{i}.conv", conv)
    _conv(sd, prefix + ".last_layer", net.last)


def _bgap(sd, prefix, bgap):
    """(radtts_tpu/export.py:196-209)."""
    _conv(sd, prefix + ".bottleneck_layer.projection_fn.conv",
          bgap.bottleneck.proj, weight_norm=True)
    for k, (inv, transform) in enumerate(zip(bgap.convinv,
                                             bgap.transforms)):
        sd[f"{prefix}.convinv.{k}.conv.weight"] = _t(_np(inv.w1x1)[:, :, None])
        pred = ("param_predictor" if bgap.is_spline(k)
                else "affine_param_predictor")
        _simple_convnet(sd, f"{prefix}.transforms.{k}.{pred}", transform.pred)


def _agap(sd, prefix, agap):
    """(radtts_tpu/export.py:212-230): the odd steps under .ar_step, as the
    reference's AR_Back_Step wraps them."""
    _conv(sd, prefix + ".bottleneck_layer.projection_fn.conv",
          agap.bottleneck.proj, weight_norm=True)
    for i, step in enumerate(agap.flows):
        base = f"{prefix}.flows.{i}" + ("" if i % 2 == 0 else ".ar_step")
        _plain_lstm(sd, base + ".attr_lstm", step.attr_lstm)
        _plain_lstm(sd, base + ".lstm", step.lstm)
        if step.spline_flow is not None:
            _simple_convnet(sd, base + ".spline_flow.param_predictor",
                            step.spline_flow.pred)
        else:
            for j, dense in enumerate(step.dense.layers):
                _linear(sd, f"{base}.dense_layer.layers.{j}.linear_layer",
                        dense)
            _conv(sd, base + ".conv", step.conv)


def _attribute(sd, prefix, mod):
    {"dap": _dap, "bgap": _bgap, "agap": _agap}[mod.name](sd, prefix, mod)


def radtts_to_torch(model):
    """A RADTTS module as a reference state dict (CPU fp32 tensors)."""
    if model.factored:
        from radtts_tpu_torch.models.radtts import fold_radtts
        model = fold_radtts(model)
    sd = {"speaker_embedding.weight": _t(_np(model.speaker_embedding.weight)),
          "embedding.weight": _t(_np(model.embedding.weight))}
    enc = model.encoder
    for i, (conv, norm) in enumerate(zip(enc.convs, enc.norms)):
        _conv(sd, f"encoder.convolutions.{i}.0.conv", conv)
        sd[f"encoder.convolutions.{i}.1.weight"] = _t(_np(norm.gamma))
        sd[f"encoder.convolutions.{i}.1.bias"] = _t(_np(norm.beta))
    _lstm(sd, "encoder.lstm", enc.lstm)
    if model.attention is not None:
        for i, conv in zip((0, 2), model.attention.key_proj):
            _conv(sd, f"attention.key_proj.{i}.conv", conv)
        for i, conv in zip((0, 2, 4), model.attention.query_proj):
            _conv(sd, f"attention.query_proj.{i}.conv", conv)
    if model.context_lstm is not None:
        _lstm(sd, "context_lstm", model.context_lstm)
    for i, flow in enumerate(model.flows):
        inv = f"flows.{i}.invtbl_conv"
        if isinstance(flow.inv, InvConv1x1LUS):
            for name in ("p", "lower", "upper", "upper_diag"):
                sd[f"{inv}.{name}"] = _t(_np(getattr(flow.inv, name)))
            sd[f"{inv}.lower_diag"] = torch.ones(flow.inv.p.shape[0])
        else:
            sd[f"{inv}.conv.weight"] = _t(_np(flow.inv.w1x1)[:, :, None])
        wn, pred = f"flows.{i}.affine_tfn.affine_param_predictor", \
            flow.affine.pred
        if flow.affine.affine_model != "wavenet":
            _simple_convnet(sd, wn, pred)
            continue
        _conv(sd, wn + ".start", pred.start, weight_norm=True)
        _conv(sd, wn + ".end", pred.end)
        for j, conv in enumerate(pred.in_layers):
            _conv(sd, f"{wn}.in_layers.{j}.conv", conv, weight_norm=True)
        for j, conv in enumerate(pred.res_skip):
            _conv(sd, f"{wn}.res_skip_layers.{j}", conv, weight_norm=True)
    for name in ("dur_pred_layer", "v_pred_module", "f0_pred_module",
                 "energy_pred_module"):
        if getattr(model, name) is not None:
            _attribute(sd, name, getattr(model, name))
    if model.unvoiced_bias is not None:
        _linear(sd, "unvoiced_bias_module.0.linear_layer",
                model.unvoiced_bias)
    if model.v_embeddings is not None:
        sd["v_embeddings.weight"] = _t(_np(model.v_embeddings.weight))
    return sd


def export_torch_checkpoint(path, model, iteration=0, learning_rate=0.0):
    """torch.save the reference checkpoint format: {'state_dict',
    'iteration', 'learning_rate'}."""
    torch.save({"state_dict": radtts_to_torch(model),
                "iteration": int(iteration),
                "learning_rate": float(learning_rate)}, path)
