"""Carry weights from the JAX package's parameter trees into the port's
modules, and read reference RADTTS state dicts into such trees.

Inputs are nested dicts and lists of numpy arrays, as radtts_init /
hifigan_generator_init produce them with the `_meta` / `_kind` entries
removed. Norm factorizations are folded first (ops/fold_norms.py), the
invertible 1x1 inverses are computed after loading, and each layout is
converted: conv kernels (K, C_in, C_out) -> (C_out, C_in, K); linear
(in, out) -> (out, in); LSTM w_ih (in, 4H) -> (4H, in); flipped
transposed-conv kernels (K, C_in, C_out) -> (C_in, C_out, K) unflipped.
MRF resblock convs keep the taps-major (n, K, C_in, C_out) layout the
kernel reads. The discriminators' kernels go to torch's conv layouts.

The attribute models carry over by family: the DAP's convs, spectral-normed
LSTM and dense, or its FFTransformer; the BGAP's plain-W 1x1s and
SimpleConvNets; the AGAP's plain LSTMs (nn.LSTM layout) and spline or dense
heads (`attribute_from_jax` loads one alone). The decoder's 1x1s are LU
factors or a plain W, its couplings WNs or SimpleConvNets.

`radtts_train_from_jax` carries the unfolded tree into the training form
(RADTTS(..., factored=True)): weight-normed convs as weight_v / weight_g,
recurrent weights as {sn_w, sn_u, sn_v} or {wn_v, wn_g}, the LU factors as
parameters, with the same layout changes.
"""

import numpy as np
import torch

from radtts_tpu_torch.models.hifigan import Generator
from radtts_tpu_torch.models.radtts import RADTTS, _norm_kind
from radtts_tpu_torch.ops.conv import effective_weight
from radtts_tpu_torch.ops.fold_norms import fold_norms
from radtts_tpu_torch.ops.lstm import effective_hh
from radtts_tpu_torch.train.vocoder_trainer import vocoder_train_init


@torch.no_grad()
def _set(param, array):
    a = torch.from_numpy(np.array(array, dtype=np.float32, copy=True))
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} into "
                         f"{tuple(param.shape)}")
    param.copy_(a)


def _conv(mod, p):
    """A conv node {w, b} or {v, g, b} into a conv: a weight-normed
    ConvNorm keeps {v, g}; any other takes the effective weight."""
    if getattr(mod, "weight_norm", False):
        _set(mod.weight_v, np.transpose(p["v"], (2, 1, 0)))
        _set(mod.weight_g, p["g"])
    else:
        _set(mod.weight, np.transpose(effective_weight(p), (2, 1, 0)))
    if "b" in p:
        _set(mod.bias, p["b"])


def _linear(mod, p):
    _set(mod.weight, np.asarray(p["w"]).T)
    if "b" in p:
        _set(mod.bias, p["b"])


def _lstm(mod, p):
    cells = ([("", p["fwd"]), ("_reverse", p["bwd"])]
             if mod.lstm.bidirectional else [("", p)])
    for d, (sfx, cell) in enumerate(cells):
        _set(getattr(mod.lstm, "weight_ih_l0" + sfx),
             np.asarray(cell["w_ih"]).T)
        if mod.factored:
            hh = mod.hh[d]
            if hh.norm == "spectral" and "sn_w" not in cell["hh"]:
                raise ValueError("a spectral-normed LSTM needs {sn_w, sn_u, "
                                 f"sn_v}}, got {sorted(cell['hh'])}")
            for k, v in cell["hh"].items():
                _set(getattr(hh, k), v)
        else:
            _set(getattr(mod.lstm, "weight_hh_l0" + sfx),
                 effective_hh(cell["hh"]))
        _set(getattr(mod.lstm, "bias_ih_l0" + sfx), cell["b_ih"])
        _set(getattr(mod.lstm, "bias_hh_l0" + sfx), cell["b_hh"])


def _invertible(mod, p):
    """An LU-decomposed 1x1 {p, lower, upper, upper_diag}, or a plain-W
    one {w1x1}; the inference form computes its inverse."""
    if "w1x1" in p:
        _set(mod.w1x1, p["w1x1"])
    else:
        for name in ("p", "lower", "upper", "upper_diag"):
            _set(getattr(mod, name), p[name])
    if not mod.trainable:
        mod.precompute_inverse()


def _plain_lstm(mod, cells):
    """An ops/lstm.py:LSTM's layers from JAX cells {w_ih, b_ih, b_hh, hh}."""
    for layer, cell in enumerate(cells):
        lstm = mod.lstm
        _set(getattr(lstm, f"weight_ih_l{layer}"), np.asarray(cell["w_ih"]).T)
        _set(getattr(lstm, f"weight_hh_l{layer}"), effective_hh(cell["hh"]))
        _set(getattr(lstm, f"bias_ih_l{layer}"), cell["b_ih"])
        _set(getattr(lstm, f"bias_hh_l{layer}"), cell["b_hh"])


def _simple_convnet(mod, p):
    for conv, cp in zip(mod.layers, p["layers"]):
        _conv(conv, cp)
    _conv(mod.last, p["last"])


def _bgap(mod, p):
    _conv(mod.bottleneck.proj, p["bottleneck"]["proj"])
    for inv, ip in zip(mod.convinv, p["convinv"]):
        _invertible(inv, ip)
    for transform, tp in zip(mod.transforms, p["transforms"]):
        _simple_convnet(transform.pred, tp["pred"])


def _agap(mod, p):
    _conv(mod.bottleneck.proj, p["bottleneck"]["proj"])
    for step, sp in zip(mod.flows, p["flows"]):
        _plain_lstm(step.attr_lstm, [sp["attr_lstm"]])
        _plain_lstm(step.lstm, sp["lstm"]["layers"])
        if step.spline_flow is not None:
            _simple_convnet(step.spline_flow.pred, sp["spline_flow"]["pred"])
        else:
            for dense, dp in zip(step.dense.layers, sp["dense"]["layers"]):
                _linear(dense, dp)
            _conv(step.conv, sp["conv"])


def _attribute(mod, p):
    {"dap": _dap, "bgap": _bgap, "agap": _agap}[mod.name](mod, p)


def _fft(mod, p):
    for layer, lp in zip(mod.layers, p["layers"]):
        attn, ff = layer["attn"], layer["ff"]
        _linear(attn.qkv, lp["attn"]["qkv"])
        _linear(attn.o, lp["attn"]["o"])
        _conv(ff.conv1, lp["ff"]["conv1"])
        _conv(ff.conv2, lp["ff"]["conv2"])
        for ln, lnp in ((attn.ln, lp["attn"]["ln"]), (ff.ln, lp["ff"]["ln"])):
            _set(ln.gamma, lnp["gamma"])
            _set(ln.beta, lnp["beta"])
    _linear(mod.dense, p["dense"])


def _dap(mod, p):
    _conv(mod.bottleneck.proj, p["bottleneck"]["proj"])
    feat = p["feat"]
    if mod.use_transformer:
        _fft(mod.feat, feat)
        return
    for conv, cp in zip(mod.feat.convs, feat["convs"]):
        _conv(conv, cp)
    if mod.feat.lstm is not None:
        _lstm(mod.feat.lstm, feat["lstm"])
    if mod.feat.dense is not None:
        _linear(mod.feat.dense, feat["dense"])


def _wn(mod, p):
    _conv(mod.start, p["start"])
    _conv(mod.end, p["end"])
    for conv, cp in zip(mod.in_layers, p["in_layers"]):
        _conv(conv, cp)
    for conv, cp in zip(mod.res_skip, p["res_skip"]):
        _conv(conv, cp)


def _attention(mod, p):
    for conv, cp in zip(mod.key_proj, p["key_proj"]):
        _conv(conv, cp)
    for conv, cp in zip(mod.query_proj, p["query_proj"]):
        _conv(conv, cp)


def attribute_from_jax(params_np, config, factored=False):
    """An attribute model ({name, hparams}, n_speaker_dim in hparams)
    holding the JAX tree's weights: the inference form (norms folded,
    eval, no grad), or with factored the training form (train mode)."""
    from radtts_tpu_torch.models.attributes import attribute_model
    mod = attribute_model(config, factored=factored)
    _attribute(mod, params_np if factored else fold_norms(params_np))
    if factored:
        return mod.train()
    return mod.eval().requires_grad_(False)


def radtts_from_jax(params_np, model_config):
    """RADTTS module (eval, no grad) holding the JAX tree's weights."""
    model = _radtts_load(RADTTS(model_config), fold_norms(params_np))
    return model.eval().requires_grad_(False)


def radtts_train_from_jax(params_np, model_config, partial=False):
    """The training-form RADTTS (train mode, grad on) holding the unfolded
    JAX tree's weights and norm state. partial=True skips the top-level
    modules the tree lacks and also returns the names of those loaded."""
    model = RADTTS(model_config, factored=True)
    loaded = _radtts_load(model, params_np, partial)
    model.train().requires_grad_(True)
    return (model, loaded) if partial else model


def _radtts_load(model, p, partial=False):
    """Fill model's modules from tree p; with partial, a top-level module
    missing from p keeps its weights, and the set of top-level names read
    is returned instead of the model."""
    loaded = set()

    def part(name, fn, *args):
        if partial and name not in p:
            return
        fn(*args)
        loaded.add(name)

    def embeddings():
        _set(model.speaker_embedding.weight, p["speaker_embedding"]["table"])

    def encoder():
        for conv, cp in zip(model.encoder.convs, p["encoder"]["convs"]):
            _conv(conv, cp)
        for norm, npar in zip(model.encoder.norms, p["encoder"]["norms"]):
            _set(norm.gamma, npar["gamma"])
            _set(norm.beta, npar["beta"])
        _lstm(model.encoder.lstm, p["encoder"]["lstm"])

    def flows():
        for flow, fp in zip(model.flows, p["flows"]):
            _invertible(flow.inv, fp["inv"])
            if flow.affine.affine_model == "wavenet":
                _wn(flow.affine.pred, fp["affine"]["pred"])
            else:
                _simple_convnet(flow.affine.pred, fp["affine"]["pred"])

    def table(name):
        _set(getattr(model, name).weight, p[name]["table"])

    part("speaker_embedding", embeddings)
    part("embedding", table, "embedding")
    part("encoder", encoder)
    # a file written before the port had ConvAttention holds none
    if model.attention is not None and "attention" in p:
        part("attention", _attention, model.attention, p["attention"])
    if model.context_lstm is not None:
        part("context_lstm", lambda: _lstm(model.context_lstm,
                                           p["context_lstm"]))
    if len(model.flows):
        part("flows", flows)
    for name in ("dur_pred_layer", "v_pred_module", "f0_pred_module",
                 "energy_pred_module"):
        if getattr(model, name) is not None:
            part(name, lambda n=name: _attribute(getattr(model, n), p[n]))
    if model.unvoiced_bias is not None:
        part("unvoiced_bias", lambda: _linear(model.unvoiced_bias,
                                              p["unvoiced_bias"]))
    if model.v_embeddings is not None:
        part("v_embeddings", table, "v_embeddings")
    return loaded if partial else model


def _generator(p, h):
    gen = Generator(h)
    _conv(gen.conv_pre, p["conv_pre"])
    _conv(gen.conv_post, p["conv_post"])
    for up, up_p in zip(gen.ups, p["ups"]):
        _set(up.weight, np.transpose(up_p["w"], (1, 2, 0))[:, :, ::-1])
        _set(up.bias, up_p["b"])
    for stage, group in zip(gen.resblocks, p["resblocks"]):
        for blk, bp in zip(stage, group):
            for name, (w, b) in blk.conv_weights().items():
                _set(w, np.stack([c["w"] for c in bp[name]]))
                _set(b, np.stack([c["b"] for c in bp[name]]))
    return gen


def hifigan_from_jax(params_np, h):
    """HiFi-GAN Generator (eval, no grad) holding the JAX tree's weights."""
    return _generator(fold_norms(params_np), h).eval().requires_grad_(False)


def _disc_conv(mod, p, perm):
    _set(mod.weight, np.transpose(p["w"], perm))
    _set(mod.bias, p["b"])


def vocoder_train_from_jax(params_np, h):
    """vocoder_train_init's modules (train mode, grad on) holding the JAX
    tree {gen, mpd, msd} of radtts_tpu.train.vocoder_trainer. 2-D conv
    kernels (kh, kw, in, out) -> (out, in, kh, kw); grouped 1-D kernels
    (k, in/groups, out) -> (out, in/groups, k)."""
    models = vocoder_train_init(h)
    models["gen"] = _generator(fold_norms(params_np["gen"]), h)
    for name, perm in (("mpd", (3, 2, 0, 1)), ("msd", (2, 1, 0))):
        for disc, dp in zip(models[name].discs, params_np[name]["discs"]):
            for conv, cp in zip(disc.convs, dp["convs"]):
                _disc_conv(conv, cp, perm)
            _disc_conv(disc.post, dp["post"], perm)
    return models.train().requires_grad_(True)


# ---------------------------------------------------------------------------
# reference RADTTS state dict -> JAX-format tree
# ---------------------------------------------------------------------------


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _np_t(t, axes=None):
    """_np(t) transposed, laid out contiguously as the JAX tree's arrays
    are, so that the folds reduce in the same order."""
    return np.ascontiguousarray(np.transpose(_np(t), axes))


def _conv_sd(sd, prefix, weight_norm=False):
    """Conv1d (out, in, k) -> {w: (k, in, out), b}, or {v, g, b} when
    weight-normed (weight_v, weight_g (out, 1, 1))."""
    if weight_norm:
        p = {"g": _np(sd[prefix + ".weight_g"]).reshape(-1),
             "v": _np_t(sd[prefix + ".weight_v"], (2, 1, 0))}
    else:
        p = {"w": _np_t(sd[prefix + ".weight"], (2, 1, 0))}
    p["b"] = _np(sd[prefix + ".bias"])
    return p


def _linear_sd(sd, prefix):
    return {"w": _np_t(sd[prefix + ".weight"]),
            "b": _np(sd[prefix + ".bias"])}


def _lstm_cell_sd(sd, prefix, suffix, norm):
    """One LSTM direction; the recurrent weight as stored: {w}, spectral
    {sn_w, sn_u, sn_v} (weight_hh_l0_orig, _u, _v) or weight {wn_g, wn_v}
    (weight_hh_l0_g, _v)."""
    base = f"{prefix}.weight_hh_l0{suffix}"
    if norm == "spectral":
        hh = {"sn_w": _np(sd[base + "_orig"]), "sn_u": _np(sd[base + "_u"]),
              "sn_v": _np(sd[base + "_v"])}
    elif norm == "weight":
        hh = {"wn_g": _np(sd[base + "_g"]).reshape(-1),
              "wn_v": _np(sd[base + "_v"])}
    else:
        hh = {"w": _np(sd[base])}
    return {"w_ih": _np_t(sd[f"{prefix}.weight_ih_l0{suffix}"]),
            "b_ih": _np(sd[f"{prefix}.bias_ih_l0{suffix}"]),
            "b_hh": _np(sd[f"{prefix}.bias_hh_l0{suffix}"]), "hh": hh}


def _bilstm_sd(sd, prefix, norm):
    return {"fwd": _lstm_cell_sd(sd, prefix, "", norm),
            "bwd": _lstm_cell_sd(sd, prefix, "_reverse", norm)}


def _layer_norm_sd(sd, prefix):
    return {"gamma": _np(sd[prefix + ".weight"]),
            "beta": _np(sd[prefix + ".bias"])}


def _fft_sd(sd, prefix, n_layers):
    """(radtts_tpu/convert.py:231-250): layers.i.dec_attn.{qkv_net, o_net
    (no bias), layer_norm}, layers.i.pos_ff.{CoreNet.0, CoreNet.2,
    layer_norm}, dense.linear_layer."""
    layers = []
    for i in range(n_layers):
        base = f"{prefix}.layers.{i}"
        layers.append({
            "attn": {"qkv": _linear_sd(sd, base + ".dec_attn.qkv_net"),
                     "o": {"w": _np_t(sd[base + ".dec_attn.o_net.weight"])},
                     "ln": _layer_norm_sd(sd, base + ".dec_attn.layer_norm")},
            "ff": {"conv1": _conv_sd(sd, base + ".pos_ff.CoreNet.0"),
                   "conv2": _conv_sd(sd, base + ".pos_ff.CoreNet.2"),
                   "ln": _layer_norm_sd(sd, base + ".pos_ff.layer_norm")}})
    return {"layers": layers,
            "dense": _linear_sd(sd, prefix + ".dense.linear_layer")}


def _dap_sd(sd, prefix, config):
    arch = config["hparams"]["arch_hparams"]
    fp = prefix + ".feat_pred_fn"
    if config["hparams"].get("use_transformer", False):
        # fft_init's default depth where the arch names none
        return {"bottleneck": _bottleneck_sd(sd, prefix),
                "feat": _fft_sd(sd, fp, arch.get("n_layers", 6))}
    feat = {"convs": [_conv_sd(sd, f"{fp}.convolutions.{i}", True)
                      for i in range(arch["n_layers"])]}
    lstm_type = arch.get("lstm_type", "bilstm")
    if lstm_type == "bilstm":
        feat["lstm"] = _bilstm_sd(sd, fp + ".bilstm", "spectral")
    elif lstm_type:
        feat["lstm"] = _lstm_cell_sd(sd, fp + ".bilstm", "", "spectral")
    if arch.get("use_linear", True):
        feat["dense"] = _linear_sd(sd, fp + ".dense")
    return {"bottleneck": _bottleneck_sd(sd, prefix), "feat": feat}


def _plain_lstm_sd(sd, prefix, n_layers):
    """An nn.LSTM's layers without norms: [{w_ih, b_ih, b_hh, hh: {w}}]."""
    return [{"w_ih": _np_t(sd[f"{prefix}.weight_ih_l{i}"]),
             "b_ih": _np(sd[f"{prefix}.bias_ih_l{i}"]),
             "b_hh": _np(sd[f"{prefix}.bias_hh_l{i}"]),
             "hh": {"w": _np(sd[f"{prefix}.weight_hh_l{i}"])}}
            for i in range(n_layers)]


def _simple_convnet_sd(sd, prefix, n_layers):
    return {"layers": [_conv_sd(sd, f"{prefix}.layers.{i}.conv")
                       for i in range(n_layers)],
            "last": _conv_sd(sd, prefix + ".last_layer")}


def _bottleneck_sd(sd, prefix):
    return {"proj": _conv_sd(
        sd, prefix + ".bottleneck_layer.projection_fn.conv", True)}


def _bgap_sd(sd, prefix, config):
    """(radtts_tpu/convert.py:266-283): transforms.k's
    affine_param_predictor (simple_conv) or param_predictor (spline),
    convinv.k.conv.weight (c, c, 1)."""
    hp = config["hparams"]
    n_flows, n_spline = hp["n_flows"], hp.get("n_spline_steps", 2)
    transforms = []
    for k in range(n_flows):
        pred = ("param_predictor" if k >= n_flows - n_spline
                else "affine_param_predictor")
        transforms.append({"pred": _simple_convnet_sd(
            sd, f"{prefix}.transforms.{k}.{pred}", hp["n_layers"])})
    return {"bottleneck": _bottleneck_sd(sd, prefix),
            "transforms": transforms,
            "convinv": [{"w1x1": np.ascontiguousarray(_np(
                sd[f"{prefix}.convinv.{k}.conv.weight"])[:, :, 0])}
                for k in range(n_flows)]}


def _agap_sd(sd, prefix, config):
    """(radtts_tpu/convert.py:286-316): flows.i (even) or flows.i.ar_step
    (odd), each attr_lstm, lstm, and spline_flow.param_predictor or
    dense_layer + conv."""
    hp = config["hparams"]
    spline = hp.get("spline_flow_params")
    flows = []
    for i in range(hp["n_flows"]):
        base = f"{prefix}.flows.{i}" + ("" if i % 2 == 0 else ".ar_step")
        step = {"attr_lstm": _plain_lstm_sd(sd, base + ".attr_lstm", 1)[0],
                "lstm": {"layers": _plain_lstm_sd(sd, base + ".lstm",
                                                  hp["n_lstm_layers"])}}
        if spline is not None:
            step["spline_flow"] = {"pred": _simple_convnet_sd(
                sd, base + ".spline_flow.param_predictor",
                spline["n_layers"])}
        else:
            step["dense"] = {"layers": [
                _linear_sd(sd, f"{base}.dense_layer.layers.{j}.linear_layer")
                for j in range(2)]}
            step["conv"] = _conv_sd(sd, base + ".conv")
        flows.append(step)
    return {"bottleneck": _bottleneck_sd(sd, prefix), "flows": flows}


def _attribute_sd(sd, prefix, config):
    fn = {"dap": _dap_sd, "bgap": _bgap_sd, "agap": _agap_sd}
    if config["name"] not in fn:
        raise ValueError(f"{config['name']} model is not supported")
    return fn[config["name"]](sd, prefix, config)


def _flow_sd(sd, prefix, n_layers, lus=True, affine_model="wavenet"):
    """A decoder flow step (radtts_tpu/convert.py:365-377): the LU 1x1's
    factors, or a plain W from invtbl_conv.conv.weight (c, c, 1); the WN or
    the SimpleConvNet coupling."""
    if lus:
        inv = {k: _np(sd[f"{prefix}.invtbl_conv.{k}"])
               for k in ("p", "lower", "upper", "upper_diag")}
        # the reference's unit diagonal of L, a constant buffer
        diag_key = f"{prefix}.invtbl_conv.lower_diag"
        if diag_key in sd and not (_np(sd[diag_key]) == 1.0).all():
            raise ValueError(f"{diag_key} is not all ones")
    else:
        inv = {"w1x1": np.ascontiguousarray(_np(
            sd[f"{prefix}.invtbl_conv.conv.weight"])[:, :, 0])}
    wn = prefix + ".affine_tfn.affine_param_predictor"
    if affine_model != "wavenet":
        return {"inv": inv,
                "affine": {"pred": _simple_convnet_sd(sd, wn, n_layers)}}
    pred = {"start": _conv_sd(sd, wn + ".start", True),
            "end": _conv_sd(sd, wn + ".end"),
            "in_layers": [_conv_sd(sd, f"{wn}.in_layers.{j}.conv", True)
                          for j in range(n_layers)],
            "res_skip": [_conv_sd(sd, f"{wn}.res_skip_layers.{j}", True)
                         for j in range(n_layers)]}
    return {"inv": inv, "affine": {"pred": pred}}


def radtts_from_torch(sd, model_config):
    """A reference RADTTS state dict (the reference checkpoint's
    'state_dict') as the JAX-format numpy tree radtts_from_jax takes, for
    the modules RADTTS(model_config) builds, their norm factorizations
    kept, the alignment attention included where the file has it."""
    cfg = dict(model_config)
    g = cfg.get
    include = g("include_modules", "dec")
    use_unvoiced_bias = bool(g("decoder_use_unvoiced_bias", True)
                             or g("ap_use_unvoiced_bias", True))
    voiced_embeddings = g("ap_use_voiced_embeddings", True)
    attributes = []   # (module name, its config key)
    if "dpm" in include:
        attributes.append(("dur_pred_layer", "dur_model_config"))
    if voiced_embeddings or use_unvoiced_bias or "vpred" in include:
        attributes.append(("v_pred_module", "v_model_config"))
    if "apm" in include:
        attributes += [("f0_pred_module", "f0_model_config"),
                       ("energy_pred_module", "energy_model_config")]

    p = {"speaker_embedding": {"table": _np(sd["speaker_embedding.weight"])},
         "embedding": {"table": _np(sd["embedding.weight"])},
         "encoder": {
             "convs": [_conv_sd(sd, f"encoder.convolutions.{i}.0.conv")
                       for i in range(3)],
             "norms": [{"gamma": _np(sd[f"encoder.convolutions.{i}.1.weight"]),
                        "beta": _np(sd[f"encoder.convolutions.{i}.1.bias"])}
                       for i in range(3)],
             "lstm": _bilstm_sd(sd, "encoder.lstm",
                                _norm_kind(g("text_encoder_lstm_norm")))}}
    if ((("atn" in include or "dec" in include)
         and g("learn_alignments", False))
            and "attention.key_proj.0.conv.weight" in sd):
        p["attention"] = {
            "key_proj": [_conv_sd(sd, f"attention.key_proj.{i}.conv")
                         for i in (0, 2)],
            "query_proj": [_conv_sd(sd, f"attention.query_proj.{i}.conv")
                           for i in (0, 2, 4)]}
    if g("use_context_lstm", False):
        p["context_lstm"] = _bilstm_sd(sd, "context_lstm",
                                       _norm_kind(g("context_lstm_norm")))
    if "dec" in include:
        p["flows"] = [_flow_sd(sd, f"flows.{i}", cfg["n_conv_layers_per_step"],
                               g("matrix_decomposition", "") == "LUS",
                               g("affine_model", "simple_conv"))
                      for i in range(cfg["n_flows"])]
    for name, key in attributes:
        p[name] = _attribute_sd(sd, name, cfg[key])
    if use_unvoiced_bias:
        p["unvoiced_bias"] = _linear_sd(
            sd, "unvoiced_bias_module.0.linear_layer")
    if voiced_embeddings and "v_pred_module" in p:
        p["v_embeddings"] = {"table": _np(sd["v_embeddings.weight"])}
    return p


# ---------------------------------------------------------------------------
# tensor-parallel shards of the training form
# ---------------------------------------------------------------------------

_MOMENTS = ("exp_avg", "exp_avg_sq")


def tp_slice(t, axis, rank, n_model):
    """Rank `rank`'s slice of t along axis, of n_model equal slices."""
    width = t.shape[axis] // n_model
    return t.narrow(axis, rank * width, width)


@torch.no_grad()
def shard_train_model(model, optimizer, n_model, rank):
    """In place: every parameter of the training-form model that
    parallel.mesh.tp_axis shards keeps rank's slice, and so do its
    optimizer moments where the optimizer holds any (a resumed run's).
    The parameters stay the objects the optimizer holds. Returns
    {parameter name: sharded axis}."""
    from radtts_tpu_torch.parallel.mesh import tp_axis

    axes = {}
    for name, p in model.named_parameters():
        axis = tp_axis(name, tuple(p.shape), n_model)
        if axis is None:
            continue
        axes[name] = axis
        p.data = tp_slice(p.data, axis, rank, n_model).clone()
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for k in _MOMENTS:
            if k in state:
                state[k] = tp_slice(state[k], axis, rank, n_model).clone()
    return axes


def unshard_train_state(model, optimizer, axes, gather):
    """(model state dict, optimizer state dict) in the single-process
    layout: each sharded parameter (axes: {name: axis}) and its moments
    replaced by gather(tensor, axis), the whole tensor. The live state is
    left as it is."""
    sd = dict(model.state_dict())
    for name, axis in axes.items():
        sd[name] = gather(sd[name], axis)
    osd = optimizer.state_dict()
    names = {id(p): n for n, p in model.named_parameters()}
    order = [p for group in optimizer.param_groups for p in group["params"]]
    state = {}
    for i, st in osd["state"].items():
        axis = axes.get(names[id(order[i])])
        state[i] = {k: gather(v, axis) if axis is not None and k in _MOMENTS
                    else v for k, v in st.items()}
    return sd, dict(osd, state=state)


# ---------------------------------------------------------------------------
# optimizer moments of the JAX package's checkpoints
# ---------------------------------------------------------------------------

_EXACT = 1 << 24     # float32 holds every integer up to 2^24


def tree_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict/list tree, the path's components
    joined by '/' as in the .npz (radtts_tpu/train/checkpoint.py)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _tree_map(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def element_map(build, tree):
    """Where each parameter of build(tree) (a loader of this module:
    radtts_train_from_jax, vocoder_train_from_jax) takes its elements from
    in the JAX tree: {name: [(leaf path, positions in the flat parameter,
    flat indices into that leaf)], one entry per leaf it draws on (several
    where the loader stacks leaves)}, or None for a parameter that is not
    an elementwise relabelling of JAX leaves (a norm folded, a product made
    at load, a parameter the tree does not fill). Found by building from
    two trees of numbers: each leaf's element numbers, then each leaf's own
    number; the loader's layout changes (transposes, flips, stacks) carry
    them as they carry the weights. The numbers are float32 (exact up to
    2^24, checked), the indices int32, and the positions of a parameter
    drawn from one leaf slice(None): a map holds ~4 bytes an element, so
    that the full discriminators' 71 M parameters cost ~0.3 GB, not
    several."""
    floats = [(p, np.asarray(a)) for p, a in tree_leaves(tree)
              if np.asarray(a).dtype.kind == "f"]
    number = {p: i + 1 for i, (p, _) in enumerate(floats)}
    for p, a in floats:
        if a.size > _EXACT:
            raise ValueError(f"element_map: {p} has {a.size} elements, more "
                             "than float32 numbers exactly")
    if len(floats) > _EXACT:
        raise ValueError(f"element_map: {len(floats)} leaves, more than "
                         "float32 numbers exactly")
    sizes = np.array([0] + [a.size for _, a in floats])

    def numbered(fn):
        """{name: flat float32 numbers} of build() on the numbered tree
        (the model itself is freed)."""
        model = build(_tree_map(tree, lambda p, a: fn(p, np.asarray(a))
                                if p in number else a))
        return {name: t.detach().reshape(-1).numpy()
                for name, t in model.named_parameters()}

    by_leaf = numbered(lambda p, a: np.full(a.shape, number[p], np.float32))
    by_element = numbered(lambda p, a: np.arange(
        1, a.size + 1, dtype=np.float32).reshape(a.shape))
    out = {}
    for name, leaf in by_leaf.items():
        elem = by_element.pop(name)
        out[name] = None
        if not (np.isfinite(leaf).all() and np.isfinite(elem).all()
                and (leaf == np.round(leaf)).all()
                and (elem == np.round(elem)).all()):
            continue
        leaf, elem = leaf.astype(np.int32), elem.astype(np.int32) - 1
        if (leaf.size == 0 or leaf.min() < 1 or leaf.max() > len(floats)
                or elem.min() < 0 or (elem >= sizes[leaf]).any()
                or np.unique(leaf.astype(np.int64) * _EXACT
                             + elem).size != leaf.size):
            continue
        ids = np.unique(leaf)
        if ids.size == 1:
            out[name] = [(floats[ids[0] - 1][0], slice(None), elem)]
        else:
            out[name] = [(floats[k - 1][0], np.nonzero(leaf == k)[0],
                          elem[leaf == k]) for k in ids]
    return out


def optimizer_state_from_jax(optimizer, named_params, emap, count, mu, nu,
                             step=int):
    """optimizer.state_dict() whose state is JAX's moments: for each
    parameter of the optimizer (named in named_params), exp_avg from the
    `mu` tree and exp_avg_sq from `nu` (keyed like the parameter tree),
    laid out by `emap` (element_map), and step(count) updates made. Raises,
    naming the parameter, where a moment cannot be carried; never zeroes
    one."""
    names = {id(p): n for n, p in named_params}
    mu, nu = dict(tree_leaves(mu)), dict(tree_leaves(nu))
    sd = optimizer.state_dict()
    state, i = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            hit = emap.get(name)
            if hit is None:
                raise ValueError(
                    f"cannot carry the JAX optimizer's moments into {name}: "
                    "its form in the port is not an elementwise relabelling "
                    "of JAX parameters")
            for path, _, _ in hit:
                if path not in mu or path not in nu:
                    raise KeyError(f"the checkpoint's optimizer state has "
                                   f"no moments for {path} ({name})")

            def take(tree):
                a = np.empty(p.numel(), np.float32)
                for path, pos, idx in hit:
                    a[pos] = np.asarray(tree[path], np.float32).reshape(-1)[
                        idx]
                return torch.from_numpy(a.reshape(tuple(p.shape)))
            state[i] = {"step": step(count), "exp_avg": take(mu),
                        "exp_avg_sq": take(nu)}
            i += 1
    sd["state"] = state
    return sd
