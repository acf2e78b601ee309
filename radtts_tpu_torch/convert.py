"""Carry weights from the JAX package's parameter trees into the port's
modules.

Inputs are nested dicts and lists of numpy arrays, as radtts_init /
hifigan_generator_init produce them with the `_meta` / `_kind` entries
removed. Norm factorizations are folded first (ops/fold_norms.py), the
invertible 1x1 inverses are computed after loading, and each layout is
converted: conv kernels (K, C_in, C_out) -> (C_out, C_in, K); linear
(in, out) -> (out, in); LSTM w_ih (in, 4H) -> (4H, in); flipped
transposed-conv kernels (K, C_in, C_out) -> (C_in, C_out, K) unflipped.
MRF resblock convs keep the taps-major (3, K, C_in, C_out) layout the
kernel reads. The discriminators' kernels go to torch's conv layouts.
"""

import numpy as np
import torch

from radtts_tpu_torch.models.hifigan import Generator
from radtts_tpu_torch.models.radtts import RADTTS
from radtts_tpu_torch.ops.fold_norms import fold_norms
from radtts_tpu_torch.train.vocoder_trainer import vocoder_train_init


@torch.no_grad()
def _set(param, array):
    a = torch.from_numpy(np.array(array, dtype=np.float32, copy=True))
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} into "
                         f"{tuple(param.shape)}")
    param.copy_(a)


def _conv(mod, p):
    _set(mod.weight, np.transpose(p["w"], (2, 1, 0)))
    if "b" in p:
        _set(mod.bias, p["b"])


def _linear(mod, p):
    _set(mod.weight, np.asarray(p["w"]).T)
    if "b" in p:
        _set(mod.bias, p["b"])


def _lstm(mod, p):
    cells = ([("", p["fwd"]), ("_reverse", p["bwd"])]
             if mod.lstm.bidirectional else [("", p)])
    for sfx, cell in cells:
        _set(getattr(mod.lstm, "weight_ih_l0" + sfx),
             np.asarray(cell["w_ih"]).T)
        _set(getattr(mod.lstm, "weight_hh_l0" + sfx), cell["hh"]["w"])
        _set(getattr(mod.lstm, "bias_ih_l0" + sfx), cell["b_ih"])
        _set(getattr(mod.lstm, "bias_hh_l0" + sfx), cell["b_hh"])


def _invertible(mod, p):
    for name in ("p", "lower", "upper", "upper_diag"):
        _set(getattr(mod, name), p[name])
    mod.precompute_inverse()


def _dap(mod, p):
    _conv(mod.bottleneck.proj, p["bottleneck"]["proj"])
    feat = p["feat"]
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


def radtts_from_jax(params_np, model_config):
    """RADTTS module (eval, no grad) holding the JAX tree's weights."""
    p = fold_norms(params_np)
    model = RADTTS(model_config)
    _set(model.speaker_embedding.weight, p["speaker_embedding"]["table"])
    _set(model.embedding.weight, p["embedding"]["table"])
    for conv, cp in zip(model.encoder.convs, p["encoder"]["convs"]):
        _conv(conv, cp)
    for norm, npar in zip(model.encoder.norms, p["encoder"]["norms"]):
        _set(norm.gamma, npar["gamma"])
        _set(norm.beta, npar["beta"])
    _lstm(model.encoder.lstm, p["encoder"]["lstm"])
    if model.context_lstm is not None:
        _lstm(model.context_lstm, p["context_lstm"])
    for flow, fp in zip(model.flows, p.get("flows", [])):
        _invertible(flow.inv, fp["inv"])
        _wn(flow.affine.pred, fp["affine"]["pred"])
    for name in ("dur_pred_layer", "v_pred_module", "f0_pred_module",
                 "energy_pred_module"):
        if getattr(model, name) is not None:
            _dap(getattr(model, name), p[name])
    if model.unvoiced_bias is not None:
        _linear(model.unvoiced_bias, p["unvoiced_bias"])
    if model.v_embeddings is not None:
        _set(model.v_embeddings.weight, p["v_embeddings"]["table"])
    return model.eval().requires_grad_(False)


def _generator(p, h):
    gen = Generator(h)
    _conv(gen.conv_pre, p["conv_pre"])
    _conv(gen.conv_post, p["conv_post"])
    for up, up_p in zip(gen.ups, p["ups"]):
        _set(up.weight, np.transpose(up_p["w"], (1, 2, 0))[:, :, ::-1])
        _set(up.bias, up_p["b"])
    for stage, group in zip(gen.resblocks, p["resblocks"]):
        for blk, bp in zip(stage, group):
            for i in (1, 2):
                convs = bp[f"convs{i}"]
                _set(getattr(blk, f"w{i}"), np.stack([c["w"] for c in convs]))
                _set(getattr(blk, f"b{i}"), np.stack([c["b"] for c in convs]))
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
