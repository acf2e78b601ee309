"""RADTTS: speaker/text embedding, the alignment attention, duration
prediction, attribute prediction, and the flow decoder, forward (training)
and inverse with early-exit replay (inference).

`RADTTS(model_config)` builds the modules from a reference-format
model_config (random init, usable for random flagship weights), in the
inference form, whose norms are folded; `RADTTS(model_config,
factored=True)` builds the training form, which holds the JAX package's
factorizations ({v, g} weight norm, {sn_w, sn_u, sn_v} spectral norm, the
LU factors) as parameters and buffers, and `fold_radtts` turns it into the
inference form. The functions below mirror the JAX package's, taking the
module where those take the params tree. Tensors are channels-last.
"""

import copy

import torch
from torch import nn

from radtts_tpu_torch import tracing
from radtts_tpu_torch.debug import check_finite
from radtts_tpu_torch.models.attention import ConvAttention
from radtts_tpu_torch.models.attributes import (attribute_model,
                                                attribute_model_forward,
                                                attribute_model_infer,
                                                agap_infer_multi,
                                                fold_group, unfold_group)
from radtts_tpu_torch.models.coupling import AffineCoupling
from radtts_tpu_torch.models.encoder import Encoder
from radtts_tpu_torch.ops.amp import cast_in, cast_out
from radtts_tpu_torch.ops.conv import ConvNorm
from radtts_tpu_torch.ops.invertible import InvConv1x1, InvConv1x1LUS
from radtts_tpu_torch.ops.length_regulator import regulate_length
from radtts_tpu_torch.ops.linear import LinearNorm
from radtts_tpu_torch.ops.lstm import MaskedLSTM
from radtts_tpu_torch.ops.mas import mas
from radtts_tpu_torch.ops.masking import sequence_mask


def attribute_config(config, use_first_order_features):
    """An f0/energy model config as the model builds it: with first-order
    features the flows take 2 input channels (radtts_tpu/models/
    radtts.py:199-210)."""
    hp = dict(config["hparams"])
    if use_first_order_features:
        hp["n_in_dim"] = 2
    if hp.get("spline_flow_params") is not None:
        hp["spline_flow_params"] = dict(
            hp["spline_flow_params"], n_in_channels=hp.get("n_in_dim", 1))
    return dict(config, hparams=hp)


def _norm_kind(name):
    if name is None:
        return None
    if "spectral" in name:
        return "spectral"
    if "weight" in name:
        return "weight"
    return None


class FlowStep(nn.Module):
    def __init__(self, inv, affine):
        super().__init__()
        self.inv = inv
        self.affine = affine


class RADTTS(nn.Module):
    # a bf16 region around the context BiLSTM when set (ops/amp.py)
    amp = False

    def __init__(self, model_config, factored=False):
        super().__init__()
        self.factored = factored
        cfg = dict(model_config)
        g = cfg.get
        n_speaker_dim = cfg["n_speaker_dim"]
        n_text_dim = cfg["n_text_dim"]
        n_group_size = cfg["n_group_size"]
        include_modules = g("include_modules", "dec")
        n_f0_dims = g("n_f0_dims", 0)
        n_energy_dims = g("n_energy_avg_dims", 0)
        use_context_lstm = bool(g("use_context_lstm", False))
        context_lstm_w_f0_and_energy = g("context_lstm_w_f0_and_energy", True)
        decoder_use_unvoiced_bias = g("decoder_use_unvoiced_bias", True)
        ap_use_unvoiced_bias = g("ap_use_unvoiced_bias", True)
        ap_use_voiced_embeddings = g("ap_use_voiced_embeddings", True)
        unvoiced_bias_activation = g("unvoiced_bias_activation", "")

        self.speaker_embedding = nn.Embedding(cfg["n_speakers"],
                                              n_speaker_dim)
        self.embedding = nn.Embedding(cfg["n_text"], n_text_dim)
        for emb in (self.speaker_embedding, self.embedding):
            nn.init.normal_(emb.weight)
        self.encoder = Encoder(
            encoder_embedding_dim=n_text_dim,
            lstm_norm=_norm_kind(g("text_encoder_lstm_norm")),
            factored=factored)

        self.attention = None
        if (("atn" in include_modules or "dec" in include_modules)
                and g("learn_alignments", False)):
            self.attention = ConvAttention(
                cfg["n_mel_channels"], n_text_dim
                + (n_speaker_dim if g("use_speaker_emb_for_alignment", False)
                   else 0))

        n_flowstep_cond_dims = (
            n_speaker_dim + (n_text_dim + n_f0_dims + n_energy_dims)
            * n_group_size)
        self.context_lstm = None
        if use_context_lstm:
            n_in = n_speaker_dim + n_text_dim * n_group_size
            n_hidden = int((n_speaker_dim + n_text_dim * n_group_size) / 2)
            if context_lstm_w_f0_and_energy:
                n_in = ((n_f0_dims + n_energy_dims + n_text_dim)
                        * n_group_size + n_speaker_dim)
                n_flowstep_cond_dims = (n_speaker_dim
                                        + n_text_dim * n_group_size)
            self.context_lstm = MaskedLSTM(
                n_in, n_hidden, norm=_norm_kind(g("context_lstm_norm")),
                factored=factored)

        exit_steps = []
        self.flows = nn.ModuleList()
        if "dec" in include_modules:
            # the LU-decomposed 1x1, or the plain W for any other
            # matrix_decomposition (radtts_tpu/models/radtts.py:144-147)
            inv1x1 = (InvConv1x1LUS if g("matrix_decomposition", "") == "LUS"
                      else InvConv1x1)
            ch = cfg["n_mel_channels"] * n_group_size
            for i in range(cfg["n_flows"]):
                if i > 0 and i % cfg["n_early_every"] == 0:
                    ch -= cfg["n_early_size"]
                    exit_steps.append(i)
                self.flows.append(FlowStep(
                    inv1x1(ch, trainable=factored),
                    AffineCoupling(ch, n_flowstep_cond_dims,
                                   cfg["n_conv_layers_per_step"],
                                   affine_model=g("affine_model",
                                                  "simple_conv"),
                                   n_hidden=g("affine_n_channels", 1024),
                                   factored=factored)))

        self.dur_pred_layer = None
        if "dpm" in include_modules:
            self.dur_pred_layer = attribute_model(cfg["dur_model_config"],
                                                  n_speaker_dim, factored)

        use_unvoiced_bias = bool(decoder_use_unvoiced_bias
                                 or ap_use_unvoiced_bias)
        self.unvoiced_bias = None
        if use_unvoiced_bias:
            if unvoiced_bias_activation not in {"relu", "exp"}:
                raise ValueError("unvoiced_bias_activation must be relu or "
                                 f"exp, got {unvoiced_bias_activation!r}")
            self.unvoiced_bias = LinearNorm(n_text_dim, 1)

        use_vpred_module = bool(ap_use_voiced_embeddings or use_unvoiced_bias
                                or "vpred" in include_modules)
        self.v_pred_module = self.v_embeddings = None
        if use_vpred_module:
            self.v_pred_module = attribute_model(cfg["v_model_config"],
                                                 n_speaker_dim, factored)
            if ap_use_voiced_embeddings:
                self.v_embeddings = nn.Embedding(4, n_text_dim)
                nn.init.normal_(self.v_embeddings.weight)

        self.f0_pred_module = self.energy_pred_module = None
        use_fof = bool(g("use_first_order_features", False))
        if "apm" in include_modules:
            self.f0_pred_module, self.energy_pred_module = (
                attribute_model(attribute_config(cfg[name], use_fof),
                                n_speaker_dim, factored)
                for name in ("f0_model_config", "energy_model_config"))

        self.meta = dict(
            n_mel_channels=cfg["n_mel_channels"],
            n_group_size=n_group_size,
            n_early_size=cfg["n_early_size"],
            exit_steps=tuple(exit_steps),
            include_modules=include_modules,
            use_speaker_emb_for_alignment=bool(
                g("use_speaker_emb_for_alignment", False)),
            attn_straight_through_estimator=bool(
                g("attn_straight_through_estimator", False)),
            ap_use_unvoiced_bias=bool(ap_use_unvoiced_bias),
            scaling_fn=g("scaling_fn", "exp"),
            affine_activation=g("affine_activation", "softplus"),
            use_context_lstm=use_context_lstm,
            context_lstm_w_f0_and_energy=bool(context_lstm_w_f0_and_energy),
            n_f0_dims=n_f0_dims,
            n_energy_avg_dims=n_energy_dims,
            decoder_use_unvoiced_bias=bool(decoder_use_unvoiced_bias),
            ap_use_voiced_embeddings=bool(ap_use_voiced_embeddings),
            ap_pred_log_f0=bool(g("ap_pred_log_f0", False)),
            use_first_order_features=use_fof,
            unvoiced_bias_activation=unvoiced_bias_activation,
            use_unvoiced_bias=use_unvoiced_bias,
            use_vpred_module=use_vpred_module,
            dummy_speaker_embedding=bool(g("dummy_speaker_embedding",
                                           False)),
            do_mel_descaling=bool(g("do_mel_descaling", True)),
            decoder_use_partial_padding=bool(
                g("decoder_use_partial_padding", True)),
        )


# ---------------------------------------------------------------------------
# shared sub-computations
# ---------------------------------------------------------------------------


def encode_speaker(model, spk_ids):
    if model.meta["dummy_speaker_embedding"]:
        spk_ids = spk_ids * 0
    return model.speaker_embedding(spk_ids)


def encode_text(model, text, in_lens, generator=None):
    """(text encoding, embeddings); a generator draws the encoder's
    training dropout."""
    with tracing.span("text_encoder", text.device):
        emb = model.embedding(text)
        return model.encoder(emb, in_lens, generator), emb


def apply_voice_mask_to_text(model, text_enc, voiced_mask):
    """Gate time-expanded text features by the voicing decision through the
    learned scale/bias embeddings."""
    table = model.v_embeddings.weight                  # (4, C)
    vm = voiced_mask[:, :, None]
    scale = torch.sigmoid(table[0] * vm + table[1] * (1 - vm))
    bias = 0.1 * torch.tanh(table[2] * vm + table[3] * (1 - vm))
    return text_enc * scale + bias


def _unvoiced_bias(model, context, voiced_mask):
    raw = model.unvoiced_bias(context)[..., 0]
    if model.meta["unvoiced_bias_activation"] == "exp":
        raw = torch.exp(raw)
    else:
        raw = torch.relu(raw)
    return -raw * (1.0 - voiced_mask)


def preprocess_context(model, context, speaker_vecs, out_lens=None, f0=None,
                       energy_avg=None):
    """Group the context, append the speaker (and f0/energy), and run the
    bidirectional context LSTM if the model has one."""
    with tracing.span("context", context.device):
        meta = model.meta
        g = meta["n_group_size"]
        context = unfold_group(context, g)
        if f0 is not None:
            f0 = unfold_group(f0[:, :, None], g)
        if energy_avg is not None:
            energy_avg = unfold_group(energy_avg[:, :, None], g)
        B, Tg, _ = context.shape
        spk = speaker_vecs[:, None, :].expand(B, Tg, -1)
        ctx = torch.cat([context, spk], dim=-1)
        extra = [a for a in (f0, energy_avg) if a is not None]
        if meta["use_context_lstm"]:
            if meta["context_lstm_w_f0_and_energy"]:
                ctx = torch.cat([ctx] + extra, dim=-1)
            lens_g = None if out_lens is None else out_lens // g
            ctx = cast_out(model.context_lstm(cast_in(ctx, model.amp), lens_g),
                           model.amp)
        if not meta["context_lstm_w_f0_and_energy"]:
            ctx = torch.cat([ctx] + extra, dim=-1)
        return ctx


def is_attribute_unconditional(meta):
    return meta["n_f0_dims"] == 0 and meta["n_energy_avg_dims"] == 0


def binarize_attention(attn_soft, in_lens, out_lens):
    """MAS over the detached soft attention, without gradient
    (ops/mas.py: the kernel on the card)."""
    attn_soft = check_finite(attn_soft, "soft attention map")
    return mas(attn_soft.detach(), out_lens, in_lens)


def get_first_order_features(feats, dilation=1):
    """Symmetric first differences along time (reference:
    radtts.py:336-349)."""
    zeros = torch.zeros_like(feats[:, 0:dilation])
    ext_r = torch.cat([feats, zeros], dim=1)
    ext_l = torch.cat([zeros, feats], dim=1)
    dr = ext_r[:, dilation:] - feats
    dl = feats - ext_l[:, 0:feats.shape[1]]
    return (dr + dl) * 0.5


def _flow_step_forward(model, flow, z, context, mask):
    meta = model.meta
    z, log_det_W = flow.inv(z)
    z, log_s = flow.affine(
        z, context, scaling_fn=meta["scaling_fn"],
        affine_activation=meta["affine_activation"], mask=mask,
        use_partial_padding=meta["decoder_use_partial_padding"])
    log_s = check_finite(log_s, "decoder flow log_s")
    log_det_W = check_finite(log_det_W, "decoder flow log_det_W")
    return z, log_det_W, log_s


def _flow_step_inverse(model, flow, z, context, mask):
    meta = model.meta
    z = flow.affine.inverse(
        z, context, scaling_fn=meta["scaling_fn"],
        affine_activation=meta["affine_activation"], mask=mask,
        use_partial_padding=meta["decoder_use_partial_padding"])
    return flow.inv.inverse(z)


# ---------------------------------------------------------------------------
# training forward (radtts_tpu/models/radtts.py:386-545)
# ---------------------------------------------------------------------------


def radtts_forward(model, mel, speaker_ids, text, in_lens, out_lens, *,
                   binarize_attention_flag=False, attn_prior=None, f0=None,
                   energy_avg=None, voiced_mask=None, p_voiced=None,
                   generator=None):
    """mel: (B, T, n_mel); text: (B, N) int64. Returns the outputs dict of
    the JAX package's radtts_forward. A generator draws the training
    dropout (encoder, DAP fronts); None runs without dropout.
    Stop-gradients sit where the JAX package puts them."""
    meta = model.meta
    sg = torch.Tensor.detach
    speaker_vecs = encode_speaker(model, speaker_ids)
    text_enc, text_emb = encode_text(model, text, in_lens, generator)
    outputs = {
        "z_mel": None, "log_det_W_list": [], "log_s_list": [],
        "duration_model_outputs": None, "f0_model_outputs": None,
        "energy_model_outputs": None, "vpred_model_outputs": None,
        "attn_soft": None, "attn": None, "text_embeddings": text_emb,
        "attn_logprob": None,
    }
    attn = attn_soft = attn_hard = context = None
    include = meta["include_modules"]
    if "atn" in include or "dec" in include:
        keys = text_emb
        if meta["use_speaker_emb_for_alignment"]:
            keys = torch.cat([keys, sg(speaker_vecs)[:, None, :].expand(
                -1, keys.shape[1], -1)], dim=-1)
        attn_soft, attn_logprob = model.attention(mel, keys, in_lens,
                                                  attn_prior=attn_prior)
        outputs["attn_soft"] = attn_soft
        outputs["attn_logprob"] = attn_logprob
        if binarize_attention_flag:
            attn = attn_hard = binarize_attention(attn_soft, in_lens,
                                                  out_lens)
            if meta["attn_straight_through_estimator"]:
                attn_hard = attn_soft + sg(attn_hard - attn_soft)
            attn = attn_hard
        else:
            attn = attn_soft
        outputs["attn"] = attn
        context = torch.bmm(attn, text_enc)

    f0_bias = 0.0
    if meta["use_unvoiced_bias"]:
        f0_bias = _unvoiced_bias(model, context, voiced_mask)

    if "dec" in include:
        g = meta["n_group_size"]
        mel_g = unfold_group(mel, g)
        if f0 is None:
            f0_aug = None
        elif meta["decoder_use_unvoiced_bias"]:
            f0_aug = f0 * voiced_mask + f0_bias
        else:
            f0_aug = f0 * voiced_mask
        ctx = preprocess_context(model, context, speaker_vecs, out_lens,
                                 f0_aug, energy_avg)
        mask_g = sequence_mask(out_lens // g, mel_g.shape[1])
        z_out = []
        n_early = meta["n_early_size"]
        for i, flow in enumerate(model.flows):
            if i in meta["exit_steps"]:
                z_out.append(mel_g[..., :n_early])
                mel_g = mel_g[..., n_early:]
            mel_g, log_det_W, log_s = _flow_step_forward(model, flow, mel_g,
                                                         ctx, mask_g)
            outputs["log_s_list"].append(log_s)
            outputs["log_det_W_list"].append(log_det_W)
        z_out.append(mel_g)
        outputs["z_mel"] = torch.cat(z_out, dim=-1)

    if "dpm" in include:
        if attn_hard is None:
            attn_hard = binarize_attention(attn_soft, in_lens, out_lens)
        durations = attn_hard.sum(1)
        outputs["duration_model_outputs"] = attribute_model_forward(
            model.dur_pred_layer, sg(text_enc), sg(speaker_vecs),
            sg(durations.float()), in_lens, generator)

    if "apm" in include:
        if attn_hard is None:
            attn_hard = binarize_attention(attn_soft, in_lens, out_lens)
        if binarize_attention_flag:
            text_enc_time_expanded = context
        else:
            text_enc_time_expanded = torch.bmm(attn_hard, text_enc)
        if meta["use_vpred_module"]:
            outputs["vpred_model_outputs"] = attribute_model_forward(
                model.v_pred_module, sg(text_enc_time_expanded),
                sg(speaker_vecs), sg(voiced_mask), out_lens, generator)
            if meta["ap_use_voiced_embeddings"]:
                text_enc_time_expanded = apply_voice_mask_to_text(
                    model, text_enc_time_expanded, voiced_mask)
        if meta["ap_use_unvoiced_bias"]:
            f0_target = sg(f0 * voiced_mask + f0_bias)
        else:
            f0_target = sg(f0)
        f0_target = torch.where(voiced_mask.bool(),
                                torch.log(f0_target.clamp(min=1e-10)),
                                f0_target) / 6.0
        energy_target = energy_avg * 2.0 - 1.0
        if meta["use_first_order_features"]:
            f0_in = torch.stack([f0_target, get_first_order_features(
                f0_target)], dim=-1) * 3.0
            energy_in = torch.stack([energy_target, get_first_order_features(
                energy_target)], dim=-1) * 3.0
        else:
            f0_in = f0_target * 2.0
            energy_in = energy_target * 1.4
        # one after the other (the JAX package fuses a DAP pair's BiLSTMs
        # into one scan; the sums are the same)
        outputs["f0_model_outputs"], outputs["energy_model_outputs"] = (
            attribute_model_forward(m, text_enc_time_expanded,
                                    sg(speaker_vecs), x, out_lens, generator)
            for m, x in ((model.f0_pred_module, f0_in),
                         (model.energy_pred_module, energy_in)))
    return outputs


def fold_radtts(model):
    """The inference form of a (training-form) RADTTS, in a copy: every
    factorization collapsed as the JAX tree's load fold does it
    (ops/fold_norms.py), the 1x1 inverses computed. Eval, no grad."""
    out = copy.deepcopy(model)
    for parent in list(out.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, (ConvNorm, MaskedLSTM, InvConv1x1LUS,
                                  InvConv1x1)):
                setattr(parent, name, child.folded())
    out.factored = False
    return out.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# inference: durations, then decode at a frame budget
# ---------------------------------------------------------------------------


def duration_noise(model, B, N, sigma_dur, generator, device):
    """infer_durations' noise: z_dur (B, N, 1) from generator times
    sigma_dur for a flow duration model, None for the DAP."""
    if model.dur_pred_layer.name == "dap":
        return None
    return torch.randn(B, N, 1, generator=generator, device=device) \
        * sigma_dur


def infer_noise(model, B, max_frames, *, sigma, sigma_f0, sigma_energy,
                generator, device, z_f0=None, z_energy=None, residual=None,
                f0=None, energy_avg=None):
    """radtts_infer's noise, each one not given drawn from generator in
    this order: z_f0 then z_energy (B, max_frames, 2 with first-order
    features else 1) times sigma_f0 / sigma_energy where a flow attribute
    model (BGAP, AGAP; a DAP draws none) predicts the feature (f0 /
    energy_avg not given), then the decoder's residual (B, max_frames/g,
    n_mel*g) times sigma. Returns (z_f0, z_energy, residual)."""
    meta = model.meta

    def draw(shape, sig):
        return torch.randn(*shape, generator=generator, device=device) * sig

    if not is_attribute_unconditional(meta):
        n_ch = 2 if meta["use_first_order_features"] else 1
        for name, given, z, sig in (
                ("f0_pred_module", f0, z_f0, sigma_f0),
                ("energy_pred_module", energy_avg, z_energy, sigma_energy)):
            if (given is None and z is None
                    and getattr(model, name).name != "dap"):
                z = draw((B, max_frames, n_ch), sig)
            if name == "f0_pred_module":
                z_f0 = z
            else:
                z_energy = z
    if residual is None:
        g = meta["n_group_size"]
        residual = draw((B, max_frames // g, meta["n_mel_channels"] * g),
                        sigma)
    return z_f0, z_energy, residual


def infer_durations(model, speaker_id_text, text, token_dur_scaling=1.0,
                    token_duration_max=100, in_lens=None, *, sigma_dur=0.8,
                    z_dur=None, generator=None):
    """Predict integer per-token durations. text: (B, N) int64.

    in_lens: optional (B,) true token counts for padded batches (pad
    positions get duration 0). A flow duration model samples from z_dur
    (B, N, 1), drawn from `generator` times sigma_dur when None; the DAP
    takes no noise."""
    with tracing.span("durations", text.device):
        spk_vec_text = encode_speaker(model, speaker_id_text)
        txt_enc, _ = encode_text(model, text, in_lens)
        B, N = text.shape
        dur_model = model.dur_pred_layer
        if z_dur is None:
            z_dur = duration_noise(model, B, N, sigma_dur, generator,
                                   txt_enc.device)
        dur = attribute_model_infer(dur_model, txt_enc, spk_vec_text, in_lens,
                                    z=z_dur)[..., 0]
        g_dur = getattr(dur_model, "n_group_size", 1)
        if dur.shape[1] < N:
            # a grouped flow gives N // g tokens: replication pad (reference
            # radtts.py:562-566)
            dur = torch.cat([dur, dur[:, -1:].expand(-1, N - dur.shape[1])],
                            dim=1)
        if in_lens is not None and g_dur > 1:
            # padded texts: tokens past (len // g) * g take that item's last
            # computed group, as the exact-length run's replication pad does
            last = ((in_lens // g_dur) * g_dur - 1).clamp(min=0)
            idx = torch.minimum(torch.arange(N, device=dur.device)[None, :],
                                last[:, None])
            dur = torch.gather(dur, 1, idx)
        dur = dur.clamp(0, token_duration_max)
        if token_dur_scaling > 0:
            dur = dur * token_dur_scaling
        dur = torch.floor(dur + 0.5).to(torch.int32)
        if in_lens is not None:
            dur = dur * (torch.arange(N, device=dur.device)[None, :]
                         < in_lens[:, None])
        return dur


def renormalize_f0(f0, voiced_mask, f0_mean, f0_std=0.0, out_lens=None):
    """Shift/scale voiced f0 frames to a target mean/std, per item, with
    Bessel-corrected stats over that item's voiced frames (padding frames
    past out_lens excluded)."""
    vm = voiced_mask
    if out_lens is not None:
        T = f0.shape[-1]
        vm = vm * (torch.arange(T, device=f0.device)[None, :]
                   < out_lens[:, None])
    cnt = vm.sum(-1, keepdim=True)
    mu = (f0 * vm).sum(-1, keepdim=True) / cnt.clamp(min=1)
    var = ((f0 - mu) ** 2 * vm).sum(-1, keepdim=True) / (cnt - 1).clamp(min=1)
    sig = torch.sqrt(var)
    f0_std_eff = f0_std if f0_std > 0 else sig
    return torch.where(vm.bool(), (f0 - mu) / sig * f0_std_eff + f0_mean, f0)


def _f0_postprocess(meta, f0, voiced_mask=None):
    if meta["ap_pred_log_f0"]:
        if meta["use_first_order_features"]:
            f0 = f0[..., 0:1] / 3.0
        else:
            f0 = f0 / 2.0
        f0 = f0 * 6.0
    else:
        f0 = f0 / 6.0 / 640.0
    if voiced_mask is None:
        vm = f0 > 0.0
    else:
        vm = voiced_mask.bool()
        if vm.ndim == 2:
            vm = vm[:, :, None]
        vm = vm[:, : f0.shape[1]]
    if meta["ap_pred_log_f0"]:
        f0 = torch.where(vm, torch.exp(f0), f0)
    return torch.where(vm, f0, torch.zeros_like(f0))


def _energy_postprocess(meta, energy):
    if meta["use_first_order_features"]:
        energy = energy[..., 0:1] / 3.0
    else:
        energy = energy / 1.4
    return (energy + 1.0) / 2.0


def radtts_infer(model, speaker_id, text, sigma, max_frames, *, dur,
                 sigma_f0=0.8, sigma_energy=0.8, speaker_id_text=None,
                 speaker_id_attributes=None, f0=None, energy_avg=None,
                 voiced_mask=None, f0_mean=0.0, f0_std=0.0, energy_mean=0.0,
                 energy_std=0.0, residual=None, z_f0=None, z_energy=None,
                 in_lens=None, generator=None):
    """Attributes + inverse flow decode at a frame budget.

    dur: (B, N) int durations; max_frames >= sum(dur), a multiple of the
    group size. Noise, each drawn from `generator` when None: z_f0 and
    z_energy (B, max_frames, 2 with first-order features else 1) times
    sigma_f0 / sigma_energy, which the flow attribute models (BGAP, AGAP)
    sample from and a DAP ignores; residual (B, max_frames/g, n_mel*g)
    times sigma, the decoder's. f0 / energy_avg (B, max_frames), where
    given, are used as they are and their predictor does not run (voice
    conversion); f0_mean > 0 renormalizes f0, given or predicted.
    speaker_id_text, energy_mean and energy_std are taken for the JAX
    package's signature and change nothing, as there. Returns a dict with
    mel (B, max_frames, n_mel); frames past sum(dur) are to be sliced
    off."""
    with tracing.span("decode", text.device):
        meta = model.meta
        g = meta["n_group_size"]
        B = text.shape[0]

        spk_vec = encode_speaker(model, speaker_id)
        spk_vec_attrs = (spk_vec if speaker_id_attributes is None
                         else encode_speaker(model, speaker_id_attributes))
        txt_enc, _ = encode_text(model, text, in_lens)
        z_f0, z_energy, residual = infer_noise(
            model, B, max_frames, sigma=sigma, sigma_f0=sigma_f0,
            sigma_energy=sigma_energy, generator=generator,
            device=txt_enc.device, z_f0=z_f0, z_energy=z_energy,
            residual=residual, f0=f0, energy_avg=energy_avg)

        out_lens = dur.sum(1)
        txt_enc_time_expanded = regulate_length(txt_enc, dur, max_frames)

        if not is_attribute_unconditional(meta):
            if voiced_mask is None and meta["use_vpred_module"]:
                v_logits = attribute_model_infer(
                    model.v_pred_module, txt_enc_time_expanded,
                    spk_vec_attrs, out_lens)
                voiced_mask = (torch.sigmoid(v_logits[..., 0])
                               > 0.5).float()

            ap_txt_enc = txt_enc_time_expanded
            if meta["ap_use_voiced_embeddings"]:
                ap_txt_enc = apply_voice_mask_to_text(
                    model, txt_enc_time_expanded, voiced_mask)

            f0_bias = 0.0
            if meta["use_unvoiced_bias"]:
                f0_bias = _unvoiced_bias(model, txt_enc_time_expanded,
                                         voiced_mask)

            f0_mod, e_mod = model.f0_pred_module, model.energy_pred_module
            if (f0 is None and energy_avg is None
                    and getattr(f0_mod, "name", None) == "agap"
                    and getattr(e_mod, "name", None) == "agap"
                    and len(f0_mod.flows) == len(e_mod.flows)):
                # both AGAP: the two predictors in lock step, each flow
                # pair's scans in one launch; the noise drawn in the same
                # order (energy takes spk_vec, not spk_vec_attrs, as in
                # the JAX package)
                f0_raw, e_raw = agap_infer_multi(
                    [f0_mod, e_mod], [z_f0, z_energy],
                    [ap_txt_enc, ap_txt_enc], [spk_vec_attrs, spk_vec],
                    out_lens)
                f0 = _f0_postprocess(meta, f0_raw, voiced_mask)[..., 0]
                energy_avg = _energy_postprocess(meta, e_raw)[..., 0]
            if f0 is None:
                f0_raw = attribute_model_infer(
                    f0_mod, ap_txt_enc, spk_vec_attrs, out_lens, z=z_f0)
                f0 = _f0_postprocess(meta, f0_raw, voiced_mask)[..., 0]
            if f0_mean > 0.0:
                f0 = renormalize_f0(f0, voiced_mask, f0_mean, f0_std,
                                    out_lens=out_lens)
            if energy_avg is None:
                # energy takes spk_vec, not spk_vec_attrs, as in the JAX
                # package
                e_raw = attribute_model_infer(
                    e_mod, ap_txt_enc, spk_vec, out_lens, z=z_energy)
                energy_avg = _energy_postprocess(meta, e_raw)[..., 0]

            if meta["decoder_use_unvoiced_bias"]:
                f0_ctx = f0 * voiced_mask + f0_bias
            else:
                f0_ctx = f0 * voiced_mask
            ctx = preprocess_context(model, txt_enc_time_expanded, spk_vec,
                                     out_lens, f0_ctx, energy_avg)
        else:
            ctx = preprocess_context(model, txt_enc_time_expanded, spk_vec,
                                     out_lens)

        Tg = max_frames // g
        exit_stack = list(meta["exit_steps"])
        n_early = meta["n_early_size"]
        mel_g = residual[..., len(exit_stack) * n_early:]
        remaining = residual[..., : len(exit_stack) * n_early]
        mask_g = sequence_mask(out_lens // g, Tg)

        with tracing.span("flows", text.device, frames=Tg):
            for i in reversed(range(len(model.flows))):
                mel_g = _flow_step_inverse(model, model.flows[i], mel_g, ctx,
                                           mask_g)
                if exit_stack and i == exit_stack[-1]:
                    exit_stack.pop()
                    chunk = remaining[..., len(exit_stack) * n_early:]
                    remaining = remaining[..., : len(exit_stack) * n_early]
                    mel_g = torch.cat([chunk, mel_g], dim=-1)

        mel = fold_group(mel_g, g)
        if meta["do_mel_descaling"]:
            mel = mel * 2 - 5.5
        return {"mel": mel, "dur": dur, "f0": f0, "energy_avg": energy_avg,
                "voiced_mask": voiced_mask, "out_lens": out_lens}
