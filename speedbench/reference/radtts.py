"""Plain PyTorch reference of RADTTS inference and the HiFi-GAN generator.

A frozen, independent statement of the math that the system under test
runs: text encoder (partial-padded convs, masked instance norm, BiLSTM),
DAP attribute predictors (bottleneck, convs, BiLSTM, dense), the AGAP's
autoregressive spline flows, frame voicing, the context BiLSTM, the WN
affine flows inverted through LU-parametrised 1x1 convolutions, and the
ResBlock1 HiFi-GAN generator. fp32 throughout; the caller turns TF32 off.
It imports nothing of the program: the LSTMs are loops over time steps,
the convolutions F.conv1d, the MRF a chain of convs.

Weights are a flat dict name -> tensor in the layout `parameter_specs`
lists (the names the program's modules use, which is how the benchmark
hands both sides the same tensors). Everything derived from them (the 1x1
inverses, the LSTM bias sums) is worked out here again.

Tensors are channels-last (B, T, C) between layers, as in the model.
"""

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
_EPS32 = float(torch.finfo(torch.float32).eps)


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------


def _conv(name, c_out, c_in, k):
    fan = c_in * k
    return [(f"{name}.weight", (c_out, c_in, k), ("normal", fan ** -0.5)),
            (f"{name}.bias", (c_out,), ("normal", 0.1 * fan ** -0.5))]


def _linear(name, n_out, n_in):
    return [(f"{name}.weight", (n_out, n_in), ("normal", n_in ** -0.5)),
            (f"{name}.bias", (n_out,), ("normal", 0.1 * n_in ** -0.5))]


def _lstm(name, n_in, hidden, bidirectional=True, spectral=False, layers=1):
    out = []
    std = (3 * hidden) ** -0.5
    for layer in range(layers):
        size_in = n_in if layer == 0 else hidden
        for sfx in ("", "_reverse") if bidirectional else ("",):
            hh = ("spectral", hidden ** -0.5) if spectral else ("normal", std)
            out += [
                (f"{name}.weight_ih_l{layer}{sfx}", (4 * hidden, size_in),
                 ("normal", size_in ** -0.5 if spectral else std)),
                (f"{name}.weight_hh_l{layer}{sfx}", (4 * hidden, hidden), hh),
                (f"{name}.bias_ih_l{layer}{sfx}", (4 * hidden,),
                 ("normal", std)),
                (f"{name}.bias_hh_l{layer}{sfx}", (4 * hidden,),
                 ("normal", std))]
    return out


def _bottleneck_dim(hp):
    b = hp["bottleneck_hparams"]
    return int(b["in_dim"] / b["reduction_factor"])


def _attribute_specs(prefix, config, n_speaker_dim):
    name, hp = config["name"], config["hparams"]
    bdim = _bottleneck_dim(hp)
    out = _conv(f"{prefix}.bottleneck.proj", bdim,
                hp["bottleneck_hparams"]["in_dim"], 3)
    if name == "dap":
        if hp.get("use_transformer", False):
            raise NotImplementedError("DAP with use_transformer")
        arch = hp["arch_hparams"]
        C, k = arch["n_channels"], arch["kernel_size"]
        dims = [bdim + n_speaker_dim] + [C] * arch["n_layers"]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out += _conv(f"{prefix}.feat.convs.{i}", b, a, k)
        lstm_type = arch.get("lstm_type", "bilstm")
        if lstm_type == "bilstm":
            out += _lstm(f"{prefix}.feat.lstm.lstm", C, C // 2,
                         spectral=True)
        elif lstm_type:
            raise NotImplementedError(f"DAP lstm_type {lstm_type!r}")
        if not arch.get("use_linear", True):
            raise NotImplementedError("DAP without its dense layer")
        out += _linear(f"{prefix}.feat.dense", arch["out_dim"], C)
        return out
    if name != "agap":
        raise NotImplementedError(f"attribute model {name!r}")
    g = hp.get("n_group_size", 1)
    sp = hp["spline_flow_params"]
    if sp is None:
        raise NotImplementedError("AGAP with the affine head")
    n_attr = hp["n_in_dim"] * g
    H = hp["n_hidden"]
    n_bins = 2 * sp.get("n_bins", 8) + 1 if sp.get("use_quadratic") \
        else sp.get("n_bins", 8)
    for i in range(hp["n_flows"]):
        f = f"{prefix}.flows.{i}"
        out += _lstm(f"{f}.attr_lstm.lstm", n_attr, H, bidirectional=False)
        out += _lstm(f"{f}.lstm.lstm", H + bdim * g + n_speaker_dim, H,
                     bidirectional=False, layers=hp["n_lstm_layers"])
        c = sp["n_context_dim"]
        for j in range(sp["n_layers"]):
            c_out = min(1024, 2 * c)
            out += _conv(f"{f}.spline_flow.pred.layers.{j}", c_out, c, 1)
            c = c_out
        # zero-initialised in the model: drawn as the others (assumed)
        out += _conv(f"{f}.spline_flow.pred.last",
                     sp["n_in_channels"] * g * n_bins, c, 1)
    return out


def flow_channels(mc):
    """The channel count of each decoder flow step."""
    ch = mc["n_mel_channels"] * mc["n_group_size"]
    out = []
    for i in range(mc["n_flows"]):
        if i > 0 and i % mc["n_early_every"] == 0:
            ch -= mc["n_early_size"]
        out.append(ch)
    return out


def context_dims(mc):
    """(context LSTM input, its hidden size, the flow steps' context)."""
    g = mc["n_group_size"]
    S, T = mc["n_speaker_dim"], mc["n_text_dim"]
    n_f0, n_e = mc.get("n_f0_dims", 0), mc.get("n_energy_avg_dims", 0)
    n_in = S + T * g
    hidden = int((S + T * g) / 2)
    cond = S + (T + n_f0 + n_e) * g
    if mc.get("context_lstm_w_f0_and_energy", True):
        n_in = (n_f0 + n_e + T) * g + S
        cond = S + T * g
    return n_in, hidden, cond


def _check_model_config(mc):
    if mc.get("affine_model", "simple_conv") != "wavenet":
        raise NotImplementedError("decoder couplings other than wavenet")
    if mc.get("matrix_decomposition", "") != "LUS":
        raise NotImplementedError("1x1 convolutions other than LUS")
    if not mc.get("use_context_lstm", False):
        raise NotImplementedError("decoders without the context LSTM")
    if mc.get("use_first_order_features", False):
        raise NotImplementedError("first-order attribute features")


def parameter_specs(mc, h):
    """[(name, shape, init)] of a RADTTS model config `mc` (inference form,
    norms folded) and a HiFi-GAN config `h`, the RADTTS names without a
    prefix and the generator's under "vocoder.". init is ("normal", std),
    ("spectral", std) (drawn, then divided by its largest singular value,
    a converged spectral norm), ("ones",), ("zeros",) or ("orthonormal",)
    (an LU-factored random rotation; see the weight maker)."""
    _check_model_config(mc)
    S, T, g = mc["n_speaker_dim"], mc["n_text_dim"], mc["n_group_size"]
    specs = [("speaker_embedding.weight", (mc["n_speakers"], S),
              ("normal", 1.0)),
             ("embedding.weight", (mc["n_text"], T), ("normal", 1.0))]
    for i in range(3):
        specs += _conv(f"encoder.convs.{i}", T, T, 5)
    for i in range(3):
        specs += [(f"encoder.norms.{i}.gamma", (T,), ("ones",)),
                  (f"encoder.norms.{i}.beta", (T,), ("zeros",))]
    specs += _lstm("encoder.lstm.lstm", T, T // 2,
                   spectral="spectral" in str(mc.get("text_encoder_lstm_norm")))
    include = mc.get("include_modules", "dec")
    if mc.get("learn_alignments", False):
        # the alignment attention: training only, never run here
        n_mel = mc["n_mel_channels"]
        for name, c_out, c_in, k in (("key_proj.0", 2 * T, T, 3),
                                     ("key_proj.1", n_mel, 2 * T, 1),
                                     ("query_proj.0", 2 * n_mel, n_mel, 3),
                                     ("query_proj.1", n_mel, 2 * n_mel, 1),
                                     ("query_proj.2", n_mel, n_mel, 1)):
            specs += [(f"attention.{name}.weight", (c_out, c_in, k),
                       ("zeros",)),
                      (f"attention.{name}.bias", (c_out,), ("zeros",))]
    n_in, hidden, cond = context_dims(mc)
    specs += _lstm("context_lstm.lstm", n_in, hidden,
                   spectral="spectral" in str(mc.get("context_lstm_norm")))
    n_hidden = mc.get("affine_n_channels", 1024)
    for i, ch in enumerate(flow_channels(mc)):
        f = f"flows.{i}"
        specs += [(f"{f}.inv.w_inv", (ch, ch), ("zeros",)),
                  (f"{f}.inv.p", (ch, ch), ("orthonormal",)),
                  (f"{f}.inv.lower", (ch, ch), ("orthonormal",)),
                  (f"{f}.inv.upper", (ch, ch), ("orthonormal",)),
                  (f"{f}.inv.upper_diag", (ch,), ("orthonormal",))]
        n_half = ch // 2
        specs += _conv(f"{f}.affine.pred.start", n_hidden, n_half + cond, 1)
        for j in range(mc["n_conv_layers_per_step"]):
            specs += _conv(f"{f}.affine.pred.in_layers.{j}", n_hidden,
                           n_hidden, 5)
        for j in range(mc["n_conv_layers_per_step"]):
            specs += _conv(f"{f}.affine.pred.res_skip.{j}", n_hidden,
                           n_hidden, 1)
        # zero-initialised in the model: drawn at a small sd (assumed)
        specs += _conv(f"{f}.affine.pred.end", 2 * n_half, n_hidden, 1)
    if "dpm" in include:
        specs += _attribute_specs("dur_pred_layer", mc["dur_model_config"], S)
    specs += _linear("unvoiced_bias", 1, T)
    specs += _attribute_specs("v_pred_module", mc["v_model_config"], S)
    specs += [("v_embeddings.weight", (4, T), ("normal", 1.0))]
    for name in ("f0", "energy"):
        specs += _attribute_specs(f"{name}_pred_module",
                                  mc[f"{name}_model_config"], S)
    return specs + [("vocoder." + n, s, i) for n, s, i in vocoder_specs(h)]


def vocoder_specs(h, n_mel=80):
    ch0 = h["upsample_initial_channel"]
    specs = _conv("conv_pre", ch0, n_mel, 7)
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c_in, c_out = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
        specs += [(f"ups.{i}.weight", (c_in, c_out, k),
                   ("normal", (c_in * k / u) ** -0.5)),
                  (f"ups.{i}.bias", (c_out,), ("zeros",))]
        for j, ks in enumerate(h["resblock_kernel_sizes"]):
            for w in ("w1", "w2"):
                specs += [(f"resblocks.{i}.{j}.{w}", (3, ks, c_out, c_out),
                           ("normal", (c_out * ks) ** -0.5)),
                          (f"resblocks.{i}.{j}.b{w[1]}", (3, c_out),
                           ("zeros",))]
    return specs + _conv("conv_post", 1, ch0 // 2 ** len(h["upsample_rates"]),
                         7)


def check_vocoder_config(h):
    if h["resblock"] != "1" or any(tuple(d) != (1, 3, 5)
                                   for d in h["resblock_dilation_sizes"]):
        raise NotImplementedError("generators other than ResBlock1 with "
                                  "dilations (1, 3, 5)")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def sequence_mask(lengths, T):
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def conv(x, W, name, k, dilation=1):
    """Same-padded conv of (B, T, C_in) by W[name.weight] (C_out, C_in, k)."""
    y = F.conv1d(x.transpose(1, 2), W[name + ".weight"],
                 W.get(name + ".bias"), padding=dilation * (k - 1) // 2,
                 dilation=dilation)
    return y.transpose(1, 2)


def partial_conv(x, W, name, k, dilation, mask):
    """A conv whose windows are rescaled by k / (the valid samples in
    them), zero where a window holds none; mask (B, T) bool or None (all
    valid). The output is zeroed past each length when a mask is given."""
    B, T, _ = x.shape
    pad = dilation * (k - 1) // 2
    m = (torch.ones(1, 1, T, dtype=x.dtype, device=x.device) if mask is None
         else mask.to(x.dtype)[:, None, :])
    counts = F.conv1d(m, torch.ones(1, 1, k, dtype=x.dtype, device=x.device),
                      padding=pad, dilation=dilation).transpose(1, 2)
    valid = counts.clamp(0.0, 1.0)
    xm = x if mask is None else x * m.transpose(1, 2)
    raw = F.conv1d(xm.transpose(1, 2), W[name + ".weight"], None,
                   padding=pad, dilation=dilation).transpose(1, 2)
    y = (raw * (k / (counts + 1e-6) * valid) + W[name + ".bias"]) * valid
    return y if mask is None else y * mask.to(y.dtype)[:, :, None]


def linear(x, W, name):
    return x @ W[name + ".weight"].T + W[name + ".bias"]


def instance_norm(x, mask, gamma, beta, eps=1e-5):
    m = mask.to(x.dtype)[:, :, None]
    n = m.sum(1, keepdim=True)
    mean = (x * m).sum(1, keepdim=True) / n
    var = ((x - mean) ** 2 * m).sum(1, keepdim=True) / n
    return ((x - mean) / torch.sqrt(var + eps) * gamma + beta) * m


def reverse_valid(x, lengths):
    """Each item's first lengths[b] frames reversed, zeros past them."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    idx = (lengths[:, None] - 1 - t).clamp(0, T - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return out * (t < lengths[:, None]).to(x.dtype)[:, :, None]


def _cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_direction(x, w_ih, w_hh, b, lengths=None):
    """One LSTM direction over (B, T, I) from zero state; an item stops
    at its length (its output zero past it)."""
    B, T, _ = x.shape
    H = w_hh.shape[1]
    gx = x @ w_ih.T + b
    h = c = x.new_zeros(B, H)
    outs = []
    for t in range(T):
        h_new, c_new = _cell(gx[:, t] + h @ w_hh.T, c)
        if lengths is None:
            h, c = h_new, c_new
            outs.append(h)
            continue
        live = (t < lengths)[:, None]
        h, c = torch.where(live, h_new, h), torch.where(live, c_new, c)
        outs.append(h_new * live.to(x.dtype))
    return torch.stack(outs, dim=1)


def bilstm(x, W, name, lengths=None):
    """A one-layer bidirectional LSTM: [forward ; backward], the backward
    direction starting at each item's last valid frame."""
    def weights(sfx):
        return (W[f"{name}.weight_ih_l0{sfx}"], W[f"{name}.weight_hh_l0{sfx}"],
                W[f"{name}.bias_ih_l0{sfx}"] + W[f"{name}.bias_hh_l0{sfx}"])

    fwd = lstm_direction(x, *weights(""), lengths)
    if lengths is None:
        bwd = lstm_direction(x.flip(1), *weights("_reverse")).flip(1)
    else:
        bwd = reverse_valid(lstm_direction(reverse_valid(x, lengths),
                                           *weights("_reverse"), lengths),
                            lengths)
    return torch.cat([fwd, bwd], dim=-1)


def unfold_group(x, g):
    """(B, T, C) -> (B, T // g, C * g), channel c * g + j of frame j."""
    B, T, C = x.shape
    Tg = T // g
    return x[:, :Tg * g].reshape(B, Tg, g, C).transpose(2, 3).reshape(
        B, Tg, C * g)


def fold_group(x, g):
    B, Tg, Cg = x.shape
    return x.reshape(B, Tg, Cg // g, g).transpose(2, 3).reshape(
        B, Tg * g, Cg // g)


def regulate_length(x, dur, T):
    """Token features repeated dur times each; frames past sum(dur) zero."""
    ends = torch.cumsum(dur, dim=1)
    t = torch.arange(T, device=x.device)
    idx = (ends[:, None, :] <= t[None, :, None]).sum(-1).clamp(
        0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return out * (t[None, :] < ends[:, -1:]).to(x.dtype)[:, :, None]


# ---------------------------------------------------------------------------
# model parts
# ---------------------------------------------------------------------------


def encoder(W, ids, in_lens):
    """Text ids (B, N) -> encoding (B, N, C); in_lens None: every item N."""
    x = W["embedding.weight"][ids]
    B, N, _ = x.shape
    mask = None if in_lens is None else sequence_mask(in_lens, N)
    norm_mask = (torch.ones(B, N, dtype=torch.bool, device=x.device)
                 if mask is None else mask)
    for i in range(3):
        x = partial_conv(x, W, f"encoder.convs.{i}", 5, 1, mask)
        x = torch.relu(instance_norm(x, norm_mask,
                                     W[f"encoder.norms.{i}.gamma"],
                                     W[f"encoder.norms.{i}.beta"]))
    return bilstm(x, W, "encoder.lstm.lstm", in_lens)


def dap(W, prefix, config, x, spk, lengths):
    """A DAP's raw output (B, T, out_dim) on its input features x."""
    hp = config["hparams"]
    arch = hp["arch_hparams"]
    h = torch.relu(conv(x, W, f"{prefix}.bottleneck.proj", 3))
    h = torch.cat([h, spk[:, None, :].expand(-1, h.shape[1], -1)], dim=-1)
    mf = (None if lengths is None
          else sequence_mask(lengths, h.shape[1]).to(h.dtype)[:, :, None])
    if mf is not None:
        h = h * mf
    for i in range(arch["n_layers"]):
        h = torch.relu(conv(h, W, f"{prefix}.feat.convs.{i}",
                            arch["kernel_size"]))
        if mf is not None:
            h = h * mf
    if arch.get("lstm_type", "bilstm") == "bilstm":
        h = bilstm(h, W, f"{prefix}.feat.lstm.lstm", lengths)
    out = linear(h, W, f"{prefix}.feat.dense")
    return torch.exp(out) - 1.0 if hp["take_log_of_input"] else out


def _quadratic_inverse(x, w_tilde, v_tilde):
    """The monotone quadratic spline's inverse on [0, 1)."""
    w = torch.softmax(w_tilde, dim=-1)
    v = v_tilde - v_tilde.max(dim=-1, keepdim=True).values
    v = torch.exp(v) + 1e-8
    v = v / ((v[..., :-1] + v[..., 1:]) / 2 * w).sum(-1, keepdim=True)
    w_cum = torch.cumsum(w, dim=-1)
    w_cum = torch.cat([w_cum[..., :-1], torch.ones_like(w_cum[..., -1:])], -1)
    w_cum_shift = F.pad(w_cum, (1, 0))
    cdf = torch.cumsum((v[..., 1:] + v[..., :-1]) / 2 * w, dim=-1)
    cdf = torch.cat([cdf[..., :-1], torch.ones_like(cdf[..., -1:])], -1)
    cdf_shift = F.pad(cdf, (1, 0))
    K = w.shape[-1]
    b = (cdf < x[..., None]).sum(-1).clamp(0, K - 1)

    def take(a, i):
        return torch.gather(a, -1, i[..., None])[..., 0]

    w_b, w_bn1 = take(w, b), take(w_cum_shift, b)
    v_b, v_bp1 = take(v, b), take(v, b + 1)
    a = (v_bp1 - v_b) * w_b / 2
    bb = v_b * w_b
    cc = take(cdf_shift, b) - x
    sqrt_disc = torch.sqrt(torch.clamp(bb * bb - 4 * a * cc, min=0.0))
    alpha = torch.where(a.abs() < 1e-12, -cc / torch.clamp(bb, min=_EPS32),
                        -2 * cc / torch.clamp(bb + sqrt_disc, min=_EPS32))
    return torch.clamp(alpha * w_b + w_bn1, _EPS32, 1.0 - _EPS32)


def _spline_inverse(z, q, n_bins, bounds=(-6.0, 6.0, -6.0, 6.0)):
    """The AGAP head's inverse of residual z (B, C) by its bins q."""
    left, right, bottom, top = bounds
    B, C = z.shape
    y = (z - bottom) / (top - bottom)
    q = q.reshape(B, C, n_bins)
    inside = (y >= 0.0) & (y < 1.0)
    x = _quadratic_inverse(torch.clamp(y, 0.0, 1.0 - _EPS32),
                           q[..., :n_bins // 2], q[..., n_bins // 2:])
    x = torch.where(inside, x, y)
    return x * (right - left) + left


def ar_step_inverse(W, f, hp, residual, context):
    """One AGAP AR step's inverse, frame after frame: residual (B, T, C),
    context (B, T, D) -> (B, T, C)."""
    sp = hp["spline_flow_params"]
    n_bins = 2 * sp.get("n_bins", 8) + 1
    a = f"{f}.attr_lstm.lstm"
    w_ih_a, w_hh_a = W[a + ".weight_ih_l0"], W[a + ".weight_hh_l0"]
    b_a = W[a + ".bias_ih_l0"] + W[a + ".bias_hh_l0"]
    H = w_hh_a.shape[1]
    s = f"{f}.lstm.lstm"
    layers = []
    for layer in range(hp["n_lstm_layers"]):
        layers.append((W[f"{s}.weight_ih_l{layer}"], W[f"{s}.weight_hh_l{layer}"],
                       W[f"{s}.bias_ih_l{layer}"] + W[f"{s}.bias_hh_l{layer}"]))
    w_ih0 = layers[0][0]
    ctx_gates = context @ w_ih0[:, H:].T + layers[0][2]
    head = [(W[f"{f}.spline_flow.pred.layers.{j}.weight"][:, :, 0],
             W[f"{f}.spline_flow.pred.layers.{j}.bias"])
            for j in range(sp["n_layers"])]
    last = (W[f"{f}.spline_flow.pred.last.weight"][:, :, 0],
            W[f"{f}.spline_flow.pred.last.bias"])
    B, T, C = residual.shape
    zeros = residual.new_zeros(B, H)
    attr = (zeros, zeros)
    state = [(zeros, zeros) for _ in layers]
    prev = residual.new_zeros(B, C)
    outs = []
    for t in range(T):
        attr = _cell(prev @ w_ih_a.T + b_a + attr[0] @ w_hh_a.T, attr[1])
        x = attr[0]
        for li, (w_ih, w_hh, b) in enumerate(layers):
            gx = (x @ w_ih[:, :H].T + ctx_gates[:, t] if li == 0
                  else x @ w_ih.T + b)
            state[li] = _cell(gx + state[li][0] @ w_hh.T, state[li][1])
            x = state[li][0]
        for w, b in head:
            x = torch.relu(x @ w.T + b)
        prev = _spline_inverse(residual[:, t], x @ last[0].T + last[1],
                               n_bins)
        outs.append(prev)
    return torch.stack(outs, dim=1)


def agap(W, prefix, config, x, spk, lengths, z):
    """An AGAP's sample from noise z (B, T, 1): its flows inverted, the
    odd ones over each item's valid frames reversed."""
    hp = config["hparams"]
    if hp.get("n_group_size", 1) != 1 or hp.get("take_log_of_input"):
        raise NotImplementedError("grouped or log-domain AGAP")
    h = torch.relu(conv(x, W, f"{prefix}.bottleneck.proj", 3))
    context = torch.cat([h, spk[:, None, :].expand(-1, h.shape[1], -1)], -1)
    for i in reversed(range(hp["n_flows"])):
        f = f"{prefix}.flows.{i}"
        if i % 2:
            z = reverse_valid(ar_step_inverse(
                W, f, hp, reverse_valid(z, lengths),
                reverse_valid(context, lengths)), lengths)
        else:
            z = ar_step_inverse(W, f, hp, z, context)
    return z


def attribute(W, prefix, config, x, spk, lengths, z=None):
    if config["name"] == "dap":
        return dap(W, prefix, config, x, spk, lengths)
    return agap(W, prefix, config, x, spk, lengths, z)


def lu_inverse(W, f):
    """W^-1 of a flow step's 1x1 convolution W = P L U, in float64."""
    p = W[f + ".p"].double()
    lower = torch.tril(W[f + ".lower"].double(), -1) + torch.eye(
        p.shape[0], dtype=torch.float64, device=p.device)
    upper = (torch.triu(W[f + ".upper"].double(), 1)
             + torch.diag(W[f + ".upper_diag"].double()))
    return torch.linalg.inv(p @ lower @ upper).float()


def wn(W, f, z, context, mask, n_layers, partial=True):
    h = conv(torch.cat([z, context], dim=-1), W, f"{f}.start", 1)
    out = 0.0
    for j in range(n_layers):
        name = f"{f}.in_layers.{j}"
        if partial:
            h = F.softplus(partial_conv(h, W, name, 5, 2 ** j, mask))
        else:
            h = F.softplus(conv(h, W, name, 5, 2 ** j)
                           * mask.to(h.dtype)[:, :, None])
        out = out + F.softplus(conv(h, W, f"{f}.res_skip.{j}", 1))
    return conv(out, W, f"{f}.end", 1)


def scale(raw, scaling_fn):
    if scaling_fn == "tanh":
        return torch.tanh(raw) + 1.0 + 1e-6
    if scaling_fn == "exp":
        return torch.exp(raw)
    raise NotImplementedError(f"scaling_fn {scaling_fn!r}")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def durations(W, mc, ids, in_lens, token_dur_scaling=1.0,
              token_duration_max=100):
    """The durations before rounding (B, N) and the text encoding."""
    spk = W["speaker_embedding.weight"][torch.zeros(
        ids.shape[0], dtype=torch.int64, device=ids.device)]
    enc = encoder(W, ids, in_lens)
    d = dap(W, "dur_pred_layer", mc["dur_model_config"], enc, spk,
            in_lens)[..., 0]
    d = d.clamp(0, token_duration_max)
    if token_dur_scaling > 0:
        d = d * token_dur_scaling
    if in_lens is not None:
        d = d * sequence_mask(in_lens, ids.shape[1]).to(d.dtype)
    return d, enc


def decode(W, mc, enc, dur, max_frames, voiced, z_f0, z_energy, residual,
           speaker_ids):
    """Attributes and the inverse flow at a frame budget, given the
    integer durations (B, N) and the voicing (B, max_frames) to follow.
    Returns v_logits, f0, energy (B, max_frames) and mel (B, max_frames,
    n_mel)."""
    g = mc["n_group_size"]
    spk = W["speaker_embedding.weight"][speaker_ids]
    out_lens = dur.sum(1)
    x = regulate_length(enc, dur, max_frames)
    v_logits = dap(W, "v_pred_module", mc["v_model_config"], x, spk,
                   out_lens)[..., 0]
    vm = voiced.to(x.dtype)
    ap_x = x
    if mc.get("ap_use_voiced_embeddings", True):
        table = W["v_embeddings.weight"]
        v = vm[:, :, None]
        ap_x = x * torch.sigmoid(table[0] * v + table[1] * (1 - v)) \
            + 0.1 * torch.tanh(table[2] * v + table[3] * (1 - v))
    f0_bias = 0.0
    if mc.get("decoder_use_unvoiced_bias", True) or mc.get(
            "ap_use_unvoiced_bias", True):
        raw = linear(x, W, "unvoiced_bias")[..., 0]
        raw = (torch.exp(raw) if mc["unvoiced_bias_activation"] == "exp"
               else torch.relu(raw))
        f0_bias = -raw * (1.0 - vm)
    f0_raw = attribute(W, "f0_pred_module", mc["f0_model_config"], ap_x,
                       spk, out_lens, z_f0)[..., 0]
    e_raw = attribute(W, "energy_pred_module", mc["energy_model_config"],
                      ap_x, spk, out_lens, z_energy)[..., 0]
    if mc.get("ap_pred_log_f0", False):
        f0 = torch.where(voiced, torch.exp(f0_raw * 3.0), f0_raw * 3.0)
    else:
        f0 = f0_raw / 6.0 / 640.0
    f0 = torch.where(voiced, f0, torch.zeros_like(f0))
    energy = (e_raw / 1.4 + 1.0) / 2.0
    f0_ctx = (f0 * vm + f0_bias if mc.get("decoder_use_unvoiced_bias", True)
              else f0 * vm)
    # the context: grouped text, speaker, f0 and energy, then the BiLSTM
    ctx = unfold_group(x, g)
    Tg = ctx.shape[1]
    parts = [ctx, spk[:, None, :].expand(-1, Tg, -1)]
    feats = [unfold_group(f0_ctx[:, :, None], g),
             unfold_group(energy[:, :, None], g)]
    with_feats = mc.get("context_lstm_w_f0_and_energy", True)
    if with_feats:
        parts += feats
    ctx = bilstm(torch.cat(parts, dim=-1), W, "context_lstm.lstm",
                 out_lens // g)
    if not with_feats:
        ctx = torch.cat([ctx] + feats, dim=-1)
    # the flows, last first, the early outputs put back at their steps
    mask = sequence_mask(out_lens // g, Tg)
    chans = flow_channels(mc)
    n_early = mc["n_early_size"]
    exits = [i for i in range(1, len(chans)) if chans[i] < chans[i - 1]]
    z = residual[..., len(exits) * n_early:]
    early = residual[..., : len(exits) * n_early]
    partial = mc.get("decoder_use_partial_padding", True)
    for i in reversed(range(len(chans))):
        f = f"flows.{i}"
        n_half = chans[i] // 2
        z0, z1 = z[..., :n_half], z[..., n_half:]
        params = wn(W, f"{f}.affine.pred", z0, ctx, mask,
                    mc["n_conv_layers_per_step"], partial)
        z1 = (z1 - params[..., n_half:]) / scale(params[..., :n_half],
                                                 mc.get("scaling_fn", "exp"))
        z = torch.cat([z0, z1], dim=-1) @ lu_inverse(W, f + ".inv").T
        if exits and i == exits[-1]:
            exits.pop()
            z = torch.cat([early[..., len(exits) * n_early:], z], dim=-1)
            early = early[..., : len(exits) * n_early]
    mel = fold_group(z, g)
    if mc.get("do_mel_descaling", True):
        mel = mel * 2 - 5.5
    return {"v_logits": v_logits, "f0": f0, "energy": energy, "mel": mel}


def vocoder(W, h, mel, prefix="vocoder.", pre_tanh=False):
    """HiFi-GAN generator: mel (B, T, n_mel) -> waveform (B, T * hop) (its
    input to the last tanh with pre_tanh)."""
    check_vocoder_config(h)

    def c1d(x, name, k, d=1):
        return F.conv1d(x, W[prefix + name + ".weight"],
                        W[prefix + name + ".bias"],
                        padding=d * (k - 1) // 2, dilation=d)

    x = c1d(mel.transpose(1, 2), "conv_pre", 7)
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE),
                               W[f"{prefix}ups.{i}.weight"],
                               W[f"{prefix}ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        total = 0.0
        for j, ks in enumerate(h["resblock_kernel_sizes"]):
            r = f"{prefix}resblocks.{i}.{j}."
            xr = x
            for m, d in enumerate((1, 3, 5)):
                w1 = W[r + "w1"][m].permute(2, 1, 0)
                w2 = W[r + "w2"][m].permute(2, 1, 0)
                xt = F.conv1d(F.leaky_relu(xr, LRELU_SLOPE), w1,
                              W[r + "b1"][m], padding=(ks - 1) // 2 * d,
                              dilation=d)
                xt = F.conv1d(F.leaky_relu(xt, LRELU_SLOPE), w2,
                              W[r + "b2"][m], padding=(ks - 1) // 2)
                xr = xr + xt
            total = total + xr
        x = total / len(h["resblock_kernel_sizes"])
    x = c1d(F.leaky_relu(x), "conv_post", 7)[:, 0]
    return x if pre_tanh else torch.tanh(x)


def istft_length(n, n_fft, hop):
    n_frames = 1 + (n + 2 * (n_fft // 2) - n_fft) // hop
    return n_fft + hop * (n_frames - 1) - 2 * (n_fft // 2)


def frame_budget(n_frames, group_size, multiple=16):
    m = multiple * group_size
    return ((int(n_frames) + m - 1) // m) * m


def waveforms(W, h, mel, totals, hop, n_fft=1024):
    """The vocoder on a decoded batch as the serving path runs it: each
    item's last valid frame repeated over the batch's padding, the length
    conformed to an STFT round trip (the denoiser at strength 0), each
    waveform cut to its own frames."""
    B, T, _ = mel.shape
    t = torch.arange(T, device=mel.device)
    idx = torch.minimum(t[None, :], totals[:, None] - 1)
    mel = torch.gather(mel, 1, idx[:, :, None].expand(-1, -1, mel.shape[2]))
    audio = vocoder(W, h, mel)
    n_out = istft_length(audio.shape[-1], n_fft, hop)
    audio = (audio[..., :n_out] if n_out <= audio.shape[-1]
             else F.pad(audio, (0, n_out - audio.shape[-1])))
    return [audio[j, : int(totals[j]) * hop] for j in range(B)]
