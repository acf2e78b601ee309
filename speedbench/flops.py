"""The work the benchmark counts, from a configuration's shapes alone.

Model FLOP follow the convention of the program's counter
(radtts_tpu_torch/ops/flops.py, whose arithmetic this copies): only
products count, 2*M*N*K each; a convolution is a product over its taps; an
LSTM counts 2 * 4H * (I + H) a direction and a valid step; a transposed
convolution counts 2 * output elements * input channels * taps; the
partial-padded convolutions count their mask's window sums. They are
counted at an item's own token and frame counts, whatever the program
pads, fuses or launches, so that they stay fixed while the program
changes.
"""

from speedbench.reference.radtts import context_dims, flow_channels

MRF_DILATIONS = (1, 3, 5)


def _conv(T, c_in, c_out, k):
    return 2 * T * c_out * c_in * k


def _lstm(steps, n_in, hidden, dirs):
    return 2 * steps * 4 * hidden * (n_in + hidden) * dirs


def _bottleneck(hp, T):
    b = hp["bottleneck_hparams"]
    bdim = int(b["in_dim"] / b["reduction_factor"])
    return bdim, _conv(T, b["in_dim"], bdim, 3)


def _dap(hp, T, steps, n_speaker):
    arch = hp["arch_hparams"]
    bdim, total = _bottleneck(hp, T)
    dims = [bdim + n_speaker] + [arch["n_channels"]] * arch["n_layers"]
    for a, b in zip(dims[:-1], dims[1:]):
        total += _conv(T, a, b, arch["kernel_size"])
    C = arch["n_channels"]
    if arch.get("lstm_type", "bilstm") == "bilstm":
        total += _lstm(steps, C, C // 2, 2)
    return total + 2 * T * arch["out_dim"] * C


def _agap(hp, T, n_speaker):
    """Bottleneck, and per flow the context's input projection and the
    scan's products at every frame."""
    sp = hp["spline_flow_params"]
    bdim, total = _bottleneck(hp, T)
    H, n_attr = hp["n_hidden"], hp["n_in_dim"]
    n_bins = 2 * sp.get("n_bins", 8) + 1 if sp.get("use_quadratic") \
        else sp.get("n_bins", 8)
    head, c = 0, sp["n_context_dim"]
    for _ in range(sp["n_layers"]):
        head += min(1024, 2 * c) * c
        c = min(1024, 2 * c)
    head += c * sp["n_in_channels"] * n_bins
    frame = 4 * H * n_attr + 4 * H * H + head
    frame += sum(2 * 4 * H * H for _ in range(hp["n_lstm_layers"]))
    per_flow = 2 * T * (bdim + n_speaker) * 4 * H + 2 * T * frame
    return total + hp["n_flows"] * per_flow


def _attribute(config, T, steps, n_speaker):
    if config["name"] == "dap":
        return _dap(config["hparams"], T, steps, n_speaker)
    return _agap(config["hparams"], T, n_speaker)


def encoder_flops(mc, n_tokens):
    C = mc["n_text_dim"]
    return (3 * (_conv(n_tokens, 1, 1, 5) + _conv(n_tokens, C, C, 5))
            + _lstm(n_tokens, C, C // 2, 2))


def vocoder_flops(h, n_frames, n_mel=80):
    ch0 = h["upsample_initial_channel"]
    total = _conv(n_frames, n_mel, ch0, 7)
    T = n_frames
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c_in, c_out = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
        T *= u
        total += 2 * T * c_out * c_in * k
        total += mrf_stage(T, c_out, h["resblock_kernel_sizes"])[0]
    return total + _conv(T, ch0 // 2 ** len(h["upsample_rates"]), 1, 7)


def synthesis_flops(mc, h, n_tokens, n_frames, lstm_frames=None,
                    encoder_passes=1):
    """Model FLOP of synthesizing one text of n_tokens symbols into
    n_frames mel frames and their waveform. lstm_frames (default n_frames)
    are the frames the frame-level LSTMs step over, encoder_passes the
    times the text encoder runs (the program runs it once for the
    durations and again for the decode; the model needs it once)."""
    S, g = mc["n_speaker_dim"], mc["n_group_size"]
    steps = n_frames if lstm_frames is None else lstm_frames
    total = encoder_passes * encoder_flops(mc, n_tokens)
    total += _attribute(mc["dur_model_config"], n_tokens, n_tokens, S)
    total += _attribute(mc["v_model_config"], n_frames, steps, S)
    total += 2 * n_frames * mc["n_text_dim"]          # the unvoiced bias
    for name in ("f0_model_config", "energy_model_config"):
        total += _attribute(mc[name], n_frames, steps, S)
    n_in, hidden, cond = context_dims(mc)
    total += _lstm(steps // g, n_in, hidden, 2)
    Tg = n_frames // g
    nh = mc.get("affine_n_channels", 1024)
    partial = mc.get("decoder_use_partial_padding", True)
    for ch in flow_channels(mc):
        n_half = ch // 2
        total += _conv(Tg, n_half + cond, nh, 1)
        for _ in range(mc["n_conv_layers_per_step"]):
            total += _conv(Tg, nh, nh, 5) + _conv(Tg, nh, nh, 1)
            if partial:
                total += _conv(Tg, 1, 1, 5)
        total += _conv(Tg, nh, 2 * n_half, 1) + 2 * Tg * ch * ch
    return total + vocoder_flops(h, n_frames, mc["n_mel_channels"])


def mrf_stage(n_samples, C, kernel_sizes=(3, 7, 11)):
    """(FLOP, bytes) of one MRF stage over n_samples rows of C channels:
    every conv of every resblock at 2 * C * C * k a row (6 convs a
    resblock: two at each dilation), the input read and the output
    written once, the weights read once."""
    flop = 2 * n_samples * C * C * sum(2 * len(MRF_DILATIONS) * k
                                       for k in kernel_sizes)
    weights = sum(2 * len(MRF_DILATIONS) * (k * C * C + C)
                  for k in kernel_sizes)
    return flop, 4 * (2 * n_samples * C + weights)
