"""Output layers set from the seeded weights themselves, so that every
seed does the same amount of work (the configuration's
`assumed.calibration`):

  duration: the duration DAP's dense layer scaled so that its output (the
    log of duration + 1) has the standard deviation `duration_log_sd` over
    the calibration texts' symbols, and its bias set so that a symbol's
    duration averages `mean_duration_frames`;
  voicing: the voicing DAP's dense layer scaled so that its logits have the
    sd `voicing_logit_sd` over those texts' frames, and its bias set so
    that a `voiced_share` of the frames are voiced;
  vocoder: the generator's last conv scaled so that its output before the
    tanh has the sd `vocoder_pre_tanh_sd` on a mel of N(-5.5, 1.6^2) (the
    decoder's output at sigma 0.8: 2 * N(0, 0.8^2) - 5.5).

It runs the plain reference (speedbench/reference/) on the device, on a
fixed set of texts, in fp32; nothing of the program runs.
"""

import copy

import numpy as np
import torch

from speedbench.reference import radtts as ref


def _ids(tp, texts, device):
    encs = [np.asarray(tp.encode_text(t), np.int64) for t in texts]
    lens = np.array([len(e) for e in encs])
    ids = np.zeros((len(encs), int(np.ceil(lens.max() / 16) * 16)), np.int64)
    for j, e in enumerate(encs):
        ids[j, :len(e)] = e
    return torch.as_tensor(ids, device=device), torch.as_tensor(
        lens, device=device)


def calibration_texts(target):
    """The fixed texts the calibration runs on."""
    from speedbench import traffic
    texts = traffic.load_texts({"texts": target["texts"]})
    rng = np.random.default_rng(target["texts_seed"])
    return [texts[i] for i in rng.choice(len(texts), target["n_texts"],
                                         replace=False)]


def calibrate(W, config, device, tp, seed):
    """Set the calibrated layers of the weights W in place."""
    target = config["assumed"]["calibration"]
    texts = calibration_texts(target)
    mc, h = config["model_config"], config["vocoder"]["config"]
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ids, lens = _ids(tp, texts, device)
            enc = ref.encoder(W, ids, lens)
            _durations(W, mc, device, ids, lens, enc, target)
            _voicing(W, mc, device, ids, lens, enc, target)
            _vocoder(W, h, device, target, seed)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _speakers(W, n, device):
    return W["speaker_embedding.weight"][torch.zeros(n, dtype=torch.int64,
                                                     device=device)]


def _durations(W, mc, device, ids, lens, enc, target):
    name = "dur_pred_layer.feat.dense"
    raw = copy.deepcopy(mc["dur_model_config"])
    raw["hparams"]["take_log_of_input"] = False
    W[name + ".bias"].zero_()
    y = ref.dap(W, "dur_pred_layer", raw, enc, _speakers(W, len(lens),
                                                          device), lens)[..., 0]
    y = y[ref.sequence_mask(lens, ids.shape[1])]
    k = target["duration_log_sd"] / y.std()
    W[name + ".weight"].mul_(k)
    y = y * k
    W[name + ".bias"].fill_(float(
        np.log(target["mean_duration_frames"] + 1.0)
        - torch.log(torch.exp(y).mean()).item()))


def _voicing(W, mc, device, ids, lens, enc, target):
    name = "v_pred_module.feat.dense"
    spk = _speakers(W, len(lens), device)
    d = ref.dap(W, "dur_pred_layer", mc["dur_model_config"], enc, spk,
                lens)[..., 0].clamp(min=0)
    dur = torch.floor(d + 0.5).to(torch.int64) * ref.sequence_mask(
        lens, ids.shape[1])
    totals = dur.sum(1)
    T = int(totals.max())
    x = ref.regulate_length(enc, dur, T)
    W[name + ".bias"].zero_()
    v = ref.dap(W, "v_pred_module", mc["v_model_config"], x, spk,
                totals)[..., 0]
    v = v[ref.sequence_mask(totals, T)]
    k = target["voicing_logit_sd"] / v.std()
    W[name + ".weight"].mul_(k)
    v = v * k
    W[name + ".bias"].fill_(-torch.quantile(
        v, 1.0 - target["voiced_share"]).item())


def _vocoder(W, h, device, target, seed):
    gen = torch.Generator(device).manual_seed(int(seed) % 2 ** 63)
    mel = torch.randn(1, 16, 80, generator=gen, device=device) * 1.6 - 5.5
    pre = ref.vocoder(W, h, mel, pre_tanh=True)
    W["vocoder.conv_post.weight"].mul_(target["vocoder_pre_tanh_sd"]
                                       / pre.std())
