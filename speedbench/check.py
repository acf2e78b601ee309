"""Whether what the timed path produced is correct: the plain reference
(speedbench/reference/) recomputes a sample of the window's synthesize
calls from the same weights, texts and noise, and each number compared
is held to its limit (the configuration's `limits`).

The program's discrete decisions are judged first and then followed, as
a served model's tokens are: its integer durations must round what the
reference predicts (dur_gap: how far the reference's duration lies
outside the program's rounding interval, in frames), its voicing must be
the side of 0 that the reference's logit is on (voice_gap: the largest
logit on the wrong side). The reference then decodes with those
durations and that voicing, and the program's f0, energy and waveforms
are held to its own (f0_err, energy_err: the largest gap over an item's
valid frames over that item's largest value; logf0_err the same of log
f0 over the voiced frames, for a model whose f0 spans decades; wav_err:
the relative L2 distance of an item's waveform; infinite where the call
returned another number of waveforms than it was given texts).
"""

import math

import numpy as np
import torch

from speedbench.reference import radtts as ref
from speedbench.reference.text import TextProcessing
from speedbench.system import text_processing

NUMBERS = ("dur_gap", "voice_gap", "f0_err", "logf0_err", "energy_err",
           "wav_err")


def sample(window, n, seed):
    """n of the window's calls: the one with the longest text, the largest
    batch, the rest drawn from the seed."""
    if not window:
        return []
    picked = [max(window, key=lambda d: max(len(t) for t in d["texts"])),
              max(window, key=lambda d: len(d["texts"]))]
    rest = [d for d in window if d not in picked]
    rng = np.random.default_rng(int(seed) % 2 ** 64 + 1)
    picked += [rest[i] for i in rng.permutation(len(rest))]
    out = []
    for d in picked:
        if d not in out:
            out.append(d)
    return out[:n]


class Judge:
    def __init__(self, config, weights, device):
        self.config = config
        self.mc = config["model_config"]
        self.h = config["vocoder"]["config"]
        self.W = weights
        self.device = torch.device(device)
        self.tp = text_processing(TextProcessing, config["data_config"])

    def readings(self, d):
        """The numbers of one synthesize call d (a recorded dispatch)."""
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                return self._readings(d)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev

    def _readings(self, d):
        mc, dev = self.mc, self.device
        syn = self.config["synthesis"]
        knobs = {"sigma": 0.8, "sigma_f0": 1.0, "sigma_energy": 1.0,
                 **d["knobs"]}
        if knobs.get("denoising_strength", 0.0) > 0:
            raise NotImplementedError("denoising_strength > 0")
        encs = [np.asarray(self.tp.encode_text(t), np.int64)
                for t in d["texts"]]
        B = len(encs)
        lens = np.array([len(e) for e in encs])
        if B == 1:
            N, in_lens = int(lens[0]), None
        else:
            N = int(math.ceil(lens.max() / 16) * 16)
            in_lens = torch.as_tensor(lens, device=dev)
        ids = np.zeros((B, N), np.int64)
        for j, e in enumerate(encs):
            ids[j, :len(e)] = e
        ids = torch.as_tensor(ids, device=dev)
        aux = d["aux"]
        inf = {k: math.inf for k in NUMBERS}
        dur = torch.as_tensor(np.asarray(aux["dur"]), device=dev)
        if tuple(dur.shape) != (B, N):
            return inf
        d_ref, enc = ref.durations(self.W, mc, ids, in_lens,
                                   syn["token_dur_scaling"],
                                   syn["token_duration_max"])
        dur = dur.to(torch.int64)
        dur_gap = ((d_ref - dur).abs() - 0.5).clamp(min=0).max().item()
        totals = dur.sum(1)
        if not np.array_equal(totals.cpu().numpy(),
                              np.asarray(aux["n_frames"], np.int64)):
            return dict(inf, dur_gap=dur_gap)
        g = mc["n_group_size"]
        T = ref.frame_budget(int(totals.max()), g)
        f0_p = torch.as_tensor(np.asarray(aux["f0"]), device=dev)
        e_p = torch.as_tensor(np.asarray(aux["energy_avg"]), device=dev)
        if tuple(f0_p.shape) != (B, T) or tuple(e_p.shape) != (B, T):
            return dict(inf, dur_gap=dur_gap)
        gen = torch.Generator(dev).manual_seed(d["gen_seed"])
        z = {}
        for name, sig in (("f0", knobs["sigma_f0"]),
                          ("energy", knobs["sigma_energy"])):
            if mc[f"{name}_model_config"]["name"] != "dap":
                z[name] = torch.randn(B, T, 1, generator=gen,
                                      device=dev) * sig
        residual = torch.randn(B, T // g, mc["n_mel_channels"] * g,
                               generator=gen, device=dev) * knobs["sigma"]
        voiced = f0_p > 0
        spk = torch.full((B,), self.config["speakers"][d["speaker"]],
                         dtype=torch.int64, device=dev)
        out = ref.decode(self.W, mc, enc, dur, T, voiced, z.get("f0"),
                         z.get("energy"), residual, spk)
        valid = ref.sequence_mask(totals, T)
        wrong = (out["v_logits"] > 0) != voiced
        voice_gap = (out["v_logits"].abs() * (wrong & valid)).max().item()
        f0_err = _worst_rel(f0_p, out["f0"], valid)
        on = valid & voiced
        logf0_err = _worst_rel(torch.log(f0_p.clamp(min=1e-30)),
                               torch.log(out["f0"].clamp(min=1e-30)), on)
        e_err = _worst_rel(e_p, out["energy"], valid)
        wavs = ref.waveforms(self.W, self.h, out["mel"], totals,
                             self.config["data_config"]["hop_length"],
                             self.config["denoiser"]["filter_length"])
        wav_err = 0.0 if len(d["wavs"]) == B else math.inf
        for got, want in zip(d["wavs"], wavs):
            got = torch.as_tensor(np.asarray(got), device=dev)
            if got.shape != want.shape:
                wav_err = math.inf
                break
            wav_err = max(wav_err, ((got - want).norm()
                                    / want.norm().clamp(min=1e-30)).item())
        return {"dur_gap": dur_gap, "voice_gap": voice_gap, "f0_err": f0_err,
                "logf0_err": logf0_err, "energy_err": e_err,
                "wav_err": wav_err}


def _worst_rel(got, want, valid):
    err = ((got - want).abs() * valid).amax(1)
    scale = (want.abs() * valid).amax(1).clamp(min=1e-30)
    return (err / scale).max().item()


def check(config, weights, device, window, n, seed):
    """{number: (value, limit)} over a sample of n of the window's calls
    (the numbers the configuration's `limits` name), whether every value
    is within its limit, the calls compared, and the readings of the
    numbers it does not compare."""
    judge = Judge(config, weights, device)
    worst = {k: 0.0 for k in NUMBERS}
    picked = sample(window, n, seed)
    for d in picked:
        for k, v in judge.readings(d).items():
            worst[k] = max(worst[k], v)
    limits = config["limits"]
    checks = {k: (v, limits[k]) for k, v in worst.items() if k in limits}
    ok = bool(picked) and all(v <= lim for v, lim in checks.values())
    others = {k: v for k, v in worst.items() if k not in limits}
    return checks, ok, len(picked), others
