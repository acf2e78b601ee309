#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (radtts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a JSON or text line:
  1. device: the card's name and power limit, torch/CUDA versions, the
     pinned TF32 flags;
  2. build: nvcc of radtts_tpu_torch/csrc/mrf.cu for sm_90a, with seconds;
  3. kernel vs plain: ops/mrf.py:mrf (the CUDA kernel) against mrf_plain on
     the card at the four flagship stage shapes and a ragged B=2 shape,
     within 1e-4 * max|plain| (fp32 sums in another order, TF32 off), with
     the kernel's, the plain version's and the cuDNN conv chain's times and
     the fp32 FLOP bound;
  4. main path: a Synthesizer at the flagship config_ljs_dap.json width
     plus HiFi-GAN v1 with random weights (seed 0; WN end convs perturbed
     to sd 0.002) answers three requests (one text, a batch of three, one
     with denoising_strength=0.1), then a fixed-duration 608-frame
     decode + vocoder + denoiser runs with stage times and the RTF.
     mrf.launches must grow by 72 per generator call. Outputs must be
     finite and of the expected lengths; the decode and the vocoder of
     the 608-frame utterance are also held against the CPU plain path.
The last line is {"ok": true, "device": {...}}. Any failure raises, and the
exit code is not 0. Without CUDA, or without the rest of the repo beside
it, it exits 1 and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "config_ljs_dap.json")
HIFIGAN_V1 = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
MAX_FRAMES = 608            # 608 * 256 / 22050 Hz = 7.06 s of audio
STAGES = [(1, 4864, 256), (1, 38912, 128), (1, 77824, 64), (1, 155648, 32)]
RAGGED = (2, 997, 32)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
HBM_BYTES = 3.35e12         # H100 SXM HBM3
TEXTS = [
    "It is well known that deep generative models have a rich latent "
    "space, and that it is possible to synthesize speech with "
    "controllable attributes.",
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned, "
    "differs from most if not from all the arts and crafts.",
]


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed(fn):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - tic) * 1e3


def random_mrf_weights(C, dev, gen):
    def rnd(*shape):
        return 0.01 * torch.randn(*shape, device=dev, generator=gen)
    return [{"w1": rnd(3, k, C, C), "b1": rnd(3, C),
             "w2": rnd(3, k, C, C), "b2": rnd(3, C)} for k in (3, 7, 11)]


def library_mrf(xc, torch_weights):
    """The same MRF as a chain of cuDNN F.conv1d calls on channels-first
    input (B, C, T), conv weights pre-laid out as (C_out, C_in, K)."""
    out = torch.zeros_like(xc)
    for w1, b1, w2, b2 in torch_weights:
        xr = xc
        for i, d in enumerate((1, 3, 5)):
            k = w1[i].shape[-1]
            xt = F.conv1d(F.leaky_relu(xr, 0.1), w1[i], b1[i],
                          padding=(k - 1) // 2 * d, dilation=d)
            xt = F.conv1d(F.leaky_relu(xt, 0.1), w2[i], b2[i],
                          padding=(k - 1) // 2)
            xr = xr + xt
        out = out + xr
    return out / len(torch_weights)


def mrf_bound(B, T, C, ks=(3, 7, 11)):
    flop = 2.0 * B * T * C * C * sum(6 * k for k in ks)
    n_weights = sum(6 * (k * C * C + C) for k in ks)
    nbytes = 4.0 * (2 * B * T * C + n_weights)
    t_ops, t_bytes = flop / FP32_FLOPS, nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flop)


def phase_kernels(mrf_mod, dev):
    gen = torch.Generator(dev).manual_seed(1)
    stages, max_err = [], 0.0
    for B, T, C in STAGES + [RAGGED]:
        x = torch.randn(B, T, C, device=dev, generator=gen)
        w = random_mrf_weights(C, dev, gen)
        got = mrf_mod.mrf(x, w)
        ref = mrf_mod.mrf_plain(x, w)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        max_err = max(max_err, err)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"mrf kernel disagrees at {(B, T, C)}: "
                                 f"max|k-p| {err} > 1e-4 * {scale}")
        row = {"phase": "kernel_vs_plain", "shape": [B, T, C],
               "max_abs_err": err, "max_abs_plain": scale}
        if (B, T, C) != RAGGED:
            xc = x.transpose(1, 2).contiguous()
            tw = [tuple(t.permute(0, 3, 2, 1).contiguous()
                        if t.dim() == 4 else t
                        for t in (wd["w1"], wd["b1"], wd["w2"], wd["b2"]))
                  for wd in w]
            bound_ms, bound_by, flop = mrf_bound(B, T, C)
            row.update(
                ms=cuda_ms(lambda: mrf_mod.mrf(x, w)),
                plain_ms=cuda_ms(lambda: mrf_mod.mrf_plain(x, w)),
                library_ms=cuda_ms(lambda: library_mrf(xc, tw)),
                bound_ms=bound_ms, bound_by=bound_by, gflop=flop / 1e9)
            row["tflops"] = flop / row["ms"] / 1e9
            stages.append(row)
        log(row)
    return stages, max_err


def flagship_parts(dev):
    from radtts_tpu_torch.models.hifigan import Generator, denoiser_init
    from radtts_tpu_torch.models.radtts import RADTTS

    with open(CONFIG) as f:
        config = json.load(f)
    model_config = config["model_config"]
    torch.manual_seed(0)
    model = RADTTS(model_config).eval().requires_grad_(False)
    # the WN end convs are zero-initialised, which makes decode vacuous
    for flow in model.flows:
        torch.nn.init.normal_(flow.affine.pred.end.weight, std=0.002)
    vocoder = Generator(HIFIGAN_V1).to(dev).eval().requires_grad_(False)
    denoiser = denoiser_init(vocoder)
    return config, model, vocoder, denoiser


def flagship_input(synth):
    """TEXTS[0] with fixed durations summing to MAX_FRAMES (CPU tensors)."""
    text = torch.as_tensor(synth.encode(TEXTS[0]))[None]
    N = text.shape[1]
    dur = torch.full((1, N), MAX_FRAMES // N, dtype=torch.int32)
    dur[0, -1] += MAX_FRAMES - int(dur.sum())
    return text, dur


def phase_reference(synth, dev):
    """Decode and vocoder on the card vs the CPU plain path, on the
    608-frame flagship utterance with a seeded decoder residual."""
    from radtts_tpu_torch.models.radtts import radtts_infer

    text, dur = flagship_input(synth)
    meta = synth.model.meta
    g = meta["n_group_size"]
    gen = torch.Generator().manual_seed(3)
    res = torch.randn(1, MAX_FRAMES // g, meta["n_mel_channels"] * g,
                      generator=gen) * 0.8
    spk = torch.zeros(1, dtype=torch.int64)
    mel_gpu = radtts_infer(synth.model, spk.to(dev), text.to(dev), 0.8,
                           MAX_FRAMES, dur=dur.to(dev),
                           residual=res.to(dev))["mel"]
    wav_gpu = synth.vocoder(mel_gpu)
    model_cpu = synth.model.to("cpu")
    mel_cpu = radtts_infer(model_cpu, spk, text, 0.8, MAX_FRAMES, dur=dur,
                           residual=res)["mel"]
    synth.model.to(dev)
    wav_cpu = synth.vocoder.to("cpu")(mel_gpu.cpu())
    synth.vocoder.to(dev)
    mel_err = (mel_gpu.cpu() - mel_cpu).abs().max().item()
    wav_err = (wav_gpu.cpu() - wav_cpu).abs().max().item()
    wav_scale = wav_cpu.abs().max().item()
    if mel_gpu.shape != (1, MAX_FRAMES, meta["n_mel_channels"]) or \
            wav_gpu.shape != (1, MAX_FRAMES * synth.hop_length):
        raise AssertionError(f"shapes {tuple(mel_gpu.shape)}, "
                             f"{tuple(wav_gpu.shape)}")
    log({"phase": "gpu_vs_cpu", "frames": MAX_FRAMES,
         "mel_max_abs_err": mel_err,
         "mel_max_abs": mel_cpu.abs().max().item(),
         "wav_max_abs_err": wav_err, "wav_max_abs": wav_scale})
    # decode: the CPU parity bound of the port's tests; vocoder: the
    # kernel's 1e-4 * max bound, loosened 10x for the 4 chained stages
    if not mel_err <= 1e-3:
        raise AssertionError(f"decode on the card vs CPU: {mel_err}")
    if not wav_err <= 1e-3 * wav_scale:
        raise AssertionError(f"vocoder on the card vs CPU: {wav_err}")


def phase_main_path(synth, mrf_mod, dev, power):
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import infer_durations, radtts_infer

    hop = synth.hop_length
    n_generator_calls = 0
    mrf_mod.mrf.launches = 0
    requests = [(TEXTS[0], {}), (TEXTS, {}),
                (TEXTS[1], {"denoising_strength": 0.1, "sigma": 0.6})]
    for texts, kw in requests:
        (wavs, aux), ms = timed(lambda: synth.synthesize(texts, "ljs", **kw))
        n_generator_calls += 1
        for wav, n in zip(wavs, aux["n_frames"]):
            if wav.shape != (int(n) * hop,) or not torch.isfinite(
                    torch.as_tensor(wav)).all():
                raise AssertionError(f"bad output: {wav.shape}, {n} frames")
        log({"phase": "request", "n_texts": len(wavs),
             "n_frames": [int(n) for n in aux["n_frames"]], "ms": ms, **kw})

    # fixed-duration flagship utterance (608 frames)
    with torch.inference_mode():
        text, dur = (t.to(dev) for t in flagship_input(synth))
        spk = torch.zeros(1, dtype=torch.int64, device=dev)

        def utterance():
            _, t_dur = timed(lambda: infer_durations(synth.model, spk, text))
            out, t_dec = timed(lambda: radtts_infer(
                synth.model, spk, text, 0.8, MAX_FRAMES, dur=dur,
                generator=synth.generator))
            audio, t_voc = timed(lambda: denoiser_apply(
                synth.denoiser, synth.vocoder(out["mel"]), strength=0.01))
            return audio, {"durations": t_dur, "decode": t_dec,
                           "vocoder_denoiser": t_voc}

        runs = [utterance() for _ in range(3)]
        audio = runs[-1][0]
        times = {k: [t[k] for _, t in runs] for k in runs[0][1]}
        profile = profile_utterance(utterance)
        n_generator_calls += len(runs) + 1
    launches = mrf_mod.mrf.launches
    if audio.shape != (1, MAX_FRAMES * hop) or not torch.isfinite(
            audio).all():
        raise AssertionError(f"bad flagship audio {tuple(audio.shape)}")
    if launches != 72 * n_generator_calls:
        raise AssertionError(f"mrf.launches {launches} != 72 x "
                             f"{n_generator_calls} generator calls")
    med = {k: statistics.median(v) for k, v in times.items()}
    audio_s = MAX_FRAMES * hop / synth.sampling_rate
    log({"phase": "flagship_608", "card": power, "stage_ms": med,
         "stage_ms_all": times, "audio_s": audio_s,
         "rtf": sum(med.values()) / 1e3 / audio_s,
         "mrf_launches": launches, "generator_calls": n_generator_calls})
    log({"phase": "profile_608", **profile})
    return launches


def profile_utterance(utterance, top=12):
    """One flagship utterance under torch.profiler: device time by kernel
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        utterance()
        wall_ms = (time.perf_counter() - tic) * 1e3
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[2])
    busy_ms = sum(k[2] for k in kernels) if kernels else None
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (None if busy_ms is None
                                  else 1.0 - busy_ms / wall_ms),
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms}
                            for n, c, ms in kernels[:top]]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "radtts_tpu_torch")):
        print("chip_smoke: radtts_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from radtts_tpu_torch.ops import mrf as mrf_mod
    from radtts_tpu_torch.synthesizer import Synthesizer, resolve_device
    from radtts_tpu_torch.text import TextProcessing

    t_start = time.perf_counter()
    dev = resolve_device()
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log({"phase": "device", "nvidia_smi": power,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
         "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    _, nvcc_log, build_s = mrf_mod.build()
    log({"phase": "build", "seconds": build_s,
         "ptxas": [ln.strip() for ln in nvcc_log.splitlines()
                   if "registers" in ln or "spill" in ln]})

    stages, max_err = phase_kernels(mrf_mod, dev)

    config, model, vocoder, denoiser = flagship_parts(dev)
    dc = config["data_config"]
    tp = TextProcessing(
        dc["symbol_set"], dc["cleaner_names"], dc["heteronyms_path"],
        dc["phoneme_dict_path"], p_phoneme=dc["p_phoneme"],
        handle_phoneme=dc["handle_phoneme"],
        handle_phoneme_ambiguous=dc["handle_phoneme_ambiguous"],
        prepend_space_to_text=dc["prepend_space_to_text"],
        append_space_to_text=dc["append_space_to_text"])
    synth = Synthesizer.from_parts(
        config["model_config"], model, vocoder, denoiser,
        encode_fn=tp.encode_text, speaker_id_fn=lambda name: 0,
        sampling_rate=dc["sampling_rate"], hop_length=dc["hop_length"],
        seed=0, device=dev)
    with torch.no_grad():
        phase_reference(synth, dev)

    launches = phase_main_path(synth, mrf_mod, dev, power)

    def total(key):
        return sum(s[key] for s in stages)

    log({"kernels": [{
        "name": "mrf_conv",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/mrf.cu",
        "replaces": "radtts_tpu/ops/pallas_mrf.py:121",
        "also_replaces": ["radtts_tpu/ops/pallas_mrf.py:177",
                          "radtts_tpu/ops/pallas_mrf.py:231"],
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if all(s["bound_by"] == "operations"
                                         for s in stages) else "bytes"),
        "library_ms": total("library_ms"),
        "note": "sums over the four MRF stages of one 608-frame utterance",
        "stages": [{k: s[k] for k in ("shape", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "max_abs_err")} for s in stages],
    }]})
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
