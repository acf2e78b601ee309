"""Warm-model text->waveform synthesis engine: durations -> attributes ->
inverse flow -> vocoder -> denoiser, on one device or, with
data_parallel=N, on N replicas.

Entry points run on the card by default: `device=None` means CUDA and
raises when CUDA is absent; pass device="cpu" to run the plain path.
Precision is full fp32 by default (no TF32 in cuDNN convolutions or cuBLAS
matmuls): the 1024-wide WN couplings compound reduced-precision error over
the 8 inverse flows.

Three reduced-precision options, as the JAX engine has them: use_amp runs
the durations and decode stages' bf16 regions (ops/amp.py; the vocoder
and denoiser stay fp32), weight_dtype="bfloat16" stores the RADTTS
conv kernels in bf16 (ops/fold_norms.py:store_conv_weights, on a copy of
the model; "auto" is fp32), and matmul_precision "high" or "default"
runs every synthesis inside ops/precision.py:scope (TF32 in cuBLAS and
cuDNN outside the fp32 islands; "default" also the one-pass tensor-core
MRF). The precision is the Synthesizer's, applied per call: loading,
which pins fp32 through resolve_device, does not undo it.

data_parallel=N (the JAX engine's, radtts_tpu/synthesizer.py:144-167)
holds one replica of the model, vocoder and denoiser on each of N devices
(`devices`, default the first N CUDA devices, or N times the CPU with
device="cpu"; replicas on one device share its modules) and raises
ValueError when fewer devices are visible. A request pads its batch to a
multiple of N by repeating the last text and returns only the requested
wavs. Each replica takes its rows: the durations come from each replica's
rows, the frame budget from the whole batch. All noise is drawn once for
the padded batch from the Synthesizer's one generator, in the order
data_parallel=1 draws it, and each replica takes its slice, so an
exact-multiple batch gives data_parallel=1's audio. Each replica's work is
queued on its device before any result is gathered.

Under a torch profiler (the benchmark's traced window, an operator's own
torch.profiler.profile()) each call is traced by tracing.py: the trace
holds its radtts.* spans (synthesize, frontend, noise, durations,
text_encoder, attributes, decode, context, flows, lstm, vocoder, mrf,
denoiser, readback, upload) and tracing.records() their host times, CUDA
events and counts (syncs, lstm_steps). Without a profiler a span is one
check.
"""

import copy
import time

import numpy as np
import torch

from radtts_tpu_torch import tracing
from radtts_tpu_torch.data.dataset import data_factory
from radtts_tpu_torch.models.hifigan import denoiser_apply
from radtts_tpu_torch.models.radtts import (duration_noise, infer_durations,
                                            infer_noise, radtts_infer)
from radtts_tpu_torch.ops import amp, precision
from radtts_tpu_torch.ops.fold_norms import store_conv_weights
from radtts_tpu_torch.text.chunking import split_text_to_chunks
from radtts_tpu_torch.train.checkpoint import load_radtts_for_inference
from radtts_tpu_torch.vocoder_io import load_vocoder


def frame_budget(n_frames, group_size, multiple=16):
    m = multiple * group_size
    return ((int(n_frames) + m - 1) // m) * m


def resolve_device(device=None):
    """None -> CUDA, raising when it is absent. Pins fp32 precision (a
    reduced one is a scope: ops/precision.py)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device(device)


def replica_devices(data_parallel, devices=None, device=None):
    """The devices of data_parallel replicas: `devices` as given (N of
    them), else [device] at N = 1, N times the CPU for device "cpu", or
    the first N CUDA devices, raising ValueError when fewer are visible
    (the JAX engine's check)."""
    n = int(data_parallel)
    if n < 1:
        raise ValueError(f"data_parallel={n}: at least 1")
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"data_parallel={n} but {len(devices)} "
                             "devices were given")
        return devices
    device = resolve_device(device)
    if n == 1:
        return [device]
    if device.type == "cpu":
        return [device] * n
    visible = torch.cuda.device_count()
    if visible < n:
        raise ValueError(f"data_parallel={n} but only {visible} devices "
                         "are visible")
    return [torch.device("cuda", i) for i in range(n)]


class Synthesizer:
    """One loaded model + vocoder + denoiser; `synthesize()` per request
    batch. Built from checkpoint files, or by `from_parts` from modules in
    memory."""

    def __init__(self, config, radtts_path, vocoder_path,
                 vocoder_config_path, *, seed=1234, token_dur_scaling=1.0,
                 token_duration_max=100, f0_mean=0.0, f0_std=0.0,
                 energy_mean=0.0, energy_std=0.0, bucket_single=False,
                 use_amp=False, weight_dtype="auto", matmul_precision=None,
                 data_parallel=1, devices=None, device=None):
        """Load the HiFi-GAN checkpoint and its JSON config, the RADTTS
        checkpoint (a reference state dict or the JAX package's .npz) and
        the speaker table and text frontend of config's training
        filelists, then set up as from_parts does."""
        model_config = config["model_config"]
        data_config = config["data_config"]
        devices = replica_devices(data_parallel, devices, device)
        device = devices[0]
        tic = time.perf_counter()
        vocoder, denoiser = load_vocoder(vocoder_path, vocoder_config_path,
                                         device=device)
        t_voc = time.perf_counter()
        model, _ = load_radtts_for_inference(radtts_path, model_config)
        t_ck = time.perf_counter()
        trainset = data_factory(data_config, "training_files")
        t_data = time.perf_counter()
        self._setup(
            model_config, model, vocoder, denoiser,
            encode_fn=trainset.get_text,
            speaker_id_fn=trainset.get_speaker_id,
            sampling_rate=data_config["sampling_rate"],
            hop_length=data_config["hop_length"], seed=seed,
            token_dur_scaling=token_dur_scaling,
            token_duration_max=token_duration_max, f0_mean=f0_mean,
            f0_std=f0_std, energy_mean=energy_mean, energy_std=energy_std,
            bucket_single=bucket_single, use_amp=use_amp,
            weight_dtype=weight_dtype, matmul_precision=matmul_precision,
            devices=devices)
        self.trainset = trainset
        self.load_phases = {"vocoder": t_voc - tic,
                            "checkpoint": t_ck - t_voc,
                            "dataset": t_data - t_ck, **self.load_phases}
        print("[synthesizer] load phases: " + ", ".join(
            f"{k.replace('_', ' ')} {v:.1f}s"
            for k, v in self.load_phases.items()), flush=True)

    @classmethod
    def from_parts(cls, model_config, model, vocoder, denoiser, *,
                   encode_fn, speaker_id_fn, sampling_rate=22050,
                   hop_length=256, seed=1234, token_dur_scaling=1.0,
                   token_duration_max=100, f0_mean=0.0, f0_std=0.0,
                   energy_mean=0.0, energy_std=0.0, bucket_single=False,
                   use_amp=False, weight_dtype="auto", matmul_precision=None,
                   data_parallel=1, devices=None, device=None):
        """Build from in-memory modules (no checkpoint files).
        `encode_fn(text) -> int array`; `speaker_id_fn(name) -> int`.
        The modules are moved to `device` (the first replica's, with
        data_parallel; the others get copies); with bf16 weights the model
        is copied first, so the caller's keeps its fp32 kernels."""
        self = object.__new__(cls)
        self.trainset = None
        self._setup(model_config, model, vocoder, denoiser,
                    encode_fn=encode_fn, speaker_id_fn=speaker_id_fn,
                    sampling_rate=sampling_rate, hop_length=hop_length,
                    seed=seed, token_dur_scaling=token_dur_scaling,
                    token_duration_max=token_duration_max, f0_mean=f0_mean,
                    f0_std=f0_std, energy_mean=energy_mean,
                    energy_std=energy_std, bucket_single=bucket_single,
                    use_amp=use_amp, weight_dtype=weight_dtype,
                    matmul_precision=matmul_precision,
                    devices=replica_devices(data_parallel, devices, device))
        return self

    def _setup(self, model_config, model, vocoder, denoiser, *, encode_fn,
               speaker_id_fn, sampling_rate, hop_length, seed,
               token_dur_scaling, token_duration_max, f0_mean, f0_std,
               energy_mean, energy_std, bucket_single, use_amp,
               weight_dtype, matmul_precision, devices):
        self.devices = list(devices)
        self.data_parallel = len(self.devices)
        self.device = self.devices[0]
        self.matmul_precision = precision.check(matmul_precision)
        self.use_amp = bool(use_amp)
        self.weight_dtype = self.resolve_weight_dtype(weight_dtype)
        self.model_config = model_config
        self.group_size = model_config["n_group_size"]
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.token_dur_scaling = token_dur_scaling
        self.token_duration_max = token_duration_max
        self.f0_mean, self.f0_std = f0_mean, f0_std
        # stored for the JAX engine's signature: its radtts_infer takes
        # energy_mean/std and never reads them, so they change nothing
        self.energy_mean, self.energy_std = energy_mean, energy_std
        # pad single-text requests to the batched path's 16-token buckets
        # (padded == exact, tested)
        self.bucket_single = bucket_single
        tic = time.perf_counter()
        if self.weight_dtype == "bfloat16":
            model = store_conv_weights(copy.deepcopy(model))
        self.replicas = []   # (device, model, vocoder, denoiser)
        for dev in self.devices:
            same = [r for r in self.replicas if r[0] == dev]
            if same:
                self.replicas.append(same[0])
                continue
            parts = (model, vocoder, denoiser)
            if self.replicas:
                parts = copy.deepcopy(parts)
            self.replicas.append((dev,) + tuple(m.to(dev).eval()
                                                for m in parts))
        _, self.model, self.vocoder, self.denoiser = self.replicas[0]
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.load_phases = {"to_device": time.perf_counter() - tic}
        self._encode_fn = encode_fn
        self._speaker_id_fn = speaker_id_fn
        self.generator = torch.Generator(self.device).manual_seed(seed)

    @staticmethod
    def resolve_weight_dtype(weight_dtype):
        """'auto' or None -> 'float32'; 'float32'; 'bfloat16'."""
        if weight_dtype in (None, "auto", "float32"):
            return "float32"
        if weight_dtype == "bfloat16":
            return "bfloat16"
        raise ValueError(f"weight_dtype={weight_dtype!r}: expected 'auto', "
                         "'float32' or 'bfloat16'")

    def encode(self, text):
        return np.asarray(self._encode_fn(text))

    def speaker_id(self, name):
        return self._speaker_id_fn(name)

    def _ids(self, name, default, B):
        sid = default if name is None else self.speaker_id(name)
        return torch.full((B,), sid, dtype=torch.int64, device=self.device)

    def synthesize(self, texts, speaker, **kwargs):
        """Synthesize a batch of texts for one speaker at the
        Synthesizer's matmul precision (see _synthesize). Under a torch
        profiler the call is traced (tracing.py): its root span
        `synthesize` holds the call's id and totals."""
        with tracing.call("synthesize", self.device), \
                precision.scope(self.matmul_precision):
            return self._synthesize(texts, speaker, **kwargs)

    def _shards(self, B):
        """(replica, row slice) of each replica for a batch of B rows (a
        multiple of data_parallel)."""
        n = B // self.data_parallel
        return [(r, slice(i * n, (i + 1) * n))
                for i, r in enumerate(self.replicas)]

    @torch.inference_mode()
    def _synthesize(self, texts, speaker, *, speaker_text=None,
                   speaker_attributes=None, sigma=0.8, sigma_tkndur=0.666,
                   sigma_f0=1.0, sigma_energy=1.0, denoising_strength=0.0,
                   trim=True):
        """Synthesize a batch of texts for one speaker.

        Returns (wavs, aux): `wavs` is a list of float32 numpy arrays (one
        per text, trimmed to its own duration unless trim=False); `aux` has
        per-item 'f0', 'energy_avg', 'dur', 'n_frames'. Batches pad to a
        16-token bucket. `sigma` scales the decoder's noise; sigma_tkndur,
        sigma_f0 and sigma_energy scale the noise that flow attribute
        models (BGAP, AGAP) sample durations, f0 and energy from. A DAP
        is deterministic and takes no noise: with DAPs they change
        nothing, as in the JAX engine. With data_parallel (see the
        module's docstring) the batch is split over the replicas."""
        if isinstance(texts, str):
            texts = [texts]
        with tracing.span("frontend", self.device):
            encs = [self.encode(t) for t in texts]
            B_real = len(encs)
            if B_real % self.data_parallel:
                encs = encs + [encs[-1]] * (self.data_parallel
                                            - B_real % self.data_parallel)
            B = len(encs)
            lens = np.array([len(e) for e in encs], np.int64)
            if B == 1 and not self.bucket_single:
                N, in_lens = int(lens[0]), None
            else:
                N = ((int(lens.max()) + 15) // 16) * 16
                with tracing.upload("tokens", self.device):
                    in_lens = torch.as_tensor(lens, device=self.device)
            text_b = np.zeros((B, N), np.int64)
            for j, e in enumerate(encs):
                text_b[j, : len(e)] = e
            with tracing.upload("tokens", self.device):
                text_b = torch.as_tensor(text_b, device=self.device)

            sid = self.speaker_id(speaker)
            spk = self._ids(None, sid, B)
            spk_text = self._ids(speaker_text, sid, B)
            spk_attr = self._ids(speaker_attributes, sid, B)
        tracing.annotate(B=B, N=N)
        shards = self._shards(B)

        def part(t, rows, dev):
            return None if t is None else t[rows].to(dev, non_blocking=True)

        with tracing.span("noise", self.device):
            z_dur = duration_noise(self.model, B, N, sigma_tkndur,
                                   self.generator, self.device)
        durs = []
        for (dev, model, _, _), rows in shards:
            with amp.scope(model, self.use_amp):
                durs.append(infer_durations(
                    model, part(spk_text, rows, dev),
                    part(text_b, rows, dev),
                    token_dur_scaling=self.token_dur_scaling,
                    token_duration_max=self.token_duration_max,
                    in_lens=part(in_lens, rows, dev),
                    z_dur=part(z_dur, rows, dev)))
        dur = torch.cat([d.to(self.device) for d in durs])
        with tracing.readback("totals", self.device):
            totals = dur.sum(1).cpu().numpy()
        if (totals < 1).any():  # untrained/degenerate duration guard
            valid = np.arange(N)[None, :] < lens[:, None]
            bump = (totals < 1)[:, None] & valid
            with tracing.upload("totals", self.device):
                bump = torch.as_tensor(bump.astype(np.int32),
                                       device=self.device)
            dur = dur + bump
            with tracing.readback("totals", self.device):
                totals = dur.sum(1).cpu().numpy()
        max_frames = frame_budget(totals.max(), self.group_size)
        tracing.annotate(max_frames=max_frames)
        with tracing.span("noise", self.device):
            z_f0, z_energy, residual = infer_noise(
                self.model, B, max_frames, sigma=sigma, sigma_f0=sigma_f0,
                sigma_energy=sigma_energy, generator=self.generator,
                device=self.device)
        with tracing.upload("totals", self.device):
            total = torch.as_tensor(totals, device=self.device)
        t = torch.arange(max_frames, device=self.device)
        idx = torch.minimum(t[None, :], total[:, None] - 1)
        outs, audios = [], []
        for (dev, model, vocoder, denoiser), rows in shards:
            with amp.scope(model, self.use_amp):
                out = radtts_infer(
                    model, part(spk, rows, dev), part(text_b, rows, dev),
                    sigma, max_frames, dur=part(dur, rows, dev),
                    speaker_id_attributes=part(spk_attr, rows, dev),
                    f0_mean=self.f0_mean, f0_std=self.f0_std,
                    in_lens=part(in_lens, rows, dev),
                    z_f0=part(z_f0, rows, dev),
                    z_energy=part(z_energy, rows, dev),
                    residual=part(residual, rows, dev))
            # replicate the last valid frame into the padding so the
            # vocoder's receptive field sees no garbage at the boundary
            mel = torch.gather(out["mel"], 1, part(idx, rows, dev)[
                :, :, None].expand(-1, -1, out["mel"].shape[2]))
            audios.append(denoiser_apply(denoiser, vocoder(mel),
                                         strength=denoising_strength))
            outs.append(out)
        # f0 and energy are absent on attribute-less configs
        feats = [k for k in ("f0", "energy_avg") if outs[0][k] is not None]
        with tracing.readback("outputs", self.device,
                              len(audios) + 1 + len(feats) * len(outs)):
            audio = np.concatenate([a.cpu().numpy() for a in audios])
            aux = {"dur": dur.cpu().numpy()[:B_real],
                   "n_frames": totals[:B_real]}
            for k in feats:
                aux[k] = np.concatenate([o[k].cpu().numpy()
                                         for o in outs])[:B_real]
        wavs = [audio[j, : int(totals[j]) * self.hop_length] if trim
                else audio[j] for j in range(B_real)]
        return wavs, aux

    def synthesize_long(self, text, speaker, *, max_tokens, gap_ms=120.0,
                        **kwargs):
        """Synthesize one text of unbounded length: split at sentence
        boundaries into chunks of <= max_tokens encoded symbols
        (text/chunking.py, the splitter of the inference CLI's
        --long_text_chunk), run the chunks as one batch, and join the
        trimmed waveforms with `gap_ms` of silence. Returns (wav, aux)
        where aux carries the batched per-chunk arrays plus 'n_chunks'."""
        parts = split_text_to_chunks(
            text, lambda s: len(self.encode(s)), max_tokens)
        wavs, aux = self.synthesize(parts, speaker, **kwargs)
        aux["n_chunks"] = len(parts)
        gap = np.zeros(int(self.sampling_rate * gap_ms / 1000.0),
                       np.float32)
        joined = []
        for j, w in enumerate(wavs):
            joined.append(w)
            if j < len(wavs) - 1:
                joined.append(gap)
        return np.concatenate(joined), aux
