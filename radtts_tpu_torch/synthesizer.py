"""Warm-model text->waveform synthesis engine: durations -> attributes ->
inverse flow -> vocoder -> denoiser, on one device.

Entry points run on the card by default: `device=None` means CUDA and
raises when CUDA is absent; pass device="cpu" to run the plain path.
Precision is pinned to full fp32 (no TF32 in cuDNN convolutions or cuBLAS
matmuls): the 1024-wide WN couplings compound reduced-precision error over
the 8 inverse flows.
"""

import numpy as np
import torch

from radtts_tpu_torch.models.hifigan import denoiser_apply
from radtts_tpu_torch.models.radtts import infer_durations, radtts_infer


def frame_budget(n_frames, group_size, multiple=16):
    m = multiple * group_size
    return ((int(n_frames) + m - 1) // m) * m


def resolve_device(device=None):
    """None -> CUDA, raising when it is absent. Pins fp32 precision."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device(device)


class Synthesizer:
    """One loaded model + vocoder + denoiser; `synthesize()` per request
    batch. Build with `from_parts`."""

    @classmethod
    def from_parts(cls, model_config, model, vocoder, denoiser, *,
                   encode_fn, speaker_id_fn, sampling_rate=22050,
                   hop_length=256, seed=1234, token_dur_scaling=1.0,
                   token_duration_max=100, f0_mean=0.0, f0_std=0.0,
                   bucket_single=False, device=None):
        """Build from in-memory modules (no checkpoint files).
        `encode_fn(text) -> int array`; `speaker_id_fn(name) -> int`.
        The modules are moved to `device`."""
        self = cls()
        self.device = resolve_device(device)
        self.model_config = model_config
        self.group_size = model_config["n_group_size"]
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.token_dur_scaling = token_dur_scaling
        self.token_duration_max = token_duration_max
        self.f0_mean, self.f0_std = f0_mean, f0_std
        # pad single-text requests to the batched path's 16-token buckets
        # (padded == exact, tested)
        self.bucket_single = bucket_single
        self.model = model.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()
        self.denoiser = denoiser.to(self.device).eval()
        self._encode_fn = encode_fn
        self._speaker_id_fn = speaker_id_fn
        self.generator = torch.Generator(self.device).manual_seed(seed)
        return self

    def encode(self, text):
        return np.asarray(self._encode_fn(text))

    def speaker_id(self, name):
        return self._speaker_id_fn(name)

    def _ids(self, name, default, B):
        sid = default if name is None else self.speaker_id(name)
        return torch.full((B,), sid, dtype=torch.int64, device=self.device)

    @torch.inference_mode()
    def synthesize(self, texts, speaker, *, speaker_text=None,
                   speaker_attributes=None, sigma=0.8, denoising_strength=0.0,
                   trim=True):
        """Synthesize a batch of texts for one speaker.

        Returns (wavs, aux): `wavs` is a list of float32 numpy arrays (one
        per text, trimmed to its own duration unless trim=False); `aux` has
        per-item 'f0', 'energy_avg', 'dur', 'n_frames'. Batches pad to a
        16-token bucket. `sigma` scales the decoder's noise; the DAP
        attribute models are deterministic, so the JAX engine's
        sigma_tkndur/sigma_f0/sigma_energy have no counterpart here."""
        if isinstance(texts, str):
            texts = [texts]
        encs = [self.encode(t) for t in texts]
        B = len(encs)
        lens = np.array([len(e) for e in encs], np.int64)
        if B == 1 and not self.bucket_single:
            N, in_lens = int(lens[0]), None
        else:
            N = ((int(lens.max()) + 15) // 16) * 16
            in_lens = torch.as_tensor(lens, device=self.device)
        text_b = np.zeros((B, N), np.int64)
        for j, e in enumerate(encs):
            text_b[j, : len(e)] = e
        text_b = torch.as_tensor(text_b, device=self.device)

        sid = self.speaker_id(speaker)
        spk = self._ids(None, sid, B)
        spk_text = self._ids(speaker_text, sid, B)
        spk_attr = self._ids(speaker_attributes, sid, B)

        dur = infer_durations(
            self.model, spk_text, text_b,
            token_dur_scaling=self.token_dur_scaling,
            token_duration_max=self.token_duration_max, in_lens=in_lens)
        totals = dur.sum(1).cpu().numpy()
        if (totals < 1).any():  # untrained/degenerate duration guard
            valid = np.arange(N)[None, :] < lens[:, None]
            bump = (totals < 1)[:, None] & valid
            dur = dur + torch.as_tensor(bump.astype(np.int32),
                                        device=self.device)
            totals = dur.sum(1).cpu().numpy()
        max_frames = frame_budget(totals.max(), self.group_size)
        out = radtts_infer(
            self.model, spk, text_b, sigma, max_frames, dur=dur,
            speaker_id_attributes=spk_attr, f0_mean=self.f0_mean,
            f0_std=self.f0_std, in_lens=in_lens, generator=self.generator)
        # replicate the last valid frame into the padding so the vocoder's
        # receptive field sees no garbage at the boundary
        total = torch.as_tensor(totals, device=self.device)
        t = torch.arange(max_frames, device=self.device)
        idx = torch.minimum(t[None, :], total[:, None] - 1)
        mel = torch.gather(out["mel"], 1,
                           idx[:, :, None].expand(-1, -1,
                                                  out["mel"].shape[2]))
        audio = denoiser_apply(self.denoiser, self.vocoder(mel),
                               strength=denoising_strength)
        audio = audio.cpu().numpy()
        wavs = [audio[j, : int(totals[j]) * self.hop_length] if trim
                else audio[j] for j in range(B)]
        aux = {"dur": dur.cpu().numpy(), "n_frames": totals}
        for k in ("f0", "energy_avg"):  # absent on attribute-less configs
            if out[k] is not None:
                aux[k] = out[k].cpu().numpy()
        return wavs, aux
