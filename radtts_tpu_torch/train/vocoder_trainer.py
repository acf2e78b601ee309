"""HiFi-GAN vocoder training: generator + multi-period and multi-scale
discriminators, mel L1 x45, feature matching x2 and LSGAN losses, AdamW
betas (0.8, 0.99) with stepped exponential lr decay, random fixed-size
audio segments. The port of radtts_tpu/train/vocoder_trainer.py.

One step updates the discriminators on a generator output made without
gradients, then the generator against the updated discriminators. On the
card the mel frontend runs through the hand-written kernel (ops/mel.py),
and the discriminator pass's generator runs the MRF kernel (ops/mrf.py);
the generator pass that is differentiated runs mrf_plain, since the MRF
kernel has no backward (the JAX package sends it through XLA's MRF).
"""

import numpy as np
import torch
from torch import nn

from radtts_tpu_torch.models.hifigan import (Generator,
                                             gaussian_blur_augmentation)
from radtts_tpu_torch.models.hifigan_disc import (MultiPeriodDiscriminator,
                                                  MultiScaleDiscriminator,
                                                  discriminator_loss,
                                                  feature_loss,
                                                  generator_loss)
from radtts_tpu_torch.ops.mel import mel

BETAS = (0.8, 0.99)
WEIGHT_DECAY = 0.01


def vocoder_train_init(h, seed=0):
    """{gen, mpd, msd} for a HiFi-GAN config dict, normal(0, 0.01) weights
    drawn from `seed` (the global torch generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return nn.ModuleDict({"gen": Generator(h),
                              "mpd": MultiPeriodDiscriminator(),
                              "msd": MultiScaleDiscriminator()})


class DecayedAdamW(torch.optim.AdamW):
    """AdamW whose lr is optax.exponential_decay(lr, decay_every, lr_decay,
    staircase=True) of the number of updates made before the current one,
    read from the optimizer's own state, so it survives a state_dict round
    trip."""

    def __init__(self, params, lr, lr_decay, decay_every, **kwargs):
        super().__init__(params, lr=lr, **kwargs)
        self.base_lr = lr
        self.lr_decay = lr_decay
        self.decay_every = decay_every

    def step(self, closure=None):
        done = next((int(s["step"]) for s in self.state.values()), 0)
        lr = self.base_lr * self.lr_decay ** (done // self.decay_every)
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def make_optimizers(models, lr=2e-4, lr_decay=0.999, decay_every=1000):
    """(optim_g, optim_d): upstream HiFi-GAN's AdamW pair (BETAS,
    WEIGHT_DECAY) with stepped exponential decay."""
    def make(params):
        return DecayedAdamW(params, lr, lr_decay, decay_every, betas=BETAS,
                            eps=1e-8, weight_decay=WEIGHT_DECAY)
    return (make(models["gen"].parameters()),
            make([*models["mpd"].parameters(), *models["msd"].parameters()]))


def make_vocoder_train_step(mel_kwargs, optim_g, optim_d, p_blurring=0.0):
    """Returns step(models, audio, generator=None) -> metrics, which updates
    the models in place. audio: (B, segment) in [-1, 1]; `generator` is the
    torch.Generator of the blur draws."""
    hop = mel_kwargs["hop_length"]

    def mel_fn(a):
        # crop the centered STFT's trailing frame: segment -> segment // hop
        # frames -> generator output length == segment
        return mel(a, **mel_kwargs)[:, : a.shape[1] // hop]

    def step(models, audio, generator=None):
        gen, mpd, msd = models["gen"], models["mpd"], models["msd"]
        with torch.no_grad():
            mel_target = mel_fn(audio)
            mel_in = gaussian_blur_augmentation(mel_target, generator,
                                                p_blurring=p_blurring)
            y_hat = gen(mel_in)

        # discriminators first, on the generator output without gradients
        pr, pg, _, _ = mpd(audio, y_hat)
        loss_p, _, _ = discriminator_loss(pr, pg)
        sr, sg, _, _ = msd(audio, y_hat)
        loss_s, _, _ = discriminator_loss(sr, sg)
        loss_d = loss_p + loss_s
        optim_d.zero_grad()
        loss_d.backward()
        optim_d.step()

        # generator against the updated discriminators
        y_hat = gen(mel_in, mrf_impl="plain")
        loss_mel = (mel_fn(y_hat) - mel_target).abs().mean() * 45.0
        pr, pg, fr, fg = mpd(audio, y_hat)
        sr, sg, fsr, fsg = msd(audio, y_hat)
        loss_fm = feature_loss(fr, fg) + feature_loss(fsr, fsg)
        loss_adv = generator_loss(pg)[0] + generator_loss(sg)[0]
        loss_g = loss_mel + loss_fm + loss_adv
        optim_g.zero_grad()
        loss_g.backward(inputs=list(gen.parameters()))
        optim_g.step()

        return {"loss_disc": loss_d.detach(), "loss_gen": loss_g.detach(),
                "loss_mel": loss_mel.detach(), "loss_fm": loss_fm.detach(),
                "loss_adv": loss_adv.detach()}

    return step


class SegmentSampler:
    """Random fixed-size audio segments from a wav list (host side).

    Wavs shorter than the segment are reflect-padded. Audio is scaled to
    [-1, 1] like the data pipeline (int16 / 32768)."""

    def __init__(self, paths, segment_size, seed=0):
        from scipy.io import wavfile
        self.audio = []
        for p in paths:
            _, w = wavfile.read(p)
            if w.dtype.kind == "i":
                w = w.astype(np.float32) / 32768.0
            elif w.dtype.kind == "f":
                w = w.astype(np.float32)
            if w.ndim > 1:
                w = w[:, 0]
            if len(w) < segment_size:
                w = np.pad(w, (0, segment_size - len(w)), mode="reflect")
            self.audio.append(w)
        self.segment_size = segment_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size, step=None):
        """step=None: draw from the sampler's own stream. step=i: derive
        the stream from (seed, i), so a run resumed at iteration i draws
        the segments the uninterrupted run would have drawn."""
        rng = (self.rng if step is None
               else np.random.default_rng((self.seed, int(step))))
        out = np.empty((batch_size, self.segment_size), np.float32)
        for b in range(batch_size):
            w = self.audio[rng.integers(len(self.audio))]
            o = rng.integers(0, len(w) - self.segment_size + 1)
            out[b] = w[o: o + self.segment_size]
        return out
