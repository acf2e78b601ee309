"""The port's HiFi-GAN discriminators, GAN losses and the gradients of the
discriminator and generator losses against the JAX package on the CPU, on
the weights of test_torch_vocoder_train.py (a small generator, the full
discriminators) carried over by radtts_tpu_torch.convert. Tolerances are
stated at each check.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models import hifigan_disc as jd
from radtts_tpu.models.hifigan import hifigan_generator_apply
from radtts_tpu.ops.stft import mel_spectrogram as jax_mel_spectrogram

from radtts_tpu_torch.models import hifigan_disc as td
from radtts_tpu_torch.ops.mel import mel
from radtts_tpu_torch.train import vocoder_trainer as tt

from tests.test_torch_vocoder_train import (H32, MEL_KW, SEGMENT,  # noqa: F401
                                            _audio, assert_close_each,
                                            params, port_models)


# --------------------------------------------------------------------------
# discriminators and losses
# --------------------------------------------------------------------------

# JAX feature maps are channels-last: NHWC (period) and NTC (scale)
_FMAP_PERM = {"mpd": (0, 3, 1, 2), "msd": (0, 2, 1)}
_JAX_APPLY = {"mpd": jd.multi_period_discriminator_apply,
              "msd": jd.multi_scale_discriminator_apply}


@pytest.fixture(scope="module")
def disc_outputs(params):
    """Both discriminators on the same real/generated pair of length 2053:
    not a multiple of any period but 2, so the period pad is exercised."""
    y, y_hat = _audio((2, 2053), 1), _audio((2, 2053), 2)
    models = port_models(params)
    out = {}
    with torch.no_grad():
        for name in ("mpd", "msd"):
            ref = jax.jit(_JAX_APPLY[name])(params[name], jnp.asarray(y),
                                            jnp.asarray(y_hat))
            got = models[name](torch.from_numpy(y), torch.from_numpy(y_hat))
            out[name] = (ref, got)
    return out


@pytest.mark.parametrize("name", ["mpd", "msd"])
def test_discriminator_matches_jax(disc_outputs, name):
    """Scores and every feature map within 1e-4 of the tensor's max: fp32
    convolutions of up to 1024 x 41 terms, summed in another order."""
    (sr, sg, fr, fg), (tsr, tsg, tfr, tfg) = disc_outputs[name]
    assert_close_each([s.numpy() for s in tsr + tsg], sr + sg, 1e-4)
    perm = _FMAP_PERM[name]
    for ref_maps, got_maps in ((fr, tfr), (fg, tfg)):
        assert_close_each([m.numpy() for d in got_maps for m in d],
                          [np.transpose(np.asarray(m), perm)
                           for d in ref_maps for m in d], 1e-4)


@pytest.mark.parametrize("name", ["mpd", "msd"])
def test_gan_losses_match_jax(disc_outputs, name):
    """The three losses on the JAX discriminator outputs, within 1e-5
    relative: means of O(1) values in fp32."""
    (sr, sg, fr, fg), _ = disc_outputs[name]
    perm = _FMAP_PERM[name]

    def t(x, p=None):
        x = np.asarray(x)
        return torch.from_numpy(np.ascontiguousarray(
            x if p is None else np.transpose(x, p)))

    pairs = [
        (jd.discriminator_loss(sr, sg)[0],
         td.discriminator_loss([t(s) for s in sr], [t(s) for s in sg])[0]),
        (jd.generator_loss(sg)[0], td.generator_loss([t(s) for s in sg])[0]),
        (jd.feature_loss(fr, fg),
         td.feature_loss([[t(m, perm) for m in d] for d in fr],
                         [[t(m, perm) for m in d] for d in fg])),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_discriminator_parameter_count():
    models = tt.vocoder_train_init(H32)
    n = sum(p.numel() for k in ("mpd", "msd")
            for p in models[k].parameters())
    assert n == 70_702_792


# --------------------------------------------------------------------------
# loss gradients and one train step
# --------------------------------------------------------------------------

def _mel_fn(a):
    return jax_mel_spectrogram(a, **MEL_KW)[:, : a.shape[1] // 256]


def _jax_disc_loss(dparams, audio, y_hat):
    pr, pg, _, _ = jd.multi_period_discriminator_apply(dparams["mpd"], audio,
                                                       y_hat)
    sr, sg, _, _ = jd.multi_scale_discriminator_apply(dparams["msd"], audio,
                                                      y_hat)
    return jd.discriminator_loss(pr, pg)[0] + jd.discriminator_loss(sr, sg)[0]


def _jax_gen_loss(gen, dparams, mel_in, audio):
    y_hat = hifigan_generator_apply(gen, mel_in, mrf_impl="xla")
    loss_mel = jnp.mean(jnp.abs(_mel_fn(y_hat) - mel_in)) * 45.0
    pr, pg, fr, fg = jd.multi_period_discriminator_apply(dparams["mpd"],
                                                         audio, y_hat)
    sr, sg, fsr, fsg = jd.multi_scale_discriminator_apply(dparams["msd"],
                                                          audio, y_hat)
    return (loss_mel + jd.feature_loss(fr, fg) + jd.feature_loss(fsr, fsg)
            + jd.generator_loss(pg)[0] + jd.generator_loss(sg)[0])


def _port_losses(models, audio, y_hat, mel_in):
    pr, pg, _, _ = models["mpd"](audio, y_hat.detach())
    sr, sg, _, _ = models["msd"](audio, y_hat.detach())
    loss_d = (td.discriminator_loss(pr, pg)[0]
              + td.discriminator_loss(sr, sg)[0])
    loss_mel = (mel(y_hat, **MEL_KW)[:, :SEGMENT // 256] - mel_in).abs() \
        .mean() * 45.0
    pr, pg, fr, fg = models["mpd"](audio, y_hat)
    sr, sg, fsr, fsg = models["msd"](audio, y_hat)
    loss_g = (loss_mel + td.feature_loss(fr, fg) + td.feature_loss(fsr, fsg)
              + td.generator_loss(pg)[0] + td.generator_loss(sg)[0])
    return loss_d, loss_g


def _grads_by_name(grad_tree, params, which):
    """JAX gradients laid out as the port's parameters, by name."""
    tree = dict(params)
    tree.update(grad_tree)
    mods = port_models(tree)
    return {k: p.detach().numpy() for k, p in mods.named_parameters()
            if k.split(".")[0] in which}


def test_loss_gradients_match_jax(params):
    """The discriminator loss's gradient with respect to both
    discriminators, and the generator loss's with respect to the generator,
    in float64 on both sides: in fp32 some of the ~10^6 leaky-ReLU inputs
    lie close enough to the kink for rounding to put JAX and the port on
    different sides, which moves a weight gradient by ~1% of its max. Each
    tensor within 1e-6 of its own max |grad|: the JAX mel projection rounds
    to fp32 (its einsum pins preferred_element_type), and the gradients are
    compared as fp32."""
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        audio = _audio((1, SEGMENT), 4).astype(np.float64)
        mel_in = np.asarray(_mel_fn(jnp.asarray(audio)), np.float64)
        dparams = {"mpd": p64["mpd"], "msd": p64["msd"]}
        y_hat = hifigan_generator_apply(p64["gen"], jnp.asarray(mel_in))
        ld, gd = jax.jit(jax.value_and_grad(_jax_disc_loss))(
            dparams, jnp.asarray(audio), y_hat)
        lg, gg = jax.jit(jax.value_and_grad(_jax_gen_loss))(
            p64["gen"], dparams, jnp.asarray(mel_in), jnp.asarray(audio))

    models = port_models(params).double()
    y_hat_t = models["gen"](torch.from_numpy(mel_in), mrf_impl="plain")
    loss_d, loss_g = _port_losses(models, torch.from_numpy(audio), y_hat_t,
                                  torch.from_numpy(mel_in))
    np.testing.assert_allclose(float(loss_d), float(ld), rtol=1e-9)
    np.testing.assert_allclose(float(loss_g), float(lg), rtol=1e-6)
    for loss, grads, which in ((loss_d, gd, ("mpd", "msd")),
                               (loss_g, {"gen": gg}, ("gen",))):
        loss.backward(inputs=[p for k in which
                              for p in models[k].parameters()])
        ref = _grads_by_name(grads, params, which)
        got = dict(models.named_parameters())
        assert_close_each([got[k].grad.float().numpy() for k in ref],
                          list(ref.values()), 1e-6)
