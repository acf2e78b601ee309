"""The port's HiFi-GAN vocoder training against the JAX package on the CPU:
blur augmentation, AdamW with its schedule, segment sampling,
reference-format generator state dicts and one whole train step, on the
same weights (a small generator, the full discriminators) carried over by
radtts_tpu_torch.convert. The discriminators, the GAN losses and the loss
gradients are in test_torch_vocoder_losses.py, which shares this file's
weights.

Weights are drawn with numpy at std 1/sqrt(fan_in), so activations stay
O(1) through the deep discriminators and every comparison is away from
zero. Tolerances are stated at each check.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from radtts_tpu.models.hifigan import gaussian_blur_augmentation as \
    jax_blur
from radtts_tpu.models.hifigan import gaussian_blur_kernels as \
    jax_blur_kernels
from radtts_tpu.models.hifigan import (hifigan_generator_apply,
                                       hifigan_generator_from_torch,
                                       hifigan_generator_to_torch)
from radtts_tpu.train import vocoder_trainer as jt

from radtts_tpu_torch.convert import vocoder_train_from_jax
from radtts_tpu_torch.models.hifigan import (BLUR_KERNEL_SIZE, BLUR_SIGMAS,
                                             _blur, gaussian_blur_kernels,
                                             gaussian_blur_augmentation,
                                             generator_from_reference,
                                             generator_to_reference)
from radtts_tpu_torch.train import vocoder_trainer as tt

H32 = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 32,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
MEL_KW = dict(filter_length=1024, hop_length=256, win_length=1024,
              n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
              mel_fmax=8000.0)
SEGMENT = 2048


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()
                if k not in ("_meta", "_kind")}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def params():
    """The JAX trainer's {gen, mpd, msd} tree (structure from
    vocoder_train_init, weights from numpy)."""
    shapes = jax.eval_shape(
        lambda: jt.vocoder_train_init(jax.random.PRNGKey(0), H32))
    rng = np.random.default_rng(0)

    def draw(s):
        std = 0.05 if len(s.shape) == 1 else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return jnp.asarray(std * rng.standard_normal(s.shape), jnp.float32)

    return jax.tree.map(draw, shapes)


def port_models(tree):
    return vocoder_train_from_jax(np_tree(tree), H32)


def _audio(shape, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * np.tanh(rng.standard_normal(shape))).astype(np.float32)


def assert_close_each(got, ref, rel):
    """Each tensor within rel * its own max |ref|."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, (g.shape, r.shape)
        assert np.abs(g - r).max() <= rel * np.abs(r).max(), (
            np.abs(g - r).max(), np.abs(r).max())


# --------------------------------------------------------------------------
# blur, optimizer, sampler, state dicts
# --------------------------------------------------------------------------

def test_blur_kernels_are_exact():
    args = (BLUR_KERNEL_SIZE, BLUR_SIGMAS)
    np.testing.assert_array_equal(gaussian_blur_kernels(*args),
                                  np.asarray(jax_blur_kernels(*args)))


# keys whose draws cover no blur, and a blur with each kernel
@pytest.mark.parametrize("seed, p", [(0, 0.5), (1, 0.5), (2, 0.5), (4, 0.5),
                                     (7, 0.7)])
def test_blur_matches_jax_with_injected_draws(seed, p):
    """The port's blur given the draws JAX makes from its key: the same
    branch and the same 5x5 conv within 1e-6."""
    mel_np = np.random.default_rng(seed).standard_normal((2, 9, 80)).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_blur(key, jnp.asarray(mel_np), p_blurring=p))
    k_rng, p_rng = jax.random.split(key)
    index = int(jax.random.randint(k_rng, (), 0, 3))
    uniform = float(jax.random.uniform(p_rng, ()))
    got = _blur(torch.from_numpy(mel_np), index, uniform, p).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if uniform > p:
        np.testing.assert_array_equal(got, mel_np)
    elif index > 0:  # sigma 0.1 (index 0) leaves the mel as it was
        assert np.abs(got - mel_np).max() > 0.1


def test_blur_draws_from_generator():
    mel_t = torch.randn(1, 7, 80, generator=torch.Generator().manual_seed(0))
    assert gaussian_blur_augmentation(mel_t, None) is mel_t
    blurred = gaussian_blur_augmentation(
        mel_t, torch.Generator().manual_seed(3), p_blurring=1.0)
    g = torch.Generator().manual_seed(3)
    index = int(torch.randint(3, (), generator=g))
    expect = _blur(mel_t, index, 0.0, 1.0)
    torch.testing.assert_close(blurred, expect, rtol=0, atol=0)


def test_adamw_schedule_matches_optax():
    """Three updates of make_optimizers' generator optimizer, crossing a
    decay boundary (decay_every=2), against the JAX package's optax.adamw.
    Random gradients keep Adam's first step away from the sign flip a
    near-zero gradient would allow; 3e-7 absolute is a few fp32 roundings
    of parameters of size up to 2 moved by 1e-2."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
    kw = dict(lr=1e-2, lr_decay=0.5, decay_every=2)

    optim_g, _ = jt.make_optimizers(**kw)
    p = {"w": jnp.asarray(w0)}
    state = optim_g.init(p)
    models = torch.nn.ModuleDict({"gen": torch.nn.Linear(3, 4, bias=False),
                                  "mpd": torch.nn.Linear(1, 1),
                                  "msd": torch.nn.Linear(1, 1)})
    with torch.no_grad():
        models["gen"].weight.copy_(torch.from_numpy(w0))
    opt, _ = tt.make_optimizers(models, **kw)
    for g in grads:
        upd, state = optim_g.update({"w": jnp.asarray(g)}, state, p)
        p = optax.apply_updates(p, upd)
        models["gen"].weight.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(models["gen"].weight.detach().numpy(),
                                   np.asarray(p["w"]), rtol=0, atol=3e-7)
    # the third update ran at half the rate of the first two
    assert opt.param_groups[0]["lr"] == pytest.approx(5e-3)


def test_segment_sampler_matches_jax(tmp_path):
    from scipy.io import wavfile
    paths = []
    for i, n in enumerate((3000, 9000)):
        path = tmp_path / f"{i}.wav"
        wavfile.write(path, 22050, (np.sin(np.arange(n) / (5 + i)) * 20000)
                      .astype(np.int16))
        paths.append(str(path))
    ref = jt.SegmentSampler(paths, 4096, seed=3)
    got = tt.SegmentSampler(paths, 4096, seed=3)
    np.testing.assert_array_equal(got.sample(4, step=5), ref.sample(4, step=5))
    for _ in range(2):
        np.testing.assert_array_equal(got.sample(3), ref.sample(3))


def _legacy(sd):
    """Flat resblocks.N.* keys, as old checkpoints store them."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "resblocks":
            k = ".".join(["resblocks", str(3 * int(parts[1]) + int(parts[2]))]
                         + parts[3:])
        out[k] = v
    return out


def test_generator_reference_state_dict(params):
    """Export equals hifigan_generator_to_torch exactly; import (also from
    legacy keys) gives the audio hifigan_generator_from_torch gives, within
    1e-4 of its scale (four upsample stages of fp32 convs)."""
    gen = port_models(params)["gen"]
    ref_sd = hifigan_generator_to_torch(params["gen"])
    sd = generator_to_reference(gen)
    assert list(sd) == list(ref_sd)
    for k in sd:
        torch.testing.assert_close(sd[k], ref_sd[k], rtol=0, atol=0)

    mel_np = np.random.default_rng(3).standard_normal((1, 12, 80)).astype(
        np.float32)
    ref = np.asarray(hifigan_generator_apply(
        hifigan_generator_from_torch(ref_sd, H32), jnp.asarray(mel_np)))
    loaded = generator_from_reference(ref_sd, H32)
    with torch.no_grad():
        got = loaded(torch.from_numpy(mel_np)).numpy()
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    legacy = generator_from_reference(_legacy(ref_sd), H32)
    for (k, a), (_, b) in zip(loaded.state_dict().items(),
                              legacy.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------

def test_train_step_matches_jax(params):
    """One whole step (discriminators, then the generator against the
    updated discriminators) from the same state: the five losses within
    rtol 1e-4, every parameter within 2 * lr, Adam's first update moving a
    parameter by ~lr * sign(grad), whose sign a gradient near zero may
    flip. Any gradient bounds that update by lr, so the 2 * lr limit alone
    would pass a zero or wrong gradient; such a gradient moves nearly every
    parameter by ~lr away from JAX's, so at most 1e-3 of the generator's
    and of the discriminators' parameters may differ by more than 0.1 *
    lr."""
    lr = 2e-4
    audio = _audio((1, SEGMENT), 5)
    optim_g, optim_d = jt.make_optimizers(lr=lr)
    opt_g = optim_g.init(params["gen"])
    opt_d = optim_d.init({"mpd": params["mpd"], "msd": params["msd"]})
    step = jt.make_vocoder_train_step(MEL_KW, optim_g, optim_d)
    new, _, _, metrics = step(params, opt_g, opt_d, jnp.asarray(audio),
                              jax.random.PRNGKey(0))

    models = port_models(params)
    t_opt_g, t_opt_d = tt.make_optimizers(models, lr=lr)
    got = tt.make_vocoder_train_step(MEL_KW, t_opt_g, t_opt_d)(
        models, torch.from_numpy(audio))
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    ref = port_models(new)
    for name in ("gen", "mpd", "msd"):
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(
            models[name].parameters(), ref[name].parameters())])
        assert diffs.max().item() <= 2 * lr, (name, diffs.max().item())
        share = (diffs > 0.1 * lr).float().mean().item()
        assert share <= 1e-3, (name, share)
