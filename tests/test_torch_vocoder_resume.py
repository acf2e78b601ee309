"""Resuming vocoder training in the port (train_vocoder.py --resume) from
the JAX package's do_<it>.npz, on the CPU: both AdamW states (step counts
and moments) and their staircase schedule; JAX resumes its own file; the
next step must agree, the moments included."""

import ctypes
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.train import vocoder_trainer as jvt
from radtts_tpu.train.checkpoint import save_checkpoint
from tests.test_torch_checkpoint import tmp_path  # noqa: F401
from tests.test_torch_resume import close_moments, close_params
from tests.test_torch_synthesizer_parity import np_tree
from tests.test_torch_vocoder_train import H32, MEL_KW, SEGMENT, _audio
from tests.test_torch_vocoder_train import params as vocoder_params  # noqa

from radtts_tpu_torch.convert import vocoder_train_from_jax
from radtts_tpu_torch.train import vocoder_trainer as tvt
from radtts_tpu_torch.train.checkpoint import opt_moments
from radtts_tpu_torch.train_vocoder import load_resume


def release_memory():
    """Hand freed heap memory back to the system: glibc keeps what JAX's
    steps and its save over the full discriminators freed (~2 GB), and a
    loaded machine ends the processes that hold the most."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def test_vocoder_resume_from_jax_npz(tmp_path, vocoder_params):  # noqa
    """train_vocoder's resume (load_resume) of JAX's do_<it>.npz: the
    generator's and discriminators' weights, both AdamW states (moments
    equal to JAX's, the step count) and the schedule's position, read by
    the staircase at decay_every=2, which the resumed step crosses; then
    one step agrees with JAX's own resume and step."""
    lr, kw = 2e-4, dict(lr_decay=0.5, decay_every=2)
    optim_g, optim_d = jvt.make_optimizers(lr=lr, **kw)
    params = vocoder_params
    opt_g = optim_g.init(params["gen"])
    opt_d = optim_d.init({"mpd": params["mpd"], "msd": params["msd"]})
    step = jvt.make_vocoder_train_step(MEL_KW, optim_g, optim_d)
    audio = [_audio((1, SEGMENT), 5 + i) for i in range(3)]
    for i in range(2):
        params, opt_g, opt_d, _ = step(params, opt_g, opt_d,
                                       jnp.asarray(audio[i]),
                                       jax.random.PRNGKey(i))
    path = str(tmp_path / "do_00000002")
    save_checkpoint(path, params, {"g": opt_g, "d": opt_d}, iteration=2)
    release_memory()
    # JAX's trees go into the port's layout as soon as they are made and
    # are dropped: the full discriminators' weights and moments are ~0.3
    # GB a tree, and the run's peak memory is what a loaded machine ends
    mu = dict(vocoder_train_from_jax(
        {"gen": np_tree(opt_g[0].mu), **np_tree(opt_d[0].mu)},
        H32).named_parameters())
    new, opt_g, opt_d, metrics = step(params, opt_g, opt_d,
                                      jnp.asarray(audio[2]),
                                      jax.random.PRNGKey(2))
    metrics = {k: float(v) for k, v in metrics.items()}
    want = vocoder_train_from_jax(np_tree(new), H32)
    want_mu = vocoder_train_from_jax(
        {"gen": np_tree(opt_g[0].mu), **np_tree(opt_d[0].mu)}, H32)
    want_nu = vocoder_train_from_jax(
        {"gen": np_tree(opt_g[0].nu), **np_tree(opt_d[0].nu)}, H32)
    del params, new, opt_g, opt_d, step
    release_memory()

    models = tvt.vocoder_train_init(H32, seed=9)
    t_opt_g, t_opt_d = tvt.make_optimizers(models, lr=lr, **kw)
    it = load_resume(path + ".npz", models, t_opt_g, t_opt_d, H32)
    assert it == 2
    names = {id(p): n for n, p in models.named_parameters()}
    for opt in (t_opt_g, t_opt_d):
        for p in opt.param_groups[0]["params"]:
            st = opt.state[p]
            assert int(st["step"]) == 2
            assert torch.equal(st["exp_avg"], mu[names[id(p)]].detach())
    del mu
    got = tvt.make_vocoder_train_step(MEL_KW, t_opt_g, t_opt_d)(
        models, torch.from_numpy(audio[2]))
    assert t_opt_g.param_groups[0]["lr"] == pytest.approx(lr * 0.5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-4, err_msg=k)
    close_params(models, want, lr)
    for opt in (t_opt_g, t_opt_d):
        close_moments(opt, models, want_mu, want_nu)
    assert set(opt_moments(path)) == {"g/0/", "g/2/", "d/0/", "d/2/"}
