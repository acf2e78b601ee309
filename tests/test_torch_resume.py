"""Resuming RADTTS training in the port from the JAX package's
model_<it>.npz, optimizer state included, on the CPU (RAdam with fp32 and
with bf16 moments): JAX trains, saves and resumes itself; the port
resumes from the same file; the next step must agree, the moments
included. The vocoder's do_<it>.npz: tests/test_torch_vocoder_resume.py."""

import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.attributes import attribute_model_init
from radtts_tpu.train.checkpoint import save_checkpoint
from radtts_tpu.train.optim import build_optimizer as jax_build_optimizer
from radtts_tpu.train.trainer import build_trainable_mask as jax_mask
from radtts_tpu.train.trainer import make_train_step
from radtts_tpu.train.trainer import resume as jax_resume
from tests.small_model import MODEL_CONFIG
from tests.test_torch_synthesizer_parity import np_tree
from tests.test_torch_train_forward import (LOSS_WEIGHTS, jax_params,
                                            make_batch, to_torch)

from radtts_tpu_torch.convert import (attribute_from_jax, element_map,
                                      optimizer_state_from_jax,
                                      radtts_train_from_jax)
from radtts_tpu_torch.train.checkpoint import load_train_checkpoint
from radtts_tpu_torch.train.optim import build_optimizer
from radtts_tpu_torch.train.trainer import (apply_trainable_mask,
                                            build_trainable_mask,
                                            train_step)

LR = 1e-3


def close_params(got_model, want_model, lr, names=None):
    """test_torch_train_step.py's rule: every parameter within 2 lr of
    JAX's, at most 1e-3 of its elements more than 0.1 lr apart."""
    want = dict(want_model.named_parameters())
    for name, p in got_model.named_parameters():
        if names is not None and name not in names:
            continue
        diff = (p.detach() - want[name].detach()).abs()
        assert diff.max() <= 2 * lr, (name, float(diff.max()))
        assert (diff > 0.1 * lr).float().mean() <= 1e-3, name


def close_moments(opt, model, want_mu, want_nu, rel=1e-3):
    """Each parameter's exp_avg and exp_avg_sq within rel * its max of
    JAX's (given as modules of the port's layout) after the same step, or
    1e-6 of the largest moment of its kind: a parameter whose gradient is
    ~0 (a conv bias before an InstanceNorm) holds rounding noise alone."""
    want = {"exp_avg": dict(want_mu.named_parameters()),
            "exp_avg_sq": dict(want_nu.named_parameters())}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in opt.param_groups for p in group["params"]]
    assert params
    for key, refs in want.items():
        floor = 1e-6 * max(float(refs[names[id(p)]].abs().max())
                           for p in params)
        for p in params:
            name = names[id(p)]
            ref = refs[name].detach()
            err = (opt.state[p][key].float() - ref).abs().max()
            assert err <= rel * ref.abs().max() + floor, (
                name, key, float(err), float(ref.abs().max()))


# ---------------------------------------------------------------------------
# RADTTS: model_<it>.npz
# ---------------------------------------------------------------------------


def _jax_run(tmp_path, state_dtype):
    """JAX: 2 steps, save_checkpoint, its own resume, 1 more step. Returns
    (checkpoint path, saved optimizer state, final params, final state)."""
    params = jax_params(seed=1)
    batch = {k: jnp.asarray(v) for k, v in make_batch(seed=4).items()}
    optimizer = jax_build_optimizer("RAdam", LR, 1e-2, 1.0, state_dtype)
    mask = jax_mask(params, "all", ())
    step = make_train_step(MODEL_CONFIG, LOSS_WEIGHTS, 1.0, optimizer, mask)
    template = optimizer.init(params)
    opt_state = template
    for _ in range(2):
        params, opt_state, _, _, _ = step(params, opt_state, batch, None,
                                          False, False)
    path = str(tmp_path / "model_1")
    save_checkpoint(path, params, opt_state, 1, LR)
    saved = opt_state
    params, opt_state, meta = jax_resume(path + ".npz", jax_params(seed=2),
                                         template, MODEL_CONFIG)
    assert meta["iteration"] == 1
    params, opt_state, _, _, _ = step(params, opt_state, batch, None, False,
                                      False)
    return path + ".npz", saved, params, opt_state


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_radtts_resume_from_jax_npz(tmp_path, state_dtype):
    """The port's load_train_checkpoint of JAX's .npz fills every trainable
    parameter's moments with JAX's, exactly (bf16 moments stay bf16) and
    the count (RAdam's step 3 follows); then one step from there agrees
    with JAX's own resume and step: parameters by test_torch_train_step's
    rule, each moment within 1e-3 of its max."""
    path, saved, want_params, want_state = _jax_run(tmp_path, state_dtype)
    model = radtts_train_from_jax(np_tree(jax_params(seed=2)), MODEL_CONFIG)
    trainable = apply_trainable_mask(model, build_trainable_mask(model))
    opt = build_optimizer(trainable, "RAdam", LR, 1e-2, state_dtype)
    meta = load_train_checkpoint(path, model, opt, MODEL_CONFIG)
    assert meta["iteration"] == 1
    dtype = torch.bfloat16 if state_dtype else torch.float32
    saved_mu = radtts_train_from_jax(np_tree(saved[1].mu), MODEL_CONFIG)
    mu = dict(saved_mu.named_parameters())
    names = {id(p): n for n, p in model.named_parameters()}
    for p in trainable:
        st = opt.state[p]
        assert st["step"] == 2 and st["exp_avg"].dtype == dtype
        assert torch.equal(st["exp_avg"].float(), mu[names[id(p)]].detach())
    train_step(model, opt, trainable, to_torch(make_batch(seed=4)),
               MODEL_CONFIG, LOSS_WEIGHTS, 1.0, False, False, 1.0)
    close_params(model, radtts_train_from_jax(np_tree(want_params),
                                              MODEL_CONFIG), LR)
    close_moments(opt, model,
                  radtts_train_from_jax(np_tree(want_state[1].mu),
                                        MODEL_CONFIG),
                  radtts_train_from_jax(np_tree(want_state[1].nu),
                                        MODEL_CONFIG))


def test_moments_that_cannot_be_carried_raise():
    """Where the port's parameter is not an elementwise relabelling of a
    JAX leaf (here the duration DAP's inference form, whose weight-normed
    convs and spectral-normed LSTM are folded at load), the carry raises,
    naming the parameter."""
    cfg = MODEL_CONFIG["dur_model_config"]
    dap = np_tree(attribute_model_init(jax.random.PRNGKey(3), cfg))
    folded = attribute_from_jax(dap, cfg).requires_grad_(True)
    emap = element_map(lambda t: attribute_from_jax(t, cfg), dap)
    lost = [n for n, v in emap.items() if v is None]
    assert "bottleneck.proj.weight" in lost, lost
    opt = build_optimizer(list(folded.parameters()), "RAdam", LR, 0.0)
    with pytest.raises(ValueError, match=r"moments into bottleneck\.proj"):
        optimizer_state_from_jax(opt, folded.named_parameters(), emap, 2,
                                 dap, dap)
    factored = element_map(
        lambda t: attribute_from_jax(t, cfg, factored=True), dap)
    assert all(v is not None for v in factored.values())
