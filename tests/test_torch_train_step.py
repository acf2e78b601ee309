"""Whole training steps of the port against the JAX package's
make_train_step on the CPU (dropout off on both sides): the power
iteration, the forward and losses across the curriculum, the global-norm
clip over the trainable gradients, RAdam (both of its branches) or Adam,
and the trainable mask; then the optimizers' own update math on fixed
gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from radtts_tpu.train.optim import radam as jax_radam
from radtts_tpu.train.optim import torch_adam as jax_adam
from radtts_tpu.train.optim import build_optimizer as jax_build_optimizer
from radtts_tpu.train.trainer import build_trainable_mask as jax_mask
from radtts_tpu.train.trainer import make_train_step
from tests.small_model import MODEL_CONFIG
from tests.test_torch_synthesizer_parity import np_tree
from tests.test_torch_train_forward import (LOSS_WEIGHTS, jax_params,
                                            make_batch, to_torch)

from radtts_tpu_torch.convert import radtts_train_from_jax
from radtts_tpu_torch.train.optim import (Adam, RAdam, build_optimizer,
                                          clip_grad_norm)
from radtts_tpu_torch.train.trainer import (apply_trainable_mask,
                                            build_trainable_mask,
                                            train_step)

# (binarize, use_kl) of each step: across both curriculum points; RAdam's
# rectified branch starts at step 6
CURRICULUM = [(False, False), (False, False), (True, False), (True, False),
              (True, True), (True, True)]
LR = 1e-3


def run_both(optim_algo, unfreeze, curriculum):
    params = jax_params(seed=1)
    batch = make_batch(seed=4)
    optimizer = jax_build_optimizer(optim_algo, LR, 1e-2, 1.0)
    mask = jax_mask(params, unfreeze, ())
    step = make_train_step(MODEL_CONFIG, LOSS_WEIGHTS, 1.0, optimizer, mask)
    opt_state = optimizer.init(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    model = radtts_train_from_jax(np_tree(params), MODEL_CONFIG)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainable = apply_trainable_mask(
        model, build_trainable_mask(model, unfreeze))
    opt = build_optimizer(trainable, optim_algo, LR, 1e-2)
    tb = to_torch(batch)
    records = []
    for binarize, use_kl in curriculum:
        params, opt_state, total, _, gnorm = step(params, opt_state, jb,
                                                  None, binarize, use_kl)
        p_total, _, p_gnorm = train_step(model, opt, trainable, tb,
                                         MODEL_CONFIG, LOSS_WEIGHTS, 1.0,
                                         binarize, use_kl, 1.0)
        records.append((float(total), float(p_total), float(gnorm),
                        float(p_gnorm)))
    want = radtts_train_from_jax(np_tree(params), MODEL_CONFIG)
    return model, want, start, records, trainable


@pytest.mark.parametrize("optim_algo,unfreeze,curriculum", [
    ("RAdam", "all", CURRICULUM),
    ("Adam", "durf0energyvpred", CURRICULUM[-2:])])
def test_train_steps_match_jax(optim_algo, unfreeze, curriculum):
    """Losses and pre-clip grad norms within 1e-4 relative at every step
    (the norm is ~10, so the clip to 1.0 acts). After the steps every
    parameter within 2 lr of JAX's, and at most 1e-3 of its elements more
    than 0.1 lr apart: the rectified step is ~lr * sign(m), so an element
    whose gradient is ~0 may take the other sign in the other framework.
    The spectral norms' vectors within 1e-5. Frozen parameters unchanged,
    bit for bit."""
    model, want, start, records, trainable = run_both(optim_algo, unfreeze,
                                                      curriculum)
    for j_total, p_total, j_gn, p_gn in records:
        np.testing.assert_allclose(p_total, j_total, rtol=1e-4)
        np.testing.assert_allclose(p_gn, j_gn, rtol=1e-4)
        assert j_gn > 1.0
    want_sd = want.state_dict()
    trainable_ids = {id(p) for p in trainable}
    n_frozen = 0
    for name, p in model.named_parameters():
        got, ref = p.detach(), want_sd[name]
        diff = (got - ref).abs()
        assert diff.max() <= 2 * LR, (name, float(diff.max()))
        assert (diff > 0.1 * LR).float().mean() <= 1e-3, name
        if id(p) not in trainable_ids:
            n_frozen += 1
            assert torch.equal(got, start[name]), name
    assert (n_frozen > 0) == (unfreeze != "all")
    for name, buf in model.named_buffers():
        if name.endswith(("sn_u", "sn_v")):
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                       atol=1e-5, err_msg=name)
            assert not torch.equal(buf, start[name]), name


@pytest.mark.parametrize("name", ["RAdam", "Adam"])
def test_optimizer_update_math_matches_jax(name):
    """Twelve updates on fixed gradients (RAdam's rectified branch from
    step 6), weight decay on, the clip at 1.0 before each: parameters
    within 1e-6 relative of optax's chain."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.7 for s in shapes]
             for _ in range(12)]
    make = jax_radam if name == "RAdam" else jax_adam
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     make(1e-2, weight_decay=0.1))
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = (RAdam if name == "RAdam" else Adam)(tp, lr=1e-2,
                                               weight_decay=0.1)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        clip_grad_norm(tp, 1.0)
        opt.step()
    for got, ref in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7)


def test_optimizer_refuses_reduced_state():
    """Moments in float32 or bfloat16 only (bfloat16:
    tests/test_torch_amp.py)."""
    for dtype in ("float16", torch.float16, "int8"):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            RAdam([torch.nn.Parameter(torch.zeros(2))], state_dtype=dtype)


def test_trainable_mask_names():
    """unfreeze_modules and finetune_layers on the port's names."""
    model = radtts_train_from_jax(np_tree(jax_params()), MODEL_CONFIG)
    mask = build_trainable_mask(model, "durf0energyvpred")
    on = {k.split(".")[0] for k, v in mask.items() if v}
    assert on == {"dur_pred_layer", "f0_pred_module", "energy_pred_module",
                  "v_pred_module", "v_embeddings"}
    mask = build_trainable_mask(model, "all", ["flows.1."])
    assert all(k.startswith("flows.1.") for k, v in mask.items() if v)
    assert any(mask.values())
    assert not any("sn_u" in k or k.endswith(".p") for k in mask)
