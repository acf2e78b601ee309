"""The port's generative attribute predictors against the JAX package's on
the CPU: BGAP (bgap_forward, bgap_infer) and AGAP (agap_forward,
agap_infer, with the JAX lax.scan of ar_step_infer against the port's
ar_scan_plain), at small widths, over ragged batches, from the same
JAX-initialised parameters and numpy inputs; and the host side of the
ar_scan kernel's interface (csrc/ar_scan.cu runs only on the card, where
chip_smoke.py holds it against ar_scan_plain)."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.attributes import (agap_forward, agap_infer,
                                          ar_step_infer, attribute_model_init,
                                          bgap_forward, bgap_infer)
from radtts_tpu.ops.lstm import unroll_scope
from tests.test_torch_synthesizer_parity import np_tree

from radtts_tpu_torch.convert import attribute_from_jax
from radtts_tpu_torch.models import attributes as tattr
from radtts_tpu_torch.ops import ar_scan as ar_mod

BOTTLENECK = {"in_dim": 64, "reduction_factor": 16, "norm": "weightnorm",
              "non_linearity": "leakyrelu", "use_partial_padding": True,
              "kernel_size": 1}
BGAP_CFG = {"name": "bgap", "hparams": {
    "n_in_dim": 2, "take_log_of_input": False, "n_speaker_dim": 8,
    "n_flows": 2, "n_group_size": 2, "n_layers": 2, "kernel_size": 5,
    "scaling_fn": "tanh", "with_dilation": True,
    "bottleneck_hparams": BOTTLENECK, "n_bins": 4, "use_quadratic": True,
    "n_spline_steps": 1}}
AGAP_CFG = {"name": "agap", "hparams": {
    "n_in_dim": 1, "n_group_size": 1, "take_log_of_input": False,
    "n_speaker_dim": 8, "n_flows": 2, "n_hidden": 16, "n_lstm_layers": 1,
    "scaling_fn": "tanh",
    "bottleneck_hparams": dict(BOTTLENECK, non_linearity="relu",
                               kernel_size=3),
    "spline_flow_params": {"n_in_channels": 1, "n_context_dim": 16,
                           "n_layers": 2, "n_bins": 4,
                           "use_quadratic": True}}}


@pytest.fixture(autouse=True)
def _fast_compiles():
    """The JAX scans traced unrolled once, not eight times: the same
    numbers, a fraction of the compile time."""
    with unroll_scope(1):
        yield


def agap_variant(head, layers=1, g=1):
    """AGAP_CFG with another head ("quadratic", "linear", "affine"), stacked
    LSTM depth and group size."""
    cfg = copy.deepcopy(AGAP_CFG)
    hp = cfg["hparams"]
    hp.update(n_lstm_layers=layers, n_group_size=g)
    if head == "affine":
        hp["spline_flow_params"] = None
    else:
        hp["spline_flow_params"]["use_quadratic"] = head == "quadratic"
    return cfg


def perturb(tree, seed, sd=0.1):
    """Draw every zero-initialised last layer (SimpleConvNet "last", the
    AR affine head's "conv") at sd, in place."""
    rng = np.random.default_rng(seed)

    def draw(node):
        for k in ("w", "b"):
            node[k] = jnp.asarray(rng.normal(0, sd, node[k].shape)
                                  .astype(np.float32))

    def walk(node):
        if isinstance(node, dict):
            for key in ("last", "conv"):
                if key in node and isinstance(node[key], dict) \
                        and "w" in node[key]:
                    draw(node[key])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(tree)
    return tree


def build(cfg, seed=0):
    params = perturb(attribute_model_init(jax.random.PRNGKey(seed), cfg),
                     seed + 1)
    return params, attribute_from_jax(np_tree(params), cfg)


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def rel(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach()), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


T = 24
LENS = np.array([24, 17, 9])       # ragged; odd lengths under grouping


def inputs(n_in, seed=3):
    txt = rnd((3, T, 64), seed)
    spk = rnd((3, 8), seed + 1)
    x = rnd((3, T, n_in), seed + 2)
    x[np.arange(T)[None, :] >= LENS[:, None]] = 0.0
    return txt, spk, x


def test_bgap_forward_and_infer_match_jax():
    """bgap_forward's z, log_s_list and log_det_W_list and bgap_infer (full
    length and ragged) within 1e-4 * max; the port's inverse of its own
    z gives x back on the valid frames."""
    params, mod = build(BGAP_CFG)
    txt, spk, x = inputs(2)
    j = [jnp.asarray(a) for a in (txt, spk, x, LENS)]
    t = [torch.from_numpy(a) for a in (txt, spk, x, LENS)]
    want = bgap_forward(params, *j)
    got = tattr.bgap_forward(mod, *t)
    rel(got["z"], want["z"])
    for a, b in zip(got["log_s_list"], want["log_s_list"]):
        rel(a, b)
    for a, b in zip(got["log_det_W_list"], want["log_det_W_list"]):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)
    z = rnd((3, T, 2), 9)
    for lens in (None, LENS):
        jl = None if lens is None else jnp.asarray(lens)
        tl = None if lens is None else torch.from_numpy(lens)
        rel(tattr.bgap_infer(mod, torch.from_numpy(z), t[0], t[1], tl),
            bgap_infer(params, jnp.asarray(z), j[0], j[1], jl))
    back = tattr.bgap_infer(mod, tattr.fold_group(got["z"], 2), t[0], t[1],
                            t[3])
    valid = np.arange(T)[None, :] < (LENS // 2 * 2)[:, None]
    np.testing.assert_allclose(back.numpy()[valid], x[valid], atol=1e-4)


@pytest.mark.parametrize("head,layers", [("quadratic", 1), ("linear", 2),
                                         ("affine", 1)])
def test_ar_scan_plain_matches_jax_scan(head, layers):
    """ar_scan_plain (through ar_step_infer) against the JAX lax.scan of
    ar_step_infer, per head kind, with one and two stacked layers."""
    cfg = agap_variant(head, layers)
    params, mod = build(cfg, seed=4)
    ctx, res = rnd((3, T, 12), 5), rnd((3, T, 1), 6)
    want = ar_step_infer(params["flows"][0], jnp.asarray(res),
                         jnp.asarray(ctx), "tanh")
    got = tattr.ar_step_infer(mod.flows[0], torch.from_numpy(res),
                              torch.from_numpy(ctx), "tanh")
    rel(got, want)
    assert np.abs(got.numpy() - res).max() > 1e-2   # the step acts


@pytest.mark.parametrize("g", [1, 2])
def test_agap_forward_and_infer_match_jax(g):
    """agap_forward (teacher-forced, ragged lengths, the back step over
    each item's valid frames reversed) and agap_infer, full length and
    ragged (with g=2 a grouped truncation is reflect-padded), within
    1e-4 * max; the inverse of the port's z gives x back within 1e-3 *
    max (the sequential inverse feeds each frame's rounding into the
    next frame's input)."""
    cfg = agap_variant("quadratic", 1, g)
    params, mod = build(cfg, seed=7)
    txt, spk, x = inputs(1, seed=8)
    j = [jnp.asarray(a) for a in (txt, spk, x, LENS)]
    t = [torch.from_numpy(a) for a in (txt, spk, x, LENS)]
    want = agap_forward(params, *j)
    got = tattr.agap_forward(mod, *t)
    rel(got["z"], want["z"])
    for a, b in zip(got["log_s_list"], want["log_s_list"]):
        rel(a, b)
    z = rnd((3, T - 1, 1), 10)    # T - 1: odd under g = 2
    for lens in (None, LENS - 1):
        jl = None if lens is None else jnp.asarray(lens)
        tl = None if lens is None else torch.from_numpy(lens)
        rel(tattr.agap_infer(mod, torch.from_numpy(z), t[0][:, :T - 1],
                             t[1], tl),
            agap_infer(params, jnp.asarray(z), j[0][:, :T - 1], j[1], jl))
    back = tattr.agap_infer(mod, tattr.fold_group(got["z"], g), t[0], t[1],
                            t[3])
    valid = np.arange(T)[None, :] < (LENS // g * g)[:, None]
    np.testing.assert_allclose(back.numpy()[valid], x[valid],
                               atol=1e-3 * np.abs(x).max())


def test_ar_scan_pack_follows_the_weights():
    """The packed weights are those of the model at hand: after an in-place
    update, and for a second model built where the first was freed (the
    allocator may hand it the same addresses)."""
    _, mod = build(agap_variant("quadratic", 2), seed=2)

    def head_last(m):
        return m.flows[0].scan_params("tanh")["head"][-1][0]

    def packed_head_last(m):
        p = m.flows[0].scan_params("tanh")
        weights, offsets = ar_mod.pack(p)
        w = head_last(m)
        start = offsets[f"w_head{len(p['head']) - 1}"]
        return weights[start:start + w.numel()].reshape(w.shape)

    packed_head_last(mod)
    with torch.no_grad():
        head_last(mod).add_(0.5)
    np.testing.assert_array_equal(packed_head_last(mod).numpy(),
                                  head_last(mod).numpy())
    # new values at the same address and the same version, as a model
    # allocated where a freed one was
    version = head_last(mod)._version
    head_last(mod).data.add_(0.25)
    assert head_last(mod)._version == version
    np.testing.assert_array_equal(packed_head_last(mod).numpy(),
                                  head_last(mod).numpy())
    with torch.inference_mode():                        # as when serving
        models = [build(agap_variant("quadratic", 2), seed=3)[1]]
        first = packed_head_last(models[0]).clone()
        models.clear()
        models.append(build(agap_variant("quadratic", 2), seed=4)[1])
        got = packed_head_last(models[0])
        np.testing.assert_array_equal(got.numpy(),
                                      head_last(models[0]).numpy())
    assert not np.array_equal(got.numpy(), first.numpy())


def test_ar_scan_interface():
    """The packing the kernel reads, its limits by name, and the CPU path
    launching nothing."""
    params, mod = build(agap_variant("quadratic", 2), seed=2)
    p = mod.flows[0].scan_params("tanh")
    weights, offsets = ar_mod.pack(p)
    H = 16
    w_attr = weights[offsets["w_lstm0"]:offsets["w_lstm0"] + 4 * H * 17]
    np.testing.assert_array_equal(
        w_attr.reshape(4 * H, 17).numpy(),
        torch.cat(p["attr"][:2], dim=1).numpy())
    assert all(v % 4 == 0 for v in offsets.values())
    icfg, fcfg, n_scratch, kmax, nq = ar_mod.config(p, offsets, 3, T, 1, H)
    assert len(icfg) == ar_mod.N_SCALARS + 2 * (ar_mod.MAX_LAYERS + 1) \
        + 6 * ar_mod.MAX_HEAD
    assert icfg[:10] == [3, T, 1, H, 2, 0, 0, 9, 3, 64]  # no scaling
    assert icfg[ar_mod.N_SCALARS + ar_mod.MAX_LAYERS + 2] == -1  # layer 0
    assert fcfg == [-6.0, 6.0, -6.0, 6.0] and nq == 9
    assert n_scratch == 3 * 3 * 3 * H + 3 * (32 + 64 + 9)
    assert ar_mod.macs_per_frame(p, 1) == 4 * H * (17 + 2 * H + 2 * H) \
        + 32 * 16 + 64 * 32 + 9 * 64
    bad = dict(p, kind="cubic")
    with pytest.raises(ValueError, match="head kind"):
        ar_mod.check_shapes(bad, 3, T, 1, H)
    with pytest.raises(ValueError, match="n_lstm_layers"):
        ar_mod.check_shapes(dict(p, lstm=p["lstm"] * 3), 3, T, 1, H)
    with pytest.raises(ValueError, match="spline bins"):
        ar_mod.check_shapes(dict(p, n_bins=301), 3, T, 1, H)
    before = ar_mod.ar_scan.launches
    ctx = torch.zeros(3, T, 4 * H)
    out = ar_mod.ar_scan(p, torch.zeros(3, T, 1), ctx)
    assert out.shape == (3, T, 1) and ar_mod.ar_scan.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        ar_mod.ar_scan(p, torch.zeros(3, T, 1, device="meta"), ctx)
