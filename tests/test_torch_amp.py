"""Mixed precision in the port against the JAX package on the CPU, on the
small test config: the bf16 regions (radtts_tpu_torch/ops/amp.py) take and
give the dtypes the JAX package's do under amp.scope(True); the decode and
a training step under AMP; the bf16 conv-kernel storage (the fold's dtype
layout, the conv semantics, the decode); RAdam and Adam with bf16 moments;
and the Synthesizer's flags.

Reduced precision is held by distance, not by fp32 tolerances: the port's
AMP output may be no further from the JAX package's AMP output than twice
the JAX package's own AMP-vs-fp32 distance on the same input, or a floor
stated with each test. bf16 rounds to 8 bits of mantissa; torch and XLA
accumulate in different orders, so an output element near a rounding
boundary lands on either side.
"""

import collections
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import lax

from radtts_tpu.models.radtts import infer_durations as jax_infer_durations
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.ops import amp as jax_amp
from radtts_tpu.ops.conv import conv1d_apply as jax_conv1d_apply
from radtts_tpu.ops.fold_norms import fold_norms as jax_fold_norms
from radtts_tpu.ops.invertible import precompute_inverses
from radtts_tpu.train.optim import radam as jax_radam
from radtts_tpu.train.optim import torch_adam as jax_adam
from tests.small_model import MODEL_CONFIG
from tests.test_torch_checkpoint import ljs_small_config
from tests.test_torch_radtts import IN_LENS, SPK, TEXT
from tests.test_torch_synthesizer_parity import (_converge_spectral_norms,
                                                 np_tree)
from tests.test_torch_train_forward import (LOSS_WEIGHTS, jax_loss,
                                            jax_params, make_batch, to_torch)

from radtts_tpu_torch.convert import radtts_from_jax, radtts_train_from_jax
from radtts_tpu_torch.models import attributes as port_attributes
from radtts_tpu_torch.models import coupling as port_coupling
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.ops import amp
from radtts_tpu_torch.ops.conv import conv1d
from radtts_tpu_torch.ops.fold_norms import (conv_weight_bytes,
                                             store_conv_weights)
from radtts_tpu_torch.ops.lstm import MaskedLSTM
from radtts_tpu_torch.train.optim import Adam, RAdam, clip_grad_norm
from radtts_tpu_torch.train.trainer import compute_loss

BF16, F32 = "bfloat16", "float32"


def _perturbed(cfg, seed=0, sd=0.02):
    """radtts_init's tree with converged spectral norms (random ones make
    the LSTMs chaotic, and bf16 rounding then moves the durations by
    whole frames) and the (zero at init) WN end convs drawn, so that the
    decode through the flows is not vacuous."""
    params = _converge_spectral_norms(
        radtts_init(jax.random.PRNGKey(seed), copy.deepcopy(cfg)))
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, sd, end["w"].shape).astype(np.float32))
    return params


@pytest.fixture(scope="module")
def models():
    params = _perturbed(MODEL_CONFIG)
    return params, radtts_from_jax(np_tree(params), MODEL_CONFIG)


def _decode_inputs(seed=1):
    rng = np.random.default_rng(seed)
    dur = rng.integers(1, 4, TEXT.shape).astype(np.int32)
    dur[1, IN_LENS[1]:] = 0
    max_frames = ((int(dur.sum(1).max()) + 31) // 32) * 32
    g, n_mel = MODEL_CONFIG["n_group_size"], MODEL_CONFIG["n_mel_channels"]
    residual = (0.8 * rng.standard_normal(
        (TEXT.shape[0], max_frames // g, n_mel * g))).astype(np.float32)
    vm = (rng.random((TEXT.shape[0], max_frames)) > 0.3).astype(np.float32)
    return dur, max_frames, residual, vm


def _jax_decode(params, use_amp, dur, max_frames, residual, vm):
    with jax_amp.scope(use_amp):
        out = jax_radtts_infer(
            params, jax.random.PRNGKey(1), jnp.asarray(SPK),
            jnp.asarray(TEXT), 0.8, max_frames, dur=jnp.asarray(dur),
            residual=jnp.asarray(residual), voiced_mask=jnp.asarray(vm),
            in_lens=jnp.asarray(IN_LENS))
    return {k: np.asarray(out[k]) for k in ("mel", "f0", "energy_avg")}


def _port_decode(model, use_amp, dur, max_frames, residual, vm):
    with torch.no_grad(), amp.scope(model, use_amp):
        out = port.radtts_infer(
            model, torch.as_tensor(SPK), torch.as_tensor(TEXT), 0.8,
            max_frames, dur=torch.as_tensor(dur),
            residual=torch.as_tensor(residual),
            voiced_mask=torch.as_tensor(vm),
            in_lens=torch.as_tensor(IN_LENS))
    return {k: out[k].numpy() for k in ("mel", "f0", "energy_avg")}


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# the regions' dtypes
# ---------------------------------------------------------------------------


def _record(monkeypatch, owners, fn_name, log, kind):
    for owner in owners:
        real = getattr(owner, fn_name)

        def spy(x, *args, _real=real):
            y = _real(x, *args)
            log[(kind, str(x.dtype).split(".")[-1],
                 str(y.dtype).split(".")[-1])] += 1
            return y
        monkeypatch.setattr(owner, fn_name, spy)


@pytest.mark.parametrize("path", ["decode", "train_forward"])
def test_region_dtypes_match_jax(models, monkeypatch, path):
    """Under AMP every region is entered as bf16 and left as fp32, at the
    same sites as the JAX package's amp.cast_in / cast_out (counted by
    (site kind, dtype in, dtype out)); without AMP nothing is cast; the
    outputs outside the regions stay fp32."""
    params, model = models
    batch = make_batch()
    j_log, p_log = collections.Counter(), collections.Counter()
    _record(monkeypatch, [jax_amp], "cast_in", j_log, "in")
    _record(monkeypatch, [jax_amp], "cast_out", j_log, "out")
    owners = [port, port_coupling, port_attributes]
    _record(monkeypatch, owners, "cast_in", p_log, "in")
    _record(monkeypatch, owners, "cast_out", p_log, "out")
    if path == "decode":
        inputs = _decode_inputs()
        for use_amp in (False, True):
            j_log.clear(), p_log.clear()
            jout = _jax_decode(params, use_amp, *inputs)
            pout = _port_decode(model, use_amp, *inputs)
            assert pout["mel"].dtype == jout["mel"].dtype == np.float32
            want = {k: v for k, v in j_log.items()}
            assert p_log == want, (dict(p_log), want)
            assert (sum(v for k, v in want.items() if k[1] != k[2]) > 0
                    ) == use_amp
    else:
        train_model = radtts_train_from_jax(np_tree(params), MODEL_CONFIG)
        with jax_amp.scope(True):
            total, _ = jax_loss(params, batch, True, True)
        with amp.scope(train_model, True):
            p_total, _, _ = compute_loss(train_model, to_torch(batch),
                                         MODEL_CONFIG, LOSS_WEIGHTS, 1.0,
                                         True, True)
        assert p_total.dtype == torch.float32
        assert p_log == j_log and j_log[("in", F32, BF16)] > 0, (
            dict(p_log), dict(j_log))
    # the marks are put back
    assert not any(m.amp for m in amp.regions(model))


def test_region_dtypes_inside(models):
    """Inside a region the convs and the recurrences run in bf16 (weights
    follow x); outside, the text encoder and the 1x1 convs stay fp32."""
    _, model = models
    seen = collections.defaultdict(set)
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, (MaskedLSTM, port_coupling.ConvNorm,
                          torch.nn.Linear)):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: seen[name].add(out.dtype)))
    try:
        _port_decode(model, True, *_decode_inputs())
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(len(v) == 1 for v in seen.values())
    for name, (dtype,) in seen.items():
        island = name.startswith(("encoder", "unvoiced_bias"))
        in_region = (".pred." in name or name.startswith("context_lstm")
                     or ".feat." in name)
        if island or not in_region:
            assert dtype == torch.float32, name
        else:
            assert dtype == torch.bfloat16, name
    assert any(v == {torch.bfloat16} for k, v in seen.items()
               if "lstm" in k)


# ---------------------------------------------------------------------------
# AMP decode and training step against JAX's AMP
# ---------------------------------------------------------------------------


def test_amp_decode_matches_jax(models):
    """Mel under AMP: the port within 2x the JAX package's own AMP-vs-fp32
    distance of JAX's AMP mel (floor 1e-3 of the mel's scale); the DAP
    features within the same rule; the fp32 pair as close as the fp32
    parity tests hold it. The durations' raw predictions likewise."""
    params, model = models
    inputs = _decode_inputs()
    j32, j16 = (_jax_decode(params, a, *inputs) for a in (False, True))
    p32, p16 = (_port_decode(model, a, *inputs) for a in (False, True))
    assert _dist(p32["mel"], j32["mel"]) <= 1e-3
    for key in ("mel", "f0", "energy_avg"):
        scale = float(np.abs(j32[key]).max())
        jd = _dist(j16[key], j32[key])
        assert jd > 0, key                     # AMP acted on the JAX side
        assert _dist(p16[key], j32[key]) > 0, key
        assert _dist(p16[key], j16[key]) <= max(2 * jd, 1e-3 * scale), (
            key, _dist(p16[key], j16[key]), jd, scale)

    text, spk = torch.as_tensor(TEXT), torch.as_tensor(SPK)
    lens = torch.as_tensor(IN_LENS)

    def port_dur(use_amp):
        with torch.no_grad(), amp.scope(model, use_amp):
            enc, _ = port.encode_text(model, text, lens)
            raw = port.attribute_model_infer(
                model.dur_pred_layer, enc, port.encode_speaker(model, spk),
                lens)
        return raw[..., 0].numpy()

    def jax_dur(use_amp):
        from radtts_tpu.models.attributes import attribute_model_infer
        from radtts_tpu.models.radtts import encode_speaker, encode_text
        with jax_amp.scope(use_amp):
            enc, _ = encode_text(params, jnp.asarray(TEXT),
                                 jnp.asarray(IN_LENS))
            raw = attribute_model_infer(
                params["dur_pred_layer"], None, enc,
                encode_speaker(params, jnp.asarray(SPK)),
                jnp.asarray(IN_LENS))
        return np.asarray(raw[..., 0], np.float32)

    jd = _dist(jax_dur(True), jax_dur(False))
    scale = float(np.abs(jax_dur(False)).max())
    assert jd > 0
    assert _dist(port_dur(True), jax_dur(True)) <= max(2 * jd, 1e-3 * scale)
    # the integer durations follow from these as in fp32
    with jax_amp.scope(True):
        want = np.asarray(jax_infer_durations(
            params, jax.random.PRNGKey(0), jnp.asarray(SPK),
            jnp.asarray(TEXT), in_lens=jnp.asarray(IN_LENS)))
    with torch.no_grad(), amp.scope(model, True):
        got = port.infer_durations(model, spk, text, in_lens=lens).numpy()
    frac = port_dur(True) - np.floor(port_dur(True))
    clear = np.abs(frac - 0.5) > 2 * max(jd, 1e-3)
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.fixture(scope="module")
def amp_step():
    """Loss and gradients of one binarized training step, JAX fp32, JAX
    AMP and the port's AMP, from the same weights and batch."""
    params = jax_params()
    batch = make_batch()
    runs = {}
    for use_amp in (False, True):
        def loss(p, b):
            with jax_amp.scope(use_amp):
                return jax_loss(p, b, True, True)
        (total, (scalars, _)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params, batch)
        runs[use_amp] = (float(total), jax.device_get(scalars),
                         dict(radtts_train_from_jax(
                             np_tree(grads), MODEL_CONFIG).named_parameters()))
    model = radtts_train_from_jax(np_tree(params), MODEL_CONFIG)
    with amp.scope(model, True):
        total, loss_dict, _ = compute_loss(model, to_torch(batch),
                                           MODEL_CONFIG, LOSS_WEIGHTS, 1.0,
                                           True, True)
    total.backward()
    return runs, model, float(total.detach()), loss_dict


def test_amp_train_step_losses_match_jax(amp_step):
    """Each loss within 2x JAX's AMP-vs-fp32 distance of JAX's AMP loss
    (floor 1e-3 of its magnitude: the mel losses sum bf16-rounded log_s
    over every frame, and JAX's own AMP moved them by less than 2e-5)."""
    runs, _, total, loss_dict = amp_step
    j32, j16 = runs[False], runs[True]
    assert abs(j16[0] - j32[0]) > 0
    for k, (v, _) in loss_dict.items():
        jd = abs(float(j16[1][k]) - float(j32[1][k]))
        floor = 1e-3 * max(abs(float(j32[1][k])), 1e-3)
        assert abs(float(v) - float(j16[1][k])) <= max(2 * jd, floor), (
            k, float(v), float(j16[1][k]), float(j32[1][k]))
    jd = abs(j16[0] - j32[0])
    assert abs(total - j16[0]) <= max(2 * jd, 1e-3 * abs(j32[0]))


def test_amp_train_step_gradients_match_jax(amp_step):
    """Per top-level module, the norm of the gradient's difference from
    JAX's AMP gradient within 2x that of JAX's AMP-vs-fp32 difference
    (floor 1e-3 of the module's gradient norm); JAX's AMP moved the
    gradients of every module it reaches."""
    runs, model, _, _ = amp_step
    g32, g16 = runs[False][2], runs[True][2]
    groups = collections.defaultdict(lambda: np.zeros(3))
    for name, p in model.named_parameters():
        got = (p.grad if p.grad is not None else torch.zeros_like(p))
        got = got.double().numpy()
        w16 = g16[name].detach().double().numpy()
        w32 = g32[name].detach().double().numpy()
        top = name.split(".")[0]
        groups[top] += [np.sum((got - w16) ** 2), np.sum((w16 - w32) ** 2),
                        np.sum(w32 ** 2)]
    moved = 0
    for top, (d_port, d_jax, norm) in groups.items():
        d_port, d_jax, norm = np.sqrt([d_port, d_jax, norm])
        moved += d_jax > 0
        assert d_port <= max(2 * d_jax, 1e-3 * norm), (top, d_port, d_jax,
                                                       norm)
    assert moved >= 5


# ---------------------------------------------------------------------------
# bf16 conv-kernel storage
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "_meta":
                yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif hasattr(tree, "dtype"):
        yield path, tree


@pytest.mark.parametrize("name", ["small", "ljs_shrunk"])
def test_bf16_fold_dtype_layout_matches_jax(name):
    """store_conv_weights(radtts_from_jax(tree)) holds bf16 exactly where
    the JAX package's fold_norms(..., bfloat16) does: the same number of
    bf16 conv kernels with the same shapes (torch's (C_out, C_in, K) for
    JAX's (K, C_in, C_out)), none under the text encoder, which keeps fp32
    kernels; everything else fp32. The bf16 values are the fp32 fold's,
    rounded once. Resident conv-kernel bytes halve outside the encoder."""
    cfg = MODEL_CONFIG if name == "small" else ljs_small_config()[
        "model_config"]
    params = radtts_init(jax.random.PRNGKey(0), copy.deepcopy(cfg))
    folded = jax_fold_norms(precompute_inverses(params),
                            matmul_dtype=jnp.bfloat16)
    want, enc_fp32 = collections.Counter(), 0
    for path, leaf in _leaves(folded):
        if leaf.dtype == jnp.bfloat16:
            assert path[-1] == "w" and leaf.ndim == 3 and \
                "encoder" not in path
            want[tuple(leaf.shape[::-1])] += 1
        elif path[-1] == "w" and leaf.ndim == 3:
            assert "encoder" in path, path
            enc_fp32 += 1
    model = radtts_from_jax(np_tree(params), cfg)
    ref = {k: v.clone() for k, v in model.state_dict().items()}
    before = conv_weight_bytes(model)
    store_conv_weights(model)
    got, enc = collections.Counter(), 0
    for k, v in model.state_dict().items():
        if v.dtype == torch.bfloat16:
            assert k.endswith(".weight") and v.ndim == 3 and \
                not k.startswith("encoder."), k
            got[tuple(v.shape)] += 1
            torch.testing.assert_close(v, ref[k].to(torch.bfloat16),
                                       rtol=0, atol=0)
        else:
            assert v.dtype in (torch.float32, torch.int64), k
            if k.startswith("encoder.") and v.ndim == 3:
                enc += 1
    assert got == want and sum(want.values()) > 10
    assert enc == enc_fp32 > 0
    enc_bytes = sum(m.weight.numel() * 4 for m in model.encoder.convs)
    assert conv_weight_bytes(model) == (before - enc_bytes) // 2 + enc_bytes


def test_bf16_weight_conv_semantics():
    """conv1d with a bf16 kernel and an fp32 activation computes
    conv(bf16(x), w) with fp32 sums and an fp32 output, as the JAX
    package's conv1d_apply does (preferred_element_type=float32): within
    fp32 rounding of JAX's and of the float64 conv of the bf16 operands,
    and not the bf16-rounded output a plain bf16 conv would give. Partial
    padding and the bias follow the same rule; the kernel stays bf16."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 37, 24)).astype(np.float32)
    w32 = rng.standard_normal((5, 24, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    mask = np.arange(37)[None, :] < np.array([37, 20])[:, None]
    w16j = jnp.asarray(w32).astype(jnp.bfloat16)
    w16 = torch.as_tensor(np.ascontiguousarray(w32.transpose(2, 1, 0))).to(
        torch.bfloat16)
    tx = torch.as_tensor(x)
    for partial in (False, True):
        want = np.asarray(jax_conv1d_apply(
            {"w": w16j, "b": jnp.asarray(b)}, jnp.asarray(x), padding=2,
            dilation=1, mask=jnp.asarray(mask) if partial else None,
            partial=partial))
        if partial:
            from radtts_tpu_torch.ops.conv import partial_conv1d
            got = partial_conv1d(tx, w16, torch.as_tensor(b), 2, 1,
                                 torch.as_tensor(mask))
        else:
            got = conv1d(tx, w16, torch.as_tensor(b), padding=2)
        assert got.dtype == torch.float32 and w16.dtype == torch.bfloat16
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xb = tx.to(torch.bfloat16).double()
    exact = torch.nn.functional.conv1d(
        xb.transpose(1, 2), w16.double(), torch.as_tensor(b).double(),
        padding=2).transpose(1, 2)
    got = conv1d(tx, w16, torch.as_tensor(b), padding=2)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5)
    rounded = exact.to(torch.bfloat16).double()
    assert (got.double() - rounded).abs().max() > 1e-3
    ref = lax.conv_general_dilated(
        jnp.asarray(x).astype(jnp.bfloat16), w16j, (1,), [(2, 2)],
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.float32) + jnp.asarray(b)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_amp", [False, True])
def test_bf16_weights_decode_matches_jax(models, use_amp):
    """The decode with bf16-stored conv kernels (with and without AMP):
    the port within 2x the JAX package's own bf16-vs-fp32 distance of
    JAX's bf16-weight mel (floor 1e-3 of the mel's scale)."""
    params, model = models
    inputs = _decode_inputs()
    jp16 = jax_fold_norms(precompute_inverses(params),
                          matmul_dtype=jnp.bfloat16)
    j32 = _jax_decode(params, False, *inputs)
    j16 = _jax_decode(jp16, use_amp, *inputs)
    p16 = _port_decode(store_conv_weights(copy.deepcopy(model)), use_amp,
                       *inputs)
    scale = float(np.abs(j32["mel"]).max())
    jd = _dist(j16["mel"], j32["mel"])
    assert jd > 0 and _dist(p16["mel"], j32["mel"]) > 0
    assert _dist(p16["mel"], j16["mel"]) <= max(2 * jd, 1e-3 * scale), (
        _dist(p16["mel"], j16["mel"]), jd, scale)


# ---------------------------------------------------------------------------
# bf16 optimizer moments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["RAdam", "Adam"])
def test_bf16_moments_match_jax(name):
    """Twelve updates on fixed gradients (RAdam's rectified branch from
    step 6), weight decay on, the clip at 1.0, the moments stored in
    bf16: the moments stay bf16 and equal JAX's, except where an fp32 sum
    taken in another order rounds to the neighbouring bf16 value (at most
    1 in 100 elements, one bf16 step apart); the parameters within 1e-5
    relative of optax's chain."""
    rng = np.random.default_rng(0)
    shapes = [(50, 30), (70,), (4, 6, 8)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.7 for s in shapes]
             for _ in range(12)]
    make = jax_radam if name == "RAdam" else jax_adam
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     make(1e-2, weight_decay=0.1, state_dtype=jnp.bfloat16))
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = (RAdam if name == "RAdam" else Adam)(tp, lr=1e-2, weight_decay=0.1,
                                               state_dtype="bfloat16")
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        clip_grad_norm(tp, 1.0)
        opt.step()
    for got, ref in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    moments = state[1]
    for p, mu, nu in zip(tp, moments.mu, moments.nu):
        st = opt.state[p]
        for key, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
            got = st[key]
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            got = got.float().numpy()
            want = np.asarray(want, np.float32)
            diff = np.abs(got - want)
            ulp = np.abs(want) * 2.0 ** -7 + 1e-30
            assert (diff <= ulp).all(), key
            assert (diff > 0).mean() <= 1e-2, key


def test_bf16_moments_halve_the_state_and_survive_a_reload():
    p = [torch.nn.Parameter(torch.ones(64, 8))]
    opt = RAdam(p, state_dtype="bfloat16")
    p[0].grad = torch.full_like(p[0], 0.5)
    opt.step()
    state = opt.state_dict()
    opt2 = RAdam([torch.nn.Parameter(torch.ones(64, 8))],
                 state_dtype="bfloat16")
    opt2.load_state_dict(state)
    for o in (opt, opt2):
        st = next(iter(o.state.values()))
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.bfloat16
        assert st["exp_avg"].element_size() * 2 == p[0].element_size()


# ---------------------------------------------------------------------------
# the Synthesizer's flags
# ---------------------------------------------------------------------------


def test_synthesizer_precision_flags(monkeypatch):
    """Synthesizer.from_parts(use_amp=True) runs the regions in bf16 and
    weight_dtype='bfloat16' stores a copy's conv kernels in bf16, leaving
    the caller's model fp32; the outputs are finite and differ from
    fp32's (test_amp_decode_matches_jax bounds by how much); 'auto' is
    fp32 and an unknown dtype is refused."""
    from tests.test_torch_synthesizer_parity import (CFG, DUR_BIAS, H_SMALL,
                                                     _audible_vocoder,
                                                     _encode)
    from radtts_tpu_torch.convert import hifigan_from_jax
    from radtts_tpu_torch.models.hifigan import denoiser_init
    from radtts_tpu_torch.synthesizer import Synthesizer

    params = _perturbed(CFG)
    dense = params["dur_pred_layer"]["feat"]["dense"]
    dense["b"] = jnp.full_like(dense["b"], DUR_BIAS["durations"])
    model = radtts_from_jax(np_tree(params), CFG)
    voc = hifigan_from_jax(np_tree(_audible_vocoder()), H_SMALL)
    with torch.no_grad():
        den = denoiser_init(voc)
    log = collections.Counter()
    _record(monkeypatch, [port_coupling], "cast_in", log, "in")

    def synth(**kw):
        return Synthesizer.from_parts(
            CFG, model, voc, den, encode_fn=_encode,
            speaker_id_fn=lambda n: 0, seed=3, device="cpu", **kw)

    text = "Mixed precision in the port."
    out = {}
    for key, kw in (("fp32", {}), ("amp", dict(use_amp=True)),
                    ("bf16", dict(weight_dtype="bfloat16"))):
        log.clear()
        s = synth(**kw)
        wavs, _ = s.synthesize(text, "spk", sigma=0.0)
        out[key] = wavs[0]
        assert np.isfinite(wavs[0]).all()
        assert (log[("in", F32, BF16)] > 0) == (key == "amp"), key
        bf16 = [p for p in s.model.parameters() if p.dtype == torch.bfloat16]
        assert bool(bf16) == (key == "bf16"), key
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for key in ("amp", "bf16"):
        n = min(len(out[key]), len(out["fp32"]))
        assert np.abs(out[key][:n] - out["fp32"][:n]).max() > 0, key
    assert Synthesizer.resolve_weight_dtype("auto") == F32
    with pytest.raises(ValueError, match="weight_dtype"):
        Synthesizer.resolve_weight_dtype("float16")
