"""Small RADTTS models whose f0 and energy come from BGAPs (with
first-order features, as config_ljs_bgap.json) or AGAPs (as
config_ljs_agap.json), held against the JAX package on the CPU: decode
with injected z_f0 / z_energy / residual, a flow duration model with
injected z_dur, the training forward and losses, the attribute modules'
gradients in float64, the checkpoint readers and the writer's key set,
and the synthesizer's sigmas. Every zero-initialised last layer is
perturbed on both sides; the DAPs' spectral norms are converged."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.convert import radtts_from_torch as jax_from_torch
from radtts_tpu.export import radtts_to_torch as jax_to_torch
from radtts_tpu.losses import attribute_prediction_loss as jax_attr_loss
from radtts_tpu.models.attributes import \
    attribute_model_forward as jax_attr_forward
from radtts_tpu.models.radtts import infer_durations as jax_infer_durations
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.ops.lstm import unroll_scope
from radtts_tpu.train.checkpoint import save_checkpoint
from tests.small_model import MODEL_CONFIG
from tests.test_torch_gap_models import (AGAP_CFG, BGAP_CFG, perturb, rel,
                                         rnd)
from tests.test_torch_synthesizer_parity import (_converge_spectral_norms,
                                                 np_tree)
from tests.test_torch_train_forward import (LOSS_WEIGHTS, jax_loss,
                                            make_batch, to_torch)

from radtts_tpu_torch.convert import (attribute_from_jax, radtts_from_jax,
                                      radtts_from_torch)
from radtts_tpu_torch.export import radtts_to_torch
from radtts_tpu_torch.losses import attribute_prediction_loss
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.models.attributes import attribute_model_forward
from radtts_tpu_torch.models.hifigan import Generator, denoiser_init
from radtts_tpu_torch.synthesizer import Synthesizer
from radtts_tpu_torch.train.checkpoint import load_radtts_for_inference
from radtts_tpu_torch.train.trainer import compute_loss


def gap_config(kind):
    """tests/small_model.py's model with BGAP or AGAP f0 and energy, set
    as the published configs set them."""
    cfg = copy.deepcopy(MODEL_CONFIG)
    if kind == "bgap":
        energy = copy.deepcopy(BGAP_CFG)
        energy["hparams"]["n_group_size"] = 4
        cfg.update(use_first_order_features=True, ap_use_unvoiced_bias=False,
                   f0_model_config=copy.deepcopy(BGAP_CFG),
                   energy_model_config=energy)
    else:
        cfg.update(use_first_order_features=False, ap_use_unvoiced_bias=True,
                   f0_model_config=copy.deepcopy(AGAP_CFG),
                   energy_model_config=copy.deepcopy(AGAP_CFG))
    return cfg


def jax_params(cfg, seed=0):
    params = perturb(_converge_spectral_norms(
        radtts_init(jax.random.PRNGKey(seed), cfg)), seed + 1)
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.02, end["w"].shape).astype(np.float32))
    return params


@pytest.fixture(autouse=True)
def _fast_compiles():
    """The JAX scans traced unrolled once, not eight times: the same
    numbers, a fraction of the compile time."""
    with unroll_scope(1):
        yield


@pytest.fixture(scope="module", params=["bgap", "agap"])
def case(request):
    cfg = gap_config(request.param)
    params = jax_params(cfg)
    return request.param, cfg, params, radtts_from_jax(np_tree(params), cfg)


TEXT = np.array([[12, 55, 3, 91, 140, 7, 33, 62, 18, 101, 77, 5],
                 [44, 9, 120, 66, 2, 150, 31, 8, 0, 0, 0, 0]], np.int64)
IN_LENS = np.array([12, 8])
SPK = np.array([0, 2])


def test_radtts_infer_matches_jax(case):
    """Decode of a padded batch of two with the same durations, z_f0,
    z_energy and residual: f0, energy and mel within 1e-4 * max; the flow
    attribute models act on their noise (f0 moves with z_f0)."""
    kind, cfg, params, model = case
    dur = np.random.default_rng(1).integers(1, 4, TEXT.shape).astype(
        np.int32)
    dur[1, 8:] = 0
    T = ((int(dur.sum(1).max()) + 31) // 32) * 32
    n_ch = 2 if kind == "bgap" else 1
    g, n_mel = cfg["n_group_size"], cfg["n_mel_channels"]
    z_f0, z_e = rnd((2, T, n_ch), 2, 0.8), rnd((2, T, n_ch), 3, 0.8)
    residual = rnd((2, T // g, n_mel * g), 4, 0.8)
    args = dict(dur=dur, residual=residual, z_f0=z_f0, z_energy=z_e,
                in_lens=IN_LENS)
    ref = jax_radtts_infer(params, jax.random.PRNGKey(1), jnp.asarray(SPK),
                           jnp.asarray(TEXT), 0.8, T,
                           **{k: jnp.asarray(v) for k, v in args.items()})
    targs = {k: torch.as_tensor(v) for k, v in args.items()}
    got = port.radtts_infer(model, torch.as_tensor(SPK),
                            torch.as_tensor(TEXT), 0.8, T, **targs)
    np.testing.assert_array_equal(got["voiced_mask"].numpy(),
                                  np.asarray(ref["voiced_mask"]))
    for key in ("f0", "energy_avg", "mel"):
        rel(got[key], ref[key])
    targs["z_f0"] = targs["z_f0"] * 0.5
    moved = port.radtts_infer(model, torch.as_tensor(SPK),
                              torch.as_tensor(TEXT), 0.8, T, **targs)["f0"]
    voiced = got["voiced_mask"].bool()
    assert (moved - got["f0"])[voiced].abs().max() > 1e-3


def test_flow_duration_model_matches_jax():
    """A grouped BGAP duration model (g=2 over 12 and 7 tokens) with
    injected z_dur: its output within 1e-4 * max of JAX's, and the integer
    durations (replication-padded past the last group, scaled 4x) equal
    to JAX's where the scaled value is clear of the rounding point."""
    from radtts_tpu.models.attributes import \
        attribute_model_infer as jax_attr_infer
    from radtts_tpu.models.radtts import encode_speaker as jax_spk
    from radtts_tpu.models.radtts import encode_text as jax_encode_text
    from radtts_tpu_torch.models.attributes import attribute_model_infer
    cfg = gap_config("agap")
    dur_cfg = copy.deepcopy(BGAP_CFG)
    dur_cfg["hparams"].update(n_in_dim=1)
    cfg["dur_model_config"] = dur_cfg
    params = jax_params(cfg, seed=3)
    model = radtts_from_jax(np_tree(params), cfg)
    text, lens = TEXT.copy(), np.array([12, 7])
    text[1, 7:] = 0
    z = rnd((2, 12, 1), 6, 0.6)
    j = {"spk": jnp.asarray(SPK), "text": jnp.asarray(text),
         "lens": jnp.asarray(lens), "z": jnp.asarray(z)}
    txt_enc, _ = jax_encode_text(params, j["text"], j["lens"])
    raw = np.asarray(jax_attr_infer(params["dur_pred_layer"], j["z"],
                                    txt_enc, jax_spk(params, j["spk"]),
                                    j["lens"]))[..., 0]
    t_enc, _ = port.encode_text(model, torch.as_tensor(text),
                                torch.as_tensor(lens))
    rel(attribute_model_infer(model.dur_pred_layer, t_enc,
                              port.encode_speaker(model,
                                                  torch.as_tensor(SPK)),
                              torch.as_tensor(lens), z=torch.as_tensor(z)),
        raw[..., None])
    want = np.asarray(jax_infer_durations(
        params, jax.random.PRNGKey(0), j["spk"], j["text"],
        token_dur_scaling=4.0, in_lens=j["lens"], z_dur=j["z"]))
    got = port.infer_durations(model, torch.as_tensor(SPK),
                               torch.as_tensor(text), token_dur_scaling=4.0,
                               in_lens=torch.as_tensor(lens),
                               z_dur=torch.as_tensor(z)).numpy()
    # the scaled value before rounding, padded and gathered as JAX does
    last = np.maximum(lens // 2 * 2 - 1, 0)
    idx = np.minimum(np.arange(12)[None, :], last[:, None])
    scaled = np.clip(np.take_along_axis(raw, idx, 1), 0, 100) * 4.0
    clear = np.abs(scaled - np.floor(scaled) - 0.5) > 1e-3
    valid = np.arange(12)[None, :] < lens[:, None]
    assert clear[valid].mean() > 0.9 and (got[~valid] == 0).all()
    np.testing.assert_array_equal(got[valid & clear], want[valid & clear])
    assert len(np.unique(got[valid])) > 2     # not a constant duration


@pytest.mark.parametrize("kind", ["bgap", "agap"])
def test_training_losses_match_jax(kind):
    """radtts_forward + radtts_loss with the flow attribute losses
    (loss_f0, loss_prior_f0, loss_energy, ...) at binarize on: rtol 1e-4;
    the total within rtol 1e-5."""
    cfg = gap_config(kind)
    params = jax_params(cfg)
    batch = make_batch(seed=2)
    import tests.test_torch_train_forward as tf
    old = tf.MODEL_CONFIG
    tf.MODEL_CONFIG = cfg        # jax_loss reads the module's config
    try:
        total, (scalars, _) = jax.jit(
            lambda p, b: jax_loss(p, b, True, True))(params, batch)
    finally:
        tf.MODEL_CONFIG = old
    from radtts_tpu_torch.convert import radtts_train_from_jax
    model = radtts_train_from_jax(np_tree(params), cfg)
    t_total, loss_dict, out = compute_loss(
        model, to_torch(batch), cfg, LOSS_WEIGHTS, 1.0, True, True)
    assert {"loss_f0", "loss_prior_f0", "loss_energy",
            "loss_prior_energy"} <= set(loss_dict)
    assert out["f0_model_outputs"]["z"] is not None
    for k, (v, _) in loss_dict.items():
        np.testing.assert_allclose(float(v), float(scalars[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(t_total), float(total), rtol=1e-5)


@pytest.mark.parametrize("kind", ["bgap", "agap"])
def test_attribute_gradients_match_jax_in_float64(kind):
    """The f0 flow's loss (attribute_prediction_loss on its training
    forward, ragged lengths) differentiated by JAX and by the port in
    float64: the loss within rtol 1e-6 and every parameter's gradient
    within 1e-5 * max|JAX's| (the JAX spline couplings cast their bins to
    float32 even under x64, so its gradient carries fp32 rounding there;
    the port's is float64 throughout)."""
    hp_cfg = copy.deepcopy(BGAP_CFG if kind == "bgap" else AGAP_CFG)
    from radtts_tpu.models.attributes import attribute_model_init
    params = perturb(attribute_model_init(jax.random.PRNGKey(9), hp_cfg), 8)
    T, lens = 20, np.array([20, 13, 7])
    txt, spk = rnd((3, T, 64), 1), rnd((3, 8), 2)
    x = rnd((3, T, hp_cfg["hparams"]["n_in_dim"]), 3)
    g = hp_cfg["hparams"]["n_group_size"]
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if hasattr(a, "dtype") and a.dtype == jnp.float32 else a,
            params)

        def loss(p):
            out = jax_attr_forward(p, jnp.asarray(txt, jnp.float64),
                                   jnp.asarray(spk, jnp.float64),
                                   jnp.asarray(x, jnp.float64),
                                   jnp.asarray(lens))
            return jax_attr_loss("f0", out, jnp.asarray(lens), 1.0,
                                 n_group_size=g)["loss_f0"][0]
        want_loss, grads = jax.jit(jax.value_and_grad(loss))(p64)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    mod = attribute_from_jax(np_tree(params), hp_cfg, factored=True).double()
    out = attribute_model_forward(
        mod, torch.from_numpy(txt).double(), torch.from_numpy(spk).double(),
        torch.from_numpy(x).double(), torch.from_numpy(lens))
    got_loss = attribute_prediction_loss("f0", out, torch.from_numpy(lens),
                                         1.0, n_group_size=g)["loss_f0"][0]
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    want = dict(attribute_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               np_tree(grads)),
        hp_cfg, factored=True).double().named_parameters())
    bad, n = [], 0
    for name, p in mod.named_parameters():
        w = want[name].detach().numpy()
        gr = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        n += 1
        if np.abs(gr - w).max() > 1e-5 * max(np.abs(w).max(), 1e-12):
            bad.append((name, np.abs(gr - w).max(), np.abs(w).max()))
    assert n > 10 and not bad, bad


def test_checkpoints_read_and_write_as_jax(case, tmp_path):
    """The JAX exporter's reference state dict reads (every key) into the
    tree JAX's reader gives; the .npz and the .pt load into the module
    radtts_from_jax builds; the port's writer gives JAX's key set at JAX's
    shapes, and reads back to the module it was written from."""
    from tests.test_torch_checkpoint import _Recorder, assert_trees_equal
    kind, cfg, params, model = case
    sd = jax_to_torch(params)
    rec = _Recorder(sd)
    assert_trees_equal(radtts_from_torch(rec, cfg),
                       np_tree(jax_from_torch(sd, cfg, template=params)))
    assert not sorted(set(sd) - rec.read)
    want = model.state_dict()
    npz = str(tmp_path / "ckpt.npz")
    save_checkpoint(npz, params, iteration=2)
    pt = str(tmp_path / "ckpt.pt")
    torch.save({"state_dict": sd, "iteration": 2}, pt)
    for path in (npz, pt):
        got = load_radtts_for_inference(path, cfg)[0].state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
    written = radtts_to_torch(model)
    assert set(written) == set(sd)
    for k in sd:
        assert tuple(written[k].shape) == tuple(sd[k].shape), k
    back = radtts_from_jax(radtts_from_torch(written, cfg), cfg).state_dict()
    for k, v in want.items():
        if "f0_pred_module" in k or "energy_pred_module" in k:
            np.testing.assert_allclose(back[k].numpy(), v.numpy(),
                                       atol=1e-6, err_msg=k)


def test_synthesizer_sigmas_move_flow_attributes(case):
    """Synthesizer.from_parts on the CPU with flow attribute models:
    sigma_f0 = 0 and 1 give other f0, sigma_energy other energy; the same
    seed and sigmas give the same waveform again."""
    from tests.test_torch_synthesizer import H_SMALL, _encode
    kind, cfg, params, model = case
    torch.manual_seed(0)
    vocoder = Generator(H_SMALL, n_mel=cfg["n_mel_channels"])
    with torch.no_grad():   # its bias spectrum from an 80-mel generator
        denoiser = denoiser_init(Generator(H_SMALL))

    def run(**kw):
        synth = Synthesizer.from_parts(
            cfg, model, vocoder, denoiser, encode_fn=_encode,
            speaker_id_fn=lambda name: 0, seed=3, device="cpu")
        return synth.synthesize("a flow of prosody", "x", **kw)

    wav, aux = run(sigma_f0=1.0, sigma_energy=1.0)
    wav2, aux2 = run(sigma_f0=1.0, sigma_energy=1.0)
    np.testing.assert_array_equal(wav[0], wav2[0])
    _, aux0 = run(sigma_f0=0.0, sigma_energy=1.0)
    _, aux_e = run(sigma_f0=1.0, sigma_energy=0.0)
    assert np.abs(aux0["f0"] - aux["f0"]).max() > 1e-3
    assert np.abs(aux_e["energy_avg"] - aux["energy_avg"]).max() > 1e-4
