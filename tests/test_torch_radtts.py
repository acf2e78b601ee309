"""Parity of the PyTorch port's RADTTS inference with the JAX package on the
CPU, on the small test config: the same JAX-initialised weights (carried
over by radtts_tpu_torch.convert) and the same injected decoder noise.

Integer outputs (durations, the voiced mask) compare exactly only where
the value before rounding / thresholding lies clear of the decision point;
each test asserts that margin on its inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.radtts import encode_text as jax_encode_text
from radtts_tpu.models.radtts import infer_durations as jax_infer_durations
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.models.radtts import renormalize_f0 as jax_renormalize_f0
from tests.small_model import MODEL_CONFIG

from radtts_tpu_torch.convert import radtts_from_jax
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.models.attributes import attribute_model_infer
from radtts_tpu_torch.ops.length_regulator import regulate_length

TEXT = np.array([[12, 55, 3, 91, 140, 7, 33, 62, 18, 101, 77, 5],
                 [44, 9, 120, 66, 2, 150, 31, 8, 0, 0, 0, 0]], np.int64)
IN_LENS = np.array([12, 8])
SPK = np.array([0, 2])


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()
                if k not in ("_meta", "_kind")}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    params = radtts_init(jax.random.PRNGKey(0), MODEL_CONFIG)
    # the WN end convs are zero-initialised, which would make the decode
    # comparison vacuous: perturb them on both sides
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.02, end["w"].shape).astype(np.float32))
    return params, radtts_from_jax(np_tree(params), MODEL_CONFIG)


@pytest.mark.parametrize("batched", [True, False])
def test_encode_text(models, batched):
    params, model = models
    text = TEXT if batched else TEXT[:1]
    lens = IN_LENS if batched else None
    ref, ref_emb = jax_encode_text(params, jnp.asarray(text),
                                   None if lens is None
                                   else jnp.asarray(lens))
    got, emb = port.encode_text(model, torch.as_tensor(text),
                                None if lens is None
                                else torch.as_tensor(lens))
    # fp32 convs, norms and a BiLSTM: sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(ref_emb))


@pytest.mark.parametrize("scaling", [1.0, 7.3])
def test_infer_durations(models, scaling):
    params, model = models
    text, lens, spk = (torch.as_tensor(a) for a in (TEXT, IN_LENS, SPK))
    # margin: the value before rounding is clear of x.5
    txt_enc, _ = port.encode_text(model, text, lens)
    raw = attribute_model_infer(model.dur_pred_layer, txt_enc,
                                port.encode_speaker(model, spk), lens)
    raw = raw[..., 0].clamp(0, 100) * scaling
    frac = (raw - torch.floor(raw)).numpy()
    assert (np.abs(frac - 0.5) > 1e-4).all()

    ref = jax_infer_durations(params, jax.random.PRNGKey(0),
                              jnp.asarray(SPK), jnp.asarray(TEXT),
                              token_dur_scaling=scaling,
                              in_lens=jnp.asarray(IN_LENS))
    got = port.infer_durations(model, spk, text, token_dur_scaling=scaling,
                               in_lens=lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy()[1, 8:].sum() == 0


@pytest.mark.parametrize("batched", [False, True])
def test_radtts_infer_mel(models, batched):
    params, model = models
    text = TEXT if batched else TEXT[:1]
    lens = IN_LENS if batched else None
    B = text.shape[0]
    dur = np.random.default_rng(1).integers(1, 4, text.shape).astype(
        np.int32)
    if batched:
        dur[1, 8:] = 0
    max_frames = ((int(dur.sum(1).max()) + 31) // 32) * 32
    g, n_mel = MODEL_CONFIG["n_group_size"], MODEL_CONFIG["n_mel_channels"]
    residual = (0.8 * np.random.default_rng(2).standard_normal(
        (B, max_frames // g, n_mel * g))).astype(np.float32)
    spk = SPK[:B]

    # margin: the voiced-mask logits are clear of the 0.5 threshold
    t_text, t_dur = torch.as_tensor(text), torch.as_tensor(dur)
    t_lens = None if lens is None else torch.as_tensor(lens)
    txt_enc, _ = port.encode_text(model, t_text, t_lens)
    expanded = regulate_length(txt_enc, t_dur, max_frames)
    logits = attribute_model_infer(
        model.v_pred_module, expanded,
        port.encode_speaker(model, torch.as_tensor(spk)), t_dur.sum(1))
    assert (torch.abs(torch.sigmoid(logits) - 0.5) > 1e-4).all()

    ref = jax_radtts_infer(
        params, jax.random.PRNGKey(1), jnp.asarray(spk), jnp.asarray(text),
        0.8, max_frames, dur=jnp.asarray(dur),
        residual=jnp.asarray(residual),
        in_lens=None if lens is None else jnp.asarray(lens))
    got = port.radtts_infer(model, torch.as_tensor(spk), t_text, 0.8,
                            max_frames, dur=t_dur,
                            residual=torch.as_tensor(residual),
                            in_lens=t_lens)
    np.testing.assert_array_equal(got["voiced_mask"].numpy(),
                                  np.asarray(ref["voiced_mask"]))
    # 8 inverse flows of fp32 convs: the decode bounds of the port's
    # parity target (max-abs 1e-3, mean-abs 1e-4 on mels of scale ~10)
    err = np.abs(got["mel"].numpy() - np.asarray(ref["mel"]))
    assert err.max() <= 1e-3 and err.mean() <= 1e-4, (err.max(), err.mean())
    for key in ("f0", "energy_avg"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("f0_std", [0.0, 30.0])
def test_renormalize_f0(f0_std):
    rng = np.random.default_rng(4)
    f0 = rng.uniform(80, 300, (2, 40)).astype(np.float32)
    vm = (rng.random((2, 40)) > 0.4).astype(np.float32)
    out_lens = np.array([40, 25])
    ref = jax_renormalize_f0(jnp.asarray(f0), jnp.asarray(vm), 180.0,
                             f0_std, out_lens=jnp.asarray(out_lens))
    got = port.renormalize_f0(torch.as_tensor(f0), torch.as_tensor(vm),
                              180.0, f0_std,
                              out_lens=torch.as_tensor(out_lens))
    # masked means and a Bessel-corrected std over <= 40 fp32 values
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
    assert not np.allclose(got.numpy(), f0)
