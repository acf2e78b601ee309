"""The RADTTS trainer's validation audio samples and the debug sentinels,
held against the JAX package on the CPU: _log_audio_samples with a
recording logger (JAX's tags in JAX's order, the audio within 1e-3 * max,
the decoder's residual injected on both sides), its two guards, and the
numerical sentinels at JAX's sites, off by default and free when off."""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import radtts_tpu.models.radtts as jax_radtts
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.ops.lstm import unroll_scope
from radtts_tpu.train.trainer import _log_audio_samples as jax_log_samples
from tests.small_model import MODEL_CONFIG
from tests.test_torch_synthesizer_parity import (H_SMALL,
                                                 _audible_vocoder,
                                                 _converge_spectral_norms,
                                                 np_tree)

import radtts_tpu_torch.models.radtts as port_radtts
from radtts_tpu_torch import debug
from radtts_tpu_torch.convert import hifigan_from_jax, radtts_train_from_jax
from radtts_tpu_torch.models.hifigan import generator_to_reference
from radtts_tpu_torch.train.trainer import _log_audio_samples

CFG = dict(MODEL_CONFIG, n_mel_channels=80)      # the vocoder takes 80
N, T = 12, 48


class Recorder:
    def __init__(self):
        self.calls = []

    def add_audio(self, tag, audio, step, sr):
        self.calls.append((tag, np.asarray(audio), step, sr))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A small DAP model (the JAX tree and the port's training form), a
    reference-format vocoder checkpoint written by the port, and a batch
    whose MAS durations sum to 48 frames (max_frames 64: the ground-truth
    frames are zero-padded)."""
    root = tmp_path_factory.mktemp("voc")
    voc_ckpt, voc_cfg = root / "hifigan.pt", root / "hifigan.json"
    torch.save({"generator": generator_to_reference(
        hifigan_from_jax(np_tree(_audible_vocoder()), H_SMALL))}, voc_ckpt)
    import json
    voc_cfg.write_text(json.dumps(H_SMALL))
    with unroll_scope(1):
        params = _converge_spectral_norms(radtts_init(jax.random.PRNGKey(0),
                                                      CFG))
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.02, end["w"].shape).astype(np.float32))
    r = np.random.default_rng(0)
    voiced = (r.random((1, T)) > 0.3).astype(np.float32)
    batch = {"speaker_ids": np.zeros((1,), np.int64),
             "text": r.integers(1, 180, (1, N)),
             "f0": (r.random((1, T)).astype(np.float32) * 200 + 100) * voiced,
             "voiced_mask": voiced,
             "energy_avg": r.random((1, T)).astype(np.float32)}
    dur = np.full(N, T // N)
    attn = np.zeros((1, T, N), np.float32)
    attn[0, np.arange(T), np.repeat(np.arange(N), dur)] = 1.0
    train_config = {"vocoder_checkpoint_path": str(voc_ckpt),
                    "vocoder_config_path": str(voc_cfg),
                    "log_decoder_samples": True,
                    "log_attribute_samples": True}
    return params, radtts_train_from_jax(np_tree(params), CFG), batch, \
        attn, train_config


def inject_residual(monkeypatch):
    """Both trainers call radtts_infer at sigma 0.8 with noise of their
    own generators: hand each the same residual instead."""
    def residual(max_frames):
        g = CFG["n_group_size"]
        return (0.8 * np.random.default_rng(11).standard_normal(
            (1, max_frames // g, CFG["n_mel_channels"] * g))).astype(
                np.float32)

    real_jax, real_port = jax_radtts.radtts_infer, port_radtts.radtts_infer

    def jax_infer(params, rng, spk, text, sigma, max_frames, **kw):
        return real_jax(params, rng, spk, text, sigma, max_frames,
                        residual=jnp.asarray(residual(max_frames)), **kw)

    def port_infer(model, spk, text, sigma, max_frames, **kw):
        return real_port(model, spk, text, sigma, max_frames,
                         residual=torch.from_numpy(residual(max_frames)),
                         **kw)

    monkeypatch.setattr(jax_radtts, "radtts_infer", jax_infer)
    monkeypatch.setattr(port_radtts, "radtts_infer", port_infer)


def test_audio_samples_match_jax(setup, monkeypatch):
    """Ground-truth attributes then attribute sigmas 0.1, 0.5, 0.8 and 1.0:
    JAX's tags in JAX's order at 22050 Hz, each waveform within 1e-3 *
    max of JAX's."""
    params, model, batch, attn, train_config = setup
    inject_residual(monkeypatch)
    want, got = Recorder(), Recorder()
    with unroll_scope(1):
        jax_log_samples(3, params, CFG, train_config, batch, attn, want,
                        22050)
    _log_audio_samples(3, model, CFG, train_config, batch,
                       torch.from_numpy(attn), got, 22050,
                       torch.device("cpu"))
    tags = ["decoder_sample_gt_attributes"] + [
        f"sample_attribute_sigma_{s}" for s in (0.1, 0.5, 0.8, 1.0)]
    assert [c[0] for c in want.calls] == tags
    assert [c[0] for c in got.calls] == tags
    for (_, w, ws, wsr), (_, g, gs, gsr) in zip(want.calls, got.calls):
        assert (gs, gsr) == (ws, wsr) == (3, 22050)
        assert g.shape == w.shape and np.abs(w).max() > 0.1
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("missing", ["checkpoint", "config", "file"])
def test_no_vocoder_writes_nothing(setup, tmp_path, missing):
    """A vocoder path that is empty or names no file: no sample, no
    error, as in the JAX package."""
    _, model, batch, attn, train_config = setup
    tc = dict(train_config)
    if missing == "file":
        tc["vocoder_checkpoint_path"] = str(tmp_path / "absent.pt")
    else:
        tc[f"vocoder_{missing}_path"] = ""
    rec = Recorder()
    _log_audio_samples(0, model, CFG, tc, batch, torch.from_numpy(attn),
                       rec, 22050, torch.device("cpu"))
    assert rec.calls == []


def test_one_failing_sigma_lets_the_others_through(setup, monkeypatch,
                                                   capsys):
    """A synthesis that raises at attribute sigma 0.5 is reported and
    skipped (JAX's instability guard); the other four are written."""
    _, model, batch, attn, train_config = setup
    real = port_radtts.radtts_infer

    def flaky(*args, **kw):
        if kw.get("sigma_f0") == 0.5:
            raise FloatingPointError("unstable")
        return real(*args, **kw)

    monkeypatch.setattr(port_radtts, "radtts_infer", flaky)
    rec = Recorder()
    _log_audio_samples(0, model, CFG, train_config, batch,
                       torch.from_numpy(attn), rec, 22050,
                       torch.device("cpu"))
    assert [c[0] for c in rec.calls] == [
        "decoder_sample_gt_attributes", "sample_attribute_sigma_0.1",
        "sample_attribute_sigma_0.8", "sample_attribute_sigma_1.0"]
    assert "skipping sample generation" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# debug sentinels (the cases of tests/test_debug_sentinel.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def debug_mode():
    debug.enable_numerical_checks(True)
    yield
    debug.enable_numerical_checks(False)


def _nan_attention():
    attn = np.random.default_rng(0).random((1, 24, 8)).astype(np.float32)
    attn[0, 3, 2] = np.nan
    return (torch.from_numpy(attn), torch.tensor([8]), torch.tensor([24]))


def _nan_spline_input():
    from radtts_tpu_torch.ops.splines import piecewise_linear_forward
    x = torch.tensor([[0.5, math.nan]])
    return lambda: piecewise_linear_forward(x, torch.zeros(1, 2, 8))


def test_nan_attention_raises_in_debug_mode(debug_mode):
    attn, in_lens, out_lens = _nan_attention()
    with pytest.raises(debug.NumericalError, match="soft attention map"):
        port_radtts.binarize_attention(attn, in_lens, out_lens)


def test_nan_attention_silent_by_default():
    assert not debug.numerical_checks_enabled()
    attn, in_lens, out_lens = _nan_attention()
    port_radtts.binarize_attention(attn, in_lens, out_lens)


def test_nan_spline_input_raises_in_debug_mode(debug_mode):
    with pytest.raises(debug.NumericalError,
                       match="piecewise_linear_forward bin input"):
        _nan_spline_input()()
    assert issubclass(debug.NumericalError, FloatingPointError)


def test_spline_silent_by_default():
    _nan_spline_input()()


def test_checks_cost_nothing_when_off(monkeypatch):
    """Off, a check reads nothing: torch.isfinite is never called."""
    def no_call(*args):
        raise AssertionError("isfinite called with the checks off")

    monkeypatch.setattr(torch, "isfinite", no_call)
    attn, in_lens, out_lens = _nan_attention()
    port_radtts.binarize_attention(attn, in_lens, out_lens)
    _nan_spline_input()()


def test_decoder_and_scan_sites(debug_mode, setup):
    """A finite training forward passes with the checks on; a NaN in the
    decoder's input raises at the flows' log_s, and a NaN residual in an
    AGAP's quadratic-spline scan at its output, under JAX's names."""
    from tests.test_torch_gap_models import AGAP_CFG

    from radtts_tpu_torch.models.attributes import AGAP, ar_step_problem
    from radtts_tpu_torch.ops.ar_scan import ar_scan
    _, model, _, _, _ = setup
    B, n, t = 2, 10, 32
    mel = torch.randn(B, t, 80, generator=torch.Generator().manual_seed(0))
    text = torch.randint(1, 180, (B, n),
                         generator=torch.Generator().manual_seed(1))
    lens, out_lens = torch.tensor([10, 7]), torch.tensor([32, 24])
    voiced = (torch.rand(B, t, generator=torch.Generator().manual_seed(2))
              > 0.3).float()
    kw = dict(f0=200 * voiced, energy_avg=torch.rand(B, t), voiced_mask=voiced)
    with torch.no_grad():
        port_radtts.radtts_forward(model, mel, torch.tensor([0, 1]), text,
                                   lens, out_lens,
                                   binarize_attention_flag=True, **kw)
        flow = model.flows[0]
        n_half = flow.affine.n_half
        n_ctx = flow.affine.pred.start.effective_weight().shape[1] - n_half
        z = torch.full((B, t // 2, 2 * n_half), math.nan)
        with pytest.raises(debug.NumericalError,
                           match="decoder flow log_s"):
            port_radtts._flow_step_forward(model, flow, z,
                                           torch.zeros(B, t // 2, n_ctx),
                                           None)
    agap = AGAP(copy.deepcopy(AGAP_CFG["hparams"])).eval()
    step = agap.flows[0]
    C = step.n_attr
    ctx = torch.randn(1, 6, step.lstm.lstm.input_size - step.lstm.lstm
                      .hidden_size)
    res = torch.full((1, 6, C), math.nan)
    with torch.no_grad(), pytest.raises(
            debug.NumericalError, match="piecewise_quadratic bin input"):
        ar_scan(*ar_step_problem(step, res, ctx, agap.scaling_fn))
