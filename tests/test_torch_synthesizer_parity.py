"""The PyTorch port's Synthesizer against the JAX package's Synthesizer on
the CPU: the same JAX-initialised weights on both sides (carried over by
radtts_tpu_torch.convert), sigma 0 so that neither side draws noise.

This holds the engine code around the model: the 16-token buckets, the
guard for durations that sum below 1, last-frame replication into the
padded frames, the per-request denoise strength and trimming.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.hifigan import denoiser_init as jax_denoiser_init
from radtts_tpu.models.hifigan import hifigan_generator_init
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.synthesizer import Synthesizer as JaxSynthesizer
from tests.small_model import MODEL_CONFIG

from radtts_tpu_torch.convert import hifigan_from_jax, radtts_from_jax
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.models.attributes import attribute_model_infer
from radtts_tpu_torch.models.hifigan import denoiser_init
from radtts_tpu_torch.synthesizer import Synthesizer

CFG = dict(MODEL_CONFIG, n_mel_channels=80)   # the vocoder's conv_pre is 80
H_SMALL = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 64,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
TEXTS = ["A quick check of bucketing.", "Short one!", "Middle text."]
SPEAKERS = {"spk": 0, "other": 2}
# dense bias of the duration DAP (log domain): 1.3 centres durations on
# ~3 frames; -3 makes every duration round to 0, so the guard fires
DUR_BIAS = {"durations": 1.3, "guard": -3.0}


def _encode(text):
    return np.array([ord(c) % 150 + 1 for c in text], np.int64)


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()
                if k not in ("_meta", "_kind")}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree)


def _audible_vocoder():
    """hifigan_generator_init's normal(0, 0.01) convs give a waveform of
    scale ~1e-6 and, with zero biases, a zero denoiser bias spectrum.
    Scale the six non-MRF convs 10x and draw the biases, so the waveform
    reaches the tanh's range and the denoiser has something to remove."""
    voc = hifigan_generator_init(jax.random.PRNGKey(1), H_SMALL)
    rng = np.random.default_rng(3)

    def fix(conv, gain):
        conv["w"] = jnp.asarray(np.asarray(conv["w"]) * gain)
        conv["b"] = jnp.asarray(
            rng.normal(0, 0.05, conv["b"].shape).astype(np.float32))

    for conv in [voc["conv_pre"], *voc["ups"], voc["conv_post"]]:
        fix(conv, 10.0)
    for stage in voc["resblocks"]:
        for block in stage:
            for conv in block["convs1"] + block["convs2"]:
                fix(conv, 1.0)
    return voc


def _converge_spectral_norms(node):
    """Set every LSTM's stored power-iteration vectors to the top singular
    pair of its weight, as training leaves them. At init they are random,
    so w / (u . (w v)) divides by a small sigma of either sign and the
    recurrences become chaotic: fp32 sums taken in another order then
    diverge over a few dozen frames."""
    if isinstance(node, dict):
        if "sn_w" in node:
            u, _, vt = np.linalg.svd(np.asarray(node["sn_w"], np.float64))
            return {**node, "sn_u": jnp.asarray(u[:, 0], jnp.float32),
                    "sn_v": jnp.asarray(vt[0], jnp.float32)}
        return {k: _converge_spectral_norms(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_converge_spectral_norms(v) for v in node]
    return node


@pytest.fixture(scope="module")
def trees():
    params = _converge_spectral_norms(
        radtts_init(jax.random.PRNGKey(0), CFG))
    # the WN end convs are zero-initialised, which would make the decode
    # comparison vacuous: perturb them on both sides
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.02, end["w"].shape).astype(np.float32))
    voc = _audible_vocoder()
    return params, voc, jax_denoiser_init(voc)


def _synths(trees, dur_bias):
    params, voc, jax_den = trees
    dense = params["dur_pred_layer"]["feat"]["dense"]
    params = {**params, "dur_pred_layer": {
        **params["dur_pred_layer"], "feat": {
            **params["dur_pred_layer"]["feat"],
            "dense": {**dense, "b": jnp.full_like(dense["b"], dur_bias)}}}}
    common = dict(encode_fn=_encode, speaker_id_fn=SPEAKERS.__getitem__,
                  seed=11)
    ref = JaxSynthesizer.from_parts(CFG, params, voc, jax_den, **common)
    model = radtts_from_jax(np_tree(params), CFG)
    gen = hifigan_from_jax(np_tree(voc), H_SMALL)
    with torch.no_grad():
        den = denoiser_init(gen)
    return ref, Synthesizer.from_parts(CFG, model, gen, den, device="cpu",
                                       **common)


def _assert_rounding_margin(model, texts, speaker):
    """Durations compare exactly only where the value before rounding lies
    clear of x.5: check that on the port's side for these inputs."""
    lens = [len(_encode(t)) for t in texts]
    N = ((max(lens) + 15) // 16) * 16 if len(texts) > 1 else lens[0]
    text = torch.zeros(len(texts), N, dtype=torch.int64)
    for j, t in enumerate(texts):
        text[j, :lens[j]] = torch.as_tensor(_encode(t))
    in_lens = torch.as_tensor(lens) if len(texts) > 1 else None
    spk = torch.full((len(texts),), SPEAKERS[speaker], dtype=torch.int64)
    with torch.no_grad():
        txt_enc, _ = port.encode_text(model, text, in_lens)
        raw = attribute_model_infer(model.dur_pred_layer, txt_enc,
                                    port.encode_speaker(model, spk), in_lens)
    raw = raw[..., 0].clamp(0, 100)
    frac = (raw - torch.floor(raw)).numpy()
    for j, n in enumerate(lens):
        assert (np.abs(frac[j, :n] - 0.5) > 1e-4).all()


@pytest.mark.parametrize("case,texts,kw", [
    ("durations", TEXTS[0], {}),
    # untrimmed, with the text and attribute speakers overridden
    ("durations", TEXTS, dict(trim=False, speaker_text="other",
                              speaker_attributes="other")),
    ("guard", TEXTS, {}),
])
def test_synthesize_matches_jax(trees, case, texts, kw):
    ref, synth = _synths(trees, DUR_BIAS[case])
    batch = [texts] if isinstance(texts, str) else texts
    if case == "durations":
        _assert_rounding_margin(synth.model, batch,
                                kw.get("speaker_text", "spk"))
    kw = dict(kw, sigma=0.0, denoising_strength=0.1)
    wr, aux_r = ref.synthesize(texts, "spk", **kw)
    wp, aux_p = synth.synthesize(texts, "spk", **kw)
    trim = kw.get("trim", True)

    n_tokens = np.array([len(_encode(t)) for t in batch])
    np.testing.assert_array_equal(aux_p["dur"], np.asarray(aux_r["dur"]))
    np.testing.assert_array_equal(aux_p["n_frames"], aux_r["n_frames"])
    if case == "guard":   # every valid token bumped to one frame
        np.testing.assert_array_equal(aux_p["n_frames"], n_tokens)
    else:
        assert (aux_p["n_frames"] > 2 * n_tokens).all()
    for j, n in enumerate(aux_r["n_frames"]):
        for key in ("f0", "energy_avg"):   # the frames the decode keeps
            np.testing.assert_allclose(aux_p[key][j, :n], aux_r[key][j, :n],
                                       rtol=1e-4, atol=1e-4)
    max_frames = ((aux_r["n_frames"].max() + 31) // 32) * 32
    for got, want, n in zip(wp, wr, aux_r["n_frames"]):
        assert got.shape == want.shape == ((n if trim else max_frames) * 256,)
        scale = np.abs(want).max()
        assert scale > 0.05   # the waveform is in range, not near silence
        # the decode's 1e-3 max-abs on mels, carried through four upsample
        # stages of fp32 convs and the STFT round trip of the denoiser
        err = np.abs(got - want).max()
        assert err <= 1e-4 * scale, (err, scale)
