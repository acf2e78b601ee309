"""The port's RADTTS checkpoint readers and writer against the JAX
package's, on the CPU: JAX-initialised weights of the small test model and
of a shrunk config_ljs_dap.json, written by the JAX package's writers
(save_checkpoint's .npz, export_torch_checkpoint's reference state dict)
and read by both; then the port's writer read back by the JAX package.
"""

import copy
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.convert import radtts_from_torch as jax_from_torch
from radtts_tpu.export import export_torch_checkpoint as jax_export
from radtts_tpu.export import radtts_to_torch as jax_to_torch
from radtts_tpu.models.hifigan import denoiser_init as jax_denoiser_init
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.synthesizer import Synthesizer as JaxSynthesizer
from radtts_tpu.train.checkpoint import load_checkpoint as jax_load_npz
from radtts_tpu.train.checkpoint import save_checkpoint
from tests.small_model import MODEL_CONFIG
from tests.test_torch_synthesizer_parity import (CFG, DUR_BIAS, H_SMALL,
                                                 SPEAKERS, TEXTS,
                                                 _assert_rounding_margin,
                                                 _audible_vocoder,
                                                 _converge_spectral_norms,
                                                 _encode, np_tree)

from radtts_tpu_torch.convert import (hifigan_from_jax, radtts_from_jax,
                                      radtts_from_torch)
from radtts_tpu_torch.export import export_torch_checkpoint, radtts_to_torch
from radtts_tpu_torch.models.hifigan import denoiser_init
from radtts_tpu_torch.synthesizer import Synthesizer
from radtts_tpu_torch.train.checkpoint import (is_torch_checkpoint,
                                               load_checkpoint,
                                               load_radtts_for_inference)


def shrink_model_config(mc):
    """config_ljs_dap.json's model at test size, every submodel shrunk
    consistently (the rule of tests/test_cli_inference.py)."""
    mc.update(n_text_dim=64, n_hidden=32, n_flows=4, mel_encoder_n_hidden=64,
              n_mel_channels=80)
    for key in ("dur_model_config", "f0_model_config",
                "energy_model_config", "v_model_config"):
        h = mc[key]["hparams"]
        h["bottleneck_hparams"]["in_dim"] = 64
        h["arch_hparams"]["n_channels"] = 32
    return mc


def ljs_small_config():
    with open("configs/config_ljs_dap.json") as f:
        config = json.load(f)
    config["model_config"] = shrink_model_config(config["model_config"])
    return config


CONFIGS = {"small": MODEL_CONFIG,
           "ljs_shrunk": ljs_small_config()["model_config"]}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, removed when the test ends, passed or failed. The
    checkpoints written there take 0.4-0.8 GB each, and pytest keeps the
    directories of its last three runs. (Modules that import this fixture
    get the same.)"""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    cfg = copy.deepcopy(CONFIGS[request.param])
    params = _converge_spectral_norms(radtts_init(jax.random.PRNGKey(0), cfg))
    return cfg, params


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    else:
        assert got.dtype == np.float32, (path, got.dtype)
        np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                      err_msg=path)


class _Recorder(dict):
    """A state dict that records the keys read."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_npz_reader_matches_jax(case, tmp_path):
    """save_checkpoint's .npz (optimizer state beside, one leaf bf16) reads
    into the tree JAX's load_checkpoint gives, leaf for leaf, in fp32."""
    cfg, params = case
    table = params["speaker_embedding"]["table"]
    params = {**params, "speaker_embedding": {
        "table": table.astype(jnp.bfloat16)}}
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, opt_state={"mu": params["embedding"]},
                    iteration=7, learning_rate=1e-3)
    got, meta = load_checkpoint(path)
    want, _, want_meta = jax_load_npz(path, params)
    assert_trees_equal(got, np_tree(want))
    assert meta == want_meta and meta["iteration"] == 7
    assert not is_torch_checkpoint(path)
    assert not is_torch_checkpoint(path[:-4])     # 'ckpt' beside ckpt.npz
    assert is_torch_checkpoint(str(tmp_path / "ckpt.pt"))


def test_state_dict_reader_matches_jax(case, tmp_path):
    """The JAX package's exported reference state dict reads into JAX's
    convert.radtts_from_torch tree, its alignment attention included;
    every entry is read."""
    cfg, params = case
    path = tmp_path / "ckpt.pt"
    jax_export(str(path), params, iteration=3, learning_rate=2e-4)
    sd = torch.load(path, weights_only=True)["state_dict"]
    rec = _Recorder(sd)
    got = radtts_from_torch(rec, cfg)
    want = np_tree(jax_from_torch(sd, cfg, template=params))
    assert "attention" in got
    assert_trees_equal(got, want)
    unread = sorted(set(sd) - rec.read)
    assert not unread, unread
    assert any(k.endswith(".lower_diag") for k in rec.read)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_loader_builds_radtts_from_jax_module(case, tmp_path, fmt):
    """load_radtts_for_inference on either file gives the module
    radtts_from_jax builds from the tree in memory, parameter for
    parameter and buffer for buffer."""
    cfg, params = case
    path = str(tmp_path / f"ckpt.{fmt}")
    if fmt == "npz":
        save_checkpoint(path, params, iteration=5)
    else:
        jax_export(path, params, iteration=5)
    model, meta = load_radtts_for_inference(path, cfg)
    assert meta["iteration"] == 5
    want = radtts_from_jax(np_tree(params), cfg).state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


def test_reads_transformer_attribute_model():
    """A DAP on the FFTransformer, which the reader once refused: the
    JAX package's exported reference state dict of a model whose f0 DAP
    uses the transformer reads into JAX's convert.radtts_from_torch tree,
    every entry read, and loads into the port's module."""
    cfg = copy.deepcopy(MODEL_CONFIG)
    cfg["f0_model_config"] = copy.deepcopy(cfg["f0_model_config"])
    cfg["f0_model_config"]["hparams"]["use_transformer"] = True
    params = _converge_spectral_norms(radtts_init(jax.random.PRNGKey(2), cfg))
    sd = jax_to_torch(params)
    rec = _Recorder(sd)
    got = radtts_from_torch(rec, cfg)
    assert_trees_equal(got, np_tree(jax_from_torch(sd, cfg,
                                                   template=params)))
    assert not sorted(set(sd) - rec.read)
    assert any(".feat_pred_fn.layers.1.dec_attn.qkv_net." in k
               for k in rec.read)
    assert radtts_from_jax(got, cfg).f0_pred_module.use_transformer


def test_writer_keys_and_shapes_match_jax(case, tmp_path):
    """The port's writer gives every key JAX's exporter writes, attention.*
    included, at the same shapes (the attention's equal to JAX's); each
    spectral-normed recurrent weight has u . (W v) = 1; the file holds
    what radtts_to_torch returns; the port's reader reads it back to the
    module it was written from."""
    cfg, params = case
    model = radtts_from_jax(np_tree(params), cfg)
    sd = radtts_to_torch(model)
    ref = jax_to_torch(params)
    assert set(sd) == set(ref)
    for k in ref:
        if k.startswith("attention."):
            assert torch.equal(sd[k], ref[k]), k
    back = radtts_from_jax(radtts_from_torch(sd, cfg), cfg).state_dict()
    for k, v in model.state_dict().items():
        if k.startswith("attention."):
            assert torch.equal(back[k], v), k
    for k in ref:
        assert sd[k].shape == ref[k].shape and sd[k].dtype == torch.float32, k
    for k in sd:
        if k.endswith("_orig"):
            w = sd[k].double()
            u, v = sd[k[:-5] + "_u"].double(), sd[k[:-5] + "_v"].double()
            assert abs(float(u @ (w @ v)) - 1.0) < 1e-6, k
    path = tmp_path / "port.pt"
    export_torch_checkpoint(str(path), model, iteration=9,
                            learning_rate=1e-4)
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["iteration"] == 9 and ckpt["learning_rate"] == 1e-4
    assert set(ckpt["state_dict"]) == set(sd)


def test_written_checkpoint_infers_as_jax():
    """The port's writer, read by the JAX package (attention.* included,
    so nothing is merged in): JAX's Synthesizer on that tree against the
    port's on the module it was written from, sigma 0, durations exact and
    waveforms within 1e-4 * max."""
    params = _converge_spectral_norms(radtts_init(jax.random.PRNGKey(0),
                                                  CFG))
    rng = np.random.default_rng(5)
    for flow in params["flows"]:   # the WN end convs are zero at init
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.02, end["w"].shape).astype(np.float32))
    dense = params["dur_pred_layer"]["feat"]["dense"]
    dense["b"] = jnp.full_like(dense["b"], DUR_BIAS["durations"])
    model = radtts_from_jax(np_tree(params), CFG)
    tree = jax_from_torch(radtts_to_torch(model), CFG, template=params)
    voc = _audible_vocoder()
    gen = hifigan_from_jax(np_tree(voc), H_SMALL)
    with torch.no_grad():
        den = denoiser_init(gen)
    common = dict(encode_fn=_encode, speaker_id_fn=SPEAKERS.__getitem__,
                  seed=11)
    ref = JaxSynthesizer.from_parts(CFG, tree, voc, jax_denoiser_init(voc),
                                    **common)
    synth = Synthesizer.from_parts(CFG, model, gen, den, device="cpu",
                                   **common)
    _assert_rounding_margin(synth.model, TEXTS, "spk")
    wr, aux_r = ref.synthesize(TEXTS, "spk", sigma=0.0)
    wp, aux_p = synth.synthesize(TEXTS, "spk", sigma=0.0)
    np.testing.assert_array_equal(aux_p["dur"], np.asarray(aux_r["dur"]))
    for got, want in zip(wp, wr):
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert scale > 0.05
        assert np.abs(got - want).max() <= 1e-4 * scale
