"""Voice conversion in the port against the JAX package on the CPU:
radtts_infer with injected f0 / energy (and f0_mean renormalization), the
HiFi-GAN generators the hand kernels do not take (ResBlock2 at HiFi-GAN
V3's layout, ResBlock1 with other dilations) with their reference state
dicts both ways, and `python -m radtts_tpu_torch.inference_voice_conversion`
against the root inference_voice_conversion.py on the same files, in both
modes, at --sigma 0 (the DAPs draw no noise, so both CLIs are
deterministic).
"""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from radtts_tpu.export import export_torch_checkpoint as jax_export
from radtts_tpu.models.hifigan import (_mrf_is_pallas_compatible,
                                       hifigan_generator_apply,
                                       hifigan_generator_init,
                                       hifigan_generator_to_torch)
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from radtts_tpu.models.radtts import radtts_init
from tests.small_model import MODEL_CONFIG
from tests.test_torch_checkpoint import ljs_small_config
from tests.test_torch_radtts import IN_LENS, SPK, TEXT, models  # noqa: F401
from tests.test_torch_synthesizer_parity import (_converge_spectral_norms,
                                                 np_tree)

from radtts_tpu_torch import inference_voice_conversion as vc
from radtts_tpu_torch.convert import hifigan_from_jax
from radtts_tpu_torch.models import hifigan
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.models.hifigan import (generator_from_reference,
                                             generator_to_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This file's small models run on one intra-op thread, its module
    fixtures included: where the suite's workers share the cores, OpenMP's
    barriers stall many short ops (tests/test_torch_parallel_serve.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SR = 22050

# ---------------------------------------------------------------------------
# radtts_infer with injected features
# ---------------------------------------------------------------------------

INJECT = {
    "both": dict(f0=True, energy=True),
    "both_f0_mean": dict(f0=True, energy=True, f0_mean=180.0, f0_std=25.0),
    "f0_only": dict(f0=True, energy=False),
    "energy_only_f0_mean": dict(f0=False, energy=True, f0_mean=150.0),
}


@pytest.mark.parametrize("case", sorted(INJECT))
def test_radtts_infer_injected_features(models, case):  # noqa: F811
    """Injected f0 / energy_avg with a given voiced mask, a ragged batch:
    mel within the decode parity bounds (max-abs 1e-3, mean-abs 1e-4),
    f0 and energy within 1e-4; an injected feature comes back as given
    (before the f0_mean renormalization), and energy_mean / energy_std /
    speaker_id_text change nothing, as in the JAX package."""
    params, model = models
    spec = INJECT[case]
    B = TEXT.shape[0]
    rng = np.random.default_rng(7)
    dur = rng.integers(1, 4, TEXT.shape).astype(np.int32)
    dur[1, IN_LENS[1]:] = 0
    max_frames = ((int(dur.sum(1).max()) + 31) // 32) * 32
    g, n_mel = MODEL_CONFIG["n_group_size"], MODEL_CONFIG["n_mel_channels"]
    residual = (0.8 * rng.standard_normal(
        (B, max_frames // g, n_mel * g))).astype(np.float32)
    vm = (rng.random((B, max_frames)) > 0.3).astype(np.float32)
    f0 = (rng.uniform(90, 260, (B, max_frames)) * vm).astype(np.float32)
    energy = rng.uniform(0.1, 0.9, (B, max_frames)).astype(np.float32)
    kw = dict(f0_mean=spec.get("f0_mean", 0.0),
              f0_std=spec.get("f0_std", 0.0))
    inj_j = dict(voiced_mask=jnp.asarray(vm), **kw)
    inj_p = dict(voiced_mask=torch.as_tensor(vm), **kw)
    if spec["f0"]:
        inj_j["f0"], inj_p["f0"] = jnp.asarray(f0), torch.as_tensor(f0)
    if spec["energy"]:
        inj_j["energy_avg"] = jnp.asarray(energy)
        inj_p["energy_avg"] = torch.as_tensor(energy)

    ref = jax_radtts_infer(
        params, jax.random.PRNGKey(1), jnp.asarray(SPK), jnp.asarray(TEXT),
        0.8, max_frames, dur=jnp.asarray(dur),
        residual=jnp.asarray(residual), in_lens=jnp.asarray(IN_LENS),
        **inj_j)
    args = (model, torch.as_tensor(SPK), torch.as_tensor(TEXT), 0.8,
            max_frames)
    common = dict(dur=torch.as_tensor(dur), residual=torch.as_tensor(residual),
                  in_lens=torch.as_tensor(IN_LENS), **inj_p)
    got = port.radtts_infer(*args, **common)
    err = np.abs(got["mel"].numpy() - np.asarray(ref["mel"]))
    assert err.max() <= 1e-3 and err.mean() <= 1e-4, (err.max(), err.mean())
    for key in ("f0", "energy_avg"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-4)
    if spec["energy"]:
        np.testing.assert_array_equal(got["energy_avg"].numpy(), energy)
    if spec["f0"] and not kw["f0_mean"]:
        np.testing.assert_array_equal(got["f0"].numpy(), f0)
    if kw["f0_mean"]:
        n = dur.sum(1)
        for b in range(B):
            voiced = vm[b, :n[b]] > 0
            np.testing.assert_allclose(
                got["f0"].numpy()[b, :n[b]][voiced].mean(), kw["f0_mean"],
                rtol=1e-4)

    other = port.radtts_infer(*args, **common, energy_mean=3.0,
                              energy_std=2.0,
                              speaker_id_text=torch.as_tensor(
                                  SPK[::-1].copy()))
    np.testing.assert_array_equal(other["mel"].numpy(), got["mel"].numpy())


# ---------------------------------------------------------------------------
# generators off the hand kernels
# ---------------------------------------------------------------------------

# HiFi-GAN V3's layout (jik876/hifi-gan config_v3.json) at a narrower
# upsample_initial_channel; a ResBlock1 with other dilations; and the
# standard MRF with a prefix of its kernel sizes, which the kernels take
GENERATORS = {
    "v3_resblock2": {
        "resblock": "2", "upsample_rates": [8, 8, 4],
        "upsample_kernel_sizes": [16, 16, 8],
        "upsample_initial_channel": 64,
        "resblock_kernel_sizes": [3, 5, 7],
        "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]},
    "resblock1_dilations": {
        "resblock": "1", "upsample_rates": [8, 8, 4],
        "upsample_kernel_sizes": [16, 16, 8],
        "upsample_initial_channel": 32,
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 2, 4]] * 3},
    "resblock1_prefix": {
        "resblock": "1", "upsample_rates": [8, 8, 4],
        "upsample_kernel_sizes": [16, 16, 8],
        "upsample_initial_channel": 32,
        "resblock_kernel_sizes": [3, 7],
        "resblock_dilation_sizes": [[1, 3, 5]] * 2},
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_jax(name, monkeypatch):
    """The port routes a stage to ops/mrf.py exactly where the JAX package
    routes it to Pallas (_mrf_is_pallas_compatible), and runs the other
    generators as a chain of convs (the hand kernels are never called);
    the waveform within 1e-4 of its scale (the vocoder parity limit)."""
    h = GENERATORS[name]
    params = hifigan_generator_init(jax.random.PRNGKey(2), h)
    gen = hifigan_from_jax(np_tree(params), h)
    meta = params["_meta"]
    compatible = _mrf_is_pallas_compatible(
        meta, meta["resblock_kernel_sizes"], meta["resblock_dilation_sizes"])
    assert gen.mrf_kernels == compatible == (name == "resblock1_prefix")
    calls = []
    real_mrf = hifigan.mrf

    def counted(x, weights):
        calls.append(x.shape)
        return real_mrf(x, weights)
    monkeypatch.setattr(hifigan, "mrf", counted)
    mel = np.random.default_rng(0).standard_normal((2, 20, 80)).astype(
        np.float32)
    ref = np.asarray(hifigan_generator_apply(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = gen(torch.as_tensor(mel)).numpy()
    assert len(calls) == (len(h["upsample_rates"]) if compatible else 0)
    assert got.shape == ref.shape == (2, 20 * 256)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_state_dict_both_ways(name):
    """generator_to_reference equals the JAX package's
    hifigan_generator_to_torch key for key (ResBlock2: convs.{m} only);
    generator_from_reference reads it back, and old flat resblocks.N keys
    too, to the same weights."""
    h = GENERATORS[name]
    params = hifigan_generator_init(jax.random.PRNGKey(3), h)
    gen = hifigan_from_jax(np_tree(params), h)
    want = hifigan_generator_to_torch(params)
    got = generator_to_reference(gen)
    assert sorted(got) == sorted(want)
    if h["resblock"] == "2":
        assert not any("convs1" in k or "convs2" in k for k in got)
        assert any(".convs.1." in k for k in got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    n_k = len(h["resblock_kernel_sizes"])
    flat = {}
    for k, v in want.items():
        parts = k.split(".")
        if parts[0] == "resblocks":
            k = ".".join(["resblocks", str(int(parts[1]) * n_k
                                           + int(parts[2]))] + parts[3:])
        flat[k] = v
    for sd in (want, flat) if n_k == 3 else (want,):
        back = generator_from_reference(sd, h)
        for (n1, p1), (n2, p2) in zip(gen.named_parameters(),
                                      back.named_parameters()):
            assert n1 == n2
            torch.testing.assert_close(p2, p1, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the CLI against the JAX package's
# ---------------------------------------------------------------------------

# the ResBlock2 vocoder of tests/test_cli_voice_conversion.py
HIFIGAN_SMALL = {
    "resblock": "2",
    "upsample_rates": [8, 8, 4],
    "upsample_kernel_sizes": [16, 16, 8],
    "upsample_initial_channel": 48,
    "resblock_kernel_sizes": [3, 7],
    "resblock_dilation_sizes": [[1, 3], [1, 3]],
    "gaussian_blur": {"p_blurring": 0.0},
}
# lengths whose collated frames (a multiple of 16) reach the decode's frame
# budget (a multiple of 32): 61, 91 and 59 frames. The JAX CLI slices the
# injected features to the budget and fails where the batch is shorter;
# the port zero-pads them (test_injected_features_padded)
UTTERANCES = [("a", "Hello there, general.", "ljs", 0.7),
              ("b", "The cat sat on the mat.", "other", 1.05),
              ("c", "Testing one two three.", "ljs", 0.68)]


def _audible_resblock2():
    """normal(0, 0.01) convs give a waveform of scale ~1e-6: scale the
    non-resblock convs 10x and draw every bias, so the audio reaches the
    tanh's range."""
    voc = hifigan_generator_init(jax.random.PRNGKey(4), HIFIGAN_SMALL)
    rng = np.random.default_rng(6)

    def fix(conv, gain):
        conv["w"] = jnp.asarray(np.asarray(conv["w"]) * gain)
        conv["b"] = jnp.asarray(
            rng.normal(0, 0.05, conv["b"].shape).astype(np.float32))

    for conv in [voc["conv_pre"], *voc["ups"], voc["conv_post"]]:
        fix(conv, 10.0)
    for stage in voc["resblocks"]:
        for block in stage:
            for conv in block["convs"]:
                fix(conv, 1.0)
    return voc


def write_vc_fixtures(root):
    """A shrunk config_ljs_dap.json model written by the JAX package's
    exporter, the ResBlock2 vocoder written by the port's
    generator_to_reference, three int16 wavs and the config whose
    training and validation filelists name them. Returns the paths."""
    config = ljs_small_config()
    cfg = config["model_config"]
    cfg["n_speakers"] = 2       # the filelist names two
    params = _converge_spectral_norms(
        radtts_init(jax.random.PRNGKey(0), copy.deepcopy(cfg)))
    rng = np.random.default_rng(5)
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.002, end["w"].shape).astype(np.float32))
    # voiced frames, so that predicted f0 passes --filter_invalid at once
    dense = params["v_pred_module"]["feat"]["dense"]
    dense["b"] = jnp.full_like(dense["b"], 3.0)
    paths = {k: str(root / name) for k, name in (
        ("config", "config.json"), ("radtts", "radtts.pt"),
        ("vocoder", "hifigan.pt"), ("vocoder_config", "hifigan.json"))}
    jax_export(paths["radtts"], params, iteration=1)
    gen = hifigan_from_jax(np_tree(_audible_resblock2()), HIFIGAN_SMALL)
    torch.save({"generator": generator_to_reference(gen)}, paths["vocoder"])
    with open(paths["vocoder_config"], "w") as f:
        json.dump(HIFIGAN_SMALL, f)
    (root / "wavs").mkdir()
    rows = []
    for i, (name, text, speaker, seconds) in enumerate(UTTERANCES):
        t = np.arange(int(SR * seconds)) / SR
        y = (0.4 * np.sin(2 * np.pi * (170 + 40 * i) * t)
             * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
             + 0.02 * rng.standard_normal(len(t)))
        wavfile.write(root / "wavs" / f"{name}.wav", SR,
                      (y * 32767).astype(np.int16))
        rows.append(f"{name}.wav|{text}|{speaker}")
    (root / "list.txt").write_text("\n".join(rows) + "\n")
    dc = config["data_config"]
    dc["training_files"] = {"LJS": {"basedir": str(root), "audiodir": "wavs",
                                    "filelist": "list.txt", "lmdbpath": ""}}
    dc["validation_files"] = dc["training_files"]
    dc["betabinom_cache_path"] = str(root / "cache")
    with open(paths["config"], "w") as f:
        json.dump(config, f)
    return paths


@pytest.fixture(scope="module")
def vc_fixtures(tmp_path_factory):
    """write_vc_fixtures' files (a 0.4 GB checkpoint), removed when the
    module ends."""
    root = tmp_path_factory.mktemp("vc")
    yield write_vc_fixtures(root)
    shutil.rmtree(root, ignore_errors=True)


def vc_args(paths, out_dir, *extra):
    return ["-r", paths["radtts"], "-c", paths["config"],
            "-v", paths["vocoder"], "-k", paths["vocoder_config"],
            "-o", str(out_dir), "--sigma", "0", *extra]


MODES = {
    "injected": ["-n", "2", "--shuffle", "--seed", "5", "--save_mels",
                 "--save_features", "--f0_mean", "160"],
    "predicted": ["-n", "1", "--predict_features", "--filter_invalid",
                  "--save_features", "--seed", "3"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_jax_voice_conversion(vc_fixtures, tmp_path, mode,
                                          monkeypatch):
    """Both CLIs on the same files write the same file names; the
    waveforms within 1e-4 and of equal length (equal durations from MAS),
    the mels and features within the decode parity bounds. The port's
    --filter_invalid takes one pass (the DAPs are deterministic)."""
    paths = vc_fixtures
    extra = MODES[mode]
    env = dict(os.environ, JAX_PLATFORMS="cpu", RADTTS_JAX_CACHE="off",
               OMP_NUM_THREADS="1")
    jax_out = tmp_path / "jax"
    result = subprocess.run(
        [sys.executable, "inference_voice_conversion.py",
         *vc_args(paths, jax_out, *extra)],
        capture_output=True, text=True, env=env, timeout=900, cwd=REPO)
    assert result.returncode == 0, result.stderr[-4000:]

    checks = []
    real_check = vc.is_feature_invalid

    def once(x, max_val):
        checks.append(max_val)
        assert len(checks) <= 2, "--filter_invalid drew again"
        return real_check(x, max_val)
    monkeypatch.setattr(vc, "is_feature_invalid", once)
    port_out = tmp_path / "port"
    written = vc.main(vc_args(paths, port_out, *extra, "--device", "cpu"))
    names = sorted(os.listdir(port_out))
    assert names == sorted(os.listdir(jax_out))
    assert sorted(os.path.basename(p) for p in written) == [
        n for n in names if n.endswith(".wav")]
    n_utts = int(extra[extra.index("-n") + 1])
    assert len(written) == n_utts
    assert len(checks) == (2 if mode == "predicted" else 0)
    for name in names:
        if name.endswith(".wav"):
            sr_p, got = wavfile.read(port_out / name)
            sr_j, want = wavfile.read(jax_out / name)
            assert sr_p == sr_j == SR
            assert got.dtype == want.dtype == np.float32
            assert got.shape == want.shape, name
            assert np.isfinite(got).all() and np.abs(got).max() > 1e-2
            assert np.abs(got - want).max() <= 1e-4, name
        else:
            got, want = np.load(port_out / name), np.load(jax_out / name)
            assert got.shape == want.shape, name
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(got - want).max() <= 1e-3 * scale, name


def test_injected_features_padded():
    """A feature shorter than the frame budget is zero-padded to it, a
    longer one cut."""
    a = np.arange(1, 81, dtype=np.float32)[None]
    got = vc._frames(a, 96, "cpu")
    assert got.shape == (1, 96) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[0, :80].numpy(), a[0])
    assert not got[0, 80:].any()
    np.testing.assert_array_equal(vc._frames(a, 64, "cpu").numpy(),
                                  a[:, :64])


def test_cli_shuffle_order(vc_fixtures, tmp_path, capsys):
    """--shuffle --seed S visits the validation set in the JAX loader's
    order (radtts_tpu/data/dataset.py: a permutation from
    default_rng(seed + epoch))."""
    from radtts_tpu.data.dataset import DataLoader as JaxLoader
    from radtts_tpu_torch.data.dataset import DataLoader

    for seed in (0, 5, 1234):
        ds = list(range(len(UTTERANCES)))
        want = [list(b) for b in JaxLoader(
            ds, 1, list, shuffle=True, seed=seed)._indices()]
        got = [list(b) for b in DataLoader(
            ds, 1, list, shuffle=True, seed=seed)._indices()]
        assert got == want
    capsys.readouterr()
    out = vc.main(vc_args(vc_fixtures, tmp_path, "-n", "3", "--shuffle",
                          "--seed", "5", "--no_audio", "--save_mels",
                          "--device", "cpu"))
    assert out == []
    visited = [ln.split()[2] for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("sample ")]
    order = np.random.default_rng(5).permutation(len(UTTERANCES))
    assert visited == [UTTERANCES[i][0] for i in order]
    assert list(order) != sorted(order)
    assert len(os.listdir(tmp_path)) == len(UTTERANCES)


def test_cli_precision_flags(vc_fixtures, tmp_path, monkeypatch):
    """--use_amp runs the bf16 regions and --weight_dtype bfloat16 stores
    the RADTTS conv kernels in bf16 (the encoder's stay fp32); the mel
    moves from fp32's by less than 5e-2 of its scale (the AMP tests
    bound it against JAX's own distance). --matmul_precision default runs
    too; on the CPU, which computes fp32 at every setting, its mel equals
    fp32's."""
    from radtts_tpu_torch.models import coupling
    from radtts_tpu_torch.ops import fold_norms

    casts, stored = [], []
    real_cast, real_store = coupling.cast_in, fold_norms.store_conv_weights
    monkeypatch.setattr(coupling, "cast_in", lambda x, on: casts.append(
        real_cast(x, on).dtype) or real_cast(x, on))
    monkeypatch.setattr(fold_norms, "store_conv_weights",
                        lambda m: stored.append(real_store(m)) or m)
    mels = {}
    for name, flags in (("fp32", []), ("bf16", [
            "--use_amp", "--weight_dtype", "bfloat16"]),
            ("default", ["--matmul_precision", "default"])):
        out = tmp_path / name
        vc.main(vc_args(vc_fixtures, out, "-n", "1", "--no_audio",
                        "--save_mels", "--device", "cpu", *flags))
        (mel,) = os.listdir(out)
        mels[name] = np.load(out / mel)
    assert torch.bfloat16 in casts and len(stored) == 1
    assert any(p.dtype == torch.bfloat16 for p in stored[0].parameters())
    assert all(p.dtype == torch.float32
               for p in stored[0].encoder.parameters())
    d = np.abs(mels["bf16"] - mels["fp32"]).max()
    assert 0 < d < 5e-2 * np.abs(mels["fp32"]).max(), d
    np.testing.assert_array_equal(mels["default"], mels["fp32"])


def test_cli_refuses_matmul_precision(tmp_path, capsys):
    with pytest.raises(SystemExit) as err:
        vc.main(vc_args({k: str(tmp_path / k) for k in (
            "radtts", "config", "vocoder", "vocoder_config")},
            tmp_path / "o", "--matmul_precision", "bfloat16"))
    assert err.value.code == 2
    assert "highest" in capsys.readouterr().err

