"""python -m radtts_tpu_torch.inference against the JAX package's
inference.py on the CPU: the same checkpoint files (a shrunk
config_ljs_dap.json model written by the JAX package's exporter, a small
HiFi-GAN written by the port's generator_to_reference), the same text file
at sigma 0, --batch_size 2 and one line long enough for --long_text_chunk.
Both CLIs must write the same files with the same waveforms; the flags the
port cannot honour must be refused.
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
from radtts_tpu.models.radtts import radtts_init
from tests.test_torch_checkpoint import ljs_small_config
from tests.test_torch_synthesizer_parity import (DUR_BIAS, H_SMALL,
                                                 _audible_vocoder,
                                                 _converge_spectral_norms,
                                                 np_tree)

from radtts_tpu_torch import inference
from radtts_tpu_torch.convert import hifigan_from_jax
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.models.attributes import attribute_model_infer
from radtts_tpu_torch.models.hifigan import generator_to_reference
from radtts_tpu_torch.text.chunking import split_text_to_chunks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This file's small models run on one intra-op thread, its module
    fixtures included: where the suite's workers share the cores, OpenMP's
    barriers stall many short ops (tests/test_torch_parallel_serve.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LINES = [
    "# a comment line is skipped",
    "The quick brown fox jumps over the lazy dog.",
    "Short one!",
    "It is well known that deep generative models have a rich latent "
    "space. It is possible to synthesize speech with controllable "
    "attributes.",
]
CHUNK = 40      # --long_text_chunk: "Short one!" stays whole


def write_fixtures(root):
    """Checkpoint, vocoder and config files under root (a pathlib.Path).
    Returns (paths dict, JAX params, HiFi-GAN config)."""
    config = ljs_small_config()
    cfg = config["model_config"]
    params = _converge_spectral_norms(
        radtts_init(jax.random.PRNGKey(0), copy.deepcopy(cfg)))
    rng = np.random.default_rng(5)
    # the WN end convs are zero at init; sd 0.002 (the 1024-wide WN of
    # this config) keeps the vocoder's tanh out of saturation
    for flow in params["flows"]:
        end = flow["affine"]["pred"]["end"]
        end["w"] = jnp.asarray(
            rng.normal(0, 0.002, end["w"].shape).astype(np.float32))
    dense = params["dur_pred_layer"]["feat"]["dense"]
    dense["b"] = jnp.full_like(dense["b"], DUR_BIAS["durations"])

    paths = {k: str(root / name) for k, name in (
        ("config", "config.json"), ("radtts", "radtts.pt"),
        ("vocoder", "hifigan.pt"), ("vocoder_config", "hifigan.json"),
        ("text", "lines.txt"))}
    jax_export(paths["radtts"], params, iteration=1)
    gen = hifigan_from_jax(np_tree(_audible_vocoder()), H_SMALL)
    torch.save({"generator": generator_to_reference(gen)}, paths["vocoder"])
    with open(paths["vocoder_config"], "w") as f:
        json.dump(H_SMALL, f)
    # inference reads the filelist only for the speaker table
    (root / "list.txt").write_text("a.wav|hello there|ljs\n"
                                   "b.wav|general kenobi|other\n")
    dc = config["data_config"]
    dc["training_files"] = {"LJS": {"basedir": str(root), "audiodir": "wavs",
                                    "filelist": "list.txt", "lmdbpath": ""}}
    dc["validation_files"] = dc["training_files"]
    # the JAX package's dataset creates this directory
    dc["betabinom_cache_path"] = str(root / "cache")
    with open(paths["config"], "w") as f:
        json.dump(config, f)
    with open(paths["text"], "w") as f:
        f.write("\n".join(LINES) + "\n")
    return paths, params, H_SMALL


def cli_args(paths, out_dir, *extra):
    return ["-c", paths["config"], "-r", paths["radtts"],
            "-v", paths["vocoder"], "-k", paths["vocoder_config"],
            "-t", paths["text"], "-s", "ljs", "-o", str(out_dir),
            *extra]


# write_fixtures' files, kept for every module of a worker process that
# imports `fixtures`: pytest runs an imported session fixture once for each
# importing module, so the files are written once here and removed when the
# last of those modules' fixtures is torn down
_SHARED = {}


@pytest.fixture(scope="session")
def fixtures(tmp_path_factory):
    """write_fixtures' files (its checkpoint is 0.4 GB), written once a
    worker process and removed at the end of the session."""
    if not _SHARED:
        root = tmp_path_factory.mktemp("cli")
        _SHARED.update(root=root, files=write_fixtures(root), users=0)
    _SHARED["users"] += 1
    yield _SHARED["files"]
    _SHARED["users"] -= 1
    if not _SHARED["users"]:
        shutil.rmtree(_SHARED["root"], ignore_errors=True)
        _SHARED.clear()


def _assert_rounding_margin(synth, texts):
    """Durations compare exactly only where the value before rounding lies
    clear of x.5; checked on the port's side for one batch."""
    encs = [synth.encode(t) for t in texts]
    lens = [len(e) for e in encs]
    N = ((max(lens) + 15) // 16) * 16
    text = torch.zeros(len(texts), N, dtype=torch.int64)
    for j, e in enumerate(encs):
        text[j, :lens[j]] = torch.as_tensor(e)
    spk = torch.full((len(texts),), int(synth.speaker_id("ljs")))
    with torch.no_grad():
        txt_enc, _ = port.encode_text(synth.model, text,
                                      torch.as_tensor(lens))
        raw = attribute_model_infer(synth.model.dur_pred_layer, txt_enc,
                                    port.encode_speaker(synth.model, spk),
                                    torch.as_tensor(lens))
    frac = (raw[..., 0].clamp(0, 100) - torch.floor(raw[..., 0].clamp(
        0, 100))).numpy()
    for j, n in enumerate(lens):
        assert (np.abs(frac[j, :n] - 0.5) > 1e-4).all()


def test_cli_matches_jax_inference(fixtures, tmp_path, capsys):
    paths, _, _ = fixtures
    extra = ["--sigma", "0", "--batch_size", "2", "--long_text_chunk",
             str(CHUNK), "--seed", "7"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_out = tmp_path / "jax"
    result = subprocess.run(
        [sys.executable, "inference.py", *cli_args(paths, jax_out, *extra)],
        capture_output=True, text=True, env=env, timeout=600)
    assert result.returncode == 0, result.stderr[-4000:]

    port_out = tmp_path / "port"
    written = inference.main(cli_args(paths, port_out, *extra,
                                      "--device", "cpu"))
    log = capsys.readouterr().out
    assert "load phases: vocoder" in log and "to device" in log
    names = sorted(os.listdir(port_out))
    assert names == sorted(os.listdir(jax_out))
    assert sorted(os.path.basename(p) for p in written) == names
    assert len(names) == 3 and all(n.endswith(".wav") for n in names)

    # the batches of 2 as the CLI formed them, the last line in chunks
    from radtts_tpu_torch.synthesizer import Synthesizer
    with open(paths["config"]) as f:
        config = json.load(f)
    synth = Synthesizer(config, paths["radtts"], paths["vocoder"],
                        paths["vocoder_config"], device="cpu")
    items, splits = [], 0
    for i, line in enumerate(LINES[1:], 1):
        parts = split_text_to_chunks(line, lambda s: len(synth.encode(s)),
                                     CHUNK)
        if len(parts) > 1:
            splits += 1
            assert (f"{i}: split into {len(parts)} chunks (<= {CHUNK} "
                    "tokens each)") in log
        items += parts
    assert 0 < splits < len(LINES) - 1
    for b0 in range(0, len(items), 2):
        _assert_rounding_margin(synth, items[b0:b0 + 2])

    for name in names:
        sr_p, got = wavfile.read(port_out / name)
        sr_j, want = wavfile.read(jax_out / name)
        assert sr_p == sr_j == 22050
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape, name     # equal durations
        assert np.isfinite(got).all() and np.abs(got).max() == 1.0
        assert np.abs(got).mean() < 0.5          # not a saturated tanh
        assert np.abs(got - want).max() <= 1e-4, name


@pytest.mark.parametrize("flag", ["use_amp", "weight_dtype"])
@pytest.mark.parametrize("cli", ["inference", "serve"])
def test_honours_precision_flags(fixtures, tmp_path, monkeypatch, cli, flag):
    """--use_amp runs the coupling predictors' bf16 regions and
    --weight_dtype bfloat16 stores the RADTTS conv kernels in bf16, on
    both CLIs; the audio comes out finite. (Their numbers against the
    JAX package: tests/test_torch_amp.py.)"""
    from radtts_tpu_torch import synthesizer
    from radtts_tpu_torch.models import coupling

    paths, _, _ = fixtures
    casts, stored = [], []
    real_cast, real_store = coupling.cast_in, synthesizer.store_conv_weights
    monkeypatch.setattr(coupling, "cast_in", lambda x, on: casts.append(
        real_cast(x, on).dtype) or real_cast(x, on))
    monkeypatch.setattr(synthesizer, "store_conv_weights",
                        lambda m: stored.append(real_store(m)) or m)
    flags = (["--use_amp"] if flag == "use_amp"
             else ["--weight_dtype", "bfloat16"])
    text = tmp_path / "one.txt"
    text.write_text("Short one!\n")
    if cli == "inference":
        written = inference.main(cli_args(
            dict(paths, text=str(text)), tmp_path / "out", "--sigma", "0",
            "--device", "cpu", *flags))
        wav = wavfile.read(written[0])[1]
    else:
        from radtts_tpu_torch.serve import build_server
        server, synth, _ = build_server([
            "-c", paths["config"], "-r", paths["radtts"],
            "-v", paths["vocoder"], "-k", paths["vocoder_config"],
            "-s", "ljs", "--port", "0", "--device", "cpu", *flags])
        server.server_close()
        assert synth.use_amp == (flag == "use_amp")
        assert synth.weight_dtype == ("bfloat16" if flag == "weight_dtype"
                                      else "float32")
        wav = synth.synthesize("Short one!", "ljs", sigma=0.0)[0][0]
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    if flag == "use_amp":
        assert torch.bfloat16 in casts and not stored
    else:
        assert set(casts) == {torch.float32} and len(stored) == 1
        assert any(p.dtype == torch.bfloat16
                   for p in stored[0].parameters())
        assert all(p.dtype == torch.float32
                   for p in stored[0].encoder.parameters())


@pytest.mark.parametrize("flags,message", [
    (["--data_parallel", "0"], "at least 1"),
    (["--matmul_precision", "bfloat16"], "highest"),
])
@pytest.mark.parametrize("cli", ["inference", "serve"])
def test_refuses_unsupported_flags(tmp_path, capsys, cli, flags, message):
    """Refused before any file is read (the paths do not exist)."""
    if cli == "inference":
        argv = cli_args({k: str(tmp_path / k) for k in (
            "config", "radtts", "vocoder", "vocoder_config", "text")},
            tmp_path / "out", *flags)
        run = inference.main
    else:
        from radtts_tpu_torch.serve import build_server
        argv = ["-c", "c", "-r", "r", "-v", "v", "-k", "k", "-s", "ljs",
                *flags]
        run = build_server
    with pytest.raises(SystemExit) as err:
        run(argv)
    assert err.value.code == 2
    assert message in capsys.readouterr().err


def test_aot_dir_has_no_effect(capsys):
    parser = inference.build_parser()
    args = parser.parse_args(["-c", "c", "-r", "r", "-v", "v", "-k", "k",
                              "-t", "t", "-s", "ljs", "--aot_dir", "x"])
    inference.refuse_unsupported(parser, args)
    assert capsys.readouterr().out == "--aot_dir x: no effect (XLA only)\n"


def test_cli_needs_cuda_without_device(fixtures, tmp_path, monkeypatch):
    """Without --device the CLI runs on CUDA, and raises where it is
    absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths, _, _ = fixtures
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.main(cli_args(paths, tmp_path / "out"))


class FlagSpy(torch.overrides.TorchFunctionMode):
    """Records the TF32 flags (cuDNN, cuBLAS) at every torch call, by
    where it ran: inside the text encoder's forward, an inverse 1x1 conv's
    forward or inverse (the fp32 islands), or elsewhere."""

    ISLANDS = {("encoder.py", "forward"): "encoder",
               ("invertible.py", "forward"): "inv1x1",
               ("invertible.py", "inverse"): "inv1x1"}

    def __init__(self):
        super().__init__()
        self.seen = {"encoder": set(), "inv1x1": set(), "other": set()}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        where, frame = "other", sys._getframe(1)
        while frame is not None and where == "other":
            code = frame.f_code
            where = self.ISLANDS.get(
                (os.path.basename(code.co_filename), code.co_name), "other")
            frame = frame.f_back
        self.seen[where].add((torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


def test_inference_cli_takes_matmul_precision(fixtures, tmp_path):
    """--matmul_precision default runs; on the CPU, which computes fp32 at
    every setting, its wav equals highest's. The parser takes high too
    (its scope: tests/test_torch_precision.py)."""
    paths, _, _ = fixtures
    text = tmp_path / "one.txt"
    text.write_text("Short one!\n")
    wavs = {}
    for name in ("default", "highest"):
        (path,) = inference.main(cli_args(
            dict(paths, text=str(text)), tmp_path / name, "--sigma", "0",
            "--device", "cpu", "--matmul_precision", name))
        wavs[name] = wavfile.read(path)[1]
    np.testing.assert_array_equal(wavs["default"], wavs["highest"])
    args = inference.build_parser().parse_args(cli_args(
        paths, tmp_path, "--matmul_precision", "high"))
    assert args.matmul_precision == "high"


def test_serve_keeps_fp32_islands_at_default_precision(fixtures):
    """The serve CLI at --matmul_precision default: the Synthesizer keeps
    the precision through loading; inside a request TF32 is on, except in
    the text encoder and the inverse 1x1 convs (a spy on the flags at
    every torch call); after it the flags are as the load left them. On
    the CPU the audio equals highest's."""
    from radtts_tpu_torch.serve import build_server

    paths, _, _ = fixtures
    server, synth, _ = build_server([
        "-c", paths["config"], "-r", paths["radtts"],
        "-v", paths["vocoder"], "-k", paths["vocoder_config"],
        "-s", "ljs", "--port", "0", "--device", "cpu",
        "--matmul_precision", "default"])
    server.server_close()
    assert synth.matmul_precision == "default"
    assert not torch.backends.cudnn.allow_tf32
    spy = FlagSpy()
    with spy:
        got = synth.synthesize("Short one!", "ljs", sigma=0.0)[0][0]
    assert spy.seen["encoder"] == {(False, False)}, spy.seen
    assert spy.seen["inv1x1"] == {(False, False)}, spy.seen
    assert spy.seen["other"] == {(True, True)}, spy.seen
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    synth.matmul_precision = "highest"
    want = synth.synthesize("Short one!", "ljs", sigma=0.0)[0][0]
    np.testing.assert_array_equal(got, want)
