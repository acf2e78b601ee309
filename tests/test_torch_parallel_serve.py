"""data_parallel serving in the port, on the CPU (two replicas on the CPU
stand for two cards): the Synthesizer's, as the JAX engine's own test
holds it (tests/test_parallel.py:337-372): an exact-multiple batch gives
data_parallel=1's durations and audio, a batch that is not one pads by
repeating its last text and returns only the requested wavs, and too few
devices raise; then python -m radtts_tpu_torch.inference and .serve with
--data_parallel 2 --device cpu."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.test_torch_inference_cli import cli_args
from tests.test_torch_synthesizer import H_SMALL, _encode, _parts

from radtts_tpu_torch import inference
from radtts_tpu_torch.export import export_torch_checkpoint
from radtts_tpu_torch.models.hifigan import generator_to_reference
from radtts_tpu_torch.synthesizer import Synthesizer, replica_devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True)
def one_thread():
    """This file's small models run on one intra-op thread: where the
    suite's workers share the cores, OpenMP's barriers stall its many
    short ops (a 4 s test took 169 s at 8 threads a worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TEXTS = ["Exact multiple.", "Second line.", "Third of four.",
         "Fourth one!"]


def synth(data_parallel, **kw):
    parts = _parts("cpu")
    if data_parallel > 1:
        parts["devices"] = ["cpu"] * data_parallel
    return Synthesizer.from_parts(**parts, data_parallel=data_parallel,
                                  **kw)


def test_data_parallel_matches_single():
    """Four texts over two replicas (sigma 0.8: the decoder's noise is
    drawn once for the batch and sliced) equal data_parallel=1: the same
    durations, the audio within rtol 1e-3, atol 1e-4; three texts pad to
    four and give three wavs, each equal to its row of the padded batch
    at data_parallel=1."""
    one, two = synth(1), synth(2)
    assert [r[0] for r in two.replicas] == [torch.device("cpu")] * 2
    assert two.replicas[0][1] is two.replicas[1][1]   # one device: shared
    w1, a1 = one.synthesize(TEXTS, "spk", denoising_strength=0.01)
    w2, a2 = two.synthesize(TEXTS, "spk", denoising_strength=0.01)
    np.testing.assert_array_equal(a2["dur"], a1["dur"])
    np.testing.assert_array_equal(a2["n_frames"], a1["n_frames"])
    for x, y in zip(w2, w1):
        assert len(x) == len(y) and np.abs(y).max() > 0.05
        np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-4)
    for k in ("f0", "energy_avg"):
        np.testing.assert_allclose(a2[k], a1[k], rtol=1e-3, atol=1e-4)

    padded = TEXTS[:3] + TEXTS[2:3]
    w1, a1 = synth(1).synthesize(padded, "spk")
    w3, a3 = synth(2).synthesize(TEXTS[:3], "spk")
    assert len(w3) == 3 and a3["dur"].shape[0] == 3
    assert a3["f0"].shape[0] == 3
    np.testing.assert_array_equal(a3["dur"], a1["dur"][:3])
    for x, y in zip(w3, w1[:3]):
        np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-4)


def test_too_few_devices_raise(monkeypatch):
    """data_parallel N needs N visible cards (without explicit devices),
    as the JAX engine raises; explicit devices must number N."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        synth_parts = _parts(None)
        Synthesizer.from_parts(**synth_parts, data_parallel=2)
    with pytest.raises(ValueError, match="but 1 devices were given"):
        replica_devices(2, ["cpu"])
    assert replica_devices(3, device="cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert replica_devices(2) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]


def test_single_text_buckets_alone():
    """One text at data_parallel=2 pads to two rows and returns one wav
    of its own length."""
    wavs, aux = synth(2).synthesize("Short one!", "spk")
    assert len(wavs) == 1 and aux["dur"].shape == (1, 16)
    assert len(wavs[0]) == aux["n_frames"][0] * 256
    assert aux["dur"][0, len(_encode("Short one!")):].sum() == 0


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The CLIs' files for _parts' small model and vocoder: a reference
    checkpoint by the port's exporter, the vocoder's, config_ljs_dap.json
    with the small model config and a one-speaker filelist, three
    lines."""
    root = tmp_path_factory.mktemp("dp_cli")
    parts = _parts("cpu")
    paths = {k: str(root / name) for k, name in (
        ("config", "config.json"), ("radtts", "radtts.pt"),
        ("vocoder", "hifigan.pt"), ("vocoder_config", "hifigan.json"),
        ("text", "lines.txt"))}
    export_torch_checkpoint(paths["radtts"], parts["model"])
    torch.save({"generator": generator_to_reference(parts["vocoder"])},
               paths["vocoder"])
    with open(paths["vocoder_config"], "w") as f:
        json.dump(H_SMALL, f)
    with open(os.path.join(REPO, "configs", "config_ljs_dap.json")) as f:
        config = json.load(f)
    config["model_config"] = parts["model_config"]
    (root / "list.txt").write_text("a.wav|hello there|ljs\n")
    dc = config["data_config"]
    dc["training_files"] = {"LJS": {"basedir": str(root), "audiodir": "wavs",
                                    "filelist": "list.txt", "lmdbpath": ""}}
    dc["validation_files"] = dc["training_files"]
    with open(paths["config"], "w") as f:
        json.dump(config, f)
    (root / "lines.txt").write_text("The quick brown fox.\nShort one!\n"
                                    "A third line of text.\n")
    return paths


def test_inference_cli_data_parallel(fixtures, tmp_path):
    """--data_parallel 2 --device cpu writes the files --data_parallel 1
    writes (--batch_size 2: one batch of two and one of one, padded to
    two), with the same waveforms (each normalised to 16-bit, within
    1e-3 of its peak)."""
    paths = fixtures
    extra = ["--batch_size", "2", "--device", "cpu"]
    one = inference.main(cli_args(paths, tmp_path / "one", *extra))
    two = inference.main(cli_args(paths, tmp_path / "two", *extra,
                                  "--data_parallel", "2"))
    assert [p.split("/")[-1] for p in one] == [p.split("/")[-1]
                                               for p in two]
    assert len(one) == 3
    for a, b in zip(one, two):
        wa, wb = wavfile.read(a)[1], wavfile.read(b)[1]
        assert wa.shape == wb.shape
        np.testing.assert_allclose(wb.astype(np.float32),
                                   wa.astype(np.float32), rtol=0,
                                   atol=1e-3 * np.abs(wa).max() + 1)


def test_serve_data_parallel(fixtures):
    """build_server with --data_parallel 2 --device cpu: two replicas, and
    a batch of three texts answers three wavs."""
    from radtts_tpu_torch.serve import build_server

    paths = fixtures
    server, synth_, _ = build_server([
        "-c", paths["config"], "-r", paths["radtts"],
        "-v", paths["vocoder"], "-k", paths["vocoder_config"],
        "-s", "ljs", "--port", "0", "--device", "cpu",
        "--data_parallel", "2"])
    server.server_close()
    assert synth_.data_parallel == 2 and len(synth_.replicas) == 2
    wavs, aux = synth_.synthesize(["Short one!", "Hello there.", "Hi."],
                                  "ljs", sigma=0.0)
    assert len(wavs) == 3 and all(np.isfinite(w).all() for w in wavs)
