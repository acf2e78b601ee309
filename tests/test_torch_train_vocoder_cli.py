"""The port's vocoder training CLI (python -m radtts_tpu_torch.train_vocoder)
on the CPU, on a seeded wav dataset written to a temp dir: the generator
checkpoint it writes loads in the JAX package, and a run resumed from its
full-state checkpoint continues the uninterrupted run bit for bit (segments
and blur draws are keyed by the iteration; the checkpoint holds both
discriminators and both optimizers).
"""

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from radtts_tpu.models.hifigan import (hifigan_generator_apply,
                                       hifigan_generator_from_torch)
from tests.test_torch_checkpoint import tmp_path  # noqa: F401

from radtts_tpu_torch.train_vocoder import main
from radtts_tpu_torch.train.vocoder_trainer import vocoder_train_init

REPO = pathlib.Path(__file__).resolve().parents[1]
H32 = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 32,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
    "gaussian_blur": {"p_blurring": 0.5},
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two seeded int16 wavs (sines plus noise), a filelist, the radtts
    config repointed at it, and the HiFi-GAN config."""
    root = tmp_path_factory.mktemp("vocoder_data")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i, hz in enumerate((220.0, 330.0)):
        t = np.arange(11025) / 22050
        w = 0.4 * np.sin(2 * np.pi * hz * t) + 0.05 * rng.standard_normal(
            t.shape)
        wavfile.write(root / "wavs" / f"{i}.wav", 22050,
                      (w * 32767).astype(np.int16))
        names.append(f"{i}.wav|text|ljs")
    (root / "train.txt").write_text("\n".join(names) + "\n")
    config = json.loads((REPO / "configs" / "config_ljs_dap.json").read_text())
    config["data_config"]["training_files"] = {
        "T": {"basedir": str(root), "audiodir": "wavs",
              "filelist": "train.txt"}}
    (root / "config.json").write_text(json.dumps(config))
    (root / "hifigan.json").write_text(json.dumps(H32))
    return root


def run(dataset, out, steps, *extra):
    return main(["-c", str(dataset / "config.json"),
                 "-k", str(dataset / "hifigan.json"), "-o", str(out),
                 "--steps", str(steps), "--batch_size", "1",
                 "--segment_size", "2048", "--log_interval", "1",
                 "--device", "cpu", "--seed", "5", *extra])


@pytest.fixture(scope="module")
def straight(dataset, tmp_path_factory):
    """Two steps from scratch; their do_00000002.pt (0.85 GB: both full
    discriminators and both AdamW states) is read by two tests and removed
    when the module ends."""
    out = tmp_path_factory.mktemp("straight")
    yield out, run(dataset, out, 2)
    shutil.rmtree(out, ignore_errors=True)


def test_cli_writes_reference_generator(straight):
    """Two finite steps; g_00000002.pt loads through the JAX package's
    hifigan_generator_from_torch and gives the trained generator's audio
    within 1e-4 of its scale (fp32 convs summed in another order)."""
    out, history = straight
    assert [h["iteration"] for h in history] == [0, 1]
    for h in history:
        assert all(np.isfinite(h[k]) for k in (
            "loss_disc", "loss_gen", "loss_mel", "loss_fm", "loss_adv"))
    sd = torch.load(out / "g_00000002.pt")["generator"]
    params = hifigan_generator_from_torch(sd, H32)

    models = vocoder_train_init(H32)
    models.load_state_dict(torch.load(out / "do_00000002.pt")["models"])
    mel = np.random.default_rng(1).standard_normal((1, 10, 80)).astype(
        np.float32)
    ref = np.asarray(hifigan_generator_apply(params, jnp.asarray(mel)))
    with torch.no_grad():
        got = models["gen"](torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_warmstart_loads_reference_generator(dataset, straight, tmp_path,
                                             capsys):
    """--warmstart reads a {'generator': sd} checkpoint into the generator
    and trains from there."""
    out, _ = straight
    history = run(dataset, tmp_path, 1, "--warmstart",
                  str(out / "g_00000002.pt"))
    assert "warmstarted generator" in capsys.readouterr().out
    assert np.isfinite(history[0]["loss_gen"])


def test_resume_is_bit_exact(dataset, straight, tmp_path):
    """1 step, save, resume, 1 step == 2 straight steps: every weight and
    every optimizer state tensor equal."""
    out, history = straight
    run(dataset, tmp_path / "a", 1)
    resumed = run(dataset, tmp_path / "b", 2, "--resume",
                  str(tmp_path / "a" / "do_00000001.pt"))
    assert [h["iteration"] for h in resumed] == [1]
    assert resumed[0]["loss_gen"] == history[1]["loss_gen"]
    want = torch.load(out / "do_00000002.pt")
    got = torch.load(tmp_path / "b" / "do_00000002.pt")
    assert got["iteration"] == want["iteration"] == 2
    for k, v in want["models"].items():
        torch.testing.assert_close(got["models"][k], v, rtol=0, atol=0,
                                   msg=k)
    for name in ("optim_g", "optim_d"):
        for i, state in want[name]["state"].items():
            for k, v in state.items():
                torch.testing.assert_close(got[name]["state"][i][k], v,
                                           rtol=0, atol=0)
