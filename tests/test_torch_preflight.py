"""python -m radtts_tpu_torch.data (the dataset preflight) against the
repository's data.py (-j 2 against -j 1), on a tiny seeded filelist: the same
cache files, byte for byte."""

import json
import os
import subprocess
import sys
import zipfile

from tests.test_torch_train_data import DATA_CONFIG, wavs  # noqa: F401

from radtts_tpu_torch.data.preflight import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(root, cache, path):
    files = {"T": {"basedir": str(root), "audiodir": "wavs",
                   "filelist": "train.txt", "lmdbpath": ""}}
    config = {"data_config": dict(DATA_CONFIG, training_files=files,
                                  validation_files=files,
                                  betabinom_cache_path=str(cache))}
    path.write_text(json.dumps(config))
    return str(path)


def _contents(cache):
    """{file name: bytes}; an .npz's members' bytes (the container also
    records its write time)."""
    out = {}
    for name in sorted(os.listdir(cache)):
        path = os.path.join(cache, name)
        if name.endswith(".npz"):
            with zipfile.ZipFile(path) as z:
                out[name] = {m: z.read(m) for m in sorted(z.namelist())}
        else:
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def test_preflight_writes_the_caches_data_py_writes(wavs, tmp_path):  # noqa
    """Both CLIs as a user runs them (the port's spawn pool of 2 workers
    started from `python -m`); every utterance's i/n printed once a set."""
    n = len((wavs / "train.txt").read_text().splitlines())
    runs = {}
    for name, argv in (
            ("port", [sys.executable, "-m", "radtts_tpu_torch.data", "-j",
                      "2"]),
            ("jax", [sys.executable, "data.py", "-j", "1"])):
        cfg = _config(wavs, tmp_path / name, tmp_path / f"{name}.json")
        runs[name] = subprocess.run(
            argv + ["-c", cfg], cwd=REPO, check=True, capture_output=True,
            text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    printed = [ln for ln in runs["port"].stdout.splitlines()
               if "/" in ln and ln[0].isdigit()]
    assert sorted(printed) == sorted([f"{i}/{n}" for i in range(n)] * 2)
    got, want = _contents(tmp_path / "port"), _contents(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert sum(k.endswith("_prior.npy") for k in got) >= 1
    assert sum(k.endswith(".npz") for k in got) == n
    for name in want:
        assert got[name] == want[name], name


def test_preflight_main_returns_the_set_sizes(wavs, tmp_path):  # noqa
    """main(argv) in the calling process, serially (-j 1): the sizes of the
    training and validation sets, every cache file written."""
    n = len((wavs / "train.txt").read_text().splitlines())
    cfg = _config(wavs, tmp_path / "cache", tmp_path / "c.json")
    assert main(["-c", cfg, "-j", "1"]) == [n, n]
    assert sum(k.endswith(".npz") for k in os.listdir(tmp_path / "cache")) \
        == n
