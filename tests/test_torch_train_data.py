"""The port's training data pipeline against the JAX package's on the same
int16 wavs: Data.__getitem__ (mel, pYIN f0 and voicing, energy, text,
the beta-binomial prior), its caches, DataCollate's padded batch and the
DataLoader's seeded order, bit for bit (both are numpy on the host)."""

import numpy as np
import pytest
from scipy.io import wavfile

from radtts_tpu.data import dataset as jax_dataset

from radtts_tpu_torch.data import dataset
from radtts_tpu_torch.data.pyin import _viterbi_log
from radtts_tpu_torch.native import viterbi_log_native

SR = 22050
TEXTS = ["The cat sat.", "A big dog ran fast!", "Hello world again.",
         "Testing one two three.", "Printing, in the only sense."]
DATA_CONFIG = {
    "dur_min": 0.05, "dur_max": 10.0, "sampling_rate": SR,
    "filter_length": 1024, "hop_length": 256, "win_length": 1024,
    "n_mel_channels": 80, "mel_fmin": 0.0, "mel_fmax": 8000.0,
    "f0_min": 80.0, "f0_max": 640.0, "max_wav_value": 32768.0,
    "use_f0": True, "use_log_f0": False, "use_energy_avg": True,
    "use_scaled_energy": True, "symbol_set": "radtts",
    "cleaner_names": ["radtts_cleaners"],
    "heteronyms_path": "radtts_tpu/text/assets/heteronyms",
    "phoneme_dict_path": "radtts_tpu/text/assets/cmudict-0.7b",
    "p_phoneme": 1.0, "handle_phoneme": "word",
    "handle_phoneme_ambiguous": "ignore", "include_speakers": None,
    "n_frames": -1, "use_attn_prior_masking": True,
    "prepend_space_to_text": True, "append_space_to_text": True,
    "add_bos_eos_to_text": False, "betabinom_scaling_factor": 1.0,
    "distance_tx_unvoiced": False, "mel_noise_scale": 0.0,
    "lmdb_cache_path": "",
}


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        t = np.arange(int(SR * (0.5 + 0.15 * i))) / SR
        hz = 140 + 35 * i
        y = (0.4 * np.sin(2 * np.pi * hz * t) * (t > 0.1)
             + 0.02 * rng.standard_normal(len(t)))
        wavfile.write(root / "wavs" / f"u{i}.wav", SR,
                      (y * 32767).astype(np.int16))
        rows.append(f"u{i}.wav|{text}|spk{i % 2}")
    (root / "train.txt").write_text("\n".join(rows) + "\n")
    return root


def make(module, root, cache):
    files = {"T": {"basedir": str(root), "audiodir": "wavs",
                   "filelist": "train.txt", "lmdbpath": ""}}
    return module.Data(files, betabinom_cache_path=str(cache), **DATA_CONFIG)


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_getitem_bit_equal_to_jax_and_cached(wavs, tmp_path):
    ref = make(jax_dataset, wavs, tmp_path / "jax")
    port = make(dataset, wavs, tmp_path / "port")
    assert port.speaker_ids == ref.speaker_ids and len(port) == len(ref)
    for i in range(len(ref)):
        want = ref[i]
        assert want["f0"].max() > 0            # voiced frames were found
        assert_items_equal(port[i], want)
    # the port's caches written on the first pass: read back equal
    assert len(list((tmp_path / "port").iterdir())) == 2 * len(ref)
    for i in range(len(ref)):
        assert_items_equal(port[i], ref[i])


def test_collate_and_loader_bit_equal_to_jax(wavs, tmp_path):
    ref = make(jax_dataset, wavs, tmp_path / "c")
    port = make(dataset, wavs, tmp_path / "c")
    batch = dataset.DataCollate()([port[i] for i in (0, 3, 1)])
    want = jax_dataset.DataCollate()([ref[i] for i in (0, 3, 1)])
    assert batch["text"].shape[1] % 16 == 0 and \
        batch["mel"].shape[1] % 16 == 0
    assert_items_equal(batch, want)
    loaders = [m.DataLoader(d, 2, m.DataCollate(), shuffle=True, seed=7,
                            rank=1, world_size=2, num_workers=2)
               for m, d in ((dataset, port), (jax_dataset, ref))]
    loaders[0].set_epoch(3)
    loaders[1].set_epoch(3)
    assert all(np.array_equal(a, b) for a, b in zip(
        loaders[0]._indices(), loaders[1]._indices()))
    got, want = list(loaders[0]), list(loaders[1])
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert_items_equal(g, w)


def test_beta_binomial_prior_equals_jax():
    for p, m in ((5, 40), (17, 203), (1, 3)):
        np.testing.assert_array_equal(
            dataset.beta_binomial_prior_distribution(p, m, 1.0),
            jax_dataset.beta_binomial_prior_distribution(p, m, 1.0))


def test_native_viterbi_matches_numpy_path(monkeypatch):
    """The port's C++ Viterbi (g++ into build/radtts_tpu_torch/ at first
    use) against pyin's numpy loop on a random HMM."""
    rng = np.random.default_rng(2)
    T, S = 40, 12
    log_obs = np.log(rng.random((T, S)))
    trans = rng.random((S, S))
    log_trans = np.log(trans / trans.sum(1, keepdims=True))
    log_init = np.log(np.full(S, 1.0 / S))
    native = viterbi_log_native(log_obs, log_trans, log_init)
    assert native is not None
    import radtts_tpu_torch.native as native_mod
    monkeypatch.setattr(native_mod, "viterbi_log_native", lambda *a: None)
    plain = _viterbi_log(log_obs, log_trans, log_init)
    np.testing.assert_array_equal(native, plain)
