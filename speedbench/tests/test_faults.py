"""A whole run, its look for a card skipped, with the timed path broken
underneath: `correct` must come out false for each fault a cell can have,
and true without one. Small configurations on the CPU, the full-size
configurations' limits.

Faults: a layer that returns its input unchanged (the MRF; the AGAP
scan), half of each
batch left out (its outputs copied from the other half), an answer
altered where it is produced (a duration; a waveform), and a call that
returns fewer waveforms than it was given texts. A one-card cell has no
exchange between cards to leave out."""

import numpy as np
import pytest

from speedbench.run import run_cell
from speedbench.tests.tiny import small_spec

SEED = 2 ** 31 + 17


def spec(name):
    s = small_spec(name)
    s["config"]["assumed"]["calibration"]["mean_duration_frames"] = 2.0
    return s


def mrf_identity(monkeypatch):
    from radtts_tpu_torch.models import hifigan

    def hook(synth):
        monkeypatch.setattr(hifigan, "mrf", lambda x, weights: x)
    return hook


def scan_identity(monkeypatch):
    from radtts_tpu_torch.models import attributes

    def hook(synth):
        monkeypatch.setattr(attributes, "ar_scan_multi",
                            lambda problems: [r for _, r, _ in problems])
    return hook


def half_batch(monkeypatch):
    def hook(synth):
        orig = synth._synthesize

        def first_half(texts, speaker, **kw):
            k = (len(texts) + 1) // 2
            wavs, aux = orig(texts[:k], speaker, **kw)
            rows = [j % k for j in range(len(texts))]
            wavs = [wavs[j] for j in rows]
            aux = {key: np.asarray(v)[rows] for key, v in aux.items()}
            return wavs, aux
        monkeypatch.setattr(synth, "_synthesize", first_half, raising=False)
    return hook


def altered(what):
    def make(monkeypatch):
        def hook(synth):
            orig = synth._synthesize

            def wrong(texts, speaker, **kw):
                wavs, aux = orig(texts, speaker, **kw)
                if what == "dur":
                    aux["dur"][0, 0] += 1
                elif what == "wav":
                    wavs[0] = wavs[0] * 0.99
                else:
                    wavs = wavs[:-1]
                return wavs, aux
            monkeypatch.setattr(synth, "_synthesize", wrong, raising=False)
        return hook
    return make


@pytest.mark.parametrize("name", ["ljs_dap_hifigan_v1",
                                  "ljs_agap_hifigan_v1"])
def test_a_sound_run_is_correct(name):
    result = run_cell(spec(name), SEED, 1.0, False, device="cpu")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [mrf_identity, half_batch, altered("dur"),
                                   altered("wav"), altered("count")],
                         ids=["mrf_identity", "half_batch", "dur_altered",
                              "wav_altered", "wav_missing"])
def test_a_broken_offline_run_is_not_correct(fault, monkeypatch):
    result = run_cell(spec("ljs_dap_hifigan_v1"), SEED, 1.0, False,
                      device="cpu", hook=fault(monkeypatch))
    assert not result["correct"], result["checks"]


def test_a_broken_agap_scan_is_not_correct(monkeypatch):
    result = run_cell(spec("ljs_agap_hifigan_v1"), SEED, 1.0,
                      False, device="cpu", hook=scan_identity(monkeypatch))
    assert not result["correct"], result["checks"]
