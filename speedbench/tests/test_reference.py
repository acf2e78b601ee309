"""The frozen reference against the program at a small size on the CPU:
the same seeded weights, texts and noise, one text and a ragged batch,
for the DAP and the AGAP configuration."""

import numpy as np
import pytest

from speedbench import check, system
from speedbench.calibrate import calibrate
from speedbench.reference import radtts as ref
from speedbench.reference.text import TextProcessing
from speedbench.spans import Recorder
from speedbench.tests.tiny import small_config
from speedbench.weights import make_weights

TEXTS = ["The quick brown fox jumps over the lazy dog.",
         "Printing, in the only sense with which we are at present "
         "concerned, differs from most if not from all the arts.",
         "It is well known."]
# fp32 on both sides, on the same CPU: rounding alone separates them
TOLERANCE = {"dur_gap": 1e-5, "voice_gap": 1e-5, "f0_err": 1e-5,
             "logf0_err": 1e-5, "energy_err": 1e-5, "wav_err": 1e-4}


@pytest.fixture(scope="module", params=["ljs_dap_hifigan_v1",
                                        "ljs_agap_hifigan_v1"])
def system_and_judge(request):
    config = small_config(request.param)
    config["assumed"]["calibration"]["mean_duration_frames"] = 2.0
    mc, h = config["model_config"], config["vocoder"]["config"]
    W = make_weights(ref.parameter_specs(mc, h), 5, "cpu",
                     config["assumed"]["init"])
    calibrate(W, config, "cpu",
              system.text_processing(TextProcessing, config["data_config"]),
              5)
    synth = system.build(config, W, "cpu", "highest")
    recorder = Recorder(5, False, "cpu")
    recorder.install(synth)
    recorder.phase = "window"
    return synth, recorder, check.Judge(config, W, "cpu")


@pytest.mark.parametrize("texts", [TEXTS[:1], TEXTS])
def test_reference_matches_the_program(system_and_judge, texts):
    synth, recorder, judge = system_and_judge
    wavs, aux = synth.synthesize(texts, "ljs", sigma=0.8)
    assert all(len(w) == int(n) * 256 for w, n in zip(wavs, aux["n_frames"]))
    assert np.all(aux["n_frames"] > 0)
    readings = judge.readings(recorder.dispatches[-1])
    for k, v in readings.items():
        assert v <= TOLERANCE[k], (k, v)


def test_reference_sees_another_noise(system_and_judge):
    # the same call judged as if drawn from another seed: the waveforms
    # no longer match
    synth, recorder, judge = system_and_judge
    synth.synthesize(TEXTS, "ljs", sigma=0.8)
    d = dict(recorder.dispatches[-1], gen_seed=recorder.dispatches[-1]
             ["gen_seed"] + 1)
    assert judge.readings(d)["wav_err"] > 1e-2
