"""The benchmark's FLOP arithmetic: the model FLOP function against the
program's own counter (radtts_tpu_torch/ops/flops.py) at a small size on
the CPU, and the MRF roofline's work and bytes at known shapes."""

import numpy as np
import pytest
import torch

from speedbench import flops, system
from speedbench.calibrate import calibrate
from speedbench.reference import radtts as ref
from speedbench.reference.text import TextProcessing
from speedbench.tests.tiny import small_config
from speedbench.weights import make_weights

TEXT = "Printing, in the only sense with which we are at present concerned."


@pytest.mark.parametrize("name", ["ljs_dap_hifigan_v1", "ljs_agap_hifigan_v1"])
def test_model_flops_match_the_programs_counter(name):
    from radtts_tpu_torch.ops import flops as port_flops

    config = small_config(name)
    config["assumed"]["calibration"]["mean_duration_frames"] = 2.0
    mc, h = config["model_config"], config["vocoder"]["config"]
    W = make_weights(ref.parameter_specs(mc, h), 3, "cpu",
                     config["assumed"]["init"])
    tp = system.text_processing(TextProcessing, config["data_config"])
    calibrate(W, config, "cpu", tp, 3)
    synth = system.build(config, W, "cpu", "highest")
    from radtts_tpu_torch.models.radtts import infer_durations, radtts_infer

    text = torch.as_tensor(synth.encode(TEXT))[None]
    spk = torch.zeros(1, dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)
    # the synthesizer's steps for one text, outside its inference mode,
    # where the counter sees each product
    with port_flops.counting() as records:
        dur = infer_durations(synth.model, spk, text)
        n_frames = int(dur.sum())
        T = ref.frame_budget(n_frames, mc["n_group_size"])
        mel = radtts_infer(synth.model, spk, text, 0.8, T, dur=dur,
                           generator=gen)["mel"]
        synth.vocoder(mel)
    counted = sum(r["flops"] for r in records)
    # the program pads the frames to a budget and runs the encoder twice;
    # its LSTMs step over the valid frames only
    got = flops.synthesis_flops(mc, h, text.shape[1], T,
                                lstm_frames=n_frames, encoder_passes=2)
    assert n_frames > 0 and got == counted


def test_mrf_stage_work_and_bytes():
    # HiFi-GAN v1's first stage at 608 frames: 4864 rows of 256 channels
    flop, nbytes = flops.mrf_stage(4864, 256)
    assert flop == 2 * 4864 * 256 * 256 * 6 * (3 + 7 + 11)
    weights = 6 * (3 + 7 + 11) * 256 * 256 + 18 * 256
    assert nbytes == 4 * (2 * 4864 * 256 + weights)
    # the work follows the rows: twice the rows, twice the FLOP
    assert flops.mrf_stage(9728, 256)[0] == 2 * flop
    # a kernel-size subset counts only its resblocks
    assert flops.mrf_stage(10, 32, (3,))[0] == 2 * 10 * 32 * 32 * 6 * 3


def test_synthesis_flops_grow_with_the_work():
    config = small_config("ljs_dap_hifigan_v1")
    mc, h = config["model_config"], config["vocoder"]["config"]
    base = flops.synthesis_flops(mc, h, 50, 300)
    assert flops.synthesis_flops(mc, h, 50, 600) > base
    assert flops.synthesis_flops(mc, h, 100, 300) > base
    assert flops.synthesis_flops(mc, h, 50, 300, encoder_passes=2) \
        - base == flops.encoder_flops(mc, 50)
    assert np.isclose(flops.vocoder_flops(h, 2) * 3,
                      flops.vocoder_flops(h, 6))
