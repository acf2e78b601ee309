"""Cells at a size a CPU test can hold: the benchmark's configurations
with their widths cut, the limits of the full-size configuration."""

import copy
import json
import os

from speedbench.run import ROOT

SMALL_MODEL = {"n_text_dim": 32, "n_flows": 4, "affine_n_channels": 32,
               "n_speaker_dim": 8}
SMALL_DAP = {"in_dim": 32, "n_channels": 16}
SMALL_AGAP = {"n_hidden": 16, "n_context_dim": 16, "n_layers": 2,
              "n_bins": 4}
SMALL_VOCODER = {"upsample_initial_channel": 32}


def small_config(name):
    with open(os.path.join(ROOT, "speedbench", "configs",
                           f"{name}.json")) as f:
        config = json.load(f)
    config = copy.deepcopy(config)
    mc = config["model_config"]
    mc.update(SMALL_MODEL)
    for key in ("dur_model_config", "v_model_config", "f0_model_config",
                "energy_model_config"):
        hp = mc[key]["hparams"]
        hp["bottleneck_hparams"]["in_dim"] = SMALL_DAP["in_dim"]
        if mc[key]["name"] == "dap":
            hp["arch_hparams"]["n_channels"] = SMALL_DAP["n_channels"]
        else:
            hp["n_hidden"] = SMALL_AGAP["n_hidden"]
            hp["spline_flow_params"].update(
                n_context_dim=SMALL_AGAP["n_context_dim"],
                n_layers=SMALL_AGAP["n_layers"], n_bins=SMALL_AGAP["n_bins"])
    config["vocoder"]["config"].update(SMALL_VOCODER)
    return config


def small_spec(config_name):
    """A cell spec (run.cell_spec's shape) of a small configuration under a
    small closed-loop mix."""
    mix = {"loop": "closed", "batch": 3, "texts": "ljs_train_texts.txt",
           "pool": 12, "pool_seed": 0, "speaker": "ljs",
           "knobs": {"sigma": 0.8, "denoising_strength": 0.0},
           "check": {"dispatches": 2}}
    e2e = [{"name": "setup_s", "unit": "s"},
           {"name": "audio_s_per_s", "unit": "audio_s/s"}]
    per_layer = [{"name": n, "unit": u} for n, u in (
        ("mel_ms.offline", "ms"), ("mfu.offline", "%"))]
    return {"cell": {"name": f"{config_name}.small", "chips": 1},
            "config": small_config(config_name), "mix": mix,
            "end_to_end": e2e, "per_layer": per_layer}
