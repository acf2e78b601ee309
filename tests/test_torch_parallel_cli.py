"""The RADTTS training CLI's main at WORLD_SIZE=2 on the CPU (gloo on the
loopback, each rank a process of tests/torch_dist_child.py's cli mode,
launched with the env contract), on the tiny dataset of
tests/test_torch_train_cli.py (its four wavs): data parallel, then with
-p dist_config.n_model=2. Rank 0 alone writes the output folder and the
checkpoints, the data ranks load disjoint rows, every rank reports the
global step (binarized, with the KL loss), and the checkpoint loads
into one process."""

import json

import numpy as np
import torch

from tests.test_torch_parallel import spawn
from tests.test_torch_train_cli import MC, config_path  # noqa: F401

from radtts_tpu_torch.models.radtts import RADTTS
from radtts_tpu_torch.train.checkpoint import load_train_checkpoint
from radtts_tpu_torch.train.optim import build_optimizer
from radtts_tpu_torch.train.trainer import (apply_trainable_mask,
                                            build_trainable_mask)


def test_training_cli_world_of_two(config_path, tmp_path):  # noqa: F811
    config = json.loads(open(config_path).read())
    config["dist_config"]["n_model"] = 1
    spec = config["data_config"]["training_files"]["T"]
    root = spec["basedir"]
    with open(f"{root}/train.txt") as f, open(f"{root}/val.txt") as g:
        rows = f.read() + g.read()
    with open(f"{root}/all.txt", "w") as f:
        f.write(rows)
    spec["filelist"] = "all.txt"
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    outs = [str(tmp_path / "dp"), str(tmp_path / "tp")]
    torch.save({"cli_argv": [
        "-c", str(path), "--device", "cpu", "-p", "train_config.epochs=1",
        "train_config.seed=3", "train_config.iters_per_checkpoint=1",
        "train_config.binarization_start_iter=0",
        "train_config.kl_loss_start_iter=0"],
        "cli_runs": [["train_config.batch_size=2"],
                     ["train_config.batch_size=4", "dist_config.n_model=2"]],
        "cli_out": outs}, tmp_path / "inputs.pt")
    results, logs = spawn("cli", tmp_path, 2, timeout=300)
    dp, tp = ([r[i] for r in results] for i in range(2))
    # data parallel: four rows, two a rank (batch_size 2 a rank): one
    # step, the ranks' rows disjoint
    (a,), (b,) = dp[0]["rows"], dp[1]["rows"]
    assert len(a) == len(b) == 2 and len(set(a) | set(b)) == 4
    # n_model=2: one data rank, so both ranks read the same four rows
    assert tp[0]["rows"] == tp[1]["rows"]
    assert [len(r) for r in tp[0]["rows"]] == [4]
    for run, out in zip((dp, tp), outs):
        history = run[0]["history"]
        assert [(h["binarize"], h["use_kl"]) for h in history] == [
            (True, True)]
        assert run[0]["writes"] == ["output_folder", "checkpoint"]
        assert run[1]["writes"] == []
        for h0, h1 in zip(history, run[1]["history"]):
            assert h0["total"] == h1["total"] and np.isfinite(h0["total"])
            assert h0["grad_norm"] == h1["grad_norm"]
        model = RADTTS(MC, factored=True)
        opt = build_optimizer(apply_trainable_mask(
            model, build_trainable_mask(model)), "RAdam", 1e-4, 1e-6)
        meta = load_train_checkpoint(f"{out}/model_0", model, opt, MC)
        assert meta["iteration"] == 0 and len(opt.state) > 0
        assert all(st["exp_avg"].shape == p.shape
                   for p, st in opt.state.items())
    assert all("backend gloo" in log for log in logs)
