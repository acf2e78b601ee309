"""`python -m radtts_tpu_torch.train --device cpu` on a tiny dataset (the
recipe of tests/test_train_e2e.py) at tests/small_model.py widths: it
crosses both curriculum points, validates and checkpoints, resumes where
an uninterrupted run would be, warm-starts with the include/ignore
filters (from its own files, the JAX package's .npz and a reference state
dict) and with a frozen decoder, serves from its checkpoint, writes a
profiler trace, and refuses the layouts the JAX trainer asserts against."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from radtts_tpu.export import export_torch_checkpoint as jax_export
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.train.checkpoint import save_checkpoint
from tests.small_model import MODEL_CONFIG
from tests.test_torch_synthesizer_parity import np_tree

from radtts_tpu_torch.convert import radtts_train_from_jax
from radtts_tpu_torch.models.radtts import RADTTS, fold_radtts
from radtts_tpu_torch.train import main
from radtts_tpu_torch.train.checkpoint import (load_radtts_for_inference,
                                               warmstart_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This file's small models run on one intra-op thread, its module
    fixtures included: where the suite's workers share the cores, OpenMP's
    barriers stall many short ops (tests/test_torch_parallel_serve.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SR = 22050
TEXTS = ["The cat sat.", "A big dog ran fast!", "Hello world again.",
         "Testing one two three."]
MC = dict(MODEL_CONFIG, n_speakers=2)
STEPS = ["train_config.binarization_start_iter=1",
         "train_config.kl_loss_start_iter=2",
         "train_config.iters_per_checkpoint=3", "train_config.batch_size=2",
         "train_config.seed=3"]


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        t = np.arange(int(SR * (0.4 + 0.1 * i))) / SR
        y = (0.4 * np.sin(2 * np.pi * (150 + 30 * i) * t)
             + 0.02 * rng.standard_normal(len(t)))
        wavfile.write(root / "wavs" / f"u{i}.wav", SR,
                      (y * 32767).astype(np.int16))
        rows.append(f"u{i}.wav|{text}|spk{i % 2}")
    (root / "train.txt").write_text("\n".join(rows[:3]) + "\n")
    (root / "val.txt").write_text(rows[3] + "\n")
    with open(os.path.join(REPO, "configs", "config_ljs_decoder.json")) as f:
        config = json.load(f)
    config["model_config"] = MC
    dc = config["data_config"]
    for key, filelist in (("training_files", "train.txt"),
                          ("validation_files", "val.txt")):
        dc[key] = {"T": {"basedir": str(root), "audiodir": "wavs",
                         "filelist": filelist, "lmdbpath": ""}}
    dc.update(betabinom_cache_path=str(root / "cache"), dur_min=0.05,
              n_mel_channels=MC["n_mel_channels"])
    path = root / "config.json"
    path.write_text(json.dumps(config))
    return str(path)


def run(config_path, out, *params):
    return main(["-c", config_path, "--device", "cpu", "-p",
                 f"train_config.output_directory={out}", *STEPS, *params])


@pytest.fixture(scope="module")
def trained(config_path, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out"))
    return out, run(config_path, out, "train_config.epochs=5")


def test_trains_across_curriculum_and_checkpoints(trained):
    out, history = trained
    assert [h["iteration"] for h in history] == [0, 1, 2, 3, 4]
    assert [(h["binarize"], h["use_kl"]) for h in history] == [
        (False, False), (True, False), (True, True), (True, True),
        (True, True)]
    for h in history:
        assert all(np.isfinite(v) for k, v in h.items()
                   if isinstance(v, float)), h
    assert history[0]["binarization_loss"] == 0.0
    assert history[2]["binarization_loss"] > 0.0
    assert "validation" in history[0] and "validation" in history[3]
    assert sorted(f for f in os.listdir(out) if f.startswith("model_")) == [
        "model_0", "model_3"]
    assert os.path.exists(os.path.join(out, "config.json"))


def test_resume_continues_the_uninterrupted_run(config_path, trained,
                                                tmp_path):
    """From model_3, iteration 4 is the uninterrupted run's iteration 4:
    the same state, batch and dropout draws, so the same losses, bit for
    bit."""
    out, history = trained
    resumed = run(config_path, str(tmp_path), "train_config.epochs=5",
                  f"train_config.checkpoint_path={out}/model_3")
    assert [h["iteration"] for h in resumed] == [4]
    for k in ("total", "grad_norm", "loss_mel", "loss_ctc"):
        assert resumed[0][k] == history[4][k], k


def test_serves_from_its_checkpoint(trained):
    """load_radtts_for_inference reads the training checkpoint and folds
    it into the inference RADTTS, equal to folding the loaded training
    form."""
    out, _ = trained
    model, meta = load_radtts_for_inference(os.path.join(out, "model_3"), MC)
    assert meta["iteration"] == 3
    ckpt = torch.load(os.path.join(out, "model_3"), weights_only=True)
    train_form = RADTTS(MC, factored=True)
    train_form.load_state_dict(ckpt["model"])
    want = fold_radtts(train_form).state_dict()
    assert set(model.state_dict()) == set(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_warmstart_filters_across_formats(trained, tmp_path):
    """The include/ignore substring filters on the port's names, from the
    port's checkpoint, the JAX package's .npz and its reference state
    dict."""
    out, _ = trained
    params = radtts_init(jax.random.PRNGKey(4), MC)
    save_checkpoint(str(tmp_path / "jax.npz"), params, iteration=2)
    jax_export(str(tmp_path / "ref.pt"), params, iteration=2)
    from_tree = radtts_train_from_jax(np_tree(params), MC).state_dict()
    port_sd = torch.load(os.path.join(out, "model_3"),
                         weights_only=True)["model"]
    for path, source in ((os.path.join(out, "model_3"), port_sd),
                         (str(tmp_path / "jax.npz"), from_tree),
                         (str(tmp_path / "ref.pt"), from_tree)):
        model = RADTTS(MC, factored=True)
        before = copy.deepcopy(model.state_dict())
        taken = warmstart_state(path, model, MC, ["encoder", "flows"],
                                ["flows.1."])
        assert taken and all(("encoder" in k or "flows" in k)
                             and "flows.1." not in k for k in taken)
        assert any(k.startswith("flows.0.") for k in taken)
        for k, v in model.state_dict().items():
            want = source[k] if k in taken else before[k]
            assert torch.equal(v, want), (path, k)


def test_warmstart_with_frozen_decoder(config_path, trained, tmp_path):
    """unfreeze_modules=durf0energyvpred after a warm start: two steps move
    the attribute predictors and leave every other parameter the warm
    start's, bit for bit."""
    out, _ = trained
    history = run(config_path, str(tmp_path), "train_config.epochs=2",
                  f"train_config.warmstart_checkpoint_path={out}/model_3",
                  "train_config.unfreeze_modules=durf0energyvpred")
    assert len(history) == 2
    src = torch.load(os.path.join(out, "model_3"), weights_only=True)["model"]
    got = torch.load(os.path.join(tmp_path, "model_0"),
                     weights_only=True)["model"]
    model = RADTTS(MC, factored=True)
    moved = 0
    for name, _ in model.named_parameters():
        if name.split(".")[0] in ("dur_pred_layer", "f0_pred_module",
                                  "energy_pred_module", "v_pred_module",
                                  "v_embeddings"):
            moved += not torch.equal(got[name], src[name])
        else:
            assert torch.equal(got[name], src[name]), name
    assert moved > 0


@pytest.mark.parametrize("param", ["train_config.use_amp=true",
                                   "train_config.optim_state_dtype=bfloat16"])
def test_honours_precision_options(config_path, tmp_path, monkeypatch,
                                   param):
    """use_amp runs each step's forward in the bf16 regions (validation
    in fp32); optim_state_dtype=bfloat16 keeps the optimizer's moments in
    bf16, in the checkpoint too. Losses stay finite. (Their numbers
    against the JAX package: tests/test_torch_amp.py.)"""
    from radtts_tpu_torch.models import coupling

    casts = []
    real_cast = coupling.cast_in
    monkeypatch.setattr(coupling, "cast_in", lambda x, on: casts.append(
        (on, real_cast(x, on).dtype)) or real_cast(x, on))
    config = json.loads(open(config_path).read())
    config["train_config"].setdefault("optim_state_dtype", "")
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    history = run(str(path), str(tmp_path), "train_config.epochs=2", param)
    assert len(history) == 2
    for h in history:
        assert all(np.isfinite(v) for k, v in h.items()
                   if isinstance(v, float)), h
    state = torch.load(os.path.join(tmp_path, "model_0"),
                       weights_only=True)["optimizer"]["state"]
    dtypes = {t.dtype for st in state.values()
              for k, t in st.items() if k.startswith("exp_avg")}
    if "use_amp" in param:
        assert (True, torch.bfloat16) in casts
        assert (False, torch.float32) in casts      # validation
        assert dtypes == {torch.float32}
    else:
        assert {on for on, _ in casts} == {False}
        assert dtypes == {torch.bfloat16}


@pytest.mark.parametrize("param,item", [
    ("dist_config.n_model=2", "does not divide WORLD_SIZE=1"),
])
def test_refuses_unsupported_options(config_path, tmp_path, capsys, param,
                                     item):
    """Refused before anything is written: an n_model that does not divide
    the world size (one process here), as the JAX trainer asserts."""
    config = json.loads(open(config_path).read())
    config["train_config"].setdefault("optim_state_dtype", "")
    config["dist_config"].setdefault("n_model", 1)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    with pytest.raises(SystemExit) as err:
        run(str(path), str(tmp_path / "o"), param)
    assert err.value.code == 2
    assert item in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_profile_dir_writes_a_trace(config_path, tmp_path, capsys):
    """train_config.profile_dir, which the CLI once refused: a
    torch.profiler trace of iterations profile_start_iter to
    profile_start_iter + profile_n_iters, written there on the CPU."""
    config = json.loads(open(config_path).read())
    config["train_config"].update(profile_dir="", profile_start_iter=5,
                                  profile_n_iters=5)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    prof = tmp_path / "prof"
    history = run(str(path), str(tmp_path / "o"), "train_config.epochs=2",
                  f"train_config.profile_dir={prof}",
                  "train_config.profile_start_iter=0",
                  "train_config.profile_n_iters=1")
    assert len(history) == 2
    assert f"profiler trace written to {prof}" in capsys.readouterr().out
    assert os.listdir(prof) == ["trace_0_1.json"]
    with open(prof / "trace_0_1.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_refuses_world_size(config_path, tmp_path, capsys, monkeypatch):
    """WORLD_SIZE=2 whose data axis does not divide the batch (3 rows) is
    refused before any process group forms, as the JAX trainer asserts;
    tests/test_torch_parallel_cli.py runs the world it does divide."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as err:
        run(config_path, str(tmp_path / "o"), "train_config.batch_size=3")
    assert err.value.code == 2
    assert "not divisible by 2 data shards" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_module_entry_point_runs(config_path, tmp_path):
    """python -m radtts_tpu_torch.train, in a process of its own; without
    --device it would need CUDA."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "radtts_tpu_torch.train", "-c", config_path,
         "--device", "cpu", "-p", f"train_config.output_directory={tmp_path}",
         "train_config.epochs=1", *STEPS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "iter: 0" in proc.stdout and "Validation loss" in proc.stdout
    assert os.path.exists(tmp_path / "model_0")
    proc = subprocess.run(
        [sys.executable, "-c", "import torch; torch.cuda.is_available = "
         "lambda: False; import sys; sys.argv = ['x', '-c', %r]; "
         "from radtts_tpu_torch.train import main; main()" % config_path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
