"""The PyTorch port's Synthesizer and package boundary, on the CPU:

* a single text padded to the 16-token bucket reproduces the exact-length
  result (the JAX engine's contract, tests/test_synthesizer.py);
* entry points run on the card unless the caller asks for the CPU, and
  pin fp32 precision;
* the port and chip_smoke.py import neither JAX nor the JAX package.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.small_model import MODEL_CONFIG

from radtts_tpu_torch.models.hifigan import Generator, denoiser_init
from radtts_tpu_torch.models.radtts import RADTTS
from radtts_tpu_torch.synthesizer import (Synthesizer, frame_budget,
                                          resolve_device)

REPO = pathlib.Path(__file__).resolve().parents[1]
H_SMALL = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 64,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
CFG = dict(MODEL_CONFIG, n_mel_channels=80)   # the vocoder's conv_pre is 80


def close(got, want):
    """Within 1e-4 of the waveform's scale: the same fp32 convs on inputs
    that differ only by zero padding, sums taken in another order."""
    scale = np.abs(want).max()
    assert scale > 0.05   # the waveform is in range, not near silence
    err = np.abs(got - want).max()
    assert err <= 1e-4 * scale, (err, scale)


def _encode(text):
    return np.array([ord(c) % 150 + 1 for c in text], np.int64)


def _parts(device=None, bucket_single=False):
    torch.manual_seed(0)
    model = RADTTS(CFG)
    for flow in model.flows:
        torch.nn.init.normal_(flow.affine.pred.end.weight, std=0.02)
    # random weights predict near-zero durations: centre them on ~3 frames
    torch.nn.init.constant_(model.dur_pred_layer.feat.dense.bias, 1.4)
    vocoder = Generator(H_SMALL)
    with torch.no_grad():
        # the normal(0, 0.01) init gives a waveform of scale ~1e-6: scale
        # the non-MRF convs 10x and draw the biases, so the waveform reaches
        # the tanh's range and the denoiser's bias spectrum is not zero
        for conv in [vocoder.conv_pre, *vocoder.ups, vocoder.conv_post]:
            conv.weight.mul_(10.0)
            torch.nn.init.normal_(conv.bias, std=0.05)
        denoiser = denoiser_init(vocoder)
    return dict(model_config=CFG, model=model, vocoder=vocoder,
                denoiser=denoiser, encode_fn=_encode,
                speaker_id_fn=lambda name: 0, seed=11, device=device,
                bucket_single=bucket_single)


def test_bucket_single_matches_exact():
    s_exact = Synthesizer.from_parts(**_parts("cpu"))
    s_bucket = Synthesizer.from_parts(**_parts("cpu", bucket_single=True))
    text = "A quick check of bucketing."  # 27 tokens -> bucket N=32
    we, aux_e = s_exact.synthesize(text, "spk", denoising_strength=0.01)
    wb, aux_b = s_bucket.synthesize(text, "spk", denoising_strength=0.01)
    n = len(_encode(text))
    np.testing.assert_array_equal(aux_b["dur"][:, :n], aux_e["dur"])
    assert aux_b["dur"].shape[1] == 32 and aux_e["dur"].sum() > n
    assert len(wb[0]) == len(we[0]) == aux_e["n_frames"][0] * 256
    close(wb[0], we[0])


def test_batch_items_match_single():
    synth = Synthesizer.from_parts(**_parts("cpu"))
    texts = ["A quick check of bucketing.", "Short one!", "Middle text."]
    wavs, aux = synth.synthesize(texts, "spk", sigma=0.0)
    assert aux["dur"].shape == (3, 32)
    for j, text in enumerate(texts):
        w1, aux1 = synth.synthesize(text, "spk", sigma=0.0)
        np.testing.assert_array_equal(aux1["dur"][0],
                                      aux["dur"][j, :len(_encode(text))])
        assert len(w1[0]) == len(wavs[j])
        # sigma 0: no noise; the vocoder sees the same frames up to the
        # replicated tail, which reaches back 6 frames of receptive field
        n = len(w1[0]) - 6 * 256
        close(w1[0][:n], wavs[j][:n])


def test_frame_budget():
    assert frame_budget(1, 2) == 32
    assert frame_budget(32, 2) == 32
    assert frame_budget(33, 2) == 64


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer.from_parts(**_parts())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)


def test_resolve_device_pins_fp32(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _port_sources():
    return sorted((REPO / "radtts_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _is_forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "radtts_tpu")


def test_no_jax_imports_in_sources():
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names
                          if _is_forbidden(n)]
    assert not offenders, offenders


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import radtts_tpu_torch\n"
        "for m in pkgutil.walk_packages(radtts_tpu_torch.__path__,\n"
        "                               'radtts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'radtts_tpu')]\n"
        "n = sum(m.startswith('radtts_tpu_torch.') for m in sys.modules)\n"
        "new = ['radtts_tpu_torch.' + m for m in (\n"
        "    'train', 'train.cli', 'train.trainer', 'train.optim',\n"
        "    'losses', 'ops.mas', 'ops.dropout', 'models.attention',\n"
        "    'data.pyin', 'data.audio_np', 'native', 'ops.amp',\n"
        "    'inference_voice_conversion', 'models.fftransformer',\n"
        "    'debug', 'ops.flops', 'ops.precision', 'data.__main__',\n"
        "    'data.preflight')]\n"
        "missing = [m for m in new if m not in sys.modules]\n"
        "print(n, bad, missing)\n"
        "sys.exit(1 if bad or missing or n < 20 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
