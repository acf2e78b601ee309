"""The port's FLOP counter (radtts_tpu_torch/ops/flops.py) against the JAX
package's (radtts_tpu/ops/flops.py) on the CPU: the unit cases of
tests/test_flops_count.py, the hand-written kernels' records against
their plain versions' products, and the small model's inference, the
small HiFi-GAN generator and the RADTTS training step, where the two
counts must be equal once each product the two sides compute differently
is added as a named term."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from radtts_tpu.models.hifigan import hifigan_generator_apply
from radtts_tpu.models.radtts import infer_durations as jax_infer_durations
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from radtts_tpu.models.radtts import radtts_init
from radtts_tpu.ops.flops import count_matmul_flops as jax_count
from radtts_tpu.ops.folded_conv import (fold_conv_weights, fold_time,
                                        folded_conv_apply)
from radtts_tpu.ops.fold_norms import fold_norms as jax_fold_norms
from radtts_tpu.ops.invertible import precompute_inverses
from radtts_tpu.train.optim import build_optimizer as jax_build_optimizer
from radtts_tpu.train.trainer import build_trainable_mask as jax_mask
from radtts_tpu.train.trainer import make_train_step
from tests.small_model import MODEL_CONFIG
from tests.test_torch_radtts import IN_LENS, SPK, TEXT, np_tree
from tests.test_torch_synthesizer_parity import H_SMALL, _audible_vocoder
from tests.test_torch_train_forward import (LOSS_WEIGHTS, N, T, jax_params,
                                            make_batch, to_torch)

from radtts_tpu_torch.convert import (hifigan_from_jax, radtts_from_jax,
                                      radtts_train_from_jax)
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.ops import flops
from radtts_tpu_torch.ops import mel as mel_mod
from radtts_tpu_torch.ops import mrf as mrf_mod
from radtts_tpu_torch.ops.ar_scan import ar_scan_multi, ar_scan_plain
from radtts_tpu_torch.ops.invertible import InvConv1x1LUS
from radtts_tpu_torch.ops.lstm import LSTM, MaskedLSTM, RecurrentWeight
from radtts_tpu_torch.ops.mas import mas
from radtts_tpu_torch.train.optim import build_optimizer
from radtts_tpu_torch.train.trainer import (apply_trainable_mask,
                                            build_trainable_mask,
                                            train_step)

count = flops.count_matmul_flops


# ---------------------------------------------------------------------------
# the unit cases of tests/test_flops_count.py
# ---------------------------------------------------------------------------


def test_plain_and_batched_matmul():
    a, b = torch.zeros(8, 32), torch.zeros(32, 16)
    assert count(lambda x, y: x @ y, a, b) == 2 * 8 * 32 * 16
    a, b = torch.zeros(4, 8, 32), torch.zeros(4, 32, 16)
    assert count(torch.matmul, a, b) == 2 * 4 * 8 * 32 * 16
    assert count(torch.mv, torch.zeros(8, 32), torch.zeros(32)) == 2 * 8 * 32
    (rec,) = flops.mxu_records(torch.bmm, a, b)
    assert (rec["kind"], rec["batch"], rec["m"], rec["n"], rec["k"],
            rec["trips"], rec["bytes"]) == ("dot", 4, 8, 16, 32, 1,
                                            4 * (4 * 8 * 32 + 4 * 32 * 16
                                                 + 4 * 8 * 16))


def test_conv():
    x, w = torch.zeros(2, 24, 100), torch.zeros(48, 24, 5)
    # out (2, 48, 100); per output element 2 * C_in * K, as JAX's count
    assert count(lambda x, w: F.conv1d(x, w, padding=2), x, w) \
        == 2 * (2 * 48 * 100) * 24 * 5
    # a transposed conv: 2 * output elements * C_in * K (the JAX count of
    # the lhs-dilated conv)
    wt = torch.zeros(24, 12, 16)
    got = count(lambda x: F.conv_transpose1d(x, wt, stride=8, padding=4), x)
    assert got == 2 * (2 * 12 * 800) * 24 * 16


def test_recurrence_multiplies_by_length():
    """A loop's products count at every trip; an LSTM's at every time
    step: 2 * B * 4H * (I + H) per step and direction, as the JAX scan's
    trips."""
    a = torch.zeros(8, 8)

    def loop(c):
        for _ in range(7):
            c = c @ a
        return c
    assert count(loop, a) == 7 * 2 * 8 * 8 * 8
    lstm = torch.nn.LSTM(6, 5, batch_first=True, bidirectional=True)
    with torch.no_grad():
        got = count(lstm, torch.zeros(3, 7, 6))
    assert got == 2 * (7 * 2 * 3 * 4 * 5 * (6 + 5))


def test_grad_includes_backward():
    a = torch.zeros(8, 32)
    w = torch.zeros(32, 16, requires_grad=True)
    fwd = count(lambda w: (a @ w).sum(), w)
    both = count(lambda w: torch.autograd.grad((a @ w).sum(), w), w)
    assert fwd == 2 * 8 * 32 * 16 and both == 2 * fwd
    x = torch.zeros(2, 24, 100, requires_grad=True)
    wc = torch.zeros(48, 24, 5, requires_grad=True)
    one = 2 * (2 * 48 * 100) * 24 * 5
    assert count(lambda: torch.autograd.grad(
        F.conv1d(x, wc, padding=2).sum(), (x, wc))) == 3 * one


def test_inference_mode_counts_the_products():
    """Inside torch.inference_mode composite ops (linear, conv1d, lstm)
    would reach a dispatch mode whole; the counter leaves inference mode,
    so the count is the same as under no_grad."""
    lin, conv = torch.nn.Linear(6, 5), torch.nn.Conv1d(5, 4, 3)
    lstm = torch.nn.LSTM(4, 3, batch_first=True)

    def fn(x):
        y = conv(lin(x).transpose(1, 2)).transpose(1, 2)
        return lstm(y)[0]
    x = torch.zeros(2, 9, 6)
    with torch.no_grad():
        want = count(fn, x)
    with torch.inference_mode():
        assert count(fn, torch.zeros(2, 9, 6)) == want > 0
    assert want == (2 * 18 * 5 * 6 + 2 * 2 * 7 * 4 * 5 * 3
                    + 2 * 2 * 7 * 4 * 3 * (4 + 3))


# ---------------------------------------------------------------------------
# the port's own kernels: their records are their plain versions' products
# ---------------------------------------------------------------------------


def test_kernel_records_equal_their_plain_versions():
    """mrf, mel and ar_scan_multi count what mrf_plain, mel_plain and
    ar_scan_plain compute (the kernels run outside aten on the card), and
    nothing of what they dispatch counts twice; mas counts 0 (JAX's
    mas_width1 has no dot)."""
    rng = np.random.default_rng(0)
    C = 16
    x = torch.from_numpy(rng.standard_normal((2, 50, C)).astype(np.float32))
    w = [{key: torch.zeros((3, k, C, C) if key[0] == "w" else (3, C))
          for key in ("w1", "b1", "w2", "b2")} for k in (3, 7, 11)]
    want = count(mrf_mod.mrf_plain, x, w)
    assert count(mrf_mod.mrf, x, w) == want == sum(
        2 * 2 * 50 * C * C * k * 6 for k in (3, 7, 11))
    audio = torch.zeros(2, 3000)
    kw = dict(filter_length=1024, hop_length=256, win_length=1024,
              n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
              mel_fmax=8000.0)
    assert count(lambda a: mel_mod.mel(a, **kw), audio) \
        == count(lambda a: mel_mod.mel_plain(a, **kw), audio) > 0
    H, Cr, B, Tr = 8, 1, 2, 5
    params = {"attr": (torch.zeros(4 * H, Cr), torch.zeros(4 * H, H),
                       (torch.zeros(4 * H), torch.zeros(4 * H))),
              "lstm": [(torch.zeros(4 * H, H), torch.zeros(4 * H, H), None)],
              "head": [(torch.zeros(12, H), torch.zeros(12), "relu"),
                       (torch.zeros(2 * Cr, 12), torch.zeros(2 * Cr), None)],
              "kind": "affine", "scaling_fn": "exp"}
    res, cproj = torch.zeros(B, Tr, Cr), torch.zeros(B, Tr, 4 * H)
    got = count(lambda: ar_scan_multi([(params, res, cproj)]))
    assert got == count(ar_scan_plain, params, res, cproj) > 0
    assert count(mas, torch.rand(2, 9, 4), torch.tensor([9, 5]),
                 torch.tensor([4, 3])) == 0


# ---------------------------------------------------------------------------
# the small model against the JAX package's count
# ---------------------------------------------------------------------------


def lstm_calls(monkeypatch):
    """Spy on every LSTM call: (B, T, rows the port runs, per-row FLOP of
    all its layers and directions)."""
    calls = []

    def spy(cls):
        real = cls.forward

        def forward(self, x, lengths=None, *args, **kwargs):
            lstm = self.lstm
            dirs = 2 if lstm.bidirectional else 1
            H, per_row = lstm.hidden_size, 0
            for layer in range(lstm.num_layers):
                size_in = lstm.input_size if layer == 0 else H * dirs
                per_row += dirs * 2 * 4 * H * (size_in + H)
            B, T_ = x.shape[:2]
            rows = B * T_ if lengths is None else int(
                lengths.clamp(1, T_).sum())
            calls.append((B, T_, rows, per_row))
            return real(self, x, lengths, *args, **kwargs)
        monkeypatch.setattr(cls, "forward", forward)
    spy(MaskedLSTM)
    spy(LSTM)
    return calls


def packed_lstm_term(calls):
    """JAX scans every padded step of an LSTM; the port packs each item to
    its length (pack_padded_sequence; cuDNN on the card): the products of
    the steps the port skips."""
    return sum((B * T_ - rows) * per_row for B, T_, rows, per_row in calls)


@pytest.fixture(scope="module")
def small():
    params = radtts_init(jax.random.PRNGKey(0), MODEL_CONFIG)
    return (params, jax_fold_norms(precompute_inverses(params)),
            radtts_from_jax(np_tree(params), MODEL_CONFIG))


@pytest.mark.parametrize("batched", [False, True])
def test_inference_matches_jax(small, monkeypatch, batched):
    """infer_durations + radtts_infer of the small model against the JAX
    package's on its serving tree (norms folded, the 1x1 inverses
    precomputed, as its Synthesizer loads it): one text whose durations
    fill the frame budget, equal; a ragged batch, equal with the packed
    LSTMs' skipped steps added to the port's count."""
    _, served, model = small
    text = TEXT if batched else TEXT[:1]
    lens = IN_LENS if batched else None
    B = text.shape[0]
    dur = np.full(text.shape, 2, np.int32)
    dur[:, :8] = 3                       # 32 frames: the budget exactly
    if batched:
        dur[1] = np.random.default_rng(1).integers(1, 4, text.shape[1])
        dur[1, 8:] = 0
    frames = 32
    g, n_mel = MODEL_CONFIG["n_group_size"], MODEL_CONFIG["n_mel_channels"]
    res = (0.8 * np.random.default_rng(2).standard_normal(
        (B, frames // g, n_mel * g))).astype(np.float32)
    spk = SPK[:B]
    jl = None if lens is None else jnp.asarray(lens)

    def jax_fn():
        jax_infer_durations(served, jax.random.PRNGKey(0), jnp.asarray(spk),
                            jnp.asarray(text), in_lens=jl)
        return jax_radtts_infer(served, jax.random.PRNGKey(1),
                                jnp.asarray(spk), jnp.asarray(text), 0.8,
                                frames, dur=jnp.asarray(dur),
                                residual=jnp.asarray(res), in_lens=jl)

    tl = None if lens is None else torch.as_tensor(lens)

    def port_fn():
        with torch.no_grad():
            port.infer_durations(model, torch.as_tensor(spk),
                                 torch.as_tensor(text), in_lens=tl)
            return port.radtts_infer(
                model, torch.as_tensor(spk), torch.as_tensor(text), 0.8,
                frames, dur=torch.as_tensor(dur),
                residual=torch.as_tensor(res), in_lens=tl)

    calls = lstm_calls(monkeypatch)
    got = count(port_fn)
    term = packed_lstm_term(calls)
    assert (term > 0) == batched
    assert got + term == jax_count(jax_fn), (got, term)


def test_generator_matches_jax():
    """The small HiFi-GAN generator (the MRF counted by ops/mrf.py's
    records) against the JAX generator through XLA: equal, with one named
    term, post_fold: JAX runs the C_out = 1 post conv folded in time
    (128 // C frames into channels, a block-banded kernel whose structural
    zeros its count includes; radtts_tpu/ops/folded_conv.py), the port the
    plain conv."""
    params = _audible_vocoder()
    gen = hifigan_from_jax(np_tree(params), H_SMALL)
    mel = np.zeros((1, 24, 80), np.float32)
    with torch.no_grad():
        got = count(gen, torch.from_numpy(mel))
    want = jax_count(lambda m: hifigan_generator_apply(params, m,
                                                       mrf_impl="xla"),
                     jnp.asarray(mel))
    post = params["conv_post"]
    K, C, _ = post["w"].shape
    n = 24 * int(np.prod(H_SMALL["upsample_rates"]))
    fold = 128 // C
    folded = jax_count(lambda x: folded_conv_apply(
        *fold_conv_weights(post["w"], post["b"], pad=(K - 1) // 2,
                           dilation=1, fold=fold), fold_time(x, fold)),
        jnp.zeros((1, n, C)))
    post_fold = folded - 2 * n * C * K
    assert post_fold > 0
    assert got + post_fold == want, (got, post_fold, want)


def test_train_step_matches_jax():
    """One RADTTS training step (binarized, every module trainable) on a
    batch with no padding: the port's count plus three named terms equals
    JAX's:
      - sn_grad: the spectral norm's sigma = u^T W v in the backward of
        every spectral-normed recurrent weight, where JAX's effective_hh
        makes the outer product u v^T (2 * 4H * H) and its scaling
        (2 * 4H) dot_generals that contract nothing, and torch's autograd
        multiplies elementwise;
      - lu_p_grad: JAX differentiates each LU 1x1's permutation P, a leaf
        of its parameter tree masked after the gradient (one C x C x C
        product, 2 * C^3), where the port holds P as a buffer;
      - ctc: optax's CTC loss gathers the label probabilities by one-hot
        products (forward and backward, JAX's own count of it), where
        torch's ctc_loss has none."""
    import optax

    params = jax_params(seed=1)
    batch = make_batch(seed=4, in_lens=[N] * 3, out_lens=[T] * 3)
    opt = jax_build_optimizer("RAdam", 1e-3, 1e-2, 1.0)
    step = make_train_step(MODEL_CONFIG, LOSS_WEIGHTS, 1.0, opt,
                           jax_mask(params, "all", ()))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_count(lambda p, s, b: step(p, s, b, None, True, False),
                     params, opt.init(params), jb)

    model = radtts_train_from_jax(np_tree(params), MODEL_CONFIG)
    trainable = apply_trainable_mask(model, build_trainable_mask(model))
    optimizer = build_optimizer(trainable, "RAdam", 1e-3, 1e-2)
    got = count(train_step, model, optimizer, trainable, to_torch(batch),
                MODEL_CONFIG, LOSS_WEIGHTS, 1.0, True, False, 1.0)

    sn_grad = sum(2 * m.sn_w.shape[0] * (m.sn_w.shape[1] + 1)
                  for m in model.modules()
                  if isinstance(m, RecurrentWeight) and m.norm == "spectral")
    lu_p_grad = sum(2 * m.p.shape[0] ** 3 for m in model.modules()
                    if isinstance(m, InvConv1x1LUS))
    B, K = len(batch["text"]), N + 1

    def ctc(logits):
        return optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]),
                              jnp.ones((B, N), jnp.int32),
                              jnp.zeros((B, N))).sum()
    ctc_term = jax_count(jax.grad(ctc), jnp.zeros((B, T, K)))
    assert sn_grad > 0 and lu_p_grad > 0 and ctc_term > 0
    assert got + sn_grad + lu_p_grad + ctc_term == want, (
        got, sn_grad, lu_p_grad, ctc_term, want)
