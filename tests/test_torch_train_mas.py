"""The port's MAS against the JAX package's mas_width1 on the CPU: the hard
alignments must be equal, not close, on random, ragged, tied and
in_len > out_len inputs. mas_plain is also the reference the card's kernel
(csrc/mas.cu) is held to by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radtts_tpu.ops.mas import mas_width1

from radtts_tpu_torch.ops import mas as mas_mod


def softmax_attn(rng, B, T, N, in_lens, scale=3.0):
    """Soft attention as ConvAttention gives it: a softmax over each item's
    valid tokens, zero past them."""
    logits = rng.normal(size=(B, T, N)) * scale
    pad = np.arange(N)[None, :] >= np.asarray(in_lens)[:, None]    # (B, N)
    logits = np.where(pad[:, None, :], -np.inf, logits)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def both(attn, out_lens, in_lens):
    want = np.asarray(mas_width1(jnp.asarray(attn), jnp.asarray(out_lens),
                                 jnp.asarray(in_lens)))
    got = mas_mod.mas(torch.from_numpy(attn), torch.as_tensor(out_lens),
                      torch.as_tensor(in_lens)).numpy()
    return got, want


CASES = {
    "random": (4, 60, 17, [17, 17, 17, 17], [60, 60, 60, 60]),
    "ragged": (3, 97, 23, [23, 11, 5], [97, 40, 18]),
    "short_in_len": (2, 30, 9, [1, 9], [30, 9]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mas_plain_equals_jax(case):
    B, T, N, in_lens, out_lens = CASES[case]
    attn = softmax_attn(np.random.default_rng(len(case)), B, T, N, in_lens)
    got, want = both(attn, out_lens, in_lens)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # one token per valid frame, monotone, covering the first and last
    for b in range(B):
        path = got[b, :out_lens[b], :in_lens[b]]
        assert (path.sum(1) == 1).all() or out_lens[b] < in_lens[b]


@pytest.mark.parametrize("kind", ["uniform", "blocks"])
def test_mas_plain_equals_jax_on_ties(kind):
    """Exact ties everywhere (uniform attention) or in blocks of equal
    values: the tie-break (the token before wins) decides the path."""
    B, T, N = 2, 25, 8
    if kind == "uniform":
        attn = np.full((B, T, N), 1.0 / N, np.float32)
    else:
        attn = np.repeat(np.repeat(
            softmax_attn(np.random.default_rng(3), B, 5, 4, [4, 4]), 5,
            axis=1), 2, axis=2) / 2
    got, want = both(attn, [25, 17], [8, 6])
    np.testing.assert_array_equal(got, want)


def test_mas_plain_equals_jax_when_tokens_outnumber_frames():
    """in_len > out_len: no monotone path covers every token; both take the
    same partial one (and the quirk's opt[0, 0])."""
    attn = softmax_attn(np.random.default_rng(9), 3, 12, 20, [20, 15, 4])
    got, want = both(attn, [6, 12, 0], [20, 15, 4])
    np.testing.assert_array_equal(got, want)
    assert got[2].sum() == 0          # an empty item stays empty


def test_mas_plain_equals_jax_with_zero_probabilities():
    """Exact zeros inside the valid region (log 0 = -inf), the case where
    the backtrack can fall below token 0."""
    attn = softmax_attn(np.random.default_rng(4), 2, 30, 6, [6, 6])
    attn[0, 3:9, 0] = 0.0
    attn[1, :, 2] = 0.0
    got, want = both(attn, [30, 30], [6, 6])
    np.testing.assert_array_equal(got, want)


def test_mas_dispatch_counts_only_kernel_launches():
    """On a CPU tensor `mas` runs mas_plain and launches nothing."""
    attn = torch.from_numpy(softmax_attn(np.random.default_rng(0), 1, 8, 3,
                                         [3]))
    before = mas_mod.mas.launches
    out = mas_mod.mas(attn, torch.tensor([8]), torch.tensor([3]))
    assert mas_mod.mas.launches == before
    torch.testing.assert_close(out, mas_mod.mas_plain(
        attn, torch.tensor([8]), torch.tensor([3])))


def test_mas_kernel_source_is_there():
    """csrc/mas.cu exists beside the other kernels and exports the entry
    points ops/mas.py binds (it builds and runs on the card only)."""
    import os
    src = open(os.path.join(os.path.dirname(mas_mod.__file__), "..", "csrc",
                            "mas.cu")).read()
    assert 'extern "C" int radtts_mas(' in src
    assert 'extern "C" int radtts_mas_smem_bytes(' in src


def kernel_emulation(attn, out_lens, in_lens):
    """csrc/mas.cu's algorithm line by line in numpy float32: two DP rows,
    byte choices, the log taken per cell as the row is reached, and one
    backtrack that stops below token 0."""
    B, T, N = attn.shape
    out = np.zeros_like(attn)
    neg = np.float32(-1e30)
    for b in range(B):
        out_len, in_len = min(max(out_lens[b], 0), T), min(max(in_lens[b],
                                                               0), N)

        def la(i, j):
            return np.log(attn[b, i, j]) if j < in_len else neg

        with np.errstate(divide="ignore", invalid="ignore"):
            prev = np.array([la(0, 0) if j == 0 else neg for j in range(N)],
                            np.float32)
            ch = np.zeros((T, N), np.uint8)
            for i in range(1, out_len):
                nxt = np.empty(N, np.float32)
                for j in range(N):
                    p, sh = prev[j], prev[j - 1] if j > 0 else neg
                    best = np.float32(np.nan) if np.isnan(sh) or np.isnan(p) \
                        else max(sh, p)
                    nxt[j] = np.float32(la(i, j)) + best
                    ch[i, j] = sh >= p
                prev = nxt
        if out_len > 0 and in_len > 0:
            curr = in_len - 1
            for i in range(out_len - 1, -1, -1):
                if curr < 0:
                    break
                out[b, i, curr] = 1.0
                if i > 0 and ch[i, curr]:
                    curr -= 1
            out[b, 0, 0] = 1.0
    return out


@pytest.mark.parametrize("case", ["ragged", "ties", "outnumber", "zeros"])
def test_kernel_algorithm_equals_mas_plain(case):
    """The kernel's own algorithm (which runs only on the card) gives
    mas_plain's matrix on the cases above."""
    rng = np.random.default_rng(11)
    if case == "ragged":
        attn, ol, il = softmax_attn(rng, 3, 41, 13, [13, 7, 2]), \
            [41, 20, 9], [13, 7, 2]
    elif case == "ties":
        attn, ol, il = np.full((2, 19, 6), 1 / 6, np.float32), [19, 11], \
            [6, 4]
    elif case == "outnumber":
        attn, ol, il = softmax_attn(rng, 2, 8, 12, [12, 10]), [5, 0], [12, 10]
    else:
        attn = softmax_attn(rng, 2, 25, 5, [5, 5])
        attn[0, 2:8, 0] = 0.0
        attn[1, :, 1] = 0.0
        ol, il = [25, 25], [5, 5]
    want = mas_mod.mas_plain(torch.from_numpy(attn), torch.as_tensor(ol),
                             torch.as_tensor(il)).numpy()
    np.testing.assert_array_equal(kernel_emulation(attn, ol, il), want)
