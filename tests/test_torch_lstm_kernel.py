"""The masked LSTM's kernel route (radtts_tpu_torch/ops/lstm.py, csrc/lstm.cu)
on the CPU: `lstm_plain` against the packed nn.LSTM path MaskedLSTM runs
off the card, an emulation of the kernel's layout (its blocks' slices of
the resident image, the warps' K slices, the projection's per-item
backward frame index, the exact zeros) against `lstm_plain`, and the
routing and the plan at the cells' widths.

Tests marked `chip` run on the card: the kernel against `lstm_plain` at the
cells' shapes. Run them there without the JAX conftest:
`python3 -m pytest --noconftest -m chip tests/test_torch_lstm_kernel.py`.
"""

import pytest
import torch

from radtts_tpu_torch import tracing
from radtts_tpu_torch.ops import lstm as lstm_mod
from radtts_tpu_torch.ops.lstm import (MaskedLSTM, lstm_plain, lstm_plan,
                                       lstm_route)

SMS = 132     # an H100's SMs


def _module(C, H, bidirectional, seed):
    torch.manual_seed(seed)
    return MaskedLSTM(C, H, bidirectional=bidirectional,
                      norm="spectral").eval()


def _ragged(B, T, seed):
    """Lengths with 0, 1 and T among them, the others drawn."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(2, T, (B,), generator=gen)
    lens[:3] = torch.tensor([T, 1, 0])[:B]
    return lens


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("H", [8, 24])
def test_lstm_plain_matches_packed(bidirectional, H):
    """lstm_plain against MaskedLSTM's packed nn.LSTM path (the cpu route,
    which also counts lstm_cpu), ragged lengths with 0, 1 and the full T,
    and without lengths."""
    B, T, C = 5, 11, 6
    mod = _module(C, H, bidirectional, seed=H)
    x = torch.randn(B, T, C, generator=torch.Generator().manual_seed(1))
    lens = _ragged(B, T, seed=2)
    with torch.no_grad():
        tracing.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.call("synthesize"):
                want = mod(x, lens)
        root = tracing.records()[-1]
        assert root["counts"]["lstm_cpu"] == 1
        assert "lstm_kernel" not in root["counts"]
        got = lstm_plain(x, lens, mod.weights(), bidirectional)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert (got[1, 1:] == 0).all() and (got[2] == 0).all()
        torch.testing.assert_close(
            lstm_plain(x, None, mod.weights(), bidirectional), mod(x),
            rtol=0, atol=1e-6)


def emulate(x, lengths, weights, bidirectional, sms):
    """csrc/lstm.cu's launch in torch ops, from the wrapper's own plan,
    image and projection: each block's rows of the image against h of the
    step before, the projection read at the kernel's index (the backward
    direction's frame len_b - 1 - s), the cells of its units, h through
    the parity buffer, and every output written where the kernel writes
    it (the rest stays NaN)."""
    B, T, _ = x.shape
    D = 2 if bidirectional else 1
    H = weights[1].shape[1]
    plan = lstm_plan(H, B, D, sms)
    U, bpd, kp = (plan[k] for k in ("units", "blocks_per_dir", "kp"))
    R = 4 * U
    w_ih, bias, img = lstm_mod.kernel_weights(weights, D, plan)
    xproj = torch.nn.functional.linear(x, w_ih, bias).reshape(-1)
    lens = (torch.full((B,), T) if lengths is None
            else lengths.clamp(0, T)).tolist()
    steps = max(lens)
    y = torch.full((B, T, D * H), float("nan"))
    hbuf = torch.zeros(D, 2, B, kp)
    hs = torch.zeros(D, B, kp)
    cs = torch.zeros(D * bpd, B, U)
    for s in range(steps):
        par = s & 1
        for blk in range(D * bpd):
            d, u0 = blk // bpd, (blk % bpd) * U
            v = hs[d] @ img[blk].reshape(R, kp).T
            for b in range(B):
                for r in range(R):
                    unit = u0 + r // 4
                    if s < lens[b] and unit < H:
                        frame = s if d == 0 else lens[b] - 1 - s
                        v[b, r] += xproj[((b * T + frame) * D + d) * 4 * H
                                         + (r % 4) * H + unit]
            g = torch.where(torch.arange(R) % 4 == 2, torch.tanh(v),
                            torch.sigmoid(v)).reshape(B, U, 4)
            for b in range(B):
                for u in range(U):
                    unit = u0 + u
                    if unit >= H:
                        continue
                    if s < lens[b]:
                        i, f, gg, o = g[b, u]
                        c = f * cs[blk, b, u] + i * gg
                        cs[blk, b, u] = c
                        hbuf[d, par, b, unit] = o * torch.tanh(c)
                        frame = s if d == 0 else lens[b] - 1 - s
                        y[b, frame, d * H + unit] = hbuf[d, par, b, unit]
                    else:
                        y[b, s, d * H + unit] = 0.0
        hs = hbuf[:, par].clone()
    for blk in range(D * bpd):
        d, u0 = blk // bpd, (blk % bpd) * U
        hi = min(u0 + U, H)
        y[:, steps:, d * H + u0:d * H + hi] = 0.0
    return y, plan


@pytest.mark.parametrize("B,T,H,bidirectional,sms,lengths", [
    (3, 7, 20, True, 16, "ragged"),      # U = 3: 7 blocks a direction
    (2, 6, 36, True, 4, "ragged"),       # U = 18: 2 blocks a direction
    (4, 5, 12, False, SMS, None),
    (3, 9, 8, True, SMS, "short"),       # every item shorter than T
])
def test_kernel_emulation_matches_plain(B, T, H, bidirectional, sms,
                                        lengths):
    mod = _module(5, H, bidirectional, seed=B * T)
    x = torch.randn(B, T, 5, generator=torch.Generator().manual_seed(3))
    lens = {"ragged": _ragged(B, T, seed=4), None: None,
            "short": torch.tensor([4, 0, 7])}[lengths]
    with torch.no_grad():
        got, plan = emulate(x, lens, mod.weights(), bidirectional, sms)
        want = lstm_plain(x, lens, mod.weights(), bidirectional)
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    if sms == 4:
        assert plan["units"] == 18 and plan["blocks"] == 4
    if lengths == "short":
        assert (got[:, 7:] == 0).all()


def test_lstm_route_and_plan():
    """The cells' widths (the duration and frame-level DAPs at 128, the
    text encoder at 256, the context at 520, bidirectional at B = 16) take
    the kernel with a block on (nearly) every SM, within the card's shared
    memory; gradients, bf16 and a width whose weights do not fit take
    cuDNN; a CPU input takes the cpu route."""
    f32 = torch.float32
    for H, units, blocks in ((128, 2, 128), (256, 4, 128), (520, 8, 130)):
        plan = lstm_plan(H, 16, 2, SMS)
        assert (plan["units"], plan["blocks"]) == (units, blocks)
        assert plan["smem"] <= lstm_mod.SMEM_CAP and plan["items"] == 8
        assert lstm_route("cuda", f32, False, H, 16, 2, SMS) == "kernel"
        assert lstm_route("cuda", f32, True, H, 16, 2, SMS) == "cudnn"
        assert lstm_route("cuda", torch.bfloat16, False, H, 16, 2,
                          SMS) == "cudnn"
        assert lstm_route("cpu", f32, False, H, 16, 2, SMS) == "cpu"
    # the context's (16, 520) plan: its bytes, as layout() sums them
    plan = lstm_plan(520, 16, 2, SMS)
    assert plan["smem"] == 4 * (32 * 520 + 16 * 520 + 2 * 16 * 32
                                + 2 * 16 * 8 + 16)
    assert [lstm_plan(8, B, 1, SMS)["items"] for B in (1, 3, 8, 40)] == [
        1, 4, 8, 8]
    assert lstm_plan(1024, 16, 2, SMS) is None
    assert lstm_route("cuda", f32, False, 1024, 16, 2, SMS) == "cudnn"
    assert lstm_route("cuda", None, False, 128, 16, 2, SMS) == "cudnn"
    assert MaskedLSTM(6, 4).route(torch.zeros(2, 3, 6)) == "cpu"


# -- on the card --------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")


# the cells' masked BiLSTMs at batch 16: a frame-level DAP (~870 frames at
# 128), the text encoder (160 tokens at 256, input 512), the context (435
# frame pairs at 520, input 1044); then the serving batches (the
# MicroBatcher's 1 to 8 items) on the other item groups: one item (G = 1),
# three (G = 4, one lane of the group idle) and five (G = 8, a partial
# group), and one direction at two items (G = 2)
CARD_SHAPES = [
    pytest.param(16, 870, 128, 256, True, id="16-870-128-256"),
    pytest.param(16, 160, 256, 512, True, id="16-160-256-512"),
    pytest.param(16, 435, 520, 1044, True, id="16-435-520-1044"),
    pytest.param(1, 870, 128, 256, True, id="1-870-128-256"),
    pytest.param(3, 160, 256, 512, True, id="3-160-256-512"),
    pytest.param(5, 435, 520, 1044, True, id="5-435-520-1044"),
    pytest.param(2, 300, 128, 256, False, id="2-300-128-256-forward"),
]


@pytest.mark.chip
@pytest.mark.parametrize("B,T,H,C,bidirectional", CARD_SHAPES)
def test_kernel_matches_plain_on_card(card, B, T, H, C, bidirectional):
    """csrc/lstm.cu at the cells' shapes and the serving batches, ragged
    lengths with 1 and T among them, against lstm_plain on the card within
    1e-4 * max|plain| (fp32 sums in another order over a recurrence, as
    ar_scan's limit); exact zeros past each length; one launch; the
    plan's shared-memory bytes those of the kernel's own layout."""
    mod = _module(C, H, bidirectional, seed=T).to(card)
    x = torch.randn(B, T, C, generator=torch.Generator().manual_seed(T))
    lens = _ragged(B, T, seed=T)
    if B > 2:
        lens[2] = T // 2
    x, lens = x.to(card), lens.to(card)
    with torch.no_grad():
        assert mod.route(x) == "kernel"
        before = lstm_mod.lstm_cuda.launches
        got = mod(x, lens)
        want = lstm_plain(x, lens, mod.weights(), bidirectional)
    torch.cuda.synchronize()
    assert lstm_mod.lstm_cuda.launches == before + 1
    scale = want.abs().max().item()
    assert scale > 0.05
    assert (got - want).abs().max().item() <= 1e-4 * scale
    past = torch.arange(T, device=card)[None, :] >= lens[:, None]
    assert (got[past] == 0).all()
    plan = lstm_plan(H, B, 2 if bidirectional else 1,
                     torch.cuda.get_device_properties(card)
                     .multi_processor_count)
    assert lstm_mod._lib.radtts_lstm_smem_bytes(
        B, plan["units"], plan["kp"], plan["items"]) == plan["smem"]
