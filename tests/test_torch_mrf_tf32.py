"""The one-pass TF32 MRF kernel's host side and operand addressing on the
CPU.

csrc/mrf_tf32.cu runs only on the card. What can be held here: the routing
rule that sends a stage to it at one pass, the one-plane weight packer it
reads, and its addressing, emulated in numpy: the activations rectified and
rounded once into a plane whose 4-channel groups hold all their rows
contiguously (tf32_plane_rows, an odd count), tap j's A operand read through
a no-swizzle K-major descriptor that starts 16 * j * d bytes further on
(LBO = rows * 16 bytes between channel groups, SBO = 128 between 8-row
groups), B through the packed unit's descriptor (LBO = tn * 16), and the
64 x 8 by 8 x tn products summed in fp32.

Limits: one emulated conv within 1e-6 * max of _conv_plain(..., passes=1)
(the same rounded operands; fp32 sums in another order); the emulated
one-pass chain against the JAX pallas_mrf (C=128, 64) and pallas_mrf_folded
(C=32) in interpret mode, which compute fp32 on the CPU, no further than
1.5x the distance between mrf_plain(passes=1) and mrf_plain on the same
inputs: TF32 rounding is the only difference either chain has from fp32,
and the kernel's summation order may move it a little, not by half again.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from radtts_tpu.ops.pallas_mrf import pallas_mrf, pallas_mrf_folded

from radtts_tpu_torch.ops import mrf as mrf_mod
from radtts_tpu_torch.ops.mrf import (DILATIONS, LRELU_SLOPE, TC_CK,
                                      _conv_plain, mrf, mrf_cuda, mrf_plain,
                                      mrf_route, padded_width, tf32_pack,
                                      tf32_plane_rows, tf32_round,
                                      tf32_stage_pack, tf32_tile)
from tests.test_torch_mrf_tc import _desc_rows, _rna, _weights, _x



def _conv_emulated(x, w_taps, b, d, tn, nwg, res=None):
    """One launch of csrc/mrf_tf32.cu, addressing and all. x (B, T, C)
    before leaky ReLU, w_taps (k, C_in, C_out), b (C,) -> (B, T, C) numpy,
    run at the padded width CP = padded_width(C) as the kernel runs it
    (the slab's channels at and past C zero, the taps and the bias
    zero-padded as tf32_stage_pack and bias_pack pad them, the channels
    past C not stored): per (item, time tile, C_out tile, C_in chunk) the
    plane is built from the slab, then per tap and warpgroup the four
    k-steps read their A and B operands through the kernel's
    descriptors."""
    C_real = x.shape[2]
    C = padded_width(C_real)
    x = F.pad(x, (0, C - C_real)).numpy()
    w_taps = F.pad(w_taps, (0, C - C_real, 0, C - C_real))
    b = F.pad(b, (0, C - C_real))
    B, T, _ = x.shape
    k = w_taps.shape[0]
    TM, R = 64 * nwg, tf32_plane_rows(nwg)
    pad = (k - 1) // 2 * d
    rows = TM + 2 * pad
    units = tf32_pack(w_taps, tn).numpy().reshape(-1)
    unit = tn * TC_CK
    a = tf32_round(F.leaky_relu(torch.from_numpy(x), LRELU_SLOPE)).numpy()
    # a tap's operands over the four k-steps (k-step q: groups 2q, 2q + 1)
    ia = np.concatenate([_desc_rows(2 * q * R * 16, R * 16, 128, 64)
                         for q in range(TC_CK // 8)], axis=1)
    ib = np.concatenate([_desc_rows(q * tn * 32, tn * 16, 128, tn)
                         for q in range(TC_CK // 8)], axis=1)
    y = np.zeros_like(x)
    for item in range(B):
        for t0 in range(0, T, TM):
            t = t0 - pad + np.arange(rows)
            inside = (t >= 0) & (t < T)
            for nt in range(C // tn):
                acc = np.zeros((TM, tn), np.float32)
                for c in range(C // TC_CK):
                    slab = np.zeros((rows, TC_CK), np.float32)
                    slab[inside] = a[item, t[inside],
                                     c * TC_CK:(c + 1) * TC_CK]
                    # unit (group g, row i) at (g * R + i) * 16 bytes
                    plane = np.zeros((TC_CK // 4, R, 4), np.float32)
                    plane[:, :rows] = slab.reshape(rows, TC_CK // 4,
                                                   4).transpose(1, 0, 2)
                    plane = plane.reshape(-1)
                    for j in range(k):
                        u = ((j * (C // tn) + nt) * (C // TC_CK) + c) * unit
                        bw = units[u + ib]                  # (tn, 32)
                        for wg in range(nwg):
                            start = (64 * wg + j * d) * 16 // 4
                            acc[64 * wg:64 * wg + 64] += (
                                plane[ia + start] @ bw.T)
                n = min(TM, T - t0)
                y[item, t0:t0 + n, nt * tn:(nt + 1) * tn] = (
                    acc[:n] + b.numpy()[nt * tn:(nt + 1) * tn])
    y = y[..., :C_real]
    return y if res is None else y + res


def _chain_emulated(x, weights, tn, nwg):
    """mrf_cuda's 18-launch chain (route "tf32") with every launch as
    _conv_emulated."""
    out = np.zeros(tuple(x.shape), np.float32)
    for wd in weights:
        src = x.numpy()
        for i, d in enumerate(DILATIONS):
            xt = _conv_emulated(torch.from_numpy(src), wd["w1"][i],
                                wd["b1"][i], d, tn, nwg)
            src = _conv_emulated(torch.from_numpy(xt), wd["w2"][i],
                                 wd["b2"][i], 1, tn, nwg, res=src)
        out += np.float32(1.0 / len(weights)) * src
    return out


@pytest.mark.parametrize("C,route", [(256, "tf32"), (128, "tf32"),
                                     (512, "tf32"), (192, "tf32"),
                                     (64, "tf32"), (32, "tf32"),
                                     (16, "stack"), (8, "stack"),
                                     (48, "tf32"), (96, "tf32"),
                                     (24, "tf32"), (160, "tf32")])
def test_routing_rule_at_one_pass(C, route):
    """At one pass csrc/mrf_tf32.cu takes every width but the stack's
    (C=48, 96, 24 and 160 padded; csrc/mrf.cu, which took them, runs only
    by name); at three passes those widths go to csrc/mrf_tc.cu; the stack
    kernel takes its widths at both."""
    assert mrf_route(C, 3, passes=1) == route
    assert mrf_route(C, 3, passes=3) == ("tc" if route == "tf32" else route)
    assert mrf_route(C) == mrf_route(C, 3, passes=3)


def test_one_pass_arguments_are_checked():
    w = _weights(32, seed=2)
    x = _x((1, 16, 32), 3)
    with pytest.raises(ValueError, match="passes=1"):
        mrf_cuda(x, w, route="tf32", passes=3)
    with pytest.raises(ValueError, match="passes=2"):
        mrf_cuda(x, w, passes=2)


def test_cpu_tensor_at_default_precision_takes_plain_path():
    from radtts_tpu_torch.ops import precision

    w = _weights(64, seed=1)
    x = _x((1, 40, 64), 2)
    before = (mrf.tf32_launches, mrf.tc1_launches)
    with precision.scope("default"):
        got = mrf(x, w)
    torch.testing.assert_close(got, mrf_plain(x, w), rtol=0, atol=0)
    assert (mrf.tf32_launches, mrf.tc1_launches) == before
    assert mrf_mod._tf32_lib is None     # nothing was built


@pytest.mark.parametrize("C,tile", [(256, (128, 2)), (128, (128, 2)),
                                    (64, (64, 2)), (32, (32, 2)),
                                    (192, (64, 2)), (96, (96, 2)),
                                    (48, (64, 2)), (24, (32, 2)),
                                    (160, (64, 2)), (100, (128, 2))])
def test_tile(C, tile):
    """TN = CP (the padded width) up to 96, 128 at the multiples of 128,
    else 64: a tile the kernel takes (TN in 32, 64, 96, 128 dividing CP) at
    every width mrf_route sends it, C=192 among them."""
    assert tf32_tile(C) == tile
    assert tile[0] in (32, 64, 96, 128) and padded_width(C) % tile[0] == 0
    assert mrf_route(C, 3, 1) == "tf32"


@pytest.mark.parametrize("tn", [128, 64, 32])
def test_pack_layout(tn):
    """One plane: element (co, ci) of unit (tap, co // tn, ci // 32) at
    ((ci % 32 // 4) * tn / 8 + co % tn // 8) * 32 + (co % 8) * 4 + ci % 4,
    holding tf32_round(w[tap, ci, co]) (rounded to nearest as cvt.rna)."""
    C, n_taps = 256, 5
    w = _x((n_taps, C, C), tn)
    p = tf32_pack(w, tn)
    assert p.shape == (n_taps, C // tn, C // TC_CK, TC_CK // 4, tn // 8, 8,
                       4)
    want = _rna(w.contiguous())
    rng = np.random.default_rng(tn)
    for j, co, ci in zip(rng.integers(0, n_taps, 60),
                         rng.integers(0, C, 60), rng.integers(0, C, 60)):
        unit = p[j, co // tn, ci // TC_CK].reshape(-1)
        n, kk = co % tn, ci % TC_CK
        idx = ((kk // 4) * (tn // 8) + n // 8) * 32 + (n % 8) * 4 + kk % 4
        assert unit[idx] == want[j, ci, co]
    assert (p.contiguous().view(torch.int32) & 0x1FFF).eq(0).all()


def test_plane_rows_are_odd_and_hold_every_tap():
    for nwg in (1, 2):
        rows = tf32_plane_rows(nwg)
        assert rows % 2 == 1
        # the last warpgroup's last row at the widest tap shift
        assert 64 * nwg - 1 + mrf_mod.TF32_MAX_HALO < rows


@pytest.mark.parametrize("C,T,k,d,tn,nwg", [
    (256, 97, 3, 5, 128, 1), (256, 70, 11, 1, 64, 1),
    (128, 131, 7, 3, 128, 2), (128, 97, 11, 5, 64, 1),
    (64, 101, 11, 5, 64, 1), (64, 150, 7, 3, 32, 2),
    (32, 97, 11, 3, 32, 1), (32, 201, 3, 1, 32, 2),
    (160, 97, 11, 5, 64, 1), (24, 101, 7, 3, 32, 2), (96, 70, 11, 1, 96, 1)])
def test_descriptor_emulation_matches_plain(C, T, k, d, tn, nwg):
    """One conv through the kernel's plane, descriptors and packed units
    equals _conv_plain(..., passes=1) on the same inputs, ragged T; C=160
    and C=24 at their padded widths (192, 32), C=96 in one 96-wide
    tile."""
    rng = np.random.default_rng(C + T + k)
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32))
    w = torch.from_numpy((0.03 * rng.standard_normal((k, C, C)))
                         .astype(np.float32))
    b = torch.from_numpy((0.03 * rng.standard_normal(C)).astype(np.float32))
    want = _conv_plain(F.leaky_relu(x.transpose(1, 2), LRELU_SLOPE), w, b,
                       d, passes=1).transpose(1, 2).numpy()
    got = _conv_emulated(x, w, b, d, tn, nwg)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale


@pytest.mark.parametrize("C", [128, 64, 32, 24, 96])
def test_one_pass_chain_matches_pallas(C):
    """The emulated chain against the TPU kernels it replaces: pallas_mrf
    at C=128 and C=64 (and at C=24 and 96, padded to 32 and run as one
    96-wide tile), pallas_mrf_folded (4 frames folded into 128 lanes) at
    C=32, ragged T; within 1.5x the one-pass plain version's own distance
    from fp32 (see the module's docstring)."""
    B, T = 2, 97
    w = _weights(C, seed=C + 11)
    x = _x((B, T, C), C + 12)
    jw = [{k: jnp.asarray(v.numpy()) for k, v in wd.items()} for wd in w]
    if C == 32:
        ref = pallas_mrf_folded(jnp.asarray(x.numpy()), jw, fold=4, tile=32,
                                interpret=True)
    else:
        ref = pallas_mrf(jnp.asarray(x.numpy()), jw, tile=128,
                         interpret=True)
    ref = np.asarray(ref)
    tn, nwg = (96 if C == 96 else min(padded_width(C), 64)), 1
    got = _chain_emulated(x, w, tn, nwg)
    tf32_dist = (mrf_plain(x, w, passes=1) - mrf_plain(x, w)).abs().max()
    assert tf32_dist > 0
    assert np.abs(got - ref).max() <= 1.5 * tf32_dist.item()
    # and the one-pass plain chain within the card's limit
    one = mrf_plain(x, w, passes=1).numpy()
    assert np.abs(got - one).max() <= 1e-4 * np.abs(one).max()


def test_stage_pack_is_kept_per_weight_version():
    w = _weights(64, seed=9)
    first = tf32_stage_pack(w, 64)
    taps = torch.cat([wd[key].reshape(-1, 64, 64) for wd in w
                      for key in ("w1", "w2")])
    torch.testing.assert_close(first, tf32_pack(taps, 64), rtol=0, atol=0)
    assert tf32_stage_pack(w, 64) is first
    w[1]["w2"].add_(1e-3)                      # an optimizer step, in place
    second = tf32_stage_pack(w, 64)
    assert second is not first
    taps = torch.cat([wd[key].reshape(-1, 64, 64) for wd in w
                      for key in ("w1", "w2")])
    torch.testing.assert_close(second, tf32_pack(taps, 64), rtol=0, atol=0)
    assert tf32_stage_pack(w, 32) is not second    # another tile width
    assert mrf_mod.stage_pack(w, 64) is not second  # the 3xTF32 packing


@pytest.mark.parametrize("C,tn", [(48, 64), (20, 32), (96, 96)])
def test_padded_one_pass_chain_matches_plain(C, tn):
    """At widths that run padded (C=48 and 20 with zero channels, C=96 in
    one 96-wide tile) the emulated one-pass chain equals
    mrf_plain(passes=1) within the card's 1e-4 * max, ragged T. (C=160,
    padded to 192, is held one conv at a time in
    test_descriptor_emulation_matches_plain.)"""
    B, T = 2, 97
    w = _weights(C, seed=C + 21)
    x = _x((B, T, C), C + 22)
    assert tf32_tile(C)[0] == tn
    got = _chain_emulated(x, w, tn, 1)
    one = mrf_plain(x, w, passes=1).numpy()
    assert np.abs(got - one).max() <= 1e-4 * np.abs(one).max()


def test_padded_one_pass_pack():
    """tf32_stage_pack at C=24 (padded to 32): the padded taps' units zero
    in the padded rows and columns, the real ones rounded as tf32_pack
    rounds the unpadded values."""
    C, cp = 24, 32
    w = _weights(C, seed=31)
    p = tf32_stage_pack(w, 32)
    taps = torch.cat([wd[key].reshape(-1, C, C) for wd in w
                      for key in ("w1", "w2")])
    full = torch.zeros(taps.shape[0], cp, cp)
    full[:, :C, :C] = taps
    torch.testing.assert_close(p, tf32_pack(full, 32), rtol=0, atol=0)
    unit = p.reshape(taps.shape[0], -1)
    rows = torch.arange(cp)      # (co, ci) of the unit, core-matrix order
    co, ci = rows[:, None].expand(cp, cp), rows[None, :].expand(cp, cp)
    idx = ((ci // 4) * (cp // 8) + co // 8) * 32 + (co % 8) * 4 + ci % 4
    pad = (co >= C) | (ci >= C)
    assert unit[:, idx[pad]].eq(0).all()
    assert unit[:, idx[~pad]].ne(0).any()
