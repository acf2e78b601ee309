"""The tensor-core MRF kernel's host side and arithmetic on the CPU.

csrc/mrf_tc.cu runs only on the card. What can be held here: the routing
rule that sends a stage to it, the weight packer it reads, and its
arithmetic (3xTF32: operands rounded as cvt.rna.tf32.f32 rounds them, split
hi/lo, the products hi*hi + hi*lo + lo*hi summed in fp32), emulated with
numpy-rounded operands and F.conv1d. Limits: the emulated chain within
1e-4 * max|plain| of mrf_plain (the kernel's limit on the card), and within
rtol/atol 1e-5 of the JAX pallas_mrf (C=128, 64) and pallas_mrf_folded
(C=32) in interpret mode, as tests/test_torch_ops.py holds mrf_plain.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from radtts_tpu.ops.pallas_mrf import pallas_mrf, pallas_mrf_folded

from radtts_tpu_torch.ops import mrf as mrf_mod
from radtts_tpu_torch.ops.mrf import (DILATIONS, LRELU_SLOPE, TC_CK,
                                      _conv_plain, bias_pack, mrf, mrf_cuda,
                                      mrf_plain, mrf_route, narrow,
                                      padded_width, stage_pack, tc_grid,
                                      tc_pack, tc_pack_narrow, tc_split,
                                      tc_tile, tf32_plane_rows, tf32_round)


def _weights(C, seed, std=0.03):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy((std * rng.standard_normal(shape))
                                .astype(np.float32))
    return [{"w1": rnd(3, k, C, C), "b1": rnd(3, C), "w2": rnd(3, k, C, C),
             "b2": rnd(3, C)} for k in (3, 7, 11)]


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _rna(t):
    """cvt.rna.tf32.f32 in numpy: round the 13 low mantissa bits to
    nearest, ties away from zero (sign-magnitude: add half, truncate)."""
    b = t.numpy().view(np.uint32)
    return torch.from_numpy(((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000))
                            .view(np.float32))


def _conv_emulated(x, w_taps, b, d, passes=3):
    """One conv of the chain as the kernel computes it. x (B, C, T) before
    leaky ReLU; w_taps (k, C_in, C_out)."""
    k = w_taps.shape[0]
    a = F.leaky_relu(x, LRELU_SLOPE)
    a_hi, w_hi = _rna(a), _rna(w_taps)
    a_lo, w_lo = _rna(a - a_hi), _rna(w_taps - w_hi)

    def conv(aa, ww):
        return F.conv1d(aa, ww.permute(2, 1, 0), None,
                        padding=(k - 1) // 2 * d, dilation=d)
    y = conv(a_hi, w_hi)
    if passes == 3:
        y = conv(a_lo, w_hi) + conv(a_hi, w_lo) + y
    return y + b[:, None]


def _mrf_emulated(x, weights, passes=3):
    """mrf_plain's chain with every conv as _conv_emulated."""
    xc = x.transpose(1, 2)
    out = torch.zeros_like(xc)
    for wd in weights:
        xr = xc
        for i, d in enumerate(DILATIONS):
            xt = _conv_emulated(xr, wd["w1"][i], wd["b1"][i], d, passes)
            xr = xr + _conv_emulated(xt, wd["w2"][i], wd["b2"][i], 1, passes)
        out = out + xr
    return (out / len(weights)).transpose(1, 2)


@pytest.mark.parametrize("C,tc", [(256, True), (128, True), (64, True),
                                  (32, True), (16, False), (8, False)])
def test_routing_rule(C, tc):
    """Every HiFi-GAN v1 width goes to the tensor cores; C=16 and C=8 to
    the stack kernel (tests/test_torch_mrf_stack.py has every width)."""
    assert (mrf_route(C) == "tc") is tc
    assert mrf_route(C) == ("tc" if tc else "stack")


def test_cpu_tensor_takes_plain_path_at_tensor_core_width():
    w = _weights(128, seed=1)
    x = _x((1, 40, 128), 2)
    before = (mrf.launches, mrf.tc_launches)
    torch.testing.assert_close(mrf(x, w), mrf_plain(x, w), rtol=0, atol=0)
    assert (mrf.launches, mrf.tc_launches) == before
    assert not mrf_mod._tc_libs    # nothing was built


def test_tile_and_grid_at_serving_and_training_shapes():
    assert tc_tile(256) == (128, 2) and tc_tile(128) == (64, 2)
    # tiles never straddle batch items: the batch is the grid's z
    assert tc_grid(1, 4864, 256) == (38, 2, 1)
    assert tc_grid(1, 38912, 128) == (304, 2, 1)
    assert tc_grid(16, 256, 256) == (2, 2, 16)
    assert tc_grid(2, 997, 128) == (8, 2, 2)
    assert tc_grid(1, 4864, 256, tile=(64, 1)) == (76, 4, 1)


@pytest.mark.parametrize("shape,grid", [
    ((1, 77824, 64), (608, 1, 1)),      # serving stages
    ((1, 155648, 32), (1216, 1, 1)),
    ((16, 4096, 64), (32, 1, 16)),      # training discriminator pass
    ((16, 8192, 32), (64, 1, 16)),
    ((2, 997, 32), (8, 1, 2)),          # ragged: the last tile is partial
])
def test_narrow_tile_and_grid(shape, grid):
    """At C=64 and C=32 one tile holds every output channel (TN = C), so a
    block reads its slab once; 128 time rows per tile."""
    B, T, C = shape
    assert tc_tile(C) == (C, 2)
    assert tc_grid(B, T, C) == grid
    assert tc_grid(B, T, C, tile=(C, 1)) == (-(-T // 64), 1, B)


def test_route_override_is_checked():
    w = _weights(32, seed=2)
    with pytest.raises(ValueError, match="unknown route"):
        mrf_cuda(_x((1, 16, 32), 3), w, route="fma")


def test_tf32_round_matches_cvt_rna():
    one = 1.0 + 2.0 ** -11         # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 0.0,
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                         0.0, 1.0 + 2.0 ** -9])
    torch.testing.assert_close(tf32_round(x), want, rtol=0, atol=0)
    r = _x((1000,), 3) * 100
    torch.testing.assert_close(tf32_round(r), _rna(r), rtol=0, atol=0)


def test_split_planes():
    w = _x((2, 3, 64, 96), 4) * 0.05
    hi, lo = tc_split(w)
    assert hi.shape == lo.shape == (2, 3, 96, 64)   # (.., C_out, C_in)
    assert (hi.contiguous().view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.contiguous().view(torch.int32) & 0x1FFF).eq(0).all()
    wt = w.transpose(-1, -2)
    torch.testing.assert_close(hi, _rna(wt.contiguous()), rtol=0, atol=0)
    err = ((hi.double() + lo.double()) - wt.double()).abs()
    assert (err <= 2.0 ** -22 * wt.double().abs()).all()


@pytest.mark.parametrize("tn", [64, 128, 32])
def test_pack_layout(tn):
    C, n_taps = 256, 5
    w = _x((n_taps, C, C), 5)
    p = tc_pack(w, tn)
    assert p.shape == (n_taps, C // tn, C // TC_CK, 2, TC_CK // 4, tn // 8,
                       8, 4)
    hi, lo = tc_split(w)
    rng = np.random.default_rng(tn)
    for j, co, ci in zip(rng.integers(0, n_taps, 50),
                         rng.integers(0, C, 50), rng.integers(0, C, 50)):
        block = p[j, co // tn, ci // TC_CK].reshape(2, -1)
        n, kk = co % tn, ci % TC_CK
        idx = ((kk // 4) * (tn // 8) + n // 8) * 32 + (n % 8) * 4 + kk % 4
        assert block[0, idx] == hi[j, co, ci]
        assert block[1, idx] == lo[j, co, ci]


@pytest.mark.parametrize("C", [64, 32])
def test_narrow_pack_layout(C):
    """The narrow kernel's unit: one operand of 2C rows per (tap, chunk),
    hi in rows [0, C), lo in [C, 2C)."""
    n_taps = 7
    w = _x((n_taps, C, C), C + 5)
    p = tc_pack_narrow(w)
    assert p.shape == (n_taps, C // TC_CK, TC_CK // 4, 2, C // 8, 8, 4)
    hi, lo = tc_split(w)
    rng = np.random.default_rng(C)
    for j, co, ci in zip(rng.integers(0, n_taps, 50),
                         rng.integers(0, C, 50), rng.integers(0, C, 50)):
        block = p[j, ci // TC_CK].reshape(-1)
        kk = ci % TC_CK
        for plane, ref in ((0, hi), (1, lo)):
            n = plane * C + co
            idx = ((kk // 4) * (C // 4) + n // 8) * 32 + (n % 8) * 4 + kk % 4
            assert block[idx] == ref[j, co, ci]


@pytest.mark.parametrize("C,tn,is_narrow", [(64, 64, True), (32, 32, True),
                                            (128, 128, False),
                                            (64, 32, False)])
def test_narrow_rule(C, tn, is_narrow):
    assert narrow(C, tn) is is_narrow


@pytest.mark.parametrize("B,T,C", [(1, 160, 256), (2, 97, 128), (2, 97, 64),
                                   (2, 101, 32)])
def test_3xtf32_emulation_matches_plain(B, T, C):
    w = _weights(C, seed=T, std=0.01)
    x = _x((B, T, C), C)
    ref = mrf_plain(x, w)
    got = _mrf_emulated(x, w)
    limit = 1e-4 * ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= limit
    # one TF32 pass would not do: the 3 passes are what keeps fp32 accuracy
    one_pass = (_mrf_emulated(x, w, passes=1) - ref).abs().max().item()
    assert one_pass > 30 * err


def test_3xtf32_emulation_matches_pallas():
    B, T, C = 2, 97, 128
    w = _weights(C, seed=7)
    x = _x((B, T, C), 8)
    jw = [{k: jnp.asarray(v.numpy()) for k, v in wd.items()} for wd in w]
    ref = pallas_mrf(jnp.asarray(x.numpy()), jw, tile=128, interpret=True)
    np.testing.assert_allclose(_mrf_emulated(x, w).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [64, 32])
def test_3xtf32_emulation_matches_pallas_narrow(C):
    """The narrow stages against the TPU kernels they replace: pallas_mrf
    at C=64, pallas_mrf_folded (4 frames folded into 128 lanes) at C=32,
    ragged T."""
    B, T = 2, 101
    w = _weights(C, seed=C + 1)
    x = _x((B, T, C), C + 2)
    jw = [{k: jnp.asarray(v.numpy()) for k, v in wd.items()} for wd in w]
    if C == 32:
        ref = pallas_mrf_folded(jnp.asarray(x.numpy()), jw, fold=4, tile=32,
                                interpret=True)
    else:
        ref = pallas_mrf(jnp.asarray(x.numpy()), jw, tile=128, interpret=True)
    np.testing.assert_allclose(_mrf_emulated(x, w).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def _fresh_pack(w, tn):
    C = w[0]["w1"].shape[-1]
    taps = torch.cat([wd[key].reshape(-1, C, C) for wd in w
                      for key in ("w1", "w2")])
    return tc_pack_narrow(taps) if narrow(C, tn) else tc_pack(taps, tn)


@pytest.mark.parametrize("C", [64, 128])
def test_stage_pack_is_kept_per_weight_version(C):
    """The packed stage is reused while the weights are unchanged, and
    rebuilt after an in-place update, a `.data` assignment, or for other
    tensors with the same values. At C=64 with tn=64 it is the narrow
    kernel's packing."""
    w = _weights(C, seed=9)
    first = stage_pack(w, 64)
    torch.testing.assert_close(first, _fresh_pack(w, 64), rtol=0, atol=0)
    assert stage_pack(w, 64) is first
    w[0]["w1"].add_(1e-3)                      # an optimizer step, in place
    second = stage_pack(w, 64)
    assert second is not first
    torch.testing.assert_close(second, _fresh_pack(w, 64), rtol=0, atol=0)
    w[2]["w2"].data = 2 * w[2]["w2"]           # new storage, same version
    third = stage_pack(w, 64)
    assert third is not second
    torch.testing.assert_close(third, _fresh_pack(w, 64), rtol=0, atol=0)
    copy = [{k: v.clone() for k, v in wd.items()} for wd in w]
    assert stage_pack(copy, 64) is not third
    assert stage_pack(w, 32) is not third      # another tile width


def _desc_rows(start, lbo, sbo, n_rows):
    """Float indices of an n_rows x 8 tf32 K-major operand read through a
    no-swizzle wgmma descriptor (byte offsets): element (m, kk) of core
    matrix (m // 8, kk // 4) at start + (m // 8) * sbo + (kk // 4) * lbo +
    (m % 8) * 16 + (kk % 4) * 4."""
    m = np.arange(n_rows)[:, None]
    kk = np.arange(8)[None, :]
    return (start + (m // 8) * sbo + (kk // 4) * lbo + (m % 8) * 16
            + (kk % 4) * 4) // 4


def _narrow_conv_emulated(x, w_taps, b, d, nwg):
    """One launch of csrc/mrf_tc.cu's narrow kernel, addressing and all. x
    (B, T, C) before leaky ReLU, w_taps (k, C_in, C_out), b (C,) -> (B, T,
    C) numpy, run at the padded width CP = padded_width(C) as the kernel
    runs it (the split writes the channels at and past C as zeros; the
    taps and the bias zero-padded as stage_pack and bias_pack pad them;
    the channels past C neither staged nor stored): per (item, time tile)
    the hi and lo planes of all CP channels (the 16-byte unit (group g, row
    i) at (g * R + i) * 16 bytes), then per (tap j, chunk c) unit of
    tc_pack_narrow and k-step q the kernel's descriptors: A at group 8c +
    2q, j d rows on; B the unit's 2CP rows (hi, then lo), its first CP for
    the lo * hi product; the sum acc_w[:, :CP] + (acc_w[:, CP:] +
    acc_l)."""
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
    units = tc_pack_narrow(w_taps).numpy().reshape(k * (C // TC_CK), -1)
    a = F.leaky_relu(torch.from_numpy(x), LRELU_SLOPE)
    a_hi = _rna(a)
    a_lo = _rna(a - a_hi)
    ib = np.concatenate([_desc_rows(q * C * 64, C * 32, 128, 2 * C)
                         for q in range(TC_CK // 8)], axis=1)
    y = np.zeros_like(x)
    for item in range(B):
        for t0 in range(0, T, TM):
            t = t0 - pad + np.arange(rows)
            inside = (t >= 0) & (t < T)
            planes = []
            for src in (a_hi.numpy(), a_lo.numpy()):
                slab = np.zeros((rows, C), np.float32)
                slab[inside] = src[item, t[inside]]
                plane = np.zeros((C // 4, R, 4), np.float32)
                plane[:, :rows] = slab.reshape(rows, C // 4, 4).transpose(
                    1, 0, 2)
                planes.append(plane.reshape(-1))
            acc_w = np.zeros((TM, 2 * C), np.float32)
            acc_l = np.zeros((TM, C), np.float32)
            for j in range(k):
                for c in range(C // TC_CK):
                    bw = units[j * (C // TC_CK) + c][ib]    # (2C, 32)
                    for wg in range(nwg):
                        ia = np.concatenate([_desc_rows(
                            (TC_CK // 4 * c + 2 * q) * R * 16
                            + (64 * wg + j * d) * 16, R * 16, 128, 64)
                            for q in range(TC_CK // 8)], axis=1)
                        rs = slice(64 * wg, 64 * wg + 64)
                        acc_w[rs] += planes[0][ia] @ bw.T
                        acc_l[rs] += planes[1][ia] @ bw[:C].T
            frag = acc_w[:, :C] + (acc_w[:, C:] + acc_l)
            n = min(TM, T - t0)
            y[item, t0:t0 + n] = frag[:n] + b.numpy()
    return y[..., :C_real]


@pytest.mark.parametrize("C,T,k,d,nwg", [
    (64, 101, 7, 3, 2), (64, 97, 11, 5, 1), (32, 97, 11, 1, 2),
    (32, 150, 3, 3, 1)])
def test_narrow_descriptor_emulation_matches_plain(C, T, k, d, nwg):
    """One conv through the narrow kernel's hi/lo planes, its descriptors
    and tc_pack_narrow's units equals the fp32 conv on the same inputs
    within 1e-6 * max (3xTF32 drops lo * lo, ~2^-22 of a product), ragged
    T."""
    rng = np.random.default_rng(C + T + k)
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32))
    w = torch.from_numpy((0.03 * rng.standard_normal((k, C, C)))
                         .astype(np.float32))
    b = torch.from_numpy((0.03 * rng.standard_normal(C)).astype(np.float32))
    want = _conv_plain(F.leaky_relu(x.transpose(1, 2), LRELU_SLOPE), w, b,
                       d).transpose(1, 2).numpy()
    got = _narrow_conv_emulated(x, w, b, d, nwg)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("passes", [3, 1])
def test_no_width_routes_to_the_fma_kernel(passes):
    """Every multiple of 4 up to 256 goes to the tensor cores at both
    precisions (csrc/mrf.cu runs only by name), but the stack kernel's
    C <= 16 stages of at most 4 resblocks; 5 resblocks at C=16 take the
    tensor cores too, padded to 32."""
    tc = "tf32" if passes == 1 else "tc"
    routes = {C: mrf_route(C, 3, passes) for C in range(4, 257, 4)}
    assert "conv" not in routes.values()
    assert {C for C, r in routes.items() if r == "stack"} == {4, 8, 12, 16}
    assert all(r == tc for C, r in routes.items() if C > 16)
    assert mrf_route(16, 5, passes) == tc and padded_width(16) == 32


@pytest.mark.parametrize("C,cp,tile", [
    (24, 32, (32, 2)), (20, 32, (32, 2)), (40, 64, (64, 2)),
    (48, 64, (64, 2)), (72, 96, (96, 1)), (96, 96, (96, 1)),
    (100, 128, (64, 2)), (160, 192, (64, 2)), (224, 256, (128, 2)),
    (32, 32, (32, 2)), (64, 64, (64, 2)), (256, 256, (128, 2))])
def test_padded_width_and_tile(C, cp, tile):
    """The padded width (the next multiple of 32 up to 96, 128 up to 128,
    the next multiple of 64 above) and its tile: the narrow kernel up to
    96 (one warpgroup at 96, whose planes alone fill the block), the wide
    kernel's tiles above; the v1 widths are their own."""
    assert padded_width(C) == cp and cp - C < 64 and cp % 32 == 0
    assert tc_tile(C) == tile
    assert narrow(C, tile[0]) is (cp <= 96)
    assert tc_grid(2, 997, C) == (-(-997 // (64 * tile[1])), cp // tile[0],
                                  2)


@pytest.mark.parametrize("C", [24, 96, 160])
def test_padded_pack(C):
    """stage_pack at a padded width: the taps zero in the padded rows and
    columns, the C real ones as tc_pack(_narrow) lays out the unpadded
    values; bias_pack zero past C and the C real biases as given."""
    w = _weights(C, seed=C)
    cp = padded_width(C)
    tn = tc_tile(C)[0]
    p = stage_pack(w, tn)
    n_taps = sum(3 * wd[key].shape[1] for wd in w for key in ("w1", "w2"))
    taps = torch.cat([wd[key].reshape(-1, C, C) for wd in w
                      for key in ("w1", "w2")])
    full = torch.zeros(n_taps, cp, cp)
    full[:, :C, :C] = taps
    want = tc_pack_narrow(full) if narrow(C, tn) else tc_pack(full, tn)
    torch.testing.assert_close(p, want, rtol=0, atol=0)
    # the padded rows and columns of both planes, read back, are zero
    hi, lo = tc_split(full)
    assert hi[:, C:].eq(0).all() and hi[:, :, C:].eq(0).all()
    assert lo[:, C:].eq(0).all() and lo[:, :, C:].eq(0).all()
    assert p.numel() == 2 * n_taps * cp * cp
    for wd, bd in zip(w, bias_pack(w)):
        for key in ("b1", "b2"):
            assert bd[key].shape == (3, cp) and bd[key].is_contiguous()
            torch.testing.assert_close(bd[key][:, :C], wd[key], rtol=0,
                                       atol=0)
            assert bd[key][:, C:].eq(0).all()
    assert bias_pack(w)[0]["b1"] is bias_pack(w)[0]["b1"]   # kept
    v1 = _weights(64, seed=1)
    assert bias_pack(v1)[1]["b2"] is v1[1]["b2"]     # unpadded: as given


@pytest.mark.parametrize("C,T,k,d", [(24, 101, 11, 5), (48, 97, 7, 3),
                                     (96, 131, 11, 1), (20, 70, 3, 5)])
def test_padded_narrow_conv_emulation_matches_plain(C, T, k, d):
    """One conv through the narrow kernel at the padded width (zero
    channels in the planes, zero-padded taps) equals the fp32 conv on the
    same inputs within 1e-6 * max, ragged T."""
    rng = np.random.default_rng(C + T + k)
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32))
    w = torch.from_numpy((0.03 * rng.standard_normal((k, C, C)))
                         .astype(np.float32))
    b = torch.from_numpy((0.03 * rng.standard_normal(C)).astype(np.float32))
    want = _conv_plain(F.leaky_relu(x.transpose(1, 2), LRELU_SLOPE), w, b,
                       d).transpose(1, 2).numpy()
    got = _narrow_conv_emulated(x, w, b, d, tc_tile(C)[1])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _narrow_chain_emulated(x, weights):
    """mrf_cuda's 18-launch chain (route "tc") at a narrow padded width,
    every launch as _narrow_conv_emulated."""
    nwg = tc_tile(x.shape[2])[1]
    out = np.zeros(tuple(x.shape), np.float32)
    for wd in weights:
        src = x.numpy()
        for i, d in enumerate(DILATIONS):
            xt = _narrow_conv_emulated(torch.from_numpy(src), wd["w1"][i],
                                       wd["b1"][i], d, nwg)
            src = src + _narrow_conv_emulated(
                torch.from_numpy(xt), wd["w2"][i], wd["b2"][i], 1, nwg)
        out += np.float32(1.0 / len(weights)) * src
    return out


@pytest.mark.parametrize("C", [24, 48, 96, 20])
def test_padded_chain_matches_plain_and_pallas(C):
    """The 18-launch chain on the narrow kernel at the padded width equals
    mrf_plain within 1e-4 * max (the card's limit) at C = 24, 48, 96 and
    20 (not a multiple of 8), and the JAX pallas_mrf in interpret mode,
    the TPU kernel these widths ran, within rtol/atol 1e-5 at C=24 and 96;
    ragged T."""
    B, T = 2, 97
    w = _weights(C, seed=C + 3)
    x = _x((B, T, C), C + 4)
    got = _narrow_chain_emulated(x, w)
    ref = mrf_plain(x, w).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    if C in (24, 96):
        jw = [{k: jnp.asarray(v.numpy()) for k, v in wd.items()} for wd in w]
        pal = pallas_mrf(jnp.asarray(x.numpy()), jw, tile=128,
                         interpret=True)
        np.testing.assert_allclose(got, np.asarray(pal), rtol=1e-5,
                                   atol=1e-5)
