"""The stack-fused MRF kernel's host side and tiling on the CPU.

csrc/mrf_stack.cu runs only on the card. What can be held here: the routing
rule that sends a stage to it (every width), its tile rule, the weight
order it streams, and its tiling, emulated: overlapping slabs of a tile
plus a 6 (k_max - 1)-row halo a side, each conv computed only on the rows
that stay valid (rows outside them are NaN here, so a read past them shows),
outputs at rows outside [0, T) masked to zero, tiles stitched. Limits: the
emulation within rtol/atol 1e-5 of mrf_plain (fp32 sums in another order);
mrf on a CPU tensor and the emulation within 1e-5 of the JAX pallas_mrf in
interpret mode at C=16 and C=8, as tests/test_torch_ops.py holds mrf_plain.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from radtts_tpu.ops.pallas_mrf import pallas_mrf

from radtts_tpu_torch.ops import mrf as mrf_mod
from radtts_tpu_torch.ops.mrf import (DILATIONS, LRELU_SLOPE, STACK_MAX_TILE,
                                      mrf, mrf_cuda, mrf_plain, mrf_route,
                                      stack_pack, stack_tile)


def _weights(C, seed, ks=(3, 7, 11), std=0.05):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy((std * rng.standard_normal(shape))
                                .astype(np.float32))
    return [{"w1": rnd(3, k, C, C), "b1": rnd(3, C), "w2": rnd(3, k, C, C),
             "b2": rnd(3, C)} for k in ks]


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _valid_conv(a, w_taps, b, d):
    """Unpadded conv of slab rows a (L, C) -> (L - (k - 1) d, C)."""
    return F.conv1d(a.T[None], w_taps.permute(2, 1, 0), b, dilation=d)[0].T


def _stack_emulated(x, weights, max_rows=STACK_MAX_TILE, sms=None):
    """csrc/mrf_stack.cu's tiling in torch: per (batch item, tile) a slab of
    the tile plus the halo, per resblock only the rows its chain needs,
    each conv on the rows that stay valid, masks outside [0, T), the mean
    of the tile's rows written once."""
    B, T, C = x.shape
    ks = [wd["w1"].shape[1] for wd in weights]
    halo = 6 * (max(ks) - 1)
    tile = stack_tile(T, B, sms, max_rows)
    S = tile + 2 * halo
    out = torch.full_like(x, float("nan"))
    lrelu = lambda v: F.leaky_relu(v, LRELU_SLOPE)   # noqa: E731
    for b in range(B):
        for t0 in range(0, T, tile):
            t = t0 - halo + torch.arange(S)
            inside = ((t >= 0) & (t < T))[:, None].float()
            slab = torch.zeros(S, C)
            slab[inside[:, 0] > 0] = x[b, t[inside[:, 0] > 0]]
            mean = torch.zeros(tile, C)
            for wd, k in zip(weights, ks):
                half = (k - 1) // 2
                lo, hi = halo - 12 * half, S - halo + 12 * half
                xr = torch.full((S, C), float("nan"))
                xr[lo:hi] = slab[lo:hi]
                for i, d in enumerate(DILATIONS):
                    xt = torch.full((S, C), float("nan"))
                    p1 = half * d
                    y = _valid_conv(lrelu(xr[lo:hi]), wd["w1"][i],
                                    wd["b1"][i], d)
                    lo, hi = lo + p1, hi - p1
                    xt[lo:hi] = lrelu(y * inside[lo:hi])
                    y = _valid_conv(xt[lo:hi], wd["w2"][i], wd["b2"][i], 1)
                    lo, hi = lo + half, hi - half
                    xr[lo:hi] = xr[lo:hi] + y * inside[lo:hi]
                assert (lo, hi) == (halo, halo + tile)
                mean += xr[halo:halo + tile]
            n = min(tile, T - t0)
            out[b, t0:t0 + n] = (mean / len(weights))[:n]
    return out


@pytest.mark.parametrize("C,route", [
    (4, "stack"), (8, "stack"), (12, "stack"), (16, "stack"),
    (20, "tc"), (24, "tc"), (32, "tc"), (48, "tc"), (64, "tc"),
    (96, "tc"), (128, "tc"), (160, "tc"), (192, "tc"), (256, "tc"),
    (512, "tc")])
def test_route(C, route):
    """The stack kernel takes C <= 16; every other width the tensor
    cores, padded where it is not a tile width (C=20, 24, 48, 96, 160)."""
    assert mrf_route(C) == route


@pytest.mark.parametrize("C,n_rb,route", [
    (16, 1, "stack"), (16, 4, "stack"), (16, 5, "tc"), (8, 6, "tc"),
    (4, 5, "tc"), (32, 5, "tc"), (48, 5, "tc")])
def test_route_by_resblock_count(C, n_rb, route):
    """A C <= 16 stage with more resblocks than the stack kernel takes
    goes to the tensor cores' narrow kernel, padded to 32, which takes any
    count; mrf_cuda routes by the weights it is given."""
    assert mrf_route(C, n_rb) == route


@pytest.mark.parametrize("n_rb,build", [(5, "build_tc"),
                                        (3, "build_stack")])
def test_mrf_cuda_routes_by_resblock_count(monkeypatch, n_rb, build):
    """At C=16 mrf_cuda builds csrc/mrf_tc.cu for 5 resblocks and the
    stack kernel for 3 (each build is stubbed to stop there)."""
    class Built(Exception):
        pass

    def stub(name):
        def fn(*args):
            raise Built(name)
        return fn

    for name in ("build", "build_tc", "build_stack"):
        monkeypatch.setattr(mrf_mod, name, stub(name))
    monkeypatch.setattr(mrf_mod, "_lib", None)
    monkeypatch.setattr(mrf_mod, "_tc_libs", {})
    monkeypatch.setattr(mrf_mod, "_stack_lib", None)
    w = _weights(16, seed=8, ks=(3,) * n_rb)
    with pytest.raises(Built, match=f"^{build}$"):
        mrf_cuda(_x((1, 16, 16), 9), w)


def test_route_at_every_width():
    """Every multiple of 4 up to 1024 has exactly one route; the stack
    kernel takes exactly C <= 16, the tensor cores every other width."""
    routes = {C: mrf_route(C) for C in range(4, 1025, 4)}
    assert set(routes.values()) == {"tc", "stack"}
    assert [C for C, r in routes.items() if r == "stack"] == [4, 8, 12, 16]
    assert all(r == "tc" for C, r in routes.items() if C > 16)


@pytest.mark.parametrize("T,tile", [(77824, 400), (155648, 400), (997, 333),
                                    (400, 400), (401, 201), (50, 50),
                                    (1, 1)])
def test_stack_tile(T, tile):
    assert stack_tile(T) == tile
    n = -(-T // tile)
    assert tile <= STACK_MAX_TILE and (n - 1) * tile < T <= n * tile


@pytest.mark.parametrize("B,T,sms,tile,blocks", [
    (1, 77824, 132, 295, 264),     # HiFi-GAN V2's C=16 stage: 2 per SM
    (1, 155648, 132, 394, 396),    # C=8: 3 per SM
    (2, 997, 132, 333, 6),         # fewer blocks than SMs: as without sms
    (3, 40000, 16, 393, 306),      # 3 x 100 tiles -> 19 waves of 16
])
def test_stack_tile_fills_the_sms(B, T, sms, tile, blocks):
    """Where the blocks fill the card at least once, their count is raised
    to about a multiple of the SM count, so no SM gets more than others."""
    assert stack_tile(T, B, sms) == tile
    n = -(-T // tile)
    assert B * n == blocks and tile <= STACK_MAX_TILE


@pytest.mark.parametrize("B,T,C,max_rows", [
    (1, 997, 16, STACK_MAX_TILE),   # ragged: 3 tiles of 333
    (2, 997, 8, STACK_MAX_TILE),    # B = 2: no leak between batch items
    (2, 50, 16, STACK_MAX_TILE),    # T below one tile and below the halo
    (1, 301, 4, 64),                # the tests' small vocoder width
    (2, 257, 8, 32),                # many tiles, each smaller than the halo
])
def test_stack_emulation_matches_plain(B, T, C, max_rows):
    w = _weights(C, seed=T + C)
    x = _x((B, T, C), C)
    got = _stack_emulated(x, w, max_rows, sms=4)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, mrf_plain(x, w), rtol=1e-5, atol=1e-5)


def test_stack_emulation_other_kernel_sizes():
    """Two resblocks of k = 3 and 5: the halo follows the largest k."""
    w = _weights(8, seed=3, ks=(3, 5))
    x = _x((2, 203, 8), 4)
    torch.testing.assert_close(_stack_emulated(x, w, 64), mrf_plain(x, w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [16, 8])
def test_mrf_and_emulation_match_pallas(C):
    """mrf on a CPU tensor and the stack kernel's tiling against the TPU
    kernel the stack kernel replaces at these widths, ragged T, B = 2."""
    B, T = 2, 301
    w = _weights(C, seed=C + 11, std=0.03)
    x = _x((B, T, C), C + 12)
    jw = [{k: jnp.asarray(v.numpy()) for k, v in wd.items()} for wd in w]
    ref = np.asarray(pallas_mrf(jnp.asarray(x.numpy()), jw, tile=128,
                                interpret=True))
    np.testing.assert_allclose(mrf(x, w).numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_stack_emulated(x, w, 128).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensor_launches_nothing_at_stack_width():
    w = _weights(16, seed=5)
    x = _x((1, 90, 16), 6)
    before = (mrf.launches, mrf.tc_launches, mrf.stack_launches)
    torch.testing.assert_close(mrf(x, w), mrf_plain(x, w), rtol=0, atol=0)
    assert (mrf.launches, mrf.tc_launches, mrf.stack_launches) == before
    assert mrf.stack_launches == 0
    assert mrf_mod._stack_lib is None    # nothing was built


def test_stack_pack_order_and_cache():
    """One conv after another: per resblock and dilation w1, b1, w2, b2;
    kept while the weights are unchanged, rebuilt after an update."""
    C = 8
    w = _weights(C, seed=7, ks=(3, 7))
    packed = stack_pack(w)
    off = 0
    for wd in w:
        k = wd["w1"].shape[1]
        for i in range(3):
            for key, n in (("w1", k * C * C), ("b1", C), ("w2", k * C * C),
                           ("b2", C)):
                torch.testing.assert_close(packed[off:off + n],
                                           wd[key][i].reshape(-1), rtol=0,
                                           atol=0)
                off += n
    assert off == packed.numel() == 6 * (3 + 7) * C * C + 12 * C
    assert stack_pack(w) is packed
    w[1]["b2"].add_(1.0)
    again = stack_pack(w)
    assert again is not packed
    assert again[-C:].sub(w[1]["b2"][2]).abs().max() == 0


@pytest.mark.parametrize("C,n_rb", [(32, 3), (20, 3), (8, 5)])
def test_stack_route_refuses_other_shapes(C, n_rb):
    """route="stack" takes C in (4, 8, 12, 16) and at most 4 resblocks; it
    refuses before building anything."""
    w = _weights(C, seed=8, ks=(3,) * n_rb)
    with pytest.raises(ValueError, match="stack kernel"):
        mrf_cuda(_x((1, 16, C), 9), w, route="stack")
    assert mrf_mod._stack_lib is None
