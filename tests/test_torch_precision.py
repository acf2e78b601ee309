"""--matmul_precision in the port (radtts_tpu_torch/ops/precision.py): the
scope and its fp32 islands, and mrf_plain(..., passes=1), the plain
version of csrc/mrf_tc.cu's one-TF32-pass build. (The CLIs: tests/
test_torch_inference_cli.py and tests/test_torch_vc.py.)"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radtts_tpu_torch.ops import mrf as mrf_mod
from radtts_tpu_torch.ops import precision
from radtts_tpu_torch.synthesizer import resolve_device

FLAGS = (lambda: (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32))


def test_scope_sets_and_restores_the_flags():
    """TF32 on inside "high" and "default" (one MRF pass at "default"
    only), off inside an island and under "highest"; everything restored
    after each block, also when it raises; a resolve_device call (as a
    load makes) does not leak a scope's flags out of it."""
    resolve_device("cpu")
    assert FLAGS() == (False, False) and precision.mrf_passes() == 3
    for name, tf32, passes in (("default", True, 1), ("high", True, 3),
                               ("highest", False, 3)):
        with precision.scope(name):
            assert FLAGS() == (tf32, tf32)
            assert precision.mrf_passes() == passes
            with precision.scope("highest"):
                assert FLAGS() == (False, False)
                assert precision.mrf_passes() == 3
            assert FLAGS() == (tf32, tf32)
            assert precision.mrf_passes() == passes
        assert FLAGS() == (False, False)
    with pytest.raises(RuntimeError):
        with precision.scope("default"):
            raise RuntimeError
    assert FLAGS() == (False, False) and precision.mrf_passes() == 3
    with pytest.raises(ValueError, match="matmul_precision"):
        precision.check("bfloat16")
    assert precision.check(None) == "highest"


def test_island_is_fp32_inside_any_scope():
    seen = []

    @precision.island
    def fn(x):
        seen.append(FLAGS())
        return x + 1

    with precision.scope("default"):
        assert fn(1) == 2
        assert FLAGS() == (True, True)
    assert seen == [(False, False)]
    assert fn.__name__ == "fn"


def _mrf_float64(x, weights):
    """mrf_plain(passes=1)'s function in float64: each conv's input (after
    the leaky ReLU) and taps rounded to TF32 in fp32, then every product
    and sum in float64."""
    def conv(v, w, b, d):
        k = w.shape[0]
        v = mrf_mod.tf32_round(v.float()).double()
        w = mrf_mod.tf32_round(w).double()
        return F.conv1d(v, w.permute(2, 1, 0), b.double(),
                        padding=(k - 1) // 2 * d, dilation=d)

    xc = x.double().transpose(1, 2)
    out = torch.zeros_like(xc)
    for wd in weights:
        xr = xc
        for i, d in enumerate(mrf_mod.DILATIONS):
            xt = conv(F.leaky_relu(xr, mrf_mod.LRELU_SLOPE), wd["w1"][i],
                      wd["b1"][i], d)
            xt = conv(F.leaky_relu(xt, mrf_mod.LRELU_SLOPE), wd["w2"][i],
                      wd["b2"][i], 1)
            xr = xr + xt
        out = out + xr
    return (out / len(weights)).transpose(1, 2)


def _weights(C, rng):
    out = []
    for k in mrf_mod.KERNEL_SIZES:
        std = 1.0 / np.sqrt(k * C)
        out.append({key: torch.from_numpy((std * rng.standard_normal(
            (3, k, C, C) if key[0] == "w" else (3, C))).astype(np.float32))
            for key in ("w1", "b1", "w2", "b2")})
    return out


@pytest.mark.parametrize("C", [32, 64])
def test_mrf_plain_one_pass_matches_tf32_products(C):
    """Each conv of mrf_plain(passes=1) within 1e-6 * max of the float64
    conv of its TF32-rounded operands (fp32 sums against float64 ones);
    the whole stack within 1e-4 * max of the same stack in float64 (a
    rounding boundary crossed between the two chains moves an operand by a
    TF32 ulp), while the fp32 stack lies past that limit: the limit tells
    one pass from fp32."""
    rng = np.random.default_rng(C)
    x = torch.from_numpy(rng.standard_normal((2, 150, C)).astype(np.float32))
    weights = _weights(C, rng)
    v = F.leaky_relu(x.transpose(1, 2), mrf_mod.LRELU_SLOPE)
    for k_idx, d in ((0, 1), (1, 3), (2, 5)):
        w, b = weights[k_idx]["w1"][k_idx], weights[k_idx]["b1"][k_idx]
        got = mrf_mod._conv_plain(v, w, b, d, passes=1)
        k = w.shape[0]
        want = F.conv1d(mrf_mod.tf32_round(v).double(),
                        mrf_mod.tf32_round(w).double().permute(2, 1, 0),
                        b.double(), padding=(k - 1) // 2 * d, dilation=d)
        err = (got.double() - want).abs().max() / want.abs().max()
        assert err <= 1e-6, (k, d, float(err))
    got = mrf_mod.mrf_plain(x, weights, passes=1)
    want = _mrf_float64(x, weights)
    scale = want.abs().max()
    err = (got.double() - want).abs().max() / scale
    assert err <= 1e-4, float(err)
    full = (mrf_mod.mrf_plain(x, weights).double() - want).abs().max()
    assert full / scale > 1e-4, (float(full / scale), float(err))
    with pytest.raises(ValueError, match="passes"):
        mrf_mod.mrf_plain(x, weights, passes=2)


def test_mrf_on_the_cpu_is_fp32_at_every_precision():
    """The CPU path runs mrf_plain in fp32 at "default" too (the CPU has
    no TF32): the port's CPU output is the same at every setting."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(
        np.float32))
    weights = _weights(32, rng)
    want = mrf_mod.mrf(x, weights)
    with precision.scope("default"):
        assert torch.equal(mrf_mod.mrf(x, weights), want)
