"""HiFi-GAN multi-receptive-field (MRF) resblock stack of one upsample stage:

    mean_k RB_k(x),
    RB_k(x): 3x [x += conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))], d in (1, 3, 5),

lrelu slope 0.1, every conv zero-padded at 0 and T.

Port of the TPU kernels in radtts_tpu/ops/pallas_mrf.py (pallas_mrf,
pallas_mrf_wide, pallas_mrf_folded: one function at four widths). On the
card `mrf` chains 18 launches of the hand-written kernel in csrc/mrf.cu
(see its header for the design and what bounds it); `mrf_plain` is the same
function in plain PyTorch, which the CPU path, the tests and every pass
that needs gradients use.

weights: one dict per resblock, {w1: (3, k, C, C), b1: (3, C), w2: (3, k, C,
C), b2: (3, C)}, w*[i] being the dilation-i conv taps-major (k, C_in, C_out)
as in the JAX package's packed layout.
"""

import ctypes

import torch
import torch.nn.functional as F

from radtts_tpu_torch.ops.cuda_build import build_library

DILATIONS = (1, 3, 5)
LRELU_SLOPE = 0.1

_lib = None


def _conv_plain(x, w_taps, b, d):
    """x (B, C, T); w_taps (k, C_in, C_out) -> same-padded conv."""
    k = w_taps.shape[0]
    return F.conv1d(x, w_taps.permute(2, 1, 0), b, padding=(k - 1) // 2 * d,
                    dilation=d)


def mrf_plain(x, weights):
    """Plain PyTorch MRF mean, as the JAX package's _resblock1_apply runs
    it: one F.conv1d per conv. x: (B, T, C) -> (B, T, C)."""
    xc = x.transpose(1, 2)
    out = torch.zeros_like(xc)
    for wd in weights:
        xr = xc
        for i, d in enumerate(DILATIONS):
            xt = _conv_plain(F.leaky_relu(xr, LRELU_SLOPE), wd["w1"][i],
                             wd["b1"][i], d)
            xt = _conv_plain(F.leaky_relu(xt, LRELU_SLOPE), wd["w2"][i],
                             wd["b2"][i], 1)
            xr = xr + xt
        out = out + xr
    return (out / len(weights)).transpose(1, 2)


def build():
    """Compile csrc/mrf.cu (ops/cuda_build.py) and load it. Returns
    (library, nvcc output, build seconds)."""
    global _lib
    lib, log, seconds = build_library("mrf")
    fn = lib.radtts_mrf_conv
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib, log, seconds


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"mrf: {name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mrf: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"mrf: {name} must be contiguous and 16-byte "
                         "aligned")


def _conv_launch(x, w, b, d, res, out, acc, acc_scale):
    B, T, C = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib.radtts_mrf_conv(
        _ptr(x), _ptr(w), _ptr(b), _ptr(res), _ptr(out), _ptr(acc),
        acc_scale, B, T, C, w.shape[0], d, LRELU_SLOPE, stream)
    if err != 0:
        raise RuntimeError(f"mrf: kernel launch failed with cudaError {err} "
                           f"(B={B}, T={T}, C={C}, k={w.shape[0]}, d={d})")
    mrf.launches += 1


def mrf(x, weights):
    """MRF mean of one stage. x: (B, T, C) float32 -> (B, T, C).

    A CPU tensor runs mrf_plain. A CUDA tensor runs the hand-written kernel
    (18 launches for three resblocks), or raises. The kernel has no
    backward: with grad enabled and x or a weight requiring grad it raises,
    since its output would carry no gradient; differentiate mrf_plain."""
    if x.device.type == "cpu":
        return mrf_plain(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"mrf: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for wd in weights for t in wd.values())):
        raise RuntimeError(
            "mrf: the CUDA kernel has no backward, and its output would "
            "carry no gradient; run it under torch.no_grad() or use "
            "mrf_plain (Generator mrf_impl='plain')")
    if _lib is None:
        build()
    B, T, C = x.shape
    _check("x", x, (B, T, C), x.device)
    if C % 4:
        raise ValueError(f"mrf: C={C} must be a multiple of 4")
    for m, wd in enumerate(weights):
        k = wd["w1"].shape[1]
        if k % 2 == 0 or k > 11:
            raise ValueError(f"mrf: resblock {m} kernel size {k} is not "
                             "supported")
        n = len(DILATIONS)
        for key in ("w1", "w2"):
            _check(f"{key}[{m}]", wd[key], (n, k, C, C), x.device)
        for key in ("b1", "b2"):
            _check(f"{key}[{m}]", wd[key], (n, C), x.device)

    out = torch.zeros_like(x)
    xr = torch.empty_like(x)
    xt = torch.empty_like(x)
    scale = 1.0 / len(weights)
    for wd in weights:
        src = x
        for i, d in enumerate(DILATIONS):
            last = i == len(DILATIONS) - 1
            _conv_launch(src, wd["w1"][i], wd["b1"][i], d, None, xt, None,
                         0.0)
            _conv_launch(xt, wd["w2"][i], wd["b2"][i], 1, src,
                         None if last else xr, out if last else None, scale)
            src = xr
    return out


mrf.launches = 0
