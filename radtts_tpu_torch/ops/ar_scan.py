"""The AGAP's autoregressive flow inverse over frames: one AR step's
sampling, for B items at once, with (prev, the attribute LSTM's and each
stacked layer's (h, c)) carried from frame to frame.

Port of radtts_tpu/models/attributes.py:ar_step_infer, which the JAX
package compiles as one lax.scan over frames (not a Pallas kernel). On the
card `ar_scan` launches the hand-written kernel csrc/ar_scan.cu once per
call (one cooperative launch; see its header for the design and what
bounds it); `ar_scan_plain` is the same loop over frames in plain PyTorch,
which the CPU path and the tests use. Both take the step's weights as
`ARStep.scan_params()` gives them and the context half of the stacked
LSTM's first input projection precomputed for every frame
(`context_proj`, (B, T, 4H)): the same math as the JAX scan, summed in
another order.
"""

import ctypes

import numpy as np
import torch

from radtts_tpu_torch.ops.cuda_build import build_library
from radtts_tpu_torch.ops.invertible import scaling_and_log_s
from radtts_tpu_torch.ops.splines import spline_transform

KINDS = {"quadratic": 0, "linear": 1, "affine": 2}
SCALINGS = {"translate": 0, "exp": 1, "tanh": 2, "sigmoid": 3}
ACTS = {None: 0, "relu": 1, "tanh": 2}
MAX_LAYERS = 4        # csrc/ar_scan.cu kMaxLayers
MAX_HEAD = 8          # kMaxHead
MAX_BINS = 64         # kMaxBins
N_SCALARS = 10        # kNumScalars
_lib = None


def _bias(b):
    """A layer's bias: (b_ih, b_hh) summed, or None."""
    return None if b is None else b[0] + b[1]


def _cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _act(x, act):
    if act == "relu":
        return torch.relu(x)
    if act == "tanh":
        return torch.tanh(x)
    return x


def _head_inverse(params, res, q):
    """The inverse of one frame: res (B, C) by the head's output q."""
    C = res.shape[-1]
    if params["kind"] == "affine":
        s, _ = scaling_and_log_s(q[:, :C], params["scaling_fn"])
        return (res - q[:, C:]) / s
    left, right, bottom, top = params["bounds"]
    nb = params["n_bins"]
    z = (res - bottom) / (top - bottom)
    y, _ = spline_transform(z, q.reshape(-1, C, nb), nb,
                            params["kind"] == "quadratic", True)
    return y * (right - left) + left


def ar_scan_plain(params, residual, context_proj):
    """residual (B, T, C), context_proj (B, T, 4H) -> (B, T, C): the loop
    over frames in torch ops."""
    B, T, C = residual.shape
    w_ih_a, w_hh_a, b_a = params["attr"]
    b_a = _bias(b_a)
    H = w_hh_a.shape[1]
    zeros = residual.new_zeros(B, H)
    prev = residual.new_zeros(B, C)
    attr = (zeros, zeros)
    layers = [(zeros, zeros) for _ in params["lstm"]]
    outs = []
    for t in range(T):
        attr = _cell(prev @ w_ih_a.T + b_a + attr[0] @ w_hh_a.T, attr[1])
        x = attr[0]
        for li, (w_ih, w_hh, b) in enumerate(params["lstm"]):
            gx = x @ w_ih.T + (context_proj[:, t] if li == 0 else _bias(b))
            layers[li] = _cell(gx + layers[li][0] @ w_hh.T, layers[li][1])
            x = layers[li][0]
        for w, b, act in params["head"]:
            x = _act(x @ w.T + b, act)
        prev = _head_inverse(params, residual[:, t], x)
        outs.append(prev)
    return torch.stack(outs, dim=1)


def build():
    """Compile csrc/ar_scan.cu (ops/cuda_build.py) and load it. Returns
    (library, nvcc output, build seconds)."""
    global _lib
    lib, log, seconds = build_library("ar_scan")
    lib.radtts_ar_scan.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.radtts_ar_scan.restype = ctypes.c_int
    lib.radtts_ar_scan_max_blocks.argtypes = [ctypes.c_int]
    lib.radtts_ar_scan_max_blocks.restype = ctypes.c_int
    lib.radtts_ar_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.radtts_ar_scan_smem_bytes.restype = ctypes.c_int
    _lib = lib
    return lib, log, seconds


def _weights(params):
    """Every weight tensor of params, in the packing order."""
    w_ih, w_hh, b = params["attr"]
    out = [w_ih, w_hh, *b]
    for w_ih, w_hh, b in params["lstm"]:
        out += [w_ih, w_hh] + ([] if b is None else list(b))
    for w, b, _ in params["head"]:
        out += [w, b]
    return out


def pack(params):
    """(one flat fp32 tensor of the weights, its offsets) as the kernel
    reads them: each LSTM layer's [W_ih | W_hh] as one (4H, in + H)
    matrix, then its summed bias; each head layer's (out, in) matrix and
    bias; every segment at a multiple of 4 floats. Made anew on every
    launch (about 8 MB at the published width, a few copies against a
    launch of tens of ms), so it always holds the weights as they are."""
    segs, offsets = [], {}
    size = 0

    def add(name, t):
        nonlocal size
        t = t.detach().float().reshape(-1)
        pad = (-t.numel()) % 4
        offsets[name] = size
        segs.append(t)
        if pad:
            segs.append(t.new_zeros(pad))
        size += t.numel() + pad

    w_ih_a, w_hh_a, b_a = params["attr"]
    add("w_lstm0", torch.cat([w_ih_a, w_hh_a], dim=1))
    add("b_lstm0", _bias(b_a))
    for li, (w_ih, w_hh, b) in enumerate(params["lstm"]):
        add(f"w_lstm{li + 1}", torch.cat([w_ih, w_hh], dim=1))
        if b is not None:
            add(f"b_lstm{li + 1}", _bias(b))
    for k, (w, b, _) in enumerate(params["head"]):
        add(f"w_head{k}", w)
        add(f"b_head{k}", b)
    return torch.cat(segs).contiguous(), offsets


def check_shapes(params, B, T, C, H):
    """Raise, by name, on a shape csrc/ar_scan.cu does not take."""
    L, n_head = len(params["lstm"]), len(params["head"])
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"ar_scan: n_lstm_layers={L} outside 1..{MAX_LAYERS}")
    if not 1 <= n_head <= MAX_HEAD:
        raise ValueError(f"ar_scan: {n_head} head layers outside "
                         f"1..{MAX_HEAD}")
    kind = params["kind"]
    if kind not in KINDS:
        raise ValueError(f"ar_scan: head kind {kind!r} not supported")
    if kind == "affine" and params["scaling_fn"] not in SCALINGS:
        raise ValueError(f"ar_scan: scaling_fn {params['scaling_fn']!r} "
                         "not supported (one function for every channel)")
    n_out = params["head"][-1][0].shape[0]
    if kind == "affine":
        if n_out != 2 * C:
            raise ValueError(f"ar_scan: affine head gives {n_out} values, "
                             f"C={C} needs {2 * C}")
    else:
        nb = params["n_bins"]
        bins = nb // 2 if kind == "quadratic" else nb
        if not 1 <= bins <= MAX_BINS:
            raise ValueError(f"ar_scan: {bins} spline bins outside "
                             f"1..{MAX_BINS}")
        if n_out != C * nb:
            raise ValueError(f"ar_scan: spline head gives {n_out} values, "
                             f"C={C} with {nb} bins needs {C * nb}")


def _widths(params, C, H):
    """(kmax, nq): the widest layer input and the head's output width."""
    head = params["head"]
    kmax = max([C + H, 2 * H] + [w.shape[1] for w, _, _ in head])
    return kmax, head[-1][0].shape[0]


def config(params, offsets, B, T, C, H):
    """(icfg, fcfg, scratch floats, kmax, nq) of the kernel's interface,
    with `offsets` from pack(params)."""
    L, head = len(params["lstm"]), params["head"]
    kmax, nq = _widths(params, C, H)
    icfg = [B, T, C, H, L, KINDS[params["kind"]],
            SCALINGS.get(params.get("scaling_fn"), 0),
            params.get("n_bins") or 0, len(head), kmax]
    icfg += [offsets.get(f"w_lstm{i}", 0) for i in range(MAX_LAYERS + 1)]
    icfg += [offsets.get(f"b_lstm{i}", -1) for i in range(MAX_LAYERS + 1)]
    pad = [0] * (MAX_HEAD - len(head))
    act_off, off = [], 3 * (L + 1) * B * H
    for w, _, _ in head:
        act_off.append(off)
        off += B * w.shape[0]
    icfg += [offsets[f"w_head{k}"] for k in range(len(head))] + pad
    icfg += [offsets[f"b_head{k}"] for k in range(len(head))] + pad
    icfg += [w.shape[1] for w, _, _ in head] + pad
    icfg += [w.shape[0] for w, _, _ in head] + pad
    icfg += [ACTS[a] for _, _, a in head] + pad
    icfg += act_off + pad
    fcfg = list(params.get("bounds") or (0.0, 0.0, 0.0, 1.0))
    return icfg, fcfg, off, kmax, nq


def max_blocks(params, B, C, H):
    """The most blocks the cooperative launch can take at this shape."""
    if _lib is None:
        build()
    kmax, nq = _widths(params, C, H)
    return _lib.radtts_ar_scan_max_blocks(
        _lib.radtts_ar_scan_smem_bytes(B, C, kmax, nq))


def ar_scan_cuda(params, residual, context_proj, blocks=None):
    """csrc/ar_scan.cu on the card; `blocks` overrides the block count
    (by default one per SM, as many as can be resident)."""
    B, T, C = residual.shape
    H = params["attr"][1].shape[1]
    dev = residual.device
    for name, t, shape in (("residual", residual, (B, T, C)),
                           ("context_proj", context_proj, (B, T, 4 * H))):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != shape):
            raise ValueError(f"ar_scan: {name} must be float32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for t in _weights(params):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("ar_scan: weights must be float32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    check_shapes(params, B, T, C, H)
    if B == 0 or T == 0:
        return residual.new_zeros(B, T, C)
    if _lib is None:
        build()
    weights, offsets = pack(params)
    icfg, fcfg, n_scratch, kmax, nq = config(params, offsets, B, T, C, H)
    smem = _lib.radtts_ar_scan_smem_bytes(B, C, kmax, nq)
    limit = _lib.radtts_ar_scan_max_blocks(smem)
    if limit < 1:
        raise ValueError(f"ar_scan: B={B} needs {smem} bytes of shared "
                         "memory a block, more than a block can take")
    if blocks is None:
        blocks = min(limit, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    if not 1 <= blocks <= limit:
        raise ValueError(f"ar_scan: {blocks} blocks outside 1..{limit}")
    residual = residual.contiguous()
    context_proj = context_proj.contiguous()
    out = torch.empty_like(residual)
    scratch = torch.zeros(n_scratch, dtype=torch.float32, device=dev)
    barrier = torch.zeros(2, dtype=torch.int32, device=dev)
    icfg_c = (ctypes.c_int * len(icfg))(*icfg)
    fcfg_c = (ctypes.c_float * 4)(*fcfg)
    err = _lib.radtts_ar_scan(
        weights.data_ptr(), residual.data_ptr(), context_proj.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), barrier.data_ptr(),
        ctypes.addressof(icfg_c),
        ctypes.addressof(fcfg_c), blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ar_scan: kernel launch failed with cudaError "
                           f"{err} (B={B}, T={T}, C={C}, H={H}, "
                           f"blocks={blocks})")
    ar_scan.launches += 1
    return out


def ar_scan(params, residual, context_proj):
    """One AR step's inverse over every frame. A CPU tensor runs
    ar_scan_plain; a CUDA tensor launches csrc/ar_scan.cu, or raises. The
    kernel has no backward: with grad enabled and an input or a weight
    requiring grad it raises."""
    if residual.device.type == "cpu":
        return ar_scan_plain(params, residual, context_proj)
    if residual.device.type != "cuda":
        raise ValueError(f"ar_scan: unsupported device {residual.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [residual, context_proj]
            + _weights(params)):
        raise RuntimeError("ar_scan: the CUDA kernel has no backward, and "
                           "its output would carry no gradient; run it "
                           "under torch.no_grad()")
    return ar_scan_cuda(params, residual, context_proj)


ar_scan.launches = 0


def macs_per_frame(params, C):
    """Multiply-adds a frame and item: the bound's operation count."""
    w_ih_a, w_hh_a, _ = params["attr"]
    n = w_ih_a.numel() + w_hh_a.numel()
    for w_ih, w_hh, _ in params["lstm"]:
        n += w_ih.numel() + w_hh.numel()
    # layer 0's context half is in context_proj (one matmul before)
    return n + sum(w.numel() for w, _, _ in params["head"])


def weight_bytes(params):
    return 4 * int(np.sum([t.numel() for t in _weights(params)]))
