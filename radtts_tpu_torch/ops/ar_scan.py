"""The AGAP's autoregressive flow inverse over frames: one AR step's
sampling, for B items at once, with (prev, the attribute LSTM's and each
stacked layer's (h, c)) carried from frame to frame.

Port of radtts_tpu/models/attributes.py:ar_step_infer, which the JAX
package compiles as one lax.scan over frames (not a Pallas kernel). On the
card `ar_scan_multi` runs one or more steps ("problems": f0's and energy's
flows) in the launches `ar_scan_plan` names, each a cooperative launch of
csrc/ar_scan.cu's resident kernel: by default one, every block holding its
slice of the weights in shared memory, the blocks split between the
problems by their weight bytes; a problem whose weights do not fit the
blocks' shared memory runs split (route "split"): each block keeps the rows
that fit and reads the others from its overflow image in global memory
(L2) every frame; H and head widths that are not multiples of 4 are
zero-padded (`pad_widths`). The
choice is by shape. csrc/ar_scan.cu's barrier kernel (`ar_scan_cuda`),
which took the steps that did not fit before, runs only when called by
name. See the kernel's header for the designs.
`ar_scan_plain` is the same loop over frames in plain PyTorch, which the
CPU path and the tests use. All take the step's weights as
`ARStep.scan_params()` gives them and the context half of the stacked
LSTM's first input projection precomputed for every frame
(`context_proj`, (B, T, 4H)): the same math as the JAX scan, summed in
another order.
"""

import collections
import ctypes
import weakref

import numpy as np
import torch

from radtts_tpu_torch.debug import check_finite
from radtts_tpu_torch.ops import flops
from radtts_tpu_torch.ops.cuda_build import build_library
from radtts_tpu_torch.ops.invertible import scaling_and_log_s
from radtts_tpu_torch.ops.splines import spline_transform

KINDS = {"quadratic": 0, "linear": 1, "affine": 2}
SCALINGS = {"translate": 0, "exp": 1, "tanh": 2, "sigmoid": 3}
ACTS = {None: 0, "relu": 1, "tanh": 2}
# a head layer's act code | ROUND_BF16: its input rounded to bf16 (a
# bf16-stored kernel, see `widened`); csrc/ar_scan.cu kRoundBf16
ROUND_BF16 = 4
MAX_LAYERS = 4        # csrc/ar_scan.cu kMaxLayers
MAX_HEAD = 8          # kMaxHead
MAX_BINS = 64         # kMaxBins
N_SCALARS = 10        # kNumScalars
# the resident kernel (csrc/ar_scan.cu ar_scan_resident_kernel)
MAX_PROBLEMS = 4      # kMaxProblems
MAX_SEGS = 2 + MAX_LAYERS + MAX_HEAD   # kMaxSegs
SEG_INTS = 6          # kSegInts
MAX_PHASES = MAX_LAYERS + MAX_HEAD     # kMaxPhases
RES_SCALARS = 23      # rNumScalars
RES_INTS = RES_SCALARS + MAX_SEGS + 4 * MAX_HEAD + MAX_PHASES  # kResInts
# a block's dynamic shared memory: the card's 232448 bytes less the
# kernel's static slice table and problem
SMEM_CAP = 232448 - 1024
PLAN_CACHE_SIZE = 32  # ar_scan_plan's results kept, by shape
PADDED_CACHE_SIZE = 8  # kernel_params' results kept, by weight version
_lib = None
_plans = collections.OrderedDict()
_padded = collections.OrderedDict()


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
    params = widened(params)
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
        for (w, b, act), rnd in zip(params["head"], params["head_bf16"]):
            if rnd:
                x = x.to(torch.bfloat16).float()
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
    lib.radtts_ar_scan_resident.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.radtts_ar_scan_resident.restype = ctypes.c_int
    lib.radtts_ar_scan_resident_ints.restype = ctypes.c_int
    lib.radtts_ar_scan_trace_frames.restype = ctypes.c_int
    lib.radtts_ar_scan_trace_stamps.restype = ctypes.c_int
    lib.radtts_handoff_probe.argtypes = [ctypes.c_void_p] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.radtts_handoff_probe.restype = ctypes.c_int
    if lib.radtts_ar_scan_resident_ints() != RES_INTS:
        raise RuntimeError("ar_scan: csrc/ar_scan.cu's kResInts differs "
                           "from ops/ar_scan.py's RES_INTS")
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
    widths = [H] + [w.shape[0] for w, _, _ in params["head"]]
    if [w.shape[1] for w, _, _ in params["head"]] != widths[:-1]:
        raise ValueError(f"ar_scan: head widths {widths[1:]} do not chain "
                         f"from H={H}")
    if any(w_ih.shape[1] != H for w_ih, _, _ in params["lstm"]):
        raise ValueError("ar_scan: a stacked layer's input (without "
                         f"context) is not H={H} wide")


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
    icfg += _act_codes(params) + pad
    icfg += act_off + pad
    fcfg = list(params.get("bounds") or (0.0, 0.0, 0.0, 1.0))
    return icfg, fcfg, off, kmax, nq


def _act_codes(params):
    """Each head layer's activation code, with ROUND_BF16 where its kernel
    is bf16-stored (`widened`'s head_bf16)."""
    return [ACTS[a] | (ROUND_BF16 if rnd else 0) for (_, _, a), rnd in
            zip(params["head"], widened(params)["head_bf16"])]


def ar_scan_cuda(params, residual, context_proj, blocks=None):
    """csrc/ar_scan.cu's barrier kernel (the grid barrier, weights read from
    L2) on the card, which no route names (the split resident launch took
    its shapes): called by name, as chip_smoke.py's "before"; `blocks`
    overrides the block count (by default one per SM, as many as can be
    resident)."""
    params = widened(params)
    B, T, C = residual.shape
    H = params["attr"][1].shape[1]
    dev = residual.device
    _check_inputs(params, residual, context_proj)
    if B == 0 or T == 0:
        return residual.new_zeros(B, T, C)
    if _lib is None:
        build()
    weights, offsets = pack(params)
    icfg, fcfg, n_scratch, kmax, nq = config(params, offsets, B, T, C, H)
    smem = _lib.radtts_ar_scan_smem_bytes(B, C, kmax, nq)
    with torch.cuda.device(dev):    # the attribute and occupancy: dev's
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
    with torch.cuda.device(dev):
        err = _lib.radtts_ar_scan(
            weights.data_ptr(), residual.data_ptr(), context_proj.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), barrier.data_ptr(),
            ctypes.addressof(icfg_c), ctypes.addressof(fcfg_c), blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ar_scan: kernel launch failed with cudaError "
                           f"{err} (B={B}, T={T}, C={C}, H={H}, "
                           f"blocks={blocks})")
    ar_scan.barrier_launches += 1
    return out


def _check_inputs(params, residual, context_proj):
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


# ---------------------------------------------------------------------------
# the resident kernel: its plan, its weight images, its launch
# ---------------------------------------------------------------------------


def _pad4(n):
    return (n + 3) // 4 * 4


def _segments(params):
    """The sliced weight segments of one step, in the kernel's order (the
    attribute LSTM's recurrent rows, each stacked layer, each head layer):
    (units, rows a unit, row length K, biased). An LSTM unit is its four
    gate rows."""
    H = params["attr"][1].shape[1]
    segs = [(H, 4, H, False)]
    for w_ih, w_hh, b in params["lstm"]:
        segs.append((H, 4, w_ih.shape[1] + H, b is not None))
    segs += [(w.shape[0], 1, w.shape[1], True) for w, _, _ in params["head"]]
    return segs


def _split(units, blocks):
    """Contiguous slices of `units` over `blocks` blocks: (starts, counts)."""
    edges = (np.arange(blocks + 1) * units) // blocks
    return edges[:-1], np.diff(edges)


def problem_plan(params, B, blocks, smem_cap=SMEM_CAP):
    """One problem's layout on `blocks` blocks of the resident kernel: each
    block's slice of every segment and where it sits (`table`, (blocks,
    MAX_SEGS, SEG_INTS): first unit or row, count, weight and bias offsets
    in floats in shared memory, then the split: units kept in shared memory
    and the others' offset in the block's overflow image), the activation
    offsets, the bytes a block, and each phase's producers (the blocks that
    own rows of it).

    Where every block's slices fit `smem_cap` bytes beside its state, all
    are kept ("split": False). Else ("split": True) each block keeps, in
    segment order, as many whole units (an LSTM unit's four gate rows, a
    head row) as fit beside its state, its common part (W_ih_attr and the
    attribute bias) and every bias; its other units go to its overflow image
    in global memory, read through L2 every frame. `streamed` lists the
    overflow units as (block, segment, first unit, count); raises where a
    block's state alone does not fit."""
    C, H = params["attr"][0].shape[1], params["attr"][1].shape[1]
    L, head = len(params["lstm"]), params["head"]
    segs = _segments(params)
    n_segs = len(segs)
    split = [_split(units, blocks) for units, _, _, _ in segs]
    lds = [_pad4(K) for _, _, K, _ in segs]
    unit_floats = np.array([r * ld for (_, r, _, _), ld in zip(segs, lds)])
    counts = np.stack([c for _, c in split], 1)          # (blocks, n_segs)
    rows = np.array([r for _, r, _, _ in segs])
    biased = np.array([b for _, _, _, b in segs])
    bias_floats = np.where(biased, (counts * rows + 3) // 4 * 4, 0)
    n_common = _pad4(4 * H * C) + _pad4(4 * H)
    cmax = int(max(c.max() for _, c in split[1:1 + L]))
    nq = head[-1][0].shape[0]
    xmax = max([4 * H] + [w.shape[1] for w, _, _ in head[1:]])
    sizes = [("hs", (L + 1) * B * H), ("cattr", B * H),
             ("cown", L * cmax * B), ("xs", B * xmax), ("qs", B * nq),
             ("prev", B * C), ("ctx", 2 * cmax * 4 * B), ("res", 2 * B * C)]
    state = sum(_pad4(n) for _, n in sizes)
    full = n_common + bias_floats.sum(1) + (counts * unit_floats).sum(1)
    cap = smem_cap // 4
    n_split = state + _pad4(int(full.max())) > cap
    n_res = counts.copy()
    if n_split:
        room = cap - state - n_common - bias_floats.sum(1)
        if (room < 0).any():
            raise ValueError(
                f"ar_scan: B={B} at H={H} needs {4 * (cap - room.min())} "
                f"bytes of state, common weights and biases a block, more "
                f"than the {smem_cap} a block can take")
        rem = room // 4 * 4
        for s in range(n_segs):           # every block at once
            n_res[:, s] = np.minimum(counts[:, s], rem // unit_floats[s])
            rem = rem - n_res[:, s] * unit_floats[s]
    n_ovf = counts - n_res
    off, o = {}, 0
    for name, n in sizes:
        off[name] = o
        o += _pad4(n)
    off["img"] = o
    table = np.zeros((blocks, MAX_SEGS, SEG_INTS), np.int32)
    table[:, 0, :4] = (0, 0, o, o + _pad4(4 * H * C))
    img = np.full(blocks, n_common)
    ovf = np.zeros(blocks, np.int64)
    for s in range(n_segs):
        t = table[:, s + 1]
        t[:, 0], t[:, 1] = split[s][0], counts[:, s]
        t[:, 2] = o + img
        img = img + n_res[:, s] * unit_floats[s]
        t[:, 3] = np.where(biased[s], o + img, 0)
        img = img + bias_floats[:, s]
        t[:, 4], t[:, 5] = n_res[:, s], ovf
        ovf = ovf + n_ovf[:, s] * unit_floats[s]
    stride = int(_pad4(img.max()))
    producers = [int(((split[0][1] if li == 0 else 0) + split[1 + li][1]
                      > 0).sum()) for li in range(L)]
    producers += [int((c > 0).sum()) for _, c in split[1 + L:]]
    streamed = [(int(i), int(s), int(split[s][0][i] + n_res[i, s]),
                 int(n_ovf[i, s])) for i, s in zip(*np.nonzero(n_ovf))]
    return {"blocks": blocks, "B": B, "C": C, "H": H, "L": L,
            "segments": segs, "table": table, "offsets": off, "cmax": cmax,
            "xmax": xmax, "img_floats": img, "img_stride": stride,
            "smem": 4 * (o + stride), "producers": producers, "ld": lds,
            "split": bool(n_split), "ovf_floats": ovf,
            "ovf_stride": int(_pad4(ovf.max())), "streamed": streamed}


def item_group(B):
    """Items a warp of the resident kernel takes at once (its template G):
    the least power of two >= B, at most 8."""
    return min(8, 1 << max(0, int(B) - 1).bit_length())


def resident_widths_ok(params):
    """The resident kernel reads every activation in float4s: H and every
    head layer's input width must be multiples of 4 (else `pad_widths`
    pads them)."""
    H = params["attr"][1].shape[1]
    return H % 4 == 0 and all(w.shape[1] % 4 == 0
                              for w, _, _ in params["head"])


def _pad_gates(t, H, Hp, cols=None):
    """t (4H, ...) -> (4Hp, ...), each gate's rows [q H, q H + H) at q Hp,
    zeros between; with `cols`, its last dimension's first H columns
    spread to Hp as well (cols = (offset, H, Hp): the columns [offset,
    offset + H) become [offset, offset + Hp))."""
    t = t.reshape(4, H, *t.shape[1:])
    t = torch.cat([t, t.new_zeros(4, Hp - H, *t.shape[2:])], 1)
    t = t.reshape(4 * Hp, *t.shape[2:])
    if cols is not None:
        t = _pad_cols(t, *cols)
    return t


def _pad_cols(t, offset, n, n_padded):
    """t's last dimension's columns [offset, offset + n) widened to
    n_padded, zeros after them."""
    return torch.cat([t[..., :offset + n],
                      t.new_zeros(*t.shape[:-1], n_padded - n),
                      t[..., offset + n:]], -1)


def pad_widths(params, context_proj=None):
    """(params, context_proj) with H and every head layer's width but the
    last padded to multiples of 4 by zero rows and columns (the resident
    kernel reads activations in float4s), or as they are where they are
    multiples already. The padded LSTM units have zero weights and biases,
    so their cells stay at h = c = 0 (i = f = o = 1/2, g = 0 from c = 0),
    and the padded head rows give act(0) = 0; the padded columns meet only
    those zeros: every real output is unchanged. context_proj (B, T, 4H) is
    padded per gate as the gate rows are."""
    if resident_widths_ok(params):
        return params, context_proj
    H = params["attr"][1].shape[1]
    Hp = _pad4(H)

    def bias(b):
        return None if b is None else tuple(_pad_gates(v, H, Hp) for v in b)

    w_ih_a, w_hh_a, b_a = params["attr"]
    out = dict(params)
    out["attr"] = (_pad_gates(w_ih_a, H, Hp),
                   _pad_gates(w_hh_a, H, Hp, (0, H, Hp)), bias(b_a))
    out["lstm"] = [(_pad_gates(w_ih, H, Hp, (0, H, Hp)),
                    _pad_gates(w_hh, H, Hp, (0, H, Hp)), bias(b))
                   for w_ih, w_hh, b in params["lstm"]]
    head, n_in = [], Hp
    for k, (w, b, act) in enumerate(params["head"]):
        n_out = w.shape[0] if k + 1 == len(params["head"]) else _pad4(
            w.shape[0])
        w = _pad_cols(w, 0, w.shape[1], n_in)
        head.append((torch.cat([w, w.new_zeros(n_out - w.shape[0], n_in)]),
                     torch.cat([b, b.new_zeros(n_out - b.shape[0])]), act))
        n_in = n_out
    out["head"] = head
    return out, _pad_context(context_proj, H, Hp)


def _pad_context(context_proj, H, Hp):
    """context_proj (B, T, 4H) -> (B, T, 4Hp), padded per gate as
    pad_widths pads the gate rows (None stays None)."""
    if context_proj is None or H == Hp:
        return context_proj
    B, T, _ = context_proj.shape
    return _pad_cols(context_proj.reshape(B, T, 4, H), 0, H,
                     Hp).reshape(B, T, 4 * Hp)


def kernel_params(params):
    """pad_widths(widened(params))[0], kept per weight version where it
    pads (at H = 1022 it copies ~55 MB): the key is each weight tensor's
    identity (a weak reference, so a freed tensor whose id is reused cannot
    hit), its _version, which in-place updates advance, and its data
    pointer, as ops/mrf.py keeps its packs."""
    wide = widened(params)
    if resident_widths_ok(wide):
        return wide
    ts = _weights(params)
    if any(t.is_inference() for t in ts):    # no version counter
        return pad_widths(wide)[0]
    key = tuple(id(t) for t in ts)
    versions = tuple((t._version, t.data_ptr()) for t in ts)
    hit = _padded.get(key)
    if hit is not None and hit[1] == versions and all(
            ref() is t for ref, t in zip(hit[0], ts)):
        _padded.move_to_end(key)
        return hit[2]
    padded = pad_widths(wide)[0]
    _padded[key] = (tuple(weakref.ref(t) for t in ts), versions, padded)
    while len(_padded) > PADDED_CACHE_SIZE:
        _padded.popitem(last=False)
    return padded


def _max_rows(params):
    return max(units for units, _, _, _ in _segments(params))


def _split_blocks(params_list, total):
    """`total` blocks split between the problems by their weight bytes,
    each at least 1 and at most its widest segment's rows (so that every
    block owns rows of some phase)."""
    w = np.array([weight_bytes(p) for p in params_list], np.float64)
    n = np.maximum(1, np.floor(total * w / w.sum()).astype(int))
    while n.sum() < total:
        n[np.argmax(w / n)] += 1
    while n.sum() > total:
        n[np.argmax(n)] -= 1
    return [int(min(k, _max_rows(p))) for k, p in zip(n, params_list)]


def ar_scan_plan(params_list, B, sms, smem_cap=SMEM_CAP, blocks=None):
    """The launches that run these problems (each an AR step's
    scan_params, its widths padded by `pad_widths`; B an int or one per
    problem) on a card of `sms` SMs, a block at most `smem_cap` bytes of
    dynamic shared memory. Chosen by shape alone, each a cooperative
    launch of the resident kernel:
      1. all problems in one launch ("resident"), `blocks` (default `sms`)
         split between them by weight bytes, every weight in shared
         memory;
      2. else each problem in a launch of its own on every block, its
         weights in shared memory ("resident") or, where they do not fit,
         split ("split"): the rows that do not fit read from the blocks'
         overflow images in global memory every frame (problem_plan); where
         even a block's state does not fit
         (B = 32 at the published width), in launches over slices of its
         items (independent sequences), halved until one fits.
    Returns a list of {"route", "problems": [indices], "items": [(first,
    stop)] per problem, "plans", "blocks", "smem"} in the order they
    run, kept per shape (the same object for the same shapes: do not
    change it)."""
    n = len(params_list)
    Bs = [B] * n if isinstance(B, int) else list(B)
    key = (tuple(_signature(p) for p in params_list), tuple(Bs), sms,
           smem_cap, blocks)
    hit = _plans.get(key)
    if hit is not None:
        _plans.move_to_end(key)
        return hit
    launches = _plan(params_list, Bs, sms, smem_cap, blocks)
    _plans[key] = launches
    while len(_plans) > PLAN_CACHE_SIZE:
        _plans.popitem(last=False)
    return launches


def _plan(params_list, Bs, sms, smem_cap, blocks):
    """ar_scan_plan, uncached."""
    params_list = [pad_widths(p)[0] for p in params_list]
    n = len(params_list)
    total = blocks or sms
    if n > MAX_PROBLEMS:
        raise ValueError(f"ar_scan: {n} problems, at most {MAX_PROBLEMS} "
                         "a launch")

    def launch(idx, counts, items):
        plans = [problem_plan(params_list[i], hi - lo, k, smem_cap)
                 for i, k, (lo, hi) in zip(idx, counts, items)]
        return {"route": "split" if any(p["split"] for p in plans)
                else "resident", "problems": list(idx), "items": items,
                "plans": plans, "blocks": sum(counts),
                "smem": max(p["smem"] for p in plans)}

    if n > 1:
        try:
            one = launch(range(n), _split_blocks(params_list, total),
                         [(0, b) for b in Bs])
        except ValueError:
            one = None
        if one is not None and one["route"] == "resident":
            return [one]
    launches = []
    for i, p in enumerate(params_list):
        counts, chunk = [min(total, _max_rows(p))], Bs[i]
        while True:
            try:
                launch([i], counts, [(0, chunk)])
                break
            except ValueError:
                if chunk == 1:
                    raise
                chunk = (chunk + 1) // 2
        launches += [launch([i], counts, [(lo, min(lo + chunk, Bs[i]))])
                     for lo in range(0, Bs[i], chunk)]
    return launches


def _mats(params):
    """The matrices the weight images gather from, in _segments' order,
    after the common part (W_ih_attr, the attribute bias)."""
    w_ih_a, w_hh_a, b_a = params["attr"]
    mats = [w_ih_a, _bias(b_a), w_hh_a]
    biases = [None]
    for w_ih, w_hh, b in params["lstm"]:
        mats.append(torch.cat([w_ih, w_hh], dim=1))
        biases.append(_bias(b))
    for w, b, _ in params["head"]:
        mats.append(w)
        biases.append(b)
    return mats, biases


def image_index(plan):
    """(resident, overflow): (blocks, img_stride) and (blocks, ovf_stride)
    int64 indices into the flat concatenation of _mats (weights, then the
    biases of the biased segments, then one zero): each block's
    shared-memory image and its overflow image. Depends on shapes alone."""
    segs, table, H = plan["segments"], plan["table"], plan["H"]
    C = plan["C"]
    sizes = [4 * H * C, 4 * H] + [u * r * K for u, r, K, _ in segs]
    bias_sizes = [u * r for u, r, _, b in segs if b]
    base = np.concatenate([[0], np.cumsum(sizes + bias_sizes)])
    zero = int(base[-1])
    bias_base = iter(base[len(sizes):])
    bias_at = [next(bias_base) if b else None for _, _, _, b in segs]
    off_img = plan["offsets"]["img"]
    idx = np.full((plan["blocks"], plan["img_stride"]), zero, np.int64)
    ovf = np.full((plan["blocks"], plan["ovf_stride"]), zero, np.int64)

    def rows_of(s, units, first, n):
        """The source indices of units [first, first + n) of segment s, as
        (rows, K)."""
        u = first + np.arange(n)
        if segs[s][1] == 4:     # unit u's gate rows q * H + u, q = 0..3
            src = (np.arange(4)[None, :] * units + u[:, None]).reshape(-1)
        else:
            src = u
        K = segs[s][2]
        return src, base[2 + s] + src[:, None] * K + np.arange(K)

    for i in range(plan["blocks"]):
        row = idx[i]
        row[:4 * H * C] = np.arange(4 * H * C)
        o = int(table[i, 0, 3]) - off_img
        row[o:o + 4 * H] = base[1] + np.arange(4 * H)
        for s, (units, rows, K, biased) in enumerate(segs):
            start, count, w_off, b_off, n_res, ovf_off = (
                int(v) for v in table[i, s + 1, :6])
            if count == 0:
                continue
            ld = _pad4(K)
            src, w = rows_of(s, units, start, n_res)
            o = w_off - off_img
            row[o:o + len(src) * ld].reshape(len(src), ld)[:, :K] = w
            src_o, w = rows_of(s, units, start + n_res, count - n_res)
            ovf[i, ovf_off:ovf_off + len(src_o) * ld].reshape(
                len(src_o), ld)[:, :K] = w
            if biased:
                src, _ = rows_of(s, units, start, count)
                o = b_off - off_img
                row[o:o + len(src)] = bias_at[s] + src
    return idx, ovf


def _signature(params):
    return (tuple(params["attr"][0].shape), tuple(params["attr"][1].shape),
            tuple((tuple(w_ih.shape), b is None)
                  for w_ih, _, b in params["lstm"]),
            tuple(tuple(w.shape) for w, _, _ in params["head"]))


def _on_device(plan, device):
    """(resident index, overflow index, table) of `plan` on `device`: the
    gather's int32 indices (image_index) and the slice table, made once per
    plan and device (plans depend on shapes alone and are cached by
    them)."""
    cache = plan.setdefault("on_device", {})
    hit = cache.get(str(device))
    if hit is None:
        hit = tuple(torch.from_numpy(a).to(device) for a in (
            *(i.astype(np.int32) for i in image_index(plan)), plan["table"]))
        cache[str(device)] = hit
    return hit


def resident_pack(params, plan, device):
    """The blocks' weight images, (blocks, img_stride), and their overflow
    images, (blocks, ovf_stride) (0 wide unless the plan splits), fp32 on
    `device`, gathered anew from the weights at every launch (the gather's
    indices depend on shapes alone and are kept with the plan)."""
    img_idx, ovf_idx, _ = _on_device(plan, device)
    mats, biases = _mats(params)
    flat = torch.cat([m.detach().float().reshape(-1) for m in mats]
                     + [b.detach().float().reshape(-1) for b in biases
                        if b is not None]
                     + [mats[0].new_zeros(1)])
    return tuple(flat.index_select(0, i.reshape(-1)).reshape(i.shape)
                 for i in (img_idx, ovf_idx))


def resident_config(params, plan, T, block0):
    """(icfg, fcfg, head act offsets, act floats) of one problem as
    csrc/ar_scan.cu's radtts_ar_scan_resident reads them."""
    head = params["head"]
    off = plan["offsets"]
    B = plan["B"]
    pad = [0] * (MAX_HEAD - len(head))
    act_off, n_act = [], 0
    for w, _, _ in head:
        act_off.append(n_act)
        n_act += 2 * B * w.shape[0]
    icfg = [B, T, plan["C"], plan["H"], plan["L"], KINDS[params["kind"]],
            SCALINGS.get(params.get("scaling_fn"), 0),
            params.get("n_bins") or 0, len(head), block0, plan["blocks"],
            plan["img_stride"], off["hs"], off["cattr"], off["cown"],
            off["xs"], off["qs"], off["prev"], off["ctx"], off["res"],
            off["img"], plan["cmax"], plan["ovf_stride"]]
    assert len(icfg) == RES_SCALARS
    icfg += [0] + plan["ld"] + [0] * (MAX_SEGS - 1 - len(plan["ld"]))
    icfg += [w.shape[1] for w, _, _ in head] + pad
    icfg += [w.shape[0] for w, _, _ in head] + pad
    icfg += _act_codes(params) + pad
    icfg += act_off + pad
    icfg += plan["producers"] + [0] * (MAX_PHASES - len(plan["producers"]))
    assert len(icfg) == RES_INTS
    fcfg = list(params.get("bounds") or (0.0, 0.0, 0.0, 1.0))
    return icfg, fcfg, n_act


def trace_buffer(device):
    """A zeroed trace for ar_scan_multi(..., trace=): (frames, stamps)
    int64, block 0's %globaltimer (ns) at each phase boundary of the first
    frames (csrc/ar_scan.cu kTraceFrames, kStamps)."""
    if _lib is None:
        build()
    return torch.zeros(_lib.radtts_ar_scan_trace_frames(),
                       _lib.radtts_ar_scan_trace_stamps(),
                       dtype=torch.int64, device=device)


def _launch_resident(launch, problems, trace=None):
    """One cooperative launch of the resident kernel over `problems`
    (params, residual, context_proj; widths padded) as `launch` plans them;
    `trace` from trace_buffer, or None."""
    dev = problems[0][1].device
    icfg, fcfg, ptrs, keep, outs = [], [], [], [], []
    block0 = 0
    for (params, res, cproj), plan in zip(problems, launch["plans"]):
        B, T, C = res.shape
        H, L = plan["H"], plan["L"]
        ic, fc, n_act = resident_config(params, plan, T, block0)
        block0 += plan["blocks"]
        res, cproj = res.contiguous(), cproj.contiguous()
        out = torch.empty_like(res)
        img, ovf = resident_pack(params, plan, dev)
        tensors = [res, cproj, out, img, ovf, _on_device(plan, dev)[2],
                   torch.empty(L * 2 * B * H, device=dev),
                   torch.empty(2 * B * 4 * H, device=dev),
                   torch.empty(n_act, device=dev),
                   torch.zeros(L + len(params["head"]), dtype=torch.int32,
                               device=dev)]
        icfg += ic
        fcfg += fc
        ptrs += [t.data_ptr() if t.numel() else None for t in tensors]
        keep += tensors
        outs.append(out)
    icfg_c = (ctypes.c_int * len(icfg))(*icfg)
    fcfg_c = (ctypes.c_float * len(fcfg))(*fcfg)
    ptrs_c = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(dev):
        err = _lib.radtts_ar_scan_resident(
            ctypes.addressof(icfg_c), ctypes.addressof(fcfg_c),
            ctypes.addressof(ptrs_c), len(problems), launch["blocks"],
            launch["smem"], item_group(max(p["B"] for p in launch["plans"])),
            None if trace is None else trace.data_ptr(), 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ar_scan: resident kernel launch failed with cudaError {err} "
            f"({len(problems)} problems, blocks={launch['blocks']}, "
            f"smem={launch['smem']}, route={launch['route']})")
    ar_scan.launches += 1
    return outs


def _flop_records(problems, *args, **kwargs):
    """ar_scan_multi's products for ops/flops.py, as ar_scan_plain makes
    them: a frame's attribute LSTM, stacked layers (without layer 0's
    context half, a matmul before the scan) and head, T frames."""
    out = []
    for params, res, _ in problems:
        B, T, _ = res.shape
        w_ih_a, w_hh_a, _ = params["attr"]
        mats = [w_ih_a, w_hh_a]
        for w_ih, w_hh, _ in params["lstm"]:
            mats += [w_ih, w_hh]
        mats += [w for w, _, _ in params["head"]]
        out += [flops.record("dot", 1, B, w.shape[0], w.shape[1], trips=T,
                             nbytes=4 * (w.numel() + B * sum(w.shape)))
                for w in mats]
    return out


@flops.counted(_flop_records)
def ar_scan_multi(problems, blocks=None, trace=None):
    """Each problem (params, residual, context_proj) -> its inverse over
    every frame, as ar_scan. A CPU tensor runs ar_scan_plain on each; CUDA
    tensors run the launches ar_scan_plan names (`blocks`: its block
    count), or raise: no failure falls back to another route. `trace`
    (trace_buffer) records the first resident launch's block 0."""
    given = [params for params, _, _ in problems]
    problems = [(widened(params), res, cproj)
                for params, res, cproj in problems]
    dev = problems[0][1].device
    if dev.type == "cpu":
        return [_checked(params, ar_scan_plain(params, res, cproj))
                for params, res, cproj in problems]
    if dev.type != "cuda":
        raise ValueError(f"ar_scan: unsupported device {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for params, res, cproj in problems
            for t in [res, cproj] + _weights(params)):
        raise RuntimeError("ar_scan: the CUDA kernel has no backward, and "
                           "its output would carry no gradient; run it "
                           "under torch.no_grad()")
    for params, res, cproj in problems:
        if res.device != dev:
            raise ValueError("ar_scan: problems on different devices")
        _check_inputs(params, res, cproj)
    padded = []
    for p, (params, res, cproj) in zip(given, problems):
        H = params["attr"][1].shape[1]
        padded.append((kernel_params(p), res,
                       _pad_context(cproj, H, _pad4(H))))
    problems = padded
    outs = [res.new_zeros(res.shape) for _, res, _ in problems]
    live = [i for i, (_, res, _) in enumerate(problems)
            if res.shape[0] and res.shape[1]]
    if not live:
        return outs
    if _lib is None:
        build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ar_scan_plan([problems[i][0] for i in live],
                        [problems[i][1].shape[0] for i in live], sms,
                        blocks=blocks)
    for launch in plan:
        idx = [live[k] for k in launch["problems"]]
        items = launch["items"]
        for i, (lo, hi), o in zip(idx, items, _launch_resident(
                launch, [(problems[i][0], problems[i][1][lo:hi],
                          problems[i][2][lo:hi])
                         for i, (lo, hi) in zip(idx, items)], trace)):
            outs[i][lo:hi] = o
        trace = None
    return [_checked(params, o) for (params, _, _), o in zip(problems, outs)]


def widened(params):
    """params with every bf16-stored weight (ops/fold_norms.py:
    store_conv_weights casts the spline head's and the affine head's
    convs) widened to fp32 (exact), the fp32 ones as they are, and
    "head_bf16": for each head layer, whether its kernel was bf16. The
    scans round such a layer's input activations to bf16 (to nearest
    even) and sum the products in fp32, as the JAX package's conv1d_apply
    does with a bf16 kernel and an fp32 input (radtts_tpu/ops/conv.py:
    _raw_conv). Applying it twice changes nothing."""
    def w(t):
        return t if t is None or t.dtype == torch.float32 else t.float()

    out = dict(params)
    if "head_bf16" not in params:
        out["head_bf16"] = [a.dtype == torch.bfloat16
                            for a, _, _ in params["head"]]
    out["attr"] = (w(params["attr"][0]), w(params["attr"][1]),
                   params["attr"][2])
    out["lstm"] = [(w(a), w(b), c) for a, b, c in params["lstm"]]
    out["head"] = [(w(a), w(b), act) for a, b, act in params["head"]]
    return out


# the debug sentinel's name for the spline inverse the scan runs in its
# head (csrc/ar_scan.cu runs it inside the launch): its output is checked
_SENTINELS = {"quadratic": "piecewise_quadratic bin input",
              "linear": "piecewise_linear_inverse bin input"}


def _checked(params, out):
    name = _SENTINELS.get(params["kind"])
    return out if name is None else check_finite(out, name)


def ar_scan(params, residual, context_proj):
    """One AR step's inverse over every frame. A CPU tensor runs
    ar_scan_plain; a CUDA tensor launches csrc/ar_scan.cu (the route
    ar_scan_plan names), or raises. The kernels have no backward: with grad
    enabled and an input or a weight requiring grad it raises."""
    return ar_scan_multi([(params, residual, context_proj)])[0]


ar_scan.launches = 0           # the resident kernel's launches
ar_scan.barrier_launches = 0   # the barrier kernel's


def handoff_probe(n_phases, T, mode, blocks, smem, device):
    """One launch of csrc/ar_scan.cu's handoff_probe_kernel: `blocks`
    blocks with `smem` bytes each run T x n_phases empty phases joined by
    the resident kernel's handoff (mode "handoff") or the barrier kernel's
    grid barrier (mode "barrier")."""
    if _lib is None:
        build()
    counters = torch.zeros(2 + n_phases, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = _lib.radtts_handoff_probe(
            counters.data_ptr(), n_phases, T,
            {"handoff": 0, "barrier": 1}[mode], blocks, smem,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"handoff_probe: launch failed with cudaError "
                           f"{err}")
    return counters


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
