"""HiFi-GAN multi-receptive-field (MRF) resblock stack of one upsample stage:

    mean_k RB_k(x),
    RB_k(x): 3x [x += conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))], d in (1, 3, 5),

lrelu slope 0.1, every conv zero-padded at 0 and T.

Port of the TPU kernels in radtts_tpu/ops/pallas_mrf.py (pallas_mrf,
pallas_mrf_wide, pallas_mrf_folded: one function at every width). On the
card `mrf` runs one of three hand-written kernels, by `mrf_route` (see
their headers for the design and what bounds them):
  "tc"    csrc/mrf_tc.cu, a 3xTF32 implicit GEMM on the tensor cores, 18
          launches per stage, at every width but the stack's (every
          HiFi-GAN v1 stage), counted by mrf.tc_launches;
  "tf32"  csrc/mrf_tf32.cu, the same widths in one TF32 pass, at
          --matmul_precision default (ops/precision.py), counted by
          mrf.tf32_launches. csrc/mrf_tc.cu's own one-pass build, which it
          replaced (chip_smoke.py's mrf_tf32_vs_plain; PERF.md), runs only
          when asked for by name (mrf_cuda(..., route="tc", passes=1)),
          counted by mrf.tc1_launches;
  "stack" csrc/mrf_stack.cu, the whole stack in one launch with every
          intermediate in shared memory, fp32 FMA, at C <= 16 with at most
          4 resblocks (HiFi-GAN V2's C=16 and C=8 stages), counted by
          mrf.stack_launches.
The tensor-core kernels run a width that is not one of their tile widths
padded to `padded_width(C)` (C=24: 32, C=48: 64, C=96 as it is, C=160:
192), the packed taps and biases zero-padded (`stage_pack`,
`tf32_stage_pack`, `bias_pack`): the padded channels are exactly zero in
every product, and the kernels load and store only the C real channels.
csrc/mrf.cu, one fp32-FMA conv per launch, which took those widths before,
runs only when asked for by name (mrf_cuda(..., route="conv"), counted by
mrf.launches), as their "before" on the card.
`mrf_plain` is the same function in plain PyTorch, which the CPU path,
the tests and every pass that needs gradients use (at every precision:
the CPU computes fp32); `mrf_plain(..., passes=1)` is the one-pass
kernels' plain version.

weights: one dict per resblock, {w1: (3, k, C, C), b1: (3, C), w2: (3, k, C,
C), b2: (3, C)}, w*[i] being the dilation-i conv taps-major (k, C_in, C_out)
as in the JAX package's packed layout.
"""

import collections
import ctypes
import functools
import weakref

import torch
import torch.nn.functional as F

from radtts_tpu_torch.ops import flops, precision
from radtts_tpu_torch.ops.cuda_build import build_library

KERNEL_SIZES = (3, 7, 11)   # the standard MRF (JAX ops/pallas_mrf.py)
DILATIONS = (1, 3, 5)
LRELU_SLOPE = 0.1

TC_CK = 32            # input channels per chunk of csrc/mrf_tc.cu and
#                       csrc/mrf_tf32.cu (kCK)
TF32_MAX_HALO = 50    # csrc/mrf_tf32.cu's kMaxHalo: (k - 1) * d at most
PACK_CACHE_SIZE = 8   # packed stages kept (HiFi-GAN v1 has 4)
STACK_MAX_TILE = 400  # rows per block of csrc/mrf_stack.cu (see stack_tile)
STACK_WIDTHS = (4, 8, 12, 16)
STACK_MAX_RESBLOCKS = 4

_lib = None
_tc_libs = {}         # csrc/mrf_tc.cu by TF32 passes: 3, or 1 (one-pass)
_TC_COUNTS = {3: "tc_launches", 1: "tc1_launches"}   # mrf's count of each
_tf32_lib = None
_stack_lib = None
_packs = collections.OrderedDict()


def _conv_plain(x, w_taps, b, d, passes=3):
    """x (B, C, T); w_taps (k, C_in, C_out) -> same-padded conv; with
    passes=1 both operands rounded to TF32 first (tf32_round)."""
    k = w_taps.shape[0]
    if passes == 1:
        x, w_taps = tf32_round(x), tf32_round(w_taps)
    return F.conv1d(x, w_taps.permute(2, 1, 0), b, padding=(k - 1) // 2 * d,
                    dilation=d)


def mrf_plain(x, weights, passes=3):
    """Plain PyTorch MRF mean, as the JAX package's _resblock1_apply runs
    it: one F.conv1d per conv. x: (B, T, C) -> (B, T, C). passes=1: each
    conv's activations (after the leaky ReLU) and taps rounded to TF32,
    the products summed in fp32, as the one-pass kernels compute it."""
    if passes not in (1, 3):
        raise ValueError(f"mrf_plain: passes={passes}, expected 1 or 3")
    xc = x.transpose(1, 2)
    out = torch.zeros_like(xc)
    for wd in weights:
        xr = xc
        for i, d in enumerate(DILATIONS):
            xt = _conv_plain(F.leaky_relu(xr, LRELU_SLOPE), wd["w1"][i],
                             wd["b1"][i], d, passes)
            xt = _conv_plain(F.leaky_relu(xt, LRELU_SLOPE), wd["w2"][i],
                             wd["b2"][i], 1, passes)
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


def build_tc(passes=3):
    """Compile csrc/mrf_tc.cu (passes=3) or its one-pass build (passes=1,
    -DMRF_TC_PASSES=1) and load it. Returns (library, nvcc output, build
    seconds)."""
    if passes not in _TC_COUNTS:
        raise ValueError(f"mrf_tc: passes={passes}, expected 1 or 3")
    lib, log, seconds = build_library(
        "mrf_tc", () if passes == 3 else ("MRF_TC_PASSES=1",))
    fn = lib.radtts_mrf_tc_conv
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name, n_args in (("radtts_mrf_tc_smem_bytes", 3),
                         ("radtts_mrf_tc_weight_stages", 2)):
        getattr(lib, name).argtypes = [ctypes.c_int] * n_args
        getattr(lib, name).restype = ctypes.c_int
    _tc_libs[passes] = lib
    return lib, log, seconds


def build_tf32():
    """Compile csrc/mrf_tf32.cu and load it. Returns (library, nvcc output,
    build seconds)."""
    global _tf32_lib
    lib, log, seconds = build_library("mrf_tf32")
    fn = lib.radtts_mrf_tf32_conv
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name in ("radtts_mrf_tf32_smem_bytes",
                 "radtts_mrf_tf32_weight_stages"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 2
        getattr(lib, name).restype = ctypes.c_int
    _tf32_lib = lib
    return lib, log, seconds


def build_stack():
    """Compile csrc/mrf_stack.cu and load it. Returns (library, nvcc
    output, build seconds)."""
    global _stack_lib
    lib, log, seconds = build_library("mrf_stack")
    fn = lib.radtts_mrf_stack
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.radtts_mrf_stack_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.radtts_mrf_stack_smem_bytes.restype = ctypes.c_int
    _stack_lib = lib
    return lib, log, seconds


def mrf_route(C, n_resblocks=3, passes=3):
    """The routing rule, the kernel a stage of width C (a multiple of 4)
    with n_resblocks resblocks runs on the card with `passes` TF32 passes:
    "stack" (csrc/mrf_stack.cu, fp32 FMA at either passes) at C=4, 8, 12,
    16 with at most STACK_MAX_RESBLOCKS resblocks; else "tc"
    (csrc/mrf_tc.cu, 3xTF32) or, at passes=1, "tf32" (csrc/mrf_tf32.cu),
    at padded_width(C). No width routes to csrc/mrf.cu."""
    if C in STACK_WIDTHS and n_resblocks <= STACK_MAX_RESBLOCKS:
        return "stack"
    return "tf32" if passes == 1 else "tc"


def padded_width(C):
    """The width the tensor-core kernels run a stage of width C at: the
    next multiple of 32 up to 64 (C=24: 32, C=48: 64), 96 from 68 to 96
    (the narrow kernel's widest tile), 128 from 100 to 128, the next
    multiple of 64 above (C=160: 192, C=224: 256). Every v1 width is its
    own."""
    if C <= 64:
        return -(-C // 32) * 32
    if C <= 128:
        return 96 if C <= 96 else 128
    return -(-C // 64) * 64


def stack_tile(T, B=1, sms=None, max_rows=STACK_MAX_TILE):
    """Rows per block of csrc/mrf_stack.cu: the fewest tiles of at most
    max_rows rows, evened out (T=997: 3 tiles of 333); where the B * tiles
    blocks fill the card's sms SMs at least once, as many more as make
    their count a multiple of sms, so every SM gets as many blocks (on 132
    SMs: T=77824, 264 tiles of 295, two blocks per SM, where 195 of 400
    left 69 SMs one block; T=155648, 396 of 394). Each block also
    computes a 6 (k_max - 1)-row halo a side; its 256 threads cover 512
    rows per pass, so a tile of 400 plus the first conv's region (tile +
    110 rows at k=11) takes one pass. chip_smoke.py's tile sweep measures
    the choice."""
    n = -(-T // max_rows)
    if sms and B * n >= sms:
        waves = -(-B * n // sms)
        n = -(-waves * sms // B)
    return -(-T // n)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def tc_tile(C):
    """(TN, NWG) of csrc/mrf_tc.cu for width C (run at CP =
    padded_width(C)): TN output channels and NWG consumer warpgroups (64
    NWG time rows) per tile. The fastest on the H100 (chip_smoke.py's
    mrf_tc_tiles phase): 128 x 128 tiles at C=256 (each weight stage feeds
    128 rows; 76 blocks at 4864 frames beat 152 smaller ones), 128 x 64 at
    C=128, and TN = CP at CP=64 and CP=32 (the narrow kernel: every output
    channel in one tile); at CP=96 the narrow kernel with one warpgroup,
    the only one whose planes fit."""
    cp = padded_width(C)
    if cp <= 64:
        return (cp, 2)
    if cp == 96:
        return (96, 1)
    return (128, 2) if cp >= 256 and cp % 128 == 0 else (64, 2)


def tc_grid(B, T, C, tile=None):
    """The tiles of csrc/mrf_tc.cu: (time tiles, C_out tiles, B), over
    padded_width(C) channels. Past 96 this is the launch grid; up to 96 the
    narrow kernel walks these tiles with min(tiles, SMs) persistent
    blocks."""
    tn, nwg = tile or tc_tile(C)
    return (-(-T // (64 * nwg)), padded_width(C) // tn, B)


def tf32_tile(C):
    """(TN, NWG) of csrc/mrf_tf32.cu for width C (run at CP =
    padded_width(C)): TN output channels and NWG consumer warpgroups (64
    NWG time rows) per tile. The fastest on the H100 (chip_smoke.py's
    mrf_tf32_tiles): 128 x 128 tiles at C=256 and C=128 (every multiple of
    128), TN = CP with two warpgroups at CP=96, 64 and 32 (one tile reads
    the plane for every output channel), and 64 at the other multiples of
    64 (CP=192), which 128 does not divide."""
    cp = padded_width(C)
    if cp % 128 == 0:
        return (128, 2)
    return (cp, 2) if cp <= 96 else (64, 2)


def tf32_plane_rows(nwg):
    """Rows of csrc/mrf_tf32.cu's activation plane (kR): the tile's 64 nwg
    rows, the largest halo and one more, so the count is odd."""
    return 64 * nwg + TF32_MAX_HALO + 1


def tf32_round(x):
    """Round float32 to TF32 as cvt.rna.tf32.f32 does (to nearest, ties
    away from zero; the 13 low mantissa bits zero), for finite x."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tc_split(w):
    """w (..., C_in, C_out) -> its K-major planes (hi, lo), each (...,
    C_out, C_in) (views): hi = tf32(w), lo = tf32(w - hi), so hi + lo is
    w within 2^-22 relative."""
    hi = tf32_round(w)
    return hi.transpose(-1, -2), tf32_round(w - hi).transpose(-1, -2)


def tc_pack(w, tn):
    """Taps w (..., C_in, C_out) -> the order in which csrc/mrf_tc.cu
    streams them: (..., C/tn, C/TC_CK, 2, TC_CK/4, tn/8, 8, 4). Per (tap,
    C_out tile, C_in chunk) one contiguous block of the hi and lo planes,
    each in wgmma's core-matrix layout: element (co, ci) of the tile at
    ((ci // 4) * tn / 8 + co // 8) * 32 + (co % 8) * 4 + ci % 4."""
    p = torch.stack(tc_split(w), -3)             # (..., 2, C_out, C_in)
    *lead, _, C, _ = p.shape
    n = len(lead)
    p = p.reshape(*lead, 2, C // tn, tn // 8, 8, C // TC_CK, TC_CK // 4, 4)
    order = [n + 1, n + 4, n, n + 5, n + 2, n + 3, n + 6]
    return p.permute(*range(n), *order).contiguous()


def tc_pack_narrow(w):
    """Taps w (..., C, C) -> the order in which the narrow kernel of
    csrc/mrf_tc.cu (C=64 and C=32, the tile holding every output channel)
    reads them: (..., C/TC_CK, TC_CK/4, 2, C/8, 8, 4). Per (tap, C_in
    chunk) one K-major operand of 2C rows, hi in rows [0, C) and lo in [C,
    2C), in wgmma's core-matrix layout: element (co, ci) of plane p at
    ((ci // 4) * C / 4 + (p * C + co) // 8) * 32 + (co % 8) * 4 + ci % 4,
    ci counted within the chunk."""
    p = torch.stack(tc_split(w), -3)             # (..., 2, C_out, C_in)
    *lead, _, C, _ = p.shape
    n = len(lead)
    p = p.reshape(*lead, 2, C // 8, 8, C // TC_CK, TC_CK // 4, 4)
    order = [n + 3, n + 4, n, n + 1, n + 2, n + 5]
    return p.permute(*range(n), *order).contiguous()


def tf32_pack(w, tn):
    """Taps w (..., C_in, C_out) -> the order in which csrc/mrf_tf32.cu
    streams them: (..., C/tn, C/TC_CK, TC_CK/4, tn/8, 8, 4), tf32_round(w)
    alone. Per (tap, C_out tile, C_in chunk) one K-major unit of tn x
    TC_CK in wgmma's core-matrix layout: element (co, ci) of the unit at
    ((ci // 4) * tn / 8 + co // 8) * 32 + (co % 8) * 4 + ci % 4, co and ci
    counted within the tile and the chunk."""
    p = tf32_round(w).transpose(-1, -2)          # (..., C_out, C_in)
    *lead, C, _ = p.shape
    n = len(lead)
    p = p.reshape(*lead, C // tn, tn // 8, 8, C // TC_CK, TC_CK // 4, 4)
    order = [n, n + 3, n + 4, n + 1, n + 2, n + 5]
    return p.permute(*range(n), *order).contiguous()


def narrow(C, tn):
    """Whether tile width tn at width C runs the narrow kernel."""
    cp = padded_width(C)
    return tn == cp and cp in (32, 64, 96)


def _padded_taps(ts, cp):
    """The taps of ts (each (..., C, C)) as one (n, cp, cp) tensor, zero in
    the padded rows and columns."""
    C = ts[0].shape[-1]
    taps = torch.cat([t.reshape(-1, C, C) for t in ts])
    return F.pad(taps, (0, cp - C, 0, cp - C)) if cp != C else taps


def _cached_pack(ts, tag, pack, cache=_packs, size=PACK_CACHE_SIZE):
    """pack() of the weight tensors ts, kept per weight version in `cache`
    (at most `size` entries; ops/lstm.py keeps its own): the key is
    each tensor's identity (a weak reference, so a freed tensor whose id is
    reused cannot hit), its _version, which in-place updates (the
    optimizer's step, load_state_dict) advance, and its data pointer,
    which Module.to() and a `.data` assignment change without a new
    version. Serving packs once; training repacks after every update and
    is never stale."""
    if any(t.is_inference() for t in ts):    # no version counter
        return pack()
    key = (tuple(id(t) for t in ts), tag)
    versions = tuple((t._version, t.data_ptr()) for t in ts)
    hit = cache.get(key)
    if hit is not None and hit[1] == versions and all(
            ref() is t for ref, t in zip(hit[0], ts)):
        cache.move_to_end(key)
        return hit[2]
    packed = pack()
    cache[key] = (tuple(weakref.ref(t) for t in ts), versions, packed)
    cache.move_to_end(key)
    while len(cache) > size:
        cache.popitem(last=False)
    return packed


def stage_pack(weights, tn):
    """The packed taps of a stage for csrc/mrf_tc.cu (w1 then w2 of each
    resblock, zero-padded to padded_width(C); tc_pack, or tc_pack_narrow
    where narrow(C, tn)), kept per weight version (_cached_pack)."""
    ts = [wd[key] for wd in weights for key in ("w1", "w2")]
    C = ts[0].shape[-1]

    def pack():
        with torch.no_grad():
            taps = _padded_taps(ts, padded_width(C))
            return (tc_pack_narrow(taps) if narrow(C, tn)
                    else tc_pack(taps, tn))
    return _cached_pack(ts, tn, pack)


def tf32_stage_pack(weights, tn):
    """The packed taps of a stage for csrc/mrf_tf32.cu (w1 then w2 of each
    resblock, zero-padded to padded_width(C), tf32_pack), kept per weight
    version (_cached_pack)."""
    ts = [wd[key] for wd in weights for key in ("w1", "w2")]
    C = ts[0].shape[-1]

    def pack():
        with torch.no_grad():
            return tf32_pack(_padded_taps(ts, padded_width(C)), tn)
    return _cached_pack(ts, ("tf32", tn), pack)


def bias_pack(weights):
    """A stage's biases for the tensor-core kernels: per resblock {b1, b2}
    (3, padded_width(C)), zero past C; the weights' own tensors where C is
    its own padded width, else kept per weight version (_cached_pack)."""
    ts = [wd[key] for wd in weights for key in ("b1", "b2")]
    C = ts[0].shape[-1]
    cp = padded_width(C)
    if cp == C:
        return [{"b1": wd["b1"], "b2": wd["b2"]} for wd in weights]

    def pack():
        with torch.no_grad():
            return [{key: F.pad(wd[key], (0, cp - C)).contiguous()
                     for key in ("b1", "b2")} for wd in weights]
    return _cached_pack(ts, "bias", pack)


def stack_pack(weights):
    """A stage's weights in the order csrc/mrf_stack.cu streams them, one
    conv after another: per resblock and dilation i, w1[i] (k, C, C),
    b1[i] (C), w2[i] (k, C, C), b2[i] (C), flat; kept per weight version
    (_cached_pack)."""
    ts = [wd[key] for wd in weights for key in ("w1", "b1", "w2", "b2")]

    def pack():
        with torch.no_grad():
            return torch.cat([wd[key][i].reshape(-1) for wd in weights
                              for i in range(len(DILATIONS))
                              for key in ("w1", "b1", "w2", "b2")])
    return _cached_pack(ts, "stack", pack)


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


def _raise(err, x, k, d):
    B, T, C = x.shape
    raise RuntimeError(f"mrf: kernel launch failed with cudaError {err} "
                       f"(B={B}, T={T}, C={C}, k={k}, d={d})")


def _conv_launch(x, w, b, d, res, out, acc, acc_scale):
    B, T, C = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib.radtts_mrf_conv(
            _ptr(x), _ptr(w), _ptr(b), _ptr(res), _ptr(out), _ptr(acc),
            acc_scale, B, T, C, w.shape[0], d, LRELU_SLOPE, stream)
    if err != 0:
        _raise(err, x, w.shape[0], d)
    mrf.launches += 1


def _stack_launch(x, packed, ks, out, tile):
    B, T, C = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    k_args = list(ks) + [0] * (STACK_MAX_RESBLOCKS - len(ks))
    with torch.cuda.device(x.device):
        err = _stack_lib.radtts_mrf_stack(
            _ptr(x), _ptr(packed), _ptr(out), B, T, C, tile, *k_args,
            len(ks), LRELU_SLOPE, stream)
    if err != 0:
        _raise(err, x, max(ks), DILATIONS)
    mrf.stack_launches += 1


def _flop_records(x, weights):
    """mrf's products for ops/flops.py: its plain version's convs, two a
    dilation and resblock."""
    B, T, C = x.shape
    return [flops.conv_record((B, C, T), (C, C, wd[key].shape[1]), False, 1,
                              4 * (2 * B * T * C + wd[key][i].numel()))
            for wd in weights for i in range(len(DILATIONS))
            for key in ("w1", "w2")]


@flops.counted(_flop_records)
def mrf(x, weights):
    """MRF mean of one stage. x: (B, T, C) float32 -> (B, T, C).

    A CPU tensor runs mrf_plain. A CUDA tensor runs the hand-written
    kernel that mrf_route names at the current matmul precision's passes
    (ops/precision.py: one pass at "default"), or raises. The kernels
    have no backward: with grad enabled and x or a weight requiring grad
    it raises, since its output would carry no gradient; differentiate
    mrf_plain."""
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
    return mrf_cuda(x, weights, passes=precision.mrf_passes())


def mrf_cuda(x, weights, tile=None, route=None, passes=3):
    """The card's kernels of mrf at `passes` TF32 passes (3 or 1); `route`
    ("tc", "tf32", "stack" or "conv") overrides mrf_route, to time one
    kernel against another on the same inputs, and `tile` overrides
    tc_tile(C) or tf32_tile(C) ((TN, NWG), routes "tc" and "tf32") or
    stack_tile(T) (rows, route "stack"). Route "tc" at passes=1 is
    csrc/mrf_tc.cu's one-pass build, which "tf32" replaced; "tf32" takes
    passes=1 only; "conv" (csrc/mrf.cu, which no width routes to) and
    "stack" are fp32 FMA at either."""
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
    if passes not in _TC_COUNTS:
        raise ValueError(f"mrf: passes={passes}, expected 1 or 3")
    route = mrf_route(C, len(weights), passes) if route is None else route
    if route not in ("tc", "tf32", "stack", "conv"):
        raise ValueError(f"mrf: unknown route {route!r}")

    if route == "stack":
        if C not in STACK_WIDTHS or len(weights) > STACK_MAX_RESBLOCKS:
            raise ValueError(f"mrf: the stack kernel takes C in "
                             f"{STACK_WIDTHS} and at most "
                             f"{STACK_MAX_RESBLOCKS} resblocks, got C={C}, "
                             f"{len(weights)}")
        if _stack_lib is None:
            build_stack()
        out = torch.empty_like(x)
        _stack_launch(x, stack_pack(weights),
                      [wd["w1"].shape[1] for wd in weights], out,
                      tile or stack_tile(T, B, _sm_count(x.device)))
        return out
    if route == "tf32":
        if passes != 1:
            raise ValueError(f"mrf: the one-pass TF32 kernel takes passes=1, "
                             f"got passes={passes}")
        if _tf32_lib is None:
            build_tf32()
        fn, count = _tf32_lib.radtts_mrf_tf32_conv, "tf32_launches"
        tile = tile or tf32_tile(C)
        packed = tf32_stage_pack(weights, tile[0])
    elif route == "tc":
        if passes not in _tc_libs:
            build_tc(passes)
        fn, count = _tc_libs[passes].radtts_mrf_tc_conv, _TC_COUNTS[passes]
        tile = tile or tc_tile(C)
        packed = stage_pack(weights, tile[0])
    if route in ("tc", "tf32"):
        # one conv on a tensor-core kernel: fn, csrc/mrf_tc.cu's or
        # csrc/mrf_tf32.cu's entry (the same arguments), at the padded
        # width, counted in mrf.<count>; the taps' and biases' addresses
        # by offset (a launch on a kernel this fast is near the host's
        # rate, so it makes no tensor views)
        first, n = {}, 0    # each conv's first tap in the packed stage
        for m, wd in enumerate(weights):
            for key in ("w1", "w2"):
                first[m, key] = n
                n += wd[key].shape[0] * wd[key].shape[1]
        biases = bias_pack(weights)
        cp = padded_width(C)
        taps, tap_bytes = packed.data_ptr(), 4 * packed.stride(0)
        stream = torch.cuda.current_stream(x.device).cuda_stream

        def conv(m, key, i, src, d, res, dst, acc, scale):
            k = weights[m][key].shape[1]
            err = fn(src.data_ptr(), taps + tap_bytes * (first[m, key]
                                                         + i * k),
                     biases[m]["b" + key[1]].data_ptr() + 4 * cp * i,
                     _ptr(res), _ptr(dst), _ptr(acc), scale, B, T, C, cp, k,
                     d, LRELU_SLOPE, *tile, stream)
            if err != 0:
                _raise(err, src, k, d)
            setattr(mrf, count, getattr(mrf, count) + 1)
    else:
        if _lib is None:
            build()

        def conv(m, key, i, src, d, res, dst, acc, scale):
            wd = weights[m]
            _conv_launch(src, wd[key][i], wd["b" + key[1]][i], d, res, dst,
                         acc, scale)

    out = torch.zeros_like(x)
    xr = torch.empty_like(x)
    xt = torch.empty_like(x)
    scale = 1.0 / len(weights)
    with torch.cuda.device(x.device):
        for m in range(len(weights)):
            src = x
            for i, d in enumerate(DILATIONS):
                last = i == len(DILATIONS) - 1
                conv(m, "w1", i, src, d, None, xt, None, 0.0)
                conv(m, "w2", i, xt, 1, src, None if last else xr,
                     out if last else None, scale)
                src = xr
    return out


mrf.launches = 0        # csrc/mrf.cu launches (route="conv" only)
mrf.tc_launches = 0     # csrc/mrf_tc.cu launches (3xTF32)
mrf.tc1_launches = 0    # its one-pass build's launches (route="tc" only)
mrf.tf32_launches = 0   # csrc/mrf_tf32.cu launches (one TF32 pass)
mrf.stack_launches = 0  # csrc/mrf_stack.cu launches
