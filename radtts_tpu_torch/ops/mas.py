"""Monotonic alignment search (Viterbi, width 1): the hard attention that
binarizes the soft text-mel alignment during training.

Port of radtts_tpu/ops/mas.py:mas_width1, which the JAX package compiles as
one XLA scan over mel frames (not a Pallas kernel). On the card `mas`
launches a hand-written kernel of csrc/mas.cu once per call, the one
`mas_route(N)` names by shape: "warp" (one warp an utterance, the DP row in
registers, K = 1 to 32 tokens a lane, for N <= 1024 tokens) or "block"
(one block an utterance, the DP row in shared memory, for longer texts);
see its header for both designs and what bounds them. `mas_plain` is the same function in plain
PyTorch, a loop over frames vectorized over the batch and the tokens,
which the CPU path and the tests use. Both give the JAX package's 0/1
matrix exactly: its tie-break (prefer the token before when the scores
tie), its -1e30 fill, and its quirk of also setting opt[0, 0] = 1.
"""

import ctypes

import torch

from radtts_tpu_torch.ops.cuda_build import build_library

NEG_INF = -1e30
WARP_MAX_N = 1024   # csrc/mas.cu kWarpMaxN: 32 lanes x 32 tokens
_lib = None


def mas_plain(attn, out_lens, in_lens):
    """attn: (B, T_mel, T_text) probabilities -> hard attention (B, T_mel,
    T_text) of attn's dtype with one monotone path through each item's valid
    region (out_lens[b] frames, in_lens[b] tokens)."""
    B, T, N = attn.shape
    dev = attn.device
    # lengths past the padded sizes are taken as the sizes, as the kernel
    # takes them
    out_lens = out_lens.to(dev, torch.int64).clamp(0, T)
    in_lens = in_lens.to(dev, torch.int64).clamp(0, N)
    cols = torch.arange(N, device=dev)
    col_valid = cols[None, :] < in_lens[:, None]                 # (B, N)
    neg = torch.full((), NEG_INF, dtype=attn.dtype, device=dev)
    log_attn = torch.where(col_valid[:, None, :], torch.log(attn), neg)
    prev = torch.where(cols[None, :] == 0, log_attn[:, 0], neg)  # (B, N)
    choices = torch.zeros(B, T, N, dtype=torch.bool, device=dev)
    pad = neg.expand(B, 1)
    for i in range(1, T):
        shifted = torch.cat([pad, prev[:, :-1]], dim=1)
        left = shifted >= prev
        row_valid = (i < out_lens)[:, None]
        choices[:, i] = left & row_valid
        prev = torch.where(row_valid,
                           log_attn[:, i] + torch.maximum(shifted, prev),
                           prev)
    opt = torch.zeros(B, T, N, dtype=attn.dtype, device=dev)
    curr = in_lens - 1
    rows = torch.arange(B, device=dev)
    for i in range(T - 1, -1, -1):
        on = (i < out_lens) & (curr >= 0)
        idx = curr.clamp(min=0)
        opt[rows[on], i, idx[on]] = 1.0
        go_left = choices[rows, i, idx] & on
        curr = torch.where(go_left, curr - 1, curr)
    opt[:, 0, 0] = 1.0
    valid = ((torch.arange(T, device=dev)[None, :, None]
              < out_lens[:, None, None]) & col_valid[:, None, :])
    return opt * valid


def build():
    """Compile csrc/mas.cu (ops/cuda_build.py) and load it. Returns
    (library, nvcc output, build seconds)."""
    global _lib
    lib, log, seconds = build_library("mas")
    fn = lib.radtts_mas
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.radtts_mas_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.radtts_mas_smem_bytes.restype = ctypes.c_int
    lib.radtts_mas_warp.argtypes = fn.argtypes
    lib.radtts_mas_warp.restype = ctypes.c_int
    lib.radtts_mas_warp_scratch_words.argtypes = [ctypes.c_int] * 3
    lib.radtts_mas_warp_scratch_words.restype = ctypes.c_int
    _lib = lib
    return lib, log, seconds


def warp_tokens_a_lane(N):
    """K of csrc/mas.cu's warp kernel at N tokens (tokens_a_lane): the
    least of 1, 2, 4, 8, 16, 32 with 32 K >= N, one template instance
    each."""
    return next(k for k in (1, 2, 4, 8, 16, 32) if 32 * k >= N)


def mas_route(N):
    """The kernel a call with N tokens runs, by shape alone: "warp" (one
    warp an utterance) for N <= WARP_MAX_N, else "block"."""
    return "warp" if N <= WARP_MAX_N else "block"


def mas_cuda(attn, out_lens, in_lens, route=None):
    """csrc/mas.cu on the card, on `route` (default mas_route(N); "warp"
    raises above WARP_MAX_N tokens)."""
    B, T, N = attn.shape
    if attn.dtype != torch.float32 or not attn.is_contiguous():
        raise ValueError("mas: attn must be contiguous float32, got "
                         f"{attn.dtype}")
    route = route or mas_route(N)
    if route not in ("warp", "block"):
        raise ValueError(f"mas: unknown route {route!r}")
    if route == "warp" and N > WARP_MAX_N:
        raise ValueError(f"mas: the warp kernel takes N <= {WARP_MAX_N}, "
                         f"got {N}")
    if B == 0 or T == 0 or N == 0:
        return torch.zeros_like(attn)
    if _lib is None:
        build()
    dev = attn.device
    out_l = out_lens.to(dev, torch.int32).contiguous()
    in_l = in_lens.to(dev, torch.int32).contiguous()
    if route == "warp":
        # the warp kernel writes the path's ones into a zeroed output
        out = torch.zeros_like(attn)
        # the choices go to global scratch only when one utterance's do
        # not fit a block's shared memory
        words = _lib.radtts_mas_warp_scratch_words(B, T, N)
        scratch = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        fn = _lib.radtts_mas_warp
    else:
        out = torch.empty_like(attn)
        smem = _lib.radtts_mas_smem_bytes(T, N)
        scratch = torch.empty(1 if smem > 0 else B * T * N,
                              dtype=torch.uint8, device=dev)
        fn = _lib.radtts_mas
    with torch.cuda.device(dev):
        err = fn(attn.data_ptr(), out_l.data_ptr(), in_l.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), B, T, N,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mas: {route} kernel launch failed with "
                           f"cudaError {err} (B={B}, T={T}, N={N})")
    if route == "warp":
        mas.launches += 1
    else:
        mas.block_launches += 1
    return out


@torch.no_grad()
def mas(attn, out_lens, in_lens):
    """Hard attention from soft attention (B, T_mel, T_text), no gradient.
    A CPU tensor runs mas_plain; a CUDA tensor launches csrc/mas.cu on the
    route mas_route names, or raises."""
    if attn.device.type == "cpu":
        return mas_plain(attn, out_lens, in_lens)
    if attn.device.type != "cuda":
        raise ValueError(f"mas: unsupported device {attn.device}")
    return mas_cuda(attn, out_lens, in_lens)


mas.launches = 0          # the warp kernel's launches
mas.block_launches = 0    # the block kernel's
