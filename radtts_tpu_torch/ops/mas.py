"""Monotonic alignment search (Viterbi, width 1): the hard attention that
binarizes the soft text-mel alignment during training.

Port of radtts_tpu/ops/mas.py:mas_width1, which the JAX package compiles as
one XLA scan over mel frames (not a Pallas kernel). On the card `mas`
launches the hand-written kernel csrc/mas.cu once per call (one block per
utterance, the DP row in shared memory; see its header for the design and
what bounds it); `mas_plain` is the same function in plain PyTorch, a loop
over frames vectorized over the batch and the tokens, which the CPU path
and the tests use. Both give the JAX package's 0/1 matrix exactly: its
tie-break (prefer the token before when the scores tie), its -1e30 fill,
and its quirk of also setting opt[0, 0] = 1.
"""

import ctypes

import torch

from radtts_tpu_torch.ops.cuda_build import build_library

NEG_INF = -1e30
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
    _lib = lib
    return lib, log, seconds


def _launch(attn, out_lens, in_lens):
    B, T, N = attn.shape
    if attn.dtype != torch.float32 or not attn.is_contiguous():
        raise ValueError("mas: attn must be contiguous float32, got "
                         f"{attn.dtype}")
    if B == 0 or T == 0 or N == 0:
        return torch.zeros_like(attn)
    if _lib is None:
        build()
    out_l = out_lens.to(attn.device, torch.int32).contiguous()
    in_l = in_lens.to(attn.device, torch.int32).contiguous()
    out = torch.empty_like(attn)
    # the choices go to global scratch only when they do not fit in the
    # block's shared memory (see csrc/mas.cu)
    smem = _lib.radtts_mas_smem_bytes(T, N)
    scratch = (torch.empty(0, dtype=torch.uint8, device=attn.device)
               if smem > 0 else
               torch.empty(B * T * N, dtype=torch.uint8, device=attn.device))
    err = _lib.radtts_mas(attn.data_ptr(), out_l.data_ptr(),
                          in_l.data_ptr(), out.data_ptr(),
                          scratch.data_ptr(), B, T, N,
                          torch.cuda.current_stream(attn.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mas: kernel launch failed with cudaError {err} "
                           f"(B={B}, T={T}, N={N})")
    mas.launches += 1
    return out


@torch.no_grad()
def mas(attn, out_lens, in_lens):
    """Hard attention from soft attention (B, T_mel, T_text), no gradient.
    A CPU tensor runs mas_plain; a CUDA tensor launches csrc/mas.cu, or
    raises."""
    if attn.device.type == "cpu":
        return mas_plain(attn, out_lens, in_lens)
    if attn.device.type != "cuda":
        raise ValueError(f"mas: unsupported device {attn.device}")
    return _launch(attn, out_lens, in_lens)


mas.launches = 0
