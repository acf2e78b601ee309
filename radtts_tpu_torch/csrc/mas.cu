// Monotonic alignment search (Viterbi, width 1), fp32, for Hopper (sm_90a).
//
// Replaces radtts_tpu/ops/mas.py:mas_width1, which the JAX package runs as
// one XLA scan over mel frames (a dynamic program, not a Pallas kernel) with
// a reverse scan for the backtrack. The host wrapper is
// radtts_tpu_torch/ops/mas.py:mas; its plain PyTorch version, mas_plain,
// computes the same 0/1 matrix.
//
// Per utterance b (attn (T, N) probabilities, out_len frames, in_len tokens):
//   la[i][j] = log attn[i][j] for j < in_len, else -1e30;
//   row 0:   s[0] = la[0][0], s[j > 0] = -1e30;
//   row i in [1, out_len): left[j] = s[j-1] >= s[j] (s[-1] = -1e30),
//            s[j] = la[i][j] + max(s[j-1], s[j]);
//   backtrack from (out_len - 1, in_len - 1): mark the cell, step one token
//            back where left[i][cell] was chosen, stop below token 0;
//   and opt[0][0] = 1 (the reference's quirk), inside the valid region.
// Ties go to the token before (>=), as in the JAX package; max propagates a
// NaN as torch.maximum does.
//
// Design: one block per utterance, one thread per token (a thread takes
// tokens tid, tid + blockDim, ... up to kPerThread of them). The DP row
// lives in shared memory, double-buffered, so a frame costs one
// __syncthreads(). Each thread issues the load (and the log) of its
// attention values for frame i + 1 while it computes frame i. The choices
// are bytes, in shared memory after the two
// rows when T * N + 8 N bytes fit in the block's 227 KB (the flagship
// training batch's 512 x 112 takes 57 KB), else in a global scratch the
// wrapper allocates. One thread then backtracks over them: out_len
// dependent byte reads. The block first zeroes its output slab, so every
// output element is written once.
//
// Bound: the function moves B*T*N*4 bytes in and out (7.3 MB at the
// flagship (16, 512, 112): 2.2 us at 3.35 TB/s), and does ~4 operations per
// cell. What bounds it here is neither: it is the dependence over frames, a
// chain of out_len steps of (shared read, compare, add, shared write,
// barrier) in each block, plus the backtrack's out_len dependent reads, and
// B blocks use B of the 132 SMs. On an H100 (700 W) it takes 0.23 ms at
// (16, 512, 112), ~0.45 us a frame (chip_smoke.py, PERF.md): more than the
// chain's own work, so the one-frame prefetch does not hide a global
// load's latency; loading several frames ahead is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kPerThread = 4;      // tokens per thread: N <= 4 * 1024
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory cap

__device__ __forceinline__ float log_cell(const float* row, int j,
                                          int in_len) {
  return j < in_len ? logf(row[j]) : kNeg;
}

__global__ void __launch_bounds__(1024)
mas_kernel(const float* __restrict__ attn, const int* __restrict__ out_lens,
           const int* __restrict__ in_lens, float* __restrict__ out,
           unsigned char* __restrict__ scratch, int T, int N,
           int choices_in_smem) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t slab = (size_t)T * N;
  const float* a = attn + b * slab;
  float* o = out + b * slab;
  unsigned char* ch = choices_in_smem
                          ? reinterpret_cast<unsigned char*>(smem + 2 * N)
                          : scratch + b * slab;
  const int out_len = min(max(out_lens[b], 0), T);
  const int in_len = min(max(in_lens[b], 0), N);

  for (size_t k = tid; k < slab; k += nt) o[k] = 0.f;

  float* prev = smem;
  float* next = smem + N;
  float la[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int j = tid + q * nt;
    if (j < N) {
      prev[j] = j == 0 ? log_cell(a, 0, in_len) : kNeg;
      la[q] = out_len > 1 ? log_cell(a + N, j, in_len) : kNeg;
    }
  }
  __syncthreads();

  for (int i = 1; i < out_len; ++i) {
    const bool more = i + 1 < out_len;
    const float* a_next = a + (size_t)(i + 1) * N;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int j = tid + q * nt;
      if (j < N) {
        const float p = prev[j];
        const float sh = j > 0 ? prev[j - 1] : kNeg;
        const float best = (isnan(sh) || isnan(p)) ? __int_as_float(0x7fc00000)
                                                   : fmaxf(sh, p);
        next[j] = la[q] + best;
        ch[(size_t)i * N + j] = sh >= p;
        la[q] = more ? log_cell(a_next, j, in_len) : kNeg;
      }
    }
    __syncthreads();
    float* t = prev;
    prev = next;
    next = t;
  }

  if (tid == 0 && out_len > 0 && in_len > 0) {
    int curr = in_len - 1;
    for (int i = out_len - 1; i >= 0 && curr >= 0; --i) {
      o[(size_t)i * N + curr] = 1.f;
      if (i > 0 && ch[(size_t)i * N + curr]) --curr;
    }
    o[0] = 1.f;
  }
}

int row_bytes(int N) { return 2 * N * (int)sizeof(float); }

}  // namespace

// Dynamic shared memory of a block whose choices stay in shared memory, or
// 0 when they do not fit (the wrapper then allocates B * T * N bytes of
// global scratch).
extern "C" int radtts_mas_smem_bytes(int T, int N) {
  const long long bytes = (long long)row_bytes(N) + (long long)T * N;
  return bytes <= kMaxSmem ? (int)bytes : 0;
}

extern "C" int radtts_mas(const float* attn, const int* out_lens,
                          const int* in_lens, float* out,
                          unsigned char* scratch, int B, int T, int N,
                          cudaStream_t stream) {
  if (N > kPerThread * 1024 || B <= 0 || T <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const int in_smem = radtts_mas_smem_bytes(T, N);
  const int smem = in_smem > 0 ? in_smem : row_bytes(N);
  const int threads = min(1024, (N + 31) / 32 * 32);
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mas_kernel<<<B, threads, smem, stream>>>(attn, out_lens, in_lens, out,
                                           scratch, T, N, in_smem > 0);
  return (int)cudaGetLastError();
}
