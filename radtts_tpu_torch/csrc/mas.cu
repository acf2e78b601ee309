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
// Two kernels; ops/mas.py:mas_route picks one by N.
//
// mas_warp_kernel (texts of N <= 256 tokens): a
// block an utterance; warp 0 runs the DP, lane l holding tokens l K .. l K
// + K - 1 (K <= 8) in registers, s[j-1] across a lane boundary by one
// __shfl_up_sync, no block barrier a frame; a frame's choices are K
// ballots (bits), in shared memory where T x K words fit (~8 KB at
// (16, 512, 112), ~40 KB at (2, 2500, 100)), else in global scratch. Warps
// 1 .. 7 feed it: they load the attention a chunk (16 frames) ahead into
// registers and write the logs into a double-buffered shared ring, one
// __syncthreads a chunk. Warp 0 then backtracks, 32 rows at a time, each
// lane holding one row's words. The output comes zeroed (torch.zeros).
//
// mas_kernel (the block kernel, N > 256): one block an utterance, one
// thread a token (up to 4), the DP row in shared memory double-buffered, one
// __syncthreads a frame, the next frame's attention loaded one frame ahead,
// byte choices (in shared memory when T * N + 8 N bytes fit, else global
// scratch), and one thread's backtrack over them.
//
// Bound: the function moves B*T*N*4 bytes in and out (7.3 MB at the
// flagship (16, 512, 112): 2.2 us at 3.35 TB/s), and does ~4 operations per
// cell. What bounds both kernels is neither: it is the dependence over
// frames, out_len steps an utterance, then the backtrack's out_len
// dependent steps. On an H100 (700 W; chip_smoke.py, PERF.md) the warp
// kernel takes ~0.10 ms at (16, 512, 112), the block kernel ~0.24 ms;
// what is left is the feeders' logs and the backtrack's dependent steps.

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

// ---------------------------------------------------------------------------
// The warp kernel (the route for N <= kWarpMaxN): one warp an utterance
// runs the DP; the other warps of its block feed it.
// ---------------------------------------------------------------------------

constexpr int kWarpMaxN = 256;   // 32 lanes x 8 tokens
constexpr int kWarpThreads = 256;
constexpr int kChunk = 16;       // frames the feeders hand over at a time
constexpr int kFeeders = kWarpThreads - 32;   // warps 1 .. 7

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A feeder's share of chunk c: its attention values, loaded into registers
// a chunk ahead (feed_load), then their logs into the ring (feed_logs). E
// values a feeder, ring rows of 32 K.
template <int K, int E>
__device__ __forceinline__ void feed_load(float (&v)[E], const float* a,
                                          int c, int fid, int N,
                                          int out_len, int in_len) {
  constexpr int W = 32 * K;
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = fid + m * kFeeders;
    const int i = 1 + c * kChunk + e / W, j = e % W;
    v[m] = (e < kChunk * W && i < out_len && j < in_len)
               ? __ldg(a + (size_t)i * N + j)
               : 1.0f;
  }
}

template <int K, int E>
__device__ __forceinline__ void feed_logs(const float (&v)[E], float* ring,
                                          int c, int fid, int out_len,
                                          int in_len) {
  constexpr int W = 32 * K;
  float* r = ring + (c & 1) * kChunk * W;
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = fid + m * kFeeders;
    if (e < kChunk * W) {
      const int i = 1 + c * kChunk + e / W, j = e % W;
      r[e] = (i < out_len && j < in_len) ? logf(v[m]) : kNeg;
    }
  }
}

// Warp 0 holds the DP row, lane l tokens l K .. l K + K - 1 in registers;
// s[j-1] across a lane boundary comes from one __shfl_up_sync; a frame's
// choices are K ballots (bit l of word q: token l K + q), in shared memory
// (global scratch where T x K words do not fit). Warps 1 .. 7 feed it: they
// load the attention a chunk ahead into registers and take the logs into a
// double-buffered shared ring of kChunk frames; one __syncthreads a chunk.
// Then warp 0 backtracks, 32 rows at a time: lane l holds row i - l's K
// words, each step takes its word by a shuffle that does not wait for the
// token, and lane l keeps its row's token and writes its one after the
// window. The output comes zeroed (the wrapper's torch.zeros): the kernel
// writes the path's ones.
template <int K>
__global__ void __launch_bounds__(kWarpThreads)
mas_warp_kernel(const float* __restrict__ attn,
                const int* __restrict__ out_lens,
                const int* __restrict__ in_lens, float* __restrict__ out,
                unsigned int* __restrict__ scratch, int T, int N,
                int bits_in_smem) {
  constexpr int W = 32 * K;                               // a ring row
  constexpr int E = (kChunk * W + kFeeders - 1) / kFeeders;
  extern __shared__ __align__(16) float mas_smem[];
  float* ring = mas_smem;                                 // 2 x kChunk x W
  unsigned int* bits =
      bits_in_smem ? reinterpret_cast<unsigned int*>(ring + 2 * kChunk * W)
                   : scratch + (size_t)blockIdx.x * T * K;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool feeder = warp > 0;
  const int fid = threadIdx.x - 32;                       // 0 .. kFeeders-1
  const size_t slab = (size_t)T * N;
  const float* a = attn + b * slab;
  float* o = out + b * slab;
  const int out_len = min(max(out_lens[b], 0), T);
  const int in_len = min(max(in_lens[b], 0), N);
  const int chunks = out_len > 1 ? (out_len - 1 + kChunk - 1) / kChunk : 0;

  float v[E];   // a feeder's attention values of the next chunk
  float s[K];
  if (feeder) {
    if (chunks > 0) {
      feed_load<K>(v, a, 0, fid, N, out_len, in_len);
      feed_logs<K>(v, ring, 0, fid, out_len, in_len);
      if (chunks > 1) feed_load<K>(v, a, 1, fid, N, out_len, in_len);
    }
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q)
      s[q] = (lane * K + q == 0 && in_len > 0) ? logf(__ldg(a)) : kNeg;
  }
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    if (warp == 0) {
      const float* r = ring + (c & 1) * kChunk * W + lane * K;
      const int frames = min(kChunk, out_len - 1 - c * kChunk);
      for (int f = 0; f < frames; ++f) {
        float la[K];
#pragma unroll
        for (int q = 0; q < K; ++q) la[q] = r[f * W + q];
        const float from_left = __shfl_up_sync(0xffffffffu, s[K - 1], 1);
        float next[K];
        unsigned mine = 0;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float p = s[q];
          const float sh = q > 0 ? s[q - 1] : (lane > 0 ? from_left : kNeg);
          next[q] = la[q] + max_nan(sh, p);
          const unsigned w = __ballot_sync(0xffffffffu, sh >= p);
          if (lane == q) mine = w;
        }
#pragma unroll
        for (int q = 0; q < K; ++q) s[q] = next[q];
        if (lane < K) bits[(size_t)(1 + c * kChunk + f) * K + lane] = mine;
      }
    } else if (c + 1 < chunks) {
      feed_logs<K>(v, ring, c + 1, fid, out_len, in_len);
      if (c + 2 < chunks) feed_load<K>(v, a, c + 2, fid, N, out_len, in_len);
    }
    __syncthreads();
  }

  if (warp == 0 && out_len > 0 && in_len > 0) {
    int curr = in_len - 1;   // the same in every lane
    for (int i0 = out_len - 1; i0 >= 0 && curr >= 0; i0 -= 32) {
      const int row = i0 - lane;
      unsigned w[K];
#pragma unroll
      for (int q = 0; q < K; ++q)
        w[q] = row > 0 ? bits[(size_t)row * K + q] : 0u;
      const int steps = min(32, i0 + 1);
      int token = -1;   // the path's token at row i0 - lane
      for (int st = 0; st < steps && curr >= 0; ++st) {
        const int i = i0 - st;
        if (lane == st) token = curr;
        unsigned word[K];
#pragma unroll
        for (int q = 0; q < K; ++q)
          word[q] = __shfl_sync(0xffffffffu, w[q], st);
        const int l = curr / K, q = curr - l * K;
        unsigned pick = word[0];
#pragma unroll
        for (int k = 1; k < K; ++k)
          if (q == k) pick = word[k];
        if (i > 0 && ((pick >> l) & 1u)) --curr;
      }
      if (token >= 0) o[(size_t)row * N + token] = 1.f;
    }
    if (lane == 0) o[0] = 1.f;
  }
}

int tokens_a_lane(int N) {
  return N <= 32 ? 1 : N <= 64 ? 2 : N <= 128 ? 4 : 8;
}

// Dynamic shared memory of the warp kernel: the ring, and the choices
// (T x K words) where they fit beside it (else 0 for them: global scratch).
int warp_smem(int T, int N, bool* bits_in_smem) {
  const int K = tokens_a_lane(N);
  const long long ring = 2LL * kChunk * 32 * K * 4;
  const long long with_bits = ring + (long long)T * K * 4;
  *bits_in_smem = with_bits <= kMaxSmem;
  return (int)(*bits_in_smem ? with_bits : ring);
}

template <int K>
int launch_warp(const float* attn, const int* out_lens, const int* in_lens,
                float* out, unsigned int* scratch, int B, int T, int N,
                cudaStream_t stream) {
  bool in_smem = false;
  const int smem = warp_smem(T, N, &in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      mas_warp_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mas_warp_kernel<K><<<B, kWarpThreads, smem, stream>>>(
      attn, out_lens, in_lens, out, scratch, T, N, in_smem);
  return (int)cudaGetLastError();
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

// Words of global scratch the warp kernel needs (B x T x K), or 0 when the
// choices stay in shared memory.
extern "C" int radtts_mas_warp_scratch_words(int B, int T, int N) {
  bool in_smem = false;
  warp_smem(T, N, &in_smem);
  return in_smem ? 0 : B * T * tokens_a_lane(N);
}

// The warp kernel, for N <= kWarpMaxN.
extern "C" int radtts_mas_warp(const float* attn, const int* out_lens,
                               const int* in_lens, float* out,
                               unsigned int* scratch, int B, int T, int N,
                               cudaStream_t stream) {
  if (N > kWarpMaxN || B <= 0 || T <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  switch (tokens_a_lane(N)) {
    case 1:
      return launch_warp<1>(attn, out_lens, in_lens, out, scratch, B, T, N,
                            stream);
    case 2:
      return launch_warp<2>(attn, out_lens, in_lens, out, scratch, B, T, N,
                            stream);
    case 4:
      return launch_warp<4>(attn, out_lens, in_lens, out, scratch, B, T, N,
                            stream);
    default:
      return launch_warp<8>(attn, out_lens, in_lens, out, scratch, B, T, N,
                            stream);
  }
}
