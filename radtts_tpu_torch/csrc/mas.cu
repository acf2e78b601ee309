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
// mas_warp_kernel (texts of N <= 1024 tokens): a
// block an utterance; warp 0 runs the DP, lane l holding tokens l K .. l K
// + K - 1 (K = 1, 2, 4, 8, 16 or 32, the least that covers N: one template
// instance each) in registers, s[j-1] across a lane boundary by one
// __shfl_up_sync, no block barrier a frame; a frame's choices are 32
// lane words, one a lane, in shared memory where T frames' words fit
// beside the ring (64 KB at (16, 512, 112); T <= 1688 at K=4, 1304 at
// K=32, whose ring alone is 64 KB), else in global scratch. Warps 1 .. 7
// feed it: they load the attention a chunk (16 frames, 8 at K=32) ahead
// into registers and write the logs into a double-buffered shared ring,
// one __syncthreads a chunk. At K >= 16 a lane's slots sit in the ring's
// row with their 16-byte groups permuted by the lane (ring_pos), so warp
// 0's float4 loads of a frame hit distinct bank quads (unpermuted, lanes
// K floats apart share them: 4-way at K=16, 8-way at K=32). Warp 0 then
// backtracks, 32 rows at a time, each lane holding one row's words. The
// output comes zeroed (torch.zeros).
//
// mas_kernel (the block kernel, N > 1024): one block an utterance, one
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
// Past 512 tokens (K=32) the feeders bound the warp kernel: the logs of
// 32 K slots a frame took a feeder warp ~870 cycles a frame at (1, 3000,
// 1000) against warp 0's ~450 (a clock64 trace of block 0), 1.77 ms
// there against the block kernel's 2.82.

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

constexpr int kWarpMaxN = 1024;  // 32 lanes x 32 tokens
constexpr int kWarpThreads = 256;
// frames the feeders hand over at a time: 16, or 8 at K=32, where a
// feeder holds kChunk x 32 K / 224 values in registers
__host__ __device__ constexpr int chunk_frames(int K) {
  return K >= 32 ? 8 : 16;
}
constexpr int kFeeders = kWarpThreads - 32;   // warps 1 .. 7

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Where token j = l K + q (lane l, slot q) sits in a ring row of 32 K
// floats: at j for K <= 8; at K >= 16 the lane's 16-byte groups of slots
// are permuted by key(l), so that 8 lanes reading the same group (one
// quarter-warp's 16-byte loads) hit 8 distinct bank quads: key(l) = l % 8
// at K=32 (8 groups a lane, lanes a bank row apart), (l / 2) % 4 at K=16
// (4 groups, two lanes a bank row).
template <int K>
__device__ __forceinline__ int ring_key(int l) {
  constexpr int G = K / 4;               // 16-byte groups a lane
  return (l / (8 / G)) % G;
}

template <int K>
__device__ __forceinline__ int ring_pos(int j) {
  if constexpr (K < 16) {
    return j;
  } else {
    const int l = j / K, q = j % K;
    return l * K + 4 * ((q / 4) ^ ring_key<K>(l)) + q % 4;
  }
}

// A feeder's share of chunk c, its attention values loaded into registers
// a chunk ahead (feed_load), then their logs written into the ring
// (feed_logs). At K <= 8, slots in a flat order over the chunk's frames
// and columns, e = fid + m * kFeeders. At K >= 16, where that order kept a
// few values a slot live (all 255 registers with spills at K=32, and a
// feeder warp spent ~250 cycles a slot on the card, three times warp 0's
// frame), by columns: j = fid + t * kFeeders (t < feed_cols(K)) in each of
// the chunk's frames, so a thread's columns and where they sit in the ring
// are the same in every frame, and the unrolled loads and logs keep little
// beside the values.
__host__ __device__ constexpr int feed_cols(int K) {
  return (32 * K + kFeeders - 1) / kFeeders;
}

// values a feeder holds: a chunk's slots over the feeders
__host__ __device__ constexpr int feed_values(int K) {
  return K >= 16 ? chunk_frames(K) * feed_cols(K)
                 : (chunk_frames(K) * 32 * K + kFeeders - 1) / kFeeders;
}

template <int K>
__device__ __forceinline__ void feed_load(float (&v)[feed_values(K)],
                                          const float* a, int c, int fid,
                                          int N, int out_len, int in_len) {
  constexpr int W = 32 * K, kChunk = chunk_frames(K);
  if constexpr (K >= 16) {
#pragma unroll
    for (int t = 0; t < feed_cols(K); ++t) {
      const int j = fid + t * kFeeders;
#pragma unroll
      for (int f = 0; f < kChunk; ++f) {
        const int i = 1 + c * kChunk + f;
        v[f * feed_cols(K) + t] = (j < W && j < in_len && i < out_len)
                                      ? __ldg(a + (size_t)i * N + j)
                                      : 1.0f;
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < feed_values(K); ++m) {
      const int e = fid + m * kFeeders;
      const int i = 1 + c * kChunk + e / W, j = e % W;
      v[m] = (e < kChunk * W && i < out_len && j < in_len)
                 ? __ldg(a + (size_t)i * N + j)
                 : 1.0f;
    }
  }
}

template <int K>
__device__ __forceinline__ void feed_logs(const float (&v)[feed_values(K)],
                                          float* ring, int c, int fid,
                                          int out_len, int in_len) {
  constexpr int W = 32 * K, kChunk = chunk_frames(K);
  float* r = ring + (c & 1) * kChunk * W;
  if constexpr (K >= 16) {
#pragma unroll
    for (int t = 0; t < feed_cols(K); ++t) {
      const int j = fid + t * kFeeders;
      if (j < W) {
        const int pos = ring_pos<K>(j);
#pragma unroll
        for (int f = 0; f < kChunk; ++f) {
          const int i = 1 + c * kChunk + f;
          r[f * W + pos] = (j < in_len && i < out_len)
                               ? logf(v[f * feed_cols(K) + t])
                               : kNeg;
        }
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < feed_values(K); ++m) {
      const int e = fid + m * kFeeders;
      if (e < kChunk * W) {
        const int i = 1 + c * kChunk + e / W, j = e % W;
        r[e] = (i < out_len && j < in_len) ? logf(v[m]) : kNeg;
      }
    }
  }
}

// Lane l's K log-attentions of one frame from the ring row (ring_pos): K
// scalar loads at K <= 8, K / 4 float4 loads at K >= 16.
template <int K>
__device__ __forceinline__ void ring_read(float (&la)[K], const float* row,
                                          int lane) {
  if constexpr (K < 16) {
#pragma unroll
    for (int q = 0; q < K; ++q) la[q] = row[lane * K + q];
  } else {
    const int key = ring_key<K>(lane);
#pragma unroll
    for (int g = 0; g < K / 4; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(row + lane * K + 4 * (g ^ key));
      la[4 * g] = v.x;
      la[4 * g + 1] = v.y;
      la[4 * g + 2] = v.z;
      la[4 * g + 3] = v.w;
    }
  }
}

// w[q] for a q that is the same in every lane, as a tree of log2 K levels
// of selects on registers: each level halves the words by one bit of q,
// and every index is a constant, so nothing goes to local memory.
template <int K>
__device__ __forceinline__ unsigned select_word(const unsigned (&w)[K],
                                                int q) {
  if constexpr (K == 1) {
    return w[0];
  } else {
    unsigned t[K / 2];
#pragma unroll
    for (int i = 0; i < K / 2; ++i) t[i] = (q & 1) ? w[2 * i + 1] : w[2 * i];
    return select_word<K / 2>(t, q >> 1);
  }
}

constexpr int kFrameWords = 32;   // a frame's choices: a word a lane

// Warp 0 holds the DP row, lane l tokens l K .. l K + K - 1 in registers;
// s[j-1] across a lane boundary comes from one __shfl_up_sync. A frame's
// choices are kFrameWords words, in shared memory (global scratch where T
// of them do not fit): each lane's own K-bit word (bit q of word l: token
// l K + q), built with ALU operations alone. K ballot words (bit l of word
// q), K warp-wide votes a frame, were as fast up to K=16 and slower at
// K=32 on the card (PERF.md). Warps 1 .. 7 feed it: they load the
// attention a chunk ahead into registers and take the logs into a
// double-buffered shared ring of kChunk frames; one __syncthreads a
// chunk. Then warp 0 backtracks, 32 rows at a time: lane l holds row i
// - l's words; every lane picks its own row's word of the token's lane
// (select_word: the token is the same in every lane) and one shuffle
// brings lane st's. Lane l keeps its row's token and writes its one after
// the window. Ties and NaNs take the same path at every K: the choice is
// sh >= p (the token before on a tie, never on a NaN) and the max is
// max.NaN. The output comes zeroed (the wrapper's torch.zeros): the kernel
// writes the path's ones.
template <int K>
__global__ void __launch_bounds__(kWarpThreads)
mas_warp_kernel(const float* __restrict__ attn,
                const int* __restrict__ out_lens,
                const int* __restrict__ in_lens, float* __restrict__ out,
                unsigned int* __restrict__ scratch, int T, int N,
                int bits_in_smem) {
  constexpr int W = 32 * K;                               // a ring row
  constexpr int kChunk = chunk_frames(K);
  constexpr int kWords = kFrameWords;
  extern __shared__ __align__(16) float mas_smem[];
  float* ring = mas_smem;                                 // 2 x kChunk x W
  unsigned int* bits =
      bits_in_smem ? reinterpret_cast<unsigned int*>(ring + 2 * kChunk * W)
                   : scratch + (size_t)blockIdx.x * T * kWords;
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

  float v[feed_values(K)];   // a feeder's values of the next chunk
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
      const float* r = ring + (c & 1) * kChunk * W;
      const int frames = min(kChunk, out_len - 1 - c * kChunk);
      for (int f = 0; f < frames; ++f) {
        float la[K];
        ring_read<K>(la, r + f * W, lane);
        const float from_left = __shfl_up_sync(0xffffffffu, s[K - 1], 1);
        float next[K];
        // four partial words, so the ORs are four short chains
        unsigned part[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float p = s[q];
          const float sh = q > 0 ? s[q - 1] : (lane > 0 ? from_left : kNeg);
          next[q] = la[q] + max_nan(sh, p);
          part[q & 3] |= (sh >= p ? 1u : 0u) << q;
        }
#pragma unroll
        for (int q = 0; q < K; ++q) s[q] = next[q];
        bits[(size_t)(1 + c * kChunk + f) * kWords + lane] =
            (part[0] | part[1]) | (part[2] | part[3]);
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
      unsigned w[kWords];
      // 16-byte loads of a row's words (16-byte aligned): 8-way bank
      // conflicts across the lanes' rows, where word loads are 32-way
#pragma unroll
      for (int q = 0; q < kWords; q += 4) {
        const uint4 v = row > 0 ? *reinterpret_cast<const uint4*>(
                                      bits + (size_t)row * kWords + q)
                                : make_uint4(0u, 0u, 0u, 0u);
        w[q] = v.x;
        w[q + 1] = v.y;
        w[q + 2] = v.z;
        w[q + 3] = v.w;
      }
      const int steps = min(32, i0 + 1);
      int token = -1;   // the path's token at row i0 - lane
      for (int st = 0; st < steps && curr >= 0; ++st) {
        const int i = i0 - st;
        if (lane == st) token = curr;
        const int l = curr / K, q = curr - l * K;
        // word l of row i (lane l's slots), bit q: token l K + q
        const bool left =
            (__shfl_sync(0xffffffffu, select_word<32>(w, l), st) >> q) & 1u;
        if (i > 0 && left) --curr;
      }
      if (token >= 0) o[(size_t)row * N + token] = 1.f;
    }
    if (lane == 0) o[0] = 1.f;
  }
}

int tokens_a_lane(int N) {
  return N <= 32 ? 1 : N <= 64 ? 2 : N <= 128 ? 4 : N <= 256 ? 8
       : N <= 512 ? 16 : 32;
}

// Dynamic shared memory of the warp kernel: the ring, and the choices
// (T x kFrameWords words) where they fit beside it (else 0 for them:
// global scratch).
int warp_smem(int T, int N, bool* bits_in_smem) {
  const int K = tokens_a_lane(N);
  const long long ring = 2LL * chunk_frames(K) * 32 * K * 4;
  const long long with_bits = ring + (long long)T * kFrameWords * 4;
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

// Words of global scratch the warp kernel needs (B x T x kFrameWords), or
// 0 when the choices stay in shared memory.
extern "C" int radtts_mas_warp_scratch_words(int B, int T, int N) {
  bool in_smem = false;
  warp_smem(T, N, &in_smem);
  return in_smem ? 0 : B * T * kFrameWords;
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
    case 8:
      return launch_warp<8>(attn, out_lens, in_lens, out, scratch, B, T, N,
                            stream);
    case 16:
      return launch_warp<16>(attn, out_lens, in_lens, out, scratch, B, T, N,
                             stream);
    default:
      return launch_warp<32>(attn, out_lens, in_lens, out, scratch, B, T, N,
                             stream);
  }
}
