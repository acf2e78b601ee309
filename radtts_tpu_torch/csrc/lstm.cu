// Masked (bi)LSTM inference over padded sequences, fp32, for Hopper
// (sm_90a): one persistent cooperative launch runs every time step of both
// directions of one layer.
//
// Replaces no Pallas kernel: radtts_tpu/ops/lstm.py:bilstm_apply is a masked
// lax.scan that XLA compiles. The port ran it on cuDNN with packed sequences
// (ops/lstm.py:MaskedLSTM's "cudnn" route): about two launches a time step,
// and three blocking host transfers a run, since packing needs the lengths
// on the host. The host wrapper is radtts_tpu_torch/ops/lstm.py:lstm_cuda;
// its plain version, lstm_plain, is the same masked step loop in torch ops.
//
// The wrapper computes the input half of every gate, x . W_ih^T + b_ih +
// b_hh, for every frame and both directions as one fp32 matmul before the
// launch (xproj, (B, T, D x 4H), each direction's 4H gate-major as
// nn.LSTM's rows). The kernel is the recurrence only.
//
// lstm_resident_kernel: csrc/ar_scan.cu's resident design applied to one
// LSTM layer. The blocks are split between the directions: block j of
// direction d owns units [j U, j U + U) (U = ceil(D H / 132): every SM takes
// a block; ops/lstm.py:lstm_plan), their four gate rows of W_hh copied once
// into shared memory (row 4u + q: gate q of unit u, ops/lstm.py:
// resident_image), and their cells' c. After that prologue a block reads no
// weight from global memory. A step:
//   1. a warp takes one unit and a group of G items at a time: its lanes
//      split K in float4s (as ar_scan's dot_rows: every shared-memory read
//      of W and of h is a distinct 16 bytes a lane, the full bandwidth),
//      each lane summing its part of the 4 x G products; a transposed
//      butterfly then leaves each (item, gate) sum whole on lanes of its
//      own (31 shuffles for 32 sums, where an all-reduce of each takes
//      160), which add the prefetched projection and apply the gate's
//      nonlinearity; the lane of each item's gate i gathers the other
//      three gates by shuffles and makes the cell;
//   2. the block writes its units' h into a step-parity double buffer in
//      global memory and joins the next step through csrc/handoff.cuh's
//      handoff on its direction's counter (one release-add, then an
//      acquire spin until every block of the direction has arrived), then
//      reads all of h(s) back with ld.global.cg. Between the handoff's two
//      halves, while the other blocks arrive, it writes its outputs of the
//      step (staged in shared memory) and issues the next step's
//      projection prefetch: neither is on the chain.
// The directions never wait for each other. The next step's projection is
// prefetched with cp.async a step ahead. Every product is an fp32 FMA on
// the CUDA cores, never TF32.
//
// Lengths are read from device memory: no host read, no pack. Item b of
// length len_b (clamped to [0, T]): the forward direction's step s reads
// frame s and stops at s >= len_b (its state frozen; no later output reads
// it); the backward direction's step s reads frame len_b - 1 - s, so it
// starts at the item's own last valid frame. Every output past a length is
// an exact zero, written at the step of that frame's index or, past the
// longest length, by the tail. These are nn.LSTM's packed-sequence
// semantics and the JAX package's masked scan. The launch runs max_b len_b
// steps, not T.
//
// Bound: 2 x B x T x 4H x H x D FLOP at 67 TFLOP/s (fp32 FMA), 0.05 ms
// at (16, 870, 128) and 0.45 ms at (16, 435, 520); the chain of T handoffs
// bounds it harder, ~1.0 us each (chip_smoke.py's handoff probe x T: 1.0
// and 0.5 ms there). On an H100 (700 W; PERF.md) a step of both directions
// takes ~2.5 / 3.0 / 5.4 us at H = 128 / 256 / 520 and B = 16, ~2.2 /
// 2.4 / 2.7 of it without the products: the handoff, the reload of h from
// L2 and the cells.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "handoff.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 8;      // items a warp takes at once (G's largest)
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory cap

struct Args {
  const float* img;        // D x bpd blocks of 4U x kp: the blocks' W_hh rows
  const float* xproj;      // (B, T, D x 4H)
  const long long* lens;   // (B,), or null: every item T long
  float* y;                // (B, T, D x H)
  float* hbuf;             // D x 2 x B x kp: h by step parity, zero pad
  unsigned int* counters;  // one a direction, zero before the launch
  int B, T, H, D, U, bpd, kp;
};

// A block's dynamic shared memory, in floats: its weight rows, h(s - 1) of
// every item (Bg rows: B rounded up to whole groups of G items, the rows
// past B zero), the projection of two steps, its cells' c, its h of the
// step for the outputs, the clamped lengths (ops/lstm.py:lstm_plan sizes
// the same).
struct Layout {
  int w, h, xs, c, ys, lens, total;
};

__host__ __device__ inline Layout layout(int B, int Bg, int U, int kp) {
  Layout l;
  l.w = 0;
  l.h = l.w + 4 * U * kp;
  l.xs = l.h + Bg * kp;
  l.c = l.xs + 2 * B * 4 * U;
  l.ys = l.c + B * U;
  l.lens = l.ys + B * U;
  l.total = l.lens + B;
  return l;
}

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The projection of step s of direction d into slot `slot`:
// xs[b][4u + q] = xproj[b, frame, d, q, u0 + u] for the items that run
// step s (the others' slots are never read).
__device__ __forceinline__ void prefetch(const Args& a, const int* lens,
                                         float* xs, int d, int u0, int s,
                                         int slot) {
  const int R = 4 * a.U, G4 = 4 * a.H;
  float* dst = xs + slot * a.B * R;
  for (int i = threadIdx.x; i < a.B * R; i += blockDim.x) {
    const int b = i / R, r = i - b * R;
    const int unit = u0 + (r >> 2), len = lens[b];
    if (s < len && unit < a.H) {
      const int frame = d == 0 ? s : len - 1 - s;
      cp_async4(dst + i, a.xproj + ((size_t)b * a.T + frame) * a.D * G4
                             + (size_t)d * G4 + (r & 3) * a.H + unit);
    }
  }
}

// v[0..V) summed over the warp's lanes, transposed: after it, lane l holds
// the whole sum of value l >> (5 - log2 V) (V a power of two <= 32). Each
// halving stage (offset O, N values left) keeps one half of the values and
// sends the other to the partner lane; the offsets left over then join the
// lanes that share a value. Recursive on compile-time N and O, so that v
// stays in registers.
template <int V, int N = V, int O = 16>
__device__ __forceinline__ float transposed_sum(float (&v)[V], int lane) {
  if constexpr (N > 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return transposed_sum<V, N / 2, O / 2>(v, lane);
  } else if constexpr (O > 0) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return transposed_sum<V, 1, O / 2>(v, lane);
  } else {
    return v[0];
  }
}

// G: items a warp takes at once (1, 2, 4 or 8, by B)
template <int G>
__global__ void __launch_bounds__(kThreads, 1)
lstm_resident_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int V = 4 * G;                       // sums a warp makes
  constexpr int kShift = V == 32 ? 0 : V == 16 ? 1 : V == 8 ? 2 : 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, T = a.T, H = a.H, U = a.U, R = 4 * U, kp = a.kp;
  const int d = blockIdx.x / a.bpd, u0 = (blockIdx.x - d * a.bpd) * U;
  const int groups = (B + G - 1) / G;
  const Layout L = layout(B, groups * G, U, kp);
  float* w = smem + L.w;
  float* hs = smem + L.h;
  float* xs = smem + L.xs;
  float* cs = smem + L.c;
  float* ys = smem + L.ys;
  int* lens = reinterpret_cast<int*>(smem + L.lens);
  const int chunks = kp / 4;
  // the lane's sum after transposed_sum: gate q of item i of the group
  const int q = (lane >> kShift) & 3, item = lane >> (kShift + 2);
  const bool cell_lane = (lane & ((4 << kShift) - 1)) == 0;
  const size_t frame_floats = (size_t)a.D * H;

  // prologue: the block's weights (once), zero state, the lengths
  {
    const float* src = a.img + (size_t)blockIdx.x * R * kp;
    for (int i = tid * 4; i < R * kp; i += kThreads * 4)
      cp_async16(w + i, src + i);
  }
  for (int i = tid; i < groups * G * kp; i += kThreads) hs[i] = 0.0f;
  for (int i = tid; i < B * U; i += kThreads) cs[i] = 0.0f;
  for (int b = tid; b < B; b += kThreads)
    lens[b] = a.lens == nullptr ? T
                                : (int)min(max(a.lens[b], 0LL), (long long)T);
  __syncthreads();
  int steps = 0;
  for (int b = 0; b < B; ++b) steps = max(steps, lens[b]);
  prefetch(a, lens, xs, d, u0, 0, 0);
  cp_async_wait_all();
  __syncthreads();
  float* hdir = a.hbuf + (size_t)d * 2 * B * kp;

  for (int s = 0; s < steps; ++s) {
    const int par = s & 1;
    const float* xsp = xs + par * B * R;
    float* hout = hdir + (size_t)par * B * kp;
    // 1. a warp a (unit, item group); warp-uniform throughout
    for (int task = warp; task < U * groups; task += kWarps) {
      const int u = task % U, b0 = (task / U) * G;
      if (u0 + u >= H) continue;
      const int nb = min(G, B - b0);
      float acc[4][G];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < G; ++i) acc[g][i] = 0.0f;
      const float* wu = w + 4 * u * kp;
      const float* hb = hs + b0 * kp;
      for (int c = lane; c < chunks; c += 32) {
        float4 w4[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          w4[g] = *reinterpret_cast<const float4*>(wu + g * kp + 4 * c);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float4 h4 =
              *reinterpret_cast<const float4*>(hb + i * kp + 4 * c);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][i] = fmaf(w4[g].x, h4.x, acc[g][i]);
            acc[g][i] = fmaf(w4[g].y, h4.y, acc[g][i]);
            acc[g][i] = fmaf(w4[g].z, h4.z, acc[g][i]);
            acc[g][i] = fmaf(w4[g].w, h4.w, acc[g][i]);
          }
        }
      }
      float v[V];
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) v[i * 4 + g] = acc[g][i];
      float z = transposed_sum<V>(v, lane);
      const int b = b0 + item;
      if (item < nb) z += xsp[b * R + 4 * u + q];
      z = q == 2 ? tanhf(z) : sigm(z);
      const int base = (item * 4) << kShift;
      const float gi = __shfl_sync(0xffffffffu, z, base);
      const float gf = __shfl_sync(0xffffffffu, z, base + (1 << kShift));
      const float gg = __shfl_sync(0xffffffffu, z, base + (2 << kShift));
      const float go = __shfl_sync(0xffffffffu, z, base + (3 << kShift));
      if (cell_lane && item < nb && s < lens[b]) {
        float& c = cs[b * U + u];
        c = gf * c + gi * gg;
        const float h = go * tanhf(c);
        hout[b * kp + u0 + u] = h;
        ys[b * U + u] = h;
      }
    }
    // 2. the handoff, with the step's outputs and the next prefetch between
    //    its halves
    if (s + 1 < steps)
      handoff_arrive(a.counters + d, true);
    else
      __syncthreads();
    for (int i = tid; i < B * U; i += kThreads) {
      const int b = i / U, u = i - b * U, len = lens[b];
      if (u0 + u < H) {
        // a frame past the item's length (frame s, both directions): zero
        const int frame = s >= len ? s : d == 0 ? s : len - 1 - s;
        a.y[((size_t)b * T + frame) * frame_floats + d * H + u0 + u] =
            s < len ? ys[i] : 0.0f;
      }
    }
    prefetch(a, lens, xs, d, u0, s + 1, par ^ 1);
    if (s + 1 < steps) {
      handoff_wait(a.counters + d, (unsigned int)(s + 1) * a.bpd);
      // h(s) of every unit of the direction, for step s + 1
      const float4* src = reinterpret_cast<const float4*>(hout);
      float4* dst = reinterpret_cast<float4*>(hs);
      for (int i = tid; i < B * kp / 4; i += kThreads) dst[i] = __ldcg(src + i);
      cp_async_wait_all();
      __syncthreads();
    }
  }
  cp_async_wait_all();
  // the frames past the longest length: zeros
  const int tail = T - steps;
  for (int i = tid; i < B * tail * U; i += kThreads) {
    const int u = i % U, bt = i / U;
    const int b = bt / tail, t = steps + bt % tail;
    if (u0 + u < H)
      a.y[((size_t)b * T + t) * frame_floats + d * H + u0 + u] = 0.0f;
  }
}

const void* resident_kernel(int G) {
  switch (G) {
    case 1: return (const void*)lstm_resident_kernel<1>;
    case 2: return (const void*)lstm_resident_kernel<2>;
    case 4: return (const void*)lstm_resident_kernel<4>;
    case 8: return (const void*)lstm_resident_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// A block's dynamic shared memory in bytes (ops/lstm.py:lstm_plan's smem).
int radtts_lstm_smem_bytes(int B, int U, int kp, int G) {
  return 4 * layout(B, (B + G - 1) / G * G, U, kp).total;
}

// One launch over D directions of H units, U a block, h kp = H rounded up
// to 4 floats wide (the weight rows too); G the items a warp takes at once.
// lens: int64 (B,) on the device, or null.
int radtts_lstm(const float* img, const float* xproj, const long long* lens,
                float* y, float* hbuf, unsigned int* counters, int B, int T,
                int H, int D, int U, int kp, int G, void* stream) {
  const void* fn = resident_kernel(G);
  if (fn == nullptr || B < 1 || T < 1 || H < 1 || (D != 1 && D != 2)
      || U < 1 || kp != (H + 3) / 4 * 4
      || G < (B < kMaxItems ? B : kMaxItems))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.img = img;
  a.xproj = xproj;
  a.lens = lens;
  a.y = y;
  a.hbuf = hbuf;
  a.counters = counters;
  a.B = B;
  a.T = T;
  a.H = H;
  a.D = D;
  a.U = U;
  a.bpd = (H + U - 1) / U;
  a.kp = kp;
  const int smem = 4 * layout(B, (B + G - 1) / G * G, U, kp).total;
  const int blocks = D * a.bpd;
  if (smem > kMaxSmem
      || cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(kThreads), kargs, (size_t)smem,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
