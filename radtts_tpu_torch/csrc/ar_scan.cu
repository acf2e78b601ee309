// The AGAP's autoregressive flow inverse, one AR step over all frames, fp32,
// for Hopper (sm_90a).
//
// Replaces radtts_tpu/models/attributes.py:ar_step_infer, which the JAX
// package compiles as one lax.scan over frames (not a Pallas kernel). The
// host wrapper is radtts_tpu_torch/ops/ar_scan.py:ar_scan; its plain
// PyTorch version, ar_scan_plain, is the same loop over frames in torch ops.
//
// Per frame t and item b, with state carried from frame to frame (prev = 0
// and every (h, c) = 0 at t = 0):
//   1. the attribute LSTM cell over prev (C -> H);
//   2. the stacked LSTM (L layers) over [h_attr, context]: layer 0's
//      gates are W [h_attr ; h_0] + ctx_proj[b, t], where ctx_proj (the
//      context half of its input projection plus both biases) is one
//      matmul the wrapper makes before the launch; layer l > 0 takes
//      W [h_(l-1) ; h_l] + b;
//   3. the head on the last layer's h: 1x1 convs with relu between them
//      (the spline heads) or two tanh dense layers and a 1x1 (affine);
//   4. the inverse: the quadratic or linear spline inverse of res[b, t] by
//      the head's bins (the JAX package's unbounded_piecewise_quadratic /
//      piecewise_linear_inverse, as SplineAR scales them), or
//      (res - bias) / s; the result is out[b, t] and the next prev.
//
// Two kernels; ops/ar_scan.py:ar_scan_plan picks one by shape.
//
// ar_scan_resident_kernel (the route of every step, split or not):
// one cooperative launch of up to kMaxProblems independent steps (f0's and
// energy's flows), the blocks split between them by weight bytes. Every
// block holds a contiguous slice of each layer's rows (an LSTM unit's four
// gate rows, or a head row) in shared memory, copied once at the start
// with cp.async from an image the wrapper gathers (ops/ar_scan.py:
// resident_pack); after that prologue it reads no weight from global
// memory (~60 KB a block at the published width on 132 blocks, ~120 KB for
// the f0 + energy pair on 66 blocks each). A frame is L + n_head phases
// (6 at the published AGAP), each joined by one handoff: a block writes
// its rows, then one release-add on the phase's monotonic counter; a
// consumer spins on an acquire-load until the count reaches frames x the
// phase's producers (no reset, no generation word), then reads the layer
// with ld.global.cg. The attribute LSTM is off the chain: with layer 0
// each block makes its rows of W_hh_attr . h_attr(t), published with layer
// 0's output; at frame t + 1 every block finishes the attribute cell
// itself (that product, W_ih_attr . prev, the bias; its own c_attr). The
// inverse runs in every block, a warp an item (softmaxes, cdf and bin
// search as warp reductions, scans and a ballot). ctx_proj and res of the
// next frame are prefetched with cp.async a frame ahead. Everything written
// inside the launch is double-buffered by frame parity, and every block
// owns rows of some phase, so no buffer is rewritten before its last
// reader has arrived somewhere later. The kernel is templated on the items
// a warp takes at once (1, 2, 4, 8: by B) and needs H and each head input
// width to be multiples of 4 (float4 reads; ops/ar_scan.py:pad_widths pads
// other widths with zero units and rows, which stay exactly zero).
//
// Split plans (ops/ar_scan.py:problem_plan, route "split"): a step whose
// weights do not fit the blocks' shared memory (H = 1024: ~55 MB against
// ~30 MB on 132 blocks). Each block keeps, in segment order, the whole
// units that fit beside its state; the rest of its units lie in its
// overflow image in global memory, which the wrapper gathers in the same
// layout. A warp reads such a unit's rows with its own float4 loads
// (streamed_w), so a row is summed in the same order wherever it lies. The
// overflow images (32.4 MB at H = 1024) fit the 50 MB L2, and stay there
// from frame to frame without a persisting window. The handoff protocol is
// the same. The split is its own instantiation (SPLIT), so the resident
// kernel keeps its shared-memory loads. Bound:
// the overflow bytes a frame at the L2 rate plus the handoffs, times the
// frames (PERF.md's chain floor of the split route).
//
// ar_scan_kernel (the barrier kernel, which no route names since the split
// plans; ops/ar_scan.py:ar_scan_cuda runs it by name, chip_smoke.py's
// "before"): every block owns a slice of each layer's rows (a warp per
// LSTM unit or head row), reads its weights from global memory (L2) and
// the layer's input from a global scratch, with a grid barrier (one atomic
// counter and a generation word) after each of the 1 + L + n_head phases a
// frame.
//
// handoff_probe_kernel: the resident launch's grid with empty phases,
// joined by the handoff or by the barrier kernel's grid barrier; its time
// is the chain floor.
//
// Bound: 2 * B * T * (MACs a frame; 1.98 M at H = 128 and the 128 -> 256
// -> 512 -> 1024 -> 1024 -> 49 head) FLOP at 67 TFLOP/s fp32, 0.036 ms at
// (1, 608); the bytes floor, the weights once plus res, ctx_proj and out,
// is ~9.2 MB, 0.0027 ms at 3.35 TB/s. Neither bounds the kernels: the
// chain of T x 6 handoffs does. On an H100 (700 W; chip_smoke.py, PERF.md)
// the handoff alone costs ~1.09 us (the barrier kernel's ~1.95 us), a chain
// floor of ~3.98 ms at (1, 608); the resident kernel takes ~10.1 ms
// there (a traced frame ~15.4 us: the handoffs with the wait for the
// slowest producer ~7.5 us, each layer's load from L2 ~2.1 us, the
// inverse ~2.3 us, the rows ~2.7 us), the barrier kernel ~22.7 ms.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

#include "handoff.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 4;     // stacked LSTM layers
constexpr int kMaxHead = 8;       // head layers
constexpr int kGroup = 8;         // items a warp holds in registers at once
constexpr int kMaxBins = 64;      // K of the quadratic spline, b of the linear
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory cap

enum { kQuadratic = 0, kLinear = 1, kAffine = 2 };
enum { kTranslate = 0, kExp = 1, kTanh = 2, kSigmoid = 3 };
enum { kActNone = 0, kActRelu = 1, kActTanh = 2 };
// a head layer's act code may carry kRoundBf16: its kernel is stored in
// bf16 (ops/fold_norms.py:store_conv_weights; the wrapper widens it to
// fp32, exactly), and its input activations are rounded to bf16 (to
// nearest even) before the products, which are summed in fp32, as the JAX
// package's conv1d_apply computes a bf16 kernel on an fp32 input
constexpr int kActMask = 3;
constexpr int kRoundBf16 = 4;

// icfg, the wrapper's int array: these fields, then the per-layer offsets
enum {
  kB, kT, kC, kH, kL, kKind, kScaling, kBins, kNHead, kKmax, kNumScalars
};

struct Args {
  const float* w;
  const float* res;
  const float* ctx;
  float* out;
  float* scratch;
  unsigned int* bar;   // arrivals, generation (zero before the launch)
  int B, T, C, H, L, kind, scaling, n_bins, n_head, kmax;
  int w_lstm[kMaxLayers + 1];   // [0]: the attribute LSTM, [l + 1]: layer l
  int b_lstm[kMaxLayers + 1];   // -1 for layer 0 (its biases are in ctx)
  int w_head[kMaxHead], b_head[kMaxHead], head_in[kMaxHead],
      head_out[kMaxHead], head_act[kMaxHead], act_off[kMaxHead];
  float left, right, bottom, top;
};

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// fp32 -> bf16 (round to nearest even) -> fp32, for finite v
__device__ __forceinline__ float bf16_rne(float v) {
  const unsigned int u = __float_as_uint(v);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Every block waits here until all have arrived. Thread 0 of each block
// arrives on bar[0]; the last to arrive resets it and bumps the generation
// bar[1], which the others spin on; the fences order each block's writes
// before the barrier and its reads after it.
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&bar[0], 1u) == gridDim.x - 1) {
      atomicExch(&bar[0], 0u);
      __threadfence();
      atomicAdd(&bar[1], 1u);
    } else {
      while (*(volatile unsigned int*)&bar[1] == gen) __nanosleep(32);
    }
    __threadfence();
  }
  ++gen;
  __syncthreads();
}

__device__ __forceinline__ float* h_buf(const Args& a, int layer, int par) {
  return a.scratch + (size_t)((layer * 2 + par) * a.B) * a.H;
}

__device__ __forceinline__ float* c_buf(const Args& a, int layer) {
  return a.scratch + (size_t)(2 * (a.L + 1) * a.B) * a.H
         + (size_t)(layer * a.B) * a.H;
}

// xs[b][k] = [first (Ka values, stride sa) ; second (Kb values, stride sb)]
// for every item, from global memory written inside this launch (L2 loads).
__device__ void load_pair(float* xs, const float* first, int Ka, int sa,
                          const float* second, int Kb, int sb, int B) {
  const int K = Ka + Kb;
  for (int i = threadIdx.x; i < B * K; i += blockDim.x) {
    const int b = i / K, k = i - b * K;
    xs[i] = k < Ka ? __ldcg(first + (size_t)b * sa + k)
                   : __ldcg(second + (size_t)b * sb + (k - Ka));
  }
}

// One LSTM layer's cells: warp gw of tw takes units gw, gw + tw, ...; each
// unit's four gate rows (i, f, g, o) of W (4H, K) against xs (B, K). bias
// is the layer's (4H) or null, then ctx (B, T, 4H) at frame t is added.
__device__ void lstm_phase(const Args& a, const float* W, const float* bias,
                           int t, int K, const float* xs, float* h_new,
                           float* c, int gw, int tw, int lane) {
  const int H = a.H, B = a.B;
  for (int j = gw; j < H; j += tw) {
    const float* w0 = W + (size_t)j * K;
    const float* w1 = W + (size_t)(H + j) * K;
    const float* w2 = W + (size_t)(2 * H + j) * K;
    const float* w3 = W + (size_t)(3 * H + j) * K;
    for (int b0 = 0; b0 < B; b0 += kGroup) {
      const int nb = min(kGroup, B - b0);
      float acc[4][kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        acc[0][i] = acc[1][i] = acc[2][i] = acc[3][i] = 0.0f;
      for (int k = lane; k < K; k += 32) {
        const float a0 = __ldg(w0 + k), a1 = __ldg(w1 + k),
                    a2 = __ldg(w2 + k), a3 = __ldg(w3 + k);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < nb) {
            const float x = xs[(b0 + i) * K + k];
            acc[0][i] = fmaf(a0, x, acc[0][i]);
            acc[1][i] = fmaf(a1, x, acc[1][i]);
            acc[2][i] = fmaf(a2, x, acc[2][i]);
            acc[3][i] = fmaf(a3, x, acc[3][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (i < nb) {
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][i] = warp_sum(acc[g][i]);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < nb) {
            const int b = b0 + i;
            float gi = acc[0][i], gf = acc[1][i], gg = acc[2][i],
                  go = acc[3][i];
            if (bias != nullptr) {
              gi += __ldg(bias + j);
              gf += __ldg(bias + H + j);
              gg += __ldg(bias + 2 * H + j);
              go += __ldg(bias + 3 * H + j);
            } else {
              const float* cp = a.ctx + ((size_t)b * a.T + t) * 4 * H;
              gi += __ldg(cp + j);
              gf += __ldg(cp + H + j);
              gg += __ldg(cp + 2 * H + j);
              go += __ldg(cp + 3 * H + j);
            }
            const float cn = sigm(gf) * c[b * H + j] + sigm(gi) * tanhf(gg);
            c[b * H + j] = cn;
            h_new[b * H + j] = sigm(go) * tanhf(cn);
          }
        }
      }
    }
  }
}

// One dense layer: y[b][r] = act(W[r] . xs[b] + bias[r]) for the rows r of
// warp gw of tw.
__device__ void dense_phase(const float* W, const float* bias, int K, int N,
                            int act, const float* xs, float* y, int B,
                            int gw, int tw, int lane) {
  for (int r = gw; r < N; r += tw) {
    const float* wr = W + (size_t)r * K;
    for (int b0 = 0; b0 < B; b0 += kGroup) {
      const int nb = min(kGroup, B - b0);
      float acc[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = 0.0f;
      if ((K & 3) == 0) {
        for (int k = lane * 4; k < K; k += 128) {
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(wr + k));
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            if (i < nb) {
              const float4 x4 =
                  *reinterpret_cast<const float4*>(xs + (b0 + i) * K + k);
              acc[i] = fmaf(w4.x, x4.x, acc[i]);
              acc[i] = fmaf(w4.y, x4.y, acc[i]);
              acc[i] = fmaf(w4.z, x4.z, acc[i]);
              acc[i] = fmaf(w4.w, x4.w, acc[i]);
            }
          }
        }
      } else {
        for (int k = lane; k < K; k += 32) {
          const float wk = __ldg(wr + k);
#pragma unroll
          for (int i = 0; i < kGroup; ++i)
            if (i < nb) acc[i] = fmaf(wk, xs[(b0 + i) * K + k], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (i < nb) acc[i] = warp_sum(acc[i]);
      if (lane == 0) {
        const float bv = __ldg(bias + r);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < nb) {
            float v = acc[i] + bv;
            if (act == kActRelu) v = fmaxf(v, 0.0f);
            else if (act == kActTanh) v = tanhf(v);
            y[(size_t)(b0 + i) * N + r] = v;
          }
        }
      }
    }
  }
}

// radtts_tpu/ops/splines.py:unbounded_piecewise_quadratic(inverse=True) of
// one value x, bins wt (K) and vt (K + 1), on [0, 1), as the port's
// ops/splines.py computes it.
__device__ float quadratic_inverse(const float* wt, const float* vt, int K,
                                   float x) {
  const float eps = FLT_EPSILON;
  const bool inside = x >= 0.0f && x < 1.0f;
  const float xn = fminf(fmaxf(x, 0.0f), 1.0f - eps);
  float w[kMaxBins], v[kMaxBins + 1];
  float m = -FLT_MAX;
  for (int k = 0; k < K; ++k) m = fmaxf(m, wt[k]);
  float s = 0.0f;
  for (int k = 0; k < K; ++k) {
    w[k] = expf(wt[k] - m);
    s += w[k];
  }
  for (int k = 0; k < K; ++k) w[k] /= s;
  float mv = -FLT_MAX;
  for (int k = 0; k <= K; ++k) mv = fmaxf(mv, vt[k]);
  for (int k = 0; k <= K; ++k) v[k] = expf(vt[k] - mv) + 1e-8f;
  float vs = 0.0f;
  for (int k = 0; k < K; ++k) vs += (v[k] + v[k + 1]) / 2 * w[k];
  for (int k = 0; k <= K; ++k) v[k] /= vs;
  // the bin: the count of cdf edges below xn (the last edge is 1)
  int cnt = 0;
  float cdf = 0.0f;
  for (int k = 0; k < K; ++k) {
    cdf += (v[k + 1] + v[k]) / 2 * w[k];
    const float edge = k == K - 1 ? 1.0f : cdf;
    cnt += edge < xn;
  }
  const int bin = min(cnt, K - 1);
  float cdf_bn1 = 0.0f, w_bn1 = 0.0f;
  for (int k = 0; k < bin; ++k) {
    cdf_bn1 += (v[k + 1] + v[k]) / 2 * w[k];
    w_bn1 += w[k];
  }
  const float w_b = w[bin], v_b = v[bin], v_bp1 = v[bin + 1];
  const float qa = (v_bp1 - v_b) * w_b / 2;
  const float qb = v_b * w_b;
  const float qc = cdf_bn1 - xn;
  const float sq = sqrtf(fmaxf(qb * qb - 4 * qa * qc, 0.0f));
  // the larger root in its cancellation-free form (ops/splines.py)
  const float alpha = fabsf(qa) < 1e-12f ? -qc / fmaxf(qb, eps)
                                         : -2 * qc / fmaxf(qb + sq, eps);
  const float y = fminf(fmaxf(alpha * w_b + w_bn1, eps), 1.0f - eps);
  return inside ? y : x;
}

// radtts_tpu/ops/splines.py:piecewise_linear_inverse of one value y by its
// b bins qt.
__device__ float linear_inverse(const float* qt, int nb, float y) {
  const float eps = FLT_EPSILON;
  const float w = 1.0f / nb;
  float q[kMaxBins];
  float m = -FLT_MAX;
  for (int k = 0; k < nb; ++k) m = fmaxf(m, qt[k]);
  float s = 0.0f;
  for (int k = 0; k < nb; ++k) {
    q[k] = expf(qt[k] - m);
    s += q[k];
  }
  for (int k = 0; k < nb; ++k) q[k] = q[k] / s / w;
  // the first bin of least gap y - left edge, a negative gap counting 2
  int edge = 0;
  float best = FLT_MAX, left = 0.0f, left_edge = 0.0f, run = 0.0f;
  for (int k = 0; k < nb; ++k) {
    left = run * w;
    float gap = y - left;
    if (gap < 0.0f) gap = 2.0f;
    if (gap < best) {
      best = gap;
      edge = k;
      left_edge = left;
    }
    run += q[k];
  }
  float x = (y - left_edge) / q[edge] + edge * w;
  x = fminf(fmaxf(x, eps), 1.0f - eps);
  return (y < 0.0f || y > 1.0f) ? y : x;
}

__device__ float affine_inverse(float r, float scale, float bias,
                                int scaling) {
  float s = 1.0f;
  if (scaling == kExp) s = expf(scale);
  else if (scaling == kTanh) s = tanhf(scale) + 1.0f + 1e-6f;
  else if (scaling == kSigmoid) s = sigm(scale + 10.0f) + 1e-6f;
  return (r - bias) / s;
}

__global__ void __launch_bounds__(kThreads)
ar_scan_kernel(Args a) {
  unsigned int gen = 0;
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, C = a.C, H = a.H, L = a.L;
  const int nq = a.head_out[a.n_head - 1];
  float* xs = smem;                        // (B, kmax)
  float* prev = xs + (size_t)B * a.kmax;   // (B, C)
  float* qs = prev + (size_t)B * C;        // (B, nq)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int gw = blockIdx.x * nwarps + warp, tw = gridDim.x * nwarps;

  for (int i = threadIdx.x; i < B * C; i += blockDim.x) prev[i] = 0.0f;
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    // 1. the attribute LSTM over [prev ; h_attr]
    {
      const float* hold = h_buf(a, 0, cur);
      const int K = C + H;
      for (int i = threadIdx.x; i < B * K; i += blockDim.x) {
        const int b = i / K, k = i - b * K;
        xs[i] = k < C ? prev[b * C + k] : __ldcg(hold + b * H + (k - C));
      }
      __syncthreads();
      lstm_phase(a, a.w + a.w_lstm[0], a.w + a.b_lstm[0], t, K, xs,
                 h_buf(a, 0, nxt), c_buf(a, 0), gw, tw, lane);
      grid_barrier(a.bar, gen);
    }
    // 2. the stacked LSTM over [h below ; own h]
    for (int l = 1; l <= L; ++l) {
      load_pair(xs, h_buf(a, l - 1, nxt), H, H, h_buf(a, l, cur), H, H, B);
      __syncthreads();
      lstm_phase(a, a.w + a.w_lstm[l],
                 a.b_lstm[l] < 0 ? nullptr : a.w + a.b_lstm[l], t, 2 * H,
                 xs, h_buf(a, l, nxt), c_buf(a, l), gw, tw, lane);
      grid_barrier(a.bar, gen);
    }
    // 3. the head
    const float* src = h_buf(a, L, nxt);
    for (int k = 0; k < a.n_head; ++k) {
      const int K = a.head_in[k], N = a.head_out[k];
      load_pair(xs, src, K, K, src, 0, 0, B);
      __syncthreads();
      if (a.head_act[k] & kRoundBf16) {
        for (int i = threadIdx.x; i < B * K; i += blockDim.x)
          xs[i] = bf16_rne(xs[i]);
        __syncthreads();
      }
      float* y = a.scratch + a.act_off[k];
      dense_phase(a.w + a.w_head[k], a.w + a.b_head[k], K, N,
                  a.head_act[k] & kActMask, xs, y, B, gw, tw, lane);
      grid_barrier(a.bar, gen);
      src = y;
    }
    // 4. the inverse, in every block
    for (int i = threadIdx.x; i < B * nq; i += blockDim.x)
      qs[i] = __ldcg(src + i);
    __syncthreads();
    for (int i = threadIdx.x; i < B * C; i += blockDim.x) {
      const int b = i / C, c = i - b * C;
      const float r = __ldg(a.res + ((size_t)b * a.T + t) * C + c);
      const float* q = qs + (size_t)b * nq;
      float o;
      if (a.kind == kAffine) {
        o = affine_inverse(r, q[c], q[C + c], a.scaling);
      } else {
        const float z = (r - a.bottom) / (a.top - a.bottom);
        const float* qc = q + (size_t)c * a.n_bins;
        const float y =
            a.kind == kQuadratic
                ? quadratic_inverse(qc, qc + a.n_bins / 2, a.n_bins / 2, z)
                : linear_inverse(qc, a.n_bins, z);
        o = y * (a.right - a.left) + a.left;
      }
      prev[i] = o;
      if (blockIdx.x == 0) a.out[((size_t)b * a.T + t) * C + c] = o;
    }
    __syncthreads();
  }
}

int smem_bytes(int B, int C, int kmax, int nq) {
  return (int)(sizeof(float) * ((size_t)B * kmax + (size_t)B * C
                                + (size_t)B * nq));
}


// ---------------------------------------------------------------------------
// The resident kernel (the default route): weights in shared memory, one
// release/acquire handoff a phase, the attribute LSTM in every block, and
// several independent problems (f0's and energy's flows) in one launch.
// ---------------------------------------------------------------------------

constexpr int kResThreads = 512;
constexpr int kMaxProblems = 4;
// a block's slices: the common part (the attribute LSTM's input weights and
// bias), the attribute LSTM's recurrent rows, each stacked layer, each head
// layer; eight ints each: first unit or row, count, weight and bias offsets
// (floats from the start of shared memory), then the split: the units kept
// in shared memory (the first n_res of the slice) and the offset of the
// others in the block's overflow image (floats; ops/ar_scan.py:
// problem_plan)
constexpr int kMaxSegs = 2 + kMaxLayers + kMaxHead;
constexpr int kSegInts = 6;
enum { sFirst, sCount, sW, sB, sRes, sOvf };
constexpr int kMaxPhases = kMaxLayers + kMaxHead;
enum { kSegCommon = 0, kSegAttr = 1, kSegLayer0 = 2 };

// one problem's ints, as ops/ar_scan.py:resident_config writes them
enum {
  rB, rT, rC, rH, rL, rKind, rScaling, rBins, rNHead, rBlock0, rBlocks,
  rImgStride, rOffHs, rOffCattr, rOffCown, rOffXs, rOffQs, rOffPrev, rOffCtx,
  rOffRes, rOffImg, rCmax, rOvfStride, rNumScalars
};
constexpr int kResInts =
    rNumScalars + kMaxSegs + 4 * kMaxHead + kMaxPhases;
constexpr int kResPtrs = 10;

struct Problem {
  const float* res;        // (B, T, C)
  const float* ctx;        // (B, T, 4H): layer 0's context half and biases
  float* out;              // (B, T, C)
  const float* img;        // blocks x img_stride: each block's weights
  const float* ovf;        // blocks x ovf_stride: the rows not kept (split)
  const int* table;        // blocks x kMaxSegs x kSegInts
  float* hbuf;             // L x 2 x B x H: each layer's h, by frame parity
  float* apbuf;            // 2 x B x 4H: W_hh_attr . h_attr, by parity
  float* actbuf;           // head layer k at act_off[k]: 2 x B x N_k
  unsigned int* counters;  // one a phase, zero before the launch
  int B, T, C, H, L, kind, scaling, n_bins, n_head, block0, blocks;
  int img_stride, off_hs, off_cattr, off_cown, off_xs, off_qs, off_prev,
      off_ctx, off_res, off_img, cmax, ovf_stride;
  int ld[kMaxSegs];
  int head_in[kMaxHead], head_out[kMaxHead], head_act[kMaxHead],
      act_off[kMaxHead];
  int producers[kMaxPhases];   // blocks that own rows of each phase
  float left, right, bottom, top;
};

// the optional trace: block trace_block's %globaltimer (ns) at each phase
// boundary of the first kTraceFrames frames, kStamps a frame: the frame's
// start, the attribute LSTM done, then for each phase its rows done, its
// handoff done and its input loaded, and last the inverse done
constexpr int kTraceFrames = 1024;
constexpr int kStamps = 3 + 3 * kMaxPhases;

struct ResidentArgs {
  Problem p[kMaxProblems];
  int n;
  unsigned long long* trace;   // kTraceFrames x kStamps, or null
  int trace_block;
};

__device__ __forceinline__ void stamp(const ResidentArgs& args, int t,
                                      int k) {
  if (args.trace != nullptr && (int)blockIdx.x == args.trace_block
      && threadIdx.x == 0 && t < kTraceFrames) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    args.trace[t * kStamps + k] = ns;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// inclusive prefix sums over the 64 slots k = lane (a0) and k = lane + 32
// (a1)
__device__ __forceinline__ void warp_scan2(float a0, float a1, int lane,
                                           float& s0, float& s1) {
  s0 = a0;
  s1 = a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t0 = __shfl_up_sync(0xffffffffu, s0, o);
    const float t1 = __shfl_up_sync(0xffffffffu, s1, o);
    if (lane >= o) {
      s0 += t0;
      s1 += t1;
    }
  }
  s1 += __shfl_sync(0xffffffffu, s0, 31);
}

__device__ __forceinline__ float pick(float v0, float v1, int k) {
  return __shfl_sync(0xffffffffu, k < 32 ? v0 : v1, k & 31);
}

// quadratic_inverse across one warp: bin k on lane k & 31 (K <= 64), the
// softmaxes and the cdf as warp reductions and scans, the bin by a ballot.
// The same function in another summation order.
__device__ float quadratic_inverse_warp(const float* wt, const float* vt,
                                        int K, float x, int lane) {
  const float eps = FLT_EPSILON;
  const bool inside = x >= 0.0f && x < 1.0f;
  const float xn = fminf(fmaxf(x, 0.0f), 1.0f - eps);
  const int k0 = lane, k1 = lane + 32;
  const bool in0 = k0 < K, in1 = k1 < K;
  const float m = warp_max(fmaxf(in0 ? wt[k0] : -FLT_MAX,
                                 in1 ? wt[k1] : -FLT_MAX));
  float w0 = in0 ? expf(wt[k0] - m) : 0.0f;
  float w1 = in1 ? expf(wt[k1] - m) : 0.0f;
  const float s = warp_sum(w0 + w1);
  w0 /= s;
  w1 /= s;
  float mv = -FLT_MAX;
  for (int k = lane; k <= K; k += 32) mv = fmaxf(mv, vt[k]);
  mv = warp_max(mv);
  // v at each bin's two vertices
  float v0 = 0.0f, v0n = 0.0f, v1 = 0.0f, v1n = 0.0f;
  if (in0) {
    v0 = expf(vt[k0] - mv) + 1e-8f;
    v0n = expf(vt[k0 + 1] - mv) + 1e-8f;
  }
  if (in1) {
    v1 = expf(vt[k1] - mv) + 1e-8f;
    v1n = expf(vt[k1 + 1] - mv) + 1e-8f;
  }
  const float vs = warp_sum((v0 + v0n) / 2 * w0 + (v1 + v1n) / 2 * w1);
  v0 /= vs;
  v0n /= vs;
  v1 /= vs;
  v1n /= vs;
  const float area0 = (v0n + v0) / 2 * w0, area1 = (v1n + v1) / 2 * w1;
  float cdf0, cdf1, wc0, wc1;
  warp_scan2(area0, area1, lane, cdf0, cdf1);
  warp_scan2(w0, w1, lane, wc0, wc1);
  // the bin: the count of cdf edges below xn (the last edge is 1)
  const bool below0 = in0 && (k0 == K - 1 ? 1.0f : cdf0) < xn;
  const bool below1 = in1 && (k1 == K - 1 ? 1.0f : cdf1) < xn;
  const int cnt = __popc(__ballot_sync(0xffffffffu, below0))
                  + __popc(__ballot_sync(0xffffffffu, below1));
  const int bin = min(cnt, K - 1);
  const float w_b = pick(w0, w1, bin), v_b = pick(v0, v1, bin),
              v_bp1 = pick(v0n, v1n, bin);
  const float cdf_bn1 = pick(cdf0 - area0, cdf1 - area1, bin);
  const float w_bn1 = pick(wc0 - w0, wc1 - w1, bin);
  const float qa = (v_bp1 - v_b) * w_b / 2;
  const float qb = v_b * w_b;
  const float qc = cdf_bn1 - xn;
  const float sq = sqrtf(fmaxf(qb * qb - 4 * qa * qc, 0.0f));
  const float alpha = fabsf(qa) < 1e-12f ? -qc / fmaxf(qb, eps)
                                         : -2 * qc / fmaxf(qb + sq, eps);
  const float y = fminf(fmaxf(alpha * w_b + w_bn1, eps), 1.0f - eps);
  return inside ? y : x;
}

// linear_inverse across one warp (nb <= 64 bins)
__device__ float linear_inverse_warp(const float* qt, int nb, float y,
                                     int lane) {
  const float eps = FLT_EPSILON;
  const float w = 1.0f / nb;
  const int k0 = lane, k1 = lane + 32;
  const bool in0 = k0 < nb, in1 = k1 < nb;
  const float m = warp_max(fmaxf(in0 ? qt[k0] : -FLT_MAX,
                                 in1 ? qt[k1] : -FLT_MAX));
  float q0 = in0 ? expf(qt[k0] - m) : 0.0f;
  float q1 = in1 ? expf(qt[k1] - m) : 0.0f;
  const float s = warp_sum(q0 + q1);
  q0 = q0 / s / w;
  q1 = q1 / s / w;
  float r0, r1;
  warp_scan2(q0, q1, lane, r0, r1);
  const float left0 = (r0 - q0) * w, left1 = (r1 - q1) * w;
  // the first bin of least gap y - left edge, a negative gap counting 2
  float g0 = y - left0, g1 = y - left1;
  if (g0 < 0.0f) g0 = 2.0f;
  if (g1 < 0.0f) g1 = 2.0f;
  float best = in0 ? g0 : FLT_MAX;
  int edge = k0;
  if (in1 && g1 < best) {
    best = g1;
    edge = k1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oe = __shfl_xor_sync(0xffffffffu, edge, o);
    if (ob < best || (ob == best && oe < edge)) {
      best = ob;
      edge = oe;
    }
  }
  const float left_edge = pick(left0, left1, edge);
  const float q_e = pick(q0, q1, edge);
  float x = (y - left_edge) / q_e + edge * w;
  x = fminf(fmaxf(x, eps), 1.0f - eps);
  return (y < 0.0f || y > 1.0f) ? y : x;
}

// acc[r][i] = W[r] . x_i for NR rows of W (stride ldw) and the items
// b0 + i, i < nb <= G, x_i = [xa + (b0 + i) lda (Ka values) ; xb + (b0 + i)
// ldb (Kb values)], every operand in shared memory and every width and
// stride a multiple of 4 (ar_scan_plan routes other shapes to the
// barrier kernel); lanes split k in float4s, then a butterfly completes
// each sum in every lane. RND: each x value rounded to bf16 first.
template <int NR, int G, bool RND = false>
__device__ __forceinline__ void dot_rows(const float* W, int ldw,
                                         const float* xa, int Ka, int lda,
                                         const float* xb, int Kb, int ldb,
                                         int b0, int nb, int lane,
                                         float (&acc)[NR][G]) {
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < G; ++i) acc[r][i] = 0.0f;
  const int K = Ka + Kb;
#pragma unroll 2
  for (int k = lane * 4; k < K; k += 128) {
    const bool first = k < Ka;
    const float* xp = first ? xa + k : xb + (k - Ka);
    const int ld = first ? lda : ldb;
    float4 w4[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      w4[r] = *reinterpret_cast<const float4*>(W + r * ldw + k);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (G == 1 || i < nb) {
        float4 x4 = *reinterpret_cast<const float4*>(xp + (b0 + i) * ld);
        if (RND)
          x4 = make_float4(bf16_rne(x4.x), bf16_rne(x4.y), bf16_rne(x4.z),
                           bf16_rne(x4.w));
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          acc[r][i] = fmaf(w4[r].x, x4.x, acc[r][i]);
          acc[r][i] = fmaf(w4[r].y, x4.y, acc[r][i]);
          acc[r][i] = fmaf(w4[r].z, x4.z, acc[r][i]);
          acc[r][i] = fmaf(w4[r].w, x4.w, acc[r][i]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int i = 0; i < G; ++i) acc[r][i] = warp_sum(acc[r][i]);
}

__device__ __forceinline__ float lstm_cell(float gi, float gf, float gg,
                                           float go, float& c) {
  c = sigm(gf) * c + sigm(gi) * tanhf(gg);
  return sigm(go) * tanhf(c);
}

// Unit (or head row) k of the block's slice sl, unit_floats floats each,
// lies in shared memory (the first n_res, in the block's image) or in the
// block's overflow image in global memory (L2), which the lanes read with
// their own float4 loads. Both hold the same values in the same layout, so
// dot_rows sums a row in one order wherever it lies. The callers branch on
// is_kept and call dot_rows with kept_w's or streamed_w's pointer, so that
// the kept rows' loads stay shared-memory loads (a pointer that may be
// either would make every load a generic one).
__device__ __forceinline__ bool is_kept(const int* sl, int k) {
  return k < sl[sRes];
}

__device__ __forceinline__ const float* kept_w(const int* sl, float* smem,
                                               int k, int unit_floats) {
  return smem + sl[sW] + k * unit_floats;
}

__device__ __forceinline__ const float* streamed_w(const int* sl,
                                                   const float* ovf, int k,
                                                   int unit_floats) {
  return ovf + sl[sOvf] + (size_t)(k - sl[sRes]) * unit_floats;
}

// ctx[b, t] of the block's layer-0 units and res[b, t] into shared slot
// `slot`, as cp.async copies that the next frame's top waits for
__device__ __forceinline__ void prefetch_frame(const Problem& a,
                                               const int* seg, float* smem,
                                               int t, int slot) {
  if (t >= a.T) return;
  const int B = a.B, H = a.H;
  const int u0 = seg[kSegLayer0 * kSegInts + sFirst],
            cnt = seg[kSegLayer0 * kSegInts + sCount];
  float* cs = smem + a.off_ctx + slot * a.cmax * 4 * B;
  for (int i = threadIdx.x; i < cnt * 4 * B; i += blockDim.x) {
    const int ug = i / B, b = i - ug * B;
    cp_async4(cs + i, a.ctx + ((size_t)b * a.T + t) * 4 * H
                          + (ug & 3) * H + u0 + (ug >> 2));
  }
  float* rs = smem + a.off_res + slot * B * a.C;
  for (int i = threadIdx.x; i < B * a.C; i += blockDim.x) {
    const int b = i / a.C, c = i - b * a.C;
    cp_async4(rs + i, a.res + ((size_t)b * a.T + t) * a.C + c);
  }
}

// NG: items a warp takes at once (1, 2, 4 or 8, by B); SPLIT: a split
// plan's launch (some rows streamed; the unsplit kernel compiles none of
// the split's code)
template <int NG, bool SPLIT>
__global__ void __launch_bounds__(kResThreads, 1)
ar_scan_resident_kernel(const __grid_constant__ ResidentArgs args) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int seg[kMaxSegs * kSegInts];
  // the block's problem, copied once: a parameter read at a varying index
  // is a constant-cache load on every use
  __shared__ Problem a;
  if (threadIdx.x == 0) {
    int pi = 0;
    while (pi + 1 < args.n && (int)blockIdx.x >= args.p[pi + 1].block0)
      ++pi;
    a = args.p[pi];
  }
  __syncthreads();
  const int lb = blockIdx.x - a.block0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int B = a.B, C = a.C, H = a.H, L = a.L, T = a.T, G = 4 * H;
  const int nq = a.head_out[a.n_head - 1];
  // the block's overflow image: its rows not kept in shared memory (a
  // split plan)
  const float* ovf = a.ovf + (size_t)lb * a.ovf_stride;

  // prologue: the block's slice table, zero state, then its weights (once)
  for (int i = tid; i < kMaxSegs * kSegInts; i += blockDim.x)
    seg[i] = a.table[(size_t)lb * kMaxSegs * kSegInts + i];
  for (int i = tid; i < a.off_img; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  {
    const float* src = a.img + (size_t)lb * a.img_stride;
    float* dst = smem + a.off_img;
    for (int i = tid * 4; i < a.img_stride; i += blockDim.x * 4)
      cp_async16(dst + i, src + i);
  }
  prefetch_frame(a, seg, smem, 0, 0);

  float* hs = smem + a.off_hs;        // (L + 1) x B x H: h_attr, each layer
  float* cattr = smem + a.off_cattr;  // B x H
  float* cown = smem + a.off_cown;    // L x cmax x B: the block's units' c
  float* xs = smem + a.off_xs;        // B x xmax: a head input, W_hh_attr.h
  float* qs = smem + a.off_qs;        // B x nq: the head's output
  float* prev = smem + a.off_prev;    // B x C
  const float* w_ih_attr = smem + seg[kSegCommon * kSegInts + sW];  // 4H x C
  const float* b_attr = smem + seg[kSegCommon * kSegInts + sB];     // 4H

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    cp_async_wait_all();
    __syncthreads();
    stamp(args, t, 0);
    prefetch_frame(a, seg, smem, t + 1, par ^ 1);
    // 1. the attribute LSTM, every unit and item, in every block:
    //    W_hh_attr . h_attr(t - 1) (xs, published with layer 0's output the
    //    frame before; 0 at t = 0) + W_ih_attr . prev + bias
    for (int i = tid; i < B * H; i += blockDim.x) {
      const int b = i / H, j = i - b * H;
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = q * H + j;
        float v = xs[b * G + r] + b_attr[r];
        for (int c = 0; c < C; ++c)
          v = fmaf(w_ih_attr[r * C + c], prev[b * C + c], v);
        g[q] = v;
      }
      hs[i] = lstm_cell(g[0], g[1], g[2], g[3], cattr[i]);
    }
    __syncthreads();
    stamp(args, t, 1);
    // 2. the stacked LSTM: the block's units of layer l over [h below ;
    //    own h]; with layer 0, the block's rows of W_hh_attr . h_attr(t)
    for (int l = 0; l < L; ++l) {
      const int* sl = seg + (kSegLayer0 + l) * kSegInts;
      const int* sa = seg + kSegAttr * kSegInts;
      const int u0 = sl[sFirst], cnt = sl[sCount], ldw = a.ld[kSegLayer0 + l];
      const int na = l == 0 ? sa[sCount] : 0;
      const float* x_in = hs + l * B * H;
      const float* h_old = hs + (l + 1) * B * H;
      float* hout = a.hbuf + (size_t)(l * 2 + par) * B * H;
      for (int item = warp; item < cnt + na; item += nw) {
        const bool unit = item < cnt;
        const int k = unit ? item : item - cnt;
        const int* su = unit ? sl : sa;
        const int uf = 4 * (unit ? ldw : a.ld[kSegAttr]);
        const bool kept = !SPLIT || is_kept(su, k);
        for (int b0 = 0; b0 < B; b0 += NG) {
          const int nb = min(NG, B - b0);
          float acc[4][NG];
          auto dots = [&](const float* W) {
            if (unit)
              dot_rows<4, NG>(W, ldw, x_in, H, H, h_old, H, H, b0, nb, lane,
                             acc);
            else
              dot_rows<4, NG>(W, a.ld[kSegAttr], hs, H, H, hs, 0, H, b0,
                             nb, lane, acc);
          };
          if (kept)
            dots(kept_w(su, smem, k, uf));
          else
            dots(streamed_w(su, ovf, k, uf));
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            if (i < nb && lane == i) {
              const int b = b0 + i;
              if (unit) {
                float g[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  g[q] = acc[q][i]
                         + (l == 0 ? smem[a.off_ctx
                                          + par * a.cmax * 4 * B
                                          + (k * 4 + q) * B + b]
                                   : smem[sl[sB] + k * 4 + q]);
                float& c = cown[(l * a.cmax + k) * B + b];
                hout[b * H + u0 + k] = lstm_cell(g[0], g[1], g[2], g[3], c);
              } else {
                float* ap = a.apbuf + (size_t)par * B * G + b * G
                            + sa[sFirst] + k;
#pragma unroll
                for (int q = 0; q < 4; ++q) ap[q * H] = acc[q][i];
              }
            }
          }
        }
      }
      stamp(args, t, 2 + 3 * l);
      handoff(a.counters + l, cnt + na > 0,
              (unsigned int)(t + 1) * a.producers[l]);
      stamp(args, t, 3 + 3 * l);
      for (int i = tid; i < B * H; i += blockDim.x)
        hs[(l + 1) * B * H + i] = __ldcg(hout + i);
      __syncthreads();
      stamp(args, t, 4 + 3 * l);
    }
    // 3. the head: the block's rows of each layer
    for (int k = 0; k < a.n_head; ++k) {
      const int* sk = seg + (kSegLayer0 + L + k) * kSegInts;
      const int r0 = sk[sFirst], cnt = sk[sCount],
                ldw = a.ld[kSegLayer0 + L + k];
      const int K = a.head_in[k], N = a.head_out[k];
      const int act = a.head_act[k] & kActMask;
      const bool rnd = a.head_act[k] & kRoundBf16;
      const float* x = k == 0 ? hs + L * B * H : xs;
      float* y = a.actbuf + a.act_off[k] + (size_t)par * B * N;
      for (int r = warp; r < cnt; r += nw) {
        const bool kept = !SPLIT || is_kept(sk, r);
        for (int b0 = 0; b0 < B; b0 += NG) {
          const int nb = min(NG, B - b0);
          float acc[1][NG];
          auto dots = [&](const float* W) {
            if (rnd)
              dot_rows<1, NG, true>(W, ldw, x, K, K, x, 0, K, b0, nb, lane,
                                    acc);
            else
              dot_rows<1, NG>(W, ldw, x, K, K, x, 0, K, b0, nb, lane, acc);
          };
          if (kept)
            dots(kept_w(sk, smem, r, ldw));
          else
            dots(streamed_w(sk, ovf, r, ldw));
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            if (i < nb && lane == i) {
              float v = acc[0][i] + smem[sk[sB] + r];
              if (act == kActRelu) v = fmaxf(v, 0.0f);
              else if (act == kActTanh) v = tanhf(v);
              y[(b0 + i) * N + r0 + r] = v;
            }
          }
        }
      }
      stamp(args, t, 2 + 3 * (L + k));
      handoff(a.counters + L + k, cnt > 0,
              (unsigned int)(t + 1) * a.producers[L + k]);
      stamp(args, t, 3 + 3 * (L + k));
      if (k + 1 < a.n_head) {
        for (int i = tid; i < B * N; i += blockDim.x) xs[i] = __ldcg(y + i);
      } else {
        const float* ap = a.apbuf + (size_t)par * B * G;
        for (int i = tid; i < B * nq; i += blockDim.x) qs[i] = __ldcg(y + i);
        for (int i = tid; i < B * G; i += blockDim.x) xs[i] = __ldcg(ap + i);
      }
      __syncthreads();
      stamp(args, t, 4 + 3 * (L + k));
    }
    // 4. the inverse, in every block (a warp an item for the splines)
    const float* rs = smem + a.off_res + par * B * C;
    if (a.kind == kAffine) {
      for (int i = tid; i < B * C; i += blockDim.x) {
        const int b = i / C, c = i - b * C;
        const float* q = qs + b * nq;
        const float o = affine_inverse(rs[i], q[c], q[C + c], a.scaling);
        prev[i] = o;
        if (lb == 0) a.out[((size_t)b * T + t) * C + c] = o;
      }
    } else {
      for (int i = warp; i < B * C; i += nw) {
        const int b = i / C, c = i - b * C;
        const float* q = qs + b * nq + c * a.n_bins;
        const float z = (rs[i] - a.bottom) / (a.top - a.bottom);
        const float yv =
            a.kind == kQuadratic
                ? quadratic_inverse_warp(q, q + a.n_bins / 2, a.n_bins / 2,
                                         z, lane)
                : linear_inverse_warp(q, a.n_bins, z, lane);
        if (lane == 0) {
          const float o = yv * (a.right - a.left) + a.left;
          prev[i] = o;
          if (lb == 0) a.out[((size_t)b * T + t) * C + c] = o;
        }
      }
    }
    stamp(args, t, 2 + 3 * (L + a.n_head));
  }
}

const void* resident_kernel(int G, bool split) {
  switch (G) {
    case 1: return split ? (const void*)ar_scan_resident_kernel<1, true>
                         : (const void*)ar_scan_resident_kernel<1, false>;
    case 2: return split ? (const void*)ar_scan_resident_kernel<2, true>
                         : (const void*)ar_scan_resident_kernel<2, false>;
    case 4: return split ? (const void*)ar_scan_resident_kernel<4, true>
                         : (const void*)ar_scan_resident_kernel<4, false>;
    case 8: return split ? (const void*)ar_scan_resident_kernel<8, true>
                         : (const void*)ar_scan_resident_kernel<8, false>;
    default: return nullptr;
  }
}

// The handoff alone: the same grid and shared memory as a launch of the
// resident kernel, T x n_phases empty phases joined by the handoff (mode 0)
// or by the barrier kernel's grid barrier (mode 1). Its time is the chain's
// floor.
__global__ void __launch_bounds__(kResThreads, 1)
handoff_probe_kernel(unsigned int* counters, int n_phases, int T, int mode) {
  unsigned int gen = 0;
  for (int t = 0; t < T; ++t) {
    for (int p = 0; p < n_phases; ++p) {
      if (mode == 0)
        handoff(counters + 2 + p, true, (unsigned int)(t + 1) * gridDim.x);
      else
        grid_barrier(counters, gen);
    }
  }
}

}  // namespace

extern "C" {

// Blocks that can be resident at once (the cooperative launch's limit) for
// this many bytes of shared memory, or 0 if a block cannot take them.
int radtts_ar_scan_max_blocks(int smem) {
  if (smem > kMaxSmem) return 0;
  if (cudaFuncSetAttribute(ar_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ar_scan_kernel,
                                                    kThreads, smem)
      != cudaSuccess)
    return 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm * sms;
}

int radtts_ar_scan_smem_bytes(int B, int C, int kmax, int nq) {
  return smem_bytes(B, C, kmax, nq);
}

// icfg: the kNumScalars fields, then w_lstm[kMaxLayers + 1],
// b_lstm[kMaxLayers + 1], w_head, b_head, head_in, head_out, head_act,
// act_off (kMaxHead each); fcfg: left, right, bottom, top.
int radtts_ar_scan(const float* w, const float* res, const float* ctx,
                   float* out, float* scratch, unsigned int* bar,
                   const int* icfg, const float* fcfg, int blocks,
                   void* stream) {
  Args a;
  a.w = w;
  a.res = res;
  a.ctx = ctx;
  a.out = out;
  a.scratch = scratch;
  a.bar = bar;
  a.B = icfg[kB];
  a.T = icfg[kT];
  a.C = icfg[kC];
  a.H = icfg[kH];
  a.L = icfg[kL];
  a.kind = icfg[kKind];
  a.scaling = icfg[kScaling];
  a.n_bins = icfg[kBins];
  a.n_head = icfg[kNHead];
  a.kmax = icfg[kKmax];
  if (a.L < 1 || a.L > kMaxLayers || a.n_head < 1 || a.n_head > kMaxHead)
    return (int)cudaErrorInvalidValue;
  const int* p = icfg + kNumScalars;
  for (int i = 0; i <= kMaxLayers; ++i) a.w_lstm[i] = *p++;
  for (int i = 0; i <= kMaxLayers; ++i) a.b_lstm[i] = *p++;
  int* heads[6] = {a.w_head, a.b_head, a.head_in, a.head_out, a.head_act,
                   a.act_off};
  for (int f = 0; f < 6; ++f)
    for (int i = 0; i < kMaxHead; ++i) heads[f][i] = *p++;
  a.left = fcfg[0];
  a.right = fcfg[1];
  a.bottom = fcfg[2];
  a.top = fcfg[3];
  const int bins = a.kind == kQuadratic ? a.n_bins / 2 : a.n_bins;
  if (a.kind != kAffine && (bins < 1 || bins > kMaxBins))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(a.B, a.C, a.kmax, a.head_out[a.n_head - 1]);
  const int max_blocks = radtts_ar_scan_max_blocks(smem);
  if (blocks < 1 || blocks > max_blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)ar_scan_kernel, dim3(blocks), dim3(kThreads), args,
      (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"

extern "C" {

// Blocks of the resident kernel (item group G, split or not) that can be
// resident at once with this much dynamic shared memory, or 0 if a block
// cannot take it.
int radtts_ar_scan_resident_max_blocks(int smem, int G, int split) {
  const void* fn = resident_kernel(G, split != 0);
  if (fn == nullptr
      || cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem) != cudaSuccess)
    return 0;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kResThreads,
                                                    smem)
      != cudaSuccess)
    return 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm * sms;
}

// The length of one problem's int array (ops/ar_scan.py checks it).
int radtts_ar_scan_resident_ints() { return kResInts; }

// The trace's shape: kTraceFrames x kStamps.
int radtts_ar_scan_trace_frames() { return kTraceFrames; }
int radtts_ar_scan_trace_stamps() { return kStamps; }

// n problems in one cooperative launch of `blocks` blocks (problem i takes
// blocks block0_i ..). icfg: n x kResInts ints (the rNumScalars fields, then
// ld[kMaxSegs], head_in, head_out, head_act, act_off [kMaxHead each],
// producers[kMaxPhases]); fcfg: n x (left, right, bottom, top); ptrs: n x
// (res, ctx, out, img, ovf, table, hbuf, apbuf, actbuf, counters); trace:
// null, or kTraceFrames x kStamps of block trace_block's clock.
int radtts_ar_scan_resident(const int* icfg, const float* fcfg,
                            void* const* ptrs, int n, int blocks, int smem,
                            int G, unsigned long long* trace,
                            int trace_block, void* stream) {
  if (n < 1 || n > kMaxProblems) return (int)cudaErrorInvalidValue;
  ResidentArgs args;
  args.n = n;
  args.trace = trace;
  args.trace_block = trace_block;
  int covered = 0;
  bool split = false;
  for (int pi = 0; pi < n; ++pi) {
    Problem& a = args.p[pi];
    const int* c = icfg + pi * kResInts;
    void* const* q = ptrs + pi * kResPtrs;
    a.res = (const float*)q[0];
    a.ctx = (const float*)q[1];
    a.out = (float*)q[2];
    a.img = (const float*)q[3];
    a.ovf = (const float*)q[4];
    a.table = (const int*)q[5];
    a.hbuf = (float*)q[6];
    a.apbuf = (float*)q[7];
    a.actbuf = (float*)q[8];
    a.counters = (unsigned int*)q[9];
    a.B = c[rB];
    a.T = c[rT];
    a.C = c[rC];
    a.H = c[rH];
    a.L = c[rL];
    a.kind = c[rKind];
    a.scaling = c[rScaling];
    a.n_bins = c[rBins];
    a.n_head = c[rNHead];
    a.block0 = c[rBlock0];
    a.blocks = c[rBlocks];
    a.img_stride = c[rImgStride];
    a.off_hs = c[rOffHs];
    a.off_cattr = c[rOffCattr];
    a.off_cown = c[rOffCown];
    a.off_xs = c[rOffXs];
    a.off_qs = c[rOffQs];
    a.off_prev = c[rOffPrev];
    a.off_ctx = c[rOffCtx];
    a.off_res = c[rOffRes];
    a.off_img = c[rOffImg];
    a.cmax = c[rCmax];
    a.ovf_stride = c[rOvfStride];
    const int* p = c + rNumScalars;
    for (int i = 0; i < kMaxSegs; ++i) a.ld[i] = *p++;
    int* heads[4] = {a.head_in, a.head_out, a.head_act, a.act_off};
    for (int f = 0; f < 4; ++f)
      for (int i = 0; i < kMaxHead; ++i) heads[f][i] = *p++;
    for (int i = 0; i < kMaxPhases; ++i) a.producers[i] = *p++;
    a.left = fcfg[4 * pi];
    a.right = fcfg[4 * pi + 1];
    a.bottom = fcfg[4 * pi + 2];
    a.top = fcfg[4 * pi + 3];
    if (a.L < 1 || a.L > kMaxLayers || a.n_head < 1 || a.n_head > kMaxHead
        || a.block0 != covered || a.blocks < 1
        || (a.ovf_stride > 0 && a.ovf == nullptr))
      return (int)cudaErrorInvalidValue;
    const int bins = a.kind == kQuadratic ? a.n_bins / 2 : a.n_bins;
    if (a.kind != kAffine && (bins < 1 || bins > kMaxBins))
      return (int)cudaErrorInvalidValue;
    covered += a.blocks;
    split = split || a.ovf_stride > 0;
  }
  const void* fn = resident_kernel(G, split);
  if (covered != blocks || fn == nullptr)
    return (int)cudaErrorInvalidValue;
  if (blocks > radtts_ar_scan_resident_max_blocks(smem, G, split))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(kResThreads), kargs, (size_t)smem,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The handoff probe (mode 0: the resident kernel's handoff, 1: the
// barrier kernel's grid barrier) on `blocks` blocks with `smem` bytes each;
// counters: 2 + n_phases zeros.
int radtts_handoff_probe(unsigned int* counters, int n_phases, int T,
                         int mode, int blocks, int smem, void* stream) {
  if (cudaFuncSetAttribute(handoff_probe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, handoff_probe_kernel,
                                                kResThreads, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks < 1 || blocks > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&counters, &n_phases, &T, &mode};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)handoff_probe_kernel, dim3(blocks), dim3(kResThreads),
      kargs, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
