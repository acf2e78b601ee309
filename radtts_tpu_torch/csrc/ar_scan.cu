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
// Design (a simple one, first): one cooperative launch; every block owns a
// slice of the output rows of every layer (a warp per LSTM unit, whose four
// gate rows it reads, or per head row), reads its weights from global
// memory (about 8 MB at the published width, resident in the 50 MB L2
// after the first frame) and the layer's input, for all items, from a
// global scratch into shared memory, and writes its outputs back to the
// scratch; the grid synchronizes between layers (1 + L + n_head syncs a
// frame: 7 at the published AGAP; a barrier of one atomic counter and a
// generation word, the launch cooperative so that every block is
// resident). Each block then computes the inverse
// of every item itself from the head's output, so the next frame's first
// layer needs no further sync; block 0 writes out. Data written inside the
// launch is read with ld.global.cg (L2), never through L1. The h vectors
// are double-buffered by frame parity; each c is read and written only by
// the warp that owns its unit.
//
// Bound: 2 * B * T * (MACs a frame; 1.98 M at H = 128 and the 128 -> 256
// -> 512 -> 1024 -> 1024 -> 49 head) FLOP at 67 TFLOP/s fp32, 0.036 ms at
// (1, 608); the bytes floor, the weights once plus res, ctx_proj and out,
// is ~8.7 MB, 0.0026 ms at 3.35 TB/s. What bounds this design is neither:
// it is the chain of T * 7 grid-wide barriers and the L2 latency of each
// layer's first loads. chip_smoke.py sweeps the block count and PERF.md
// keeps the times; weights resident in shared memory, or thread-block
// clusters instead of the grid barrier, are the redesign.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

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
      float* y = a.scratch + a.act_off[k];
      dense_phase(a.w + a.w_head[k], a.w + a.b_head[k], K, N, a.head_act[k],
                  xs, y, B, gw, tw, lane);
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
