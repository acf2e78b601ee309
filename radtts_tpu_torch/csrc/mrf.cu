// One fused convolution of the HiFi-GAN multi-receptive-field (MRF)
// resblock chain, channels-last, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernels of radtts_tpu/ops/pallas_mrf.py: pallas_mrf
// and pallas_mrf_folded (there with 4 frames folded into 128 lanes to fill
// the MXU; here unfolded) at the widths no other kernel takes: C % 4 == 0
// that is neither a csrc/mrf_tc.cu width (32, 64, multiples of 64 from
// 128) nor a csrc/mrf_stack.cu width (C <= 16), e.g. C=48 or 96 (the
// routing rule is ops/mrf.py:mrf_route). No HiFi-GAN v1 or V2 stage runs
// it. It takes any C % 4 == 0, so `mrf_cuda(..., route="conv")` times it
// against the other two on the same inputs. The host wrapper
// (radtts_tpu_torch/ops/mrf.py:mrf) chains 18 launches per stage:
//
//   for k in (3, 7, 11), d in (1, 3, 5):
//       xt = conv_{k,d}(lrelu(xr)) + b1              (out = xt)
//       xr = xr + conv_{k,1}(lrelu(xt)) + b2          (res = xr, out = xr)
//   out += xr / 3 after the last d of each k          (acc, acc_scale)
//
// One launch computes, for t in [0, T):
//   y[b,t,co] = bias[co] + sum_{j<k, ci<C} w[j,ci,co] * lrelu(x[b, t+(j-(k-1)/2)*d, ci])
// with x read as zero outside [0, T): this is the zero padding every conv of
// the reference sees at the true sequence ends, so no intermediate needs
// re-zeroing. Epilogue: y += res (if given); out = y (if given);
// acc += acc_scale * y (if given). res may alias out (each element is read
// and written by the same thread); x never aliases out.
//
// Bound: 2*T*C^2*126 FLOP per stage against its activations; at C=16 and
// C=8 the chain's bytes (49 passes of the (B, T, C) tensor) bound it. This
// first design does its products in fp32 FMA on the CUDA cores: a block owns
// a (TT time x CO_TILE channel) output tile held in registers (8 x 4 per
// thread), and walks C_in in chunks of CI channels, staging lrelu(x) for the
// tile plus its halo, and the chunk's k taps of weights, in shared memory.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kCI = 8;         // input channels per shared-memory chunk
constexpr int kRT = 8;         // time rows per thread
constexpr int kRC = 4;         // output channels per thread (one float4)
constexpr int kMaxTaps = 11;
constexpr int kMaxHalo = 50;   // (kMaxTaps - 1) * largest dilation (5)

template <int CO_TILE>
__global__ void __launch_bounds__(kThreads)
mrf_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* res, float* out,
                float* acc, float acc_scale, int T, int C, int k, int d,
                float slope) {
  constexpr int TX = CO_TILE / kRC;
  constexpr int TY = kThreads / TX;
  constexpr int TT = TY * kRT;
  constexpr int ROWS = TT + kMaxHalo;
  __shared__ float in_s[kCI][ROWS];
  __shared__ __align__(16) float w_s[kMaxTaps * kCI * CO_TILE];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int pad = (k - 1) / 2 * d;
  const int rows = TT + (k - 1) * d;
  const float* xb = x + (size_t)b * T * C;

  float accum[kRT][kRC];
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int c = 0; c < kRC; ++c) accum[r][c] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += kCI) {
    for (int e = tid; e < rows * kCI; e += kThreads) {
      const int r = e / kCI, c = e % kCI;
      const int t = t0 - pad + r, ci = ci0 + c;
      float v = 0.f;
      if (t >= 0 && t < T && ci < C) {
        v = xb[(size_t)t * C + ci];
        v = v >= 0.f ? v : slope * v;
      }
      in_s[c][r] = v;
    }
    for (int e = tid; e < k * kCI * CO_TILE; e += kThreads) {
      const int co = e % CO_TILE;
      const int c = (e / CO_TILE) % kCI;
      const int j = e / (CO_TILE * kCI);
      const int ci = ci0 + c, cog = co0 + co;
      w_s[e] = (ci < C && cog < C) ? w[((size_t)j * C + ci) * C + cog] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < k; ++j) {
      const int row0 = j * d + ty * kRT;
#pragma unroll
      for (int c = 0; c < kCI; ++c) {
        float a[kRT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) a[r] = in_s[c][row0 + r];
        const float4 wv = *reinterpret_cast<const float4*>(
            &w_s[(j * kCI + c) * CO_TILE + tx * kRC]);
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          accum[r][0] = fmaf(a[r], wv.x, accum[r][0]);
          accum[r][1] = fmaf(a[r], wv.y, accum[r][1]);
          accum[r][2] = fmaf(a[r], wv.z, accum[r][2]);
          accum[r][3] = fmaf(a[r], wv.w, accum[r][3]);
        }
      }
    }
    __syncthreads();
  }

  const int co = co0 + tx * kRC;
  if (co >= C) return;  // C % 4 == 0, so co..co+3 are all in range
  const float4 bv = *reinterpret_cast<const float4*>(&bias[co]);
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int t = t0 + ty * kRT + r;
    if (t >= T) break;
    const size_t idx = ((size_t)b * T + t) * C + co;
    float4 y = make_float4(accum[r][0] + bv.x, accum[r][1] + bv.y,
                           accum[r][2] + bv.z, accum[r][3] + bv.w);
    if (res != nullptr) {
      const float4 rv = *reinterpret_cast<const float4*>(&res[idx]);
      y.x += rv.x; y.y += rv.y; y.z += rv.z; y.w += rv.w;
    }
    if (out != nullptr) *reinterpret_cast<float4*>(&out[idx]) = y;
    if (acc != nullptr) {
      float4 av = *reinterpret_cast<float4*>(&acc[idx]);
      av.x = fmaf(acc_scale, y.x, av.x);
      av.y = fmaf(acc_scale, y.y, av.y);
      av.z = fmaf(acc_scale, y.z, av.z);
      av.w = fmaf(acc_scale, y.w, av.w);
      *reinterpret_cast<float4*>(&acc[idx]) = av;
    }
  }
}

template <int CO_TILE>
void launch(const float* x, const float* w, const float* bias,
            const float* res, float* out, float* acc, float acc_scale, int B,
            int T, int C, int k, int d, float slope, cudaStream_t stream) {
  constexpr int TT = (kThreads / (CO_TILE / kRC)) * kRT;
  const dim3 grid((T + TT - 1) / TT, (C + CO_TILE - 1) / CO_TILE, B);
  mrf_conv_kernel<CO_TILE><<<grid, kThreads, 0, stream>>>(
      x, w, bias, res, out, acc, acc_scale, T, C, k, d, slope);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes: x, res, out,
// acc (B, T, C) contiguous; w (k, C, C) taps-major (C_in, C_out); bias (C,).
// Requires C % 4 == 0, k odd and <= 11, (k - 1) * d <= 50, and 16-byte
// aligned bias, res, out and acc.
extern "C" int radtts_mrf_conv(const float* x, const float* w,
                               const float* bias, const float* res,
                               float* out, float* acc, float acc_scale, int B,
                               int T, int C, int k, int d, float slope,
                               void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % kRC != 0 || k <= 0 || k % 2 == 0 ||
      k > kMaxTaps || d <= 0 || (k - 1) * d > kMaxHalo)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32)
    launch<32>(x, w, bias, res, out, acc, acc_scale, B, T, C, k, d, slope, s);
  else
    launch<64>(x, w, bias, res, out, acc, acc_scale, B, T, C, k, d, slope, s);
  return (int)cudaGetLastError();
}
