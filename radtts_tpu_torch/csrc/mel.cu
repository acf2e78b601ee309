// Fused STFT -> log-mel spectrogram, fp32, for Hopper (sm_90a), by a real
// FFT in shared memory.
//
// Replaces the TPU kernel radtts_tpu/ops/pallas_mel.py:mel_spectrogram_pallas
// (body _mel_kernel): reflect pad by n_fft/2, frame with hop, periodic Hann
// window, |DFT|, slaney mel projection, log(max(., clip)). The TPU kernel
// runs the DFT as two matmuls against cos/sin bases on the MXU; on Hopper a
// DFT by products costs ~70x the function's least work on the fp32 pipes,
// so this kernel computes the spectrum by an FFT instead. The host wrapper
// is radtts_tpu_torch/ops/mel.py:mel.
//
// One warp owns one frame, kWarps frames per block, frames of all batch
// rows numbered as one sequence (f = b * T + t), so (16, 8192) (528 frames)
// launches 132 blocks, one per SM. Per frame, all in shared memory:
//   1. the n_fft = N samples are read with reflect indexing at both ends,
//      windowed as they load, and packed as M = N/2 complex values
//      z[m] = x[2m] + i x[2m+1] (separate re / im arrays);
//   2. a complex FFT of z of size M by Stockham stages (no bit-reversal
//      pass: each stage reads in natural order and writes the next stage's
//      order into the other of two buffers): radix-4 stages while 4
//      divides what is left, then one radix-2 stage (M = 512: 4,4,4,4,2);
//      stage with radix r after p = product of earlier radices, for
//      i < M/r: k = i mod p, u_q = x[i + q M/r] * W_M^{q k M/(p r)},
//      y[(i - k) r + k + s p] = sum_q u_q exp(-2 pi i q s / r), the
//      r-point DFT;
//   3. the real-FFT post-twiddle unpacks bins 0..M:
//      X[k] = E[k] + W_N^k O[k], E = (Z[k] + conj Z[M-k]) / 2,
//      O = (Z[k] - conj Z[M-k]) / 2i; DC = Re Z0 + Im Z0, Nyquist =
//      Re Z0 - Im Z0; their magnitudes go to shared memory;
//   4. each lane sums the mel filters lane, lane + 32, ... over their
//      nonzero bins only ([first, last + 1), weights packed one filter
//      after another) and writes log(max(., clip)).
// Twiddles W_N^e = exp(-2 pi i e / N), e < N, are fp32 values rounded from
// float64 on the host (ops/mel.py:kernel_constants); they and the packed
// filterbank (727 weights at N = 1024, 80 mels) are read into shared
// memory once per block; W_M^e = W_N^{2e}. Each lane keeps 16 audio loads
// in flight, so a frame's samples arrive in two round trips. Shared-memory rows are padded by
// one word per 32 (index j + j/32), so the radix-4 stages' first strided
// writes (j = 4i) fall in 32 distinct banks.
//
// Bound: the function's least work per frame is a real FFT (2.5 N log2 N
// FLOP), N/2+1 magnitudes, two FLOP per nonzero of the filterbank (~700)
// and n_mels logs: about 29 kFLOP at N = 1024, n_mels = 80, against 4 * (N/4
// + n_mels) = 1344 bytes of audio in and log-mel out, so it is bound by
// operations, barely (~22 FLOP per byte against an fp32 ridge of ~20); at
// the training shape (528 frames) that bound is ~0.23 us, far below one
// launch, so in practice the launch and the latency of one frame's chain of
// dependent shared-memory stages bound it. This design spends per frame N
// window products, 4 radix-4 stages of 128 butterflies (34 FLOP each), a
// radix-2 stage of 256 (10 FLOP), 16 FLOP per unpacked bin, 4 per
// magnitude, 2 per filterbank nonzero and one per log: ~33 kFLOP at N =
// 1024 (chip_smoke.py:mel_bound's design_gflop), against ~2.1 MFLOP for the
// DFT by products it replaces. Time on an H100 (700 W) at (16, 8192): ~0.021
// ms per call, back to back, against 0.107-0.112 ms for the DFT kernel in
// the same run (PERF.md): ~90x the operations bound, which is ~0.2 us, and
// about the cost of a launch and one frame's chain of dependent stages.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kWarps = 4;   // frames per block
constexpr int kLoads = 16;  // audio loads per lane in flight

__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kWarps * 32)
mel_fft_kernel(const float* __restrict__ audio,
               const float* __restrict__ window,
               const float2* __restrict__ twiddles,
               const float* __restrict__ fb_packed,
               const int* __restrict__ ranges, float* __restrict__ out,
               int n_frames, int n, int T, int n_fft, int hop, int n_mels,
               int fb_nnz, float clip) {
  extern __shared__ __align__(16) float smem[];
  const int M = n_fft / 2;
  const int PL = pad(M - 1) + 2;  // padded array length, >= M + 1
  float2* tw = reinterpret_cast<float2*>(smem);  // [n_fft]
  float* fb = smem + 2 * n_fft;                  // [fb_nnz]
#pragma unroll 8
  for (int e = threadIdx.x; e < n_fft; e += blockDim.x) tw[e] = twiddles[e];
#pragma unroll 8
  for (int e = threadIdx.x; e < fb_nnz; e += blockDim.x) fb[e] = fb_packed[e];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= n_frames) return;  // no block-wide barrier follows
  const int b = f / T, t = f % T;
  float* xr = smem + 2 * n_fft + fb_nnz + warp * 4 * PL;
  float* xi = xr + PL;
  float* yr = xi + PL;
  float* yi = yr + PL;

  // 1. reflect-indexed, windowed, packed as z[m] = x[2m] + i x[2m+1];
  //    kLoads loads per lane in flight at once
  const float* x = audio + (size_t)b * n;
  const int start = t * hop - M;
  for (int j0 = 0; j0 < n_fft; j0 += 32 * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + lane + 32 * u;
      int s = start + j;
      if (s < 0) s = -s;
      else if (s >= n) s = 2 * (n - 1) - s;
      v[u] = j < n_fft ? __ldg(x + s) * __ldg(window + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + lane + 32 * u;
      if (j < n_fft) (j & 1 ? xi : xr)[pad(j >> 1)] = v[u];
    }
  }
  __syncwarp();

  // 2. Stockham FFT of size M
  int p = 1;
  while ((M / p) % 4 == 0) {
    const int L = M / 4;
    const int stride = 2 * (M / (4 * p));  // W_N index of q = 1 per unit k
    for (int i = lane; i < L; i += 32) {
      const int k = i & (p - 1);
      const int e = k * stride;
      const float2 u0 = make_float2(xr[pad(i)], xi[pad(i)]);
      const float2 u1 = cmul(make_float2(xr[pad(i + L)], xi[pad(i + L)]),
                             tw[e]);
      const float2 u2 = cmul(
          make_float2(xr[pad(i + 2 * L)], xi[pad(i + 2 * L)]), tw[2 * e]);
      const float2 u3 = cmul(
          make_float2(xr[pad(i + 3 * L)], xi[pad(i + 3 * L)]), tw[3 * e]);
      const float2 a = make_float2(u0.x + u2.x, u0.y + u2.y);
      const float2 c = make_float2(u0.x - u2.x, u0.y - u2.y);
      const float2 s13 = make_float2(u1.x + u3.x, u1.y + u3.y);
      const float2 d13 = make_float2(u1.x - u3.x, u1.y - u3.y);
      const int j = (i - k) * 4 + k;
      yr[pad(j)] = a.x + s13.x;          // v0 = u0 + u1 + u2 + u3
      yi[pad(j)] = a.y + s13.y;
      yr[pad(j + p)] = c.x + d13.y;      // v1 = u0 - i u1 - u2 + i u3
      yi[pad(j + p)] = c.y - d13.x;
      yr[pad(j + 2 * p)] = a.x - s13.x;  // v2 = u0 - u1 + u2 - u3
      yi[pad(j + 2 * p)] = a.y - s13.y;
      yr[pad(j + 3 * p)] = c.x - d13.y;  // v3 = u0 + i u1 - u2 - i u3
      yi[pad(j + 3 * p)] = c.y + d13.x;
    }
    __syncwarp();
    float* r = xr; xr = yr; yr = r;
    float* q = xi; xi = yi; yi = q;
    p *= 4;
  }
  if (p < M) {  // one radix-2 stage: M / p == 2
    const int L = M / 2;
    for (int i = lane; i < L; i += 32) {
      const int k = i & (p - 1);
      const float2 u0 = make_float2(xr[pad(i)], xi[pad(i)]);
      const float2 u1 = cmul(make_float2(xr[pad(i + L)], xi[pad(i + L)]),
                             tw[2 * k]);  // W_N^{2k M / (2p)}, M / p = 2
      const int j = (i - k) * 2 + k;
      yr[pad(j)] = u0.x + u1.x;
      yi[pad(j)] = u0.y + u1.y;
      yr[pad(j + p)] = u0.x - u1.x;
      yi[pad(j + p)] = u0.y - u1.y;
    }
    __syncwarp();
    float* r = xr; xr = yr; yr = r;
    float* q = xi; xi = yi; yi = q;
  }

  // 3. real-FFT unpack: magnitudes of bins 0..M into the free buffer (yr
  //    and yi are one pair's adjacent arrays, 2 PL >= M + 1 words)
  float* mag = yr;
  for (int k = lane; k <= M; k += 32) {
    float m;
    if (k == 0 || k == M) {
      const float z0r = xr[pad(0)], z0i = xi[pad(0)];
      m = fabsf(k == 0 ? z0r + z0i : z0r - z0i);
    } else {
      const float ar = xr[pad(k)], ai = xi[pad(k)];
      const float cr = xr[pad(M - k)], ci = -xi[pad(M - k)];  // conj Z[M-k]
      const float er = 0.5f * (ar + cr), ei = 0.5f * (ai + ci);
      // O = (a - c) / 2i = ((a - c).im, -(a - c).re) / 2
      const float2 o = make_float2(0.5f * (ai - ci), -0.5f * (ar - cr));
      const float2 wo = cmul(o, tw[k]);
      const float re = er + wo.x, im = ei + wo.y;
      m = sqrtf(re * re + im * im);
    }
    mag[k] = m;
  }
  __syncwarp();

  // 4. sparse mel sums and the log
  for (int mi = lane; mi < n_mels; mi += 32) {
    const int first = __ldg(&ranges[3 * mi]), last = __ldg(&ranges[3 * mi + 1]);
    const float* w = fb + __ldg(&ranges[3 * mi + 2]) - first;
    float s = 0.f;
    for (int k = first; k < last; ++k) s = fmaf(mag[k], w[k], s);
    out[(size_t)f * n_mels + mi] = logf(fmaxf(s, clip));
  }
}

size_t smem_bytes(int n_fft, int fb_nnz) {
  const int M = n_fft / 2;
  const int PL = (M - 1) + ((M - 1) >> 5) + 2;
  return sizeof(float) *
         ((size_t)2 * n_fft + fb_nnz + (size_t)kWarps * 4 * PL);
}

}  // namespace

// Shared memory per block at n_fft with fb_nnz filterbank nonzeros
// (44,892 bytes at 1024 and the slaney filterbank's 727).
extern "C" int radtts_mel_smem_bytes(int n_fft, int fb_nnz) {
  return (int)smem_bytes(n_fft, fb_nnz);
}

// Returns the cudaError_t of the launch (0 on success). Shapes: audio (B, n)
// contiguous, n > n_fft / 2; window (n_fft,); twiddles (n_fft, 2) with
// twiddles[e] = (cos, -sin)(2 pi e / n_fft); fb_packed (fb_nnz,) each mel
// filter's weights over its bins [first, last) one filter after another;
// ranges (n_mels, 3) int32 = (first, last, offset in fb_packed); out (B, T,
// n_mels) with T = 1 + n / hop. Requires n_fft a power of two in [16, 4096]
// and the shared memory within 227 KB.
extern "C" int radtts_mel(const float* audio, const float* window,
                          const float* twiddles, const float* fb_packed,
                          const int* ranges, float* out, int B, int n,
                          int n_fft, int hop, int n_mels, int fb_nnz,
                          float clip, void* stream) {
  if (B <= 0 || n_fft < 16 || n_fft > 4096 || (n_fft & (n_fft - 1)) != 0 ||
      hop <= 0 || n <= n_fft / 2 || n_mels <= 0 || fb_nnz < 0)
    return (int)cudaErrorInvalidValue;
  const int T = 1 + n / hop;
  const int n_frames = B * T;
  const size_t smem = smem_bytes(n_fft, fb_nnz);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n_frames + kWarps - 1) / kWarps;
  mel_fft_kernel<<<grid, kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      audio, window, reinterpret_cast<const float2*>(twiddles), fb_packed,
      ranges, out, n_frames, n, T, n_fft, hop, n_mels, fb_nnz, clip);
  return (int)cudaGetLastError();
}
