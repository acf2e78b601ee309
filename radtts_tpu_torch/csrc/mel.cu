// Fused STFT -> log-mel spectrogram, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel radtts_tpu/ops/pallas_mel.py:mel_spectrogram_pallas
// (body _mel_kernel): reflect pad by n_fft/2, frame with hop, windowed
// cos/sin DFT, magnitude, mel projection, log(max(., clip)). The host
// wrapper is radtts_tpu_torch/ops/mel.py:mel.
//
// One block owns kFT consecutive frames of one batch row:
//   1. it reads the audio span those frames cover straight from the input,
//      with reflect indexing at both ends, into shared memory (the (B, T,
//      n_fft) frame tensor the TPU version gathers is never built);
//   2. each thread takes two adjacent DFT columns and sums, over the n_fft
//      samples of all kFT frames, the products with the windowed bases
//      (plain fp32 FMAs on the CUDA cores: no TF32, since the log amplifies
//      magnitude error near the clamp); the frames' samples come from
//      shared memory as broadcasts, the bases from L2 as float4 loads, each
//      used kFT times from registers;
//   3. the magnitudes go to shared memory, and the mel projection and the
//      log follow in the same block, so the (T, n_fft/2+1) magnitude never
//      reaches device memory.
//
// Bases layout, built once on the host (ops/mel.py:kernel_constants):
//   bases[j][c] = (w_j cos(2 pi j c / N), w_j sin(2 pi j c / N)),
//   j < N = n_fft, c < N/2, except bases[j][0].y = w_j cos(pi j): column 0
//   carries DC in .x and Nyquist in .y (both have no imaginary part), so
//   N/2 column pairs hold all N/2+1 bins and N/4 threads cover them evenly.
// mel_fb is (n_mels, N/2+1) row-major; ranges[m] = [first, last+1) of the
// nonzero bins of filter m (the slaney triangles are narrow), so each mel
// output sums only the bins its filter touches.
//
// Bound: the function's least work per frame is a real FFT (2.5 N log2 N
// FLOP), N/2+1 magnitudes, two FLOP per nonzero of the filterbank (~700)
// and n_mels logs: about 29 kFLOP at N = 1024, n_mels = 80, against
// 4 * (N/4 + n_mels) = 1344 bytes of audio in and log-mel out. That is ~22
// FLOP per byte, just above an H100 SXM's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so the function is bound by operations, barely; at the
// training shape (528 frames) the bound is a fraction of a microsecond, far
// below one launch. This first design does not approach it: it spends the
// operations of a DFT by products, 2 * N * (N/2+1) * 2 FLOP per frame
// (~2.1 MFLOP, ~70x the least work), at the fp32 FMA rate, with the bases
// (4 MB) streamed from L2 once per block.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kFT = 8;  // frames per block

__global__ void __launch_bounds__(kThreads)
mel_kernel(const float* __restrict__ audio, const float4* __restrict__ bases,
           const float* __restrict__ mel_fb, const int* __restrict__ ranges,
           float* __restrict__ out, int n, int T, int n_fft, int hop,
           int n_mels, float clip) {
  extern __shared__ __align__(16) float smem[];
  const int n_half = n_fft / 2;
  const int n_freq = n_half + 1;
  const int n_quads = n_fft / 4;  // float4 column pairs per basis row
  const int span = (kFT - 1) * hop + n_fft;
  float* seg = smem;          // [span] padded audio under the kFT frames
  float* mag = smem + span;   // [kFT][n_freq]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFT;
  const float* x = audio + (size_t)b * n;
  const int n_padded = n + n_fft;  // n_fft/2 reflected samples at each end

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int p = t0 * hop + i;
    float v = 0.f;
    if (p < n_padded) {
      int s = p - n_half;
      if (s < 0) s = -s;
      else if (s >= n) s = 2 * (n - 1) - s;
      v = x[s];
    }
    seg[i] = v;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < n_quads; q += blockDim.x) {
    // acc[f] = (re of column 2q, im of 2q, re of 2q+1, im of 2q+1)
    float4 acc[kFT];
#pragma unroll
    for (int f = 0; f < kFT; ++f) acc[f] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll 2
    for (int j = 0; j < n_fft; j += 4) {
      const float4 w0 = __ldg(&bases[(size_t)(j + 0) * n_quads + q]);
      const float4 w1 = __ldg(&bases[(size_t)(j + 1) * n_quads + q]);
      const float4 w2 = __ldg(&bases[(size_t)(j + 2) * n_quads + q]);
      const float4 w3 = __ldg(&bases[(size_t)(j + 3) * n_quads + q]);
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        const float4 s = *reinterpret_cast<const float4*>(&seg[f * hop + j]);
        acc[f].x = fmaf(s.x, w0.x, acc[f].x);
        acc[f].y = fmaf(s.x, w0.y, acc[f].y);
        acc[f].z = fmaf(s.x, w0.z, acc[f].z);
        acc[f].w = fmaf(s.x, w0.w, acc[f].w);
        acc[f].x = fmaf(s.y, w1.x, acc[f].x);
        acc[f].y = fmaf(s.y, w1.y, acc[f].y);
        acc[f].z = fmaf(s.y, w1.z, acc[f].z);
        acc[f].w = fmaf(s.y, w1.w, acc[f].w);
        acc[f].x = fmaf(s.z, w2.x, acc[f].x);
        acc[f].y = fmaf(s.z, w2.y, acc[f].y);
        acc[f].z = fmaf(s.z, w2.z, acc[f].z);
        acc[f].w = fmaf(s.z, w2.w, acc[f].w);
        acc[f].x = fmaf(s.w, w3.x, acc[f].x);
        acc[f].y = fmaf(s.w, w3.y, acc[f].y);
        acc[f].z = fmaf(s.w, w3.z, acc[f].z);
        acc[f].w = fmaf(s.w, w3.w, acc[f].w);
      }
    }

    const int c = 2 * q;
#pragma unroll
    for (int f = 0; f < kFT; ++f) {
      float* m = mag + f * n_freq;
      if (c == 0) {
        m[0] = fabsf(acc[f].x);       // DC
        m[n_half] = fabsf(acc[f].y);  // Nyquist
      } else {
        m[c] = sqrtf(acc[f].x * acc[f].x + acc[f].y * acc[f].y);
      }
      m[c + 1] = sqrtf(acc[f].z * acc[f].z + acc[f].w * acc[f].w);
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kFT * n_mels; o += blockDim.x) {
    const int f = o / n_mels, mi = o % n_mels;
    const int t = t0 + f;
    if (t >= T) continue;
    const float* fb = mel_fb + (size_t)mi * n_freq;
    const float* m = mag + f * n_freq;
    float s = 0.f;
    for (int k = ranges[2 * mi]; k < ranges[2 * mi + 1]; ++k)
      s = fmaf(m[k], fb[k], s);
    out[((size_t)b * T + t) * n_mels + mi] = logf(fmaxf(s, clip));
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes: audio (B, n)
// contiguous, n > n_fft / 2; bases (n_fft, n_fft / 2, 2) 16-byte aligned;
// mel_fb (n_mels, n_fft / 2 + 1); ranges (n_mels, 2) int32; out (B, T,
// n_mels) with T = 1 + n / hop. Requires n_fft % 4 == 0 and hop % 4 == 0.
extern "C" int radtts_mel(const float* audio, const float* bases,
                          const float* mel_fb, const int* ranges, float* out,
                          int B, int n, int n_fft, int hop, int n_mels,
                          float clip, void* stream) {
  if (B <= 0 || n_fft <= 0 || n_fft % 4 != 0 || hop <= 0 || hop % 4 != 0 ||
      n <= n_fft / 2 || n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  const int T = 1 + n / hop;
  const size_t smem =
      sizeof(float) * ((size_t)(kFT - 1) * hop + n_fft +
                       (size_t)kFT * (n_fft / 2 + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + kFT - 1) / kFT, B);
  mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, reinterpret_cast<const float4*>(bases), mel_fb, ranges, out, n,
      T, n_fft, hop, n_mels, clip);
  return (int)cudaGetLastError();
}
