// The whole HiFi-GAN multi-receptive-field (MRF) resblock stack of one
// stage in one launch, channels-last, fp32, for Hopper (sm_90a), at the
// narrow widths C <= 16 (C % 4 == 0).
//
// Replaces the TPU kernel radtts_tpu/ops/pallas_mrf.py:pallas_mrf as the
// JAX package runs it at these widths (radtts_tpu/models/hifigan.py:313-320;
// HiFi-GAN V2's C=16 and C=8 stages): one read of a tile plus its halo,
// every conv of the stack on chip, one write of the mean,
//
//   mean_m RB_m(x),  RB_m(x): 3x [x += conv_{k,1}(lrelu(conv_{k,d}(lrelu x)))],
//   d in (1, 3, 5), k = ks[m] odd <= 11, every conv zero-padded at 0 and T.
//
// The host wrapper is radtts_tpu_torch/ops/mrf.py:mrf (route "stack").
//
// What bounds it: at C=16 a stage is 2 T C^2 126 FLOP (5.0 GFLOP at T =
// 77824: 75 us at the 67 TFLOP/s fp32 FMA rate; 30 us in 3xTF32) against
// 2 T C 4 bytes in and out (10 MB: 3 us). The 18-launch chain it replaces
// (csrc/mrf.cu) moved ~49 passes of the (B, T, C) tensor and paid a launch
// per conv for ~2-4 us of arithmetic each. So the design keeps every
// intermediate in shared memory and does the products on the CUDA cores:
// at these widths a tensor-core tile (64 rows x 8+ columns x 8 deep) would
// be mostly padding, and the FMA bound is below what one launch per conv
// cost. Operations bound it, on the fp32 pipes.
//
// Design:
//   - a block owns `tile` rows of one batch item (grid: tiles x B). Its
//     slab is the tile plus halo = 6 (max k - 1) rows each side (60 at
//     k = 11), rows outside [0, T) loaded as zeros;
//   - per resblock m the slab rows the chain needs, [halo - R, tile + halo
//     + R) with R = 6 (k - 1), are read from x (L2) into xr; each conv then
//     computes only the rows that stay valid, the region shrinking by its
//     reach (k - 1) d / 2 a side, and ends on exactly the tile's rows;
//   - zero padding: every conv output at a row whose global index lies
//     outside [0, T) is written as 0 (pallas_mrf.py:96-113 masks the same
//     way), so nothing from beyond the sequence ends, or from another batch
//     item, flows back in;
//   - conv_{k,d} reads lrelu(xr) and stores lrelu(xt) (all its reader
//     needs); conv_{k,1} adds into xr in place (each element read and
//     written by one thread);
//   - products: one thread owns kRT = 2 rows (tid, tid + 256) of a pass
//     with all C output channels in registers (a warp whose second rows lie
//     past the region computes only its first); weights (k, C_in, C_out) and bias of one conv
//     sit in shared memory and are read as float4 broadcasts; activations
//     as float4 along channels from rows padded to C + 4 words (C % 8 == 0),
//     which puts 8 consecutive rows' float4s in distinct banks;
//   - the next conv's weights stream into the second of two buffers by
//     cp.async while the current conv multiplies;
//   - the mean of the resblocks accumulates in registers (two tile rows per
//     thread) and is written once.
// Shared memory per block: (2 (tile + 2 halo) LD + 2 (k_max C^2 + C)) * 4
// bytes, LD = C + 4 if C % 8 == 0 else C: 89,056 at C=16 with the 295-row
// tiles ops/mrf.py:stack_tile picks at T = 77824 on 132 SMs (264 blocks,
// two per SM), 55,040 at C=8 (394 rows, 396 blocks). Registers (nvcc
// -Xptxas -v, sm_90a): 128 at C=16, 123 at C=12, 106 at C=8, 102 at C=4;
// no spills (a 16-byte stack frame holds the kernel sizes), so two blocks
// of 256 threads fit an SM. On an H100 (700 W) the C=16 stage takes ~0.21
// ms and the C=8 one ~0.11 ms, ~35% of the FMA bound (PERF.md).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 2;                     // rows per thread per pass
constexpr int kMaxTile = kThreads * kRT;   // tile rows of the mean registers
constexpr int kMaxRB = 4;
constexpr int kMaxTaps = 11;

struct Ks {
  int k[kMaxRB];
};

template <int C>
__host__ __device__ constexpr int row_stride() {
  return C % 8 == 0 ? C + 4 : C;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// RT rows of one conv for this thread: rows s0 + r * kThreads, r < RT,
// those below hi stored. FIRST: dst = lrelu(mask(conv(lrelu src))); else
// dst += mask(conv(src)). w: k taps (C_in, C_out) then C biases.
template <int C, bool FIRST, int RT>
__device__ __forceinline__ void conv_rows(const float* src, float* dst,
                                          const float* w, int k, int d,
                                          int s0, int hi, int t_base, int T,
                                          float slope) {
  constexpr int LD = row_stride<C>();
  constexpr int C4 = C / 4;
  const int half = (k - 1) / 2;
  const float* bias = w + k * C * C;
  int s[RT];
  bool ok[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    s[r] = s0 + r * kThreads;
    ok[r] = s[r] < hi;
    if (!ok[r]) s[r] = hi - 1;  // read inside the slab, never stored
  }
  float acc[RT][C];
#pragma unroll
  for (int co = 0; co < C; ++co) {
    const float bv = bias[co];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r][co] = bv;
  }
  for (int j = 0; j < k; ++j) {
    const int off = (j - half) * d;
    const float* wj = w + j * C * C;
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4) {
      float4 a[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        a[r] = *reinterpret_cast<const float4*>(
            &src[(s[r] + off) * LD + c4 * 4]);
        if (FIRST) {
          a[r].x = lrelu(a[r].x, slope);
          a[r].y = lrelu(a[r].y, slope);
          a[r].z = lrelu(a[r].z, slope);
          a[r].w = lrelu(a[r].w, slope);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* wr = wj + (c4 * 4 + cc) * C;
#pragma unroll
        for (int o4 = 0; o4 < C4; ++o4) {
          const float4 wv = *reinterpret_cast<const float4*>(&wr[o4 * 4]);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float av = comp(a[r], cc);
            acc[r][o4 * 4 + 0] = fmaf(av, wv.x, acc[r][o4 * 4 + 0]);
            acc[r][o4 * 4 + 1] = fmaf(av, wv.y, acc[r][o4 * 4 + 1]);
            acc[r][o4 * 4 + 2] = fmaf(av, wv.z, acc[r][o4 * 4 + 2]);
            acc[r][o4 * 4 + 3] = fmaf(av, wv.w, acc[r][o4 * 4 + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (!ok[r]) continue;
    const int t = t_base + s[r];
    const bool inside = t >= 0 && t < T;
    float* row = dst + s[r] * LD;
#pragma unroll
    for (int o4 = 0; o4 < C4; ++o4) {
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (inside)
        y = make_float4(acc[r][o4 * 4 + 0], acc[r][o4 * 4 + 1],
                        acc[r][o4 * 4 + 2], acc[r][o4 * 4 + 3]);
      float4* p = reinterpret_cast<float4*>(&row[o4 * 4]);
      if (FIRST) {
        *p = make_float4(lrelu(y.x, slope), lrelu(y.y, slope),
                         lrelu(y.z, slope), lrelu(y.w, slope));
      } else {
        float4 v = *p;
        v.x += y.x; v.y += y.y; v.z += y.z; v.w += y.w;
        *p = v;
      }
    }
  }
}

// One conv over slab rows [lo, hi), in passes of kThreads * kRT rows. A
// warp whose rows of a pass all lie at or past hi skips them (warp-uniform:
// its 32 rows are consecutive), so a region shorter than a pass leaves its
// issue slots to the SM's other warps instead of multiplying clamped rows.
template <int C, bool FIRST>
__device__ __forceinline__ void conv(const float* src, float* dst,
                                     const float* w, int k, int d, int lo,
                                     int hi, int t_base, int T,
                                     float slope) {
  static_assert(kRT == 2, "conv dispatches one or two rows per thread");
  const int warp0 = threadIdx.x & ~31;
  for (int base = lo; base < hi; base += kThreads * kRT) {
    const int s0 = base + threadIdx.x;
    if (base + warp0 >= hi) continue;
    if (base + kThreads + warp0 >= hi)
      conv_rows<C, FIRST, 1>(src, dst, w, k, d, s0, hi, t_base, T, slope);
    else
      conv_rows<C, FIRST, 2>(src, dst, w, k, d, s0, hi, t_base, T, slope);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
mrf_stack_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                 float* __restrict__ out, int T, int tile, Ks ks, int n_rb,
                 int halo, int w_stride, float slope) {
  constexpr int LD = row_stride<C>();
  constexpr int C4 = C / 4;
  extern __shared__ __align__(16) float smem[];
  const int S = tile + 2 * halo;
  float* xr = smem;               // [S][LD]
  float* xt = xr + S * LD;        // [S][LD]
  float* wbuf = xt + S * LD;      // [2][w_stride]
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int t_base = t0 - halo;   // global row of slab row 0
  const float* xb = x + (size_t)b * T * C;

  // conv g (g < 6 n_rb) of resblock g / 6: k C^2 weights then C biases
  const int n_convs = 6 * n_rb;
  int next_off = 0;
  auto prefetch = [&](int g) {
    const int n4 = (ks.k[g / 6] * C * C + C) / 4;
    float* dst = wbuf + (g & 1) * w_stride;
    for (int i = tid; i < n4; i += kThreads)
      cp_async16(dst + 4 * i, wp + next_off + 4 * i);
    cp_async_commit();
    next_off += 4 * n4;
  };
  prefetch(0);

  float mean[kRT][C];
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) mean[r][c] = 0.f;

  int g = 0;
  for (int m = 0; m < n_rb; ++m) {
    const int k = ks.k[m];
    const int half = (k - 1) / 2;
    int lo = halo - 12 * half, hi = S - halo + 12 * half;
    __syncthreads();  // the previous resblock's reads of xr are done
    for (int e = tid; e < (hi - lo) * C4; e += kThreads) {
      const int s = lo + e / C4, c4 = e % C4;
      const int t = t_base + s;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T)
        v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C) + c4);
      *reinterpret_cast<float4*>(&xr[s * LD + c4 * 4]) = v;
    }
    for (int i = 0; i < 3; ++i) {
      const int d = 2 * i + 1;  // dilations 1, 3, 5
      const int p1 = half * d;
      cp_async_wait_all();
      __syncthreads();
      if (g + 1 < n_convs) prefetch(g + 1);
      conv<C, true>(xr, xt, wbuf + (g & 1) * w_stride, k, d, lo + p1,
                    hi - p1, t_base, T, slope);
      lo += p1;
      hi -= p1;
      ++g;
      cp_async_wait_all();
      __syncthreads();
      if (g + 1 < n_convs) prefetch(g + 1);
      conv<C, false>(xt, xr, wbuf + (g & 1) * w_stride, k, 1, lo + half,
                     hi - half, t_base, T, slope);
      lo += half;
      hi -= half;
      ++g;
    }
    __syncthreads();  // [lo, hi) is now the tile: [halo, halo + tile)
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int row = tid + r * kThreads;
      if (row >= tile) continue;
      const float* src = xr + (halo + row) * LD;
#pragma unroll
      for (int c = 0; c < C; ++c) mean[r][c] += src[c];
    }
  }

  const float inv = 1.f / n_rb;
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int row = tid + r * kThreads;
    const int t = t0 + row;
    if (row >= tile || t >= T) continue;
    float4* dst = reinterpret_cast<float4*>(out + ((size_t)b * T + t) * C);
#pragma unroll
    for (int c4 = 0; c4 < C4; ++c4)
      dst[c4] = make_float4(mean[r][4 * c4] * inv, mean[r][4 * c4 + 1] * inv,
                            mean[r][4 * c4 + 2] * inv,
                            mean[r][4 * c4 + 3] * inv);
  }
}

int stride_of(int C) { return C % 8 == 0 ? C + 4 : C; }

size_t smem_bytes(int C, int tile, int k_max) {
  const int halo = 6 * (k_max - 1);
  return sizeof(float) * (2 * (size_t)(tile + 2 * halo) * stride_of(C) +
                          2 * (size_t)(k_max * C * C + C));
}

template <int C>
int launch(const float* x, const float* wp, float* out, int B, int T,
           int tile, const Ks& ks, int n_rb, int k_max, float slope,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(C, tile, k_max);
  const cudaError_t e = cudaFuncSetAttribute(
      mrf_stack_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + tile - 1) / tile, B);
  mrf_stack_kernel<C><<<grid, kThreads, smem, stream>>>(
      x, wp, out, T, tile, ks, n_rb, 6 * (k_max - 1), k_max * C * C + C,
      slope);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory per block for width C, `tile` rows and largest kernel
// size k_max.
extern "C" int radtts_mrf_stack_smem_bytes(int C, int tile, int k_max) {
  return (int)smem_bytes(C, tile, k_max);
}

// Returns the cudaError_t of the launch (0 on success). x, out (B, T, C)
// contiguous, 16-byte aligned; wp the stage's weights packed per resblock m
// and dilation i as [w1[i] (k, C, C), b1[i] (C), w2[i] (k, C, C), b2[i] (C)]
// (ops/mrf.py:stack_pack), 16-byte aligned; k0..k3 the first n_rb resblocks'
// kernel sizes. Requires C in {4, 8, 12, 16}, 1 <= n_rb <= 4, odd k <= 11,
// 1 <= tile <= 512.
extern "C" int radtts_mrf_stack(const float* x, const float* wp, float* out,
                                int B, int T, int C, int tile, int k0, int k1,
                                int k2, int k3, int n_rb, float slope,
                                void* stream) {
  Ks ks = {{k0, k1, k2, k3}};
  if (B <= 0 || T <= 0 || tile <= 0 || tile > kMaxTile || n_rb <= 0 ||
      n_rb > kMaxRB)
    return (int)cudaErrorInvalidValue;
  int k_max = 0;
  for (int m = 0; m < n_rb; ++m) {
    if (ks.k[m] <= 0 || ks.k[m] % 2 == 0 || ks.k[m] > kMaxTaps)
      return (int)cudaErrorInvalidValue;
    k_max = ks.k[m] > k_max ? ks.k[m] : k_max;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4: return launch<4>(x, wp, out, B, T, tile, ks, n_rb, k_max, slope, s);
    case 8: return launch<8>(x, wp, out, B, T, tile, ks, n_rb, k_max, slope, s);
    case 12:
      return launch<12>(x, wp, out, B, T, tile, ks, n_rb, k_max, slope, s);
    case 16:
      return launch<16>(x, wp, out, B, T, tile, ks, n_rb, k_max, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
