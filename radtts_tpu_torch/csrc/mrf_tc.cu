// One fused convolution of the HiFi-GAN multi-receptive-field (MRF)
// resblock chain on Hopper's tensor cores, channels-last, fp32-accurate,
// for sm_90a. It serves every width C (a multiple of 4) but the C <= 16
// stages of at most 4 resblocks, which csrc/mrf_stack.cu serves (the
// routing rule is ops/mrf.py:mrf_route). Two kernels: mrf_tc_kernel for
// C > 96 (the design below), mrf_tc_narrow_kernel for C <= 96 (its own
// section further down). Widths that are not a tile width run padded to
// ops/mrf.py:padded_width(C): 32, 64 or 96 up to 96 (the narrow kernel),
// 128 from 100 to 128, the next multiple of 64 above (C=160: 192). The
// padded channels are exactly zero in every product (zero weights, zero
// activations: loads and stores touch only the C real channels, whose
// rows are 16-byte aligned since C % 4 == 0), so padding changes no real
// output. csrc/mrf.cu's FMA kernel, which took these widths before, runs
// only when asked for by name (chip_smoke.py's "before").
//
// Replaces the TPU kernels of radtts_tpu/ops/pallas_mrf.py: pallas_mrf_wide
// (C=256, there with bf16 weight storage; here fp32-accurate), pallas_mrf
// (at C=128 and C=64) and pallas_mrf_folded (C=32, there with 4 frames
// folded into 128 lanes; here unfolded). The host wrapper
// (radtts_tpu_torch/ops/mrf.py:mrf)
// chains 18 launches per stage, exactly as for csrc/mrf.cu, and one launch
// computes the same function as mrf_conv_kernel there:
//
//   y[b,t,co] = bias[co] + sum_{j<k, ci<C} w[j,ci,co] * lrelu(x[b, t+(j-(k-1)/2)*d, ci])
//
// with x read as zero outside [0, T). Epilogue: y += res (if given);
// out = y (if given); acc += acc_scale * y (if given). res may alias out:
// each element is read and written by the same thread, from its own
// accumulator fragment. x never aliases out.
//
// Bound: 2*T*C^2*126 FLOP per stage against <= 20 MB of activations, so
// it is operation-bound. In fp32 FMA (csrc/mrf.cu) the card caps it at
// 67 TFLOP/s; here it is an implicit GEMM on the tensor cores in 3xTF32:
// every operand v is split as hi = tf32_rna(v), lo = tf32_rna(v - hi), and
// the products hi*hi + hi*lo + lo*hi are summed in the fp32 accumulators
// (the dropped lo*lo term is ~2^-22 of each product), which keeps fp32
// accuracy at a third of the 495 TFLOP/s TF32 rate. Single-pass TF32
// (10-bit mantissas) lands hundreds of times further from fp32 in the
// arithmetic's emulation (tests/test_torch_mrf_tc.py).
//
// One-pass variant: built with -DMRF_TC_PASSES=1 (ops/mrf.py:build_tc(1)),
// each product is hi*hi alone: one TF32 pass, the counterpart of the Pallas
// MRF's single default-precision dot (radtts_tpu/ops/pallas_mrf.py:55-63).
// The loads, the weight pack and the split stay as they are; only the lo
// products go. Its plain version is ops/mrf.py:mrf_plain(..., passes=1).
// csrc/mrf_tf32.cu, designed for one pass, replaced it as the route of
// --matmul_precision default; this build runs only when asked for by name
// (ops/mrf.py:mrf_cuda(..., route="tc", passes=1)), as its "before".
//
// Design (one block = a TM x TN output tile of one batch item, TM = 64 *
// NWG time rows, TN output channels; M = time, N = C_out, K = taps x C_in):
//  - NWG consumer warpgroups run wgmma.m64nTNk8.f32.tf32.tf32 with A in
//    registers and B from shared memory; one producer warp keeps loads in
//    flight through mbarrier rings (2 activation slabs, 3 weight stages).
//  - A (activations) come from registers: tf32 wgmma reads shared-memory
//    operands only K-major, and tap j reads the slab shifted by j*d rows,
//    d in {1, 3, 5}. A K-major plane in which each 4-channel group holds
//    all its rows contiguously would express any such shift as a
//    descriptor start 16*j*d bytes further on, as the narrow kernel below
//    and csrc/mrf_tf32.cu do; this kernel keeps its register operands, and
//    with them the per-tap fragment loads. The producer stages, once
//    per chunk of kCK input channels, the slab of rows [t0 - pad, t0 + TM +
//    pad) with cp.async, whose zero fill for a source size of 0 is the
//    conv's zero padding (rows outside [0, T) of this item, never the
//    neighbouring item). Slab rows are padded to kCK + 4 floats, so the
//    fragment loads (8 rows x 4 columns per warp) hit 32 distinct banks.
//    TMA is not used for the slab: its tensor map comes from libcuda's
//    cuTensorMapEncodeTiled, and an unpadded box would make those loads
//    8-way bank conflicts. Each consumer thread loads its fragment at row
//    offset j*d, applies leaky ReLU (lrelu(0) = 0 keeps the padding zero)
//    and splits it into hi/lo.
//  - B (weights) must be K-major: per tap (C_out, C_in), as hi and lo
//    planes. The wrapper packs w (k, C_in, C_out) once per weight version
//    (ops/mrf.py:stage_pack, tc_pack), so weights that change every
//    training step are never stale, into the order in which the kernel
//    streams it: per (tap, C_out tile, C_in chunk) one contiguous block of
//    two planes, each in wgmma's no-swizzle core-matrix layout (8 rows x 16
//    bytes per core matrix; K-direction stride LBO = TN * 16 bytes,
//    8-row-group stride SBO = 128 bytes). The producer fetches each block
//    with one bulk copy (cp.async.bulk) that completes on an mbarrier. All
//    taps' planes of a chunk at C=256, k=11 would exceed shared memory, so
//    B streams per (chunk, tap).
//  - Per tap, each consumer thread loads and splits all of its A fragments
//    (kCK / 8 k-steps) before the tap's first wgmma, issues the tap's
//    3 * kCK / 8 wgmmas as one group, and waits for that group before it
//    releases the weight stage and writes the next tap's fragments. Letting
//    the next tap's fragments be written while the group was still in
//    flight (wgmma.wait_group 1) gave occasional wrong outputs on the card
//    at TN=64, NWG=2 (four warpgroups per SM): wgmma reads its register
//    operands asynchronously. The overlap of loads with products comes
//    from the other warpgroups on the SM and from the producer warp.
//  - Tiles: the host picks (TN, NWG) per C (ops/mrf.py:tc_tile), the
//    fastest of the four on the card (chip_smoke.py, mrf_tc_tiles). At
//    C=256 and 4864 frames that is 128 x 128 in 76 blocks, though 132 SMs
//    are left part idle: the 152-block shapes do the same A-fragment work
//    per element for half the products (TN=64), or run one warpgroup per
//    block, whose fragment preparation leaves the tensor cores idle
//    (NWG=1), and both measured slower.
//  - Padded widths (cp > C): the slab's padded channels are cp.async's
//    zero fill (source size 0), the packed taps' padded rows and columns
//    are zero, and the epilogue skips the padded output channels. These
//    tests are compiled only into the PAD instances, which run the padded
//    widths, so the widths that are their own tile width test no channel.
//  - A wait on an mbarrier that does not complete within ~2 s traps, so a
//    fault in the pipeline ends the launch with an error instead of a hang.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

#ifndef MRF_TC_PASSES
#define MRF_TC_PASSES 3
#endif
static_assert(MRF_TC_PASSES == 1 || MRF_TC_PASSES == 3,
              "MRF_TC_PASSES: 3 (3xTF32) or 1 (one TF32 pass)");

namespace {

constexpr int kCK = 32;                // input channels per chunk
constexpr int kSlabStride = kCK + 4;   // floats per slab row
constexpr int kMaxTaps = 11;
constexpr int kMaxHalo = 50;           // (kMaxTaps - 1) * largest dilation (5)
constexpr int kStagesA = 2;
constexpr int kStagesB = 3;
constexpr long long kWaitTrapCycles = 1LL << 32;
constexpr int kMaxDevices = 64;        // per-device caches of the launchers

template <int TN, int NWG>
struct Layout {
  static constexpr int TM = 64 * NWG;
  static constexpr int kThreads = 128 * NWG + 32;
  static constexpr int kSlabFloats = (TM + kMaxHalo) * kSlabStride;
  static constexpr int kBFloats = 2 * TN * kCK;   // hi and lo planes
  static constexpr size_t kBytes =
      (size_t)(kStagesB * kBFloats + kStagesA * kSlabFloats) * 4 +
      sizeof(uint64_t) * 2 * (kStagesA + kStagesB);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > kWaitTrapCycles) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The barrier gets one arrival once all of this thread's earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, completion tracked by this thread's bulk async-groups
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// wgmma shared-memory descriptor, no swizzle: start address, leading
// (K-direction) byte offset, stride (8-row-group) byte offset, all >> 4.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma group boundaries.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int TN>
__device__ __forceinline__ void wgmma(float (&d)[TN / 2], const uint32_t (&a)[4],
                                      uint64_t desc_b) {
  if constexpr (TN == 128)
    wgmma_n128(d, a, desc_b);
  else
    wgmma_n64(d, a, desc_b);
}

// The same products with A from shared memory too (both descriptors).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b) {
  if constexpr (N == 192)
    wgmma_ss_n192(d, desc_a, desc_b);
  else if constexpr (N == 128)
    wgmma_ss_n128(d, desc_a, desc_b);
  else if constexpr (N == 96)
    wgmma_ss_n96(d, desc_a, desc_b);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, desc_a, desc_b);
  else
    wgmma_ss_n32(d, desc_a, desc_b);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Epilogue of a TM x CP tile (the narrow kernel): y = frag + bias (+ res);
// out = y, or acc += acc_scale * y. frag[4 jn + 2 h + e] is row r0 + 8 h of
// the tile, channel 8 jn + 2 tig + e. The tile's C real channels are staged
// row-major (row stride C) in shared memory: the store warp fills it with
// the tile's rows of res (when the launch has one) before the consumers
// get there and writes it out with one bulk copy after them, so res and the
// output move by bulk copies that overlap the products. PAD (C < CP): the
// padded channels [C, CP) are neither staged nor stored (C % 4 == 0, so a
// thread's pair of channels is both real or both padded); without it no
// channel is tested. acc_old, only in the launch that accumulates, is read
// into registers (load_acc; rows at and past T read as 0).
template <int CP>
struct AccInputs {
  float2 v[CP / 8][2];
};

template <int CP, bool PAD>
__device__ __forceinline__ void load_acc(AccInputs<CP>& in, const float* acc,
                                         int b, int T, int C, int t0, int r0,
                                         int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + r0 + 8 * h;
#pragma unroll
    for (int jn = 0; jn < CP / 8; ++jn) {
      const int co = 8 * jn + 2 * tig;
      const size_t idx = ((size_t)b * T + t) * C + co;
      in.v[jn][h] = t < T && (!PAD || co < C)
                        ? *reinterpret_cast<const float2*>(&acc[idx])
                        : make_float2(0.f, 0.f);
    }
  }
}

template <int CP, bool PAD>
__device__ __forceinline__ void stage_tile(
    const float (&frag)[CP / 2], const AccInputs<CP>& in,
    const float* __restrict__ bias, float* staged, int C, bool add_res,
    bool accumulate, float acc_scale, int r0, int tig) {
#pragma unroll
  for (int jn = 0; jn < CP / 8; ++jn) {
    if (PAD && 8 * jn + 2 * tig >= C) continue;
    const float2 bv = *reinterpret_cast<const float2*>(&bias[8 * jn + 2 * tig]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* p = reinterpret_cast<float2*>(
          &staged[(r0 + 8 * h) * C + 8 * jn + 2 * tig]);
      float2 y = make_float2(frag[4 * jn + 2 * h] + bv.x,
                             frag[4 * jn + 2 * h + 1] + bv.y);
      if (add_res) {
        const float2 rv = *p;
        y.x += rv.x;
        y.y += rv.y;
      }
      if (accumulate)
        y = make_float2(fmaf(acc_scale, y.x, in.v[jn][h].x),
                        fmaf(acc_scale, y.y, in.v[jn][h].y));
      *p = y;
    }
  }
}

// PAD: C < cp, the padded channels tested (cp == C compiles no test)
template <int TN, int NWG, bool PAD>
__global__ void __launch_bounds__(Layout<TN, NWG>::kThreads)
mrf_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
              const float* __restrict__ bias, const float* res, float* out,
              float* acc, float acc_scale, int T, int C, int cp, int k,
              int d, float slope) {
  using L = Layout<TN, NWG>;
  constexpr int TM = L::TM;
  extern __shared__ __align__(128) float smem[];
  float* b_ring = smem;
  float* a_ring = smem + kStagesB * L::kBFloats;
  uint64_t* a_full =
      reinterpret_cast<uint64_t*>(a_ring + kStagesA * L::kSlabFloats);
  uint64_t* a_empty = a_full + kStagesA;
  uint64_t* b_full = a_empty + kStagesA;
  uint64_t* b_empty = b_full + kStagesB;

  const int t0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int pad = (k - 1) / 2 * d;
  const int n_chunks = cp / kCK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesA; ++s) {
      mbar_init(&a_full[s], 32);          // one cp.async arrival per lane
      mbar_init(&a_empty[s], 128 * NWG);  // every consumer thread
    }
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(&b_full[s], 1);           // expect_tx + the bulk copy
      mbar_init(&b_empty[s], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // Producer warp: per chunk the activation slab, then its k weight
    // stages. Waits on "empty" start at parity 1, which passes at once.
    const float* xb = x + (size_t)b * T * C;
    const int rows = TM + 2 * pad;
    int sa = 0, pa = 0, sb = 0, pb = 0;
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(&a_empty[sa], pa ^ 1);
      float* slab = a_ring + sa * L::kSlabFloats;
      for (int e = lane; e < rows * (kCK / 4); e += 32) {
        const int i = e / (kCK / 4), q = e % (kCK / 4);
        const int t = t0 - pad + i;
        // rows outside the item and the padded channels read as zero
        const bool in = t >= 0 && t < T && (!PAD || c * kCK + 4 * q < C);
        cp_async_16(slab + i * kSlabStride + 4 * q,
                    in ? xb + (size_t)t * C + c * kCK + 4 * q : xb,
                    in ? 16 : 0);
      }
      cp_async_mbar_arrive(&a_full[sa]);
      if (++sa == kStagesA) { sa = 0; pa ^= 1; }
      for (int j = 0; j < k; ++j) {
        mbar_wait(&b_empty[sb], pb ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&b_full[sb], L::kBFloats * 4);
          bulk_copy(b_ring + sb * L::kBFloats,
                    wp + (((size_t)j * gridDim.y + blockIdx.y) * n_chunks +
                          c) * L::kBFloats,
                    L::kBFloats * 4, &b_full[sb]);
        }
        __syncwarp();
        if (++sb == kStagesB) { sb = 0; pb ^= 1; }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumer warpgroups. Fragment rows of this thread: r0 and r0 + 8 of
  // the tile; columns tig and tig + 4 of each k-step of 8 channels.
  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + gid;
  float frag[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) frag[i] = 0.f;
  fence_operand(frag);

  int sa = 0, pa = 0, sb = 0, pb = 0;
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(&a_full[sa], pa);
    const float* slab = a_ring + sa * L::kSlabFloats;
    for (int j = 0; j < k; ++j) {
      // All of the tap's A fragments are in registers before its first
      // wgmma, and the tap's group completes before the next tap writes
      // them: no register that an in-flight wgmma reads is ever written.
      const float* row_a = slab + (r0 + j * d) * kSlabStride + tig;
      const float* row_b = row_a + 8 * kSlabStride;
      uint32_t a_hi[kCK / 8][4], a_lo[kCK / 8][4];
#pragma unroll
      for (int s = 0; s < kCK / 8; ++s) {
        const float v[4] = {row_a[8 * s], row_b[8 * s], row_a[8 * s + 4],
                            row_b[8 * s + 4]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = v[q] >= 0.f ? v[q] : slope * v[q];
          a_hi[s][q] = tf32_rna(a);
          a_lo[s][q] = tf32_rna(a - __uint_as_float(a_hi[s][q]));
        }
      }
      mbar_wait(&b_full[sb], pb);
      const uint32_t b_hi = smem_u32(b_ring + sb * L::kBFloats);
      const uint32_t b_lo = b_hi + TN * kCK * 4;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kCK / 8; ++s) {
        const uint64_t d_hi = make_desc(b_hi + s * TN * 32, TN * 16, 128);
        const uint64_t d_lo = make_desc(b_lo + s * TN * 32, TN * 16, 128);
#if MRF_TC_PASSES == 3
        wgmma<TN>(frag, a_lo[s], d_hi);
        wgmma<TN>(frag, a_hi[s], d_lo);
#endif
        wgmma<TN>(frag, a_hi[s], d_hi);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operand(frag);
      mbar_arrive(&b_empty[sb]);
      if (++sb == kStagesB) { sb = 0; pb ^= 1; }
    }
    // the slab's values are all in registers by now
    mbar_arrive(&a_empty[sa]);
    if (++sa == kStagesA) { sa = 0; pa ^= 1; }
  }
  // Accumulator fragment: frag[4 jn + 2 h + e] is row r0 + 8 h, column
  // 8 jn + 2 tig + e of the tile.
#pragma unroll
  for (int jn = 0; jn < TN / 8; ++jn) {
    const int co = n0 + 8 * jn + 2 * tig;
    if (PAD && co >= C) continue;   // a padded channel (C % 4 == 0: both)
    const float2 bv = *reinterpret_cast<const float2*>(&bias[co]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + 8 * h;
      if (t >= T) continue;
      const size_t idx = ((size_t)b * T + t) * C + co;
      float2 y = make_float2(frag[4 * jn + 2 * h] + bv.x,
                             frag[4 * jn + 2 * h + 1] + bv.y);
      if (res != nullptr) {
        const float2 rv = *reinterpret_cast<const float2*>(&res[idx]);
        y.x += rv.x;
        y.y += rv.y;
      }
      if (out != nullptr) *reinterpret_cast<float2*>(&out[idx]) = y;
      if (acc != nullptr) {
        float2 av = *reinterpret_cast<float2*>(&acc[idx]);
        av.x = fmaf(acc_scale, y.x, av.x);
        av.y = fmaf(acc_scale, y.y, av.y);
        *reinterpret_cast<float2*>(&acc[idx]) = av;
      }
    }
  }
}

template <int TN, int NWG, bool PAD>
int launch(const float* x, const float* wp, const float* bias,
           const float* res, float* out, float* acc, float acc_scale, int B,
           int T, int C, int cp, int k, int d, float slope,
           cudaStream_t stream) {
  using L = Layout<TN, NWG>;
  // the attribute belongs to the current device: set at every launch (a
  // host-side call), so a launch on a second card never runs without it
  const cudaError_t e = cudaFuncSetAttribute(
      mrf_tc_kernel<TN, NWG, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + L::TM - 1) / L::TM, cp / TN, B);
  mrf_tc_kernel<TN, NWG, PAD><<<grid, L::kThreads, L::kBytes, stream>>>(
      x, wp, bias, res, out, acc, acc_scale, T, C, cp, k, d, slope);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The narrow stages, C <= 96: mrf_tc_narrow_kernel<CP, NWG>.
//
// The same implicit GEMM and 3xTF32 split, with N = TN = CP (one block
// reads its slab once for all output channels) and K = all of C_in
// resident at once. CP is the padded width (ops/mrf.py:padded_width): 32,
// 64 or 96, the width C rounded up to a multiple of 32 (C=64 and C=32, the
// HiFi-GAN v1 stages, run unpadded; C=96 takes one warpgroup, NWG = 1,
// since two planes of 179 rows by 96 channels and the raw slab do not fit
// a block's shared memory beside the staged tile). The padded channels [C,
// CP) are exactly zero in every product: their planes' groups are written
// as zeros by the split, their weights are zero (the packed taps are
// zero-padded), and their outputs are never staged or stored. What
// mrf_tc_kernel does per tap, this does once:
//  - Activations are split once per slab, not once per tap. A slab warp
//    stages the tile's rows [t0 - pad, t0 + TM + pad) x C (the real
//    channels, row stride C) into a raw buffer: one bulk copy of the rows
//    inside [0, T) of the item, and zeros for the rest (the conv's
//    padding). The consumer threads then apply leaky ReLU and the hi/lo
//    split to each element once and write two planes, hi and lo, of CP / 4
//    channel groups (zeros at and past C) in wgmma's no-swizzle K-major
//    layout with all rows of a 4-channel group contiguous: the 16-byte unit
//    (group g, slab row i) at (g*kR + i)*16 bytes. A core matrix is then
//    any 8 consecutive rows, so tap j's operand, the slab shifted by j * d
//    rows, is a descriptor whose start is 16 * j * d bytes further (LBO =
//    kR * 16 between channel groups, SBO = 128 between 8-row groups), and A
//    is read from shared memory by the tensor cores: no per-tap fragment
//    loads, conversions or register hazards. kR is odd, so the split's
//    16-byte stores of 8 neighbouring groups hit 8 distinct bank quads.
//  - Weights: the k taps of the conv in (tap, chunk) units, fetched by a
//    weight warp with bulk copies. A unit is one K-major operand of 2CP
//    rows, w's hi plane in rows [0, CP) and its lo plane in [CP, 2CP)
//    (ops/mrf.py:tc_pack_narrow). Per k-step one m64n(2CP)k8 multiplies A's
//    hi plane by both (hi*hi and hi*lo, in accumulator columns [0, CP) and
//    [CP, 2CP)), and one m64nCPk8 multiplies A's lo plane by the first CP
//    rows (lo*hi, a second accumulator; wgmma orders accumulator chains
//    only between instructions of one shape). Against three m64nCPk8 that
//    is one read of A's hi plane fewer per k-step: at C=32 the three
//    products would read 9 KB of shared memory for 48 tensor-core cycles,
//    72 cycles at 128 B per clock, and now read 7 KB. Where all of a conv's
//    units fit (C=32: 11 x 8 KB; C=64 at k=3 with NWG=1) they are loaded
//    once per block and stay; otherwise (C=64, C=96) they stream through a
//    ring per tile, as above.
//  - Persistent blocks: min(tiles, SMs x blocks per SM) blocks walk the
//    (item, time tile) tiles, so resident weights are fetched once per
//    block (at C=32 the 88 KB per conv, once per 1216-tile launch, would
//    otherwise be read 1216 times from L2), and the slab warp fetches the
//    next tile's raw slab while the consumers multiply the current one.
//    Where two pairs of planes fit (C=32), the consumers also split the
//    next slab while the tensor cores work through the current tile.
//  - wgmma groups: one per (tap, chunk) unit, committed as issued; with
//    streamed weights the previous unit's stage is released once
//    wait_group 1 shows its group complete, and each tile ends with
//    wait_group 0 before the accumulators are read. A and B both come from
//    shared memory, so no register that an in-flight wgmma reads is ever
//    written; the planes are rewritten only after every consumer warpgroup
//    has waited for all of its groups (a named barrier), and the split's
//    generic-proxy stores are fenced (fence.proxy.async) before the tensor
//    cores read them.

constexpr int kSmemLimit = 232448;      // per block, sm_90

template <int CP, int NWG>
struct NarrowLayout {
  static constexpr int TM = 64 * NWG;
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 96;   // + slab, weight, store
  static constexpr int kChunks = CP / kCK;
  static constexpr int kRawRows = TM + kMaxHalo;
  static constexpr int kR = TM + kMaxHalo + 1;       // plane rows (odd)
  static constexpr int kRawFloats = kRawRows * CP;
  static constexpr int kPlaneFloats = kR * CP;       // one of hi, lo
  static constexpr int kOutFloats = TM * CP;         // the staged tile
  static constexpr int kUnitFloats = 2 * CP * kCK;   // one (tap, chunk)
  static constexpr int kMaxUnits = kMaxTaps * kChunks;
  static constexpr int kBarBytes = 8 * (4 + 2 * kMaxUnits);
  static constexpr int kOtherFloats = kRawFloats + kOutFloats;
  // two plane buffers (the next tile split while this one multiplies)
  // where they fit beside every weight unit of a conv; else one
  static constexpr int kBufs =
      (4 * kPlaneFloats + kOtherFloats + kMaxUnits * kUnitFloats) * 4 +
                  kBarBytes <= kSmemLimit ? 2 : 1;
  static constexpr int kFixedBytes =
      (kOtherFloats + 2 * kBufs * kPlaneFloats) * 4 + kBarBytes;
  static constexpr int kFit = (kSmemLimit - kFixedBytes) / (kUnitFloats * 4);
  static constexpr int kStages = kFit < kMaxUnits ? kFit : kMaxUnits;
  static constexpr size_t kBytes =
      (size_t)(kStages * kUnitFloats + 2 * kBufs * kPlaneFloats +
               kOtherFloats) * 4 +
      sizeof(uint64_t) * (4 + 2 * kStages);
  static_assert(kStages >= 2, "the weight ring needs two stages");
  static_assert(kBytes <= kSmemLimit, "shared memory per block");
};

__device__ __forceinline__ void consumer_sync(int n_threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n_threads) : "memory");
}

// PAD: c_real < CP, the real width at run time; else C = CP at compile time
template <int CP, int NWG, bool PAD>
__global__ void __launch_bounds__(NarrowLayout<CP, NWG>::kThreads, 1)
mrf_tc_narrow_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                     const float* __restrict__ bias, const float* res,
                     float* out, float* acc, float acc_scale, int B, int T,
                     int c_real, int k, int d, float slope) {
  using L = NarrowLayout<CP, NWG>;
  constexpr int TM = L::TM;
  constexpr int kGroupsP = CP / 4;            // plane groups (16 bytes)
  const int C = PAD ? c_real : CP;
  const int groups = C / 4;                   // real ones, in a slab row
  extern __shared__ __align__(128) float smem[];
  float* w_ring = smem;
  float* planes = w_ring + L::kStages * L::kUnitFloats;  // [buf][hi, lo]
  float* raw = planes + 2 * L::kBufs * L::kPlaneFloats;  // rows x C
  float* staged = raw + L::kRawFloats;                  // TM x C, row-major
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(staged + L::kOutFloats);
  uint64_t* raw_empty = raw_full + 1;
  uint64_t* out_full = raw_empty + 1;      // consumers staged the tile
  uint64_t* out_ready = out_full + 1;      // staging free (and holds res)
  uint64_t* w_full = out_ready + 1;
  uint64_t* w_empty = w_full + L::kStages;

  const int pad = (k - 1) / 2 * d;
  const int rows = TM + 2 * pad;
  const int n_tt = (T + TM - 1) / TM;
  const int n_tiles = B * n_tt;
  const int units = k * L::kChunks;
  const bool resident = units <= L::kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(raw_full, 32);                  // every lane; + the bulk copy
    mbar_init(raw_empty, L::kConsumers);
    mbar_init(out_full, L::kConsumers);
    mbar_init(out_ready, 1);                  // the store warp's lane 0
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&w_full[s], 1);               // expect_tx + the bulk copy
      mbar_init(&w_empty[s], L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // Slab warp: the raw slab of each of this block's tiles, one ahead of
    // the consumers. Its rows inside [0, T) of the item are contiguous in
    // x, so one bulk copy fetches them; rows outside (the conv's zero
    // padding, at the first and last tile of an item) are zeroed by the
    // lanes. Waits on "empty" start at parity 1, which passes.
    int ph = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
      const int lo_t = max(t0 - pad, 0), hi_t = min(t0 + TM + pad, T);
      const int skip = lo_t - (t0 - pad);          // zero rows at the top
      const int n_in = hi_t - lo_t;
      mbar_wait(raw_empty, ph ^ 1);
      for (int e = lane; e < (rows - n_in) * groups; e += 32) {
        const int i = e / groups, g = e % groups;
        const int row = i < skip ? i : i + n_in;
        *reinterpret_cast<float4*>(raw + row * C + 4 * g) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // order these stores before later bulk copies into the same rows
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) {
        const uint32_t bytes = (uint32_t)n_in * C * 4;
        mbar_expect_tx(raw_full, bytes);
        bulk_copy(raw + skip * C, x + ((size_t)b * T + lo_t) * C, bytes,
                  raw_full);
      } else {
        mbar_arrive(raw_full);
      }
      ph ^= 1;
    }
    return;
  }
  if (warp == 4 * NWG + 2) {
    // Store warp: per tile, the tile's rows of res into the staging buffer
    // (or just a release of it), then, once the consumers have staged the
    // result, one bulk copy of it to out or acc (the launch writes one of
    // them). Rows at and past T are neither read nor written.
    float* dst = out != nullptr ? out : acc;
    if (lane == 0) {
      int ph = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
        const size_t row0 = (size_t)b * T + t0;
        const uint32_t bytes = (uint32_t)min(TM, T - t0) * C * 4;
        if (res != nullptr) {
          mbar_expect_tx(out_ready, bytes);
          bulk_copy(staged, res + row0 * C, bytes, out_ready);
        } else {
          mbar_arrive(out_ready);
        }
        mbar_wait(out_full, ph);
        bulk_store(dst + row0 * C, staged, bytes);
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        ph ^= 1;
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    return;
  }
  if (warp == 4 * NWG + 1) {
    // Weight warp: unit u = (tap u / kChunks, chunk u % kChunks), each a
    // contiguous block of wp. Resident: stage u holds unit u for every
    // tile. Otherwise a ring, refilled per tile.
    if (lane == 0) {
      constexpr uint32_t kUnitBytes = L::kUnitFloats * 4;
      if (resident) {
        for (int u = 0; u < units; ++u) {
          mbar_expect_tx(&w_full[u], kUnitBytes);
          bulk_copy(w_ring + u * L::kUnitFloats,
                    wp + (size_t)u * L::kUnitFloats, kUnitBytes, &w_full[u]);
        }
      } else {
        int s = 0, ph = 0;
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
          for (int u = 0; u < units; ++u) {
            mbar_wait(&w_empty[s], ph ^ 1);
            mbar_expect_tx(&w_full[s], kUnitBytes);
            bulk_copy(w_ring + s * L::kUnitFloats,
                      wp + (size_t)u * L::kUnitFloats, kUnitBytes, &w_full[s]);
            if (++s == L::kStages) { s = 0; ph ^= 1; }
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups: wg owns rows [64 wg, 64 wg + 64) of each tile.
  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + gid;
  const uint32_t w_s = smem_u32(w_ring);
  int ph = 0, s = 0, wph = 0, oph = 0;

  // raw slab -> lrelu -> hi/lo planes of buffer buf, once per element;
  // the padded groups [C / 4, CP / 4) as zeros
  auto split = [&](int buf) {
    float* hi = planes + 2 * buf * L::kPlaneFloats;
    float* lo = hi + L::kPlaneFloats;
    mbar_wait(raw_full, ph);
    for (int e = threadIdx.x; e < rows * kGroupsP; e += L::kConsumers) {
      const int i = e / kGroupsP, g = e % kGroupsP;
      const float4 v =
          !PAD || g < groups
              ? *reinterpret_cast<const float4*>(raw + i * C + 4 * g)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float a[4] = {v.x >= 0.f ? v.x : slope * v.x,
                          v.y >= 0.f ? v.y : slope * v.y,
                          v.z >= 0.f ? v.z : slope * v.z,
                          v.w >= 0.f ? v.w : slope * v.w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h[q] = tf32_rna(a[q]);
        l[q] = tf32_rna(a[q] - __uint_as_float(h[q]));
      }
      const int off = (g * L::kR + i) * 4;
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    mbar_arrive(raw_empty);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    ph ^= 1;
  };

  int buf = 0;
  if (L::kBufs == 2 && (int)blockIdx.x < n_tiles) {
    split(0);
    consumer_sync(L::kConsumers);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
    if (L::kBufs == 1) {
      // every warpgroup has waited for all wgmma groups of the last tile,
      // so the planes are free
      consumer_sync(L::kConsumers);
      split(0);
      consumer_sync(L::kConsumers);
    }
    // acc's old values: before the products where the registers allow,
    // else (CP = 96) after them
    constexpr bool kAccEarly = CP <= 64;
    AccInputs<CP> in;
    if (kAccEarly && acc != nullptr)
      load_acc<CP, PAD>(in, acc, b, T, C, t0, r0, tig);

    const uint32_t hi_s = smem_u32(planes + 2 * buf * L::kPlaneFloats);
    const uint32_t lo_s = hi_s + L::kPlaneFloats * 4;
    // acc_w: columns [0, CP) sum hi*hi, [CP, 2CP) hi*lo; acc_l: lo*hi (one
    // pass: acc_l sums hi*hi, acc_w is unused)
    constexpr int kW = MRF_TC_PASSES == 3 ? CP : 1;
    float acc_w[kW], acc_l[CP / 2];
#pragma unroll
    for (int i = 0; i < kW; ++i) acc_w[i] = 0.f;
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) acc_l[i] = 0.f;
    fence_operand(acc_w);
    fence_operand(acc_l);
    int prev = -1;
    for (int u = 0; u < units; ++u) {
      const int j = u / L::kChunks, c = u % L::kChunks;
      const int st = resident ? u : s;
      mbar_wait(&w_full[st], resident ? 0 : wph);
      const uint32_t b_s = w_s + st * L::kUnitFloats * 4;
      const uint32_t a_row = (64 * wg + j * d) * 16;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kCK / 8; ++q) {
        // k-step q: channel groups 8c + 2q and 8c + 2q + 1
        const uint32_t a_off = (8 * c + 2 * q) * L::kR * 16 + a_row;
        const uint64_t da_hi = make_desc(hi_s + a_off, L::kR * 16, 128);
        const uint64_t da_lo = make_desc(lo_s + a_off, L::kR * 16, 128);
        const uint64_t db = make_desc(b_s + q * CP * 64, CP * 32, 128);
#if MRF_TC_PASSES == 3
        wgmma_ss<2 * CP>(acc_w, da_hi, db);
        wgmma_ss<CP>(acc_l, da_lo, db);     // the first CP rows: hi
#else
        (void)da_lo;
        wgmma_ss<CP>(acc_l, da_hi, db);     // hi*hi alone, in acc_l
#endif
      }
      wgmma_commit();
      // with two buffers, the next tile's split runs while the tensor
      // cores work through the first unit's group
      if (L::kBufs == 2 && u == 0 && tile + (int)gridDim.x < n_tiles)
        split(buf ^ 1);
      if (!resident) {
        wgmma_wait<1>();          // the previous unit's group is complete
        if (prev >= 0) mbar_arrive(&w_empty[prev]);
        prev = s;
        if (++s == L::kStages) { s = 0; wph ^= 1; }
      }
    }
    wgmma_wait<0>();
    fence_operand(acc_w);
    fence_operand(acc_l);
    if (prev >= 0) mbar_arrive(&w_empty[prev]);
    if (!kAccEarly && acc != nullptr)
      load_acc<CP, PAD>(in, acc, b, T, C, t0, r0, tig);
    // acc_w[i + CP / 2] is the same row and channel as acc_w[i] and
    // acc_l[i]
    float frag[CP / 2];
#pragma unroll
    for (int i = 0; i < CP / 2; ++i) {
#if MRF_TC_PASSES == 3
      frag[i] = acc_w[i] + (acc_w[i + CP / 2] + acc_l[i]);
#else
      frag[i] = acc_l[i];
#endif
    }
    mbar_wait(out_ready, oph);    // the last tile's store has read it
    stage_tile<CP, PAD>(frag, in, bias, staged, C, res != nullptr,
                        acc != nullptr, acc_scale, r0, tig);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(out_full);
    oph ^= 1;
    if (L::kBufs == 2) {
      // this tile's planes are free (every group waited for) and the next
      // tile's are written and fenced
      consumer_sync(L::kConsumers);
      buf ^= 1;
    }
  }
}

template <int CP, int NWG, bool PAD>
int launch_narrow(const float* x, const float* wp, const float* bias,
                  const float* res, float* out, float* acc, float acc_scale,
                  int B, int T, int C, int k, int d, float slope,
                  cudaStream_t stream) {
  using L = NarrowLayout<CP, NWG>;
  // the attribute at every launch (it belongs to the current device); the
  // grid cap, SMs x resident blocks per SM, cached per device
  static int max_blocks[kMaxDevices] = {};
  cudaError_t e = cudaFuncSetAttribute(
      mrf_tc_narrow_kernel<CP, NWG, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (max_blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mrf_tc_narrow_kernel<CP, NWG, PAD>, L::kThreads,
        L::kBytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks[dev] = sms * per_sm;
  }
  const long long tiles = (long long)B * ((T + L::TM - 1) / L::TM);
  const int grid = (int)(tiles < max_blocks[dev] ? tiles : max_blocks[dev]);
  mrf_tc_narrow_kernel<CP, NWG, PAD>
      <<<grid, L::kThreads, L::kBytes, stream>>>(
          x, wp, bias, res, out, acc, acc_scale, B, T, C, k, d, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes: x, res,
// out, acc (B, T, C) contiguous with C % 4 == 0; wp the k packed taps of
// one conv at the padded width cp (ops/mrf.py:tc_pack_narrow for the narrow
// kernel, else tc_pack with the same tn), zero in the padded rows and
// columns; bias (cp,), zero past C. Requires either tn == cp in {32, 64}
// (nwg 1 or 2) or {96} (nwg 1) with exactly one of out and acc
// (mrf_tc_narrow_kernel), or tn in {64, 128} with cp % tn == 0 and cp >=
// 128 (mrf_tc_kernel); C <= cp < C + 64, nwg in {1, 2}, k odd and <= 11,
// (k - 1) * d <= 50, and 16-byte aligned x, wp, bias, res, out and acc.
extern "C" int radtts_mrf_tc_conv(const float* x, const float* wp,
                                  const float* bias, const float* res,
                                  float* out, float* acc, float acc_scale,
                                  int B, int T, int C, int cp, int k, int d,
                                  float slope, int tn, int nwg,
                                  void* stream) {
  const bool one_out = (out != nullptr) != (acc != nullptr);
  const bool narrow = tn == cp && one_out &&
                      (((cp == 32 || cp == 64) && (nwg == 1 || nwg == 2)) ||
                       (cp == 96 && nwg == 1));
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || cp < C || cp >= C + 64 ||
      !(narrow || ((tn == 64 || tn == 128) && cp % tn == 0 && cp >= 128)) ||
      (nwg != 1 && nwg != 2) || k <= 0 || k % 2 == 0 || k > kMaxTaps ||
      d <= 0 || (k - 1) * d > kMaxHalo || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a padded width tests its channels; the others compile no test
  const bool pad = C != cp;
  if (narrow) {
#define MRF_TC_NARROW(CP_, NWG_)                                           \
  if (cp == CP_ && nwg == NWG_)                                            \
    return pad ? launch_narrow<CP_, NWG_, true>(x, wp, bias, res, out, acc, \
                                                acc_scale, B, T, C, k, d,  \
                                                slope, s)                  \
               : launch_narrow<CP_, NWG_, false>(x, wp, bias, res, out,    \
                                                 acc, acc_scale, B, T, C,  \
                                                 k, d, slope, s);
    MRF_TC_NARROW(96, 1)
    MRF_TC_NARROW(64, 2)
    MRF_TC_NARROW(64, 1)
    MRF_TC_NARROW(32, 2)
    MRF_TC_NARROW(32, 1)
#undef MRF_TC_NARROW
    return (int)cudaErrorInvalidValue;
  }
#define MRF_TC_WIDE(TN_, NWG_)                                               \
  if (tn == TN_ && nwg == NWG_)                                              \
    return pad ? launch<TN_, NWG_, true>(x, wp, bias, res, out, acc,         \
                                         acc_scale, B, T, C, cp, k, d, slope, \
                                         s)                                  \
               : launch<TN_, NWG_, false>(x, wp, bias, res, out, acc,        \
                                          acc_scale, B, T, C, cp, k, d,      \
                                          slope, s);
  MRF_TC_WIDE(128, 2)
  MRF_TC_WIDE(128, 1)
  MRF_TC_WIDE(64, 2)
  MRF_TC_WIDE(64, 1)
#undef MRF_TC_WIDE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at padded width cp and tile (tn, nwg),
// in bytes, and the narrow kernel's weight stages (for the build report);
// 0 for a narrow tile the kernel does not take.
extern "C" int radtts_mrf_tc_smem_bytes(int cp, int tn, int nwg) {
  if (tn == cp) {
    if (cp == 96) return nwg == 1 ? (int)NarrowLayout<96, 1>::kBytes : 0;
    if (cp == 64) return nwg == 2 ? (int)NarrowLayout<64, 2>::kBytes
                                  : (int)NarrowLayout<64, 1>::kBytes;
    if (cp == 32) return nwg == 2 ? (int)NarrowLayout<32, 2>::kBytes
                                  : (int)NarrowLayout<32, 1>::kBytes;
  }
  if (tn == 128) return nwg == 2 ? (int)Layout<128, 2>::kBytes
                                 : (int)Layout<128, 1>::kBytes;
  return nwg == 2 ? (int)Layout<64, 2>::kBytes : (int)Layout<64, 1>::kBytes;
}

extern "C" int radtts_mrf_tc_weight_stages(int cp, int nwg) {
  if (cp == 96) return nwg == 1 ? NarrowLayout<96, 1>::kStages : 0;
  if (cp == 64) return nwg == 2 ? NarrowLayout<64, 2>::kStages
                                : NarrowLayout<64, 1>::kStages;
  return nwg == 2 ? NarrowLayout<32, 2>::kStages : NarrowLayout<32, 1>::kStages;
}
