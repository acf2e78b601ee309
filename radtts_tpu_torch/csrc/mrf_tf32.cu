// One convolution of the HiFi-GAN multi-receptive-field (MRF) resblock
// chain in ONE TF32 pass on Hopper's tensor cores, channels-last, for
// sm_90a: the route of --matmul_precision default (ops/precision.py) at
// every width but the C <= 16 stages of at most 4 resblocks
// (ops/mrf.py:mrf_route(C, passes=1)), in place of csrc/mrf_tc.cu's
// one-pass build. The 3xTF32 kernels of csrc/mrf_tc.cu serve the other
// precisions. A width that is not a multiple of 32 runs padded to
// ops/mrf.py:padded_width(C) (C=24: 32; C=48: 64; C=96 as it is, one
// 96-wide tile; C=160: 192): the slab warp fetches only the C real
// channels, the split writes the padded groups as zeros, the packed taps
// are zero in the padded rows and columns, and the store warps write only
// the real channels, so padding changes no real output. Those channel
// tests are compiled only into the PAD instances, which run the padded
// widths, so C=256, 128, 64 and 32 test no channel.
//
// Replaces, at the JAX package's default matmul precision (a single
// one-pass dot, radtts_tpu/ops/pallas_mrf.py:54-63), the TPU kernels of
// radtts_tpu/ops/pallas_mrf.py: pallas_mrf_wide (:177, C=256, there with
// bf16 weight storage), pallas_mrf (:121, call at :162; C=128 and C=64) and
// pallas_mrf_folded (:231, call at :285; C=32, there with 4 frames folded
// into 128 lanes; here unfolded). The host wrapper (ops/mrf.py:mrf) chains
// 18 launches per stage; one launch computes
//
//   y[b,t,co] = bias[co] + sum_{j<k, ci<C} tf32(w[j,ci,co]) *
//               tf32(lrelu(x[b, t + (j - (k-1)/2) * d, ci]))
//
// with x read as zero outside [0, T) of its item, tf32() rounding to
// nearest with ties away from zero (cvt.rna.tf32.f32; the tensor cores
// would truncate an fp32 operand, so both operands are rounded explicitly)
// and the products summed in fp32. Epilogue: y += res (if given), then out
// = y or acc += acc_scale * y (exactly one of out and acc). res may alias
// out; x never does. Its plain version is ops/mrf.py:mrf_plain(...,
// passes=1).
//
// What bounds it on one H100 SXM:
//  - C=256 and C=128: operations. A stage is 2*T*C^2*126 FLOP, 0.162 ms
//    (1, 4864, 256) and 0.325 ms (1, 38912, 128) at the 495 TFLOP/s TF32
//    rate, above the chain's activation bytes.
//  - C=64 and C=32: bytes. The 18 launches of a stage move 49 whole (B, T,
//    C) tensors through device memory (the mean's zero fill; 2 per first
//    conv, 3 per second conv, 4 for the last, which accumulates): 0.292 ms
//    at 3.35 TB/s for (1, 77824, 64) and (1, 155648, 32), above their TF32
//    bound (0.162 and 0.081 ms). No design that runs one conv a launch
//    beats that floor; only fusing convs would.
//  - In this design the consumers' wgmma issue is the limit: a clock64
//    trace of one block on the card (with a wgmma.fence before every
//    unit, since dropped: 5-12% faster) put a shared-memory-operand
//    m64n32k8.tf32 at ~77 cycles and m64n64k8 at ~107 cycles of the SM's
//    time (16 and 32 at the peak rate), with the split, the loads and the
//    stores off the critical path. At C=64 that leaves it level with
//    csrc/mrf_tc.cu's one-pass build (within the spread between calls);
//    narrow N is what a later design would remove (time along N,
//    m64n256k8). A 128-byte-swizzled plane read through the same shifted
//    descriptors (base offset 0: the swizzle follows absolute address
//    bits) was right but no faster.
// csrc/mrf_tc.cu's one-pass build (-DMRF_TC_PASSES=1) kept the 3xTF32
// design: per tap every consumer thread reloaded, rectified and converted
// its A fragments (each element k times a chunk), waited for the tap's
// group before writing the next tap's registers, and streamed a lo weight
// plane that one pass never reads.
//
// Design (M = time, N = C_out, K = taps x C_in; a tile is TM = 64 * NWG
// time rows of one item by TN output channels; a step is one 32-channel
// chunk of C_in of a tile). Four roles, as warpgroups:
//  - Activations are prepared once per element, not once per tap. The
//    slab warp fetches each step's rows [t0 - pad, t0 + TM + pad) that lie
//    inside [0, T) of the item into a ring of raw buffers (one bulk copy at
//    C=32, where the rows are contiguous; 16-byte cp.async by the lanes
//    otherwise). The split warpgroup applies leaky ReLU and cvt.rna once
//    to each element (rows outside the item become the conv's zero
//    padding) and writes ONE plane in wgmma's no-swizzle K-major layout
//    with all rows of a 4-channel group contiguous: the 16-byte unit (group
//    g, row i) at (g * kR + i) * 16 bytes. A core matrix is then any 8
//    consecutive rows, so tap j's A operand, the slab shifted by j * d rows,
//    is a shared-memory descriptor whose start lies 16 * j * d bytes
//    further on (LBO = kR * 16 between channel groups, SBO = 128 between
//    8-row groups). The tap loop has no fragment loads, no conversions and
//    no register operand that a wgmma in flight reads. kR is odd, so the
//    split's 16-byte stores of 8 neighbouring groups hit 8 distinct bank
//    quads. Two plane buffers: the next step's plane is written while the
//    tensor cores read this one; its generic-proxy stores are fenced
//    (fence.proxy.async.shared::cta) before it is handed over
//    (plane_full), and a buffer is rewritten only once every consumer has
//    waited for the groups that read it (plane_empty).
//  - One weight plane: the wrapper packs tf32_round(w) alone
//    (ops/mrf.py:tf32_pack, cached per weight version) per (tap, C_out
//    tile, C_in chunk) unit of TN x 32 in the core-matrix order, half the
//    bytes of csrc/mrf_tc.cu's hi/lo units. The weight warp fetches units
//    with bulk copies into a ring sized to the shared memory left (4-24
//    stages, static_assert'ed within 232,448 bytes). Where all of a conv's
//    units fit (C=32; C=64 at k=3 with TN=64) they are loaded once per
//    block and stay.
//  - The consumer warpgroups issue one wgmma group per unit, A and B from
//    shared memory, committed as issued; a streamed unit's stage is
//    released once wgmma.wait_group shows its group complete. At TN <= 64
//    the taps alternate between two accumulators, so each warpgroup keeps
//    two independent dependence chains in flight. Tiles are outer and
//    chunks inner, with every group of a tile waited for at its end, so no
//    group is in flight across the tile loop. setmaxnreg gives the
//    consumers the registers the other roles do not need.
//  - Persistent blocks: min(tiles, SMs) blocks walk the (item, time tile,
//    C_out tile) tiles. Two store warps fetch each tile's rows of res into a
//    padded staging buffer (kOutStride, so the consumers' fragment-order
//    accesses hit distinct banks) up to kOutBufs tiles ahead and, once the
//    consumers have staged the result there, write it out with coalesced
//    16-byte stores. acc's old values are read into registers a tile ahead
//    at TN <= 64, while the tile's last groups run at TN = 128.
//  - Tiles: ops/mrf.py:tf32_tile, the fastest (TN, NWG) per width in
//    chip_smoke.py's mrf_tf32_tiles sweep on the card.
//  - A wait on an mbarrier that does not complete within ~2 s traps, so a
//    fault in the pipeline ends the launch with an error instead of a hang.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kCK = 32;                 // C_in per plane chunk and unit
constexpr int kGroups = kCK / 4;        // 16-byte units per plane row
constexpr int kMaxTaps = 11;
constexpr int kMaxHalo = 50;            // (kMaxTaps - 1) * largest dilation
constexpr int kMaxStages = 24;
constexpr int kSmemLimit = 232448;      // per block, sm_90
constexpr long long kWaitTrapCycles = 1LL << 32;
constexpr int kMaxDevices = 64;         // per-device caches of the launcher

template <int TN, int NWG>
struct Layout {
  static constexpr int TM = 64 * NWG;
  static constexpr int kConsumers = 128 * NWG;
  // + a warpgroup of the slab, weight and two store warps, and the split
  // warpgroup
  static constexpr int kThreads = kConsumers + 256;
  // registers a thread after setmaxnreg: the 64K of the SM shared out
  static constexpr int kRegsProducer = 56, kRegsSplit = 88;
  static constexpr int kRegsConsumer =
      (65536 / 128 - kRegsProducer - kRegsSplit) / NWG / 8 * 8 > 232
          ? 232
          : (65536 / 128 - kRegsProducer - kRegsSplit) / NWG / 8 * 8;
  static constexpr int kRawRows = TM + kMaxHalo;
  static constexpr int kR = TM + kMaxHalo + 1;       // plane rows (odd)
  static constexpr int kPlaneFloats = kR * kCK;
  static constexpr int kRawFloats = kRawRows * kCK;
  static constexpr int kOutStride = TN + 8;          // padded staged row
  static constexpr int kOutFloats = TM * kOutStride;
  static constexpr int kUnitFloats = TN * kCK;       // one (tap, chunk)
  // raw slabs and staged tiles in flight: as many as leave the weight ring
  // its stages (TN = 32: every unit of a conv; TN = 64: k <= 3; TN = 96:
  // seven; TN = 128: four)
  static constexpr int kRawBufs = TN == 32 ? 3 : 2;
  static constexpr int kOutBufs = TN >= 96 ? 1 : 2;
  static constexpr int kBars = 4 + 2 * kRawBufs + 2 * kOutBufs;  // + stages
  static constexpr int kFixedFloats =
      2 * kPlaneFloats + kRawBufs * kRawFloats + kOutBufs * kOutFloats;
  static constexpr int kFit =
      (kSmemLimit - kFixedFloats * 4 - 8 * (kBars + 2 * kMaxStages)) /
      (kUnitFloats * 4);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes =
      (size_t)(kStages * kUnitFloats + kFixedFloats) * 4 +
      sizeof(uint64_t) * (kBars + 2 * kStages);
  static_assert(kR % 2 == 1, "plane rows must be odd");
  static_assert(kStages >= 3, "the weight ring needs three stages");
  static_assert(kBytes <= kSmemLimit, "shared memory per block");
  static_assert((kOutStride * 4) % 16 == 0, "staged rows 16-byte aligned");
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

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes global -> shared
__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The barrier gets one arrival once all of this thread's earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma group boundaries.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32) += A (64 x 8) * B (N x 8)^T, both tf32 K-major in
// shared memory.
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

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, desc_a, desc_b);
  else if constexpr (N == 96)
    wgmma_ss_n96(d, desc_a, desc_b);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, desc_a, desc_b);
  else
    wgmma_ss_n32(d, desc_a, desc_b);
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// The tiles a block walks: tile = (item b, time tile, C_out tile nt), the
// C_out tile fastest; a (tile, chunk) step s of this block is tile
// blockIdx.x + (s / n_chunks) * gridDim.x, C_in chunk s % n_chunks.
struct Tiles {
  int n_tt, n_nt, n_chunks, TM;
  __device__ void at(int s, int& b, int& t0, int& nt, int& c) const {
    const int tile = blockIdx.x + (s / n_chunks) * gridDim.x;
    c = s % n_chunks;
    nt = tile % n_nt;
    const int bt = tile / n_nt;
    b = bt / n_tt;
    t0 = (bt % n_tt) * TM;
  }
};

// PAD: C < cp, the padded channels tested (cp == C compiles no test)
template <int TN, int NWG, bool PAD>
__global__ void __launch_bounds__(Layout<TN, NWG>::kThreads, 1)
mrf_tf32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                const float* __restrict__ bias, const float* res, float* out,
                float* acc, float acc_scale, int B, int T, int C, int cp,
                int k, int d, float slope) {
  using L = Layout<TN, NWG>;
  constexpr int TM = L::TM;
  constexpr uint32_t kUnitBytes = L::kUnitFloats * 4;
  // two accumulator chains and acc fetched a tile ahead where the
  // registers allow (TN <= 64)
  constexpr int kChains = TN <= 64 ? 2 : 1;
  constexpr bool kLoadAccEarly = TN <= 64;
  extern __shared__ __align__(128) float smem[];
  float* w_ring = smem;
  float* planes = w_ring + L::kStages * L::kUnitFloats;   // 2 buffers
  float* raw = planes + 2 * L::kPlaneFloats;        // kRawBufs x rows x kCK
  float* staged = raw + L::kRawBufs * L::kRawFloats;  // kOutBufs x TM rows
  uint64_t* raw_full =
      reinterpret_cast<uint64_t*>(staged + L::kOutBufs * L::kOutFloats);
  uint64_t* raw_empty = raw_full + L::kRawBufs;
  uint64_t* out_full = raw_empty + L::kRawBufs;  // consumers staged y
  uint64_t* out_ready = out_full + L::kOutBufs;  // staging free, holds res
  uint64_t* plane_full = out_ready + L::kOutBufs;  // 2: split and fenced
  uint64_t* plane_empty = plane_full + 2;        // 2: its groups complete
  uint64_t* w_full = plane_empty + 2;
  uint64_t* w_empty = w_full + L::kStages;

  const int pad = (k - 1) / 2 * d;
  const int rows = TM + 2 * pad;
  const Tiles tiles{(T + TM - 1) / TM, cp / TN, cp / kCK, TM};
  const int n_tiles = B * tiles.n_tt * tiles.n_nt;
  const int my_tiles =
      (int)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1
                                : 0;
  const int n_steps = my_tiles * tiles.n_chunks;
  // every unit of the block's tiles fits the ring: loaded once, kept
  const bool resident = tiles.n_nt == 1 && k * tiles.n_chunks <= L::kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kRawBufs; ++i) {
      mbar_init(&raw_full[i], 32);            // every lane; + the copies
      mbar_init(&raw_empty[i], 128);          // every split thread
    }
    for (int i = 0; i < L::kOutBufs; ++i) {
      mbar_init(&out_full[i], L::kConsumers);
      mbar_init(&out_ready[i], 64);           // every store-warp lane
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&plane_full[i], 128);         // every split thread
      mbar_init(&plane_empty[i], L::kConsumers);
    }
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&w_full[s], 1);               // expect_tx + the bulk copy
      mbar_init(&w_empty[s], L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG + 4) {
    // Split warpgroup: per step, once the slab has landed and the plane
    // buffer s & 1 is free (the consumers' groups of step s - 2 complete),
    // lrelu and cvt.rna once per element of the slab into the plane:
    // element e = (row e / kGroups, channel group e % kGroups), the 16-byte
    // unit (g, i) of the plane at (g * kR + i) * 16 bytes; rows outside the
    // item and the padded channels (at and past C) as zeros. Loads of a
    // batch are issued together, so a batch pays one shared-memory latency.
    // The generic-proxy stores are fenced for the tensor cores before the
    // plane is handed over.
    regs_dec<L::kRegsSplit>();
    constexpr int kBatch = 4;
    const int stid = threadIdx.x - (L::kConsumers + 128);
    const int n_elems = rows * kGroups;
    for (int s = 0; s < n_steps; ++s) {
      int b, t0, nt, c;
      tiles.at(s, b, t0, nt, c);
      const int first = max(pad - t0, 0);          // rows before t = 0
      const int last = min(T - t0 + pad, rows);    // rows from t = T on
      const int real = (C - c * kCK) / 4;          // groups below C
      const int rb = s % L::kRawBufs;
      const float* slab = raw + rb * L::kRawFloats;
      float* plane = planes + (s & 1) * L::kPlaneFloats;
      mbar_wait(&plane_empty[s & 1], ((s >> 1) & 1) ^ 1);
      mbar_wait(&raw_full[rb], (s / L::kRawBufs) & 1);
      for (int e0 = stid; e0 < n_elems; e0 += 128 * kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int e = e0 + 128 * m;
          const int i = e / kGroups, g = e % kGroups;
          v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (e < n_elems && i >= first && i < last && (!PAD || g < real))
            v[m] = *reinterpret_cast<const float4*>(slab + i * kCK + 4 * g);
        }
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int e = e0 + 128 * m;
          const int i = e / kGroups, g = e % kGroups;
          if (e < n_elems)
            *reinterpret_cast<uint4*>(plane + (g * L::kR + i) * 4) =
                make_uint4(tf32_rna(lrelu(v[m].x, slope)),
                           tf32_rna(lrelu(v[m].y, slope)),
                           tf32_rna(lrelu(v[m].z, slope)),
                           tf32_rna(lrelu(v[m].w, slope)));
        }
      }
      mbar_arrive(&raw_empty[rb]);
      fence_proxy_async();
      mbar_arrive(&plane_full[s & 1]);
    }
    return;
  }
  if (warp >= 4 * NWG) regs_dec<L::kRegsProducer>();
  if (warp == 4 * NWG) {
    // Slab warp: per step the rows of its chunk inside [0, T) of the item
    // into raw buffer s % kRawBufs, up to kRawBufs steps ahead of the
    // split: at C=32 one bulk copy (the rows are contiguous), else 16-byte
    // cp.async by the lanes, of the chunk's groups below C. Waits on
    // "empty" start at parity 1, which passes.
    for (int s = 0; s < n_steps; ++s) {
      int b, t0, nt, c;
      tiles.at(s, b, t0, nt, c);
      const int lo_t = max(t0 - pad, 0), hi_t = min(t0 + TM + pad, T);
      const int skip = lo_t - (t0 - pad);
      const int n_in = hi_t - lo_t;
      const float* src = x + ((size_t)b * T + lo_t) * C + c * kCK;
      const int rb = s % L::kRawBufs;
      float* dst = raw + rb * L::kRawFloats + skip * kCK;
      uint64_t* full = &raw_full[rb];
      const int real = min(kGroups, (C - c * kCK) / 4);
      mbar_wait(&raw_empty[rb], ((s / L::kRawBufs) & 1) ^ 1);
      if (C == kCK && cp == kCK) {
        if (lane == 0) {
          const uint32_t bytes = (uint32_t)n_in * kCK * 4;
          mbar_expect_tx(full, bytes);
          bulk_copy(dst, src, bytes, full);
        } else {
          mbar_arrive(full);
        }
      } else {
        for (int e = lane; e < n_in * kGroups; e += 32)
          if (!PAD || e % kGroups < real)
            cp_async_16(dst + e * 4,
                        src + (size_t)(e / kGroups) * C + 4 * (e % kGroups));
        cp_async_mbar_arrive(full);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  if (warp == 4 * NWG + 1) {
    // Weight warp: unit (tap j, C_out tile nt, chunk c) at ((j * n_nt + nt)
    // * n_chunks + c) units into wp. Resident: stage c * k + j holds it for
    // every tile. Otherwise a ring, in the consumers' order.
    if (lane == 0) {
      if (resident) {
        for (int c = 0; c < tiles.n_chunks; ++c)
          for (int j = 0; j < k; ++j) {
            const int u = c * k + j;
            mbar_expect_tx(&w_full[u], kUnitBytes);
            bulk_copy(w_ring + u * L::kUnitFloats,
                      wp + ((size_t)j * tiles.n_chunks + c) * L::kUnitFloats,
                      kUnitBytes, &w_full[u]);
          }
      } else {
        int st = 0, ph = 0;
        for (int s = 0; s < n_steps; ++s) {
          int b, t0, nt, c;
          tiles.at(s, b, t0, nt, c);
          for (int j = 0; j < k; ++j) {
            mbar_wait(&w_empty[st], ph ^ 1);
            mbar_expect_tx(&w_full[st], kUnitBytes);
            bulk_copy(w_ring + st * L::kUnitFloats,
                      wp + (((size_t)j * tiles.n_nt + nt) * tiles.n_chunks +
                            c) * L::kUnitFloats,
                      kUnitBytes, &w_full[st]);
            if (++st == L::kStages) { st = 0; ph ^= 1; }
          }
        }
      }
    }
    return;
  }
  if (warp >= 4 * NWG + 2) {
    // Store warps (two): the rows of res of this block's tile i into staging
    // buffer i % kOutBufs by 16-byte cp.async (or just a release of the
    // buffer), kOutBufs tiles ahead; once the consumers have staged tile
    // i's result there, the tile to out or acc by coalesced 16-byte stores.
    // The staged rows are padded (kOutStride), so the consumers'
    // fragment-order accesses hit distinct banks. Rows at and past T, and
    // the padded channels at and past C, are neither read nor written.
    float* dst = out != nullptr ? out : acc;
    constexpr int kQ = TN / 4;                 // 16-byte units per row
    const int sl = threadIdx.x - (L::kConsumers + 64);   // 0..63
    auto fetch = [&](int i) {
      int b, t0, nt, c;
      tiles.at(i * tiles.n_chunks, b, t0, nt, c);
      float* buf = staged + (i % L::kOutBufs) * L::kOutFloats;
      uint64_t* ready = &out_ready[i % L::kOutBufs];
      if (res != nullptr) {
        const float* src = res + ((size_t)b * T + t0) * C + nt * TN;
        const int q_real = min(kQ, (C - nt * TN) / 4);
        for (int e = sl; e < min(TM, T - t0) * kQ; e += 64)
          if (!PAD || e % kQ < q_real)
            cp_async_16(buf + (e / kQ) * L::kOutStride + 4 * (e % kQ),
                        src + (size_t)(e / kQ) * C + 4 * (e % kQ));
        cp_async_mbar_arrive(ready);
      } else {
        mbar_arrive(ready);
      }
    };
    for (int i = 0; i < L::kOutBufs && i < my_tiles; ++i) fetch(i);
    for (int i = 0; i < my_tiles; ++i) {
      int b, t0, nt, c;
      tiles.at(i * tiles.n_chunks, b, t0, nt, c);
      const int n_units = min(TM, T - t0) * kQ;
      const int q_real = min(kQ, (C - nt * TN) / 4);
      float* out_t = dst + ((size_t)b * T + t0) * C + nt * TN;
      const float* buf = staged + (i % L::kOutBufs) * L::kOutFloats;
      mbar_wait(&out_full[i % L::kOutBufs], (i / L::kOutBufs) & 1);
#pragma unroll 4
      for (int e = sl; e < n_units; e += 64)
        if (!PAD || e % kQ < q_real)
          *reinterpret_cast<float4*>(&out_t[(size_t)(e / kQ) * C +
                                            4 * (e % kQ)]) =
              *reinterpret_cast<const float4*>(
                  &buf[(e / kQ) * L::kOutStride + 4 * (e % kQ)]);
      __syncwarp();
      if (i + L::kOutBufs < my_tiles) fetch(i + L::kOutBufs);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumer warpgroups: wg owns rows [64 wg, 64 wg + 64) of each tile.
  const int ctid = threadIdx.x;
  const int wg = warp / 4, gid = lane / 4, tig = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + gid;
  const uint32_t w_s = smem_u32(w_ring);
  const uint32_t planes_s = smem_u32(planes);
  // Streamed units: `issued` so far; stage issued % kStages, its parity
  // (issued / kStages) & 1; stages of units below `released` are free.
  int issued = 0, released = 0;
  auto release = [&](int keep) {   // all units but the last `keep` done
    if (resident) return;
    for (; released < issued - keep; ++released)
      mbar_arrive(&w_empty[released % L::kStages]);
  };
  // One wgmma group: unit (chunk c, tap j) of the tile into accumulator f,
  // A from plane buffer at a_s.
  auto unit = [&](auto& f, uint32_t a_s, int c, int j) {
    uint32_t b_s;
    if (resident) {
      const int u = c * k + j;
      mbar_wait(&w_full[u], 0);
      b_s = w_s + u * kUnitBytes;
    } else {
      const int st = issued % L::kStages;
      mbar_wait(&w_full[st], (issued / L::kStages) & 1);
      b_s = w_s + st * kUnitBytes;
    }
#pragma unroll
    for (int q = 0; q < kCK / 8; ++q) {
      // k-step q: channel groups 2q and 2q + 1; tap j: j * d rows on
      const uint64_t da =
          make_desc(a_s + (2 * q * L::kR + j * d) * 16, L::kR * 16, 128);
      const uint64_t db = make_desc(b_s + q * TN * 32, TN * 16, 128);
      wgmma_ss<TN>(f, da, db);
    }
    wgmma_commit();
    ++issued;
  };

  regs_inc<L::kRegsConsumer>();
  int pending = -1;   // the step whose plane awaits release
  // acc's old values of this block's tile i, frag's layout (rows at and
  // past T and the padded channels read as 0)
  auto load_acc = [&](float2 (&v)[TN / 8][2], int i) {
    int b, t0, nt, c;
    tiles.at(i * tiles.n_chunks, b, t0, nt, c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + 8 * h;
#pragma unroll
      for (int jn = 0; jn < TN / 8; ++jn) {
        const int co = nt * TN + 8 * jn + 2 * tig;
        v[jn][h] = t < T && (!PAD || co < C)
                       ? *reinterpret_cast<const float2*>(
                             &acc[((size_t)b * T + t) * C + co])
                       : make_float2(0.f, 0.f);
      }
    }
  };
  // at TN <= 64 a tile ahead, so they arrive during the tile before; at
  // TN = 128, where the registers are short, while its last groups are in
  // flight
  float2 acc_old[TN / 8][2], acc_next[TN / 8][2];
  if (kLoadAccEarly && acc != nullptr && my_tiles > 0) load_acc(acc_next, 0);
  // Tiles outer, chunks inner: every wgmma group of a tile is waited for
  // at its end, before the next tile zeroes the accumulators, so no group
  // is in flight across the tile loop and ptxas need not serialize them.
  for (int i = 0, s = 0; i < my_tiles; ++i) {
    int b, t0, nt, c;
    tiles.at(s, b, t0, nt, c);
    const int col0 = nt * TN;
    if (kLoadAccEarly && acc != nullptr) {
#pragma unroll
      for (int jn = 0; jn < TN / 8; ++jn)
        acc_old[jn][0] = acc_next[jn][0], acc_old[jn][1] = acc_next[jn][1];
      if (i + 1 < my_tiles) load_acc(acc_next, i + 1);
    }
    // kChains accumulators, taps alternating between them: independent
    // wgmma chains, so the tensor cores overlap two of each warpgroup's
    // dependent sequences
    float frag[TN / 2], frag1[TN / 2];
#pragma unroll
    for (int f = 0; f < TN / 2; ++f) frag[f] = frag1[f] = 0.f;
    fence_operand(frag);
    fence_operand(frag1);
    // the zeroing is the only register access to the accumulators before
    // the tile's wgmmas; between units only wgmmas of one shape touch
    // them, which need no fence
    wgmma_fence();
    for (c = 0; c < tiles.n_chunks; ++c, ++s) {
      mbar_wait(&plane_full[s & 1], (s >> 1) & 1);
      const uint32_t a_s =
          planes_s + (s & 1) * L::kPlaneFloats * 4 + 64 * wg * 16;
      for (int j = 0; j < k; ++j) {
        if (kChains == 2 && (j & 1))
          unit(frag1, a_s, c, j);
        else
          unit(frag, a_s, c, j);
        if (j == 0) {
          // this warpgroup's groups of the last step are complete: its
          // plane buffer may be split into again
          wgmma_wait<1>();
          release(1);
          if (pending >= 0) mbar_arrive(&plane_empty[pending & 1]);
          pending = -1;
        } else if (!resident) {
          // the unit kChains back is complete: its stage is free
          wgmma_wait<kChains>();
          release(kChains);
        }
      }
      pending = s;
    }
    if (!kLoadAccEarly && acc != nullptr) load_acc(acc_old, i);
    wgmma_wait<0>();
    fence_operand(frag);
    fence_operand(frag1);
    release(0);
    mbar_arrive(&plane_empty[pending & 1]);
    pending = -1;
    if (kChains == 2) {
#pragma unroll
      for (int f = 0; f < TN / 2; ++f) frag[f] += frag1[f];
    }

    // The tile's epilogue, once the staging buffer's last tile is stored
    // and this tile's res fetched. frag[4 jn + 2 h + e] is row r0 + 8 h,
    // column 8 jn + 2 tig + e of the tile.
    float* buf = staged + (i % L::kOutBufs) * L::kOutFloats;
    mbar_wait(&out_ready[i % L::kOutBufs], (i / L::kOutBufs) & 1);
#pragma unroll
    for (int jn = 0; jn < TN / 8; ++jn) {
      const float2 bv =
          *reinterpret_cast<const float2*>(&bias[col0 + 8 * jn + 2 * tig]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* p = reinterpret_cast<float2*>(
            &buf[(r0 + 8 * h) * L::kOutStride + 8 * jn + 2 * tig]);
        float2 y = make_float2(frag[4 * jn + 2 * h] + bv.x,
                               frag[4 * jn + 2 * h + 1] + bv.y);
        if (res != nullptr) {
          const float2 rv = *p;
          y.x += rv.x;
          y.y += rv.y;
        }
        if (acc != nullptr)
          y = make_float2(fmaf(acc_scale, y.x, acc_old[jn][h].x),
                          fmaf(acc_scale, y.y, acc_old[jn][h].y));
        *p = y;
      }
    }
    mbar_arrive(&out_full[i % L::kOutBufs]);
  }
}

template <int TN, int NWG, bool PAD>
int launch(const float* x, const float* wp, const float* bias,
           const float* res, float* out, float* acc, float acc_scale, int B,
           int T, int C, int cp, int k, int d, float slope,
           cudaStream_t stream) {
  using L = Layout<TN, NWG>;
  // the attribute at every launch (it belongs to the current device); the
  // grid cap, SMs x resident blocks per SM, cached per device
  static int max_blocks[kMaxDevices] = {};
  cudaError_t e = cudaFuncSetAttribute(
      mrf_tf32_kernel<TN, NWG, PAD>,
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
        &per_sm, mrf_tf32_kernel<TN, NWG, PAD>, L::kThreads, L::kBytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks[dev] = sms * per_sm;
  }
  const long long tiles =
      (long long)B * ((T + L::TM - 1) / L::TM) * (cp / TN);
  const int grid = (int)(tiles < max_blocks[dev] ? tiles : max_blocks[dev]);
  mrf_tf32_kernel<TN, NWG, PAD><<<grid, L::kThreads, L::kBytes, stream>>>(
      x, wp, bias, res, out, acc, acc_scale, B, T, C, cp, k, d, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Shapes: x, res,
// out, acc (B, T, C) contiguous with C % 4 == 0; wp the k packed taps of
// one conv at the padded width cp (ops/mrf.py:tf32_pack with the same tn),
// zero in the padded rows and columns; bias (cp,), zero past C. Requires
// cp % 32 == 0, C <= cp < C + 64, tn in {32, 64, 96, 128} dividing cp, nwg
// in {1, 2}, exactly one of out and acc, k odd and <= 11, (k - 1) * d <=
// 50, and 16-byte aligned x, wp, bias, res, out and acc.
extern "C" int radtts_mrf_tf32_conv(const float* x, const float* wp,
                                    const float* bias, const float* res,
                                    float* out, float* acc, float acc_scale,
                                    int B, int T, int C, int cp, int k, int d,
                                    float slope, int tn, int nwg,
                                    void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || cp % kCK != 0 ||
      cp < C || cp >= C + 64 ||
      !(tn == 32 || tn == 64 || tn == 96 || tn == 128) || cp % tn != 0 ||
      (nwg != 1 && nwg != 2) || (out != nullptr) == (acc != nullptr) ||
      k <= 0 || k % 2 == 0 || k > kMaxTaps || d <= 0 ||
      (k - 1) * d > kMaxHalo)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a padded width tests its channels; the others compile no test
  const bool pad = C != cp;
#define MRF_TF32_LAUNCH(TN_, NWG_)                                           \
  if (tn == TN_ && nwg == NWG_)                                              \
    return pad ? launch<TN_, NWG_, true>(x, wp, bias, res, out, acc,         \
                                         acc_scale, B, T, C, cp, k, d, slope, \
                                         s)                                  \
               : launch<TN_, NWG_, false>(x, wp, bias, res, out, acc,        \
                                          acc_scale, B, T, C, cp, k, d,      \
                                          slope, s);
  MRF_TF32_LAUNCH(128, 2)
  MRF_TF32_LAUNCH(128, 1)
  MRF_TF32_LAUNCH(96, 2)
  MRF_TF32_LAUNCH(96, 1)
  MRF_TF32_LAUNCH(64, 2)
  MRF_TF32_LAUNCH(64, 1)
  MRF_TF32_LAUNCH(32, 2)
  MRF_TF32_LAUNCH(32, 1)
#undef MRF_TF32_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block and its weight stages at tile (tn,
// nwg), for the build report; 0 for a tile the kernel does not take.
extern "C" int radtts_mrf_tf32_smem_bytes(int tn, int nwg) {
#define MRF_TF32_Q(TN_, NWG_) \
  if (tn == TN_ && nwg == NWG_) return (int)Layout<TN_, NWG_>::kBytes;
  MRF_TF32_Q(128, 2) MRF_TF32_Q(128, 1) MRF_TF32_Q(96, 2) MRF_TF32_Q(96, 1)
  MRF_TF32_Q(64, 2) MRF_TF32_Q(64, 1) MRF_TF32_Q(32, 2) MRF_TF32_Q(32, 1)
#undef MRF_TF32_Q
  return 0;
}

extern "C" int radtts_mrf_tf32_weight_stages(int tn, int nwg) {
#define MRF_TF32_Q(TN_, NWG_) \
  if (tn == TN_ && nwg == NWG_) return Layout<TN_, NWG_>::kStages;
  MRF_TF32_Q(128, 2) MRF_TF32_Q(128, 1) MRF_TF32_Q(96, 2) MRF_TF32_Q(96, 1)
  MRF_TF32_Q(64, 2) MRF_TF32_Q(64, 1) MRF_TF32_Q(32, 2) MRF_TF32_Q(32, 1)
#undef MRF_TF32_Q
  return 0;
}
