// The handoff between the blocks of a persistent cooperative launch, and the
// cp.async copies the persistent kernels prefetch with; shared by
// csrc/ar_scan.cu (its resident kernel and the handoff probe) and
// csrc/lstm.cu. ops/cuda_build.py hashes this header into every library's
// name, so a change here rebuilds both.

#pragma once

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The handoff of one phase. Every thread has written its outputs; the
// block's thread 0 makes one release-add on the phase's counter (if the
// block owns rows of it), then spins on an acquire-load until the count
// reaches target = frames so far x the phase's producers. The counter only
// grows: no reset, no generation word. Data written inside the launch is
// then read with ld.global.cg. handoff_arrive and handoff_wait are its two
// halves, for a block with work that no other block reads (its own
// outputs, its next prefetch) to do between them while the others arrive.
__device__ __forceinline__ void handoff_arrive(unsigned int* ctr,
                                               bool producer) {
  __syncthreads();
  if (threadIdx.x == 0 && producer)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr)
                 : "memory");
}

__device__ __forceinline__ void handoff_wait(unsigned int* ctr,
                                             unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(ctr)
                   : "memory");
    } while (v < target);
  }
  __syncthreads();
}

__device__ __forceinline__ void handoff(unsigned int* ctr, bool producer,
                                        unsigned int target) {
  handoff_arrive(ctr, producer);
  handoff_wait(ctr, target);
}

}  // namespace
