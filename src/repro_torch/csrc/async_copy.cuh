// Asynchronous copies from global to shared memory, as inline PTX for
// sm_90a; kernels/build.py digests this header with each source, so an
// edit rebuilds both users.
//
// * bulk:: (probe.cu) Hopper's 1-D bulk copy, one thread moving a whole
//   contiguous piece with no tensor map, and the shared-memory barrier
//   (mbarrier) that counts its bytes.  One thread initialises a barrier
//   with its count of arrivals and fences the initialisation; every
//   arriving thread announces the bytes it will copy (arrive_expect_tx)
//   before it issues them, so the barrier's phase completes only when
//   every arrival is in and every announced byte has landed.  Source,
//   destination and size of a bulk copy are multiples of 16 bytes.
// * cp_async:: (embedding_bag.cu) a thread's own 16-byte copies,
//   committed in groups and waited for by the same thread, which alone
//   reads what they bring.
#pragma once

#include <cstdint>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Before any thread waits on the barrier: init, fence, then __syncthreads().
__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more to land (0 is a plain arrival).
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Copies `bytes` from global `src` to this block's shared `dst`; the bytes
// complete on `bar`.
__device__ __forceinline__ void copy(void* dst, const void* src,
                                     uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace bulk

namespace cp_async {

// 16 bytes from global `src` to shared `dst`, both 16 B aligned, around L1.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(bulk::smem_addr(dst)), "l"(src) : "memory");
}

// Closes this thread's current group of copies (an empty group is fine).
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's newest groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

}  // namespace cp_async
