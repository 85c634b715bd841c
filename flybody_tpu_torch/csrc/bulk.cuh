// One-dimensional bulk asynchronous copies (Hopper's TMA without a tensor
// map) from global into shared memory, completing on an mbarrier, and from
// shared into global memory, completing in bulk groups. The Newton kernels
// (newton.cu) stage each env's contiguous slabs with them: one thread
// announces the bytes of a stage on its barrier and issues one copy a slab;
// every thread of the block then waits on the barrier's phase. The
// position stage (pos_stage.cu) writes its outputs' slabs back with them:
// every thread that wrote the slabs fences (fence_proxy_async), the block
// synchronises, one thread issues the stores and commits them, and waits
// for their reads of shared memory before the block ends. Addresses and
// sizes must be multiples of 16 bytes; load_floats and store_floats move
// a slab at any 4-byte alignment, its aligned middle in bulk (the contact
// rows; the older kernels take _cuda.bulk_mask and fall back to element
// copies instead).
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the barrier expects `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: arrive on the barrier and add `bytes` to the transfers the
// current phase waits for.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Copies `bytes` from global src to shared dst; completes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier generic accesses to shared memory (after a
// block barrier: every thread's) before later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Copies `bytes` from shared src to global dst, in the current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// Closes the current bulk group of this thread's stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until every committed bulk store of this thread has read its
// shared memory (the writes to global memory may still be in flight).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// One float, or 16 bytes (both addresses 16-byte aligned), from global
// into shared memory by an asynchronous copy (cp.async: no register
// staging, so a thread keeps many in flight); cp_async_wait_all waits for
// the thread's own copies. Many scattered 4-byte copies issue slowly: the
// SM throttles their requests.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Floats a shared staging buffer leaves before a slab bound for (or from)
// `g`, so that the two agree modulo 16 bytes: the slab then starts at
// stage + stage_shift(g), stage 16-byte aligned with 3 floats of room.
__device__ __forceinline__ int stage_shift(const float* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// The 16-byte aligned middle of n floats at g: the floats before it
// (head) and its length (body, a multiple of 4).
struct Span {
  int head, body;
};

__device__ __forceinline__ Span aligned_span(const float* g, int n) {
  Span s;
  s.head = (4 - stage_shift(g)) & 3;
  if (s.head > n) s.head = n;
  s.body = (n - s.head) & ~3;
  return s;
}

// n floats at global src into a staged slab (dst = stage +
// stage_shift(src)), at any 4-byte alignment: thread 0 issues the bulk
// copy of the aligned middle on bar (whose expected bytes it announced:
// 4 * aligned_span(src, n).body), threads t of nt load the at most 3 + 3
// floats around it.
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int n, int t, int nt,
                                            uint64_t* bar) {
  const Span sp = aligned_span(src, n);
  if (t == 0 && sp.body > 0)
    bulk_load(dst + sp.head, src + sp.head, 4u * sp.body, bar);
  for (int i = t; i < n - sp.body; i += nt) {
    const int j = i < sp.head ? i : i + sp.body;
    dst[j] = src[j];
  }
}

// Thread t of nt stores n floats of a staged slab (src = stage +
// stage_shift(dst)) to global dst, at any 4-byte alignment: the 16-byte
// aligned middle by one bulk store, issued and committed by thread 0, and
// the at most 3 + 3 floats around it by plain stores. Every thread that
// wrote src has fenced (fence_proxy_async) and the nt threads have
// synchronised; thread 0 waits (bulk_wait_read) before src is reused or
// the block ends.
__device__ __forceinline__ void store_floats(float* dst, const float* src,
                                             int n, int t, int nt) {
  const Span sp = aligned_span(dst, n);
  if (t == 0 && sp.body > 0) {
    bulk_store(dst + sp.head, src + sp.head, 4u * sp.body);
    bulk_commit();
  }
  for (int i = t; i < n - sp.body; i += nt) {
    const int j = i < sp.head ? i : i + sp.body;
    dst[j] = src[j];
  }
}
