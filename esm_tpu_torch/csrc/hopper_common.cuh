// Hopper (sm_90a) building blocks shared by the flash-attention forward (K1,
// flash_attention.cu), its backward (K2, flash_attention_bwd.cu), the
// triangle attention (K6, triangle_attention.cu) and the tri-mul stages (K7,
// K8, triangle_mul.cu): mbarriers, TMA tile loads and stores,
// wgmma descriptors and instructions, register reallocation,
// the swizzled tile layout TMA writes and wgmma reads, and the host-side
// tensor-map encoder. Raw PTX, no CuTe or CUTLASS headers, so each library
// still builds in seconds.
//
// Tiles. A bf16 tile of ROWS rows and DP columns (DP a power of two >= 16,
// the head width d padded up; TMA zero-fills the columns past d) lies in
// shared memory as DP / BC boxes of ROWS x BC, BC = min(DP, 64), one box per
// TMA load. A box row is 2 BC bytes (32, 64 or 128) and is stored with the
// swizzle of that width (CU_TENSOR_MAP_SWIZZLE_32B/64B/128B; the 16-byte
// chunk index XORed with address bits 7 and up), the same layout the wgmma
// descriptor's layout type names. Boxes start on 1024-byte boundaries, so
// the pattern's phase is the offset's.
//
// Operands. A tile whose rows are the product's M or N axis and whose
// columns are the reduction axis is "K-major": the descriptor starts at the
// first row and advances 32 bytes per 16-column step (the hardware applies
// the swizzle to the address it forms), SBO = 8 rows. A tile whose rows are
// the reduction axis is read "MN-major" with the tnspB bit: 16 rows per step,
// SBO = 8 rows, LBO = the next 64-column box.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// async proxy; a __syncthreads() follows it.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with the given parity has completed. A
// wait that spins for seconds is a protocol error (a wrong parity or byte
// count): it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// One arrival per warp (its lane 0, after the warp's own accesses).
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operand reads, TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier over `count` threads (whole warps): wait there, or arrive
// without waiting.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Two consumer warpgroups taking turns to issue their products (named
// barriers 3 and 4), so that one's softmax runs while the other's products
// do: each waits for its turn, issues, and passes the turn on. Warpgroup 1
// passes first, and not after its last issue, so no arrival is left over
// when the CTA ends. With one consumer warpgroup the turns are no-ops.
struct TakeTurns {
  int cw;   // this consumer warpgroup, 0 or 1
  bool on;  // two consumer warpgroups
  __device__ TakeTurns(int consumer, int n_consumers) : cw(consumer), on(n_consumers == 2) {
    if (on && cw == 1) pass();
  }
  __device__ void wait() const {
    if (on) named_sync(3 + cw, 256);
  }
  __device__ void pass() const {
    if (on) named_arrive(3 + (cw ^ 1), 256);
  }
  __device__ void pass_unless_last() const {
    if (cw == 0) pass();
  }
};

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D tensor map.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The reverse of tma_load_3d: one box from shared memory into a 3-D tensor
// map, in a bulk async-group of the issuing thread; the parts of the box past
// the tensor's bounds are not written. Every thread that wrote the box runs
// fence_proxy_async() and the writers synchronise before one thread issues
// it and commits (bulk_commit); that thread waits with bulk_wait_read()
// before the box is written again and with bulk_wait() before it exits.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 2^x on the MUFU unit (ex2.approx, flush-to-zero): one instruction, where
// exp2f adds range handling around it. Relative error ~2^-22; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups (all four warps execute it)
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

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

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the instructions that issue and wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (1 = 128-byte swizzle, 2 = 64, 3 = 32).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The swizzled tile described at the top of this file.
template <int DP, int ROWS>
struct Tile {
  static_assert(DP == 16 || DP == 32 || DP == 64 || DP == 128, "DP: a power of two in [16, 128]");
  static_assert(ROWS % 8 == 0 && ROWS <= 256, "TMA boxes hold at most 256 rows");
  static constexpr int kBoxCols = DP < 64 ? DP : 64;
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kPitch = kBoxCols * 2;  // bytes per box row
  static constexpr int kBoxBytes = ROWS * kPitch;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr uint64_t kLayout = kPitch == 128 ? 1 : kPitch == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kPitch == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                    : kPitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static_assert(kBoxBytes % 1024 == 0, "boxes keep the swizzle pattern's phase");

  // Byte offset of element (row, col) from the tile's start.
  static __device__ __forceinline__ int offset(int row, int col) {
    int off = row * kPitch + (col % kBoxCols) * 2;
    off ^= ((off >> 7) & (kPitch / 16 - 1)) << 4;
    return (col / kBoxCols) * kBoxBytes + off;
  }

  // K-major operand: rows [r0, r0 + M or N), columns [16 kk, 16 kk + 16).
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int r0, int kk) {
    const int col = kk * 16;
    return make_desc(base + (col / kBoxCols) * kBoxBytes + r0 * kPitch + (col % kBoxCols) * 2,
                     16, 8 * kPitch, kLayout);
  }

  // MN-major operand (tnspB): rows [16 kk, 16 kk + 16) are the reduction
  // axis, all DP columns the output axis.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return make_desc(base + kk * 16 * kPitch, kBoxBytes, 8 * kPitch, kLayout);
  }

  // The A-register fragments (m64nNk16, one per 16 columns) of the rows
  // row0 and row0 + 8 that this thread holds in the fragment layout.
  static __device__ __forceinline__ void a_frags(uint32_t (&a)[DP / 16][4],
                                                 const unsigned char* tile, int row0) {
    const int c0 = (threadIdx.x & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[kk][e] = *reinterpret_cast<const uint32_t*>(
            tile + offset(row0 + (e & 1) * 8, kk * 16 + (e >> 1) * 8 + c0));
      }
    }
  }

  // Issues the TMA loads of rows [row0, row0 + ROWS) of slice z into dst.
  static __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row0, int z) {
#pragma unroll
    for (int bx = 0; bx < kBoxes; ++bx) {
      tma_load_3d(static_cast<char*>(dst) + bx * kBoxBytes, map, bar, bx * kBoxCols, row0, z);
    }
  }
};

// Accumulator fragment of one m64nN wgmma, per thread of the warpgroup:
// d[4 c + e] holds row 16 warp + lane / 4 + 8 (e / 2), column 8 c + 2 (lane % 4)
// + e % 2. The A-from-registers fragment of m64nNk16 for the 16 columns
// [16 kk, 16 kk + 16) of such an accumulator is its chunks 2 kk and 2 kk + 1
// packed to bf16 pairs.
#define ESM_F8(i)                                                                      \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// Wgmma<N>::ss<TB>: d (64 x N, fp32) = [d +] A . B, A (64 x 16) K-major in
// shared memory; `accumulate` 0 overwrites d. B from shared memory, K-major
// (N x 16, TB = 0: d = A . B^T) or MN-major (16 x N, TB = 1: transposed
// through the descriptor's tnspB bit).
// Wgmma<N>::rs<TB>: the same with A (64 x 16) from registers.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : ESM_F8(0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : ESM_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : ESM_F8(0), ESM_F8(8)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : ESM_F8(0), ESM_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : ESM_F8(0), ESM_F8(8), ESM_F8(16), ESM_F8(24)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : ESM_F8(0), ESM_F8(8), ESM_F8(16), ESM_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : ESM_F8(0), ESM_F8(8), ESM_F8(16), ESM_F8(24), ESM_F8(32), ESM_F8(40), ESM_F8(48), ESM_F8(56)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : ESM_F8(0), ESM_F8(8), ESM_F8(16), ESM_F8(24), ESM_F8(32), ESM_F8(40), ESM_F8(48), ESM_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
  }
};

#undef ESM_F8

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, so the library
// needs no -lcuda.
inline cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// The 3-D map (d, rows, slices) of a contiguous bf16 (slices, rows, d) array,
// cut into boxes of Tile<DP, ROWS>: one slice, ROWS rows, BC columns. Boxes
// that run past d, past `rows` or past the last slice are zero-filled.
template <typename TileT>
cudaError_t make_map(CUtensorMap* map, const void* base, int d, int rows, int slices) {
  EncodeTiled encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)TileT::kBoxCols, (cuuint32_t)(TileT::kBoxBytes /
                                                                      TileT::kPitch), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            TileT::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
