// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu): vector loads and stores, the
// mma.sync / ldmatrix / cp.async wrappers, the key-bias convention and the
// rotary prologue kernel. Each source includes this header and compiles its
// own copy (the two are separate libraries).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kMaskBias = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// bf16 tiles: 64 rows per block (16 per warp), 64-row key/query tiles.
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// The bias a score gets from key j of batch row b: -inf past S (excluded),
// -1e30 at padding (mask nonzero), else 0.
__device__ __forceinline__ float key_bias(const uint8_t* mask, int S, int b, int j) {
  if (j >= S) return -INFINITY;
  if (mask != nullptr && mask[(size_t)b * S + j]) return kMaskBias;
  return 0.f;
}

// Four elements of T as floats, and back.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// c += a . b for one m16n8k16 tile: bf16 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane i gives the row address of
// matrix i / 8, row i % 8. Plain, each lane receives per matrix the elements
// (row lane / 4, columns 2 * (lane % 4) and + 1): the B fragment of mma
// m16n8k16 when the rows are the output (n) axis. Transposed, it receives
// (rows 2 * (lane % 4) and + 1, column lane / 4): the B fragment when the
// rows are the reduction (k) axis.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A fragment (m16n8k16) of rows [r0, r0 + 16), columns [c0, c0 + 16) of
// a bf16 tile in shared memory with row stride ld.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                            int r0, int c0, int lane) {
  const __nv_bfloat16* base = tile + (r0 + (lane >> 2)) * ld + c0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * ld + 8);
}

// The A fragments of rows [r0, r0 + 16), all DP columns.
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[DP / 16][4],
                                             const __nv_bfloat16* tile, int ld, int r0,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) load_a_frag(a[kk], tile, ld, r0, kk * 16, lane);
}

// Issue cp.async copies of rows [row0, row0 + 64) of a (n, d) bf16 matrix
// into dst (row stride ld), 16 bytes at a time, zero-filled past n and past
// d. The caller commits the group and waits for it.
template <int DP>
__device__ __forceinline__ void copy_rows_async(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* src, int row0, int n,
                                                int d) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int c = threadIdx.x; c < kBN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int j = (c % kChunks) * 8;
    const bool valid = row0 + r < n && j < d;
    const __nv_bfloat16* g = valid ? src + (size_t)(row0 + r) * d + j : src;
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * ld + j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(valid ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Rotary prologue: y = rot(x) for x (rows, d) whose position is row % len.
// Each thread rotates four pairs (j, j + d/2); both halves of a table row are
// equal, so only the first half is read.
// ---------------------------------------------------------------------------

// x.c + y.s with each product and the sum rounded on its own (no fused
// multiply-add), as PyTorch's elementwise ops round it: the rotated bf16
// values then equal the plain version's bit for bit, where one contracted
// rounding could flip a bf16 rounding and move a score.
__device__ __forceinline__ float rot_term(float x, float c, float y, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

template <typename T>
__global__ void rotate_rows(const T* __restrict__ x, T* __restrict__ y,
                            const float* __restrict__ cos, const float* __restrict__ sin,
                            size_t rows, int len, int d) {
  const int half = d / 2;
  const int per_row = half / 4;
  const size_t n = rows * per_row;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / per_row;
    const int j = (int)(i % per_row) * 4;
    const size_t t = (row % len) * d + j;
    float a[4], b[4], c[4], s[4], lo[4], hi[4];
    load4(x + row * d + j, a);
    load4(x + row * d + j + half, b);
    load4(cos + t, c);
    load4(sin + t, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = rot_term(a[e], c[e], -b[e], s[e]);
      hi[e] = rot_term(b[e], c[e], a[e], s[e]);
    }
    store4(y + row * d + j, lo);
    store4(y + row * d + j + half, hi);
  }
}

template <typename T>
cudaError_t rotate(const void* x, void* y, const float* cos, const float* sin, size_t rows,
                   int len, int d, cudaStream_t stream) {
  const size_t n = rows * (d / 8);
  const unsigned blocks = (unsigned)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  rotate_rows<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), cos,
                                              sin, rows, len, d);
  return cudaGetLastError();
}

}  // namespace flash
