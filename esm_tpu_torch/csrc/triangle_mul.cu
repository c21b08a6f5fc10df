// The two row-wise stages around the triangular multiplicative update's
// O(L^3.C) product, for Hopper (sm_90a).
//
// Replaces the TPU kernels of esm_tpu/kernels/triangle_mul.py, both launched
// through _rows_call (:109, pallas_call :126) over the pair tensor viewed as
// rows (B.I.J, C):
//  * stage 1 (tri_mul_stage1 :147; _stage1_kernel :73 / _stage1_kernel_nomask
//    :77, body _stage1_impl :45):
//      zn = LN_in(z) in fp32, rounded to z's dtype;
//      p  = zn . W4 + b4, W4 = [a_g | a_p | b_g | b_p] (C, 4C), b4 in z's dtype;
//      a  = m . sigmoid(p_ag) . p_ap,  b = m . sigmoid(p_bg) . p_bp  (fp32),
//    a and b written in z's dtype; m is an optional per-row int8 mask (no mask
//    stream is read when it is absent);
//  * the epilogue (tri_mul_epilogue :186; _epilogue_kernel :81):
//      out = z + (sigmoid(LN_in(z) . Wg + bg) . (LN_out(x) . Wz + bz)).astype(z)
//    with fp32 LNs (eps 1e-5), the gated product rounded to z's dtype before
//    the residual add in z's dtype (:106).
// The einsum between the stages stays a cuBLAS product outside, as it
// stayed outside Pallas in JAX (esm_tpu/ops/triangle.py:86-89).
//
// What bounds them on an H100: at C = 128 each row does 2.C.4C = 131k
// (stage 1) or 2.2.C.C = 65.5k (epilogue) operations per 3.C.2 bytes moved
// in bf16: 170 and 85 operations per byte, below the card's ~295 in bf16, so
// device memory bounds both (~0.23 ms each for 10^6 rows, L = 1000). The
// design therefore moves each row once: a block stages the weights in shared
// memory once and then walks row tiles of 128 (a persistent grid of as many
// blocks as fit on the card), one warp per 16 rows: the warp's LayerNorms
// (one row at a time, lanes over channels, fp32 warp sums) write the
// normalized rows into shared memory in the compute dtype, the products run
// on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the weight fragments
// from shared memory by ldmatrix, and the gating, mask and residual are
// applied to the accumulators before one store. Rows not divisible by the
// tile are handled by the row bound, not by padding copies. wgmma, TMA and
// overlapping the next tile's loads are later work. The fp32 path (parity
// runs) computes the same in fp32 FMA, without TF32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/triangle_mul.py).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kTWarps = 8;
constexpr int kTThreads = kTWarps * 32;
constexpr int kTRows = 16 * kTWarps;  // rows per tile: 16 per warp
constexpr float kEps = 1e-5f;

struct Stage1Params {
  const void* z;         // (rows, C)
  const int8_t* mask;    // (rows,) or null
  const void* w4;        // (4C, C): rows a_g, a_p, b_g, b_p (out-major, as torch stores them)
  const void* b4;        // (4C,) in z's dtype
  const float* ln_s;     // (C,)
  const float* ln_b;
  void* a;               // (rows, C)
  void* b;
  long long rows;
};

struct EpilogueParams {
  const void* x;         // (rows, C), z's dtype
  const void* z;
  const void* wg;        // (C, C) out-major
  const void* bg;        // (C,) in z's dtype
  const void* wz;
  const void* bz;
  const float* lni_s;
  const float* lni_b;
  const float* lno_s;
  const float* lno_b;
  void* o;
  long long rows;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// y = LN(row) in fp32 for one row of C channels held by one warp: lane owns
// channels lane, lane + 32, ... (coalesced loads).
template <int C, typename T>
__device__ __forceinline__ void ln_row(const T* row, const float* s, const float* b, int lane,
                                       float (&y)[C / 32]) {
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < C / 32; ++e) {
    y[e] = to_f32(row[lane + 32 * e]);
    sum += y[e];
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < C / 32; ++e) {
    y[e] -= mean;
    sq += y[e] * y[e];
  }
  const float r = rsqrtf(warp_sum(sq) / C + kEps);
#pragma unroll
  for (int e = 0; e < C / 32; ++e) {
    const int c = lane + 32 * e;
    y[e] = y[e] * r * s[c] + b[c];
  }
}

// LN of the warp's 16 rows [row0, row0 + 16) into dst rows [r0, r0 + 16)
// (row stride ld), rounded to bf16; zero rows past `rows`.
template <int C>
__device__ __forceinline__ void ln_rows_bf16(const __nv_bfloat16* src, long long row0,
                                             long long rows, const float* s, const float* b,
                                             __nv_bfloat16* dst, int ld, int r0, int lane) {
  for (int rr = 0; rr < 16; ++rr) {
    const long long row = row0 + rr;
    float y[C / 32];
    if (row < rows) {
      ln_row<C>(src + row * C, s, b, lane, y);
    } else {
#pragma unroll
      for (int e = 0; e < C / 32; ++e) y[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < C / 32; ++e) dst[(r0 + rr) * ld + lane + 32 * e] = __float2bfloat16(y[e]);
  }
}

// Copy a (n, C) bf16 matrix into shared memory rows of stride ld.
template <int C>
__device__ __forceinline__ void stage_matrix(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                             int n) {
  for (int c = threadIdx.x; c < n * (C / 8); c += kTThreads) {
    const int r = c / (C / 8);
    const int j = (c % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + j) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * C + j);
  }
}

// acc[nt] (+)= A (16 rows, C) . W[n0 + nt*8 .. +8, :]^T for kN output columns:
// W rows are output channels in shared memory (stride ld).
template <int C, int kN>
__device__ __forceinline__ void mma_cols(float (&acc)[kN / 8][4], const uint32_t (&a)[C / 16][4],
                                         const __nv_bfloat16* sw, int ld, int n0, int lane) {
  const int mat = lane >> 3;
  const __nv_bfloat16* wrow = sw + (n0 + (mat >> 1) * 8 + (lane & 7)) * ld + (mat & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < kN / 8; nt += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = acc[nt + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t wb[4];
      ldmatrix_x4(wb, wrow + nt * 8 * ld + kk * 16);
      mma_16816(acc[nt], a[kk], wb[0], wb[1]);
      mma_16816(acc[nt + 1], a[kk], wb[2], wb[3]);
    }
  }
}

__device__ __forceinline__ int grid_tiles(long long rows) {
  return (int)((rows + kTRows - 1) / kTRows);
}

// ---------------------------------------------------------------------------
// Stage 1, bf16.
// ---------------------------------------------------------------------------

template <int C>
constexpr size_t stage1_smem_bytes() {
  return (size_t)(4 * C + kTRows) * (C + 8) * sizeof(__nv_bfloat16) + 6 * C * sizeof(float);
}

template <int C, bool kMask>
__global__ void __launch_bounds__(kTThreads) stage1_bf16(Stage1Params p) {
  constexpr int kLd = C + 8;
  constexpr int kN = C < 64 ? C : 64;  // output channels per pass
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem);  // [4C][kLd]
  __nv_bfloat16* sZ = sW + 4 * C * kLd;                         // [kTRows][kLd]
  float* sB = reinterpret_cast<float*>(sZ + kTRows * kLd);      // [4C]
  float* sLn = sB + 4 * C;                                      // [2C]: scale, bias

  stage_matrix<C>(sW, kLd, static_cast<const __nv_bfloat16*>(p.w4), 4 * C);
  for (int c = threadIdx.x; c < 4 * C; c += kTThreads)
    sB[c] = __bfloat162float(static_cast<const __nv_bfloat16*>(p.b4)[c]);
  for (int c = threadIdx.x; c < C; c += kTThreads) {
    sLn[c] = p.ln_s[c];
    sLn[C + c] = p.ln_b[c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* z = static_cast<const __nv_bfloat16*>(p.z);
  __nv_bfloat16* outs[2] = {static_cast<__nv_bfloat16*>(p.a), static_cast<__nv_bfloat16*>(p.b)};

  for (int tile = blockIdx.x; tile < grid_tiles(p.rows); tile += gridDim.x) {
    const long long row0 = (long long)tile * kTRows + r0;
    ln_rows_bf16<C>(z, row0, p.rows, sLn, sLn + C, sZ, kLd, r0, lane);
    __syncwarp();
    uint32_t za[C / 16][4];
    load_a_frags<C>(za, sZ, kLd, r0, lane);
    float mrow[2] = {1.f, 1.f};
    if (kMask) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = row0 + g + 8 * r;
        mrow[r] = row < p.rows ? (float)p.mask[row] : 0.f;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // a, then b
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += kN) {
        float gate[kN / 8][4], proj[kN / 8][4];
        const int gate0 = half * 2 * C + c0;
        const int proj0 = gate0 + C;
        mma_cols<C, kN>(gate, za, sW, kLd, gate0, lane);
        mma_cols<C, kN>(proj, za, sW, kLd, proj0, lane);
#pragma unroll
        for (int nt = 0; nt < kN / 8; ++nt) {
          const int col = nt * 8 + t4 * 2;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long long row = row0 + g + 8 * r;
            if (row >= p.rows) continue;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = sigmoid(gate[nt][2 * r + e] + sB[gate0 + col + e]) *
                     (proj[nt][2 * r + e] + sB[proj0 + col + e]);
              if (kMask) v[e] = mrow[r] * v[e];
            }
            *reinterpret_cast<__nv_bfloat162*>(outs[half] + row * C + c0 + col) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      }
    }
    __syncwarp();  // the warp's sZ rows are rewritten by the next tile
  }
}

// ---------------------------------------------------------------------------
// Epilogue, bf16.
// ---------------------------------------------------------------------------

template <int C>
constexpr size_t epilogue_smem_bytes() {
  return (size_t)(2 * C + 2 * kTRows) * (C + 8) * sizeof(__nv_bfloat16) + 6 * C * sizeof(float);
}

template <int C>
__global__ void __launch_bounds__(kTThreads) epilogue_bf16(EpilogueParams p) {
  constexpr int kLd = C + 8;
  constexpr int kN = C < 64 ? C : 64;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sWg = reinterpret_cast<__nv_bfloat16*>(smem);  // [C][kLd]
  __nv_bfloat16* sWz = sWg + C * kLd;                            // [C][kLd]
  __nv_bfloat16* sZ = sWz + C * kLd;                             // [kTRows][kLd]
  __nv_bfloat16* sX = sZ + kTRows * kLd;                         // [kTRows][kLd]
  float* sBg = reinterpret_cast<float*>(sX + kTRows * kLd);      // [C]
  float* sBz = sBg + C;                                          // [C]
  float* sLn = sBz + C;                                          // [4C]

  stage_matrix<C>(sWg, kLd, static_cast<const __nv_bfloat16*>(p.wg), C);
  stage_matrix<C>(sWz, kLd, static_cast<const __nv_bfloat16*>(p.wz), C);
  for (int c = threadIdx.x; c < C; c += kTThreads) {
    sBg[c] = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bg)[c]);
    sBz[c] = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bz)[c]);
    sLn[c] = p.lni_s[c];
    sLn[C + c] = p.lni_b[c];
    sLn[2 * C + c] = p.lno_s[c];
    sLn[3 * C + c] = p.lno_b[c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* z = static_cast<const __nv_bfloat16*>(p.z);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);

  for (int tile = blockIdx.x; tile < grid_tiles(p.rows); tile += gridDim.x) {
    const long long row0 = (long long)tile * kTRows + r0;
    ln_rows_bf16<C>(z, row0, p.rows, sLn, sLn + C, sZ, kLd, r0, lane);
    ln_rows_bf16<C>(x, row0, p.rows, sLn + 2 * C, sLn + 3 * C, sX, kLd, r0, lane);
    __syncwarp();
    uint32_t za[C / 16][4], xa[C / 16][4];
    load_a_frags<C>(za, sZ, kLd, r0, lane);
    load_a_frags<C>(xa, sX, kLd, r0, lane);
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += kN) {
      float gate[kN / 8][4], upd[kN / 8][4];
      mma_cols<C, kN>(gate, za, sWg, kLd, c0, lane);
      mma_cols<C, kN>(upd, xa, sWz, kLd, c0, lane);
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        const int col = c0 + nt * 8 + t4 * 2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = row0 + g + 8 * r;
          if (row >= p.rows) continue;
          const float2 zr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(z + row * C + col));
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gu = sigmoid(gate[nt][2 * r + e] + sBg[col + e]) *
                             (upd[nt][2 * r + e] + sBz[col + e]);
            v[e] = __bfloat162float(__float2bfloat16(gu));  // (g . u).astype(z.dtype)
          }
          *reinterpret_cast<__nv_bfloat162*>(o + row * C + col) =
              __floats2bfloat162_rn(zr.x + v[0], zr.y + v[1]);
        }
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// fp32: fp32 FMA (no TF32). Rows in tiles of 16: one warp normalizes two
// rows into shared memory, then each thread computes output channels.
// ---------------------------------------------------------------------------

constexpr int kFRows = 16;

template <int C>
__device__ __forceinline__ void ln_tile_f32(const float* src, long long row0, long long rows,
                                            const float* s, const float* b,
                                            float (*dst)[C + 1]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int rr = warp; rr < kFRows; rr += kTWarps) {
    const long long row = row0 + rr;
    float y[C / 32];
    if (row < rows) {
      ln_row<C>(src + row * C, s, b, lane, y);
    } else {
#pragma unroll
      for (int e = 0; e < C / 32; ++e) y[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < C / 32; ++e) dst[rr][lane + 32 * e] = y[e];
  }
}

template <int C, bool kMask>
__global__ void __launch_bounds__(kTThreads) stage1_f32(Stage1Params p) {
  __shared__ float sZ[kFRows][C + 1];
  const float* z = static_cast<const float*>(p.z);
  const float* w = static_cast<const float*>(p.w4);
  const float* bias = static_cast<const float*>(p.b4);
  float* a = static_cast<float*>(p.a);
  float* b = static_cast<float*>(p.b);
  const long long n_tiles = (p.rows + kFRows - 1) / kFRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kFRows;
    ln_tile_f32<C>(z, row0, p.rows, p.ln_s, p.ln_b, sZ);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFRows * C; idx += kTThreads) {
      const int r = idx / C;
      const int c = idx % C;
      const long long row = row0 + r;
      if (row >= p.rows) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // a_g, a_p, b_g, b_p at channel c
      for (int kk = 0; kk < C; ++kk) {
        const float zv = sZ[r][kk];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] = fmaf(zv, w[(size_t)(m * C + c) * C + kk], acc[m]);
      }
      float va = sigmoid(acc[0] + bias[c]) * (acc[1] + bias[C + c]);
      float vb = sigmoid(acc[2] + bias[2 * C + c]) * (acc[3] + bias[3 * C + c]);
      if (kMask) {
        const float m = (float)p.mask[row];
        va = m * va;
        vb = m * vb;
      }
      a[row * C + c] = va;
      b[row * C + c] = vb;
    }
    __syncthreads();
  }
}

template <int C>
__global__ void __launch_bounds__(kTThreads) epilogue_f32(EpilogueParams p) {
  __shared__ float sZ[kFRows][C + 1];
  __shared__ float sX[kFRows][C + 1];
  const float* z = static_cast<const float*>(p.z);
  const float* x = static_cast<const float*>(p.x);
  const float* wg = static_cast<const float*>(p.wg);
  const float* wz = static_cast<const float*>(p.wz);
  const float* bg = static_cast<const float*>(p.bg);
  const float* bz = static_cast<const float*>(p.bz);
  float* o = static_cast<float*>(p.o);
  const long long n_tiles = (p.rows + kFRows - 1) / kFRows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kFRows;
    ln_tile_f32<C>(z, row0, p.rows, p.lni_s, p.lni_b, sZ);
    ln_tile_f32<C>(x, row0, p.rows, p.lno_s, p.lno_b, sX);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFRows * C; idx += kTThreads) {
      const int r = idx / C;
      const int c = idx % C;
      const long long row = row0 + r;
      if (row >= p.rows) continue;
      float gsum = 0.f, usum = 0.f;
      for (int kk = 0; kk < C; ++kk) {
        gsum = fmaf(sZ[r][kk], wg[(size_t)c * C + kk], gsum);
        usum = fmaf(sX[r][kk], wz[(size_t)c * C + kk], usum);
      }
      o[row * C + c] = z[row * C + c] + sigmoid(gsum + bg[c]) * (usum + bz[c]);
    }
    __syncthreads();
  }
}

// As many blocks as fit on the card at once (at most one per row tile),
// each walking row tiles with a stride of the grid.
template <typename P>
cudaError_t launch_rows(void (*kernel)(P), size_t smem, long long tiles, cudaStream_t stream,
                        const P& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTThreads, smem);
  if (e != cudaSuccess) return e;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(int)(tiles < fit ? tiles : fit), kTThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int C>
cudaError_t stage1(const Stage1Params& p, bool bf16, cudaStream_t st) {
  const bool masked = p.mask != nullptr;
  if (bf16) {
    const long long tiles = (p.rows + kTRows - 1) / kTRows;
    constexpr size_t smem = stage1_smem_bytes<C>();
    return masked ? launch_rows(stage1_bf16<C, true>, smem, tiles, st, p)
                  : launch_rows(stage1_bf16<C, false>, smem, tiles, st, p);
  }
  const long long tiles = (p.rows + kFRows - 1) / kFRows;
  return masked ? launch_rows(stage1_f32<C, true>, 0, tiles, st, p)
                : launch_rows(stage1_f32<C, false>, 0, tiles, st, p);
}

template <int C>
cudaError_t epilogue(const EpilogueParams& p, bool bf16, cudaStream_t st) {
  if (bf16) {
    const long long tiles = (p.rows + kTRows - 1) / kTRows;
    return launch_rows(epilogue_bf16<C>, epilogue_smem_bytes<C>(), tiles, st, p);
  }
  const long long tiles = (p.rows + kFRows - 1) / kFRows;
  return launch_rows(epilogue_f32<C>, 0, tiles, st, p);
}

}  // namespace

extern "C" {

// z, a, b (rows, C) contiguous in one dtype (is_bf16: bf16, else fp32),
// 16-byte aligned; mask (rows,) int8 or null; w4 (4C, C) and b4 (4C,) in
// z's dtype; ln_s/ln_b (C,) fp32. C in {32, 64, 128}. Returns the first CUDA
// error (0 on success).
int esm_tri_mul_stage1(const void* z, const void* mask, const void* w4, const void* b4,
                       const void* ln_s, const void* ln_b, void* a, void* b, long long rows,
                       int C, int is_bf16, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  Stage1Params p{z, static_cast<const int8_t*>(mask), w4, b4, static_cast<const float*>(ln_s),
                 static_cast<const float*>(ln_b), a, b, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)stage1<32>(p, is_bf16 != 0, st);
    case 64: return (int)stage1<64>(p, is_bf16 != 0, st);
    case 128: return (int)stage1<128>(p, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, z, o (rows, C) in one dtype; wg/wz (C, C) out-major and bg/bz (C,) in
// that dtype; the four LN vectors (C,) fp32. C in {32, 64, 128}.
int esm_tri_mul_epilogue(const void* x, const void* z, const void* wg, const void* bg,
                         const void* wz, const void* bz, const void* lni_s, const void* lni_b,
                         const void* lno_s, const void* lno_b, void* o, long long rows, int C,
                         int is_bf16, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  EpilogueParams p{x, z, wg, bg, wz, bz,
                   static_cast<const float*>(lni_s), static_cast<const float*>(lni_b),
                   static_cast<const float*>(lno_s), static_cast<const float*>(lno_b), o, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return (int)epilogue<32>(p, is_bf16 != 0, st);
    case 64: return (int)epilogue<64>(p, is_bf16 != 0, st);
    case 128: return (int)epilogue<128>(p, is_bf16 != 0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
