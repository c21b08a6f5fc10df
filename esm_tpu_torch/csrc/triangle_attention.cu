// Triangle attention (the ESMFold trunk's starting/ending-node attention
// core) for Hopper (sm_90a).
//
// Replaces the TPU kernel esm_tpu/kernels/triangle_attention.py: the entry
// triangle_attention_fused (:96) and its Pallas body _kernel (:42) through
// _strips (:65). For every batch b, pair row i and head h:
//
//   o[b, i, :, h] = softmax(q[b, i, :, h] . k[b, i, :, h]^T
//                           + tri_bias[b, h] + mask_bias[b, i]) . v[b, i, :, h]
//
// over the J axis; q, k, v and o are (B, I, J, H, d) in the trunk's dtype
// (bf16, or fp32 for parity runs), q already scaled by d^-1/2; tri_bias is
// (B, H, J, J) fp32 and is shared by every row i; mask_bias is (B, I, J) fp32
// (0 or -1e30). Scores and softmax statistics are fp32, P is rounded to v's
// dtype before P.V (as the TPU kernel's p.astype(v.dtype)), a row sum of 0
// divides by 1. Keys past J are excluded.
//
// The TPU kernel read (B, I, H, d, J) with J on the 128-lane axis, a fix for
// T(8,128) lane padding, and split J > 1024 into 512-query strips to bound
// VMEM. Neither carries over: this kernel reads q/k/v and writes o in the
// (B, I, J, H, d) layout the projections produce (row stride H.d, so no
// transposes around it), and walks key tiles with an online softmax, so one
// loop covers every J.
//
// What bounds it on an H100: at the ESMFold trunk's shape (I = J ~ 1000,
// H = 4, d = 32) each score costs 4.d = 128 FLOPs and one exponential, and
// the work is 4.B.I.H.J.J.d operations over ~4.B.I.J.H.d.2 bytes: the
// tensor cores bound it (0.52 ms at I = J = 1000 at 989 TFLOP/s, against 0.31
// ms of bytes), with the exponentials close behind (4e9 at 16 MUFU results
// per SM-clock is ~0.96 ms). The design:
//  * one block owns a (b, i, h, 64-query) tile and walks the key tiles, so
//    scores live in registers; S = QK^T and O = PV run on mma.sync m16n8k16
//    (bf16 in, fp32 accumulate), exponentials are exp2f with log2e folded;
//  * K/V tiles and the (64 x 64) fp32 tri-bias tile are staged with
//    cp.async into two shared-memory stages, so the next tile's copies
//    overlap this tile's products;
//  * the tri bias (B.H.J^2.4 bytes, 16 MB at J = 1000) is read again by every
//    row i; the grid puts i on blockIdx.x, fastest, so the blocks of one
//    (b, h, query tile) and different i run together and find it in the
//    50 MB L2 instead of device memory.
// wgmma, TMA and warp specialisation are later work. The fp32 path (parity
// runs) uses fp32 FMA, not TF32, and keeps fp32 accuracy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/triangle_attention.py).

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;        // (B, I, J, H, d)
  const void* k;
  const void* v;
  const float* tri;     // (B, H, J, J)
  const float* maskb;   // (B, I, J)
  void* o;              // (B, I, J, H, d)
  int I, J, H, d;
};

// Offset of row j of (b, i, h) in a (B, I, J, H, d) tensor.
__device__ __forceinline__ size_t row_offset(const Params& p, int b, int i, int h, int j) {
  return (((size_t)b * p.I + i) * p.J + j) * (size_t)(p.H * p.d) + (size_t)h * p.d;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16, fp32 accumulation.
// ---------------------------------------------------------------------------

constexpr int kBiasLd = kBN + 8;  // padded fp32 bias rows: two wavefronts per float2 load

template <int DP>
constexpr size_t bf16_smem_bytes() {
  // two stages of K and V tiles, two stages of the bias tile, two mask rows
  return 4 * kBN * (DP + 8) * sizeof(__nv_bfloat16) + 2 * kBM * kBiasLd * sizeof(float) +
         2 * kBN * sizeof(float);
}

// cp.async rows [row0, row0 + 64) of a strided bf16 matrix (row stride rs
// elements) into dst (row stride ld), zero past n rows and past d columns.
template <int DP>
__device__ __forceinline__ void copy_rows_strided(__nv_bfloat16* dst, int ld,
                                                  const __nv_bfloat16* src, size_t rs, int row0,
                                                  int n, int d) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < kBN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int j = (c % kChunks) * 8;
    const bool valid = row0 + r < n && j < d;
    const __nv_bfloat16* g = valid ? src + (size_t)(row0 + r) * rs + j : src;
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * ld + j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(valid ? 16 : 0));
  }
}

// cp.async the (64 query x 64 key) fp32 bias tile at (q0, n0) of the (J, J)
// matrix src into dst (row stride kBiasLd), zero outside J x J. Rows of 16
// bytes when J % 4 == 0 (every chunk then lies wholly inside or outside),
// else 4 bytes at a time.
__device__ __forceinline__ void copy_bias_tile(float* dst, const float* src, int J, int q0,
                                               int n0, bool vec) {
  if (vec) {
    for (int c = threadIdx.x; c < kBM * (kBN / 4); c += kThreads) {
      const int r = c / (kBN / 4);
      const int j = (c % (kBN / 4)) * 4;
      const bool valid = q0 + r < J && n0 + j < J;
      const float* g = valid ? src + (size_t)(q0 + r) * J + n0 + j : src;
      const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * kBiasLd + j));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(s), "l"(g), "r"(valid ? 16 : 0));
    }
  } else {
    for (int c = threadIdx.x; c < kBM * kBN; c += kThreads) {
      const int r = c / kBN;
      const int j = c % kBN;
      const bool valid = q0 + r < J && n0 + j < J;
      const float* g = valid ? src + (size_t)(q0 + r) * J + n0 + j : src;
      const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * kBiasLd + j));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(s), "l"(g), "r"(valid ? 4 : 0));
    }
  }
}

// The additive key term of key n for row (b, i): the mask bias, or -inf
// past J (excluded).
__device__ __forceinline__ float key_term(const float* maskb_row, int J, int n) {
  return n < J ? maskb_row[n] : -INFINITY;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) tri_attn_bf16(Params p) {
  constexpr int kLd = DP + 8;  // padded row stride: conflict-free ldmatrix rows
  constexpr int kTile = kBN * kLd;
  static_assert(kBM == kBN, "a K stage buffer also stages the Q tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);       // [2][kTile]
  __nv_bfloat16* sV = sK + 2 * kTile;                                // [2][kTile]
  float* sBias = reinterpret_cast<float*>(sV + 2 * kTile);           // [2][kBM][kBiasLd]
  float* sMask = sBias + 2 * kBM * kBiasLd;                          // [2][kBN]

  const int i = blockIdx.x;  // fastest: the blocks sharing a bias tile run together
  const int q0 = blockIdx.y * kBM;
  const int bh = blockIdx.z;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mat = lane >> 3;
  const size_t rs = (size_t)p.H * p.d;
  const size_t base = row_offset(p, b, i, h, 0);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + base;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + base;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + base;
  const float* tri = p.tri + (size_t)bh * p.J * p.J;
  const float* maskb = p.maskb + ((size_t)b * p.I + i) * p.J;
  const bool vec = (p.J % 4) == 0;
  const int n_tiles = (p.J + kBN - 1) / kBN;
  constexpr int kBiasTile = kBM * kBiasLd;

  // key tile 0 into stage 0, in flight while Q is staged
  copy_rows_strided<DP>(sK, kLd, k, rs, 0, p.J, p.d);
  copy_rows_strided<DP>(sV, kLd, v, rs, 0, p.J, p.d);
  copy_bias_tile(sBias, tri, p.J, q0, 0, vec);
  cp_async_commit();
  if (threadIdx.x < kBN) sMask[threadIdx.x] = key_term(maskb, p.J, threadIdx.x);

  // Q tile through K's stage 1, kept as A fragments
  copy_rows_strided<DP>(sK + kTile, kLd, q, rs, q0, p.J, p.d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[DP / 16][4];
  const int r0 = warp * 16;
  load_a_frags<DP>(qa, sK + kTile, kLd, r0, lane);
  __syncthreads();

  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    float mask_next = 0.f;
    if (it + 1 < n_tiles) {
      const int n1 = (it + 1) * kBN;
      copy_rows_strided<DP>(sK + (cur ^ 1) * kTile, kLd, k, rs, n1, p.J, p.d);
      copy_rows_strided<DP>(sV + (cur ^ 1) * kTile, kLd, v, rs, n1, p.J, p.d);
      copy_bias_tile(sBias + (cur ^ 1) * kBiasTile, tri, p.J, q0, n1, vec);
      cp_async_commit();
      if (threadIdx.x < kBN) mask_next = key_term(maskb, p.J, n1 + threadIdx.x);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + cur * kTile;
    const __nv_bfloat16* tV = sV + cur * kTile;
    const float* tB = sBias + cur * kBiasTile;
    const float* tM = sMask + cur * kBN;

    float s[kBN / 8][4];
    const __nv_bfloat16* krow = tK + ((mat >> 1) * 8 + (lane & 7)) * kLd + (mat & 1) * 8;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; nt += 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s[nt + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, krow + nt * 8 * kLd + kk * 16);
        mma_16816(s[nt], qa[kk], kb[0], kb[1]);
        mma_16816(s[nt + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // (s + tri_bias) + mask_bias, in the TPU kernel's order
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const int col = nt * 8 + t4 * 2;
      const float2 mk = *reinterpret_cast<const float2*>(tM + col);
      const float2 b0 = *reinterpret_cast<const float2*>(tB + (r0 + g) * kBiasLd + col);
      const float2 b1 = *reinterpret_cast<const float2*>(tB + (r0 + g + 8) * kBiasLd + col);
      s[nt][0] = (s[nt][0] + b0.x) + mk.x;
      s[nt][1] = (s[nt][1] + b0.y) + mk.y;
      s[nt][2] = (s[nt][2] + b1.x) + mk.x;
      s[nt][3] = (s[nt][3] + b1.y) + mk.y;
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every tile holds a key < J, whose term is finite, so mx is finite here
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[nt][e] = exp2f((s[nt][e] - m[r]) * kLog2e);
        ls[r] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P . V, P re-packed from the score accumulators as A fragments
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow =
          tV + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * kLd + (mat >> 1) * 8;
#pragma unroll
      for (int dn = 0; dn < DP / 8; dn += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + dn * 8);
        mma_16816(acc[dn], pa, vb[0], vb[1]);
        mma_16816(acc[dn + 1], pa, vb[2], vb[3]);
      }
    }
    if (it + 1 < n_tiles && threadIdx.x < kBN) sMask[(cur ^ 1) * kBN + threadIdx.x] = mask_next;
    __syncthreads();  // this stage is free for the copies issued next iteration
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= p.J) continue;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + t4 * 2;
      if (col < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * rs + col) =
            __floats2bfloat162_rn(acc[dn][2 * r] * inv[r], acc[dn][2 * r + 1] * inv[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: fp32 FMA (no TF32), four threads per query row.
// ---------------------------------------------------------------------------

constexpr int kFBM = 32;  // query rows per block
constexpr int kFBN = 32;  // keys per tile

template <int DP>
__global__ void __launch_bounds__(128) tri_attn_f32(Params p) {
  constexpr int kPer = DP / 4;  // columns per thread: part, part + 4, ...
  __shared__ float sK[kFBN][DP];
  __shared__ float sV[kFBN][DP];
  __shared__ float sB[kFBM][kFBN + 1];
  __shared__ float sM[kFBN];

  const int i = blockIdx.x;
  const int q0 = blockIdx.y * kFBM;
  const int bh = blockIdx.z;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int t = q0 + row;
  const size_t rs = (size_t)p.H * p.d;
  const size_t base = row_offset(p, b, i, h, 0);
  const float* q = static_cast<const float*>(p.q) + base;
  const float* k = static_cast<const float*>(p.k) + base;
  const float* v = static_cast<const float*>(p.v) + base;
  const float* tri = p.tri + (size_t)bh * p.J * p.J;
  const float* maskb = p.maskb + ((size_t)b * p.I + i) * p.J;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = part + 4 * e;
    qr[e] = (t < p.J && j < p.d) ? q[(size_t)t * rs + j] : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int n0 = 0; n0 < p.J; n0 += kFBN) {
    for (int e = threadIdx.x; e < kFBN * DP; e += 128) {
      const int r = e / DP;
      const int j = e % DP;
      const int key = n0 + r;
      const bool ok = key < p.J && j < p.d;
      sK[r][j] = ok ? k[(size_t)key * rs + j] : 0.f;
      sV[r][j] = ok ? v[(size_t)key * rs + j] : 0.f;
    }
    for (int e = threadIdx.x; e < kFBM * kFBN; e += 128) {
      const int r = e / kFBN;
      const int c = e % kFBN;
      sB[r][c] = (q0 + r < p.J && n0 + c < p.J) ? tri[(size_t)(q0 + r) * p.J + n0 + c] : 0.f;
    }
    for (int e = threadIdx.x; e < kFBN; e += 128) sM[e] = key_term(maskb, p.J, n0 + e);
    __syncthreads();

    float s[kFBN];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kFBN; ++jj) {
      float part_sum = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) part_sum = fmaf(qr[e], sK[jj][part + 4 * e], part_sum);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 2);
      s[jj] = (part_sum + sB[row][jj]) + sM[jj];
      mx = fmaxf(mx, s[jj]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kFBN; ++jj) {
      const float pj = expf(s[jj] - m);
      l += pj;
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] = fmaf(pj, sV[jj][part + 4 * e], acc[e]);
    }
    __syncthreads();
  }

  if (t < p.J) {
    const float inv = l == 0.f ? 1.f : 1.f / l;
    float* o = static_cast<float*>(p.o) + base + (size_t)t * rs;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = part + 4 * e;
      if (j < p.d) o[j] = acc[e] * inv;
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int bh, bool bf16, cudaStream_t stream) {
  if (bf16) {
    constexpr size_t smem = bf16_smem_bytes<DP>();
    const cudaError_t e = cudaFuncSetAttribute(
        tri_attn_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid(p.I, (p.J + kBM - 1) / kBM, bh);
    tri_attn_bf16<DP><<<grid, kThreads, smem, stream>>>(p);
  } else {
    dim3 grid(p.I, (p.J + kFBM - 1) / kFBM, bh);
    tri_attn_f32<DP><<<grid, 128, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/o (B, I, J, H, d) contiguous, one dtype (is_bf16: bf16, else fp32),
// 16-byte aligned; tri (B, H, J, J) fp32; maskb (B, I, J) fp32. d a multiple
// of 8, at most 128. Launches on `stream`; returns the first CUDA error.
int esm_triangle_attention_fwd(const void* q, const void* k, const void* v, const void* tri,
                               const void* maskb, void* o, int B, int I, int J, int H, int d,
                               int is_bf16, void* stream) {
  if (B <= 0 || I <= 0 || J <= 0 || H <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
      B * H > 65535 || (J + kFBM - 1) / kFBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{q, k, v, static_cast<const float*>(tri), static_cast<const float*>(maskb), o,
           I, J, H, d};
  const bool bf16 = is_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d <= 16) e = launch<16>(p, B * H, bf16, st);
  else if (d <= 32) e = launch<32>(p, B * H, bf16, st);
  else if (d <= 64) e = launch<64>(p, B * H, bf16, st);
  else e = launch<128>(p, B * H, bf16, st);
  return (int)e;
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
