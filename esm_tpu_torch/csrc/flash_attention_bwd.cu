// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2
// two-pass recompute from the forward's per-row log-sum-exp, with the
// GPT-NeoX rotary pulled back through its transpose.
//
// Replaces the TPU kernel esm_tpu/kernels/flash_attention.py
// _flash_bwd_padded (:730) with its two Pallas bodies, _dq_kernel (:590,
// pallas_call :815) and _dkv_kernel (:652, pallas_call :845), reached from
// the custom_vjp of _flash_core (:884-935) and from flash_attention_block_bwd
// (:975). Per (b, h), with Q and K as the forward's main loop read them
// (rotated when rotary is on), bias the key-padding bias of the forward and
// lse its saved log-sum-exp:
//
//   delta_i = sum_c dO_ic O_ic                          (fp32)
//   P_ij    = exp(Q_i . K_j + bias_j - lse_i)           (fp32, recomputed)
//   dS_ij   = P_ij (dO_i . V_j - delta_i)
//   dQ      = unrot(dS . K)        dK = unrot(dS^T . Q)        dV = P^T . dO
//
// As on the TPU, dS is rounded to K's dtype for dQ (:640) and to Q's for dK
// (:710), and P to dO's for dV (:695); products accumulate in fp32. unrot is
// the transpose of the rotary (_unrotate, :201): lo' = lo.c + hi.s,
// hi' = hi.c - lo.s. Keys past S are excluded (-inf) and padded keys get
// -1e30, exactly the key set and lse of K1 (flash_attention.cu).
//
// Launches, in order: the rotary prologue of K1 (flash_common.cuh) rotates Q
// once into scratch the wrapper allocates (K arrives already rotated: the
// forward saved its rotated copy); row_dot computes delta; the dq pass, one
// block per (b.h, 64-query tile) walking the key tiles; the dk/dv pass, one
// block per (b.h, 64-key tile) walking the query tiles. Neither pass writes
// anything another block reads, so there are no atomics and the result does
// not depend on the order blocks run in.
//
// What bounds it on an H100: 10.B.H.T.S.d operations of matrix products
// (the two passes recompute S and dP, 14.B.H.T.S.d in all) over
// ~9.B.H.T.d.2 bytes at the ESM-2 shapes: far above the card's ~295
// operations per byte, so the tensor cores bound it. The bf16 kernels keep
// every (T, S) quantity in registers, feed mma.sync m16n8k16 (bf16 in, fp32
// accumulate), re-pack P and dS from the accumulators as A fragments without
// touching shared memory, take the transposed B operands with ldmatrix.trans,
// and double-buffer the streamed tiles with cp.async. The fp32 kernels (parity
// runs) use fp32 FMA, not TF32, four threads per row. wgmma, TMA and warp
// specialisation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/flash_attention.py).

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const void* q;        // rot(q) when rotary is on
  const void* k;        // rot(k) when rotary is on
  const void* v;
  const void* dout;
  const uint8_t* mask;  // (B, S), nonzero at padding; may be null
  const float* cos;     // (L, d) tables for the un-rotation; null when off
  const float* sin;
  const float* lse;     // (B, H, T)
  const float* delta;   // (B, H, T)
  void* dq;             // the dq pass writes dq; the dk/dv pass dk and dv
  void* dk;
  void* dv;
  int H, T, S, d;
};

// delta[r] = sum_c a[r, c] b[r, c] in fp32: one warp per row.
template <typename T>
__global__ void row_dot(const T* __restrict__ a, const T* __restrict__ b,
                        float* __restrict__ out, size_t rows, int d) {
  const size_t row = blockIdx.x * (size_t)(blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  float acc = 0.f;
  for (int j = lane * 4; j < d; j += 128) {
    float x[4], y[4];
    load4(a + row * d + j, x);
    load4(b + row * d + j, y);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(x[e], y[e], acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = acc;
}

// Rows [0, n_rows) of an fp32 tile in shared memory (row stride ld) to the
// global rows row0 + r < n of out (rows of d elements), pulled back through
// the rotary (the transpose of rot, position = global row) when tables are
// given.
template <typename T>
__device__ void store_rows(const float* tile, int ld, int n_rows, int row0, int n, T* out,
                           const float* cos, const float* sin, int d) {
  const int half = d / 2;
  for (int c = threadIdx.x; c < n_rows * half; c += blockDim.x) {
    const int r = c / half;
    const int j = c % half;
    const int row = row0 + r;
    if (row >= n) continue;
    float lo = tile[r * ld + j];
    float hi = tile[r * ld + j + half];
    if (cos != nullptr) {
      const float cs = cos[(size_t)row * d + j];  // both halves of a table row are equal
      const float sn = sin[(size_t)row * d + j];
      const float x1 = lo;
      lo = x1 * cs + hi * sn;
      hi = hi * cs - x1 * sn;
    }
    store1(out + (size_t)row * d + j, lo);
    store1(out + (size_t)row * d + j + half, hi);
  }
}

// A fragments of columns [16 kk, 16 kk + 16) of a 16 x 64 fp32 tile held as
// mma accumulators (s[n][e]: row g + 8 (e / 2), column 8 n + 2 t4 + e % 2),
// rounded to bf16.
__device__ __forceinline__ void pack_a_frag(uint32_t (&a)[4], const float (&s)[kBN / 8][4],
                                            int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// acc (16 x 64 per warp) += A . B^T over DP columns, where A's fragments come
// from `a` (16 rows x DP) and B's rows are the 64 rows of a bf16 tile in
// shared memory (row stride kLd): the tile rows are the output columns.
template <int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[kBN / 8][4], const uint32_t (&a)[DP / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
  constexpr int kLd = DP + 8;
  const int mat = lane >> 3;
  const __nv_bfloat16* row = tile + ((mat >> 1) * 8 + (lane & 7)) * kLd + (mat & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; nt += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = acc[nt + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, row + nt * 8 * kLd + kk * 16);
      mma_16816(acc[nt], a[kk], b[0], b[1]);
      mma_16816(acc[nt + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x DP per warp) += X . tile, where X is 16 x 64 held as mma
// accumulators (rounded to bf16 here) and the tile is 64 x DP bf16 in shared
// memory (row stride kLd): the tile rows are the reduction axis.
template <int DP>
__device__ __forceinline__ void mma_xb(float (&acc)[DP / 8][4], const float (&x)[kBN / 8][4],
                                       const __nv_bfloat16* tile, int lane) {
  constexpr int kLd = DP + 8;
  const int mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    uint32_t a[4];
    pack_a_frag(a, x, kk);
    const __nv_bfloat16* row = tile + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * kLd + (mat >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < DP / 8; dn += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + dn * 8);
      mma_16816(acc[dn], a, b[0], b[1]);
      mma_16816(acc[dn + 1], a, b[2], b[3]);
    }
  }
}

// Write a warp's 16 x DP accumulators to rows [r0, r0 + 16) of an fp32 tile
// in shared memory (row stride ld).
template <int DP>
__device__ __forceinline__ void acc_to_smem(float* tile, int ld, const float (&acc)[DP / 8][4],
                                            int r0, int lane) {
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      *reinterpret_cast<float2*>(tile + (r0 + g + 8 * i) * ld + dn * 8 + t4 * 2) =
          make_float2(acc[dn][2 * i], acc[dn][2 * i + 1]);
    }
  }
}

template <int DP>
constexpr size_t bwd_smem_bytes(int resident_tiles) {
  // two stages of two streamed bf16 tiles, resident tiles, (DP + 8)-element
  // rows, and two stages of two fp32 rows (bias, or lse and delta)
  return (4 + resident_tiles) * kBN * (DP + 8) * sizeof(__nv_bfloat16) +
         4 * kBN * sizeof(float);
}

// ---------------------------------------------------------------------------
// bf16 dq pass: block (b.h, 64 queries); 16 queries per warp.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dq_bf16(BwdParams p) {
  constexpr int kLd = DP + 8;
  constexpr int kTile = kBN * kLd;
  static_assert(kBM == kBN, "a K/V stage buffer also stages the Q/dO tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kTile]
  __nv_bfloat16* sV = sK + 2 * kTile;                           // [2][kTile]
  float* sBias = reinterpret_cast<float*>(sV + 2 * kTile);      // [2][kBN], times log2(e)

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.T * p.d;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + (size_t)bh * p.T * p.d;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + (size_t)bh * p.S * p.d;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + (size_t)bh * p.S * p.d;
  const int n_tiles = (p.S + kBN - 1) / kBN;

  // key tile 0 into stage 0; the Q and dO tiles through stage 1
  copy_rows_async<DP>(sK, kLd, k, 0, p.S, p.d);
  copy_rows_async<DP>(sV, kLd, v, 0, p.S, p.d);
  copy_rows_async<DP>(sK + kTile, kLd, q, q0, p.T, p.d);
  copy_rows_async<DP>(sV + kTile, kLd, dout, q0, p.T, p.d);
  cp_async_commit();
  if (threadIdx.x < kBN) sBias[threadIdx.x] = key_bias(p.mask, p.S, b, threadIdx.x) * kLog2e;
  float lse2[2], dlt[2];  // rows g and g + 8: lse times log2(e), and delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const bool in = row < p.T;
    lse2[i] = in ? p.lse[(size_t)bh * p.T + row] * kLog2e : INFINITY;
    dlt[i] = in ? p.delta[(size_t)bh * p.T + row] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[DP / 16][4], da[DP / 16][4];
  load_a_frags<DP>(qa, sK + kTile, kLd, r0, lane);
  load_a_frags<DP>(da, sV + kTile, kLd, r0, lane);
  __syncthreads();  // stage 1 is free

  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    float bias_next = 0.f;
    if (it + 1 < n_tiles) {
      const int n1 = (it + 1) * kBN;
      copy_rows_async<DP>(sK + (cur ^ 1) * kTile, kLd, k, n1, p.S, p.d);
      copy_rows_async<DP>(sV + (cur ^ 1) * kTile, kLd, v, n1, p.S, p.d);
      cp_async_commit();
      if (threadIdx.x < kBN) bias_next = key_bias(p.mask, p.S, b, n1 + threadIdx.x) * kLog2e;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + cur * kTile;
    const __nv_bfloat16* tV = sV + cur * kTile;
    const float* tBias = sBias + cur * kBN;

    float s[kBN / 8][4], dp[kBN / 8][4];
    mma_abt<DP>(s, qa, tK, lane);   // S = Q . K^T
    mma_abt<DP>(dp, da, tV, lane);  // dP = dO . V^T
    // dS = P (dP - delta), P = exp(S + bias - lse), in place of S
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const float2 bias = *reinterpret_cast<const float2*>(tBias + nt * 8 + t4 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pr = exp2f(fmaf(s[nt][e], kLog2e, (e & 1) ? bias.y : bias.x) - lse2[i]);
        s[nt][e] = pr * (dp[nt][e] - dlt[i]);
      }
    }
    mma_xb<DP>(acc, s, tK, lane);  // dQ += dS . K
    if (it + 1 < n_tiles && threadIdx.x < kBN) sBias[(cur ^ 1) * kBN + threadIdx.x] = bias_next;
    __syncthreads();  // this stage is free for the copy issued next iteration
  }

  // un-rotate and store through shared memory (the stages are free now)
  constexpr int kAccLd = DP + 4;
  float* sAcc = reinterpret_cast<float*>(smem);  // [kBM][kAccLd]
  acc_to_smem<DP>(sAcc, kAccLd, acc, r0, lane);
  __syncthreads();
  store_rows(sAcc, kAccLd, kBM, q0, p.T,
             static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.T * p.d, p.cos, p.sin, p.d);
}

// ---------------------------------------------------------------------------
// bf16 dk/dv pass: block (b.h, 64 keys); 16 keys per warp. K and V stay in
// shared memory and give their A fragments at each use, which keeps the
// registers for the two accumulators.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv_bf16(BwdParams p) {
  constexpr int kLd = DP + 8;
  constexpr int kTile = kBN * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kTile]
  __nv_bfloat16* sD = sQ + 2 * kTile;                           // [2][kTile], dO
  __nv_bfloat16* sK = sD + 2 * kTile;                           // [kTile]
  __nv_bfloat16* sV = sK + kTile;                               // [kTile]
  float* sL = reinterpret_cast<float*>(sV + kTile);             // [2][kBM], lse times log2(e)
  float* sDl = sL + 2 * kBM;                                    // [2][kBM], delta

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int k0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.T * p.d;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + (size_t)bh * p.T * p.d;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + (size_t)bh * p.S * p.d;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + (size_t)bh * p.S * p.d;
  const float* lse = p.lse + (size_t)bh * p.T;
  const float* delta = p.delta + (size_t)bh * p.T;
  const int n_tiles = (p.T + kBM - 1) / kBM;

  copy_rows_async<DP>(sK, kLd, k, k0, p.S, p.d);
  copy_rows_async<DP>(sV, kLd, v, k0, p.S, p.d);
  copy_rows_async<DP>(sQ, kLd, q, 0, p.T, p.d);
  copy_rows_async<DP>(sD, kLd, dout, 0, p.T, p.d);
  cp_async_commit();
  // rows past T: P = exp(... - inf) = 0 and delta = 0, so they add nothing
  if (threadIdx.x < kBM) {
    const bool in = (int)threadIdx.x < p.T;
    sL[threadIdx.x] = in ? lse[threadIdx.x] * kLog2e : INFINITY;
    sDl[threadIdx.x] = in ? delta[threadIdx.x] : 0.f;
  }
  float bias2[2];  // key rows g and g + 8, times log2(e)
#pragma unroll
  for (int i = 0; i < 2; ++i) bias2[i] = key_bias(p.mask, p.S, b, k0 + r0 + g + 8 * i) * kLog2e;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }
  const int mat = lane >> 3;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    float l_next = 0.f, d_next = 0.f;
    if (it + 1 < n_tiles) {
      const int m1 = (it + 1) * kBM;
      copy_rows_async<DP>(sQ + (cur ^ 1) * kTile, kLd, q, m1, p.T, p.d);
      copy_rows_async<DP>(sD + (cur ^ 1) * kTile, kLd, dout, m1, p.T, p.d);
      cp_async_commit();
      if (threadIdx.x < kBM) {
        const int row = m1 + threadIdx.x;
        const bool in = row < p.T;
        l_next = in ? lse[row] * kLog2e : INFINITY;
        d_next = in ? delta[row] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tQ = sQ + cur * kTile;
    const __nv_bfloat16* tD = sD + cur * kTile;
    const float* tL = sL + cur * kBM;
    const float* tDl = sDl + cur * kBM;

    // S^T = K . Q^T (rows: this warp's keys, columns: the tile's queries)
    float st[kBM / 8][4], dpt[kBM / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    }
    const __nv_bfloat16* qrow = tQ + ((mat >> 1) * 8 + (lane & 7)) * kLd + (mat & 1) * 8;
    const __nv_bfloat16* drow = tD + ((mat >> 1) * 8 + (lane & 7)) * kLd + (mat & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sK, kLd, r0, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < kBM / 8; nt += 2) {
        uint32_t bq[4];
        ldmatrix_x4(bq, qrow + nt * 8 * kLd + kk * 16);
        mma_16816(st[nt], a, bq[0], bq[1]);
        mma_16816(st[nt + 1], a, bq[2], bq[3]);
      }
    }
    // P^T = exp(S^T + bias - lse)
#pragma unroll
    for (int nt = 0; nt < kBM / 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(tL + nt * 8 + t4 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[nt][e] = exp2f(fmaf(st[nt][e], kLog2e, bias2[e >> 1]) - ((e & 1) ? l2.y : l2.x));
      }
    }
    mma_xb<DP>(dv, st, tD, lane);  // dV += P^T . dO
    // dP^T = V . dO^T
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, sV, kLd, r0, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < kBM / 8; nt += 2) {
        uint32_t bd[4];
        ldmatrix_x4(bd, drow + nt * 8 * kLd + kk * 16);
        mma_16816(dpt[nt], a, bd[0], bd[1]);
        mma_16816(dpt[nt + 1], a, bd[2], bd[3]);
      }
    }
    // dS^T = P^T (dP^T - delta), in place of P^T
#pragma unroll
    for (int nt = 0; nt < kBM / 8; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(tDl + nt * 8 + t4 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] *= dpt[nt][e] - ((e & 1) ? d2.y : d2.x);
    }
    mma_xb<DP>(dk, st, tQ, lane);  // dK += dS^T . Q
    if (it + 1 < n_tiles && threadIdx.x < kBM) {
      sL[(cur ^ 1) * kBM + threadIdx.x] = l_next;
      sDl[(cur ^ 1) * kBM + threadIdx.x] = d_next;
    }
    __syncthreads();
  }

  __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(p.dv) + (size_t)bh * p.S * p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + g + 8 * i;
    if (row >= p.S) continue;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + t4 * 2;
      if (col < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(dvo + (size_t)row * p.d + col) =
            __floats2bfloat162_rn(dv[dn][2 * i], dv[dn][2 * i + 1]);
      }
    }
  }
  constexpr int kAccLd = DP + 4;
  float* sAcc = reinterpret_cast<float*>(smem);  // [kBN][kAccLd], over the Q/dO stages
  acc_to_smem<DP>(sAcc, kAccLd, dk, r0, lane);
  __syncthreads();
  store_rows(sAcc, kAccLd, kBN, k0, p.S,
             static_cast<__nv_bfloat16*>(p.dk) + (size_t)bh * p.S * p.d, p.cos, p.sin, p.d);
}

// ---------------------------------------------------------------------------
// fp32: fp32 FMA (no TF32), four threads per row, 32 rows per block.
// ---------------------------------------------------------------------------

constexpr int kFB = 32;  // rows per block and rows per streamed tile

template <int DP>
__global__ void __launch_bounds__(128) flash_dq_f32(BwdParams p) {
  constexpr int kPer = DP / 4;  // columns per thread: part, part + 4, ...
  __shared__ float sK[kFB][DP];
  __shared__ float sV[kFB][DP];
  __shared__ float sBias[kFB];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int t = blockIdx.y * kFB + row;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.T * p.d;
  const float* dout = static_cast<const float*>(p.dout) + (size_t)bh * p.T * p.d;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.S * p.d;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.S * p.d;

  float qr[kPer], dr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = part + 4 * i;
    const bool ok = t < p.T && j < p.d;
    qr[i] = ok ? q[(size_t)t * p.d + j] : 0.f;
    dr[i] = ok ? dout[(size_t)t * p.d + j] : 0.f;
    acc[i] = 0.f;
  }
  const float lse = t < p.T ? p.lse[(size_t)bh * p.T + t] : INFINITY;
  const float dlt = t < p.T ? p.delta[(size_t)bh * p.T + t] : 0.f;

  for (int n0 = 0; n0 < p.S; n0 += kFB) {
    for (int e = threadIdx.x; e < kFB * DP; e += 128) {
      const int r = e / DP;
      const int j = e % DP;
      const int key = n0 + r;
      const bool ok = key < p.S && j < p.d;
      sK[r][j] = ok ? k[(size_t)key * p.d + j] : 0.f;
      sV[r][j] = ok ? v[(size_t)key * p.d + j] : 0.f;
    }
    for (int i = threadIdx.x; i < kFB; i += 128) sBias[i] = key_bias(p.mask, p.S, b, n0 + i);
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kFB; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s = fmaf(qr[i], sK[jj][part + 4 * i], s);
        dp = fmaf(dr[i], sV[jj][part + 4 * i], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float ds = expf(s + sBias[jj] - lse) * (dp - dlt);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(ds, sK[jj][part + 4 * i], acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) sK[row][part + 4 * i] = acc[i];
  __syncthreads();
  store_rows(&sK[0][0], DP, kFB, blockIdx.y * kFB, p.T,
             static_cast<float*>(p.dq) + (size_t)bh * p.T * p.d, p.cos, p.sin, p.d);
}

template <int DP>
__global__ void __launch_bounds__(128) flash_dkv_f32(BwdParams p) {
  constexpr int kPer = DP / 4;
  __shared__ float sQ[kFB][DP];
  __shared__ float sD[kFB][DP];
  __shared__ float sL[kFB];
  __shared__ float sDl[kFB];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int key = blockIdx.y * kFB + row;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.T * p.d;
  const float* dout = static_cast<const float*>(p.dout) + (size_t)bh * p.T * p.d;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.S * p.d;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.S * p.d;

  float kr[kPer], vr[kPer], dk[kPer], dv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = part + 4 * i;
    const bool ok = key < p.S && j < p.d;
    kr[i] = ok ? k[(size_t)key * p.d + j] : 0.f;
    vr[i] = ok ? v[(size_t)key * p.d + j] : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  const float bias = key_bias(p.mask, p.S, b, key);

  for (int m0 = 0; m0 < p.T; m0 += kFB) {
    for (int e = threadIdx.x; e < kFB * DP; e += 128) {
      const int r = e / DP;
      const int j = e % DP;
      const int t = m0 + r;
      const bool ok = t < p.T && j < p.d;
      sQ[r][j] = ok ? q[(size_t)t * p.d + j] : 0.f;
      sD[r][j] = ok ? dout[(size_t)t * p.d + j] : 0.f;
    }
    for (int i = threadIdx.x; i < kFB; i += 128) {
      const int t = m0 + i;
      sL[i] = t < p.T ? p.lse[(size_t)bh * p.T + t] : INFINITY;
      sDl[i] = t < p.T ? p.delta[(size_t)bh * p.T + t] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < kFB; ++ii) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s = fmaf(kr[i], sQ[ii][part + 4 * i], s);
        dp = fmaf(vr[i], sD[ii][part + 4 * i], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float pr = expf(s + bias - sL[ii]);
      const float ds = pr * (dp - sDl[ii]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        dv[i] = fmaf(pr, sD[ii][part + 4 * i], dv[i]);
        dk[i] = fmaf(ds, sQ[ii][part + 4 * i], dk[i]);
      }
    }
    __syncthreads();
  }

  if (key < p.S) {
    float* dvo = static_cast<float*>(p.dv) + (size_t)bh * p.S * p.d + (size_t)key * p.d;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = part + 4 * i;
      if (j < p.d) dvo[j] = dv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) sQ[row][part + 4 * i] = dk[i];
  __syncthreads();
  store_rows(&sQ[0][0], DP, kFB, blockIdx.y * kFB, p.S,
             static_cast<float*>(p.dk) + (size_t)bh * p.S * p.d, p.cos, p.sin, p.d);
}

template <typename F>
cudaError_t by_width(int d, F&& f) {
  switch ((d + 15) / 16 * 16) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 112: return f(std::integral_constant<int, 112>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

template <typename K>
cudaError_t launch_bf16(K kernel, size_t smem, dim3 grid, const BwdParams& p, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int T, int S, int d, const void* cos, const void* sin) {
  return B <= 0 || H <= 0 || T <= 0 || S <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
         (cos == nullptr) != (sin == nullptr);
}

}  // namespace

extern "C" {

// The dq pass. q (B, H, T, d) as the caller holds it (un-rotated); with
// rotary tables cos/sin ((L >= max(T, S), d) fp32) the prologue writes rot(q)
// into q_rot (scratch of q's shape and dtype), which the dk/dv pass reads
// next. k: (B, H, S, d) as the forward's main loop read it (rot(k) when
// rotary is on); v (B, H, S, d); o and dout (B, H, T, d); mask (B, S) uint8
// or null; lse (B, H, T) fp32 from the forward; delta (B, H, T) fp32
// receives rowsum(dout * o); dq (B, H, T, d) receives the gradient of q.
// All contiguous, 16-byte aligned, q/k/v/o/dout/dq of one dtype (is_bf16:
// bf16, else fp32). Launches on `stream`; returns the first CUDA error.
int esm_flash_attention_bwd_dq(const void* q, void* q_rot, const void* k, const void* v,
                               const void* mask, const void* cos, const void* sin,
                               const void* o, const void* dout, const void* lse, void* delta,
                               void* dq, int B, int H, int T, int S, int d, int is_bf16,
                               void* stream) {
  if (bad_shape(B, H, T, S, d, cos, sin) || (cos != nullptr && q_rot == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool bf16 = is_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  const size_t rows = (size_t)B * H * T;
  const void* qr = q;
  if (c != nullptr) {
    const cudaError_t e = bf16 ? rotate<__nv_bfloat16>(q, q_rot, c, s, rows, T, d, st)
                               : rotate<float>(q, q_rot, c, s, rows, T, d, st);
    if (e != cudaSuccess) return (int)e;
    qr = q_rot;
  }
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (bf16) {
    row_dot<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(o),
        static_cast<float*>(delta), rows, d);
  } else {
    row_dot<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(dout),
                                           static_cast<const float*>(o),
                                           static_cast<float*>(delta), rows, d);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const BwdParams p{qr, k, v, dout, static_cast<const uint8_t*>(mask), c, s,
                    static_cast<const float*>(lse), static_cast<const float*>(delta),
                    dq, nullptr, nullptr, H, T, S, d};
  e = by_width(d, [&](auto w) -> cudaError_t {
    constexpr int DP = decltype(w)::value;
    if (bf16) {
      return launch_bf16(flash_dq_bf16<DP>, bwd_smem_bytes<DP>(0),
                         dim3(B * H, (T + kBM - 1) / kBM), p, st);
    }
    flash_dq_f32<DP><<<dim3(B * H, (T + kFB - 1) / kFB), 128, 0, st>>>(p);
    return cudaGetLastError();
  });
  return (int)e;
}

// The dk/dv pass, after the dq pass: q_rot is what that pass read (rot(q)
// when rotary is on, else q), delta what it wrote; the other arguments as
// there. dk and dv (B, H, S, d) receive the gradients of k (pulled back
// through the rotary) and v.
int esm_flash_attention_bwd_dkv(const void* q_rot, const void* k, const void* v,
                                const void* mask, const void* cos, const void* sin,
                                const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, int B, int H, int T, int S, int d, int is_bf16,
                                void* stream) {
  if (bad_shape(B, H, T, S, d, cos, sin)) return (int)cudaErrorInvalidValue;
  const bool bf16 = is_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdParams p{q_rot, k, v, dout, static_cast<const uint8_t*>(mask),
                    static_cast<const float*>(cos), static_cast<const float*>(sin),
                    static_cast<const float*>(lse), static_cast<const float*>(delta),
                    nullptr, dk, dv, H, T, S, d};
  const cudaError_t e = by_width(d, [&](auto w) -> cudaError_t {
    constexpr int DP = decltype(w)::value;
    if (bf16) {
      return launch_bf16(flash_dkv_bf16<DP>, bwd_smem_bytes<DP>(2),
                         dim3(B * H, (S + kBN - 1) / kBN), p, st);
    }
    flash_dkv_f32<DP><<<dim3(B * H, (S + kFB - 1) / kFB), 128, 0, st>>>(p);
    return cudaGetLastError();
  });
  return (int)e;
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
