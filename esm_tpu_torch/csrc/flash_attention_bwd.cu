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
// forward saved its rotated copy); the dq pass, one CTA per (b.h, 128-query
// tile) walking the key tiles, which also computes delta for its rows and
// writes it; the dk/dv pass, one CTA per (b.h, 128-key tile) walking the
// query tiles. Neither pass writes anything another CTA of it reads, so there
// are no atomics and the result does not depend on the order CTAs run in.
//
// What bounds it on an H100: 10.B.H.T.S.d operations of matrix products
// (the two passes recompute S and dP, 14.B.H.T.S.d in all) over
// ~9.B.H.T.d.2 bytes at the ESM-2 shapes: far above the card's ~295
// operations per byte, so the tensor cores bound it. The bf16 kernels keep
// every (T, S) quantity in registers and run every product on wgmma: the
// score-side products (S, dP, or their transposes) with both operands
// TMA-loaded into swizzled shared memory, the gradient products with P or
// dS re-packed from the accumulators as the register A operand and the
// streamed tile read transposed (tnspB); a producer warp keeps the streamed
// tiles in flight (hopper_common.cuh). The fp32 kernels (parity runs) use
// fp32 FMA, not TF32, four threads per row, with a row_dot launch for delta.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/flash_attention.py).

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

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

// delta[r] = sum_c a[r, c] b[r, c] in fp32, one warp per row (the fp32 path;
// the bf16 dq pass computes delta in its prologue).
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
// given; threads tid of n_threads share the work.
template <typename T>
__device__ void store_rows(const float* tile, int ld, int n_rows, int row0, int n, T* out,
                           const float* cos, const float* sin, int d, int tid, int n_threads) {
  const int half = d / 2;
  for (int c = tid; c < n_rows * half; c += n_threads) {
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

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernels fed by TMA (hopper_common.cuh), one
// per pass. A CTA is a producer warpgroup, whose first warp loads the
// resident tiles once and streams the other side's tiles through a ring of
// kStages stages (full/empty mbarriers), writing the per-column values each
// stage needs (key bias, or lse and delta) beside them; the consumer
// warpgroups (two, one for the dk/dv pass at d = 128) each own 64 rows.
// Each turn issues the score-side products of step i (A and B K-major from
// shared memory) and the gradient products of step i - 1 (the streamed tile
// read MN-major, tnspB; dS as the register A operand in the dq pass, P^T and
// dS^T through shared memory in the dk/dv pass), then forms step i's P and
// dS while the gradient products run; two consumer warpgroups take turns to
// issue. The grid is one CTA per (b.h, row tile), head-major.
// ---------------------------------------------------------------------------

constexpr int kHopperThreads = 384;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kMaskBias2 = kMaskBias * kLog2e;  // a padded key's bias, times log2(e)

struct BwdArgs {
  const uint8_t* mask;  // (B, S), nonzero at padding; may be null
  const float* cos;     // (L, d) tables for the un-rotation; null when off
  const float* sin;
  const float* lse;     // (B, H, T)
  float* delta;         // (B, H, T): written by the dq pass, read by the dk/dv pass
  const void* o;        // the dq pass reads o and dout for delta
  const void* dout;
  void* dq;             // the dq pass writes dq; the dk/dv pass dk and dv
  void* dk;
  void* dv;
  int H, T, S, d;
  int n_tiles;          // row tiles per (b, h): the grid is n_tiles . B . H
};

// key_bias times log2(e), with the padding value exactly kMaskBias2.
__device__ __forceinline__ float key_bias2(const uint8_t* mask, int S, int b, int j) {
  if (j >= S) return -INFINITY;
  if (mask != nullptr && mask[(size_t)b * S + j]) return kMaskBias2;
  return 0.f;
}

// The four A-register fragments of columns [16 kk, 16 kk + 16) of an m64nN
// accumulator, rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
  }
}

// An m64nDP accumulator (rows r0 + warp 16 + lane / 4 (+ 8)) into an fp32
// tile in shared memory with row stride ld.
template <int DP>
__device__ __forceinline__ void acc_to_smem(float* tile, int ld, const float (&acc)[DP / 2],
                                            int r0) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = c * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(tile + row * ld + col) = make_float2(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<float2*>(tile + (row + 8) * ld + col) =
        make_float2(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// Stages and shared memory of a pass: resident tiles (two of RES rows),
// EXTRA bytes of the pass's own, kStages stages of two streamed tiles (ROWS rows) and 1 KB of per-column
// fp32 values; the epilogue reuses the stage area, at least RES x (DP + 4)
// floats, for the fp32 gradient tile.
template <int DP, int RES, int ROWS, int EXTRA = 0>
struct BwdConfig {
  using ResTile = hopper::Tile<DP, RES>;
  using StrTile = hopper::Tile<DP, ROWS>;
  static constexpr int kStageBytes = 2 * StrTile::kBytes + 1024;
  static constexpr int kBudget = 220 * 1024 - 2 * ResTile::kBytes - EXTRA;
  static constexpr int kStages = kBudget / kStageBytes < 4 ? kBudget / kStageBytes : 4;
  static_assert(kStages >= 2, "two stages at least");
  static constexpr int kEpilogueBytes = RES * (DP + 4) * 4;
  static constexpr int kStageArea =
      kStages * kStageBytes > kEpilogueBytes ? kStages * kStageBytes : kEpilogueBytes;
  static constexpr int kSmem = 1024 + 2 * ResTile::kBytes + EXTRA + kStageArea;
};

// Keys per step of the dq pass, queries per step of the dk/dv pass, and the
// dk/dv pass's consumer warpgroups: the shapes whose accumulators (the
// step's two score tiles, dS re-packed in the dq pass, the gradient tiles)
// fit in the registers ptxas allocates, 168 a thread in a 384-thread CTA
// whatever setmaxnreg grants later; the dk/dv pass passes P and dS through
// shared memory for that. At d = 128 the dK and dV tiles alone take 128, so
// that pass runs one consumer warpgroup (256 threads, 232 registers).
__host__ __device__ constexpr int dq_keys(int dp) { return dp == 128 ? 32 : 64; }
__host__ __device__ constexpr int dkv_rows(int dp) { return dp == 128 ? 32 : 64; }
__host__ __device__ constexpr int dkv_warpgroups(int dp) { return dp == 128 ? 1 : 2; }

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// dq pass: a CTA owns 128 queries (Q and dO resident), streams dq_keys(DP)-key
// K and V tiles; delta = rowsum(dO o O) in the prologue, written for the
// dk/dv pass.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_dq_bf16(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const BwdArgs p) {
  constexpr int kBN = dq_keys(DP);
  using C = BwdConfig<DP, 128, kBN>;
  using QTile = typename C::ResTile;
  using KTile = typename C::StrTile;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sDo = smem + QTile::kBytes;
  unsigned char* sStages = smem + 2 * QTile::kBytes;  // [K tile | V tile | bias] per stage
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], res_full;

  // warp-uniform (a shuffle from lane 0), as setmaxnreg.sync.aligned requires
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x / p.n_tiles;
  const int q0 = (blockIdx.x % p.n_tiles) * 128;
  const int b = bh / p.H;
  const int n_kt = (p.S + kBN - 1) / kBN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_init(&res_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&res_full, 2 * QTile::kBytes);
      QTile::load(sQ, &q_map, &res_full, q0, bh);
      QTile::load(sDo, &do_map, &res_full, q0, bh);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_kt; ++j) {
      unsigned char* st = sStages + stage * C::kStageBytes;
      float* bias = reinterpret_cast<float*>(st + 2 * KTile::kBytes);
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      for (int i = lane; i < kBN; i += 32) bias[i] = key_bias2(p.mask, p.S, b, j * kBN + i);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * KTile::kBytes);
        KTile::load(st, &k_map, &full[stage], j * kBN, bh);
        KTile::load(st + KTile::kBytes, &v_map, &full[stage], j * kBN, bh);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int t4 = lane & 3;
  const int r_in = cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  // delta and lse (times log2 e) of rows r_in and r_in + 8; rows past T get
  // P = exp2(x - inf) = 0 and delta 0, so they add nothing
  float dlt[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_in + 8 * i;
    float acc = 0.f;
    if (row < p.T) {
      const size_t base = ((size_t)bh * p.T + row) * p.d;
      for (int c = t4 * 8; c < p.d; c += 32) {
        const uint4 x = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) +
                                                        base + c);
        const uint4 y =
            *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.o) + base + c);
        const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(xh[e]);
          const float2 bb = __bfloat1622float2(yh[e]);
          acc = fmaf(a.x, bb.x, acc);
          acc = fmaf(a.y, bb.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[i] = acc;
    lse2[i] = row < p.T ? p.lse[(size_t)bh * p.T + row] * kLog2e : INFINITY;
    if (row < p.T && t4 == 0) p.delta[(size_t)bh * p.T + row] = acc;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  float s[kBN / 2], dp[kBN / 2];
  uint32_t da[kBN / 16][4];
  const uint32_t q_base = hopper::smem_u32(sQ);
  const uint32_t do_base = hopper::smem_u32(sDo);
  hopper::mbar_wait(&res_full, 0);

  hopper::TakeTurns turns(cw, 2);
  auto issue_scores = [&](int stg) {  // S = Q K^T, dP = dO V^T
    const uint32_t k_base = hopper::smem_u32(sStages + stg * C::kStageBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hopper::Wgmma<kBN>::ss(s, QTile::kmajor(q_base, cw * 64, kk), KTile::kmajor(k_base, 0, kk),
                             kk > 0);
      hopper::Wgmma<kBN>::ss(dp, QTile::kmajor(do_base, cw * 64, kk),
                             KTile::kmajor(k_base + KTile::kBytes, 0, kk), kk > 0);
    }
    hopper::wgmma_commit();
  };
  auto issue_dq = [&](int stg) {  // dQ += dS K
    const uint32_t k_base = hopper::smem_u32(sStages + stg * C::kStageBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      hopper::Wgmma<DP>::template rs<1>(dq, da[kk], KTile::mnmajor(k_base, kk), 1);
    }
    hopper::wgmma_commit();
  };
  // dS = P (dP - delta), P = exp2(S log2 e + bias - lse log2 e), in place of S
  auto grads = [&](int stg) {
    const float* bias =
        reinterpret_cast<const float*>(sStages + stg * C::kStageBytes + 2 * KTile::kBytes);
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + c * 8 + t4 * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float x = fmaf(s[4 * c + e], kLog2e, (e & 1) ? bb.y : bb.x);
        const float pr = hopper::exp2_approx(x - lse2[i]);
        s[4 * c + e] = pr * (dp[4 * c + e] - dlt[i]);
      }
    }
  };

  // as in K1: each turn issues the scores of key tile j and the dQ product
  // of tile j - 1, and tile j's dS is formed while the second runs
  int stage = 0;
  uint32_t phase = 0;
  hopper::mbar_wait(&full[stage], phase);
  turns.wait();
  issue_scores(stage);
  turns.pass();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  hopper::fence_regs(dp);
  grads(stage);
  pack_frags<kBN>(da, s);
  int prev = stage;
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
  for (int j = 1; j < n_kt; ++j) {
    hopper::mbar_wait(&full[stage], phase);
    turns.wait();
    issue_scores(stage);
    issue_dq(prev);
    turns.pass();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    grads(stage);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    hopper::fence_regs(da);
    hopper::warp_arrive(&empty[prev]);
    pack_frags<kBN>(da, s);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  turns.wait();
  issue_dq(prev);
  turns.pass_unless_last();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);

  // every stage is consumed and the producer is done: un-rotate and store
  // through the stage area
  hopper::named_sync(1, 256);
  constexpr int kAccLd = DP + 4;
  float* sAcc = reinterpret_cast<float*>(sStages);
  acc_to_smem<DP>(sAcc, kAccLd, dq, cw * 64);
  hopper::named_sync(1, 256);
  store_rows(sAcc, kAccLd, 128, q0, p.T,
             static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.T * p.d, p.cos, p.sin, p.d,
             threadIdx.x - 128, 256);
}

// ---------------------------------------------------------------------------
// dk/dv pass: a CTA owns 64 keys per consumer warpgroup (K and V resident),
// streams dkv_rows(DP)-query Q and dO tiles with their lse (times log2 e)
// and delta.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(128 * (1 + dkv_warpgroups(DP)), 1)
    flash_dkv_bf16(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap do_map, const BwdArgs p) {
  constexpr int kBM = dkv_rows(DP);
  constexpr int kNW = dkv_warpgroups(DP);  // consumer warpgroups, 64 keys each
  constexpr int kRows = 64 * kNW;          // keys per CTA
  using PTile = hopper::Tile<kBM, 64>;     // P^T or dS^T of a warpgroup: 64 keys x kBM queries
  using C = BwdConfig<DP, kRows, kBM, 4 * kNW * PTile::kBytes>;
  using KTile = typename C::ResTile;
  using QTile = typename C::StrTile;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + KTile::kBytes;
  unsigned char* sP = smem + 2 * KTile::kBytes;  // [warpgroup][buffer][P^T | dS^T]
  unsigned char* sStages = sP + 4 * kNW * PTile::kBytes;  // [Q tile | dO tile | lse2 | delta]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], res_full;

  // warp-uniform (a shuffle from lane 0), as setmaxnreg.sync.aligned requires
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x / p.n_tiles;
  const int k0 = (blockIdx.x % p.n_tiles) * kRows;
  const int b = bh / p.H;
  const int n_qt = (p.T + kBM - 1) / kBM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], 4 * kNW);
    }
    hopper::mbar_init(&res_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&res_full, 2 * KTile::kBytes);
      KTile::load(sK, &k_map, &res_full, k0, bh);
      KTile::load(sV, &v_map, &res_full, k0, bh);
    }
    const float* lse = p.lse + (size_t)bh * p.T;
    const float* delta = p.delta + (size_t)bh * p.T;
    int stage = 0;
    uint32_t phase = 0;
    for (int i0 = 0; i0 < n_qt; ++i0) {
      unsigned char* st = sStages + stage * C::kStageBytes;
      float* sl = reinterpret_cast<float*>(st + 2 * QTile::kBytes);
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      for (int i = lane; i < kBM; i += 32) {
        const int row = i0 * kBM + i;
        const bool in = row < p.T;
        sl[i] = in ? lse[row] * kLog2e : INFINITY;  // rows past T: P = 0
        sl[kBM + i] = in ? delta[row] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * QTile::kBytes);
        QTile::load(st, &q_map, &full[stage], i0 * kBM, bh);
        QTile::load(st + QTile::kBytes, &do_map, &full[stage], i0 * kBM, bh);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int t4 = lane & 3;
  const int r_in = cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  float bias2[2];  // key rows r_in and r_in + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) bias2[i] = key_bias2(p.mask, p.S, b, k0 + r_in + 8 * i);

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  float st_[kBM / 2], dpt[kBM / 2];
  const uint32_t k_base = hopper::smem_u32(sK);
  const uint32_t v_base = hopper::smem_u32(sV);
  unsigned char* my_p = sP + cw * 4 * PTile::kBytes;  // this warpgroup's two P^T/dS^T buffers
  hopper::mbar_wait(&res_full, 0);
  hopper::TakeTurns turns(cw, kNW);
  auto issue_scores = [&](int stg) {  // S^T = K Q^T, dP^T = V dO^T
    const uint32_t q_base = hopper::smem_u32(sStages + stg * C::kStageBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hopper::Wgmma<kBM>::ss(st_, KTile::kmajor(k_base, cw * 64, kk),
                             QTile::kmajor(q_base, 0, kk), kk > 0);
      hopper::Wgmma<kBM>::ss(dpt, KTile::kmajor(v_base, cw * 64, kk),
                             QTile::kmajor(q_base + QTile::kBytes, 0, kk), kk > 0);
    }
    hopper::wgmma_commit();
  };
  // dV += P^T dO, dK += dS^T Q, with P^T and dS^T from buffer buf
  auto issue_grads = [&](int stg, int buf) {
    const uint32_t q_base = hopper::smem_u32(sStages + stg * C::kStageBytes);
    const uint32_t p_base = hopper::smem_u32(my_p + buf * 2 * PTile::kBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk) {
      hopper::Wgmma<DP>::template ss<1>(dv, PTile::kmajor(p_base, 0, kk),
                                        QTile::mnmajor(q_base + QTile::kBytes, kk), 1);
      hopper::Wgmma<DP>::template ss<1>(dk, PTile::kmajor(p_base + PTile::kBytes, 0, kk),
                                        QTile::mnmajor(q_base, kk), 1);
    }
    hopper::wgmma_commit();
  };
  // P^T = exp2(S^T log2 e + bias - lse log2 e) and dS^T = P^T (dP^T - delta),
  // rounded to bf16 into buffer buf for the gradient products
  auto probs = [&](int stg, int buf) {
    const float* sl =
        reinterpret_cast<const float*>(sStages + stg * C::kStageBytes + 2 * QTile::kBytes);
    unsigned char* pt = my_p + buf * 2 * PTile::kBytes;
    const int row = (r_in & 63);
#pragma unroll
    for (int c = 0; c < kBM / 8; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + c * 8 + t4 * 2);
      const float2 d2 = *reinterpret_cast<const float2*>(sl + kBM + c * 8 + t4 * 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows row and row + 8
        const int e = 4 * c + 2 * h;
        const float p0 = hopper::exp2_approx(fmaf(st_[e], kLog2e, bias2[h]) - l2.x);
        const float p1 = hopper::exp2_approx(fmaf(st_[e + 1], kLog2e, bias2[h]) - l2.y);
        const int off = PTile::offset(row + 8 * h, c * 8 + t4 * 2);
        *reinterpret_cast<uint32_t*>(pt + off) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(pt + PTile::kBytes + off) =
            pack_bf16(p0 * (dpt[e] - d2.x), p1 * (dpt[e + 1] - d2.y));
      }
    }
    hopper::fence_proxy_async();  // the wgmma of the next turn reads them
    hopper::named_sync(5 + cw, 128);
  };

  // as in the dq pass: each turn issues the scores of query tile i and the
  // gradient products of tile i - 1, and tile i's P and dS are formed (into
  // the other buffer) while the second runs
  int stage = 0;
  uint32_t phase = 0;
  hopper::mbar_wait(&full[stage], phase);
  turns.wait();
  issue_scores(stage);
  turns.pass();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(st_);
  hopper::fence_regs(dpt);
  probs(stage, 0);
  int prev = stage;
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
  for (int i0 = 1; i0 < n_qt; ++i0) {
    hopper::mbar_wait(&full[stage], phase);
    turns.wait();
    issue_scores(stage);
    issue_grads(prev, (i0 - 1) & 1);
    turns.pass();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(st_);
    hopper::fence_regs(dpt);
    probs(stage, i0 & 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::warp_arrive(&empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  turns.wait();
  issue_grads(prev, (n_qt - 1) & 1);
  turns.pass_unless_last();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dk);
  hopper::fence_regs(dv);

  __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(p.dv) + (size_t)bh * p.S * p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r_in + 8 * i;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = c * 8 + t4 * 2;
      if (col < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(dvo + (size_t)row * p.d + col) =
            __floats2bfloat162_rn(dv[4 * c + 2 * i], dv[4 * c + 2 * i + 1]);
      }
    }
  }
  hopper::named_sync(1, 128 * kNW);
  constexpr int kAccLd = DP + 4;
  float* sAcc = reinterpret_cast<float*>(sStages);
  acc_to_smem<DP>(sAcc, kAccLd, dk, cw * 64);
  hopper::named_sync(1, 128 * kNW);
  store_rows(sAcc, kAccLd, kRows, k0, p.S,
             static_cast<__nv_bfloat16*>(p.dk) + (size_t)bh * p.S * p.d, p.cos, p.sin, p.d,
             threadIdx.x - 128, 128 * kNW);
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
             static_cast<float*>(p.dq) + (size_t)bh * p.T * p.d, p.cos, p.sin, p.d, threadIdx.x, blockDim.x);
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
             static_cast<float*>(p.dk) + (size_t)bh * p.S * p.d, p.cos, p.sin, p.d, threadIdx.x, blockDim.x);
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

// bf16 tiles: d padded to a power of two >= 16 (TMA zero-fills the rest).
template <typename F>
cudaError_t by_tile_width(int d, F&& f) {
  if (d <= 16) return f(std::integral_constant<int, 16>());
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  return f(std::integral_constant<int, 128>());
}

template <typename Kernel>
cudaError_t launch_hopper(Kernel kernel, int threads, int smem, int blocks,
                          const CUtensorMap& m0, const CUtensorMap& m1, const CUtensorMap& m2,
                          const CUtensorMap& m3, const BwdArgs& a, cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, smem, st>>>(m0, m1, m2, m3, a);
  return cudaGetLastError();
}

// The tensor maps of the resident (128-row boxes) and streamed tiles of a
// pass: r0, r1 over `res_rows` rows, s0, s1 over `str_rows`.
template <typename C>
cudaError_t pass_maps(CUtensorMap (&m)[4], const void* r0, const void* r1, int res_rows,
                      const void* s0, const void* s1, int str_rows, int d, int bh) {
  cudaError_t e = hopper::make_map<typename C::ResTile>(&m[0], r0, d, res_rows, bh);
  if (e == cudaSuccess) e = hopper::make_map<typename C::ResTile>(&m[1], r1, d, res_rows, bh);
  if (e == cudaSuccess) e = hopper::make_map<typename C::StrTile>(&m[2], s0, d, str_rows, bh);
  if (e == cudaSuccess) e = hopper::make_map<typename C::StrTile>(&m[3], s1, d, str_rows, bh);
  return e;
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
  const int bh = B * H;
  if (bf16) {
    BwdArgs a{static_cast<const uint8_t*>(mask), c, s, static_cast<const float*>(lse),
              static_cast<float*>(delta), o, dout, dq, nullptr, nullptr, H, T, S, d,
              (T + 127) / 128};
    return (int)by_tile_width(d, [&](auto w) -> cudaError_t {
      constexpr int DP = decltype(w)::value;
      using C = BwdConfig<DP, 128, dq_keys(DP)>;
      CUtensorMap m[4];
      const cudaError_t e = pass_maps<C>(m, qr, dout, T, k, v, S, d, bh);
      if (e != cudaSuccess) return e;
      return launch_hopper(flash_dq_bf16<DP>, kHopperThreads, C::kSmem, bh * a.n_tiles, m[0], m[1],
                           m[2], m[3], a, st);
    });
  }
  row_dot<float><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const float*>(dout), static_cast<const float*>(o), static_cast<float*>(delta),
      rows, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const BwdParams p{qr, k, v, dout, static_cast<const uint8_t*>(mask), c, s,
                    static_cast<const float*>(lse), static_cast<const float*>(delta),
                    dq, nullptr, nullptr, H, T, S, d};
  e = by_width(d, [&](auto w) -> cudaError_t {
    constexpr int DP = decltype(w)::value;
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
  if (bf16) {
    const int bh = B * H;
    BwdArgs a{static_cast<const uint8_t*>(mask), static_cast<const float*>(cos),
              static_cast<const float*>(sin), static_cast<const float*>(lse),
              static_cast<float*>(const_cast<void*>(delta)), nullptr, dout, nullptr, dk, dv,
              H, T, S, d, 0};
    return (int)by_tile_width(d, [&](auto w) -> cudaError_t {
      constexpr int DP = decltype(w)::value;
      constexpr int kRows = 64 * dkv_warpgroups(DP);
      using C = BwdConfig<DP, kRows, dkv_rows(DP),
                          4 * dkv_warpgroups(DP) * hopper::Tile<dkv_rows(DP), 64>::kBytes>;
      a.n_tiles = (S + kRows - 1) / kRows;
      CUtensorMap m[4];
      const cudaError_t e = pass_maps<C>(m, k, v, S, q_rot, dout, T, d, bh);
      if (e != cudaSuccess) return e;
      return launch_hopper(flash_dkv_bf16<DP>, 128 * (1 + dkv_warpgroups(DP)), C::kSmem,
                           bh * a.n_tiles, m[0], m[1], m[2], m[3], a, st);
    });
  }
  const BwdParams p{q_rot, k, v, dout, static_cast<const uint8_t*>(mask),
                    static_cast<const float*>(cos), static_cast<const float*>(sin),
                    static_cast<const float*>(lse), static_cast<const float*>(delta),
                    nullptr, dk, dv, H, T, S, d};
  const cudaError_t e = by_width(d, [&](auto w) -> cudaError_t {
    constexpr int DP = decltype(w)::value;
    flash_dkv_f32<DP><<<dim3(B * H, (S + kFB - 1) / kFB), 128, 0, st>>>(p);
    return cudaGetLastError();
  });
  return (int)e;
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
