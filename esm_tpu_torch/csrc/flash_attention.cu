// Flash-attention forward for Hopper (sm_90a), with the GPT-NeoX rotary
// embedding and the key-padding bias fused in.
//
// Replaces the TPU kernel esm_tpu/kernels/flash_attention.py: the entries
// flash_attention (:1026) and flash_attention_dmajor (:1077), through
// _flash_core (:884) and _flash_padded (:394), with both of its bodies,
// _single_pass_kernel (:300, whole source resident, S <= 2048) and
// _flash_kernel (:211, online softmax over KV blocks, S > 2048). The TPU's
// split between the two bodies was a VMEM-size choice; here one loop over
// key/value tiles with a running max and sum covers every S. The d-major
// (B, H, d, T) layout of flash_attention_dmajor was a TPU lane-layout device
// and has no counterpart: the caller hands over (B, H, T, d).
//
//   out = softmax(rot(q) . rot(k)^T + bias) . v        on (B, H, T, d)
//
// q arrives already scaled; rot is the GPT-NeoX rotary with position = row
// index (q rows and k rows each from 0), from fp32 (L, d) tables with
// L >= max(T, S); bias is 0, or -1e30 where key_padding_mask is set; keys
// past S are excluded. Softmax statistics and accumulation are fp32; a row
// whose sum is 0 divides by 1. The output has q's dtype. Given an lse
// buffer (the differentiated forward, and flash_attention_with_lse), each
// row's log-sum-exp m + log(max(l, 1e-37)) is written beside it in fp32, as
// the TPU kernel's with_lse output (:294, :383); the backward
// (flash_attention_bwd.cu) recomputes the probabilities from it.
//
// What bounds it on an H100: at the ESM-2 shapes (T = S ~ 1024, d = 64) the
// work is 4.B.H.T.S.d operations over 4.B.H.T.d.2 bytes, ~T/2 operations per
// byte, far above the card's ~295 in bf16, so the tensor cores bound it; at
// d = 64 the B.H.T.S exponentials (16 per SM-clock on the MUFU unit) take
// about as long as the products. The bf16 kernel (below) keeps the (T, S)
// scores out of device memory and in registers, feeds the tensor cores with
// wgmma from TMA-loaded, swizzled tiles (hopper_common.cuh), and overlaps
// each key tile's exponentials with the previous tile's P.V product. Every
// query tile reads every key tile, so work done per key tile as it is loaded
// is repeated T/128 times: the rotary of K is therefore applied once, by a
// prologue kernel into a scratch copy of K that the wrapper allocates (one
// extra read and write of K, which the training path keeps as its saved
// rot(k)); the bf16 path rotates Q the same way (rotating each Q tile inside
// the kernel, in shared memory or at the fragment load, put the tables'
// loads on the consumers' path and cost more than this pass). The fp32 path
// (parity runs) uses fp32 FMA, not TF32, so it keeps fp32 accuracy; it is
// bounded by the 67 TFLOP/s fp32 rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/flash_attention.py). The helpers shared
//        with the backward are in flash_common.cuh and hopper_common.cuh.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;        // K as the main loop reads it: rotated when rotary is on
  const void* v;
  const uint8_t* mask;  // (B, S), nonzero at padding; may be null
  const float* cos;     // (L, d) rotary tables, applied to Q; null when off
  const float* sin;
  void* o;
  float* lse;           // (B, H, T) per-row log-sum-exp; null when not wanted
  int H, T, S, d;
};

__device__ __forceinline__ float key_bias(const Params& p, int b, int j) {
  return flash::key_bias(p.mask, p.S, b, j);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel fed by TMA (hopper_common.cuh).
//
// A CTA is three warpgroups. Warpgroup 0 produces: its first warp loads, by
// TMA, each work tile's Q tile (128 rows, rotated by the prologue) and then
// its K and V tiles (128 keys each, 64 at d > 64) into a ring of kStages
// stages, writing each key tile's bias (times log2 e) beside them.
// Full/empty mbarriers pass the buffers back and forth. Warpgroups 1 and 2
// consume, 64 query rows each: they take their Q rows into registers as
// wgmma A fragments (freeing the Q tile for the next work tile's), then per
// key tile
//   S = Q K^T                 wgmma, A from registers, B (K-major) from
//                             shared memory
//   x = S log2 e + bias       one FMA; online softmax in registers, exp2
//   O = O alpha + P V         wgmma, P from registers (the S accumulators
//                             packed to bf16), V read MN-major (tnspB)
// where the products S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
// together and the softmax of tile j runs while the second is in flight, so
// that the tensor cores work while the MUFU unit computes the exponentials;
// the two consumer warpgroups take turns to issue, so that one's softmax
// also runs under the other's products.
// The grid is persistent: one CTA per SM walks the (b.h, query tile) work
// tiles in head-major order, so the CTAs running together share K and V in
// L2, and the producer loads the next tile while the consumers store.
// ---------------------------------------------------------------------------

constexpr int kHopperThreads = 384;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskBias2 = kMaskBias * kLog2e;  // a padded key's bias, times log2(e)

template <int DP>
struct Fwd {
  static constexpr int kBM = 128;  // query rows per work tile: 64 per consumer warpgroup
  // keys per tile: 128, or 64 at DP = 128, where the Q fragments, the scores,
  // P and O must share the 168 registers ptxas gives a consumer thread
  static constexpr int kBN = DP == 128 ? 64 : 128;
  using QTile = hopper::Tile<DP, kBM>;
  using KTile = hopper::Tile<DP, kBN>;
  static constexpr int kBiasBytes = 1024;  // kBN floats, padded to keep the tiles aligned
  static constexpr int kStageBytes = 2 * KTile::kBytes + kBiasBytes;
  static constexpr int kBudget = 220 * 1024;
  static constexpr int kStages =
      (kBudget - QTile::kBytes) / kStageBytes < 4 ? (kBudget - QTile::kBytes) / kStageBytes : 4;
  static_assert(kStages >= 2, "two stages at least");
  static constexpr int kSmem = 1024 + QTile::kBytes + kStages * kStageBytes;
};

struct FwdArgs {
  const uint8_t* mask;  // (B, S), nonzero at padding; may be null
  void* o;
  float* lse;  // (B, H, T) per-row log-sum-exp; null when not wanted
  int H, T, S, d;
  int n_qtiles, n_tiles;
};

// key_bias times log2(e), with the padding value exactly kMaskBias2.
__device__ __forceinline__ float key_bias2(const uint8_t* mask, int S, int b, int j) {
  if (j >= S) return -INFINITY;
  if (mask != nullptr && mask[(size_t)b * S + j]) return kMaskBias2;
  return 0.f;
}

template <int DP>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const FwdArgs p) {
  using C = Fwd<DP>;
  using QTile = typename C::QTile;
  using KTile = typename C::KTile;
  constexpr int kBN = C::kBN;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;
  unsigned char* sStages = smem + QTile::kBytes;  // [K tile | V tile | bias] per stage
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], q_full, q_empty;

  // warp-uniform (a shuffle from lane 0), as setmaxnreg.sync.aligned requires
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  const int n_kt = (p.S + kBN - 1) / kBN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes, with the TMA bytes
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_init(&q_full, 1);
    hopper::mbar_init(&q_empty, 8);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer warpgroup ----------------
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;  // one warp issues the loads
    if (lane == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
    }
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
      const int bh = tile / p.n_qtiles;
      const int q0 = (tile % p.n_qtiles) * C::kBM;
      const int b = bh / p.H;
      if (lane == 0) {
        hopper::mbar_wait(&q_empty, (it & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&q_full, QTile::kBytes);
        QTile::load(sQ, &q_map, &q_full, q0, bh);
      }
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
    }
  } else {
    // ---------------- consumers ----------------
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;  // consumer warpgroup: query rows [64 cw, 64 cw + 64)
    const int warp = (threadIdx.x & 127) >> 5;
    const int t4 = lane & 3;
    const int r_in = cw * 64 + warp * 16 + (lane >> 2);  // this thread's rows: r_in, r_in + 8
    hopper::TakeTurns turns(cw, 2);
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
      const int bh = tile / p.n_qtiles;
      const int q0 = (tile % p.n_qtiles) * C::kBM;
      const bool last_tile = tile + (int)gridDim.x >= p.n_tiles;
      // Q into registers: the tile is free for the next work tile's at once
      hopper::mbar_wait(&q_full, it & 1);
      uint32_t qa[DP / 16][4];
      QTile::a_frags(qa, sQ, r_in);
      hopper::warp_arrive(&q_empty);

      float o[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      float m2[2] = {-INFINITY, -INFINITY};  // running max of x = s log2 e + bias
      float l[2] = {0.f, 0.f};                // this thread's share of the running sums
      float s[kBN / 2];
      uint32_t pa[kBN / 16][4];

      // S = Q K^T of the key tile at stage stg (A and B K-major in shared memory)
      auto issue_qk = [&](int stg) {
        const uint32_t k_base = hopper::smem_u32(sStages + stg * C::kStageBytes);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          hopper::Wgmma<kBN>::template rs<0>(s, qa[kk], KTile::kmajor(k_base, 0, kk), kk > 0);
        }
        hopper::wgmma_commit();
      };
      // O += P V of the key tile at stage stg (P from registers, V MN-major)
      auto issue_pv = [&](int stg) {
        const uint32_t v_base = hopper::smem_u32(sStages + stg * C::kStageBytes) + KTile::kBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          hopper::Wgmma<DP>::template rs<1>(o, pa[kk], KTile::mnmajor(v_base, kk), 1);
        }
        hopper::wgmma_commit();
      };
      // bias, running max and exponentials of the scores in s (key tile at
      // stage stg), in place; the rows' rescale factors and new partial sums
      float alpha[2], ls[2];
      auto softmax = [&](int stg) {
        const float* bias = reinterpret_cast<const float*>(sStages + stg * C::kStageBytes +
                                                           2 * KTile::kBytes);
        float mx[2] = {m2[0], m2[1]};
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + c * 8 + t4 * 2);
          s[4 * c + 0] = fmaf(s[4 * c + 0], kLog2e, bb.x);
          s[4 * c + 1] = fmaf(s[4 * c + 1], kLog2e, bb.y);
          s[4 * c + 2] = fmaf(s[4 * c + 2], kLog2e, bb.x);
          s[4 * c + 3] = fmaf(s[4 * c + 3], kLog2e, bb.y);
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * c + 0], s[4 * c + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * c + 2], s[4 * c + 3]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          // every key tile holds a key < S, so mx is finite here
          alpha[i] = hopper::exp2_approx(m2[i] - mx[i]);
          m2[i] = mx[i];
          ls[i] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * c + e] = hopper::exp2_approx(s[4 * c + e] - m2[e >> 1]);
            ls[e >> 1] += s[4 * c + e];
          }
        }
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        }
      };

      // key tile 0: its product alone
      hopper::mbar_wait(&full[stage], phase);
      turns.wait();
      issue_qk(stage);
      turns.pass();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      softmax(stage);
      l[0] = ls[0];
      l[1] = ls[1];
      pack_p();
      int prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      for (int j = 1; j < n_kt; ++j) {
        hopper::mbar_wait(&full[stage], phase);
        turns.wait();
        issue_qk(stage);  // S of tile j ...
        issue_pv(prev);   // ... and O += P V of tile j - 1, both in flight
        turns.pass();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        softmax(stage);   // while P V runs
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        hopper::warp_arrive(&empty[prev]);
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) {
          o[4 * c + 0] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
        l[0] = l[0] * alpha[0] + ls[0];
        l[1] = l[1] * alpha[1] + ls[1];
        pack_p();
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      turns.wait();
      issue_pv(prev);
      if (last_tile) {
        turns.pass_unless_last();
      } else {
        turns.pass();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::warp_arrive(&empty[prev]);

      // epilogue: o / l in bf16, and the lse
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * p.T * p.d;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
        const int row = q0 + r_in + 8 * i;
        if (row >= p.T) continue;
        if (p.lse != nullptr && t4 == 0) {
          // a row whose keys are all padding has m = -1e30 exactly, as in the
          // plain version; the backward relies on it
          const float m = m2[i] == kMaskBias2 ? kMaskBias : m2[i] * kLn2;
          p.lse[(size_t)bh * p.T + row] = m + logf(fmaxf(l[i], 1e-37f));
        }
#pragma unroll
        for (int c = 0; c < DP / 8; ++c) {
          const int col = c * 8 + t4 * 2;
          if (col < p.d) {
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * p.d + col) =
                __floats2bfloat162_rn(o[4 * c + 2 * i] * inv, o[4 * c + 2 * i + 1] * inv);
          }
        }
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
__global__ void __launch_bounds__(128) flash_fwd_f32(Params p) {
  constexpr int kPer = DP / 4;  // columns per thread: part, part + 4, ...
  __shared__ float sK[kFBN][DP];
  __shared__ float sV[kFBN][DP];
  __shared__ float sBias[kFBN];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int t = blockIdx.y * kFBM + row;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.T * p.d;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.S * p.d;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.S * p.d;

  float qr[kPer], acc[kPer];
  const int half = p.d / 2;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = part + 4 * i;
    float x = 0.f;
    if (t < p.T && j < p.d) {
      const float* rp = q + (size_t)t * p.d;
      x = rp[j];
      if (p.cos != nullptr) {
        const bool lo = j < half;
        const size_t c = (size_t)t * p.d + (lo ? j : j - half);  // halves are equal
        x = rot_term(x, p.cos[c], lo ? -rp[j + half] : rp[j - half], p.sin[c]);
      }
    }
    qr[i] = x;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int n0 = 0; n0 < p.S; n0 += kFBN) {
    for (int e = threadIdx.x; e < kFBN * DP; e += 128) {
      const int r = e / DP;
      const int j = e % DP;
      const int key = n0 + r;
      const bool ok = key < p.S && j < p.d;
      sK[r][j] = ok ? k[(size_t)key * p.d + j] : 0.f;
      sV[r][j] = ok ? v[(size_t)key * p.d + j] : 0.f;
    }
    for (int i = threadIdx.x; i < kFBN; i += 128) sBias[i] = key_bias(p, b, n0 + i);
    __syncthreads();

    float s[kFBN];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kFBN; ++jj) {
      float part_sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) part_sum = fmaf(qr[i], sK[jj][part + 4 * i], part_sum);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 1);
      part_sum += __shfl_xor_sync(0xffffffffu, part_sum, 2);
      s[jj] = part_sum + sBias[jj];
      mx = fmaxf(mx, s[jj]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kFBN; ++jj) {
      const float pj = expf(s[jj] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pj, sV[jj][part + 4 * i], acc[i]);
    }
    __syncthreads();
  }

  if (t < p.T) {
    if (p.lse != nullptr && part == 0) p.lse[(size_t)bh * p.T + t] = m + logf(fmaxf(l, 1e-37f));
    const float denom = l == 0.f ? 1.f : l;
    float* o = static_cast<float*>(p.o) + (size_t)bh * p.T * p.d + (size_t)t * p.d;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = part + 4 * i;
      if (j < p.d) o[j] = acc[i] / denom;
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, FwdArgs a, int bh,
                        cudaStream_t stream) {
  using C = Fwd<DP>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t e = hopper::make_map<typename C::QTile>(&q_map, q, a.d, a.T, bh);
  if (e == cudaSuccess) e = hopper::make_map<typename C::KTile>(&k_map, k, a.d, a.S, bh);
  if (e == cudaSuccess) e = hopper::make_map<typename C::KTile>(&v_map, v, a.d, a.S, bh);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  }
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  a.n_qtiles = (a.T + C::kBM - 1) / C::kBM;
  a.n_tiles = bh * a.n_qtiles;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  flash_fwd_bf16<DP><<<grid, kHopperThreads, C::kSmem, stream>>>(q_map, k_map, v_map, a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  dim3 grid(bh, (p.T + kFBM - 1) / kFBM);
  flash_fwd_f32<DP><<<grid, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, T, d), k/v (B, H, S, d), o (B, H, T, d): contiguous, all of one
// dtype (is_bf16: bf16, else fp32), 16-byte aligned. mask: (B, S) uint8 or
// null. cos/sin: (L >= max(T, S), d) fp32, or null for no rotary; with them,
// k_rot is scratch of k's shape and dtype that receives rot(k), and, for bf16,
// q_rot scratch of q's that receives rot(q) (the fp32 kernel rotates Q as it
// loads it). lse: (B, H, T) fp32 that receives each row's log-sum-exp
// m + log(max(l, 1e-37)), or null. Launches on `stream` and returns the first
// CUDA error (0 on success).
int esm_flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* cos, const void* sin, void* k_rot, void* q_rot, void* o,
                            void* lse, int B, int H, int T, int S, int d, int is_bf16,
                            void* stream) {
  const bool bf16 = is_bf16 != 0;
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
      (cos == nullptr) != (sin == nullptr) ||
      (cos != nullptr && (k_rot == nullptr || (bf16 && q_rot == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  const void* kr = k;
  const void* qr = q;
  if (c != nullptr) {
    cudaError_t e = bf16 ? rotate<__nv_bfloat16>(k, k_rot, c, s, (size_t)B * H * S, S, d, st)
                         : rotate<float>(k, k_rot, c, s, (size_t)B * H * S, S, d, st);
    if (e == cudaSuccess && bf16) {
      e = rotate<__nv_bfloat16>(q, q_rot, c, s, (size_t)B * H * T, T, d, st);
      qr = q_rot;
    }
    if (e != cudaSuccess) return (int)e;
    kr = k_rot;
  }
  const int bh = B * H;
  cudaError_t e;
  if (bf16) {
    const FwdArgs a{static_cast<const uint8_t*>(mask), o, static_cast<float*>(lse), H, T, S, d,
                    0, 0};
    // the tile's width: d padded to a power of two >= 16 (TMA zero-fills the rest)
    const int dp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
    switch (dp) {
      case 16: e = launch_bf16<16>(qr, kr, v, a, bh, st); break;
      case 32: e = launch_bf16<32>(qr, kr, v, a, bh, st); break;
      case 64: e = launch_bf16<64>(qr, kr, v, a, bh, st); break;
      default: e = launch_bf16<128>(qr, kr, v, a, bh, st); break;
    }
    return (int)e;
  }
  const Params p{q, kr, v, static_cast<const uint8_t*>(mask), c, s, o, static_cast<float*>(lse),
                 H, T, S, d};
  switch ((d + 15) / 16 * 16) {
    case 16: e = launch_f32<16>(p, bh, st); break;
    case 32: e = launch_f32<32>(p, bh, st); break;
    case 48: e = launch_f32<48>(p, bh, st); break;
    case 64: e = launch_f32<64>(p, bh, st); break;
    case 80: e = launch_f32<80>(p, bh, st); break;
    case 96: e = launch_f32<96>(p, bh, st); break;
    case 112: e = launch_f32<112>(p, bh, st); break;
    case 128: e = launch_f32<128>(p, bh, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
