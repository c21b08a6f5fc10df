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
// (0 or -1e30). Scores and softmax statistics are fp32, the tri bias is
// added before the mask bias, P is rounded to v's dtype before P.V (as the
// TPU kernel's p.astype(v.dtype)), a row sum of 0 divides by 1. Keys past J
// are excluded; a row whose keys are all masked averages v over the J keys.
//
// The TPU kernel read (B, I, H, d, J) with J on the 128-lane axis and put I
// innermost in its grid, so one (J, J) bias strip stayed in VMEM while the
// rows streamed through. Neither layout carries over: this kernel reads q/k/v
// and writes o in the (B, I, J, H, d) layout the projections produce (a
// 4-D TMA map walks rows j at a stride of H.d), and one online-softmax loop
// over key tiles covers every J.
//
// What bounds it on an H100: at the trunk's shape (I = J = 1000, H = 4,
// d = 32) each score costs 4.d = 128 FLOPs, one exponential and ~6 other
// instructions; the operations take 0.52 ms at 989 TFLOP/s, the 4e9
// exponentials ~1 ms at 16 per SM-clock. What a kernel stages matters as
// much: the fp32 bias is 4 bytes per score for every row i that reads it,
// and K/V are re-read by every query tile of a row. The previous design (one
// row per CTA, mma.sync) moved ~25 GB through L2 per call and was bound by it.
//
// The bf16 design (tri_attn_bf16), on hopper_common.cuh:
//  * a CTA owns a (b, h, 128-query tile) and a group of R rows i of one
//    batch (R = 2 at d = 32); each 64-key tile of the fp32 bias is loaded
//    once and used for the R rows, which cuts the bias traffic by R, and the
//    128-query tile halves the K/V re-reads against 64 queries: 3 bytes
//    staged per score at R = 2, 12 GB per call at the trunk's shape;
//  * warpgroup 0 produces: one lane issues the TMA loads (the group's Q
//    tiles once, then per key tile the R rows' K and V tiles, through a 4-D
//    map that walks rows j at a stride of H.d, and the bias tile, into a ring
//    of up to four stages, swizzled for wgmma), one warp writes the R mask
//    rows times log2 e (-inf past J) and a flag per row that says whether
//    the tile has a nonzero mask term. TMA needs 16-byte row strides, so for
//    J % 4 != 0 the wrapper pads the bias rows to a multiple of 4 floats;
//  * warpgroups 1 and 2 consume 64 queries each, P of the R rows per step
//    (P = 2 at d = 32, so two rows' softmaxes interleave): S = tri + Q K^T on
//    wgmma, the thread's bias fragment loaded from shared memory into the
//    accumulator and the product accumulated onto it (both operands
//    K-major); on a tile without mask terms the max is taken over S and
//    p = exp2(S log2 e - m) in one FMA, on a masked tile x = S log2 e + mask
//    log2 e first; O += P V on wgmma (P from registers, V MN-major). Each
//    step's S products issue with the previous step's P V, whose product
//    runs under this step's softmax, and the two warpgroups take turns to
//    issue, so one's softmax runs under the other's products;
//  * the grid is persistent, one CTA per SM, the query tiles of a (row group,
//    head) adjacent so the CTAs running together share K and V in L2.
// PERF.md (section 6) has what limits it, measured. No atomics: every output
// element is written once, so repeat calls are bitwise equal. The fp32 path
// (parity runs) uses fp32 FMA, not TF32, and keeps fp32 accuracy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/triangle_attention.py).

#include <string.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;        // (B, I, J, H, d)
  const void* k;
  const void* v;
  const float* tri;     // (B, H, J, tri_ld): (B, H, J, J) with rows padded to tri_ld floats
  const float* maskb;   // (B, I, J)
  void* o;              // (B, I, J, H, d)
  int I, J, H, d, tri_ld;
};

// Offset of row j of (b, i, h) in a (B, I, J, H, d) tensor.
__device__ __forceinline__ size_t row_offset(const Params& p, int b, int i, int h, int j) {
  return (((size_t)b * p.I + i) * p.J + j) * (size_t)(p.H * p.d) + (size_t)h * p.d;
}

// The additive key term of key n for row (b, i): the mask bias, or -inf
// past J (excluded).
__device__ __forceinline__ float key_term(const float* maskb_row, int J, int n) {
  return n < J ? maskb_row[n] : -INFINITY;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel fed by TMA (design in the header).
// ---------------------------------------------------------------------------

constexpr int kHopperThreads = 384;
constexpr int kProducerRegs = 88;
constexpr int kConsumerRegs = 208;

template <int DP, int R>
struct Tri {
  static constexpr int kBM = 128;  // queries per CTA: 64 per consumer warpgroup
  static constexpr int kBN = 64;   // keys per tile
  using QTile = hopper::Tile<DP, kBM>;
  using KTile = hopper::Tile<DP, kBN>;
  // The fp32 bias tile: kBM rows x kBN keys as two boxes of 32 keys (128-byte
  // rows, 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r & 7)).
  static constexpr int kBiasBox = kBM * 128;
  static constexpr int kBiasBytes = 2 * kBiasBox;
  // One stage: the R rows' K tiles, their V tiles, the bias tile, the R mask
  // rows (fp32, times log2 e) and R flags.
  static constexpr int kVOff = R * KTile::kBytes;
  static constexpr int kBiasOff = 2 * R * KTile::kBytes;
  static constexpr int kMaskOff = kBiasOff + kBiasBytes;
  static constexpr int kFlagOff = kMaskOff + R * kBN * 4;
  static constexpr int kStageBytes = (kFlagOff + R * 4 + 1023) / 1024 * 1024;
  static constexpr int kBudget = 232448 - 1024 - 256;  // less alignment and static barriers
  static constexpr int kFit = (kBudget - R * QTile::kBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "two stages at least");
  static constexpr int kSmem = 1024 + R * QTile::kBytes + kStages * kStageBytes;
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

struct TriArgs {
  const float* maskb;  // (B, I, J)
  void* o;
  int I, J, H, d;
  int n_qt, n_grp, n_tiles;
};

// Work tile t of the persistent grid: the query tile fastest, then the head,
// then the row group, then the batch, so the CTAs running together share a
// group's K and V in L2.
struct WorkTile {
  int qt, h, grp, b;
  __device__ WorkTile(const TriArgs& p, int t)
      : qt(t % p.n_qt), h(t / p.n_qt % p.H), grp(t / p.n_qt / p.H % p.n_grp),
        b(t / p.n_qt / p.H / p.n_grp) {}
};

// Byte offset of bias element (row, key) in a stage's bias tile.
__device__ __forceinline__ int bias_offset(int row, int key, int box_bytes) {
  return (key >> 5) * box_bytes + ((row * 128 + (key & 31) * 4) ^ ((row & 7) << 4));
}

// Shared-memory loads by 32-bit shared address (a generic pointer into the
// realigned dynamic buffer compiles to generic loads).
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ int lds_i32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Byte offset of a K-major operand's 16-column step kk from column 0.
template <typename TileT>
__host__ __device__ constexpr int kmajor_step(int kk) {
  return (16 * kk / TileT::kBoxCols) * TileT::kBoxBytes + (16 * kk % TileT::kBoxCols) * 2;
}

// The TMA loads of one tile of rows [j0, j0 + ROWS) of (b.I + i, h) from a
// (B, I, J, H, d) tensor's 4-D map (d, H, J, B.I).
template <typename TileT>
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int h, int j0, int row) {
#pragma unroll
  for (int bx = 0; bx < TileT::kBoxes; ++bx) {
    hopper::tma_load_4d(static_cast<char*>(dst) + bx * TileT::kBoxBytes, map, bar,
                        bx * TileT::kBoxCols, h, j0, row);
  }
}

// kCompute is the kernel. The others measure what limits it, and their
// outputs are wrong: kLoadsOnly runs the producer's data movement alone (the
// consumers release every stage at once and write nothing), kNoExp replaces
// each exponential by a multiply, kNoBiasLoads starts S at 0 instead of
// loading the bias fragment from shared memory.
enum Mode { kCompute = 0, kLoadsOnly = 1, kNoExp = 2, kNoBiasLoads = 3 };

template <int DP, int R, int P, int kMode>
__global__ void __launch_bounds__(kHopperThreads, 1)
    tri_attn_bf16(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap bias_map, const TriArgs p) {
  using C = Tri<DP, R>;
  using QTile = typename C::QTile;
  using KTile = typename C::KTile;
  constexpr int kBN = C::kBN;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;                       // the R rows' Q tiles
  unsigned char* sStages = smem + R * QTile::kBytes;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], q_full, q_empty;

  // warp-uniform (a shuffle from lane 0), as setmaxnreg.sync.aligned requires
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  const int n_kt = (p.J + kBN - 1) / kBN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA issuer (with the bytes) and the mask warp's lanes
      hopper::mbar_init(&full[s], 33);
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
    const int pw = threadIdx.x >> 5;
    if ((pw == 0 && lane != 0) || pw >= 2) return;  // one lane issues TMA, one warp the mask
    if (pw == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&bias_map);
    }
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
      const WorkTile w(p, tile);
      const int h = w.h, b = w.b;
      const int q0 = w.qt * C::kBM;
      const int i0 = w.grp * R;       // the group's first row i
      const int row0 = b * p.I + i0;  // ... on the maps' B.I axis
      const int bh = b * p.H + h;
      if (pw == 0) {
        // rows past the batch's last are loaded too (the next batch's, or
        // zeros past B.I) and computed, but never stored
        hopper::mbar_wait(&q_empty, (it & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&q_full, R * QTile::kBytes);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          load_rows<QTile>(sQ + r * QTile::kBytes, &q_map, &q_full, h, q0, row0 + r);
        }
      }
      for (int j = 0; j < n_kt; ++j) {
        unsigned char* st = sStages + stage * C::kStageBytes;
        const int n0 = j * kBN;
        if (pw == 0) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&full[stage],
                                        2 * R * KTile::kBytes + C::kBiasBytes);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            load_rows<KTile>(st + r * KTile::kBytes, &k_map, &full[stage], h, n0, row0 + r);
            load_rows<KTile>(st + C::kVOff + r * KTile::kBytes, &v_map, &full[stage], h, n0,
                             row0 + r);
          }
          hopper::tma_load_3d(st + C::kBiasOff, &bias_map, &full[stage], n0, q0, bh);
          hopper::tma_load_3d(st + C::kBiasOff + C::kBiasBox, &bias_map, &full[stage], n0 + 32, q0,
                              bh);
        } else {
          // the R mask rows times log2 e (-inf past J, 0 on rows past I),
          // loaded before the stage is free
          float2 x[R];
          const int col = n0 + 2 * lane;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float* mrow = p.maskb + ((size_t)b * p.I + i0 + r) * p.J;
            const bool row_ok = i0 + r < p.I;
            x[r].x = col < p.J ? (row_ok ? mrow[col] * kLog2e : 0.f) : -INFINITY;
            x[r].y = col + 1 < p.J ? (row_ok ? mrow[col + 1] * kLog2e : 0.f) : -INFINITY;
          }
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          float* mask = reinterpret_cast<float*>(st + C::kMaskOff);
          int* flags = reinterpret_cast<int*>(st + C::kFlagOff);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            *reinterpret_cast<float2*>(mask + r * kBN + 2 * lane) = x[r];
            const int any = __any_sync(0xffffffffu, x[r].x != 0.f || x[r].y != 0.f);
            if (lane == 0) flags[r] = any;
          }
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
    const int cw = wg - 1;  // consumer warpgroup: queries [64 cw, 64 cw + 64) of the tile
    const int warp = (threadIdx.x & 127) >> 5;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r_in = cw * 64 + warp * 16 + g;  // this thread's queries: r_in, r_in + 8
    // byte offsets, in a bias box, of this thread's fragment in row r_in at
    // keys 8 c + 2 t4 (c = 0..3; row r_in + 8 is 1024 bytes on, same swizzle)
    int colb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) colb[c] = bias_offset(r_in, 8 * c + 2 * t4, 0);
    hopper::TakeTurns turns(cw, kMode == kLoadsOnly ? 1 : 2);
    // the descriptors of the Q tile's rows [64 cw, 64 cw + 64), the first K
    // tile and the first V tile at column 0
    const uint64_t q_desc0 = QTile::kmajor(hopper::smem_u32(sQ), cw * 64, 0);
    const uint64_t k_desc0 = KTile::kmajor(hopper::smem_u32(sStages), 0, 0);
    const uint64_t v_desc0 = KTile::mnmajor(hopper::smem_u32(sStages), 0);
    int stage = 0;
    uint32_t phase = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
      const WorkTile w(p, tile);
      const int h = w.h, b = w.b;
      const int q0 = w.qt * C::kBM;
      const int i0 = w.grp * R;
      const bool last_tile = tile + (int)gridDim.x >= p.n_tiles;

      float o[R][DP / 2];
      float m2[R][2];  // running max in log2 units, rows r_in and r_in + 8
      float l[R][2];   // this thread's share of the running sums
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < DP / 2; ++e) o[r][e] = 0.f;
        m2[r][0] = m2[r][1] = -INFINITY;
        l[r][0] = l[r][1] = 0.f;
      }
      // A step takes P rows at once: their S products issue together and
      // their softmaxes interleave. pa: the previous step's P as wgmma A
      // fragments; 0 before the first, so that step's P V adds nothing (every
      // step issues both products, so ptxas sees one fixed wgmma sequence and
      // serializes none of it).
      uint32_t pa[P][kBN / 16][4];
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          pa[q][kk][0] = pa[q][kk][1] = pa[q][kk][2] = pa[q][kk][3] = 0u;
        }
      }
      float s[P][kBN / 2];
      float alpha[P][2], ls[P][2];

      // s = the bias fragment of the key tile at stage stg; the S product
      // accumulates onto it
      auto load_bias = [&](float (&acc)[kBN / 2], int stg) {
        const uint32_t bias = hopper::smem_u32(sStages) + stg * C::kStageBytes + C::kBiasOff;
#pragma unroll
        for (int c = 0; c < kBN / 8; ++c) {
          const uint32_t a0 = bias + (c >> 2) * C::kBiasBox + colb[c & 3];
          float2 b0 = make_float2(0.f, 0.f), b1 = b0;
          if (kMode != kNoBiasLoads) {
            b0 = lds_f2(a0);
            b1 = lds_f2(a0 + 1024);
          }
          acc[4 * c + 0] = b0.x;
          acc[4 * c + 1] = b0.y;
          acc[4 * c + 2] = b1.x;
          acc[4 * c + 3] = b1.y;
        }
      };
      // S = tri + Q_r K_r^T for rows r0 .. r0 + P - 1 at stage stg, both
      // operands K-major in shared memory, one commit group. Descriptors are
      // the tile start's plus the byte offset / 16 (every address is below
      // 2^18, so the 14-bit field never carries).
      auto issue_qk = [&](int stg, int r0) {
        hopper::wgmma_fence();
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const uint64_t k_desc =
              k_desc0 + ((stg * C::kStageBytes + (r0 + q) * KTile::kBytes) >> 4);
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            hopper::Wgmma<kBN>::ss(
                s[q], q_desc0 + (((r0 + q) * QTile::kBytes + kmajor_step<QTile>(kk)) >> 4),
                k_desc + (kmajor_step<KTile>(kk) >> 4), 1);
          }
        }
        hopper::wgmma_commit();
      };
      // O_r += P V_r for the same rows (P from registers, V MN-major)
      auto issue_pv = [&](int stg, int r0) {
        hopper::wgmma_fence();
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const uint64_t v_desc =
              v_desc0 + ((stg * C::kStageBytes + C::kVOff + (r0 + q) * KTile::kBytes) >> 4);
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk) {
            hopper::Wgmma<DP>::template rs<1>(o[r0 + q], pa[q][kk],
                                              v_desc + ((kk * 16 * KTile::kPitch) >> 4), 1);
          }
        }
        hopper::wgmma_commit();
      };
      // mask, running max and exponentials of rows r0 .. r0 + P - 1 (s = q.k
      // + tri), in place; the rows' rescale factors and new partial sums. On
      // a tile with a nonzero mask term, x = s log2 e + mask log2 e (one FMA),
      // the max is taken over x and p = exp2(x - m). Otherwise the max is
      // taken over s and p = exp2(s log2 e - m), one FMA; m in log2 units.
      auto softmax = [&](int stg, int r0) {
        const uint32_t st = hopper::smem_u32(sStages) + stg * C::kStageBytes;
        bool masked = false;
#pragma unroll
        for (int q = 0; q < P; ++q) masked |= lds_i32(st + C::kFlagOff + 4 * (r0 + q)) != 0;
        float sc = kLog2e;
        if (masked) {
          // (s + tri) + mask, in the TPU body's order
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const uint32_t mk = st + C::kMaskOff + (r0 + q) * kBN * 4 + 8 * t4;
#pragma unroll
            for (int c = 0; c < kBN / 8; ++c) {
              const float2 mm = lds_f2(mk + 32 * c);
              s[q][4 * c + 0] = fmaf(s[q][4 * c + 0], kLog2e, mm.x);
              s[q][4 * c + 1] = fmaf(s[q][4 * c + 1], kLog2e, mm.y);
              s[q][4 * c + 2] = fmaf(s[q][4 * c + 2], kLog2e, mm.x);
              s[q][4 * c + 3] = fmaf(s[q][4 * c + 3], kLog2e, mm.y);
            }
          }
          sc = 1.f;
        }
        float mx[P][2];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          mx[q][0] = s[q][0];
          mx[q][1] = s[q][2];
#pragma unroll
          for (int c = 0; c < kBN / 8; ++c) {
            mx[q][0] = fmaxf(mx[q][0], fmaxf(s[q][4 * c + 0], s[q][4 * c + 1]));
            mx[q][1] = fmaxf(mx[q][1], fmaxf(s[q][4 * c + 2], s[q][4 * c + 3]));
          }
        }
        float nm[P][2];
#pragma unroll
        for (int q = 0; q < P; ++q) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float x = fmaxf(mx[q][i], __shfl_xor_sync(0xffffffffu, mx[q][i], 1));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
            // every key tile holds a key < J, whose term is finite, so x is
            // finite here; alpha is 0 on the first tile (m2 = -inf)
            const float m_new = fmaxf(m2[r0 + q][i], x * sc);
            alpha[q][i] = hopper::exp2_approx(m2[r0 + q][i] - m_new);
            m2[r0 + q][i] = m_new;
            nm[q][i] = -m_new;
          }
        }
#pragma unroll
        for (int q = 0; q < P; ++q) {
          float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two chains per row: half the latency
#pragma unroll
          for (int c = 0; c < kBN / 8; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float xx = fmaf(s[q][4 * c + e], sc, nm[q][e >> 1]);
              s[q][4 * c + e] = kMode == kNoExp ? xx * 0.5f : hopper::exp2_approx(xx);
              part[e >> 1][c & 1] += s[q][4 * c + e];
            }
          }
          ls[q][0] = part[0][0] + part[0][1];
          ls[q][1] = part[1][0] + part[1][1];
        }
      };

      hopper::mbar_wait(&q_full, it & 1);
      int prev = stage;  // the stage of the previous key tile (this one at first)
      if constexpr (kMode == kLoadsOnly) {
        for (int j = 0; j < n_kt; ++j) {
          hopper::mbar_wait(&full[stage], phase);
          hopper::warp_arrive(&empty[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        hopper::warp_arrive(&q_empty);
        continue;
      }
      for (int j = 0; j < n_kt; ++j) {
        hopper::mbar_wait(&full[stage], phase);
#pragma unroll
        for (int r0 = 0; r0 < R; r0 += P) {
          const int pr0 = r0 == 0 ? R - P : r0 - P;  // the previous step's rows
#pragma unroll
          for (int q = 0; q < P; ++q) load_bias(s[q], stage);
          turns.wait();
          issue_qk(stage, r0);                    // S of these rows ...
          issue_pv(r0 == 0 ? prev : stage, pr0);  // ... and the previous rows' P V
          turns.pass();
          hopper::wgmma_wait<1>();
#pragma unroll
          for (int q = 0; q < P; ++q) hopper::fence_regs(s[q]);
          softmax(stage, r0);  // while P V runs
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int q = 0; q < P; ++q) {
            hopper::fence_regs(o[pr0 + q]);
            hopper::fence_regs(pa[q]);
          }
          if (r0 == 0 && j > 0) hopper::warp_arrive(&empty[prev]);  // its last P V is done
#pragma unroll
          for (int q = 0; q < P; ++q) {
#pragma unroll
            for (int c = 0; c < DP / 8; ++c) {
              o[r0 + q][4 * c + 0] *= alpha[q][0];
              o[r0 + q][4 * c + 1] *= alpha[q][0];
              o[r0 + q][4 * c + 2] *= alpha[q][1];
              o[r0 + q][4 * c + 3] *= alpha[q][1];
            }
            l[r0 + q][0] = l[r0 + q][0] * alpha[q][0] + ls[q][0];
            l[r0 + q][1] = l[r0 + q][1] * alpha[q][1] + ls[q][1];
#pragma unroll
            for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                pa[q][kk][e] = pack_bf16(s[q][8 * kk + 2 * e], s[q][8 * kk + 2 * e + 1]);
              }
            }
          }
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      turns.wait();
      issue_pv(prev, R - P);
      if (last_tile) {
        turns.pass_unless_last();
      } else {
        turns.pass();
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < P; ++q) hopper::fence_regs(o[R - P + q]);
      hopper::warp_arrive(&empty[prev]);
      hopper::warp_arrive(&q_empty);

      // epilogue: o / l in bf16, for the group's rows that exist
      const size_t rs = (size_t)p.H * p.d;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r >= p.I) break;
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                             ((size_t)b * p.I + i0 + r) * p.J * rs + (size_t)h * p.d;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float li = l[r][i];
          li += __shfl_xor_sync(0xffffffffu, li, 1);
          li += __shfl_xor_sync(0xffffffffu, li, 2);
          const float inv = li == 0.f ? 1.f : 1.f / li;
          const int row = q0 + r_in + 8 * i;
          if (row >= p.J) continue;
#pragma unroll
          for (int c = 0; c < DP / 8; ++c) {
            const int col = c * 8 + t4 * 2;
            if (col < p.d) {
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * rs + col) =
                  __floats2bfloat162_rn(o[r][4 * c + 2 * i] * inv, o[r][4 * c + 2 * i + 1] * inv);
            }
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
  const float* tri = p.tri + (size_t)bh * p.J * p.tri_ld;
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
      sB[r][c] = (q0 + r < p.J && n0 + c < p.J) ? tri[(size_t)(q0 + r) * p.tri_ld + n0 + c] : 0.f;
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

// The 4-D map (d, H, J, B.I) of a contiguous bf16 (B, I, J, H, d) tensor, in
// boxes of TileT: BC columns of one head, ROWS rows j, one row i. Boxes past
// d, J or B.I are zero-filled.
template <typename TileT>
cudaError_t make_rows_map(CUtensorMap* map, const void* base, int bi, int J, int H, int d) {
  hopper::EncodeTiled encode;
  const cudaError_t e = hopper::encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)J, (cuuint64_t)bi};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)H * d * 2,
                                 (cuuint64_t)J * H * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)TileT::kBoxCols, 1,
                             (cuuint32_t)(TileT::kBoxBytes / TileT::kPitch), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            TileT::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 3-D map (J, J, B.H) of the fp32 tri bias, rows ld floats apart, in
// boxes of 32 keys x `rows` queries with the 128-byte swizzle; ld % 4 == 0
// (TMA wants 16-byte row strides). Keys and queries past J are zero-filled.
cudaError_t make_bias_map(CUtensorMap* map, const float* tri, int J, int ld, int bh, int rows) {
  hopper::EncodeTiled encode;
  const cudaError_t e = hopper::encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)J, (cuuint64_t)J, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)J * ld * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(tri),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP, int R, int P, int kMode>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  using C = Tri<DP, R>;
  CUtensorMap q_map, k_map, v_map, bias_map;
  cudaError_t e = make_rows_map<typename C::QTile>(&q_map, p.q, B * p.I, p.J, p.H, p.d);
  if (e == cudaSuccess) e = make_rows_map<typename C::KTile>(&k_map, p.k, B * p.I, p.J, p.H, p.d);
  if (e == cudaSuccess) e = make_rows_map<typename C::KTile>(&v_map, p.v, B * p.I, p.J, p.H, p.d);
  if (e == cudaSuccess) e = make_bias_map(&bias_map, p.tri, p.J, p.tri_ld, B * p.H, C::kBM);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(tri_attn_bf16<DP, R, P, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  }
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  TriArgs a{p.maskb, p.o, p.I, p.J, p.H, p.d, 0, 0, 0};
  a.n_qt = (p.J + C::kBM - 1) / C::kBM;
  a.n_grp = (p.I + R - 1) / R;
  a.n_tiles = B * a.n_grp * p.H * a.n_qt;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  tri_attn_bf16<DP, R, P, kMode>
      <<<grid, kHopperThreads, C::kSmem, stream>>>(q_map, k_map, v_map, bias_map, a);
  return cudaGetLastError();
}

// Bytes the bf16 kernel stages into shared memory for one call: per CTA its
// R Q tiles, then per key tile the R rows' K and V tiles, the bias tile and
// the R mask rows.
template <int DP, int R>
long long staged_bytes(int B, int I, int J, int H, int* rows) {
  using C = Tri<DP, R>;
  const long long n_kt = (J + C::kBN - 1) / C::kBN;
  const long long ctas = (long long)B * ((I + R - 1) / R) * H * ((J + C::kBM - 1) / C::kBM);
  *rows = R;
  return ctas * (R * C::QTile::kBytes +
                 n_kt * (2 * R * C::KTile::kBytes + C::kBiasBytes + R * C::kBN * 4));
}

template <int DP>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  dim3 grid(p.I, (p.J + kFBM - 1) / kFBM, bh);
  tri_attn_f32<DP><<<grid, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

bool valid_shape(int B, int I, int J, int H, int d, int tri_ld) {
  return B > 0 && I > 0 && J > 0 && H > 0 && d > 0 && d % 8 == 0 && d <= 128 &&
         B * H <= 65535 && (J + kFBM - 1) / kFBM <= 65535 && tri_ld >= J;
}

}  // namespace

extern "C" {

// q/k/v/o (B, I, J, H, d) contiguous, one dtype (is_bf16: bf16, else fp32),
// 16-byte aligned; tri (B, H, J, tri_ld) fp32, the (B, H, J, J) bias with
// its rows padded to tri_ld floats (bf16: tri_ld % 4 == 0, the bias goes by
// TMA); maskb (B, I, J) fp32. d a multiple of 8, at most 128. Launches on
// `stream`; returns the first CUDA error.
int esm_triangle_attention_fwd(const void* q, const void* k, const void* v, const void* tri,
                               const void* maskb, void* o, int B, int I, int J, int H, int d,
                               int tri_ld, int is_bf16, void* stream) {
  if (!valid_shape(B, I, J, H, d, tri_ld) || (is_bf16 != 0 && tri_ld % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{q, k, v, static_cast<const float*>(tri), static_cast<const float*>(maskb), o,
                 I, J, H, d, tri_ld};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16 != 0) {
    // the tile's width: d padded to a power of two >= 16 (TMA zero-fills the
    // rest); R rows a CTA, P of them a step, sized so the registers hold the
    // R rows' outputs and the P rows' scores and probabilities
    if (d <= 16) e = launch_bf16<16, 4, 2, kCompute>(p, B, st);
    else if (d <= 32) e = launch_bf16<32, 2, 2, kCompute>(p, B, st);
    else if (d <= 64) e = launch_bf16<64, 2, 1, kCompute>(p, B, st);
    else e = launch_bf16<128, 1, 1, kCompute>(p, B, st);
  } else {
    if (d <= 16) e = launch_f32<16>(p, B * H, st);
    else if (d <= 32) e = launch_f32<32>(p, B * H, st);
    else if (d <= 64) e = launch_f32<64>(p, B * H, st);
    else e = launch_f32<128>(p, B * H, st);
  }
  return (int)e;
}

// The bf16 kernel at 16 < d <= 32 in the shapes and modes that measure it
// against the one esm_triangle_attention_fwd launches (R = 2 rows a CTA, both
// in one step): `variant` 0 one row a CTA (R = 1, the bias not shared), 1 two
// rows a CTA taken one per step (P = 1), 2 the kernel's loads alone, 3 the
// kernel with its exponentials replaced by multiplies, 4 the kernel without
// its bias loads from shared memory. Variants 2-4 write wrong outputs. Same
// arguments as esm_triangle_attention_fwd otherwise, bf16 only.
int esm_triangle_attention_variant(const void* q, const void* k, const void* v, const void* tri,
                                   const void* maskb, void* o, int B, int I, int J, int H, int d,
                                   int tri_ld, int variant, void* stream) {
  if (!valid_shape(B, I, J, H, d, tri_ld) || tri_ld % 4 != 0 || d <= 16 || d > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{q, k, v, static_cast<const float*>(tri), static_cast<const float*>(maskb), o,
                 I, J, H, d, tri_ld};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)launch_bf16<32, 1, 1, kCompute>(p, B, st);
    case 1: return (int)launch_bf16<32, 2, 1, kCompute>(p, B, st);
    case 2: return (int)launch_bf16<32, 2, 2, kLoadsOnly>(p, B, st);
    case 3: return (int)launch_bf16<32, 2, 2, kNoExp>(p, B, st);
    case 4: return (int)launch_bf16<32, 2, 2, kNoBiasLoads>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the bf16 kernel stages into shared memory for a call at this shape,
// and in *rows the rows i a CTA takes; -1 for a shape the kernel refuses.
long long esm_triangle_attention_staged_bytes(int B, int I, int J, int H, int d, int* rows) {
  if (!valid_shape(B, I, J, H, d, J)) return -1;
  if (d <= 16) return staged_bytes<16, 4>(B, I, J, H, rows);
  if (d <= 32) return staged_bytes<32, 2>(B, I, J, H, rows);
  if (d <= 64) return staged_bytes<64, 2>(B, I, J, H, rows);
  return staged_bytes<128, 1>(B, I, J, H, rows);
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
