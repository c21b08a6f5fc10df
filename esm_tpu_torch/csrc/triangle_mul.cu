// The two row-wise stages around the triangular multiplicative update's
// O(L^3.C) product, for Hopper (sm_90a).
//
// Replaces the TPU kernels of esm_tpu/kernels/triangle_mul.py, both launched
// through _rows_call (:109, pallas_call :126) over the pair tensor viewed as
// rows (B.I.J, C):
//  * stage 1, K7 (tri_mul_stage1 :147; _stage1_kernel :73 /
//    _stage1_kernel_nomask :77, body _stage1_impl :45):
//      zn = LN_in(z) in fp32, rounded to z's dtype;
//      p  = zn . W4 + b4, W4 = [a_g | a_p | b_g | b_p] (C, 4C), b4 in z's dtype;
//      a  = m . sigmoid(p_ag) . p_ap,  b = m . sigmoid(p_bg) . p_bp  (fp32),
//    a and b written in z's dtype; m is an optional per-row int8 mask (no mask
//    stream is read when it is absent);
//  * the epilogue, K8 (tri_mul_epilogue :186; _epilogue_kernel :81):
//      out = z + (sigmoid(LN_in(z) . Wg + bg) . (LN_out(x) . Wz + bz)).astype(z)
//    with fp32 LNs (two passes: mean, then the centred variance; eps 1e-5),
//    the gated product rounded to z's dtype before the residual add in z's
//    dtype (:106).
// The einsum between the stages stays a cuBLAS product outside, as it
// stayed outside Pallas in JAX (esm_tpu/ops/triangle.py:86-89).
//
// What bounds them on an H100: at C = 128 each row does 2.C.4C = 131k
// (stage 1) or 2.2.C.C = 65.5k (epilogue) operations per 3.C.2 bytes moved
// in bf16: 170 and 85 operations per byte, below the card's ~295 in bf16, so
// device memory bounds both (~0.23 ms each for 10^6 rows, L = 1000). The
// design therefore moves each row once, at full bandwidth, with the
// LayerNorms, products and gating hidden under the copies.
//
// The bf16 design (tri_mul_stage1_bf16, tri_mul_epilogue_bf16), on
// hopper_common.cuh:
//  * a persistent grid, one CTA per SM, walks 64-row tiles; a CTA is a
//    producer warp and consumer warpgroups, three for K7 and two for K8
//    (ptxas allocates registers for whole warpgroups: 128 a thread for K7's
//    416 threads, 168 for K8's 288);
//  * the producer's lane 0 loads the weights once (TMA, K-major: torch's
//    (out, in) Linear layout is the B operand of d = A.B^T as it is), then
//    TMA-loads each row tile of z (and of x for K8) through the 2-D view of
//    the contiguous (rows, C) array into a ring of stages (at C = 128, one
//    for each K7 consumer and two for each K8 consumer), swizzled for wgmma;
//    TMA zero-fills rows past the end, so nothing is padded;
//  * consumer warpgroup w of n takes the CTA's tiles w, w + n, ... from its
//    own stages: each thread reads its two rows straight into the m64k16
//    A-fragment registers (K7 releases the stage there; K8 keeps z in it for
//    the residual); the LayerNorm runs on those registers (a row's C values
//    lie on the 4 lanes of a quad: a local sum and two shuffles, in fp32)
//    and packs the result back to bf16 pairs in place;
//  * the products run on wgmma with A from registers, 32 output columns a
//    chunk, fp32 accumulators; a warpgroup's wgmma issue is paced by the
//    tensor core, so the other warpgroups' gating runs under its products.
//    The gating, mask and residual act on the accumulators, each sigmoid
//    one FMA (the gate's bias is kept as -b log2 e), an ex2 and a
//    reciprocal;
//  * each warp stages its 16 rows of a TMA box (64 columns, or C) in bf16 in
//    shared memory, swizzled as the box, and writes it with one TMA store
//    once the box's chunks are done; it waits for the store to have read the
//    buffer before writing the next. TMA clips the rows past the end.
// PERF.md (section 6) has what limits them, measured, and chip_smoke.py's
// [k7-variants] and [k8-variants] lines time the kernels' measurement modes
// (esm_tri_mul_variant). No atomics: every output element is written once,
// so repeat calls are bitwise equal. The fp32 path (parity runs) computes
// the same in fp32 FMA, without TF32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/triangle_mul.py).

#include <limits.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

constexpr int kTWarps = 8;
constexpr int kTThreads = kTWarps * 32;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// y = LN(row) in fp32 for one row of C channels held by one warp: lane owns
// channels lane, lane + 32, ... (coalesced loads).
template <int C>
__device__ __forceinline__ void ln_row(const float* row, const float* s, const float* b,
                                       int lane, float (&y)[C / 32]) {
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < C / 32; ++e) {
    y[e] = row[lane + 32 * e];
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

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernels fed by TMA (design in the header).
// ---------------------------------------------------------------------------

// Consumer warpgroups a CTA: K7's three fit ptxas's 128-register cap of a
// 416-thread CTA (its accumulators take 32 registers), K8's two need the 168
// of a 288-thread one (the two normalized operands stay in registers).
constexpr int kStage1WG = 3;
constexpr int kEpilogueWG = 2;
constexpr int kRows = 64;         // rows a consumer warpgroup takes at once
constexpr int kSmemMax = 232448;  // shared memory of one CTA

// Threads of a CTA with kWG consumer warpgroups and one producer warp.
template <int kWG>
constexpr int cta_threads() {
  return kWG * 128 + 32;
}

// The tiles and the shared-memory layout of a kernel at C channels with
// kWeights (C x C) weight blocks, kInputs row tiles a stage and kWG
// consumer warpgroups: the weights, the ring of stages, the consumer warps'
// output staging, six fp32 vectors of C (linear biases, LN scales and
// biases).
template <int C, int kWeights, int kInputs, int kWG>
struct Rows {
  using RowTile = hopper::Tile<C, kRows>;  // a tile of z or x, as loaded
  using WTile = hopper::Tile<C, C>;        // one weight block (C out x C in), K-major B
  // one warp's 16 output rows of one TMA box's columns (all C, or 64), as staged
  using OutBox = hopper::Tile<RowTile::kBoxCols, 16>;
  static constexpr int kStageOff = kWeights * WTile::kBytes;
  static constexpr int kStageBytes = kInputs * RowTile::kBytes;
  static constexpr int kOutBytes = kWG * 4 * OutBox::kBytes;
  static constexpr int kVecBytes = 6 * C * 4;
  // less the alignment slack and the static barriers; a multiple of kWG, so
  // that consumer warpgroup w always takes the stages s with s % kWG == w (a
  // stage's uses are then one warpgroup's, in order, and a wait on a phase's
  // parity cannot pass on the phase before it)
  static constexpr int kFit =
      (kSmemMax - 1024 - 256 - kStageOff - kOutBytes - kVecBytes) / kStageBytes;
  static constexpr int kStages = (kFit < 2 * kWG ? kFit : 2 * kWG) / kWG * kWG;
  static_assert(kStages >= kWG, "a stage for each consumer warpgroup at least");
  static constexpr int kOutOff = kStageOff + kStages * kStageBytes;
  static constexpr int kVecOff = kOutOff + kOutBytes;
  static constexpr int kSmem = 1024 + kVecOff + kVecBytes;
  static_assert(kSmem + 256 <= kSmemMax, "shared memory of one CTA");
};

// Shared memory is read and written with plain loads and stores through
// pointers derived from the dynamic buffer, so the compiler knows their space
// (LDS/STS) and may schedule them; the asm barriers around them (mbarrier
// waits, wgmma fences, proxy fences) carry "memory" clobbers.
__device__ __forceinline__ uint32_t ld32(const unsigned char* p, int off) {
  return *reinterpret_cast<const uint32_t*>(p + off);
}

__device__ __forceinline__ float2 ld_f2(const float* p, int i) {
  return *reinterpret_cast<const float2*>(p + i);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// x, opaque to the compiler from here on: what is computed from it is
// computed after this point, not hoisted ahead into registers that stay
// live (the per-product descriptors, the swizzled offsets). ptxas keeps the
// kernels under its 168-register cap only with these.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// x, made to depend on y: what is computed from x waits for y.
__device__ __forceinline__ uint32_t after(uint32_t x, uint32_t y) {
  asm volatile("" : "+r"(x) : "r"(y));
  return x;
}

__device__ __forceinline__ uint64_t opaque_desc(uint64_t desc) {
  return (desc & 0xffffffff00000000ull) | opaque(static_cast<uint32_t>(desc));
}

// The A fragments (m64k16, one per 16 columns) of rows row0 and row0 + 8 of
// a row tile: a[kk][e] holds row row0 + 8 (e & 1), columns 16 kk + 8 (e >> 1)
// + 2 (lane % 4) and the next.
template <typename TileT, int C>
__device__ __forceinline__ void load_frags(uint32_t (&a)[C / 16][4], const unsigned char* tile,
                                           int row0) {
  row0 = (int)opaque((uint32_t)row0);  // the offsets are formed here, not held in registers
  const int c0 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[kk][e] = ld32(tile, TileT::offset(row0 + (e & 1) * 8, kk * 16 + (e >> 1) * 8 + c0));
    }
  }
}

// LayerNorm, in place, of the two rows this thread holds in A fragments: the
// quad's four lanes hold a row's C values, so the fp32 mean and then the
// centred variance are a local sum and two shuffles each; the result, times
// the scale plus the bias (fp32 vectors of C in shared memory), is rounded
// to bf16 pairs in the same registers.
template <int C>
__device__ __forceinline__ void layer_norm_frags(uint32_t (&a)[C / 16][4], const float* scale,
                                                 const float* bias) {
  const int c0 = (threadIdx.x & 3) * 2;
  float part[4] = {0.f, 0.f, 0.f, 0.f};  // by e: rows e & 1, two chains a row
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack_bf16(a[kk][e]);
      part[e] += v.x + v.y;
    }
  }
  float mean[2], rstd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = part[i] + part[i + 2];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    mean[i] = s * (1.f / C);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) part[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack_bf16(opaque(a[kk][e]));  // unpacked again, not held
      const float dx = v.x - mean[e & 1], dy = v.y - mean[e & 1];
      part[e] = fmaf(dx, dx, fmaf(dy, dy, part[e]));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = part[i] + part[i + 2];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    rstd[i] = rsqrtf(s * (1.f / C) + kEps);
  }
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    // one 16-column step's scale and bias at a time: loads hoisted over the
    // whole row would hold 2 C / 2 registers
    asm volatile("" ::: "memory");
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kk * 16 + (e >> 1) * 8 + c0;
      const float2 sc = ld_f2(scale, col), bi = ld_f2(bias, col);
      const float2 v = unpack_bf16(opaque(a[kk][e]));
      const float m = mean[e & 1], r = rstd[e & 1];
      a[kk][e] = pack_bf16((v.x - m) * r * sc.x + bi.x, (v.y - m) * r * sc.y + bi.y);
    }
  }
}

// Byte offset, from the first weight block's start, of the K-major B operand
// of block `blk`, output rows [r0, r0 + N), reduction columns [16 kk, 16 kk + 16).
template <typename WTile>
__host__ __device__ constexpr int weight_step(int blk, int r0, int kk) {
  return blk * WTile::kBytes + (16 * kk / WTile::kBoxCols) * WTile::kBoxBytes +
         r0 * WTile::kPitch + (16 * kk % WTile::kBoxCols) * 2;
}

// The dynamic buffer from its first 1024-byte boundary on (the swizzled
// tiles' alignment), by pointer arithmetic, so accesses through it stay in
// the shared space.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

// kCompute is the kernel. The others measure what limits it, and their
// outputs are wrong: kLoadsOnly runs the data movement in alone (the
// consumers read their fragments and release the stage, nothing more),
// kNoStores skips the stores, kNoSigmoid replaces each sigmoid by its
// argument.
enum Mode { kCompute = 0, kLoadsOnly = 1, kNoStores = 2, kNoSigmoid = 3 };

// sigmoid(x) from t = -x log2 e (a gate's bias is stored as -b log2 e, so t
// is one FMA from the accumulator): 1 / (1 + 2^t) with MUFU ex2 and rcp,
// ~2^-21 relative error; 0 and 1 at the extremes.
template <int kMode>
__device__ __forceinline__ float sigmoid_exp2(float t) {
  if (kMode == kNoSigmoid) return t;
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(1.f + hopper::exp2_approx(t)));
  return y;
}

// Keeps the fragments of a kLoadsOnly run alive: a store that never happens.
template <int N>
__device__ __forceinline__ void consume(const uint32_t (&a)[N][4], unsigned char* p) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) x ^= a[i][0] ^ a[i][1] ^ a[i][2] ^ a[i][3];
  if (x == 0x9e3779b9u) *reinterpret_cast<uint32_t*>(p) = x;
}

// One warp's TMA store of its staged box (16 rows) to rows [row0, row0 + 16),
// columns [col0, col0 + the box's) of the tensor behind `map`, once every
// lane's writes to the staging buffer are visible to the async proxy; TMA
// clips the rows past the tensor's end.
__device__ __forceinline__ void store_box(const CUtensorMap* map, const unsigned char* staged,
                                          int col0, int row0, int lane) {
  hopper::fence_proxy_async();
  __syncwarp();
  if (lane == 0) {
    hopper::tma_store_3d(map, staged, col0, row0, 0);
    hopper::bulk_commit();
  }
}

// Waits until the warp's previous TMA store has read its staging buffer.
__device__ __forceinline__ void staging_free(int lane) {
  if (lane == 0) hopper::bulk_wait_read<0>();
  __syncwarp();
}

// ---------------------------------------------------------------------------
// K7, stage 1. Shared memory: W4 as four (C x C) blocks a_g, a_p, b_g, b_p;
// the ring of z tiles; the staging; b4 (4C, fp32: the gates' halves as
// -b log2 e), LN scale, LN bias.
// ---------------------------------------------------------------------------

template <int C, int kMasked, int kMode>
__global__ void __launch_bounds__(cta_threads<kStage1WG>(), 1)
    tri_mul_stage1_bf16(const __grid_constant__ CUtensorMap z_map,
                        const __grid_constant__ CUtensorMap w_map,
                        const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map, const Stage1Params p) {
  constexpr int kWG = kStage1WG;
  using L = Rows<C, 4, 1, kWG>;
  using RowTile = typename L::RowTile;
  using OutBox = typename L::OutBox;
  using WTile = typename L::WTile;
  constexpr int kN = 32;                          // output columns a product takes
  constexpr int kStages = L::kStages;
  constexpr int kChunks = C / kN;                 // chunks of a (then of b)
  constexpr int kPerBox = OutBox::kBoxCols / kN;  // chunks a staged box holds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], w_full;

  float* vec = reinterpret_cast<float*>(smem + L::kVecOff);
  for (int c = threadIdx.x; c < 4 * C; c += blockDim.x) {
    const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(p.b4)[c]);
    vec[c] = (c / C) % 2 == 0 ? -b * kLog2e : b;  // a_g, b_g: the exponent's term
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    vec[4 * C + c] = p.ln_s[c];
    vec[5 * C + c] = p.ln_b[c];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // the consumer warpgroup's warps
    }
    hopper::mbar_init(&w_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_tiles = (int)((p.rows + kRows - 1) / kRows);
  const int warp_id = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id == 4 * kWG) {
    // ---------------- producer: one lane issues every TMA load ----------------
    if (lane != 0) return;
    hopper::prefetch_map(&z_map);
    hopper::prefetch_map(&w_map);
    hopper::mbar_arrive_expect_tx(&w_full, 4 * WTile::kBytes);
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) {
      WTile::load(smem + blk * WTile::kBytes, &w_map, &w_full, blk * C, 0);
    }
    int k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
      const int s = k % kStages;
      hopper::mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[s], L::kStageBytes);
      RowTile::load(smem + L::kStageOff + s * L::kStageBytes, &z_map, &full[s], tile * kRows, 0);
    }
    return;
  }

  // ---------------- consumers ----------------
  const int cw = warp_id >> 2;
  const int warp = warp_id & 3;
  const int t4 = lane & 3;
  const int r_in = warp * 16 + (lane >> 2);  // this thread's rows in a tile: r_in, r_in + 8
  unsigned char* staged = smem + L::kOutOff + warp_id * OutBox::kBytes;
  const uint64_t w_desc0 = WTile::kmajor(hopper::smem_u32(smem), 0, 0);
  hopper::mbar_wait(&w_full, 0);

  int k = cw;
  for (int tile = blockIdx.x + cw * gridDim.x; tile < n_tiles;
       tile += kWG * gridDim.x, k += kWG) {
    const int s = k % kStages;
    const long long row0 = (long long)tile * kRows + warp * 16;  // the warp's first row
    float m[2] = {1.f, 1.f};
    if (kMasked) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long row = row0 + (lane >> 2) + 8 * i;
        m[i] = row < p.rows ? (float)p.mask[row] : 0.f;
      }
    }
    uint32_t zn[C / 16][4];
    hopper::mbar_wait(&full[s], (k / kStages) & 1);
    load_frags<RowTile, C>(zn, smem + L::kStageOff + s * L::kStageBytes, r_in);
    hopper::warp_arrive(&empty[s]);  // the rows are in registers: the stage is free
    if (kMode == kLoadsOnly) {
      consume(zn, staged);
      continue;
    }
    layer_norm_frags<C>(zn, vec + 4 * C, vec + 5 * C);

    // chunk j: a's columns [j kN, j kN + kN), then b's
#pragma unroll
    for (int j = 0; j < 2 * kChunks; ++j) {
      const int half = j / kChunks;  // 0: a, 1: b
      const int c0 = (j % kChunks) * kN;
      const int cb = c0 % OutBox::kBoxCols;  // the chunk's first column in its box
      float gate[kN / 2], proj[kN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int g = 0; g < 2; ++g) {  // the gate (W4's block 2 half), the projection (the next)
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          hopper::Wgmma<kN>::template rs<0>(
              g ? proj : gate, zn[kk],
              opaque_desc(w_desc0) + (weight_step<WTile>(2 * half + g, c0, kk) >> 4), kk > 0);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(gate);
      hopper::fence_regs(proj);
      if (cb == 0) staging_free(lane);  // the previous box has left the buffer
      unsigned char* out = staged;
      const int rw = (int)opaque((uint32_t)(lane >> 2));  // the thread's row in the warp's 16
#pragma unroll
      for (int c = 0; c < kN / 8; ++c) {
        const int col = 8 * c + 2 * t4;  // in the chunk
        const float2 nbg = ld_f2(vec, 2 * half * C + c0 + col);
        const float2 bp = ld_f2(vec, (2 * half + 1) * C + c0 + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a0 = 4 * c + 2 * i;  // the accumulator pair of row r + 8 i
          float v0 = sigmoid_exp2<kMode>(fmaf(gate[a0], -kLog2e, nbg.x)) * (proj[a0] + bp.x);
          float v1 =
              sigmoid_exp2<kMode>(fmaf(gate[a0 + 1], -kLog2e, nbg.y)) * (proj[a0 + 1] + bp.y);
          if (kMasked) {
            v0 = m[i] * v0;
            v1 = m[i] * v1;
          }
          *reinterpret_cast<uint32_t*>(out + OutBox::offset(rw + 8 * i, cb + col)) =
              pack_bf16(v0, v1);
        }
      }
      if (kMode != kNoStores && (j + 1) % kPerBox == 0) {
        store_box(half ? &b_map : &a_map, staged, c0 + kN - OutBox::kBoxCols, (int)row0, lane);
      }
    }
  }
  if (lane == 0) hopper::bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// K8, the epilogue. Shared memory: Wg, Wz; the ring of (z, x) tile pairs;
// the staging; bg (as -bg log2 e), bz, LN_in scale and bias, LN_out scale
// and bias (fp32).
// ---------------------------------------------------------------------------

template <int C, int kMode>
__global__ void __launch_bounds__(cta_threads<kEpilogueWG>(), 1)
    tri_mul_epilogue_bf16(const __grid_constant__ CUtensorMap z_map,
                          const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap wg_map,
                          const __grid_constant__ CUtensorMap wz_map,
                          const __grid_constant__ CUtensorMap o_map, const EpilogueParams p) {
  constexpr int kWG = kEpilogueWG;
  using L = Rows<C, 2, 2, kWG>;
  using RowTile = typename L::RowTile;
  using OutBox = typename L::OutBox;
  using WTile = typename L::WTile;
  constexpr int kN = 32;  // output columns a product takes
  constexpr int kPerBox = OutBox::kBoxCols / kN;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], w_full;

  float* vec = reinterpret_cast<float*>(smem + L::kVecOff);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    vec[c] = -__bfloat162float(static_cast<const __nv_bfloat16*>(p.bg)[c]) * kLog2e;
    vec[C + c] = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bz)[c]);
    vec[2 * C + c] = p.lni_s[c];
    vec[3 * C + c] = p.lni_b[c];
    vec[4 * C + c] = p.lno_s[c];
    vec[5 * C + c] = p.lno_b[c];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_init(&w_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_tiles = (int)((p.rows + kRows - 1) / kRows);
  const int warp_id = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id == 4 * kWG) {
    // ---------------- producer ----------------
    if (lane != 0) return;
    hopper::prefetch_map(&z_map);
    hopper::prefetch_map(&x_map);
    hopper::mbar_arrive_expect_tx(&w_full, 2 * WTile::kBytes);
    WTile::load(smem, &wg_map, &w_full, 0, 0);
    WTile::load(smem + WTile::kBytes, &wz_map, &w_full, 0, 0);
    int k = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
      const int s = k % kStages;
      unsigned char* st = smem + L::kStageOff + s * L::kStageBytes;
      hopper::mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(&full[s], L::kStageBytes);
      RowTile::load(st, &z_map, &full[s], tile * kRows, 0);
      RowTile::load(st + RowTile::kBytes, &x_map, &full[s], tile * kRows, 0);
    }
    return;
  }

  // ---------------- consumers ----------------
  const int cw = warp_id >> 2;
  const int warp = warp_id & 3;
  const int t4 = lane & 3;
  const int r_in = warp * 16 + (lane >> 2);
  unsigned char* staged = smem + L::kOutOff + warp_id * OutBox::kBytes;
  const uint64_t w_desc0 = WTile::kmajor(hopper::smem_u32(smem), 0, 0);
  hopper::mbar_wait(&w_full, 0);

  int k = cw;
  for (int tile = blockIdx.x + cw * gridDim.x; tile < n_tiles;
       tile += kWG * gridDim.x, k += kWG) {
    const int s = k % kStages;
    const long long row0 = (long long)tile * kRows + warp * 16;
    const unsigned char* st = smem + L::kStageOff + s * L::kStageBytes;
    // the normalized rows; z stays in the stage for the residual, and the
    // stage is released after the last chunk
    uint32_t zn[C / 16][4], xn[C / 16][4];
    hopper::mbar_wait(&full[s], (k / kStages) & 1);
    load_frags<RowTile, C>(zn, st, r_in);
    if (kMode == kLoadsOnly) {
      load_frags<RowTile, C>(xn, st + RowTile::kBytes, r_in);
      hopper::warp_arrive(&empty[s]);
      consume(zn, staged);
      consume(xn, staged);
      continue;
    }
    layer_norm_frags<C>(zn, vec + 2 * C, vec + 3 * C);
    // x is read once z's LayerNorm is done, so the two LayerNorms'
    // temporaries are never live together
    load_frags<RowTile, C>(xn, st + RowTile::kBytes + after(0u, zn[C / 16 - 1][3]), r_in);
    layer_norm_frags<C>(xn, vec + 4 * C, vec + 5 * C);

#pragma unroll
    for (int j = 0; j < C / kN; ++j) {
      const int c0 = j * kN;
      const int cb = c0 % OutBox::kBoxCols;  // the chunk's first column in its box
      float g[kN / 2], u[kN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // g from zn and Wg, u from xn and Wz
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          hopper::Wgmma<kN>::template rs<0>(
              h ? u : g, h ? xn[kk] : zn[kk],
              opaque_desc(w_desc0) + (weight_step<WTile>(h, c0, kk) >> 4), kk > 0);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(g);
      hopper::fence_regs(u);
      if (cb == 0) staging_free(lane);
      unsigned char* out = staged;
      const int rw = (int)opaque((uint32_t)(lane >> 2));  // the thread's row in the warp's 16
#pragma unroll
      for (int c = 0; c < kN / 8; ++c) {
        const int col = c0 + 8 * c + 2 * t4;
        const float2 nbg = ld_f2(vec, col);
        const float2 bz = ld_f2(vec, C + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 zv = unpack_bf16(ld32(st, RowTile::offset(warp * 16 + rw + 8 * i, col)));
          // (g . u).astype(z.dtype), then z + that in z's dtype
          const float v0 = round_bf16(sigmoid_exp2<kMode>(fmaf(g[4 * c + 2 * i], -kLog2e, nbg.x)) *
                                      (u[4 * c + 2 * i] + bz.x));
          const float v1 =
              round_bf16(sigmoid_exp2<kMode>(fmaf(g[4 * c + 2 * i + 1], -kLog2e, nbg.y)) *
                         (u[4 * c + 2 * i + 1] + bz.y));
          *reinterpret_cast<uint32_t*>(
              out + OutBox::offset(rw + 8 * i, cb + 8 * c + 2 * t4)) =
              pack_bf16(zv.x + v0, zv.y + v1);
        }
      }
      if (j == C / kN - 1) hopper::warp_arrive(&empty[s]);  // z's residual is read
      if (kMode != kNoStores && (j + 1) % kPerBox == 0) {
        store_box(&o_map, staged, c0 + kN - OutBox::kBoxCols, (int)row0, lane);
      }
    }
  }
  if (lane == 0) hopper::bulk_wait<0>();
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

// As many fp32 blocks as fit on the card at once (at most one per row
// tile), each walking row tiles with a stride of the grid.
template <typename P>
cudaError_t launch_rows(void (*kernel)(P), long long tiles, cudaStream_t stream, const P& p) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTThreads, 0);
  if (e != cudaSuccess) return e;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(int)(tiles < fit ? tiles : fit), kTThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The bf16 kernels' persistent grid: one CTA per SM, at most one per row tile.
cudaError_t hopper_grid(long long rows, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (rows + kRows - 1) / kRows;
  *grid = (int)(tiles < sms ? tiles : sms);
  return e;
}

template <int C, int kMode>
cudaError_t stage1_bf16(const Stage1Params& p, cudaStream_t st) {
  using L = Rows<C, 4, 1, kStage1WG>;
  const int rows = (int)p.rows;
  CUtensorMap z_map, w_map, a_map, b_map;
  cudaError_t e = hopper::make_map<typename L::RowTile>(&z_map, p.z, C, rows, 1);
  if (e == cudaSuccess) e = hopper::make_map<typename L::WTile>(&w_map, p.w4, C, 4 * C, 1);
  if (e == cudaSuccess) e = hopper::make_map<typename L::OutBox>(&a_map, p.a, C, rows, 1);
  if (e == cudaSuccess) e = hopper::make_map<typename L::OutBox>(&b_map, p.b, C, rows, 1);
  auto kernel = p.mask != nullptr ? tri_mul_stage1_bf16<C, 1, kMode>
                                  : tri_mul_stage1_bf16<C, 0, kMode>;
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  }
  int grid = 0;
  if (e == cudaSuccess) e = hopper_grid(p.rows, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, cta_threads<kStage1WG>(), L::kSmem, st>>>(z_map, w_map, a_map, b_map, p);
  return cudaGetLastError();
}

template <int C, int kMode>
cudaError_t epilogue_bf16(const EpilogueParams& p, cudaStream_t st) {
  using L = Rows<C, 2, 2, kEpilogueWG>;
  const int rows = (int)p.rows;
  CUtensorMap z_map, x_map, wg_map, wz_map, o_map;
  cudaError_t e = hopper::make_map<typename L::RowTile>(&z_map, p.z, C, rows, 1);
  if (e == cudaSuccess) e = hopper::make_map<typename L::RowTile>(&x_map, p.x, C, rows, 1);
  if (e == cudaSuccess) e = hopper::make_map<typename L::WTile>(&wg_map, p.wg, C, C, 1);
  if (e == cudaSuccess) e = hopper::make_map<typename L::WTile>(&wz_map, p.wz, C, C, 1);
  if (e == cudaSuccess) e = hopper::make_map<typename L::OutBox>(&o_map, p.o, C, rows, 1);
  auto kernel = tri_mul_epilogue_bf16<C, kMode>;
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  }
  int grid = 0;
  if (e == cudaSuccess) e = hopper_grid(p.rows, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, cta_threads<kEpilogueWG>(), L::kSmem, st>>>(z_map, x_map, wg_map, wz_map, o_map,
                                                            p);
  return cudaGetLastError();
}

template <int C>
cudaError_t stage1(const Stage1Params& p, bool bf16, cudaStream_t st) {
  if (bf16) return stage1_bf16<C, kCompute>(p, st);
  const long long tiles = (p.rows + kFRows - 1) / kFRows;
  return p.mask != nullptr ? launch_rows(stage1_f32<C, true>, tiles, st, p)
                           : launch_rows(stage1_f32<C, false>, tiles, st, p);
}

template <int C>
cudaError_t epilogue(const EpilogueParams& p, bool bf16, cudaStream_t st) {
  if (bf16) return epilogue_bf16<C, kCompute>(p, st);
  const long long tiles = (p.rows + kFRows - 1) / kFRows;
  return launch_rows(epilogue_f32<C>, tiles, st, p);
}

// The bf16 kernels address rows by TMA's 32-bit coordinates.
bool valid_rows(long long rows, int is_bf16) {
  return rows > 0 && (is_bf16 == 0 || rows <= (long long)INT_MAX - kRows);
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
  if (!valid_rows(rows, is_bf16)) return (int)cudaErrorInvalidValue;
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
  if (!valid_rows(rows, is_bf16)) return (int)cudaErrorInvalidValue;
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

// K7 (`kernel` 0) or K8 (1), bf16 at C = 128, in a measurement mode of
// Mode (`variant` 1-3, all writing wrong outputs). Arguments as
// esm_tri_mul_stage1 / esm_tri_mul_epilogue: K7 reads its pointers from
// ptrs[0..7] (z, mask, w4, b4, ln_s, ln_b, a, b), K8 from ptrs[0..10].
int esm_tri_mul_variant(int kernel, int variant, void* const* ptrs, long long rows,
                        void* stream) {
  if (!valid_rows(rows, 1) || kernel < 0 || kernel > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    const Stage1Params p{ptrs[0], static_cast<const int8_t*>(ptrs[1]), ptrs[2], ptrs[3],
                         static_cast<const float*>(ptrs[4]), static_cast<const float*>(ptrs[5]),
                         ptrs[6], ptrs[7], rows};
    switch (variant) {
      case kLoadsOnly: return (int)stage1_bf16<128, kLoadsOnly>(p, st);
      case kNoStores: return (int)stage1_bf16<128, kNoStores>(p, st);
      case kNoSigmoid: return (int)stage1_bf16<128, kNoSigmoid>(p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const EpilogueParams p{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5],
                         static_cast<const float*>(ptrs[6]), static_cast<const float*>(ptrs[7]),
                         static_cast<const float*>(ptrs[8]), static_cast<const float*>(ptrs[9]),
                         ptrs[10], rows};
  switch (variant) {
    case kLoadsOnly: return (int)epilogue_bf16<128, kLoadsOnly>(p, st);
    case kNoStores: return (int)epilogue_bf16<128, kNoStores>(p, st);
    case kNoSigmoid: return (int)epilogue_bf16<128, kNoSigmoid>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
