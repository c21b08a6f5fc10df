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
// byte, far above the card's ~295 in bf16, so the tensor cores bound it.
// The design keeps the (T, S) scores out of device memory (one block owns a
// query tile and walks every key tile, scores live in registers) and feeds
// the tensor cores with mma.sync m16n8k16 bf16 tiles with fp32 accumulation.
// Every query tile reads every key tile, so work done per key tile as it is
// loaded is repeated T/64 times: the rotary of K is therefore applied once,
// by a prologue kernel into a scratch copy of K that the wrapper allocates
// (one extra read and write of K), and the main loop only copies K and V
// tiles, with cp.async into two shared-memory stages so that the next
// tile's copy overlaps this tile's products. Q's rotary is applied as its
// tile is staged, once per block. K and V fragments come out of shared
// memory with ldmatrix (V transposed). wgmma, TMA and warp specialisation
// are later work. The fp32 path (parity runs) uses fp32 FMA, not TF32, so
// it keeps fp32 accuracy; it is bounded by the 67 TFLOP/s fp32 rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; plain C interface, bound with ctypes
//        (esm_tpu_torch/kernels/flash_attention.py). The helpers shared
//        with the backward are in flash_common.cuh.

#include "flash_common.cuh"

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
// bf16: tensor cores through mma.sync m16n8k16, fp32 accumulation.
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t bf16_smem_bytes() {
  // two stages of K and V tiles, (DP + 8)-element rows, and two bias rows
  return 4 * kBN * (DP + 8) * sizeof(__nv_bfloat16) + 2 * kBN * sizeof(float);
}

// Stage the Q tile [q0, q0 + kBM) into dst (row stride ld), rotated when
// tables are given, zero past T and past d; four elements at a time (d is a
// multiple of 8, so a chunk never straddles the rotary halves).
template <int DP>
__device__ __forceinline__ void stage_q(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                        int q0, const Params& p) {
  constexpr int kChunks = DP / 4;
  const int half = p.d / 2;
  for (int c = threadIdx.x; c < kBM * kChunks; c += kThreads) {
    const int j = (c % kChunks) * 4;
    const int row = q0 + c / kChunks;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < p.T && j < p.d) {
      const __nv_bfloat16* rp = src + (size_t)row * p.d;
      load4(rp + j, x);
      if (p.cos != nullptr) {
        const bool lo = j < half;
        const size_t t = (size_t)row * p.d + (lo ? j : j - half);  // halves are equal
        float y[4], cs[4], sn[4];
        load4(rp + (lo ? j + half : j - half), y);
        load4(p.cos + t, cs);
        load4(p.sin + t, sn);
        const float sign = lo ? -1.f : 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = rot_term(x[e], cs[e], sign * y[e], sn[e]);
      }
    }
    store4(dst + (c / kChunks) * ld + j, x);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int kLd = DP + 8;  // padded row stride: conflict-free ldmatrix rows
  constexpr int kTile = kBN * kLd;
  static_assert(kBM == kBN, "a K stage buffer also stages the Q tile");
  static_assert(DP % 16 == 0, "ldmatrix.x4 takes two 8-column groups at a time");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kTile]
  __nv_bfloat16* sV = sK + 2 * kTile;                           // [2][kTile]
  float* sBias = reinterpret_cast<float*>(sV + 2 * kTile);      // [2][kBN]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // fragment row group
  const int t4 = lane & 3;    // thread in group
  const int mat = lane >> 3;  // ldmatrix: the matrix this lane addresses
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.T * p.d;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + (size_t)bh * p.S * p.d;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + (size_t)bh * p.S * p.d;
  const int n_tiles = (p.S + kBN - 1) / kBN;

  // key tile 0 into stage 0, in flight while Q is staged
  copy_rows_async<DP>(sK, kLd, k, 0, p.S, p.d);
  copy_rows_async<DP>(sV, kLd, v, 0, p.S, p.d);
  cp_async_commit();
  if (threadIdx.x < kBN) sBias[threadIdx.x] = key_bias(p, b, threadIdx.x);

  // Q tile: stage (rotated) through K's stage 1, keep as A fragments
  stage_q<DP>(sK + kTile, kLd, q, q0, p);
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
    float bias_next = 0.f;
    if (it + 1 < n_tiles) {
      // next tile into the other stage, in flight during this tile's products
      const int n1 = (it + 1) * kBN;
      copy_rows_async<DP>(sK + (cur ^ 1) * kTile, kLd, k, n1, p.S, p.d);
      copy_rows_async<DP>(sV + (cur ^ 1) * kTile, kLd, v, n1, p.S, p.d);
      cp_async_commit();
      if (threadIdx.x < kBN) bias_next = key_bias(p, b, n1 + threadIdx.x);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + cur * kTile;
    const __nv_bfloat16* tV = sV + cur * kTile;
    const float* tBias = sBias + cur * kBN;

    // S = Q . K^T; K fragments for key groups nt and nt + 1: matrices
    // (keys nt*8 | (nt+1)*8) x (dims +0..7 | +8..15)
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

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      const float2 bias = *reinterpret_cast<const float2*>(tBias + nt * 8 + t4 * 2);
      s[nt][0] += bias.x;
      s[nt][1] += bias.y;
      s[nt][2] += bias.x;
      s[nt][3] += bias.y;
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    // every tile holds a key < S, so mx is finite here
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[nt][e] = exp2f((s[nt][e] - m[i]) * kLog2e);
        ls[i] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
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
      // B fragments of V (keys x dims) for column groups dn and dn + 1:
      // matrices (keys +0..7 | +8..15) x (dims dn*8 | (dn+1)*8)
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
    if (it + 1 < n_tiles && threadIdx.x < kBN) sBias[(cur ^ 1) * kBN + threadIdx.x] = bias_next;
    __syncthreads();  // this stage is free for the copy issued next iteration
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.f ? 1.f : 1.f / l[i];
  }
  if (p.lse != nullptr && t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + g + 8 * i;
      if (row < p.T) p.lse[(size_t)bh * p.T + row] = m[i] + logf(fmaxf(l[i], 1e-37f));
    }
  }
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * p.T * p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + t4 * 2;
      if (col < p.d) {
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * p.d + col) =
            __floats2bfloat162_rn(acc[dn][2 * i] * inv[i], acc[dn][2 * i + 1] * inv[i]);
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
cudaError_t launch(const Params& p, int bh, bool bf16, cudaStream_t stream) {
  if (bf16) {
    constexpr size_t smem = bf16_smem_bytes<DP>();
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    dim3 grid(bh, (p.T + kBM - 1) / kBM);
    flash_fwd_bf16<DP><<<grid, kThreads, smem, stream>>>(p);
  } else {
    dim3 grid(bh, (p.T + kFBM - 1) / kFBM);
    flash_fwd_f32<DP><<<grid, 128, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, T, d), k/v (B, H, S, d), o (B, H, T, d): contiguous, all of one
// dtype (is_bf16: bf16, else fp32), 16-byte aligned. mask: (B, S) uint8 or
// null. cos/sin: (L >= max(T, S), d) fp32, or null for no rotary; with them,
// k_rot is scratch of k's shape and dtype that receives rot(k). lse: (B, H, T)
// fp32 that receives each row's log-sum-exp m + log(max(l, 1e-37)), or null.
// Launches on `stream` and returns the first CUDA error (0 on success).
int esm_flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* cos, const void* sin, void* k_rot, void* o, void* lse,
                            int B, int H, int T, int S, int d, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && k_rot == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool bf16 = is_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  const void* kr = k;
  if (c != nullptr) {
    const size_t rows = (size_t)B * H * S;
    const cudaError_t e = bf16 ? rotate<__nv_bfloat16>(k, k_rot, c, s, rows, S, d, st)
                               : rotate<float>(k, k_rot, c, s, rows, S, d, st);
    if (e != cudaSuccess) return (int)e;
    kr = k_rot;
  }
  Params p{q, kr, v, static_cast<const uint8_t*>(mask), c, s, o, static_cast<float*>(lse),
           H, T, S, d};
  const int bh = B * H;
  cudaError_t e;
  switch ((d + 15) / 16 * 16) {
    case 16: e = launch<16>(p, bh, bf16, st); break;
    case 32: e = launch<32>(p, bh, bf16, st); break;
    case 48: e = launch<48>(p, bh, bf16, st); break;
    case 64: e = launch<64>(p, bh, bf16, st); break;
    case 80: e = launch<80>(p, bh, bf16, st); break;
    case 96: e = launch<96>(p, bh, bf16, st); break;
    case 112: e = launch<112>(p, bh, bf16, st); break;
    case 128: e = launch<128>(p, bh, bf16, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

const char* esm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
