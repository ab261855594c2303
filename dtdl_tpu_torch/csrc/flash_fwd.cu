// Flash-attention forward with fused rope.
//
// Replaces: dtdl_tpu/ops/attention.py:_fwd_kernel (launched by _fwd, public
// flash_attention), the Pallas TPU forward kernel of the model's cacheless
// forward (models/transformer.py Attention, the training and scoring path).
//
// What it computes, per (b·h, query row i): softmax(q_i·K^T · scale) · V over
// the keys j < Sk, causal when asked with the diagonal bottom-aligned
// (row i sees j <= i + Sk - Sq).  With rope tables, q and k rows are rotated
// on load (f32 arithmetic, rounded back to the input type, as
// ops/rope.py:apply_rope).  Scores and the running m, l, acc are f32; the
// weights are rounded to the input type before P·V, as the JAX kernel casts
// p before its second matmul.  It also writes lse = m + log(l) per row (f32,
// [B·H, Sq]) for the backward kernels of the training slice; rows with
// l == 0 give o = 0.
//
// What bounds it on an H100: operations at long sequence.  4·Sq·Sk·D flops per
// head (halved when causal) against 2·(Sq + 2·Sk)·D input bytes: at 2048 x
// 2048 x 128 that is ~700 flops per byte, well past the ~295 where bf16
// tensor cores, not memory, are the limit.
//
// What the design does about it: the S x S score matrix never leaves the
// block: one block per (q tile, b·h) keeps a tile of query rows resident and
// loops over key chunks of 64 rows inside the block (the TPU's sequential
// grid axis becomes this loop), so each K/V element is read once per q tile
// and reused by every row of the tile from shared memory; causal chunks
// entirely above the diagonal are never loaded; ragged tails are
// bounds-checked loads, zero filled.  Two bodies:
//  * bf16: the two products run on the tensor cores with mma.sync
//    m16n8k16 (bf16 in, f32 accumulate), 64 query rows per block, 16 per
//    warp; S stays in registers and its accumulator layout is reused as
//    the A operand of P·V (the FlashAttention-2 arrangement); V's B
//    operand comes through transposing ldmatrix loads.  wgmma tiles fed by
//    TMA, with loads overlapping the products, are the next step;
//  * f32: FMA on the CUDA cores, 16 query rows per block (the tensor cores
//    have no f32 path that keeps f32 accuracy).
#include "attn_common.cuh"

namespace {

using dtdl::ld32;
using dtdl::mma_16816;
using dtdl::pack_bf16;
using dtdl::rope_rows;
using dtdl::smem_addr;
using dtdl::stage_rows;
using dtdl::Tile;

constexpr int kThreads = 128;
constexpr int kRows = 16;     // QT
constexpr int kChunk = 64;    // KC

struct FlashArgs {
  const void* q;   // [BH, Sq, D] T
  const void* k;   // [BH, Sk, D] T
  const void* v;
  const float* qc; // rope rows [Sq, D] f32 (cos, widened to D), or null
  const float* qs;
  const float* kc; // [Sk, D]
  const float* ks;
  void* o;         // [BH, Sq, D] T
  float* lse;      // [BH, Sq] f32
  int BH, Sq, Sk, causal, kind;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashArgs a) {
  extern __shared__ float smem[];
  using TileT = Tile<D, kRows, kThreads>;
  TileT tile(smem, kChunk);

  const int bh = blockIdx.y, r0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.Sq - r0);
  const int off = a.Sk - a.Sq;
  const bool rope = a.qc != nullptr;
  float acc[TileT::DPT];
#pragma unroll
  for (int j = 0; j < TileT::DPT; ++j) acc[j] = 0.f;
  tile.init_stats();

  const T* q = static_cast<const T*>(a.q) + (size_t(bh) * a.Sq + r0) * D;
  for (int e = threadIdx.x; e < kRows * D; e += kThreads)
    tile.Qs[e] = e < rows * D ? dtdl::to_f32<T>(q[e]) : 0.f;
  if (rope) {
    __syncthreads();
    rope_rows<T, D>(tile.Qs, D, kRows, r0, rows, a.qc, a.qs);
  }

  // keys past this bound sit above the diagonal for every row of the tile
  const int kend = a.causal ? min(a.Sk, r0 + rows + off) : a.Sk;
  const T* kb = static_cast<const T*>(a.k) + size_t(bh) * a.Sk * D;
  const T* vb = static_cast<const T*>(a.v) + size_t(bh) * a.Sk * D;
  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int nk = min(kChunk, kend - c0);
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk * (D / 8); e += kThreads) {
      const int k = e / (D / 8), d0 = (e - k * (D / 8)) * 8;
      float kv[8], vv[8];
      if (k < nk) {
        const size_t el = size_t(c0 + k) * D + d0;
        dtdl::load8(kb, el, a.kind, kv);
        dtdl::load8(vb, el, a.kind, vv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        tile.Ks[k * TileT::KSTRIDE + d0 + i] = kv[i];
        tile.Vs[k * D + d0 + i] = vv[i];
      }
    }
    if (rope) {
      __syncthreads();
      rope_rows<T, D>(tile.Ks, TileT::KSTRIDE, kChunk, c0, nk, a.kc, a.ks);
    }
    __syncthreads();
    const int i0 = r0 + off;
    tile.scores(kChunk, rows, [&](int r, int k, float dot) {
      const int col = c0 + k;
      const bool visible = col < a.Sk && (!a.causal || col <= i0 + r);
      return visible ? dot * a.scale : dtdl::kMaskFill;
    });
    __syncthreads();
    tile.template softmax<T>(kChunk, rows, false);
    __syncthreads();
    tile.pv(kChunk, rows, acc);
  }
  __syncthreads();
  tile.template store<T>(static_cast<T*>(a.o) + (size_t(bh) * a.Sq + r0) * D, rows, acc);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float l = tile.L[r];
    a.lse[size_t(bh) * a.Sq + r0 + r] = tile.M[r] + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = Tile<D, kRows, kThreads>::smem_bytes(kChunk);
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.BH);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kMmaRows = 64;   // query rows per block, 16 per warp
constexpr int kMmaKeys = 64;   // keys per chunk
constexpr int kPad = 8;        // bf16 pad per shared row: conflict-free fragment loads

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const FlashArgs a) {
  constexpr int LDQ = D + kPad;
  constexpr int KS = D / 16;   // k-steps of Q·K^T
  constexpr int ND = D / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);   // [64][LDQ]
  __nv_bfloat16* Ks = Qs + kMmaRows * LDQ;                           // [64][LDQ]
  __nv_bfloat16* Vs = Ks + kMmaKeys * LDQ;                           // [64][LDQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  // the last (causal: heaviest) query tiles are scheduled first
  const int bh = blockIdx.y, r0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;
  const int rows = min(kMmaRows, a.Sq - r0);
  const int off = a.Sk - a.Sq;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + size_t(bh) * a.Sq * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + size_t(bh) * a.Sk * D;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + size_t(bh) * a.Sk * D;

  stage_rows<D>(Qs, LDQ, qb, r0, kMmaRows, rows, a.qc, a.qs);
  __syncthreads();
  const int wr = warp * 16;    // this warp's 16 rows of the tile
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* q0 = Qs + (wr + g) * LDQ + ks * 16 + tig * 2;
    qf[ks][0] = ld32(q0);
    qf[ks][1] = ld32(q0 + 8 * LDQ);
    qf[ks][2] = ld32(q0 + 8);
    qf[ks][3] = ld32(q0 + 8 * LDQ + 8);
  }
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_r[2] = {dtdl::kMaskFill, dtdl::kMaskFill};
  float l_r[2] = {0.f, 0.f};   // this thread's share of the row sums
  const int row_a = r0 + wr + g;   // global q rows of c0/c1 and c2/c3

  const int kend = a.causal ? min(a.Sk, r0 + rows + off) : a.Sk;
  for (int c0 = 0; c0 < kend; c0 += kMmaKeys) {
    const int nk = min(kMmaKeys, kend - c0);
    __syncthreads();   // the previous chunk's fragment loads are done
    stage_rows<D>(Ks, LDQ, kb, c0, kMmaKeys, nk, a.kc, a.ks);
    stage_rows<D>(Vs, LDQ, vb, c0, kMmaKeys, nk, nullptr, nullptr);
    __syncthreads();

    float sc[kMmaKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* k0 = Ks + (nt * 8 + g) * LDQ + tig * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_16816(sc[nt], qf[ks], ld32(k0 + ks * 16), ld32(k0 + ks * 16 + 8));
    }
    // scale and mask: c0/c1 belong to row_a, c2/c3 to row_a + 8
#pragma unroll
    for (int nt = 0; nt < kMmaKeys / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + nt * 8 + tig * 2 + (j & 1);
        const int row = row_a + (j >> 1) * 8;
        const bool visible = col < a.Sk && (!a.causal || col <= row + off);
        sc[nt][j] = visible ? sc[nt][j] * a.scale : dtdl::kMaskFill;
      }
    // online softmax, two rows per thread, each row spread over 4 lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = dtdl::kMaskFill;
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float alpha = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kMmaKeys / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(sc[nt][2 * r + j] - m_new);
          sc[nt][2 * r + j] = p;
          sum += p;
        }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][2 * r] *= alpha;
        o[nd][2 * r + 1] *= alpha;
      }
    }
    // P·V: the score accumulators of key tiles 2kk, 2kk+1 are the A operand
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      // B operand (k = key, n = dim) straight from row-major V: a
      // transposing matrix load, lanes 0-15 addressing keys kk*16 + 0..15
      const uint32_t vrow = smem_addr(Vs + (kk * 16 + lane % 16) * LDQ);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(vrow + nd * 8 * 2));
        mma_16816(o[nd], pa, b0, b1);
      }
    }
  }
  // finalize: the row sums over the row's 4 lanes, o = acc / l, lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    const int row = row_a + 8 * r;
    if (row >= a.Sq) continue;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + (size_t(bh) * a.Sq + row) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(o[nd][2 * r] / l_safe, o[nd][2 * r + 1] / l_safe);
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + tig * 2) = v;
    }
    if (tig == 0) a.lse[size_t(bh) * a.Sq + row] = m_r[r] + logf(l_safe);
  }
}

template <int D>
int launch_mma(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * size_t(kMmaRows + 2 * kMmaKeys) * (D + kPad);
  auto kernel = flash_fwd_mma_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((a.Sq + kMmaRows - 1) / kMmaRows, a.BH);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

int launch_dim(const FlashArgs& a, int D, cudaStream_t stream) {
  const bool bf16 = a.kind == dtdl::kBF16;
  switch (D) {
    case 16: return bf16 ? launch_mma<16>(a, stream) : launch<float, 16>(a, stream);
    case 32: return bf16 ? launch_mma<32>(a, stream) : launch<float, 32>(a, stream);
    case 64: return bf16 ? launch_mma<64>(a, stream) : launch<float, 64>(a, stream);
    case 128: return bf16 ? launch_mma<128>(a, stream) : launch<float, 128>(a, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 f32, 1 bf16.  Rope tables are all null or all set.  Returns a
// cudaError_t.
extern "C" int dtdl_flash_fwd(const void* q, const void* k, const void* v, const void* qc,
                              const void* qs, const void* kc, const void* ks, void* o, void* lse,
                              int BH, int Sq, int Sk, int D, int kind, int causal, float scale,
                              void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || BH > 65535) return int(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.qc = static_cast<const float*>(qc);
  a.qs = static_cast<const float*>(qs);
  a.kc = static_cast<const float*>(kc);
  a.ks = static_cast<const float*>(ks);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.BH = BH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.kind = kind;
  a.scale = scale;
  return launch_dim(a, D, static_cast<cudaStream_t>(stream));
}

// Message for a code returned by the entry points above.
extern "C" const char* dtdl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
