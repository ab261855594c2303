// Flash-attention forward with fused rope.
//
// Replaces: dtdl_tpu/ops/attention.py:_fwd_kernel (launched by _fwd, public
// flash_attention), the Pallas TPU forward kernel of the model's cacheless
// forward (models/transformer.py Attention, the training and scoring path).
//
// What it computes, per (b·h, query row i): softmax(q_i·K^T · scale) · V over
// the keys j < Sk, causal when asked with the diagonal bottom-aligned
// (row i sees j <= i + Sk - Sq).  With rope tables, q and k rows are rotated
// (f32 arithmetic, rounded back to the input type, as
// ops/rope.py:apply_rope): on load in the f32 body, beforehand by the
// pre-pass for the bf16 body.  Scores and the running m, l, acc are f32;
// the weights are rounded to the input type before P·V, as the JAX kernel
// casts p before its second matmul.  It also writes lse = m + log(l) per
// row (f32, [B·H, Sq]) for the backward kernels.
//
// What bounds it on an H100: operations at long sequence.  4·Sq·Sk·D flops per
// head (halved when causal) against 2·(Sq + 2·Sk)·D input bytes: at 2048 x
// 2048 x 128 that is ~700 flops per byte, well past the ~295 where bf16
// tensor cores, not memory, are the limit.
//
// What the design does about it: the S x S score matrix never leaves the
// block: one block per (q tile, b·h) keeps a tile of query rows resident and
// loops over key tiles inside the block (the TPU's sequential grid axis
// becomes this loop), so each K/V element is read once per q tile and reused
// by every row of the tile from shared memory; causal tiles entirely above
// the diagonal are never loaded.  Two bodies:
//  * bf16 (the training path): warp-specialised, 128 query rows per block.
//    A producer warpgroup streams 128-key K and V tiles by TMA through a
//    two-stage mbarrier ring while two consumer warpgroups run both
//    products as wgmma (S = Q·Kᵀ from shared memory, O += P·V with P from
//    registers), the online softmax in f32 with exp2f between them; see the
//    section below.  Rope is applied once per row beforehand by the
//    pre-pass in rope_rows.cu (ops/attention.py flash_fwd), not per tile;
//  * f32 (the scoring check): FMA on the CUDA cores, 16 query rows per
//    block, rope fused into the loads, ragged tails zero filled by
//    bounds-checked loads (the tensor cores have no f32 path that keeps
//    f32 accuracy).
#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

namespace hopper = dtdl::hopper;
using dtdl::kMaskFill;
using dtdl::pack_bf16;
using dtdl::rope_rows;
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

  // keys past this bound sit above the diagonal for every row of the tile,
  // unless a row of it sees no key at all: that row weights every key
  // alike, as the plain version does, so the tile walks them all
  const int kend = (a.causal && r0 + off >= 0) ? min(a.Sk, r0 + rows + off) : a.Sk;
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
      if (col >= a.Sk) return -INFINITY;   // zero-filled keys weigh nothing
      return (!a.causal || col <= i0 + r) ? dot * a.scale : dtdl::kMaskFill;
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

// ---- bf16: wgmma on TMA tiles, warp-specialised ------------------------------
//
// One block per (128 query rows, b·h), the heaviest causal tiles first.
// Warpgroups 0 and 1 are consumers of 64 query rows each; warpgroup 2 is the
// producer, one thread of which issues every TMA load: the Q tile once, then
// the K and V tiles of 128 keys through a ring of kStages stages (full
// barrier: the tile has landed; empty barrier: all 8 consumer warps are done
// with it).  A consumer computes S = Q·Kᵀ with wgmma (both operands K-major
// in shared memory), the online softmax in registers in the log2 domain
// (scores scaled by scale·log2(e), exp2f), and O += P·V with wgmma, P from
// registers (the S accumulator rounded to bf16) and V read MN-major.  Masks
// are computed only on tiles that cross the causal diagonal or the ragged
// end.  q and k arrive already rotated (the rope pre-pass, rope_rows.cu).

constexpr int kBM = 128;                       // query rows per block
constexpr int kBN = 128;                       // keys per tile
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kWG = 128;                       // threads of a warpgroup
constexpr int kWsThreads = 3 * kWG;            // consumers 0, 1; producer 2
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {   // byte offsets from a 1024-byte aligned base
  static constexpr int kQBytes = kBM * D * 2, kTileBytes = kBN * D * 2;
  static constexpr int kQ = 0, kK = kQBytes, kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;   // q_full, full[s], empty[s]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;   // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const FlashArgs a) {
  using C = hopper::Cols<D>;
  using L = FwdSmem<D>;
  constexpr int RB = C::kRowBytes;
  extern __shared__ unsigned char fwd_smem[];
  const uint32_t base = (hopper::saddr(fwd_smem) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 * (1 + kStages);

  const int bh = blockIdx.y, r0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int rows = min(kBM, a.Sq - r0);
  const int off = a.Sk - a.Sq;
  // keys past kend sit above the diagonal for every row of the tile, unless
  // a row of it sees no key at all: that row weights every key alike, as
  // the plain version does, so the tile walks them all
  const int kend = (a.causal && r0 + off >= 0) ? min(a.Sk, r0 + rows + off) : a.Sk;
  const int n_tiles = (kend + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 2 * kWG) {
      hopper::mbar_expect_tx(q_full, L::kQBytes);
      for (int cb = 0; cb < C::kBlocks; ++cb)
        hopper::tma_load(base + L::kQ + cb * kBM * RB, &tq, q_full, cb * C::kBox, r0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        hopper::mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
        const uint32_t kt = base + L::kK + s * L::kTileBytes;
        const uint32_t vt = base + L::kV + s * L::kTileBytes;
        for (int cb = 0; cb < C::kBlocks; ++cb) {
          hopper::tma_load(kt + cb * kBN * RB, &tk, full0 + 8 * s, cb * C::kBox, t * kBN, bh);
          hopper::tma_load(vt + cb * kBN * RB, &tv, full0 + 8 * s, cb * C::kBox, t * kBN, bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    hopper::regs_alloc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int wr0 = r0 + wg * 64;            // this warpgroup's first row
    const int row_a = wr0 + warp * 16 + g;   // rows of regs 4j, 4j+1; +8 for 4j+2, 4j+3
    const float sl2 = a.scale * kLog2e;
    float o[D / 2], sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    float m_r[2] = {kMaskFill, kMaskFill};
    float l_r[2] = {0.f, 0.f};   // this thread's share of the row sums
    const uint32_t qa = base + L::kQ + wg * 64 * RB;
    hopper::mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, c0 = t * kBN;
      const uint32_t kt = base + L::kK + s * L::kTileBytes;
      const uint32_t vt = base + L::kV + s * L::kTileBytes;
      hopper::mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      // S = Q·Kᵀ over D in k steps of 16: column block ks / kSteps, 32 bytes a step
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int cb = ks / C::kSteps, kin = (ks % C::kSteps) * 32;
        const uint64_t da = hopper::make_desc(qa + cb * kBM * RB + kin, 16, 8 * RB, RB);
        const uint64_t db = hopper::make_desc(kt + cb * kBN * RB + kin, 16, 8 * RB, RB);
        hopper::wgmma_ss<kBN>(sc, da, db, ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // scale to the log2 domain; mask only a tile that crosses the diagonal
      // (for this warpgroup's rows) or the ragged end of the keys
      const bool edge = c0 + kBN > a.Sk || (a.causal && c0 + kBN - 1 > wr0 + off);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = c0 + j * 8 + tig * 2 + (i & 1);
            const int row = row_a + (i >> 1) * 8;
            float x = sc[4 * j + i] * sl2;
            if (a.causal && col > row + off) x = kMaskFill;
            if (col >= a.Sk) x = -INFINITY;   // zero-filled keys weigh nothing
            sc[4 * j + i] = x;
          }
      } else {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sc[i] *= sl2;
      }
      // online softmax: two rows per thread, each spread over 4 lanes
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[r];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2f(m_r[r] - mx);
        m_r[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * r + e] - mx);
            sc[4 * j + 2 * r + e] = p;
            sum += p;
          }
        l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * r] *= alpha;
          o[4 * j + 2 * r + 1] *= alpha;
        }
      }
      // O += P·V: the S accumulator of keys 16kk..16kk+15 is the A fragment
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) pa[kk][f] = pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t db = hopper::make_desc(vt + kk * 16 * RB, kBN * RB, 8 * RB, RB);
        hopper::wgmma_rs<D>(o, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
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
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / l_safe, o[4 * j + 2 * r + 1] / l_safe);
      // a row that saw no key keeps the mask fill as its lse, as the plain
      // version's logsumexp over -1e30 scores does
      if (tig == 0)
        a.lse[size_t(bh) * a.Sq + row] =
            m_r[r] == kMaskFill ? kMaskFill : (m_r[r] + log2f(l_safe)) * kLn2;
    }
  }
}

template <int D>
int launch_wgmma(const FlashArgs& a, cudaStream_t stream) {
  // q and k come rotated from the rope pre-pass: this body takes no tables
  if (a.qc != nullptr) return int(cudaErrorInvalidValue);
  using C = hopper::Cols<D>;
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_rows(&tq, a.q, a.BH, a.Sq, D, kBM, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tk, a.k, a.BH, a.Sk, D, kBN, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tv, a.v, a.BH, a.Sk, D, kBN, C::kBox);
  if (err != 0) return err;
  const int smem = FwdSmem<D>::kBytes;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((a.Sq + kBM - 1) / kBM, a.BH);
  kernel<<<grid, kWsThreads, smem, stream>>>(tq, tk, tv, a);
  return int(cudaGetLastError());
}

int launch_dim(const FlashArgs& a, int D, cudaStream_t stream) {
  const bool bf16 = a.kind == dtdl::kBF16;
  switch (D) {
    case 16: return bf16 ? launch_wgmma<16>(a, stream) : launch<float, 16>(a, stream);
    case 32: return bf16 ? launch_wgmma<32>(a, stream) : launch<float, 32>(a, stream);
    case 64: return bf16 ? launch_wgmma<64>(a, stream) : launch<float, 64>(a, stream);
    case 128: return bf16 ? launch_wgmma<128>(a, stream) : launch<float, 128>(a, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 f32, 1 bf16.  Rope tables are all null or all set; the bf16 body
// takes q and k already rotated and no tables.  Returns a cudaError_t.
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
