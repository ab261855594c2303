// Flash-attention backward with fused rope: kernels K2 (dq) and K3 (dk, dv).
//
// Replaces: dtdl_tpu/ops/attention.py:_bwd_dq_kernel (K2) and _bwd_dkv_kernel
// (K3), both launched by _bwd, the Pallas TPU backward of flash_attention
// (the causal-LM training step: one K2 and one K3 launch per layer).
//
// What they compute, per b·h, from the forward's residuals q, k (unrotated),
// v, its lse [B·H, Sq] f32 and delta = rowsum(dO∘O) [B·H, Sq] f32 (computed
// outside, as attention.py:554 does):
//   s = q·kᵀ·scale (masked to -1e30 above the bottom-aligned causal diagonal,
//   off = Sk - Sq), p = exp(s - lse), dp = dO·vᵀ, ds = p∘(dp - delta)·scale;
//   K2: dq = ds·k;  K3: dk = dsᵀ·q, dv = pᵀ·dO.
// ds and p are rounded to the input type before their products, as the JAX
// kernels cast them; products accumulate in f32.  With rope tables, q and k
// rows are rotated on load (f32, rounded back, as flash_fwd.cu) and dq / dk,
// which are gradients of the rotated rows, get the inverse rotation on the
// f32 accumulator before the store.
//
// What bounds them on an H100: operations at the training shape.  At S =
// 4096, D = 128 the causal K2 does 6·S²·D/2 flops per head and K3 8·S²·D/2
// against ~2·4·S·D input bytes: ~700 flops per byte, past the ~295 where the
// bf16 tensor cores, not memory, are the limit.
//
// What the design does about it: JAX's split into two kernels is kept, with
// no atomics, so the gradients are bitwise reproducible from run to run.
// K2 runs one block per (q tile, b·h) that loops over key chunks up to the
// causal diagonal; K3 one block per (key tile, b·h) that loops over q chunks
// from the first one that reaches its keys (the TPU's sequential grid axis
// becomes the loop).  Both recompute s and dp, so the pair does 14·S²·D
// flops per head where FlashAttention-2's atomic dq does 10.  The S x S
// matrices never leave the block.  Two bodies:
//  * bf16: mma.sync m16n8k16 on the tensor cores (bf16 in, f32 accumulate),
//    16 rows per warp, the score accumulators reused as the A operand of
//    the next product (ds or p packed to bf16), the B operands of ds·k,
//    pᵀ·dO and dsᵀ·q read straight from row-major shared tiles by
//    transposing ldmatrix loads.  K3 works in the transposed frame (rows
//    are keys, columns q rows: sᵀ = k·qᵀ, dpᵀ = v·dOᵀ), so no operand is
//    re-laid out in registers.  K3 keeps dk and dv for its 64 keys in
//    registers (16 keys per warp) and walks q in chunks of 32 rows, which
//    keeps the transposed score tiles at 32 registers a thread;
//  * f32: FMA on the CUDA cores (16 rows per block), as flash_fwd.cu's f32
//    body.
// Rows that see no key at all (causal with Sq > Sk) have lse = -1e30, so
// p = 1 against every masked key, as in the plain version; a tile holding
// such a row walks every key (K2), and K3 then starts at the first q chunk.
// wgmma tiles fed by TMA are the next step.
#include "attn_common.cuh"

namespace {

using dtdl::kMaskFill;
using dtdl::ld32;
using dtdl::ldmatrix_trans_x2;
using dtdl::mma_16816;
using dtdl::pack_bf16;
using dtdl::rope_rows;
using dtdl::smem_addr;
using dtdl::stage_rows;
using dtdl::unrotate_pair;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;

struct BwdArgs {
  const void* q;     // [BH, Sq, D] T, unrotated
  const void* k;     // [BH, Sk, D] T, unrotated
  const void* v;     // [BH, Sk, D] T
  const void* dO;    // [BH, Sq, D] T
  const float* lse;  // [BH, Sq]
  const float* delta;
  const float* qc;   // rope rows [Sq, D] f32, or null
  const float* qs;
  const float* kc;   // [Sk, D]
  const float* ks;
  void* dq;          // [BH, Sq, D] T
  void* dk;          // [BH, Sk, D] T
  void* dv;
  int BH, Sq, Sk, causal;
  float scale;
};

// p = exp(s - lse) of one score; `dot` is the raw q·k product.  Rows past
// Sq and keys past Sk (`live` false) contribute nothing.
__device__ __forceinline__ float prob(float dot, bool live, bool visible, float scale, float lse) {
  if (!live) return 0.f;
  return expf((visible ? __fmul_rn(dot, scale) : kMaskFill) - lse);
}

// ds = p·(dp - delta)·scale
__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, dp - delta), scale);
}

// Every kernel opts in to its dynamic shared memory and launches on
// `stream`; returns a cudaError_t.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const BwdArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kRows = 64;    // K2: q rows per block; K3: keys per block (16 per warp)
constexpr int kKeys = 64;    // K2: keys per chunk
constexpr int kQ = 32;       // K3: q rows per chunk
constexpr int kPad = 8;      // bf16 pad per shared row: conflict-free fragment loads

// The A fragment (16 rows from `row0`, k step ks) of a row-major shared tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* tile, int row0, int ks,
                                       int g, int tig) {
  const bf16* p = tile + (row0 + g) * LD + ks * 16 + tig * 2;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * LD);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * LD + 8);
}

// acc (16 x D per warp) += A (16 x 16·NK, packed from NK pairs of score
// tiles) · the NK·16 rows of `tile` from `row0`, read through transposing
// matrix loads.
template <int D, int NK, int LD>
__device__ __forceinline__ void acc_product(float (&acc)[D / 8][4], const float (&sc)[2 * NK][4],
                                            const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
    const uint32_t row = smem_addr(tile + (kk * 16 + lane % 16) * LD);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      uint32_t b0, b1;
      ldmatrix_trans_x2(b0, b1, row, nd * 8 * 2);
      mma_16816(acc[nd], pa, b0, b1);
    }
  }
}

// Inverse rope on a warp's f32 accumulator and the bf16 store of its 16
// rows: rows row_a and row_a + 8 (global rows of [.., n, D]); dimension d
// and d + D/2 of a row sit in tiles nd and nd + D/16 of one thread.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, float (&acc)[D / 8][4], int row_a, int n,
                                           int tig, const float* c, const float* s) {
  constexpr int ND = D / 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n) continue;
    if (c != nullptr) {
      const float* cr = c + size_t(row) * D;
      const float* sr = s + size_t(row) * D;
#pragma unroll
      for (int nd = 0; nd < ND / 2; ++nd)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d = nd * 8 + tig * 2 + j;
          unrotate_pair(acc[nd][2 * r + j], acc[nd + ND / 2][2 * r + j], cr[d], sr[d],
                        cr[d + D / 2], sr[d + D / 2]);
        }
    }
    bf16* orow = out + size_t(row) * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

// K2: one block per (64 q rows, b·h), 16 rows per warp.
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_mma_kernel(const BwdArgs a) {
  constexpr int LD = D + kPad, KS = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(dq_smem);   // [64][LD] roped q tile
  bf16* Ds = Qs + kRows * LD;                     // [64][LD] dO tile
  bf16* Ks = Ds + kRows * LD;                     // [64][LD] roped key chunk
  bf16* Vs = Ks + kKeys * LD;                     // [64][LD] value chunk

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  // the last (causal: heaviest) q tiles are scheduled first
  const int bh = blockIdx.y, r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int rows = min(kRows, a.Sq - r0);
  const int off = a.Sk - a.Sq;
  const bf16* qb = static_cast<const bf16*>(a.q) + size_t(bh) * a.Sq * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + size_t(bh) * a.Sk * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + size_t(bh) * a.Sk * D;
  const bf16* db = static_cast<const bf16*>(a.dO) + size_t(bh) * a.Sq * D;
  stage_rows<D>(Qs, LD, qb, r0, kRows, rows, a.qc, a.qs);
  stage_rows<D>(Ds, LD, db, r0, kRows, rows, nullptr, nullptr);

  const int wr = warp * 16;
  const int row_a = r0 + wr + g;   // global q rows of c0/c1; c2/c3 are row_a + 8
  float lse_r[2], delta_r[2];
  bool live_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    live_r[r] = row < a.Sq;
    lse_r[r] = live_r[r] ? a.lse[size_t(bh) * a.Sq + row] : 0.f;
    delta_r[r] = live_r[r] ? a.delta[size_t(bh) * a.Sq + row] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  // keys past this bound sit above the diagonal for every row of the tile,
  // unless a row of the tile sees no key at all (then it walks every key)
  const int kend = (a.causal && r0 + off >= 0) ? min(a.Sk, r0 + rows + off) : a.Sk;
  for (int c0 = 0; c0 < kend; c0 += kKeys) {
    const int nk = min(kKeys, kend - c0);
    __syncthreads();   // the previous chunk's fragment loads are done
    stage_rows<D>(Ks, LD, kb, c0, kKeys, nk, a.kc, a.ks);
    stage_rows<D>(Vs, LD, vb, c0, kKeys, nk, nullptr, nullptr);
    __syncthreads();

    float sc[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qs, wr, ks, g, tig);
      load_a<LD>(da, Ds, wr, ks, g, tig);
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        const bf16* k0 = Ks + (nt * 8 + g) * LD + ks * 16 + tig * 2;
        const bf16* v0 = Vs + (nt * 8 + g) * LD + ks * 16 + tig * 2;
        mma_16816(sc[nt], qa, ld32(k0), ld32(k0 + 8));
        mma_16816(dp[nt], da, ld32(v0), ld32(v0 + 8));
      }
    }
    // ds in place of the scores: c0/c1 belong to row_a, c2/c3 to row_a + 8
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int col = c0 + nt * 8 + tig * 2 + (j & 1);
        const int row = row_a + 8 * r;
        const bool live = live_r[r] && col < a.Sk;
        const bool visible = !a.causal || col <= row + off;
        const float p = prob(sc[nt][j], live, visible, a.scale, lse_r[r]);
        sc[nt][j] = dscore(p, dp[nt][j], delta_r[r], a.scale);
      }
    acc_product<D, kKeys / 16, LD>(dq, sc, Ks, lane);   // dq += ds·k
  }
  store_rows<D>(static_cast<bf16*>(a.dq) + size_t(bh) * a.Sq * D, dq, row_a, a.Sq, tig, a.qc,
                a.qs);
}

// K3: one block per (64 keys, b·h), 16 keys per warp, in the transposed
// frame: score tiles are [keys, q rows].
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_mma_kernel(const BwdArgs a) {
  constexpr int LD = D + kPad, KS = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(dkv_smem);  // [64][LD] roped key tile
  bf16* Vs = Ks + kRows * LD;                     // [64][LD] value tile
  bf16* Qs = Vs + kRows * LD;                     // [32][LD] roped q chunk
  bf16* Ds = Qs + kQ * LD;                        // [32][LD] dO chunk
  float* Ls = reinterpret_cast<float*>(Ds + kQ * LD);   // [32] lse of the chunk's rows
  float* Dl = Ls + kQ;                                  // [32] delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int bh = blockIdx.y, c0 = blockIdx.x * kRows;   // the first (causal: heaviest) first
  const int keys = min(kRows, a.Sk - c0);
  const int off = a.Sk - a.Sq;
  const bf16* qb = static_cast<const bf16*>(a.q) + size_t(bh) * a.Sq * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + size_t(bh) * a.Sk * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + size_t(bh) * a.Sk * D;
  const bf16* db = static_cast<const bf16*>(a.dO) + size_t(bh) * a.Sq * D;
  const float* lb = a.lse + size_t(bh) * a.Sq;
  const float* deb = a.delta + size_t(bh) * a.Sq;
  stage_rows<D>(Ks, LD, kb, c0, kRows, keys, a.kc, a.ks);
  stage_rows<D>(Vs, LD, vb, c0, kRows, keys, nullptr, nullptr);

  const int wr = warp * 16;
  const int key_a = c0 + wr + g;   // keys of c0/c1; c2/c3 are key_a + 8
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nd][j] = dv[nd][j] = 0.f;

  // leading q chunks whose rows all sit above this tile's first key are
  // skipped; rows that see no key at all (off < 0) take part everywhere
  int qstart = 0;
  if (a.causal && off >= 0) qstart = max(0, c0 - off) / kQ * kQ;
  for (int q0 = qstart; q0 < a.Sq; q0 += kQ) {
    const int nq = min(kQ, a.Sq - q0);
    __syncthreads();   // the previous chunk's reads are done
    stage_rows<D>(Qs, LD, qb, q0, kQ, nq, a.qc, a.qs);
    stage_rows<D>(Ds, LD, db, q0, kQ, nq, nullptr, nullptr);
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
      Ls[i] = i < nq ? lb[q0 + i] : 0.f;
      Dl[i] = i < nq ? deb[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[kQ / 8][4], dpt[kQ / 8][4];   // sᵀ and dpᵀ: [16 keys, 32 q rows] per warp
#pragma unroll
    for (int nt = 0; nt < kQ / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[nt][j] = dpt[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, Ks, wr, ks, g, tig);
      load_a<LD>(va, Vs, wr, ks, g, tig);
#pragma unroll
      for (int nt = 0; nt < kQ / 8; ++nt) {
        const bf16* q0p = Qs + (nt * 8 + g) * LD + ks * 16 + tig * 2;
        const bf16* d0p = Ds + (nt * 8 + g) * LD + ks * 16 + tig * 2;
        mma_16816(st[nt], ka, ld32(q0p), ld32(q0p + 8));
        mma_16816(dpt[nt], va, ld32(d0p), ld32(d0p + 8));
      }
    }
    // pᵀ in place of sᵀ, dsᵀ in place of dpᵀ: c0/c1 belong to key_a,
    // c2/c3 to key_a + 8; the columns are q rows
#pragma unroll
    for (int nt = 0; nt < kQ / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = nt * 8 + tig * 2 + (j & 1);
        const int key = key_a + 8 * (j >> 1);
        const bool live = qi < nq && key < a.Sk;
        const bool visible = !a.causal || key <= q0 + qi + off;
        const float p = prob(st[nt][j], live, visible, a.scale, Ls[qi]);
        st[nt][j] = p;
        dpt[nt][j] = dscore(p, dpt[nt][j], Dl[qi], a.scale);
      }
    acc_product<D, kQ / 16, LD>(dv, st, Ds, lane);    // dv += pᵀ·dO
    acc_product<D, kQ / 16, LD>(dk, dpt, Qs, lane);   // dk += dsᵀ·q
  }
  store_rows<D>(static_cast<bf16*>(a.dk) + size_t(bh) * a.Sk * D, dk, key_a, a.Sk, tig, a.kc,
                a.ks);
  store_rows<D>(static_cast<bf16*>(a.dv) + size_t(bh) * a.Sk * D, dv, key_a, a.Sk, tig,
                nullptr, nullptr);
}

template <int D>
size_t dq_mma_smem() { return sizeof(bf16) * size_t(2 * kRows + 2 * kKeys) * (D + kPad); }

template <int D>
size_t dkv_mma_smem() {
  return sizeof(bf16) * size_t(2 * kRows + 2 * kQ) * (D + kPad) + sizeof(float) * 2 * kQ;
}

// ---- f32 on the CUDA cores --------------------------------------------------

constexpr int kF32Rows = 16;   // K2: q rows per block; K3: keys per block
constexpr int kF32Chunk = 32;  // K2: keys per chunk; K3: q rows per chunk
constexpr int kTPR = kThreads / kF32Rows;   // threads per accumulator row

// `n` rows of an f32 [.., D] slab from row0 (nvalid real, the rest zero)
// into shared rows of stride ld.
template <int D>
__device__ void load_rows_f32(float* dst, int ld, const float* src, int row0, int n,
                              int nvalid) {
  for (int e = threadIdx.x; e < n * (D / 4); e += kThreads) {
    const int r = e / (D / 4), d = (e - r * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) x = *reinterpret_cast<const float4*>(src + size_t(row0 + r) * D + d);
    float* o = dst + r * ld + d;
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

// Inverse rope on an f32 accumulator row held by kTPR threads (dimension
// lane + j·kTPR, so d and d + D/2 are slots j and j + DPT/2 of one thread),
// then the store.
template <int D>
__device__ void store_row_f32(float* out, float (&acc)[D / kTPR], int lane, const float* c,
                              const float* s) {
  constexpr int DPT = D / kTPR;
  if (c != nullptr) {
#pragma unroll
    for (int j = 0; j < DPT / 2; ++j) {
      const int d = lane + j * kTPR;
      unrotate_pair(acc[j], acc[j + DPT / 2], c[d], s[d], c[d + D / 2], s[d + D / 2]);
    }
  }
#pragma unroll
  for (int j = 0; j < DPT; ++j) out[lane + j * kTPR] = acc[j];
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* x, const float* y) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

// K2, f32: one block per (16 q rows, b·h).
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_f32_kernel(const BwdArgs a) {
  constexpr int KLD = D + 1, DPT = D / kTPR;
  extern __shared__ float f32_smem[];
  float* Qs = f32_smem;                    // [16][D] roped q rows
  float* Ds = Qs + kF32Rows * D;           // [16][D] dO rows
  float* Ks = Ds + kF32Rows * D;           // [32][D + 1] roped key chunk
  float* Vs = Ks + kF32Chunk * KLD;        // [32][D + 1]
  float* Ps = Vs + kF32Chunk * KLD;        // [16][32] ds
  float* Lr = Ps + kF32Rows * kF32Chunk;   // [16] lse
  float* Dr = Lr + kF32Rows;               // [16] delta

  const int bh = blockIdx.y, r0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int rows = min(kF32Rows, a.Sq - r0);
  const int off = a.Sk - a.Sq;
  const float* kb = static_cast<const float*>(a.k) + size_t(bh) * a.Sk * D;
  const float* vb = static_cast<const float*>(a.v) + size_t(bh) * a.Sk * D;
  load_rows_f32<D>(Qs, D, static_cast<const float*>(a.q) + size_t(bh) * a.Sq * D, r0, kF32Rows,
                   rows);
  load_rows_f32<D>(Ds, D, static_cast<const float*>(a.dO) + size_t(bh) * a.Sq * D, r0,
                   kF32Rows, rows);
  for (int r = threadIdx.x; r < kF32Rows; r += kThreads) {
    Lr[r] = r < rows ? a.lse[size_t(bh) * a.Sq + r0 + r] : 0.f;
    Dr[r] = r < rows ? a.delta[size_t(bh) * a.Sq + r0 + r] : 0.f;
  }
  if (a.qc != nullptr) {
    __syncthreads();
    rope_rows<float, D>(Qs, D, kF32Rows, r0, rows, a.qc, a.qs);
  }
  const int ar = threadIdx.x / kTPR, lane = threadIdx.x % kTPR;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  const int kend = (a.causal && r0 + off >= 0) ? min(a.Sk, r0 + rows + off) : a.Sk;
  for (int c0 = 0; c0 < kend; c0 += kF32Chunk) {
    const int nk = min(kF32Chunk, kend - c0);
    __syncthreads();
    load_rows_f32<D>(Ks, KLD, kb, c0, kF32Chunk, nk);
    load_rows_f32<D>(Vs, KLD, vb, c0, kF32Chunk, nk);
    if (a.kc != nullptr) {
      __syncthreads();
      rope_rows<float, D>(Ks, KLD, kF32Chunk, c0, nk, a.kc, a.ks);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kF32Rows * kF32Chunk; e += kThreads) {
      const int r = e / kF32Chunk, kk = e - r * kF32Chunk;
      const int row = r0 + r, col = c0 + kk;
      float ds = 0.f;
      if (r < rows && col < a.Sk) {
        const float s = dot_rows<D>(Qs + r * D, Ks + kk * KLD);
        const float dp = dot_rows<D>(Ds + r * D, Vs + kk * KLD);
        const bool visible = !a.causal || col <= row + off;
        ds = dscore(prob(s, true, visible, a.scale, Lr[r]), dp, Dr[r], a.scale);
      }
      Ps[e] = ds;
    }
    __syncthreads();
    for (int kk = 0; kk < kF32Chunk; ++kk) {
      const float ds = Ps[ar * kF32Chunk + kk];
      const float* kr = Ks + kk * KLD + lane;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(ds, kr[j * kTPR], acc[j]);
    }
  }
  if (ar < rows) {
    const size_t row = r0 + ar;
    store_row_f32<D>(static_cast<float*>(a.dq) + (size_t(bh) * a.Sq + row) * D, acc, lane,
                     a.qc ? a.qc + row * D : nullptr, a.qs ? a.qs + row * D : nullptr);
  }
}

// K3, f32: one block per (16 keys, b·h).
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_f32_kernel(const BwdArgs a) {
  constexpr int LDF = D + 1, DPT = D / kTPR;
  extern __shared__ float f32_smem[];
  float* Ks = f32_smem;                    // [16][D + 1] roped keys
  float* Vs = Ks + kF32Rows * LDF;         // [16][D + 1]
  float* Qs = Vs + kF32Rows * LDF;         // [32][D + 1] roped q chunk
  float* Ds = Qs + kF32Chunk * LDF;        // [32][D + 1] dO chunk
  float* Pt = Ds + kF32Chunk * LDF;        // [16][32] pᵀ
  float* St = Pt + kF32Rows * kF32Chunk;   // [16][32] dsᵀ
  float* Lq = St + kF32Rows * kF32Chunk;   // [32] lse
  float* Dq = Lq + kF32Chunk;              // [32] delta

  const int bh = blockIdx.y, c0 = blockIdx.x * kF32Rows;
  const int keys = min(kF32Rows, a.Sk - c0);
  const int off = a.Sk - a.Sq;
  const float* qb = static_cast<const float*>(a.q) + size_t(bh) * a.Sq * D;
  const float* db = static_cast<const float*>(a.dO) + size_t(bh) * a.Sq * D;
  load_rows_f32<D>(Ks, LDF, static_cast<const float*>(a.k) + size_t(bh) * a.Sk * D, c0,
                   kF32Rows, keys);
  load_rows_f32<D>(Vs, LDF, static_cast<const float*>(a.v) + size_t(bh) * a.Sk * D, c0,
                   kF32Rows, keys);
  if (a.kc != nullptr) {
    __syncthreads();
    rope_rows<float, D>(Ks, LDF, kF32Rows, c0, keys, a.kc, a.ks);
  }
  const int ar = threadIdx.x / kTPR, lane = threadIdx.x % kTPR;
  float dk[DPT], dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = dv[j] = 0.f;

  int qstart = 0;
  if (a.causal && off >= 0) qstart = max(0, c0 - off) / kF32Chunk * kF32Chunk;
  for (int q0 = qstart; q0 < a.Sq; q0 += kF32Chunk) {
    const int nq = min(kF32Chunk, a.Sq - q0);
    __syncthreads();
    load_rows_f32<D>(Qs, LDF, qb, q0, kF32Chunk, nq);
    load_rows_f32<D>(Ds, LDF, db, q0, kF32Chunk, nq);
    for (int i = threadIdx.x; i < kF32Chunk; i += kThreads) {
      Lq[i] = i < nq ? a.lse[size_t(bh) * a.Sq + q0 + i] : 0.f;
      Dq[i] = i < nq ? a.delta[size_t(bh) * a.Sq + q0 + i] : 0.f;
    }
    if (a.qc != nullptr) {
      __syncthreads();
      rope_rows<float, D>(Qs, LDF, kF32Chunk, q0, nq, a.qc, a.qs);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kF32Rows * kF32Chunk; e += kThreads) {
      const int kr = e / kF32Chunk, qi = e - kr * kF32Chunk;
      const int key = c0 + kr, row = q0 + qi;
      float p = 0.f, ds = 0.f;
      if (kr < keys && qi < nq) {
        const float s = dot_rows<D>(Ks + kr * LDF, Qs + qi * LDF);
        const float dp = dot_rows<D>(Vs + kr * LDF, Ds + qi * LDF);
        const bool visible = !a.causal || key <= row + off;
        p = prob(s, true, visible, a.scale, Lq[qi]);
        ds = dscore(p, dp, Dq[qi], a.scale);
      }
      Pt[e] = p;
      St[e] = ds;
    }
    __syncthreads();
    for (int qi = 0; qi < kF32Chunk; ++qi) {
      const float p = Pt[ar * kF32Chunk + qi], ds = St[ar * kF32Chunk + qi];
      const float* dr = Ds + qi * LDF + lane;
      const float* qr = Qs + qi * LDF + lane;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        dv[j] = fmaf(p, dr[j * kTPR], dv[j]);
        dk[j] = fmaf(ds, qr[j * kTPR], dk[j]);
      }
    }
  }
  if (ar < keys) {
    const size_t key = c0 + ar;
    store_row_f32<D>(static_cast<float*>(a.dk) + (size_t(bh) * a.Sk + key) * D, dk, lane,
                     a.kc ? a.kc + key * D : nullptr, a.ks ? a.ks + key * D : nullptr);
    store_row_f32<D>(static_cast<float*>(a.dv) + (size_t(bh) * a.Sk + key) * D, dv, lane,
                     nullptr, nullptr);
  }
}

template <int D>
size_t dq_f32_smem() {
  return sizeof(float) * (2 * size_t(kF32Rows) * D + 2 * size_t(kF32Chunk) * (D + 1) +
                          size_t(kF32Rows) * kF32Chunk + 2 * kF32Rows);
}

template <int D>
size_t dkv_f32_smem() {
  return sizeof(float) * (2 * size_t(kF32Rows + kF32Chunk) * (D + 1) +
                          2 * size_t(kF32Rows) * kF32Chunk + 2 * kF32Chunk);
}

// ---- dispatch ---------------------------------------------------------------

template <int D>
int launch_dq(const BwdArgs& a, bool bf16_in, cudaStream_t stream) {
  if (bf16_in)
    return launch(bwd_dq_mma_kernel<D>, dim3((a.Sq + kRows - 1) / kRows, a.BH), dq_mma_smem<D>(),
                  a, stream);
  return launch(bwd_dq_f32_kernel<D>, dim3((a.Sq + kF32Rows - 1) / kF32Rows, a.BH),
                dq_f32_smem<D>(), a, stream);
}

template <int D>
int launch_dkv(const BwdArgs& a, bool bf16_in, cudaStream_t stream) {
  if (bf16_in)
    return launch(bwd_dkv_mma_kernel<D>, dim3((a.Sk + kRows - 1) / kRows, a.BH),
                  dkv_mma_smem<D>(), a, stream);
  return launch(bwd_dkv_f32_kernel<D>, dim3((a.Sk + kF32Rows - 1) / kF32Rows, a.BH),
                dkv_f32_smem<D>(), a, stream);
}

template <bool DQ>
int launch_dim(const BwdArgs& a, int D, bool bf16_in, cudaStream_t stream) {
  switch (D) {
    case 16: return DQ ? launch_dq<16>(a, bf16_in, stream) : launch_dkv<16>(a, bf16_in, stream);
    case 32: return DQ ? launch_dq<32>(a, bf16_in, stream) : launch_dkv<32>(a, bf16_in, stream);
    case 64: return DQ ? launch_dq<64>(a, bf16_in, stream) : launch_dkv<64>(a, bf16_in, stream);
    case 128:
      return DQ ? launch_dq<128>(a, bf16_in, stream) : launch_dkv<128>(a, bf16_in, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                  const void* delta, const void* qc, const void* qs, const void* kc,
                  const void* ks, int BH, int Sq, int Sk, int causal, float scale) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.qc = static_cast<const float*>(qc);
  a.qs = static_cast<const float*>(qs);
  a.kc = static_cast<const float*>(kc);
  a.ks = static_cast<const float*>(ks);
  a.dq = a.dk = a.dv = nullptr;
  a.BH = BH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return a;
}

bool bad_geometry(int BH, int Sq, int Sk) {
  return BH < 1 || Sq < 1 || Sk < 1 || BH > 65535;   // grid-y limit
}

}  // namespace

// K2.  kind: 0 f32, 1 bf16.  Rope tables are all null or all set.  Returns
// a cudaError_t.
extern "C" int dtdl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, const void* qc,
                                 const void* qs, const void* kc, const void* ks, void* dq,
                                 int BH, int Sq, int Sk, int D, int kind, int causal,
                                 float scale, void* stream) {
  if (bad_geometry(BH, Sq, Sk)) return int(cudaErrorInvalidValue);
  BwdArgs a = make_args(q, k, v, dO, lse, delta, qc, qs, kc, ks, BH, Sq, Sk, causal, scale);
  a.dq = dq;
  return launch_dim<true>(a, D, kind == dtdl::kBF16, static_cast<cudaStream_t>(stream));
}

// K3, same arguments with dk and dv for dq.
extern "C" int dtdl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, const void* qc,
                                  const void* qs, const void* kc, const void* ks, void* dk,
                                  void* dv, int BH, int Sq, int Sk, int D, int kind, int causal,
                                  float scale, void* stream) {
  if (bad_geometry(BH, Sq, Sk)) return int(cudaErrorInvalidValue);
  BwdArgs a = make_args(q, k, v, dO, lse, delta, qc, qs, kc, ks, BH, Sq, Sk, causal, scale);
  a.dk = dk;
  a.dv = dv;
  return launch_dim<false>(a, D, kind == dtdl::kBF16, static_cast<cudaStream_t>(stream));
}
