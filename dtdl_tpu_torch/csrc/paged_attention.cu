// Paged attention over the serving engine's block-paged KV pool.
//
// Replaces: dtdl_tpu/ops/paged_attention.py:_kernel (public paged_attention),
// the Pallas TPU kernel every paged prefill, decode and verify goes through.
//
// What it computes, per (row b, head h, query row i < S): attention of the
// roped query q[b, h, i] over the keys at logical columns 0..pos[b] + i of
// row b, where logical page j lives at physical page table[b, j] of the pools
// [n_pages, H, page, D].  Scores are f32 (q·k, times the key scale of an
// int8/fp8 pool, then times `scale`, masked to -1e30 past the column); an
// online softmax keeps m, l and acc in f32; the weights are multiplied by the
// value scale (quantized pools) and rounded to q's type before P·V.  Rows
// with active[b] == 0 read nothing and write zeros.
//
// What bounds it on an H100: the bytes of the live pages it reads.  A decode
// step does about 4·D flops per key byte pair, far below the ~295 flops per
// byte where bf16 tensor cores become the limit, so the time is the K/V
// bytes of pages 0..last over 3.35 TB/s.  Prefill with many query rows per
// block reuses each page QT times and moves towards the flop side.
//
// What the design does about it:
//  * one block per (query-row tile, head, row); the block reads its own
//    page-table row, pos and active flag (a TPU kernel had them in scalar
//    prefetch) and walks pages 0..last only, where last is the page of the
//    tile's highest visible column, so pages past a row's high-water mark
//    are never read (no gathered copy of the table exists at any point);
//  * query rows are tiled (QT = 16; 1 for decode): the JAX kernel kept the
//    whole [S, D] f32 accumulator of a prefill in VMEM, which at S = 2048 is
//    1 MB, far over the 227 KB of shared memory a Hopper block may use;
//  * every pool element is read once per tile with 8-element vector loads
//    (16 bytes of bf16, 8 of int8/fp8) and dequantized on the way into
//    shared memory; scales ride beside their page;
//  * a decode step has few (row, head) pairs, 32 blocks for 8 slots x 4
//    heads on a card of 132 SMs, so the wrapper may split each row's live
//    pages into n_splits ranges, one block each, writing unnormalized partials
//    (acc, m, l) that a second small kernel merges (split-KV, as in
//    flash-decoding); the card then reads the live pages with ~8x more
//    blocks in flight.
// Decode and short verify windows run on the CUDA cores in f32; a bf16
// prefill of more than 16 query rows runs both products on the tensor cores
// (mma.sync, below).  wgmma tiles fed by TMA are later work.
#include <type_traits>

#include "attn_common.cuh"

namespace {

using dtdl::Tile;

constexpr int kThreads = 128;

struct PagedArgs {
  const void* q;          // [B, H, S, D] T
  const void* pages_k;    // [n_pages, H, page, D] kv_kind
  const void* pages_v;
  const void* key_scale;  // [n_pages, H, page] scale_kind, or null
  const void* value_scale;
  const int32_t* table;   // [B, n_ptab]
  const int32_t* pos;     // [B]
  const int32_t* active;  // [B]
  void* out;              // [B, H, S, D] T
  float* part_acc;        // [B, H, S, n_splits, D] f32 when n_splits > 1
  float* part_ml;         // [B, H, S, n_splits, 2] f32 (m, l)
  int B, H, S, n_ptab, page, kc, kv_kind, scale_kind, n_splits;
  float scale;
};

// Pages per split of a row whose live pages are 0..last: an even share of
// the live pages (not of the table), rounded up to whole key chunks.
__device__ __forceinline__ int split_pages(const PagedArgs& a, int last) {
  const int chunk_pages = a.kc / a.page;
  const int per = (last + a.n_splits) / a.n_splits;
  return (per + chunk_pages - 1) / chunk_pages * chunk_pages;
}

template <typename T, int D, int QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const PagedArgs a) {
  extern __shared__ float smem[];
  using TileT = Tile<D, QT, kThreads>;
  TileT tile(smem, a.kc);

  const int split = blockIdx.x % a.n_splits;
  const int b = blockIdx.z, h = blockIdx.y, r0 = (blockIdx.x / a.n_splits) * QT;
  const int rows = min(QT, a.S - r0);
  float acc[TileT::DPT];
#pragma unroll
  for (int j = 0; j < TileT::DPT; ++j) acc[j] = 0.f;
  tile.init_stats();

  // this block's keys: its split's pages, up to the tile's last live page;
  // an inactive row reads nothing (and comes out as zeros)
  const int pos = a.pos[b];
  const int last = min(max((pos + r0 + rows - 1) / a.page, 0), a.n_ptab - 1);
  const int per = split_pages(a, last);
  const int k_begin = split * per * a.page;
  const int k_end = a.active[b] == 0 ? 0 : min((last + 1) * a.page, (split + 1) * per * a.page);
  const int32_t* trow = a.table + size_t(b) * a.n_ptab;
  const bool quant = a.key_scale != nullptr;

  // query tile (already roped by the caller) into shared memory
  const T* q = static_cast<const T*>(a.q) + ((size_t(b) * a.H + h) * a.S + r0) * D;
  for (int e = threadIdx.x; e < QT * D; e += kThreads)
    tile.Qs[e] = e < rows * D ? dtdl::to_f32<T>(q[e]) : 0.f;

  for (int c0 = k_begin; c0 < k_end; c0 += a.kc) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < a.kc * (D / 8); e += kThreads) {
      const int k = e / (D / 8), d0 = (e - k * (D / 8)) * 8;
      const int key = c0 + k;
      float kv[8], vv[8];
      if (key < k_end) {
        const int phys = trow[key / a.page];
        const size_t el = ((size_t(phys) * a.H + h) * a.page + key % a.page) * D + d0;
        dtdl::load8(a.pages_k, el, a.kv_kind, kv);
        dtdl::load8(a.pages_v, el, a.kv_kind, vv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // a quantized pool dequantizes to q's type first (k.astype(dtype));
        // int8 and e4m3 values are exact in bf16, so this is a no-op there
        tile.Ks[k * TileT::KSTRIDE + d0 + i] = dtdl::round_to<T>(kv[i]);
        tile.Vs[k * D + d0 + i] = dtdl::round_to<T>(vv[i]);
      }
    }
    // key scales go through the score epilogue, value scales into VSc
    for (int k = threadIdx.x; k < a.kc; k += kThreads) {
      float ks = 0.f, vs = 0.f;
      const int key = c0 + k;
      if (quant && key < k_end) {
        const int phys = trow[key / a.page];
        const size_t el = (size_t(phys) * a.H + h) * a.page + key % a.page;
        ks = dtdl::load_scalar(a.key_scale, el, a.scale_kind);
        vs = dtdl::load_scalar(a.value_scale, el, a.scale_kind);
      }
      tile.KSc[k] = ks;
      tile.VSc[k] = vs;
    }
    __syncthreads();
    // the key scale multiplies the f32 logits before `scale` and the mask
    const int qpos0 = pos + r0;
    tile.scores(a.kc, rows, [&](int r, int k, float dot) {
      const int col = c0 + k;
      const float s = quant ? dot * tile.KSc[k] : dot;
      return (col <= qpos0 + r && col < k_end) ? s * a.scale : dtdl::kMaskFill;
    });
    __syncthreads();
    tile.template softmax<T>(a.kc, rows, quant);
    __syncthreads();
    tile.pv(a.kc, rows, acc);
  }
  __syncthreads();
  const size_t row0 = (size_t(b) * a.H + h) * a.S + r0;
  if (a.n_splits == 1) {
    tile.template store<T>(static_cast<T*>(a.out) + row0 * D, rows, acc);
    return;
  }
  const int r = threadIdx.x / TileT::TPR, lane = threadIdx.x % TileT::TPR;
  if (r < rows) {  // this split's unnormalized partial for the merge
    const size_t slot = (row0 + r) * a.n_splits + split;
#pragma unroll
    for (int j = 0; j < TileT::DPT; ++j)
      if (lane + j * TileT::TPR < D) a.part_acc[slot * D + lane + j * TileT::TPR] = acc[j];
    if (lane == 0) {
      a.part_ml[slot * 2] = tile.M[r];
      a.part_ml[slot * 2 + 1] = tile.L[r];
    }
  }
}

// Merge the splits of one query row: m = max m_j, l = sum l_j·e^(m_j - m),
// o = sum acc_j·e^(m_j - m) / l (l == 0 -> 0).  One block per row, one
// thread per dimension.
template <typename T>
__global__ void paged_merge_kernel(const float* part_acc, const float* part_ml, T* out,
                                   int n_splits, int D) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * n_splits * 2;
  float m = dtdl::kMaskFill;
  for (int j = 0; j < n_splits; ++j) m = fmaxf(m, ml[2 * j]);
  float l = 0.f, o = 0.f;
  for (int j = 0; j < n_splits; ++j) {
    const float w = expf(ml[2 * j] - m);
    l += ml[2 * j + 1] * w;
    o += part_acc[(row * n_splits + j) * D + d] * w;
  }
  out[row * D + d] = dtdl::from_f32<T>(o / (l == 0.f ? 1.f : l));
}

// ---- bf16 prefill on the tensor cores ---------------------------------------
//
// The same walk for a bf16 query of more than 16 rows, with both products on
// the tensor cores (mma.sync m16n8k16, as csrc/flash_fwd.cu): 64 query rows
// per block, 16 per warp, key chunks of 64 (whole pages).  Pool elements of
// any kind are widened and rounded to bf16 on the way into shared memory
// (exact for bf16, int8 and e4m3), the key scale multiplies the f32 scores
// and the value scale the weights before their bf16 rounding, as above.

constexpr int kMmaRows = 64;
constexpr int kMmaKeys = 64;
constexpr int kPad = 8;

template <int D>
__device__ void stage_pages(__nv_bfloat16* dst, const void* pool, int kind, const int32_t* trow,
                            int h, int H, int page, int c0, int k_end) {
  constexpr int G = D / 8;
  for (int e = threadIdx.x; e < kMmaKeys * G; e += kThreads) {
    const int k = e / G, d = (e - k * G) * 8;
    const int key = c0 + k;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (key < k_end) {
      float f[8];
      const int phys = trow[key / page];
      dtdl::load8(pool, ((size_t(phys) * H + h) * page + key % page) * D + d, kind, f);
      v.x = dtdl::pack_bf16(f[0], f[1]);
      v.y = dtdl::pack_bf16(f[2], f[3]);
      v.z = dtdl::pack_bf16(f[4], f[5]);
      v.w = dtdl::pack_bf16(f[6], f[7]);
    }
    *reinterpret_cast<uint4*>(dst + k * (D + kPad) + d) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(const PagedArgs a) {
  constexpr int LD = D + kPad, KS = D / 16, ND = D / 8, NT = kMmaKeys / 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);   // [64][LD]
  __nv_bfloat16* Ks = Qs + kMmaRows * LD;                            // [64][LD]
  __nv_bfloat16* Vs = Ks + kMmaKeys * LD;                            // [64][LD]
  float* KSc = reinterpret_cast<float*>(Vs + kMmaKeys * LD);          // [64]
  float* VSc = KSc + kMmaKeys;                                        // [64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int split = blockIdx.x % a.n_splits;
  const int b = blockIdx.z, h = blockIdx.y, r0 = (blockIdx.x / a.n_splits) * kMmaRows;
  const int rows = min(kMmaRows, a.S - r0);
  const int pos = a.pos[b];
  const int last = min(max((pos + r0 + rows - 1) / a.page, 0), a.n_ptab - 1);
  const int per = split_pages(a, last);
  const int k_begin = split * per * a.page;
  const int k_end = a.active[b] == 0 ? 0 : min((last + 1) * a.page, (split + 1) * per * a.page);
  const int32_t* trow = a.table + size_t(b) * a.n_ptab;
  const bool quant = a.key_scale != nullptr;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + ((size_t(b) * a.H + h) * a.S + r0) * D;
  for (int e = threadIdx.x; e < kMmaRows * (D / 8); e += kThreads) {
    const int r = e / (D / 8), d = (e - r * (D / 8)) * 8;
    const uint4 v = r < rows ? *reinterpret_cast<const uint4*>(q + r * D + d)
                             : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(Qs + r * LD + d) = v;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* q0 = Qs + (wr + g) * LD + ks * 16 + tig * 2;
    qf[ks][0] = dtdl::ld32(q0);
    qf[ks][1] = dtdl::ld32(q0 + 8 * LD);
    qf[ks][2] = dtdl::ld32(q0 + 8);
    qf[ks][3] = dtdl::ld32(q0 + 8 * LD + 8);
  }
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_r[2] = {dtdl::kMaskFill, dtdl::kMaskFill};
  float l_r[2] = {0.f, 0.f};
  const int qrow = r0 + wr + g;   // query rows qrow and qrow + 8 of this thread

  for (int c0 = k_begin; c0 < k_end; c0 += kMmaKeys) {
    __syncthreads();
    stage_pages<D>(Ks, a.pages_k, a.kv_kind, trow, h, a.H, a.page, c0, k_end);
    stage_pages<D>(Vs, a.pages_v, a.kv_kind, trow, h, a.H, a.page, c0, k_end);
    for (int k = threadIdx.x; k < kMmaKeys; k += kThreads) {
      float ks = 0.f, vs = 0.f;
      const int key = c0 + k;
      if (quant && key < k_end) {
        const int phys = trow[key / a.page];
        const size_t el = (size_t(phys) * a.H + h) * a.page + key % a.page;
        ks = dtdl::load_scalar(a.key_scale, el, a.scale_kind);
        vs = dtdl::load_scalar(a.value_scale, el, a.scale_kind);
      }
      KSc[k] = ks;
      VSc[k] = vs;
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* k0 = Ks + (nt * 8 + g) * LD + tig * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        dtdl::mma_16816(sc[nt], qf[ks], dtdl::ld32(k0 + ks * 16), dtdl::ld32(k0 + ks * 16 + 8));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = nt * 8 + tig * 2 + (j & 1);
        const int col = c0 + k;
        const float s = quant ? sc[nt][j] * KSc[k] : sc[nt][j];
        const bool visible = col <= pos + qrow + (j >> 1) * 8 && col < k_end;
        sc[nt][j] = visible ? s * a.scale : dtdl::kMaskFill;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = dtdl::kMaskFill;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float alpha = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(sc[nt][2 * r + j] - m_new);
          sum += p;
          sc[nt][2 * r + j] = quant ? p * VSc[nt * 8 + tig * 2 + j] : p;
        }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][2 * r] *= alpha;
        o[nd][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {dtdl::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              dtdl::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              dtdl::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              dtdl::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const uint32_t vrow = dtdl::smem_addr(Vs + (kk * 16 + lane % 16) * LD);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(vrow + nd * 8 * 2));
        dtdl::mma_16816(o[nd], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int i = qrow + 8 * r;
    if (i >= a.S) continue;
    const size_t row = (size_t(b) * a.H + h) * a.S + i;
    if (a.n_splits == 1) {
      const float l_safe = l == 0.f ? 1.f : l;
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.out) + row * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + tig * 2) =
            __floats2bfloat162_rn(o[nd][2 * r] / l_safe, o[nd][2 * r + 1] / l_safe);
    } else {
      const size_t slot = row * a.n_splits + split;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        a.part_acc[slot * D + nd * 8 + tig * 2] = o[nd][2 * r];
        a.part_acc[slot * D + nd * 8 + tig * 2 + 1] = o[nd][2 * r + 1];
      }
      if (tig == 0) {
        a.part_ml[slot * 2] = m_r[r];
        a.part_ml[slot * 2 + 1] = l;
      }
    }
  }
}

template <typename T>
int merge(const PagedArgs& a, int D, cudaStream_t stream) {
  paged_merge_kernel<T><<<size_t(a.B) * a.H * a.S, D, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.n_splits, D);
  return int(cudaGetLastError());
}

template <int D>
int launch_mma(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * size_t(kMmaRows + 2 * kMmaKeys) * (D + kPad) +
                      sizeof(float) * 2 * kMmaKeys;
  auto kernel = paged_attention_mma_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows * a.n_splits, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return int(err);
  return merge<__nv_bfloat16>(a, D, stream);
}

template <typename T, int D, int QT>
int launch(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = Tile<D, QT, kThreads>::smem_bytes(a.kc);
  auto kernel = paged_attention_kernel<T, D, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((a.S + QT - 1) / QT * a.n_splits, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return int(err);
  return merge<T>(a, D, stream);
}

// decode: one query row per block; a bf16 prefill of more than 16 rows on
// the tensor cores (when a key chunk is 64 keys of whole pages); the rest
// 16 rows per block on the CUDA cores
template <typename T, int D>
int launch_rows(const PagedArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (a.S > 16 && a.kc == kMmaKeys) return launch_mma<D>(a, stream);
  return a.S == 1 ? launch<T, D, 1>(a, stream) : launch<T, D, 16>(a, stream);
}

template <typename T>
int launch_dim(const PagedArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_rows<T, 16>(a, stream);
    case 32: return launch_rows<T, 32>(a, stream);
    case 64: return launch_rows<T, 64>(a, stream);
    case 128: return launch_rows<T, 128>(a, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_kind: 0 f32, 1 bf16.  kv_kind: 0 f32, 1 bf16, 2 int8, 3 fp8 e4m3 (bytes).
// scale_kind: 0 f32, 1 bf16 (ignored without scales).  n_splits > 1 splits
// each row's live pages into that many ranges, with the partials in the
// caller's scratch part_acc [B·H·S·n_splits·D] and part_ml [B·H·S·n_splits·2]
// (f32).  Returns a cudaError_t.
extern "C" int dtdl_paged_attention(const void* q, const void* pages_k, const void* pages_v,
                                    const void* key_scale, const void* value_scale,
                                    const void* table, const void* pos, const void* active,
                                    void* out, void* part_acc, void* part_ml, int B, int H,
                                    int S, int D, int n_ptab, int page, int q_kind, int kv_kind,
                                    int scale_kind, int n_splits, float scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || n_ptab < 1 || page < 1 || page > 256 || n_splits < 1 ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return int(cudaErrorInvalidValue);
  PagedArgs a;
  a.q = q;
  a.pages_k = pages_k;
  a.pages_v = pages_v;
  a.key_scale = key_scale;
  a.value_scale = value_scale;
  a.table = static_cast<const int32_t*>(table);
  a.pos = static_cast<const int32_t*>(pos);
  a.active = static_cast<const int32_t*>(active);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.n_splits = n_splits;
  a.B = B;
  a.H = H;
  a.S = S;
  a.n_ptab = n_ptab;
  a.page = page;
  a.kc = page >= 64 ? page : page * (64 / page);  // whole pages per key chunk
  a.kv_kind = kv_kind;
  a.scale_kind = scale_kind;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_kind == dtdl::kBF16 ? launch_dim<__nv_bfloat16>(a, D, s) : launch_dim<float>(a, D, s);
}
