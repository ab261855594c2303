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
// What bounds it on an H100: the bytes of the live pages it reads, and at
// the serving shapes the latency of reading them.  A decode step does about
// 4·D flops per key byte pair, far below the ~295 flops per byte where bf16
// tensor cores become the limit; its ~10 MB (8 rows x 4 heads x ~600 keys x
// 128 x 2 bytes x 2 pools) take 3 us at 3.35 TB/s, so launches and
// dependent memory round trips, not bandwidth, set its time.  Prefill with
// many query rows per block reuses each page 64 times and moves towards the
// flop side.
//
// What the design does about it:
//  * one block per (split, query-row tile, head, row); the block reads its
//    own page-table row, pos and active flag (a TPU kernel had them in
//    scalar prefetch) and walks pages 0..last only, where last is the page
//    of the tile's highest visible column, so pages past a row's high-water
//    mark are never read (no gathered copy of the table exists at any
//    point);
//  * the page stream (bf16 queries): one (physical page, head) slab of a
//    pool is contiguous, page·D elements, 4 KB at page 16, D 128 in bf16.
//    Each slab of K and of V (or a run of whole keys of it, at most 8 KB)
//    is one cp.async.bulk global-to-shared copy that completes on an
//    mbarrier, with no tensor map.  Copies are issued ahead, so the pages
//    of a block are in flight together and their round trips overlap.  The
//    pool keeps its own type in shared memory (int8/fp8 stay bytes) and is
//    dequantized in registers; the per-key scales are ordinary loads;
//  * decode and short verify (bf16 q, S <= 16): a block takes 1 (decode) or
//    4 query rows, held in registers.  Each warp takes every fourth unit of
//    the block's range with its own ring of stages; D/16 lanes split a key's
//    dimensions, so a warp works on 512/D keys at once, and each such lane
//    group keeps its own online softmax (m, l, acc).  The groups' and the
//    warps' states are merged once, at the end of the block's range;
//  * split-KV in one launch: a decode step has few (row, head) pairs, 32
//    blocks for 8 slots x 4 heads on a card of 132 SMs, so the wrapper may
//    split each row's live pages into n_splits ranges, one block each
//    (flash-decoding).  Each block writes its unnormalized partial (acc, m,
//    l) and arrives on a per-(row, head, query tile) counter in the
//    wrapper's scratch; the last block to arrive merges the splits, writes
//    the output and resets the counter to 0, so the next call finds it
//    clean.  Empty splits arrive too;
//  * prefill (bf16 q, S > 16, pages that tile 64 keys): both products on the
//    tensor cores (mma.sync m16n8k16), 64 query rows per block; the page
//    stream fills a two-stage ring of raw 64-key chunks, widened to padded
//    bf16 tiles in shared memory, so the next chunk's pages load while this
//    chunk's products run.  wgmma tiles for it are later work;
//  * f32 queries (the crosscheck engine): the CUDA cores in f32, 1 or 16
//    query rows per block, loads synchronous (attn_common.cuh Tile).
#include <type_traits>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

namespace hopper = dtdl::hopper;
using dtdl::kMaskFill;
using dtdl::Tile;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kSlabBytes = 8192;         // at most this many bytes of one pool per streamed unit
constexpr int kRingBytes = 32 * 1024;    // the decode body's ring, at most
constexpr int kMaxSplits = 32;           // split-KV ranges, at most

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
  int* counters;          // [B, H, S] arrivals, all 0 between calls
  int B, H, S, n_ptab, page, kc, kv_kind, scale_kind, n_splits;
  int unit;               // keys per streamed unit (a divisor of page)
  int stages;             // decode body: ring stages per warp
  float scale;
};

// The live pages [p0, p1) of this block's split: an even share of the row's
// live pages 0..last (not of the table), rounded up to whole chunks of
// `chunk` pages; empty for an inactive row.
__device__ __forceinline__ void split_range(const PagedArgs& a, int b, int last, int chunk,
                                            int split, int& p0, int& p1) {
  const int per = ((last + a.n_splits) / a.n_splits + chunk - 1) / chunk * chunk;
  p0 = split * per;
  p1 = a.active[b] == 0 ? p0 : max(p0, min(last + 1, p0 + per));
}

// A split block's end, after it wrote the partials of its `rows` query rows
// (from row0 of [B·H·S]): the last block of the tile to arrive merges the
// splits and resets the tile's counter.  It first takes each row's weights
// w_j = e^(m_j - m) / l with m = max m_j, l = sum l_j·e^(m_j - m) (l == 0 ->
// weights 0), then o = sum acc_j·w_j, four dimensions a thread, the loads of
// all splits in flight together.  Every thread of the block calls it; `wts`
// ([rows][n_splits] f32) is the kernel's dynamic shared memory, which the
// block no longer reads, so the kernels declare no static shared memory.
template <typename T, int D>
__device__ void merge_splits(const PagedArgs& a, size_t row0, int rows, float* wts) {
  __threadfence();   // this block's partials are visible before it arrives
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    int* counter = a.counters + row0;
    last = atomicAdd(counter, 1) == a.n_splits - 1;
    if (last) atomicExch(counter, 0);   // every split has arrived
  }
  if (!__syncthreads_or(last)) return;
  __threadfence();
  const int ns = a.n_splits;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* ml = a.part_ml + (row0 + r) * ns * 2;
    float* w = wts + r * ns;
    float m = kMaskFill;
    for (int j = 0; j < ns; ++j) m = fmaxf(m, __ldcg(ml + 2 * j));
    float l = 0.f;
    for (int j = 0; j < ns; ++j) {
      w[j] = expf(__ldcg(ml + 2 * j) - m);
      l += __ldcg(ml + 2 * j + 1) * w[j];
    }
    const float inv = l == 0.f ? 0.f : 1.f / l;
    for (int j = 0; j < ns; ++j) w[j] *= inv;
  }
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * (D / 4); e += blockDim.x) {
    const int r = e / (D / 4), d = (e - r * (D / 4)) * 4;
    const size_t row = row0 + r;
    const float4* src = reinterpret_cast<const float4*>(a.part_acc + row * ns * D + d);
    const float* w = wts + r * ns;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < ns; ++j) {
      const float4 x = __ldcg(src + j * (D / 4));
      o[0] = fmaf(x.x, w[j], o[0]);
      o[1] = fmaf(x.y, w[j], o[1]);
      o[2] = fmaf(x.z, w[j], o[2]);
      o[3] = fmaf(x.w, w[j], o[3]);
    }
    T* out = static_cast<T*>(a.out) + row * D + d;
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = dtdl::from_f32<T>(o[i]);
  }
}

// Opt a kernel in to `smem` bytes of dynamic shared memory where they pass
// the default 48 KB, with room for what ptxas reserves beside them.
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem + 1024 <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

// ---- f32 queries: the CUDA cores ---------------------------------------------

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
  int p0, p1;
  split_range(a, b, last, a.kc / a.page, split, p0, p1);
  const int k_begin = p0 * a.page, k_end = p1 * a.page;
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
      return (col <= qpos0 + r && col < k_end) ? s * a.scale : kMaskFill;
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
  merge_splits<T, D>(a, row0, rows, smem);
}

// ---- bf16 decode and short verify: the page stream ---------------------------

constexpr int kVerifyRows = 4;   // query rows per block when S > 1

template <int D, int QT, int KIND>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const PagedArgs a) {
  constexpr int EL = KIND == dtdl::kBF16 ? 2 : 1;   // bytes of a pool element
  constexpr int LPK = D / 16;                       // lanes per key
  constexpr int KPW = 32 / LPK;                     // keys per warp at once
  constexpr int NK = QT == 1 ? 4 : 2;               // keys per lane group per step
  extern __shared__ __align__(128) unsigned char dec_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPK, sub = lane % LPK;
  const int d0 = sub * 8, d1 = D / 2 + sub * 8;     // this lane's two 8-dimension pieces

  const int split = blockIdx.x % a.n_splits;
  const int b = blockIdx.z, h = blockIdx.y, r0 = (blockIdx.x / a.n_splits) * QT;
  const int rows = min(QT, a.S - r0);
  const int pos = a.pos[b];
  const int last = min(max((pos + r0 + rows - 1) / a.page, 0), a.n_ptab - 1);
  int p0, p1;
  split_range(a, b, last, 1, split, p0, p1);
  const int upp = a.page / a.unit;                  // units per page
  const int u0 = p0 * upp, n_units = (p1 - p0) * upp;
  const int32_t* trow = a.table + size_t(b) * a.n_ptab;
  const int R = a.stages;
  const uint32_t slab = uint32_t(a.unit) * D * EL;  // bytes of one unit of one pool
  const bool quant = a.key_scale != nullptr;

  // shared memory: the ring [warp][stage]{K unit, V unit}, the ring's
  // barriers, then the warps' states [warp][QT] (m, l) and [warp][QT][D] acc
  const uint32_t ring = hopper::saddr(dec_smem);
  const uint32_t bars = ring + 4 * R * 2 * slab;
  float* red_ml = reinterpret_cast<float*>(dec_smem + 4 * R * (2 * slab + 8));
  float* red_acc = red_ml + 4 * QT * 2;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4 * R; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // this warp's units: warp, warp + 4, ...; unit i goes to stage i % R
  const int n_mine = n_units > warp ? (n_units - warp + 3) / 4 : 0;
  auto issue = [&](int i) {
    const int u = u0 + warp + 4 * i;
    const int phys = trow[u / upp];
    const size_t e0 = ((size_t(phys) * a.H + h) * a.page + (u % upp) * a.unit) * D;
    const int st = warp * R + i % R;
    hopper::mbar_expect_tx(bars + 8 * st, 2 * slab);
    hopper::bulk_load(ring + st * 2 * slab, static_cast<const unsigned char*>(a.pages_k) + e0 * EL,
                      slab, bars + 8 * st);
    hopper::bulk_load(ring + st * 2 * slab + slab,
                      static_cast<const unsigned char*>(a.pages_v) + e0 * EL, slab,
                      bars + 8 * st);
  };
  if (lane == 0)
    for (int i = 0; i < min(R, n_mine); ++i) issue(i);

  // the query rows (already roped by the caller), this lane's dimensions
  float q[QT][16];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    if (r < rows) {
      const size_t e = ((size_t(b) * a.H + h) * a.S + r0 + r) * D;
      dtdl::load8(a.q, e + d0, dtdl::kBF16, q[r]);
      dtdl::load8(a.q, e + d1, dtdl::kBF16, q[r] + 8);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) q[r][i] = 0.f;
    }
  }
  float m[QT], l[QT], acc[QT][16];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    m[r] = kMaskFill;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[r][i] = 0.f;
  }

  for (int i = 0; i < n_mine; ++i) {
    const int u = u0 + warp + 4 * i;
    const int c0 = u * a.unit;   // logical column of the unit's first key
    const size_t sc0 = (size_t(trow[u / upp]) * a.H + h) * a.page + (u % upp) * a.unit;
    const int st = warp * R + i % R;
    const unsigned char* kst = dec_smem + st * 2 * slab;
    const unsigned char* vst = kst + slab;
    hopper::mbar_wait(bars + 8 * st, (i / R) & 1);
    for (int kb = 0; kb < a.unit; kb += KPW * NK) {
      float s[QT][NK], vsc[NK];
      bool have[NK];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int key = kb + n * KPW + grp;   // this lane group's key in the unit
        have[n] = key < a.unit;
        float kf[16];
        if (have[n]) {
          dtdl::load8(kst, size_t(key) * D + d0, KIND, kf);
          dtdl::load8(kst, size_t(key) * D + d1, KIND, kf + 8);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) kf[e] = 0.f;
        }
        float ksc = 1.f;
        vsc[n] = 1.f;
        if (quant && have[n]) {
          ksc = dtdl::load_scalar(a.key_scale, sc0 + key, a.scale_kind);
          vsc[n] = dtdl::load_scalar(a.value_scale, sc0 + key, a.scale_kind);
        }
#pragma unroll
        for (int r = 0; r < QT; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) dot = fmaf(q[r][e], kf[e], dot);
#pragma unroll
          for (int o = 1; o < LPK; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          // the key scale multiplies the f32 logits before `scale` and the mask
          const int col = c0 + key;
          s[r][n] = !have[n] ? -INFINITY
                             : (col <= pos + r0 + r ? (quant ? dot * ksc : dot) * a.scale
                                                    : kMaskFill);
        }
      }
      // one online-softmax step of this lane group: new max, the weights
      // summed into l unrounded, then times the value scale and rounded to
      // bf16 for P·V, as the JAX kernels cast p before their second matmul
      float pw[QT][NK];
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < NK; ++n) mx = fmaxf(mx, s[r][n]);
        const float alpha = __expf(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float p = have[n] ? __expf(s[r][n] - mx) : 0.f;
          sum += p;
          pw[r][n] = dtdl::round_to<bf16>(p * vsc[n]);
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[r][e] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        if (!have[n]) continue;
        const int key = kb + n * KPW + grp;
        float vf[16];
        dtdl::load8(vst, size_t(key) * D + d0, KIND, vf);
        dtdl::load8(vst, size_t(key) * D + d1, KIND, vf + 8);
#pragma unroll
        for (int r = 0; r < QT; ++r)
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[r][e] = fmaf(pw[r][n], vf[e], acc[r][e]);
      }
    }
    __syncwarp();   // every lane is done with the stage
    if (lane == 0 && i + R < n_mine) {
      hopper::fence_proxy_async();
      issue(i + R);
    }
  }

  // merge the warp's lane groups, then the warps through shared memory
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float wa = __expf(m[r] - mn), wb = __expf(mo - mn);
      l[r] = l[r] * wa + lo * wb;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        acc[r][e] = acc[r][e] * wa + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * wb;
    }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      float* ar = red_acc + (warp * QT + r) * D;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ar[d0 + e] = acc[r][e];
        ar[d1 + e] = acc[r][8 + e];
      }
      if (sub == 0) {
        red_ml[(warp * QT + r) * 2] = m[r];
        red_ml[(warp * QT + r) * 2 + 1] = l[r];
      }
    }
  }
  __syncthreads();
  const size_t row0 = (size_t(b) * a.H + h) * a.S + r0;
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float mb = kMaskFill;
#pragma unroll
    for (int w = 0; w < 4; ++w) mb = fmaxf(mb, red_ml[(w * QT + r) * 2]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = __expf(red_ml[(w * QT + r) * 2] - mb);
      lb += red_ml[(w * QT + r) * 2 + 1] * wt;
      ab += red_acc[(w * QT + r) * D + d] * wt;
    }
    const size_t row = row0 + r;
    if (a.n_splits == 1) {
      static_cast<bf16*>(a.out)[row * D + d] = __float2bfloat16(ab / (lb == 0.f ? 1.f : lb));
    } else {   // this split's unnormalized partial for the merge
      const size_t slot = row * a.n_splits + split;
      a.part_acc[slot * D + d] = ab;
      if (d == 0) {
        a.part_ml[slot * 2] = mb;
        a.part_ml[slot * 2 + 1] = lb;
      }
    }
  }
  if (a.n_splits > 1) merge_splits<bf16, D>(a, row0, rows, reinterpret_cast<float*>(dec_smem));
}

template <int D, int QT, int KIND>
int launch_decode(const PagedArgs& a, cudaStream_t stream) {
  constexpr int EL = KIND == dtdl::kBF16 ? 2 : 1;
  const size_t smem = size_t(4) * a.stages * (2 * size_t(a.unit) * D * EL + 8) +
                      sizeof(float) * 4 * QT * (D + 2);
  auto kernel = paged_decode_kernel<D, QT, KIND>;
  if (const int err = opt_in(kernel, smem)) return err;
  const dim3 grid((a.S + QT - 1) / QT * a.n_splits, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int D, int QT>
int launch_decode_kind(const PagedArgs& a, cudaStream_t stream) {
  switch (a.kv_kind) {
    case dtdl::kBF16: return launch_decode<D, QT, dtdl::kBF16>(a, stream);
    case dtdl::kInt8: return launch_decode<D, QT, dtdl::kInt8>(a, stream);
    case dtdl::kFp8E4M3: return launch_decode<D, QT, dtdl::kFp8E4M3>(a, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// ---- bf16 prefill on the tensor cores ---------------------------------------
//
// A bf16 query of more than 16 rows, pages that tile a 64-key chunk: both
// products on the tensor cores (mma.sync m16n8k16), 64 query rows per block,
// 16 per warp.  The first thread streams each chunk's pages (one bulk copy
// per slab of K and of V) into a two-stage ring of raw chunks, two chunks
// ahead; the threads widen a chunk (any pool type) to bf16 tiles of padded
// rows, exact for bf16, int8 and e4m3, and run the products on them while
// the next chunk lands.  The key scale multiplies the f32 scores and the
// value scale the weights before their bf16 rounding, as above.

constexpr int kMmaRows = 64;
constexpr int kMmaKeys = 64;
constexpr int kPad = 8;

template <int D>
struct PrefillSmem {   // byte offsets from a 128-byte aligned base
  static constexpr int LD = D + kPad;
  static constexpr int kRawPool = kMmaKeys * D * 2;   // one pool's chunk at 2 bytes an element
  static constexpr int kRaw = 0;                      // [stage]{K, V}
  static constexpr int kQs = 2 * 2 * kRawPool;        // [64][LD] bf16
  static constexpr int kKs = kQs + kMmaRows * LD * 2;
  static constexpr int kVs = kKs + kMmaKeys * LD * 2;
  static constexpr int kScales = kVs + kMmaKeys * LD * 2;   // KSc[64], VSc[64] f32
  static constexpr int kBars = kScales + 2 * kMmaKeys * 4;
  static constexpr int kBytes = kBars + 2 * 8 + 128;  // + alignment slack
};

// keys [c0, c0 + 64) of a raw chunk (any pool type) into a padded bf16
// tile; keys at or past k_end are zeros
template <int D>
__device__ void widen_chunk(bf16* dst, const unsigned char* raw, int kind, int c0, int k_end) {
  constexpr int G = D / 8;
  for (int e = threadIdx.x; e < kMmaKeys * G; e += kThreads) {
    const int k = e / G, d = (e - k * G) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c0 + k < k_end) {
      float f[8];
      dtdl::load8(raw, size_t(k) * D + d, kind, f);
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
paged_prefill_kernel(const PagedArgs a) {
  using L = PrefillSmem<D>;
  constexpr int LD = L::LD, KS = D / 16, ND = D / 8, NT = kMmaKeys / 8;
  extern __shared__ __align__(128) unsigned char pre_smem[];
  unsigned char* sm = pre_smem + ((128 - hopper::saddr(pre_smem) % 128) % 128);
  const uint32_t sbase = hopper::saddr(sm);
  bf16* Qs = reinterpret_cast<bf16*>(sm + L::kQs);
  bf16* Ks = reinterpret_cast<bf16*>(sm + L::kKs);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::kVs);
  float* KSc = reinterpret_cast<float*>(sm + L::kScales);
  float* VSc = KSc + kMmaKeys;
  const uint32_t bars = sbase + L::kBars;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int split = blockIdx.x % a.n_splits;
  const int b = blockIdx.z, h = blockIdx.y, r0 = (blockIdx.x / a.n_splits) * kMmaRows;
  const int rows = min(kMmaRows, a.S - r0);
  const int pos = a.pos[b];
  const int last = min(max((pos + r0 + rows - 1) / a.page, 0), a.n_ptab - 1);
  int p0, p1;
  split_range(a, b, last, kMmaKeys / a.page, split, p0, p1);
  const int k_begin = p0 * a.page, k_end = p1 * a.page;
  const int n_chunks = (k_end - k_begin + kMmaKeys - 1) / kMmaKeys;
  const int32_t* trow = a.table + size_t(b) * a.n_ptab;
  const bool quant = a.key_scale != nullptr;
  const int el = a.kv_kind == dtdl::kBF16 ? 2 : 1;
  const uint32_t slab = uint32_t(a.page) * D * el;   // one page of one pool

  // chunk t's live pages into raw stage t % 2: one bulk copy per slab
  auto issue = [&](int t) {
    const int c0 = k_begin + t * kMmaKeys, s = t % 2;
    const int np = (min(k_end, c0 + kMmaKeys) - c0) / a.page;
    const uint32_t rk = sbase + L::kRaw + s * 2 * L::kRawPool, rv = rk + L::kRawPool;
    hopper::mbar_expect_tx(bars + 8 * s, 2 * np * slab);
    for (int j = 0; j < np; ++j) {
      const size_t src = (size_t(trow[c0 / a.page + j]) * a.H + h) * slab;
      hopper::bulk_load(rk + j * slab, static_cast<const unsigned char*>(a.pages_k) + src, slab,
                        bars + 8 * s);
      hopper::bulk_load(rv + j * slab, static_cast<const unsigned char*>(a.pages_v) + src, slab,
                        bars + 8 * s);
    }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    hopper::mbar_init(bars + 8, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < min(2, n_chunks); ++t) issue(t);

  const bf16* q = static_cast<const bf16*>(a.q) + ((size_t(b) * a.H + h) * a.S + r0) * D;
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
    const bf16* q0 = Qs + (wr + g) * LD + ks * 16 + tig * 2;
    qf[ks][0] = dtdl::ld32(q0);
    qf[ks][1] = dtdl::ld32(q0 + 8 * LD);
    qf[ks][2] = dtdl::ld32(q0 + 8);
    qf[ks][3] = dtdl::ld32(q0 + 8 * LD + 8);
  }
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_r[2] = {kMaskFill, kMaskFill};
  float l_r[2] = {0.f, 0.f};
  const int qrow = r0 + wr + g;   // query rows qrow and qrow + 8 of this thread

  for (int t = 0; t < n_chunks; ++t) {
    const int c0 = k_begin + t * kMmaKeys, s = t % 2;
    const unsigned char* raw = sm + L::kRaw + s * 2 * L::kRawPool;
    __syncthreads();   // the previous chunk's fragment loads are done
    hopper::mbar_wait(bars + 8 * s, (t / 2) & 1);
    widen_chunk<D>(Ks, raw, a.kv_kind, c0, k_end);
    widen_chunk<D>(Vs, raw + L::kRawPool, a.kv_kind, c0, k_end);
    for (int k = threadIdx.x; k < kMmaKeys; k += kThreads) {
      float ks = 0.f, vs = 0.f;
      const int key = c0 + k;
      if (quant && key < k_end) {
        const int phys = trow[key / a.page];
        const size_t el_s = (size_t(phys) * a.H + h) * a.page + key % a.page;
        ks = dtdl::load_scalar(a.key_scale, el_s, a.scale_kind);
        vs = dtdl::load_scalar(a.value_scale, el_s, a.scale_kind);
      }
      KSc[k] = ks;
      VSc[k] = vs;
    }
    __syncthreads();
    // the raw stage is free: refill it with the chunk after next
    if (threadIdx.x == 0 && t + 2 < n_chunks) {
      hopper::fence_proxy_async();
      issue(t + 2);
    }

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const bf16* k0 = Ks + (nt * 8 + g) * LD + tig * 2;
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
        sc[nt][j] = visible ? s * a.scale : kMaskFill;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kMaskFill;
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
      const uint32_t vrow = hopper::saddr(Vs + (kk * 16 + lane % 16) * LD);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        dtdl::ldmatrix_trans_x2(b0, b1, vrow, nd * 8 * 2);
        dtdl::mma_16816(o[nd], pa, b0, b1);
      }
    }
  }
  const size_t row0 = (size_t(b) * a.H + h) * a.S + r0;
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
      bf16* orow = static_cast<bf16*>(a.out) + row * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + tig * 2) =
            __floats2bfloat162_rn(o[nd][2 * r] / l_safe, o[nd][2 * r + 1] / l_safe);
    } else {   // this split's unnormalized partial for the merge
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
  if (a.n_splits > 1) merge_splits<bf16, D>(a, row0, rows, reinterpret_cast<float*>(sm));
}

template <int D>
int launch_prefill(const PagedArgs& a, cudaStream_t stream) {
  const int smem = PrefillSmem<D>::kBytes;
  auto kernel = paged_prefill_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows * a.n_splits, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T, int D, int QT>
int launch(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = Tile<D, QT, kThreads>::smem_bytes(a.kc);
  auto kernel = paged_attention_kernel<T, D, QT>;
  if (const int err = opt_in(kernel, smem)) return err;
  const dim3 grid((a.S + QT - 1) / QT * a.n_splits, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// bf16 queries: decode and verify windows of up to 16 rows stream their
// pages; a longer prefill runs on the tensor cores when a key chunk is 64
// keys of whole pages, else 16 rows per block on the CUDA cores.  f32
// queries: one query row per block for decode, 16 otherwise.
template <typename T, int D>
int launch_rows(const PagedArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (a.S == 1) return launch_decode_kind<D, 1>(a, stream);
    if (a.S <= 16) return launch_decode_kind<D, kVerifyRows>(a, stream);
    if (a.kc == kMmaKeys) return launch_prefill<D>(a, stream);
    return launch<T, D, 16>(a, stream);
  }
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

// q_kind: 0 f32, 1 bf16.  kv_kind: 0 f32, 1 bf16, 2 int8, 3 fp8 e4m3 (bytes);
// a bf16 query takes a bf16, int8 or fp8 pool, whose base is 16-byte
// aligned (the bulk copies).  scale_kind: 0 f32, 1 bf16 (ignored without
// scales).  n_splits (1..32) > 1 splits each row's live pages into that many ranges,
// with the partials in the caller's scratch part_acc [B·H·S·n_splits·D] and
// part_ml [B·H·S·n_splits·2] (f32) and the arrival counters [B·H·S] (int32,
// zero before the first call; each call leaves them zero).  Returns a
// cudaError_t.
extern "C" int dtdl_paged_attention(const void* q, const void* pages_k, const void* pages_v,
                                    const void* key_scale, const void* value_scale,
                                    const void* table, const void* pos, const void* active,
                                    void* out, void* part_acc, void* part_ml, void* counters,
                                    int B, int H, int S, int D, int n_ptab, int page, int q_kind,
                                    int kv_kind, int scale_kind, int n_splits, float scale,
                                    void* stream) {
  if (B < 1 || H < 1 || S < 1 || n_ptab < 1 || page < 1 || page > 256 || n_splits < 1 ||
      n_splits > kMaxSplits ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  const int el = kv_kind == dtdl::kF32 ? 4 : kv_kind == dtdl::kBF16 ? 2 : 1;
  if (q_kind == dtdl::kBF16 &&
      (el == 4 || (size_t(page) * D * el) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(pages_k) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(pages_v) % 16 != 0))
    return int(cudaErrorInvalidValue);   // the bulk copies' size and alignment rules
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
  a.counters = static_cast<int*>(counters);
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
  // the stream's unit: the whole page slab, or the largest run of whole
  // keys of it within kSlabBytes; enough stages per warp that a split's
  // units are all in flight (ceil(n_ptab / n_splits) pages bound a split),
  // within kRingBytes
  int unit = page;
  while (size_t(unit) * D * el > kSlabBytes) {
    do --unit;
    while (page % unit != 0);
  }
  a.unit = unit;
  const int units = (n_ptab + n_splits - 1) / n_splits * (page / unit);
  const int fit = kRingBytes / (8 * unit * D * el);
  a.stages = max(1, min((units + 3) / 4, fit));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_kind == dtdl::kBF16 ? launch_dim<bf16>(a, D, s) : launch_dim<float>(a, D, s);
}
