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
//  * the page stream (bf16 decode and verify): one (physical page, head) slab of a
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
//  * prefill and chunk windows (bf16 q, S > 16, a page of a multiple of 8
//    keys that divides 64): warp-specialised, 64 query rows per block.  A
//    producer warpgroup loads Q and each 64-key tile by TMA, one box per
//    (physical page, head) from the block's page-table row, straight into
//    the swizzled layout wgmma reads (a quantized pool's byte boxes are
//    widened there by the producer warpgroup), through a two-stage
//    mbarrier ring; the consumer warpgroup runs both products as wgmma
//    (Q·Kᵀ from shared memory, P·V with P from registers) around the f32
//    online softmax.  Slots past the range are zeros, never stale; the
//    split rule counts this body's 64-row tiles (ops/paged_attention.py
//    kv_splits).  Other page sizes take the CUDA-core body below;
//  * f32 queries (the crosscheck engine), and bf16 prefill over other page
//    sizes: the CUDA cores in f32, 1 or 16 query rows per block, loads
//    synchronous (attn_common.cuh Tile).
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
  int B, H, S, n_pages, n_ptab, page, kc, kv_kind, scale_kind, n_splits;
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

// ---- bf16 prefill: TMA page boxes into warp-specialised wgmma ---------------
//
// A bf16 query of more than 16 rows over pages of a multiple of 8 keys that
// divides the 64-key tile.  One block per (split, 64 query rows, head, row):
// warpgroup 0 consumes, warpgroup 1 produces.  The producer's first warp
// reads each tile's physical pages from the block's own page-table row a
// tile ahead (a table load issued behind a copy would wait out its round
// trip), and its first thread loads the Q tile, then each key tile of
// kPreKeys keys as kPreKeys / page boxes of one (physical page, head)
// each, landing where one 64-row box would have (a page is a whole number
// of 8-row swizzle atoms), through a ring of kPreStages stages (full
// barrier: the tile is in; empty barrier: the 4 consumer warps are done
// with it).  A slot past the block's range gets a box wholly out of
// bounds, which TMA fills with zeros, so no stale or NaN value meets P·V.
// The consumer warpgroup runs S = Q·Kᵀ as wgmma from shared memory, the key
// scale, `scale` and the mask as a select (on tiles that cross a row's
// column or the range's end), the f32 online softmax in the log2 domain,
// the weights times the value scale rounded to bf16, and O += P·V as wgmma
// with P from registers and V read MN-major (flash_fwd.cu's layouts).
// A quantized pool (int8, fp8) lands by byte boxes and bulk-copied scale
// rows in a raw ring of kRawStages; the producer warpgroup widens each raw
// tile to the swizzled bf16 tile (exact: int8 and e4m3 values are bf16
// values) and its scales to f32, zeros past the range, off the consumers'
// path.  Registers are not rebalanced: a bf16 pool's block (80 KB at D 128)
// runs two to an SM within 128 registers a thread, a quantized one (114 KB)
// one to an SM.

constexpr int kPreRows = 64;     // query rows a block (one consumer warpgroup)
constexpr int kPreKeys = 64;     // keys a tile
constexpr int kPreStages = 2;    // bf16 K/V ring depth
constexpr int kRawStages = 2;    // quantized pools: raw byte ring depth
constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kPreThreads = 2 * kWG;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, bool QUANT>
struct WgSmem {   // byte offsets from a 1024-byte aligned base
  static constexpr int kQBytes = kPreRows * D * 2, kTileBytes = kPreKeys * D * 2;
  static constexpr int kRawBytes = kPreKeys * D;                 // one pool's raw tile
  static constexpr int kScBytes = QUANT ? 2 * kPreKeys * 4 : 0;  // {KSc, VSc}[64] f32 or raw
  static constexpr int kQ = 0, kK = kQBytes, kV = kK + kPreStages * kTileBytes;
  static constexpr int kSc = kV + kPreStages * kTileBytes;       // [stage] widened scales
  static constexpr int kRaw = kSc + kPreStages * kScBytes;       // [raw stage]{K, V}
  static constexpr int kRawSc = kRaw + (QUANT ? kRawStages * 2 * kRawBytes : 0);
  static constexpr int kBars = kRawSc + (QUANT ? kRawStages * kScBytes : 0);
  // q_full, full[s], empty[s], raw_full[r]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kPreStages + kRawStages) + 1024;
};

// Raw tile r (any pool type) into stage tile `dst` as swizzled bf16, its
// scales into f32; keys at or past k_end (slots no page filled) are zeros.
// The 128 threads of the producer warpgroup take part.
template <int D, int KIND>
__device__ void widen_tile(unsigned char* dst_k, unsigned char* dst_v, float* ksc, float* vsc,
                           const unsigned char* raw_k, const unsigned char* raw_v,
                           const unsigned char* raw_ks, const unsigned char* raw_vs,
                           int scale_kind, int c0, int k_end, int pt) {
  using C = hopper::Cols<D>;
  constexpr int G = D / 8;
  for (int e = pt; e < kPreKeys * G; e += kWG) {
    const int k = e / G, d = (e - k * G) * 8;
    const uint32_t off = (d / C::kBox) * kPreKeys * C::kRowBytes +
                         hopper::swizzled(k, d % C::kBox, C::kRowBytes);
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (c0 + k < k_end) {
      float f[8];
      dtdl::load8(raw_k, size_t(k) * D + d, KIND, f);
      kv = make_uint4(dtdl::pack_bf16(f[0], f[1]), dtdl::pack_bf16(f[2], f[3]),
                      dtdl::pack_bf16(f[4], f[5]), dtdl::pack_bf16(f[6], f[7]));
      dtdl::load8(raw_v, size_t(k) * D + d, KIND, f);
      vv = make_uint4(dtdl::pack_bf16(f[0], f[1]), dtdl::pack_bf16(f[2], f[3]),
                      dtdl::pack_bf16(f[4], f[5]), dtdl::pack_bf16(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(dst_k + off) = kv;
    *reinterpret_cast<uint4*>(dst_v + off) = vv;
  }
  for (int k = pt; k < kPreKeys; k += kWG) {
    const bool live = c0 + k < k_end;
    ksc[k] = live ? dtdl::load_scalar(raw_ks, k, scale_kind) : 0.f;
    vsc[k] = live ? dtdl::load_scalar(raw_vs, k, scale_kind) : 0.f;
  }
}

template <int D, int KIND>
__global__ void __launch_bounds__(kPreThreads, KIND == dtdl::kBF16 ? 2 : 1)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const PagedArgs a) {
  constexpr bool QUANT = KIND != dtdl::kBF16;
  constexpr int KT = kPreKeys;
  using C = hopper::Cols<D>;
  using L = WgSmem<D, QUANT>;
  constexpr int RB = C::kRowBytes;
  extern __shared__ unsigned char pre_smem[];
  const uint32_t base = (hopper::saddr(pre_smem) + 1023) & ~1023u;
  unsigned char* sm = pre_smem + (base - hopper::saddr(pre_smem));
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kPreStages;
  const uint32_t raw0 = empty0 + 8 * kPreStages;

  const int split = blockIdx.x % a.n_splits;
  const int b = blockIdx.z, h = blockIdx.y, r0 = (blockIdx.x / a.n_splits) * kPreRows;
  const int rows = min(kPreRows, a.S - r0);
  const int pos = a.pos[b];
  const int last = min(max((pos + r0 + rows - 1) / a.page, 0), a.n_ptab - 1);
  int p0, p1;
  split_range(a, b, last, KT / a.page, split, p0, p1);
  const int k_begin = p0 * a.page, k_end = p1 * a.page;
  const int n_tiles = (k_end - k_begin + KT - 1) / KT;
  const int32_t* trow = a.table + size_t(b) * a.n_ptab;
  const int qbh = b * a.H + h;
  const size_t row0 = size_t(qbh) * a.S + r0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kPreStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 4);   // one arrival per consumer warp
    }
    for (int r = 0; r < kRawStages; ++r) hopper::mbar_init(raw0 + 8 * r, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWG) {
    // ---- producer warpgroup ----
    const int pt = threadIdx.x - kWG;
    if (pt == 0 && n_tiles > 0) {
      hopper::mbar_expect_tx(q_full, L::kQBytes);
      for (int cb = 0; cb < C::kBlocks; ++cb)
        hopper::tma_load(base + L::kQ + cb * kPreRows * RB, &tq, q_full, cb * C::kBox, r0, qbh);
    }
    // lane j of the first producer warp: the physical page of tile t's
    // page j, or -1 past the range (loaded a tile ahead, so the table's
    // round trip overlaps the ring's waits instead of each copy's issue)
    const int ppt = KT / a.page;   // pages a tile
    auto tile_pages = [&](int t) {
      const int key = k_begin + t * KT + pt * a.page;
      return t < n_tiles && pt < ppt && key < k_end ? trow[key / a.page] : -1;
    };
    if constexpr (!QUANT) {
      // one warp: each tile's page boxes straight into the swizzled stage
      if (pt < 32) {
        int next = tile_pages(0);
        for (int t = 0; t < n_tiles; ++t) {
          const int s = t % kPreStages, cur = next;
          next = tile_pages(t + 1);
          hopper::mbar_wait(empty0 + 8 * s, ((t / kPreStages) & 1) ^ 1);
          if (pt == 0) hopper::mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
          const uint32_t kt = base + L::kK + s * L::kTileBytes;
          const uint32_t vt = base + L::kV + s * L::kTileBytes;
          for (int j = 0; j < ppt; ++j) {
            const int phys = __shfl_sync(0xffffffffu, cur, j);
            // a slot past the range gets a box wholly past its page: zeros
            const int bh = phys < 0 ? 0 : phys * a.H + h;
            const int row = phys < 0 ? a.page : 0;
            if (pt == 0)
              for (int cb = 0; cb < C::kBlocks; ++cb) {
                const uint32_t off = cb * KT * RB + j * a.page * RB;
                hopper::tma_load(kt + off, &tk, full0 + 8 * s, cb * C::kBox, row, bh);
                hopper::tma_load(vt + off, &tv, full0 + 8 * s, cb * C::kBox, row, bh);
              }
          }
        }
      }
    } else {
      // tile t's live pages (byte boxes) and their scale rows into raw
      // stage t % kRawStages; the first warp calls it, its first thread copies
      const int el_s = a.scale_kind == dtdl::kBF16 ? 2 : 4;
      const uint32_t sbytes = uint32_t(a.page) * el_s;
      auto issue = [&](int t, int pages) {
        const int r = t % kRawStages, c0 = k_begin + t * KT;
        const int np = (min(k_end, c0 + KT) - c0) / a.page;
        const uint32_t rk = base + L::kRaw + r * 2 * L::kRawBytes, rv = rk + L::kRawBytes;
        const uint32_t rks = base + L::kRawSc + r * L::kScBytes, rvs = rks + KT * 4;
        if (pt == 0) hopper::mbar_expect_tx(raw0 + 8 * r, np * (2 * a.page * D + 2 * sbytes));
        for (int j = 0; j < np; ++j) {
          const int bh = __shfl_sync(0xffffffffu, pages, j) * a.H + h;
          if (pt != 0) continue;
          hopper::tma_load(rk + j * a.page * D, &tk, raw0 + 8 * r, 0, 0, bh);
          hopper::tma_load(rv + j * a.page * D, &tv, raw0 + 8 * r, 0, 0, bh);
          const size_t so = size_t(bh) * sbytes;
          hopper::bulk_load(rks + j * sbytes, static_cast<const unsigned char*>(a.key_scale) + so,
                            sbytes, raw0 + 8 * r);
          hopper::bulk_load(rvs + j * sbytes,
                            static_cast<const unsigned char*>(a.value_scale) + so, sbytes,
                            raw0 + 8 * r);
        }
      };
      if (pt < 32)
        for (int t = 0; t < min(kRawStages, n_tiles); ++t) issue(t, tile_pages(t));
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kPreStages, r = t % kRawStages;
        const int ahead = pt < 32 ? tile_pages(t + kRawStages) : -1;
        const unsigned char* rk = sm + L::kRaw + r * 2 * L::kRawBytes;
        const unsigned char* rks = sm + L::kRawSc + r * L::kScBytes;
        float* sc = reinterpret_cast<float*>(sm + L::kSc + s * L::kScBytes);
        hopper::mbar_wait(raw0 + 8 * r, (t / kRawStages) & 1);
        hopper::mbar_wait(empty0 + 8 * s, ((t / kPreStages) & 1) ^ 1);
        widen_tile<D, KIND>(sm + L::kK + s * L::kTileBytes, sm + L::kV + s * L::kTileBytes, sc,
                            sc + KT, rk, rk + L::kRawBytes, rks, rks + KT * 4, a.scale_kind,
                            k_begin + t * KT, k_end, pt);
        hopper::fence_proxy_async();   // the widened tile is visible to wgmma
        hopper::named_sync(1, kWG);    // every producer thread is done with raw stage r
        if (pt == 0) hopper::mbar_arrive(full0 + 8 * s);
        if (pt < 32 && t + kRawStages < n_tiles) issue(t + kRawStages, ahead);
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows ----
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int row_a = warp * 16 + g;   // tile rows of regs 4j, 4j+1; +8 for 4j+2, 4j+3
    float o[D / 2], sc[KT / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    float m_r[2] = {kMaskFill, kMaskFill};   // row maxima, log2 domain
    float l_r[2] = {0.f, 0.f};   // this thread's share of the row sums
    const float sl2 = a.scale * kLog2e;
    const uint32_t qa = base + L::kQ;
    if (n_tiles > 0) hopper::mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kPreStages, c0 = k_begin + t * KT;
      const uint32_t kt = base + L::kK + s * L::kTileBytes;
      const uint32_t vt = base + L::kV + s * L::kTileBytes;
      hopper::mbar_wait(full0 + 8 * s, (t / kPreStages) & 1);

      // S = Q·Kᵀ over D in k steps of 16: column block ks / kSteps, 32 bytes a step
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int cb = ks / C::kSteps, kin = (ks % C::kSteps) * 32;
        const uint64_t da = hopper::make_desc(qa + cb * kPreRows * RB + kin, 16, 8 * RB, RB);
        const uint64_t db = hopper::make_desc(kt + cb * KT * RB + kin, 16, 8 * RB, RB);
        hopper::wgmma_ss<KT>(sc, da, db, ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // the key scale multiplies the f32 score before `scale`, taken with
      // log2(e): the softmax runs in the log2 domain (one ex2 a weight).
      // The mask, a select, only on a tile that crosses its first row's
      // column or the range's end
      const float* ksc = reinterpret_cast<const float*>(sm + L::kSc + s * L::kScBytes);
      const bool edge = c0 + KT > k_end || c0 + KT - 1 > pos + r0;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = j * 8 + tig * 2 + (i & 1), col = c0 + k;
          const float x = (QUANT ? sc[4 * j + i] * ksc[k] : sc[4 * j + i]) * sl2;
          const bool visible = !edge || (col <= pos + r0 + row_a + (i >> 1) * 8 && col < k_end);
          sc[4 * j + i] = visible ? x : kMaskFill;
        }
      // online softmax: two rows per thread, each spread over 4 lanes; the
      // weights enter l unscaled, then times the value scale for P·V.  A
      // masked key weighs 2^(-1e30 - m) = 0, or 1 while its row has seen
      // no key (m is the fill), as the plain softmax weights them
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[r];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = dtdl::ex2(m_r[r] - mx);
        m_r[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = dtdl::ex2(sc[4 * j + 2 * r + e] - mx);
            sum += p;
            sc[4 * j + 2 * r + e] = QUANT ? p * ksc[KT + j * 8 + tig * 2 + e] : p;
          }
        l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * r] *= alpha;
          o[4 * j + 2 * r + 1] *= alpha;
        }
      }
      // O += P·V: the S accumulator of keys 16kk..16kk+15 is the A fragment
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          pa[kk][f] = dtdl::pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint64_t db = hopper::make_desc(vt + kk * 16 * RB, KT * RB, 8 * RB, RB);
        hopper::wgmma_rs<D>(o, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
    }

    // the row sums over the row's 4 lanes; o / l, or this split's partial
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int i = row_a + 8 * r;
      if (i >= rows) continue;
      const size_t row = row0 + i;
      if (a.n_splits == 1) {
        const float l_safe = l == 0.f ? 1.f : l;
        bf16* orow = static_cast<bf16*>(a.out) + row * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / l_safe, o[4 * j + 2 * r + 1] / l_safe);
      } else {
        const size_t slot = row * a.n_splits + split;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(a.part_acc + slot * D + j * 8 + tig * 2) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (tig == 0) {   // the merge takes m in the natural log's units
          a.part_ml[slot * 2] = m_r[r] == kMaskFill ? kMaskFill : m_r[r] * kLn2;
          a.part_ml[slot * 2 + 1] = l;
        }
      }
    }
  }
  // both warpgroups: the split merge's weights reuse the Q tile's bytes
  if (a.n_splits > 1) merge_splits<bf16, D>(a, row0, rows, reinterpret_cast<float*>(sm));
}

template <int D, int KIND>
int launch_prefill(const PagedArgs& a, cudaStream_t stream) {
  using C = hopper::Cols<D>;
  CUtensorMap tq, tk, tv;   // encoded per call, passed by value as grid constants
  int err = hopper::encode_rows(&tq, a.q, a.B * a.H, a.S, D, kPreRows, C::kBox);
  const int bh = a.n_pages * a.H;   // the pools seen as [n_pages·H, page, D]
  if constexpr (KIND == dtdl::kBF16) {
    if (err == 0) err = hopper::encode_rows(&tk, a.pages_k, bh, a.page, D, a.page, C::kBox);
    if (err == 0) err = hopper::encode_rows(&tv, a.pages_v, bh, a.page, D, a.page, C::kBox);
  } else {
    if (err == 0) err = hopper::encode_bytes(&tk, a.pages_k, bh, a.page, D, a.page);
    if (err == 0) err = hopper::encode_bytes(&tv, a.pages_v, bh, a.page, D, a.page);
  }
  if (err != 0) return err;
  constexpr int smem = WgSmem<D, KIND != dtdl::kBF16>::kBytes;
  auto kernel = paged_prefill_wgmma_kernel<D, KIND>;
  if (const int attr = opt_in(kernel, smem)) return attr;
  const dim3 grid((a.S + kPreRows - 1) / kPreRows * a.n_splits, a.H, a.B);
  kernel<<<grid, kPreThreads, smem, stream>>>(tq, tk, tv, a);
  return int(cudaGetLastError());
}

template <int D>
int launch_prefill_kind(const PagedArgs& a, cudaStream_t stream) {
  switch (a.kv_kind) {
    case dtdl::kBF16: return launch_prefill<D, dtdl::kBF16>(a, stream);
    case dtdl::kInt8: return launch_prefill<D, dtdl::kInt8>(a, stream);
    case dtdl::kFp8E4M3: return launch_prefill<D, dtdl::kFp8E4M3>(a, stream);
    default: return int(cudaErrorInvalidValue);
  }
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
// pages; a longer prefill runs the wgmma body when a page is a multiple of
// 8 keys that divides the 64-key tile, else 16 rows per block on the CUDA
// cores.  f32 queries: one query row per block for decode, 16 otherwise.
template <typename T, int D>
int launch_rows(const PagedArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (a.S == 1) return launch_decode_kind<D, 1>(a, stream);
    if (a.S <= 16) return launch_decode_kind<D, kVerifyRows>(a, stream);
    if (a.page % 8 == 0 && kPreKeys % a.page == 0) return launch_prefill_kind<D>(a, stream);
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
// a bf16 query takes a bf16, int8 or fp8 pool of n_pages pages, whose base
// and scales' bases are 16-byte aligned (the bulk copies and tensor maps).  scale_kind: 0 f32, 1 bf16 (ignored without
// scales).  n_splits (1..32) > 1 splits each row's live pages into that many ranges,
// with the partials in the caller's scratch part_acc [B·H·S·n_splits·D] and
// part_ml [B·H·S·n_splits·2] (f32) and the arrival counters [B·H·S] (int32,
// zero before the first call; each call leaves them zero).  Returns a
// cudaError_t.
extern "C" int dtdl_paged_attention(const void* q, const void* pages_k, const void* pages_v,
                                    const void* key_scale, const void* value_scale,
                                    const void* table, const void* pos, const void* active,
                                    void* out, void* part_acc, void* part_ml, void* counters,
                                    int B, int H, int S, int D, int n_pages, int n_ptab, int page,
                                    int q_kind, int kv_kind, int scale_kind, int n_splits,
                                    float scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || n_pages < 1 || n_ptab < 1 || page < 1 || page > 256 ||
      n_splits < 1 ||
      n_splits > kMaxSplits ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  const int el = kv_kind == dtdl::kF32 ? 4 : kv_kind == dtdl::kBF16 ? 2 : 1;
  if (q_kind == dtdl::kBF16 &&
      (el == 4 || (size_t(page) * D * el) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(pages_k) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(pages_v) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(key_scale) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(value_scale) % 16 != 0))
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
  a.n_pages = n_pages;
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
