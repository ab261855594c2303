// Flash-attention backward with fused rope: kernels K2 (dq) and K3 (dk, dv).
//
// Replaces: dtdl_tpu/ops/attention.py:_bwd_dq_kernel (K2) and _bwd_dkv_kernel
// (K3), both launched by _bwd, the Pallas TPU backward of flash_attention
// (the causal-LM training step: one K2 and one K3 launch per layer).
//
// What they compute, per b·h, from the forward's residuals q, k, v, its lse
// [B·H, Sq] f32 and delta = rowsum(dO∘O) [B·H, Sq] f32 (computed outside, as
// attention.py:554 does):
//   s = q·kᵀ·scale (masked to -1e30 above the bottom-aligned causal diagonal,
//   off = Sk - Sq), p = exp(s - lse), dp = dO·vᵀ, ds = p∘(dp - delta)·scale;
//   K2: dq = ds·k;  K3: dk = dsᵀ·q, dv = pᵀ·dO.
// ds and p are rounded to the input type before their products, as the JAX
// kernels cast them; products accumulate in f32.  With rope tables, q and k
// are the rotated rows (f32, rounded back, as flash_fwd.cu) and dq / dk,
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
// K2 runs one block per (q tile, b·h) that loops over key tiles up to the
// causal diagonal; K3 one block per (key tile, b·h) that loops over q chunks
// from the first one that reaches its keys (the TPU's sequential grid axis
// becomes the loop).  Both recompute s and dp, so the pair does 14·S²·D
// flops per head where FlashAttention-2's atomic dq does 10.  The S x S
// matrices never leave the block.  The bodies:
//  * bf16, both: warp-specialised wgmma on TMA tiles (the sections below).
//    A producer warpgroup streams tiles through a two-stage full/empty
//    mbarrier ring while two consumer warpgroups run all products as wgmma,
//    with the scores and the probabilities kept in registers and rounded to
//    bf16 as the register A operand of the second products; masks only on
//    tiles that cross the causal diagonal or a ragged end.  K2 holds 128 q
//    rows and dq in registers and streams the keys; K3 holds 128 keys and
//    dk, dv and streams the q rows, in the transposed frame (rows are keys,
//    columns q rows: sᵀ = k·qᵀ, dpᵀ = v·dOᵀ), so no operand is re-laid out
//    in registers.  Both take q and k already rotated by the rope pre-pass
//    (rope_rows.cu, run once for the pair by ops/attention.py flash_bwd);
//    the tables serve the inverse rotation of dq and dk only;
//  * f32, both: FMA on the CUDA cores (16 rows per block), rotating q and k
//    on load, as flash_fwd.cu's f32 body.
// Rows that see no key at all (causal with Sq > Sk) have lse = -1e30, so
// p = 1 against every masked key, as in the plain version; a tile holding
// such a row walks every key (K2), and K3 then starts at the first q chunk.
#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

namespace hopper = dtdl::hopper;
using dtdl::kMaskFill;
using dtdl::pack_bf16;
using dtdl::rope_rows;
using dtdl::unrotate_pair;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;

struct BwdArgs {
  const void* q;     // [BH, Sq, D] T: f32 unrotated, bf16 rotated
  const void* k;     // [BH, Sk, D] T: likewise
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

// ---- bf16: wgmma on TMA tiles, warp-specialised ---------------------------

constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kWsThreads = 3 * kWG;      // consumers 0, 1; producer 2
constexpr int kStages = 2;               // depth of the streamed-tile ring
constexpr float kLog2e = 1.4426950408889634f;

// Inverse rope on a warpgroup's flat f32 accumulator (the wgmma layout:
// rows row_a and row_a + 8, columns 8j + 2·tig (+1) in d[4j..4j+3]) and the
// bf16 store of its rows below n; dimension d and d + D/2 sit in blocks j
// and j + D/16 of one thread.
template <int D>
__device__ __forceinline__ void store_acc(bf16* out, float (&acc)[D / 2], int row_a, int n,
                                          int tig, const float* c, const float* s) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n) continue;
    if (c != nullptr) {
      const float* cr = c + size_t(row) * D;
      const float* sr = s + size_t(row) * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = j * 8 + tig * 2 + e;
          unrotate_pair(acc[4 * j + 2 * r + e], acc[4 * (j + D / 16) + 2 * r + e], cr[d], sr[d],
                        cr[d + D / 2], sr[d + D / 2]);
        }
    }
    bf16* orow = out + size_t(row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// K2, bf16.  One block per (128 q rows, b·h), the last (causal: heaviest)
// first.  Warpgroups 0 and 1 are consumers of 64 q rows each and hold dq for
// them in registers; warpgroup 2 is the producer.  Its first thread loads the
// block's Q and dO tiles once by TMA and then streams the K and V tiles of BN
// keys through the ring (K3's scheme with the roles of q and k swapped).
// Each consumer thread reads the lse·log2(e) and delta of its two rows once,
// into registers.  A consumer computes s = Q·Kᵀ and dp = dO·Vᵀ with wgmma
// (all operands K-major in shared memory), p = exp2(s·scale·log2(e) −
// lse·log2(e)) and ds = p∘(dp − delta)·scale in registers, then dq += ds·K
// with wgmma, ds rounded to bf16 as the register A operand and K read
// MN-major from the same tile, as K1 reads V.  Keys past Sk get p = 0.  dq
// gets the inverse rope at the store, once per row.
constexpr int kDqRows = 128;             // q rows per block
constexpr int kDqKeys = 128;             // keys per streamed tile

template <int D, int BN>
struct DqSmem {   // byte offsets from a 1024-byte aligned base
  static constexpr int kQBytes = kDqRows * D * 2, kTileBytes = BN * D * 2;
  static constexpr int kQ = 0, kDO = kQBytes, kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;   // q_full, full[s], empty[s]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;   // + alignment slack
};

template <int D, int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const BwdArgs a) {
  using C = hopper::Cols<D>;
  using L = DqSmem<D, BN>;
  constexpr int RB = C::kRowBytes;
  extern __shared__ unsigned char dq_smem[];
  const uint32_t base = (hopper::saddr(dq_smem) + 1023) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 * (1 + kStages);

  const int bh = blockIdx.y, r0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int rows = min(kDqRows, a.Sq - r0);
  const int off = a.Sk - a.Sq;
  // keys past kend sit above the diagonal for every row of the tile, unless
  // a row of it sees no key at all: then the tile walks every key
  const int kend = (a.causal && r0 + off >= 0) ? min(a.Sk, r0 + rows + off) : a.Sk;
  const int n_tiles = (kend + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG, lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 2 * kWG) {
      hopper::mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int cb = 0; cb < C::kBlocks; ++cb) {
        hopper::tma_load(base + L::kQ + cb * kDqRows * RB, &tq, q_full, cb * C::kBox, r0, bh);
        hopper::tma_load(base + L::kDO + cb * kDqRows * RB, &tdo, q_full, cb * C::kBox, r0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        hopper::mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full0 + 8 * s, 2 * L::kTileBytes);
        const uint32_t kt = base + L::kK + s * L::kTileBytes;
        const uint32_t vt = base + L::kV + s * L::kTileBytes;
        for (int cb = 0; cb < C::kBlocks; ++cb) {
          hopper::tma_load(kt + cb * BN * RB, &tk, full0 + 8 * s, cb * C::kBox, t * BN, bh);
          hopper::tma_load(vt + cb * BN * RB, &tv, full0 + 8 * s, cb * C::kBox, t * BN, bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    hopper::regs_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, tig = lane % 4;
    const int wr0 = r0 + wg * 64;            // this warpgroup's first row
    const int row_a = wr0 + warp * 16 + g;   // rows of regs 4j, 4j+1; +8 for 4j+2, 4j+3
    const float sl2 = a.scale * kLog2e;
    const float fill2 = __fmul_rn(kMaskFill, kLog2e);   // == lse·log2(e) of a row that sees no key
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // rows past Sq: q and dO are zero-filled, so ds = 0
      const int row = row_a + 8 * r;
      const bool live = row < a.Sq;
      lse2[r] = live ? __fmul_rn(a.lse[size_t(bh) * a.Sq + row], kLog2e) : 0.f;
      dlt[r] = live ? a.delta[size_t(bh) * a.Sq + row] : 0.f;
    }
    float dq[D / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
    const uint32_t qa = base + L::kQ + wg * 64 * RB, oa = base + L::kDO + wg * 64 * RB;
    hopper::mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, c0 = t * BN;
      const uint32_t kt = base + L::kK + s * L::kTileBytes;
      const uint32_t vt = base + L::kV + s * L::kTileBytes;
      hopper::mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      // s = Q·Kᵀ and dp = dO·Vᵀ over D in k steps of 16
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int cb = ks / C::kSteps, kin = (ks % C::kSteps) * 32;
        hopper::wgmma_ss<BN>(sc, hopper::make_desc(qa + cb * kDqRows * RB + kin, 16, 8 * RB, RB),
                             hopper::make_desc(kt + cb * BN * RB + kin, 16, 8 * RB, RB), ks > 0);
        hopper::wgmma_ss<BN>(dp, hopper::make_desc(oa + cb * kDqRows * RB + kin, 16, 8 * RB, RB),
                             hopper::make_desc(vt + cb * BN * RB + kin, 16, 8 * RB, RB), ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // ds in place of s; the mask only on a tile that crosses the diagonal
      // (for this warpgroup's rows) or the ragged end of the keys
      const bool edge = c0 + BN > a.Sk || (a.causal && c0 + BN - 1 > wr0 + off);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          float p;
          if (edge) {
            const int col = c0 + j * 8 + tig * 2 + (i & 1);
            const bool visible = !a.causal || col <= row_a + 8 * r + off;
            p = col < a.Sk ? exp2f((visible ? sc[4 * j + i] * sl2 : fill2) - lse2[r]) : 0.f;
          } else {
            p = exp2f(sc[4 * j + i] * sl2 - lse2[r]);
          }
          sc[4 * j + i] = __fmul_rn(__fmul_rn(p, dp[4 * j + i] - dlt[r]), a.scale);
        }
      // dq += ds·K: keys 16kk..16kk+15 are one k step; every A fragment is
      // packed before the fence, so no register the products read is
      // written while they run
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) da[kk][f] = pack_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::wgmma_rs<D>(dq, da[kk], hopper::make_desc(kt + kk * 16 * RB, BN * RB, 8 * RB, RB),
                            1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
    }
    store_acc<D>(static_cast<bf16*>(a.dq) + size_t(bh) * a.Sq * D, dq, row_a, a.Sq, tig, a.qc,
                 a.qs);
  }
}

template <int D, int BN>
int launch_dq_wgmma(const BwdArgs& a, cudaStream_t stream) {
  using C = hopper::Cols<D>;
  CUtensorMap tq, tdo, tk, tv;
  int err = hopper::encode_rows(&tq, a.q, a.BH, a.Sq, D, kDqRows, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tdo, a.dO, a.BH, a.Sq, D, kDqRows, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tk, a.k, a.BH, a.Sk, D, BN, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tv, a.v, a.BH, a.Sk, D, BN, C::kBox);
  if (err != 0) return err;
  const int smem = DqSmem<D, BN>::kBytes;
  auto kernel = bwd_dq_wgmma_kernel<D, BN>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((a.Sq + kDqRows - 1) / kDqRows, a.BH);
  kernel<<<grid, kWsThreads, smem, stream>>>(tq, tdo, tk, tv, a);
  return int(cudaGetLastError());
}

// K3, bf16: wgmma on TMA tiles, warp-specialised.  One block per (128 keys,
// b·h), the first (causal: heaviest) first, in the transposed frame: score
// tiles are [keys, q rows].  Warpgroups 0 and 1 are consumers of 64 keys
// each and hold dk and dv for them in registers; warpgroup 2 is the
// producer.  Its first thread loads the K and V tiles once and then streams
// 64-row chunks of the rotated q and of dO by TMA through a two-stage
// mbarrier ring; its second warp writes each chunk's lse·log2(e) and delta
// into shared memory beside them and arrives on the same full barrier.  A
// consumer computes sᵀ = K·Qᵀ and dpᵀ = V·dOᵀ with wgmma (all operands
// K-major in shared memory), pᵀ = exp2(sᵀ·scale·log2(e) − lse·log2(e)) and
// dsᵀ = pᵀ∘(dpᵀ − delta)·scale in registers, then dv += pᵀ·dO and
// dk += dsᵀ·Q with wgmma, pᵀ and dsᵀ rounded to bf16 as the register A
// operand and dO and Q read MN-major.  Masks are computed only on chunks
// that cross the causal diagonal or a ragged end.  dk gets the inverse rope
// at the store, once per key row.
constexpr int kBK = 128;                 // keys per block
constexpr int kBQ = 64;                  // q rows per chunk

template <int D>
struct DkvSmem {   // byte offsets from a 1024-byte aligned base
  static constexpr int kTileBytes = kBK * D * 2, kChunkBytes = kBQ * D * 2;
  static constexpr int kK = 0, kV = kTileBytes, kQ = 2 * kTileBytes;
  static constexpr int kDO = kQ + kStages * kChunkBytes;
  static constexpr int kStats = kDO + kStages * kChunkBytes;   // [stage][lse2 | delta][kBQ] f32
  static constexpr int kBars = kStats + kStages * 2 * kBQ * 4;  // kv_full, full[s], empty[s]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;   // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo, const BwdArgs a) {
  using C = hopper::Cols<D>;
  using L = DkvSmem<D>;
  constexpr int RB = C::kRowBytes;
  extern __shared__ unsigned char dkv_smem[];
  const uint32_t raw = hopper::saddr(dkv_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* stats = reinterpret_cast<float*>(dkv_smem + (base - raw) + L::kStats);
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full0 = kv_full + 8, empty0 = kv_full + 8 * (1 + kStages);

  const int bh = blockIdx.y, c0 = blockIdx.x * kBK;
  const int off = a.Sk - a.Sq;
  // leading q chunks whose rows all sit above this tile's first key are
  // skipped; rows that see no key at all (off < 0) take part everywhere
  const int qstart = (a.causal && off >= 0) ? max(0, c0 - off) / kBQ * kBQ : 0;
  const int n_chunks = (a.Sq - qstart + kBQ - 1) / kBQ;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1 + 32);   // the TMA thread and the stats warp
      hopper::mbar_init(empty0 + 8 * s, 8);       // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG, lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer ----
    hopper::regs_dealloc<24>();
    const int pw = (threadIdx.x / 32) % 4;
    if (pw == 0 && lane == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * L::kTileBytes);
      for (int cb = 0; cb < C::kBlocks; ++cb) {
        hopper::tma_load(base + L::kK + cb * kBK * RB, &tk, kv_full, cb * C::kBox, c0, bh);
        hopper::tma_load(base + L::kV + cb * kBK * RB, &tv, kv_full, cb * C::kBox, c0, bh);
      }
      for (int t = 0; t < n_chunks; ++t) {
        const int s = t % kStages, q0 = qstart + t * kBQ;
        hopper::mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full0 + 8 * s, 2 * L::kChunkBytes);
        const uint32_t qt = base + L::kQ + s * L::kChunkBytes;
        const uint32_t dt = base + L::kDO + s * L::kChunkBytes;
        for (int cb = 0; cb < C::kBlocks; ++cb) {
          hopper::tma_load(qt + cb * kBQ * RB, &tq, full0 + 8 * s, cb * C::kBox, q0, bh);
          hopper::tma_load(dt + cb * kBQ * RB, &tdo, full0 + 8 * s, cb * C::kBox, q0, bh);
        }
      }
    } else if (pw == 1) {
      const float* lb = a.lse + size_t(bh) * a.Sq;
      const float* db = a.delta + size_t(bh) * a.Sq;
      for (int t = 0; t < n_chunks; ++t) {
        const int s = t % kStages, q0 = qstart + t * kBQ;
        hopper::mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        float* st = stats + s * 2 * kBQ;
        for (int i = lane; i < kBQ; i += 32) {
          const bool live = q0 + i < a.Sq;
          st[i] = live ? __fmul_rn(lb[q0 + i], kLog2e) : 0.f;
          st[kBQ + i] = live ? db[q0 + i] : 0.f;
        }
        hopper::mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    hopper::regs_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, tig = lane % 4;
    const int wk0 = c0 + wg * 64;              // this warpgroup's first key
    const int key_a = wk0 + warp * 16 + g;     // keys of regs 4j, 4j+1; +8 for 4j+2, 4j+3
    const float sl2 = a.scale * kLog2e;
    const float fill2 = __fmul_rn(kMaskFill, kLog2e);   // == lse·log2(e) of a row that sees no key
    float dk[D / 2], dv[D / 2], st[kBQ / 2], dpt[kBQ / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) st[i] = dpt[i] = 0.f;
    const uint32_t ka = base + L::kK + wg * 64 * RB, va = base + L::kV + wg * 64 * RB;
    hopper::mbar_wait(kv_full, 0);

    for (int t = 0; t < n_chunks; ++t) {
      const int s = t % kStages, q0 = qstart + t * kBQ;
      const uint32_t qt = base + L::kQ + s * L::kChunkBytes;
      const uint32_t dt = base + L::kDO + s * L::kChunkBytes;
      const float* ls = stats + s * 2 * kBQ;   // lse·log2(e) of the chunk's rows, then delta
      hopper::mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      // sᵀ = K·Qᵀ and dpᵀ = V·dOᵀ over D in k steps of 16
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int cb = ks / C::kSteps, kin = (ks % C::kSteps) * 32;
        hopper::wgmma_ss<kBQ>(st, hopper::make_desc(ka + cb * kBK * RB + kin, 16, 8 * RB, RB),
                              hopper::make_desc(qt + cb * kBQ * RB + kin, 16, 8 * RB, RB),
                              ks > 0);
        hopper::wgmma_ss<kBQ>(dpt, hopper::make_desc(va + cb * kBK * RB + kin, 16, 8 * RB, RB),
                              hopper::make_desc(dt + cb * kBQ * RB + kin, 16, 8 * RB, RB),
                              ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // pᵀ in place of sᵀ, dsᵀ in place of dpᵀ; the columns are q rows
      const bool edge = q0 + kBQ > a.Sq || wk0 + 64 > a.Sk ||
                        (a.causal && wk0 + 63 > q0 + off);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = j * 8 + tig * 2 + (i & 1);
          const float lse2 = ls[qi];
          float p;
          if (edge) {
            const int key = key_a + 8 * (i >> 1);
            const bool live = q0 + qi < a.Sq && key < a.Sk;
            const bool visible = !a.causal || key <= q0 + qi + off;
            p = live ? exp2f((visible ? st[4 * j + i] * sl2 : fill2) - lse2) : 0.f;
          } else {
            p = exp2f(st[4 * j + i] * sl2 - lse2);
          }
          st[4 * j + i] = p;
          dpt[4 * j + i] = __fmul_rn(__fmul_rn(p, dpt[4 * j + i] - ls[kBQ + qi]), a.scale);
        }
      // dv += pᵀ·dO and dk += dsᵀ·Q: q rows 16kk..16kk+15 are one k step.
      // Every A fragment is packed before the fence, so no register the
      // products read is written while they run
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          pa[kk][f] = pack_bf16(st[8 * kk + 2 * f], st[8 * kk + 2 * f + 1]);
          da[kk][f] = pack_bf16(dpt[8 * kk + 2 * f], dpt[8 * kk + 2 * f + 1]);
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t bo = hopper::make_desc(dt + kk * 16 * RB, kBQ * RB, 8 * RB, RB);
        const uint64_t bq = hopper::make_desc(qt + kk * 16 * RB, kBQ * RB, 8 * RB, RB);
        hopper::wgmma_rs<D>(dv, pa[kk], bo, 1);
        hopper::wgmma_rs<D>(dk, da[kk], bq, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
    }
    store_acc<D>(static_cast<bf16*>(a.dk) + size_t(bh) * a.Sk * D, dk, key_a, a.Sk, tig, a.kc,
                 a.ks);
    store_acc<D>(static_cast<bf16*>(a.dv) + size_t(bh) * a.Sk * D, dv, key_a, a.Sk, tig,
                 nullptr, nullptr);
  }
}

template <int D>
int launch_dkv_wgmma(const BwdArgs& a, cudaStream_t stream) {
  using C = hopper::Cols<D>;
  CUtensorMap tk, tv, tq, tdo;
  int err = hopper::encode_rows(&tk, a.k, a.BH, a.Sk, D, kBK, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tv, a.v, a.BH, a.Sk, D, kBK, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tq, a.q, a.BH, a.Sq, D, kBQ, C::kBox);
  if (err == 0) err = hopper::encode_rows(&tdo, a.dO, a.BH, a.Sq, D, kBQ, C::kBox);
  if (err != 0) return err;
  const int smem = DkvSmem<D>::kBytes;
  auto kernel = bwd_dkv_wgmma_kernel<D>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((a.Sk + kBK - 1) / kBK, a.BH);
  kernel<<<grid, kWsThreads, smem, stream>>>(tk, tv, tq, tdo, a);
  return int(cudaGetLastError());
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
  if (bf16_in) return launch_dq_wgmma<D, kDqKeys>(a, stream);
  return launch(bwd_dq_f32_kernel<D>, dim3((a.Sq + kF32Rows - 1) / kF32Rows, a.BH),
                dq_f32_smem<D>(), a, stream);
}

template <int D>
int launch_dkv(const BwdArgs& a, bool bf16_in, cudaStream_t stream) {
  if (bf16_in) return launch_dkv_wgmma<D>(a, stream);
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

// K2.  kind: 0 f32, 1 bf16.  Rope tables are all null or all set; for f32
// they rotate q and k on load, for bf16 q and k come already rotated and the
// tables serve the inverse rotation of dq.  Returns a cudaError_t.
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

// K3, the same arguments with dk and dv for dq (for bf16 the tables serve
// the inverse rotation of dk).
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

