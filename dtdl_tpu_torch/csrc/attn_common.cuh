// Shared pieces of the attention kernels (flash_fwd.cu, flash_bwd.cu,
// paged_attention.cu).
//
// Both kernels hold a tile of QT query rows in shared memory and stream key
// chunks of KC rows past it: scores, an online softmax (running max m, sum l
// and accumulator acc, all f32) and the P·V product.  What differs is where
// a key chunk comes from (a contiguous [S, D] slab with fused rope, or the
// pages a page table names, with optional int8/fp8 dequant) and how a score
// is scaled and masked; the kernels pass that in as a functor.
//
// Layout of one block (NT threads):
//   Qs [QT][D]      query rows as f32 (already roped, rounded to the input type)
//   Ks [KC][D + 1]  key chunk as f32; the +1 pad makes the column reads of the
//                   score loop (32 keys, one dimension) hit 32 different banks
//   Vs [KC][D]      value chunk as f32
//   Ps [QT][KC]     scores, then the rounded softmax weights
//   KSc, VSc [KC]   per-key score and weight factors (the key and value
//                   scales of a quantized pool)
//   M, L, A [QT]    running max, running sum, this chunk's rescale factor
// The accumulator lives in registers: thread t owns row t / TPR and the
// dimensions (t % TPR) + j * TPR.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtdl {

// The mask fill of the JAX package (ops/attention.py NEG_INF), not -inf: a
// row whose visible columns all lie in later chunks keeps a finite max.
constexpr float kMaskFill = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x.astype(T) and back: where the JAX kernels cast an f32 intermediate to
// the input type before a matmul, the kernels here round the same way.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int QT, int NT>
struct Tile {
  static_assert(NT % 32 == 0 && NT % QT == 0, "NT must split into warps and rows");
  static constexpr int TPR = NT / QT;                 // threads per query row (P·V)
  static constexpr int DPT = (D + TPR - 1) / TPR;     // accumulator slots per thread
  static constexpr int KSTRIDE = D + 1;

  static size_t smem_bytes(int kc) {
    return sizeof(float) *
           (size_t(QT) * D + size_t(kc) * KSTRIDE + size_t(kc) * D + size_t(QT) * kc + 2 * kc +
            3 * QT);
  }

  float* Qs; float* Ks; float* Vs; float* Ps; float* KSc; float* VSc; float* M; float* L; float* A;

  __device__ Tile(float* smem, int kc) {
    Qs = smem;
    Ks = Qs + QT * D;
    Vs = Ks + kc * KSTRIDE;
    Ps = Vs + kc * D;
    KSc = Ps + QT * kc;
    VSc = KSc + kc;
    M = VSc + kc;
    L = M + QT;
    A = L + QT;
  }

  __device__ void init_stats() {
    for (int r = threadIdx.x; r < QT; r += NT) {
      M[r] = kMaskFill;
      L[r] = 0.f;
      A[r] = 1.f;
    }
  }

  // Ps[r][k] = epi(r, k, q_r · k_k) for the live rows; dead rows get the fill.
  template <typename Epi>
  __device__ void scores(int kc, int rows, Epi epi) {
    for (int p = threadIdx.x; p < QT * kc; p += NT) {
      const int r = p / kc, k = p - r * kc;
      float s = kMaskFill;
      if (r < rows) {
        const float* qr = Qs + r * D;
        const float* kr = Ks + k * KSTRIDE;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = epi(r, k, dot);
      }
      Ps[r * kc + k] = s;
    }
  }

  // One online-softmax step per live row (a warp per row): new max, the
  // weights p = exp(s - m) summed into l unrounded, then multiplied by the
  // per-key factor and rounded to T for the P·V product, as the JAX
  // kernels cast p before their second matmul.
  template <typename T>
  __device__ void softmax(int kc, int rows, bool weight_factor) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < rows; r += NT / 32) {
      float* pr = Ps + r * kc;
      float mx = kMaskFill;
      for (int k = lane; k < kc; k += 32) mx = fmaxf(mx, pr[k]);
      mx = warp_max(mx);
      const float m_prev = M[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int k = lane; k < kc; k += 32) {
        const float p = expf(pr[k] - m_new);
        sum += p;
        pr[k] = round_to<T>(weight_factor ? p * VSc[k] : p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        A[r] = alpha;
        L[r] = L[r] * alpha + sum;
        M[r] = m_new;
      }
    }
  }

  // acc = acc * alpha + P·V over this chunk, for this thread's row and dims.
  __device__ void pv(int kc, int rows, float (&acc)[DPT]) {
    const int r = threadIdx.x / TPR, lane = threadIdx.x % TPR;
    if (r >= rows) return;
    const float* pr = Ps + r * kc;
    float s[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) s[j] = 0.f;
    for (int k = 0; k < kc; ++k) {
      const float p = pr[k];
      const float* vr = Vs + k * D + lane;
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        if (lane + j * TPR < D) s[j] = fmaf(p, vr[j * TPR], s[j]);
    }
    const float alpha = A[r];
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] = acc[j] * alpha + s[j];
  }

  // o = acc / l (l == 0 -> 0 output), written as T.
  template <typename T>
  __device__ void store(T* out_rows, int rows, const float (&acc)[DPT]) {
    const int r = threadIdx.x / TPR, lane = threadIdx.x % TPR;
    if (r >= rows) return;
    const float l = L[r];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = lane + j * TPR;
      if (d < D) out_rows[size_t(r) * D + d] = from_f32<T>(acc[j] / l_safe);
    }
  }
};

// Eight consecutive elements of a row, widened to f32, from one vector load.
// `e` counts elements and is a multiple of 8; the wrapper checks that every
// base pointer is 16-byte aligned.
enum ElemKind : int { kF32 = 0, kBF16 = 1, kInt8 = 2, kFp8E4M3 = 3 };

template <typename T> __device__ __forceinline__ constexpr int kind_of();
template <> __device__ __forceinline__ constexpr int kind_of<float>() { return kF32; }
template <> __device__ __forceinline__ constexpr int kind_of<__nv_bfloat16>() { return kBF16; }

__device__ __forceinline__ void load8(const void* base, size_t e, int kind, float* out) {
  switch (kind) {
    case kF32: {
      const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(base) + e);
      const float4 a = p[0], b = p[1];
      out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
      out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
      break;
    }
    case kBF16: {
      const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + e);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
      break;
    }
    case kInt8: {
      const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(base) + e);
      const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = float(c[i]);
      break;
    }
    default: {  // kFp8E4M3, passed as raw bytes
      const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(base) + e);
      const __nv_fp8_storage_t* c = reinterpret_cast<const __nv_fp8_storage_t*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        __nv_fp8_e4m3 f;
        f.__x = c[i];
        out[i] = float(f);
      }
      break;
    }
  }
}

// 2^x, one MUFU.EX2 (relative error 2^-22, subnormal results flushed to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16 and packed in one register, lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float load_scalar(const void* base, size_t e, int kind) {
  return kind == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[e])
                       : static_cast<const float*>(base)[e];
}

// ---- fused rope on load (flash_fwd.cu, flash_bwd.cu) ------------------------
//
// The tables are per-position rows (c, s) of width D, the half-width
// cos/sin tables repeated twice (ops/rope.py rope_rows), so a rotated row is
// x·c + rot_half(x)·s with rot_half([x1, x2]) = [-x2, x1].

// Rotate `n` rows of the f32 buffer `buf` (stride `ld`) in place, the rows
// of positions row0.. (only the first `nvalid` are real): f32 without fused
// multiply-adds (the reference computes two products and a sum), rounded
// to T.  NT threads take part.
template <typename T, int D, int NT = 128>
__device__ void rope_rows(float* buf, int ld, int n, int row0, int nvalid, const float* c,
                          const float* s) {
  constexpr int H2 = D / 2;
  for (int e = threadIdx.x; e < n * H2; e += NT) {
    const int r = e / H2, d = e - r * H2;
    if (r >= nvalid) continue;
    float* x = buf + r * ld;
    const float* cr = c + size_t(row0 + r) * D;
    const float* sr = s + size_t(row0 + r) * D;
    const float x1 = x[d], x2 = x[d + H2];
    x[d] = round_to<T>(__fadd_rn(__fmul_rn(x1, cr[d]), __fmul_rn(-x2, sr[d])));
    x[d + H2] = round_to<T>(__fadd_rn(__fmul_rn(x2, cr[d + H2]), __fmul_rn(x1, sr[d + H2])));
  }
}

// The inverse rotation of one f32 gradient pair (g1 at dimension d, g2 at
// d + D/2), g·c − rot_half(g)·s: rope is orthogonal per row, so its VJP is
// the rotation with the angle negated (attention.py _unrotate_f32).
__device__ __forceinline__ void unrotate_pair(float& g1, float& g2, float c1, float s1, float c2,
                                              float s2) {
  const float a = __fsub_rn(__fmul_rn(g1, c1), __fmul_rn(-g2, s1));
  const float b = __fsub_rn(__fmul_rn(g2, c2), __fmul_rn(g1, s2));
  g1 = a;
  g2 = b;
}

}  // namespace dtdl
