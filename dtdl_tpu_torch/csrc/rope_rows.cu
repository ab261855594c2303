// Rope pre-pass of the bf16 flash kernels: rotate every q or k row once per
// call, before K1 (flash_fwd.cu) or the K2/K3 pair (flash_bwd.cu, one
// pre-pass for both) stream the rows through their tiles.
//
// Replaces: the rotation that dtdl_tpu/ops/attention.py:_fwd_kernel,
// _bwd_dq_kernel and _bwd_dkv_kernel fuse into their tile loads (_rotate,
// attention.py:118).
// The TPU kernels can afford to rotate a tile each time they load it; on
// this card the rotation inside the inner loop re-read 1 KB of f32 tables
// per 256-byte row, once per tile pair, so it moves out of the loop.
//
// What it computes, per row r of [BH, S, D] (position r % S in the [S, D]
// tables c, s of ops/rope.py rope_rows): y = x·c + rot_half(x)·s with
// rot_half([x1, x2]) = [-x2, x1], in f32 products and a sum without fused
// multiply-adds, rounded to the input type: bitwise ops/attention.py
// _rotate, and the arithmetic of attn_common.cuh rope_rows.
//
// What bounds it on an H100: bytes.  It reads x and the tables and writes y,
// a few flops per element.  Each thread takes 8 dimensions of the first
// half of a row and the matching 8 of the second half (16-byte loads and
// stores for bf16).
#include "attn_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(256)
rope_rows_kernel(const T* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ s, T* __restrict__ y, long rows, int S) {
  constexpr int H2 = D / 2, G = H2 / 8;
  const long e = long(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= long(rows) * G) return;
  const long r = e / G;
  const int d = int(e - r * G) * 8;
  const size_t at = size_t(r) * D + d;
  const float* cr = c + size_t(r % S) * D + d;
  const float* sr = s + size_t(r % S) * D + d;
  float x1[8], x2[8];
  dtdl::load8(x, at, dtdl::kind_of<T>(), x1);
  dtdl::load8(x, at + H2, dtdl::kind_of<T>(), x2);
  __align__(16) T o1[8];
  __align__(16) T o2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o1[i] = dtdl::from_f32<T>(__fadd_rn(__fmul_rn(x1[i], cr[i]), __fmul_rn(-x2[i], sr[i])));
    o2[i] = dtdl::from_f32<T>(
        __fadd_rn(__fmul_rn(x2[i], cr[i + H2]), __fmul_rn(x1[i], sr[i + H2])));
  }
  constexpr int V = sizeof(T) * 8 / 16;   // 16-byte stores per 8 elements
#pragma unroll
  for (int v = 0; v < V; ++v) {
    reinterpret_cast<uint4*>(y + at)[v] = reinterpret_cast<const uint4*>(o1)[v];
    reinterpret_cast<uint4*>(y + at + H2)[v] = reinterpret_cast<const uint4*>(o2)[v];
  }
}

template <typename T, int D>
int launch(const void* x, const float* c, const float* s, void* y, long rows, int S,
           cudaStream_t stream) {
  const long work = rows * (D / 16);
  const int threads = 256;
  const long blocks = (work + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return int(cudaErrorInvalidValue);
  rope_rows_kernel<T, D><<<unsigned(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), c, s, static_cast<T*>(y), rows, S);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* x, const float* c, const float* s, void* y, long rows, int S, int D,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(x, c, s, y, rows, S, stream);
    case 32: return launch<T, 32>(x, c, s, y, rows, S, stream);
    case 64: return launch<T, 64>(x, c, s, y, rows, S, stream);
    case 128: return launch<T, 128>(x, c, s, y, rows, S, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// y [BH, S, D] = x rotated by the rope rows c, s [S, D] f32.  kind: 0 f32,
// 1 bf16.  Returns a cudaError_t.
extern "C" int dtdl_rope_rows(const void* x, const void* c, const void* s, void* y, int BH,
                              int S, int D, int kind, void* stream) {
  if (BH < 1 || S < 1) return int(cudaErrorInvalidValue);
  const float* cf = static_cast<const float*>(c);
  const float* sf = static_cast<const float*>(s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long rows = long(BH) * S;
  if (kind == dtdl::kBF16) return launch_dim<__nv_bfloat16>(x, cf, sf, y, rows, S, D, st);
  if (kind == dtdl::kF32) return launch_dim<float>(x, cf, sf, y, rows, S, D, st);
  return int(cudaErrorInvalidValue);
}
