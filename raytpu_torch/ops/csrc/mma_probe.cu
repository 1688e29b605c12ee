// A measuring kernel, on no main path: the fp32 sums of the tensor cores'
// bf16 products, computed by the same mma.sync m16n8k16 helpers and in the
// same order as the attention kernels (attention_mma.cuh), for a caller
// to hold against exact sums. chip_smoke.py uses it to choose the rounding
// model of the fp32 accumulation on which its limits rest.
//
// One block of four warps per [64, ...] tile t:
//   mode 0, scores:  out[t] (64 x 64) = A[t] (64 x D) . B[t] (64 x D)^T,
//                    the forward's and the backward's row dot products
//                    (ldmatrix A and B, D / 16 products of depth 16);
//   mode 1, P V:     out[t] (64 x D)  = P[t] (64 x 64, fp32) . B[t] (64 x D),
//                    the forward's P V: P rounded to bf16 into A fragments
//                    (a_from_c), B transposed by ldmatrix.trans, 4 products
//                    of depth 16.

#include "attention_mma.cuh"

namespace {

using rt::mma::bf16;
using rt::mma::kTile;

template <int D>
__global__ void __launch_bounds__(rt::mma::kThreads)
mma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 const float* __restrict__ p, float* __restrict__ out, int mode) {
  using namespace rt::mma;
  constexpr int kT = kTile * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + kT;
  const long long t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);

  load_tile<D>(as, a + t * kT, kTile);
  load_tile<D>(bs, b + t * kT, kTile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (mode == 0) {
    float s[kTile / 8][4];
    row_dots<D, kTile>(s, as, r0, bs, 0);
    float* o = out + t * kTile * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[(r0 + g + 8 * (e >> 1)) * kTile + 8 * j + t2 + (e & 1)] = s[j][e];
  } else {
    float pc[kTile / 8][4];  // P's C fragments
    const float* pt = p + t * kTile * kTile;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pc[j][e] = pt[(r0 + g + 8 * (e >> 1)) * kTile + 8 * j + t2 + (e & 1)];
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4];
      a_from_c<kTile>(af, pc, kk);
      mma_rows_t<D>(acc, af, bs, 16 * kk);
    }
    float* o = out + t * kT;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[(r0 + g + 8 * (e >> 1)) * D + 8 * j + t2 + (e & 1)] = acc[j][e];
  }
}

template <int D>
cudaError_t launch_probe(const void* a, const void* b, const float* p, float* out, int mode,
                         int n_tiles, cudaStream_t stream) {
  return rt::mma::launch(mma_probe_kernel<D>, dim3(n_tiles), 2 * kTile * D * sizeof(bf16),
                         stream, static_cast<const bf16*>(a), static_cast<const bf16*>(b), p,
                         out, mode);
}

}  // namespace

// a, b: [n_tiles, 64, d] bf16; p: [n_tiles, 64, 64] float32 (mode 1);
// out: [n_tiles, 64, 64] (mode 0) or [n_tiles, 64, d] (mode 1) float32.
extern "C" int rt_mma_probe(const void* a, const void* b, const void* p, void* out, int mode,
                            int d, int n_tiles, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  float* o = static_cast<float*>(out);
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch_probe<32>(a, b, pf, o, mode, n_tiles, s);
    case 64: return launch_probe<64>(a, b, pf, o, mode, n_tiles, s);
    case 128: return launch_probe<128>(a, b, pf, o, mode, n_tiles, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
