// Tile helpers of the two flash-attention backward kernels' fp32 path
// (flash_bwd_dq.cu and flash_bwd_dkv.cu; bf16 runs on the tensor cores,
// attention_mma.cuh).
//
// Both kernels recompute, for one 64 x 64 tile of (query, key) pairs,
//
//   S = Q K^T * scale (masked),  P = exp(S - LSE),  dP = dO V^T,
//   dS = P * (dP - delta) * scale,
//
// and add a product of P or dS with a [64, D] tile into fp32 registers.
// Every tile lives in shared memory as fp32, rows padded by one float so
// that the 16 rows a warp reads at one column fall in 16 banks. 256
// threads form a 16 x 16 grid: thread (tx, ty) owns tile rows ty + 16 i
// and tile columns tx + 16 j (pairs) or channels tx + 16 j (outputs), as
// in the forward's tile engine (attention_tile.cuh).

#pragma once

#include "attention_tile.cuh"

namespace rt {
namespace bwd {

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kRM = kTile / 16;  // tile rows a thread owns
constexpr int kCM = kTile / 16;  // tile columns a thread owns
constexpr int kPS = kTile + 1;   // padded row stride of a [64, 64] tile

// Rows 0..n-1 of the [64, D] tile at src (row stride D elements) into
// shared memory as fp32, row stride D + 1; rows n..63 become zeros. All
// of a thread's 16-byte loads are issued before any is used.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int n) {
  constexpr int E = kVec<T>;
  constexpr int CH = D / E;
  constexpr int N = (kTile * CH + kThreads - 1) / kThreads;
  uint4 u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / CH;
    u[i] = (idx < kTile * CH && r < n)
               ? *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * D +
                                                 (idx - r * CH) * E)
               : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / CH;
    if (idx < kTile * CH) unpack(u[i], dst + r * (D + 1) + (idx - r * CH) * E, T());
  }
}

// acc[i][j] = sum_d a[row ty + 16 i][d] * b[row tx + 16 j][d], for two
// [64, D] tiles of row stride D + 1: a tile of row-by-row dot products.
template <int D>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          float (&acc)[kRM][kCM]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCM; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[kRM], bv[kCM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kCM; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_s p[row ty + 16 i][s] * x[s][tx + 16 c]: a [64, 64]
// tile (row stride kPS) times a [64, D] tile (row stride D + 1).
template <int D>
__device__ __forceinline__ void tile_matmul_acc(const float* p, const float* x,
                                                float (&acc)[kRM][D / 16]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int s = 0; s < kTile; ++s) {
    float pv[kRM], xv[D / 16];
#pragma unroll
    for (int i = 0; i < kRM; ++i) pv[i] = p[(ty + 16 * i) * kPS + s];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) xv[c] = x[s * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
  }
}

// Shared memory of either kernel: four [64, D] tiles, NP [64, 64] tiles
// and two 64-float vectors (LSE and delta of the query tile).
template <int D, int NP>
struct BwdSmem {
  static constexpr int kRow = kTile * (D + 1);  // floats in a [64, D] tile
  static constexpr size_t kBytes =
      (4 * kRow + NP * kTile * kPS + 2 * kTile) * sizeof(float);
};

// Rows 0..n-1 of a thread's [64, D] accumulator tile, written in T at
// rows row0.. of out (row stride D).
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[kRM][D / 16], T* out, int n,
                                           long long row0) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) store(out + (row0 + r) * D + tx + 16 * c, acc[i][c]);
  }
}

}  // namespace bwd
}  // namespace rt
