// Flash attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytpu/ops/flash_attention.py::_flash_bwd_dq_kernel
// (launched by _flash_backward_pallas). Same function: for q, k, v and the
// output gradient dO laid out [B*H, T, D], the forward's log-sum-exp LSE
// and delta = rowsum(dO * O) ([B*H, T_q], fp32),
//
//   dQ = sum over keys of dS K,  dS = P * (dP - delta) * scale,
//   P = exp(S - LSE),  S = Q K^T * scale (masked),  dP = dO V^T,
//
// accumulated in fp32 and written in q's type. The causal diagonal is
// bottom-aligned, off = t_kv - t_q, as on the TPU.
//
// The TPU walks K/V as a sequential grid axis and carries dQ in scratch
// memory from one grid step to the next. Here one thread block owns one
// (b*h, 64-row query tile) and walks the K/V tiles in a loop up to the
// last key the tile's last row can see (the TPU's kv_of_q clamp): tiles
// past the diagonal are neither loaded nor computed. Each dQ row has one
// writer, so no atomics, and the sums run in a fixed order: the same
// inputs give the same bits. Query tiles are issued last-first so the
// longest walks start earliest.
//
// What bounds it on an H100: three products of 2*D operations per visible
// (query, key) pair against 989 TFLOP/s of bf16 tensor cores, and the
// bytes of q, k, v, dO, LSE, delta and dQ at 3.35 TB/s; at T = 1024,
// D = 64 the two are about equal, at T = 4096, D = 128 the operations
// bound it 20 times over the bytes. So bf16 input runs on the tensor cores
// (attention_mma.cuh): four warps of 16 query rows; Q and dO resident in
// shared memory as bf16, K and V streamed through a two-stage cp.async
// ring so the next tile's copy overlaps this tile's products; S = Q K^T
// and dP = dO V^T as mma.sync m16n8k16 into fp32 registers; P and dS in
// registers, masked only on tiles that cross the diagonal or the keys'
// end; dS rounded to bf16 (where the TPU kernel's ds.astype(mxu) rounds
// it) and fed straight from registers as the A operand of dQ += dS K, with
// K transposed by ldmatrix. Swizzled bf16 tiles take 96 KB at D = 128, so
// two blocks share an SM. fp32 input (the TPU's "f32" dot mode; on no
// main path) keeps the fp32 FMA tiles of flash_bwd_tile.cuh.

#include <type_traits>

#include "attention_mma.cuh"
#include "flash_bwd_tile.cuh"

namespace {

using rt::bwd::kCM;
using rt::bwd::kPS;
using rt::bwd::kRM;
using rt::bwd::kTile;
static_assert(rt::mma::kTile == kTile, "the two kernels share one tile size");

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int t_q, int t_kv,
                    int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = rt::bwd::BwdSmem<D, 1>;
  constexpr int kRow = Smem::kRow;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* gs = qs + kRow;
  float* ks = gs + kRow;
  float* vs = ks + kRow;
  float* ds = vs + kRow;       // [64, 64] dS
  float* ls = ds + kTile * kPS;  // LSE of the query tile
  float* dl = ls + kTile;      // delta of the query tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // latest tiles first
  const int nq = min(kTile, t_q - q0);
  const int off = t_kv - t_q;
  const long long qrow = static_cast<long long>(blockIdx.x) * t_q + q0;
  const long long krow = static_cast<long long>(blockIdx.x) * t_kv;
  const int n_keys = causal ? max(0, min(t_kv, q0 + nq + off)) : t_kv;

  rt::bwd::load_tile<T, D>(qs, q + qrow * D, nq);
  rt::bwd::load_tile<T, D>(gs, g + qrow * D, nq);
  for (int r = tid; r < kTile; r += rt::kThreads) {
    ls[r] = r < nq ? lse[qrow + r] : 0.f;
    dl[r] = r < nq ? delta[qrow + r] : 0.f;
  }
  float acc[kRM][D / 16];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    // The previous tile's readers of ks, vs and ds are done (and, on the
    // first pass, Q, dO, LSE and delta are written).
    __syncthreads();
    const int nk = min(kTile, n_keys - k0);
    rt::bwd::load_tile<T, D>(ks, k + (krow + k0) * D, nk);
    rt::bwd::load_tile<T, D>(vs, v + (krow + k0) * D, nk);
    __syncthreads();

    float s[kRM][kCM], dp[kRM][kCM];
    rt::bwd::tile_dots<D>(qs, ks, s);
    rt::bwd::tile_dots<D>(gs, vs, dp);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCM; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        const bool live = r < nq && c < nk && (!causal || key <= q0 + r + off);
        const float p = live ? expf(s[i][j] * scale - ls[r]) : 0.f;
        ds[r * kPS + c] = p * (dp[i][j] - dl[r]) * scale;
      }
    }
    __syncthreads();
    rt::bwd::tile_matmul_acc<D>(ds, ks, acc);
  }
  rt::bwd::store_rows<T, D>(acc, dq, nq, qrow);
}

// The bf16 kernel on the tensor cores: one block of four warps per (b*h,
// 64 query rows), warp w owning rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(rt::mma::kThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int t_q, int t_kv, int causal,
                        float scale) {
  using namespace rt::mma;
  using rt::mma::kTile;
  constexpr int kT = kTile * D;  // elements of a [64, D] tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + kT;
  bf16* ks = gs + kT;      // two stages
  bf16* vs = ks + 2 * kT;  // two stages

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's first row of the tile
  const int gr = lane >> 2, t2 = 2 * (lane & 3);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // latest tiles first
  const int nq = min(kTile, t_q - q0);
  const int off = t_kv - t_q;
  const long long qrow = static_cast<long long>(blockIdx.x) * t_q + q0;
  const long long krow = static_cast<long long>(blockIdx.x) * t_kv;
  const int n_keys = causal ? max(0, min(t_kv, q0 + nq + off)) : t_kv;
  const int n_tiles = (n_keys + kTile - 1) / kTile;

  load_tile<D>(qs, q + qrow * D, nq);
  load_tile<D>(gs, g + qrow * D, nq);
  if (n_tiles > 0) {
    load_tile<D>(ks, k + krow * D, min(kTile, n_keys));
    load_tile<D>(vs, v + krow * D, min(kTile, n_keys));
  }
  cp_async_commit();
  float lr[2], dr[2];  // LSE and delta of the thread's rows r0 + gr (+ 8)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + gr + 8 * i;
    lr[i] = r < nq ? lse[qrow + r] : 0.f;
    dr[i] = r < nq ? delta[qrow + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      const int nk = min(kTile, n_keys - k0 - kTile);
      load_tile<D>(ks + ((it + 1) & 1) * kT, k + (krow + k0 + kTile) * D, nk);
      load_tile<D>(vs + ((it + 1) & 1) * kT, v + (krow + k0 + kTile) * D, nk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) landed
    __syncthreads();
    const bf16* kt = ks + (it & 1) * kT;
    const bf16* vt = vs + (it & 1) * kT;

    float s[kTile / 8][4], dp[kTile / 8][4];  // [16 rows, 64 keys] each
    row_dots<D, kTile>(s, qs, r0, kt, 0);
    row_dots<D, kTile>(dp, gs, r0, vt, 0);
    // P = exp(S scale - LSE), dS = P (dP - delta) scale, in place of S.
    // Only a tile past the keys' end or across the warp's diagonal masks.
    const bool edge = k0 + kTile > t_kv || (causal && k0 + kTile - 1 > q0 + r0 + off);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + 8 * j + t2 + (e & 1);
        const bool live =
            !edge || (key < t_kv && (!causal || key <= q0 + r0 + gr + 8 * i + off));
        const float p = live ? expf(s[j][e] * scale - lr[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[i]) * scale;
      }
    // dQ += dS K, dS rounded to bf16 as the A operand.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a_from_c<kTile>(a, s, kk);
      mma_rows_t<D>(acc, a, kt, 16 * kk);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  store_rows<D>(acc, dq + (qrow + r0) * D, nq - r0);
}

// bf16 runs the tensor-core kernel, float the fp32 FMA one.
template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, void* dq, int bh, int t_q,
                      int t_kv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (t_q + kTile - 1) / kTile);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const size_t smem = 6 * kTile * D * sizeof(T);  // Q, dO, 2 x K, 2 x V
    return rt::mma::launch(flash_bwd_dq_mma_kernel<D>, grid, smem, stream,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
                           static_cast<T*>(dq), t_q, t_kv, causal, scale);
  } else {
    return rt::launch(flash_bwd_dq_kernel<T, D>, grid, rt::bwd::BwdSmem<D, 1>::kBytes, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
                      static_cast<T*>(dq), t_q, t_kv, causal, scale);
  }
}

template <typename T>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v, const void* g,
                         const float* lse, const float* delta, void* dq, int bh, int t_q,
                         int t_kv, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_dq<T, 32>(q, k, v, g, lse, delta, dq, bh, t_q, t_kv, causal, scale, stream);
    case 64:
      return launch_dq<T, 64>(q, k, v, g, lse, delta, dq, bh, t_q, t_kv, causal, scale, stream);
    case 128:
      return launch_dq<T, 128>(q, k, v, g, lse, delta, dq, bh, t_q, t_kv, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (fp32 FMA tiles), 1 = bfloat16 (tensor cores).
// q, g, dq: [bh, t_q, d]; k, v: [bh, t_kv, d]; lse, delta: [bh, t_q]
// float32. All contiguous, on the stream's device.
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                               const void* lse, const void* delta, void* dq, int dtype, int bh,
                               int t_q, int t_kv, int d, int causal, float scale,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return dispatch_dim<float>(d, q, k, v, g, l, dl, dq, bh, t_q, t_kv, causal, scale, s);
    case 1:
      return dispatch_dim<__nv_bfloat16>(d, q, k, v, g, l, dl, dq, bh, t_q, t_kv, causal, scale,
                                         s);
    default: return cudaErrorInvalidValue;
  }
}
