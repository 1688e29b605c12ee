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
// (b*h, 64-row query tile), keeps its Q, dO, LSE and delta in shared
// memory and dQ in registers, and walks the K/V tiles in a loop up to the
// last key the tile's last row can see (the TPU's kv_of_q clamp): tiles
// past the diagonal are neither loaded nor computed. Each dQ row has one
// writer, so no atomics.
//
// What bounds it on an H100: three products of 2*D operations per visible
// (query, key) pair against 989 TFLOP/s of bf16 tensor cores, and the
// bytes of q, k, v, dO, LSE, delta and dQ at 3.35 TB/s; at T = 1024,
// D = 64 the two are about equal. This first version computes on the fp32
// FMA units from shared-memory tiles (flash_bwd_tile.cuh), so it stays
// far from the tensor-core bound; what it does about the bytes is read
// each K/V tile once per 64 query rows and never materialise the T x T
// scores. Query tiles are issued last-first so the longest walks start
// earliest.

#include "flash_bwd_tile.cuh"

namespace {

using rt::bwd::kCM;
using rt::bwd::kPS;
using rt::bwd::kRM;
using rt::bwd::kTile;

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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, void* dq, int bh, int t_q,
                      int t_kv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (t_q + kTile - 1) / kTile);
  return rt::launch(flash_bwd_dq_kernel<T, D>, grid, rt::bwd::BwdSmem<D, 1>::kBytes, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
                    static_cast<T*>(dq), t_q, t_kv, causal, scale);
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

// dtype: 0 = float32, 1 = bfloat16. q, g, dq: [bh, t_q, d]; k, v:
// [bh, t_kv, d]; lse, delta: [bh, t_q] float32. All contiguous, on the
// stream's device.
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
