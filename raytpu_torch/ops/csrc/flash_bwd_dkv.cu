// Flash attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (launched by _flash_backward_pallas). Same function: for q, k, v and the
// output gradient dO laid out [B*H, T, D], the forward's log-sum-exp LSE
// and delta = rowsum(dO * O) ([B*H, T_q], fp32),
//
//   dV = sum over queries of P^T dO,  dK = sum over queries of dS^T Q,
//   P = exp(S - LSE),  dS = P * (dP - delta) * scale,
//   S = Q K^T * scale (masked),  dP = dO V^T,
//
// accumulated in fp32 and written in k's and v's type. The causal
// diagonal is bottom-aligned, off = t_kv - t_q, as on the TPU.
//
// The TPU walks Q as a sequential grid axis and carries dK and dV in
// scratch memory. Here one thread block owns one (b*h, 64-key tile),
// keeps its K and V in shared memory and dK and dV in registers, and
// walks the query tiles in a loop from the first row that can see the
// tile's first key (the TPU's q_of_kv clamp): query rows above the
// diagonal are neither loaded nor computed. It computes the transposed
// tiles S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T need no
// transpose. Each dK and dV row has one writer, so no atomics.
//
// What bounds it on an H100: four products of 2*D operations per visible
// (query, key) pair against 989 TFLOP/s of bf16 tensor cores, and the
// bytes of q, k, v, dO, LSE, delta, dK and dV at 3.35 TB/s; at T = 1024,
// D = 64 the operations bound it, a little. This first version computes
// on the fp32 FMA units from shared-memory tiles (flash_bwd_tile.cuh), so
// it stays far from the tensor-core bound; what it does about the bytes
// is read each Q/dO tile once per 64 keys and never materialise the
// T x T scores. Key tiles are issued first-first: under the causal mask
// the first keys have the longest walks, so they start earliest.

#include "flash_bwd_tile.cuh"

namespace {

using rt::bwd::kCM;
using rt::bwd::kPS;
using rt::bwd::kRM;
using rt::bwd::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int t_q, int t_kv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = rt::bwd::BwdSmem<D, 2>;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + Smem::kRow;
  float* qs = vs + Smem::kRow;
  float* gs = qs + Smem::kRow;
  float* pt = gs + Smem::kRow;    // [64 keys, 64 queries] P^T
  float* dst = pt + kTile * kPS;  // [64 keys, 64 queries] dS^T
  float* ls = dst + kTile * kPS;  // LSE of the query tile
  float* dl = ls + kTile;         // delta of the query tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.y * kTile;
  const int nk = min(kTile, t_kv - k0);
  const int off = t_kv - t_q;
  const long long qrow = static_cast<long long>(blockIdx.x) * t_q;
  const long long krow = static_cast<long long>(blockIdx.x) * t_kv + k0;
  // Query row i sees key j when j <= i + off: the first row that sees
  // key k0 is k0 - off.
  const int first = causal ? max(0, k0 - off) : 0;

  rt::bwd::load_tile<T, D>(ks, k + krow * D, nk);
  rt::bwd::load_tile<T, D>(vs, v + krow * D, nk);
  float dk_acc[kRM][D / 16], dv_acc[kRM][D / 16];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = first; q0 < t_q; q0 += kTile) {
    // The previous tile's readers of qs, gs, pt, dst, ls and dl are done
    // (and, on the first pass, K and V are written).
    __syncthreads();
    const int nq = min(kTile, t_q - q0);
    rt::bwd::load_tile<T, D>(qs, q + (qrow + q0) * D, nq);
    rt::bwd::load_tile<T, D>(gs, g + (qrow + q0) * D, nq);
    for (int r = tid; r < kTile; r += rt::kThreads) {
      ls[r] = r < nq ? lse[qrow + q0 + r] : 0.f;
      dl[r] = r < nq ? delta[qrow + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[kRM][kCM], dp[kRM][kCM];  // [key ty + 16 i][query tx + 16 j]
    rt::bwd::tile_dots<D>(ks, qs, s);
    rt::bwd::tile_dots<D>(vs, gs, dp);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int kr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCM; ++j) {
        const int qc = tx + 16 * j;
        const bool live = kr < nk && qc < nq && (!causal || k0 + kr <= q0 + qc + off);
        const float p = live ? expf(s[i][j] * scale - ls[qc]) : 0.f;
        pt[kr * kPS + qc] = p;
        dst[kr * kPS + qc] = p * (dp[i][j] - dl[qc]) * scale;
      }
    }
    __syncthreads();
    rt::bwd::tile_matmul_acc<D>(pt, gs, dv_acc);
    rt::bwd::tile_matmul_acc<D>(dst, qs, dk_acc);
  }
  rt::bwd::store_rows<T, D>(dk_acc, dk, nk, krow);
  rt::bwd::store_rows<T, D>(dv_acc, dv, nk, krow);
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dk, void* dv, int bh,
                       int t_q, int t_kv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (t_kv + kTile - 1) / kTile);
  return rt::launch(flash_bwd_dkv_kernel<T, D>, grid, rt::bwd::BwdSmem<D, 2>::kBytes, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
                    static_cast<T*>(dk), static_cast<T*>(dv), t_q, t_kv, causal, scale);
}

template <typename T>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v, const void* g,
                         const float* lse, const float* delta, void* dk, void* dv, int bh,
                         int t_q, int t_kv, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, g, lse, delta, dk, dv, bh, t_q, t_kv, causal, scale,
                               stream);
    case 64:
      return launch_dkv<T, 64>(q, k, v, g, lse, delta, dk, dv, bh, t_q, t_kv, causal, scale,
                               stream);
    case 128:
      return launch_dkv<T, 128>(q, k, v, g, lse, delta, dk, dv, bh, t_q, t_kv, causal, scale,
                                stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, g: [bh, t_q, d]; k, v, dk, dv:
// [bh, t_kv, d]; lse, delta: [bh, t_q] float32. All contiguous, on the
// stream's device.
extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                const void* lse, const void* delta, void* dk, void* dv,
                                int dtype, int bh, int t_q, int t_kv, int d, int causal,
                                float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return dispatch_dim<float>(d, q, k, v, g, l, dl, dk, dv, bh, t_q, t_kv, causal, scale, s);
    case 1:
      return dispatch_dim<__nv_bfloat16>(d, q, k, v, g, l, dl, dk, dv, bh, t_q, t_kv, causal,
                                         scale, s);
    default: return cudaErrorInvalidValue;
  }
}
