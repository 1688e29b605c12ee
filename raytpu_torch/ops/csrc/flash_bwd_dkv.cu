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
// scratch memory. Here one thread block owns one (b*h, 64-key tile) and
// walks the query tiles in a loop from the first row that can see the
// tile's first key (the TPU's q_of_kv clamp): query rows above the
// diagonal are neither loaded nor computed. It computes the transposed
// tiles S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are
// already the A operands of their products. Each dK and dV row has one
// writer, so no atomics, and the sums run in a fixed order. Key tiles are
// issued first-first: under the causal mask the first keys have the
// longest walks, so they start earliest.
//
// What bounds it on an H100: four products of 2*D operations per visible
// (query, key) pair against 989 TFLOP/s of bf16 tensor cores, and the
// bytes of q, k, v, dO, LSE, delta, dK and dV at 3.35 TB/s; the
// operations bound it at both train shapes. So bf16 input runs on the
// tensor cores (attention_mma.cuh): four warps of 16 keys; K and V
// resident in shared memory as bf16, Q, dO, LSE and delta streamed
// through a two-stage cp.async ring; S^T and dP^T as mma.sync m16n8k16
// into fp32 registers; P^T and dS^T in registers, masked only on tiles
// that cross the diagonal or the queries' end, each rounded to bf16
// (where the TPU kernel's p.astype(mxu) and ds.astype(mxu) round them)
// and fed straight from registers as the A operands of dV += P^T dO and
// dK += dS^T Q, with dO and Q transposed by ldmatrix. At D = 128 the dK
// and dV accumulators take 128 fp32 registers a thread, so the score
// tiles are taken 32 queries at a time (16 + 16 registers), in a loop
// kept rolled, which fits 255 registers without spills (64 queries at a
// time, or the loop unrolled, spill). Swizzled bf16 tiles take 97 KB at
// D = 128, so two blocks share an SM. fp32 input (the TPU's "f32" dot
// mode; on no main path) keeps the fp32 FMA tiles of flash_bwd_tile.cuh.

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

// The bf16 kernel on the tensor cores: one block of four warps per (b*h,
// 64 keys), warp w owning keys 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(rt::mma::kThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t_q,
                         int t_kv, int causal, float scale) {
  using namespace rt::mma;
  using rt::mma::kTile;
  constexpr int kT = kTile * D;  // elements of a [64, D] tile
  constexpr int QN = D == 128 ? 32 : 64;  // queries a pass of the scores takes
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kT;
  bf16* qs = vs + kT;      // two stages
  bf16* gs = qs + 2 * kT;  // two stages
  float* ls = reinterpret_cast<float*>(gs + 2 * kT);  // LSE, two stages
  float* dl = ls + 2 * kTile;                         // delta, two stages

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's first key of the tile
  const int gr = lane >> 2, t2 = 2 * (lane & 3);
  const int k0 = blockIdx.y * kTile;
  const int nk = min(kTile, t_kv - k0);
  const int off = t_kv - t_q;
  const long long qrow = static_cast<long long>(blockIdx.x) * t_q;
  const long long krow = static_cast<long long>(blockIdx.x) * t_kv + k0;
  // Query row i sees key j when j <= i + off: the first row that sees
  // key k0 is k0 - off.
  const int first = causal ? max(0, k0 - off) : 0;
  const int n_tiles = first < t_q ? (t_q - first + kTile - 1) / kTile : 0;

  // Q, dO, LSE and delta of the query rows q0.. into stage st; threads
  // 0-63 copy LSE, 64-127 delta.
  auto load_queries = [&](int q0, int st) {
    const int n = min(kTile, t_q - q0);
    load_tile<D>(qs + st * kT, q + (qrow + q0) * D, n);
    load_tile<D>(gs + st * kT, g + (qrow + q0) * D, n);
    const int r = threadIdx.x & (kTile - 1);
    const bool first_half = threadIdx.x < kTile;
    cp_async4((first_half ? ls : dl) + st * kTile + r,
              (first_half ? lse : delta) + qrow + q0 + (r < n ? r : 0), r < n ? 4 : 0);
  };
  load_tile<D>(ks, k + krow * D, nk);
  load_tile<D>(vs, v + krow * D, nk);
  if (n_tiles > 0) load_queries(first, 0);
  cp_async_commit();
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = first + it * kTile;
    if (it + 1 < n_tiles) load_queries(q0 + kTile, (it + 1) & 1);  // overlaps this tile
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) landed
    __syncthreads();
    const bf16* qt = qs + (it & 1) * kT;
    const bf16* gt = gs + (it & 1) * kT;
    const float* lt = ls + (it & 1) * kTile;
    const float* dt = dl + (it & 1) * kTile;
    // Kept rolled: unrolled at D = 128, the two passes spill.
#pragma unroll 1
    for (int h = 0; h < kTile; h += QN) {
      float p[QN / 8][4], ds[QN / 8][4];  // [16 keys, QN queries] each
      row_dots<D, QN>(p, ks, r0, qt, h);   // S^T = K Q^T
      row_dots<D, QN>(ds, vs, r0, gt, h);  // dP^T = V dO^T
      // P^T in place of S^T, dS^T in place of dP^T. Only a pass past the
      // queries' end or across the warp's diagonal masks.
      const bool edge = q0 + h + QN > t_q || (causal && k0 + r0 + 15 > q0 + h + off);
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = h + 8 * j + t2 + (e & 1), key = k0 + r0 + gr + 8 * (e >> 1);
          const bool live = !edge || (q0 + qc < t_q && (!causal || key <= q0 + qc + off));
          const float pe = live ? expf(p[j][e] * scale - lt[qc]) : 0.f;
          p[j][e] = pe;
          ds[j][e] = pe * (ds[j][e] - dt[qc]) * scale;
        }
      // dV += P^T dO, dK += dS^T Q: P^T and dS^T rounded to bf16 as the A
      // operands.
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) {
        uint32_t a[4];
        a_from_c<QN>(a, p, kk);
        mma_rows_t<D>(dva, a, gt, h + 16 * kk);
        a_from_c<QN>(a, ds, kk);
        mma_rows_t<D>(dka, a, qt, h + 16 * kk);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  store_rows<D>(dka, dk + (krow + r0) * D, nk - r0);
  store_rows<D>(dva, dv + (krow + r0) * D, nk - r0);
}

// bf16 runs the tensor-core kernel, float the fp32 FMA one.
template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* lse, const float* delta, void* dk, void* dv, int bh,
                       int t_q, int t_kv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (t_kv + kTile - 1) / kTile);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    // K, V, 2 x Q, 2 x dO in bf16; 2 x LSE, 2 x delta in fp32.
    const size_t smem = 6 * kTile * D * sizeof(T) + 4 * kTile * sizeof(float);
    return rt::mma::launch(flash_bwd_dkv_mma_kernel<D>, grid, smem, stream,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
                           static_cast<T*>(dk), static_cast<T*>(dv), t_q, t_kv, causal, scale);
  } else {
    return rt::launch(flash_bwd_dkv_kernel<T, D>, grid, rt::bwd::BwdSmem<D, 2>::kBytes, stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
                      static_cast<T*>(dk), static_cast<T*>(dv), t_q, t_kv, causal, scale);
  }
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

// dtype: 0 = float32 (fp32 FMA tiles), 1 = bfloat16 (tensor cores).
// q, g: [bh, t_q, d]; k, v, dk, dv: [bh, t_kv, d]; lse, delta: [bh, t_q]
// float32. All contiguous, on the stream's device.
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
