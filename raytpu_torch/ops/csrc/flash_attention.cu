// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel raytpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_forward_pallas). Same function: causal or full
// attention over q, k, v laid out [B*H, T, D], online softmax in fp32,
// output O in the input type and the log-sum-exp in fp32. The causal
// diagonal is bottom-aligned, off = t_kv - t_q, as on the TPU.
//
// The TPU walks K/V as the innermost, sequential grid dimension and
// clamps dead blocks in its index map. Here one thread block owns one
// (b*h, 64-row query tile) and walks K/V in a loop inside the block, up
// to the last key the tile's last row can see: blocks past the diagonal
// are neither loaded nor computed.
//
// What bounds it on an H100: at short T the bytes (q, k, v and o, each
// read or written once, 3.35 TB/s); at long T the operations (4*T^2*D/2
// per head under the causal mask, against 989 TFLOP/s of bf16 tensor
// cores). This first version computes on the fp32 FMA units from
// shared-memory tiles (attention_tile.cuh), so at long T it stays far
// from the tensor-core bound; what it does about the bytes is read each
// K/V tile once per 64 query rows and never materialise the T x T scores.
// Query tiles are issued last-first so the longest walks start earliest.

#include "attention_tile.cuh"

namespace {

constexpr int kRows = 64;

template <typename T, int D>
struct FlashRows {
  const T* q;
  T* o;
  float* lse;
  long long base;     // (b*h) * t_q, in rows
  long long kv_base;  // (b*h) * t_kv, in rows
  int t_q, q0, off, n_keys;
  bool causal;

  __device__ const T* q_row(int r) const {
    const int i = q0 + r;
    return i < t_q ? q + (base + i) * D : nullptr;
  }
  __device__ T* o_row(int r) const {
    const int i = q0 + r;
    return i < t_q ? o + (base + i) * D : nullptr;
  }
  __device__ void write_lse(int r, float x) const { lse[base + q0 + r] = x; }
  __device__ long long kv_offset(int key) const { return (kv_base + key) * D; }
  __device__ bool visible(int r, int key) const { return !causal || key <= q0 + r + off; }
};

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int t_q, int t_kv, int causal, float scale) {
  const int bh = blockIdx.x;
  FlashRows<T, D> pol;
  pol.q = q;
  pol.o = o;
  pol.lse = lse;
  pol.base = static_cast<long long>(bh) * t_q;
  pol.kv_base = static_cast<long long>(bh) * t_kv;
  pol.t_q = t_q;
  pol.q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // latest tiles first
  pol.off = t_kv - t_q;
  pol.causal = causal != 0;
  const int q_last = min(pol.q0 + kRows, t_q) - 1;
  pol.n_keys = pol.causal ? max(0, min(t_kv, q_last + pol.off + 1)) : t_kv;
  rt::attend<T, D, kRows>(pol, k, v, scale);
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, float* lse,
                         int bh, int t_q, int t_kv, int causal, float scale,
                         cudaStream_t stream) {
  const dim3 grid(bh, (t_q + kRows - 1) / kRows);
  return rt::launch(flash_forward_kernel<T, D>, grid, rt::TileSmem<D, kRows>::kBytes, stream,
                    static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<T*>(o), lse, t_q, t_kv, causal,
                    scale);
}

template <typename T>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int t_q, int t_kv, int causal, float scale,
                         cudaStream_t stream) {
  switch (d) {
    case 32: return launch_flash<T, 32>(q, k, v, o, lse, bh, t_q, t_kv, causal, scale, stream);
    case 64: return launch_flash<T, 64>(q, k, v, o, lse, bh, t_q, t_kv, causal, scale, stream);
    case 128: return launch_flash<T, 128>(q, k, v, o, lse, bh, t_q, t_kv, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o: [bh, t_q, d]; k, v: [bh, t_kv, d];
// lse: [bh, t_q] float32. All contiguous, on the stream's device.
extern "C" int rt_flash_forward(const void* q, const void* k, const void* v, void* o,
                                void* lse, int dtype, int bh, int t_q, int t_kv, int d,
                                int causal, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return dispatch_dim<float>(d, q, k, v, o, l, bh, t_q, t_kv, causal, scale, s);
    case 1:
      return dispatch_dim<__nv_bfloat16>(d, q, k, v, o, l, bh, t_q, t_kv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
