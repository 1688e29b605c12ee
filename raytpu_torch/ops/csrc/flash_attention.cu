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
// are neither loaded nor computed. Query tiles are issued last-first so
// the longest walks start earliest.
//
// What bounds it on an H100: at short T the bytes (q, k, v and o, each
// read or written once, 3.35 TB/s); at long T the operations (4*T^2*D/2
// per head under the causal mask, against 989 TFLOP/s of bf16 tensor
// cores). So bf16 input runs on the tensor cores (attention_mma.cuh's
// engine): four warps of 16 query rows, Q's fragments in registers, K and
// V streamed in 64-key tiles through a two-stage cp.async ring, the score
// tile kept in registers, and P rounded to bf16 before P V where the TPU
// kernel rounds it (p.astype(mxu)), with l summed from the fp32 P. Each K/V
// tile is read once per 64 query rows and the T x T scores never reach
// memory. fp32 input (the TPU's "f32" dot mode; on no main path) keeps the
// fp32 FMA engine of attention_tile.cuh.

#include <type_traits>

#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

constexpr int kRows = 64;
static_assert(rt::mma::kTile == kRows, "both engines own 64 query rows a block");

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

// The rows of this block: (b*h = blockIdx.x, the query tile of blockIdx.y,
// latest tiles first).
template <typename T, int D>
__device__ FlashRows<T, D> block_rows(const T* q, T* o, float* lse, int t_q, int t_kv,
                                      int causal) {
  FlashRows<T, D> pol;
  pol.q = q;
  pol.o = o;
  pol.lse = lse;
  pol.base = static_cast<long long>(blockIdx.x) * t_q;
  pol.kv_base = static_cast<long long>(blockIdx.x) * t_kv;
  pol.t_q = t_q;
  pol.q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  pol.off = t_kv - t_q;
  pol.causal = causal != 0;
  const int q_last = min(pol.q0 + kRows, t_q) - 1;
  pol.n_keys = pol.causal ? max(0, min(t_kv, q_last + pol.off + 1)) : t_kv;
  return pol;
}

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int t_q, int t_kv, int causal, float scale) {
  rt::attend<T, D, kRows>(block_rows<T, D>(q, o, lse, t_q, t_kv, causal), k, v, scale);
}

// At least one block an SM: without the bound ptxas holds the D = 64
// instance to 128 registers and spills; with it, 154 and no spills.
template <int D>
__global__ void __launch_bounds__(rt::mma::kThreads, 1)
flash_forward_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int t_q, int t_kv, int causal, float scale) {
  rt::mma::attend<D>(block_rows<__nv_bfloat16, D>(q, o, lse, t_q, t_kv, causal), k, v,
                     scale);
}

// bf16 runs the tensor-core kernel, float the fp32 FMA one.
template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, float* lse,
                         int bh, int t_q, int t_kv, int causal, float scale,
                         cudaStream_t stream) {
  const dim3 grid(bh, (t_q + kRows - 1) / kRows);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const size_t smem = 5 * kRows * D * sizeof(T);  // Q, 2 x K, 2 x V
    return rt::mma::launch(flash_forward_mma_kernel<D>, grid, smem, stream, qp, kp, vp, op,
                           lse, t_q, t_kv, causal, scale);
  } else {
    return rt::launch(flash_forward_kernel<T, D>, grid, rt::TileSmem<D, kRows>::kBytes, stream,
                      qp, kp, vp, op, lse, t_q, t_kv, causal, scale);
  }
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

// dtype: 0 = float32 (fp32 FMA tiles), 1 = bfloat16 (tensor cores).
// q, o: [bh, t_q, d]; k, v: [bh, t_kv, d]; lse: [bh, t_q] float32. All
// contiguous, on the stream's device.
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
