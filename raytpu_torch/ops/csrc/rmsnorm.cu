// RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel raytpu/ops/fused.py::_rmsnorm_kernel (launched
// by rmsnorm through pl.pallas_call). Same function, row by row over x
// laid out [N, D]:
//
//   out = (x_f32 * rsqrt(mean(x_f32^2) + eps) * scale_f32), cast to x's type,
//
// with the two products in that order, as _rmsnorm_ref. The scale is read
// in its own type (fp32 or bf16; bf16 -> fp32 is exact), so the wrapper
// launches no cast. The TPU pads the rows to blocks of 256 and normalises
// a whole block in VMEM; here nothing is padded.
//
// What bounds it on an H100: the bytes. It reads x once and writes out once
// against 3.35 TB/s; its 3 operations an element are nothing beside that.
// So the design keeps device memory busy and moves each byte once
// (rmsnorm_ring_kernel):
//
// - A grid planned on the host (fused.plan_rows): one row a block where the
//   rows fit the card at once; for more rows, a persistent grid of as many
//   blocks as the card holds at once, each walking the rows blockIdx.x,
//   += gridDim.x; for an x that streams from device memory (larger than
//   most of the L2), blocks of two rows, since long walks lost 3-8 % there.
// - A ring of `stages` rows in shared memory, filled by the TMA's 1-D bulk
//   copy (cp.async.bulk, global -> shared, completion counted in bytes on
//   the stage's mbarrier). One thread issues the copy of the row `stages`
//   ahead; the block's threads wait on the stage's barrier phase. While
//   they reduce and write one row, the next rows are in flight, and no
//   thread spends registers or instructions on loading them.
// - Each thread holds its columns of the scale in registers for the whole
//   walk, loaded once a block while the first rows are in flight.
// - A thread reads its 16-byte units of the arrived row into registers and
//   sums their squares in fp32; the sum goes across the warp by shuffles
//   and across warps through shared memory (one __syncthreads a row).
//   After that barrier no thread reads the stage again, so it is refilled
//   at once, and the thread writes its units from registers as 16-byte
//   stores.
// Rows with more units a thread than kPerMax re-read the stage and the
// scale (from L2) in a second pass, and refill the stage after it. A row
// whose bytes are not a multiple of 16 can be neither bulk-copied nor
// loaded in 16-byte vectors: rmsnorm_kernel takes it, one block a row,
// element by element. Each output row has one writer: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a block's threads at most, whole warps
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // of kThreads an SM: at most 64 registers a thread
constexpr int kMaxStages = 3;  // rows a block has in flight at most (fused._STAGES)
constexpr int kPerMax = 4;     // 16-byte units a thread holds in registers
constexpr int kInFlight = 4;   // element path: loads a thread issues before it uses one
constexpr int kSmemDefault = 47 * 1024;  // dynamic bytes without opting in (fused._SMEM_DEFAULT)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The sum of x over the block, returned to every thread: each warp adds by
// shuffles, lane 0 posts the warp's sum in red[warp], and after the barrier
// every warp adds the posts in the same order (so all get the same value).
// A caller that sums again must pass another red until every thread has
// passed a later barrier.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// E consecutive scale values from p (16-byte aligned for an fp32 scale,
// 2E-byte aligned for a bf16 one) as fp32.
template <int E>
__device__ __forceinline__ void load_scale(const float* p, float* s) {
#pragma unroll
  for (int k = 0; k < E; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    s[k] = v.x; s[k + 1] = v.y; s[k + 2] = v.z; s[k + 3] = v.w;
  }
}
template <int E>
__device__ __forceinline__ void load_scale(const __nv_bfloat16* p, float* s) {
  static_assert(E == 4 || E == 8, "a unit is 16 bytes of fp32 or bf16");
  using Raw = typename std::conditional<E == 8, uint4, uint2>::type;
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) s[e] = __bfloat162float(b[e]);
}

// ---- the bulk-copy ring (PTX for sm_90) ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier: the
// phase completes when they have landed.
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from global `src` to shared `dst` by the TMA, counted on `bar`.
// Both addresses 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// kPer > 0: each thread holds up to kPer 16-byte units of the row and of the
// scale in registers (units t, t + blockDim.x, ...); kPer == 0: any width,
// two passes over the stage. `stages` rows in flight, 1..kMaxStages.
template <typename T, typename S, int kPer>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rmsnorm_ring_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                    int n_rows, int d, float eps, int stages) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ float red[2][kWarps];

  const int units = d / E;
  const uint32_t row_bytes = static_cast<uint32_t>(d) * sizeof(T);
  const int mine = (n_rows - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);  // this block's rows
  auto row_at = [&](int i) {  // the offset of this block's i-th row
    return (static_cast<long long>(blockIdx.x) + static_cast<long long>(i) * gridDim.x) * d;
  };
  auto stage_at = [&](int s) { return ring + static_cast<size_t>(s) * row_bytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) barrier_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages && i < mine; ++i) {
      barrier_expect(&full[i], row_bytes);
      bulk_load(stage_at(i), x + row_at(i), row_bytes, &full[i]);
    }
  }
  // Refill stage s with row i + stages once no thread reads it any more:
  // the proxy fence orders the block's reads before the TMA's writes.
  auto refill = [&](int i, int s) {
    if (threadIdx.x == 0 && i + stages < mine) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      barrier_expect(&full[s], row_bytes);
      bulk_load(stage_at(s), x + row_at(i + stages), row_bytes, &full[s]);
    }
  };

  float sc[kPer > 0 ? kPer : 1][E];
  if constexpr (kPer > 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = threadIdx.x + j * blockDim.x;
      if (u < units) load_scale<E>(scale + u * E, sc[j]);
    }
  }

  int s = 0;
  uint32_t parity = 0;
  for (int i = 0; i < mine; ++i) {
    barrier_wait(&full[s], parity);
    const T* row = reinterpret_cast<const T*>(stage_at(s));
    T* orow = out + row_at(i);
    float ss = 0.0f;
    if constexpr (kPer > 0) {
      uint4 v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int u = threadIdx.x + j * blockDim.x;
        if (u < units) {
          v[j] = *reinterpret_cast<const uint4*>(row + u * E);
          const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const float f = to_float(e[k]);
            ss += f * f;
          }
        }
      }
      const float r = rsqrtf(block_sum(ss, red[i & 1]) / static_cast<float>(d) + eps);
      refill(i, s);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int u = threadIdx.x + j * blockDim.x;
        if (u < units) {
          const T* e = reinterpret_cast<const T*>(&v[j]);
          uint4 o;
          T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int k = 0; k < E; ++k)
            from_float(&oe[k], __fmul_rn(__fmul_rn(to_float(e[k]), r), sc[j][k]));
          *reinterpret_cast<uint4*>(orow + u * E) = o;
        }
      }
    } else {
      for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + u * E);
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float f = to_float(e[k]);
          ss += f * f;
        }
      }
      const float r = rsqrtf(block_sum(ss, red[i & 1]) / static_cast<float>(d) + eps);
      for (int u = threadIdx.x; u < units; u += blockDim.x) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + u * E);
        const T* e = reinterpret_cast<const T*>(&v);
        float su[E];
        load_scale<E>(scale + u * E, su);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int k = 0; k < E; ++k)
          from_float(&oe[k], __fmul_rn(__fmul_rn(to_float(e[k]), r), su[k]));
        *reinterpret_cast<uint4*>(orow + u * E) = o;
      }
      __syncthreads();
      refill(i, s);
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1u;
    }
  }
}

// The element path: one block a row, the row staged in shared memory.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out, int d,
               float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);  // the row, d elements of T
  __shared__ float red[kWarps];

  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  const int step = blockDim.x;

  // Pass 1: device memory -> shared memory, sum of squares in fp32.
  float ss = 0.0f;
  for (int u0 = threadIdx.x; u0 < d; u0 += kInFlight * step) {
    T buf[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int u = u0 + j * step;
      if (u < d) buf[j] = xr[u];
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int u = u0 + j * step;
      if (u < d) {
        const float f = to_float(buf[j]);
        ss += f * f;
        row[u] = buf[j];
      }
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);

  // Pass 2: shared memory -> device memory; (x * r) * scale, rounded once.
  T* orow = out + base;
  for (int u = threadIdx.x; u < d; u += step)
    from_float(&orow[u], __fmul_rn(__fmul_rn(to_float(row[u]), r), to_float(scale[u])));
}

// The element path: one thread an element up to kThreads, in whole warps.
int threads_for(int units) { return units >= kThreads ? kThreads : ((units + 31) / 32) * 32; }

// Opt the kernel in to `smem` dynamic bytes where that is over the default.
// A refusal is returned and also cleared, so that the next launch's
// cudaGetLastError does not report it again.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= static_cast<size_t>(kSmemDefault)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <typename T, typename S, int kPer>
cudaError_t launch_ring(const void* x, const void* scale, void* out, int n_rows, int d, float eps,
                        int blocks, int stages, int threads, cudaStream_t stream) {
  auto kernel = rmsnorm_ring_kernel<T, S, kPer>;
  const size_t smem = static_cast<size_t>(stages) * d * sizeof(T);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x),
                                            static_cast<const S*>(scale), static_cast<T*>(out),
                                            n_rows, d, eps, stages);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dispatch(const void* x, const void* scale, void* out, int n_rows, int d, float eps,
                     int blocks, int stages, int threads, cudaStream_t stream) {
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  if (stages == 0) {  // the element path
    auto kernel = rmsnorm_kernel<T, S>;
    const size_t smem = static_cast<size_t>(row_bytes);
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<n_rows, threads_for(d), smem, stream>>>(static_cast<const T*>(x),
                                                     static_cast<const S*>(scale),
                                                     static_cast<T*>(out), d, eps);
    return cudaGetLastError();
  }
  // The ring: every row on a 16-byte boundary (the wrapper passes 16-byte
  // aligned x, scale and out), 1..kMaxStages rows in flight, 1..n_rows
  // blocks of whole warps, at most kThreads.
  if (row_bytes % 16 != 0 || stages < 0 || stages > kMaxStages || blocks < 1 ||
      blocks > n_rows || threads < 32 || threads > kThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int units = static_cast<int>(row_bytes / 16);
  const int per = (units + threads - 1) / threads;
  if (per <= 1)
    return launch_ring<T, S, 1>(x, scale, out, n_rows, d, eps, blocks, stages, threads, stream);
  if (per <= 2)
    return launch_ring<T, S, 2>(x, scale, out, n_rows, d, eps, blocks, stages, threads, stream);
  if (per <= kPerMax)
    return launch_ring<T, S, kPerMax>(x, scale, out, n_rows, d, eps, blocks, stages, threads,
                                      stream);
  return launch_ring<T, S, 0>(x, scale, out, n_rows, d, eps, blocks, stages, threads, stream);
}

template <typename T>
cudaError_t dispatch_scale(const void* x, const void* scale, void* out, int n_rows, int d,
                           int scale_dtype, float eps, int blocks, int stages, int threads,
                           cudaStream_t stream) {
  switch (scale_dtype) {
    case 0:
      return dispatch<T, float>(x, scale, out, n_rows, d, eps, blocks, stages, threads, stream);
    case 1:
      return dispatch<T, __nv_bfloat16>(x, scale, out, n_rows, d, eps, blocks, stages, threads,
                                        stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype, scale_dtype: 0 = float32, 1 = bfloat16. x, out: [n_rows, d] of
// dtype; scale: [d] of scale_dtype. All contiguous and 16-byte aligned, on
// the stream's device. stages 0: the element path (one block a row, any d;
// blocks and threads unread); else the ring on `blocks` blocks of `threads`
// with `stages` rows in flight (d * size a multiple of 16), as
// fused.plan_rows plans them.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out, int n_rows, int d,
                          int dtype, int scale_dtype, float eps, int blocks, int stages,
                          int threads, void* stream) {
  if (n_rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_scale<float>(x, scale, out, n_rows, d, scale_dtype, eps, blocks, stages,
                                   threads, s);
    case 1:
      return dispatch_scale<__nv_bfloat16>(x, scale, out, n_rows, d, scale_dtype, eps, blocks,
                                           stages, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
