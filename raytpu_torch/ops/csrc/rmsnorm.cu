// RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel raytpu/ops/fused.py::_rmsnorm_kernel (launched
// by rmsnorm through pl.pallas_call). Same function, row by row over x
// laid out [N, D]:
//
//   out = (x_f32 * rsqrt(mean(x_f32^2) + eps) * scale_f32), cast to x's type,
//
// with the two products in that order, as _rmsnorm_ref. The TPU pads the
// rows to blocks of 256 and normalises a whole block in VMEM; here one
// thread block owns one row, so nothing is padded.
//
// What bounds it on an H100: the bytes. It reads x once, writes out once
// and reads the fp32 scale (which stays in L2), against 3.35 TB/s; its
// 3 operations an element are nothing beside that. So the design moves
// each byte of x across device memory once: the block loads its row in
// 16-byte vectors (several in flight per thread) into shared memory,
// summing the squares in fp32 on the way; the sum goes across the warp by
// shuffles and across warps through shared memory; one rsqrtf; then the
// second pass reads the row back from shared memory and writes 16-byte
// vectors. A row whose bytes are not a multiple of 16 takes the same two
// passes one element at a time. Each output row has one writer: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kInFlight = 4;  // loads a thread issues before it uses one

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A unit is what one thread moves at once: a 16-byte vector of T, or one T,
// held in a 16-byte register vector either way.
template <typename T, bool kVector>
struct Unit {
  static constexpr int kElems = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
  uint4 raw;
  __device__ __forceinline__ T* v() { return reinterpret_cast<T*>(&raw); }
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kVector) {
      raw = *reinterpret_cast<const uint4*>(p);
    } else {
      v()[0] = *p;
    }
  }
  __device__ __forceinline__ void store(T* p) {
    if constexpr (kVector) {
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
      *p = v()[0];
    }
  }
};

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
               int d, float eps) {
  using U = Unit<T, kVector>;
  constexpr int E = U::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);  // the row, d elements of T
  __shared__ float red[kMaxThreads / 32];

  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  const int units = d / E;
  const int step = blockDim.x;

  // Pass 1: device memory -> shared memory, sum of squares in fp32.
  float ss = 0.0f;
  for (int u0 = threadIdx.x; u0 < units; u0 += kInFlight * step) {
    U buf[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int u = u0 + j * step;
      if (u < units) buf[j].load(xr + u * E);
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int u = u0 + j * step;
      if (u < units) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float f = to_float(buf[j].v()[e]);
          ss += f * f;
        }
        buf[j].store(row + u * E);
      }
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);

  // Pass 2: shared memory -> device memory; (x * r) * scale, rounded once.
  T* orow = out + base;
  for (int u = threadIdx.x; u < units; u += step) {
    U in, o;
    in.load(row + u * E);
    float s[E];
    if constexpr (kVector && E == 8) {
      const float4 s0 = *reinterpret_cast<const float4*>(scale + u * E);
      const float4 s1 = *reinterpret_cast<const float4*>(scale + u * E + 4);
      s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
      s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
    } else if constexpr (kVector && E == 4) {
      const float4 s0 = *reinterpret_cast<const float4*>(scale + u * E);
      s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) s[e] = scale[u * E + e];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float y = __fmul_rn(__fmul_rn(to_float(in.v()[e]), r), s[e]);
      from_float(&o.v()[e], y);
    }
    o.store(orow + u * E);
  }
}

template <typename T, bool kVector>
cudaError_t launch(const void* x, const float* scale, void* out, int n_rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int E = Unit<T, kVector>::kElems;
  const int units = d / E;
  // One thread per unit up to kMaxThreads, in whole warps.
  const int threads = units >= kMaxThreads ? kMaxThreads : ((units + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(d) * sizeof(T);
  auto kernel = rmsnorm_kernel<T, kVector>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_rows, threads, smem, stream>>>(static_cast<const T*>(x), scale,
                                            static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* scale, void* out, int n_rows, int d, float eps,
                     cudaStream_t stream) {
  // 16-byte vectors where every row starts on a 16-byte boundary (the
  // wrapper passes 16-byte aligned x, scale and out).
  if ((static_cast<long long>(d) * sizeof(T)) % 16 == 0)
    return launch<T, true>(x, scale, out, n_rows, d, eps, stream);
  return launch<T, false>(x, scale, out, n_rows, d, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out: [n_rows, d] of that type;
// scale: [d] float32. All contiguous, on the stream's device.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out, int n_rows, int d,
                          int dtype, float eps, void* stream) {
  if (n_rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (dtype) {
    case 0: return dispatch<float>(x, sc, out, n_rows, d, eps, s);
    case 1: return dispatch<__nv_bfloat16>(x, sc, out, n_rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
