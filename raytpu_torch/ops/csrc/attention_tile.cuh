// Tile engine shared by the port's two attention kernels
// (flash_attention.cu and paged_attention.cu).
//
// One thread block owns BR query rows and walks their keys in tiles of
// kBK, keeping the online-softmax state (running max m, denominator l)
// in shared memory and the output accumulator in registers, all fp32:
//
//   S = Q K^T * scale   (masked entries set to -1e30, as the JAX kernels)
//   m' = max(m, rowmax S);  P = exp(S - m');  c = exp(m - m')
//   l = l c + rowsum P;     O = O c + P V;    m = m'
//
// and at the end O / max(l, 1e-30) and lse = m + log(l).
//
// The two kernels differ only in where their rows and keys live and in
// the mask. Each passes a Policy that answers:
//
//   int n_keys;                          keys 0..n_keys-1 are walked
//   const T* q_row(int r) const;         row r's query vector, or nullptr
//   long long kv_offset(int key) const;  element offset of key's K/V vector
//   bool visible(int r, int key) const;  the mask
//   T* o_row(int r) const;               row r's output vector, or nullptr
//   void write_lse(int r, float) const;  called for rows with an output
//
// Design: plain shared-memory tiles and fp32 FMA, 256 threads as a
// 16 x 16 grid. For the scores a thread owns rows ty + 16 i and keys
// tx + 16 j; for the output it owns rows ty + 16 i and channels tx + 16 j.
// Rows of Q and K in shared memory are padded by one float so the 16 keys
// a warp reads at one channel fall in 16 different banks. Bytes come in
// as 16-byte vector loads, all of a tile's issued before any is used (so
// a tile costs one memory latency, not one per load), and are converted
// to fp32 once, on their way into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

constexpr int kThreads = 256;
constexpr int kBK = 32;            // keys per tile: one per lane in the softmax
constexpr float kNegInf = -1e30f;  // the mask value of the JAX kernels

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T, loaded as one vector and unpacked to floats.
template <typename T>
constexpr int kVec = 16 / sizeof(T);
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout, in floats, of a block with BR rows and head dim D.
template <int D, int BR>
struct TileSmem {
  static constexpr int kQS = D + 1;    // padded row strides
  static constexpr int kKS = D + 1;
  static constexpr int kVS = D;
  static constexpr int kPS = kBK + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BR * kQS;
  static constexpr int kV = kK + kBK * kKS;
  static constexpr int kP = kV + kBK * kVS;
  static constexpr int kM = kP + BR * kPS;
  static constexpr int kL = kM + BR;
  static constexpr int kC = kL + BR;
  static constexpr int kOff = (kC + BR + 1) & ~1;  // 8-byte aligned
  static constexpr size_t kBytes = kOff * sizeof(float) + kBK * sizeof(long long);
};

template <typename T, int D, int BR, class Policy>
__device__ __forceinline__ void attend(const Policy& pol, const T* __restrict__ k,
                                       const T* __restrict__ v, float scale) {
  static_assert(D % 16 == 0 && BR % 16 == 0, "tile shape");
  using S = TileSmem<D, BR>;
  constexpr int RM = BR / 16;   // rows per thread
  constexpr int CN = kBK / 16;  // score columns per thread
  constexpr int DN = D / 16;    // output channels per thread
  constexpr int E = kVec<T>;    // elements per 16-byte vector
  constexpr int CH = D / E;     // vectors per row
  constexpr int NQ = (BR * CH + kThreads - 1) / kThreads;   // per thread
  constexpr int NKV = (kBK * CH + kThreads - 1) / kThreads;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* qs = sm + S::kQ;
  float* ks = sm + S::kK;
  float* vs = sm + S::kV;
  float* ps = sm + S::kP;
  float* ms = sm + S::kM;
  float* ls = sm + S::kL;
  float* cs = sm + S::kC;
  long long* offs = reinterpret_cast<long long*>(sm + S::kOff);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;

  {
    uint4 qv[NQ];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int idx = tid + n * kThreads, r = idx / CH;
      const T* row = idx < BR * CH ? pol.q_row(r) : nullptr;
      qv[n] = row ? *reinterpret_cast<const uint4*>(row + (idx - r * CH) * E)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int idx = tid + n * kThreads, r = idx / CH;
      if (idx < BR * CH) unpack(qv[n], qs + r * S::kQS + (idx - r * CH) * E, T());
    }
  }
  for (int r = tid; r < BR; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  const int n_tiles = (pol.n_keys + kBK - 1) / kBK;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    // The previous tile's readers of offs/ks/vs/ps/cs are done (and, on
    // the first pass, Q and the softmax state are written).
    __syncthreads();
    if (tid < kBK) offs[tid] = (k0 + tid < pol.n_keys) ? pol.kv_offset(k0 + tid) : -1;
    __syncthreads();
    {
      uint4 kv[NKV], vv[NKV];  // keys past n_keys are zeros, never garbage
#pragma unroll
      for (int n = 0; n < NKV; ++n) {
        const int idx = tid + n * kThreads, s = idx / CH;
        const long long off = idx < kBK * CH ? offs[s] : -1;
        kv[n] = vv[n] = make_uint4(0u, 0u, 0u, 0u);
        if (off >= 0) {
          const long long at = off + (idx - s * CH) * E;
          kv[n] = *reinterpret_cast<const uint4*>(k + at);
          vv[n] = *reinterpret_cast<const uint4*>(v + at);
        }
      }
#pragma unroll
      for (int n = 0; n < NKV; ++n) {
        const int idx = tid + n * kThreads, s = idx / CH;
        if (idx < kBK * CH) {
          unpack(kv[n], ks + s * S::kKS + (idx - s * CH) * E, T());
          unpack(vv[n], vs + s * S::kVS + (idx - s * CH) * E, T());
        }
      }
    }
    __syncthreads();

    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RM], kb[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = qs[(ty + 16 * i) * S::kQS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kb[j] = ks[(tx + 16 * j) * S::kKS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 16 * j, key = k0 + c;
        const bool live = key < pol.n_keys && pol.visible(r, key);
        ps[r * S::kPS + c] = live ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one warp per row, one key per lane.
    for (int r = warp; r < BR; r += kThreads / 32) {
      const float s = ps[r * S::kPS + lane];
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      ps[r * S::kPS + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * corr + sum;
        cs[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float corr = cs[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
    }
#pragma unroll 8
    for (int s = 0; s < kBK; ++s) {
      float pa[RM], vb[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pa[i] = ps[(ty + 16 * i) * S::kPS + s];
#pragma unroll
      for (int j = 0; j < DN; ++j) vb[j] = vs[s * S::kVS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    T* o = pol.o_row(r);
    if (o == nullptr) continue;
    const float l = fmaxf(ls[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j) store(o + tx + 16 * j, acc[i][j] / l);
    if (tx == 0) pol.write_lse(r, ms[r] + logf(l));
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed, then
// launch; returns the launch's error (a refused launch never runs, and a
// later synchronize would not report it).
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace rt

extern "C" const char* rt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
