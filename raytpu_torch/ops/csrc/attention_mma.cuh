// Tensor-core building blocks of the port's bf16 attention kernels: the
// flash forward (flash_attention.cu), the paged kernel's chunk path
// (paged_attention.cu) and the flash backward (flash_bwd_dq.cu,
// flash_bwd_dkv.cu).
//
// Products run as mma.sync.m16n8k16 (bf16 operands, fp32 accumulators) on
// Hopper's tensor cores. A block is four warps; each warp owns 16 of the
// block's 64 rows (query rows in the forward and dQ, keys in dK/dV) and
// walks the other side in tiles of 64. Operands come from shared memory by
// ldmatrix, transposed (.trans) where a product needs its B operand that
// way.
//
// Tiles of [64, D] bf16 live in shared memory with their 16-byte chunks
// XOR-swizzled by row, so that the eight rows one ldmatrix phase reads at
// one column fall in eight different bank groups (a row of D = 128 is 256
// bytes: unswizzled, all eight would hit the same four banks). Tiles
// arrive by cp.async, issued one loop step ahead of their use (a
// two-stage ring), with rows past the tensor's end zero-filled.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"; lane l, g = l / 4, t = l % 4):
//   C, 16 x 8 fp32:  c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g+8.
//   A, 16 x 16 bf16: a0 row g, k 2t..; a1 row g+8, k 2t..;
//                    a2 row g, k 2t+8..; a3 row g+8, k 2t+8.. (pairs).
//   B, 16 x 8 bf16:  b0 k 2t.., column g; b1 k 2t+8.., column g (pairs).
// So the C fragments of two neighbouring 8-column groups, packed to bf16,
// are the A fragment of a 16-deep product: a score tile computed in
// registers feeds the next product without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows a block owns; rows of a streamed tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the mask value of the JAX kernels

// Element offset of 16-byte chunk c (elements 8c..8c+7) of row r in a
// swizzled [rows, D] tile. Eight consecutive rows from a multiple of 8
// put one logical chunk in eight different 16-byte bank groups: the XOR
// spans eight chunks, or, at D = 32 (two rows to 128 bytes), four chunks
// of every other row.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  constexpr int kChunks = D / 8;
  constexpr int kSpan = kChunks < 8 ? kChunks : 8;
  constexpr int kShift = kChunks < 8 ? 1 : 0;
  return r * D + ((c ^ ((r >> kShift) & (kSpan - 1))) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; with bytes = 0 the destination is
// zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows 0..n-1 (n >= 1) of the [64, D] tile at src (row stride D) into the
// swizzled tile dst by cp.async, rows n..63 zero-filled; the caller
// commits.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int n) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < kTile * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / kChunks, c = i % kChunks;
    const bool live = r < n;
    cp_async16(dst + swz<D>(r, c), src + (live ? r : 0) * D + c * 8, live ? 16 : 0);
  }
}

// Four 8 x 8 bf16 matrices of the swizzled tile from row r0 and column c0
// (multiples of 16 and 8): lanes 0-15 address rows r0..r0+15 at columns
// c0..c0+7, lanes 16-31 the same rows at c0+8..c0+15. Read as
//   - ldsm: the A fragment of rows r0.., depth c0..c0+15; or the B
//     fragments of the 8-column groups r0.. (x[0], x[2]) and r0+8..
//     (x[1], x[3]), depth c0.., of a tile stored [n][k];
//   - ldsm_t (transposed): the B fragments of the 8-column groups c0..
//     (x[0], x[1]) and c0+8.. (x[2], x[3]), depth r0.., of a tile stored
//     [k][n].
template <int D>
__device__ __forceinline__ const bf16* frag(const bf16* tile, int r0, int c0) {
  const int l = threadIdx.x & 31;
  return tile + swz<D>(r0 + (l & 15), (c0 >> 3) + (l >> 4));
}
__device__ __forceinline__ void ldsm(uint32_t (&x)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&x)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: m16n8k16, bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += a (16 x 16) times the 16 x 8 column groups j of a [64, D]
// tile: with rows k0..k0+15 of a tile stored [k][n] (ldsm_t), over all D
// of its columns.
template <int D>
__device__ __forceinline__ void mma_rows_t(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                           const bf16* tile, int k0) {
#pragma unroll
  for (int n = 0; n < D; n += 16) {
    uint32_t b[4];
    ldsm_t(b, frag<D>(tile, k0, n));
    mma(acc[n / 8], a, b[0], b[1]);
    mma(acc[n / 8 + 1], a, b[2], b[3]);
  }
}

// acc (16 rows x N columns) = rows r0..r0+15 of tile a times the rows
// n0..n0+N-1 of tile b, transposed: the dot products of two [64, D]
// tiles' rows, both stored [row][D].
template <int D, int N>
__device__ __forceinline__ void row_dots(float (&acc)[N / 8][4], const bf16* a_tile, int r0,
                                         const bf16* b_tile, int n0) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldsm(a, frag<D>(a_tile, r0, kk));
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      uint32_t b[4];
      ldsm(b, frag<D>(b_tile, n0 + n, kk));
      mma(acc[n / 8], a, b[0], b[2]);
      mma(acc[n / 8 + 1], a, b[1], b[3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A fragment of columns 16 kk.. of a 16-row fp32 C tile: each
// value rounded once to bf16, as the TPU kernels' .astype(mxu) does.
template <int N>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c)[N / 8][4],
                                         int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// A warp's [16, D] fp32 accumulator, rows 0..n-1 of it, written in bf16
// at out (row stride D), the warp's first row at out.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], bf16* out, int n) {
  const int l = threadIdx.x & 31, g = l >> 2, t2 = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (g + 8 * i >= n) continue;
    bf16* row = out + static_cast<long long>(g + 8 * i) * D + t2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// The forward's tile engine: one block of four warps owns 64 rows and
// walks their keys in tiles of 64, in the TPU kernel's order,
//
//   S = (Q K^T) * scale         fp32 accumulators; masked entries -1e30,
//                               only on tiles that reach past a row's
//                               last visible key
//   m' = max(m, rowmax S);  P = exp(S - m');  c = exp(m - m')
//   l = l c + rowsum P          from the fp32 P
//   O = O c + bf16(P) V         P rounded once, as the TPU's p.astype(mxu)
//
// and at the end O / max(l, 1e-30) and lse = m + log(l). The rows and
// keys are the Policy's (the same interface as attention_tile.cuh's
// engine, bf16 throughout):
//
//   int n_keys;                          keys 0..n_keys-1 are walked
//   const bf16* q_row(int r) const;      row r's query vector, or nullptr
//   long long kv_offset(int key) const;  element offset of key's K/V vector
//   bool visible(int r, int key) const;  the mask; a row that sees a key
//                                        sees every earlier one, and a
//                                        later row sees at least as much
//   bf16* o_row(int r) const;            row r's output vector, or nullptr
//   void write_lse(int r, float) const;  called for rows with an output
//
// Q's fragments are loaded once into registers; K and V stream through a
// two-stage cp.async ring, K as the B operand of Q K^T (ldmatrix), V
// transposed for P V (ldmatrix.trans). The score tile stays in registers:
// its row max and row sum run over the quad of lanes that owns a row, and
// its C fragments become P's A fragments (a_from_c). Each thread keeps its
// own share of l and sums the quad's at the end. Dynamic shared memory:
// Q and two stages each of K and V, 5 * 64 * D bf16.
template <int D, class Policy>
__device__ __forceinline__ void attend(const Policy& pol, const bf16* __restrict__ k,
                                       const bf16* __restrict__ v, float scale) {
  constexpr int kT = kTile * D;  // elements of a [64, D] tile
  constexpr int kN = kTile / 8;  // 8-key column groups of a score tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kT;      // two stages
  bf16* vs = ks + 2 * kT;  // two stages

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's first row
  const int gr = lane >> 2, t2 = 2 * (lane & 3);
  const int n_tiles = (pol.n_keys + kTile - 1) / kTile;

  constexpr int kChunks = D / 8;
  // K and V rows k0.. of the walk into stage st; keys past n_keys are zeros.
  auto load_kv = [&](int st, int k0) {
#pragma unroll
    for (int j = 0; j < kTile * kChunks / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / kChunks, c = i % kChunks;
      const bool live = k0 + r < pol.n_keys;
      const long long at = live ? pol.kv_offset(k0 + r) + c * 8 : 0;
      cp_async16(ks + st * kT + swz<D>(r, c), k + at, live ? 16 : 0);
      cp_async16(vs + st * kT + swz<D>(r, c), v + at, live ? 16 : 0);
    }
  };

  // Q's rows; rows past the Policy's are zeros (k stands in as a source).
#pragma unroll
  for (int j = 0; j < kTile * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / kChunks, c = i % kChunks;
    const bf16* row = pol.q_row(r);
    cp_async16(qs + swz<D>(r, c), row ? row + c * 8 : k, row ? 16 : 0);
  }
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q landed
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm(qa[kk], frag<D>(qs, r0, 16 * kk));

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Rows r0 + gr and r0 + gr + 8: the running max, and this thread's
  // share of the running sum.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, k0 + kTile);  // overlaps this tile
    cp_async_commit();
    cp_async_wait<1>();  // this tile landed
    __syncthreads();
    const bf16* kt = ks + (it & 1) * kT;
    const bf16* vt = vs + (it & 1) * kT;

    float s[kN][4];  // [16 rows, 64 keys]
#pragma unroll
    for (int j = 0; j < kN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kTile; n += 16) {
        uint32_t b[4];
        ldsm(b, frag<D>(kt, n, 16 * kk));
        mma(s[n / 8], qa[kk], b[0], b[2]);
        mma(s[n / 8 + 1], qa[kk], b[1], b[3]);
      }
    // Every row of the warp sees the whole tile unless its first row
    // misses the tile's last key.
    const int k_last = k0 + kTile - 1;
    const bool edge = !(k_last < pol.n_keys && pol.visible(r0, k_last));
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + 8 * j + t2 + (e & 1);
        float x = s[j][e] * scale;
        if (edge && !(key < pol.n_keys && pol.visible(r0 + gr + 8 * i, key))) x = kNegInf;
        s[j][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float c[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      c[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * c[i] + rs[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= c[0];
      acc[j][1] *= c[0];
      acc[j][2] *= c[1];
      acc[j][3] *= c[1];
    }
    // O += bf16(P) V, P's C fragments as the A operand.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      a_from_c<kTile>(a, s, kk);
      mma_rows_t<D>(acc, a, vt, 16 * kk);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + gr + 8 * i;
    bf16* o = pol.o_row(r);
    if (o == nullptr) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + t2) =
          __floats2bfloat162_rn(acc[j][2 * i] / li, acc[j][2 * i + 1] / li);
    if ((lane & 3) == 0) pol.write_lse(r, m[i] + logf(li));
  }
}

// Launch with kThreads threads and smem bytes of dynamic shared memory,
// the SM's carve-out set to its largest so that two blocks of up to
// 113 KB share an SM; returns the launch's error.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace mma
}  // namespace rt
