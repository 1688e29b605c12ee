// Paged attention for Hopper (sm_90a): queries against the paged KV pool,
// read in place through a block table.
//
// Replaces the TPU kernel raytpu/ops/paged_attention.py::_paged_kernel
// (launched by _paged_pallas). Same function and layouts: q [B, T, H, D];
// pools [num_pages, page_size, KV, D]; block_tables [B, P] int32;
// positions [B, T] int32, of which only positions[b, 0] is read: the
// query tokens of a sequence are consecutive, so token t sees slots
// 0 .. positions[b, 0] + t. Padding rows give garbage the caller drops.
// A slot is found through the table (slot -> page table[slot / page_size],
// offset slot % page_size); a page id outside the pool is clamped into it,
// as the JAX reference's gather clamps, so a bad table reads wrong data
// but never out of bounds. The GQA fold is the TPU's: the rows of kv head
// j are (token t, query head j*rep + r), row = t*rep + r, so the rep query
// heads of one kv head share each K/V load.
//
// The TPU prefetches the block table and the start positions as scalars
// and walks pages as a sequential grid dimension. Here a block reads its
// own row of the table and its own positions[b, 0]. The rows of one
// (b, kv head) choose the path:
//
// - Decode (T*rep <= 16 rows): memory-bound, every live K/V byte read once
//   for a handful of rows (bytes over 3.35 TB/s). B*KV blocks alone would
//   leave most of the card idle and each walking up to the whole context,
//   so the walk is split: the grid is (B*KV, n_split) and split s walks
//   slots [s*span, (s+1)*span) of the table (span = pages_per_split *
//   page_size, chosen on the host from the table width, B, KV and the SM
//   count, never from the contexts). A split past a sequence's last live
//   slot exits at once. K/V tiles of 64 slots stream through a two-stage
//   cp.async ring; q stays in registers; a group of D/E lanes takes one
//   key (E channels a lane) and sums its dot products with shuffles, on
//   the CUDA cores (an mma would waste most of its 16 rows). Each group
//   runs its own online softmax (P rounded to bf16 before P V, l summed
//   from the fp32 P); the groups and warps merge at the end. With one
//   split the block writes O; with several it writes fp32 partials
//   (m, l, acc[D]) per row to a workspace, and a second kernel rescales
//   the live splits' partials by exp(m_s - m) and writes O, rounded once.
// - Chunks (T*rep > 16 rows, chunked prefill): operation-bound, so bf16
//   runs on the tensor cores with the flash forward's engine
//   (attention_mma.cuh), 64 rows a block, K/V rows copied from their page
//   slots by 16-byte cp.async chunks; only the addressing and the mask
//   (slot <= q_start + row / rep) differ from the forward.
//
// fp32 input (on no main path) keeps the fp32 FMA engine of
// attention_tile.cuh, 16-row blocks for decode and 64-row ones for chunks.

#include <type_traits>

#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

template <typename T, int D>
struct PagedRows {
  const T* q;
  T* o;
  const int* table;  // this sequence's row of the block table
  long long q_base;  // b * T * H, in vectors
  int h, kv, rep, page_size, num_pages, j, row0, rows, q_start, n_keys;

  __device__ long long row_vec(int r) const {
    const int row = row0 + r;
    const int t = row / rep;
    return q_base + static_cast<long long>(t) * h + j * rep + (row - t * rep);
  }
  __device__ const T* q_row(int r) const {
    return row0 + r < rows ? q + row_vec(r) * D : nullptr;
  }
  __device__ T* o_row(int r) const { return row0 + r < rows ? o + row_vec(r) * D : nullptr; }
  __device__ void write_lse(int, float) const {}
  __device__ long long kv_offset(int slot) const {
    const long long page = min(max(table[slot / page_size], 0), num_pages - 1);
    return ((page * page_size + slot % page_size) * kv + j) * D;
  }
  __device__ bool visible(int r, int slot) const { return slot <= q_start + (row0 + r) / rep; }
};

struct PagedArgs {
  const void *q, *k, *v;
  const int *bt, *pos;
  void* o;
  float* ws;  // decode partials, n_split > 1 only
  int b, t, h, kv, num_pages, page_size, n_pg, n_split, pages_per_split;
  float scale;
  cudaStream_t stream;
};

// The rows of this block: (b, kv head j) = blockIdx.x, the row tile of
// blockIdx.y, latest tokens first.
template <typename T, int D, int BR>
__device__ PagedRows<T, D> block_rows(const PagedArgs& a) {
  const int b = blockIdx.x / a.kv;
  PagedRows<T, D> pol;
  pol.q = static_cast<const T*>(a.q);
  pol.o = static_cast<T*>(a.o);
  pol.table = a.bt + static_cast<long long>(b) * a.n_pg;
  pol.q_base = static_cast<long long>(b) * a.t * a.h;
  pol.h = a.h;
  pol.kv = a.kv;
  pol.rep = a.h / a.kv;
  pol.page_size = a.page_size;
  pol.num_pages = a.num_pages;
  pol.j = blockIdx.x - b * a.kv;
  pol.rows = a.t * pol.rep;
  pol.row0 = (gridDim.y - 1 - blockIdx.y) * BR;
  pol.q_start = a.pos[static_cast<long long>(b) * a.t];
  const int last_tok = (min(pol.row0 + BR, pol.rows) - 1) / pol.rep;
  pol.n_keys = max(0, min(pol.q_start + last_tok + 1, a.n_pg * a.page_size));
  return pol;
}

template <typename T, int D, int BR>
__global__ void __launch_bounds__(rt::kThreads) paged_attention_kernel(const PagedArgs a) {
  rt::attend<T, D, BR>(block_rows<T, D, BR>(a), static_cast<const T*>(a.k),
                       static_cast<const T*>(a.v), a.scale);
}

template <int D>
__global__ void __launch_bounds__(rt::mma::kThreads) paged_chunk_mma_kernel(const PagedArgs a) {
  using bf16 = __nv_bfloat16;
  rt::mma::attend<D>(block_rows<bf16, D, rt::mma::kTile>(a), static_cast<const bf16*>(a.k),
                     static_cast<const bf16*>(a.v), a.scale);
}

// ---- decode: split walk and combine --------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecSlots = 64;  // slots a ring stage holds
constexpr int kDecRows = 16;   // most rows a decode block takes
static_assert(kDecThreads == rt::mma::kThreads, "launched by rt::mma::launch");

// Bytes of dynamic shared memory of a decode block: the K/V ring, reused
// at the end for the warps' partials.
template <int D>
constexpr size_t dec_smem() {
  const size_t ring = 2 * 2 * kDecSlots * D * sizeof(__nv_bfloat16);
  const size_t merge = kDecWarps * kDecRows * (D + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Slots a decode block's rows may see: min(q_start + T, the table's).
__device__ __forceinline__ int decode_keys(const PagedArgs& a, int b) {
  const int q_start = a.pos[static_cast<long long>(b) * a.t];
  return max(0, min(q_start + a.t, a.n_pg * a.page_size));
}

// One split of one (b, kv head): R >= T*rep rows, E channels a lane, so
// G = D / E lanes take one key and a warp 32 / G keys at a time.
template <int D, int R, int E>
__global__ void __launch_bounds__(kDecThreads) paged_decode_kernel(const PagedArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int G = D / E;
  constexpr int KW = 32 / G;
  static_assert(E == 4 || E == 8, "a lane loads 8 or 16 bytes of a row");
  const int b = blockIdx.x / a.kv, j = blockIdx.x - b * a.kv;
  const int rep = a.h / a.kv, rows = a.t * rep;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int span = a.pages_per_split * a.page_size;
  const int q_start = a.pos[static_cast<long long>(b) * a.t];
  const int n_keys = decode_keys(a, b);
  const int s0 = split * span, s1 = min(s0 + span, n_keys);
  if (n_split > 1 && s0 >= n_keys) return;  // past the context: the combine skips it

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [2][64][D]
  bf16* vs = ks + 2 * kDecSlots * D;             // [2][64][D]
  const bf16* kp = static_cast<const bf16*>(a.k);
  const bf16* vp = static_cast<const bf16*>(a.v);
  const int* table = a.bt + static_cast<long long>(b) * a.n_pg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane % G, kg = lane / G;  // channel group and key of the lane

  auto row_vec = [&](int r) {  // q/o vector of row r
    const int t = r / rep;
    return (static_cast<long long>(b) * a.t + t) * a.h + j * rep + (r - t * rep);
  };
  // Slots slot0.. of the split into ring stage st; slots past s1 are zeros.
  auto load_kv = [&](int st, int slot0) {
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int n = 0; n < kDecSlots * kChunks / kDecThreads; ++n) {
      const int i = threadIdx.x + n * kDecThreads, r = i / kChunks, ch = i % kChunks;
      const int slot = slot0 + r;
      const bool live = slot < s1;
      long long at = 0;
      if (live) {
        const long long page = min(max(table[slot / a.page_size], 0), a.num_pages - 1);
        at = ((page * a.page_size + slot % a.page_size) * a.kv + j) * D + ch * 8;
      }
      const int dst = (st * kDecSlots + r) * D + ch * 8;
      rt::mma::cp_async16(ks + dst, kp + at, live ? 16 : 0);
      rt::mma::cp_async16(vs + dst, vp + at, live ? 16 : 0);
    }
  };

  float qf[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) qf[r][e] = 0.f;
    if (r < rows) {
      const bf16* src = static_cast<const bf16*>(a.q) + row_vec(r) * D + c * E;
#pragma unroll
      for (int e = 0; e < E; ++e) qf[r][e] = __bfloat162float(src[e]);
    }
  }
  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = rt::mma::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int n_tiles = s1 > s0 ? (s1 - s0 + kDecSlots - 1) / kDecSlots : 0;
  if (n_tiles > 0) load_kv(0, s0);
  rt::mma::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int slot0 = s0 + it * kDecSlots;
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, slot0 + kDecSlots);
    rt::mma::cp_async_commit();
    rt::mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * kDecSlots * D;
    const bf16* vt = vs + (it & 1) * kDecSlots * D;
#pragma unroll 2
    for (int step = 0; step < kDecSlots / kDecWarps / KW; ++step) {
      const int rr = (kDecSlots / kDecWarps) * warp + KW * step + kg;  // row of the tile
      const int slot = slot0 + rr;
      float kf[E], vf[E];
      if constexpr (E == 8) {
        rt::unpack(*reinterpret_cast<const uint4*>(kt + rr * D + c * E), kf, bf16());
        rt::unpack(*reinterpret_cast<const uint4*>(vt + rr * D + c * E), vf, bf16());
      } else {
        const uint2 ku = *reinterpret_cast<const uint2*>(kt + rr * D + c * E);
        const uint2 vu = *reinterpret_cast<const uint2*>(vt + rr * D + c * E);
        const float2 k0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ku.x));
        const float2 k1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ku.y));
        const float2 v0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vu.x));
        const float2 v1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vu.y));
        kf[0] = k0.x, kf[1] = k0.y, kf[2] = k1.x, kf[3] = k1.y;
        vf[0] = v0.x, vf[1] = v0.y, vf[2] = v1.x, vf[3] = v1.y;
      }
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qf[r][e], kf[e], x);
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        dot[r] = x;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows || slot >= s1 || slot > q_start + r / rep) continue;
        const float x = dot[r] * a.scale;
        const float m_new = fmaxf(m[r], x);
        const float corr = expf(m[r] - m_new);
        const float p = expf(x - m_new);
        const float pb = bf16_round(p);  // P rounded before P V, l from the fp32 P
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pb, vf[e], acc[r][e] * corr);
        m[r] = m_new;
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // Merge the warp's key groups (lanes G apart hold the same channels).
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float fs = expf(m[r] - mn), fo = expf(mo - mn);
      l[r] = l[r] * fs + lo * fo;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = acc[r][e] * fs + __shfl_xor_sync(0xffffffffu, acc[r][e], o) * fo;
      m[r] = mn;
    }
  // Then the warps, through shared memory (the ring is free): red[w][r] =
  // acc[D], m, l.
  float* red = reinterpret_cast<float*>(smem_raw);
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;
      float* w = red + (warp * kDecRows + r) * (D + 2);
#pragma unroll
      for (int e = 0; e < E; ++e) w[c * E + e] = acc[r][e];
      if (lane == 0) w[D] = m[r], w[D + 1] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kDecThreads) {
    const int r = i / D, d = i - r * D;
    float mx = rt::mma::kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, red[(w * kDecRows + r) * (D + 2) + D]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float* x = red + (w * kDecRows + r) * (D + 2);
      const float f = expf(x[D] - mx);
      ls += x[D + 1] * f;
      as += x[d] * f;
    }
    if (n_split == 1) {
      static_cast<bf16*>(a.o)[row_vec(r) * D + d] = __float2bfloat16(as / fmaxf(ls, 1e-30f));
    } else {
      float* p = a.ws + ((static_cast<long long>(blockIdx.x) * n_split + split) * rows + r) * (D + 2);
      p[d] = as;
      if (d == 0) p[D] = mx, p[D + 1] = ls;
    }
  }
}

// O of one (b, kv head) from its live splits' partials.
template <int D>
__global__ void __launch_bounds__(kDecThreads) paged_combine_kernel(const PagedArgs a) {
  using bf16 = __nv_bfloat16;
  const int b = blockIdx.x / a.kv, j = blockIdx.x - b * a.kv;
  const int rep = a.h / a.kv, rows = a.t * rep;
  const int span = a.pages_per_split * a.page_size;
  const int live = min(a.n_split, (decode_keys(a, b) + span - 1) / span);
  const long long stride = static_cast<long long>(rows) * (D + 2);  // one split
  for (int i = threadIdx.x; i < rows * D; i += kDecThreads) {
    const int r = i / D, d = i - r * D;
    const float* p = a.ws + (static_cast<long long>(blockIdx.x) * a.n_split * rows + r) * (D + 2);
    float mx = rt::mma::kNegInf;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, p[s * stride + D]);
    float ls = 0.f, as = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(p[s * stride + D] - mx);
      ls += p[s * stride + D + 1] * f;
      as += p[s * stride + d] * f;
    }
    const int t = r / rep;
    const long long vec = (static_cast<long long>(b) * a.t + t) * a.h + j * rep + (r - t * rep);
    static_cast<bf16*>(a.o)[vec * D + d] = __float2bfloat16(as / fmaxf(ls, 1e-30f));
  }
}

template <int D, int R>
cudaError_t launch_decode(const PagedArgs& a) {
  constexpr int E = R > 4 ? 4 : 8;  // fewer registers a row where rows are many
  cudaError_t e = rt::mma::launch(paged_decode_kernel<D, R, E>, dim3(a.b * a.kv, a.n_split),
                                  dec_smem<D>(), a.stream, a);
  if (e != cudaSuccess || a.n_split == 1) return e;
  paged_combine_kernel<D><<<a.b * a.kv, kDecThreads, 0, a.stream>>>(a);
  return cudaGetLastError();
}

// ---- dispatch ------------------------------------------------------------

template <typename T, int D, int BR>
cudaError_t launch_fma(const PagedArgs& a) {
  const int rows = a.t * (a.h / a.kv);
  const dim3 grid(a.b * a.kv, (rows + BR - 1) / BR);
  return rt::launch(paged_attention_kernel<T, D, BR>, grid, rt::TileSmem<D, BR>::kBytes,
                    a.stream, a);
}

template <typename T, int D>
cudaError_t dispatch_rows(const PagedArgs& a) {
  const int rows = a.t * (a.h / a.kv);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (rows <= 1) return launch_decode<D, 1>(a);
    if (rows <= 4) return launch_decode<D, 4>(a);
    if (rows <= kDecRows) return launch_decode<D, kDecRows>(a);
    const dim3 grid(a.b * a.kv, (rows + rt::mma::kTile - 1) / rt::mma::kTile);
    return rt::mma::launch(paged_chunk_mma_kernel<D>, grid, 5 * rt::mma::kTile * D * sizeof(T),
                           a.stream, a);
  } else {
    // 16-row blocks when every row of a sequence's kv head fits (decode).
    if (rows <= 16) return launch_fma<T, D, 16>(a);
    return launch_fma<T, D, 64>(a);
  }
}

template <typename T>
cudaError_t dispatch_dim(int d, const PagedArgs& a) {
  switch (d) {
    case 32: return dispatch_rows<T, 32>(a);
    case 64: return dispatch_rows<T, 64>(a);
    case 128: return dispatch_rows<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o: [b, t, h, d]; pools:
// [num_pages, page_size, kv, d]; block_tables: [b, n_pg] int32;
// positions: [b, t] int32. All contiguous, on the stream's device; h must
// be a multiple of kv. bf16 decode (t * h / kv <= kDecRows, the wrapper's
// DECODE_ROWS) walks the table in n_split splits of pages_per_split pages
// (n_split * pages_per_split >= n_pg); with n_split > 1, workspace holds
// b * kv * n_split * t * (h / kv) * (d + 2) floats. Other calls take
// n_split = 1 and ignore pages_per_split and workspace.
extern "C" int rt_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* block_tables, const void* positions, void* o,
                                  void* workspace, int dtype, int b, int t, int h, int kv,
                                  int d, int num_pages, int page_size, int n_pg, int n_split,
                                  int pages_per_split, float scale, void* stream) {
  if (kv <= 0 || h % kv != 0 || num_pages <= 0 || n_split <= 0 || pages_per_split <= 0 ||
      static_cast<long long>(n_split) * pages_per_split < n_pg ||
      (n_split > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const PagedArgs a{q,
                    k_pages,
                    v_pages,
                    static_cast<const int*>(block_tables),
                    static_cast<const int*>(positions),
                    o,
                    static_cast<float*>(workspace),
                    b,
                    t,
                    h,
                    kv,
                    num_pages,
                    page_size,
                    n_pg,
                    n_split,
                    pages_per_split,
                    scale,
                    static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch_dim<float>(d, a);
    case 1: return dispatch_dim<__nv_bfloat16>(d, a);
    default: return cudaErrorInvalidValue;
  }
}
