// Paged attention for Hopper (sm_90a): queries against the paged KV pool,
// read in place through a block table.
//
// Replaces the TPU kernel raytpu/ops/paged_attention.py::_paged_kernel
// (launched by _paged_pallas). Same function and layouts: q [B, T, H, D];
// pools [num_pages, page_size, KV, D]; block_tables [B, P] int32;
// positions [B, T] int32, of which only positions[b, 0] is read: the
// query tokens of a sequence are consecutive, so token t sees slots
// 0 .. positions[b, 0] + t. Padding rows give garbage the caller drops.
//
// The TPU prefetches the block table and the start positions as scalars
// and walks pages as a sequential grid dimension. Here one thread block
// owns (b, kv head j, a tile of query rows), reads its own row of the
// block table and its own positions[b, 0], and loops over the slots up
// to the last one the tile's last row can see, translating each slot
// through the table (slot -> page table[slot / page_size], offset
// slot % page_size); pages past that are never touched. A page id
// outside the pool is clamped into it, as the JAX reference's gather
// clamps, so a bad table reads wrong data but never out of bounds. The
// GQA fold is the TPU's: a tile's rows are (token t, query head
// j*rep + r), row = t*rep + r, so the rep query heads of one kv head
// share each K/V load.
//
// What bounds it on an H100: decode (T = 1) reads every live K/V byte
// once for a handful of query rows, so it is memory-bound (bytes over
// 3.35 TB/s); a long prefill chunk is operation-bound. This first version
// loads each K/V tile once per block and keeps the scores in shared
// memory (attention_tile.cuh, fp32 FMA), with 16-row blocks when a
// block's rows fit (decode) so little compute is wasted on empty rows,
// and 64-row blocks for chunks. Splitting one sequence's walk over
// several blocks, to fill the card at small batch, is later work.

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

template <typename T, int D, int BR>
__global__ void __launch_bounds__(rt::kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                       const int* __restrict__ positions, T* __restrict__ o, int t, int h,
                       int kv, int num_pages, int page_size, int n_pg, float scale) {
  const int b = blockIdx.x / kv;
  PagedRows<T, D> pol;
  pol.q = q;
  pol.o = o;
  pol.table = block_tables + static_cast<long long>(b) * n_pg;
  pol.q_base = static_cast<long long>(b) * t * h;
  pol.h = h;
  pol.kv = kv;
  pol.rep = h / kv;
  pol.page_size = page_size;
  pol.num_pages = num_pages;
  pol.j = blockIdx.x - b * kv;
  pol.rows = t * pol.rep;
  pol.row0 = (gridDim.y - 1 - blockIdx.y) * BR;  // latest tokens first
  pol.q_start = positions[static_cast<long long>(b) * t];
  const int last_tok = (min(pol.row0 + BR, pol.rows) - 1) / pol.rep;
  pol.n_keys = max(0, min(pol.q_start + last_tok + 1, n_pg * page_size));
  rt::attend<T, D, BR>(pol, k_pages, v_pages, scale);
}

struct PagedArgs {
  const void *q, *k, *v;
  const int *bt, *pos;
  void* o;
  int b, t, h, kv, num_pages, page_size, n_pg;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int BR>
cudaError_t launch_paged(const PagedArgs& a) {
  const int rows = a.t * (a.h / a.kv);
  const dim3 grid(a.b * a.kv, (rows + BR - 1) / BR);
  return rt::launch(paged_attention_kernel<T, D, BR>, grid, rt::TileSmem<D, BR>::kBytes,
                    a.stream, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                    static_cast<const T*>(a.v), a.bt, a.pos, static_cast<T*>(a.o), a.t, a.h,
                    a.kv, a.num_pages, a.page_size, a.n_pg, a.scale);
}

template <typename T, int D>
cudaError_t dispatch_rows(const PagedArgs& a) {
  // 16-row blocks when every row of a sequence's kv head fits (decode).
  if (a.t * (a.h / a.kv) <= 16) return launch_paged<T, D, 16>(a);
  return launch_paged<T, D, 64>(a);
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
// positions: [b, t] int32. All contiguous, on the stream's device;
// h must be a multiple of kv.
extern "C" int rt_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* block_tables, const void* positions, void* o,
                                  int dtype, int b, int t, int h, int kv, int d,
                                  int num_pages, int page_size, int n_pg, float scale,
                                  void* stream) {
  if (kv <= 0 || h % kv != 0 || num_pages <= 0) return cudaErrorInvalidValue;
  const PagedArgs a{q,  k_pages, v_pages, static_cast<const int*>(block_tables),
                    static_cast<const int*>(positions), o, b, t, h, kv, num_pages,
                    page_size, n_pg, scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch_dim<float>(d, a);
    case 1: return dispatch_dim<__nv_bfloat16>(d, a);
    default: return cudaErrorInvalidValue;
  }
}
