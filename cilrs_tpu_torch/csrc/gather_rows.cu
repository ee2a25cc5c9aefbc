// Batch row-gather from a card-resident, paged table: out[i] = row idx[i].
//
// Replaces the Pallas TPU kernel of cilrs_tpu/ops/gather.py (_gather_rows_impl,
// body _kernel, reached by gather_rows and gather_rows_paged). On the TPU,
// scalar-prefetched indices drove a BlockSpec index map, one grid step per row,
// and a table of several pages took one gather per page plus a select. Here one
// launch serves every page: each block reads its own index, routes it to a page
// and copies that row.
//
// Routing (bit-exact with cilrs_tpu/ops/gather.py:gather_rows_paged):
//   one page:   row = clamp(idx, 0, n_0 - 1)
//   P pages:    p = floor(idx / page_rows)   (Python // : idx < 0 gives p = -1)
//               0 <= p < P  -> page p, row clamp(idx - p * page_rows, 0, n_p - 1)
//               otherwise   -> page 0, row 0 (what the JAX where-chain yields)
//
// Bound on an H100: a pure copy, so bytes. It must read B rows and write B
// rows: 2 * B * row_bytes through HBM (at B = 3,000 frames of 52,800 B that is
// 317 MB, 0.095 ms at 3.35 TB/s). No arithmetic to speak of.
//
// Design: one block per output row; each thread moves 16-byte vectors, four in
// flight before it stores any, so a warp keeps 2 KB of loads outstanding.
// Offsets are 64-bit throughout: one page of the full-size table is
// 88,128 rows x 52,800 B = 4.65 GB, past 2^31 (the TPU build failed on this
// class of fault at 2^33, cilrs_tpu/ops/gather.py PAGE_BYTE_LIMIT). The page
// table travels as a kernel parameter, which the card keeps in its constant
// bank, so a launch needs no host-to-device copy of its own. The kernel works
// on bytes, so any dtype gathers; the wrapper checks 16-byte alignment.
// TMA bulk copies and fusing /255 + normalize into the copy are later work.

#include <cstdint>
#include <cuda_runtime.h>

#define GATHER_MAX_PAGES 16
#define GATHER_THREADS 256
#define GATHER_UNROLL 4

struct PageTable {
    const uint4* base[GATHER_MAX_PAGES];
    long long rows[GATHER_MAX_PAGES];  // physical rows n_p of each page
};

__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_kernel(const PageTable pt, int num_pages, long long page_rows,
                   const int* __restrict__ idx, uint4* __restrict__ out,
                   long long row_vecs) {
    const long long i = blockIdx.x;
    const long long g = idx[i];
    int p = 0;
    long long r = 0;
    if (num_pages == 1) {
        r = g < 0 ? 0 : (g >= pt.rows[0] ? pt.rows[0] - 1 : g);
    } else {
        const long long q = g >= 0 ? g / page_rows : -((-g + page_rows - 1) / page_rows);
        if (q >= 0 && q < num_pages) {
            p = (int)q;
            const long long local = g - q * page_rows;
            r = local < 0 ? 0 : (local >= pt.rows[p] ? pt.rows[p] - 1 : local);
        }
    }
    const uint4* __restrict__ src = pt.base[p] + r * row_vecs;
    uint4* __restrict__ dst = out + i * row_vecs;

    const long long step = (long long)GATHER_THREADS * GATHER_UNROLL;
    long long v = threadIdx.x;
    for (; v + (GATHER_UNROLL - 1) * GATHER_THREADS < row_vecs; v += step) {
        uint4 buf[GATHER_UNROLL];
#pragma unroll
        for (int u = 0; u < GATHER_UNROLL; ++u) buf[u] = __ldg(src + v + u * GATHER_THREADS);
#pragma unroll
        for (int u = 0; u < GATHER_UNROLL; ++u) dst[v + u * GATHER_THREADS] = buf[u];
    }
    for (; v < row_vecs; v += GATHER_THREADS) dst[v] = __ldg(src + v);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). Page
// pointers must be 16-byte aligned and row_bytes a multiple of 16; the Python
// wrapper checks both before it calls.
extern "C" int gather_rows_launch(const void* const* page_ptrs,
                                  const long long* page_phys_rows, int num_pages,
                                  long long page_rows, const int* idx, long long b,
                                  void* out, long long row_bytes, void* stream) {
    if (num_pages < 1 || num_pages > GATHER_MAX_PAGES || row_bytes % 16 != 0 ||
        (num_pages > 1 && page_rows < 1))
        return (int)cudaErrorInvalidValue;
    PageTable pt = {};
    for (int p = 0; p < num_pages; ++p) {
        pt.base[p] = static_cast<const uint4*>(page_ptrs[p]);
        pt.rows[p] = page_phys_rows[p];
    }
    if (b == 0) return (int)cudaSuccess;
    gather_rows_kernel<<<dim3((unsigned)b), GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        pt, num_pages, page_rows, idx, static_cast<uint4*>(out), row_bytes / 16);
    return (int)cudaGetLastError();
}

extern "C" int gather_rows_max_pages() { return GATHER_MAX_PAGES; }

extern "C" const char* gather_rows_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
