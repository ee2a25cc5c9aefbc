// Batch row-gather from a card-resident, paged table: out[i] = row idx[i].
//
// Replaces the Pallas TPU kernel of cilrs_tpu/ops/gather.py (_gather_rows_impl,
// body _kernel, reached by gather_rows and gather_rows_paged). On the TPU,
// scalar-prefetched indices drove a BlockSpec index map, one grid step per row,
// and a table of several pages took one gather per page plus a select. Here one
// launch serves every page: the kernel routes each index to a page itself.
//
// Routing (bit-exact with cilrs_tpu/ops/gather.py:gather_rows_paged):
//   one page:   row = clamp(idx, 0, n_0 - 1)
//   P pages:    p = floor(idx / page_rows)   (Python // : idx < 0 gives p = -1)
//               0 <= p < P  -> page p, row clamp(idx - p * page_rows, 0, n_p - 1)
//               otherwise   -> page 0, row 0 (what the JAX where-chain yields)
//
// Bound on an H100: a pure copy, so bytes. It must read B rows and write B
// rows: 2 * B * row_bytes through HBM (at B = 3,000 frames of 52,800 B that is
// 317 MB, 0.0946 ms at 3.35 TB/s). No arithmetic to speak of.
//
// Design, for that bound on Hopper:
// - A persistent grid. The work is B * chunks_per_row items, (row, chunk)
//   pairs: a third of a 52,800-B frame each at the path's shape. One block per
//   SM takes items blk, blk + grid, blk + 2 grid, ..., so the counts differ by
//   at most one, no wave of short blocks leaves SMs idle at the end, and no
//   block pays a start-up cost per row. Dealing the items round-robin, and not
//   as one contiguous range a block, keeps the SMs in step over neighbouring
//   output rows, so at any moment the card writes one window of the output, as
//   a plain copy does. On contiguous rows that makes the kernel as fast as
//   copy_, where contiguous ranges were slower than the one-block-per-row
//   kernel this design replaced (root PERF.md).
// - TMA bulk copies through a ring of `stages` chunks in shared memory. One
//   thread routes each item's index and issues a bulk load into a stage,
//   tracked by that stage's mbarrier (arrive.expect_tx + complete_tx); once it
//   has landed, a bulk store writes the stage out (one bulk group per item).
//   No byte passes through registers. stages - GATHER_STORE_DEPTH loads stay
//   in flight; a stage is loaded again only after wait_group.read has shown
//   that the store GATHER_STORE_DEPTH items back, its last reader, has read it.
// - That one thread is the pipeline's clock, so its work per item is
//   additions only: a cursor steps through the items, and pages are found by
//   comparison. (With 64-bit divisions per item, emulated in software,
//   smaller chunks ran slower than half rows; without them, thirds are the
//   fastest chunk measured: twelve stages of 17,600 B.)
// - Offsets are 64-bit throughout: one page of the full-size table is
//   88,128 rows x 52,800 B = 4.65 GB, past 2^31 (the TPU build failed on this
//   class of fault at 2^33, cilrs_tpu/ops/gather.py PAGE_BYTE_LIMIT). The page
//   table travels as a kernel parameter, which the card keeps in its constant
//   bank, so a launch needs no host-to-device copy of its own. The kernel works
//   on bytes, so any dtype gathers.
// - The bulk copy needs 16-byte sizes and addresses: row_bytes, chunk_bytes
//   and every page and output pointer are multiples of 16 (the Python wrapper
//   checks the page pointers, PyTorch's allocator aligns the output, and the
//   launcher below checks the sizes).
// The launch plan (chunk_bytes, chunks_per_row, stages, grid, shared memory)
// comes from ops/gather.py:bulk_plan, where the CPU tests check it.
// Fusing /255 + normalize into the copy is later work.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#define GATHER_MAX_PAGES 16
#define GATHER_THREADS 32      // one warp; thread 0 issues every copy
// The ring's limits; ops/gather.py mirrors them.
#define GATHER_MAX_STAGES 16
#define GATHER_STORE_DEPTH 1   // bulk stores left in flight before a stage is reloaded
#define GATHER_BARRIER_BYTES 128  // mbarriers at the head of shared memory
#define GATHER_MAX_SMEM 232448    // dynamic shared memory a block may opt in to
#define GATHER_MAX_DEVICES 64
static_assert(8 * GATHER_MAX_STAGES <= GATHER_BARRIER_BYTES, "one 8-byte mbarrier a stage");
static_assert(GATHER_STORE_DEPTH >= 0 && GATHER_STORE_DEPTH < GATHER_MAX_STAGES,
              "a load must stay in flight");

struct PageTable {
    const char* base[GATHER_MAX_PAGES];
    long long rows[GATHER_MAX_PAGES];  // physical rows n_p of each page
};

__device__ __forceinline__ const char* route(const PageTable& pt, int num_pages,
                                             long long page_rows, long long g,
                                             long long row_bytes) {
    // No division: it is emulated in 64 bits, and this runs once an item on
    // the one thread that issues every copy. floor(g / page_rows) is in
    // [0, P) exactly when 0 <= g < P * page_rows; the page is then found by
    // stepping over whole pages (P <= 16).
    int p = 0;
    long long r = 0;
    if (num_pages == 1) {
        r = g < 0 ? 0 : (g >= pt.rows[0] ? pt.rows[0] - 1 : g);
    } else if (g >= 0 && g < num_pages * page_rows) {
        r = g;
        while (r >= page_rows) {
            r -= page_rows;
            ++p;
        }
        r = r >= pt.rows[p] ? pt.rows[p] - 1 : r;
    }
    return pt.base[p] + r * row_bytes;
}

// Global -> shared, completing `bytes` of the stage's mbarrier transaction.
__device__ __forceinline__ void bulk_load(uint32_t dst_smem, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(dst_smem), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Shared -> global, as a bulk group of its own.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src_smem, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(dst), "r"(src_smem), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Spins until the mbarrier at `bar` has completed its phase of parity `parity`.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Walks one block's items in order: output row i, chunk c of that row, and
// the ring stage s with the parity of its mbarrier's phase for that use. Item
// k + 1 is `step` items after item k; moving on costs additions only.
struct Cursor {
    long long i;
    int c, s;
    uint32_t parity;
    __device__ __forceinline__ void next(long long step_rows, int step_chunks,
                                         int chunks_per_row, int stages) {
        i += step_rows;
        c += step_chunks;
        if (c >= chunks_per_row) {
            c -= chunks_per_row;
            ++i;
        }
        if (++s == stages) {
            s = 0;
            parity ^= 1u;
        }
    }
};

__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_kernel(const PageTable pt, int num_pages, long long page_rows,
                   const int* __restrict__ idx, char* __restrict__ out, long long b,
                   long long row_bytes, long long chunk_bytes, long long chunks_per_row,
                   int stages) {
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const uint32_t ring = bars + GATHER_BARRIER_BYTES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8 * s) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x != 0) return;

    // This block's n items: counts differ by at most one between blocks.
    // The only divisions of the kernel are here, once a block.
    const long long total = b * chunks_per_row;
    const long long grid = gridDim.x, blk = blockIdx.x;
    const long long n = total / grid + (blk < total % grid ? 1 : 0);
    const int cpr = (int)chunks_per_row;
    const long long step_rows = grid / cpr;
    const int step_chunks = (int)(grid % cpr);
    const Cursor start = {blk / cpr, (int)(blk % cpr), 0, 0u};
    const int ahead = stages - GATHER_STORE_DEPTH;

    // The chunk at cursor t: its byte offset in the row, and its size (the
    // last chunk of a row may be shorter).
    auto chunk = [&](const Cursor& t, long long& off) -> uint32_t {
        off = t.c * chunk_bytes;
        const long long left = row_bytes - off;
        return (uint32_t)(left < chunk_bytes ? left : chunk_bytes);
    };
    auto issue_load = [&](const Cursor& t) {
        long long off;
        const uint32_t bytes = chunk(t, off);
        bulk_load(ring + (uint32_t)(t.s * chunk_bytes),
                  route(pt, num_pages, page_rows, __ldg(idx + t.i), row_bytes) + off, bytes,
                  bars + 8 * t.s);
    };

    Cursor ld = start, st = start;  // the next item to load, the next to store
    for (long long k = 0; k < n && k < ahead; ++k) {
        issue_load(ld);
        ld.next(step_rows, step_chunks, cpr, stages);
    }
    for (long long k = 0; k < n; ++k) {
        wait_parity(bars + 8 * st.s, st.parity);
        long long off;
        const uint32_t bytes = chunk(st, off);
        bulk_store(out + st.i * row_bytes + off, ring + (uint32_t)(st.s * chunk_bytes), bytes);
        if (k + ahead < n) {
            // Item k + ahead reuses the stage of item k - STORE_DEPTH: wait
            // until that item's store has read it out, leaving the newer
            // stores (and the other stages' loads) in flight.
            asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(GATHER_STORE_DEPTH) : "memory");
            issue_load(ld);
            ld.next(step_rows, step_chunks, cpr, stages);
        }
        st.next(step_rows, step_chunks, cpr, stages);
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Launches on `stream` (a stream of `device`) and returns cudaGetLastError()
// (0 on success). The plan (chunk_bytes, chunks_per_row, stages, grid,
// smem_bytes) is ops/gather.py:bulk_plan's; page and output pointers must be
// 16-byte aligned.
extern "C" int gather_rows_launch(const void* const* page_ptrs,
                                  const long long* page_phys_rows, int num_pages,
                                  long long page_rows, const int* idx, long long b,
                                  void* out, long long row_bytes, long long chunk_bytes,
                                  long long chunks_per_row, int stages, int grid,
                                  int smem_bytes, int device, void* stream) {
    if (num_pages < 1 || num_pages > GATHER_MAX_PAGES || (num_pages > 1 && page_rows < 1) ||
        row_bytes <= 0 || row_bytes % 16 != 0 || chunk_bytes <= 0 || chunk_bytes % 16 != 0 ||
        chunks_per_row < 1 || chunks_per_row * chunk_bytes < row_bytes ||
        (chunks_per_row - 1) * chunk_bytes >= row_bytes ||
        stages <= GATHER_STORE_DEPTH || stages > GATHER_MAX_STAGES ||
        smem_bytes < GATHER_BARRIER_BYTES + stages * chunk_bytes ||
        smem_bytes > GATHER_MAX_SMEM || (b > 0 && grid < 1) || b < 0 ||
        device < 0 || device >= GATHER_MAX_DEVICES)
        return (int)cudaErrorInvalidValue;
    PageTable pt = {};
    for (int p = 0; p < num_pages; ++p) {
        pt.base[p] = static_cast<const char*>(page_ptrs[p]);
        pt.rows[p] = page_phys_rows[p];
    }
    if (b == 0) return (int)cudaSuccess;

    // The launch goes to the calling thread's current device, so switch to
    // `device` for it and switch back only if this call switched.
    int prev = -1;
    cudaError_t err = cudaGetDevice(&prev);
    const bool switched = err == cudaSuccess && prev != device;
    if (switched) err = cudaSetDevice(device);
    // Opting in to the large ring is once a device; racing threads at worst
    // both opt in.
    static std::atomic<bool> smem_opted_in[GATHER_MAX_DEVICES];  // zeroed: static storage
    if (err == cudaSuccess && !smem_opted_in[device].load(std::memory_order_acquire)) {
        err = cudaFuncSetAttribute(gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   GATHER_MAX_SMEM);
        if (err == cudaSuccess) smem_opted_in[device].store(true, std::memory_order_release);
    }
    if (err == cudaSuccess) {
        gather_rows_kernel<<<dim3((unsigned)grid), GATHER_THREADS, (size_t)smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
            pt, num_pages, page_rows, idx, static_cast<char*>(out), b, row_bytes, chunk_bytes,
            chunks_per_row, stages);
        err = cudaGetLastError();
    }
    if (switched) cudaSetDevice(prev);
    return (int)err;
}

extern "C" int gather_rows_max_pages() { return GATHER_MAX_PAGES; }

extern "C" const char* gather_rows_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
