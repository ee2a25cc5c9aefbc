// The simulator's sin hashes on the card, each whole in one launch, with
// glibc's float sin at their core.
//
// No TPU kernel: the JAX package computes these hashes through XLA, and jitted
// on XLA:CPU its float32 jnp.sin is glibc's sinf, which is not correctly
// rounded (nor is CUDA's sinf, and the two differ). Each hash scales sin by
// about 4.4e4 and keeps the fraction, so one ulp of sin moves it by up to its
// range. Four modes, each a launch, each bit for bit its plain version in
// ops/sinf.py:
//   hash_sinf      out = sinf(fl32(x * a + y)), y a tensor, a scalar or none,
//                  x and y read at a stride (the bare sin, for the checks);
//   hash01         h = fl32(sinf(fl32(x * a + b)) * scale); out = h - floor(h)
//                  (the rain streaks' columns, render/weather.py);
//   grain_texture  fl32(0.6 * hash2(p, 1.7) + fl32(0.4 * hash2(p, 0.45)))
//                  - 0.5 of the ground points p = (x, y), the sum rounded
//                  once as XLA contracts it into a fused multiply-add; hash2
//                  quantizes p with the float32 reciprocal of the cell,
//                  q = floor(p * r), and hashes
//                  sin(fl32(q.x * 12.9898 + fl32(q.y * 78.233))) as hash01
//                  does (the ground grain, render/raster.py);
//   reverse_steer  r = fl32(sinf(fl32(x * 12.99)) * 43758.5);
//                  out = (r - floor(r) - 0.5) * 0.6 (agent/driver.py).
// Every constant comes from the wrapper, as ops/sinf.py's plain versions use
// it.
//
// sinf is ARM's optimized-routines sinf, which glibc builds since 2.28
// (sysdeps/ieee754/flt-32/s_sinf.c, sincosf.h, sincosf_data.c), as x86-64
// builds it without TOINT_INTRINSICS: every float64 product and sum rounded on
// its own (__dmul_rn/__dadd_rn), the large-argument reduction in uint64_t, one
// rounding to float32 at the end. nvcc's default --fmad=true would contract
// the float32 epilogues (sin * scale - floor, q.y * 78.233) into FMAs, so
// they are written with __fmul_rn/__fsub_rn too. The
// argument: x * a is exact in float64 (both float32) and, for the hashes'
// integer cells and constants, so is the float64 sum; rounded once to float32
// it is the fused multiply-add that XLA forms under jit. A NaN result is
// written as 0x7fc00000, the NaN the CPU's plain version gives (the card's
// own arithmetic would give 0x7fffffff).
//
// Bound on an H100: bytes. At a 32-env tick (563,200 pixels or ground points)
// grain_texture reads 8 B and writes 4 B a point, 6.76 MB, 0.0020 ms at 3.35
// TB/s; hash01 reads 4 B and writes 4 B, 0.0013 ms. The float64 work (some 40
// operations a sin, two sins a grain point) takes 0.0007 ms at the card's 34
// TFLOP/s. Tensor cores have no role in an elementwise pass, and TMA none in
// one of 8-12 B an element: each thread loads its own 16 B.
//
// Design, for a pass of a few microseconds:
// - A grid-stride loop over a grid sized to the card (SMs times resident
//   blocks of this kernel, read once a device), each thread on groups of
//   four elements: one 16-B load of x (two for the grain's (x, y) pairs) and
//   one 16-B store. A scalar head runs until the input is 16-B aligned, and a
//   scalar tail after the last whole group; if the output is then unaligned,
//   the group is stored a float at a time.
// - glibc's 2/pi table (96 B) sits in shared memory, filled at block start:
//   its 24 words lie in 24 banks, so any index a warp takes reads without a
//   conflict, where __constant__ serializes the distinct addresses of a warp
//   (nearly every rain and grain argument is >= 120 and takes reduce_large).
//   The polynomial's coefficients are immediates: glibc's second table only
//   negates c0-c4, which negates the cos polynomial's result, so a predicate
//   picks the sign.
// Why CUDA and not Triton: float64 with no contraction anywhere, the uint64
// products of reduce_large, and a CUDA source with its build already here.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#define HASH_THREADS 256
#define HASH_MAX_DEVICES 64

// glibc's __inv_pio4: entry i is floor(2/pi * 2^(8 i + 8)) mod 2^32.
__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

// glibc's __sincosf_table[0] (the non-TOINT_INTRINSICS layout).
constexpr double kHpiInv = 0x1.45f306dc9c883p+23;  // 2/pi * 2^24
constexpr double kHpi = 0x1.921fb54442d18p+0;      // pi/2
constexpr double kC0 = 0x1p0, kC1 = -0x1.ffffffd0c621cp-2, kC2 = 0x1.55553e1068f19p-5,
                 kC3 = -0x1.6c087e89a359dp-10, kC4 = 0x1.99343027bf8c3p-16;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7,
                 kS3 = -0x1.994eb3774cf24p-13;
constexpr double kPi63 = 0x1.921fb54442d18p-62;  // pi * 2^-62

// The top 12 bits (sign off) of 0.75 (glibc's pi/4 test looks at these
// only), 2^-12, 120 and infinity.
#define TOP12_PIO4 0x3f4u
#define TOP12_TINY 0x398u
#define TOP12_120 0x42fu
#define TOP12_INF 0x7f8u

enum Mode { MODE_HASH01 = 0, MODE_GRAIN = 1, MODE_STEER = 2, NUM_MODES = 3 };

// A mode's constants, as the wrapper passes them (ops/sinf.py names each).
struct HashConsts {
    float k[8];
};

// sinf_poly: the odd polynomial for sin (n even) or the even one for cos,
// negated for glibc's second table (cos_neg).
__device__ __forceinline__ float sinf_poly(double x, double x2, int n, bool cos_neg) {
    if ((n & 1) == 0) {
        const double x3 = __dmul_rn(x, x2);
        const double s1 = __dadd_rn(kS2, __dmul_rn(x2, kS3));
        const double x7 = __dmul_rn(x3, x2);
        const double s = __dadd_rn(x, __dmul_rn(x3, kS1));
        return __double2float_rn(__dadd_rn(s, __dmul_rn(x7, s1)));
    }
    const double x4 = __dmul_rn(x2, x2);
    const double c2 = __dadd_rn(kC3, __dmul_rn(x2, kC4));
    const double c1 = __dadd_rn(kC0, __dmul_rn(x2, kC1));
    const double x6 = __dmul_rn(x4, x2);
    const double c = __dadd_rn(c1, __dmul_rn(x4, kC2));
    const double r = __dadd_rn(c, __dmul_rn(x6, c2));
    return __double2float_rn(cos_neg ? -r : r);
}

// glibc's reduce_large: x mod pi/2 from the float's bits, n the quadrant.
__device__ __forceinline__ double reduce_large(uint32_t xi, const uint32_t* inv_pio4, int* np) {
    const uint32_t* arr = &inv_pio4[(xi >> 26) & 15];
    const int shift = (xi >> 23) & 7;
    xi = (xi & 0xffffff) | 0x800000;
    xi <<= shift;
    uint64_t res0 = (uint32_t)(xi * arr[0]);  // the low 32 bits, as in C
    const uint64_t res1 = (uint64_t)xi * arr[4];
    const uint64_t res2 = (uint64_t)xi * arr[8];
    res0 = (res2 >> 32) | (res0 << 32);
    res0 += res1;
    const uint64_t n = (res0 + (1ull << 61)) >> 62;
    res0 -= n << 62;
    *np = (int)n;
    return __dmul_rn(__ll2double_rn((long long)res0), kPi63);
}

// The quadrant's sign on the reduced argument (glibc's sign[q & 3] of
// {1, -1, -1, 1}), then the polynomial with table q & 2.
__device__ __forceinline__ float sinf_quadrant(double r, int n, int q) {
    const bool flip = ((q + 1) & 2) != 0;  // q & 3 in {1, 2}
    return sinf_poly(flip ? -r : r, __dmul_rn(r, r), n, (q & 2) != 0);
}

__device__ __forceinline__ float glibc_sinf(float y, const uint32_t* inv_pio4) {
    const uint32_t bits = __float_as_uint(y);
    const uint32_t top = (bits >> 20) & 0x7ff;
    const double x = (double)y;
    if (top < TOP12_PIO4) {
        if (top < TOP12_TINY) return y;
        return sinf_poly(x, __dmul_rn(x, x), 0, false);
    }
    if (top < TOP12_120) {
        // reduce_fast: n = ((int32)(x * hpi_inv) + 2^23) >> 24, arithmetic.
        const int n = (__double2int_rz(__dmul_rn(x, kHpiInv)) + 0x800000) >> 24;
        return sinf_quadrant(__dsub_rn(x, __dmul_rn((double)n, kHpi)), n, n);
    }
    if (top < TOP12_INF) {
        int n;
        const double r = reduce_large(bits, inv_pio4, &n);
        return sinf_quadrant(r, n, n + (int)(bits >> 31));
    }
    return __int_as_float(0x7fc00000);  // NaN for +-inf and NaN
}

// sinf(fl32(x * a + b)): the float64 product is exact, the sum rounds once
// (see the header), then once more to float32.
__device__ __forceinline__ float sin_of(float x, float a, float b, const uint32_t* inv_pio4) {
    return glibc_sinf(__double2float_rn(__dadd_rn(__dmul_rn((double)x, (double)a), (double)b)),
                      inv_pio4);
}

// fl32(s * scale) - floor of it.
__device__ __forceinline__ float fraction(float s, float scale) {
    const float h = __fmul_rn(s, scale);
    return __fsub_rn(h, floorf(h));
}

__device__ __forceinline__ float canonical_nan(float v) {
    return (__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u ? __int_as_float(0x7fc00000) : v;
}

// The grain's hash at one cell size (reciprocal r): k = {a, c, scale, ...}.
__device__ __forceinline__ float grain_cell(float px, float py, float r, const HashConsts& c,
                                            const uint32_t* inv_pio4) {
    const float q0 = floorf(__fmul_rn(px, r));
    const float q1 = floorf(__fmul_rn(py, r));
    return fraction(sin_of(q0, c.k[0], __fmul_rn(q1, c.k[1]), inv_pio4), c.k[2]);
}

// One element of a mode from its IN_W input floats.
//   hash01: k = {a, b, scale}
//   grain:  k = {a, c, scale, r_coarse, r_fine, w_coarse, w_fine, bias}
//   steer:  k = {a, scale, offset, gain}
template <int MODE>
__device__ __forceinline__ float hash_element(const float* v, const HashConsts& c,
                                              const uint32_t* inv_pio4) {
    if (MODE == MODE_HASH01) {
        return canonical_nan(fraction(sin_of(v[0], c.k[0], c.k[1], inv_pio4), c.k[2]));
    } else if (MODE == MODE_GRAIN) {
        const float coarse = grain_cell(v[0], v[1], c.k[3], c, inv_pio4);
        const float fine = grain_cell(v[0], v[1], c.k[4], c, inv_pio4);
        // fl32(coarse * w_coarse + fl32(fine * w_fine)), rounded once as XLA's
        // fused multiply-add rounds it; then the bias.
        const double sum = __dadd_rn(__dmul_rn((double)coarse, (double)c.k[5]),
                                     (double)__fmul_rn(fine, c.k[6]));
        return canonical_nan(__fsub_rn(__double2float_rn(sum), c.k[7]));
    } else {
        const float s = glibc_sinf(__fmul_rn(v[0], c.k[0]), inv_pio4);
        return canonical_nan(__fmul_rn(__fsub_rn(fraction(s, c.k[1]), c.k[2]), c.k[3]));
    }
}

__device__ __forceinline__ void load_table(uint32_t* table) {
    if (threadIdx.x < 24) table[threadIdx.x] = kInvPio4[threadIdx.x];
    __syncthreads();
}

// Elements [0, head) and [head + 4 groups, n) one at a time; the groups of
// four between them with 16-B loads (in + head * IN_W is 16-B aligned).
template <int MODE>
__global__ void __launch_bounds__(HASH_THREADS)
hash_mode_kernel(const float* __restrict__ in, float* __restrict__ out, long long n,
                 long long head, long long groups, HashConsts c) {
    constexpr int IN_W = MODE == MODE_GRAIN ? 2 : 1;  // input floats an element
    __shared__ uint32_t inv_pio4[24];
    load_table(inv_pio4);
    const long long tid = (long long)blockIdx.x * HASH_THREADS + threadIdx.x;
    const long long step = (long long)gridDim.x * HASH_THREADS;
    const float4* vin = reinterpret_cast<const float4*>(in + head * IN_W);
    float* gout = out + head;
    const bool out_aligned = (reinterpret_cast<uintptr_t>(gout) & 15) == 0;
    for (long long g = tid; g < groups; g += step) {
        float v[4 * IN_W];
#pragma unroll
        for (int j = 0; j < IN_W; ++j) {
            const float4 t = vin[g * IN_W + j];
            v[4 * j] = t.x;
            v[4 * j + 1] = t.y;
            v[4 * j + 2] = t.z;
            v[4 * j + 3] = t.w;
        }
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = hash_element<MODE>(&v[e * IN_W], c, inv_pio4);
        if (out_aligned) {
            reinterpret_cast<float4*>(gout)[g] = make_float4(r[0], r[1], r[2], r[3]);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) gout[4 * g + e] = r[e];
        }
    }
    const long long tail = head + 4 * groups;
    for (long long s = tid; s < head + (n - tail); s += step) {
        const long long i = s < head ? s : tail + (s - head);
        out[i] = hash_element<MODE>(in + i * IN_W, c, inv_pio4);
    }
}

// The bare sin: one element a thread of the grid-stride loop, x and y at a
// stride; y_mode 0 takes no y (fl32(x * a)), 1 the scalar b, 2 the tensor y.
__global__ void __launch_bounds__(HASH_THREADS)
hash_sinf_kernel(const float* __restrict__ x, long long x_stride, const float* __restrict__ y,
                 long long y_stride, int y_mode, float a, float b, float* __restrict__ out,
                 long long n) {
    __shared__ uint32_t inv_pio4[24];
    load_table(inv_pio4);
    const long long step = (long long)gridDim.x * HASH_THREADS;
    for (long long i = (long long)blockIdx.x * HASH_THREADS + threadIdx.x; i < n; i += step) {
        double arg = __dmul_rn((double)x[i * x_stride], (double)a);
        if (y_mode == 1) arg = __dadd_rn(arg, (double)b);
        if (y_mode == 2) arg = __dadd_rn(arg, (double)y[i * y_stride]);
        out[i] = glibc_sinf(__double2float_rn(arg), inv_pio4);
    }
}

// Blocks of `kernel` that fill `device`: SMs times the blocks an SM holds,
// read once a device and kernel (index `slot`).
static cudaError_t full_grid(const void* kernel, int slot, int device, int* grid) {
    static std::atomic<int> cache[HASH_MAX_DEVICES][NUM_MODES + 1];  // zeroed: static storage
    if (device >= 0 && device < HASH_MAX_DEVICES) {
        *grid = cache[device][slot].load(std::memory_order_relaxed);
        if (*grid > 0) return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, HASH_THREADS, 0);
    if (err != cudaSuccess) return err;
    *grid = sms * (per_sm > 0 ? per_sm : 1);
    if (device >= 0 && device < HASH_MAX_DEVICES)
        cache[device][slot].store(*grid, std::memory_order_relaxed);
    return cudaSuccess;
}

static unsigned grid_for(long long work, int full) {
    const long long blocks = (work + HASH_THREADS - 1) / HASH_THREADS;
    return (unsigned)(blocks < full ? (blocks > 0 ? blocks : 1) : full);
}

// Runs fn on `device` (restoring the caller's device after) and returns the
// first error, or cudaGetLastError() after the launch.
template <typename Fn>
static int on_device(int device, Fn fn) {
    int prev = -1;
    cudaError_t err = cudaGetDevice(&prev);
    const bool switched = err == cudaSuccess && prev != device;
    if (switched) err = cudaSetDevice(device);
    if (err == cudaSuccess) err = fn();
    if (err == cudaSuccess) err = cudaGetLastError();
    if (switched) cudaSetDevice(prev);
    return (int)err;
}

// Launches `mode` on `stream` (a stream of `device`) over n elements of the
// contiguous input `in` (n floats; 2 n for the grain) into the contiguous
// `out`, with the mode's constants k[0..7]. Returns 0 or the CUDA error.
extern "C" int hash_mode_launch(int mode, const float* in, float* out, long long n,
                                const float* k, int device, void* stream) {
    if (n <= 0) return 0;
    if (mode < 0 || mode >= NUM_MODES) return (int)cudaErrorInvalidValue;
    HashConsts c;
    for (int j = 0; j < 8; ++j) c.k[j] = k[j];
    const int in_w = mode == MODE_GRAIN ? 2 : 1;
    // Elements before the input reaches 16 B; all of them if it never does
    // (a grain pair at a 4-B offset).
    const uintptr_t addr = reinterpret_cast<uintptr_t>(in);
    const int elem_bytes = 4 * in_w;
    long long head = addr % elem_bytes ? n : (long long)((16 - addr % 16) % 16) / elem_bytes;
    if (head > n) head = n;
    const long long groups = (n - head) / 4;
    const long long scalar = n - 4 * groups;
    const void* kernels[NUM_MODES] = {(const void*)hash_mode_kernel<MODE_HASH01>,
                                      (const void*)hash_mode_kernel<MODE_GRAIN>,
                                      (const void*)hash_mode_kernel<MODE_STEER>};
    return on_device(device, [&]() {
        int full = 0;
        cudaError_t err = full_grid(kernels[mode], mode, device, &full);
        if (err != cudaSuccess) return err;
        const unsigned grid = grid_for(groups > scalar ? groups : scalar, full);
        cudaStream_t s = (cudaStream_t)stream;
        if (mode == MODE_HASH01)
            hash_mode_kernel<MODE_HASH01><<<grid, HASH_THREADS, 0, s>>>(in, out, n, head, groups, c);
        else if (mode == MODE_GRAIN)
            hash_mode_kernel<MODE_GRAIN><<<grid, HASH_THREADS, 0, s>>>(in, out, n, head, groups, c);
        else
            hash_mode_kernel<MODE_STEER><<<grid, HASH_THREADS, 0, s>>>(in, out, n, head, groups, c);
        return cudaSuccess;
    });
}

// Launches the bare sin on `stream` (a stream of `device`). `out` is
// contiguous; x and y are read at i * stride. Returns 0 or the CUDA error.
extern "C" int hash_sinf_launch(const float* x, long long x_stride, const float* y,
                                long long y_stride, int y_mode, float a, float b, float* out,
                                long long n, int device, void* stream) {
    if (n <= 0) return 0;
    return on_device(device, [&]() {
        int full = 0;
        cudaError_t err = full_grid((const void*)hash_sinf_kernel, NUM_MODES, device, &full);
        if (err != cudaSuccess) return err;
        hash_sinf_kernel<<<grid_for(n, full), HASH_THREADS, 0, (cudaStream_t)stream>>>(
            x, x_stride, y, y_stride, y_mode, a, b, out, n);
        return cudaSuccess;
    });
}

extern "C" const char* hash_sinf_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
