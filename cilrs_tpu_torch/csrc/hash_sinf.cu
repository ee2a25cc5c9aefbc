// glibc's float sin of a hash argument: out[i] = sinf(fl32(x[i] * a + y[i])).
//
// No TPU kernel: the JAX package takes sin through XLA, and jitted on XLA:CPU
// its float32 jnp.sin is glibc's sinf, which is not correctly rounded (nor is
// CUDA's sinf, and the two differ). The simulator's sin hashes (the rain
// streaks, the ground grain, the recovery steer) scale sin by about 4.4e4 and
// keep the fraction, so one ulp of sin moves a hash by up to its range. This
// kernel computes glibc's algorithm (ARM optimized-routines sinf, glibc 2.28+
// sysdeps/ieee754/flt-32/s_sinf.c, sincosf.h, sincosf_data.c, as x86-64 builds
// it without TOINT_INTRINSICS) bit for bit: every float64 product and sum
// rounded on its own (__dmul_rn/__dadd_rn, so nvcc contracts nothing into an
// FMA), the large-argument reduction in uint64_t, one rounding to float32 at
// the end. ops/sinf.py:sinf_plain is the same arithmetic in torch ops; the two
// agree bit for bit.
//
// The argument: x * a is exact in float64 (both float32) and, for the hashes'
// integer cells and constants, so is the float64 sum with y; rounded once to
// float32 it is the fused multiply-add that XLA forms under jit. y_mode 0
// takes no y (fl32(x * a)), 1 the scalar b, 2 the tensor y.
//
// Bound on an H100: bytes. Elementwise: 4 B of x (and 4 of y) in, 4 B out
// an element, at 3.35 TB/s; some 40 float64 operations an element stay far
// under the card's float64 rate at these sizes. One thread an element, 256 a
// block; strided reads take a column of a [..., 2] tensor without a copy.

#include <cstdint>
#include <cuda_runtime.h>

#define HASH_SINF_THREADS 256

struct SincosfTable {
    double sign[4];
    double hpi_inv, hpi, c0, c1, s1, c2, s2, c3, s3, c4;
};

// glibc's __sincosf_table (the non-TOINT_INTRINSICS layout): table 1 negates
// c0-c4.
__constant__ SincosfTable kTable[2] = {
    {{1.0, -1.0, -1.0, 1.0}, 0x1.45f306dc9c883p+23, 0x1.921fb54442d18p+0, 0x1p0,
     -0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3, 0x1.55553e1068f19p-5,
     0x1.1107605230bc4p-7, -0x1.6c087e89a359dp-10, -0x1.994eb3774cf24p-13,
     0x1.99343027bf8c3p-16},
    {{1.0, -1.0, -1.0, 1.0}, 0x1.45f306dc9c883p+23, 0x1.921fb54442d18p+0, -0x1p0,
     0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3, -0x1.55553e1068f19p-5,
     0x1.1107605230bc4p-7, 0x1.6c087e89a359dp-10, -0x1.994eb3774cf24p-13,
     -0x1.99343027bf8c3p-16},
};

// glibc's __inv_pio4: entry i is floor(2/pi * 2^(8 i + 8)) mod 2^32.
__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

// The top 12 bits (sign off) of 0.75 (glibc's pi/4 test looks at these
// only), 2^-12, 120 and infinity.
#define TOP12_PIO4 0x3f4u
#define TOP12_TINY 0x398u
#define TOP12_120 0x42fu
#define TOP12_INF 0x7f8u

__device__ __forceinline__ float sinf_poly(double x, double x2, const SincosfTable& p, int n) {
    if ((n & 1) == 0) {
        const double x3 = __dmul_rn(x, x2);
        const double s1 = __dadd_rn(p.s2, __dmul_rn(x2, p.s3));
        const double x7 = __dmul_rn(x3, x2);
        const double s = __dadd_rn(x, __dmul_rn(x3, p.s1));
        return __double2float_rn(__dadd_rn(s, __dmul_rn(x7, s1)));
    }
    const double x4 = __dmul_rn(x2, x2);
    const double c2 = __dadd_rn(p.c3, __dmul_rn(x2, p.c4));
    const double c1 = __dadd_rn(p.c0, __dmul_rn(x2, p.c1));
    const double x6 = __dmul_rn(x4, x2);
    const double c = __dadd_rn(c1, __dmul_rn(x4, p.c2));
    return __double2float_rn(__dadd_rn(c, __dmul_rn(x6, c2)));
}

// glibc's reduce_large: x mod pi/2 from the float's bits, n the quadrant.
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
    const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
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
    return __dmul_rn(__ll2double_rn((long long)res0), 0x1.921fb54442d18p-62);
}

__device__ __forceinline__ float glibc_sinf(float y) {
    const uint32_t bits = __float_as_uint(y);
    const uint32_t top = (bits >> 20) & 0x7ff;
    const double x = (double)y;
    if (top < TOP12_PIO4) {
        if (top < TOP12_TINY) return y;
        return sinf_poly(x, __dmul_rn(x, x), kTable[0], 0);
    }
    if (top < TOP12_120) {
        // reduce_fast: n = ((int32)(x * hpi_inv) + 2^23) >> 24, arithmetic.
        const int n = (__double2int_rz(__dmul_rn(x, kTable[0].hpi_inv)) + 0x800000) >> 24;
        const double r = __dsub_rn(x, __dmul_rn((double)n, kTable[0].hpi));
        const SincosfTable& p = kTable[(n & 2) ? 1 : 0];
        return sinf_poly(__dmul_rn(r, p.sign[n & 3]), __dmul_rn(r, r), p, n);
    }
    if (top < TOP12_INF) {
        const int sign = bits >> 31;
        int n;
        const double r = reduce_large(bits, &n);
        const int q = n + sign;
        const SincosfTable& p = kTable[(q & 2) ? 1 : 0];
        return sinf_poly(__dmul_rn(r, p.sign[q & 3]), __dmul_rn(r, r), p, n);
    }
    return __int_as_float(0x7fc00000);  // NaN for +-inf and NaN
}

__global__ void __launch_bounds__(HASH_SINF_THREADS)
hash_sinf_kernel(const float* __restrict__ x, long long x_stride, const float* __restrict__ y,
                 long long y_stride, int y_mode, float a, float b, float* __restrict__ out,
                 long long n) {
    const long long i = (long long)blockIdx.x * HASH_SINF_THREADS + threadIdx.x;
    if (i >= n) return;
    double arg = __dmul_rn((double)x[i * x_stride], (double)a);
    if (y_mode == 1) arg = __dadd_rn(arg, (double)b);
    if (y_mode == 2) arg = __dadd_rn(arg, (double)y[i * y_stride]);
    out[i] = glibc_sinf(__double2float_rn(arg));
}

// Launches on `stream` (a stream of `device`) and returns cudaGetLastError()
// (0 on success). `out` is contiguous; x and y are read at i * stride.
extern "C" int hash_sinf_launch(const float* x, long long x_stride, const float* y,
                                long long y_stride, int y_mode, float a, float b, float* out,
                                long long n, int device, void* stream) {
    if (n <= 0) return 0;
    int prev = -1;
    cudaError_t err = cudaGetDevice(&prev);
    const bool switched = err == cudaSuccess && prev != device;
    if (switched) err = cudaSetDevice(device);
    if (err == cudaSuccess) {
        const long long blocks = (n + HASH_SINF_THREADS - 1) / HASH_SINF_THREADS;
        hash_sinf_kernel<<<(unsigned)blocks, HASH_SINF_THREADS, 0, (cudaStream_t)stream>>>(
            x, x_stride, y, y_stride, y_mode, a, b, out, n);
        err = cudaGetLastError();
    }
    if (switched) cudaSetDevice(prev);
    return (int)err;
}

extern "C" const char* hash_sinf_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
