// The fleet's camera frames on the card: render/raster.py:render_frame in four
// kernels, besides the sin hashes, which stay in csrc/hash_sinf.cu.
//
// No TPU kernel: the JAX package renders through XLA (render/raster.py), and
// its one Pallas renderer, render/pallas_ground.py, was deleted as slower than
// XLA. On the card, the torch composition of render_frame issues some 540
// launches a tick at 128 envs and writes some twenty [E, pixels, 72] bf16
// tensors of the ground pass (324 MB each) to device memory. These kernels
// compute the same frame, bit for bit, in four launches (eight a render with
// the three sin-hash launches and the final clamp):
//   render_prep    one block an env: the camera, the K nearest lane segments,
//                  buildings and lights (the set and the order nearest_k gives:
//                  ties to the lower index), every box, walker, pole and head
//                  relative to the camera, and the weather's terms, into one
//                  scene record of a few KB an env;
//   render_points  one thread a pixel: the ray, the ground hit and the motion-
//                  stretched ground point sxy [E, N, 2] that grain_texture
//                  hashes, and the rain columns that hash01 hashes;
//   render_shade   one thread a pixel, its env's record in shared memory: the
//                  ground classification over the K segments in emulated bf16,
//                  the ground colour with the grain, the merged box solve with
//                  its bf16 materialisation and exact-min ties, walkers, poles,
//                  heads, the compose, sky, atmosphere, headlight and rain: the
//                  frame before the blur, [E, H, W, 3];
//   render_blur    motion_blur: the two bilinear zoom samples and the per-env
//                  weights.
// Nothing [pixels x K]-sized leaves the registers: each pixel walks its env's
// segments, boxes and lights in shared memory.
//
// Bound on an H100: fp32 and integer issue, not bytes. At 128 envs (2.25 M
// pixels) the frame moves about 60 MB (sxy, grain, rain hashes, two images),
// 0.02 ms at 3.35 TB/s; a ground pixel does some 4,000 operations over 72
// segments (each bf16 rounding a conversion and back), a pixel some 1,500 over
// 21 boxes (six IEEE divisions each), about 0.3-0.5 ms at the card's rate.
// Sky pixels skip the ground pass, dead boxes the solve.
//
// Same frames, not close ones. Every float32 operation is rounded where the
// torch composition rounds it: __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so
// nvcc contracts nothing into an FMA (the shared NVCC_FLAGS stay as they are);
// bf16 results go through __float2bfloat16_rn (a bf16 op in PyTorch computes
// in float32 and rounds once; a product of two bf16 values is exact in
// float32). Transcendentals are the CUDA math library's expf, sqrtf, cosf,
// sinf, powf, rsqrtf, which PyTorch's kernels call. What PyTorch does on the
// card that it does not do on the CPU, and these kernels copy:
//  - a tensor divided by a Python number is multiplied by the number's
//    reciprocal, taken in double and rounded to float32 (the wrapper passes
//    the reciprocals);
//  - torch.remainder is fmodf, plus the divisor where the signs differ;
//  - a sum over the last dimension of B < 128 elements runs in lanes of
//    last_pow2(B) (at most 32): lane t adds elements t, t + lanes, ... and the
//    lanes fold in halves (lane_sum); three elements give (x0 + x2) + x1;
//  - torch.bmm and torch.einsum accumulate with fused multiply-adds in order.
// A sum whose order only matters with three or more equal depths (the box
// winners' shade, glow and palette) takes the exact path only when that
// happens.
//
// RENDER_HOST_EMULATION compiles this file as C++ for the host
// (tests/render_host_emulation.h), so that the CPU tests run the kernels'
// arithmetic against the torch composition.

#ifndef RENDER_HOST_EMULATION
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define RENDER_LAUNCH(kernel, grid, block, smem, stream, ...) \
    kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif
#include <cstdint>

#define PREP_THREADS 256  // render_prep's block; its histogram scan needs 256
#define PIXEL_THREADS 256

// The renderer's constants, each a float or an array of floats:
// X(name, extent). render/raster.py:kernel_consts gives a value for each name,
// and ops/render.py packs them in this order by the names and sizes that
// render_const_field exports.
#define NUM_WEATHERS 5
#define NUM_VEH_COLORS 8
#define NUM_BLDG_COLORS 7
#define NUM_LIGHT_COLORS 4
#define RENDER_CONSTS(X)                                                                    \
    /* camera: 1/W and 1/H as float32, tan of the half fov and its 0.75, cos and sin of */  \
    /* the pitch, the rig's offsets, the far plane */                                       \
    X(inv_w, ) X(inv_h, ) X(tan_h, ) X(tan_v, ) X(cos_pitch, ) X(sin_pitch, )               \
    X(offset_fwd, ) X(offset_up, ) X(far_plane, )                                           \
    /* ground: road half width, sidewalk edge, marking offset and half width (bf16) */      \
    X(road_half_w, ) X(sidewalk_out, ) X(marking_lat, ) X(marking_half_w, )                 \
    X(inf, ) X(bf_inf, ) /* the miss depth and its bf16 */                                  \
    /* the crosswalk switch's bf16 bounds: lane half width, stop bar start, zebra start */  \
    /* and end, zebra half width, stripe period and stripe width */                         \
    X(cw_lane, ) X(cw_bar, ) X(cw_walk0, ) X(cw_walk1, ) X(cw_walk_w, ) X(cw_period, )      \
    X(cw_stripe, )                                                                          \
    X(veh_half_l, ) X(veh_half_w, ) X(veh_height, )                                         \
    X(ped_r2, ) X(ped_height, ) X(pole_r2, ) X(pole_height, ) X(head_r2, ) X(pole_offset, ) \
    /* reciprocals of the divisions by constants: rays' z / 0.6, the cone's / 0.03, the */  \
    /* headlight's / 25, the blur's speed / 36; the blur's peak */                          \
    X(inv_elev, ) X(inv_cone, ) X(inv_near, ) X(inv_blur_speed, ) X(blur_peak, )           \
    X(blur_exp, [3]) /* the blur weights' powers, 0, 1, 2 */                                \
    X(grass, [3]) X(sidewalk, [3]) X(asphalt, [3]) X(marking, [3]) X(taillight, [3])        \
    X(pole, [3]) X(ped, [3])                                                                \
    X(light_colors, [NUM_LIGHT_COLORS][3]) X(veh_colors, [NUM_VEH_COLORS][3])               \
    X(bldg_colors, [NUM_BLDG_COLORS][3])                                                    \
    X(sky_top, [NUM_WEATHERS][3]) X(sky_horizon, [NUM_WEATHERS][3])                         \
    X(ambient, [NUM_WEATHERS]) X(fog, [NUM_WEATHERS]) X(rain, [NUM_WEATHERS])               \
    X(wet, [NUM_WEATHERS]) X(night, [NUM_WEATHERS])
#define RENDER_CONST_FIELD(name, extent) float name extent;
struct RenderConsts {
    RENDER_CONSTS(RENDER_CONST_FIELD)
};
#define RENDER_NUM_CONSTS (int)(sizeof(RenderConsts) / sizeof(float))

// The scene's sizes and switches, ints, in the order render_dim_name exports:
// E, H, W of the camera; V, P of the world; the network's waypoints, next
// slots, buildings and lights; K of each nearest set; 0 with the ego drawn (a
// chase view), else 1; the renderer's switches; floats of an env's record.
#define SCENE_DIMS(X)                                                                     \
    X(envs) X(height) X(width) X(vehicles) X(walkers) X(waypoints) X(max_next) X(buildings) \
    X(lights) X(segments) X(near_buildings) X(near_lights) X(first_box) X(lamps)          \
    X(night_lamps) X(crosswalks) X(record)
#define SCENE_DIM_FIELD(name) int name;
struct SceneDims {
    SCENE_DIMS(SCENE_DIM_FIELD)
};
#define RENDER_NUM_DIMS (int)(sizeof(SceneDims) / sizeof(int))
#define MAX_NEAREST 1024  // the most of each nearest set render_prep selects

// An env's scene record: the header, then the segments, boxes, walkers and
// lights, each a fixed number of floats.
enum Header {
    H_OX, H_OY,  // camera position
    H_FWD, H_RIGHT = H_FWD + 3, H_UP = H_RIGHT + 3,  // the ray basis
    H_EGO_X = H_UP + 3, H_EGO_Y,
    H_COS, H_SIN,  // the ego's heading
    H_STRETCH,     // 1 / (1 + 0.11 |v|) - 1, the grain's motion stretch
    H_AMP,         // rsqrt(1 + 0.11 |v|), the grain's amplitude
    H_ROAD,        // the wet road colour, 3
    H_TIME = H_ROAD + 3,
    H_WEATHER,
    HEADER_FLOATS = 32
};
enum Segment { S_AX, S_AY, S_DX, S_DY, S_LEN, S_PAINT, SEG_FLOATS };  // bf16 values
enum Box {
    B_COS, B_SIN, B_N1X, B_N2X, B_N1Y, B_N2Y, B_N2Z, B_OY, B_HW, B_ALIVE, B_R, B_G, B_B, B_GLOW,
    BOX_FLOATS
};
enum Walker { P_OX, P_OY, P_CC, P_ALIVE, PED_FLOATS };
enum Light {
    L_OX, L_OY, L_CC,               // the pole, a cylinder
    L_HX, L_HY, L_HZ, L_HCC,        // the head, a sphere
    L_R, L_G, L_B,                  // its state's colour
    L_X, L_Y, L_FX, L_FY,           // the crosswalk frame (bf16 heading)
    LIGHT_FLOATS = 16
};

__host__ __device__ inline int box_offset(const SceneDims& d) {
    return HEADER_FLOATS + d.segments * SEG_FLOATS;
}
__host__ __device__ inline int num_boxes(const SceneDims& d) {
    return d.vehicles - d.first_box + d.near_buildings;
}
__host__ __device__ inline int walker_offset(const SceneDims& d) {
    return box_offset(d) + num_boxes(d) * BOX_FLOATS;
}
__host__ __device__ inline int light_offset(const SceneDims& d) {
    return walker_offset(d) + d.walkers * PED_FLOATS;
}

#define FMUL __fmul_rn
#define FADD __fadd_rn
#define FSUB __fsub_rn
#define FDIV __fdiv_rn

// A float32 value rounded to bfloat16 (round to nearest even), as a float.
__device__ __forceinline__ float bf(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// torch.sum over the last dimension of n (< 128) elements on the card: lane
// t of last_pow2(n) lanes (at most 32) adds elements t, t + lanes, ... in
// order, and the lanes combine by shuffles at offsets lanes / 2, ..., 2, 1.
// Zeros add exactly, so a sum with few nonzero terms adds just those into
// their lanes (lane_add) and combines (lane_sum).
__device__ __forceinline__ int sum_lanes(int n) {
    int lanes = 1;
    while (lanes * 2 <= n && lanes < 32) lanes *= 2;
    return lanes;
}
__device__ __forceinline__ void lane_add(float* lane, int lanes, int pos, float x) {
    lane[pos % lanes] = FADD(lane[pos % lanes], x);
}
__device__ inline float lane_sum(float* lane, int lanes) {
    for (int off = lanes / 2; off > 0; off /= 2)
        for (int i = 0; i < off; ++i) lane[i] = FADD(lane[i], lane[i + off]);
    return lane[0];
}

// (x0 + x2) + x1: torch.sum of three elements on the card (two lanes).
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
    return FADD(FADD(x0, x2), x1);
}

// _safe_div: a / b, b kept at least 1e-7 from zero with its sign.
__device__ __forceinline__ float safe_div(float a, float b) {
    const float eps = (float)1e-7;
    return FDIV(a, fabsf(b) < eps ? (b >= 0.0f ? eps : -eps) : b);
}

// ------------------------------------------------------------ render_prep

struct PrepInputs {
    const float* veh_pos;        // [E, V, 2]
    const float* veh_yaw;        // [E, V]
    const float* veh_speed;      // [E, V]
    const uint8_t* veh_alive;    // [E, V] bool
    const float* veh_control;    // [E, V, 3]
    const uint8_t* veh_reverse;  // [E, V] bool
    const float* ped_pos;        // [E, P, 2]
    const uint8_t* ped_alive;    // [E, P] bool
    const float* time_s;         // [E]
    const int64_t* weather;      // [E]
    const float* wp_xy;          // [W, 2]
    const int64_t* wp_next;      // [W, max_next]
    const uint8_t* wp_junction;  // [W] bool
    const float* bldg_xy;        // [Bg, 2]
    const float* bldg_yaw;       // [Bg]
    const float* bldg_half;      // [Bg, 2]
    const float* bldg_h;         // [Bg]
    const float* light_xy;       // [L, 2]
    const float* light_yaw;      // [L]
    const int64_t* light_state;  // [E, L]
};
#define RENDER_NUM_PREP_INPUTS (int)(sizeof(PrepInputs) / sizeof(void*))

// Shared scratch of render_prep's selection.
struct SelectScratch {
    unsigned hist[256];
    unsigned scan[256];
    unsigned long long prefix;
    int need, done, count;
    unsigned long long keys[MAX_NEAREST];
    int order[MAX_NEAREST];
};

// The key of point i: its squared distance's bits (a sum of squares, so the
// bits sort as the floats) over its index, so that equal distances order by
// index, as a stable sort does.
__device__ __forceinline__ unsigned long long near_key(const float* xy, int i, float ex, float ey) {
    const float dx = FSUB(xy[2 * i], ex), dy = FSUB(xy[2 * i + 1], ey);
    const float d2 = FADD(FMUL(dx, dx), FMUL(dy, dy));
    return ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)i;
}

// The k (<= MAX_NEAREST) nearest of n points xy to (ex, ey), nearest first and ties
// to the lower index (raster.nearest_k), into sc->order[0..k): a radix select
// of the k-th key, eight bits a pass, then a rank sort of the k keys at or
// below it. Every thread of the block calls it.
__device__ void select_nearest(const float* xy, int n, float ex, float ey, int k,
                               SelectScratch* sc) {
    const int t = threadIdx.x;
    if (k <= 0) return;
    unsigned long long mask = 0;
    if (t == 0) {
        sc->prefix = 0;
        sc->need = k;
        sc->done = 0;
    }
    __syncthreads();
    for (int shift = 56; shift >= 0; shift -= 8) {
        const unsigned long long prefix = sc->prefix;
        sc->hist[t] = 0;
        __syncthreads();
        for (int i = t; i < n; i += PREP_THREADS) {
            const unsigned long long key = near_key(xy, i, ex, ey);
            if ((key & mask) == prefix) atomicAdd(&sc->hist[(key >> shift) & 255], 1u);
        }
        __syncthreads();
        // Inclusive scan of the histogram; the digit whose bin holds the
        // need-th key takes the prefix.
        const unsigned own = sc->hist[t];
        sc->scan[t] = own;
        __syncthreads();
        for (int off = 1; off < 256; off *= 2) {
            const unsigned add = t >= off ? sc->scan[t - off] : 0u;
            __syncthreads();
            sc->scan[t] += add;
            __syncthreads();
        }
        const unsigned need = (unsigned)sc->need;
        const unsigned before = sc->scan[t] - own;
        __syncthreads();
        if (own > 0 && before < need && need <= sc->scan[t]) {
            sc->prefix = prefix | ((unsigned long long)t << shift);
            sc->need = (int)(need - before);
            sc->done = own == need - before;  // every key of the bin is in
        }
        mask |= 255ull << shift;
        __syncthreads();
        if (sc->done) break;
    }
    const unsigned long long last = sc->prefix | ~mask;  // the k-th key's bound
    if (t == 0) sc->count = 0;
    __syncthreads();
    for (int i = t; i < n; i += PREP_THREADS) {
        const unsigned long long key = near_key(xy, i, ex, ey);
        if (key <= last) sc->keys[atomicAdd(&sc->count, 1)] = key;
    }
    __syncthreads();
    for (int p = t; p < k; p += PREP_THREADS) {
        int rank = 0;
        for (int q = 0; q < k; ++q) rank += sc->keys[q] < sc->keys[p];
        sc->order[rank] = (int)(sc->keys[p] & 0xffffffffu);
    }
    __syncthreads();
}

// One box of the merged slab pass, from its camera-relative centre, heading
// and sizes: the body-frame origin's slab numerators (_ray_obb's per-box
// terms).
__device__ void write_box(float* b, const RenderConsts& K, float cx, float cy, float yaw,
                          float half_l, float half_w, float height, bool alive,
                          const float* rgb, float glow) {
    const float c = cosf(yaw), s = sinf(yaw);
    const float nx = FSUB(0.0f, cx), ny = FSUB(0.0f, cy);
    const float ox = FADD(FMUL(nx, c), FMUL(ny, s));
    const float oy = FADD(FMUL(-nx, s), FMUL(ny, c));
    b[B_COS] = c;
    b[B_SIN] = s;
    b[B_N1X] = FSUB(-half_l, ox);
    b[B_N2X] = FSUB(half_l, ox);
    b[B_N1Y] = FSUB(-half_w, oy);
    b[B_N2Y] = FSUB(half_w, oy);
    b[B_N2Z] = FSUB(height, K.offset_up);
    b[B_OY] = oy;
    b[B_HW] = fmaxf(half_w, (float)1e-3);
    b[B_ALIVE] = alive ? 1.0f : 0.0f;
    b[B_R] = rgb[0];
    b[B_G] = rgb[1];
    b[B_B] = rgb[2];
    b[B_GLOW] = glow;
}

__global__ void __launch_bounds__(PREP_THREADS)
render_prep_kernel(PrepInputs in, RenderConsts K, SceneDims D, float* records, float* speed_kmh) {
    extern __shared__ float smem[];
    SelectScratch* sc = reinterpret_cast<SelectScratch*>(smem);
    const int e = blockIdx.x, t = threadIdx.x;
    float* rec = records + (long long)e * D.record;
    const int V = D.vehicles;
    const float ex = in.veh_pos[(long long)e * V * 2], ey = in.veh_pos[(long long)e * V * 2 + 1];
    const float yaw = in.veh_yaw[(long long)e * V];
    const float cyaw = cosf(yaw), syaw = sinf(yaw);
    // camera_position: ego + heading * offset_fwd, at offset_up.
    const float ox = FADD(ex, FMUL(cyaw, K.offset_fwd));
    const float oy = FADD(ey, FMUL(syaw, K.offset_fwd));
    const int w = (int)in.weather[e];
    if (t == 0) {
        rec[H_OX] = ox;
        rec[H_OY] = oy;
        // ray_directions' basis.
        rec[H_FWD] = FMUL(cyaw, K.cos_pitch);
        rec[H_FWD + 1] = FMUL(syaw, K.cos_pitch);
        rec[H_FWD + 2] = K.sin_pitch;
        rec[H_RIGHT] = syaw;
        rec[H_RIGHT + 1] = -cyaw;
        rec[H_RIGHT + 2] = 0.0f;
        rec[H_UP] = FMUL(-cyaw, K.sin_pitch);
        rec[H_UP + 1] = FMUL(-syaw, K.sin_pitch);
        rec[H_UP + 2] = K.cos_pitch;
        rec[H_EGO_X] = ex;
        rec[H_EGO_Y] = ey;
        rec[H_COS] = cyaw;
        rec[H_SIN] = syaw;
        const float speed = fabsf(in.veh_speed[(long long)e * V]);
        const float stretch = FADD(FMUL(speed, (float)0.11), 1.0f);
        rec[H_STRETCH] = FSUB(FDIV(1.0f, stretch), 1.0f);
        rec[H_AMP] = rsqrtf(stretch);
        const float wet = FSUB(1.0f, FMUL(K.wet[w], (float)0.35));
        for (int c = 0; c < 3; ++c) rec[H_ROAD + c] = FMUL(K.asphalt[c], wet);
        rec[H_TIME] = in.time_s[e];
        rec[H_WEATHER] = (float)w;
        speed_kmh[e] = FMUL(speed, (float)3.6);
    }

    // The K nearest lane segments: endpoints, directions, lengths and paint,
    // ego-centred in bf16 (_ground_masks).
    select_nearest(in.wp_xy, D.waypoints, ex, ey, D.segments, sc);
    for (int p = t; p < D.segments; p += PREP_THREADS) {
        const int i = sc->order[p];
        const int j = (int)in.wp_next[(long long)i * D.max_next];
        const float ax = in.wp_xy[2 * i], ay = in.wp_xy[2 * i + 1];
        const float abx = FSUB(in.wp_xy[2 * j], ax), aby = FSUB(in.wp_xy[2 * j + 1], ay);
        const float len = sqrtf(FADD(FADD(FMUL(abx, abx), FMUL(aby, aby)), (float)1e-9));
        float* s = rec + HEADER_FLOATS + p * SEG_FLOATS;
        s[S_AX] = bf(FSUB(ax, ex));
        s[S_AY] = bf(FSUB(ay, ey));
        s[S_DX] = bf(FDIV(abx, len));
        s[S_DY] = bf(FDIV(aby, len));
        s[S_LEN] = bf(len);
        s[S_PAINT] = (i % 3 != 2 && !in.wp_junction[i]) ? 1.0f : 0.0f;
    }
    __syncthreads();

    // The boxes: vehicles from first_box on, then the nearest buildings.
    const int V1 = V - D.first_box;
    float* boxes = rec + box_offset(D);
    for (int k = t; k < V1; k += PREP_THREADS) {
        const long long v = (long long)e * V + D.first_box + k;
        float glow = 0.0f;
        if (D.lamps || D.night_lamps) {
            float brake = clamp01(in.veh_control[v * 3 + 2]);
            brake = FMUL(brake, FSUB(1.0f, in.veh_reverse[v] ? 1.0f : 0.0f));
            if (D.lamps)
                glow = fmaxf(glow, brake > (float)0.45 ? FADD(FMUL(brake, 0.5f), (float)0.4) : 0.0f);
            if (D.night_lamps) glow = fmaxf(glow, FMUL(K.night[w], (float)0.55));
        }
        write_box(boxes + k * BOX_FLOATS, K, FSUB(in.veh_pos[2 * v], ox),
                  FSUB(in.veh_pos[2 * v + 1], oy), in.veh_yaw[v], K.veh_half_l, K.veh_half_w,
                  K.veh_height, in.veh_alive[v] != 0, K.veh_colors[(k + 1) % NUM_VEH_COLORS], glow);
    }
    select_nearest(in.bldg_xy, D.buildings, ex, ey, D.near_buildings, sc);
    for (int p = t; p < D.near_buildings; p += PREP_THREADS) {
        const int b = sc->order[p];
        write_box(boxes + (V1 + p) * BOX_FLOATS, K, FSUB(in.bldg_xy[2 * b], ox),
                  FSUB(in.bldg_xy[2 * b + 1], oy), in.bldg_yaw[b], in.bldg_half[2 * b],
                  in.bldg_half[2 * b + 1], in.bldg_h[b], true, K.bldg_colors[b % NUM_BLDG_COLORS],
                  0.0f);
    }
    __syncthreads();

    // The walkers: vertical cylinders (_ray_cylinder's per-walker terms).
    for (int p = t; p < D.walkers; p += PREP_THREADS) {
        const long long q = (long long)e * D.walkers + p;
        const float px = FSUB(0.0f, FSUB(in.ped_pos[2 * q], ox));
        const float py = FSUB(0.0f, FSUB(in.ped_pos[2 * q + 1], oy));
        float* s = rec + walker_offset(D) + p * PED_FLOATS;
        s[P_OX] = px;
        s[P_OY] = py;
        s[P_CC] = FSUB(FADD(FMUL(px, px), FMUL(py, py)), K.ped_r2);
        s[P_ALIVE] = in.ped_alive[q] ? 1.0f : 0.0f;
    }

    // The nearest lights: pole, head, state colour, crosswalk frame.
    select_nearest(in.light_xy, D.lights, ex, ey, D.near_lights, sc);
    for (int p = t; p < D.near_lights; p += PREP_THREADS) {
        const int l = sc->order[p];
        const float lx = in.light_xy[2 * l], ly = in.light_xy[2 * l + 1], lyaw = in.light_yaw[l];
        const float cl = cosf(lyaw), sl = sinf(lyaw);
        const float rx = FSUB(FADD(lx, FMUL(sl, K.pole_offset)), ox);
        const float ry = FSUB(FADD(ly, FMUL(-cl, K.pole_offset)), oy);
        float* s = rec + light_offset(D) + p * LIGHT_FLOATS;
        const float px = FSUB(0.0f, rx), py = FSUB(0.0f, ry);
        s[L_OX] = px;
        s[L_OY] = py;
        s[L_CC] = FSUB(FADD(FMUL(px, px), FMUL(py, py)), K.pole_r2);
        const float hz = FSUB(K.offset_up, K.pole_height);
        s[L_HX] = -rx;
        s[L_HY] = -ry;
        s[L_HZ] = hz;
        s[L_HCC] = FSUB(sum3(FMUL(rx, rx), FMUL(ry, ry), FMUL(hz, hz)), K.head_r2);
        const float* rgb = K.light_colors[(int)in.light_state[(long long)e * D.lights + l]];
        s[L_R] = rgb[0];
        s[L_G] = rgb[1];
        s[L_B] = rgb[2];
        s[L_X] = lx;
        s[L_Y] = ly;
        s[L_FX] = bf(cl);
        s[L_FY] = bf(sl);
    }
}

// ------------------------------------------------------------ the pixels

// Pixel (row, col)'s ray (ray_directions): the basis from the record, the
// image-plane offsets uu = u * tan_h, vv = v * tan_v, normalised with the
// card's three-element sum.
__device__ __forceinline__ void pixel_ray(const float* h, const RenderConsts& K, int row, int col,
                                          float* d) {
    const float u = FSUB(FMUL(FMUL(FADD((float)col, 0.5f), K.inv_w), 2.0f), 1.0f);
    const float v = FSUB(FMUL(FMUL(FADD((float)row, 0.5f), K.inv_h), 2.0f), 1.0f);
    const float uu = FMUL(u, K.tan_h), vv = FMUL(v, K.tan_v);
    float q[3];
    for (int c = 0; c < 3; ++c) {
        d[c] = FSUB(FADD(h[H_FWD + c], FMUL(uu, h[H_RIGHT + c])), FMUL(vv, h[H_UP + c]));
        q[c] = FMUL(d[c], d[c]);
    }
    const float norm = sqrtf(sum3(q[0], q[1], q[2]));
    for (int c = 0; c < 3; ++c) d[c] = FDIV(d[c], norm);
}

// The ground plane's hit depth, INF past the far plane or above the horizon.
__device__ __forceinline__ float ground_depth(const RenderConsts& K, float dz) {
    float t = dz < (float)-1e-4 ? FDIV(K.offset_up, fmaxf(-dz, (float)1e-6)) : K.inf;
    return t < K.far_plane ? t : K.inf;
}

__global__ void __launch_bounds__(PIXEL_THREADS)
render_points_kernel(const float* records, RenderConsts K, SceneDims D, float* sxy, float* cols,
                     float* cols_t) {
    const int N = D.height * D.width;
    const long long g = (long long)blockIdx.x * PIXEL_THREADS + threadIdx.x;
    if (g >= (long long)D.envs * N) return;
    const int e = (int)(g / N), n = (int)(g % N);
    const int row = n / D.width, col = n % D.width;
    const float* h = records + (long long)e * D.record;
    float d[3];
    pixel_ray(h, K, row, col, d);
    const float tg = ground_depth(K, d[2]);
    const float gx = FADD(h[H_OX], FMUL(d[0], tg)), gy = FADD(h[H_OY], FMUL(d[1], tg));
    // _motion_stretch.
    const float along = FADD(FMUL(gx, h[H_COS]), FMUL(gy, h[H_SIN]));
    const float k = FMUL(along, h[H_STRETCH]);
    sxy[2 * g] = FADD(gx, FMUL(h[H_COS], k));
    sxy[2 * g + 1] = FADD(gy, FMUL(h[H_SIN], k));
    // rain_streaks' columns: floor(u * 60), and with floor(t * 1.7) added.
    const float col60 = floorf(FMUL(FMUL(FADD((float)col, 0.5f), K.inv_w), 60.0f));
    cols_t[g] = FADD(col60, floorf(FMUL(h[H_TIME], (float)1.7)));
    if (e == 0) cols[n] = col60;
}

// The ground class of point g (ego-centred, bf16) against the K segments:
// _ground_masks' [pixels x K] pass, each bf16 op rounded as PyTorch rounds it.
__device__ __forceinline__ void ground_masks(const float* seg, int S, const RenderConsts& K,
                                             float g16x, float g16y, bool* road, bool* marking,
                                             bool* sidewalk) {
    float dmin = 0.0f;
    bool paint = false;
    for (int j = 0; j < S; ++j, seg += SEG_FLOATS) {
        const float dx16 = seg[S_DX], dy16 = seg[S_DY], len16 = seg[S_LEN];
        const float relx = bf(FSUB(g16x, seg[S_AX])), rely = bf(FSUB(g16y, seg[S_AY]));
        const float s = bf(FADD(bf(FMUL(relx, dx16)), bf(FMUL(rely, dy16))));
        const float t = fminf(fmaxf(s, 0.0f), len16);
        const float lat = bf(FSUB(bf(FMUL(rely, dx16)), bf(FMUL(relx, dy16))));
        const float dx = bf(FSUB(relx, bf(FMUL(t, dx16))));
        const float dy = bf(FSUB(rely, bf(FMUL(t, dy16))));
        const float d2 = bf(FADD(bf(FMUL(dx, dx)), bf(FMUL(dy, dy))));
        dmin = j == 0 ? d2 : fminf(dmin, d2);
        paint = paint || (fabsf(bf(FSUB(lat, K.marking_lat))) < K.marking_half_w && s > 0.0f &&
                          s < len16 && seg[S_PAINT] != 0.0f);
    }
    const float dist = sqrtf(FADD(dmin, (float)1e-12));
    *road = dist < K.road_half_w;
    *sidewalk = dist >= K.road_half_w && dist < K.sidewalk_out;
    *marking = paint && *road;
}

// Stop bars and zebra crossings at the nearest lights (_junction_markings,
// the crosswalk switch): a bf16 pass over the lights.
__device__ __forceinline__ bool junction_paint(const RenderConsts& K, const float* lights, int KL,
                                               float gx, float gy) {
    bool any = false;
    for (int k = 0; k < KL; ++k, lights += LIGHT_FLOATS) {
        const float fx = lights[L_FX], fy = lights[L_FY];
        const float rx = bf(FSUB(gx, lights[L_X])), ry = bf(FSUB(gy, lights[L_Y]));
        const float lon = bf(FADD(bf(FMUL(rx, fx)), bf(FMUL(ry, fy))));
        const float lat = bf(FSUB(bf(FMUL(ry, fx)), bf(FMUL(rx, fy))));
        float rem = fmodf(lat, K.cw_period);
        if (rem != 0.0f && (K.cw_period < 0.0f) != (rem < 0.0f)) rem = FADD(rem, K.cw_period);
        const bool zebra = bf(rem) < K.cw_stripe;
        const bool bar = lon >= K.cw_bar && lon <= 0.0f && fabsf(lat) <= K.cw_lane;
        const bool walk =
            lon >= K.cw_walk0 && lon <= K.cw_walk1 && fabsf(lat) <= K.cw_walk_w && zebra;
        any = any || bar || walk;
    }
    return any;
}

// A ray from (0, 0, oz) against a vertical cylinder with the per-object
// terms (ox, oy, cc): its depth, INF on a miss (_ray_cylinder). a2 = 2 a,
// a4 = 4 a of the ray.
__device__ __forceinline__ float cylinder(const RenderConsts& K, const float* d, float a2, float a4,
                                          float ox, float oy, float cc, float height) {
    const float b = FMUL(2.0f, FADD(FMUL(d[0], ox), FMUL(d[1], oy)));
    const float disc = FSUB(FMUL(b, b), FMUL(a4, cc));
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t = FDIV(FSUB(-b, sq), fmaxf(a2, (float)1e-7));
    const float z = FADD(FMUL(t, d[2]), K.offset_up);
    return disc > 0.0f && t > (float)0.05 && z >= 0.0f && z <= height ? t : K.inf;
}

// A ray against a light's head, a sphere with offset oc and term cc
// (_ray_sphere; the einsum's dot is a chain of fused multiply-adds).
__device__ __forceinline__ float sphere(const RenderConsts& K, const float* d, const float* l) {
    const float dot = __fmaf_rn(d[2], l[L_HZ], __fmaf_rn(d[1], l[L_HY], FMUL(d[0], l[L_HX])));
    const float b = FMUL(2.0f, dot);
    const float disc = FSUB(FMUL(b, b), FMUL(4.0f, l[L_HCC]));
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t = FMUL(FSUB(-b, sq), 0.5f);
    return disc > 0.0f && t > (float)0.05 ? t : K.inf;
}

// One box of the slab pass: the bf16 depth of a hit (>= bf_inf on a miss),
// its shade and its taillight bit. t1z is the floor's slab term of the ray.
struct BoxHit {
    float t16, shade16;
    bool lamp;
};
__device__ __forceinline__ BoxHit box_hit(const RenderConsts& K, const float* b, const float* d,
                                          float t1z, bool lamps) {
    BoxHit r{K.bf_inf, 0.0f, false};
    if (b[B_ALIVE] == 0.0f) return r;
    const float c = b[B_COS], s = b[B_SIN];
    const float dx = FADD(FMUL(d[0], c), FMUL(d[1], s));
    const float dy = FADD(FMUL(-d[0], s), FMUL(d[1], c));
    const float t1x = safe_div(b[B_N1X], dx), t2x = safe_div(b[B_N2X], dx);
    const float t1y = safe_div(b[B_N1Y], dy), t2y = safe_div(b[B_N2Y], dy);
    const float t2z = safe_div(b[B_N2Z], d[2]);
    const float tminx = fminf(t1x, t2x), tmaxx = fmaxf(t1x, t2x);
    const float tminy = fminf(t1y, t2y), tmaxy = fmaxf(t1y, t2y);
    const float tminz = fminf(t1z, t2z), tmaxz = fmaxf(t1z, t2z);
    const float tmin = fmaxf(fmaxf(tminx, tminy), tminz);
    const float tmax = fminf(fminf(tmaxx, tmaxy), tmaxz);
    if (!(tmax >= tmin && tmax > 0.0f && tmin > (float)0.05)) return r;
    r.t16 = bf(tmin);
    r.shade16 = bf(tmin == tminz ? 1.0f : (tmin == tminx ? (float)0.72 : (float)0.55));
    if (lamps && tmin == tminx && dx > 0.0f) {
        const float yfrac = FDIV(fabsf(FADD(b[B_OY], FMUL(tmin, dy))), b[B_HW]);
        const float z = FADD(FMUL(tmin, d[2]), K.offset_up);
        r.lamp = yfrac > 0.5f && yfrac < (float)0.94 && z > (float)0.42 && z < (float)0.76;
    }
    return r;
}

__global__ void __launch_bounds__(PIXEL_THREADS)
render_shade_kernel(const float* records, const float* tex, const float* phase,
                    const float* streak_hash, RenderConsts K, SceneDims D, float* img) {
    extern __shared__ float smem[];
    const int e = blockIdx.y, t = threadIdx.x;
    const float* src = records + (long long)e * D.record;
    for (int i = t; i < D.record; i += PIXEL_THREADS) smem[i] = src[i];
    __syncthreads();
    const int N = D.height * D.width;
    const int n = blockIdx.x * PIXEL_THREADS + t;
    if (n >= N) return;
    const long long g = (long long)e * N + n;
    const float* h = smem;
    const int row = n / D.width, col = n % D.width;
    const int w = (int)h[H_WEATHER];
    float d[3];
    pixel_ray(h, K, row, col, d);
    const float tg = ground_depth(K, d[2]);

    // --- the ground: classified, coloured, grained, painted ---
    float ground[3] = {0.0f, 0.0f, 0.0f};
    if (tg < K.inf) {
        const float gx = FADD(h[H_OX], FMUL(d[0], tg)), gy = FADD(h[H_OY], FMUL(d[1], tg));
        bool road, marking, sidewalk;
        ground_masks(smem + HEADER_FLOATS, D.segments, K, bf(FSUB(gx, h[H_EGO_X])),
                     bf(FSUB(gy, h[H_EGO_Y])), &road, &marking, &sidewalk);
        const float amp = FMUL(road ? (float)0.035 : (float)0.05, h[H_AMP]);
        const float grain = FMUL(amp, tex[g]);
        for (int c = 0; c < 3; ++c) {
            const float base = road ? h[H_ROAD + c] : (sidewalk ? K.sidewalk[c] : K.grass[c]);
            ground[c] = marking ? K.marking[c] : clamp01(FADD(base, grain));
        }
        if (D.crosswalks && road &&
            junction_paint(K, smem + light_offset(D), D.near_lights, gx, gy))
            for (int c = 0; c < 3; ++c) ground[c] = K.marking[c];
    }

    // --- the boxes: nearest bf16 depth, ties shared evenly ---
    const int B = num_boxes(D);
    const bool lamps = D.lamps || D.night_lamps;
    const float* boxes = smem + box_offset(D);
    const float t1z = safe_div(-K.offset_up, d[2]);
    float best = K.bf_inf;
    int wins = 0, win0 = 0, win1 = 0;
    float sh0 = 0.0f, sh1 = 0.0f, gl0 = 0.0f, gl1 = 0.0f;
    for (int k = 0; k < B; ++k) {
        const BoxHit r = box_hit(K, boxes + k * BOX_FLOATS, d, t1z, lamps);
        if (!(r.t16 < K.bf_inf)) continue;
        const float glow = r.lamp ? bf(boxes[k * BOX_FLOATS + B_GLOW]) : 0.0f;
        if (r.t16 < best) {
            best = r.t16;
            wins = 1;
            win0 = k, sh0 = r.shade16, gl0 = glow;
        } else if (r.t16 == best) {
            if (wins == 1) win1 = k, sh1 = r.shade16, gl1 = glow;
            ++wins;
        }
    }
    float t_v = K.inf, v_color[3] = {0.0f, 0.0f, 0.0f}, glow_pix = 0.0f;
    if (wins > 0) {
        t_v = best;
        const float wt = FDIV(1.0f, (float)wins);
        float sh_v;
        if (wins <= 2) {  // one or two terms: every order of the sums agrees
            sh_v = wins == 1 ? FMUL(wt, sh0) : FADD(FMUL(wt, sh0), FMUL(wt, sh1));
            glow_pix = wins == 1 ? FMUL(wt, gl0) : FADD(FMUL(wt, gl0), FMUL(wt, gl1));
            for (int c = 0; c < 3; ++c) {
                const float p0 = boxes[win0 * BOX_FLOATS + B_R + c];
                v_color[c] = FMUL(wt, p0);
                if (wins == 2) v_color[c] = __fmaf_rn(wt, boxes[win1 * BOX_FLOATS + B_R + c], v_color[c]);
            }
        } else {  // three or more equal depths: again, in the card's orders
            const int lanes = sum_lanes(B);
            float sh_lane[32], gl_lane[32];
            for (int i = 0; i < lanes; ++i) sh_lane[i] = gl_lane[i] = 0.0f;
            for (int k = 0; k < B; ++k) {
                const BoxHit r = box_hit(K, boxes + k * BOX_FLOATS, d, t1z, lamps);
                if (!(r.t16 < K.bf_inf) || r.t16 != best) continue;
                const float glow = r.lamp ? bf(boxes[k * BOX_FLOATS + B_GLOW]) : 0.0f;
                for (int c = 0; c < 3; ++c)
                    v_color[c] = __fmaf_rn(wt, boxes[k * BOX_FLOATS + B_R + c], v_color[c]);
                lane_add(sh_lane, lanes, k, FMUL(wt, r.shade16));
                lane_add(gl_lane, lanes, k, FMUL(wt, glow));
            }
            sh_v = lane_sum(sh_lane, lanes);
            glow_pix = lane_sum(gl_lane, lanes);
        }
        for (int c = 0; c < 3; ++c) v_color[c] = FMUL(v_color[c], sh_v);
        if (lamps) {
            glow_pix = clamp01(glow_pix);
            for (int c = 0; c < 3; ++c)
                v_color[c] = FADD(FMUL(v_color[c], FSUB(1.0f, glow_pix)),
                                  FMUL(K.taillight[c], glow_pix));
        } else {
            glow_pix = 0.0f;
        }
    }

    // --- walkers, poles, heads ---
    const float a = FADD(FMUL(d[0], d[0]), FMUL(d[1], d[1]));
    const float a2 = FMUL(2.0f, a), a4 = FMUL(4.0f, a);
    float t_p = K.inf;
    const float* peds = smem + walker_offset(D);
    for (int p = 0; p < D.walkers; ++p, peds += PED_FLOATS) {
        if (peds[P_ALIVE] == 0.0f) continue;
        t_p = fminf(t_p, cylinder(K, d, a2, a4, peds[P_OX], peds[P_OY], peds[P_CC], K.ped_height));
    }
    const float* lights = smem + light_offset(D);
    const int KL = D.near_lights;
    float t_pole = K.inf, t_h = K.inf;
    for (int k = 0; k < KL; ++k) {
        const float* l = lights + k * LIGHT_FLOATS;
        t_pole = fminf(t_pole, cylinder(K, d, a2, a4, l[L_OX], l[L_OY], l[L_CC], K.pole_height));
        t_h = fminf(t_h, sphere(K, d, l));
    }
    float head[3] = {0.0f, 0.0f, 0.0f};
    if (t_h < K.inf) {  // the heads within 1 mm of the nearest share it
        const float reach = FADD(t_h, (float)1e-3);
        int count = 0;
        for (int k = 0; k < KL; ++k) {
            const float th = sphere(K, d, lights + k * LIGHT_FLOATS);
            count += th <= reach && th < K.inf;
        }
        const float wt = FDIV(1.0f, (float)count);
        for (int k = 0; k < KL; ++k) {
            const float* l = lights + k * LIGHT_FLOATS;
            const float th = sphere(K, d, l);
            if (th <= reach && th < K.inf)
                for (int c = 0; c < 3; ++c) head[c] = __fmaf_rn(wt, l[L_R + c], head[c]);
        }
    }

    // --- compose: the nearest hit wins ---
    float t_hit = tg, em = 0.0f, surf[3] = {ground[0], ground[1], ground[2]};
    if (t_v < t_hit) {
        for (int c = 0; c < 3; ++c) surf[c] = v_color[c];
        em = glow_pix;
    }
    t_hit = fminf(t_v, t_hit);
    if (t_p < t_hit) {
        for (int c = 0; c < 3; ++c) surf[c] = K.ped[c];
        em = 0.0f;
    }
    t_hit = fminf(t_p, t_hit);
    if (t_pole < t_hit) {
        for (int c = 0; c < 3; ++c) surf[c] = K.pole[c];
        em = 0.0f;
    }
    t_hit = fminf(t_pole, t_hit);
    if (t_h < t_hit) {
        for (int c = 0; c < 3; ++c) surf[c] = head[c];
        em = 1.0f;
    }
    t_hit = fminf(t_h, t_hit);
    const bool is_sky = t_hit >= K.inf;

    // --- sky, atmosphere, headlight, rain ---
    const float elev = clamp01(FMUL(d[2], K.inv_elev));
    const float dist = fminf(t_hit, K.far_plane);
    const float fog = FSUB(1.0f, expf(FMUL(-K.fog[w], dist)));
    const float w_e = FMUL((float)0.9, is_sky ? 0.0f : em);
    const float u = FMUL(FADD((float)col, 0.5f), K.inv_w);
    const float v = FMUL(FADD((float)row, 0.5f), K.inv_h);
    const float q = FSUB(u, 0.5f);
    const float cone = FMUL(expf(FMUL(-FMUL(q, q), K.inv_cone)),
                            clamp01(FMUL(FSUB(v, (float)0.45), (float)2.2)));
    const float near_glow = expf(FMUL(-dist, K.inv_near));
    const float boost = FADD(FMUL(FMUL(FMUL(K.night[w], (float)2.6), cone), near_glow), 1.0f);
    float fall = fmodf(FADD(FADD(FMUL(v, 2.5f), FMUL(h[H_TIME], (float)1.7)), phase[n]), 1.0f);
    if (fall != 0.0f && fall < 0.0f) fall = FADD(fall, 1.0f);
    const bool streak = fall < (float)0.12 && streak_hash[g] > 0.5f;
    const float strength = FMUL((float)0.35, K.rain[w]);
    const float keep = FSUB(1.0f, streak ? strength : 0.0f);
    const float overlay = FMUL(streak ? 0.75f : 0.0f, strength);
    for (int c = 0; c < 3; ++c) {
        float color;
        if (is_sky) {
            color = FADD(FMUL(K.sky_horizon[w][c], FSUB(1.0f, elev)), FMUL(K.sky_top[w][c], elev));
        } else {
            float lit = FMUL(surf[c], K.ambient[w]);
            lit = FADD(FMUL(lit, FSUB(1.0f, fog)), FMUL(K.sky_horizon[w][c], fog));
            color = FADD(FMUL(surf[c], w_e), FMUL(lit, FSUB(1.0f, w_e)));
        }
        color = FMUL(color, boost);
        img[3 * g + c] = FADD(FMUL(color, keep), overlay);
    }
}

// motion_blur: out = w0 img + w1 zoom(img, 0.94) + w2 zoom(img, 0.88), each
// zoom a bilinear sample about the centre whose taps come from the wrapper
// (taps[f] = y0[H], y1[H], fy[H], x0[W], x1[W], fx[W]), the weights the
// normalised powers of the env's blur strength.
__global__ void __launch_bounds__(PIXEL_THREADS)
render_blur_kernel(const float* img, const float* speed_kmh, const float* taps, RenderConsts K,
                   int E, int H, int W, float* out) {
    const long long g = (long long)blockIdx.x * PIXEL_THREADS + threadIdx.x;
    if (g >= (long long)E * H * W) return;
    const int e = (int)(g / ((long long)H * W)), n = (int)(g % ((long long)H * W));
    const int y = n / W, x = n % W;
    const float b = FMUL(clamp01(FMUL(speed_kmh[e], K.inv_blur_speed)), K.blur_peak);
    float wt[3];
    for (int j = 0; j < 3; ++j) wt[j] = powf(b, K.blur_exp[j]);
    const float total = sum3(wt[0], wt[1], wt[2]);
    for (int j = 0; j < 3; ++j) wt[j] = FDIV(wt[j], total);
    const float* frame = img + (long long)e * H * W * 3;
    float acc[3];
    for (int c = 0; c < 3; ++c) acc[c] = FMUL(wt[0], frame[(long long)n * 3 + c]);
    for (int f = 0; f < 2; ++f) {
        const float* tp = taps + (long long)f * 3 * (H + W);
        const int y0 = (int)tp[y], y1 = (int)tp[H + y];
        const float fy = tp[2 * H + y], my = FSUB(1.0f, fy);
        const float* tx = tp + 3 * H;
        const int x0 = (int)tx[x], x1 = (int)tx[W + x];
        const float fx = tx[2 * W + x], mx = FSUB(1.0f, fx);
        for (int c = 0; c < 3; ++c) {
            const float r0 = FADD(FMUL(frame[((long long)y0 * W + x0) * 3 + c], my),
                                  FMUL(frame[((long long)y1 * W + x0) * 3 + c], fy));
            const float r1 = FADD(FMUL(frame[((long long)y0 * W + x1) * 3 + c], my),
                                  FMUL(frame[((long long)y1 * W + x1) * 3 + c], fy));
            const float zoom = FADD(FMUL(r0, mx), FMUL(r1, fx));
            acc[c] = FADD(acc[c], FMUL(wt[f + 1], zoom));
        }
    }
    for (int c = 0; c < 3; ++c) out[g * 3 + c] = acc[c];
}

// ------------------------------------------------------------ launches

static RenderConsts consts_from(const float* k) {
    RenderConsts c;
    float* dst = reinterpret_cast<float*>(&c);
    for (int i = 0; i < RENDER_NUM_CONSTS; ++i) dst[i] = k[i];
    return c;
}

static SceneDims dims_from(const int* v) {
    SceneDims d;
    int* dst = reinterpret_cast<int*>(&d);
    for (int i = 0; i < RENDER_NUM_DIMS; ++i) dst[i] = v[i];
    return d;
}

static unsigned blocks_for(long long work) {
    return (unsigned)((work + PIXEL_THREADS - 1) / PIXEL_THREADS);
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

// The layout ops/render.py reads when it loads the library: the counts of
// constants, dims and prep inputs, the floats of a record's parts, and the
// most of each nearest set.
extern "C" int render_layout(int* out) {
    out[0] = RENDER_NUM_CONSTS;
    out[1] = RENDER_NUM_DIMS;
    out[2] = RENDER_NUM_PREP_INPUTS;
    out[3] = HEADER_FLOATS;
    out[4] = SEG_FLOATS;
    out[5] = BOX_FLOATS;
    out[6] = PED_FLOATS;
    out[7] = LIGHT_FLOATS;
    out[8] = MAX_NEAREST;
    return 9;
}

// Constant i's name and floats; 0 past the last.
extern "C" int render_const_field(int i, const char** name) {
#define RENDER_CONST_ENTRY(field, extent) {#field, (int)(sizeof(RenderConsts::field) / sizeof(float))},
    static const struct { const char* name; int floats; } fields[] = {
        RENDER_CONSTS(RENDER_CONST_ENTRY)};
#undef RENDER_CONST_ENTRY
    if (i < 0 || i >= (int)(sizeof(fields) / sizeof(fields[0]))) return 0;
    *name = fields[i].name;
    return fields[i].floats;
}

// Dim i's name; null past the last.
extern "C" const char* render_dim_name(int i) {
#define SCENE_DIM_ENTRY(field) #field,
    static const char* const names[] = {SCENE_DIMS(SCENE_DIM_ENTRY)};
#undef SCENE_DIM_ENTRY
    return i >= 0 && i < RENDER_NUM_DIMS ? names[i] : nullptr;
}

// render_prep: in[] the PrepInputs pointers in order; records [E, record],
// speed_kmh [E] written. Returns 0 or the CUDA error.
extern "C" int render_prep_launch(const void* const* in, const int* dims, const float* k,
                                  float* records, float* speed_kmh, int device, void* stream) {
    PrepInputs p;
    const void** dst = reinterpret_cast<const void**>(&p);
    for (int i = 0; i < RENDER_NUM_PREP_INPUTS; ++i) dst[i] = in[i];
    const RenderConsts K = consts_from(k);
    const SceneDims D = dims_from(dims);
    if (D.segments > MAX_NEAREST || D.near_buildings > MAX_NEAREST || D.near_lights > MAX_NEAREST)
        return (int)cudaErrorInvalidValue;
    return on_device(device, [&]() {
        RENDER_LAUNCH(render_prep_kernel, D.envs, PREP_THREADS, sizeof(SelectScratch),
                      (cudaStream_t)stream, p, K, D, records, speed_kmh);
        return cudaSuccess;
    });
}

extern "C" int render_points_launch(const float* records, const int* dims, const float* k,
                                    float* sxy, float* cols, float* cols_t, int device,
                                    void* stream) {
    const RenderConsts K = consts_from(k);
    const SceneDims D = dims_from(dims);
    return on_device(device, [&]() {
        RENDER_LAUNCH(render_points_kernel, blocks_for((long long)D.envs * D.height * D.width),
                      PIXEL_THREADS, 0, (cudaStream_t)stream, records, K, D, sxy, cols, cols_t);
        return cudaSuccess;
    });
}

extern "C" int render_shade_launch(const float* records, const float* tex, const float* phase,
                                   const float* streak_hash, const int* dims, const float* k,
                                   float* img, int device, void* stream) {
    const RenderConsts K = consts_from(k);
    const SceneDims D = dims_from(dims);
    const size_t smem = (size_t)D.record * sizeof(float);
    return on_device(device, [&]() {
        if (smem > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(
                render_shade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return err;
        }
        const dim3 grid(blocks_for((long long)D.height * D.width), D.envs);
        RENDER_LAUNCH(render_shade_kernel, grid, PIXEL_THREADS, smem, (cudaStream_t)stream,
                      records, tex, phase, streak_hash, K, D, img);
        return cudaSuccess;
    });
}

extern "C" int render_blur_launch(const float* img, const float* speed_kmh, const float* taps,
                                  int E, int H, int W, const float* k, float* out, int device,
                                  void* stream) {
    const RenderConsts K = consts_from(k);
    return on_device(device, [&]() {
        RENDER_LAUNCH(render_blur_kernel, blocks_for((long long)E * H * W), PIXEL_THREADS, 0,
                      (cudaStream_t)stream, img, speed_kmh, taps, K, E, H, W, out);
        return cudaSuccess;
    });
}

extern "C" const char* render_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
