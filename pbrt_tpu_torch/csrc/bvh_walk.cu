// Closest-hit / any-hit walks of the binary BVH (bvh_walk) and of the
// kd-tree (kd_walk), each ray with a private stack.
//
// Replaces no Pallas kernel. The reference walks these scenes in XLA
// (pbrt_tpu/device/intersect.py _traverse :487-694 and _traverse_kd
// :893-1048): a lax.while_loop that pops one node per 256-ray packet over
// one shared stack, because a TPU core cannot give each lane its own stack.
// In eager PyTorch that loop would cost hundreds of launches and a host sync
// per query; on a GPU a thread can keep its own stack, so each ray walks
// alone and visits only the nodes its own tests accept, near child first.
//
// bvh_walk: pbrt's BVHAccel::Intersect over the walk's records
// (scene/arrays.py bvh_walk_records), derived from the reference's
// bvh_packed rows: one 64-byte record per interior node holding both
// children's boxes (three float4) and an int4 of the children's references
// (an interior child's record, a leaf's ~offset), the split axis and the
// node's bvh_packed row; one 48-byte row per prim holding a triangle's 9
// vertex floats, then kind | rem << 4 (rem: the prims left in its leaf),
// the instance row and the animation group. The root's box (bvh_packed row
// 0) is tested when a ray starts; an interior node tests both children's
// boxes (tn <= tf * 1.0000004, tf > 0, tn < t_best) and goes on in the near
// child it hits (child 1 when the ray's direction is negative on the split
// axis: pbrt's order), pushing the far one with its tn when it hits both; a
// pop drops an entry whose tn is no longer below t_best. So the walk
// enters, in the same order and at the same t_best, exactly the nodes of a
// walk that tests each node's box when it pops it, and returns the same
// hits. A leaf's tests all run against the t_best it started with; its
// winner is the first prim of the nearest t, and it replaces the ray's hit
// only when strictly nearer. A prim of a nonzero instance sees the ray
// through inst_w2i (t is kept). Triangles take the watertight test
// (intersect.ray_triangle), quadrics quadric.cuh over their prim_test_data
// rows. pops counts the boxes tested (the root's, then two per interior
// node entered), which equals a pop-time walk's pops on closest-hit queries.
// kd_walk: pbrt's KdTreeAccel::Intersect over the kd walk's records
// (scene/arrays.py kd_walk_records), derived from the reference's kd_*
// tables: one 8-byte record per node (an interior node's split and axis |
// above << 2, a leaf's first row and 3 | count << 2), one 48-byte row per
// entry of kd_prim_ids in leaf order (the BVH walk's prim row, with the
// prim's row in place of the instance: a kd scene has none). The root
// interval comes from the tree's bounds; an interior node's split plane
// picks the first child (below when the origin lies below the split, or on
// it with a direction <= 0) and, when the plane cuts the interval, pushes
// the second with (t_split, t_max); a leaf's rows are tested at the t_best
// it starts with; a ray stops once its best hit lies before its next
// interval. pops counts the nodes visited, interior and leaf.
// Both write (t, prim, b1, b2, pops): t_max and -1 on a miss; b1, b2 the
// barycentrics of a triangle hit, a quadric hit's object-space x and y.
// They are the twins of device/bvh_walk.py walk_plain and kd_walk_plain,
// operation for operation (built with -fmad=false and without fast math).
//
// Bound: dependent loads and, on quadric leaves, the EFloat arithmetic.
// quadric_room(248)'s tables (251,168 prims) about fill the 50 MB L2; the
// walk reads its records, the prim rows of the leaves it enters and a
// quadric's prim_test_data row. What the BVH walk's design does about it
// (tools/bvh_walk_variants.py measures each lever against the others and
// against the design before it; PERF.md has the numbers):
//  - the records: a visit of an interior node is four 16-byte loads of one
//    record and two box tests, and it pushes only the far child it hits,
//    so a ray makes about half as many dependent steps as a walk that pops
//    every child; a leaf's prims are contiguous 48-byte rows, read as
//    float4, with the kind, instance and group the test needs;
//  - work done once: the ray in an instance's space is computed once per
//    (ray, instance) and kept while the instance repeats, the motion
//    group's M(dt) once per (ray, group) (the same arithmetic, so the same
//    bits);
//  - occupancy: __launch_bounds__(THREADS, BW_MIN_BLOCKS) caps the
//    registers at 72, 7 blocks of 128 per SM;
//  - one thread per ray over a grid that covers the rays: persistent
//    lanes over a ray queue (B1's) hold more rays per warp on bounce rays
//    but cost two ballots and a branch per visit, more than the idle lanes
//    cost here (a visit is two box tests, not B1's eight).
// What the kd walk's design does about the same bound (the same tool
// measures its levers against the design before it):
//  - the records: an interior visit is one 8-byte load where the tables
//    took three dependent scalar loads (kd_flags, kd_split, kd_above), and
//    a leaf's candidates are contiguous 48-byte rows tested by the BVH
//    walk's bw_test, where each took a kd_prim_ids load, then a prim_kind
//    load and its prim_test_data row;
//  - the stack: KD_STACK (node, t_min, t_max) entries of 12 bytes, the kd
//    build's depth bound round(8 + 1.3 log2 n) for any int32 prim count
//    (a ray holds at most one entry per interior level of the tree); the
//    wrapper refuses a deeper tree before the launch;
//  - work done once: the motion group's M(dt) once per (ray, group);
//  - occupancy: __launch_bounds__(THREADS, KD_MIN_BLOCKS) on the static
//    instantiation (72 registers, 7 blocks per SM); the motion ones take
//    no cap, where 72 registers spilled 148-192 bytes;
//  - one thread per ray over a grid that covers the rays, as the BVH walk.
// bvh_walk_counted is the instrumented build: it also writes each ray's
// prim tests (triangle, quadric, and those through an instance transform)
// and its node visits (loop iterations), and marks the bvh_packed rows the
// walk read (a node's box: bit 1, when the box is tested; its offset and
// count: bit 2, when the node is entered; its axis: bit 4, when an
// interior node is entered), the prim rows tested and the instances used,
// so that the bound counts the operations done and the bytes read.
//
// Motion blur: the MOTION template argument of both walks. MOTION 0 is the
// static walk above. The motion instantiations take a per-ray shutter
// fraction time in [0, 1] and move each candidate prim to it before its
// test, as the reference's time-aware leaf test does (intersect.py
// :575-600, _test_prims :326-354):
// - MOTION 1 (keyframes): the prim row lerped toward its shutter-close row
//   (ptd_end), plus the quadratic arc term through its mid-shutter row
//   (ptd_mid) where the scene has one (_motion_quad :697); a triangle's 9
//   vertex floats, a quadric's world-to-object (12);
// - MOTION 2 (the exact animated transform, scenes whose shutter transform
//   rotates): the prim's group (anim_gid) slerped at the ray's time with
//   the nlerp below theta 0.0317, the rotation built, scale and translation
//   lerped, M(dt) = T R S (device/motion.py eval_anim); a triangle's three
//   shutter-open vertices go through M(dt) . C, a quadric's world-to-object
//   is C . M(dt)^-1 (the adjugate inverse, |det| clamped at 1e-30), C the
//   prim's anim_c. The identity group 0 goes through the same math, as the
//   reference's does.
// An instanced prim's ray is brought to instance space first. The motion
// code runs in device/motion.py's order (the twin's), with sinf, sqrtf and
// IEEE division; bvh_walk_motion, kd_walk_motion and
// bvh_walk_motion_counted are its entries.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quadric.cuh"

#define THREADS 128
#define BW_STACK 64      // entries (far child, its tn) per ray: intersect.STACK_DEPTH
#define BW_MIN_BLOCKS 7  // resident blocks per SM the register cap aims at (72 registers; PERF.md)
#define KD_STACK 48      // todo entries per ray: the kd build's depth bound for any n < 2^31 prims
#define KD_MIN_BLOCKS 7  // resident blocks per SM the kd walk's register cap aims at (PERF.md)
#define KD_MIN_BLOCKS_MOTION 1  // ... and its motion instantiations': no cap (PERF.md)
#define BW_ITER_CAP 1000000
#define BW_EPS 1e-4f
#define BW_SLAB 1.0000004f

// v[i] for a runtime i in 0..2 without indexing a local array (which would
// put the array in local memory)
__device__ __forceinline__ float bw_pick(const float v[3], int i) { return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]); }

// The motion tables of a MOTION > 0 walk (unused by the static walk).
struct BwMotion {
    const float* time;     // (R,) shutter fraction per ray
    const float* ptd_end;  // (P, cols) shutter-close rows (MOTION 1)
    const float* ptd_mid;  // (P, cols) mid-shutter rows, or null (MOTION 1)
    const float* anim;     // (G, BW_ANIM_COLS) group rows (MOTION 2): q0, q1, t0, t1, s0, s1, theta
    const int* anim_gid;   // (P,) group per prim (MOTION 2)
    const float* anim_c;   // (P, 12) compose constant per prim (MOTION 2)
};

// the columns of a group row (device/bvh_walk.py anim_records)
#define BW_ANIM_COLS 36

struct BwRay {
    float o[3], d[3];
    int kz;
    float sx, sy, sz;
};

__device__ __forceinline__ void bw_setup(BwRay& r, const float o[3], const float d[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        r.o[i] = o[i];
        r.d[i] = d[i];
    }
    // kz = argmax |d| (first index on ties), kx = kz + 1, ky = kz + 2 (mod 3)
    const float ax = fabsf(d[0]), ay = fabsf(d[1]), az = fabsf(d[2]);
    int kz = 0;
    if (ay > ax) kz = 1;
    if (az > (kz == 0 ? ax : ay)) kz = 2;
    r.kz = kz;
    const float dkx = bw_pick(d, kz == 2 ? 0 : kz + 1), dky = bw_pick(d, kz == 0 ? 2 : kz - 1), dkz = bw_pick(d, kz);
    const float inv_dz = 1.0f / dkz;
    r.sx = -dkx * inv_dz;
    r.sy = -dky * inv_dz;
    r.sz = inv_dz;
}

// The watertight test of one triangle (9 floats): intersect.ray_triangle.
__device__ __forceinline__ bool bw_tri(const BwRay& r, const float* v, float t_max, float& t, float& b1, float& b2) {
    float xs[3], ys[3], zs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float vx = v[3 * i] - r.o[0], vy = v[3 * i + 1] - r.o[1], vz = v[3 * i + 2] - r.o[2];
        const float px = r.kz == 0 ? vy : (r.kz == 1 ? vz : vx);
        const float py = r.kz == 0 ? vz : (r.kz == 1 ? vx : vy);
        const float pz = r.kz == 0 ? vx : (r.kz == 1 ? vy : vz);
        xs[i] = px + r.sx * pz;
        ys[i] = py + r.sy * pz;
        zs[i] = r.sz * pz;
    }
    const float e0 = xs[1] * ys[2] - ys[1] * xs[2];
    const float e1 = xs[2] * ys[0] - ys[2] * xs[0];
    const float e2 = xs[0] * ys[1] - ys[0] * xs[1];
    const bool same = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) || (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
    const float det = e0 + e1 + e2;
    if (!same || det == 0.0f) return false;
    const float inv = 1.0f / det;
    t = (e0 * zs[0] + e1 * zs[1] + e2 * zs[2]) * inv;
    b1 = e1 * inv;
    b2 = e2 * inv;
    return t > BW_EPS && t < t_max;
}

// r = a . b of two 3x3 (row-major) matrices, each entry (a_i0 b_0j +
// a_i1 b_1j) + a_i2 b_2j (motion._mat3); stride: b's and r's row stride
__device__ __forceinline__ void bw_mat3(const float* a, int sa, const float* b, int sb, float* r, int sr) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            r[sr * i + j] = (a[sa * i] * b[j] + a[sa * i + 1] * b[sb + j]) + a[sa * i + 2] * b[2 * sb + j];
}

// M(dt) (3x4, row-major) of a group row g at shutter fraction dt
// (motion.eval_anim)
__device__ __forceinline__ void bw_anim_matrix(const float* __restrict__ g, float dt, float m[12]) {
    float gr[BW_ANIM_COLS];
#pragma unroll
    for (int i = 0; i < 33; ++i) gr[i] = __ldg(g + i);
    const float theta = gr[32];
    const bool near = theta < 0.0317f;
    const float st = sinf(near ? 1.0f : theta);
    const float w0 = near ? 1.0f - dt : sinf((1.0f - dt) * theta) / st;
    const float w1 = near ? dt : sinf(dt * theta) / st;
    float q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = w0 * gr[i] + w1 * gr[4 + i];
    const float n2 = ((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3];
    const float nrm = fmaxf(sqrtf(n2), 1e-12f);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = q[i] / nrm;
    const float w = q[0], x = q[1], y = q[2], z = q[3];
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    const float rot[9] = {1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy),
                          2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx),
                          2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)};
    float sc[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) sc[i] = (1.0f - dt) * gr[14 + i] + dt * gr[23 + i];
    bw_mat3(rot, 3, sc, 3, m, 4);
#pragma unroll
    for (int i = 0; i < 3; ++i) m[4 * i + 3] = (1.0f - dt) * gr[8 + i] + dt * gr[11 + i];
}

// a . b as 3x4 affine transforms, b applied first (motion._compose)
__device__ __forceinline__ void bw_compose(const float a[12], const float b[12], float r[12]) {
    bw_mat3(a, 4, b, 4, r, 4);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        r[4 * i + 3] = ((a[4 * i] * b[3] + a[4 * i + 1] * b[7]) + a[4 * i + 2] * b[11]) + a[4 * i + 3];
}

// the inverse of a 3x4 affine transform by the adjugate (motion._affine_inverse)
__device__ __forceinline__ void bw_affine_inverse(const float m[12], float r[12]) {
    // the columns a0, a1, a2 of the linear part
    const float a0[3] = {m[0], m[4], m[8]}, a1[3] = {m[1], m[5], m[9]}, a2[3] = {m[2], m[6], m[10]};
    const float c[9] = {a1[1] * a2[2] - a1[2] * a2[1], a1[2] * a2[0] - a1[0] * a2[2], a1[0] * a2[1] - a1[1] * a2[0],
                        a2[1] * a0[2] - a2[2] * a0[1], a2[2] * a0[0] - a2[0] * a0[2], a2[0] * a0[1] - a2[1] * a0[0],
                        a0[1] * a1[2] - a0[2] * a1[1], a0[2] * a1[0] - a0[0] * a1[2], a0[0] * a1[1] - a0[1] * a1[0]};
    float det = (a0[0] * c[0] + a0[1] * c[1]) + a0[2] * c[2];
    det = fabsf(det) < 1e-30f ? 1e-30f : det;
#pragma unroll
    for (int i = 0; i < 9; ++i) r[4 * (i / 3) + i % 3] = c[i] / det;
#pragma unroll
    for (int i = 0; i < 3; ++i)
        r[4 * i + 3] = -((r[4 * i] * m[3] + r[4 * i + 1] * m[7]) + r[4 * i + 2] * m[11]);
}

// The ray in an instance's space (w2i: its 3x4 world-to-instance rows).
__device__ __forceinline__ void bw_inst_ray(const BwRay& r, const float* __restrict__ m, BwRay& ri) {
    float o[3], d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = __ldg(m + 4 * i) * r.o[0] + __ldg(m + 4 * i + 1) * r.o[1] + __ldg(m + 4 * i + 2) * r.o[2] +
               __ldg(m + 4 * i + 3);
        d[i] = __ldg(m + 4 * i) * r.d[0] + __ldg(m + 4 * i + 1) * r.d[1] + __ldg(m + 4 * i + 2) * r.d[2];
    }
    bw_setup(ri, o, d);
}

// One prim against the ray rr (already in its instance's space), at t_max:
// a triangle's shutter-open vertices v (its prim row's first 9 floats), or
// a quadric's prim_test_data row; moved to the ray's time dt (MOTION 1:
// the keyframe rows of pid; MOTION 2: through g, the prim's M(dt) . C for
// a triangle, C . M(dt)^-1 for a quadric), then the watertight or the
// quadric test.
template <int MOTION>
__device__ __forceinline__ bool bw_test(const BwRay& rr, int pid, bool tri, const float v0[9],
                                        const float* __restrict__ row, int cols, const float g[12],
                                        const BwMotion& mo, float dt, float t_max, float& t, float& b1, float& b2) {
    if (tri) {
        float v[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) v[i] = v0[i];
        if (MOTION == 1) {
            const float* re = mo.ptd_end + (size_t)pid * cols;
#pragma unroll
            for (int i = 0; i < 9; ++i) v[i] = v[i] + dt * (__ldg(re + i) - v[i]);
            if (mo.ptd_mid) {
                const float* rm = mo.ptd_mid + (size_t)pid * cols;
#pragma unroll
                for (int i = 0; i < 9; ++i)
                    v[i] = v[i] + (dt * (1.0f - dt)) * ((4.0f * __ldg(rm + i) - 2.0f * v0[i]) - 2.0f * __ldg(re + i));
            }
        } else if (MOTION == 2) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
#pragma unroll
                for (int i = 0; i < 3; ++i)
                    v[3 * k + i] =
                        ((g[4 * i] * v0[3 * k] + g[4 * i + 1] * v0[3 * k + 1]) + g[4 * i + 2] * v0[3 * k + 2]) +
                        g[4 * i + 3];
        }
        return bw_tri(rr, v, t_max, t, b1, b2);
    }
    float w2o[12], par[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) w2o[i] = __ldg(row + i);
    if (MOTION == 1) {
        const float* re = mo.ptd_end + (size_t)pid * cols;
#pragma unroll
        for (int i = 0; i < 12; ++i) w2o[i] = w2o[i] + dt * (__ldg(re + i) - w2o[i]);
        if (mo.ptd_mid) {
            const float* rm = mo.ptd_mid + (size_t)pid * cols;
#pragma unroll
            for (int i = 0; i < 12; ++i) {
                const float b = __ldg(row + i);
                w2o[i] = w2o[i] + (dt * (1.0f - dt)) * ((4.0f * __ldg(rm + i) - 2.0f * b) - 2.0f * __ldg(re + i));
            }
        }
    } else if (MOTION == 2) {
#pragma unroll
        for (int i = 0; i < 12; ++i) w2o[i] = g[i];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) par[i] = __ldg(row + 12 + i);
    const bool twisted = cols >= 25;
    if (twisted) {
#pragma unroll
        for (int i = 0; i < 6; ++i) par[6 + i] = __ldg(row + 19 + i);
    }
    return qf_ray_quadric(rr.o, rr.d, w2o, par, (int)__ldg(row + 18), twisted, t_max, t, b1, b2);
}

// g of a prim under MOTION 2 from its group's M(dt) m: M(dt) . C for a
// triangle, C . M(dt)^-1 for a quadric (C its anim_c row).
__device__ __forceinline__ void bw_motion_g(const float m[12], const float* __restrict__ anim_c, int pid, bool tri,
                                            float g[12]) {
    float c[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) c[i] = __ldg(anim_c + (size_t)pid * 12 + i);
    if (tri) {
        bw_compose(m, c, g);
    } else {
        float mi[12];
        bw_affine_inverse(m, mi);
        bw_compose(c, mi, g);
    }
}

// 1/d with |d| clamped at 1e-30 (bvh_walk._inv_dir)
__device__ __forceinline__ float bw_inv(float x) {
    return 1.0f / (fabsf(x) < 1e-30f ? (x < 0.0f ? -1e-30f : 1e-30f) : x);
}

// The slab test of a box (lo, hi): enter = tn <= tf * BW_SLAB, tf > 0 and
// tn < t_best; tn out.
__device__ __forceinline__ bool bw_box(const float o[3], const float inv[3], float t_best, float lx, float ly,
                                       float lz, float hx, float hy, float hz, float& tn) {
    const float lo[3] = {lx, ly, lz}, hi[3] = {hx, hy, hz};
    float n = -INFINITY, f = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float t0 = (lo[a] - o[a]) * inv[a];
        const float t1 = (hi[a] - o[a]) * inv[a];
        n = qf_max(n, qf_min(t0, t1));
        f = qf_min(f, qf_max(t0, t1));
    }
    f = f * BW_SLAB;
    tn = n;
    return n <= f && f > 0.0f && n < t_best;
}

// One ray's BVH walk between node visits.
struct BwWalk {
    BwRay r;                       // the world ray
    float inv[3];
    float t_best, b1, b2, dt;
    int prim, pops, cur, sp;       // cur: the node to visit (record, or ~leaf offset)
    bool live;
    int c_iid;                     // the instance whose space ri holds (0: none yet)
    BwRay ri;
    int c_gid;                     // the group whose M(dt) m holds (-1: none yet; MOTION 2)
    float m[12];
    int visits, n_tri, n_quad, n_inst, cur_row;  // the instrumented build's counts; cur's bvh_packed row
};

// The BVH walk's tables and instrumented outputs.
struct BwTables {
    const float* nodes;     // bvh_packed (N, 12): the root's box; the counted build's rows
    const float4* node_rec; // (n_interior, 4) float4
    const float4* prim_rec; // (P, 3) float4
    const float* ptd;       // prim_test_data (P, cols): the quadrics' rows
    int cols;
    const float* inst_w2i;  // (I, 12)
    int* seen_nodes;        // the counted build: bits per bvh_packed row
    int* seen_prims;
    int* seen_inst;
};

// Start ray id: its setup and the root's box (a dead ray, t_max <= 0,
// tests nothing).
template <bool COUNT, int MOTION>
__device__ __forceinline__ void bw_start(BwWalk& w, int id, const float* __restrict__ o_in,
                                         const float* __restrict__ d_in, const float* __restrict__ t_max_in,
                                         const BwTables& tb, const BwMotion& mo) {
    const float o[3] = {o_in[3 * id], o_in[3 * id + 1], o_in[3 * id + 2]};
    const float d[3] = {d_in[3 * id], d_in[3 * id + 1], d_in[3 * id + 2]};
#pragma unroll
    for (int i = 0; i < 3; ++i) w.inv[i] = bw_inv(d[i]);
    bw_setup(w.r, o, d);
    w.dt = MOTION ? mo.time[id] : 0.0f;
    w.t_best = t_max_in[id];
    w.b1 = 0.0f;
    w.b2 = 0.0f;
    w.prim = -1;
    w.pops = 0;
    w.sp = 0;
    w.c_iid = 0;
    w.c_gid = -1;
    w.visits = w.n_tri = w.n_quad = w.n_inst = 0;
    w.cur_row = 0;
    w.live = false;
    if (w.t_best > 0.0f) {
        const float* rt = tb.nodes;
        float tn;
        w.pops = 1;
        w.live = bw_box(w.r.o, w.inv, w.t_best, __ldg(rt), __ldg(rt + 1), __ldg(rt + 2), __ldg(rt + 3),
                        __ldg(rt + 4), __ldg(rt + 5), tn);
        w.cur = __ldg(rt + 7) > 0.0f ? ~(int)__ldg(rt + 6) : 0;
        if (COUNT) atomicOr(tb.seen_nodes, 1);
    }
}

// One visit of the node w.cur (an interior node's two boxes, or a leaf's
// prims), then, unless it goes on in a child, a pop.
template <bool COUNT, int MOTION>
__device__ __forceinline__ void bw_visit(BwWalk& w, int2* stack, int* st_row, const BwTables& tb, bool any_hit,
                                         unsigned int* counters, const BwMotion& mo) {
    if (w.pops >= BW_ITER_CAP) {
        atomicAdd(&counters[1], 1u);
        w.live = false;
        return;
    }
    if (COUNT) ++w.visits;
    if (w.cur >= 0) {
        const float4* rec = tb.node_rec + (size_t)w.cur * 4;
        const float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
        const int4 m = __ldg(reinterpret_cast<const int4*>(rec + 3));
        float tn0, tn1;
        const bool h0 = bw_box(w.r.o, w.inv, w.t_best, a.x, a.y, a.z, a.w, b.x, b.y, tn0);
        const bool h1 = bw_box(w.r.o, w.inv, w.t_best, b.z, b.w, c.x, c.y, c.z, c.w, tn1);
        w.pops += 2;
        const bool neg = bw_pick(w.r.d, m.z) < 0.0f;
        const bool hn = neg ? h1 : h0, hf = neg ? h0 : h1;
        const int rn = neg ? m.y : m.x, rf = neg ? m.x : m.y;
        int row_n = 0, row_f = 0;
        if (COUNT) {
            const int left = m.w + 1, right = (int)__ldg(tb.nodes + (size_t)m.w * 12 + 6);
            atomicOr(tb.seen_nodes + m.w, 6);
            atomicOr(tb.seen_nodes + left, 1);
            atomicOr(tb.seen_nodes + right, 1);
            row_n = neg ? right : left;
            row_f = neg ? left : right;
        }
        if (hn && hf) {
            if (w.sp < BW_STACK) {
                stack[w.sp] = make_int2(rf, __float_as_int(neg ? tn0 : tn1));
                if (COUNT) st_row[w.sp] = row_f;
                ++w.sp;
            } else {
                atomicAdd(&counters[0], 1u);
            }
        }
        if (hn || hf) {
            w.cur = hn ? rn : rf;
            if (COUNT) w.cur_row = hn ? row_n : row_f;
            return;
        }
    } else {
        // a leaf: its prims at the t_best it starts with
        int p = ~w.cur;
        float tmin = INFINITY, v1 = 0.0f, v2 = 0.0f;
        int win = -1;
        if (COUNT) atomicOr(tb.seen_nodes + w.cur_row, 2);
        for (;;) {
            const float4* pr = tb.prim_rec + (size_t)p * 3;
            const float4 q0 = __ldg(pr), q1 = __ldg(pr + 1), q2 = __ldg(pr + 2);
            const int kw = __float_as_int(q2.y), iid = __float_as_int(q2.z);
            const bool tri = (kw & 15) == 0;
            if (COUNT) {
                if (tri) ++w.n_tri; else ++w.n_quad;
                tb.seen_prims[p] = 1;
                if (iid != 0) {
                    ++w.n_inst;
                    tb.seen_inst[iid] = 1;
                }
            }
            // the ray in the prim's instance space, once per (ray, instance)
            if (iid != 0 && iid != w.c_iid) {
                bw_inst_ray(w.r, tb.inst_w2i + (size_t)iid * 12, w.ri);
                w.c_iid = iid;
            }
            float g[12];
            if (MOTION == 2) {
                // the group's M(dt), once per (ray, group)
                const int gid = __float_as_int(q2.w);
                if (gid != w.c_gid) {
                    bw_anim_matrix(mo.anim + (size_t)gid * BW_ANIM_COLS, w.dt, w.m);
                    w.c_gid = gid;
                }
                bw_motion_g(w.m, mo.anim_c, p, tri, g);
            }
            const float v[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
            float t, c1, c2;
            if (bw_test<MOTION>(iid != 0 ? w.ri : w.r, p, tri, v, tb.ptd + (size_t)p * tb.cols, tb.cols, g, mo, w.dt,
                                w.t_best, t, c1, c2) &&
                t < tmin) {
                tmin = t;
                v1 = c1;
                v2 = c2;
                win = p;
            }
            if ((kw >> 4) <= 1) break;
            ++p;
        }
        if (tmin < w.t_best) {
            w.t_best = tmin;
            w.prim = win;
            w.b1 = v1;
            w.b2 = v2;
            if (any_hit) {
                w.live = false;
                return;
            }
        }
    }
    // pop: the top entry whose tn is still below t_best
    while (w.sp > 0) {
        const int2 e = stack[--w.sp];
        if (__int_as_float(e.y) < w.t_best) {
            w.cur = e.x;
            if (COUNT) w.cur_row = st_row[w.sp];
            return;
        }
    }
    w.live = false;
}

// One thread per ray over a grid that covers the rays (a thread's loop
// iterations are its node visits).
template <bool COUNT, int MOTION>
__global__ void __launch_bounds__(THREADS, BW_MIN_BLOCKS)
bvh_walk_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in, const float* __restrict__ t_max_in,
                int n_rays, BwTables tb, int any_hit, float* __restrict__ out_t, int* __restrict__ out_prim,
                float* __restrict__ out_b1, float* __restrict__ out_b2, int* __restrict__ out_pops,
                unsigned int* __restrict__ counters, int* __restrict__ out_tests, BwMotion mo) {
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    BwWalk w;
    int2 stack[BW_STACK];
    int st_row[COUNT ? BW_STACK : 1];
    if (ray < n_rays) {
        bw_start<COUNT, MOTION>(w, ray, o_in, d_in, t_max_in, tb, mo);
        while (w.live) {
            bw_visit<COUNT, MOTION>(w, stack, st_row, tb, any_hit != 0, counters, mo);
        }
        out_t[ray] = w.t_best;
        out_prim[ray] = w.prim;
        out_b1[ray] = w.b1;
        out_b2[ray] = w.b2;
        out_pops[ray] = w.pops;
        if (COUNT) {
            out_tests[4 * ray] = w.n_tri;
            out_tests[4 * ray + 1] = w.n_quad;
            out_tests[4 * ray + 2] = w.n_inst;
            out_tests[4 * ray + 3] = w.visits;
        }
    }
}

// One todo entry of the kd walk: the node and its (t_min, t_max)
struct KdEntry {
    int node;
    float lo, hi;
};

// pbrt's KdTreeAccel::Intersect over the kd walk's records, one thread per
// ray over a grid that covers the rays.
template <int MOTION>
__global__ void __launch_bounds__(THREADS, MOTION ? KD_MIN_BLOCKS_MOTION : KD_MIN_BLOCKS)
kd_walk_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in, const float* __restrict__ t_max_in,
               int n_rays, const int2* __restrict__ node_rec, const float4* __restrict__ leaf_rec,
               const float* __restrict__ kd_lo, const float* __restrict__ kd_hi, const float* __restrict__ ptd,
               int cols, int any_hit, float* __restrict__ out_t, int* __restrict__ out_prim,
               float* __restrict__ out_b1, float* __restrict__ out_b2, int* __restrict__ out_pops,
               unsigned int* __restrict__ counters, BwMotion mo) {
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= n_rays) return;
    const float dt = MOTION ? mo.time[ray] : 0.0f;
    const float o[3] = {o_in[3 * ray], o_in[3 * ray + 1], o_in[3 * ray + 2]};
    const float d[3] = {d_in[3 * ray], d_in[3 * ray + 1], d_in[3 * ray + 2]};
    const float inv[3] = {bw_inv(d[0]), bw_inv(d[1]), bw_inv(d[2])};
    BwRay r;
    bw_setup(r, o, d);
    const float t_max = t_max_in[ray];
    float t_best = t_max, b1 = 0.0f, b2 = 0.0f;
    int prim = -1, pops = 0;
    // the root interval: the tree's bounds
    float tn = -INFINITY, tf = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float t0 = (__ldg(kd_lo + a) - o[a]) * inv[a];
        const float t1 = (__ldg(kd_hi + a) - o[a]) * inv[a];
        tn = qf_max(tn, qf_min(t0, t1));
        tf = qf_min(tf, qf_max(t0, t1));
    }
    tf = tf * BW_SLAB;
    bool live = tn <= tf && tf > 0.0f && t_max > 0.0f;
    int node = 0;
    float tmin = qf_max(tn, 0.0f), tmax = qf_min(tf, t_max);
    KdEntry stack[KD_STACK];
    int sp = 0;
    int c_gid = -1;  // the group whose M(dt) m holds (MOTION 2)
    float m[12];
    while (live) {
        if (t_best < tmin) break;  // pbrt: if (ray.tMax < tMin) break
        if (pops >= BW_ITER_CAP) {
            atomicAdd(&counters[1], 1u);
            break;
        }
        ++pops;
        const int2 nd = __ldg(node_rec + node);
        const int fl = nd.y & 3;
        if (fl != 3) {
            const float s = __int_as_float(nd.x);
            const float o_a = bw_pick(o, fl), d_a = bw_pick(d, fl);
            const float tp = (s - o_a) * bw_pick(inv, fl);
            const bool below_first = o_a < s || (o_a == s && d_a <= 0.0f);
            const int above = nd.y >> 2;
            const int first = below_first ? node + 1 : above;
            const int second = below_first ? above : node + 1;
            if (tp > tmax || tp <= 0.0f) {
                node = first;
            } else if (tp < tmin) {
                node = second;
            } else {
                if (sp < KD_STACK) {
                    stack[sp] = KdEntry{second, tp, tmax};
                    ++sp;
                } else {
                    atomicAdd(&counters[0], 1u);
                }
                node = first;
                tmax = tp;
            }
            continue;
        }
        // a leaf: its rows at the t_best it starts with
        const float4* pr = leaf_rec + (size_t)nd.x * 3;
        const int n = nd.y >> 2;
        float tl = INFINITY, w1 = 0.0f, w2 = 0.0f;
        int win = -1;
        for (int k = 0; k < n; ++k, pr += 3) {
            const float4 q0 = __ldg(pr), q1 = __ldg(pr + 1), q2 = __ldg(pr + 2);
            const bool tri = (__float_as_int(q2.y) & 15) == 0;
            const int pid = __float_as_int(q2.z);
            float g[12];
            if (MOTION == 2) {
                // the group's M(dt), once per (ray, group)
                const int gid = __float_as_int(q2.w);
                if (gid != c_gid) {
                    bw_anim_matrix(mo.anim + (size_t)gid * BW_ANIM_COLS, dt, m);
                    c_gid = gid;
                }
                bw_motion_g(m, mo.anim_c, pid, tri, g);
            }
            const float v[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
            float t, c1, c2;
            if (bw_test<MOTION>(r, pid, tri, v, ptd + (size_t)pid * cols, cols, g, mo, dt, t_best, t, c1, c2) &&
                t < tl) {
                tl = t;
                w1 = c1;
                w2 = c2;
                win = pid;
            }
        }
        const bool better = tl < t_best;
        if (better) {
            t_best = tl;
            prim = win;
            b1 = w1;
            b2 = w2;
        }
        if (sp == 0 || (better && any_hit)) break;
        --sp;
        node = stack[sp].node;
        tmin = stack[sp].lo;
        tmax = stack[sp].hi;
    }
    out_t[ray] = t_best;
    out_prim[ray] = prim;
    out_b1[ray] = b1;
    out_b2[ray] = b2;
    out_pops[ray] = pops;
}

static BwMotion bw_motion(const void* time, const void* ptd_end, const void* ptd_mid, const void* anim,
                          const void* anim_gid, const void* anim_c) {
    return BwMotion{(const float*)time, (const float*)ptd_end, (const float*)ptd_mid, (const float*)anim,
                    (const int*)anim_gid, (const float*)anim_c};
}

template <bool COUNT, int MOTION>
static int launch_bvh(const void* o, const void* d, const void* t_max, int n_rays, const BwTables& tb, int any_hit,
                      void* out_t, void* out_prim, void* out_b1, void* out_b2, void* out_pops, void* counters,
                      void* stream, void* out_tests, BwMotion mo) {
    if (n_rays > 0) {
        const int blocks = (n_rays + THREADS - 1) / THREADS;
        bvh_walk_kernel<COUNT, MOTION><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const float*)t_max, n_rays, tb, any_hit, (float*)out_t,
            (int*)out_prim, (float*)out_b1, (float*)out_b2, (int*)out_pops, (unsigned int*)counters,
            (int*)out_tests, mo);
    }
    return (int)cudaGetLastError();
}

static BwTables bw_tables(const void* nodes, const void* node_rec, const void* prim_rec, const void* ptd, int cols,
                          const void* inst_w2i, void* seen_nodes, void* seen_prims, void* seen_inst) {
    return BwTables{(const float*)nodes, (const float4*)node_rec, (const float4*)prim_rec, (const float*)ptd, cols,
                    (const float*)inst_w2i, (int*)seen_nodes, (int*)seen_prims, (int*)seen_inst};
}

template <int MOTION>
static int launch_kd(const void* o, const void* d, const void* t_max, int n_rays, const void* node_rec,
                     const void* leaf_rec, const void* kd_lo, const void* kd_hi, const void* ptd, int cols, int any_hit,
                     void* out_t, void* out_prim, void* out_b1, void* out_b2, void* out_pops, void* counters,
                     void* stream, BwMotion mo) {
    if (n_rays > 0) {
        const int blocks = (n_rays + THREADS - 1) / THREADS;
        kd_walk_kernel<MOTION><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const float*)t_max, n_rays, (const int2*)node_rec,
            (const float4*)leaf_rec, (const float*)kd_lo, (const float*)kd_hi, (const float*)ptd, cols, any_hit,
            (float*)out_t, (int*)out_prim, (float*)out_b1, (float*)out_b2, (int*)out_pops, (unsigned int*)counters,
            mo);
    }
    return (int)cudaGetLastError();
}

// The BVH walk's entries. Tables: bvh_packed (the root's box; the counted
// build's rows), the walk's node and prim records, prim_test_data and its
// column count, inst_w2i.
extern "C" int bvh_walk(const void* o, const void* d, const void* t_max, int n_rays, const void* nodes,
                        const void* node_rec, const void* prim_rec, const void* ptd, int cols, const void* inst_w2i,
                        int any_hit, void* out_t, void* out_prim, void* out_b1, void* out_b2, void* out_pops,
                        void* counters, void* stream) {
    return launch_bvh<false, 0>(o, d, t_max, n_rays,
                                bw_tables(nodes, node_rec, prim_rec, ptd, cols, inst_w2i, nullptr, nullptr, nullptr),
                                any_hit, out_t, out_prim, out_b1, out_b2, out_pops, counters, stream,
                                nullptr, BwMotion{});
}

// bvh_walk's arguments, then out_tests (R, 4: triangle, quadric and
// instanced tests, node visits) and the zeroed row marks of bvh_packed,
// the prims and the instances.
extern "C" int bvh_walk_counted(const void* o, const void* d, const void* t_max, int n_rays, const void* nodes,
                                const void* node_rec, const void* prim_rec, const void* ptd, int cols,
                                const void* inst_w2i, int any_hit, void* out_t, void* out_prim, void* out_b1,
                                void* out_b2, void* out_pops, void* counters, void* stream,
                                void* out_tests, void* seen_nodes, void* seen_prims, void* seen_inst) {
    return launch_bvh<true, 0>(
        o, d, t_max, n_rays,
        bw_tables(nodes, node_rec, prim_rec, ptd, cols, inst_w2i, seen_nodes, seen_prims, seen_inst),
        any_hit, out_t, out_prim, out_b1, out_b2, out_pops, counters, stream, out_tests, BwMotion{});
}

// The motion walks: bvh_walk's arguments, then motion (1 keyframes, 2 the
// exact animated transform), the per-ray time and the motion tables
// (ptd_mid may be null; the tables a MOTION does not read may be null; the
// BVH walk reads each prim's group from its prim record, not anim_gid).
extern "C" int bvh_walk_motion(const void* o, const void* d, const void* t_max, int n_rays, const void* nodes,
                               const void* node_rec, const void* prim_rec, const void* ptd, int cols,
                               const void* inst_w2i, int any_hit, void* out_t, void* out_prim, void* out_b1,
                               void* out_b2, void* out_pops, void* counters, void* stream,
                               int motion, const void* time, const void* ptd_end, const void* ptd_mid,
                               const void* anim, const void* anim_gid, const void* anim_c) {
    const BwMotion mo = bw_motion(time, ptd_end, ptd_mid, anim, anim_gid, anim_c);
    const BwTables tb = bw_tables(nodes, node_rec, prim_rec, ptd, cols, inst_w2i, nullptr, nullptr, nullptr);
#define BW_CALL(M)                                                                                               \
    launch_bvh<false, M>(o, d, t_max, n_rays, tb, any_hit, out_t, out_prim, out_b1, out_b2, out_pops, counters, \
                         stream, nullptr, mo)
    if (motion == 1) return BW_CALL(1);
    if (motion == 2) return BW_CALL(2);
#undef BW_CALL
    return (int)cudaErrorInvalidValue;
}

extern "C" int bvh_walk_motion_counted(const void* o, const void* d, const void* t_max, int n_rays,
                                       const void* nodes, const void* node_rec, const void* prim_rec,
                                       const void* ptd, int cols, const void* inst_w2i, int any_hit, void* out_t,
                                       void* out_prim, void* out_b1, void* out_b2, void* out_pops, void* counters,
                                       void* stream, int motion, const void* time,
                                       const void* ptd_end, const void* ptd_mid, const void* anim,
                                       const void* anim_gid, const void* anim_c, void* out_tests, void* seen_nodes,
                                       void* seen_prims, void* seen_inst) {
    const BwMotion mo = bw_motion(time, ptd_end, ptd_mid, anim, anim_gid, anim_c);
    const BwTables tb = bw_tables(nodes, node_rec, prim_rec, ptd, cols, inst_w2i, seen_nodes, seen_prims, seen_inst);
#define BW_CALL(M)                                                                                              \
    launch_bvh<true, M>(o, d, t_max, n_rays, tb, any_hit, out_t, out_prim, out_b1, out_b2, out_pops, counters, \
                        stream, out_tests, mo)
    if (motion == 1) return BW_CALL(1);
    if (motion == 2) return BW_CALL(2);
#undef BW_CALL
    return (int)cudaErrorInvalidValue;
}

// The kd walk's entries. Tables: the kd walk's node records and leaf rows
// (scene/arrays.py kd_walk_records), the tree's bounds kd_lo, kd_hi,
// prim_test_data and its column count.
extern "C" int kd_walk(const void* o, const void* d, const void* t_max, int n_rays, const void* node_rec,
                       const void* leaf_rec, const void* kd_lo, const void* kd_hi, const void* ptd, int cols,
                       int any_hit, void* out_t, void* out_prim, void* out_b1, void* out_b2, void* out_pops,
                       void* counters, void* stream) {
    return launch_kd<0>(o, d, t_max, n_rays, node_rec, leaf_rec, kd_lo, kd_hi, ptd, cols, any_hit, out_t, out_prim,
                        out_b1, out_b2, out_pops, counters, stream, BwMotion{});
}

// kd_walk's arguments, then motion, the per-ray time and the motion tables
// (bvh_walk_motion's; the kd walk reads each row's group from its leaf row,
// not anim_gid)
extern "C" int kd_walk_motion(const void* o, const void* d, const void* t_max, int n_rays, const void* node_rec,
                              const void* leaf_rec, const void* kd_lo, const void* kd_hi, const void* ptd, int cols,
                              int any_hit, void* out_t, void* out_prim, void* out_b1, void* out_b2, void* out_pops,
                              void* counters, void* stream, int motion, const void* time, const void* ptd_end,
                              const void* ptd_mid, const void* anim, const void* anim_gid, const void* anim_c) {
    const BwMotion mo = bw_motion(time, ptd_end, ptd_mid, anim, anim_gid, anim_c);
#define BW_CALL(M)                                                                                                \
    launch_kd<M>(o, d, t_max, n_rays, node_rec, leaf_rec, kd_lo, kd_hi, ptd, cols, any_hit, out_t, out_prim, out_b1, \
                 out_b2, out_pops, counters, stream, mo)
    if (motion == 1) return BW_CALL(1);
    if (motion == 2) return BW_CALL(2);
#undef BW_CALL
    return (int)cudaErrorInvalidValue;
}

// Resident blocks of THREADS threads per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// of the BVH walk's instantiation (count, motion), and of the kd walk's (motion).
extern "C" int bvh_walk_occupancy(int count, int motion, int* blocks_per_sm) {
    const void* kernels[2][3] = {
        {(const void*)bvh_walk_kernel<false, 0>, (const void*)bvh_walk_kernel<false, 1>,
         (const void*)bvh_walk_kernel<false, 2>},
        {(const void*)bvh_walk_kernel<true, 0>, (const void*)bvh_walk_kernel<true, 1>,
         (const void*)bvh_walk_kernel<true, 2>}};
    if (count < 0 || count > 1 || motion < 0 || motion > 2) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernels[count][motion], THREADS, 0);
}

extern "C" int kd_walk_occupancy(int motion, int* blocks_per_sm) {
    const void* kernels[3] = {(const void*)kd_walk_kernel<0>, (const void*)kd_walk_kernel<1>,
                              (const void*)kd_walk_kernel<2>};
    if (motion < 0 || motion > 2) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernels[motion], THREADS, 0);
}
