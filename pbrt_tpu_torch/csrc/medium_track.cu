// Delta tracking (delta_track) and ratio tracking (ratio_track) through
// grid (heterogeneous) media: each lane loops its own ray to its own end.
//
// Replaces no Pallas kernel. The reference tracks in XLA
// (pbrt_tpu/device/media.py medium_sample :183-223 and medium_tr :248-282):
// a lax.while_loop of at most MAX_TRACKING_STEPS = 256 steps whose condition
// is "any lane not done", every lane stepping until the last one ends and a
// finished lane's state frozen. In eager PyTorch that loop is a host sync and
// some thirty launches per step. A GPU thread can run its own ray's loop, so
// each ray stops at its own end; since the reference freezes a finished
// lane, the per-ray results are the same.
//
// delta_track (grid.rs sample :107-139): key = pcg(key ^ 0x6A09E667), then
// per step two draws u1, u2; t -= log(max(1 - u1, 1e-12)) / majorant; the
// ray leaves at t >= t_end, else collides for real where u2 < density /
// max density. Writes t (the last t stepped to; 0 for a ray that is not in
// a grid medium), found and the steps taken.
// ratio_track (grid.rs tr :141-182): key = pcg(key), one draw per step;
// tr *= max(1 - density / max density, 0) at each step before t_end; stops
// past t_end or once tr < 1e-4. Writes tr (1 outside a grid medium) and the
// steps taken.
// The majorant is max density * (sigma_a + sigma_s) of channel 0, from the
// medium's med_param row. The density is the trilinear lookup of
// media.py _grid_density over the medium's (nz, ny, nx) grid at p * n - 0.5,
// zero outside: p the world point through the medium's world -> grid rows.
// Keys follow device/rng.py (pcg_hash, u32_to_float) bit for bit.
//
// Each grid is read through its corner table (scene/arrays.py
// grid_corners): per voxel of the grid padded by one voxel below, its eight
// corner densities in one 32-byte row, so a step's trilinear lookup is two
// 16-byte loads of one 32-byte sector where the grid itself takes eight
// scattered 4-byte gathers (up to eight sectors); the rows hold the grid's
// floats (0 outside the grid), so the density is the same bits; the twin
// and the reference read the grids themselves (med_grids). Built with
// -fmad=false: every multiply and add rounds on its own, as the plain
// PyTorch twin's (device/medium_track.py) do.
//
// Bound: the per-step work is 2 (delta) or 1 (ratio) hashes, one log, the
// 12-operation transform, the trilinear blend and the voxel's 32-byte row;
// the 64^3 grid's corner table (8.8 MB) stays in the 50 MB L2. chip_smoke.py
// phase 38 counts the steps (the steps output) and prints the bound. What
// the design does about it (tools/medium_track_variants.py measures each
// lever against the others and against the design before it; PERF.md has
// the numbers):
//  - one thread per ray over a grid that covers the rays, each block
//    staging the media rows in shared memory; a ray outside every grid
//    medium writes its outputs without entering the tracking loop (most of
//    a render's launch). Persistent blocks (as many as the card holds
//    resident, each staging the rows once and taking rays in a grid-stride
//    loop) measured 5-7% slower (tools/medium_track_variants.py);
//  - the corner rows (above);
//  - occupancy: __launch_bounds__(MT_THREADS, MT_MIN_BLOCKS), 12 blocks
//    per SM at 38 registers (the cap does not bind there; 8, 10 and 16
//    blocks measured within 0-9% of it);
//  - the launch's own cost: the keys are read as the int64 the wave holds
//    (their low 32 bits, rng._u32's), found is written as a bool, so the
//    wrapper launches nothing beside the kernel.
// A warp runs to its longest ray (steps are geometric: 3.76 per ray, at
// most 22, on phase 38's rays). Persistent lanes that refill from the same
// loop, so that the warp need not wait, measured 4.0x (delta) and 5.9x
// (ratio) slower than persistent lanes running each ray to its end on
// phase 38's rays (NVIDIA H100 80GB HBM3, 700 W;
// tools/medium_track_variants.py): each refill's dependent loads of the
// next ray stall the lanes that are stepping.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MT_THREADS 128
#define MT_MAX_STEPS 256
#define MT_PAR 8
#define MT_W2M 12
#define MT_MIN_BLOCKS 12  // resident blocks per SM the register cap aims at (PERF.md)

__device__ __forceinline__ uint32_t mt_pcg(uint32_t x) {
    const uint32_t state = x * 747796405u + 2891336453u;
    const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
    return (word >> 22u) ^ word;
}

__device__ __forceinline__ float mt_u01(uint32_t k) {
    // rng.u32_to_float: the value times 2^-32, clamped below 1
    return fminf(__uint2float_rn(k) * 2.3283064365386963e-10f, 0.99999994f);
}

struct MtShared {
    const float* w2m;  // (n_media, 12)
    const float* par;  // (n_media, 8)
    const int* dims;   // (n_media, 4): first corner row, nx, ny, nz
};

// media.py _density_at for a ray in grid medium m at p = o + d t: the
// trilinear blend of the voxel's corner row (zeros for a voxel outside the
// padded grid, as each of its corners is outside the grid)
__device__ float mt_density(const MtShared& s, const float4* __restrict__ corners, int m, float px, float py,
                            float pz) {
    const float* w = s.w2m + m * MT_W2M;
    const float gxw = w[0] * px + w[1] * py + w[2] * pz + w[3];
    const float gyw = w[4] * px + w[5] * py + w[6] * pz + w[7];
    const float gzw = w[8] * px + w[9] * py + w[10] * pz + w[11];
    const int* dm = s.dims + m * 4;
    const int nx = dm[1], ny = dm[2], nz = dm[3];
    const float gx = gxw * (float)nx - 0.5f;
    const float gy = gyw * (float)ny - 0.5f;
    const float gz = gzw * (float)nz - 0.5f;
    const float flx = floorf(gx), fly = floorf(gy), flz = floorf(gz);
    const int x0 = (int)flx, y0 = (int)fly, z0 = (int)flz;
    const float fx = gx - (float)x0, fy = gy - (float)y0, fz = gz - (float)z0;
    const float ofx = 1.0f - fx, ofy = 1.0f - fy, ofz = 1.0f - fz;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (x0 >= -1 && x0 < nx && y0 >= -1 && y0 < ny && z0 >= -1 && z0 < nz) {
        const float4* row =
            corners + 2 * ((size_t)dm[0] + ((size_t)(z0 + 1) * (ny + 1) + (y0 + 1)) * (nx + 1) + (x0 + 1));
        a = __ldg(row);
        b = __ldg(row + 1);
    }
    const float d00 = a.x * ofx + a.y * fx;
    const float d10 = a.z * ofx + a.w * fx;
    const float d01 = b.x * ofx + b.y * fx;
    const float d11 = b.z * ofx + b.w * fx;
    const float d0 = d00 * ofy + d10 * fy;
    const float d1 = d01 * ofy + d11 * fy;
    return d0 * ofz + d1 * fz;
}

// stage the medium rows in shared memory; returns the views
__device__ MtShared mt_stage(float* sh, const float* __restrict__ w2m, const float* __restrict__ par,
                             const int* __restrict__ dims, int n_media) {
    float* sw = sh;
    float* sp = sh + n_media * MT_W2M;
    int* sd = (int*)(sp + n_media * MT_PAR);
    for (int i = threadIdx.x; i < n_media * MT_W2M; i += blockDim.x) sw[i] = w2m[i];
    for (int i = threadIdx.x; i < n_media * MT_PAR; i += blockDim.x) sp[i] = par[i];
    for (int i = threadIdx.x; i < n_media * 4; i += blockDim.x) sd[i] = dims[i];
    __syncthreads();
    MtShared s;
    s.w2m = sw;
    s.par = sp;
    s.dims = sd;
    return s;
}

// 1 / majorant and 1 / max(max density, 1e-12) of medium m (media.py)
__device__ __forceinline__ void mt_majorant(const MtShared& s, int m, float* inv_maj, float* dmax) {
    const float* p = s.par + m * MT_PAR;
    const float sig_t0 = fmaxf(p[0] + p[3], 1e-12f);
    const float maj = fmaxf(p[7] * sig_t0, 1e-12f);
    *inv_maj = 1.0f / maj;
    *dmax = fmaxf(p[7], 1e-12f);
}

// One lane's ray between steps.
struct MtRay {
    float ox, oy, oz, dx, dy, dz, te, inv_maj, dmax, t, tr;
    uint32_t k;
    int m, steps;
    bool found;
};

// Ray i's setup in r: the outputs' values for a ray outside every grid
// medium (delta: t 0, not found; ratio: tr 1; 0 steps), and for a ray in a
// grid medium its rows and key. Returns whether it is in one.
template <bool DELTA>
__device__ __forceinline__ bool mt_start(int i, const MtShared& s, int n_media, const float* __restrict__ o,
                                         const float* __restrict__ d, const float* __restrict__ t_end,
                                         const long long* __restrict__ med, const long long* __restrict__ key,
                                         MtRay& r) {
    r.t = 0.0f;
    r.tr = 1.0f;
    r.steps = 0;
    r.found = false;
    const int m = (int)med[i];
    if (m < 0 || m >= n_media || s.dims[m * 4 + 1] <= 0) return false;
    r.m = m;
    mt_majorant(s, m, &r.inv_maj, &r.dmax);
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    r.te = t_end[i];
    r.k = mt_pcg(DELTA ? (uint32_t)key[i] ^ 0x6A09E667u : (uint32_t)key[i]);
    return true;
}

// ray i's outputs
template <bool DELTA>
__device__ __forceinline__ void mt_write(int i, const MtRay& r, float* __restrict__ val_out,
                                         bool* __restrict__ found_out, int* __restrict__ steps_out) {
    val_out[i] = DELTA ? r.t : r.tr;
    if (DELTA) found_out[i] = r.found;
    steps_out[i] = r.steps;
}

// One tracking step of r; returns true when the ray is done. Delta
// (grid.rs sample): two draws, the step, a real collision where u2 <
// density / max density. Ratio (grid.rs tr): one draw, the step, tr *=
// max(1 - density / max density, 0), done once tr < 1e-4. Both end past
// t_end and after MT_MAX_STEPS steps.
template <bool DELTA>
__device__ __forceinline__ bool mt_step(MtRay& r, const MtShared& s, const float4* __restrict__ corners) {
    ++r.steps;
    r.k = mt_pcg(r.k);
    const float u1 = mt_u01(r.k);
    float u2 = 0.0f;
    if (DELTA) {
        r.k = mt_pcg(r.k);
        u2 = mt_u01(r.k);
    }
    const float tn = r.t - logf(fmaxf(1.0f - u1, 1e-12f)) * r.inv_maj;
    r.t = tn;
    if (tn >= r.te) return true;
    const float dens = mt_density(s, corners, r.m, r.ox + r.dx * tn, r.oy + r.dy * tn, r.oz + r.dz * tn);
    if (DELTA) {
        if (u2 < dens / r.dmax) {
            r.found = true;
            return true;
        }
    } else {
        const float factor = 1.0f - dens / r.dmax;
        r.tr = r.tr * fmaxf(factor, 0.0f);
        if (r.tr < 1e-4f) return true;
    }
    return r.steps >= MT_MAX_STEPS;
}

// Both entries: one thread per ray over a grid that covers the rays, each
// ray run to its end. delta writes t (the last t stepped to), found and
// steps; ratio tr and steps.
template <bool DELTA>
__global__ void __launch_bounds__(MT_THREADS, MT_MIN_BLOCKS)
mt_track_kernel(const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_end,
                const long long* __restrict__ med, const long long* __restrict__ key, int n_rays,
                const float4* __restrict__ corners, const int* __restrict__ dims,
                const float* __restrict__ w2m, const float* __restrict__ par, int n_media,
                float* __restrict__ val_out, bool* __restrict__ found_out, int* __restrict__ steps_out) {
    extern __shared__ float sh[];
    const MtShared s = mt_stage(sh, w2m, par, dims, n_media);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;
    MtRay r;
    if (mt_start<DELTA>(i, s, n_media, o, d, t_end, med, key, r)) {
        while (!mt_step<DELTA>(r, s, corners)) {
        }
    }
    mt_write<DELTA>(i, r, val_out, found_out, steps_out);
}

static size_t mt_shared_bytes(int n_media) { return (size_t)n_media * (MT_W2M + MT_PAR + 4) * 4; }

static int mt_launch(bool delta, const float* o, const float* d, const float* t_end, const long long* med,
                     const long long* key, int n_rays, const float* corners, const int* dims, const float* w2m,
                     const float* par, int n_media, float* val_out, bool* found_out,
                     int* steps_out, cudaStream_t stream) {
    if (n_rays <= 0) return 0;
    const size_t shmem = mt_shared_bytes(n_media);
    const int blocks = (n_rays + MT_THREADS - 1) / MT_THREADS;
    if (delta)
        mt_track_kernel<true><<<blocks, MT_THREADS, shmem, stream>>>(o, d, t_end, med, key, n_rays,
                                                                     (const float4*)corners, dims, w2m,
                                                                     par, n_media, val_out, found_out, steps_out);
    else
        mt_track_kernel<false><<<blocks, MT_THREADS, shmem, stream>>>(o, d, t_end, med, key, n_rays,
                                                                      (const float4*)corners, dims, w2m,
                                                                      par, n_media, val_out, found_out, steps_out);
    return (int)cudaGetLastError();
}

// The entries: rays (o, d, t_end, med, key), the grids' corner rows, the
// media's rows (dims: first corner row, nx, ny, nz; world -> grid;
// med_param), the outputs and the stream.
extern "C" int delta_track(const float* o, const float* d, const float* t_end, const long long* med,
                           const long long* key, int n_rays, const float* corners, const int* dims,
                           const float* w2m, const float* par, int n_media, float* t_out, bool* found_out,
                           int* steps_out, cudaStream_t stream) {
    return mt_launch(true, o, d, t_end, med, key, n_rays, corners, dims, w2m, par, n_media, t_out, found_out,
                     steps_out, stream);
}

extern "C" int ratio_track(const float* o, const float* d, const float* t_end, const long long* med,
                           const long long* key, int n_rays, const float* corners, const int* dims,
                           const float* w2m, const float* par, int n_media, float* tr_out, int* steps_out,
                           cudaStream_t stream) {
    return mt_launch(false, o, d, t_end, med, key, n_rays, corners, dims, w2m, par, n_media, tr_out, nullptr,
                     steps_out, stream);
}

extern "C" int medium_track_occupancy(int which, int n_media, int* blocks_per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, which == 0 ? (const void*)mt_track_kernel<true> : (const void*)mt_track_kernel<false>,
        MT_THREADS, mt_shared_bytes(n_media));
}
