// Delta tracking (delta_track) and ratio tracking (ratio_track) through
// grid (heterogeneous) media: one thread per ray, each looping its own ray
// to its own end.
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
// Each grid is read with __ldg from one flat buffer (per-medium offset and
// shape in dims); the medium rows (world -> grid, med_param) are staged in
// shared memory. Built with -fmad=false: every multiply and add rounds on its
// own, as the plain PyTorch twin's (device/medium_track.py) do.
//
// Bound: the per-step work is 2 (delta) or 1 (ratio) hashes, one log, the
// 12-operation transform, the trilinear blend and 8 gathers of 4 bytes; a
// 64^3 grid (1 MiB) stays in the 50 MB L2. chip_smoke.py phase 38 counts the
// steps (the steps output) and prints the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MT_THREADS 128
#define MT_MAX_STEPS 256
#define MT_PAR 8
#define MT_W2M 12

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
    const int* dims;   // (n_media, 4): offset, nx, ny, nz
};

__device__ __forceinline__ float mt_voxel(const float* __restrict__ grid, int off, int nx, int ny, int nz, int xi,
                                          int yi, int zi) {
    const bool inside = xi >= 0 && xi < nx && yi >= 0 && yi < ny && zi >= 0 && zi < nz;
    return inside ? __ldg(grid + off + (zi * ny + yi) * nx + xi) : 0.0f;
}

// media.py _density_at for a ray in grid medium m at p = o + d t
__device__ float mt_density(const MtShared& s, const float* __restrict__ grid, int m, float px, float py, float pz) {
    const float* w = s.w2m + m * MT_W2M;
    const float gxw = w[0] * px + w[1] * py + w[2] * pz + w[3];
    const float gyw = w[4] * px + w[5] * py + w[6] * pz + w[7];
    const float gzw = w[8] * px + w[9] * py + w[10] * pz + w[11];
    const int off = s.dims[m * 4], nx = s.dims[m * 4 + 1], ny = s.dims[m * 4 + 2], nz = s.dims[m * 4 + 3];
    const float gx = gxw * (float)nx - 0.5f;
    const float gy = gyw * (float)ny - 0.5f;
    const float gz = gzw * (float)nz - 0.5f;
    const float flx = floorf(gx), fly = floorf(gy), flz = floorf(gz);
    const int x0 = (int)flx, y0 = (int)fly, z0 = (int)flz;
    const float fx = gx - (float)x0, fy = gy - (float)y0, fz = gz - (float)z0;
    const float ofx = 1.0f - fx, ofy = 1.0f - fy, ofz = 1.0f - fz;
    const float d00 = mt_voxel(grid, off, nx, ny, nz, x0, y0, z0) * ofx
                      + mt_voxel(grid, off, nx, ny, nz, x0 + 1, y0, z0) * fx;
    const float d10 = mt_voxel(grid, off, nx, ny, nz, x0, y0 + 1, z0) * ofx
                      + mt_voxel(grid, off, nx, ny, nz, x0 + 1, y0 + 1, z0) * fx;
    const float d01 = mt_voxel(grid, off, nx, ny, nz, x0, y0, z0 + 1) * ofx
                      + mt_voxel(grid, off, nx, ny, nz, x0 + 1, y0, z0 + 1) * fx;
    const float d11 = mt_voxel(grid, off, nx, ny, nz, x0, y0 + 1, z0 + 1) * ofx
                      + mt_voxel(grid, off, nx, ny, nz, x0 + 1, y0 + 1, z0 + 1) * fx;
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

__global__ void __launch_bounds__(MT_THREADS) delta_track_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_end,
    const long long* __restrict__ med, const long long* __restrict__ key, int n_rays, const float* __restrict__ grid,
    const int* __restrict__ dims, const float* __restrict__ w2m, const float* __restrict__ par, int n_media,
    float* __restrict__ t_out, int* __restrict__ found_out, int* __restrict__ steps_out) {
    extern __shared__ float sh[];
    const MtShared s = mt_stage(sh, w2m, par, dims, n_media);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;
    const int m = (int)med[i];
    float t = 0.0f;
    int found = 0, steps = 0;
    if (m >= 0 && m < n_media && s.dims[m * 4 + 1] > 0) {
        float inv_maj, dmax;
        mt_majorant(s, m, &inv_maj, &dmax);
        const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
        const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
        const float te = t_end[i];
        uint32_t k = mt_pcg((uint32_t)key[i] ^ 0x6A09E667u);
        while (steps < MT_MAX_STEPS) {
            ++steps;
            k = mt_pcg(k);
            const float u1 = mt_u01(k);
            k = mt_pcg(k);
            const float u2 = mt_u01(k);
            const float tn = t - logf(fmaxf(1.0f - u1, 1e-12f)) * inv_maj;
            t = tn;
            if (tn >= te) break;
            const float dens = mt_density(s, grid, m, ox + dx * tn, oy + dy * tn, oz + dz * tn);
            if (u2 < dens / dmax) {
                found = 1;
                break;
            }
        }
    }
    t_out[i] = t;
    found_out[i] = found;
    steps_out[i] = steps;
}

__global__ void __launch_bounds__(MT_THREADS) ratio_track_kernel(
    const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ t_end,
    const long long* __restrict__ med, const long long* __restrict__ key, int n_rays, const float* __restrict__ grid,
    const int* __restrict__ dims, const float* __restrict__ w2m, const float* __restrict__ par, int n_media,
    float* __restrict__ tr_out, int* __restrict__ steps_out) {
    extern __shared__ float sh[];
    const MtShared s = mt_stage(sh, w2m, par, dims, n_media);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;
    const int m = (int)med[i];
    float tr = 1.0f;
    int steps = 0;
    if (m >= 0 && m < n_media && s.dims[m * 4 + 1] > 0) {
        float inv_maj, dmax;
        mt_majorant(s, m, &inv_maj, &dmax);
        const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
        const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
        const float te = t_end[i];
        uint32_t k = mt_pcg((uint32_t)key[i]);
        float t = 0.0f;
        while (steps < MT_MAX_STEPS) {
            ++steps;
            k = mt_pcg(k);
            const float u = mt_u01(k);
            const float tn = t - logf(fmaxf(1.0f - u, 1e-12f)) * inv_maj;
            t = tn;
            if (tn >= te) break;
            const float dens = mt_density(s, grid, m, ox + dx * tn, oy + dy * tn, oz + dz * tn);
            const float factor = 1.0f - dens / dmax;
            tr = tr * fmaxf(factor, 0.0f);
            if (tr < 1e-4f) break;
        }
    }
    tr_out[i] = tr;
    steps_out[i] = steps;
}

static size_t mt_shared_bytes(int n_media) { return (size_t)n_media * (MT_W2M + MT_PAR + 4) * 4; }

extern "C" int delta_track(const float* o, const float* d, const float* t_end, const long long* med,
                           const long long* key, int n_rays, const float* grid, const int* dims, const float* w2m,
                           const float* par, int n_media, float* t_out, int* found_out, int* steps_out,
                           cudaStream_t stream) {
    if (n_rays <= 0) return 0;
    const int blocks = (n_rays + MT_THREADS - 1) / MT_THREADS;
    delta_track_kernel<<<blocks, MT_THREADS, mt_shared_bytes(n_media), stream>>>(
        o, d, t_end, med, key, n_rays, grid, dims, w2m, par, n_media, t_out, found_out, steps_out);
    return (int)cudaGetLastError();
}

extern "C" int ratio_track(const float* o, const float* d, const float* t_end, const long long* med,
                           const long long* key, int n_rays, const float* grid, const int* dims, const float* w2m,
                           const float* par, int n_media, float* tr_out, int* steps_out, cudaStream_t stream) {
    if (n_rays <= 0) return 0;
    const int blocks = (n_rays + MT_THREADS - 1) / MT_THREADS;
    ratio_track_kernel<<<blocks, MT_THREADS, mt_shared_bytes(n_media), stream>>>(
        o, d, t_end, med, key, n_rays, grid, dims, w2m, par, n_media, tr_out, steps_out);
    return (int)cudaGetLastError();
}

extern "C" int medium_track_occupancy(int which, int n_media, int* blocks_per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, which == 0 ? (const void*)delta_track_kernel : (const void*)ratio_track_kernel, MT_THREADS,
        mt_shared_bytes(n_media));
}
