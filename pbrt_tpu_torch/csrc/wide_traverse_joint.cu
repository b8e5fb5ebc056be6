// Joint closest-hit / any-hit traversal of the 8-wide BVH: K rays per
// thread, all advanced one pop per iteration of one loop.
//
// Replaces pbrt_tpu/device/pallas_bvh.py _traverse_kernel_joint (the TPU
// kernel that pallas_bvh._run launches with joint=True, opt-in with
// PBRT_TPU_JOINT=1). The TPU kernel interleaves GRID_G = 8 packets' pop
// chains in one straight-line body so that the VLIW scheduler overlaps
// their load latency; per packet its results are the sequential kernel's.
//
// Hopper form of the same question: B1 (wide_traverse.cu) gives each ray a
// thread and relies on occupancy to hide the latency of its dependent node
// loads. Here each thread carries K independent rays (template parameter;
// K = 2 and K = 4 are built), each with its own WideRay state and 72-entry
// stack, and one loop calls wide_pop on every live ray of the thread in
// turn until all K stacks are empty, so the loads of independent rays can
// be in flight together: instruction-level parallelism per thread in place
// of B1's occupancy. Ray i of the launch is ray k = i / n_threads of thread
// i % n_threads, so each k-slice of a warp reads neighbouring rays.
//
// Results: a ray's pop order and arithmetic are wide_pop's alone, so t,
// idx, b1, b2 and pops equal B1's bit for bit (-fmad=false, as B1).
//
// Bound: as B1, dependent-load latency; the K stacks live in local memory
// (K x 288 bytes per thread, L1-cached), and K multiplies the registers a
// thread holds, so occupancy falls as K rises.

#include "wide_traverse.cuh"

template <int K>
__global__ void __launch_bounds__(128)
wide_traverse_joint_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ t_max, int n_rays,
                           const int* __restrict__ meta_tab,
                           const float* __restrict__ node_tab,
                           const float* __restrict__ prim_tab,
                           int any_hit,
                           float* __restrict__ out_t, int* __restrict__ out_idx,
                           float* __restrict__ out_b1, float* __restrict__ out_b2,
                           int* __restrict__ out_pops, unsigned int* __restrict__ counters) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int n_threads = gridDim.x * blockDim.x;
    WideRay r[K];
    int stack[K][WT_STACK];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = tid + k * n_threads;
        if (i < n_rays) {
            wide_init(r[k], stack[k], o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2],
                      t_max[i], any_hit != 0);
        } else {
            r[k].sp = 0;
        }
    }
    bool live = true;
    while (live) {
        live = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (r[k].sp > 0) {
                wide_pop(r[k], stack[k], meta_tab, node_tab, prim_tab, counters);
                live = live || r[k].sp > 0;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = tid + k * n_threads;
        if (i < n_rays) {
            out_t[i] = r[k].t_best;
            out_idx[i] = r[k].best_idx;
            out_b1[i] = r[k].b1;
            out_b2[i] = r[k].b2;
            out_pops[i] = r[k].pops;
        }
    }
}

template <int K>
static void launch(const float* o, const float* d, const float* t_max, int n_rays, const int* meta,
                   const float* node, const float* prim, int any_hit, float* t, int* idx, float* b1, float* b2,
                   int* pops, unsigned int* counters, cudaStream_t stream) {
    const int threads = 128;
    const int per_block = threads * K;
    const int blocks = (n_rays + per_block - 1) / per_block;
    wide_traverse_joint_kernel<K><<<blocks, threads, 0, stream>>>(o, d, t_max, n_rays, meta, node, prim, any_hit,
                                                                  t, idx, b1, b2, pops, counters);
}

// k = rays per thread (2 or 4). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for another k.
extern "C" int wide_traverse_joint(const void* o, const void* d, const void* t_max, int n_rays,
                                   const void* meta_tab, const void* node_tab, const void* prim_tab,
                                   int any_hit, int k, void* out_t, void* out_idx, void* out_b1, void* out_b2,
                                   void* out_pops, void* counters, void* stream) {
    if (k != 2 && k != 4) return (int)cudaErrorInvalidValue;
    if (n_rays > 0) {
        auto fn = k == 2 ? launch<2> : launch<4>;
        fn((const float*)o, (const float*)d, (const float*)t_max, n_rays, (const int*)meta_tab,
           (const float*)node_tab, (const float*)prim_tab, any_hit, (float*)out_t, (int*)out_idx,
           (float*)out_b1, (float*)out_b2, (int*)out_pops, (unsigned int*)counters, (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

// Resident blocks of 128 threads per SM for k rays per thread (2 or 4).
extern "C" int wide_traverse_joint_occupancy(int k, int* blocks_per_sm) {
    if (k != 2 && k != 4) return (int)cudaErrorInvalidValue;
    return (int)(k == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wide_traverse_joint_kernel<2>,
                                                                        128, 0)
                        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wide_traverse_joint_kernel<4>,
                                                                        128, 0));
}
