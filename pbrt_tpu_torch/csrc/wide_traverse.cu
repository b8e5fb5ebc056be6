// Closest-hit / any-hit traversal of the 8-wide BVH, one thread per ray.
//
// Replaces pbrt_tpu/device/pallas_bvh.py _traverse_kernel_impl (the TPU
// kernel launched by pallas_bvh._run). The TPU kernel walks 256-ray packets
// over ONE shared stack, because a TPU core cannot give each lane its own
// stack or its own node loads (ROOFLINE.md section 2). A GPU thread can, so
// here every ray keeps a private stack and visits only the nodes its own
// box tests accept, in the order of its own direction signs.
//
// Bound: dependent global loads. Each pop reads a child meta, then either
// eight 32-byte child boxes or sixteen 64-byte triangle rows, and the next
// pop depends on the result, so the kernel is bound by load latency and
// warp divergence, not by FLOPs. The tables stay in the reference's TPU
// layout (scene/widebvh.py) so the parity tests compare like with like; for
// the 123,650-triangle room they total a few MB and sit in the 50 MB L2.
// Relayout for coalescing and the worth of the coherence sort are later
// work; several rays per thread is the joint kernel (wide_traverse_joint.cu).
//
// The traversal itself (ray setup, pop, box and watertight triangle tests,
// and the reference semantics it keeps) is wide_traverse.cuh's, shared with
// the joint kernel (B2) and the wide megakernel (B4). Built with -fmad=false
// and without fast math (see the header).

#include "wide_traverse.cuh"

__global__ void __launch_bounds__(128)
wide_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, int n_rays,
                     const int* __restrict__ meta_tab,
                     const float* __restrict__ node_tab,
                     const float* __restrict__ prim_tab,
                     int any_hit,
                     float* __restrict__ out_t, int* __restrict__ out_idx,
                     float* __restrict__ out_b1, float* __restrict__ out_b2,
                     int* __restrict__ out_pops, unsigned int* __restrict__ counters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;
    WideRay r;
    int stack[WT_STACK];
    wide_init(r, stack, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2], t_max[i],
              any_hit != 0);
    wide_walk(r, stack, meta_tab, node_tab, prim_tab, counters);
    out_t[i] = r.t_best;
    out_idx[i] = r.best_idx;
    out_b1[i] = r.b1;
    out_b2[i] = r.b2;
    out_pops[i] = r.pops;
}

extern "C" int wide_traverse(const void* o, const void* d, const void* t_max, int n_rays,
                             const void* meta_tab, const void* node_tab, const void* prim_tab,
                             int any_hit, void* out_t, void* out_idx, void* out_b1, void* out_b2,
                             void* out_pops, void* counters, void* stream) {
    if (n_rays > 0) {
        const int threads = 128;
        const int blocks = (n_rays + threads - 1) / threads;
        wide_traverse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)o, (const float*)d, (const float*)t_max, n_rays,
            (const int*)meta_tab, (const float*)node_tab, (const float*)prim_tab, any_hit,
            (float*)out_t, (int*)out_idx, (float*)out_b1, (float*)out_b2, (int*)out_pops,
            (unsigned int*)counters);
    }
    return (int)cudaGetLastError();
}

// Resident blocks of 128 threads per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int wide_traverse_occupancy(int* blocks_per_sm) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, wide_traverse_kernel, 128, 0);
}
