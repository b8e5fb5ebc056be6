#!/usr/bin/env python3
"""The grid media's tracking kernel (csrc/medium_track.cu) against an
earlier design and against variants of itself, timed on one CUDA GPU.

    python3 tools/medium_track_variants.py [--parent DIR] [--reps 20] [--only NAME ...] [--out FILE.json]

--parent DIR: the root of a checkout of an earlier commit (a `git archive`)
whose csrc/medium_track.cu has the parent design's C interface (one thread
per ray in a grid that covers the rays, the flat grid through eight
gathers, the keys masked and found converted by the wrapper's own
launches, outside these timings): its library is built from DIR and run
as the variant "parent".

Each other variant is the tree's csrc/medium_track.cu with a few lines
replaced (VARIANTS below), one lever of the design undone; it keeps the
tree's C interface. The launch sets, each for delta and ratio tracking,
all on fog_room(248) (its smoke box's 64^3 grid medium in a homogeneous
fog, 1000x500):
 - phase38: chip_smoke.py phase 38's 500,000 rays from the room's eye
   through the smoke box, entry to exit, all in the grid medium;
 - mixed: the same rays with the render's share of grid rays
   (chip_smoke._mixed_track_rays: 2.6% in the grid medium, the rest in the
   fog or in no medium, shuffled), their chains phase 38's short ones;
 - empty: no ray in a grid medium;
 - render: the render's own launches, recorded: every delta_track and
   ratio_track call of a 1 spp render of the room on the card (its inputs
   cloned as the wave passed them), replayed back to back; their grid
   shares, steps per grid ray and longest rays are printed.
Before any timing a variant must return the tree's outputs bit for bit on
every launch; then the two C entries are timed alone (CUDA events over
--reps repeats on inputs prepared once, chip_smoke._track_alone_ms's way)
in turns: the tree, variant, variant, tree; the parent, tree, tree,
parent. The wrapper's host time per call (device/medium_track.py
delta_track_cuda) and its parts are timed on phase 38's rays by the host
clock. The variants, each one lever:
 - persistent: as many blocks as the card holds resident, each staging
   the media rows once and taking rays by a grid stride, each run to its
   end (the tree: one thread per ray over a grid that covers the rays);
 - refill: the same lanes, a lane whose ray has ended taking its next ray
   in the loop where the others step;
 - flat_taps: the eight corner densities gathered from the grids packed
   in one flat buffer (the parent's layout, _flat_grids; the tree: the
   voxel's 32-byte corner row), through pointers that a C entry of the
   variant (mt_variant_grid) sets before the launches;
 - texture_taps: the eight taps through a 3D texture object per grid
   medium (point filtering at each voxel's centre, border addressing: 0
   outside), which a C entry of the variant (mt_variant_texture) makes
   from the grid before the launches;
 - blocks8, blocks10, blocks16, bounds_none: __launch_bounds__(128, 8),
   (128, 10), (128, 16), (128) (the tree: MT_MIN_BLOCKS = 12).
A variant that fails to build or to pass its gate is reported and skipped.
The variants live only here: no route builds them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

SOURCE = "medium_track.cu"


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"variant patch does not apply: {old[:60]!r}")
    return src.replace(old, new)


def _define(name, value):
    return lambda s: re.sub(rf"#define {name} \d+ ", f"#define {name} {value} ", s, count=1)


_BODY = """    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;
    MtRay r;
    if (mt_start<DELTA>(i, s, n_media, o, d, t_end, med, key, r)) {
        while (!mt_step<DELTA>(r, s, corners)) {
        }
    }
    mt_write<DELTA>(i, r, val_out, found_out, steps_out);
"""

# persistent lanes taking rays by a grid stride, each run to its end
_PERSISTENT = """    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rays; i += gridDim.x * blockDim.x) {
        MtRay r;
        if (mt_start<DELTA>(i, s, n_media, o, d, t_end, med, key, r)) {
            while (!mt_step<DELTA>(r, s, corners)) {
            }
        }
        mt_write<DELTA>(i, r, val_out, found_out, steps_out);
    }
"""

# persistent lanes, a lane whose ray has ended taking its next one in the
# loop where the others step
_REFILL = """    const int stride = gridDim.x * blockDim.x;
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    MtRay r;
    bool have = false;
    for (;;) {
        if (!have) {
            for (; i < n_rays && !mt_start<DELTA>(i, s, n_media, o, d, t_end, med, key, r); i += stride)
                mt_write<DELTA>(i, r, val_out, found_out, steps_out);
            if (i >= n_rays) break;
            have = true;
        }
        if (mt_step<DELTA>(r, s, corners)) {
            mt_write<DELTA>(i, r, val_out, found_out, steps_out);
            have = false;
            i += stride;
        }
    }
"""

_GRID = "    const int blocks = (n_rays + MT_THREADS - 1) / MT_THREADS;\n"

# the resident blocks per SM x SMs, at most the blocks the rays fill
_RESIDENT = """    const void* kern = delta ? (const void*)mt_track_kernel<true> : (const void*)mt_track_kernel<false>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, MT_THREADS, shmem);
    if (e != cudaSuccess) return (int)e;
    const long long fill = ((long long)n_rays + MT_THREADS - 1) / MT_THREADS;
    const int blocks = (int)(fill < (long long)per_sm * sms ? fill : (long long)per_sm * sms);
"""


def _persistent(body):
    return lambda s: _replace(_replace(s, _BODY, body), _GRID, _RESIDENT)


_CORNERS = """    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (x0 >= -1 && x0 < nx && y0 >= -1 && y0 < ny && z0 >= -1 && z0 < nz) {
        const float4* row =
            corners + 2 * ((size_t)dm[0] + ((size_t)(z0 + 1) * (ny + 1) + (y0 + 1)) * (nx + 1) + (x0 + 1));
        a = __ldg(row);
        b = __ldg(row + 1);
    }
"""

_FLAT = """    const float* grid = mtv_grid + mtv_off[m];
    auto tap = [&](int xi, int yi, int zi) {
        const bool inside = xi >= 0 && xi < nx && yi >= 0 && yi < ny && zi >= 0 && zi < nz;
        return inside ? __ldg(grid + (zi * ny + yi) * nx + xi) : 0.0f;
    };
    (void)corners;
    const float4 a = make_float4(tap(x0, y0, z0), tap(x0 + 1, y0, z0), tap(x0, y0 + 1, z0), tap(x0 + 1, y0 + 1, z0));
    const float4 b = make_float4(tap(x0, y0, z0 + 1), tap(x0 + 1, y0, z0 + 1), tap(x0, y0 + 1, z0 + 1),
                                 tap(x0 + 1, y0 + 1, z0 + 1));
"""

_FLAT_ENTRY = """
extern "C" int mt_variant_grid(const float* grid, const int* off) {
    cudaError_t e = cudaMemcpyToSymbol(mtv_grid, &grid, sizeof(grid));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(mtv_off, &off, sizeof(off));
    return (int)e;
}
"""


def _flat(s):
    s = _replace(s, "#define MT_THREADS 128\n", "#define MT_THREADS 128\n__constant__ const float* mtv_grid;\n"
                 "__constant__ const int* mtv_off;\n")
    return _replace(s, _CORNERS, _FLAT) + _FLAT_ENTRY


# the taps through a 3D texture object per grid medium: point filtering at
# each voxel's centre, border addressing (0 outside the grid)
_TEXTURE_HEAD = """#define MTV_MAX_MEDIA 16
__constant__ cudaTextureObject_t mtv_tex[MTV_MAX_MEDIA];

__device__ __forceinline__ float mt_tap(cudaTextureObject_t t, int x, int y, int z) {
    return tex3D<float>(t, (float)x + 0.5f, (float)y + 0.5f, (float)z + 0.5f);
}
"""

_TEXTURE = """    const cudaTextureObject_t tex = mtv_tex[m];
    (void)corners;
    const float4 a = make_float4(mt_tap(tex, x0, y0, z0), mt_tap(tex, x0 + 1, y0, z0), mt_tap(tex, x0, y0 + 1, z0),
                                 mt_tap(tex, x0 + 1, y0 + 1, z0));
    const float4 b = make_float4(mt_tap(tex, x0, y0, z0 + 1), mt_tap(tex, x0 + 1, y0, z0 + 1),
                                 mt_tap(tex, x0, y0 + 1, z0 + 1), mt_tap(tex, x0 + 1, y0 + 1, z0 + 1));
"""

# medium m's grid (device float32, (nz, ny, nx)) copied into a 3D array and
# bound to a texture object in mtv_tex[m] (the array and the object live as
# long as the process: a tool's run)
_TEXTURE_ENTRY = """
extern "C" int mt_variant_texture(int m, const float* grid, int nx, int ny, int nz) {
    if (m < 0 || m >= MTV_MAX_MEDIA) return (int)cudaErrorInvalidValue;
    cudaChannelFormatDesc ch = cudaCreateChannelDesc<float>();
    cudaArray_t arr = nullptr;
    cudaError_t e = cudaMalloc3DArray(&arr, &ch, make_cudaExtent(nx, ny, nz));
    if (e != cudaSuccess) return (int)e;
    cudaMemcpy3DParms cp = {};
    cp.srcPtr = make_cudaPitchedPtr((void*)grid, nx * sizeof(float), nx, ny);
    cp.dstArray = arr;
    cp.extent = make_cudaExtent(nx, ny, nz);
    cp.kind = cudaMemcpyDeviceToDevice;
    e = cudaMemcpy3D(&cp);
    if (e != cudaSuccess) return (int)e;
    cudaResourceDesc res = {};
    res.resType = cudaResourceTypeArray;
    res.res.array.array = arr;
    cudaTextureDesc td = {};
    td.addressMode[0] = td.addressMode[1] = td.addressMode[2] = cudaAddressModeBorder;
    td.filterMode = cudaFilterModePoint;
    td.readMode = cudaReadModeElementType;
    td.normalizedCoords = 0;
    cudaTextureObject_t obj = 0;
    e = cudaCreateTextureObject(&obj, &res, &td, nullptr);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyToSymbol(mtv_tex, &obj, sizeof(obj), m * sizeof(obj));
}
"""


def _texture(s):
    s = _replace(s, "#define MT_THREADS 128\n", "#define MT_THREADS 128\n" + _TEXTURE_HEAD)
    return _replace(s, _CORNERS, _TEXTURE) + _TEXTURE_ENTRY


# name -> patch(text of csrc/medium_track.cu) -> text
VARIANTS = {
    "persistent": _persistent(_PERSISTENT),
    "refill": _persistent(_REFILL),
    "flat_taps": _flat,
    "texture_taps": _texture,
    "blocks8": _define("MT_MIN_BLOCKS", 8),
    "blocks10": _define("MT_MIN_BLOCKS", 10),
    "blocks16": _define("MT_MIN_BLOCKS", 16),
    "bounds_none": lambda s: _replace(s, "void __launch_bounds__(MT_THREADS, MT_MIN_BLOCKS)",
                                      "void __launch_bounds__(MT_THREADS)"),
}

# the parent design's C interface: o, d, t_end, med, key, n_rays, grid,
# dims, w2m, par, n_media, outputs..., stream
_PARENT_IN = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]


def _flat_grids(sa):
    """The grid media packed the parent's way: (every grid's densities in one
    flat float32 buffer, (n_media, 4) int32 rows of its offset there, nx,
    ny, nz), on the scene's device."""
    import torch

    dims = sa.med_grid_dims.clone()
    parts, off = [], 0
    for i in range(dims.shape[0]):
        grid = sa.med_grids.get(f"med{i}")
        if grid is not None:
            dims[i, 0] = off
            parts.append(grid.reshape(-1))
            off += grid.numel()
    return torch.cat(parts).contiguous(), dims.contiguous()


class _Track:
    """One library's two entries, launched alone on inputs prepared once."""

    def __init__(self, name, info, parent=False):
        from pbrt_tpu_torch.device import medium_track

        self.name, self.info, self.parent = name, info, parent
        lib = info["lib"]
        base = _PARENT_IN if parent else medium_track._IN_ARGS
        lib.delta_track.argtypes = base + [ctypes.c_void_p] * 4
        lib.ratio_track.argtypes = base + [ctypes.c_void_p] * 3
        lib.delta_track.restype = lib.ratio_track.restype = ctypes.c_int
        if hasattr(lib, "mt_variant_grid"):
            lib.mt_variant_grid.argtypes, lib.mt_variant_grid.restype = [ctypes.c_void_p] * 2, ctypes.c_int
        if hasattr(lib, "mt_variant_texture"):
            lib.mt_variant_texture.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.mt_variant_texture.restype = ctypes.c_int
        self.grid_of = self.flat = None

    def launcher(self, entry, sa, rays):
        """(a function launching entry on rays, the outputs it writes)."""
        import torch

        from pbrt_tpu_torch.device import medium_track

        R, ins, tables, n_media = medium_track._inputs(sa, *rays)
        dev = ins[0].device
        if self.grid_of is not sa:
            # the flat grids and their offsets, kept alive while the library reads them
            self.flat = (*_flat_grids(sa), None)
            self.flat = (self.flat[0], self.flat[1], self.flat[1][:, 0].contiguous())
            self.grid_of = sa
            if hasattr(self.info["lib"], "mt_variant_grid") and \
                    self.info["lib"].mt_variant_grid(self.flat[0].data_ptr(), self.flat[2].data_ptr()) != 0:
                raise RuntimeError("mt_variant_grid failed")
            if hasattr(self.info["lib"], "mt_variant_texture"):
                for i in range(sa.med_grid_dims.shape[0]):
                    grid = sa.med_grids.get(f"med{i}")
                    if grid is not None and self.info["lib"].mt_variant_texture(
                            i, grid.contiguous().data_ptr(), grid.shape[2], grid.shape[1], grid.shape[0]) != 0:
                        raise RuntimeError("mt_variant_texture failed")
        if self.parent:
            tables = (self.flat[0], self.flat[1], *tables[2:])
        outs = [torch.empty(R, dtype=torch.float32, device=dev)]
        if entry == "delta_track":  # found: the parent's int32, the tree's bool
            outs.append(torch.empty(R, dtype=torch.int32 if self.parent else torch.bool, device=dev))
        outs.append(torch.empty(R, dtype=torch.int32, device=dev))
        fn = getattr(self.info["lib"], entry)
        args = [*(x.data_ptr() for x in ins), R, *(x.data_ptr() for x in tables), n_media,
                *(x.data_ptr() for x in outs), torch.cuda.current_stream(dev).cuda_stream]

        def launch():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"{self.name} {entry} launch failed: cudaError {err}")

        return launch, outs


def _render_launches(cs, seed=0):
    """{entry: [(med, o, d, t_end, key), ...]}: the inputs of every
    delta_track and ratio_track call of a 1 spp render of cs, cloned (the
    wave calls them through device/media.py's names)."""
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import media

    rec = {"delta_track": [], "ratio_track": []}
    saved = {n: getattr(media, n) for n in rec}

    def recording(name):
        def wrapped(sa, static, med, *a):
            rec[name].append([x.clone() for x in (med, *a)])
            return saved[name](sa, static, med, *a)
        return wrapped

    try:
        for n in rec:
            setattr(media, n, recording(n))
        R_.render_compiled(cs, seed=seed, spp=1)
    finally:
        for n, fn in saved.items():
            setattr(media, n, fn)
    return rec


def _wrapper_host_ms(sa, rays, n=200) -> dict:
    """Host milliseconds per call of delta_track_cuda and of its parts on
    rays, by the host clock over n calls without a sync among them."""
    import time

    import torch

    from pbrt_tpu_torch.device import medium_track

    R = rays[1].shape[0]
    dev = rays[1].device
    _R, ins, tables, n_media = medium_track._inputs(sa, *rays)
    outs = [torch.empty(R, dtype=torch.float32, device=dev), torch.empty(R, dtype=torch.bool, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev)]
    lib = medium_track.build_kernel()["lib"]
    args = [*(x.data_ptr() for x in ins), R, *(x.data_ptr() for x in tables), n_media,
            *(x.data_ptr() for x in outs)]
    parts = {
        "wrapper": lambda: medium_track.delta_track_cuda(sa, *rays),
        "build_kernel": medium_track.build_kernel,
        "inputs": lambda: medium_track._inputs(sa, *rays),
        "three_empty": lambda: [torch.empty(R, dtype=t, device=dev) for t in (torch.float32, torch.bool, torch.int32)],
        "stream": lambda: medium_track._stream(dev),
        "c_entry": lambda: lib.delta_track(*args, torch.cuda.current_stream(dev).cuda_stream),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = 1e3 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
    return out


def _ptxas(info) -> list[dict]:
    import ptxas_report

    return [{k: r[k] for k in ("template", "registers", "spill_stores", "spill_loads", "stack_frame")}
            for r in ptxas_report.parse(info["log"])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of a checkout with the parent design's csrc/medium_track.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS), help="variants to run (default: all)")
    ap.add_argument("--out", help="also write the record as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("medium_track_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import medium_track, nvcc
    from pbrt_tpu_torch.scene.builder import compile_scene

    names = list(args.only if args.only is not None else VARIANTS)
    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._smi(), "reps": args.reps,
           "variants": {}}
    print(f"medium_track_variants: {rec['device']}; nvidia-smi: {rec['nvidia_smi']}", flush=True)
    sources = {}
    for n in names:
        out = nvcc.BUILD_DIR / "variants" / f"medium_track_{n}"
        out.mkdir(parents=True, exist_ok=True)
        (out / SOURCE).write_text(VARIANTS[n]((nvcc.CSRC / SOURCE).read_text()))
        sources[n] = out / SOURCE
    if args.parent:
        sources["parent"] = Path(args.parent).resolve() / "pbrt_tpu_torch" / "csrc" / SOURCE
    try:
        nvcc.build_all([medium_track.KERNEL_SOURCE, *sources.values()])
    except RuntimeError as e:
        print(f"[build] {str(e)[-3000:]}", flush=True)
    tree_info = nvcc.build(medium_track.KERNEL_SOURCE)
    occ = [nvcc.occupancy(tree_info["lib"].medium_track_occupancy, w, 2) for w in (0, 1)]
    rec["tree"] = {"ptxas": _ptxas(tree_info), "blocks_per_sm": occ}
    print(f"[tree] ptxas {rec['tree']['ptxas']}; blocks per SM (delta, ratio) {occ}", flush=True)
    fog = compile_scene(scenes.fog_room(), "cpu").to("cuda")
    sa = fog.arrays
    rays = chip_smoke._track_rays(fog, chip_smoke.TRACK_RAYS)
    rec["wrapper_host_ms"] = _wrapper_host_ms(sa, rays)
    print(f"[wrapper] host ms per call on phase 38's rays: {rec['wrapper_host_ms']}", flush=True)
    render = _render_launches(fog)
    entries = ("delta_track", "ratio_track")
    # launch set -> entry -> the launches' rays
    launches = {"phase38": {e: [rays] for e in entries},
                "mixed": {e: [chip_smoke._mixed_track_rays(fog, rays)] for e in entries},
                "empty": {e: [[torch.full_like(rays[0], -1), *rays[1:]]] for e in entries},
                "render": render}
    grid_ids = torch.as_tensor([i for i, k in enumerate(fog.static.media_kinds) if k == "heterogeneous"],
                               device=rays[0].device)
    tree = _Track("tree", tree_info)
    want = {}
    for lname, by_entry in launches.items():
        for entry, rs in by_entry.items():
            want[lname, entry] = []
            for r in rs:
                launch, outs = tree.launcher(entry, sa, r)
                launch()
                torch.cuda.synchronize()
                want[lname, entry].append([x.clone() for x in outs])
    shares = {}
    for entry, rs in render.items():
        in_grid = [torch.isin(r[0].long(), grid_ids) for r in rs]
        steps = [w[-1] for w in want["render", entry]]
        n_grid = [int(g.sum()) for g in in_grid]
        shares[entry] = {"launches": len(rs), "rays_per_launch": statistics.mean(int(r[0].numel()) for r in rs),
                         "share_mean": statistics.mean(g / max(int(r[0].numel()), 1) for g, r in zip(n_grid, rs)),
                         "share_max": max(g / max(int(r[0].numel()), 1) for g, r in zip(n_grid, rs)),
                         "steps_per_grid_ray": sum(float(s_.double().sum()) for s_ in steps) / max(sum(n_grid), 1),
                         "longest_ray_steps_mean": statistics.mean(int(s_.max()) for s_ in steps),
                         "longest_ray_steps_max": max(int(s_.max()) for s_ in steps)}
        print(f"[render] {entry}: {json.dumps(shares[entry])}", flush=True)
    rec["render_launches"] = shares
    for name in names + (["parent"] if args.parent else []):
        parent = name == "parent"
        try:
            info = nvcc.build(sources[name])
            var = _Track(name, info, parent)
            entry_rec = {"ptxas": _ptxas(info), "rows": []}
            print(f"[{name}] ptxas {entry_rec['ptxas']}", flush=True)
            for lname, by_entry in launches.items():
                for entry, rs in by_entry.items():
                    l_t, l_v = [], []
                    for r, w in zip(rs, want[lname, entry]):
                        l_t.append(tree.launcher(entry, sa, r)[0])
                        fn_v, outs_v = var.launcher(entry, sa, r)
                        l_v.append(fn_v)
                        fn_v()
                        torch.cuda.synchronize()
                        same = [torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.is_floating_point()
                                else torch.equal(a.to(torch.int32), b.to(torch.int32)) for a, b in zip(w, outs_v)]
                        if not all(same):
                            raise AssertionError(f"{name} differs from the tree on {lname} {entry}: {same}")
                    run_t, run_v = (lambda fs=l_t: [f() for f in fs]), (lambda fs=l_v: [f() for f in fs])
                    order = (run_v, run_t, run_t, run_v) if parent else (run_t, run_v, run_v, run_t)
                    turns = [chip_smoke._cuda_ms(fn, args.reps) for fn in order]
                    inner, outer = statistics.mean(turns[1:3]), statistics.mean([turns[0], turns[3]])
                    ms_t, ms_v = (inner, outer) if parent else (outer, inner)
                    steps = torch.cat([w[-1] for w in want[lname, entry]])
                    row = {"launch": lname, "entry": entry, "launches": len(rs), "rays": int(steps.numel()),
                           "steps_per_ray": float(steps.double().mean()), "steps_max": int(steps.max()),
                           "turns_ms": turns, "tree_ms": ms_t, "variant_ms": ms_v, "ratio": ms_v / ms_t}
                    entry_rec["rows"].append(row)
                    print(f"  {lname} {entry} ({len(rs)} launches): tree {ms_t:.4f} ms, {name} {ms_v:.4f} ms "
                          f"({ms_v / ms_t:.3f}x); "
                          f"turns {['%.4f' % t for t in turns]}; steps per ray {row['steps_per_ray']:.2f}",
                          flush=True)
            rec["variants"][name] = entry_rec
        except (RuntimeError, AssertionError) as e:
            print(f"[{name}] failed: {str(e)[-2000:]}", flush=True)
            rec["variants"][name] = {"error": str(e)[-2000:]}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"ok": True, "nvidia_smi": rec["nvidia_smi"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
