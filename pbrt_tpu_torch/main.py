"""Command-line entry point, flag-compatible with the reference binary (src/main.rs:12-54).

Usage: python -m pbrt_tpu_torch [options] <scene.pbrt>

The port's counterpart of ``pbrt_tpu/main.py``: lexer -> parser -> API ->
SceneDescription -> compile_scene -> render -> write_image -> the stats
report. It renders on the card ("--device cuda", the default) and raises
when no GPU is present; "--device cpu" runs every kernel's plain PyTorch
twin. "--checkpoint FILE" renders through the per-sample wave, writing the
film's accumulators to FILE every "--checkpoint-every" samples and resuming
from a FILE that matches the render (its spp, film and seed), as the
reference does. "--profile DIR" writes a torch.profiler chrome trace of the
render into DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time


def build_arg_parser():
    p = argparse.ArgumentParser(prog="pbrt_tpu_torch", description="pbrt renderer in PyTorch and CUDA")
    p.add_argument("scene", help=".pbrt scene file")
    p.add_argument("--nthreads", "-t", type=int, default=0, help="accepted for compatibility; ignored")
    p.add_argument("--outfile", "-o", default="", help="output image path (overrides scene Film filename)")
    p.add_argument("--cropwindow", "-w", nargs=4, type=float, default=None, metavar=("X0", "X1", "Y0", "Y1"))
    p.add_argument("--quick", "-q", action="store_true", help="quarter resolution, 1/4 spp")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--cat", action="store_true", help="print the parsed scene directives and exit")
    p.add_argument("--toply", action="store_true", help="print scene with meshes converted to PLY references")
    p.add_argument("--logtostderr", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spp", type=int, default=None, help="override sampler pixel samples")
    p.add_argument("--checkpoint", default="", help="checkpoint file for resumable renders")
    p.add_argument("--checkpoint-every", type=int, default=32, help="samples between checkpoints")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler chrome trace of the render to DIR")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to render on (default: the GPU)")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    level = logging.DEBUG if args.verbose else (logging.ERROR if args.quiet else logging.INFO)
    logging.basicConfig(level=level, format="%(levelname).1s %(name)s: %(message)s")
    log = logging.getLogger("pbrt_tpu_torch")

    from .core.options import Options
    from .parser.api import pbrt_parse

    opts = Options(
        quick_render=args.quick,
        quiet=args.quiet,
        cat=args.cat,
        to_ply=args.toply,
        image_file=args.outfile,
        crop_window=tuple(args.cropwindow) if args.cropwindow else None,
    )

    if args.cat or args.toply:
        # formatted .pbrt re-emission (main.rs --cat/--toply; api.rs printers)
        from .parser.catprint import cat_scene
        from .parser.parser import parse_file

        cat_scene(parse_file(args.scene), to_ply=args.toply)
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pbrt_tpu_torch renders on the GPU by default and none is available; "
                           "pass --device cpu to run the plain PyTorch versions of its kernels")

    t0 = time.perf_counter()
    desc = pbrt_parse(args.scene, opts)
    t_parse = time.perf_counter() - t0
    log.info("scene parsed+built in %.2fs", t_parse)

    from .core.imageio import write_image
    from .render import render_compiled
    from .scene.builder import compile_scene

    t0 = time.perf_counter()
    cs = compile_scene(desc, args.device)
    if args.device == "cuda":
        torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    log.info("scene compiled in %.2fs", t_compile)

    def progress(done, total):
        if not args.quiet:
            sys.stderr.write(f"\r[{done}/{total} spp]")
            sys.stderr.flush()

    prof = None
    prof_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])
        prof_ctx = prof = profile(activities=activities)
    t0 = time.perf_counter()
    with prof_ctx:
        img = render_compiled(cs, seed=args.seed, spp=args.spp, progress=progress,
                              checkpoint_path=args.checkpoint or None, checkpoint_every=args.checkpoint_every)
    t_render = time.perf_counter() - t0
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "render_trace.json")
        prof.export_chrome_trace(trace)
        log.info("profiler trace written to %s", trace)
    if not args.quiet:
        sys.stderr.write("\n")

    out = args.outfile or desc.film.filename
    t0 = time.perf_counter()
    write_image(out, img)
    t_write = time.perf_counter() - t0
    log.info("wrote %s", out)
    # what the run made, for callers that drive main in-process
    main.last_run = {"parse_s": t_parse, "compile_s": t_compile, "render_s": t_render, "write_s": t_write,
                     "outfile": out, "timing": render_compiled.last_timing, "scene": cs, "image": img}
    if not args.quiet:
        # categorized stats dump at end of render (api.rs:1758-1762)
        from .utils.stats import print_stats

        print_stats()
    return 0


main.last_run = None


if __name__ == "__main__":
    sys.exit(main())
