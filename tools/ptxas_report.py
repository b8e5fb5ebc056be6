#!/usr/bin/env python3
"""ptxas's report of every instantiation of one of pbrt_tpu_torch's kernels,
on a machine with nvcc.

    python3 tools/ptxas_report.py [--root DIR] [--kernel megakernel_wide|megakernel|bvh_walk|wide_bvh]

Builds the kernel of the pbrt_tpu_torch package under --root (default: this
checkout; give a `git archive` of another commit to compare the two) with
its own flags and prints one JSON line per entry function: its name, its
template arguments as integers (B4: SAMPLER, ANY_AREA, EXT, PROF; B3: its
own; the BVH walk: COUNT), registers, spill stores and loads, stack frame and static shared
bytes, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

_ENTRY = re.compile(r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads\s*\n[^\n]*Used (\d+) registers[^\n]*?(?:(\d+) bytes smem)?\n")


def parse(log: str) -> list[dict]:
    """The entry functions of an nvcc -Xptxas -v log (functions whose
    properties are followed by a register count), in the log's order."""
    rows = []
    for m in _ENTRY.finditer(log):
        name = m[1]
        targs = re.search(r"I((?:L[ib]-?\d+E)+)E", name)
        rows.append({"function": name,
                     "template": [int(x) for x in re.findall(r"L[ib](-?\d+)E", targs[1])] if targs else [],
                     "registers": int(m[5]), "spill_stores": int(m[3]), "spill_loads": int(m[4]),
                     "stack_frame": int(m[2]), "smem": int(m[6] or 0)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--kernel", default="megakernel_wide", choices=("megakernel_wide", "megakernel", "bvh_walk",
                                                                     "wide_bvh"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    mod = importlib.import_module(f"pbrt_tpu_torch.device.{args.kernel}")
    info = mod.build_kernel()
    rows = parse(info["log"])
    if not rows:
        raise SystemExit(f"no entry function in the build log of {args.kernel}:\n{info['log'][-2000:]}")
    for row in rows:
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi: none")
    return 0


if __name__ == "__main__":
    sys.exit(main())
