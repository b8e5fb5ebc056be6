"""Global render options threaded through the API (reference src/core/pbrt.rs:36-54).

The port's copy of ``pbrt_tpu/core/options.py``, field for field."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Options:
    n_threads: int = 0
    quick_render: bool = False
    quiet: bool = False
    verbose: bool = False
    cat: bool = False
    to_ply: bool = False
    image_file: str = ""
    crop_window: tuple | None = None  # (x0, x1, y0, y1)
    # knobs of this renderer (no reference equivalent):
    wave_size: int = 1 << 17  # rays per device wave
    seed: int = 0
