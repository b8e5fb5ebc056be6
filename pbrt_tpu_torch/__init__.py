"""pbrt_tpu_torch: the PyTorch + CUDA port of pbrt_tpu.

The port mirrors the JAX package's module layout and function names
(``pbrt_tpu/...`` -> ``pbrt_tpu_torch/...``) so each counterpart is easy to
find, and it imports neither ``jax`` nor ``pbrt_tpu``: the machines that run
it on a GPU have no JAX.

Its front end is the reference's: ``python -m pbrt_tpu_torch scene.pbrt``
lexes and parses the file (``parser/``), builds a SceneDescription with the
reference's API (every directive, the reference's error-and-degrade
behaviour), compiles it, renders on the card and writes the film
(``core/imageio.py``: EXR, PFM, 8-bit PNG; no PIL). ``--device cpu`` runs
the kernels' plain PyTorch twins; ``--checkpoint`` is not supported yet.

What it renders today, with a hand-written CUDA kernel on each route's
hot path where the reference has a Pallas kernel:

- the persistent wavefront (device/integrator.py) for every scene the
  compiler takes: static triangle meshes, and for scenes of at most 64
  prims full or partial spheres too; point, spot, distant and triangle
  area lights under uniform, power or 'spatial' light selection; matte
  (Lambert or Oren-Nayar), mirror, glass, metal and plastic with constant
  parameters; the (0,2), random, stratified, halton, sobol and maxmindist
  samplers; every pixel filter (box, triangle, gaussian, mitchell, sinc);
  the path and directlighting integrators. Scenes of more than 64 prims
  traverse the 8-wide BVH (``csrc/wide_traverse.cu``); smaller ones test
  every prim;
- the brute megakernel for scenes of at most 16 triangle or full-sphere
  prims with at most 4 point, spot and distant lights
  (``csrc/megakernel.cu``), and the wide megakernel for triangle scenes of
  its class with PBRT_TPU_WIDEMEGA=1 (``csrc/megakernel_wide.cu``); both
  take the (0,2), random and stratified samplers and the box filter.

Later slices added the rest of the reference's kinds: textures, every
material, quadric, light and camera kind, instancing, the kd-tree, alpha
cutouts, media and subsurface scattering, motion blur, and every
integrator (volpath, whitted and ao on the per-sample wave; BDPT, MLT and
SPPM through host loops of their own). What the parser builds and no
route renders, compile_scene refuses by name with NotImplementedError.

Public entry points:
    python -m pbrt_tpu_torch scene.pbrt [--outfile F] [--spp N] [--device cpu] ...
    pbrt_tpu_torch.main.main(argv)                       -> 0
    pbrt_tpu_torch.parser.api.pbrt_parse(path, options)   -> SceneDescription
    pbrt_tpu_torch.scenes.mesh_room(n_side)             -> SceneDescription
    pbrt_tpu_torch.scenes.spheres_gallery()             -> SceneDescription
    pbrt_tpu_torch.scenes.material_room(n_side)         -> SceneDescription
    pbrt_tpu_torch.scenes.area_box()                    -> SceneDescription
    pbrt_tpu_torch.scenes.write_pbrt(desc, path, look_at)  (a .pbrt file + PLY meshes)
    pbrt_tpu_torch.scene.builder.compile_scene(desc, device="cuda")
    pbrt_tpu_torch.render.render(desc, device="cuda")    -> (H, W, 3) image
    pbrt_tpu_torch.core.imageio.write_image(path, image)

Importing the package loads no kernel and touches no GPU; the CUDA kernels
are compiled with nvcc on their first launch.
"""

__version__ = "0.1.0"
