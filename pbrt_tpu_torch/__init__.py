"""pbrt_tpu_torch: the PyTorch + CUDA port of pbrt_tpu.

The port mirrors the JAX package's module layout and function names
(``pbrt_tpu/...`` -> ``pbrt_tpu_torch/...``) so each counterpart is easy to
find, and it imports neither ``jax`` nor ``pbrt_tpu``: the machines that run
it on a GPU have no JAX.

What it renders today, with a hand-written CUDA kernel on each route's
hot path where the reference has a Pallas kernel:

- the persistent wavefront (device/integrator.py) for every scene the
  compiler takes: static triangle meshes, and for scenes of at most 64
  prims full or partial spheres too; point, spot, distant and triangle
  area lights under uniform, power or 'spatial' light selection; matte
  (Lambert or Oren-Nayar), mirror, glass, metal and plastic with constant
  parameters; the (0,2), random and stratified samplers; the path and
  directlighting integrators. Scenes of more than 64 prims traverse the
  8-wide BVH (``csrc/wide_traverse.cu``); smaller ones test every prim;
- the brute megakernel for scenes of at most 16 triangle or full-sphere
  prims with at most 4 point, spot and distant lights
  (``csrc/megakernel.cu``), and the wide megakernel for triangle scenes of
  its class with PBRT_TPU_WIDEMEGA=1 (``csrc/megakernel_wide.cu``).

Every other feature raises NotImplementedError at scene compile time.

Public entry points:
    pbrt_tpu_torch.scenes.mesh_room(n_side)             -> SceneDescription
    pbrt_tpu_torch.scenes.spheres_gallery()             -> SceneDescription
    pbrt_tpu_torch.scenes.material_room(n_side)         -> SceneDescription
    pbrt_tpu_torch.scenes.area_box()                    -> SceneDescription
    pbrt_tpu_torch.scene.builder.compile_scene(desc, device="cuda")
    pbrt_tpu_torch.render.render(desc, device="cuda")    -> (H, W, 3) image

Importing the package loads no kernel and touches no GPU; the CUDA kernels
are compiled with nvcc on their first launch.
"""

__version__ = "0.1.0"
