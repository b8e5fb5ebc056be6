"""pbrt_tpu_torch: the PyTorch + CUDA port of pbrt_tpu.

The port mirrors the JAX package's module layout and function names
(``pbrt_tpu/...`` -> ``pbrt_tpu_torch/...``) so each counterpart is easy to
find, and it imports neither ``jax`` nor ``pbrt_tpu``: the machines that run
it on a GPU have no JAX.

What it renders today are two slices of the reference, each with a
hand-written CUDA kernel:

- the persistent path tracer over triangle meshes of more than 64 prims with
  matte (constant Kd) materials and diffuse area lights, traversing the
  8-wide BVH (``csrc/wide_traverse.cu``);
- the brute megakernel for scenes of at most 16 triangle or full-sphere
  prims with point, spot and distant lights and constant-parameter matte,
  mirror, glass, metal and plastic materials, path or directlighting
  (``csrc/megakernel.cu``).

Every other feature raises NotImplementedError at scene compile time or
when the render route is built.

Public entry points:
    pbrt_tpu_torch.scenes.mesh_room(n_side)             -> SceneDescription
    pbrt_tpu_torch.scenes.spheres_gallery()             -> SceneDescription
    pbrt_tpu_torch.scene.builder.compile_scene(desc, device="cuda")
    pbrt_tpu_torch.render.render(desc, device="cuda")    -> (H, W, 3) image

Importing the package loads no kernel and touches no GPU; the CUDA kernels
are compiled with nvcc on their first launch.
"""

__version__ = "0.1.0"
