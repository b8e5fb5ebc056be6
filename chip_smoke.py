#!/usr/bin/env python3
"""Smoke test of pbrt_tpu_torch on one CUDA GPU: the quickest proof that the
port builds and runs its main path on the card.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (one line each; any failure raises and the exit code is non-zero):
 1. device: requires CUDA (no CPU fallback), prints the card's name and
    power limit;
 2. build: nvcc-compiles every kernel source (csrc/wide_traverse.cu,
    wide_traverse_joint.cu, megakernel.cu, megakernel_wide.cu,
    bvh_walk.cu, medium_track.cu), one nvcc each, all started together,
    while HOST_WORKERS spawned processes compile the large rooms of the
    later phases on the host (the mesh, quadric, sss, fog, motion, sphere
    and zoo rooms at n_side 248; LARGE_ROOMS) and render the CPU images of
    phases 51 (SMALL_HOST_LOOPS) and 52; prints build seconds, the ptxas
    register/spill/shared-memory report of each and every variant's
    resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    B3's __launch_bounds__ choice, and the walk kernels' report per entry
    (registers, spills, stack frame, blocks per SM): the static
    instantiations (MOTION 0) beside the motion ones (MOTION 1 keyframes, 2
    the exact animated transform); the workers then go on to render the
    CPU crops of phases 5, 18, 35, 41 and 47 (CPU_CROP_TASKS) while the
    card runs the phases before them;
 3. B1 kernel vs plain: compiles the 123,650-triangle mesh room on the host,
    then traces 500,000 camera rays, one cosine bounce from their hits and
    shadow rays to the panel light through the CUDA kernel and through its
    plain PyTorch twin, closest and any hit, on the same Hopper records.
    Requires t, prim/slot, b1, b2 and pops equal on every ray (FMA-free IEEE
    arithmetic and the same pop order on both sides) and the stack-overflow
    and iteration-cap counters 0. Prints per ray set the kernel's time
    (CUDA events), ns per pop, the share of its lanes holding a ray (pops /
    32 x its warps' loop iterations) and, from the same pops, the share one
    lane per ray in a fixed grid would have (the earlier B1's); times the
    plain twin on camera rays;
 4. mesh main path: render_compiled of the room at 1000x500, 16 spp, depth 5
    on cuda after a warm-up pass; checks the route label, traversal-kernel
    launches > 0 in that run, and a finite, non-black image; prints
    path_vertex_samples_per_sec (sum of path vertices / render wall time);
 5. same mesh image on both devices: a 64x32 crop at 4 spp on cuda (kernel)
    and on cpu (plain versions; rendered by phase 2's workers, as the cpu
    crops of phases 18, 35, 41 and 47 are) with one seed must agree:
    sum|a-b| / sum|b| < 1e-3 and >= 99% of pixels within rtol 1e-2 (atol
    1e-4);
 6. B3 kernel vs plain: the brute megakernel and its plain twin on the
    spheres gallery (8 prims, 3 delta lights) at 1000x500, 2 spp, with the
    reference megakernel's image tolerance (tests/test_megakernel.py):
    weights allclose, total path vertices within 4, per-pixel
    |dL| / (|L| + 1e-2) < 2e-2 and mean |dL| < 1e-4 (sin/cos/log and
    operation order may move a rare path by ulps); times both at the main
    path's 16 spp, the kernel with CUDA events, the plain twin by the host
    clock around one call ending in a synchronize; the 16 spp launch must
    match that plain run under the same tolerances and trace the per-lane
    kernel's 8,474,737 path vertices with no pixel cut by the iteration cap;
    computes the kernel's float32 bound twice: by earlier PRs' per-vertex
    formula (one closest and one shadow test per vertex; the JSON's
    bound_ms), and from the tests the 16 spp paths made (every closest ray
    over every prim, every shadow ray up to its first hit, as the kernel's
    instrumented instantiation counts them, which must trace the same paths
    bit for bit), one regeneration per sample and the shading of every
    vertex (bound_ms_from_tests); prints B3's registers, spills, shared
    bytes and blocks per SM;
 7. gallery main path: render_compiled of the spheres gallery at 1000x500,
    16 spp, depth 5 on cuda after a warm-up pass; checks the route label
    torch-megakernel/cuda-brute, one megakernel launch in that run, and a
    finite, non-black image; prints path_vertex_samples_per_sec;
 8. same gallery image on both devices: a 64x32 crop at 4 spp, held as in
    phase 5;
 9. B2 against B1: the six ray sets of phase 3 through the cooperative
    traversal kernel (4 lanes per ray); t, prim/slot, b1, b2 and pops must
    equal B1's, and so phase 3's plain results, on every ray (the largest
    |dt|, |db| against plain is B2's max_abs_err). Times B1 and B2 with CUDA
    events and prints the share of B2's lane groups holding a ray;
10. mesh main path with PBRT_TPU_JOINT=1: route torch-wavefront/cuda-wide-
    joint, joint launches > 0 and B1 launches 0 in that run, and the image
    of phase 4 (sum|a-b| / sum|b| < 1e-6; prints whether it is bit-equal);
11. B4 kernel vs plain: the wide megakernel and its plain twin on
    material_room (3,854 triangles) at 1000x500, 2 spp, with the reference
    wide megakernel's tolerance (tests/test_megakernel_wide.py): weights
    allclose, total path vertices within 6, per-pixel |dL| / (|L| + 1e-2) <
    2e-2 and mean |dL| < 1e-4; times the kernel at 16 spp with CUDA events
    and the twin by the host clock; computes the bound from the run's pops
    and path vertices; the stack-overflow and iteration-cap counters must
    stay 0, and the 16 spp render must trace the per-lane kernel's 29,659,505 path
    vertices;
12. material_room main path with PBRT_TPU_WIDEMEGA=1 at 1000x500, 16 spp,
    depth 5: route torch-megakernel/cuda-wide, one B4 launch, a finite,
    non-black image; prints path_vertex_samples_per_sec and the kernel's
    share of the render wall;
13. same material_room crop on both devices, held as in phase 5;
14. the mesh room through B4 (PBRT_TPU_WIDEMEGA=1,
    PBRT_TPU_WIDEMEGA_MAX_TRIS=200000) at 1000x500, 16 spp, beside phase 4's
    wavefront; the B4 kernel on the route's blob timed with CUDA events as
    in phase 11, beside the render wall, and the per-lane kernel's 31,724,525 path
    vertices required; then the 64x32,
    4 spp crop through B4 and through the wavefront, both on the card,
    held to the wide tolerance of phase 11;
15. material_room through the wavefront (no route switch set) at
    1000x500, 16 spp, depth 5: route torch-wavefront/cuda-wide, B1
    launches > 0, a finite, non-black image; its
    path_vertex_samples_per_sec beside phase 12's B4, and its 16 spp
    path-vertex total within 0.01% of B4's 29,659,505; the 64x32, 4 spp
    crop through B4 and through the wavefront on the card, held to the wide
    tolerance of phase 11; the crop on cuda and cpu, held as in phase 5;
16. the spheres gallery through the brute wavefront
    (PBRT_TPU_NO_MEGAKERNEL=1): route torch-wavefront/cuda-brute, no
    brute megakernel launch, the 16 spp total within 0.01% of 8,474,737;
    the crop through B3 and through the brute wavefront, held to phase 6's
    tolerance; the crop on cuda and cpu;
17. area_box (15 prims: area and point lights, every lobe kind of the five
    materials, a partial sphere, 'spatial' selection) through the brute
    wavefront: route torch-wavefront/cuda-brute, path_vertex_samples_per_sec,
    the peak device memory of the render; the crop on cuda and cpu;
18. the mesh room under pbrt's default 'spatial' light distribution: the
    distribution's build time on the card, the render through
    torch-wavefront/cuda-wide, the crop on cuda and cpu;
19. the crop on cuda and cpu of material_room under directlighting's
    "all" strategy, and of area_box with a declared 4x4 stratified sampler
    (16 spp);
20. the front end: mesh_room(248) written as a .pbrt file (scenes.write_pbrt:
    LookAt camera, film, Sampler "02sequence" 16, path depth 5, the
    materials and the panel's two-sided area light, each mesh a binary PLY
    with float64 positions) and run in-process through main.main on cuda
    with an .exr outfile: route torch-wavefront/cuda-wide, B1 launches > 0,
    the compiled tables equal to phase 3's bit for bit, the 16 spp total
    equal to phase 4's 31,724,522, the image phase 4's (sum|a-b|/sum|b| <
    1e-6), the EXR read back equal to the image at half precision; prints
    the seconds of parse + API, compile_scene, the render wall and the write,
    path_vertex_samples_per_sec and the files' bytes. Then python -m
    pbrt_tpu_torch with --cropwindow on the same file, as a subprocess that
    runs beside phase 21's crops: it must exit 0 and write its file;
21. pbrt's defaults: material_room written with no Sampler directive
    (halton, 16 spp) and PixelFilter "gaussian", rendered through main.main
    on cuda at 1000x500, depth 5: route torch-wavefront/cuda-wide, B1
    launches > 0; prints its path vertices, path_vertex_samples_per_sec and
    the seconds to build the halton and the sobol tables at 1000x500; then
    the crop on cuda and cpu, held as in phase 5, of halton + gaussian,
    sobol + mitchell, maxmindist + triangle and halton + sinc;
22. B4's instantiations of this slice against its twin at 1000x500, 2 spp,
    under phase 11's tolerance: sky_meshes (3,232 triangles: halton +
    gaussian, the attribute rows of smooth UV-mapped spheres, a constant
    infinite light and a distant sun), material_room under halton +
    gaussian, sobol + triangle and maxmindist + box; then each at 16 spp
    with the
    stack-overflow and iteration-cap counters at 0, timed with CUDA events
    beside phase 11's (0,2) + box time, with its bound (the attribute rows'
    and the sampler table's bytes counted) and its ptxas registers, spills,
    shared bytes and blocks per SM; they ride the B4 row of the kernel
    report as "instantiations";
23. pbrt's defaults through B4: phase 21's halton + gaussian material_room
    file through main.main with PBRT_TPU_WIDEMEGA=1: route
    torch-megakernel/cuda-wide, exactly one B4 launch, the 16 spp
    path-vertex total of phase 21's wavefront within 0.01% of B4's,
    path_vertex_samples_per_sec beside phase 21's, and the 64x32 crop
    through B4 and through the wavefront on the card under phase 11's
    tolerance;
24. sky_meshes through B4 (one launch) and through the wavefront (B1
    launches > 0), the totals within 0.01%, the crop through both under
    phase 11's tolerance and, on each route, on cuda and cpu; then an
    image-mapped sky (a 64x128 latitude-longitude map the phase writes, on
    sky_meshes written as a file) through main.main on the wavefront:
    route torch-wavefront/cuda-wide, B1 launches > 0, the crop on cuda and
    cpu;
25. textured_room (material_room's 3,854 triangles with UV charts, a
    1024x1024 RGB imagemap under EWA on the floor, a 512x512 trilinear one
    on a wall, a checkerboard, a scale of marble, a mix by fbm and a brick
    bump map; halton + gaussian) through the wavefront at 1000x500, 8 spp
    (LATE_MAIN_SPP), depth 5: route
    torch-wavefront/cuda-wide, B1 launches > 0; prints the wall,
    path_vertex_samples_per_sec, the path vertices and the device kernels
    per wavefront iteration (torch.profiler over the crop's render at 1
    spp); the crop at 2 spp on cuda and cpu, held as in phase 5; then the scene
    written as a file (Texture directives, PFM images) through main.main
    at 8 spp: the tables equal to the hand-built scene's bit for bit, the
    same path vertices and an image bit-equal to the first render's;
26. B3's textured instantiation: textured_gallery (spheres_gallery with
    128x128 grayscale imagemap Kds on the ground and a backdrop quad, the
    mip atlas in device memory) against its twin at 1000x500, 2 spp under
    phase 6's tolerance; the 16 spp launch timed with CUDA events beside
    phase 6's gallery time, with its bound (the atlas and texture table
    counted in the bytes, the taps of the camera rays' textured hits in the
    operations), no pixel cut by the iteration cap, its ptxas report and
    blocks per SM; the render through the route (one B3 launch) and through
    the brute wavefront (PBRT_TPU_NO_MEGAKERNEL=1) at 8 spp, their mean
    brightness within 0.93-1.07 of each other (the reference's band for a
    ray-cone filter against EWA, tests/test_megakernel.py:189-205);
27. B4's checkerboard Kd: material_room(checker=True) (the floor matte, a
    uv checkerboard of two constant cells) against its twin at 1000x500,
    2 spp under phase 11's tolerance; the 16 spp launch timed beside phase
    11's, with its bound, counters at 0, ptxas report; the render through
    B4 (one launch) and through the wavefront at 16 spp: totals within
    0.01%, the crop through both under phase 11's tolerance;
28. spheres in wide scenes through the wavefront: sphere_room (material_room's
    3,854 triangles beside seven full spheres, a sphere lamp among them, and
    a glossy uber wall) at 1000x500, 16 spp, depth 5: route
    torch-wavefront/cuda-wide-mixed, B1 launches > 0; prints the wall,
    path_vertex_samples_per_sec, path vertices and the device kernels per
    wavefront iteration beside the mesh room's; the mixed query (B1 over
    the triangle subset's tables, the spheres tested beside it) against its
    twin (the plain walk, the same sphere merge) on the render's 500,000
    camera, bounce and shadow rays, closest and any hit, bit for bit, with
    the query's time; the crop on cuda and cpu, held as in phase 5. Then the
    same at n_side 248: the spheres among 123,662 triangles, the full-size
    main path;
29. B4's sphere instantiation (ext 2) on sphere_room: against its twin at
    2 spp under phase 11's tolerance; the 16 spp launch timed with CUDA
    events beside phase 11's, the counters at 0, its bound (every closest
    ray's sphere tests added to the operations), ptxas report and blocks per
    SM; the render through B4 (one launch), its path-vertex total within
    0.01% of phase 28's wavefront;
30. the uber material: B3 on the gallery with its plastic sphere a glossy
    uber one against its twin under phase 6's tolerance; the gallery with
    a full uber sphere (Kr, Kt, opacity 0.7) refused by B3 by lobe set
    (route torch-wavefront/cuda-brute); uber_room (sphere_room's uber rows
    full) refused by B4 by lobe set under PBRT_TPU_WIDEMEGA=1, and its crop
    through the wavefront on cuda and cpu; area_box with its copper sphere a
    sphere lamp through the brute wavefront, its crop on cuda and cpu;
31. the remaining surface materials through the wavefront: zoo_room
    (material_room's meshes with an anisotropic substrate floor, a disney
    wall, a wall mixing plastic and copper, a rough-conductor fourier box,
    a translucent quad and 32 hair curves: 7,952 triangles) at 1000x500,
    8 spp (LATE_MAIN_SPP), depth 5: route
    torch-wavefront/cuda-wide, B1 launches > 0;
    prints the wall, path_vertex_samples_per_sec, path vertices, the
    device kernels per wavefront iteration and the share of camera rays
    ending on each material kind; B1 against its twin bit for bit on the
    render's 500,000 camera, bounce and shadow rays; the crops of zoo_room
    and zoo_room(textured=True) on cuda and cpu, held as in phase 5 with
    the mix's two sub-rows made one (its per-hit choice hashes the hit
    point's float bits, which differ by ulps between the devices), and as
    built held as estimates (means within 1%);
32. zoo_room at n_side 248 (127,760 triangles), the full-size main path of
    this class: the same numbers, B1 against its twin;
33. zoo_room written as a file (scenes.write_pbrt: MakeNamedMaterial for
    the mix's sub-materials, the Fourier table copied beside it) through
    main.main: the same tables and a 4 spp crop bit-equal to the
    hand-built scene's; B4's and B3's named refusals of zoo_room, and B4's
    refusal by lobe set of substrate, disney, fourier and hair rows; B4 on
    material_room with its back wall translucent without transmission
    (baked as plastic) against its twin at 2 spp under phase 11's
    tolerance, its 16 spp launch timed, and the wavefront's 16 spp path
    total within 0.01% of it;
34. bvh_walk (csrc/bvh_walk.cu: the BVH walk and the kd walk) against its
    plain twins (device/bvh_walk.py walk_plain, kd_walk_plain) on
    quadric_room(248) (the mesh room's enclosure with 30 quadrics of the
    six kinds, 64 instances of a 1,984-triangle prop, an alpha-cut panel,
    goniometric and projection lights: 251,168 prims) and on its kd
    variant (n_side 40, no instances): the camera, bounce and shadow rays of
    the main path, closest and any hit, compared on every eighth ray: hits
    and prims equal (a prim may differ only on a tie in t), t bit-equal,
    the counters 0; prints the kernel's time on each whole set
    (CUDA events) and per ray, pops per ray (the BVH walk's: boxes
    tested), node visits per ray and the share of lanes holding a ray
    (visits over 32 x each warp's most), its ptxas report and blocks
    per SM per entry, the plain twin's time on the camera rays, and its
    bound from the instrumented entry's counts (boxes tested, triangle,
    quadric and instanced tests, the bvh_packed rows read); the kd walk's
    bound on its camera rays by the same formula from its twin's counts,
    a split plane (KD_OPS_NODE) per interior visit in place of a box test,
    the twin's time on them, the tree's depth against the kd walk's stack
    (KD_STACK); the ptxas reports of every BVH and kd instantiation;
35. quadric_room(248) through the wavefront at 1000x500, 8 spp
    (LATE_MAIN_SPP), depth 5
    (route torch-wavefront/cuda-bvh, walk launches > 0), then its kd
    variant (torch-wavefront/cuda-kdtree): wall,
    path_vertex_samples_per_sec, device kernels per iteration (the
    profiler over a 1 spp crop), the walk's launches; the 64x32 crop at
    1 spp on cuda and cpu (the cpu crop rendered by phase 2's workers)
    held as in phase 5 with the cones', paraboloids'
    and hyperboloids' hits taken out (_without_raw_quadrics: the reference
    does not re-project their hit points, so the devices' ulps part a few
    paths there), and the kd variant's as built by phase 5's second clause
    (99% of the pixels within rtol 1e-2);
36. camera_room (material_room(checker=True)) under the orthographic and,
    with the alpha panel, the environment camera through B1 at 1000x500,
    8 spp (LATE_MAIN_SPP): route torch-wavefront/cuda-wide, B1 launches > 0, the 1 spp
    crops on cuda and cpu; then B3's and B4's named refusals of the orthographic and
    environment cameras and of quadric_room (goniometric lights first)
    and its kd variant;
37. quadric_room(8) (a 112-triangle prop instanced 64 times), asking for
    the kd-tree and under the orthographic camera, written as a file
    (scenes.write_pbrt: the five quadric Shapes, ObjectBegin and
    ObjectInstance, "texture alpha", the goniometric and projection lights
    with PFM maps, Accelerator "kdtree", Camera "orthographic") through
    main.main on cuda (route torch-wavefront/cuda-bvh: its instances keep
    the BVH) with the tables and the 4 spp crop bit-equal to the hand-built
    scene's, and through python -m pbrt_tpu_torch as a subprocess;
38. medium_track (csrc/medium_track.cu: delta and ratio tracking through
    grid media) against its twin on 500,000 rays from fog_room(248)'s
    camera through its smoke box (64^3 densities), entry to exit: steps
    and collisions equal on every ray, t and the transmittance within rel
    1e-5 and bit for bit on every ray; the time through the wrapper by
    CUDA events (the `ms` of the kernels report, as every row's) and the
    wrapper's host time per call, and the kernel alone (its C entry on
    inputs prepared once) on those rays, on a mixed launch of them with
    the render's share of grid rays (MIXED_GRID_SHARE in the grid medium,
    the rest in the homogeneous fog or in none, shuffled: every output
    bit-equal to the twin's, the rays outside the grid unstepped) and on
    an empty launch (no ray in a grid medium), the twin's time by the host
    clock, the ptxas report of both instantiations, and the bound from the
    steps counted (MT_OPS_DELTA, MT_OPS_RATIO per step) and the bytes of
    the rays, the outputs and the grids' own densities once;
39. fog_room(248) (volpath: the mesh room in a homogeneous fog that is the
    camera's medium, an interface box of grid smoke, a spot light) at
    1000x500, 8 spp (LATE_MAIN_SPP), depth 5 on cuda after a warm-up on the
    crop: route torch-wave/wide, B1 and medium_track launches > 0 in that run, a
    finite, non-black image; path_vertex_samples_per_sec and the device
    kernels per wave bounce (the profiler over a 1 spp crop);
40. sss_room(248) (a "Skin1" subsurface and a kdsubsurface sphere, path)
    the same way (the tabulated BSSRDF); then a crop of sss_room(40) under
    PBRT_TPU_NO_TABSSS=1 (the random walk through the interiors as media);
41. crops of both rooms, of the mesh room under whitted and of sky_meshes
    under ao (the mesh room is closed: every ao ray there is occluded) on
    cuda and cpu, held as in phase 5;
42. fog_room(8) (the 64^3 grid) written as a file, rendered by python -m
    pbrt_tpu_torch --checkpoint as a subprocess that is killed after its
    first checkpoint (2 of 4 samples) and run again to resume: the resumed
    image bit-equal to the uninterrupted render's;
43. the motion walk (csrc/bvh_walk.cu, MOTION 2) against its twin on the
    500,000 camera rays of motion_room(248) (a spinning UV sphere, a
    translating box and a moving sphere quadric in the mesh room under a
    dollying camera), each at its shutter fraction from the sampler's
    dimension 8117 (render.TIME_DIM), as the wave draws them: t, prim,
    b1, b2 and pops bit-equal on every ray (on a quadric hit b1, b2 are its
    object-space x, y: the twin sums the sphere's |p|^2 in the kernel's
    order), and so the static walk's against its twin on the same rays;
    the kernel's time by CUDA events and per ray, node visits per ray and
    the share of lanes holding a ray,
    the twin's by the host clock, the bound from the instrumented entry's
    counts with the motion evaluation of every candidate in the operations;
    then the kd walk's motion entry on the kd variants of motion_room(40)
    (KD_MOTION_ROOM_ARGS: MOTION 2, and MOTION 1 on the keyframe room, both
    compiled by phase 2's workers) on their 500,000 camera rays at their
    shutter fractions: t, prim, b1, b2 and pops bit-equal to the twin on
    every ray, the counters 0; its time, the twin's, and the bound from
    the twin's counts (_kd_bound_of, the motion evaluation per candidate);
44. motion_room(248) at 1000x500, 16 spp, depth 5 on cuda after a warm-up
    on the crop: route torch-wave/bvh, motion-walk launches > 0, a finite,
    non-black image; path_vertex_samples_per_sec and the device kernels per
    wave bounce; then the kd motion room (MOTION 2) at 1000x500, 1 spp:
    route torch-wave/kdtree, kd motion-walk launches > 0;
45. the mesh room under the realistic camera (scenes.write_lens's double
    Gauss, phase 3's compiled tables with the camera swapped) at 1000x500,
    16 spp: route torch-wave/wide, B1 launches > 0;
46. BDPT on the mesh room (phase 3's tables) at 1000x500, depth 5, BDPT_SPP
    spp: route torch-bdpt/wide, B1 launches > 0; path_vertex_samples_per_sec
    (the subpaths' surface vertices over the wall), seconds per spp and the
    ratio of its mean to phase 4's path image (a reading beside the
    reference's 0.90-1.10 mesh-agreement band, not a gate);
47. crops of phases 44-46 on cuda and cpu with one seed (the cpu crops
    rendered by phase 2's workers), held as in phase
    5 (before the crop, the realistic camera's rays of the crop on both
    devices: the rays whose origin, direction or weight differ in any bit);
    a crop of motion_room(16, rotate=False) (the keyframe tables); and
    python -m pbrt_tpu_torch as a subprocess on written motion_room(8) and
    BDPT mesh-room files;
48. MLT on the mesh room (phase 3's tables) at 1000x500, depth 5, 1
    mutation per pixel, 4,096 chains, 100,000 bootstrap samples (16,666
    per depth; 20 mutations per depth in one block): route torch-mlt/wide,
    B1 launches > 0, a finite, non-black image; the device kernels of one
    chain step at depth 1 and at the deepest depth (one torch.profiler
    session), seconds per chain step, the
    acceptance rate, and the image mean against phase 46's BDPT image (a
    reading beside the reference's mesh-agreement readings, not a gate);
49. SPPM on the mesh room at 1000x500, depth 5, 4 iterations of 500,000
    photons (8 slices of 62,500), radius 0.024: route torch-sppm/wide, B1
    launches > 0; seconds per iteration split into the camera pass, the
    grid, the photon trace and the deposit; the longest cell run and the
    photon-visible point pairs the 1,024-entry cap dropped; device kernels
    per iteration (torch.profiler over a render of one iteration);
50. the mesh-agreement check of tools/fidelity.py _run_mesh_agreement on
    the mesh room at 200x100, depth 4: path at 16 spp, BDPT at 8 spp, SPPM
    of 16 iterations of 2^17 photons at radius 0.12; bdpt/path and
    sppm/path beside the reference's 1.0468 and 1.0454 (FIDELITY.json),
    each within the reference's 0.90-1.10 band; each render's wall and B1
    launches;
51. MLT (depth 2, 64 chains, 4 mutations per pixel, 2,048 bootstrap
    samples) and SPPM (depth 3, 4 iterations of 8,192 photons, radius
    0.375) of mesh_room(8) at 64x32 on cuda and on cpu (the cpu images
    rendered by phase 2's workers) with one seed, held as in phase 5 (the MLT runs' accept decisions compared step by step; the
    cuda renders' walls and B1 launches); and
    python -m pbrt_tpu_torch on written mlt and sppm files of
    mesh_room(8) at 200x100, two subprocesses started before phase 50 and
    waited for here (killed if a phase fails);
52. one image over a list of devices (pbrt_tpu_torch/parallel/shard.py),
    as two shards on the one card, each in its own thread and stream: (a)
    render_sharded_step on the mesh room (phase 3's tables) at 1000x500,
    16 spp, depth 5 over [cuda:0, cuda:0] and over [cuda:0], the images
    within the reference's mesh-invariance tolerance
    (tests/test_shard_parity.py: rtol 2e-4, atol 2e-5; whether they are
    bit-equal printed), the same path vertices, B1 launches > 0 in each
    run, both walls and path_vertex_samples_per_sec, and sum|a-b|/sum|b|
    against phase 4's image (a reading); (b) BDPT (4 spp), MLT (depth 2,
    4,096 chains, render_compiled's n_mut at 1 mutation per pixel) and
    SPPM (1 iteration of 500,000 photons, radius 0.024) on the mesh room
    over two shards and one: BDPT and MLT within the reference's
    tolerances, SPPM's lit pixels' mean ratio within 0.1 (its seeds ride
    the shard index); (c) the two-shard path of mesh_room(8) at 64x32,
    4 spp on [cuda:0, cuda:0] and on ["cpu", "cpu"] (rendered by phase 2's
    workers), held as in phase 5; (d) render_compiled given the devices
    [cuda:0, cuda:0] at 2 spp: route torch-shard2/wide, B1
    launches > 0, and the image of (a)'s two-shard step at 2 spp (its
    warm-up pass) within sum|a-b|/sum|b| < 1e-6 (bit-equality printed);
    each sub-phase's seconds.
Phases 15-21, 24's image-mapped sky, 25, 28, 30, 31, 32 and 36 are the
wavefront's array code around B1 (the brute wavefront launches no kernel
of the port): they add no row to the kernel report; phase 29's sphere
instantiation and phase 33's translucent wall ride B4's row; phases 34-35
fill bvh_walk's and kd_walk's rows (their launches: the two renders of
phase 35); phases 38-39 medium_track's (its launches: the fog room's
render); phases 43-44 the rows of the motion entries, bvh_walk_motion's
(its launches: the motion room's render) and kd_walk_motion's (the kd
motion room's render);
phases 48-49 add their B1 launches to wide_traverse's row
(launches_by_route), and so does phase 52 (its two-shard runs').
Each main path runs with every launch count set to 0 just
before it and read just after; every switch a phase sets is restored after
it. The second-to-last lines are the kernel report as JSON and the card's
nvidia-smi name and power limit; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

SEED = 0
CROP_BOUNDS = (468, 532, 234, 266)  # 64 x 32 pixels around the film centre
CROP_SPP = 4
COMPARE_SPP = 2  # B3 kernel vs plain
# path vertices of the 16 spp renders with SEED, as the earlier per-lane B4
# (one thread per pixel) traced them; the persistent B4 must trace the same paths
MATERIAL_ROOM_VERTICES = 29_659_505
MESH_ROOM_VERTICES = 31_724_525
# ... and as the wavefront traces the mesh room (phase 4)
MESH_ROOM_WAVEFRONT_VERTICES = 31_724_522
# ... and of the spheres gallery, as the per-lane B3 traced them
GALLERY_VERTICES = 8_474_737
# the wavefront traces the megakernels' paths within this share of their totals
WAVEFRONT_VERTEX_RTOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per unit of work, counted from the kernels' sources as
# a lower bound (one IEEE divide or square root counted as one operation):
B1_OPS_PER_POP = 8 * 20  # a pop tests at least 8 child boxes (~20 ops each)
B3_OPS_TRI, B3_OPS_SPH = 45, 65  # one watertight triangle / full-sphere test
B3_OPS_SHADE = 300  # BSDF sample + evaluation + NEE terms per path vertex
B3_OPS_REGEN = 60  # one camera regeneration: film sample, raster -> camera -> world, two normalisations
B3_OPS_TEX = 60  # one atlas lookup: the cone's level (log2), 2 levels x 4 taps weighted and summed
# phases 28-33 count kernels per iteration on a crop at LATE_SPP[0] and hold
# crops at LATE_SPP[1] samples per pixel, to keep the script's command time
# near its earlier length as phases are added
LATE_SPP = (1, 2)
# the main paths of phases 25-26, 31-32, 35-36 and 39-40 render at this spp,
# half the scenes' 16, to hold the script under 1,000 s beside the wave's
# phases 38-47 (phase 25 also profiles and checks its crop at LATE_SPP)
LATE_MAIN_SPP = 8
# phase 46's BDPT render of the mesh room (the scene's 16 spp)
BDPT_SPP = 16
# phase 26: the brute megakernel's image against the brute wavefront's (EWA),
# by mean brightness (tests/test_megakernel.py:189-205)
RAY_CONE_BAND = (0.93, 1.07)


# the large rooms' host compiles, made by worker processes while nvcc builds
# the kernels (phase 2) and taken by the phases that render them
# (_host_scene): name -> a future of (CompiledScene on the CPU, seconds)
_HOST: dict = {}
# phase 43's kd motion rooms (rotate -> scenes.motion_room's arguments):
# motion_room(40) (rotate: the spinning sphere, the exact animated
# transform; else the keyframe tables) under Accelerator "kdtree", a size
# the port's recursive kd build compiles in seconds (5,839 prims)
KD_MOTION_ROOM_ARGS = {rotate: (40, rotate, 32, "kdtree") for rotate in (True, False)}
# (name, scenes function, its arguments) of the rooms compiled during the build
LARGE_ROOMS = (("mesh_room", "mesh_room", (248,)), ("quadric_room", "quadric_room", (248,)),
               ("sss_room", "sss_room", (248,)), ("fog_room", "fog_room", (248,)),
               ("motion_room", "motion_room", (248,)), ("sphere_room", "sphere_room", (248,)),
               ("motion_room_kd", "motion_room", KD_MOTION_ROOM_ARGS[True]),
               ("motion_room_kd_keyframes", "motion_room", KD_MOTION_ROOM_ARGS[False]),
               ("zoo_room", "zoo_room", (248,)))
HOST_WORKERS = 4  # worker processes for LARGE_ROOMS' host compiles


def _compile_room(fn: str, args: tuple):
    """A worker's task: (compile_scene(scenes.fn(*args), "cpu"), seconds);
    zoo_room writes its rough conductor's table into a folder that lives
    for the compile only (the tables hold it; nothing reads the file
    later)."""
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.scene.builder import compile_scene

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tables_") as tables:
        kw = {"table_dir": tables} if fn == "zoo_room" else {}
        return compile_scene(getattr(scenes, fn)(*args, **kw), "cpu"), time.perf_counter() - t0


def _host_scene(name):
    """(the CPU-compiled scene `name` of LARGE_ROOMS, its host compile
    seconds in its worker): the worker's result, or compiled now."""
    if name not in _HOST:
        _n, fn, args = next(r for r in LARGE_ROOMS if r[0] == name)
        return _compile_room(fn, args)
    return _HOST[name].result()


# phase 51's CPU renders, made by the same workers during the build
# (_cpu_render), and phase 52 (c)'s ("shard", _cpu_shard_render): kind -> a
# future of (image, accept decisions or None, seconds)
_CPU_RENDERS: dict = {}
# phase 51's small scenes: mesh_room(8) at 64x32 under these integrator settings
SMALL_HOST_LOOPS = {"mlt": dict(max_depth=2, n_chains=64, mutations_per_pixel=4, n_bootstrap=2048),
                    "sppm": dict(max_depth=3, num_iterations=4, photons_per_iteration=8192, initial_radius=0.375)}


def _small_host_loop_desc(kind: str):
    """Phase 51's scene: mesh_room(8) at 64x32 under SMALL_HOST_LOOPS[kind]."""
    from pbrt_tpu_torch import scenes

    d = scenes.mesh_room(8)
    return dataclasses.replace(d, film=dataclasses.replace(d.film, x_resolution=64, y_resolution=32),
                               integrator=dataclasses.replace(d.integrator, kind=kind, **SMALL_HOST_LOOPS[kind]))


def _render_small(kind: str, device: str):
    """Phase 51's render of kind on device (MLT through render_mlt, keeping
    its accept decisions): (image, accept decisions (steps, chains) or
    None, seconds)."""
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import mlt
    from pbrt_tpu_torch.scene.builder import compile_scene

    cs = compile_scene(_small_host_loop_desc(kind), "cpu").to(device)
    t0 = time.perf_counter()
    if kind == "mlt":
        trace = []
        img = mlt.render_mlt(cs, seed=SEED, trace=trace)
        return img, torch.stack(trace).cpu().numpy(), time.perf_counter() - t0
    return R_.render_compiled(cs, seed=SEED), None, time.perf_counter() - t0


def _cpu_render(kind: str):
    """A worker's task (two PyTorch threads, beside the build): phase 51's
    CPU render of kind."""
    import torch

    torch.set_num_threads(2)
    return _render_small(kind, "cpu")


# the CPU crops of phases 5, 18, 35, 41 and 47, rendered by the same workers
# after their phase 2 tasks, while the card runs the phases before them
# (_cpu_crops): task ->
# a future of {crop label: (image, route label)}
_CPU_CROPS: dict = {}
_POOL: list = []  # the worker pool of phase 2, shut down at the end of main


def _build_beside_host_compiles(sources):
    """Phase 2: nvcc.build_all(sources) while HOST_WORKERS spawned processes
    compile LARGE_ROOMS on the host and make the CPU renders of phases 51
    and 52; waits for both and returns the build's result. The workers also
    render the CPU crops of phases 5, 18, 35, 41 and 47 (CPU_CROP_TASKS),
    which those phases
    take: a task on a room of LARGE_ROOMS is handed that room's compiled
    scene once phase 2 has it (so each room is compiled once), the others
    compile their own small scenes; the pool is shut down at the end of
    main."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from pbrt_tpu_torch.device import nvcc

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    _POOL.append(pool)
    for name, fn, args in LARGE_ROOMS:
        _HOST[name] = pool.submit(_compile_room, fn, args)
    for kind in SMALL_HOST_LOOPS:
        _CPU_RENDERS[kind] = pool.submit(_cpu_render, kind)
    _CPU_RENDERS["shard"] = pool.submit(_cpu_shard_render)
    large = {(fn, args): name for name, fn, args in LARGE_ROOMS}
    for task, (fn, args, _crops) in CPU_CROP_TASKS.items():
        if (fn, args) not in large:
            _CPU_CROPS[task] = pool.submit(_cpu_crops, task)
    libs = nvcc.build_all(sources)
    build_s = time.perf_counter() - t0
    done = {name: f.result() for name, f in _HOST.items()}
    for task, (fn, args, _crops) in CPU_CROP_TASKS.items():
        if (fn, args) in large:
            _CPU_CROPS[task] = pool.submit(_cpu_crops, task, done[large[(fn, args)]][0])
    rendered = {kind: f.result()[2] for kind, f in _CPU_RENDERS.items()}
    print(f"[2 build] the kernels built in {build_s:.1f}s; beside them {HOST_WORKERS} worker processes compiled "
          + ", ".join(f"{n} ({s_:.1f}s)" for n, (_c, s_) in done.items())
          + " on the host and rendered the CPU images of phases 51 and 52 ("
          + ", ".join(f"{k} {s_:.1f}s" for k, s_ in rendered.items())
          + f"), all done at {time.perf_counter() - t0:.1f}s; the CPU crops of phases 5, 18, 35, 41 and 47 "
          "follow there",
          flush=True)
    return libs


def _crop_image(cs, desc, spp):
    """(the crop CROP_BOUNDS of desc at spp samples per pixel rendered from
    cs's tables, its route label)."""
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.scene.builder import CompiledScene

    desc_c = dataclasses.replace(desc, integrator=dataclasses.replace(desc.integrator, pixel_bounds=CROP_BOUNDS),
                                 sampler=dataclasses.replace(desc.sampler, pixel_samples=spp))
    x0, x1, y0, y1 = CROP_BOUNDS
    img = R_.render_compiled(CompiledScene(cs.arrays, cs.static, desc_c), seed=SEED)[y0:y1, x0:x1]
    return img, R_.render_compiled.last_timing["tier"]


# the worker-rendered CPU crops by task: (scenes function, its
# arguments, {crop label: spp}); the labels name the scene variant each
# phase holds its cuda crop against; a task whose (function, arguments)
# are a room of LARGE_ROOMS renders from that room's host compile
CPU_CROP_TASKS = {
    "mesh_room_early": ("mesh_room", (248,), {"built": CROP_SPP, "spatial": CROP_SPP}),
    "quadric_room": ("quadric_room", (248,), {"no_raw": LATE_SPP[0], "built": LATE_SPP[0]}),
    "quadric_room_kd": ("quadric_room", (40, False, "kdtree"), {"no_raw": LATE_SPP[0], "built": LATE_SPP[0]}),
    "motion_room": ("motion_room", (248,), {"built": LATE_SPP[0]}),
    "motion_room_keyed": ("motion_room", (16, False), {"built": LATE_SPP[1]}),
    "mesh_room": ("mesh_room", (248,), {"realistic": LATE_SPP[0], "bdpt": LATE_SPP[0], "whitted": LATE_SPP[1]}),
    "fog_room": ("fog_room", (248,), {"built": LATE_SPP[0]}),
    "sss_room": ("sss_room", (248,), {"built": LATE_SPP[0]}),
    "sky_meshes": ("sky_meshes", (), {"ao": LATE_SPP[1]}),
}


def _crop_variant(cs, label, work):
    """A crop label's scene: cs as built (phases 5, 35, 41, 47), without
    the raw quadrics' hits (phase 35), under the realistic camera (its lens
    written to the directory work) or under BDPT (phase 47), under the
    'spatial' light distribution (phase 18), or under whitted or ao (phase
    41)."""
    from pbrt_tpu_torch import scenes

    if label == "no_raw":
        return _without_raw_quadrics(cs)
    desc = cs.description
    if label == "realistic":
        scenes.write_lens(str(Path(work) / scenes.LENS_FILE))
        desc = dataclasses.replace(desc, camera=scenes.realistic_mesh_room(1, lens_dir=str(work)).camera)
    elif label in ("bdpt", "whitted", "ao"):
        desc = dataclasses.replace(desc, integrator=dataclasses.replace(desc.integrator, kind=label))
    elif label == "spatial":
        desc = dataclasses.replace(desc, integrator=dataclasses.replace(desc.integrator, light_strategy="spatial"))
    return _with_desc(cs, desc)


def _cpu_crops(task: str, host=None) -> dict:
    """A worker's task (two PyTorch threads, at a lower scheduling priority
    than the script's own process and nvcc): render the task's CPU crops
    from host, its scene compiled on the host (compiled here when None):
    {label: (image, route label)}."""
    import torch

    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.scene.builder import compile_scene

    os.nice(10)  # this worker's process only: the crops fill the cores the card's phases leave idle
    torch.set_num_threads(2)
    fn, args, crops = CPU_CROP_TASKS[task]
    if host is None:
        host = compile_scene(getattr(scenes, fn)(*args), "cpu")
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_crops_")
    try:
        for label, spp in crops.items():
            c = _crop_variant(host, label, work)
            out[label] = _crop_image(c, c.description, spp)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the peak float32 rate."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _b3_against_plain(label, kernel_out, plain_out) -> float:
    """Phases 6 and 16: B3's (L, w, nv) against its plain twin's (or the
    brute wavefront's) for the same lanes,
    under the reference megakernel's tolerances (weights allclose, path
    vertices within 4, max |dL| / (|L| + 1e-2) < 2e-2, mean |dL| < 1e-4,
    a non-black image); prints the comparison and returns max |dL|."""
    import torch

    (L_k, w_k, nv_k), (L_p, w_p, nv_p) = kernel_out, plain_out
    diff = (L_k - L_p).abs()
    rel = diff / (L_p.abs() + 1e-2)
    nv_k, nv_p = nv_k.double().sum().item(), nv_p.double().sum().item()
    print(f"{label}: weights equal {torch.equal(w_k, w_p)}, vertices {nv_k:.0f} vs {nv_p:.0f}, max |dL|/(|L|+1e-2) "
          f"{rel.max().item():.3e}, mean |dL| {diff.mean().item():.3e}, max |dL| {diff.max().item():.3e}, "
          f"image mean {L_p.mean().item():.5f}", flush=True)
    if not (torch.allclose(w_k, w_p) and abs(nv_k - nv_p) <= 4 and rel.max().item() < 2e-2
            and diff.mean().item() < 1e-4 and L_p.mean().item() > 0):
        raise AssertionError(f"{label}: the two renders disagree")
    return diff.max().item()


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _check_crop(label, cs_gpu, cs_cpu, desc, spp=CROP_SPP, estimate=False, cpu=None):
    """Phases 5, 8, 13, 15-19, 21 and 25-33: the same crop rendered on cuda
    and on cpu (desc: the scene description both render). Under a filter
    with negative lobes (mitchell, sinc), whose samples carry signed
    weights, a pixel's weight sum can be near 0 or negative at a few
    samples and the film divides by it, as the reference's does; the image
    is then required to be non-black in magnitude, not in its mean.
    estimate: a scene whose paths may part on the two devices (a mix's
    per-hit choice hashes the hit point's float bits, which differ by ulps
    between the card's and the CPU's arithmetic) is held as an estimate:
    the two means within 1%, the gate's numbers printed. estimate
    "pixels": a scene whose parted paths are few but bright (phase 35) is
    held by phase 5's second clause alone, 99% of the pixels within rtol
    1e-2. cpu: the cpu crop (image, route label) made elsewhere (a worker
    process: _cpu_crops), in place of rendering it from cs_cpu."""
    import numpy as np

    x0, x1, y0, y1 = CROP_BOUNDS
    img_g, tier_g = _crop_image(cs_gpu, desc, spp)
    img_c, tier_c = cpu if cpu is not None else _crop_image(cs_cpu, desc, spp)
    rel = np.abs(img_g - img_c).sum() / max(np.abs(img_c).sum(), 1e-30)
    px_ok = np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean()
    signed = desc.film.filter_name in ("mitchell", "sinc", "lanczossinc")
    level = np.abs(img_c).mean() if signed else img_c.mean()
    print(f"[{label}] {x1 - x0}x{y1 - y0} {spp}spp ({tier_g} vs {tier_c}): "
          f"sum|a-b|/sum|b| {rel:.3e}, pixels within rtol 1e-2 {px_ok:.4f}, means {img_g.mean():.5f} "
          f"{img_c.mean():.5f}" + (f", mean |b| {level:.5f}, range [{img_c.min():.5g}, {img_c.max():.5g}]"
                                   if signed else ""), flush=True)
    if estimate == "pixels":
        if not (np.isfinite(img_g).all() and level > 0 and px_ok >= 0.99):
            raise AssertionError(f"cuda and cpu renders of the crop disagree pixel by pixel ({label})")
        return
    if estimate:
        if not (np.isfinite(img_g).all() and level > 0 and abs(img_g.mean() / img_c.mean() - 1.0) < 0.01):
            raise AssertionError(f"cuda and cpu renders of the crop disagree as estimates ({label})")
        return
    if not (np.isfinite(img_g).all() and level > 0 and rel < 1e-3 and px_ok >= 0.99):
        raise AssertionError(f"cuda and cpu renders of the crop disagree ({label})")


def _reset_launches():
    from pbrt_tpu_torch.device import bvh_walk, medium_track, megakernel, megakernel_wide, wide_bvh

    for fn in (wide_bvh.traverse_cuda, wide_bvh.traverse_joint_cuda, megakernel.megakernel_cuda,
               megakernel_wide.wide_megakernel_cuda, bvh_walk.bvh_walk_cuda, bvh_walk.kd_walk_cuda,
               bvh_walk.bvh_walk_motion_cuda, bvh_walk.kd_walk_motion_cuda,
               medium_track.delta_track_cuda, medium_track.ratio_track_cuda):
        fn.launches = 0


def _wide_tolerance(L, w, nv, L_r, w_r, nv_r):
    """The reference wide megakernel's tolerance (tests/test_megakernel_wide.py
    :190-198); returns (ok, a description of the comparison)."""
    import torch

    diff = (L - L_r).abs()
    rel = (diff / (L_r.abs() + 1e-2)).max().item()
    dnv = abs(nv.double().sum().item() - nv_r.double().sum().item())
    ok = torch.allclose(w, w_r) and dnv <= 6 and rel < 2e-2 and diff.mean().item() < 1e-4 and L_r.mean().item() > 0
    return ok, (f"weights equal {torch.equal(w, w_r)}, vertices {nv.double().sum().item():.0f} vs "
                f"{nv_r.double().sum().item():.0f}, max |dL|/(|L|+1e-2) {rel:.3e}, mean |dL| {diff.mean().item():.3e}, "
                f"max |dL| {diff.max().item():.3e}")


def _main_path(label, cs, expect_tier, kernel_fn, spp=None):
    """Phases 4, 7, 10, 12, 14 and 15-18: a warm-up pass, then one full
    render with every launch count set to 0 just before it; returns (timing,
    launches of kernel_fn, image). kernel_fn None: a route of array code
    only (the brute wavefront), which launches no kernel of the port. spp:
    the render's samples per pixel (None: the scene's)."""
    import numpy as np

    from pbrt_tpu_torch import render as R_

    R_.render_compiled(cs, seed=SEED, spp=2)  # warm-up pass
    _reset_launches()
    img = R_.render_compiled(cs, seed=SEED, spp=spp)
    launches = None if kernel_fn is None else kernel_fn.launches
    timing = R_.render_compiled.last_timing
    desc = cs.description
    if timing["tier"] != expect_tier:
        raise AssertionError(f"{label} took route {timing['tier']}")
    if launches is not None and launches <= 0:
        raise AssertionError(f"{label} made no launch of its kernel")
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"{label} image is not finite and non-black")
    vps = timing["n_vertices"] / timing["wall_s"]
    print(f"[{label}] {desc.film.x_resolution}x{desc.film.y_resolution} {spp or desc.sampler.pixel_samples}spp "
          f"depth {desc.integrator.max_depth} route {timing['tier']}: wall {timing['wall_s']:.4f}s, "
          f"{timing['n_vertices']:.0f} path vertices, path_vertex_samples_per_sec {vps:.1f}, "
          f"kernel launches {launches}, image mean {img.mean():.5f}", flush=True)
    return timing, launches, img


def _rays(cs):
    """(name, o, d, t_max) ray sets of the main path's shapes: camera rays,
    one cosine-hemisphere bounce from their hits, shadow rays to the panel."""
    import torch

    from pbrt_tpu_torch.device import rng
    from pbrt_tpu_torch.device.bsdf import LOBE_LAMBERT_R, bsdf_sample
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.device.integrator import RAY_EPS, _offset_ray, _to_local, _to_world
    from pbrt_tpu_torch.device.intersect import intersect
    from pbrt_tpu_torch.device.lights import sample_li
    from pbrt_tpu_torch.device.shading import surface_interaction
    from pbrt_tpu_torch.render import make_regen

    desc = cs.description
    dev = cs.arrays.device
    W, H = desc.film.x_resolution, desc.film.y_resolution
    idx = torch.arange(W * H, device=dev)
    cam = make_camera(desc.camera, desc.film, dev)
    regen = make_regen(cam, {"kind": desc.sampler.kind, "spp": desc.sampler.pixel_samples},
                       {"filter": "box", "filter_params": {}}, idx % W, idx // W, idx, SEED)
    o, d, _w, _dx, _dy = regen(torch.zeros_like(idx))
    inf = torch.full((W * H,), float("inf"), device=dev)
    hit = intersect(cs.arrays, cs.static, o, d, inf)
    si = surface_interaction(cs.arrays, hit, o, d)
    u = [rng.u32_to_float(rng.hash_combine(7, idx, k)) for k in range(3)]
    lobes = {"kind": torch.full_like(idx, LOBE_LAMBERT_R)[:, None], "data": torch.ones((W * H, 1, 14), device=dev),
             "possible": (frozenset({LOBE_LAMBERT_R}),)}
    bs = bsdf_sample(lobes, _to_local(si, si["wo"]), u[0], u[1], u[2])
    wi = _to_world(si, bs["wi"])
    o_b = _offset_ray(si["p"], si["ng"], wi, si["p_err"])
    ls = sample_li(cs.arrays, cs.static, idx % cs.static.n_lights, si["p"], u[1], u[2])
    o_s = _offset_ray(si["p"], si["ng"], ls["wi"], si["p_err"])
    t_s = ls["dist"] * (1.0 - 2.0 * RAY_EPS)
    return [("camera", o, d, inf), ("bounce", o_b.contiguous(), wi.contiguous(), inf),
            ("shadow", o_s.contiguous(), ls["wi"].contiguous(), t_s.contiguous())]


def _lane_share(kernel, workers, sa, o, d, t_max, any_hit):
    """One launch of a traversal wrapper; returns (the share of its warps'
    workers (lanes, or lane groups) holding a ray over its loop iterations,
    the launch's results)."""
    import torch

    iters = kernel.iterations.get(torch.device("cuda", 0))
    if iters is not None:
        iters.zero_()
    res = kernel(sa, o, d, t_max, any_hit)
    n_iter = kernel.iterations[torch.device("cuda", 0)].item()
    return res[4].double().sum().item() / max(workers * n_iter, 1), res


def _compare(name, any_hit, res_k, res_p):
    """Kernel vs plain outputs of one ray set; returns max |dt| on agreeing hits."""
    import torch

    t_k, i_k, b1_k, b2_k = res_k[:4]
    t_p, i_p, b1_p, b2_p = res_p[:4]
    i_p = i_p.to(i_k.dtype)
    hk, hp = i_k >= 0, i_p >= 0
    n = hk.numel()
    hit_agree = (hk == hp).float().mean().item()
    both = hk & hp
    nb = max(int(both.sum()), 1)
    idx_agree = ((i_k == i_p) & both).sum().item() / nb
    same = both & (i_k == i_p)
    rel = ((t_k - t_p).abs() / t_p.abs().clamp(min=1e-30))[same]
    t_ok = (rel <= 1e-5).float().mean().item() if rel.numel() else 1.0
    dt = (t_k - t_p).abs()[both].max().item() if both.any() else 0.0
    db = max((b1_k - b1_p).abs()[same].max().item(), (b2_k - b2_p).abs()[same].max().item()) if same.any() else 0.0
    label = f"{name}/{'any' if any_hit else 'closest'}"
    print(f"  {label}: rays {n} hit {hk.float().mean().item():.4f} hit-agree {hit_agree:.6f} "
          f"{'slot' if any_hit else 'prim'}-agree {idx_agree:.6f} t-rtol1e-5 {t_ok:.6f} "
          f"max|dt| {dt:.3e} max|db| {db:.3e}")
    if hit_agree < 0.9999 or (not any_hit and (idx_agree < 0.9999 or t_ok < 0.9999)):
        raise AssertionError(f"kernel and plain traversal disagree on {label}")
    return max(dt, db)


def _total_within(label, n_vertices, expected):
    """The wavefront's 16 spp path-vertex total against a megakernel's."""
    rel = abs(n_vertices - expected) / expected
    print(f"  {label}: 16 spp path vertices {n_vertices:.0f} against the megakernel's {expected} "
          f"({100 * rel:.4f}%, limit {100 * WAVEFRONT_VERTEX_RTOL:.2f}%)", flush=True)
    if rel > WAVEFRONT_VERTEX_RTOL:
        raise AssertionError(f"{label}: the wavefront traced other paths than the megakernel")


def _crop_lanes(cs):
    import torch

    x0, x1, y0, y1 = CROP_BOUNDS
    dev = cs.arrays.device
    ys, xs = torch.meshgrid(torch.arange(y0, y1, device=dev), torch.arange(x0, x1, device=dev), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1), (ys * cs.description.film.x_resolution + xs).reshape(-1)


def _with_desc(cs, desc):
    from pbrt_tpu_torch.scene.builder import CompiledScene

    return CompiledScene(cs.arrays, cs.static, desc)


def _unswitched(phases, *args) -> dict:
    """phases(out, *args) with none of the route switches set (every switch
    restored after it); returns the dict it filled."""
    out = {}
    switches = ("PBRT_TPU_WIDEMEGA", "PBRT_TPU_NO_MEGAKERNEL", "PBRT_TPU_JOINT")
    with mock.patch.dict(os.environ, {k: v for k, v in os.environ.items() if k not in switches}, clear=True):
        phases(out, *args)
    return out


def _wavefront_phases(out, cs, cs_host, m, m_host, g, g_host, b4_timing, gallery_timing):
    """Phases 15-19: the wavefront on the classes it shares with the
    megakernels, and on those only it renders."""
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import lightdistrib, megakernel, wide_bvh
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scenes import area_box

    # --- 15. material_room through the wavefront, beside B4 ---
    t15, l15, _img = _main_path("15 material_room wavefront", m, "torch-wavefront/cuda-wide",
                                wide_bvh.traverse_cuda)
    vps, vps_b4 = t15["n_vertices"] / t15["wall_s"], b4_timing["n_vertices"] / b4_timing["wall_s"]
    print(f"  path_vertex_samples_per_sec wavefront {vps:.1f} against B4 (phase 12) {vps_b4:.1f}: B4 "
          f"{vps_b4 / vps:.3f}x; B1 launches {l15}", flush=True)
    _total_within("15 material_room wavefront", t15["n_vertices"], MATERIAL_ROOM_VERTICES)
    crop = _crop_lanes(m)
    wave = R_.make_persistent_fn(m)(m.arrays, *crop, 0, CROP_SPP, SEED)
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        mega_fn = R_.make_persistent_fn(m)
        mega_tier = R_.LAST_PERSISTENT_TIER
        mega = mega_fn(m.arrays, *crop, 0, CROP_SPP, SEED)
    ok, desc_cmp = _wide_tolerance(*wave, *mega)
    print(f"[15 material_room B4 vs wavefront] {CROP_SPP}spp crop ({mega_tier} vs torch-wavefront/cuda-wide): "
          f"{desc_cmp}", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and the wavefront disagree on the material_room crop")
    _check_crop("15 cuda-vs-cpu material_room wavefront crop", m, m_host, m.description)
    out["material_room_wavefront"] = {"vps": vps, "wall_s": t15["wall_s"], "b1_launches": l15}

    # --- 16. the spheres gallery through the brute wavefront ---
    with mock.patch.dict(os.environ, PBRT_TPU_NO_MEGAKERNEL="1"):
        t16, _n, _img = _main_path("16 gallery brute wavefront", g, "torch-wavefront/cuda-brute", None)
        if megakernel.megakernel_cuda.launches != 0:
            raise AssertionError("the brute wavefront launched the brute megakernel")
        vps, vps_b3 = t16["n_vertices"] / t16["wall_s"], gallery_timing["n_vertices"] / gallery_timing["wall_s"]
        print(f"  path_vertex_samples_per_sec brute wavefront {vps:.1f} against B3 (phase 7) {vps_b3:.1f}; "
              f"brute megakernel launches 0", flush=True)
        _total_within("16 gallery brute wavefront", t16["n_vertices"], GALLERY_VERTICES)
        crop = _crop_lanes(g)
        wave = R_.make_persistent_fn(g)(g.arrays, *crop, 0, CROP_SPP, SEED)
    mega_fn = R_.make_persistent_fn(g)
    if R_.LAST_PERSISTENT_TIER != "torch-megakernel/cuda-brute":
        raise AssertionError(f"the gallery took {R_.LAST_PERSISTENT_TIER} without PBRT_TPU_NO_MEGAKERNEL")
    _b3_against_plain(f"[16 gallery B3 vs brute wavefront] {CROP_SPP}spp crop", mega_fn(g.arrays, *crop, 0, CROP_SPP,
                                                                                       SEED), wave)
    with mock.patch.dict(os.environ, PBRT_TPU_NO_MEGAKERNEL="1"):
        _check_crop("16 cuda-vs-cpu gallery brute wavefront crop", g, g_host, g.description)
    out["gallery_brute_wavefront"] = {"vps": vps, "wall_s": t16["wall_s"]}

    # --- 17. area_box, the brute wavefront's own scene ---
    box_host = compile_scene(area_box(), "cpu")
    box = box_host.to(cs.arrays.device)
    torch.cuda.reset_peak_memory_stats()
    t17, _n, _img = _main_path("17 area_box main path", box, "torch-wavefront/cuda-brute", None)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {box.static.n_prims} prims ({box.static.n_tris} triangles), {box.static.n_lights} lights, "
          f"'{box.description.integrator.light_strategy}' selection; peak device memory {peak} bytes "
          f"({peak / 2 ** 30:.2f} GiB)", flush=True)
    _check_crop("17 cuda-vs-cpu area_box crop", box, box_host, box.description)
    out["area_box"] = {"vps": t17["n_vertices"] / t17["wall_s"], "wall_s": t17["wall_s"],
                       "n_vertices": t17["n_vertices"], "peak_bytes": peak}

    # --- 18. the mesh room under pbrt's default 'spatial' light distribution ---
    desc_sp = dataclasses.replace(cs.description,
                                  integrator=dataclasses.replace(cs.description.integrator, light_strategy="spatial"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = lightdistrib.build_spatial_distribution(cs.arrays, cs.static)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[18 spatial distribution] mesh room, {cs.static.n_lights} lights: {dist['res']} voxels, built in "
          f"{build_s:.4f}s", flush=True)
    t18, l18, _img = _main_path("18 mesh room spatial", _with_desc(cs, desc_sp), "torch-wavefront/cuda-wide",
                                wide_bvh.traverse_cuda)
    _check_crop("18 cuda-vs-cpu mesh room spatial crop", _with_desc(cs, desc_sp), None, desc_sp,
                cpu=_CPU_CROPS["mesh_room_early"].result()["spatial"])
    out["mesh_spatial"] = {"vps": t18["n_vertices"] / t18["wall_s"], "wall_s": t18["wall_s"],
                           "build_s": build_s, "b1_launches": l18}

    # --- 19. directlighting "all" and the declared stratified sampler ---
    md = m.description
    desc_dl = dataclasses.replace(md, integrator=dataclasses.replace(md.integrator, kind="directlighting",
                                                                     strategy="all"))
    _check_crop("19 cuda-vs-cpu material_room directlighting 'all' crop", _with_desc(m, desc_dl),
                _with_desc(m_host, desc_dl), desc_dl)
    bd = box.description
    desc_st = dataclasses.replace(bd, sampler=dataclasses.replace(bd.sampler, kind="stratified", x_samples=4,
                                                                  y_samples=4, jitter=True))
    _check_crop("19 cuda-vs-cpu area_box stratified 4x4 crop", _with_desc(box, desc_st), _with_desc(box_host, desc_st),
                desc_st, spp=16)


def _tables_equal(a, b) -> list[str]:
    """Names of the SceneTensors tables that differ bit for bit (NaN padding
    compared as bits)."""
    import torch

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, dict):  # the MIP levels, by key
            if x.keys() != y.keys() or any(not torch.equal(x[k], y[k].to(x[k].device)) for k in x):
                bad.append(f.name)
            continue
        if x is None or y is None:
            if (x is None) != (y is None):
                bad.append(f.name)
            continue
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y.to(x.device)):
            bad.append(f.name)
    return bad


def _front_end_phases(out, work, mesh_timing, mesh_img, cs_host, m, m_host):
    """Phases 20 and 21: the front end, python -m pbrt_tpu_torch, on the
    port's own scenes written as .pbrt files with binary PLY meshes."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.core.imageio import read_exr
    from pbrt_tpu_torch.device import sampler, wide_bvh

    # --- 20. the mesh room from a .pbrt file, through main ---
    path = work / "mesh_room.pbrt"
    scenes.write_pbrt(scenes.mesh_room(248), str(path), scenes.ROOM_LOOK_AT)
    file_bytes = sum(f.stat().st_size for f in work.iterdir())
    exr = work / "mesh_room.exr"
    _reset_launches()
    cli.main([str(path), "--outfile", str(exr), "--quiet", "--seed", str(SEED)])
    b1 = wide_bvh.traverse_cuda.launches
    run = cli.main.last_run
    timing, img = run["timing"], run["image"]
    vps = timing["n_vertices"] / timing["wall_s"]
    bad = _tables_equal(run["scene"].arrays, cs_host.arrays)
    half = img.astype(np.float16).astype(np.float32)
    back = read_exr(str(exr))
    rel_img = np.abs(img - mesh_img).sum() / max(np.abs(mesh_img).sum(), 1e-30)
    print(f"[20 front end, mesh room] {path.name} + {len(list(work.glob('*.ply')))} PLY files, {file_bytes} bytes: "
          f"parse + API {run['parse_s']:.4f}s, compile_scene {run['compile_s']:.4f}s, render wall "
          f"{timing['wall_s']:.4f}s, write {run['write_s']:.4f}s; route {timing['tier']}, B1 launches {b1}; "
          f"{timing['n_vertices']:.0f} path vertices (phase 4: {mesh_timing['n_vertices']:.0f}), "
          f"path_vertex_samples_per_sec {vps:.1f}; tables differing from mesh_room(248)'s: {bad or 'none'}; "
          f"EXR equals the image to half precision {np.array_equal(back, half)}; image against phase 4's "
          f"sum|a-b|/sum|b| {rel_img:.3e}, bit-equal {bool(np.array_equal(img, mesh_img))}", flush=True)
    if timing["tier"] != "torch-wavefront/cuda-wide" or b1 <= 0:
        raise AssertionError("the mesh room file did not render through B1")
    if bad or run["scene"].static != cs_host.static:
        raise AssertionError(f"the mesh room file compiles to other tables: {bad}")
    if not np.array_equal(back, half):
        raise AssertionError("the EXR read back differs from the image at half precision")
    if timing["n_vertices"] != mesh_timing["n_vertices"] or timing["n_vertices"] != MESH_ROOM_WAVEFRONT_VERTICES:
        raise AssertionError("the mesh room file traced other paths than phase 4")
    if not rel_img < 1e-6:
        raise AssertionError("the mesh room file's image differs from phase 4's")
    out["mesh_room_file"] = {"parse_s": run["parse_s"], "compile_s": run["compile_s"], "wall_s": timing["wall_s"],
                             "write_s": run["write_s"], "vps": vps, "bytes": file_bytes, "b1_launches": b1}
    # --- 21. pbrt's defaults (halton) and the gaussian filter, then the
    # other samplers and filters ---
    md = m.description
    desc = dataclasses.replace(md, film=dataclasses.replace(md.film, filter_name="gaussian"))
    mpath = work / "material_room.pbrt"
    scenes.write_pbrt(desc, str(mpath), scenes.ROOM_LOOK_AT, sampler=False)
    _reset_launches()
    cli.main([str(mpath), "--outfile", str(work / "material_room.exr"), "--quiet", "--seed", str(SEED)])
    b1 = wide_bvh.traverse_cuda.launches
    run = cli.main.last_run
    timing = run["timing"]
    parsed = run["scene"].description
    vps = timing["n_vertices"] / timing["wall_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.halton_tables(md.film.x_resolution, md.film.y_resolution, "cuda")
    torch.cuda.synchronize()
    halton_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler.sobol_tables(md.film.x_resolution, md.film.y_resolution, md.sampler.pixel_samples)
    sobol_s = time.perf_counter() - t0
    print(f"[21 defaults] material_room file, no Sampler directive ({parsed.sampler.kind}, "
          f"{parsed.sampler.pixel_samples} spp), PixelFilter \"{parsed.film.filter_name}\", "
          f"{parsed.film.x_resolution}x{parsed.film.y_resolution} depth {parsed.integrator.max_depth}: route "
          f"{timing['tier']}, B1 launches {b1}, {timing['n_vertices']:.0f} path vertices, render wall "
          f"{timing['wall_s']:.4f}s, path_vertex_samples_per_sec {vps:.1f}; halton tables built in "
          f"{halton_s:.4f}s, sobol tables in {sobol_s:.6f}s at {md.film.x_resolution}x{md.film.y_resolution}",
          flush=True)
    if parsed.sampler.kind != "halton" or timing["tier"] != "torch-wavefront/cuda-wide" or b1 <= 0:
        raise AssertionError("the material_room file did not render halton through B1")
    if not (np.isfinite(run["image"]).all() and run["image"].mean() > 0):
        raise AssertionError("the material_room file's image is not finite and non-black")
    out["material_room_halton_gaussian"] = {"wall_s": timing["wall_s"], "vps": vps,
                                            "n_vertices": timing["n_vertices"], "b1_launches": b1,
                                            "halton_tables_s": halton_s, "sobol_tables_s": sobol_s}
    # the module entry point itself, as a subprocess on phase 20's file; it
    # runs beside the crops, after the timed renders
    crop_exr = work / "mesh_room_crop.exr"
    t_sub = time.perf_counter()
    sub = subprocess.Popen([sys.executable, "-m", "pbrt_tpu_torch", str(path), "--cropwindow", "0.4", "0.6", "0.4",
                            "0.6", "--outfile", str(crop_exr), "--quiet"], cwd=Path(__file__).resolve().parent,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for kind, filt in (("halton", "gaussian"), ("sobol", "mitchell"), ("maxmindist", "triangle"),
                           ("halton", "sinc")):
            d = dataclasses.replace(md, sampler=dataclasses.replace(md.sampler, kind=kind),
                                    film=dataclasses.replace(md.film, filter_name=filt))
            _check_crop(f"21 cuda-vs-cpu material_room {kind} + {filt} crop", _with_desc(m, d),
                        _with_desc(m_host, d), d)
        sub_out, _ = sub.communicate(timeout=900)
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.wait()
    sub_s = time.perf_counter() - t_sub
    crop = read_exr(str(crop_exr)) if crop_exr.exists() else None
    print(f"[20 module entry point] python -m pbrt_tpu_torch --cropwindow 0.4 0.6 0.4 0.6: exit {sub.returncode} "
          f"in {sub_s:.1f}s, wrote {crop_exr.name} {None if crop is None else crop.shape}", flush=True)
    if sub.returncode != 0 or crop is None or not crop.any():
        raise AssertionError(f"python -m pbrt_tpu_torch failed:\n{sub_out[-4000:]}")
    out["module_entry_point_s"] = sub_s


def _ptxas_entries(log: str) -> list[dict]:
    """Every entry function of an nvcc -Xptxas -v log: its kernel name (the
    mangled name's identifier), template arguments, registers, spills and
    stack frame (tools/ptxas_report.py's fields)."""
    rows = []
    for m in re.finditer(r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads\s*\n[^\n]*Used (\d+) registers", log):
        name = re.match(r"_Z\d+(\w+?)I|_Z\d+(\w+)", m[1])
        targs = re.search(r"I((?:L[ib]-?\d+E)+)E", m[1])
        rows.append({"kernel": (name[1] or name[2]) if name else m[1],
                     "template": [int(x) for x in re.findall(r"L[ib](-?\d+)E", targs[1])] if targs else [],
                     "registers": int(m[5]), "spill_stores": int(m[3]), "spill_loads": int(m[4]),
                     "stack_frame": int(m[2])})
    return rows


def _walk_entries(info) -> list[dict]:
    """_ptxas_entries of the walk library's log, each with its resident
    blocks of 128 per SM (the BVH walk's template: COUNT, MOTION; the kd
    walk's: MOTION)."""
    from pbrt_tpu_torch.device import nvcc

    rows = _ptxas_entries(info["log"])
    for r in rows:
        occupancy = info["lib"].bvh_walk_occupancy if r["kernel"] == "bvh_walk_kernel" else \
            info["lib"].kd_walk_occupancy
        r["blocks_per_sm"] = nvcc.occupancy(occupancy, *r["template"])
    return rows


def _ptxas_of(log: str, template: str) -> dict:
    """The ptxas report of one kernel instantiation (template: the mangled
    template arguments, e.g. ILi3ELi1ELi1ELi0EE): registers, spill stores
    and loads, shared bytes."""
    m = re.search(r"Function properties for \S*" + template + r"\S*\s*\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
                  r"stores, (\d+) bytes spill loads\s*\n[^\n]*Used (\d+) registers[^\n]*?(\d+) bytes smem", log)
    if m is None:
        return {}
    return {"registers": int(m[4]), "spill_stores": int(m[2]), "spill_loads": int(m[3]), "smem": int(m[5])}


def _b4_instantiation(label, scene, sampler_kind, filt, b4_ms_02, dev):
    """Phase 22 for one scene and sampler + filter: B4 against its twin at
    2 spp under phase 11's tolerance, the 16 spp launch with the cap and
    overflow counters at 0, its time by CUDA events, its bound (the
    attribute rows' and sampler table's bytes counted) and the
    instantiation's ptxas report and blocks per SM."""
    import torch

    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import megakernel_wide, sampler
    from pbrt_tpu_torch.device.camera import make_camera

    d = scene.description
    W, H, spp = d.film.x_resolution, d.film.y_resolution, d.sampler.pixel_samples
    scfg = {"kind": sampler_kind, "spp": spp}
    if sampler_kind == "halton":
        scfg["halton"] = sampler.halton_tables(W, H, dev)
    if sampler_kind == "sobol":
        scfg["sobol"] = sampler.sobol_tables(W, H, spp)
    params = dict(scenes.GAUSSIAN_DEFAULTS) if filt == "gaussian" else {"xwidth": 2.0, "ywidth": 2.0} \
        if filt == "triangle" else {}
    icfg = {"kind": "path", "max_depth": d.integrator.max_depth, "rr_threshold": d.integrator.rr_threshold,
            "light_strategy": d.integrator.light_strategy}
    consts = megakernel_wide.extract_wide_consts(
        scene, make_camera(d.camera, d.film, dev), icfg, scfg,
        {"filter": filt, "filter_params": params, "max_sample_luminance": float("inf")},
        megakernel_wide.DEFAULT_MAX_TRIS)
    if consts is None:
        raise AssertionError(f"{label} is outside the wide megakernel's class")
    blob = megakernel_wide.pack_wide_consts(consts).to(dev)
    mode = megakernel_wide.kernel_mode(consts)
    stab = megakernel_wide.sampler_table(consts, dev)
    idx = torch.arange(W * H, device=dev)
    lanes = (idx % W, idx // W, idx)

    def launch(n):
        return megakernel_wide.wide_megakernel_cuda(blob, mode, scene.arrays, *lanes, 0, n, SEED, stab)

    out_k = launch(COMPARE_SPP)
    out_p = megakernel_wide.wide_megakernel_plain(consts, scene.arrays, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    ok, desc_cmp = _wide_tolerance(*out_k, *out_p)
    err = (out_k[0] - out_p[0]).abs().max().item()
    print(f"[22 B4 {label}] {W}x{H} {COMPARE_SPP}spp, mode {mode}: {desc_cmp}, image mean "
          f"{out_p[0].mean().item():.5f}", flush=True)
    if not ok:
        raise AssertionError(f"the wide megakernel and its plain twin disagree on {label}")
    ms = _cuda_ms(lambda: launch(spp), 3)
    counters, pops = megakernel_wide.wide_megakernel_cuda.counters[dev], megakernel_wide.wide_megakernel_cuda.pops[dev]
    counters.zero_()
    pops.zero_()
    nv16 = launch(spp)[2].double().sum().item()
    pops_c, pops_s = pops.tolist()
    if counters.tolist() != [0, 0]:
        raise AssertionError(f"wide megakernel stack overflows / iteration-cap hits on {label}: {counters.tolist()}")
    sa = scene.arrays
    tables = [sa.wnode_rec, sa.wleaf_rec, stab] + ([sa.wattr_rec] if consts["has_attr"] else [])
    nbytes = 3 * 4 * W * H + _nbytes(*tables) + 5 * 4 * W * H
    bound = _bound(nbytes, (pops_c + pops_s) * B1_OPS_PER_POP + nv16 * B3_OPS_SHADE)
    n_s = megakernel_wide.N_SAMPLER_IDS
    ptx = _ptxas_of(megakernel_wide.build_kernel()["log"],
                    f"ILi{(mode // 2) % n_s}ELi{mode % 2}ELi{mode // (2 * n_s)}ELi0EE")
    occ = megakernel_wide.occupancy(mode)
    print(f"  {spp}spp: kernel {ms:.4f} ms (phase 11's (0,2) + box {b4_ms_02:.4f} ms, {ms / b4_ms_02:.3f}x); "
          f"{nv16:.0f} path vertices ({nv16 / (W * H * spp):.3f} per sample), pops closest {pops_c} shadow "
          f"{pops_s}; bound {bound[0]:.4f} ms ({bound[1]}, {nbytes} bytes), kernel at {100 * bound[0] / ms:.2f}% "
          f"of it; ptxas {ptx}, {occ} blocks per SM", flush=True)
    return {"mode": mode, "ms": ms, "n_vertices": nv16, "max_abs_err": err, "bound_ms": bound[0],
            "bound_by": bound[1], "blocks_per_sm": occ, **ptx}


def _sky_phases(out, work, m, m_host, b4_ms, fe):
    """Phases 22-24: B4's samplers, filters, attribute rows and constant
    sky against its twin; pbrt's defaults through B4 from a file; the sky
    scene through B4 and the wavefront, and an image-mapped sky through the
    wavefront."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.core.imageio import write_image
    from pbrt_tpu_torch.device import megakernel_wide, wide_bvh
    from pbrt_tpu_torch.scene.builder import compile_scene

    dev = torch.device("cuda", 0)
    # --- 22. B4's instantiations of this slice against its twin ---
    sky_host = compile_scene(scenes.sky_meshes(), "cpu")
    sky = sky_host.to(dev)
    out["instantiations"] = {
        "sky_meshes halton + gaussian": _b4_instantiation("sky_meshes halton + gaussian", sky, "halton",
                                                          "gaussian", b4_ms, dev),
        "material_room halton + gaussian": _b4_instantiation("material_room halton + gaussian", m, "halton",
                                                             "gaussian", b4_ms, dev),
        "material_room sobol + triangle": _b4_instantiation("material_room sobol + triangle", m, "sobol",
                                                            "triangle", b4_ms, dev),
        "material_room maxmindist + box": _b4_instantiation("material_room maxmindist + box", m, "maxmindist",
                                                            "box", b4_ms, dev),
    }

    # --- 23. pbrt's defaults from a file through B4 ---
    mpath = work / "material_room.pbrt"  # phase 21's: no Sampler directive, PixelFilter "gaussian"
    wave21 = fe["material_room_halton_gaussian"]
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        _reset_launches()
        cli.main([str(mpath), "--outfile", str(work / "material_room_b4.exr"), "--quiet", "--seed", str(SEED)])
        b4_launches = megakernel_wide.wide_megakernel_cuda.launches
        run = cli.main.last_run
        timing, parsed_cs = run["timing"], run["scene"]
        crop = _crop_lanes(parsed_cs)
        mega = R_.make_persistent_fn(parsed_cs)(parsed_cs.arrays, *crop, 0, CROP_SPP, SEED)
        mega_tier = R_.LAST_PERSISTENT_TIER
    wave = R_.make_persistent_fn(parsed_cs)(parsed_cs.arrays, *crop, 0, CROP_SPP, SEED)
    ok, desc_cmp = _wide_tolerance(*mega, *wave)
    vps = timing["n_vertices"] / timing["wall_s"]
    print(f"[23 defaults through B4] {mpath.name} ({parsed_cs.description.sampler.kind}, "
          f"{parsed_cs.description.film.filter_name}) with PBRT_TPU_WIDEMEGA=1: route {timing['tier']}, B4 launches "
          f"{b4_launches}, render wall {timing['wall_s']:.4f}s, path_vertex_samples_per_sec {vps:.1f} against phase "
          f"21's wavefront {wave21['vps']:.1f} ({vps / wave21['vps']:.2f}x); {CROP_SPP}spp crop ({mega_tier} vs "
          f"{R_.LAST_PERSISTENT_TIER}): {desc_cmp}", flush=True)
    if timing["tier"] != "torch-megakernel/cuda-wide" or b4_launches != 1:
        raise AssertionError(f"the defaults file did not render in one B4 launch ({timing['tier']}, {b4_launches})")
    if not (np.isfinite(run["image"]).all() and run["image"].mean() > 0):
        raise AssertionError("the defaults file's B4 image is not finite and non-black")
    _total_within("23 defaults file, wavefront (phase 21) against B4", wave21["n_vertices"], timing["n_vertices"])
    if not ok:
        raise AssertionError("B4 and the wavefront disagree on the defaults file's crop")
    out["material_room_defaults_b4"] = {"wall_s": timing["wall_s"], "vps": vps, "n_vertices": timing["n_vertices"],
                                        "b4_launches": b4_launches}

    # --- 24. sky_meshes through B4 and the wavefront; an image-mapped sky ---
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        t_b4, l_b4, _img = _main_path("24 sky_meshes through B4", sky, "torch-megakernel/cuda-wide",
                                      megakernel_wide.wide_megakernel_cuda)
        if l_b4 != 1:
            raise AssertionError(f"the sky render made {l_b4} B4 launches, not 1")
        crop = _crop_lanes(sky)
        mega = R_.make_persistent_fn(sky)(sky.arrays, *crop, 0, CROP_SPP, SEED)
        _check_crop("24 cuda-vs-cpu sky_meshes B4 crop", sky, sky_host, sky.description)
    t_w, l_w, _img = _main_path("24 sky_meshes wavefront", sky, "torch-wavefront/cuda-wide", wide_bvh.traverse_cuda)
    vps_b4, vps_w = t_b4["n_vertices"] / t_b4["wall_s"], t_w["n_vertices"] / t_w["wall_s"]
    print(f"  path_vertex_samples_per_sec B4 {vps_b4:.1f}, wavefront {vps_w:.1f}: B4 {vps_b4 / vps_w:.3f}x; "
          f"B1 launches {l_w}", flush=True)
    _total_within("24 sky_meshes wavefront", t_w["n_vertices"], t_b4["n_vertices"])
    wave = R_.make_persistent_fn(sky)(sky.arrays, *crop, 0, CROP_SPP, SEED)
    ok, desc_cmp = _wide_tolerance(*wave, *mega)
    print(f"[24 sky_meshes B4 vs wavefront] {CROP_SPP}spp crop: {desc_cmp}", flush=True)
    if not ok:
        raise AssertionError("B4 and the wavefront disagree on the sky crop")
    _check_crop("24 cuda-vs-cpu sky_meshes wavefront crop", sky, sky_host, sky.description)
    # an image-mapped sky: a latitude-longitude map the phase writes (a
    # zenith-to-horizon gradient and a bright sun patch), rotated by its
    # light-to-world transform nowhere (the file's identity)
    h, w = 64, 128
    theta = (np.arange(h)[:, None] + 0.5) / h
    env = np.zeros((h, w, 3), np.float32)
    env[...] = (np.array([0.3, 0.45, 0.8]) * (1.0 - 0.6 * theta) + np.array([0.6, 0.5, 0.4]) * 0.6 * theta)[:, None]
    env[10:14, 30:36] = [40.0, 36.0, 30.0]
    write_image(str(work / "sky_env.pfm"), env)
    desc = scenes.sky_meshes()
    desc.lights[0] = dataclasses.replace(desc.lights[0], map_name="sky_env.pfm", intensity=np.ones(3))
    epath = work / "sky_env.pbrt"
    scenes.write_pbrt(desc, str(epath), scenes.SKY_LOOK_AT, sampler=False)
    _reset_launches()
    cli.main([str(epath), "--outfile", str(work / "sky_env.exr"), "--quiet", "--seed", str(SEED)])
    b1 = wide_bvh.traverse_cuda.launches
    run = cli.main.last_run
    timing, env_cs = run["timing"], run["scene"]
    vps = timing["n_vertices"] / timing["wall_s"]
    print(f"[24 image-mapped sky] {epath.name} ({h}x{w} map): has_env_map {env_cs.static.has_env_map}, route "
          f"{timing['tier']}, B1 launches {b1}, {timing['n_vertices']:.0f} path vertices, render wall "
          f"{timing['wall_s']:.4f}s, path_vertex_samples_per_sec {vps:.1f}, image mean {run['image'].mean():.5f}",
          flush=True)
    if not env_cs.static.has_env_map or timing["tier"] != "torch-wavefront/cuda-wide" or b1 <= 0:
        raise AssertionError("the image-mapped sky did not render through the wavefront with its map")
    if not (np.isfinite(run["image"]).all() and run["image"].mean() > 0):
        raise AssertionError("the image-mapped sky's image is not finite and non-black")
    env_host = compile_scene(env_cs.description, "cpu")
    _check_crop("24 cuda-vs-cpu image-mapped sky crop", env_cs, env_host, env_cs.description)
    out["sky_meshes"] = {"b4_wall_s": t_b4["wall_s"], "b4_vps": vps_b4, "wave_wall_s": t_w["wall_s"],
                         "wave_vps": vps_w, "n_vertices": t_b4["n_vertices"], "b1_launches": l_w}
    out["sky_env_map"] = {"wall_s": timing["wall_s"], "vps": vps, "n_vertices": timing["n_vertices"],
                          "b1_launches": b1}


def _kernels_per_iteration(cs, spp=CROP_SPP) -> tuple[int, int]:
    """(device kernels, wavefront iterations) of the crop's render at spp
    under torch.profiler; iterations = closest-hit queries (one per
    iteration), counted without a synchronize, as tools/torch_phases.py
    counts them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import integrator

    desc_c = dataclasses.replace(cs.description, integrator=dataclasses.replace(cs.description.integrator,
                                                                                pixel_bounds=CROP_BOUNDS),
                                 sampler=dataclasses.replace(cs.description.sampler, pixel_samples=spp))
    n_iter = [0]
    closest = integrator.intersect

    def counted(*a, **k):
        n_iter[0] += 1
        return closest(*a, **k)

    integrator.intersect = counted
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            R_.render_compiled(_with_desc(cs, desc_c), seed=SEED)
            torch.cuda.synchronize()
    finally:
        integrator.intersect = closest
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA), n_iter[0]


def _texture_phases(out, work, g, b3_ms, b3_bound_vertex, m, b4_ms):
    """Phases 25-27: a textured scene through the wavefront and from a
    file; B3's Kd atlas; B4's checkerboard Kd."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import megakernel, megakernel_wide, wide_bvh
    from pbrt_tpu_torch.device.camera import generate_rays, make_camera
    from pbrt_tpu_torch.device.intersect import intersect
    from pbrt_tpu_torch.scene.builder import compile_scene

    dev = torch.device("cuda", 0)
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}

    # --- 25. textured_room through the wavefront; as a file ---
    t0 = time.perf_counter()
    tr_host = compile_scene(scenes.textured_room(), "cpu")
    host_s = time.perf_counter() - t0
    tr = tr_host.to(dev)
    timing, b1, img = _main_path("25 textured_room main path", tr, "torch-wavefront/cuda-wide",
                                 wide_bvh.traverse_cuda, LATE_MAIN_SPP)
    n_k, n_it = _kernels_per_iteration(tr, LATE_SPP[0])
    tex_bytes = _nbytes(*tr.arrays.tex_images.values())
    print(f"  host compile {host_s:.2f}s, {len(tr.static.tex_programs)} texture programs "
          f"{[p.kind for p in tr.static.tex_programs]}, MIP levels {tex_bytes} bytes; crop under the profiler: "
          f"{n_k} device kernels over {n_it} wavefront iterations ({n_k / max(n_it, 1):.1f} per iteration)",
          flush=True)
    _check_crop("25 cuda-vs-cpu textured_room crop", tr, tr_host, tr.description, LATE_SPP[1])
    path = work / "textured_room.pbrt"
    scenes.write_pbrt(tr_host.description, str(path), scenes.ROOM_LOOK_AT, sampler=False)
    _reset_launches()
    cli.main([str(path), "--outfile", str(work / "textured_room.exr"), "--quiet", "--seed", str(SEED), "--spp",
              str(LATE_MAIN_SPP)])
    run = cli.main.last_run
    f_timing, f_img = run["timing"], run["image"]
    bad = _tables_equal(run["scene"].arrays, tr_host.arrays)
    rel_img = np.abs(f_img - img).sum() / max(np.abs(img).sum(), 1e-30)
    print(f"[25 textured_room file] {path.name}: parse + API {run['parse_s']:.4f}s, compile_scene "
          f"{run['compile_s']:.4f}s, render wall {f_timing['wall_s']:.4f}s, route {f_timing['tier']}; tables "
          f"differing from the hand-built scene's: {bad or 'none'}; {f_timing['n_vertices']:.0f} path vertices; "
          f"image against the first render's sum|a-b|/sum|b| {rel_img:.3e}, bit-equal "
          f"{bool(np.array_equal(f_img, img))}", flush=True)
    if bad or run["scene"].static != tr_host.static:
        raise AssertionError(f"the textured_room file compiles to other tables: {bad}")
    if f_timing["n_vertices"] != timing["n_vertices"] or not np.array_equal(f_img, img):
        raise AssertionError("the textured_room file renders another image than the hand-built scene")
    out["textured_room"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                            "n_vertices": timing["n_vertices"], "b1_launches": b1, "kernels": n_k,
                            "iterations": n_it, "kernels_per_iteration": n_k / max(n_it, 1),
                            "file_wall_s": f_timing["wall_s"], "compile_s": run["compile_s"]}

    # --- 26. B3's Kd atlas on textured_gallery ---
    tg_host = compile_scene(scenes.textured_gallery(), "cpu")
    tg = tg_host.to(dev)
    gd = tg.description
    W, H, spp = gd.film.x_resolution, gd.film.y_resolution, gd.sampler.pixel_samples
    icfg = {"kind": gd.integrator.kind, "max_depth": gd.integrator.max_depth,
            "rr_threshold": gd.integrator.rr_threshold, "strategy": gd.integrator.strategy,
            "light_strategy": gd.integrator.light_strategy}
    cam = make_camera(gd.camera, gd.film, dev)
    consts = megakernel.extract_consts(tg, cam, icfg, {"kind": gd.sampler.kind, "spp": spp}, fcfg)
    if consts is None:
        raise AssertionError("textured_gallery is outside the megakernel's class: "
                             f"{megakernel.explain_ineligible(tg, cam, icfg, {'kind': gd.sampler.kind, 'spp': spp}, fcfg)}")
    blob = megakernel.pack_consts(consts).to(dev)
    atlas, tex = (x.to(dev) for x in megakernel.pack_textures(consts))
    mode = megakernel.kernel_mode(consts)
    idx = torch.arange(W * H, device=dev)
    lanes = (idx % W, idx // W, idx)

    def launch(n):
        return megakernel.megakernel_cuda(blob, mode, *lanes, 0, n, SEED, atlas, tex)

    out_k = launch(COMPARE_SPP)
    t0 = time.perf_counter()
    out_p = megakernel.megakernel_plain(consts, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = _b3_against_plain(f"[26 B3 textured kernel-vs-plain] textured_gallery {W}x{H} {COMPARE_SPP}spp, mode "
                            f"{mode}, atlas {tuple(atlas.shape)}", out_k, out_p)
    ms = _cuda_ms(lambda: launch(spp), 5)
    caps = megakernel.megakernel_cuda.counters[dev]
    caps.zero_()
    nv16 = launch(spp)[2].double().sum().item()
    if caps.item() != 0:
        raise AssertionError(f"the textured brute megakernel cut {caps.item()} pixels at the iteration cap")
    # the camera rays' first hits on textured prims, a lower count of the
    # lookups the 16 spp paths made (bounces hit textured prims too)
    px_f, py_f = lanes[0].float() + 0.5, lanes[1].float() + 0.5
    o, d = generate_rays(cam, px_f, py_f, torch.zeros_like(px_f), torch.zeros_like(px_f))
    hit = intersect(tg.arrays, tg.static, o, d, torch.full_like(px_f, float("inf")))
    tex_rows = torch.as_tensor([int(m_ in {mm for mm, e in consts["mats"].items() if e.get("kd_tex") is not None})
                                for m_ in range(tg.static.n_materials)], device=dev, dtype=torch.bool)
    textured_share = ((hit["prim"] >= 0) & tex_rows[tg.arrays.prim_mat[hit["prim"].clamp(min=0)].long()]).float().mean()
    n_lookups = float(textured_share) * W * H * spp
    n_tri = sum(p["kind"] == "tri" for p in consts["prims"])
    n_sph = len(consts["prims"]) - n_tri
    nbytes = 3 * 4 * W * H + megakernel.BLOB_FLOATS * 4 + _nbytes(atlas, tex) + 5 * 4 * W * H
    ops = nv16 * (2 * (n_tri * B3_OPS_TRI + n_sph * B3_OPS_SPH) + B3_OPS_SHADE) + n_lookups * B3_OPS_TEX
    bound = _bound(nbytes, ops)
    ptx = _ptxas_of(megakernel.build_kernel()["log"],
                    f"ILi{(mode % megakernel.N_PLAIN_MODES) // 2}ELi{mode % 2}ELi1ELi0EE")
    occ = megakernel.occupancy(mode)
    print(f"  {spp}spp: kernel {ms:.4f} ms (phase 6's gallery {b3_ms:.4f} ms, {ms / b3_ms:.3f}x), plain "
          f"{COMPARE_SPP}spp {plain_ms:.1f} ms; {nv16:.0f} path vertices, camera hits on textured prims "
          f"{100 * float(textured_share):.1f}%; bound {bound[0]:.4f} ms ({bound[1]}, {ops:.4g} ops, {nbytes} bytes), "
          f"kernel at {100 * bound[0] / ms:.2f}% of it (phase 6's per-vertex bound {b3_bound_vertex[0]:.4f} ms); "
          f"ptxas {ptx}, {occ} blocks per SM", flush=True)
    b3_inst = {"mode": mode, "ms": ms, "plain_ms": plain_ms, "n_vertices": nv16, "max_abs_err": err,
               "bound_ms": bound[0], "bound_by": bound[1], "blocks_per_sm": occ, **ptx}
    t_k, l_k, img_k = _main_path("26 textured_gallery through B3", tg, "torch-megakernel/cuda-brute",
                                 megakernel.megakernel_cuda, LATE_MAIN_SPP)
    if l_k != 1:
        raise AssertionError(f"the textured gallery render made {l_k} brute megakernel launches, not 1")
    with mock.patch.dict(os.environ, PBRT_TPU_NO_MEGAKERNEL="1"):
        t_w, _l, img_w = _main_path("26 textured_gallery through the brute wavefront", tg,
                                    "torch-wavefront/cuda-brute", None, LATE_MAIN_SPP)
    ratio = float(img_k.mean()) / float(img_w.mean())
    print(f"  mean brightness B3 (ray cones) {img_k.mean():.5f}, wavefront (EWA) {img_w.mean():.5f}: ratio "
          f"{ratio:.4f} (band {RAY_CONE_BAND}); path_vertex_samples_per_sec B3 "
          f"{t_k['n_vertices'] / t_k['wall_s']:.1f}, wavefront {t_w['n_vertices'] / t_w['wall_s']:.1f}", flush=True)
    if not RAY_CONE_BAND[0] <= ratio <= RAY_CONE_BAND[1]:
        raise AssertionError("the textured gallery's B3 and wavefront images differ in brightness")
    out["textured_gallery"] = {"b3_wall_s": t_k["wall_s"], "wave_wall_s": t_w["wall_s"], "ratio": ratio,
                               "b3_launches": l_k}

    # --- 27. B4's checkerboard Kd on material_room(checker=True) ---
    cm_host = compile_scene(scenes.material_room(checker=True), "cpu")
    cm = cm_host.to(dev)
    md = cm.description
    W, H, spp = md.film.x_resolution, md.film.y_resolution, md.sampler.pixel_samples
    icfg = {"kind": "path", "max_depth": md.integrator.max_depth, "rr_threshold": md.integrator.rr_threshold,
            "light_strategy": md.integrator.light_strategy}
    wconsts = megakernel_wide.extract_wide_consts(cm, make_camera(md.camera, md.film, dev), icfg,
                                                  {"kind": md.sampler.kind, "spp": spp}, fcfg,
                                                  megakernel_wide.DEFAULT_MAX_TRIS)
    if wconsts is None:
        raise AssertionError("the checker room is outside the wide megakernel's class")
    wblob = megakernel_wide.pack_wide_consts(wconsts).to(dev)
    wmode = megakernel_wide.kernel_mode(wconsts)
    idx = torch.arange(W * H, device=dev)
    lanes = (idx % W, idx // W, idx)

    def wlaunch(n):
        return megakernel_wide.wide_megakernel_cuda(wblob, wmode, cm.arrays, *lanes, 0, n, SEED)

    out_k = wlaunch(COMPARE_SPP)
    t0 = time.perf_counter()
    out_p = megakernel_wide.wide_megakernel_plain(wconsts, cm.arrays, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    ok, desc_cmp = _wide_tolerance(*out_k, *out_p)
    err = (out_k[0] - out_p[0]).abs().max().item()
    print(f"[27 B4 checker kernel-vs-plain] {W}x{H} {COMPARE_SPP}spp, mode {wmode}: {desc_cmp}, image mean "
          f"{out_p[0].mean().item():.5f}", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and its plain twin disagree on the checker room")
    ms = _cuda_ms(lambda: wlaunch(spp), 3)
    counters, pops = megakernel_wide.wide_megakernel_cuda.counters[dev], megakernel_wide.wide_megakernel_cuda.pops[dev]
    counters.zero_()
    pops.zero_()
    nv16 = wlaunch(spp)[2].double().sum().item()
    pops_c, pops_s = pops.tolist()
    if counters.tolist() != [0, 0]:
        raise AssertionError(f"wide megakernel stack overflows / iteration-cap hits on the checker room: "
                             f"{counters.tolist()}")
    sa = cm.arrays
    nbytes = 3 * 4 * W * H + _nbytes(sa.wnode_rec, sa.wleaf_rec, sa.wattr_rec) + 5 * 4 * W * H
    bound = _bound(nbytes, (pops_c + pops_s) * B1_OPS_PER_POP + nv16 * B3_OPS_SHADE)
    n_s = megakernel_wide.N_SAMPLER_IDS
    ptx = _ptxas_of(megakernel_wide.build_kernel()["log"],
                    f"ILi{(wmode // 2) % n_s}ELi{wmode % 2}ELi{wmode // (2 * n_s)}ELi0EE")
    occ = megakernel_wide.occupancy(wmode)
    print(f"  {spp}spp: kernel {ms:.4f} ms (phase 11's (0,2) + box {b4_ms:.4f} ms, {ms / b4_ms:.3f}x), plain "
          f"{COMPARE_SPP}spp {plain_ms:.1f} ms; {nv16:.0f} path vertices, pops closest {pops_c} shadow {pops_s}; "
          f"bound {bound[0]:.4f} ms ({bound[1]}, {nbytes} bytes), kernel at {100 * bound[0] / ms:.2f}% of it; "
          f"ptxas {ptx}, {occ} blocks per SM", flush=True)
    b4_inst = {"mode": wmode, "ms": ms, "plain_ms": plain_ms, "n_vertices": nv16, "max_abs_err": err,
               "bound_ms": bound[0], "bound_by": bound[1], "blocks_per_sm": occ, **ptx}
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        t_b4, l_b4, _img = _main_path("27 checker room through B4", cm, "torch-megakernel/cuda-wide",
                                      megakernel_wide.wide_megakernel_cuda)
        if l_b4 != 1:
            raise AssertionError(f"the checker room render made {l_b4} B4 launches, not 1")
        crop = _crop_lanes(cm)
        mega = R_.make_persistent_fn(cm)(cm.arrays, *crop, 0, CROP_SPP, SEED)
    t_w, l_w, _img = _main_path("27 checker room through the wavefront", cm, "torch-wavefront/cuda-wide",
                                wide_bvh.traverse_cuda)
    _total_within("27 checker room wavefront", t_w["n_vertices"], t_b4["n_vertices"])
    wave = R_.make_persistent_fn(cm)(cm.arrays, *crop, 0, CROP_SPP, SEED)
    ok, desc_cmp = _wide_tolerance(*wave, *mega)
    print(f"[27 checker room B4 vs wavefront] path_vertex_samples_per_sec B4 {t_b4['n_vertices'] / t_b4['wall_s']:.1f}"
          f", wavefront {t_w['n_vertices'] / t_w['wall_s']:.1f}; {CROP_SPP}spp crop: {desc_cmp}", flush=True)
    if not ok:
        raise AssertionError("B4 and the wavefront disagree on the checker room crop")
    out["checker_room"] = {"b4_wall_s": t_b4["wall_s"], "wave_wall_s": t_w["wall_s"], "n_vertices": t_b4["n_vertices"],
                           "b4_launches": l_b4}
    out["b3_instantiations"] = {"textured_gallery": b3_inst}
    out["b4_instantiations"] = {"material_room checker Kd": b4_inst}


def _query_against_twin(label, cs):
    """Phase 28's mixed query: intersect and intersect_p through B1 over the
    triangle subset's tables, the spheres tested beside it, against the
    same query through the walk's plain twin, on the main path's camera,
    bounce and shadow rays; every result equal bit for bit. Returns the
    kernel's camera/closest milliseconds (CUDA events) and the rays."""
    import torch

    from pbrt_tpu_torch.device.intersect import intersect, intersect_p

    sa, st = cs.arrays, cs.static
    ms = None
    for name, o, d, t_max in _rays(cs):
        hk, hp = (intersect(sa, st, o, d, t_max, sort_rays=True, plain=plain) for plain in (False, True))
        occ_k, occ_p = (intersect_p(sa, st, o, d, t_max, sort_rays=True, plain=plain) for plain in (False, True))
        equal = all(torch.equal(hk[k], hp[k]) for k in ("t", "prim", "b1", "b2")) and torch.equal(occ_k, occ_p)
        sph = (sa.prim_kind[hk["prim"].clamp(min=0)] == 1) & (hk["prim"] >= 0)
        k_ms = _cuda_ms(lambda: intersect(sa, st, o, d, t_max, sort_rays=True), 5)
        ms = ms if ms is not None else k_ms
        print(f"  {label} {name}: {o.shape[0]} rays, hits {float((hk['prim'] >= 0).float().mean()):.4f} "
              f"(spheres {float(sph.float().mean()):.4f}), occluded {float(occ_k.float().mean()):.4f}; closest and "
              f"any hit equal to the twin bit for bit: {equal}; mixed closest query {k_ms:.4f} ms", flush=True)
        if not equal:
            raise AssertionError(f"the mixed query and its twin differ on {label} {name} rays")
    return ms


def _sphere_phases(out, cs, b4_ms, g):
    """Phases 28-30: spheres and sphere lamps in wide scenes (the mixed
    query through the wavefront, B4's sphere instantiations), the uber
    material in both megakernels and the wavefront."""
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import megakernel, megakernel_wide, wide_bvh
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scene.host import HostMaterial

    dev = torch.device("cuda", 0)
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
    n_k_mesh, n_it_mesh = _kernels_per_iteration(cs, LATE_SPP[0])
    print(f"[28 mesh room] crop under the profiler: {n_k_mesh} device kernels over {n_it_mesh} wavefront "
          f"iterations ({n_k_mesh / max(n_it_mesh, 1):.1f} per iteration)", flush=True)

    # --- 28. sphere_room through the wavefront, at n_side 40 and 248 ---
    rooms = {}
    for n_side in (40, 248):
        label = f"28 sphere_room({n_side})"
        t0 = time.perf_counter()
        if n_side == 248:
            host, host_s = _host_scene("sphere_room")
        else:
            host = compile_scene(scenes.sphere_room(n_side), "cpu")
            host_s = time.perf_counter() - t0
        sr = host.to(dev)
        timing, b1, _img = _main_path(f"{label} main path", sr, "torch-wavefront/cuda-wide-mixed",
                                      wide_bvh.traverse_cuda)
        n_k, n_it = _kernels_per_iteration(sr, LATE_SPP[0])
        print(f"  {sr.static.n_tris} triangles beside {sr.static.n_spheres} spheres, {sr.static.n_lights} lights, "
              f"host compile {host_s:.2f}s; crop under the profiler: {n_k} device kernels over {n_it} wavefront "
              f"iterations ({n_k / max(n_it, 1):.1f} per iteration; the mesh room's "
              f"{n_k_mesh / max(n_it_mesh, 1):.1f})", flush=True)
        q_ms = _query_against_twin(label, sr)
        _check_crop(f"{label} cuda-vs-cpu crop", sr, host, sr.description, LATE_SPP[1])
        rooms[n_side] = sr
        out[f"sphere_room_{n_side}"] = {
            "wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
            "n_vertices": timing["n_vertices"], "b1_launches": b1, "kernels_per_iteration": n_k / max(n_it, 1),
            "mesh_room_kernels_per_iteration": n_k_mesh / max(n_it_mesh, 1), "mixed_camera_query_ms": q_ms}

    # --- 29. sphere_room through B4 ---
    sr = rooms[40]
    d = sr.description
    W, H, spp = d.film.x_resolution, d.film.y_resolution, d.sampler.pixel_samples
    icfg = {"kind": "path", "max_depth": d.integrator.max_depth, "rr_threshold": d.integrator.rr_threshold,
            "light_strategy": d.integrator.light_strategy}
    consts = megakernel_wide.extract_wide_consts(sr, make_camera(d.camera, d.film, dev), icfg,
                                                 {"kind": d.sampler.kind, "spp": spp}, fcfg,
                                                 megakernel_wide.DEFAULT_MAX_TRIS)
    if consts is None:
        raise AssertionError("sphere_room is outside the wide megakernel's class")
    blob = megakernel_wide.pack_wide_consts(consts).to(dev)
    mode = megakernel_wide.kernel_mode(consts)
    idx = torch.arange(W * H, device=dev)
    lanes = (idx % W, idx // W, idx)

    def launch(n):
        return megakernel_wide.wide_megakernel_cuda(blob, mode, sr.arrays, *lanes, 0, n, SEED)

    out_k = launch(COMPARE_SPP)
    t0 = time.perf_counter()
    out_p = megakernel_wide.wide_megakernel_plain(consts, sr.arrays, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    ok, desc_cmp = _wide_tolerance(*out_k, *out_p)
    err = (out_k[0] - out_p[0]).abs().max().item()
    n_sph = len(consts["spheres"])
    print(f"[29 B4 sphere_room] {W}x{H} {COMPARE_SPP}spp, mode {mode}, {n_sph} spheres, lamps "
          f"{sum(bool(lt.get('sphere')) for lt in consts['lights'])}: {desc_cmp}, image mean "
          f"{out_p[0].mean().item():.5f}; plain twin {plain_ms:.1f} ms", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and its plain twin disagree on sphere_room")
    ms = _cuda_ms(lambda: launch(spp), 3)
    counters, pops = megakernel_wide.wide_megakernel_cuda.counters[dev], megakernel_wide.wide_megakernel_cuda.pops[dev]
    counters.zero_()
    pops.zero_()
    nv16 = launch(spp)[2].double().sum().item()
    pops_c, pops_s = pops.tolist()
    if counters.tolist() != [0, 0]:
        raise AssertionError(f"wide megakernel stack overflows / iteration-cap hits on sphere_room: "
                             f"{counters.tolist()}")
    nbytes = 3 * 4 * W * H + _nbytes(sr.arrays.wnode_rec, sr.arrays.wleaf_rec, blob) + 5 * 4 * W * H
    # every closest ray (at least one per path vertex) tests every sphere
    ops = (pops_c + pops_s) * B1_OPS_PER_POP + nv16 * (B3_OPS_SHADE + n_sph * B3_OPS_SPH)
    bound = _bound(nbytes, ops)
    n_s = megakernel_wide.N_SAMPLER_IDS
    ptx = _ptxas_of(megakernel_wide.build_kernel()["log"],
                    f"ILi{(mode // 2) % n_s}ELi{mode % 2}ELi{mode // (2 * n_s)}ELi0EE")
    occ = megakernel_wide.occupancy(mode)
    print(f"  {spp}spp: kernel {ms:.4f} ms (phase 11's (0,2) + box on material_room {b4_ms:.4f} ms, "
          f"{ms / b4_ms:.3f}x); {nv16:.0f} path vertices ({nv16 / (W * H * spp):.3f} per sample), pops closest "
          f"{pops_c} shadow {pops_s}; bound {bound[0]:.4f} ms ({bound[1]}, {ops:.4g} ops, {nbytes} bytes), kernel "
          f"at {100 * bound[0] / ms:.2f}% of it; ptxas {ptx}, {occ} blocks per SM", flush=True)
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        t_b4, l_b4, _img = _main_path("29 sphere_room through B4", sr, "torch-megakernel/cuda-wide",
                                      megakernel_wide.wide_megakernel_cuda)
        if l_b4 != 1:
            raise AssertionError(f"the sphere_room render made {l_b4} B4 launches, not 1")
    t_w = out["sphere_room_40"]
    _total_within("29 sphere_room wavefront (phase 28) against B4", t_w["n_vertices"], t_b4["n_vertices"])
    print(f"  path_vertex_samples_per_sec B4 {t_b4['n_vertices'] / t_b4['wall_s']:.1f}, wavefront (phase 28) "
          f"{t_w['vps']:.1f}", flush=True)
    out["b4_instantiations"] = {"sphere_room": {
        "mode": mode, "ms": ms, "plain_ms": plain_ms, "n_vertices": nv16, "max_abs_err": err, "bound_ms": bound[0],
        "bound_by": bound[1], "blocks_per_sm": occ, **ptx}}
    out["sphere_room_b4"] = {"wall_s": t_b4["wall_s"], "n_vertices": t_b4["n_vertices"], "b4_launches": l_b4}

    # --- 30. the uber rows: B3 with a glossy uber sphere; uber_room and a
    # sphere lamp in area_box through the wavefronts; the lobe-set refusals ---
    gd = g.description
    mats = {id(p.material): HostMaterial(kind="uber", params=dict(p.material.params))
            for p in gd.primitives if p.material.kind == "plastic"}
    gu_desc = dataclasses.replace(gd, primitives=[dataclasses.replace(p, material=mats.get(id(p.material), p.material))
                                                  for p in gd.primitives])
    gu = compile_scene(gu_desc, dev)
    W, H, spp = gd.film.x_resolution, gd.film.y_resolution, gd.sampler.pixel_samples
    gicfg = {"kind": gd.integrator.kind, "max_depth": gd.integrator.max_depth,
             "rr_threshold": gd.integrator.rr_threshold, "strategy": gd.integrator.strategy,
             "light_strategy": gd.integrator.light_strategy}
    cam = make_camera(gd.camera, gd.film, dev)
    uconsts = megakernel.extract_consts(gu, cam, gicfg, {"kind": gd.sampler.kind, "spp": spp}, fcfg)
    if uconsts is None:
        raise AssertionError("the gallery with a glossy uber sphere is outside the brute megakernel's class")
    ublob = megakernel.pack_consts(uconsts).to(dev)
    umode = megakernel.kernel_mode(uconsts)
    idx = torch.arange(W * H, device=dev)
    glanes = (idx % W, idx // W, idx)
    b3_out = megakernel.megakernel_cuda(ublob, umode, *glanes, 0, COMPARE_SPP, SEED)
    _b3_against_plain(f"[30 B3 glossy uber gallery] {W}x{H} {COMPARE_SPP}spp", b3_out,
                      megakernel.megakernel_plain(uconsts, *glanes, 0, COMPARE_SPP, SEED))
    full = {k: ("const", v) for k, v in (("Kr", [0.3, 0.3, 0.3]), ("Kt", [0.3, 0.3, 0.3]), ("opacity", [0.7] * 3))}
    fu_desc = dataclasses.replace(gu_desc, primitives=[
        dataclasses.replace(p, material=HostMaterial(kind="uber", params={**p.material.params, **full}))
        if p.material.kind == "uber" else p for p in gu_desc.primitives])
    fu = compile_scene(fu_desc, dev)
    why_b3 = megakernel.explain_ineligible(fu, cam, gicfg, {"kind": gd.sampler.kind, "spp": spp}, fcfg)
    R_.make_persistent_fn(fu)
    tier_b3 = R_.LAST_PERSISTENT_TIER
    print(f"[30 B3 full uber gallery] route {tier_b3}; the brute megakernel refuses it: {why_b3}", flush=True)
    if tier_b3 != "torch-wavefront/cuda-brute" or "lobe set" not in (why_b3 or ""):
        raise AssertionError("the brute megakernel did not refuse the full uber gallery by lobe set")
    ub_host = compile_scene(scenes.uber_room(), "cpu")
    ub = ub_host.to(dev)
    ud = ub.description
    why_b4 = megakernel_wide.explain_ineligible_wide(
        ub, make_camera(ud.camera, ud.film, dev), icfg, {"kind": ud.sampler.kind, "spp": ud.sampler.pixel_samples},
        fcfg, megakernel_wide.DEFAULT_MAX_TRIS)
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        R_.make_persistent_fn(ub)
        tier_b4 = R_.LAST_PERSISTENT_TIER
        print(f"[30 uber_room] route with PBRT_TPU_WIDEMEGA=1: {tier_b4}; the wide megakernel refuses it: {why_b4}",
              flush=True)
        if tier_b4 != "torch-wavefront/cuda-wide-mixed" or "lobe set" not in (why_b4 or ""):
            raise AssertionError("the wide megakernel did not refuse uber_room by lobe set")
        _check_crop("30 cuda-vs-cpu uber_room crop", ub, ub_host, ud, LATE_SPP[1])
    lamp_host = compile_scene(scenes.area_box(sphere_lamp=True), "cpu")
    lamp = lamp_host.to(dev)
    R_.make_persistent_fn(lamp)
    print(f"[30 area_box with a sphere lamp] {lamp.static.n_lights} lights, cone sphere lights "
          f"{lamp.static.has_cone_sphere_lights}, route {R_.LAST_PERSISTENT_TIER}", flush=True)
    if R_.LAST_PERSISTENT_TIER != "torch-wavefront/cuda-brute" or not lamp.static.has_cone_sphere_lights:
        raise AssertionError("area_box with a sphere lamp did not take the brute wavefront")
    _check_crop("30 cuda-vs-cpu area_box sphere lamp crop", lamp, lamp_host, lamp.description, LATE_SPP[1])
    out["uber"] = {"b3_refusal": why_b3, "b4_refusal": why_b4}


def _same_sub_rows(cs):
    """cs with each mix row's second sub-row pointed at its first (the
    P_EXTRA slot of mat_const): the hit's hashed choice then picks the same
    lobes either way, and the image no longer depends on it."""
    from pbrt_tpu_torch.scene.arrays import MAT_MIX, P_EXTRA
    from pbrt_tpu_torch.scene.builder import CompiledScene

    const = cs.arrays.mat_const.clone()
    mix = cs.arrays.mat_kind == MAT_MIX
    const[mix, P_EXTRA, 1] = const[mix, P_EXTRA, 0]
    return CompiledScene(dataclasses.replace(cs.arrays, mat_const=const), cs.static, cs.description)


def _hit_shares(cs) -> dict:
    """Share of the main path's camera rays that end on each material kind
    (a mix's row counted as mix), and on none."""
    import torch

    from pbrt_tpu_torch.device.intersect import intersect
    from pbrt_tpu_torch.scene.arrays import MAT_IDS

    names = {v: k for k, v in MAT_IDS.items()}
    _name, o, d, t_max = _rays(cs)[0]
    prim = intersect(cs.arrays, cs.static, o, d, t_max, sort_rays=True)["prim"]
    kind = torch.where(prim >= 0, cs.arrays.mat_kind[cs.arrays.prim_mat[prim.clamp(min=0)]], -1)
    counts = torch.bincount(kind + 1, minlength=16).tolist()
    return {("miss" if k == 0 else names[k - 1]): c / prim.numel() for k, c in enumerate(counts) if c}


def _material_phases(out, work, m, b4_ms):
    """Phases 31-33: the surface materials the wavefront renders and the
    megakernels refuse (substrate, translucent, disney, mix, fourier,
    hair), in zoo_room at two sizes and from a file; the translucent rows
    that B4 bakes as plastic."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import megakernel, megakernel_wide, wide_bvh
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scene.host import HostMaterial

    dev = torch.device("cuda", 0)
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
    tables = work / "tables"

    # --- 31-32. zoo_room through the wavefront at n_side 40 and 248 ---
    rooms = {}
    for n_side in (40, 248):
        label = f"{31 if n_side == 40 else 32} zoo_room({n_side})"
        t0 = time.perf_counter()
        if n_side == 248:  # compiled by phase 2's workers
            host, host_s = _host_scene("zoo_room")
        else:
            host = compile_scene(scenes.zoo_room(n_side, table_dir=str(tables)), "cpu")
            host_s = time.perf_counter() - t0
        z = host.to(dev)
        timing, b1, _img = _main_path(f"{label} main path", z, "torch-wavefront/cuda-wide", wide_bvh.traverse_cuda,
                                      LATE_MAIN_SPP)
        n_k, n_it = _kernels_per_iteration(z, LATE_SPP[0])
        shares = _hit_shares(z)
        print(f"  {z.static.n_tris} triangles, {z.static.n_materials} material rows, Fourier tables "
              f"{_nbytes(*z.arrays.fourier.values())} bytes, host compile {host_s:.2f}s; crop under the profiler: "
              f"{n_k} device kernels over {n_it} wavefront iterations ({n_k / max(n_it, 1):.1f} per iteration); "
              f"camera rays ending on each kind {json.dumps({k: round(v, 4) for k, v in shares.items()})}",
              flush=True)
        q_ms = _query_against_twin(label, z)
        rooms[n_side] = (z, host)
        out[f"zoo_room_{n_side}"] = {
            "wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
            "n_vertices": timing["n_vertices"], "b1_launches": b1, "kernels_per_iteration": n_k / max(n_it, 1),
            "camera_hit_shares": shares, "camera_query_ms": q_ms, "host_compile_s": host_s}
        if n_side == 40:
            th = compile_scene(scenes.zoo_room(n_side, textured=True, table_dir=str(tables)), "cpu")
            for name, g_, c_ in (("", z, host), (" textured", th.to(dev), th)):
                _check_crop(f"{label}{name} cuda-vs-cpu crop, the mix's sub-rows the same", _same_sub_rows(g_),
                            _same_sub_rows(c_), c_.description, LATE_SPP[1])
                _check_crop(f"{label}{name} cuda-vs-cpu crop as built", g_, c_, c_.description, LATE_SPP[1],
                            estimate=True)

    # --- 33. zoo_room as a file; the megakernels' gates ---
    z, host = rooms[40]
    path = work / "zoo_room.pbrt"
    scenes.write_pbrt(host.description, str(path), scenes.ROOM_LOOK_AT)
    _reset_launches()
    cli.main([str(path), "--outfile", str(work / "zoo_room.exr"), "--quiet", "--seed", str(SEED), "--spp",
              str(CROP_SPP), "--cropwindow", "0.468", "0.532", "0.468", "0.532"])
    b1 = wide_bvh.traverse_cuda.launches
    run = cli.main.last_run
    parsed = run["scene"].description
    bad = _tables_equal(run["scene"].arrays, host.arrays)
    hand = R_.render_compiled(_with_desc(z, dataclasses.replace(
        z.description, film=dataclasses.replace(z.description.film, crop_window=parsed.film.crop_window))),
        seed=SEED, spp=CROP_SPP)
    f_img = run["image"]
    equal = f_img.shape == hand.shape and bool(np.array_equal(f_img, hand))
    print(f"[33 zoo_room file] {path.name} (MakeNamedMaterial for the mix, bsdffile beside it): parse + API "
          f"{run['parse_s']:.4f}s, compile_scene {run['compile_s']:.4f}s, route {run['timing']['tier']}, B1 "
          f"launches {b1}; tables differing from the hand-built scene's: {bad or 'none'}; crop {f_img.shape} at "
          f"{CROP_SPP} spp bit-equal to the hand-built scene's: {equal}", flush=True)
    if bad or run["scene"].static != host.static:
        raise AssertionError(f"the zoo_room file compiles to other tables: {bad}")
    if not equal or b1 <= 0 or not f_img.any():
        raise AssertionError("the zoo_room file renders another image than the hand-built scene")
    d = z.description
    icfg = {"kind": "path", "max_depth": d.integrator.max_depth, "rr_threshold": d.integrator.rr_threshold,
            "light_strategy": d.integrator.light_strategy, "strategy": d.integrator.strategy}
    scfg = {"kind": d.sampler.kind, "spp": d.sampler.pixel_samples}
    cam = make_camera(d.camera, d.film, dev)
    # past the triangle cap (zoo_room has 7,952), to the materials
    why_b4 = megakernel_wide.explain_ineligible_wide(z, cam, icfg, scfg, fcfg, 200_000)
    why_b3 = megakernel.explain_ineligible(z, cam, icfg, scfg, fcfg)
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        R_.make_persistent_fn(z)
        tier = R_.LAST_PERSISTENT_TIER
    refusals = {}
    for kind in ("substrate", "disney", "fourier", "hair"):  # one at a time, on material_room's floor
        md = m.description
        mat = next(p.material for p in d.primitives if p.material.kind == kind)
        one = compile_scene(dataclasses.replace(md, primitives=[dataclasses.replace(md.primitives[0], material=mat)]
                                                + md.primitives[1:]), dev)
        refusals[kind] = megakernel_wide.explain_ineligible_wide(one, cam, icfg, scfg, fcfg,
                                                                 megakernel_wide.DEFAULT_MAX_TRIS)
    print(f"[33 refusals] zoo_room with PBRT_TPU_WIDEMEGA=1 takes {tier}; B4 (cap 200,000): {why_b4}; B3: "
          f"{why_b3}; B4 on "
          f"material_room with each kind on its floor: {json.dumps(refusals)}", flush=True)
    if tier != "torch-wavefront/cuda-wide" or "mix materials" not in (why_b4 or "") or not why_b3:
        raise AssertionError("the megakernels did not refuse zoo_room by name")
    if not all("lobe set" in (r or "") for r in refusals.values()):
        raise AssertionError("the wide megakernel did not refuse a new material by lobe set")

    # B4 on material_room with its back wall translucent without
    # transmission: the lobe set [LAMBERT_R, MICRO_R], baked as plastic
    md = m.description
    back = md.primitives[1]
    tl = HostMaterial(kind="translucent", params={"Kd": ("const", np.array([0.6, 0.55, 0.5])),
                                                  "Ks": ("const", np.array([0.3, 0.3, 0.3])),
                                                  "transmit": ("const", np.zeros(3))})
    t_host = compile_scene(dataclasses.replace(
        md, primitives=[md.primitives[0], dataclasses.replace(back, material=tl)] + md.primitives[2:]), "cpu")
    t = t_host.to(dev)
    W, H, spp = md.film.x_resolution, md.film.y_resolution, md.sampler.pixel_samples
    consts = megakernel_wide.extract_wide_consts(t, make_camera(md.camera, md.film, dev), icfg,
                                                 {"kind": md.sampler.kind, "spp": spp}, fcfg,
                                                 megakernel_wide.DEFAULT_MAX_TRIS)
    tl_row = int((t.arrays.mat_kind == 8).nonzero()[0].item())
    if consts is None or consts["mats"][tl_row]["lobe"] != megakernel.LOBE_PLASTIC:
        raise AssertionError("the wide megakernel did not bake the translucent wall as plastic")
    blob = megakernel_wide.pack_wide_consts(consts).to(dev)
    mode = megakernel_wide.kernel_mode(consts)
    idx = torch.arange(W * H, device=dev)
    lanes = (idx % W, idx // W, idx)
    out_k = megakernel_wide.wide_megakernel_cuda(blob, mode, t.arrays, *lanes, 0, COMPARE_SPP, SEED)
    out_p = megakernel_wide.wide_megakernel_plain(consts, t.arrays, *lanes, 0, COMPARE_SPP, SEED)
    ok, desc_cmp = _wide_tolerance(*out_k, *out_p)
    ms = _cuda_ms(lambda: megakernel_wide.wide_megakernel_cuda(blob, mode, t.arrays, *lanes, 0, spp, SEED), 3)
    nv16 = megakernel_wide.wide_megakernel_cuda(blob, mode, t.arrays, *lanes, 0, spp, SEED)[2].double().sum().item()
    print(f"[33 B4 translucent wall] material_room, back wall translucent (transmit 0, row {tl_row}, baked "
          f"{consts['mats'][tl_row]['lobe']} = plastic), mode {mode}, {W}x{H} {COMPARE_SPP}spp "
          f"against the twin: {desc_cmp}; {spp}spp kernel {ms:.4f} ms (phase 11's {b4_ms:.4f} ms), "
          f"{nv16:.0f} path vertices", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and its twin disagree on the translucent wall")
    timing, _b1, _img = _main_path("33 translucent-wall material_room through the wavefront", t,
                                   "torch-wavefront/cuda-wide", wide_bvh.traverse_cuda)
    _total_within("33 translucent-wall wavefront against B4", timing["n_vertices"], nv16)
    out["zoo_room_file"] = {"compile_s": run["compile_s"], "parse_s": run["parse_s"], "bit_equal": equal}
    out["refusals"] = {"b4": why_b4, "b3": why_b3, **refusals}
    out["b4_instantiations"] = {"translucent_wall": {"mode": mode, "ms": ms, "n_vertices": nv16,
                                                     "max_abs_err": (out_k[0] - out_p[0]).abs().max().item()}}


# the BVH and kd walks (bvh_walk.cu): float32 operations per unit of work,
# counted from its source as a lower bound: one node's slab test per pop,
# one watertight triangle test, one EFloat quadric test (the intervals of
# the coefficients, the quadratic and both roots' clips with their atan2),
# one instance transform of the ray (two 3x4 transforms and the shear setup)
BW_OPS_POP = 20
BW_OPS_TRI = 45
BW_OPS_QUADRIC = 300
BW_OPS_INSTANCE = 40
# the kd walk's interior node (kd_walk_kernel's interior branch): the split
# plane's t (a subtract and a multiply) and six compares (which side the
# origin lies on: three; the plane against the interval: three); a leaf's
# visit does no node work (its prim tests are counted by kind)
KD_OPS_NODE = 8


def _warp_share(work):
    """The share of lanes holding a ray in a grid of one thread per ray,
    from each ray's loop iterations `work` (R,): their sum over 32 x the
    sum of each warp's (32 consecutive rays') most, since a warp loops as
    often as its longest walk."""
    import torch

    work = work.double()
    n32 = -(-work.numel() // 32) * 32
    per_warp = torch.nn.functional.pad(work, (0, n32 - work.numel())).view(-1, 32).max(1).values
    return float(work.sum()) / max(32.0 * float(per_warp.sum()), 1.0)


def _bvh_lanes(walk, sa, st, o, d, t_max, any_hit, **extra):
    """The BVH walk's share of lanes holding a ray on one ray set, from
    the node visits (a thread's loop iterations) its instrumented entry
    counts in one measurement launch (_warp_share). Returns (the share,
    visits per ray)."""
    import torch

    dev = o.device
    tests = torch.empty((o.shape[0], 4), dtype=torch.int32, device=dev)
    seen = tuple(torch.zeros(n, dtype=torch.int32, device=dev)
                 for n in (sa.bvh_packed.shape[0], sa.prim_test_data.shape[0], sa.inst_w2i.shape[0]))
    walk(sa, st, o, d, t_max, any_hit, prim_tests=tests, rows_read=seen, **extra)
    walk.launches -= 1  # a measurement launch, not the main path's
    visits = tests[:, 3]
    return _warp_share(visits), float(visits.double().sum()) / o.shape[0]


def _walk_against_twin(label, cs, walk_k, walk_p):
    """Phase 34: the walk kernel (walk_k) against its plain twin (walk_p)
    on the main path's camera, bounce and shadow rays, closest and any hit:
    hits equal, prim equal wherever the two t are not tied, t bit-equal
    where the prims agree, on every eighth ray (each ray walks alone in
    both, so the kernel's launch over the whole set is compared on that
    subset; the twin's lockstep loop costs seconds per set). Prints per set
    the kernel's time over the whole set (CUDA events) and per ray, pops
    per ray (the BVH walk's: boxes tested) and the share of lanes holding
    a ray (both walks run one thread per ray in a fixed grid, and a warp
    loops as often as its longest walk: _warp_share of the BVH walk's node
    visits, _bvh_lanes, and of the kd walk's pops). Returns ({set/query: {...}},
    max |dt|, the ray sets)."""
    import torch

    from pbrt_tpu_torch.device import bvh_walk

    sa, st = cs.arrays, cs.static
    rows, max_err = {}, 0.0
    ray_sets = _rays(cs)
    for name, o, d, t_max in ray_sets:
        for any_hit in (False, True):
            q = f"{name}/{'any' if any_hit else 'closest'}"
            res_all = walk_k(sa, st, o, d, t_max, any_hit)
            res_k = [x[::8] for x in res_all]
            t_twin = time.perf_counter()
            res_p = walk_p(sa, st, o[::8].contiguous(), d[::8].contiguous(), t_max[::8].contiguous(), any_hit)
            t_twin = time.perf_counter() - t_twin
            t_k, p_k, t_p, p_p = res_k[0], res_k[1].long(), res_p[0], res_p[1].long()
            hk, hp = p_k >= 0, p_p >= 0
            both = hk & hp
            same = both & (p_k == p_p)
            tied = both & (p_k != p_p) & (t_k == t_p)
            ulp = torch.abs(t_k.view(torch.int32).long() - t_p.view(torch.int32).long())
            bad_prim = int((both & (p_k != p_p) & ~tied).sum())
            bad_t = int((same & (ulp > 0)).sum())
            dt = float((t_k - t_p).abs()[both].max()) if bool(both.any()) else 0.0
            max_err = max(max_err, dt)
            pops = res_all[4].double()
            if walk_k is bvh_walk.bvh_walk_cuda:
                share, visits = _bvh_lanes(walk_k, sa, st, o, d, t_max, any_hit)
            else:
                share, visits = _warp_share(pops), None
            ms = _cuda_ms(lambda: walk_k(sa, st, o, d, t_max, any_hit), 5)
            rows[q] = {"rays": o.shape[0], "compared": int(hk.numel()), "hit": float(hk.float().mean()), "ms": ms,
                       "ns_per_ray": 1e6 * ms / o.shape[0], "pops_per_ray": float(pops.mean()),
                       "visits_per_ray": visits, "lanes_with_a_ray": share, "hit_disagree": int((hk != hp).sum()),
                       "prim_disagree": bad_prim, "tied": int(tied.sum()), "t_differing": bad_t, "max_dt": dt,
                       "twin_s": t_twin}
            print(f"  {label} {q}: {json.dumps(rows[q])}", flush=True)
            if rows[q]["hit_disagree"] or bad_prim or bad_t or res_p[5]:
                raise AssertionError(f"the walk kernel and its twin disagree on {label} {q}")
    return rows, max_err, ray_sets


def _walk_bound(label, cs, o, d, t_max, tm=None, res_main=None):
    """Phases 34 and 43: the BVH walk's bound on one ray set from its
    instrumented entry (the pops, the prim tests by kind and the table rows
    this run's walk read): the larger of the bytes (rays in; of the tables,
    each row the walk read once, and of it only what it reads: a node's
    box, 24 bytes, its offset and count, 8, its axis, 4; a prim's kind and
    instance id, 8, and its row's 9 floats of a triangle or 19 (25 with
    the twisted hyperboloid's columns) of a quadric; an instance's 12
    floats; t, prim, b1, b2, pops out) over the HBM rate and the operations
    over the float32 rate. With the rays' shutter fractions tm, the motion
    entry's (its paths must be res_main's): the times in, per prim row read
    its group id and compose constant (52 bytes), every group row once,
    and per candidate test the motion evaluation (BW_OPS_ANIM*). Returns
    (bound_ms, bound_by, the counts)."""
    import torch

    from pbrt_tpu_torch.device import bvh_walk

    sa, st = cs.arrays, cs.static
    dev = o.device
    tests = torch.empty((o.shape[0], 4), dtype=torch.int32, device=dev)
    seen = tuple(torch.zeros(n, dtype=torch.int32, device=dev)
                 for n in (sa.bvh_packed.shape[0], sa.prim_test_data.shape[0], sa.inst_w2i.shape[0]))
    walk = bvh_walk.bvh_walk_cuda if tm is None else bvh_walk.bvh_walk_motion_cuda
    extra = {} if tm is None else {"time": tm}
    res = walk(sa, st, o, d, t_max, False, prim_tests=tests, rows_read=seen, **extra)
    walk.launches -= 1  # a measurement launch, not the main path's
    if res_main is not None and not all(torch.equal(x, y) for x, y in zip(res, res_main)):
        raise AssertionError(f"{label}: the instrumented entry walked other paths")
    tri, quad, inst, visits = (float(x) for x in tests.double().sum(0))
    pops = float(res[4].double().sum())
    nodes, prims, insts = seen
    node_bytes = sum(w * int(((nodes & bit) != 0).sum()) for bit, w in ((1, 24), (2, 8), (4, 4)))
    read = prims != 0
    is_tri = sa.prim_kind == 0
    quad_floats = 25 if sa.prim_test_data.shape[1] >= 25 else 19
    prim_bytes = (8 * int(read.sum()) + 4 * 9 * int((read & is_tri).sum())
                  + 4 * quad_floats * int((read & ~is_tri).sum()))
    inst_bytes = 48 * int(insts.sum())
    n_bytes = _nbytes(o, d, t_max, *res[:5]) + node_bytes + prim_bytes + inst_bytes
    ops = pops * BW_OPS_POP + tri * BW_OPS_TRI + quad * BW_OPS_QUADRIC + inst * BW_OPS_INSTANCE
    if tm is not None:
        n_bytes += _nbytes(tm, sa.anim_rec) + 52 * int(read.sum())
        ops += tri * (BW_OPS_ANIM + BW_OPS_ANIM_TRI) + quad * (BW_OPS_ANIM + BW_OPS_ANIM_QUADRIC)
    b = _bound(n_bytes, ops)
    counts = {"pops": pops, "visits": visits, "triangle_tests": tri, "quadric_tests": quad, "instanced_tests": inst,
              "nodes_read": int((nodes != 0).sum()), "prim_rows_read": int(read.sum()),
              "instances_read": int(insts.sum()), "table_bytes_read": node_bytes + prim_bytes + inst_bytes,
              "table_bytes": _nbytes(sa.bvh_packed, sa.prim_test_data, sa.prim_kind, sa.prim_inst, sa.inst_w2i),
              "bytes": n_bytes, "ops": ops}
    print(f"  {label} bound {b[0]:.4f} ms ({b[1]}): {json.dumps(counts)}", flush=True)
    return b[0], b[1], counts


# the keyframe motion walk (MOTION 1): float32 operations per float of a
# candidate's row moved to the ray's time, the lerp toward its
# shutter-close row and, with a mid-shutter row, the arc term
BW_OPS_KEYFRAME = 3
BW_OPS_KEYFRAME_MID = 7


def _kd_walk_bound(label, cs, o, d, t_max, res_main, tm=None):
    """Phases 34 and 43: the kd walk's bound on one ray set, by
    _walk_bound's formula from the work its twin counts on the same rays
    (it must walk res_main's paths; _kd_bound_of). Returns (bound_ms,
    bound_by, the counts, with "twin_ms": that twin run's milliseconds by
    the host clock, its counting included)."""
    import torch

    from pbrt_tpu_torch.device import bvh_walk

    counts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bvh_walk.kd_walk_plain(cs.arrays, cs.static, o, d, t_max, False, counts=counts,
                                 **({} if tm is None else {"time": tm}))
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.perf_counter() - t0)
    if not all(torch.equal(x, y.to(x.dtype)) for x, y in zip(res_main[:5], res[:5])):
        raise AssertionError(f"{label}: the counting twin walked other paths")
    b = _kd_bound_of(label, cs, o, d, t_max, res_main, res, counts, tm)
    b[2]["twin_ms"] = twin_ms
    return b


def _kd_bound_of(label, cs, o, d, t_max, res_main, res, counts, tm=None):
    """The kd walk's bound from its twin's result res and counts on the
    rays: a split plane in place of a box, the interior visits (each
    KD_OPS_NODE; a leaf's visit does no node work) and the prim tests by
    kind in the operations; the rays in, the outputs and, of the tables,
    each row the walk read once: a node's flag, split, child and count (16
    bytes), a leaf's prim id (4), a prim's kind (4) and its row's 9 floats
    of a triangle or 19 (25) of a quadric, and the tree's bounds (24). With
    the rays' shutter fractions tm, the motion entry's: the times in, and
    per candidate test the motion evaluation, MOTION 2's group M(dt) and
    compose (BW_OPS_ANIM*; per prim row read its group id and compose
    constant, 52 bytes, and every group row once) or MOTION 1's keyframe
    rows (BW_OPS_KEYFRAME* per float; the shutter-close and mid rows read).
    Returns (bound_ms, bound_by, the counts)."""
    from pbrt_tpu_torch.device import bvh_walk

    sa, st = cs.arrays, cs.static
    pops = float(res[4].double().sum())
    interior, leaves = float(counts["interior_visits"]), float(counts["leaf_visits"])
    if interior + leaves != pops:
        raise AssertionError(f"{label}: the twin's visits do not sum to its pops")
    tri, quad = float(counts["triangle_tests"]), float(counts["quadric_tests"])
    read = counts["prims"]
    is_tri = sa.prim_kind == 0
    quad_floats = 25 if sa.prim_test_data.shape[1] >= 25 else 19
    n_tri_rows, n_quad_rows = int((read & is_tri).sum()), int((read & ~is_tri).sum())
    table_bytes = (16 * int(counts["nodes"].sum()) + 4 * int(counts["prim_ids"].sum()) + 4 * int(read.sum())
                   + 36 * n_tri_rows + 4 * quad_floats * n_quad_rows + 24)
    n_bytes = _nbytes(o, d, t_max, *res_main[:5]) + table_bytes
    ops = interior * KD_OPS_NODE + tri * BW_OPS_TRI + quad * BW_OPS_QUADRIC
    if tm is not None and bvh_walk.motion_kind(st) == 2:
        n_bytes += _nbytes(tm, sa.anim_rec) + 52 * int(read.sum())
        ops += tri * (BW_OPS_ANIM + BW_OPS_ANIM_TRI) + quad * (BW_OPS_ANIM + BW_OPS_ANIM_QUADRIC)
    elif tm is not None:
        keyframes = 1 if sa.prim_test_data_mid is None else 2
        n_bytes += _nbytes(tm) + keyframes * (36 * n_tri_rows + 48 * n_quad_rows)
        per_float = BW_OPS_KEYFRAME + (keyframes - 1) * BW_OPS_KEYFRAME_MID
        ops += per_float * (9 * tri + 12 * quad)
    b = _bound(n_bytes, ops)
    out = {"pops": pops, "interior_visits": interior, "leaf_visits": leaves, "triangle_tests": tri,
           "quadric_tests": quad, "nodes_read": int(counts["nodes"].sum()),
           "prim_ids_read": int(counts["prim_ids"].sum()), "prim_rows_read": int(read.sum()),
           "table_bytes_read": table_bytes, "bytes": n_bytes, "ops": ops}
    print(f"  {label} bound {b[0]:.4f} ms ({b[1]}): {json.dumps(out)}", flush=True)
    return b[0], b[1], out


def _without_raw_quadrics(cs):
    """cs with the cones, paraboloids and hyperboloids made never to be hit
    (their prim_test_data rows a disk of radius 0 inside an inner radius
    of 1), every other table shared: the quadrics whose hit points the
    reference does not re-project (phase 35)."""
    ptd = cs.arrays.prim_test_data.clone()
    raw = (cs.arrays.prim_kind == 1) & (ptd[:, 18] >= 3)
    ptd[raw, 18] = 2.0
    ptd[raw, 12] = 0.0
    ptd[raw, 14] = 1.0
    return dataclasses.replace(cs, arrays=dataclasses.replace(cs.arrays, prim_test_data=ptd))


def _walk_phases(out, work):
    """Phases 34-37: the rest of the persistent wavefront's class (quadrics,
    instancing, the kd-tree, alpha cutouts, goniometric and projection
    lights, orthographic and environment cameras) and the walk kernel
    that serves the scenes the wide tables do not."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import bvh_walk, megakernel, megakernel_wide, wide_bvh
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.scene.builder import compile_scene

    dev = torch.device("cuda", 0)
    seconds = out["seconds"] = {}
    t_phase = time.perf_counter()
    # --- 34. the walk kernel against its twin ---
    info = bvh_walk.build_kernel()
    entries = _walk_entries(info)
    print(f"[34 bvh_walk build] {Path(info['path']).name}; per entry (template; registers, spill stores/loads, "
          f"stack frame, blocks of 128 per SM): "
          + ("; ".join(f"{r['kernel']}{r['template']} {r['registers']}, {r['spill_stores']}/{r['spill_loads']}, "
                       f"{r['stack_frame']}, {r['blocks_per_sm']}" for r in entries) or "n/a (built before this run)"),
          flush=True)
    out["entries"] = entries
    scenes_34 = {}
    for key in ("bvh", "kdtree"):
        t0 = time.perf_counter()
        if key == "bvh":
            host, host_s = _host_scene("quadric_room")
        else:
            host = compile_scene(scenes.quadric_room(40, instances=False, accelerator="kdtree"), "cpu")
            host_s = time.perf_counter() - t0
        q = host.to(dev)
        scenes_34[key] = (q, host)
        st = q.static
        print(f"[34 scene] quadric_room {key}: {st.n_prims} prims ({st.n_tris} triangle rows, {st.n_spheres} "
              f"quadrics, {q.arrays.inst_i2w.shape[0] - 1} instances), {st.n_lights} lights, host compile "
              f"{host_s:.1f}s, tables {q.arrays.byte_size()} bytes", flush=True)
        walk_k = bvh_walk.kd_walk_cuda if key == "kdtree" else bvh_walk.bvh_walk_cuda
        walk_p = bvh_walk.kd_walk_plain if key == "kdtree" else bvh_walk.walk_plain
        rows, err, ray_sets = _walk_against_twin(f"34 {key}", q, walk_k, walk_p)
        counters = walk_k.counters[dev].tolist()
        if counters != [0, 0]:
            raise AssertionError(f"walk stack overflows / iteration-cap hits: {counters}")
        entry = {"host_compile_s": host_s, "queries": rows, "max_abs_err": err}
        if key == "bvh":
            _n, o, d_, t_max = ray_sets[0]
            # the twin once, by the host clock around a call ending in a synchronize
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bvh_walk.walk_plain(q.arrays, st, o, d_, t_max, False)
            torch.cuda.synchronize()
            entry["plain_ms"] = 1e3 * (time.perf_counter() - t0)
            entry["bound_ms"], entry["bound_by"], entry["counts"] = _walk_bound("34 bvh camera/closest", q, o, d_,
                                                                                t_max)
            entry["ms"] = rows["camera/closest"]["ms"]
            b1_per_ray = 0.3715 / 500_000  # phase 3's B1 camera/closest on the mesh room (PERF.md)
            print(f"  camera/closest: {entry['ms']:.4f} ms for {o.shape[0]} rays ({1e6 * entry['ms'] / o.shape[0]:.3f}"
                  f" ns per ray; B1 on the mesh room {1e6 * b1_per_ray:.3f}), plain twin {entry['plain_ms']:.2f} ms, "
                  f"at {100 * entry['bound_ms'] / entry['ms']:.2f}% of the bound", flush=True)
        else:
            # the kd walk's bound on its camera rays, from its twin's counts
            _n, o, d_, t_max = ray_sets[0]
            entry["ms"] = rows["camera/closest"]["ms"]
            entry["bound_ms"], entry["bound_by"], entry["counts"] = _kd_walk_bound(
                "34 kdtree camera/closest", q, o, d_, t_max, walk_k(q.arrays, st, o, d_, t_max, False))
            walk_k.launches -= 1  # a measurement launch, not the main path's
            entry["plain_ms"] = entry["counts"]["twin_ms"]
            print(f"  kd camera/closest: {entry['ms']:.4f} ms for {o.shape[0]} rays, plain twin (counting) "
                  f"{entry['plain_ms']:.2f} ms, tree depth {st.kd_depth} (stack {bvh_walk.KD_STACK}), at "
                  f"{100 * entry['bound_ms'] / entry['ms']:.2f}% of the bound", flush=True)
        out[f"walk_{key}"] = entry

    seconds["34"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 35. quadric_room through the wavefront, BVH then kd ---
    for key, tier in (("bvh", "torch-wavefront/cuda-bvh"), ("kdtree", "torch-wavefront/cuda-kdtree")):
        q, host = scenes_34[key]
        walk_k = bvh_walk.kd_walk_cuda if key == "kdtree" else bvh_walk.bvh_walk_cuda
        timing, launches, _img = _main_path(f"35 quadric_room {key} main path", q, tier, walk_k, LATE_MAIN_SPP)
        n_k, n_it = _kernels_per_iteration(q, LATE_SPP[0])
        print(f"  crop under the profiler: {n_k} device kernels over {n_it} wavefront iterations "
              f"({n_k / max(n_it, 1):.1f} per iteration); walk launches in the render {launches}", flush=True)
        # the crop without the cones', paraboloids' and hyperboloids' hits
        # meets phase 5's rule; the crop as built, 99% of its pixels must
        # (their hit points are not re-projected onto the surface, as in
        # the reference, so an origin offset by the devices' different ulps
        # (sums of squares in another order on the card) can re-hit the
        # surface on one device and not the other: a few paths part, and a
        # parted path can carry a bright light's sample, which moves the
        # crop's sum by a percent)
        # (the cpu crops rendered by phase 2's workers, from the same scene
        # compiled there)
        crops = _CPU_CROPS[{"bvh": "quadric_room", "kdtree": "quadric_room_kd"}[key]].result()
        _check_crop(f"35 quadric_room {key} cuda-vs-cpu crop, no cone, paraboloid or hyperboloid hits",
                    _without_raw_quadrics(q), None, host.description, LATE_SPP[0], cpu=crops["no_raw"])
        _check_crop(f"35 quadric_room {key} cuda-vs-cpu crop as built", q, None, host.description, LATE_SPP[0],
                    estimate="pixels", cpu=crops["built"])
        out[f"quadric_room_{key}"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                                      "n_vertices": timing["n_vertices"], "walk_launches": launches,
                                      "kernels_per_iteration": n_k / max(n_it, 1)}

    seconds["35"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 36. the camera scenes through B1; the megakernels' named refusals ---
    for kind in ("orthographic", "environment"):
        host = compile_scene(scenes.camera_room(kind), "cpu")
        c = host.to(dev)
        timing, b1, _img = _main_path(f"36 {kind} camera_room main path", c, "torch-wavefront/cuda-wide",
                                      wide_bvh.traverse_cuda, LATE_MAIN_SPP)
        _check_crop(f"36 {kind} cuda-vs-cpu crop", c, host, host.description, LATE_SPP[0])
        out[f"camera_{kind}"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                                 "b1_launches": b1, "has_alpha": c.static.has_alpha}
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
    refusals = {}
    q_bvh, q_kd = scenes_34["bvh"][1], scenes_34["kdtree"][1]
    for name, host in (("orthographic", compile_scene(scenes.camera_room("orthographic", 4), "cpu")),
                       ("environment", compile_scene(scenes.camera_room("environment", 4), "cpu")),
                       ("quadric_room", q_bvh), ("quadric_room kd", q_kd)):
        d = host.description
        cam = make_camera(d.camera, d.film, "cpu")
        icfg = {"kind": "path", "max_depth": d.integrator.max_depth, "rr_threshold": d.integrator.rr_threshold,
                "light_strategy": d.integrator.light_strategy, "strategy": d.integrator.strategy}
        scfg = {"kind": d.sampler.kind, "spp": d.sampler.pixel_samples}
        refusals[name] = {"b3": megakernel.explain_ineligible(host, cam, icfg, scfg, fcfg),
                          "b4": megakernel_wide.explain_ineligible_wide(host, cam, icfg, scfg, fcfg, 400_000)}
    print(f"[36 refusals] {json.dumps(refusals)}", flush=True)
    if refusals["orthographic"] != {"b3": "'orthographic' cameras", "b4": "'orthographic' cameras"} or \
            refusals["environment"]["b4"] != "'environment' cameras" or \
            refusals["quadric_room"]["b4"] != "goniometric lights":
        raise AssertionError("the megakernels did not refuse the new kinds by name")
    out["refusals"] = refusals

    seconds["36"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 37. quadric_room as a file, through the front end ---
    desc = scenes.quadric_room(8, accelerator="kdtree", prop_res=8)
    desc.camera = scenes.camera_room("orthographic").camera
    host = compile_scene(desc, "cpu")
    path = work / "quadric_room.pbrt"
    scenes.write_pbrt(desc, str(path), scenes.ROOM_LOOK_AT)
    text = path.read_text()
    directives = [w for w in ('Shape "cylinder"', 'Shape "disk"', 'Shape "cone"', 'Shape "paraboloid"',
                              'Shape "hyperboloid"', "ObjectBegin", "ObjectInstance", '"texture alpha"',
                              'LightSource "goniometric"', 'LightSource "projection"', 'Accelerator "kdtree"',
                              'Camera "orthographic"') if w in text]
    sub = subprocess.Popen([sys.executable, "-m", "pbrt_tpu_torch", str(path), "--outfile", str(work / "cli.exr"),
                            "--quiet", "--spp", "1", "--cropwindow", "0.468", "0.532", "0.468", "0.532"],
                           cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    _reset_launches()
    cli.main([str(path), "--outfile", str(work / "quadric_room.exr"), "--quiet", "--seed", str(SEED), "--spp",
              str(CROP_SPP), "--cropwindow", "0.468", "0.532", "0.468", "0.532"])
    walks = bvh_walk.bvh_walk_cuda.launches + bvh_walk.kd_walk_cuda.launches
    run = cli.main.last_run
    parsed = run["scene"].description
    bad = _tables_equal(run["scene"].arrays, host.arrays)
    g = host.to(dev)
    hand = R_.render_compiled(_with_desc(g, dataclasses.replace(
        desc, film=dataclasses.replace(desc.film, crop_window=parsed.film.crop_window))), seed=SEED, spp=CROP_SPP)
    f_img = run["image"]
    equal = f_img.shape == hand.shape and bool(np.array_equal(f_img, hand))
    log, _ = sub.communicate(timeout=600)
    print(f"[37 quadric_room file] {path.name} ({len(text)} bytes; writes {directives}): route "
          f"{run['timing']['tier']}, walk launches {walks}; tables differing from the hand-built scene's: "
          f"{bad or 'none'}; crop {f_img.shape} at {CROP_SPP} spp bit-equal to the hand-built scene's: {equal}; "
          f"python -m pbrt_tpu_torch exit {sub.returncode}, wrote {(work / 'cli.exr').exists()}", flush=True)
    if len(directives) != 12:
        raise AssertionError("the quadric_room file lacks a directive of the class")
    if bad or run["scene"].static != host.static:
        raise AssertionError(f"the quadric_room file compiles to other tables: {bad}")
    if not equal or walks <= 0 or not f_img.any() or run["timing"]["tier"] != "torch-wavefront/cuda-bvh":
        raise AssertionError("the quadric_room file renders another image than the hand-built scene")
    if sub.returncode != 0 or not (work / "cli.exr").exists():
        raise AssertionError(f"python -m pbrt_tpu_torch failed on the quadric_room file:\n{log[-2000:]}")
    out["quadric_room_file"] = {"bytes": len(text), "compile_s": run["compile_s"], "bit_equal": equal}
    seconds["37"] = time.perf_counter() - t_phase


# medium_track.cu: float32 operations per tracking step, counted from its
# source as a lower bound: a delta step's two draws (3 each), the step
# (5, the log as one), the test against t_end, the point (6), the
# world -> grid transform (18), the voxel coordinates (18), the trilinear
# blend (21) and the collision test (2); a ratio step has one draw and the
# transmittance update (4) in place of the collision test
MT_OPS_DELTA = 6 + 5 + 1 + 6 + 18 + 18 + 21 + 2
MT_OPS_RATIO = 3 + 5 + 1 + 6 + 18 + 18 + 21 + 4
TRACK_RAYS = 500_000


def _track_rays(cs, n, seed=SEED):
    """scenes.fog_box_rays(n, seed) on cs's device in its grid medium: (med,
    o, d, t_end, key), float32 but for med and key (int64)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import scenes

    o, d, t_end, key = scenes.fog_box_rays(n, seed)
    dev = cs.arrays.device
    smoke = cs.static.media_kinds.index("heterogeneous")
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    return (torch.full((n,), smoke, dtype=torch.int64, device=dev), f32(o), f32(d), f32(t_end),
            torch.as_tensor(key, device=dev))


def _track_alone_ms(entry, sa, rays, reps=20) -> float:
    """medium_track's C entry `entry` alone, by CUDA events over reps
    launches on inputs and outputs prepared once (the wrapper's argument
    checks, key conversion and output allocations outside the timing)."""
    import torch

    from pbrt_tpu_torch.device import medium_track

    R, ins, tables, n_media = medium_track._inputs(sa, *rays)
    dev = ins[0].device
    outs = [torch.empty(R, dtype=torch.float32, device=dev)] + (
        [torch.empty(R, dtype=torch.bool, device=dev)] if entry == "delta_track" else []) + [
        torch.empty(R, dtype=torch.int32, device=dev)]
    fn = getattr(medium_track.build_kernel()["lib"], entry)
    args = [*(x.data_ptr() for x in ins), R, *(x.data_ptr() for x in tables), n_media,
            *(x.data_ptr() for x in outs), torch.cuda.current_stream(dev).cuda_stream]

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")

    return _cuda_ms(launch, reps)


# the share of a render's delta-tracking rays in the grid medium: fog_room's
# delta launches at 1000x500 (tools/torch_phases.py --scene fog_room, its
# grid-share pass: 2.6% on average, 4.3% at most, on an H100)
MIXED_GRID_SHARE = 0.026


def _mixed_track_rays(cs, rays, seed=SEED):
    """Phase 38's rays in one launch with the render's share of grid rays:
    MIXED_GRID_SHARE of them left in the grid medium, the rest alternately
    put in the homogeneous fog and in no medium, in a shuffled order. The
    grid rays keep phase 38's short chains (3.8 steps a ray), not the
    render's (38 a grid ray, the longest of a launch 135 on average): the
    render's own launches are replayed by tools/medium_track_variants.py."""
    import numpy as np
    import torch

    med, *rest = rays
    n = med.shape[0]
    n_grid = int(round(MIXED_GRID_SHARE * n))
    kinds = cs.static.media_kinds
    med = med.clone()
    med[n_grid::2] = kinds.index("homogeneous")
    med[n_grid + 1::2] = -1
    perm = torch.as_tensor(np.random.RandomState(seed).permutation(n), device=med.device)
    return [x[perm].contiguous() for x in (med, *rest)]


def _kernels_per_bounce(cs, spp=1) -> tuple[int, int]:
    """(device kernels, wave bounces) of the crop's render at spp under
    torch.profiler; a wave's bounces are its iterations and its last
    pickup (integrator.wave_iterations + 1)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import integrator

    d = cs.description
    desc_c = dataclasses.replace(d, integrator=dataclasses.replace(d.integrator, pixel_bounds=CROP_BOUNDS),
                                 sampler=dataclasses.replace(d.sampler, pixel_samples=spp))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        R_.render_compiled(_with_desc(cs, desc_c), seed=SEED)
        torch.cuda.synchronize()
    bounces = spp * (integrator.wave_iterations(cs.static, d.integrator.kind, d.integrator.max_depth) + 1)
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA), bounces


def _wave_main_path(label, cs, kernels, tier="torch-wave/wide", spp=None):
    """Phases 39-40 and 44-46: a warm-up render of the crop at 1 spp, then
    the full render (spp: None, the scene's) with every launch count set to
    0 just before it; the route must be `tier` and each of `kernels`
    launched in it. Returns (timing, {kernel: launches}, image)."""
    import numpy as np

    from pbrt_tpu_torch import render as R_

    d = cs.description
    R_.render_compiled(_with_desc(cs, dataclasses.replace(
        d, integrator=dataclasses.replace(d.integrator, pixel_bounds=CROP_BOUNDS),
        sampler=dataclasses.replace(d.sampler, pixel_samples=1))), seed=SEED)
    _reset_launches()
    img = R_.render_compiled(cs, seed=SEED, spp=spp)
    timing = R_.render_compiled.last_timing
    launches = {k.__name__: k.launches for k in kernels}
    vps = timing["n_vertices"] / timing["wall_s"]
    print(f"[{label}] {d.film.x_resolution}x{d.film.y_resolution} {spp or d.sampler.pixel_samples}spp "
          f"{d.integrator.kind} depth {d.integrator.max_depth} route {timing['tier']}: wall {timing['wall_s']:.4f}s, "
          f"{timing['n_vertices']:.0f} path vertices, path_vertex_samples_per_sec {vps:.1f}, launches {launches}, "
          f"image mean {img.mean():.5f}", flush=True)
    if timing["tier"] != tier:
        raise AssertionError(f"{label} took route {timing['tier']}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"{label} made no launch of a kernel of its path: {launches}")
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"{label} image is not finite and non-black")
    return timing, launches, img


def _wave_phases(out, work, cs, cs_host):
    """Phases 38-42: the per-sample wave (volpath with homogeneous and grid
    media, interface crossings, subsurface and kdsubsurface, whitted, ao,
    checkpoint and resume) and the medium_track kernel."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import medium_track, nvcc, wide_bvh
    from pbrt_tpu_torch.scene.builder import compile_scene

    seconds = out["seconds"] = {}
    t_phase = time.perf_counter()
    # --- 38. medium_track against its twin ---
    info = medium_track.build_kernel()
    regs = "; ".join(f"{r['kernel']}{r['template']} {r['registers']} registers, {r['spill_stores']}/"
                     f"{r['spill_loads']} bytes of spill stores/loads, {r['stack_frame']}-byte frame"
                     for r in _ptxas_entries(info["log"])) or "n/a (built before this run)"
    occ = [nvcc.occupancy(info["lib"].medium_track_occupancy, w, 2) for w in (0, 1)]
    fog_host, fog_compile_s = _host_scene("fog_room")
    fog = fog_host.to("cuda")
    sa, kinds = fog.arrays, fog.static.media_kinds
    med, o, d, t_end, key = _track_rays(fog, TRACK_RAYS)
    mixed = _mixed_track_rays(fog, (med, o, d, t_end, key))
    empty = [torch.full_like(med, -1), o, d, t_end, key]
    rows = {}
    for name, kernel, plain, n_out, ops in (
            ("delta_track", medium_track.delta_track_cuda, medium_track.delta_track_plain, 3, MT_OPS_DELTA),
            ("ratio_track", medium_track.ratio_track_cuda, medium_track.ratio_track_plain, 2, MT_OPS_RATIO)):
        res_k = kernel(sa, med, o, d, t_end, key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_p = plain(sa, kinds, med, o, d, t_end, key)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        k_ms = _cuda_ms(lambda: kernel(sa, med, o, d, t_end, key), 20)
        # the wrapper's host time per call (no sync among the 20 calls)
        t0 = time.perf_counter()
        for _ in range(20):
            kernel(sa, med, o, d, t_end, key)
        host_ms = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        alone = {k: _track_alone_ms(name, sa, r) for k, r in (("grid", (med, o, d, t_end, key)), ("mixed", mixed),
                                                               ("empty", empty))}
        val_k, val_p = res_k[0], res_p[0]
        steps_k, steps_p = res_k[-1], res_p[-1]
        decisions = torch.equal(steps_k, steps_p) and (n_out == 2 or torch.equal(res_k[1], res_p[1]))
        rel = ((val_k - val_p).abs() / val_p.abs().clamp(min=1e-30)).max().item()
        bit_equal = int((val_k.view(torch.int32) == val_p.view(torch.int32)).sum().item())
        # the mixed launch: every output bit for bit, the rays outside the grid medium without a step
        mix_k, mix_p = kernel(sa, *mixed), plain(sa, kinds, *mixed)
        mix_equal = torch.equal(mix_k[0].view(torch.int32), mix_p[0].view(torch.int32)) and all(
            torch.equal(a, b) for a, b in zip(mix_k[1:], mix_p[1:]))
        in_grid = mixed[0] == kinds.index("heterogeneous")
        mix_skipped = int(mix_k[-1][~in_grid].abs().sum()) == 0
        steps = float(steps_k.double().sum())
        # the grids' own densities once (the kernel's corner rows are its layout, not the work)
        grid_bytes = _nbytes(*sa.med_grids.values(), sa.med_grid_dims, sa.med_w2m, sa.med_param)
        nbytes = _nbytes(o, d, t_end, med, key, *res_k) + grid_bytes
        bound = _bound(nbytes, steps * ops)
        rows[name] = {"ms": k_ms, "alone_ms": alone["grid"], "wrapper_host_ms": host_ms,
                      "mixed_alone_ms": alone["mixed"], "empty_alone_ms": alone["empty"], "plain_ms": p_ms,
                      "max_abs_err": (val_k - val_p).abs().max().item(), "max_rel_err": rel,
                      "bit_equal_rays": bit_equal, "mixed_bit_equal": mix_equal,
                      "mixed_grid_rays": int(in_grid.sum()), "steps": steps,
                      "steps_max": int(steps_k.max().item()), "bound_ms": bound[0], "bound_by": bound[1],
                      "bytes": nbytes}
        extra = f", collisions {int(res_k[1].sum().item())}" if n_out == 3 else f", mean tr {val_k.mean().item():.5f}"
        print(f"[38 {name}] {TRACK_RAYS} rays through the smoke box: steps and decisions equal {decisions}, "
              f"max rel err {rel:.3e}, bit-equal {bit_equal}/{TRACK_RAYS}; through the wrapper {k_ms:.4f} ms "
              f"(its host time {host_ms:.4f} ms a call), the kernel alone {alone['grid']:.4f} ms, plain {p_ms:.1f} "
              f"ms; {steps:.0f} steps ({steps / TRACK_RAYS:.2f} per ray, max {rows[name]['steps_max']}){extra}; "
              f"bound {bound[0]:.4f} ms ({bound[1]}: {nbytes} bytes, {steps * ops:.4g} ops): through the wrapper "
              f"{100 * bound[0] / k_ms:.2f}% of it, alone {100 * bound[0] / alone['grid']:.2f}%; a mixed launch "
              f"({int(in_grid.sum())} of {TRACK_RAYS} rays in the grid medium, the rest in the fog or none) alone "
              f"{alone['mixed']:.4f} ms, bit-equal {mix_equal}, rays outside the grid medium unstepped "
              f"{mix_skipped}; an empty launch (no ray in a grid medium) alone {alone['empty']:.4f} ms", flush=True)
        if not decisions or bit_equal != TRACK_RAYS or not mix_equal or not mix_skipped:
            raise AssertionError(f"{name}: the kernel and its twin disagree")
    print(f"  medium_track ptxas: {regs}; blocks per SM (delta, ratio) {occ}; fog_room host compile "
          f"{fog_compile_s:.1f}s, grid {tuple(sa.med_grids['med1'].shape)}", flush=True)
    out["medium_track"] = {**rows, "ptxas": regs, "blocks_per_sm": occ}

    seconds["38"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 39. the fog room main path ---
    timing, launches, _img = _wave_main_path("39 fog_room main path", fog, spp=LATE_MAIN_SPP, kernels=(
        wide_bvh.traverse_cuda, medium_track.delta_track_cuda, medium_track.ratio_track_cuda))
    kern, bounces = _kernels_per_bounce(fog)
    print(f"  device kernels per wave bounce {kern / bounces:.1f} ({kern} over {bounces} bounces of a 1 spp crop)",
          flush=True)
    out["fog_room"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                       "launches": launches, "kernels_per_bounce": kern / bounces}

    seconds["39"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 40. the sss room main path (the tabulated BSSRDF); the walk ---
    sss_host, sss_compile_s = _host_scene("sss_room")
    sss = sss_host.to("cuda")
    timing, launches, _img = _wave_main_path("40 sss_room main path", sss, (wide_bvh.traverse_cuda,),
                                             spp=LATE_MAIN_SPP)
    kern, bounces = _kernels_per_bounce(sss)
    # the walk on a smaller room (the spheres at 64 x 32 and 32 x 32 cells)
    x0, x1, y0, y1 = CROP_BOUNDS
    with mock.patch.dict(os.environ, PBRT_TPU_NO_TABSSS="1"):
        walk = compile_scene(scenes.sss_room(40, 64, 32), "cuda")
    d = walk.description
    desc_c = dataclasses.replace(d, integrator=dataclasses.replace(d.integrator, pixel_bounds=CROP_BOUNDS),
                                 sampler=dataclasses.replace(d.sampler, pixel_samples=LATE_SPP[1]))
    walk_img = R_.render_compiled(_with_desc(walk, desc_c), seed=SEED)[y0:y1, x0:x1]
    print(f"  host compile {sss_compile_s:.1f}s; device kernels per wave bounce {kern / bounces:.1f}; the walk "
          f"(PBRT_TPU_NO_TABSSS=1: {walk.static.sss_media} walk media, route {R_.render_compiled.last_timing['tier']}) "
          f"crop of sss_room(40, 64, 32) at {LATE_SPP[1]} spp mean {walk_img.mean():.5f}", flush=True)
    if not (walk.static.has_sss_media and np.isfinite(walk_img).all() and walk_img.mean() > 0):
        raise AssertionError("the sss room's walk crop is not finite and non-black")
    out["sss_room"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                       "launches": launches, "kernels_per_bounce": kern / bounces,
                       "walk_crop_mean": float(walk_img.mean())}

    seconds["40"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 41. crops on cuda and cpu: both rooms, whitted and ao ---
    # the cpu crops come from phase 2's workers (CPU_CROP_TASKS)
    _check_crop("41 fog_room cuda-vs-cpu crop", fog, None, fog.description, LATE_SPP[0],
                cpu=_CPU_CROPS["fog_room"].result()["built"])
    _check_crop("41 sss_room cuda-vs-cpu crop", sss, None, sss.description, LATE_SPP[0],
                cpu=_CPU_CROPS["sss_room"].result()["built"])
    # whitted on the mesh room (phase 3's tables); ao on the open sky_meshes
    # (the mesh room is closed: every ao ray is occluded)
    sky = compile_scene(scenes.sky_meshes(), "cuda")
    for kind, gpu, task in (("whitted", cs, "mesh_room"), ("ao", sky, "sky_meshes")):
        desc = dataclasses.replace(gpu.description, integrator=dataclasses.replace(gpu.description.integrator,
                                                                                   kind=kind))
        _check_crop(f"41 {kind} cuda-vs-cpu crop", _with_desc(gpu, desc), None, desc, LATE_SPP[1],
                    cpu=_CPU_CROPS[task].result()[kind])

    seconds["41"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 42. the fog room as a file: a checkpointed render, interrupted and resumed ---
    path = work / "fog_room.pbrt"
    scenes.write_pbrt(scenes.fog_room(8), str(path), scenes.ROOM_LOOK_AT)
    ck = work / "fog.npz"
    crop = ["--cropwindow", "0.3", "0.7", "0.3", "0.7"]
    args = [str(path), "--quiet", "--seed", str(SEED), "--spp", "4", *crop]
    cmd = [sys.executable, "-m", "pbrt_tpu_torch", *args, "--checkpoint", str(ck), "--checkpoint-every", "2"]
    cwd = str(Path(__file__).resolve().parent)
    sub = subprocess.Popen(cmd + ["--outfile", str(work / "cut.pfm")], cwd=cwd, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    t0 = time.perf_counter()
    while not ck.exists() and sub.poll() is None and time.perf_counter() - t0 < 300:
        time.sleep(0.01)
    sub.kill()
    sub.wait()
    cut_at = int(np.load(ck)["next_sample"]) if ck.exists() else None
    res = subprocess.run(cmd + ["--outfile", str(work / "resumed.pfm")], cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    cli.main(args + ["--outfile", str(work / "whole.pfm")])
    from pbrt_tpu_torch.core.imageio import read_image

    resumed, whole = read_image(str(work / "resumed.pfm")), read_image(str(work / "whole.pfm"))
    equal = resumed.shape == whole.shape and bool(np.array_equal(resumed, whole))
    print(f"[42 checkpoint] {path.name} ({path.stat().st_size} bytes): python -m pbrt_tpu_torch stopped at the "
          f"checkpoint of sample {cut_at}/4, resumed (exit {res.returncode}) to an image bit-equal to the "
          f"uninterrupted render's: {equal} (max |d| {np.abs(resumed - whole).max():.3e}, mean {whole.mean():.5f}); "
          f"route {cli.main.last_run['timing']['tier']}", flush=True)
    if cut_at != 2 or res.returncode != 0 or not equal or not whole.mean() > 0:
        raise AssertionError(f"the checkpointed render did not resume to the uninterrupted one:\n{res.stderr[-2000:]}")
    out["checkpoint"] = {"cut_at": cut_at, "bit_equal": equal}
    seconds["42"] = time.perf_counter() - t_phase


# the motion walk (bvh_walk.cu, MOTION 2): float32 operations per candidate
# prim, counted from its source as a lower bound: the group's M(dt)
# (bw_anim_matrix: the slerp weights 8, the quaternion 12, its norm and
# divides 12, the rotation 24, the scale lerp 27, rot . scale 45, the
# translation lerp 9), the compose with C (45 + 18); a triangle's three
# vertices through G (54); a quadric's adjugate inverse of M (60)
BW_OPS_ANIM = 8 + 12 + 12 + 24 + 27 + 45 + 9 + 63
BW_OPS_ANIM_TRI = 54
BW_OPS_ANIM_QUADRIC = 60
MOTION_RAYS = 500_000


def _motion_rays(cs, sample=0):
    """The camera rays of sample `sample` of every pixel of cs's film, as
    the wave makes them: the film and lens dimensions, the shutter time of
    dimension render.TIME_DIM, the animated camera at it. Returns (o, d,
    t_max, time)."""
    import torch

    from pbrt_tpu_torch import render as R_

    desc = cs.description
    dev = cs.arrays.device
    W, H = desc.film.x_resolution, desc.film.y_resolution
    cam = R_.scene_camera(desc, dev)
    icfg, scfg, fcfg = R_._configs(desc, dev, desc.integrator.kind)
    idx = torch.arange(W * H, device=dev)
    px, py = idx % W, idx // W
    sidx = torch.full_like(idx, sample)
    pxf, pyf, ul1, ul2, _w = R_._film_sample(scfg, fcfg, px, py, idx, SEED, sidx)
    tf = R_._shutter_fraction(cam, scfg, SEED, idx, sidx).contiguous()
    o, d = R_.generate_rays(cam, pxf, pyf, ul1, ul2, tf)
    return o.contiguous(), d.contiguous(), torch.full((W * H,), float("inf"), device=dev), tf


def _bits_against_twin(res_k, res_p, quad):
    """Phase 43: ({output: rays differing bit for bit} over t, prim, b1, b2
    and pops, every ray; the largest ulp distance of b1 and b2 on the rays
    that hit a quadric (`quad`), where they are the hit's object-space x
    and y, which must be 0 too)."""
    import torch

    bit, ulps = {}, 0
    for name, a, b in zip(("t", "prim", "b1", "b2", "pops"), res_k, res_p):
        a32 = a.view(torch.int32).long() if a.dtype == torch.float32 else a.long()
        b32 = b.view(torch.int32).long() if b.dtype == torch.float32 else b.long()
        if name in ("b1", "b2") and bool(quad.any()):
            ulps = max(ulps, int((a32 - b32).abs()[quad].max()))
        bit[name] = int((a32 != b32).sum())
    return bit, ulps


def _realistic_rays_against_cpu(cs_g, cs_c) -> dict:
    """Phase 47: the realistic camera's rays of the crop's lanes (sample 0),
    as the wave makes them, on cuda and on cpu: the lanes whose origin,
    direction or weight differ in any bit, those vignetted on one device
    only, and the largest |d_cuda - d_cpu|. While the lens trace divided
    by Python numbers (on the card a multiply by the rounded reciprocal),
    the crop after it read 7.7e-6 and 1.5e-5 of sum|b|, paths parting
    after the 13 refractions; with `realistic._div` it reads 8.9e-8 on an
    NVIDIA H100 80GB HBM3, its rays still an ulp apart in about 5% of the
    directions (at most 1.04e-7) and never vignetted on one device only."""
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device.realistic import realistic_generate_rays

    res = []
    for cs in (cs_g, cs_c):
        desc, dev = cs.description, cs.arrays.device
        cam = R_.scene_camera(desc, dev)
        _icfg, scfg, fcfg = R_._configs(desc, dev, desc.integrator.kind)
        px, py, pid = _crop_lanes(cs)
        pxf, pyf, ul1, ul2, _w = R_._film_sample(scfg, fcfg, px, py, pid, SEED, torch.zeros_like(pid))
        res.append([x.cpu() for x in realistic_generate_rays(cam, cam["realistic"], pxf, pyf, ul1, ul2)])
    (o_g, d_g, w_g), (o_c, d_c, w_c) = res

    def differ(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).reshape(a.shape[0], -1).any(1).sum())

    return {"lanes": int(o_g.shape[0]), "o_differing": differ(o_g, o_c), "d_differing": differ(d_g, d_c),
            "weight_differing": differ(w_g, w_c), "vignetted_on_one_device": int(((w_g > 0) != (w_c > 0)).sum()),
            "max_abs_dd": float((d_g - d_c).abs().max())}


def _motion_bdpt_phases(out, work, cs, cs_host, mesh_img):
    """Phases 43-47: motion blur and the animated camera (the motion walk),
    the realistic camera, BDPT."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import bvh_walk, wide_bvh
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scene.host import CameraConfig

    seconds = out["seconds"] = {}
    t_phase = time.perf_counter()
    # --- 43. the motion walk against its twin on 500,000 camera rays ---
    mr_host, mr_compile_s = _host_scene("motion_room")
    mr = mr_host.to("cuda")
    sa, st = mr.arrays, mr.static
    o, d, t_max, tm = _motion_rays(mr)
    res_k = bvh_walk.bvh_walk_motion_cuda(sa, st, o, d, t_max, False, time=tm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_p = bvh_walk.walk_plain(sa, st, o, d, t_max, False, time=tm)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    k_ms = _cuda_ms(lambda: bvh_walk.bvh_walk_motion_cuda(sa, st, o, d, t_max, False, time=tm), 10)
    hit = res_k[1] >= 0
    quad = hit & (sa.prim_kind[res_k[1].long().clamp(min=0)] != 0)
    bit, quad_ulps = _bits_against_twin(res_k, res_p, quad)
    # the static walk against its twin on the same rays (csrc/quadric.cuh
    # against prims.ray_quadric, the static walk's own quadric test)
    static_bit, static_ulps = _bits_against_twin(bvh_walk.bvh_walk_cuda(sa, st, o, d, t_max, False),
                                                 bvh_walk.walk_plain(sa, st, o, d, t_max, False), quad)
    bvh_walk.bvh_walk_cuda.launches -= 1  # a comparison launch, not the main path's
    err = float((res_k[0] - res_p[0]).abs()[hit].max()) if bool(hit.any()) else 0.0
    moving = sa.anim_gid[res_k[1].long().clamp(min=0)] > 0
    bound_ms, bound_by, counts = _walk_bound("43 motion camera/closest", mr, o, d, t_max, tm, res_k)
    lanes, visits = _bvh_lanes(bvh_walk.bvh_walk_motion_cuda, sa, st, o, d, t_max, False, time=tm)
    counters = bvh_walk.bvh_walk_motion_cuda.counters[torch.device("cuda", 0)].tolist()
    print(f"[43 motion walk] motion_room(248): {st.n_prims} prims, {sa.anim['q0'].shape[0]} groups, host compile "
          f"{mr_compile_s:.1f}s; {o.shape[0]} camera rays at shutter fractions of dimension {R_.TIME_DIM}: rays "
          f"differing from the twin (t, prim, b1, b2, pops) {bit}, max |dt| {err:.3e}; on the {int(quad.sum())} "
          f"quadric hits b1, b2 (object-space x, y) apart by at most {quad_ulps} ulps (the static walk against its "
          f"twin on the same rays: differing {static_bit}, {static_ulps} ulps); hits {float(hit.float().mean()):.4f}"
          f", on moving prims {int((hit & moving).sum())}; kernel {k_ms:.4f} ms ({1e6 * k_ms / o.shape[0]:.3f} ns per "
          f"ray), plain {p_ms:.1f} ms; boxes tested per ray {float(res_k[4].double().mean()):.2f}, node visits per "
          f"ray {visits:.2f}, lanes with a ray {lanes:.4f}; bound {bound_ms:.4f} ms ({bound_by}), kernel at "
          f"{100 * bound_ms / k_ms:.2f}% of it; counters {counters}", flush=True)
    if any(bit.values()) or any(static_bit.values()) or counters != [0, 0] or not bool((hit & moving).any()):
        raise AssertionError("the motion walk (or the static walk) and its twin disagree")
    out["motion_walk"] = {"ms": k_ms, "ns_per_ray": 1e6 * k_ms / o.shape[0], "lanes_with_a_ray": lanes,
                          "visits_per_ray": visits, "plain_ms": p_ms, "max_abs_err": err, "rays_differing": bit,
                          "quadric_xy_ulps": quad_ulps, "static_quadric_xy_ulps": static_ulps,
                          "bound_ms": bound_ms, "bound_by": bound_by, "counts": counts, "host_compile_s": mr_compile_s}
    # the kd walk's motion entry on the kd motion rooms (MOTION 2; MOTION 1
    # on the keyframe room), each ray bit for bit against the twin, whose
    # counts give the bound
    kd_rows, kd_rooms = {}, {}
    for name, motion in (("motion_room_kd", 2), ("motion_room_kd_keyframes", 1)):
        host, host_s = _host_scene(name)
        km = kd_rooms[name] = host.to("cuda")
        ka, ks = km.arrays, km.static
        if bvh_walk.motion_kind(ks) != motion or ks.accel_kind != "kdtree":
            raise AssertionError(f"{name} is not a kd scene of MOTION {motion}")
        ko, kdir, kt, ktm = _motion_rays(km)
        res_k = bvh_walk.kd_walk_motion_cuda(ka, ks, ko, kdir, kt, False, time=ktm)
        kcounts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_p = bvh_walk.kd_walk_plain(ka, ks, ko, kdir, kt, False, time=ktm, counts=kcounts)
        torch.cuda.synchronize()
        kp_ms = 1e3 * (time.perf_counter() - t0)
        kk_ms = _cuda_ms(lambda: bvh_walk.kd_walk_motion_cuda(ka, ks, ko, kdir, kt, False, time=ktm), 10)
        khit = res_k[1] >= 0
        kquad = khit & (ka.prim_kind[res_k[1].long().clamp(min=0)] != 0)
        kbit, kulps = _bits_against_twin(res_k, res_p, kquad)
        kb_ms, kb_by, kb_counts = _kd_bound_of(f"43 kd MOTION {motion} camera/closest", km, ko, kdir, kt, res_k,
                                               res_p, kcounts, ktm)
        kcounters = bvh_walk.kd_walk_motion_cuda.counters[torch.device("cuda", 0)].tolist()
        kerr = float((res_k[0] - res_p[0]).abs()[khit].max()) if bool(khit.any()) else 0.0
        # the moving prims: a group other than the identity, or keyframe rows that move
        moves = ka.anim_gid > 0 if ka.anim_gid is not None else (ka.prim_test_data_end != ka.prim_test_data).any(1)
        kmoving = moves[res_k[1].long().clamp(min=0)]
        print(f"[43 kd motion walk MOTION {motion}] {name} (motion_room(40), kdtree): {ks.n_prims} prims, tree depth "
              f"{ks.kd_depth}, host compile {host_s:.1f}s; {ko.shape[0]} camera rays at their shutter fractions: "
              f"rays differing from the twin (t, prim, b1, b2, pops) {kbit}, quadric hits {int(kquad.sum())} "
              f"({kulps} ulps), hits {float(khit.float().mean()):.4f}, on moving prims {int((khit & kmoving).sum())}; "
              f"kernel {kk_ms:.4f} ms ({1e6 * kk_ms / ko.shape[0]:.3f} ns per ray), plain {kp_ms:.1f} ms; pops per "
              f"ray {float(res_k[4].double().mean()):.2f}; bound {kb_ms:.4f} ms ({kb_by}), kernel at "
              f"{100 * kb_ms / kk_ms:.2f}% of it; counters {kcounters}", flush=True)
        if any(kbit.values()) or kcounters != [0, 0] or res_p[5] or not bool((khit & kmoving).any()):
            raise AssertionError(f"the kd motion walk (MOTION {motion}) and its twin disagree")
        kd_rows[f"motion{motion}"] = {"ms": kk_ms, "ns_per_ray": 1e6 * kk_ms / ko.shape[0], "plain_ms": kp_ms,
                                      "max_abs_err": kerr, "rays_differing": kbit, "bound_ms": kb_ms,
                                      "bound_by": kb_by, "counts": kb_counts, "host_compile_s": host_s}
    out["kd_motion_walk"] = kd_rows

    seconds["43"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 44. motion_room main path ---
    timing, launches, _img = _wave_main_path("44 motion_room main path", mr, (bvh_walk.bvh_walk_motion_cuda,),
                                             "torch-wave/bvh")
    kern, bounces = _kernels_per_bounce(mr)
    print(f"  device kernels per wave bounce {kern / bounces:.1f} ({kern} over {bounces} bounces of a 1 spp crop)",
          flush=True)
    out["motion_room"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                          "launches": launches, "kernels_per_bounce": kern / bounces}
    # the kd motion room's render at 1 spp: the kd motion entry on its main path
    timing, launches, _img = _wave_main_path("44 motion_room kd main path", kd_rooms["motion_room_kd"],
                                             (bvh_walk.kd_walk_motion_cuda,), "torch-wave/kdtree", spp=1)
    out["motion_room_kd"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                             "launches": launches}

    seconds["44"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 45. the mesh room under the realistic camera (phase 3's tables) ---
    lens = scenes.write_lens(str(work / scenes.LENS_FILE))
    real = scenes.realistic_mesh_room(1, lens_dir=str(work)).camera
    desc_r = dataclasses.replace(cs.description, camera=real)
    assert isinstance(real, CameraConfig) and real.lens_file == lens
    cs_r = _with_desc(cs, desc_r)
    timing, launches, _img = _wave_main_path("45 realistic camera main path", cs_r, (wide_bvh.traverse_cuda,))
    out["realistic_room"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                             "launches": launches}

    seconds["45"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 46. BDPT on the mesh room (phase 3's tables) ---
    desc_b = dataclasses.replace(cs.description, integrator=dataclasses.replace(cs.description.integrator,
                                                                                kind="bdpt"))
    cs_b = _with_desc(cs, desc_b)
    spp_b = BDPT_SPP
    timing, launches, img_b = _wave_main_path("46 bdpt main path", cs_b, (wide_bvh.traverse_cuda,),
                                              "torch-bdpt/wide", spp_b)
    ratio = float(img_b.mean() / mesh_img.mean())
    print(f"  {timing['wall_s'] / spp_b:.4f} s per spp; image mean against phase 4's path image: ratio {ratio:.4f} "
          f"(a reading: the reference's mesh-agreement band is 0.90-1.10, tools/fidelity.py :372-373)", flush=True)
    out["bdpt_mesh"] = {"wall_s": timing["wall_s"], "vps": timing["n_vertices"] / timing["wall_s"],
                        "s_per_spp": timing["wall_s"] / spp_b, "spp": spp_b, "launches": launches,
                        "mean_ratio_to_path": ratio, "mean": float(img_b.mean())}

    seconds["46"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 47. crops on cuda and cpu; the keyframe motion; the front end ---
    # (the cpu crops rendered by phase 2's workers, from the same scenes compiled there)
    _check_crop("47 motion_room cuda-vs-cpu crop", mr, None, mr.description, LATE_SPP[0],
                cpu=_CPU_CROPS["motion_room"].result()["built"])
    rays = _realistic_rays_against_cpu(cs_r, _with_desc(cs_host, desc_r))
    print(f"[47 realistic camera rays] the crop's camera rays (sample 0) on cuda against cpu: {json.dumps(rays)}",
          flush=True)
    out["realistic_rays"] = rays
    mesh_crops = _CPU_CROPS["mesh_room"].result()
    _check_crop("47 realistic camera cuda-vs-cpu crop", cs_r, None, desc_r, LATE_SPP[0], cpu=mesh_crops["realistic"])
    _check_crop("47 bdpt cuda-vs-cpu crop", cs_b, None, desc_b, LATE_SPP[0], cpu=mesh_crops["bdpt"])
    keyed_host = compile_scene(scenes.motion_room(16, rotate=False), "cpu")
    if keyed_host.static.has_rot_motion or not keyed_host.static.has_motion:
        raise AssertionError("motion_room(rotate=False) should take the keyframe tables")
    _check_crop("47 motion_room(16, rotate=False) cuda-vs-cpu crop", keyed_host.to("cuda"), None,
                keyed_host.description, LATE_SPP[1], cpu=_CPU_CROPS["motion_room_keyed"].result()["built"])
    files = {}
    for name, desc in (("motion_room", scenes.motion_room(8)),
                       ("bdpt_room", dataclasses.replace(scenes.mesh_room(8), integrator=dataclasses.replace(
                           scenes.mesh_room(8).integrator, kind="bdpt")))):
        path = work / f"{name}.pbrt"
        scenes.write_pbrt(desc, str(path), scenes.ROOM_LOOK_AT)
        img_path = work / f"{name}.pfm"
        res = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", str(path), "--quiet", "--seed", str(SEED),
                              "--spp", "2", "--cropwindow", "0.3", "0.7", "0.3", "0.7", "--outfile", str(img_path)],
                             cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True, timeout=600)
        from pbrt_tpu_torch.core.imageio import read_image

        img = read_image(str(img_path)) if img_path.exists() else None
        files[name] = {"exit": res.returncode, "mean": None if img is None else float(img.mean())}
        print(f"[47 front end] python -m pbrt_tpu_torch {path.name}: exit {res.returncode}, image mean "
              f"{files[name]['mean']}", flush=True)
        if res.returncode != 0 or img is None or not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"python -m pbrt_tpu_torch failed on {path.name}:\n{res.stderr[-2000:]}")
    out["files"] = files
    seconds["47"] = time.perf_counter() - t_phase


# phases 48-51: the reference's mesh-agreement readings (FIDELITY.json) and band
MESH_AGREEMENT = {"bdpt": 1.0468, "sppm": 1.0454}
MESH_AGREEMENT_BAND = (0.90, 1.10)


def _gate(label, img_g, img_c):
    """Phase 5's rule on two whole images (cuda, cpu): sum|a-b| / sum|b| <
    1e-3 and >= 99% of the pixels within rtol 1e-2 (atol 1e-4), a finite,
    non-black image; prints the numbers and returns them."""
    import numpy as np

    rel = float(np.abs(img_g - img_c).sum() / max(np.abs(img_c).sum(), 1e-30))
    px_ok = float(np.isclose(img_g, img_c, rtol=1e-2, atol=1e-4).all(axis=-1).mean())
    print(f"[{label}] sum|a-b|/sum|b| {rel:.3e}, pixels within rtol 1e-2 {px_ok:.4f}, means {img_g.mean():.5f} "
          f"{img_c.mean():.5f}", flush=True)
    if not (np.isfinite(img_g).all() and img_c.mean() > 0 and rel < 1e-3 and px_ok >= 0.99):
        raise AssertionError(f"cuda and cpu renders disagree ({label})")
    return {"rel": rel, "pixels_ok": px_ok}


def _host_loop_main_path(label, cs, tier):
    """Phases 48-49: one render_compiled of an MLT or SPPM scene with every
    launch count set to 0 just before it: route `tier`, B1 launched, a
    finite, non-black image. Returns (timing, B1 launches, image)."""
    import numpy as np

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import wide_bvh

    _reset_launches()
    img = R_.render_compiled(cs, seed=SEED)
    launches = wide_bvh.traverse_cuda.launches
    timing = R_.render_compiled.last_timing
    if timing["tier"] != tier:
        raise AssertionError(f"{label} took route {timing['tier']}")
    if launches <= 0:
        raise AssertionError(f"{label} made no launch of B1")
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"{label} image is not finite and non-black")
    return timing, launches, img


def _device_kernels(fn) -> int:
    """The device kernels of fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _mlt_step_kernels(cs, depths, n_chains):
    """Device kernels of one MLT chain step of n_chains chains at each of
    `depths`, on uniform rows: one step per depth under one torch.profiler
    session, each in a range that ends with a synchronize, a kernel counted
    in the range its start falls in. Returns ({depth: kernels}, all of
    them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from pbrt_tpu_torch.device import bdpt, lights, mlt
    from pbrt_tpu_torch.device.camera import make_camera

    sa, st, desc = cs.arrays, cs.static, cs.description
    W, H = desc.film.x_resolution, desc.film.y_resolution
    ctx = bdpt._Ctx(sa, st)
    cam = make_camera(desc.camera, desc.film, sa.device)
    cdf = torch.cumsum(lights.compute_power(sa, st), 0)
    cdf = cdf / cdf[-1]
    u = torch.rand((n_chains, mlt.DIMS), generator=torch.Generator().manual_seed(SEED)).to(sa.device)
    ids = torch.arange(n_chains, device=sa.device)
    film = torch.zeros((W * H + 1, 3), dtype=torch.float64, device=sa.device)
    curs = {depth: mlt._l_fn(sa, st, ctx, cam, cdf, u, depth, W, H) for depth in depths}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for depth in depths:
            with record_function(f"mlt_step_depth_{depth}"):
                mlt.mlt_chain_step(sa, st, ctx, cam, cdf, depth, W, H, mlt.SIGMA, mlt.P_LARGE, ids, u, curs[depth],
                                   1, film)
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name.startswith("mlt_step_depth_") and e.device_type == DeviceType.CPU}
    starts = [e.time_range.start for e in events
              if e.device_type == DeviceType.CUDA and not e.name.startswith("mlt_step_depth_")]
    per_depth = {d: sum(1 for t in starts
                        if ranges[f"mlt_step_depth_{d}"].start <= t <= ranges[f"mlt_step_depth_{d}"].end)
                 for d in depths}
    return per_depth, len(starts)


def _mlt_sppm_phases(out, work, cs, cs_host, bdpt_mean):
    """Phases 48-51: MLT and SPPM on the mesh room, the mesh-agreement
    check, cuda against cpu and the front end."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.device import wide_bvh

    seconds = out["seconds"] = {}
    d0 = cs.description

    def variant(kind, film=None, **ic):
        desc = dataclasses.replace(d0, integrator=dataclasses.replace(d0.integrator, kind=kind, **ic))
        if film is not None:
            desc = dataclasses.replace(desc, film=dataclasses.replace(d0.film, x_resolution=film[0],
                                                                      y_resolution=film[1]))
        return desc

    t_phase = time.perf_counter()
    # --- 48. MLT on the mesh room at 1000x500 ---
    desc = variant("mlt", mutations_per_pixel=1, n_chains=4096, n_bootstrap=100_000)
    timing, launches, img = _host_loop_main_path("48 mlt main path", _with_desc(cs, desc), "torch-mlt/wide")
    depths = timing["depths"]
    chain_s = sum(d_["chain_s"] for d_ in depths)
    boot_s = sum(d_["bootstrap_s"] for d_ in depths)
    # the steps of depth 1 and of the deepest depth under the profiler
    # (every depth's took about 16 s of the script)
    kernels, kernels_all = _mlt_step_kernels(_with_desc(cs, desc), (1, desc.integrator.max_depth),
                                             desc.integrator.n_chains)
    ratio = float(img.mean()) / bdpt_mean
    print(f"[48 mlt main path] 1000x500 depth {desc.integrator.max_depth}, {desc.integrator.n_chains} chains, "
          f"{timing['chain_steps']} chain steps ({timing['mutations']} mutations, blocks of "
          f"{[d_.get('block') for d_ in depths]}): wall {timing['wall_s']:.4f}s, bootstrap {boot_s:.4f}s, chains "
          f"{chain_s:.4f}s = {chain_s / max(timing['chain_steps'], 1):.4f}s per chain step; device kernels per "
          f"chain step by depth {kernels} (of {kernels_all} in the session); acceptance "
          f"{timing['acceptance']:.4f}; B1 launches {launches}; image mean {img.mean():.5f}, against phase 46's "
          f"BDPT image {ratio:.4f} (a reading: the reference's "
          f"bdpt/path and sppm/path read {MESH_AGREEMENT['bdpt']} and {MESH_AGREEMENT['sppm']})", flush=True)
    out["mlt_mesh"] = {"wall_s": timing["wall_s"], "bootstrap_s": boot_s, "chain_s": chain_s,
                       "chain_steps": timing["chain_steps"],
                       "s_per_chain_step": chain_s / max(timing["chain_steps"], 1),
                       "kernels_per_chain_step": kernels, "acceptance": timing["acceptance"], "launches": launches,
                       "mean_ratio_to_bdpt": ratio}

    seconds["48"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # --- 49. SPPM on the mesh room at 1000x500 ---
    desc = variant("sppm", num_iterations=4, photons_per_iteration=-1, initial_radius=0.024)
    timing, launches, img = _host_loop_main_path("49 sppm main path", _with_desc(cs, desc), "torch-sppm/wide")
    n_it = timing["iterations"]
    split = {k: v / n_it for k, v in timing["split"].items()}
    one = dataclasses.replace(desc, integrator=dataclasses.replace(desc.integrator, num_iterations=1))
    kernels = _device_kernels(lambda: R_.render_compiled(_with_desc(cs, one), seed=SEED))
    print(f"[49 sppm main path] 1000x500 depth {desc.integrator.max_depth}, {n_it} iterations of "
          f"{timing['photons'] // n_it} photons, radius {desc.integrator.initial_radius}: wall "
          f"{timing['wall_s']:.4f}s, per iteration {json.dumps({k: round(v, 4) for k, v in split.items()})}s; "
          f"visible points {timing['visible_points']}, photon-visible point pairs {timing['pairs']}, longest cell "
          f"run {timing['max_run']}, pairs dropped by the 1,024-entry cap {timing['dropped']}; device kernels per "
          f"iteration {kernels:.1f}; B1 launches {launches}; image mean {img.mean():.5f}", flush=True)
    out["sppm_mesh"] = {"wall_s": timing["wall_s"], "s_per_iteration": split, "max_run": timing["max_run"],
                        "dropped": timing["dropped"], "pairs": timing["pairs"], "kernels_per_iteration": kernels,
                        "launches": launches}

    seconds["49"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # phase 51's front end runs as two subprocesses beside phases 50-51
    front_end = {}
    for kind, ic in (("mlt", dict(max_depth=3, mutations_per_pixel=4, n_chains=512, n_bootstrap=6000)),
                     ("sppm", dict(max_depth=3, num_iterations=2, photons_per_iteration=20_000, initial_radius=0.1))):
        desc = scenes.mesh_room(8)
        desc.film.x_resolution, desc.film.y_resolution = 200, 100
        desc.integrator = dataclasses.replace(desc.integrator, kind=kind, **ic)
        path = work / f"{kind}_room.pbrt"
        scenes.write_pbrt(desc, str(path), scenes.ROOM_LOOK_AT)
        img_path = work / f"{kind}_room.pfm"
        front_end[kind] = (path, img_path, subprocess.Popen(
            [sys.executable, "-m", "pbrt_tpu_torch", str(path), "--quiet", "--seed", str(SEED), "--outfile",
             str(img_path)], cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        # --- 50. the mesh-agreement check (tools/fidelity.py _run_mesh_agreement) ---
        imgs, runs = {}, {}
        for kind, spp, ic in (("path", 16, {}), ("bdpt", 8, {}),
                              ("sppm", None,
                               dict(num_iterations=16, photons_per_iteration=1 << 17, initial_radius=0.12))):
            desc = variant(kind, (200, 100), max_depth=4, **ic)
            _reset_launches()
            imgs[kind] = R_.render_compiled(_with_desc(cs, desc), seed=SEED, spp=spp)
            runs[kind] = {"wall_s": R_.render_compiled.last_timing["wall_s"],
                          "b1_launches": wide_bvh.traverse_cuda.launches}
        ratios = {k: float(imgs[k].mean() / imgs["path"].mean()) for k in ("bdpt", "sppm")}
        print(f"[50 mesh agreement] 200x100 depth 4 on the mesh room: bdpt/path {ratios['bdpt']:.4f} (the reference "
              f"{MESH_AGREEMENT['bdpt']}), sppm/path {ratios['sppm']:.4f} (the reference "
              f"{MESH_AGREEMENT['sppm']}); band "
              f"{MESH_AGREEMENT_BAND}; the renders' walls and B1 launches {json.dumps(runs)}", flush=True)
        out["mesh_agreement"] = ratios
        lo, hi = MESH_AGREEMENT_BAND
        if not all(lo < r < hi for r in ratios.values()):
            raise AssertionError(f"the mesh-agreement ratios {ratios} lie outside {MESH_AGREEMENT_BAND}")

        seconds["50"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        # --- 51. MLT and SPPM on cuda against cpu; the front end ---
        gates = {}
        for kind in SMALL_HOST_LOOPS:
            _reset_launches()
            img_g, acc_g, wall_g = _render_small(kind, "cuda")
            launches = wide_bvh.traverse_cuda.launches
            img_c, acc_c, _s = _CPU_RENDERS[kind].result() if kind in _CPU_RENDERS else _render_small(kind, "cpu")
            if kind == "mlt":
                parted = np.argwhere(acc_g != acc_c).tolist()
                print(f"[51 mlt cuda-vs-cpu] {acc_g.shape[0]} chain steps of {acc_g.shape[1]} chains: accept "
                      f"decisions differing (step, chain) {parted[:8]}{' ...' if len(parted) > 8 else ''} "
                      f"({len(parted)} of {acc_g.size})", flush=True)
            gates[kind] = dict(_gate(f"51 {kind} cuda-vs-cpu 64x32", img_g, img_c), cuda_wall_s=wall_g,
                               b1_launches=launches)
            print(f"  the cuda render {wall_g:.4f}s, B1 launches {launches}", flush=True)
        files = {}
        for kind, (path, img_path, proc) in front_end.items():
            try:
                _out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                _out, err = proc.communicate()
            from pbrt_tpu_torch.core.imageio import read_image

            img = read_image(str(img_path)) if img_path.exists() else None
            files[kind] = {"exit": proc.returncode, "mean": None if img is None else float(img.mean())}
            print(f"[51 front end] python -m pbrt_tpu_torch {path.name}: exit {proc.returncode}, image mean "
                  f"{files[kind]['mean']}", flush=True)
            if proc.returncode != 0 or img is None or not (np.isfinite(img).all() and img.mean() > 0):
                raise AssertionError(f"python -m pbrt_tpu_torch failed on {path.name}:\n{err[-2000:]}")
        out["cuda_vs_cpu"] = gates
        out["files"] = files
        seconds["51"] = time.perf_counter() - t_phase
        if wide_bvh.traverse_cuda.counters[torch.device("cuda", 0)].tolist() != [0, 0]:
            raise AssertionError("B1 stack overflows / iteration-cap hits in phases 48-51")
    finally:
        for _path, _img, proc in front_end.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# phase 52's tolerances: the reference's mesh invariance (tests/test_shard_parity.py :43, :90, :99) and
# its SPPM band (:57-60)
SHARD_TOL = {"path": (2e-4, 2e-5), "bdpt": (2e-4, 2e-5), "mlt": (2e-4, 3e-5)}
SHARD_SPPM_BAND = 0.1


def _small_shard_desc():
    """Phase 52 (c)'s scene: mesh_room(8) at 64x32."""
    from pbrt_tpu_torch import scenes

    d = scenes.mesh_room(8)
    return dataclasses.replace(d, film=dataclasses.replace(d.film, x_resolution=64, y_resolution=32))


def _render_small_sharded(devices):
    """Phase 52 (c): the sharded path of _small_shard_desc() over devices
    at CROP_SPP: (image, None, seconds)."""
    from pbrt_tpu_torch.parallel import shard
    from pbrt_tpu_torch.scene.builder import compile_scene

    desc = _small_shard_desc()
    cs = compile_scene(desc, "cpu")
    t0 = time.perf_counter()
    img = shard.render_sharded_step(cs, desc, devices, spp=CROP_SPP, seed=SEED)
    return img, None, time.perf_counter() - t0


def _cpu_shard_render():
    """A worker's task (two PyTorch threads, beside the build): phase 52
    (c)'s render on two shards of the CPU."""
    import torch

    torch.set_num_threads(2)
    return _render_small_sharded(["cpu", "cpu"])


def _shard_phases(out, cs, mesh_img):
    """Phase 52: one image over a list of devices (parallel/shard.py), as
    two shards on the one card, each in its own thread and stream."""
    import numpy as np
    import torch

    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import wide_bvh
    from pbrt_tpu_torch.parallel import shard

    dev = torch.device("cuda", 0)
    one, two = [dev], [dev, dev]
    d0 = cs.description
    W, H = d0.film.x_resolution, d0.film.y_resolution
    spp = d0.sampler.pixel_samples

    def variant(kind, **ic):
        return dataclasses.replace(d0, integrator=dataclasses.replace(d0.integrator, kind=kind, **ic))

    def run(label, step, desc, devices, **kw):
        """The step over devices with every launch count set to 0 just
        before it: (image, wall seconds, B1 launches)."""
        _reset_launches()
        t0 = time.perf_counter()
        img = step(_with_desc(cs, desc), desc, devices, seed=SEED, **kw)  # on the host: the shards are done
        wall = time.perf_counter() - t0
        launches = wide_bvh.traverse_cuda.launches
        if launches <= 0:
            raise AssertionError(f"52 {label} over {len(devices)} shards made no launch of B1")
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"52 {label} over {len(devices)} shards: the image is not finite and non-black")
        return img, wall, launches

    # --- 52 (a). the path at full width, two shards against one ---
    t_phase = time.perf_counter()
    warm = shard.render_sharded_step(cs, d0, two, spp=2, seed=SEED)  # warm-up pass; (d)'s image
    img2, wall2, l2 = run("path", shard.render_sharded_step, d0, two, spp=spp)
    nv2 = shard.render_sharded_step.last_timing["n_vertices"]
    img1, wall1, l1 = run("path", shard.render_sharded_step, d0, one, spp=spp)
    nv1 = shard.render_sharded_step.last_timing["n_vertices"]
    rtol, atol = SHARD_TOL["path"]
    rel4 = float(np.abs(img2 - mesh_img.reshape(-1, 3)).sum() / np.abs(mesh_img).sum())
    out["path"] = {"walls_s": [wall2, wall1], "b1_launches": [l2, l1], "n_vertices": [nv2, nv1],
                   "path_vertex_samples_per_sec": [nv2 / wall2, nv1 / wall1],
                   "bit_equal": bool(np.array_equal(img2, img1)), "max_abs_diff": float(np.abs(img2 - img1).max()),
                   "rel_to_phase_4": rel4}
    print(f"[52 sharded path] {W}x{H} {spp}spp depth {d0.integrator.max_depth}, two shards on one card against "
          f"one: {json.dumps(out['path'])} (walls, launches, vertices and rates in that order; rel_to_phase_4: "
          f"sum|a-b|/sum|b| against phase 4's image, a reading)", flush=True)
    if nv2 != nv1 or not np.allclose(img2, img1, rtol=rtol, atol=atol):
        raise AssertionError("52: the two-shard path image differs from the one-shard image")
    seconds = out["seconds"] = {"a": time.perf_counter() - t_phase}
    t_phase = time.perf_counter()

    # --- 52 (b). BDPT, MLT and SPPM on the mesh room, two shards against one ---
    mlt_desc = variant("mlt", mutations_per_pixel=1, n_chains=4096)
    ic = mlt_desc.integrator
    n_mut = int(np.clip(ic.mutations_per_pixel * W * H // (ic.n_chains * (ic.max_depth + 1)), 1, 8192))
    families = (("bdpt", shard.render_bdpt_sharded_step, variant("bdpt"), dict(spp=4)),
                ("mlt", shard.render_mlt_sharded_step, mlt_desc, dict(depth=2, n_chains=ic.n_chains, n_mut=n_mut)),
                ("sppm", shard.render_sppm_sharded_step, variant("sppm", initial_radius=0.024),
                 dict(n_iters=1, n_photons=500_000)))
    for kind, step, desc, kw in families:
        a, wall_a, la = run(kind, step, desc, two, **kw)
        b, wall_b, lb = run(kind, step, desc, one, **kw)
        row = {"walls_s": [wall_a, wall_b], "b1_launches": [la, lb], "bit_equal": bool(np.array_equal(a, b)),
               "max_abs_diff": float(np.abs(a - b).max()), **{k: v for k, v in kw.items()}}
        if kind == "sppm":
            lit = b.mean(-1) > 1e-3
            row["lit_mean_ratio"] = float(a[lit].mean() / b[lit].mean())
            ok = lit.sum() > 0 and abs(row["lit_mean_ratio"] - 1.0) < SHARD_SPPM_BAND
        else:
            ok = np.allclose(a, b, rtol=SHARD_TOL[kind][0], atol=SHARD_TOL[kind][1])
        out[kind] = row
        print(f"[52 sharded {kind}] {W}x{H}, two shards against one: {json.dumps(row)}", flush=True)
        if not ok:
            raise AssertionError(f"52: the two-shard {kind} image differs from the one-shard image")
    seconds["b"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 52 (c). the two-shard path on cuda against cpu ---
    _reset_launches()
    img_g, _none, wall_g = _render_small_sharded(two)
    lc = wide_bvh.traverse_cuda.launches
    img_c = _CPU_RENDERS["shard"].result()[0] if "shard" in _CPU_RENDERS else _render_small_sharded(["cpu"] * 2)[0]
    out["cuda_vs_cpu"] = dict(_gate("52 sharded path cuda-vs-cpu 64x32", img_g, img_c), cuda_wall_s=wall_g,
                              b1_launches=lc)
    if lc <= 0:
        raise AssertionError("52: the small two-shard render made no launch of B1")
    seconds["c"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # --- 52 (d). render_compiled's branch, given two shards: (a)'s two-shard step at 2 spp ---
    _reset_launches()
    img_d = R_.render_compiled(cs, seed=SEED, spp=2, devices=two)
    ld = wide_bvh.traverse_cuda.launches
    tier = R_.render_compiled.last_timing["tier"]
    want = warm * d0.film.scale
    rel_d = float(np.abs(img_d.reshape(-1, 3) - want).sum() / np.abs(want).sum())
    out["branch"] = {"tier": tier, "spp": 2, "b1_launches": ld, "wall_s": R_.render_compiled.last_timing["wall_s"],
                     "rel_to_step": rel_d, "bit_equal": bool(np.array_equal(img_d.reshape(-1, 3), want))}
    print(f"[52 render_compiled branch] {json.dumps(out['branch'])}", flush=True)
    if tier != "torch-shard2/wide" or ld <= 0 or not rel_d < 1e-6:
        raise AssertionError(f"52: render_compiled's sharded branch took {tier} or another image")
    seconds["d"] = time.perf_counter() - t_phase
    if wide_bvh.traverse_cuda.counters[dev].tolist() != [0, 0]:
        raise AssertionError("B1 stack overflows / iteration-cap hits in phase 52")


def main() -> int:
    import numpy as np
    import torch

    t_script = time.perf_counter()
    # --- 1. device ---
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU", file=sys.stderr)
        return 1
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from pbrt_tpu_torch import render as R_
    from pbrt_tpu_torch.device import bvh_walk, medium_track, megakernel, megakernel_wide, nvcc, wide_bvh
    from pbrt_tpu_torch.device.camera import make_camera
    from pbrt_tpu_torch.scene.builder import compile_scene
    from pbrt_tpu_torch.scenes import material_room, spheres_gallery

    # --- 2. build: every kernel, one nvcc each, all started together ---
    _build_beside_host_compiles([wide_bvh.KERNEL_SOURCE, wide_bvh.JOINT_SOURCE, megakernel.KERNEL_SOURCE,
                                 megakernel_wide.KERNEL_SOURCE, bvh_walk.KERNEL_SOURCE, medium_track.KERNEL_SOURCE])
    # resident blocks per SM of each kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor), per variant
    occupancy = (("wide_traverse_occupancy", [()]), ("wide_traverse_joint_occupancy", [()]),
                 ("brute_megakernel_occupancy", [(m,) for m in range(2 * megakernel.N_PLAIN_MODES)]),
                 ("wide_megakernel_occupancy", [(m,) for m in range(megakernel_wide.N_MODES)]))
    for build, (entry, variants) in zip((wide_bvh.build_kernel, wide_bvh.build_joint_kernel, megakernel.build_kernel,
                                         megakernel_wide.build_kernel), occupancy):
        info = build()
        regs = "; ".join(sorted(set(re.findall(r"Used \d+ registers[^\n]*", info["log"])))) or "n/a"
        spills = "; ".join(sorted(set(re.findall(r"\d+ bytes spill stores, \d+ bytes spill loads",
                                                 info["log"])))) or "n/a"
        occ = [nvcc.occupancy(getattr(info["lib"], entry), *v) for v in variants]
        print(f"[2 build] {Path(info['path']).name} in {info['seconds']:.1f}s; ptxas: {regs}; {spills}; "
              f"blocks per SM by variant {occ}", flush=True)
    info = medium_track.build_kernel()
    regs = "; ".join(f"{r['kernel']}{r['template']} {r['registers']} registers, {r['spill_stores']}/"
                     f"{r['spill_loads']} bytes of spill stores/loads, {r['stack_frame']}-byte frame"
                     for r in _ptxas_entries(info["log"])) or "n/a (built before this run)"
    print(f"[2 build] {Path(info['path']).name} in {info['seconds']:.1f}s; ptxas: {regs}; blocks per SM (delta, "
          f"ratio) {[nvcc.occupancy(info['lib'].medium_track_occupancy, w, 2) for w in (0, 1)]}", flush=True)
    # the walk kernels: the static instantiations (MOTION 0, whose reports
    # equal the parent's) beside the motion ones (MOTION 1: keyframes, 2:
    # the exact animated transform)
    info = bvh_walk.build_kernel()
    print(f"[2 build] {Path(info['path']).name} in {info['seconds']:.1f}s; ptxas per entry (name, template, "
          f"registers, spill stores/loads, stack frame, blocks of 128 per SM): "
          + ("; ".join(f"{r['kernel']}{r['template']} {r['registers']} regs, {r['spill_stores']}/"
                       f"{r['spill_loads']} spill, {r['stack_frame']} stack, {r['blocks_per_sm']} blocks"
                       for r in _walk_entries(info))
             or "none: the library was built before this run (tools/ptxas_report.py --kernel bvh_walk)"), flush=True)
    group = wide_bvh.joint_group_width()
    print(f"[2 build] B2 walks a ray with {group} lanes, {32 // group} rays per warp", flush=True)
    b3_min_blocks = re.search(r"^#define MIN_BLOCKS (\d+)", megakernel.KERNEL_SOURCE.read_text(), re.MULTILINE)[1]
    b3_occ = [megakernel.occupancy(m) for m in range(2 * megakernel.N_PLAIN_MODES)]
    print(f"[2 build] B3 __launch_bounds__(128, {b3_min_blocks}): {b3_occ[0]} blocks of 128 path slots per SM",
          flush=True)

    # --- 3. B1 kernel vs plain at the main path's shapes ---
    cs_host, host_s = _host_scene("mesh_room")
    cs = cs_host.to("cuda")
    sa = cs.arrays
    tab_bytes = {n: getattr(sa, n).numel() * getattr(sa, n).element_size() for n in ("wnode_rec", "wleaf_rec")}
    print(f"[3 scene] {cs.static.n_prims} triangles, host compile {host_s:.1f}s, Hopper wide tables "
          f"{sum(tab_bytes.values())} bytes {tab_bytes}, all tables {sa.byte_size()} bytes", flush=True)
    dev = torch.device("cuda", 0)
    max_err = 0.0
    ms = plain_ms = b1_bound = None
    ray_sets = _rays(cs)
    plain_res = {}  # (ray set, any hit) -> traverse_plain's results, B2's reference in phase 9
    for name, o, d, t_max in ray_sets:
        for any_hit in (False, True):
            label = f"{name}/{'any' if any_hit else 'closest'}"
            share_k, res_k = _lane_share(wide_bvh.traverse_cuda, 32, sa, o, d, t_max, any_hit)
            res_p = plain_res[name, any_hit] = wide_bvh.traverse_plain(sa, o, d, t_max, any_hit)
            max_err = max(max_err, _compare(name, any_hit, res_k, res_p))
            if res_p[5] != (0, 0):
                raise AssertionError(f"plain traversal stack overflow / iteration cap: {res_p[5]}")
            if not all(torch.equal(x, y.to(x.dtype)) for x, y in zip(res_k, res_p[:5])):
                raise AssertionError(f"B1 and the plain traversal differ on {label} (t, idx, b1, b2 or pops)")
            k_ms = _cuda_ms(lambda: wide_bvh.traverse_cuda(sa, o, d, t_max, any_hit), 20)
            pops = res_k[4].double()
            # one lane per ray in a fixed grid: a warp of 32 consecutive rays
            # pops as often as its longest walk
            n32 = -(-pops.numel() // 32) * 32
            per_warp = torch.nn.functional.pad(pops, (0, n32 - pops.numel())).view(-1, 32).max(1).values
            fixed = pops.sum().item() / (32 * per_warp.sum().item())
            print(f"  {label}: B1 {k_ms:.4f} ms, {1e6 * k_ms / pops.sum().item():.4f} ns per pop, pops/ray "
                  f"{pops.mean().item():.2f}; lanes with a ray {share_k:.4f} (one lane per ray in a fixed grid: "
                  f"{fixed:.4f})", flush=True)
            if label == "camera/closest":
                ms = k_ms
                plain_ms = _cuda_ms(lambda: wide_bvh.traverse_plain(sa, o, d, t_max, False), 2)
                # inputs read once (rays, the Hopper tables), outputs written
                # once (t, prim, b1, b2, pops); operations from this run's pops
                b1_bytes = _nbytes(o, d, t_max, sa.wnode_rec, sa.wleaf_rec, *res_k[:5])
                b1_bound = _bound(b1_bytes, float(pops.sum()) * B1_OPS_PER_POP)
                print(f"  camera/closest: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms for {o.shape[0]} rays; "
                      f"pops/ray max {int(pops.max().item())}; bound {b1_bound[0]:.4f} ms ({b1_bound[1]}: "
                      f"{b1_bytes} bytes, {float(pops.sum()):.0f} pops)", flush=True)
    counters = wide_bvh.traverse_cuda.counters[dev].tolist()
    if counters != [0, 0]:
        raise AssertionError(f"kernel stack overflows / iteration-cap hits: {counters}")
    print(f"[3 kernel-vs-plain] ok, equal on all six ray sets; max abs err {max_err:.3e}", flush=True)

    # --- 4. the mesh main path ---
    mesh_timing, b1_launches, mesh_img = _main_path("4 mesh main path", cs, "torch-wavefront/cuda-wide",
                                                    wide_bvh.traverse_cuda)
    counters = wide_bvh.traverse_cuda.counters[dev].tolist()
    if counters != [0, 0]:
        raise AssertionError(f"kernel stack overflows / iteration-cap hits: {counters}")

    # --- 5. the same mesh crop on cuda and cpu ---
    _check_crop("5 cuda-vs-cpu crop", cs, None, cs.description, cpu=_CPU_CROPS["mesh_room_early"].result()["built"])

    # --- 6. B3 kernel vs plain on the spheres gallery ---
    g_host = compile_scene(spheres_gallery(), "cpu")
    g = g_host.to("cuda")
    gd = g.description
    W, H = gd.film.x_resolution, gd.film.y_resolution
    icfg = {"kind": gd.integrator.kind, "max_depth": gd.integrator.max_depth,
            "rr_threshold": gd.integrator.rr_threshold, "strategy": gd.integrator.strategy,
            "light_strategy": gd.integrator.light_strategy}
    fcfg = {"filter": "box", "filter_params": {}, "max_sample_luminance": float("inf")}
    consts = megakernel.extract_consts(g, make_camera(gd.camera, gd.film, "cuda"), icfg,
                                       {"kind": gd.sampler.kind, "spp": gd.sampler.pixel_samples}, fcfg)
    if consts is None:
        raise AssertionError("the spheres gallery is outside the megakernel's class")
    blob = megakernel.pack_consts(consts).to("cuda")
    mode = megakernel.kernel_mode(consts)
    idx = torch.arange(W * H, device="cuda")
    lanes = (idx % W, idx // W, idx)
    L_k, w_k, nv_k = megakernel.megakernel_cuda(blob, mode, *lanes, 0, COMPARE_SPP, SEED)
    L_p, w_p, nv_p = megakernel.megakernel_plain(consts, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    b3_err = _b3_against_plain(f"[6 B3 kernel-vs-plain] {W}x{H} {COMPARE_SPP}spp", (L_k, w_k, nv_k),
                               (L_p, w_p, nv_p))
    spp = gd.sampler.pixel_samples
    b3_ms = _cuda_ms(lambda: megakernel.megakernel_cuda(blob, mode, *lanes, 0, spp, SEED), 5)
    t0 = time.perf_counter()
    out16_p = megakernel.megakernel_plain(consts, *lanes, 0, spp, SEED)
    torch.cuda.synchronize()
    b3_plain_ms = 1e3 * (time.perf_counter() - t0)
    caps = megakernel.megakernel_cuda.counters[dev]
    caps.zero_()
    out16 = megakernel.megakernel_cuda(blob, mode, *lanes, 0, spp, SEED)
    cap_hits = caps.item()
    b3_err = max(b3_err, _b3_against_plain(f"  {W}x{H} {spp}spp", out16, out16_p))
    nv16 = out16[2].double().sum().item()
    # the tests those paths made, from the instrumented instantiation
    # ((0,2) sampler, path: the gallery's mode), which must trace them bit for bit
    *out16_s, split = megakernel.megakernel_split(blob, mode, *lanes, 0, spp, SEED)
    if not all(torch.equal(x, y) for x, y in zip(out16, out16_s)):
        raise AssertionError("the brute megakernel's instrumented instantiation traced other paths")
    t_closest, t_shadow, t_sh_tri, t_sh_sph = (split[k] for k in ("closest", "shadow", "shadow_tri", "shadow_sph"))
    n_tri = sum(p["kind"] == "tri" for p in consts["prims"])
    n_sph = len(consts["prims"]) - n_tri
    b3_bytes = 3 * 4 * W * H + megakernel.BLOB_FLOATS * 4 + 5 * 4 * W * H  # px, py, pid and the blob; L, w, nv
    # per path vertex: one closest-hit and one shadow test over every prim
    # plus the shading (the formula of earlier PRs)
    b3_ops_vertex = nv16 * (2 * (n_tri * B3_OPS_TRI + n_sph * B3_OPS_SPH) + B3_OPS_SHADE)
    b3_bound_vertex = _bound(b3_bytes, b3_ops_vertex)
    # the tests the kernel made: every closest ray (hit or miss) over every
    # prim, every shadow ray up to its first hit; one regeneration per
    # sample; the shading of every path vertex
    b3_ops = (t_closest * (n_tri * B3_OPS_TRI + n_sph * B3_OPS_SPH) + t_sh_tri * B3_OPS_TRI + t_sh_sph * B3_OPS_SPH
              + W * H * spp * B3_OPS_REGEN + nv16 * B3_OPS_SHADE)
    b3_bound = _bound(b3_bytes, b3_ops)
    info = megakernel.build_kernel()
    regs = "; ".join(sorted(set(re.findall(r"Used \d+ registers[^\n]*", info["log"])))) or "n/a"
    spills = "; ".join(sorted(set(re.findall(r"\d+ bytes spill stores, \d+ bytes spill loads", info["log"])))) or "n/a"
    smem = sorted({int(x) for x in re.findall(r"(\d+) bytes smem", info["log"])})
    print(f"  {W}x{H} {spp}spp: kernel {b3_ms:.4f} ms, plain {b3_plain_ms:.1f} ms; {nv16:.0f} path vertices (the "
          f"per-lane kernel's: {GALLERY_VERTICES}), pixels cut by the iteration cap {cap_hits}; tests: closest "
          f"{t_closest}, shadow {t_shadow} (triangle {t_sh_tri}, sphere {t_sh_sph}); per-vertex bound "
          f"{b3_bound_vertex[0]:.4f} ms ({b3_bound_vertex[1]}, {b3_ops_vertex:.4g} ops), kernel at "
          f"{100 * b3_bound_vertex[0] / b3_ms:.2f}% of it; bound from the tests made {b3_bound[0]:.4f} ms "
          f"({b3_bound[1]}, {b3_ops:.4g} ops), kernel at {100 * b3_bound[0] / b3_ms:.2f}% of it", flush=True)
    print(f"  B3 ptxas: {regs}; {spills}; shared bytes per block {smem}; blocks per SM by mode {b3_occ}",
          flush=True)
    if nv16 != GALLERY_VERTICES:
        raise AssertionError("the brute megakernel traced other paths than the per-lane kernel on the gallery")
    if cap_hits != 0:
        raise AssertionError(f"the brute megakernel cut {cap_hits} pixels at the iteration cap")

    # --- 7. the gallery main path ---
    g_timing, b3_launches, _img = _main_path("7 gallery main path", g, "torch-megakernel/cuda-brute",
                                             megakernel.megakernel_cuda)
    if b3_launches != 1:
        raise AssertionError(f"the gallery render made {b3_launches} brute megakernel launches, not 1")
    print(f"  kernel share of the render wall: {100 * b3_ms / (1e3 * g_timing['wall_s']):.1f}%", flush=True)

    # --- 8. the same gallery crop on cuda and cpu ---
    _check_crop("8 cuda-vs-cpu gallery crop", g, g_host, gd)

    # --- 9. B2 against B1 on the six ray sets of phase 3 ---
    b2_ms = {}
    b2_err = 0.0
    for name, o, d, t_max in ray_sets:
        for any_hit in (False, True):
            label = f"{name}/{'any' if any_hit else 'closest'}"
            ref_res = wide_bvh.traverse_cuda(sa, o, d, t_max, any_hit)
            share, res = _lane_share(wide_bvh.traverse_joint_cuda, 32 // group, sa, o, d, t_max, any_hit)
            if not all(torch.equal(x, y) for x, y in zip(res, ref_res)):
                raise AssertionError(f"the cooperative kernel differs from B1 on {label}")
            b2_err = max(b2_err, _compare(f"B2 {name}", any_hit, res, plain_res[name, any_hit]))
            times = [_cuda_ms(lambda: wide_bvh.traverse_cuda(sa, o, d, t_max, any_hit), 20),
                     _cuda_ms(lambda: wide_bvh.traverse_joint_cuda(sa, o, d, t_max, any_hit), 20)]
            b2_ms[label] = times
            pops = float(res[4].double().sum())
            print(f"  {label}: equal to B1; B1 {times[0]:.4f} ms, B2 {times[1]:.4f} ms ({times[1] / times[0]:.3f}x), "
                  f"{1e6 * times[1] / pops:.4f} ns per pop; groups with a ray {share:.4f}", flush=True)
    if wide_bvh.traverse_joint_cuda.counters[dev].tolist() != [0, 0]:
        raise AssertionError("cooperative kernel stack overflows / iteration-cap hits")
    b2_cam_ms = b2_ms["camera/closest"][1]
    print(f"[9 B2 vs B1] ok, bit-equal on all six ray sets; max abs err against plain {b2_err:.3e}; camera/closest "
          f"{b2_cam_ms:.4f} ms against B1 {b2_ms['camera/closest'][0]:.4f} ms", flush=True)

    # --- 10. the mesh main path through the joint kernel ---
    with mock.patch.dict(os.environ, PBRT_TPU_JOINT="1"):
        _t, b2_launches, joint_img = _main_path("10 mesh main path, joint", cs, "torch-wavefront/cuda-wide-joint",
                                                wide_bvh.traverse_joint_cuda)
        if wide_bvh.traverse_cuda.launches != 0:
            raise AssertionError("the joint route launched B1")
    rel_img = np.abs(joint_img - mesh_img).sum() / max(np.abs(mesh_img).sum(), 1e-30)
    print(f"  joint image against phase 4's: sum|a-b|/sum|b| {rel_img:.3e}, bit-equal "
          f"{bool(np.array_equal(joint_img, mesh_img))}", flush=True)
    if not rel_img < 1e-6:
        raise AssertionError("the joint route's image differs from the wavefront's")

    # --- 11. B4 kernel vs plain on material_room ---
    m_host = compile_scene(material_room(), "cpu")
    m = m_host.to("cuda")
    md = m.description
    W, H = md.film.x_resolution, md.film.y_resolution
    icfg = {"kind": "path", "max_depth": md.integrator.max_depth, "rr_threshold": md.integrator.rr_threshold,
            "light_strategy": md.integrator.light_strategy}
    wconsts = megakernel_wide.extract_wide_consts(m, make_camera(md.camera, md.film, "cuda"), icfg,
                                                  {"kind": md.sampler.kind, "spp": md.sampler.pixel_samples}, fcfg,
                                                  megakernel_wide.DEFAULT_MAX_TRIS)
    if wconsts is None:
        raise AssertionError("material_room is outside the wide megakernel's class")
    wblob = megakernel_wide.pack_wide_consts(wconsts).to("cuda")
    wmode = megakernel_wide.kernel_mode(wconsts)
    idx = torch.arange(W * H, device="cuda")
    lanes = (idx % W, idx // W, idx)
    L_k, w_k, nv_k = megakernel_wide.wide_megakernel_cuda(wblob, wmode, m.arrays, *lanes, 0, COMPARE_SPP, SEED)
    t0 = time.perf_counter()
    L_p, w_p, nv_p = megakernel_wide.wide_megakernel_plain(wconsts, m.arrays, *lanes, 0, COMPARE_SPP, SEED)
    torch.cuda.synchronize()
    b4_plain2_s = time.perf_counter() - t0
    ok, desc_cmp = _wide_tolerance(L_k, w_k, nv_k, L_p, w_p, nv_p)
    b4_err = (L_k - L_p).abs().max().item()
    print(f"[11 B4 kernel-vs-plain] material_room {m.static.n_tris} triangles, {W}x{H} {COMPARE_SPP}spp: {desc_cmp}, "
          f"image mean {L_p.mean().item():.5f}; plain twin {b4_plain2_s:.1f} s", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and its plain twin disagree")
    spp = md.sampler.pixel_samples
    b4_ms = _cuda_ms(lambda: megakernel_wide.wide_megakernel_cuda(wblob, wmode, m.arrays, *lanes, 0, spp, SEED), 3)
    t0 = time.perf_counter()
    megakernel_wide.wide_megakernel_plain(wconsts, m.arrays, *lanes, 0, spp, SEED)
    torch.cuda.synchronize()
    b4_plain_ms = 1e3 * (time.perf_counter() - t0)
    pops = megakernel_wide.wide_megakernel_cuda.pops[dev]
    pops.zero_()
    nv16 = megakernel_wide.wide_megakernel_cuda(wblob, wmode, m.arrays, *lanes, 0, spp, SEED)[2].double().sum().item()
    pops_c, pops_s = pops.tolist()
    if megakernel_wide.wide_megakernel_cuda.counters[dev].tolist() != [0, 0]:
        raise AssertionError("wide megakernel stack overflows / iteration-cap hits")
    print(f"  16 spp path vertices {nv16:.0f} (the per-lane kernel's: {MATERIAL_ROOM_VERTICES})", flush=True)
    if nv16 != MATERIAL_ROOM_VERTICES:
        raise AssertionError("the wide megakernel traced other paths than the per-lane kernel on material_room")
    # inputs px, py, pid (int32) and the wide tables read once, outputs L, w,
    # nv written once; operations from this run's pops and path vertices
    b4_bytes = 3 * 4 * W * H + _nbytes(m.arrays.wnode_rec, m.arrays.wleaf_rec) + 5 * 4 * W * H
    b4_ops = (pops_c + pops_s) * B1_OPS_PER_POP + nv16 * B3_OPS_SHADE
    b4_bound = _bound(b4_bytes, b4_ops)
    print(f"  {W}x{H} {spp}spp: kernel {b4_ms:.4f} ms, plain {b4_plain_ms:.1f} ms; {nv16:.0f} path vertices "
          f"({nv16 / (W * H * spp):.3f} per sample), pops closest {pops_c} shadow {pops_s}; bound "
          f"{b4_bound[0]:.4f} ms ({b4_bound[1]}, {b4_ops:.4g} ops, {b4_bytes} bytes), kernel at "
          f"{100 * b4_bound[0] / b4_ms:.2f}% of it", flush=True)

    # --- 12. the material_room main path through B4 ---
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1"):
        m_timing, b4_launches, _img = _main_path("12 material_room main path", m, "torch-megakernel/cuda-wide",
                                                 megakernel_wide.wide_megakernel_cuda)
        if b4_launches != 1:
            raise AssertionError(f"the material_room render made {b4_launches} wide megakernel launches, not 1")
        print(f"  kernel share of the render wall: {100 * b4_ms / (1e3 * m_timing['wall_s']):.1f}%", flush=True)

        # --- 13. the same material_room crop on cuda and cpu ---
        _check_crop("13 cuda-vs-cpu material_room crop", m, m_host, md)

    # --- 14. the mesh room through B4 beside the wavefront ---
    with mock.patch.dict(os.environ, PBRT_TPU_WIDEMEGA="1", PBRT_TPU_WIDEMEGA_MAX_TRIS="200000"):
        mm_timing, _n, _img = _main_path("14 mesh room through B4", cs, "torch-megakernel/cuda-wide",
                                         megakernel_wide.wide_megakernel_cuda)
        x0, x1, y0, y1 = CROP_BOUNDS
        ys, xs = torch.meshgrid(torch.arange(y0, y1, device="cuda"), torch.arange(x0, x1, device="cuda"),
                                indexing="ij")
        crop = (xs.reshape(-1), ys.reshape(-1), (ys * cs.description.film.x_resolution + xs).reshape(-1))
        b4_fn = R_.make_persistent_fn(cs)
        mega = b4_fn(cs.arrays, *crop, 0, CROP_SPP, SEED)
        mega_tier = R_.LAST_PERSISTENT_TIER
        # the render's B4 kernel alone (the route's blob and mode, timed as in
        # phase 11 by CUDA events around the launch wrapper), and its paths
        mW, mH = cs.description.film.x_resolution, cs.description.film.y_resolution
        midx = torch.arange(mW * mH, device="cuda")
        mlanes = (midx % mW, midx // mW, midx)
        mspp = cs.description.sampler.pixel_samples
        b4_launch = lambda: megakernel_wide.wide_megakernel_cuda(  # noqa: E731
            b4_fn.blob, b4_fn.mode, cs.arrays, *mlanes, 0, mspp, SEED)
        mesh_b4_ms = _cuda_ms(b4_launch, 3)
        mesh_nv = b4_launch()[2].double().sum().item()
    wave = R_.make_persistent_fn(cs)(cs.arrays, *crop, 0, CROP_SPP, SEED)
    ok, desc_cmp = _wide_tolerance(*mega, *wave)
    vps_b4 = mm_timing["n_vertices"] / mm_timing["wall_s"]
    vps_wave = mesh_timing["n_vertices"] / mesh_timing["wall_s"]
    print(f"[14 mesh room B4 vs wavefront] path_vertex_samples_per_sec B4 {vps_b4:.1f}, wavefront (phase 4) "
          f"{vps_wave:.1f}, ratio {vps_b4 / vps_wave:.3f}; B4 kernel {mesh_b4_ms:.4f} ms beside the render wall "
          f"{1e3 * mm_timing['wall_s']:.4f} ms; 16 spp path vertices {mesh_nv:.0f} (the per-lane kernel's: "
          f"{MESH_ROOM_VERTICES}); {x1 - x0}x{y1 - y0} {CROP_SPP}spp crop ({mega_tier} vs "
          f"{R_.LAST_PERSISTENT_TIER}): {desc_cmp}", flush=True)
    if not ok:
        raise AssertionError("the wide megakernel and the wavefront disagree on the mesh room crop")
    if mesh_nv != MESH_ROOM_VERTICES:
        raise AssertionError("the wide megakernel traced other paths than the per-lane kernel on the mesh room")

    # --- 15-19. the wavefront on the megakernels' scenes and on its own ---
    wf = _unswitched(_wavefront_phases, cs, cs_host, m, m_host, g, g_host, m_timing, g_timing)
    print(f"[15-19 wavefront] {json.dumps(wf)}", flush=True)

    # --- 20-21. the front end on files of the port's own scenes ---
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        fe = _unswitched(_front_end_phases, work, mesh_timing, mesh_img, cs_host, m, m_host)
        print(f"[20-21 front end] {json.dumps(fe)}", flush=True)
        # --- 22-24. B4's samplers, filters, attribute rows and sky; pbrt's
        # defaults through B4; infinite lights through the wavefront ---
        sk = _unswitched(_sky_phases, work, m, m_host, b4_ms, fe)
        print(f"[22-24 sky] {json.dumps(sk)}", flush=True)
        # --- 25-27. textures: the wavefront, B3's Kd atlas, B4's checkerboard ---
        tx = _unswitched(_texture_phases, work, g, b3_ms, b3_bound_vertex, m, b4_ms)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[25-27 textures] {json.dumps({k: v for k, v in tx.items() if not k.endswith('instantiations')})}",
          flush=True)
    # --- 28-30. spheres and sphere lamps in wide scenes; B4's spheres; uber ---
    t_group = time.perf_counter()
    sph = _unswitched(_sphere_phases, cs, b4_ms, g)
    print(f"[28-30 spheres] in {time.perf_counter() - t_group:.1f}s: "
          f"{json.dumps({k: v for k, v in sph.items() if not k.endswith('instantiations')})}", flush=True)
    # --- 31-33. substrate, translucent, disney, mix, fourier and hair ---
    t_group = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        mt = _unswitched(_material_phases, work, m, b4_ms)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[31-33 materials] in {time.perf_counter() - t_group:.1f}s: "
          f"{json.dumps({k: v for k, v in mt.items() if not k.endswith('instantiations')})}", flush=True)
    # --- 34-37. quadrics, instancing, the kd-tree, alpha, gonio and projection
    # lights, the orthographic and environment cameras; the walk kernel ---
    t_group = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        wk = _unswitched(_walk_phases, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[34-37 walks] in {time.perf_counter() - t_group:.1f}s: {json.dumps(wk)}", flush=True)

    # --- 38-42. the per-sample wave: volpath, media, subsurface, whitted, ao,
    # checkpoints; the medium_track kernel ---
    t_group = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        wv = _unswitched(_wave_phases, work, cs, cs_host)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[38-42 wave] in {time.perf_counter() - t_group:.1f}s: {json.dumps(wv)}", flush=True)

    # --- 43-47. motion blur, the animated and realistic cameras, BDPT ---
    t_group = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        mb = _unswitched(_motion_bdpt_phases, work, cs, cs_host, mesh_img)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[43-47 motion, realistic, bdpt] in {time.perf_counter() - t_group:.1f}s: {json.dumps(mb)}", flush=True)

    # --- 48-51. MLT and SPPM, the mesh agreement, cuda against cpu ---
    t_group = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        mls = _unswitched(_mlt_sppm_phases, work, cs, cs_host, mb["bdpt_mesh"]["mean"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[48-51 mlt, sppm] in {time.perf_counter() - t_group:.1f}s: {json.dumps(mls)}", flush=True)

    # --- 52. one image over two shards of the card (parallel/shard.py) ---
    t_group = time.perf_counter()
    sh = _unswitched(_shard_phases, cs, mesh_img)
    print(f"[52 shards] in {time.perf_counter() - t_group:.1f}s: seconds by sub-phase {json.dumps(sh['seconds'])}",
          flush=True)

    print(f"[timing] phases 1-52 in {time.perf_counter() - t_script:.1f}s", flush=True)
    report = {"kernels": [
        {"name": "wide_traverse", "route": "cuda", "source": "pbrt_tpu_torch/csrc/wide_traverse.cu",
         "replaces": "pbrt_tpu/device/pallas_bvh.py:90", "launches": b1_launches, "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None,
         "launches_by_route": {"wavefront": b1_launches, "mlt": mls["mlt_mesh"]["launches"],
                               "sppm": mls["sppm_mesh"]["launches"],
                               **{f"shard2_{k}": sh[k]["b1_launches"][0] for k in ("path", "bdpt", "mlt", "sppm")}}},
        {"name": "wide_traverse_joint", "route": "cuda", "source": "pbrt_tpu_torch/csrc/wide_traverse_joint.cu",
         "replaces": "pbrt_tpu/device/pallas_bvh.py:326", "launches": b2_launches, "max_abs_err": b2_err,
         "ms": b2_cam_ms, "plain_ms": plain_ms, "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
         "library_ms": None},
        {"name": "brute_megakernel", "route": "cuda", "source": "pbrt_tpu_torch/csrc/megakernel.cu",
         "replaces": "pbrt_tpu/device/megakernel.py:814", "launches": b3_launches, "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound_vertex[0], "bound_by": b3_bound_vertex[1],
         "library_ms": None, "bound_ms_from_tests": b3_bound[0], "instantiations": tx["b3_instantiations"]},
        {"name": "wide_megakernel", "route": "cuda", "source": "pbrt_tpu_torch/csrc/megakernel_wide.cu",
         "replaces": "pbrt_tpu/device/megakernel_wide.py:525", "launches": b4_launches, "max_abs_err": b4_err,
         "ms": b4_ms, "plain_ms": b4_plain_ms, "bound_ms": b4_bound[0], "bound_by": b4_bound[1],
         "library_ms": None,
         "instantiations": {**sk["instantiations"], **tx["b4_instantiations"], **sph["b4_instantiations"],
                            **mt["b4_instantiations"]}},
        {"name": "bvh_walk", "route": "cuda", "source": "pbrt_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "none (pbrt_tpu/device/intersect.py:487 _traverse, an XLA loop)",
         "launches": wk["quadric_room_bvh"]["walk_launches"], "max_abs_err": wk["walk_bvh"]["max_abs_err"],
         "ms": wk["walk_bvh"]["ms"], "plain_ms": wk["walk_bvh"]["plain_ms"], "bound_ms": wk["walk_bvh"]["bound_ms"],
         "bound_by": wk["walk_bvh"]["bound_by"], "library_ms": None},
        {"name": "kd_walk", "route": "cuda", "source": "pbrt_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "none (pbrt_tpu/device/intersect.py:893 _traverse_kd, an XLA loop)",
         "launches": wk["quadric_room_kdtree"]["walk_launches"], "max_abs_err": wk["walk_kdtree"]["max_abs_err"],
         "ms": wk["walk_kdtree"]["ms"], "plain_ms": wk["walk_kdtree"]["plain_ms"],
         "bound_ms": wk["walk_kdtree"]["bound_ms"], "bound_by": wk["walk_kdtree"]["bound_by"], "library_ms": None},
        {"name": "medium_track", "route": "cuda", "source": "pbrt_tpu_torch/csrc/medium_track.cu",
         "replaces": "none (pbrt_tpu/device/media.py:183 and :248, lax.while_loops of delta and ratio tracking)",
         "launches": sum(wv["fog_room"]["launches"][k] for k in ("delta_track_cuda", "ratio_track_cuda")),
         "max_abs_err": max(wv["medium_track"][k]["max_abs_err"] for k in ("delta_track", "ratio_track")),
         "ms": wv["medium_track"]["delta_track"]["ms"], "plain_ms": wv["medium_track"]["delta_track"]["plain_ms"],
         "bound_ms": wv["medium_track"]["delta_track"]["bound_ms"],
         "bound_by": wv["medium_track"]["delta_track"]["bound_by"], "library_ms": None,
         "launches_by_entry": {k: wv["fog_room"]["launches"][k] for k in ("delta_track_cuda", "ratio_track_cuda")},
         **{k: wv["medium_track"]["delta_track"][k] for k in ("alone_ms", "mixed_alone_ms", "empty_alone_ms")},
         "ratio_track": {k: wv["medium_track"]["ratio_track"][k]
                         for k in ("ms", "alone_ms", "plain_ms", "bound_ms", "bound_by", "mixed_alone_ms",
                                   "empty_alone_ms")}},
        {"name": "bvh_walk_motion", "route": "cuda", "source": "pbrt_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "none (pbrt_tpu/device/intersect.py:487 _traverse with time, its leaf test :575-600, an XLA loop)",
         "launches": mb["motion_room"]["launches"]["bvh_walk_motion_cuda"],
         "max_abs_err": mb["motion_walk"]["max_abs_err"], "ms": mb["motion_walk"]["ms"],
         "plain_ms": mb["motion_walk"]["plain_ms"], "bound_ms": mb["motion_walk"]["bound_ms"],
         "bound_by": mb["motion_walk"]["bound_by"], "library_ms": None},
        {"name": "kd_walk_motion", "route": "cuda", "source": "pbrt_tpu_torch/csrc/bvh_walk.cu",
         "replaces": "none (pbrt_tpu/device/intersect.py:893 _traverse_kd with time, its _test_prims :326-354, an "
                     "XLA loop)",
         "launches": mb["motion_room_kd"]["launches"]["kd_walk_motion_cuda"],
         "max_abs_err": mb["kd_motion_walk"]["motion2"]["max_abs_err"], "ms": mb["kd_motion_walk"]["motion2"]["ms"],
         "plain_ms": mb["kd_motion_walk"]["motion2"]["plain_ms"],
         "bound_ms": mb["kd_motion_walk"]["motion2"]["bound_ms"],
         "bound_by": mb["kd_motion_walk"]["motion2"]["bound_by"], "library_ms": None,
         "keyframes": {k: mb["kd_motion_walk"]["motion1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
    ]}
    print(json.dumps(report))
    print(_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for _pool in _POOL:  # phase 2's workers: no task left pending, every process ended
            _pool.shutdown(wait=True, cancel_futures=True)
    sys.exit(rc)
