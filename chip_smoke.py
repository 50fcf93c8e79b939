#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, ~8-10 min with the build

    python3 chip_smoke.py --film         # the film phase alone

    python3 chip_smoke.py --gradients    # the boundary, polarized,
                                         # Stokes and TF32 gradient phases

    python3 chip_smoke.py --turns ROOT   # B1, B2, B4, B7a, B7b, B5, B6,
                                         # B8a, B8b, B9, B10a, B10b, B11a,
                                         # B11b, B11c, the lobe sum's
                                         # forward and backward and the
                                         # gradient cells of the package
                                         # in ROOT

Seventeen paths: the PLT flagship (grating_scene, B1-B4), the fixed-depth
path tracer on the 81,920-face mesh scene over the clu2 route (B5-B6), the
regenerative path tracer in Morton order on the same scene over the
packet-BVH route (B7a, B7b), the intersection bench tool
(`mitsuba3_plt_tpu_torch/tools/bench_isect.py`: B1, B2, B7a and the brute
forces B8a, B8b, B9 on the Cornell box's rays and on a 5,120-face
icosphere), the cluster-mask sort tool (`tools/isect_mask_sort.py`: the
flat cluster kernels B10a, B10b beside B1, B2) and the unroll sweep
(`tools/isect_unroll_sweep.py`: B11a, B11b beside B1, B2) and the
multi-accumulator q closest hit (`tools/isect_q_multiacc.py`: B11c beside
B1) on the same two scenes, the per-kernel MFU tool
(`tools/kernel_mfu.py`: the FMA roof probe B11d, an HBM probe, B1, B2, B5
and B4 against the card's measured and published roofs), the path
tracer on the Cornell box (B1, B2, area light) with its diffuse, dielectric
and conductor boxes, the PLT integrator on its grating box (B1-B4 at
half = 2), the white furnace (B1, B2, the constant environment), and
polarized transport: PLT on the grating scene under the RGB-polarized
config (B1-B4) and the Stokes wrapper of the Mueller path tracer on the
glass box (B1, B2); and gradients: render_loss_grad through PLT on the
grating scene (B1-B3 and B4's recording instance forward, recomputed
under the checkpoint, and B4b, the lobe sum's backward over its bits) and through the path tracer and PRB on the
Cornell box (B1, B2), with Adam steps; the silhouette boundary terms of
the vertex rows on tests/test_projective.py's four scenes (B1, B2 through
the probe renders and visibility tests), polarized PLT's gradient on the
grating scene (B1-B3, B4's recording instance, B4b) and the Stokes path's
on the Cornell boxes (B1, B2).
Phases, each printing one JSON line with its seconds:
  card            name and power limit (nvidia-smi) and torch's device name;
  build           the CUDA kernels from ops/csrc (one nvcc per source, all
                  started together), with nvcc's register and spill report,
                  the special functions' fast paths in the SASS
                  (`ops/mfu.py::special_fn_counts`), which weigh B4's
                  bound, the instructions a (ray, row) test by class
                  of B1, B2 and the sweep's instances (B11a, B11b, B11c:
                  `q_sass_counts`), whose FFMAs their bounds count, B9's
                  HMMA and other instructions a step of its row loop, and
                  B8a's a (ray, row) test, of the filter on a trip without
                  candidates and of the exact test on every pair;
  cbox-scene      cornell_box(512, 512): 36 faces, the brute route, the
                  area light's tables;
  kernels         each kernel against its plain PyTorch version on the
                  card, at the main paths' lane counts, with the tolerance
                  stated, timed with CUDA events (10 back-to-back calls,
                  median of 7; the clu2 and BVH plain walks once per ray
                  set); a kernel whose calls take under 0.15 ms so is timed
                  again on the device, a CUDA graph of 10 calls replayed
                  between events, and keeps the event time as
                  `wrapper_ms` (`kernel_times`). B1 and B2 on the
                  grating's rays and on the Cornell box path's own first
                  camera and shadow rays (2,097,152 lanes, 36 faces),
                  their measured bounds taking each FFMA of a test (read
                  from the SASS; the hand count beside it) as one slot. B4
                  on four cases (its bound counted by
                  `lobe_sum_count`). B1 and B2 also on the dielectric
                  box path's second closest-hit and any-hit calls (the
                  first rays that leave the surfaces, refracted ones
                  inside the glass among them), and B3 and B4 on the
                  grating box path's own first sample and NEE eval inputs
                  (half = 2, height 0.25 um, coherence 1), each at the
                  tolerances stated (`hold_sample`, `hold_lobe_sum`).
                  B4's recording instance (the selection bits its gates
                  leave, launched where autograd records) on the same
                  inputs: its sum equal to B4's to the bit, its bits to
                  the plain version's (`grating_lobe_sum_sel_plain`) but
                  for lobes within float rounding of a gate, each named
                  (`hold_record`). B4b (the lobe sum's backward, fed
                  those bits) against autograd of B4's plain version
                  with a seeded cotangent on B4's four cases and on the
                  grating box's inputs, per input at rtol 2e-3 plus 2e-5
                  of its largest gradient (`hold_lobe_sum_bwd`), every
                  lane outside it shown a gate flip or not
                  (`explain_lobe_sum_bwd`, its lanes' inputs written to
                  chiprun_out/lobe_sum_bwd_outliers.json), its bound
                  counted by `lobe_sum_bwd_own_count` beside PR 17's
                  count of the whole VJP (`lobe_sum_bwd_count`). B5
                  (camera, bounce, bounce-random,
                  dead) and B6 (shadow, shadow-random, dead) on the mesh82k
                  scene at 1,048,576 lanes, equal to their plain walk (root
                  box, groups of supers, then the DFS walk) to the bit and
                  to the DFS walk without the gates, each row with the
                  plain walk's tests a ray (its bound's count) and the DFS
                  walk's beside them. B7a and B7b (both over the WideBVH)
                  run on the five live mesh82k ray sets of B5/B6 and on
                  all-dead sets at 1,048,576 lanes, unsorted and sorted by
                  the route's coherence sort, whose own time is printed,
                  and on the 131,072-lane wavefront the regenerative path
                  gives them, each equal to its plain walk to the bit and
                  B7b also to the skip-link walk over the PacketBVH; the
                  rows carry the plain walk's pops and triangle tests a ray
                  (mean, and the mean of each warp's most). For the
                  wavefront's shadow rays one line says whether the sort
                  pays for B7b (the kernel unsorted against sorted plus
                  the sort, gathers and unsort).
                  B8a, B8b and B9 run on the tool's coherent and incoherent
                  sets of the Cornell box and of the 5,120-face icosphere at
                  1,048,576 lanes, held to their plain versions on all the
                  box's lanes and on the icosphere's first 131,072 (B8 to
                  the bit, B9 within its tolerance; B8a on every 8th
                  lane, spread over the set), and B8a and B9 on every
                  lane to their filter-off instances to the bit (every
                  pair through the exact or the FP32 test; no hit dropped
                  by either filter), B8a's bound the smaller of its
                  filter on every pair with the exact test on the
                  candidates counted and the whole test on every pair,
                  B9's the tensor-core one. B10a (incoherent,
                  depth0) and B10b (shadow0) on the mask-sort tool's
                  icosphere sets, B11a at every unroll with one and two
                  accumulators and B11b at every unroll on the sweep's
                  rays of both scenes, all at 1,048,576 lanes, held on
                  131,072 lanes spread over the set (all of the Cornell
                  box's for B11): B11b (B2's row test) equal on every lane
                  to B2 with an infinite maxt as -1, to the bit, and to its
                  plain version on 1 - 1e-4 of lanes, B11a (B1's row
                  test; the call that is timed) near
                  its plain version (`q_close`: prims on 1 - 1e-4 of
                  lanes, t at rtol 1e-5 on all but 2e-3 of the hits and
                  at rtol 1e-3 on every one) and on every lane equal to
                  B1 over each group's rows to the bit (`q_groups`: with
                  one accumulator, B1 itself); B11c at nacc 2, 4 and 8 on
                  the multi-accumulator tool's 2,097,152 rays of both
                  scenes, held the same way (t, prim, u, v); B11d at
                  8,192 x 128 on random inputs, within 1 ulp of its plain
                  version;
  isect-tool      bench_isect.run on both scenes: one row per route and ray
                  set (ms, M rays/s, agreement with brute-classic), and the
                  launches of one run on one set;
  mask-sort       isect_mask_sort.run on both scenes (1,048,576 rays a
                  set): the launches of one run on two sets, each sorted
                  and Morton pipeline equal to the unsorted kernel on every
                  lane, one row per route and set (ms, ms per M rays,
                  agreement with q);
  unroll-sweep    isect_unroll_sweep.run on both scenes (2^20 rays): the
                  launches of one run, one row per variant;
  q-multiacc      isect_q_multiacc.run on both scenes (2^21 rays): the
                  launches of one run, one row per nacc (prim agreement
                  with B1 >= 0.99);
  kernel-mfu      B11d's SASS (one FFMA and one FMNMX a chain a step), the
                  launches of one run of every probe, then the probes
                  timed: the FMA roof and HBM bandwidth chained, B1/B2 on
                  the q-multiacc rays of both scenes, B5 on the camera
                  rays of mesh_scene(1024, 1024, 6) with the host BVH walk,
                  B4 on the JAX tool's inputs, each against the measured
                  and the published roofs;
  golden          grating_scene(24, 24, coherence=1e3), PLT depth 3 / rr 9,
                  4 seeds x 12 spp, Sidak z-test against tests/golden/
                  grating_plt.npz;
  golden-mesh20k  mesh_scene(32, 32, subdiv=5), path depth 3 / rr 9, 4 seeds
                  x 8 spp, z-test against tests/golden/mesh20k_path.npz;
  golden-mesh20k-packet  the same on the packet route;
  golden-cbox     cornell_box(32, 32), path depth 4 / rr 9, 4 seeds x 16 spp,
                  z-test against tests/golden/cbox_path.npz;
  golden-cbox-conductor, -roughconductor, -dielectric, -grating-plt
                  cornell_box(32, 32, box_material=...), path (PLT for the
                  grating) depth 4 / rr 9, 4 seeds x 16 spp, z-tests
                  against the JAX package's renders in tests/golden_torch/;
  golden-cbox-gaussian, golden-analytic  the same for cornell_box(32, 32)
                  through the Gaussian filter and for analytic_scene(32,
                  32) through the multijitter sampler;
  furnace         furnace_scene(64, 64, albedo=0.6), path depth 6 / rr 20,
                  96 spp: the sphere's centre within 3% of the albedo, the
                  corner within 0.02 of the environment's 1.0;
  golden-cbox-stokes  cornell_box(24, 24, box_material="dielectric"),
                  StokesIntegrator() (path depth 6 / rr 5, forward basis),
                  15 channels, 4 seeds x 12 spp, z-test against the JAX
                  package's tests/golden/cbox_stokes.npz;
  dop-golden-cbox-stokes  its mean image's degree of linear polarization:
                  above 0.1 somewhere, at most 1 + 1e-3 where S0 > 1e-3;
  collapse        cornell_box(128, 128) (all diffuse), depth 7 / rr 50, 8
                  spp: the Stokes image's S0 equal to the path tracer's to
                  the bit, S1-S3 exactly 0, force_full within rtol 2e-5 /
                  atol 1e-6;
  main            grating_scene(800, 600), PLT depth 7 / rr 50, 4 spp per
                  pass: one warm-up pass, three timed passes; the image must
                  be finite and non-zero, its four kernels launch 7 times per
                  pass (once per bounce) and the clu2 kernels never;
  split           device time of one such pass by kernel (torch.profiler),
                  written to chiprun_out/chip_smoke_profile.json;
  main-mesh82k    mesh_scene(512, 512, subdiv=6), path depth 4 / rr 3, 4 spp
                  per pass, as `main`: the clu2 kernels launch 4 times per
                  pass, the q and grating kernels never;
  split-mesh82k   as `split`, to chiprun_out/chip_smoke_profile_mesh82k.json;
                  each split line also gives the intersection kernels'
                  device ms a launch;
  main-mesh82k-packet  the same scene on the packet route,
                  render(regen=True, pixel_order="morton"): 131,072 lanes,
                  B7a and B7b launch once per loop iteration, B1-B6 never;
                  the image equals the fixed-depth Morton render of the same
                  seed at rtol 2e-5 / atol 2e-6, and the scanline render to
                  noise;
  split-mesh82k-packet  to chiprun_out/chip_smoke_profile_mesh82k_packet.json;
  main-mesh82k-regen   the regenerative render on the clu2 route (B5 and B6
                  once per iteration), held to its fixed-depth render;
  main-cbox       cornell_box(512, 512), path depth 7 / rr 50, 8 spp per
                  pass (2,097,152 lanes), as `main`: B1 and B2 launch 7
                  times per pass, no other kernel;
  split-cbox      to chiprun_out/chip_smoke_profile_cbox.json;
  main-cbox-gaussian  the same through the Gaussian filter (render(rfilter=
                  FILTER_GAUSSIAN)), as `main-cbox`, with its ms/spp and peak
                  memory beside main-cbox's (main-cbox-gaussian-vs-box);
  split-cbox-gaussian  to chiprun_out/chip_smoke_profile_cbox_gaussian.json;
  load-dict-mesh82k  the JAX bench's mesh82k dict (make_sphere(6), a
                  point light, diffuse 0.7, 512x512) through the package's
                  load_dict: every array it hands the bridge, `ctab2.*`
                  included, equal to presets.mesh_scene_arrays(512, 512,
                  6)'s to the bit, the load's seconds beside the preset's;
  main-mesh82k-dict  that scene as main-mesh82k (B5/B6 4 a pass), with
                  split-mesh82k-dict and its ms/spp beside main-mesh82k's;
  main-cbox-xml   the Cornell box written as XML (scene/xml_scenes.py:
                  rectangles and cubes under <transform>s, the gaussian
                  filter, path depth 7 / rr 50, 8 spp a pass) through
                  load_file and the package's render((scene, meta)): B1/B2
                  7 a pass, with split-cbox-xml, beside main-cbox-gaussian;
  golden-cbox-xml the same XML at 32x32 through PathIntegrator(4, 9) and
                  the box filter, z-tested against tests/golden/cbox_path
                  .npz;
  main-grating-xml  the grating scene as XML (PLT depth 7 / rr 50,
                  800x600, 4 spp a pass, the box filter): B1-B4 7 a pass,
                  the keys whose arrays differ from grating_scene_arrays'
                  printed, with split-grating-xml, beside main;
  cli             `python -m mitsuba3_plt_tpu_torch.cli` on the XML box at
                  128x128, 16 spp, as a subprocess: its .pfm equal to an
                  in-process render to the bit, its .png and
                  time_per_sample (files under chiprun_out/loaders/);
  film            the Cornell box path's first pass: the ordered filtered
                  splat against the scatter `put` (gaussian, mitchell,
                  lanczos; 3 and 15 channels), both timed;
  split-cbox-gaussian-splat  the gaussian splat alone by kernel;
  cameras         every sampler type on every sensor type, 64x64x16: the
                  card's rays and uv against the CPU's (atol 1e-5);
  main-analytic   presets.analytic_scene(512, 512) (assemble_scene: a floor,
                  an analytic sphere light, disk and cylinder; thinlens,
                  multijitter), path depth 7 / rr 50, 8 spp a pass: B1 and
                  B2 7 times a pass; split-analytic its profile;
  main-cbox-dielectric, main-cbox-conductor  cornell_box(512, 512,
                  box_material=...), as `main-cbox`: B1 and B2 7 times a
                  pass, no other kernel;
  split-cbox-dielectric  to chiprun_out/chip_smoke_profile_cbox_dielectric
                  .json;
  main-cbox-grating-plt  the grating box, PLT depth 7 / rr 50, 8 spp per
                  pass: B1-B4 7 times a pass;
  main-grating-polarized  grating_scene(800, 600), PLT depth 7 / rr 50
                  under RGB_POLARIZED (film S0), 2 spp a pass (960,000
                  lanes), a warm-up pass and 8 timed: B1-B4 7 times a pass;
  split-grating-polarized  to chiprun_out/chip_smoke_profile_grating_
                  polarized.json;
  main-cbox-stokes  cornell_box(512, 512, box_material="dielectric"),
                  StokesIntegrator(PolarizedPathIntegrator(7, 50),
                  forward_basis=False), 15 channels, 2 spp a pass (524,288
                  lanes), as main-grating-polarized: B1, B2 7 times a pass;
  dop-main-cbox-stokes  its image's degree of polarization, as above;
  split-cbox-stokes  to chiprun_out/chip_smoke_profile_cbox_stokes.json;
  grad-grating-800x600-plt  render_loss_grad of the mean image on the
                  grating scene's four grating parameters, PLT depth 7 /
                  rr 50, 4 spp (four checkpointed passes of 480,000
                  lanes): a warm-up and two timed evaluations (ms each,
                  peak memory), finite non-zero gradients, B1-B4 twice a
                  bounce and pass and B4b once, the height's and
                  inv_period's signs against central differences;
  split-grad-grating  device time of one such evaluation by kernel
                  (torch.profiler), to chiprun_out/chip_smoke_profile_grad_
                  grating.json;
  grad-cbox-512x512  cornell_box(512, 512), depth 7 / rr 50, 4 spp (two
                  passes): PRB's primal against the path tracer's
                  differentiable render (rtol 2e-4), PRB's base_color
                  gradient against the path tracer's (within 0.1 of the
                  largest), each timed with its peak memory, then five
                  Adam steps of PRB toward a target with the white wall's
                  albedo halved (ms a step, peak memory, a falling loss);
  split-grad-cbox-prb  one PRB gradient evaluation by kernel, to
                  chiprun_out/chip_smoke_profile_grad_cbox_prb.json;
  grad-boundary-rectangle, -cube, -shadow, -penumbra  tests/test_projective
                  .py's scenes (presets.boundary_scene_dict) at 512x512
                  through load_dict, the loss sum(ramp_x * image):
                  render_loss_grad on the vertex rows at 16 spp with and
                  without the boundary terms (2^20 edge samples a term,
                  2,097,152 probe lanes), each timed with its launches (B1
                  and B2 only), the interior term zero, the moving
                  object's x-translation gradient within JAX's tolerance
                  (0.12, 0.12, 0.2, 0.25) of a central difference of the
                  card's own render at 64 spp and JAX's step; each with a
                  split-grad-boundary-* profile (busy ms, idle share);
  grad-grating-800x600-plt-polarized  grad-grating under RGB_POLARIZED
                  (film S0): B1-B3 and B4's recording instance twice a
                  bounce and pass, B4b once, the height's gradient within
                  5e-2 of the card's central difference; with
                  split-grad-grating-polarized;
  grad-cbox-stokes  the Stokes path (depth 7 / rr 50) at 512x512, 4 spp:
                  the diffuse box's S0 base_color gradient against the
                  scalar path's (within 1e-5 of the largest; to the bit
                  or not, printed), the conductor box's eta_re / eta_im
                  against central differences (2e-3), the glass box's
                  eta_re against the CPU's on the 128x128 box (1e-2 of the
                  largest), its central differences printed beside it;
  tf32-grad-cbox  grad-cbox's path gradient with the caller's TF32 flags
                  off, on, off: equal (or within the run-to-run gap), the
                  flags as set.
Then the kernel list (each kernel's launches from its own path: B8a, B8b
and B9 from one tool run on one ray set, B10 and B11 from one run of
their tools, B4b from grad-grating's timed evaluations; each bound
against the published peaks and against the roofs the kernel-mfu phase
measured), the nvidia-smi line, and the final status line. Every failure raises and exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (dense): fp32 outside the tensor cores, TF32 on
# them, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

MAIN_W, MAIN_H, MAIN_SPP_PASS = 800, 600, 4
MAIN_DEPTH, MAIN_RR = 7, 50
MESH_W, MESH_H, MESH_SUBDIV, MESH_SPP_PASS = 512, 512, 6, 4
MESH_DEPTH, MESH_RR = 4, 3
CBOX_W, CBOX_H, CBOX_SPP_PASS = 512, 512, 8
CBOX_DEPTH, CBOX_RR = 7, 50
TOOL_LANES = 1 << 20       # rays per set of the intersection tool
MACC_LANES = 1 << 21       # rays of the multi-accumulator tool and the
                           # MFU tool's q probes
FMA_WIDE_ROWS = 1 << 16    # the FMA roof probe at 8x the JAX tool's rows
TOOL_SUBDIV = 4            # its icosphere: 5,120 faces
CHUNKED_SUBDIV = 5         # 20,480 faces: above B8b's resident table
PLAIN_LANES = 131072       # lanes the icosphere's plain B8/B9 run on
CHUNKED_COUNT_LANES = 16384  # lanes B8b's tests are counted on, 20,480 faces
TIMED_PASSES = 3
# the cameras phase: every sampler on every sensor at 64 x 64 x 16 spp
CAM_W, CAM_H, CAM_SPP = 64, 64, 16
# wrapper times below this are timed again on the device (`kernel_times`)
DEVICE_TIMED_BELOW_MS = 0.15

# kernel launches per pass of each main path; ITER stands for the
# iterations of the regenerative loop in that pass
ITER = "iteration"
NO_LAUNCHES = dict.fromkeys(
    ("intersect_q", "occluded_q", "grating_sample", "grating_lobe_sum",
     "intersect_clu2", "occluded_clu2", "intersect_bvh", "occluded_bvh",
     "intersect_classic", "occluded_classic", "intersect_mxu",
     "intersect_clu", "occluded_clu", "intersect_q_variant",
     "occluded_q_variant", "intersect_q_macc", "fma_roof",
     "grating_lobe_sum_bwd", "grating_lobe_sum_record"), 0)
GRATING_LAUNCHES = {**NO_LAUNCHES, "intersect_q": MAIN_DEPTH,
                    "occluded_q": MAIN_DEPTH, "grating_sample": MAIN_DEPTH,
                    "grating_lobe_sum": MAIN_DEPTH}
MESH_LAUNCHES = {**NO_LAUNCHES, "intersect_clu2": MESH_DEPTH,
                 "occluded_clu2": MESH_DEPTH}
PACKET_LAUNCHES = {**NO_LAUNCHES, "intersect_bvh": ITER, "occluded_bvh": ITER}
REGEN_CLU2_LAUNCHES = {**NO_LAUNCHES, "intersect_clu2": ITER,
                       "occluded_clu2": ITER}
CBOX_LAUNCHES = {**NO_LAUNCHES, "intersect_q": CBOX_DEPTH,
                 "occluded_q": CBOX_DEPTH}
CBOX_PLT_LAUNCHES = {**CBOX_LAUNCHES, "grating_sample": CBOX_DEPTH,
                     "grating_lobe_sum": CBOX_DEPTH}
# the Cornell box's other boxes at the cbox cell's size: (phase,
# box_material, integrator, launches a pass)
CBOX_BOXES = (("main-cbox-dielectric", "dielectric", "path", CBOX_LAUNCHES),
              ("main-cbox-conductor", "conductor", "path", CBOX_LAUNCHES),
              ("main-cbox-grating-plt", "grating", "plt", CBOX_PLT_LAUNCHES))
# the port's golden references of those boxes (tests/golden_torch/, made by
# tests/test_torch_golden_specular.py): (phase, box_material, integrator,
# file), 32 x 32, depth 4 / rr 9, 4 seeds x 16 spp
GOLDEN_BOXES = (
    ("golden-cbox-conductor", "conductor", "path", "cbox_conductor_path.npz"),
    ("golden-cbox-roughconductor", "roughconductor", "path",
     "cbox_roughconductor_path.npz"),
    ("golden-cbox-dielectric", "dielectric", "path",
     "cbox_dielectric_path.npz"),
    ("golden-cbox-grating-plt", "grating", "plt", "cbox_grating_plt.npz"))
FURNACE_W, FURNACE_H, FURNACE_SPP, FURNACE_ALBEDO = 64, 64, 96, 0.6
# the polarized paths (bench.py's polarized rows): 16 spp, 2 a pass, the
# passes timed after a warm-up pass
POL_SPP_PASS, POL_PASSES = 2, 8
POL_GRATING_LAUNCHES = GRATING_LAUNCHES
POL_CBOX_LAUNCHES = CBOX_LAUNCHES
# the collapse check: the diffuse box, depth 7 / rr 50, 8 spp
COLLAPSE_W, COLLAPSE_H, COLLAPSE_SPP = 128, 128, 8
# the gradient paths: render_loss_grad of a mean loss on the grating
# scene's four grating parameters (PLT depth 7, 4 spp: four passes of
# 480,000 lanes), timed over GRAD_EVALS evaluations after a warm-up; the
# Cornell box's path and PRB gradients (depth 7, 2 spp a pass) and
# ADAM_STEPS steps recovering a halved wall albedo
GRAD_SPP, GRAD_EVALS = 4, 2
GRAD_KEYS = ("materials.grt_inv_period", "materials.grt_height",
             "materials.grt_multiplier", "materials.grt_coherence")
# the finite-difference steps of tests/test_ad.py
GRAD_FD = (("materials.grt_height", (1,), 1e-4),
           ("materials.grt_inv_period", (1, 0), 1e-3))
GRAD_CBOX_SPP, ADAM_STEPS = 4, 5
REGEN = {"regen": True, "pixel_order": "morton"}
# the boundary-gradient cells (grad-boundary-*): tests/test_projective.py's
# scenes at 512 x 512, 16 spp, 2^20 edge samples a term (2,097,152 probe
# lanes, the Cornell box cell's wavefront); (scene, JAX's finite-difference
# step, tolerance: JAX's test's or tighter) against a central difference
# of the port's render at 64 spp
BOUNDARY_W = 512
BOUNDARY_SPP, BOUNDARY_FD_SPP, BOUNDARY_SAMPLES = 16, 64, 1 << 20
BOUNDARY_CELLS = (("rectangle", 0.05, 0.12), ("cube", 0.05, 0.12),
                  ("shadow", 0.04, 0.2), ("penumbra", 0.05, 0.25))
# polarized PLT's height gradient against the card's central difference
# (step 1e-4, a 1e-5 change of the image): the card's gradient and its
# difference part by 1.0% at 800x600 and 1.6% at 160x120, in the scalar
# grad-grating as in the polarized one, where the CPU's plain versions
# agree to 7e-6 at 160x120: B3/B4's forward on the card (its table, its
# special functions) under so small a step, not the gradient
POL_HEIGHT_TOL = 5e-2
# the glass box's index gradient, the card's against the CPU's at 128 x
# 128: each glass path refracts at every hit, so a hit whose t rounds
# apart between B1 and its plain version moves the whole path (the other
# card-against-CPU gradients hold 1e-3: `test_gradients_match_cpu`)
GLASS_CPU_TOL = 1e-2
# the Stokes path's conductor index against its central difference (the
# index moves values only; the step's curvature and float32 sums)
STOKES_ETA_TOL = 2e-3
# the loaders' cells: the CLI's render of the Cornell box XML
CLI_W, CLI_SPP = 128, 16
LOADER_DIR = os.path.join(OUT_DIR, "loaders")
# kernels whose launches in the kernels line come from a tool's run
TOOL_KERNELS = ("intersect_classic", "occluded_classic", "intersect_mxu")
MASK_KERNELS = ("intersect_clu", "occluded_clu")
SWEEP_KERNELS = ("intersect_q_variant", "occluded_q_variant")
MACC_KERNELS = ("intersect_q_macc",)
MFU_KERNELS = ("fma_roof",)


def emit(obj):
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase; `emit` adds the seconds since it began."""

    def __init__(self, name):
        self.name, self.t0 = name, time.perf_counter()

    def emit(self, **fields):
        emit({"phase": self.name, **fields,
              "seconds": time.perf_counter() - self.t0})


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps=7, calls=10, warmup=2):
    """Time of one fn() call in ms: CUDA events around `calls` back-to-back
    calls, divided by `calls`; the median of `reps` such runs. The host's
    launches overlap the device's work, so this is the device time where
    the device is the slower and the wrapper's host time where the kernel
    ends first (`kernel_times` then replays a CUDA graph)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, calls=10, reps=7):
    """Device time of one fn() call in ms: a CUDA graph of `calls` calls,
    replayed between CUDA events, divided by `calls`; the median of `reps`
    replays. The host launches the graph once, so this holds no host time,
    only the device's gaps between the graph's kernels (~1 us a launch).
    For calls that end before their wrapper returns, where `time_ms` times
    the host. (torch.profiler's sums of kernel durations agreed with this
    to ~1 us a launch in --turns, but read ~30% below it and below the
    event time in the kernels phase of a full run: PERF.md.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def kernel_times(fn, device=False):
    """{"ms", "wrapper_ms", "ms_by"}: `time_ms` of fn (the wrapper's time,
    10 back-to-back calls between CUDA events), and as "ms" the device time
    by `graph_ms` where that is under DEVICE_TIMED_BELOW_MS (the host's
    launch then takes about as long as the kernel or longer) or where
    `device` asks for it (a wrapper whose host work may outlast its kernel
    above that: B4b allocates eight gradients a call), else the same event
    time."""
    wrapper = time_ms(fn)
    if wrapper >= DEVICE_TIMED_BELOW_MS and not device:
        return {"ms": wrapper, "wrapper_ms": wrapper, "ms_by": "events"}
    return {"ms": graph_ms(fn), "wrapper_ms": wrapper, "ms_by": "graph"}


def time_once(fn):
    """(fn(), device time of that one call in ms by CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def chained_ms(step, x, reps=7, calls=10):
    """Device time of one step(x) in ms with each call fed the last one's
    output (the JAX tool's chained timing): CUDA events around `calls`
    chained calls, the median of `reps` such runs."""
    import torch

    x = step(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            x = step(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def bound(n_bytes, n_ops, n_fma=0):
    """A kernel's least time against the published peaks: the larger of
    its bytes / 3.35 TB/s and its operations (an FMA two) / 67 TFLOP/s;
    with the bytes and the issue slots (the operations less one per FMA) that
    `measured_bound` sets against the card's measured roofs."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_slots": n_ops - n_fma}


def tc_bound(n_bytes, n_tc_flop, n_ops, n_fma=0):
    """`bound` of a kernel whose product runs on the tensor cores (B9): the
    larger of its bytes / 3.35 TB/s, its tensor-core FLOP / 495 TFLOP/s
    (dense TF32) and its other operations (an FMA two) / 67 TFLOP/s; its
    measured bound takes the bytes and those other operations' issue slots
    (the probes measure no tensor-core roof)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_tc_flop / PEAK_TF32_FLOPS, n_ops / PEAK_FP32_FLOPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_slots": n_ops - n_fma}


def contracted_bound(n_bytes, n_ops):
    """`bound` of a kernel that nvcc builds with FMA contraction (grating.cu:
    B3's sample_kernel), whose operation count does not tell the FMAs
    apart: its issue slots are taken as n_ops / 2, the fewest it could
    issue (an FFMA, two operations, is the most one slot does), so its
    measured bound is a floor. Its SASS cannot give the count as B11d's
    does: it keeps loops and calls whose trips a static count cannot
    read."""
    return bound(n_bytes, n_ops, n_ops // 2)


def measured_bound(row, roofs):
    """The row's least time against the measured roofs (`kernel_mfu.roofs`):
    the larger of its bytes / the HBM probe's bytes/s and its issue slots /
    the FMA probe's instructions a second."""
    t_bytes = row["bound_bytes"] / roofs["bytes"] * 1e3
    t_slots = row["bound_slots"] / roofs["slots"] * 1e3
    return {"measured_bound_ms": max(t_bytes, t_slots),
            "measured_bound_by": "bytes" if t_bytes >= t_slots
            else "operations"}


def nbytes(*tensors):
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def frac_close(a, b, rtol, atol):
    """Fraction of rows of a, b (same shape) that agree elementwise."""
    import torch

    ok = torch.isclose(a, b, rtol=rtol, atol=atol)
    if ok.dim() > 1:
        ok = ok.all(dim=-1)
    # in float64: a float32 mean of a million ones can come out below 1
    return ok.double().mean().item() if ok.numel() else 1.0


def ptxas_report(log: str) -> tuple:
    """({kernel instance: registers per thread}, {kernel instance: spill
    bytes stored and loaded, where not 0}) from nvcc's -Xptxas -v report
    (entry names shortened to name<template args>)."""
    import re

    regs, spills, entry = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"(clu2_kernel|clu_kernel|sweep_q_kernel|"
                          r"sweep_a_kernel|q_kernel|lobe_sum_kernel|"
                          r"lobe_sum_bwd_kernel|"
                          r"mxu_kernel|"
                          r"sample_kernel|classic_kernel|fn_probe_kernel|"
                          r"anyhit_resident_kernel)"
                          r"I((?:L[ib]\d+E)+)E", entry)
            # anyhit_kernel: B7b before the WideBVH; clu_kernel<0 / 1> and
            # classic_kernel<0 / 1>: B10 and B8 one thread a ray (--turns)
            plain = re.search(r"(mxu_kernel|fma_roof_kernel|"
                              r"wide_anyhit_kernel|wide_kernel|"
                              r"clu_closest_kernel|clu_anyhit_kernel|"
                              r"anyhit_chunked_kernel|classic_kernel|"
                              r"anyhit_kernel)", entry)
            if k:
                args = re.findall(r"L([ib])(\d+)E", k.group(2))
                entry = f"{k.group(1)}<{','.join(v for _, v in args)}>"
            elif plain:
                entry = plain.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry and int(m.group(1)) + int(m.group(2)):
            spills[entry] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    return regs, spills


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# operation counts (each add, multiply, compare, select or special-function
# call counts as one), read off the kernels' algebra
# ---------------------------------------------------------------------------

Q_RAY_SETUP_OPS = 17      # anchor shift, o x d, maxt check, final divide
Q_TEST_OPS = 55           # det, u, v, t terms, sign fold, inside, best pair
Q_ANYHIT_TEST_OPS = 47    # the same without the best-pair update
Q_TEST_FMAS = 14          # of them FMAs, two operations each: det 2, u 5,
                          # v 5, t 2 (both tests; B1/B2 only, whose SASS
                          # `count_sass` reads: the kernels below that
                          # take Q_TEST_OPS keep n_fma=0)
CLU2_RAY_SETUP_OPS = 29   # the q setup plus the guarded inverse direction
SLAB_OPS = 29             # 6 sub, 6 mul, 10 min/max, gate compares and ands
BVH_RAY_SETUP_OPS = 22    # guarded inverse direction, maxt check, miss select
BVH_TEST_OPS = 64         # d x e2, det, guarded 1/det, u, tv x e1, v, t, hit, best
BVH_ANYHIT_TEST_OPS = 61  # the same without the best-hit update
CLASSIC_RAY_SETUP_OPS = 4  # maxt check, miss select
CLASSIC_TEST_OPS = BVH_TEST_OPS  # the same triangle test and best update
CLASSIC_FILTER_OPS = 59   # a pair's filter (B8a): det and the numerators
                          # of u, v, t (41), the sign fold (3), |det| times
                          # 2^-148, 1 + 2^-20 and the best's bound (3),
                          # us + vs, 6 compares, 5 ands; a candidate then
                          # takes CLASSIC_TEST_OPS
CLASSIC_ANYHIT_TEST_OPS = BVH_ANYHIT_TEST_OPS
MXU_RAY_SETUP_OPS = 15    # 9 products of phi, maxt check, miss selects
MXU_TEST_OPS = 158        # 4 x 16 FMAs (2 each), sign fold, guarded 1/|det|,
                          # t, hit, best update with u and v
MXU_TEST_FMAS = 64        # the FMAs among them
MXU_TC_FLOP = 3 * 2 * 32  # a pair's product on the tensor cores (B9):
                          # 3xTF32 of u' and v', 16 multiply-adds each
MXU_TC_OTHER_OPS = 25     # a pair's other operations, on the CUDA cores
                          # (B9's filter): det's 3 FMAs, |det|, the sign
                          # fold (3), 3 slack FMAs, us + vs, 4 compares, 4
                          # ors; a candidate then takes MXU_TEST_OPS
MXU_TC_OTHER_FMAS = 6     # the FMAs among them
MXU_HMMA_PAIRS = 64 / 6   # pairs an HMMA of B9's step: 6 (two k-steps of
                          # one n8 tile of u' and v', 3xTF32) a 16-ray x
                          # 4-triangle tile
CLU_RAY_SETUP_OPS = CLU2_RAY_SETUP_OPS  # the same ray terms
SWEEP_RAY_SETUP_OPS = 15  # anchor shift, o x d, maxt check, final divide
SWEEP_TEST_OPS = 53       # the q test with a best pair of (t|det|, |det|)
DUAL_MERGE_OPS = 6        # two products, a compare, three selects
MACC_RAY_SETUP_OPS = SWEEP_RAY_SETUP_OPS + 2  # and u, v times 1/|det|
MACC_TEST_OPS = Q_TEST_OPS  # the sweep's test keeping u|det| and v|det|
MACC_MERGE_OPS = 12       # two products, three compares, two logic ops,
                          # five selects

# the sweep's closest hits (B11a, B11c) against their plain versions on the
# sweep's rays (`q_close`): the share of the compared hits whose t, u or v
# may leave rtol 1e-5 (B1 leaves it on up to 96 of 131,072 of these rays,
# 7.3e-4), the rtol that holds t on every one (2.3e-4 needed at most), and
# the absolute error u and v, which lie in [0, 1], may have on every one
# (2.1e-4 at most; an rtol does not hold them: near an edge u or v is
# small and its error is not, 1.5e-2 relative)
Q_SWEEP_OUTSIDE = 2e-3
Q_SWEEP_RTOL = 1e-3
Q_SWEEP_UV_ATOL = 1e-3
# B1 on a path's bounce rays against its plain version (`q_close(...,
# bounce=True)`), whose origins sit RayEpsilon off a surface, refracted
# ones just inside the glass: the share of the compared hits whose t, u or
# v may leave rtol 1e-5 (5 of 1,580,536 on the dielectric box's second
# calls, 3.2e-6), the rtol that holds t on every one (3.2e-5 needed) and
# the absolute error u and v may have on every one (6.5e-5 at most)
Q_BOUNCE_OUTSIDE = 1e-5
Q_BOUNCE_RTOL = 1e-4
Q_BOUNCE_UV_ATOL = 1e-4


def bessel_ops(half):
    # 64 Miller steps (~10 each), Hankel terms, normalisation
    return 64 * 10 + (half + 1) * 16 + 4


# B4: a hand count of csrc/grating.cu::lobe_sum_kernel, whose products and
# sums are each an fmaf or rounded on their own (so none is contracted
# behind the count's back). Each add, multiply, compare, select, min/max,
# logic operation, conversion and vote counts as one operation, an fmaf as
# two and as one FMA; fabsf and negation are operand modifiers; loads are
# bytes. (operations, FMAs):
LOBE_LANE = (18, 3)        # index clamp, 2 conversions, px, py, sin_ix,
                           # sin_iy, half_lobes, 3 profile flags, ny, 4 pi q
LOBE_LANE_LOBE = {True: (3, 0), False: (7, 0)}  # lob_rx/ry, live compare
LOBE_CHANNEL = (20, 0)     # + 5 half (+ 2 separable): wavelength, kwn, a,
                           # three votes, at_zero, base, the exponent
LOBE_LOBE = (40, 7)        # the grating equation, cd.wo, unit_angle, gates,
                           # the Gaussian, the sum; the centre separable
                           # + 3 (its correction), else - 1
LOBE_TABLE = (7, 0)        # + 3 (half + 1) FMAs: the interval and t
LOBE_ASYM = (3, 0)         # + 5 (half + 1) and 2 (half + 1) FMAs
LOBE_RECT = (1, 0)         # a / 2 for sinf


def lobe_sum_count(ins, half, separable, specials):
    """B4's work on these inputs: {"ops", "fma", "calls", ...} with the
    special functions' calls weighed by `specials`
    (`ops/mfu.py::special_fn_counts`: an FFMA two operations and one FMA,
    any other instruction one operation). Data-dependent parts counted as
    these lanes need them: the lobes a lane's lobe count makes live, the
    table for sinusoidal (lane, channel)s with |a| <= 48, the asymptotics
    for those above, sin(a / 2) for rectangular ones."""
    import torch

    n, C = ins["wl_nm"].shape
    wl_um = ins["wl_nm"] * 1e-3
    x = (4.0 * 3.14159265358979323846 * ins["q"][:, None]
         / torch.clamp_min(wl_um * ins["wi"][:, 2:3].abs(), 1e-12)).abs()
    gt = ins["gtype"].float()
    is_sin = (gt < 0.5)[:, None]
    n_table = int((is_sin & (x <= 48.0)).sum())
    n_asym = int((is_sin & (x > 48.0)).sum())
    n_rect = int(((gt - 1.0).abs() < 0.5).sum()) * C
    m = torch.clamp_max(torch.floor(ins["lobes"].float() * 0.5), half)
    live = (2 * m + 1) if separable else (2 * m + 1) ** 2
    n_live = int(live.sum())
    centre = 3 if separable else -1
    h1 = half + 1
    ops = (n * (LOBE_LANE[0] + int(separable))
           + n_live * LOBE_LANE_LOBE[separable][0]
           + n * C * (LOBE_CHANNEL[0] + 5 * half + 2 * int(separable))
           + C * (n_live * LOBE_LOBE[0] + n * centre)
           + n_table * LOBE_TABLE[0] + n_asym * (LOBE_ASYM[0] + 5 * h1)
           + n_rect * LOBE_RECT[0])
    fma = (n * LOBE_LANE[1] + C * n_live * LOBE_LOBE[1]
           + n_table * 3 * h1 + n_asym * 2 * h1)
    calls = {"sqrt": 2 * n + 4 * C * n_live + n_asym,
             "div": 2 * n + C * (2 * n + n_live) + 2 * n_asym,
             "asin": C * n_live, "exp": C * n_live, "sincos": n_asym,
             "sin": n_rect}
    fn_ops = sum(k * (2 * specials[f]["ffma"] + specials[f]["other"])
                 for f, k in calls.items())
    fn_fma = sum(k * specials[f]["ffma"] for f, k in calls.items())
    return {"ops": 2 * fma + ops + fn_ops, "fma": fma + fn_fma,
            "calls": calls, "live_lobes_per_lane": n_live / n,
            "asym_share": n_asym / (n * C), "n_table": n_table,
            "n_asym": n_asym,
            "slots_per_lane": (fma + ops + fn_ops - fn_fma) / n,
            "special_slots_per_lane": (fn_ops - fn_fma) / n}


# B4b: a hand count of csrc/grating.cu::lobe_sum_bwd_kernel beyond the
# forward chain it repeats (`lobe_sum_count`, with the Gaussian's expf on
# the lobes the gates select and sin(a / 2) as sincosf). Each add,
# multiply, compare, select and negation counts as one operation, an
# fmaf as two; nvcc contracts the adjoints' products and sums, so their
# issue slots are taken as half their operations (a floor, as
# `contracted_bound`'s).
LOBE_BWD_LANE = 35        # |wi_z|'s sign, the adjoints of sin_ix, sin_iy
LOBE_BWD_CHANNEL = 55     # d out / d acc, the exponent's, kwn's and a's
                          # adjoints, the store; + 8 half: base -> a
LOBE_BWD_LOBE = 123       # a selected lobe: lobe_int, ang_coh, unit_angle,
                          # cd, rz, qq, mm, den, aa, bb, the lattice
LOBE_BWD_TABLE = (3, 2)   # an order: the cubic's derivative (ops, FMAs)
LOBE_BWD_ASYM = 15        # an order: the Hankel form's derivative


def weigh_calls(calls, specials):
    """(operations, FMAs) of special-function calls, each weighed by its
    fast path in the SASS (`ops/mfu.py::special_fn_counts`)."""
    ops = sum(k * (2 * specials[f]["ffma"] + specials[f]["other"])
              for f, k in calls.items())
    return ops, sum(k * specials[f]["ffma"] for f, k in calls.items())


def sel_popcount(sel):
    """Set bits of each word of `sel` (int32 words, as B4's recording
    instance writes them), as int64 of the same shape."""
    import torch

    words = sel.long() & 0xFFFFFFFF
    count = torch.zeros_like(words)
    for b in range(32):
        count += (words >> b) & 1
    return count


def lobe_sum_selected(ins, half, separable):
    """The (lane, channel, lobe)s that pass the lobe sum's gates (lobe_ok,
    in_cone, live) on these inputs: the set bits of the plain version's
    selection (`grating_lobe_sum_sel_plain`)."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    sel = gops.grating_lobe_sum_sel_plain([ins[k] for k in LOBE_SUM_ARGS],
                                          half, separable)
    return int(sel_popcount(sel).sum())


def lobe_sum_bwd_count(ins, half, separable, specials):
    """B4b's work on these inputs, as `lobe_sum_count`'s: the forward chain
    it repeats, then the adjoints (LOBE_BWD_*) of the lobes the gates
    select, of each (lane, channel) and lane, and of the Bessel values
    each branch gives."""
    fwd = lobe_sum_count(ins, half, separable, specials)
    n, C = ins["wl_nm"].shape
    h1 = half + 1
    n_sel = lobe_sum_selected(ins, half, separable)
    fwd_fn_ops, fwd_fn_fma = weigh_calls(fwd["calls"], specials)
    n_table = fwd["n_table"]
    n_asym = fwd["n_asym"]
    calls = dict(fwd["calls"])
    calls["exp"] = n_sel
    calls["sincos"] += calls.pop("sin")
    calls["div"] += 6 * n_sel + 3 * n * C + 8 * n + n_asym
    calls["sqrt"] += 2 * n_sel
    adj = (n_sel * LOBE_BWD_LOBE + n * C * (LOBE_BWD_CHANNEL + 8 * half)
           + n * LOBE_BWD_LANE + n_table * h1 * LOBE_BWD_TABLE[0]
           + n_asym * h1 * LOBE_BWD_ASYM)
    adj_fma = n_table * h1 * LOBE_BWD_TABLE[1]
    fn_ops, fn_fma = weigh_calls(calls, specials)
    ops = fwd["ops"] - fwd_fn_ops + 2 * adj_fma + adj + fn_ops
    fma = fwd["fma"] - fwd_fn_fma + adj_fma + fn_fma + adj // 2
    return {"ops": ops, "fma": fma, "calls": calls,
            "selected_lobes_per_lane": n_sel / n,
            "live_lobes_per_lane": fwd["live_lobes_per_lane"],
            "slots_per_lane": (ops - fma) / n}


# B4b's own work over B4's bits (PR 18): a hand count of
# csrc/grating.cu::lobe_sum_bwd_kernel as `lobe_sum_count`'s, with the
# forward's chain (LOBE_*) for the (lane, channel)s with bits and the
# selected lobes only, and the adjoints as LOBE_BWD_*. (operations):
LOBE_OWN_WORD = 2          # a word of a lane's bits: its load's OR,
                           # again in its channel's item
LOBE_OWN_SEL_LOBE = 12     # a set bit: __ffs, its clear, k into lx, ly,
                           # |lx|, |ly|, the centre's test; + 8 half: the
                           # selects of ix, iy, d base[ax], d base[ay]
LOBE_OWN_ORDER = 3         # an order of a channel: d base / d a, base
LOBE_OWN_VOTE = 7          # a channel of a lane: its bits' test, the
                           # warp's ballot, atomic, shuffle and list slot
LOBE_OWN_SUM = 14          # a channel of a lane with bits: its slot's
                           # 13 adjoints added, the test
BWD_LANES = 128            # lanes a block (csrc/grating.cu: kBwdBlock)


def bessel_table_bytes():
    """Bytes of the lobe sum's Bessel table (`ops/grating.py::
    bessel_table`)."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    return (gops.MAX_HALF + 1) * gops.BESSEL_TABLE_N * 16


def lobe_sum_bwd_own_count(ins, sel, half, separable, specials):
    """B4b's own work on these inputs and B4's bits `sel`: the bytes it
    must move (every lane its bits and its 16 gradient floats, a lane
    with bits its inputs but a_cone and its cotangent, the table once),
    and its operations as `lobe_sum_count`'s over the lanes, (lane,
    channel)s and lobes the bits select. "warp_slots" counts the issue
    slots of its warps, 32 a warp instruction: the gathering and the
    finish a thread a lane, and each block's (lane, channel) items packed
    32 to a warp, each branch and loop trip where an item of the warp
    takes it (the busiest item's bit count), beside "slots_per_lane", the
    lanes' own."""
    import torch

    n, C = ins["wl_nm"].shape
    W = sel.shape[-1]
    h1 = half + 1
    bits = sel_popcount(sel).sum(-1)                    # [n, C]
    ch = bits > 0
    lane = ch.any(-1)
    n_lane, n_ch, n_sel = int(lane.sum()), int(ch.sum()), int(bits.sum())
    wl_um = ins["wl_nm"] * 1e-3
    x = (4.0 * 3.14159265358979323846 * ins["q"][:, None]
         / torch.clamp_min(wl_um * ins["wi"][:, 2:3].abs(), 1e-12)).abs()
    gt = ins["gtype"].float()[:, None]
    is_sin, is_rect = gt < 0.5, (gt - 1.0).abs() < 0.5
    table = ch & is_sin & (x <= 48.0)
    asym = ch & is_sin & (x > 48.0)
    rect = ch & is_rect
    sep = int(separable)
    # every lane (its bits, its votes), a lane with bits (its finish), a
    # (lane, channel) item (the lane's terms, the channel's, its branches)
    # and a selected lobe: (operations, FMAs, adjoint operations, {special
    # function: calls}); nvcc contracts the adjoints' products and sums, so
    # half of those are taken as FMAs (a floor, as `lobe_sum_bwd_count`'s)
    u_every = (LOBE_OWN_WORD * C * W + LOBE_OWN_VOTE * C, 0, 0, {})
    u_finish = (LOBE_OWN_SUM * C, 0, LOBE_BWD_LANE, {"sqrt": 2, "div": 10})
    u_item = (LOBE_LANE[0] + sep, LOBE_LANE[1], 0, {"sqrt": 2, "div": 2})
    u_ch = (LOBE_CHANNEL[0] + 5 * half + 2 * sep, 0,
            LOBE_BWD_CHANNEL + LOBE_OWN_ORDER * half, {"div": 2 + 3})
    u_table = (LOBE_TABLE[0], 3 * h1 + LOBE_BWD_TABLE[1] * h1,
               LOBE_BWD_TABLE[0] * h1, {})
    u_asym = (LOBE_ASYM[0] + 5 * h1, 2 * h1, LOBE_BWD_ASYM * h1,
              {"div": 3, "sqrt": 1, "sincos": 1})
    u_rect = (LOBE_RECT[0], 0, 0, {"sincos": 1})
    u_lobe = (LOBE_LOBE[0] + LOBE_LANE_LOBE[separable][0]
              + LOBE_OWN_SEL_LOBE + 8 * half, LOBE_LOBE[1], LOBE_BWD_LOBE,
              {"div": 7, "sqrt": 6, "asin": 1, "exp": 1})

    def cost(u):
        """(operations, FMAs, issue slots) of one unit."""
        fn_ops, fn_fma = weigh_calls(u[3], specials)
        ops = u[0] + 2 * u[1] + u[2] + fn_ops
        fma = u[1] + u[2] // 2 + fn_fma
        return ops, fma, ops - fma

    # (unit, how often: a lane, a lane with bits, or a (lane, channel)
    # item, [n, C])
    item_parts = ((u_item, ch), (u_ch, ch), (u_table, table),
                  (u_asym, asym), (u_rect, rect), (u_lobe, bits))
    parts = ((u_every, torch.ones_like(lane)), (u_finish, lane)) + item_parts
    ops = fma = lane_slots = 0
    calls = {}
    for u, k in parts:
        cnt = int(k.sum())
        o, f, sl = cost(u)
        ops, fma, lane_slots = ops + cnt * o, fma + cnt * f, \
            lane_slots + cnt * sl
        for fn, c in u[3].items():
            calls[fn] = calls.get(fn, 0) + cnt * c

    # the warps' slots, 32 a warp instruction: the gathering and the finish
    # one thread a lane (the finish where a lane of the warp has bits);
    # the items of a block's BWD_LANES lanes in channel, then lane order, 32
    # to a warp, each branch where an item of the warp takes it and the bit
    # loop as often as its busiest item's bits
    pad = (-n) % BWD_LANES
    blocks = (n + pad) // BWD_LANES
    flat = torch.cat([ch, ch.new_zeros((pad, C))]).reshape(
        blocks, BWD_LANES, C).transpose(1, 2).reshape(blocks, -1)
    rank = torch.cumsum(flat.long(), 1) - 1
    warp_id = (rank // 32 + (C * BWD_LANES // 32) * torch.arange(
        blocks, device=ch.device)[:, None])[flat]

    def warp_items(t):
        t = torch.cat([t.long(), t.new_zeros((pad, C)).long()]).reshape(
            blocks, BWD_LANES, C).transpose(1, 2).reshape(blocks, -1)[flat]
        top = torch.zeros(blocks * C * BWD_LANES // 32, dtype=torch.long,
                          device=t.device)
        return int(top.scatter_reduce(0, warp_id, t, "amax").sum())

    lane32 = torch.cat([lane, lane.new_zeros(pad)]).reshape(-1, 32)
    warp_slots = (n * cost(u_every)[2]
                  + 32 * int(lane32.any(-1).sum()) * cost(u_finish)[2]
                  + 32 * sum(warp_items(k) * cost(u)[2]
                             for u, k in item_parts))
    # every lane: its bits, its 13 + C gradients; a lane with bits: wi, wo,
    # grating_dir, inv_period, q, lobes, gtype, multiplier, coherence; a
    # channel with bits: its wavelength and cotangent; the table once
    n_bytes = (n * 4 * (C * W + 13 + C) + n_lane * 60 + n_ch * 8
               + bessel_table_bytes())
    return {"ops": ops, "fma": fma, "calls": calls, "bytes": n_bytes,
            "lanes_with_bits": n_lane / n,
            "channels_with_bits_per_lane": n_ch / n,
            "selected_lobes_per_lane": n_sel / n,
            "slots_per_lane": lane_slots / n,
            "warp_slots_per_lane": warp_slots / n,
            "warp_slots": warp_slots}


def sample_ops(half, ndf):
    vndf = 150 if ndf == 1 else 45
    return vndf + 60 + 25 + bessel_ops(half) + 3 * half + 8 * (half + 1) \
        + 2 * (4 * (half + 1) + 6) + 2 * (half + 1) + 40 + 30 + 20


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def grating_q_rays(scene, n_rays, rng):
    """B1's and B2's rays on the grating scene ((o, d, maxt) each): n_rays
    camera rays (maxt inf), and shadow-like rays: origins in the scene's
    box off every surface, uniform directions, maxt uniform in [0, 6] with
    10% inf and 10% zero."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays

    dev = scene.device
    W, H = scene.sensor.resolution
    spp = max(1, n_rays // (W * H))
    ray, _ = sample_rays(scene, Sampler.create(0, W * H * spp, device=dev),
                         W, H, spp)
    n = ray.o.shape[0]
    lo = np.array([-2.0, -0.45, -2.0]); hi = np.array([2.0, 1.5, 2.0])
    so = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    sd = rng.normal(size=(n, 3))
    sd = (sd / np.linalg.norm(sd, axis=-1, keepdims=True)).astype(np.float32)
    smt = rng.uniform(0.0, 6.0, n).astype(np.float32)
    pick = rng.random(n)
    smt[pick < 0.1] = np.inf
    smt[(pick >= 0.1) & (pick < 0.2)] = 0.0
    shadow = tuple(torch.as_tensor(x, device=dev) for x in (so, sd, smt))
    return (ray.o, ray.d, ray.maxt), shadow


def recorded_calls(module, names, run, calls=(0,)):
    """{name: {i: (args, kwargs)}}: the arguments, tensors cloned, of the
    calls numbered `calls` (0 the first) that run() makes to each function
    `names` of `module`; the functions are restored after."""
    import torch

    seen, kept = {name: {} for name in names}, {}
    for name in names:
        fn = kept[name] = getattr(module, name)

        def record(*args, _fn=fn, _name=name, _count=[0], **kw):
            if _count[0] in calls:
                seen[_name][_count[0]] = (
                    tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args), dict(kw))
            _count[0] += 1
            return _fn(*args, **kw)
        setattr(module, name, record)
    try:
        run()
    finally:
        for name, fn in kept.items():
            setattr(module, name, fn)
    return seen


def path_q_rays(scene, integ, spp_pass, call=0):
    """The rays of a render pass's closest-hit and any-hit call numbered
    `call` (0: the camera rays and their shadow rays; 1: the first rays
    that leave the scene's surfaces) on the brute route ((o, d, maxt)
    each): one pass at spp_pass with `intersect_q` and `occluded_q`
    recording their arguments."""
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    seen = recorded_calls(
        isect, ("intersect_q", "occluded_q"),
        lambda: render(scene, integ, seed=0, spp=spp_pass,
                       spp_per_pass=spp_pass), (call,))
    return tuple(seen[name][call][0][2:5]
                 for name in ("intersect_q", "occluded_q"))


def grating_box_inputs(scene, integ, spp_pass):
    """{name: (args, kwargs)} of the first `grating_sample` and
    `grating_lobe_sum` calls of a PLT render pass at spp_pass (the camera
    bounce's sample and NEE eval)."""
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    seen = recorded_calls(
        gops, ("grating_sample", "grating_lobe_sum"),
        lambda: render(scene, integ, seed=0, spp=spp_pass,
                       spp_per_pass=spp_pass))
    return {name: calls[0] for name, calls in seen.items()}


def sweep_sass_kernels():
    """{key: mangled-name fragment} of the sweep's instances
    (csrc/intersect_sweep.cu): B11a (`sweep_q_kernel<UNROLL, NACC, UV>`) at
    every unroll with one and two accumulators, B11c at every nacc, B11b
    (`sweep_a_kernel<UNROLL>`) at every unroll; keys as `ptxas_report`
    names them."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    out = {}
    for unroll, nacc, uv in (
            [(u, k, 0) for u in isect.Q_VARIANT_UNROLLS for k in (1, 2)]
            + [(isect.Q_MACC_UNROLL, k, 1) for k in isect.Q_MACC_NACCS]):
        out[f"sweep_q_kernel<{unroll},{nacc},{uv}>"] = (
            f"sweep_q_kernelILi{unroll}ELi{nacc}ELb{uv}EE")
    for unroll in isect.Q_VARIANT_UNROLLS:
        out[f"sweep_a_kernel<{unroll}>"] = f"sweep_a_kernelILi{unroll}EE"
    return out


def q_sass_counts(library):
    """{"intersect_q", "occluded_q", each key of `sweep_sass_kernels`,
    "intersect_mxu", "intersect_classic" and "intersect_classic_dense"}:
    `mfu.count_sass(..., per_test=True)` of q_kernel<false / true> and of
    the sweep's instances, `mfu.loop_trip` of B9's row loop
    (`mxu_kernel<true>`: its HMMA and other instructions a step) and of
    B8a's, per test (`classic_kernel<false, false>`, the filter: a trip
    that takes no candidate; `<false, true>`, every pair exact: a trip
    without the division's slow path; `classic_step` tests a trip), in
    the kernel library file `library`, read by this checkout's
    `ops/mfu.py` in a process of its own (so that `--turns` reads another
    checkout's library the same way). An instance it cannot read
    (another checkout's) gives {"error": ...}."""
    code = (
        "import json, os, subprocess, sys\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "from mitsuba3_plt_tpu_torch.ops import build, mfu\n"
        "tool = os.path.join(os.path.dirname(build.find_nvcc()), "
        "'cuobjdump')\n"
        "sass = subprocess.run([tool, '-sass', sys.argv[1]], check=True, "
        "stdout=subprocess.PIPE, text=True).stdout\n"
        "out = {k: mfu.count_sass(sass, f'q_kernelILb{b}E', per_test=True) "
        "for k, b in (('intersect_q', 0), ('occluded_q', 1))}\n"
        "for k, name in json.loads(sys.argv[2]).items():\n"
        "    try:\n"
        "        out[k] = mfu.count_sass(sass, name, per_test=True)\n"
        "    except RuntimeError as e:\n"
        "        out[k] = {'error': str(e)}\n"
        "try:\n"
        "    out['intersect_mxu'] = mfu.loop_trip(sass, 'mxu_kernelILb1EE')\n"
        "except RuntimeError as e:\n"
        "    out['intersect_mxu'] = {'error': str(e)}\n"
        "for k, dense in (('intersect_classic', 0),\n"
        "                 ('intersect_classic_dense', 1)):\n"
        "    try:\n"
        "        out[k] = mfu.loop_trip(\n"
        "            sass, f'classic_kernelILb0ELb{dense}EE', per_test=True,\n"
        "            tests=int(sys.argv[3]))\n"
        "    except (RuntimeError, ValueError) as e:\n"
        "        out[k] = {'error': str(e)}\n"
        "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", code, library,
                          json.dumps(sweep_sass_kernels()),
                          str(classic_step(library))], check=True,
                         stdout=subprocess.PIPE, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def classic_step(library):
    """kStep, the rows a trip of B8a's row loop tests, from the source
    `intersect_classic.cu` of the checkout that built `library` (its
    `_build` beside `ops`); 0 where that source has none (a checkout from
    before the filter)."""
    import re

    cu = os.path.join(os.path.dirname(os.path.dirname(library)), "ops",
                      "csrc", "intersect_classic.cu")
    with open(cu) as f:
        m = re.search(r"constexpr int kStep = (\d+)", f.read())
    return int(m.group(1)) if m else 0


def mxu_step(q_sass):
    """B9's row loop from `q_sass_counts`: {"hmma", "slots": the
    instructions of a trip that takes no candidate, "pairs": the (ray,
    triangle) pairs a trip's HMMAs cover, "per_pair": its slots a pair
    counted as a thread's, the unit of the FMA roof, "trip": by opcode};
    raises where its SASS was not read."""
    c = q_sass["intersect_mxu"]
    require("trip" in c, f"intersect_mxu: SASS not read: {c.get('error')}")
    hmma = c["trip"].get("HMMA", 0)
    pairs = hmma * MXU_HMMA_PAIRS
    return {"hmma": hmma, "slots": c["slots"], "pairs": pairs,
            "per_pair": c["slots"] * 32 / pairs, "trip": c["trip"]}


def mxu_unfiltered(w, o, d, maxt, n_tris):
    """B9's filter-off instance (csrc/intersect_mxu.cu, mxu_kernel<false>):
    every (ray, triangle) pair through the FP32 test, which the tensor-core
    kernel must equal to the bit. Returns ((t, prim, u, v), {"candidates":
    the pairs the filter keeps, "dropped": the hits it would have dropped,
    which must be none}). Only the checks call it: `intersect_mxu` never
    does."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import build

    n, dev = o.shape[0], o.device
    out = (torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev))
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    build.check(build.load_library().plt_intersect_mxu_unfiltered(
        w.data_ptr(), w.shape[0] // 4, n_tris, o.data_ptr(), d.data_ptr(),
        maxt.data_ptr(), n, *(x.data_ptr() for x in out), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream),
        "intersect_mxu_unfiltered")
    candidates, dropped = counts.tolist()
    return out, {"candidates": candidates, "dropped": dropped}


def classic_audit(tri, o, d, maxt, n_tris):
    """B8a's audit instance (csrc/intersect_classic.cu,
    classic_kernel<true>): every (ray, row) pair through the exact test,
    which the filtered kernel must equal to the bit. Returns ((t, prim, u,
    v), {"candidates": the pairs the filter keeps, "dropped": the hits it
    would have dropped, which must be none}). Only the checks call it:
    `intersect_classic` never does."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import build
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    n, dev = o.shape[0], o.device
    out = (torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev))
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    build.check(build.load_library().plt_intersect_classic_audit(
        tri.data_ptr(), isect._closest_rows(tri, n_tris), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, *(x.data_ptr() for x in out),
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "intersect_classic_audit")
    candidates, dropped = counts.tolist()
    return out, {"candidates": candidates, "dropped": dropped}


def classic_test(q_sass):
    """B8a's row loops from `q_sass_counts`: {"filter": the instructions of
    a (ray, row) test, by opcode and "slots", of the filter's instance (a
    trip that takes no candidate), "every_pair": of the instance that runs
    the exact test on every pair (tables of at most kDenseRows rows)};
    raises where their SASS was not read."""
    out = {}
    for what, key in (("filter", "intersect_classic"),
                      ("every_pair", "intersect_classic_dense")):
        c = q_sass[key]
        require("per_test" in c, f"{key}: SASS not read: {c.get('error')}")
        out[what] = c["per_test"]
    return out


def sweep_fmas(q_sass, key):
    """FFMAs a (ray, row) test of the sweep's instance `key`, from
    `q_sass_counts`; raises where its SASS was not read."""
    c = q_sass[key]
    require("per_test" in c, f"{key}: SASS not read: {c.get('error')}")
    return c["per_test"]["ffma"]


def b1_groups(q, rays, rows, nacc):
    """B1 (`intersect_q`) on the rays over each of the nacc groups of the
    table's first `rows` rows (row r in group r % nacc): [(t, prim, u,
    v)], prim indexing the group's own rows. A group of the sweep's
    closest hit runs B1's row test over the same rows in the same order,
    so its best hit is B1's answer there, to the bit."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    tab, anchor = q
    return [isect.intersect_q(tab[g:rows:nacc].contiguous(), anchor, *rays,
                              len(range(g, rows, nacc)))
            for g in range(nacc)]


def q_close(name, got, want, sweep=False, bounce=False):
    """check_q's tolerance for a closest hit of B1's row test (q_row.cuh),
    (t, prim) or (t, prim, u, v), against its plain version on the same
    lanes: prim equal on at least 1 - 1e-4 of lanes (it may differ only
    where a ray meets a shared edge or a triangle boundary within float
    rounding: the kernel contracts multiply-adds into FMAs, the plain
    version does not), and on every lane where the prims agree and hit, t
    at rtol 1e-5 / atol 1e-6 and u, v at rtol 1e-5 / atol 1e-5.

    With `sweep` the rays start anywhere inside a scene: the sweep's
    (B11a, B11c, held to B1 to the bit by `q_groups` as well). B1's
    rounding leaves rtol 1e-5 there on up to ~1 lane in 1,000 (an origin
    near a triangle's plane, where t|det| and u|det| cancel), so t, u and
    v may leave it on at most Q_SWEEP_OUTSIDE of the lanes where the prims
    agree and hit; on every one of them t keeps rtol Q_SWEEP_RTOL and u, v
    (in [0, 1]) keep Q_SWEEP_UV_ATOL. With `bounce` they are a path's
    bounce rays, whose origins sit RayEpsilon off a surface (B1 itself):
    the same, held at Q_BOUNCE_OUTSIDE, Q_BOUNCE_RTOL and
    Q_BOUNCE_UV_ATOL.

    Returns {"agreement": prim agreement, "max_abs_err": of t, u, v on the
    lanes where the prims agree and hit, "outside_tolerance": the most
    lanes of one value outside rtol 1e-5 there, "t_rtol_needed": the least
    rtol that holds t on every one of them at atol 1e-6, and with u, v
    "uv_abs_err": their largest absolute error there}."""
    import torch

    torch.cuda.synchronize()
    prim_same = got[1] == want[1]
    frac_prim = prim_same.double().mean().item()
    require(frac_prim >= 1 - 1e-4, f"{name} prim agreement {frac_prim}")
    both = prim_same & (want[1] >= 0)
    n_both = int(both.sum())
    held = {"agreement": frac_prim, "max_abs_err": 0.0,
            "outside_tolerance": 0, "t_rtol_needed": 0.0}
    share, t_rtol, uv_atol = (
        (Q_SWEEP_OUTSIDE, Q_SWEEP_RTOL, Q_SWEEP_UV_ATOL) if sweep else
        (Q_BOUNCE_OUTSIDE, Q_BOUNCE_RTOL, Q_BOUNCE_UV_ATOL) if bounce else
        (0.0, None, None))
    for k, atol in ((0, 1e-6), (2, 1e-5), (3, 1e-5)):
        if k >= len(got):
            continue
        a, b = got[k][both], want[k][both]
        diff = (a - b).abs()
        err = diff.max().item() if a.numel() else 0.0
        held["max_abs_err"] = max(held["max_abs_err"], err)
        if k == 0 and a.numel():
            held["t_rtol_needed"] = (
                (diff - atol).clamp(min=0) / b.abs()).max().item()
        elif k > 0:
            held["uv_abs_err"] = max(held.get("uv_abs_err", 0.0), err)
        far = int((~torch.isclose(a, b, rtol=1e-5, atol=atol)).sum())
        held["outside_tolerance"] = max(held["outside_tolerance"], far)
        limit = int(share * n_both)
        require(far <= limit, f"{name}: value {k} outside rtol 1e-5 on "
                              f"{far} of {n_both} lanes (at most {limit})")
    if t_rtol is not None:
        require(held["t_rtol_needed"] <= t_rtol,
                f"{name}: t needs rtol {held['t_rtol_needed']} on a lane "
                f"(at most {t_rtol})")
        require(held.get("uv_abs_err", 0.0) <= uv_atol,
                f"{name}: u or v off by {held.get('uv_abs_err')} on a lane "
                f"(at most {uv_atol})")
    return held


def q_groups(name, got, groups):
    """A closest hit of the sweep (B11a, B11c) against B1 over each of its
    groups' rows (`b1_groups` on the same rays), to the bit: it hits where
    a group of B1's does, its t (and u, v) on a lane are B1's over the
    group its prim lies in, with B1's prim there, and its t is the least
    of the groups' within rtol 1e-5 (the merge's cross-multiplied compare;
    an exact tie goes to the lower group). With one group that is B1
    itself."""
    import torch

    torch.cuda.synchronize()
    nacc, hit = len(groups), got[1] >= 0
    each = [torch.stack([x[k] for x in groups]) for k in range(4)]
    require(torch.equal(hit, (each[1] >= 0).any(0)),
            f"{name}: hits differ from B1's groups'")
    require(torch.isinf(got[0][~hit]).all(), f"{name}: t finite on a miss")
    g = torch.where(hit, got[1] % nacc, 0).long()
    own = [x.gather(0, g[None])[0] for x in each]  # the prim's group
    require(torch.equal(got[1][hit].long(), (g + nacc * own[1])[hit]),
            f"{name}: prim differs from B1's over its group")
    for k in (0, 2, 3)[:len(got) - 1]:
        require(torch.equal(got[k][hit], own[k][hit]),
                f"{name}: value {k} differs from B1's over its group")
    least = each[0].min(0).values
    require(bool((got[0][hit] <= least[hit] * (1 + 1e-5) + 1e-6).all()),
            f"{name}: not the nearest of the groups' hits")


def check_q(label, scene, closest_rays, shadow_rays, q_sass,
            bounce=False):
    """B1 on closest_rays and B2 on shadow_rays ((o, d, maxt) each) of a
    brute-route scene against their plain versions, with the tolerance
    stated (`q_close`; with `bounce`, for rays that start on the scene's
    surfaces, its tolerance for a path's bounce rays); rows timed by
    `kernel_times` (device time where the wrapper takes longer than the
    kernel). q_sass: `q_sass_counts` of the built library, whose FFMAs a
    test the bounds count (the hand count Q_TEST_FMAS printed beside
    them)."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    geo = scene.geo
    o, d, maxt = closest_rays
    n = o.shape[0]
    args = (geo.tri_q, geo.tri_anchor, o, d, maxt, geo.n_faces)
    got = isect.intersect_q(*args)
    want = isect.intersect_q_plain(*args)
    held = q_close(f"intersect_q {label}", got, want, bounce=bounce)
    frac_prim, err = held["agreement"], held["max_abs_err"]
    times = kernel_times(lambda: isect.intersect_q(*args))
    plain_ms = time_ms(lambda: isect.intersect_q_plain(*args))
    fmas = q_sass["intersect_q"]["per_test"]["ffma"]
    bnd = bound(nbytes(geo.tri_q, geo.tri_anchor, o, d, maxt, got),
                n * (Q_RAY_SETUP_OPS + geo.n_faces * Q_TEST_OPS),
                n * geo.n_faces * fmas)
    closest = {"name": "intersect_q", "route": "cuda",
               "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_q.cu",
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1373 "
                           "(pallas_intersect_q)",
               "max_abs_err": err, **times, "plain_ms": plain_ms,
               **bnd, "library_ms": None, "rays": label,
               "test_fmas": {"sass": fmas, "hand": Q_TEST_FMAS},
               "n": n, "faces": geo.n_faces, "prim_agreement": frac_prim,
               **{k: held[k] for k in ("outside_tolerance", "t_rtol_needed",
                                       "uv_abs_err") if k in held},
               "hit_share": (want[1] >= 0).float().mean().item()}

    so, sd, smt = shadow_rays
    n = so.shape[0]
    sargs = (geo.tri_q, geo.tri_anchor, so, sd, smt, geo.n_faces)
    occ = isect.occluded_q(*sargs)
    occ_plain = isect.occluded_q_plain(*sargs)
    torch.cuda.synchronize()
    frac_occ = (occ == occ_plain).float().mean().item()
    # tolerance: equal except where t lies within float rounding of 0, maxt
    # or a triangle boundary: at most 1 lane in 10,000
    require(frac_occ >= 1 - 1e-4, f"occluded_q {label} agreement {frac_occ}")
    # triangles tested per ray: up to the first hit (the loop leaves there)
    tested = km.anyhit_tests(geo.tri_q, geo.tri_anchor, so, sd, smt,
                             geo.n_faces)
    times_a = kernel_times(lambda: isect.occluded_q(*sargs))
    plain_a = time_ms(lambda: isect.occluded_q_plain(*sargs))
    fmas_a = q_sass["occluded_q"]["per_test"]["ffma"]
    bnd_a = bound(
        nbytes(geo.tri_q, geo.tri_anchor, so, sd, smt, occ),
        n * Q_RAY_SETUP_OPS + tested * Q_ANYHIT_TEST_OPS, tested * fmas_a)
    anyhit = {"name": "occluded_q", "route": "cuda",
              "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_q.cu",
              "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1411 "
                          "(pallas_occluded_q)",
              "max_abs_err": 1.0 - frac_occ, **times_a, "plain_ms": plain_a,
              **bnd_a, "library_ms": None, "rays": label,
              "test_fmas": {"sass": fmas_a, "hand": Q_TEST_FMAS},
              "n": n, "faces": geo.n_faces, "occ_agreement": frac_occ,
              "occluded_share": occ_plain.float().mean().item(),
              "tests_per_ray": tested / n}
    return [closest, anyhit]


def _rand_dir(rng, n):
    import numpy as np

    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def lobe_sum_inputs(rng, n, gtype, ip_y, dev):
    """Random lanes as in tests/test_grating_pallas.py."""
    import numpy as np
    import torch

    f32 = np.float32
    C = 3
    ins = dict(
        wi=_rand_dir(rng, n), wo=_rand_dir(rng, n),
        wl_nm=rng.uniform(380, 680, (n, C)).astype(f32),
        grating_dir=np.stack([np.ones(n), np.zeros(n)], -1).astype(f32),
        inv_period=np.stack([np.full(n, 2.0), np.full(n, ip_y)], -1).astype(f32),
        q=rng.uniform(0.02, 0.3, n).astype(f32),
        lobes=rng.choice([3, 5, 7, 9], n).astype(np.int32),
        gtype=np.full(n, gtype, np.int32),
        multiplier=np.full(n, 1.3, f32),
        coherence=rng.uniform(1.0, 120.0, n).astype(f32),
        a_cone=rng.uniform(0.05, 0.4, n).astype(f32),
    )
    return {k: torch.as_tensor(v, device=dev) for k, v in ins.items()}


def hold_lobe_sum(label, got, want):
    """B4's output against its plain version's: the share of lanes within
    rtol 2e-3, atol 2e-5 (the CPU tests'), which must be at least 1 - 1e-5
    (a lane may fall outside only where a cone or grating-equation gate
    flips at float rounding: the kernel's Bessel table and FMAs), and
    finite."""
    import torch

    frac = frac_close(got, want, 2e-3, 2e-5)
    require(bool(torch.isfinite(got).all()),
            f"grating_lobe_sum {label}: non-finite output")
    require(frac >= 1 - 1e-5, f"grating_lobe_sum {label} agreement {frac}")
    return frac


def sel_flips(args, half, separable, got, want):
    """The lobes whose selection bit differs between `got` (B4's recording
    instance) and `want` (`grating_lobe_sum_sel_plain`), each with the
    plain chain's margins at it: [{"lane", "channel", "lobe", "ang_miss":
    | |ang| - a_cone | in rad, "lattice_miss": the least of | |aa| - 1 |
    and | |bb| - 1 |, "rounding": whether it lies within float rounding of
    a gate (ang_miss <= 1e-5 or lattice_miss <= 1e-6)}]."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import grating as gops

    diff = (got ^ want) != 0
    if not bool(diff.any()):
        return []
    where = diff.nonzero().tolist()
    lanes = sorted({w[0] for w in where})
    idx = torch.as_tensor(lanes, device=got.device)
    sub = [t[idx] for t in args]
    gates = list(gops.lobe_gates(*sub[:5], sub[6], sub[10], half, separable))
    out = []
    for lane, c, w in where:
        x = (int(got[lane, c, w]) ^ int(want[lane, c, w])) & 0xFFFFFFFF
        j = lanes.index(lane)
        for b in range(32):
            if not (x >> b) & 1:
                continue
            lx, ly, aa, bb, ang, _ = gates[32 * w + b]
            miss = abs(abs(ang[j, c].item()) - sub[10][j].item())
            lat = min(abs(abs(aa[j, c].item()) - 1.0),
                      abs(abs(bb[j, c].item()) - 1.0))
            out.append({"lane": lane, "channel": c, "lobe": [lx, ly],
                        "ang_miss": miss, "lattice_miss": lat,
                        "rounding": miss <= 1e-5 or lat <= 1e-6})
    return out


def hold_record(label, args, half, separable, plain_out):
    """B4's recording instance on `args` (LOBE_SUM_ARGS order): its sum
    must equal the plain instance's `plain_out` to the bit, and its bits
    the plain version's (`grating_lobe_sum_sel_plain`) but for lobes within
    float rounding of a gate (`sel_flips`), each named. Returns (its
    bits, the flips)."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import grating as gops

    out, sel = gops.grating_lobe_sum_record(args, half, separable)
    require(torch.equal(out, plain_out),
            f"grating_lobe_sum_record {label}: sum differs from B4's")
    flips = sel_flips(args, half, separable, sel,
                      gops.grating_lobe_sum_sel_plain(args, half, separable))
    emit({"phase": "kernels", "name": "grating_lobe_sum_record",
          "case": label, "bits_differing": len(flips), "flips": flips[:20]})
    require(all(f["rounding"] for f in flips),
            f"grating_lobe_sum_record {label}: a bit differs away from "
            f"float rounding of its gate: {flips}")
    return sel, flips


def lobe_sum_row(ins, kw, got, want, frac, specials):
    """The kernels line's row of B4 on inputs `ins` (the kernel's keyword
    arguments) and kw (half, separable, n_channels): timed, its bound
    counted by `lobe_sum_count`; beside it the recording instance's time
    ("record_ms", by `kernel_times` as "ms")."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    count = lobe_sum_count(ins, kw["half"], kw["separable"], specials)
    times = kernel_times(lambda: gops.grating_lobe_sum(**ins, **kw))
    args = [ins[k] for k in LOBE_SUM_ARGS]
    record = kernel_times(lambda: gops.grating_lobe_sum_record(
        args, kw["half"], kw["separable"]))
    plain_ms = time_ms(lambda: gops.grating_lobe_sum_plain(
        **ins, half=kw["half"], separable=kw["separable"]))
    bnd = bound(nbytes(ins, got, gops.bessel_table(got.device)),
                count["ops"], count["fma"])
    return {"name": "grating_lobe_sum", "route": "cuda",
            "source": "mitsuba3_plt_tpu_torch/ops/csrc/grating.cu",
            "replaces": "mitsuba3_plt_tpu/ops/grating_pallas.py:230 "
                        "(grating_lobe_sum)",
            "max_abs_err": (got - want).abs().max().item(), **times,
            "record_ms": record["ms"], "record_ms_by": record["ms_by"],
            "plain_ms": plain_ms, **bnd, "library_ms": None,
            "n": got.shape[0], "agreement": frac,
            "case": [kw["half"], kw["separable"]],
            "count": {**count, "how": (
                "operations and FMAs: a hand count of "
                "lobe_sum_kernel's source (chip_smoke.py LOBE_*) "
                "over the lobes, branches and profiles these lanes "
                "need; special functions: calls x their fast-path "
                "instructions in the SASS of fn_probe_kernel")}}


def check_lobe_sum(n, rng, dev, specials):
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    # (half, separable, gtype, ip_y): the main path's case first, then the
    # three other cases of the CPU tests at a smaller lane count
    cases = [(3, True, 0, 0.0, n), (3, False, 0, 1.5, n // 16),
             (4, True, 1, 0.0, n // 16), (2, True, 2, 0.0, n // 16)]
    row = None
    for half, sep, gtype, ip_y, nn in cases:
        ins = lobe_sum_inputs(rng, nn, gtype, ip_y, dev)
        kw = dict(half=half, separable=sep)
        got = gops.grating_lobe_sum(**ins, **kw, n_channels=3)
        want = gops.grating_lobe_sum_plain(**ins, **kw)
        frac = hold_lobe_sum(str((half, sep, gtype)), got, want)
        hold_record(str((half, sep, gtype)), [ins[k] for k in LOBE_SUM_ARGS],
                    half, sep, got)
        count = lobe_sum_count(ins, half, sep, specials)
        emit({"phase": "kernels", "name": "grating_lobe_sum",
              "case": [half, sep, gtype, ip_y], "n": nn, "agreement": frac,
              "asym_share": count["asym_share"]})
        if row is None:
            row = lobe_sum_row(ins, dict(kw, n_channels=3), got, want, frac,
                               specials)
    return row


def sample_inputs(rng, n, dev):
    import numpy as np
    import torch

    f32 = np.float32
    ins = dict(
        wi=_rand_dir(rng, n),
        u2=rng.uniform(0, 1, (n, 2)).astype(f32),
        lobe_u2=rng.uniform(0, 1, (n, 2)).astype(f32),
        wl_um=rng.uniform(0.38, 0.68, n).astype(f32),
        alpha=rng.uniform(0.03, 0.3, (n, 2)).astype(f32),
        grating_dir=np.stack([np.ones(n), np.zeros(n)], -1).astype(f32),
        inv_period=np.stack([np.full(n, 0.6), np.zeros(n)], -1).astype(f32),
        q=rng.uniform(0.02, 0.3, n).astype(f32),
        lobes=rng.choice([3, 5, 7], n).astype(np.int32),
        gtype=np.zeros(n, np.int32),
        multiplier=np.full(n, 10.0, f32),
    )
    return {k: torch.as_tensor(v, device=dev) for k, v in ins.items()}


def hold_sample(label, got, want):
    """B3's outputs against its plain version's, at the CPU tests'
    tolerance: lobe and ok equal, wo and mvec at rtol 1e-4 / atol 1e-5,
    pdf (clipped at 1e6) and G1 * intensity at rtol 2e-3 / atol 1e-6, on
    lanes where both agree on the lobe and are live; a lane may differ
    where u lies within float rounding of a lobe-CDF step or a live/dead
    gate sits at its threshold: at most 1 lane in 10,000. Returns (the
    worst share, the live lanes)."""
    import torch

    same = (got["lobe"] == want["lobe"]).all(-1) & (got["ok"] == want["ok"])
    frac_same = same.float().mean().item()
    live = same & want["ok"]
    fr_wo = frac_close(got["wo"][live], want["wo"][live], 1e-4, 1e-5)
    fr_m = frac_close(got["mvec"], want["mvec"], 1e-4, 1e-5)
    fr_pdf = frac_close(torch.clamp_max(got["pdf"][live], 1e6),
                        torch.clamp_max(want["pdf"][live], 1e6), 2e-3, 1e-6)
    fr_w = frac_close(got["w_g1_int"][live], want["w_g1_int"][live],
                      2e-3, 1e-6)
    worst = min(frac_same, fr_wo, fr_m, fr_pdf, fr_w)
    require(worst >= 1 - 1e-4,
            f"grating_sample {label} agreement lobe/ok {frac_same} "
            f"wo {fr_wo} mvec {fr_m} pdf {fr_pdf} w {fr_w}")
    return worst, live


def sample_row(ins, kw, got, want, worst, live):
    """The kernels line's row of B3 on inputs `ins` and kw (half, ndf)."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    n = got["wo"].shape[0]
    times = kernel_times(lambda: gops.grating_sample(**ins, **kw))
    plain_ms = time_ms(lambda: gops.grating_sample_plain(**ins, **kw))
    bnd = contracted_bound(nbytes(ins, got),
                           n * sample_ops(kw["half"], kw["ndf"]))
    return {"name": "grating_sample", "route": "cuda",
            "source": "mitsuba3_plt_tpu_torch/ops/csrc/grating.cu",
            "replaces": "mitsuba3_plt_tpu/ops/grating_pallas.py:593 "
                        "(grating_sample)",
            "max_abs_err": (got["wo"][live] - want["wo"][live]).abs().max()
            .item(), **times, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "n": n, "agreement": worst,
            "case": [kw["half"], kw["ndf"]]}


def check_sample(n, rng, dev):
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    row = None
    for ndf in (1, 0):  # Beckmann (the main path's NDF), then GGX
        ins = sample_inputs(rng, n, dev)
        got = gops.grating_sample(**ins, half=3, ndf=ndf)
        want = gops.grating_sample_plain(**ins, half=3, ndf=ndf)
        worst, live = hold_sample(f"ndf={ndf}", got, want)
        if row is None:
            row = sample_row(ins, dict(half=3, ndf=ndf), got, want, worst,
                             live)
    return row


# the positional arguments of B3's and B4's wrappers, by name
SAMPLE_ARGS = ("wi", "u2", "lobe_u2", "wl_um", "alpha", "grating_dir",
               "inv_period", "q", "lobes", "gtype", "multiplier")
LOBE_SUM_ARGS = ("wi", "wo", "wl_nm", "grating_dir", "inv_period", "q",
                 "lobes", "gtype", "multiplier", "coherence", "a_cone")


def check_grating_box(inputs, specials):
    """B3 and B4 on the grating box path's own inputs (`grating_box_inputs`:
    the first calls of a PLT pass on cornell_box(512, 512,
    box_material="grating"), half = 2, height 0.25 um, coherence 1.0 on
    the box's lanes) against their plain versions at the tolerances of
    `hold_sample` and `hold_lobe_sum`. Returns a row each."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    args, kw = inputs["grating_sample"]
    ins = dict(zip(SAMPLE_ARGS, args))
    got = gops.grating_sample(**ins, **kw)
    want = gops.grating_sample_plain(**ins, **kw)
    worst, live = hold_sample("grating box", got, want)
    sample = sample_row(ins, kw, got, want, worst, live)

    args, kw = inputs["grating_lobe_sum"]
    ins = dict(zip(LOBE_SUM_ARGS, args))
    got = gops.grating_lobe_sum(**ins, **kw)
    want = gops.grating_lobe_sum_plain(**ins, half=kw["half"],
                                       separable=kw["separable"])
    frac = hold_lobe_sum("grating box", got, want)
    hold_record("grating box", list(args), kw["half"], kw["separable"], got)
    lobe = lobe_sum_row(ins, kw, got, want, frac, specials)
    return [dict(r, rays="cbox grating path") for r in (sample, lobe)]


def lobe_sum_bwd_outside(got, want):
    """{input: lanes [N] bool} of the lanes whose gradient of that input
    lies outside `hold_lobe_sum_bwd`'s tolerance (some component further
    than rtol 2e-3 of the plain gradient plus 2e-5 of the input's
    largest), and {input: that largest}."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    out, scales = {}, {}
    for name, a, b in zip(gops.LOBE_SUM_INPUTS, got, want):
        if b is None:
            continue
        scales[name] = b.abs().max().item()
        ok = (a - b).abs() <= 2e-3 * b.abs() + 2e-5 * scales[name]
        out[name] = ~(ok.all(-1) if ok.dim() > 1 else ok)
    return out, scales


def hold_lobe_sum_bwd(label, got, want):
    """B4b's gradients against autograd of the plain version: for each
    input, the share of lanes whose every component lies within rtol 2e-3
    of the plain gradient plus 2e-5 of that input's largest (the
    forward's rtol 2e-3 / atol 2e-5, the atol scaled by each input's
    largest: B4b differentiates the Bessel table, the plain version the
    float32 sweep; a host build of the kernel's source is within 5e-5 of
    the largest), which must be at least 1 - 1e-5 (a lane may fall
    outside where a gate flips at float rounding, as for B4:
    `explain_lobe_sum_bwd` names each), and finite. Returns (the worst
    share, the largest error, the largest error over its input's
    largest)."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import grating as gops

    outside, scales = lobe_sum_bwd_outside(got, want)
    worst, err_max, rel = 1.0, 0.0, 0.0
    for name, a, b in zip(gops.LOBE_SUM_INPUTS, got, want):
        if b is None:
            continue
        err = (a - b).abs()
        # in float64: a float32 mean of a million ones can come out below 1
        frac = 1.0 - outside[name].double().mean().item()
        require(bool(torch.isfinite(a).all()),
                f"grating_lobe_sum_bwd {label} {name}: non-finite")
        require(frac >= 1 - 1e-5,
                f"grating_lobe_sum_bwd {label} {name} agreement {frac}")
        worst = min(worst, frac)
        err_max = max(err_max, err.max().item())
        rel = max(rel, err.max().item() / max(scales[name], 1e-30))
    return worst, err_max, rel


def explain_lobe_sum_bwd(label, args, cot, kw, sel, got, want):
    """Each lane B4b puts outside `hold_lobe_sum_bwd`'s tolerance: whether
    B4's bits and the plain bits differ there (a gate flip) and by how
    much each differing lobe's |ang| misses a_cone (`sel_flips`), the
    least such miss over the lane's lobes, and the errors; printed, and
    with the lane's inputs and cotangent written to
    chiprun_out/lobe_sum_bwd_outliers.json. Returns the lanes."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import grating as gops

    outside, scales = lobe_sum_bwd_outside(got, want)
    lanes = torch.zeros_like(next(iter(outside.values())))
    for v in outside.values():
        lanes |= v
    rows = []
    for lane in lanes.nonzero().flatten().tolist()[:32]:
        one = [t[lane:lane + 1] for t in args]
        plain_sel = gops.grating_lobe_sum_sel_plain(one, kw["half"],
                                                    kw["separable"])
        flips = sel_flips(one, kw["half"], kw["separable"],
                          sel[lane:lane + 1], plain_sel)
        # the least miss of a lobe the lattice admits (|aa|, |bb| <= 1)
        least = min(
            ((ang.abs() - one[10][0]).abs()[(aa.abs() <= 1.0)
                                             & (bb.abs() <= 1.0)]
             .min().item() for _, _, aa, bb, ang, _ in gops.lobe_gates(
                *one[:5], one[6], one[10], kw["half"], kw["separable"])
             if bool(((aa.abs() <= 1.0) & (bb.abs() <= 1.0)).any())),
            default=None)
        rows.append({
            "lane": lane, "gate_flip": bool(flips), "flips": flips,
            "least_ang_miss": least,
            "bits": sel[lane].tolist(), "plain_bits": plain_sel[0].tolist(),
            "errors": {name: {
                "of_largest": (got[i][lane] - want[i][lane]).abs().max().item()
                / max(scales[name], 1e-30),
                "got": got[i][lane].tolist(), "want": want[i][lane].tolist()}
                for i, name in enumerate(gops.LOBE_SUM_INPUTS)
                if name in outside and bool(outside[name][lane])},
            "inputs": {k: t[0].tolist() for k, t in zip(LOBE_SUM_ARGS, one)},
            "cot": cot[lane].tolist()})
    emit({"phase": "kernels", "name": "grating_lobe_sum_bwd",
          "case": label, "lanes_outside": int(lanes.sum()),
          "outside": [{k: r[k] for k in ("lane", "gate_flip", "flips",
                                         "least_ang_miss", "errors")}
                      for r in rows]})
    if rows:
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, "lobe_sum_bwd_outliers.json")
        old = []
        if os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
        with open(path, "w") as f:
            json.dump(old + [{"case": label, **kw, **r} for r in rows], f)
    return rows


def lobe_sum_bwd_row(args, cot, kw, sel, got, want, specials):
    """The kernels line's row of B4b on inputs `args` (LOBE_SUM_ARGS order)
    with the cotangent `cot`, kw (half, separable) and B4's bits `sel`:
    held (`hold_lobe_sum_bwd`), timed, its bound counted by
    `lobe_sum_bwd_own_count` (the bytes it must move and its own work on
    the selected lobes), with PR 17's count of the whole VJP (the forward
    chain on every live lobe and the adjoints: `lobe_sum_bwd_count`) as
    "vjp_bound_ms"."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    frac, err, rel = hold_lobe_sum_bwd(str(kw), got, want)
    ins = dict(zip(LOBE_SUM_ARGS, args))
    own = lobe_sum_bwd_own_count(ins, sel, kw["half"], kw["separable"],
                                 specials)
    vjp = lobe_sum_bwd_count(ins, kw["half"], kw["separable"], specials)
    times = kernel_times(lambda: gops.grating_lobe_sum_bwd(
        args, cot, sel=sel, **kw), device=True)
    plain_ms = time_ms(lambda: gops.grating_lobe_sum_bwd_plain(
        args, cot, **kw), reps=3, calls=2, warmup=1)
    grads = [x for x in got if x is not None]
    table = gops.bessel_table(cot.device)
    bnd = bound(own["bytes"], own["ops"], own["fma"])
    vjp_bnd = bound(nbytes(list(args), cot, grads, table), vjp["ops"],
                    vjp["fma"])
    return {"name": "grating_lobe_sum_bwd", "route": "cuda",
            "source": "mitsuba3_plt_tpu_torch/ops/csrc/grating.cu",
            "replaces": "mitsuba3_plt_tpu/ops/grating_pallas.py:743 "
                        "(_make_lobe_sum_vjp: the custom_vjp's backward, "
                        "jax.vjp of _lobe_sum_xla :660)",
            "max_abs_err": err, "max_err_of_largest": rel, **times,
            "plain_ms": plain_ms, **bnd, "library_ms": None,
            "vjp_bound_ms": vjp_bnd["bound_ms"],
            "vjp_bound_by": vjp_bnd["bound_by"],
            "vjp_bound_slots": vjp_bnd["bound_slots"],
            "n": cot.shape[0], "agreement": frac,
            "case": [kw["half"], kw["separable"]],
            "count": {**own, "how": (
                "B4b over B4's bits: every lane its bits and 16 gradient "
                "floats, a lane with bits its inputs and cotangent, the "
                "table once; a hand count of lobe_sum_bwd_kernel "
                "(chip_smoke.py LOBE_OWN_*, LOBE_BWD_*, with the forward "
                "chain's LOBE_*) on the lanes, channels and lobes the bits "
                "select; special functions: calls x their fast-path "
                "instructions in the SASS of fn_probe_kernel; the "
                "adjoints' slots half their operations (contracted)"),
                "vjp": vjp}}


def check_lobe_sum_bwd(n, rng, dev, specials, box_inputs):
    """B4b, fed the bits of B4's recording launch, against autograd of the
    plain version on the four cases of `check_lobe_sum` (the main path's
    case at n lanes, the others at n / 16) and on the grating box path's
    own first lobe-sum inputs (half 2, separable), each with a seeded
    normal cotangent; every lane outside the tolerance explained
    (`explain_lobe_sum_bwd`). Returns the row of the main case and the
    grating box's."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.ops import grating as gops

    def one(label, args, cot, kw):
        _, sel = gops.grating_lobe_sum_record(args, **kw)
        got = gops.grating_lobe_sum_bwd(args, cot, sel=sel, **kw)
        want = gops.grating_lobe_sum_bwd_plain(args, cot, **kw)
        explain_lobe_sum_bwd(label, args, cot, kw, sel, got, want)
        frac, err, rel = hold_lobe_sum_bwd(label, got, want)
        return sel, got, want, (frac, err, rel)

    cases = [(3, True, 0, 0.0, n), (3, False, 0, 1.5, n // 16),
             (4, True, 1, 0.0, n // 16), (2, True, 2, 0.0, n // 16)]
    rows = []
    for half, sep, gtype, ip_y, nn in cases:
        ins = lobe_sum_inputs(rng, nn, gtype, ip_y, dev)
        args = [ins[k] for k in LOBE_SUM_ARGS]
        cot = torch.as_tensor(rng.normal(size=(nn, 3)).astype(np.float32),
                              device=dev)
        kw = dict(half=half, separable=sep)
        sel, got, want, (frac, err, rel) = one(str((half, sep, gtype)),
                                               args, cot, kw)
        emit({"phase": "kernels", "name": "grating_lobe_sum_bwd",
              "case": [half, sep, gtype, ip_y], "n": nn, "agreement": frac,
              "max_abs_err": err, "max_err_of_largest": rel})
        if not rows:
            rows.append(lobe_sum_bwd_row(args, cot, kw, sel, got, want,
                                         specials))
        del got, want
    args, kw = box_inputs["grating_lobe_sum"]
    args = list(args)
    cot = torch.as_tensor(rng.normal(size=(args[0].shape[0], 3)).astype(
        np.float32), device=dev)
    kw = dict(half=kw["half"], separable=kw["separable"])
    sel, got, want, _ = one("grating box", args, cot, kw)
    rows.append(dict(lobe_sum_bwd_row(args, cot, kw, sel, got, want,
                                      specials),
                     rays="cbox grating path"))
    return rows


def grad_grating(scene, integ):
    """grad-grating-800x600-plt: render_loss_grad of the mean image on the
    four grating parameters (GRAD_SPP spp, one checkpointed pass of
    480,000 lanes each spp), one warm-up and GRAD_EVALS timed
    evaluations, each ending in a device sync. The gradients must be
    finite and non-zero on the grating's row, each forward kernel
    launches twice a bounce and pass (the checkpoint's recomputation)
    and B4b once for each B4 launch that needed a gradient, and the
    height's and inv_period's gradients must share the sign of a central
    difference of the render (tests/test_ad.py's steps). Returns the
    timed evaluations' launches."""
    import torch

    from mitsuba3_plt_tpu_torch import ad, ops
    from mitsuba3_plt_tpu_torch.ad.render import default_spp_per_pass

    ph = Phase("grad-grating-800x600-plt")
    W, H = scene.sensor.resolution
    keys = list(GRAD_KEYS)

    def evaluate():
        return ad.render_loss_grad(scene, integ.sample, torch.mean, keys,
                                   seed=0, spp=GRAD_SPP)

    t0 = time.perf_counter()
    evaluate()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    eval_ms = []
    for _ in range(GRAD_EVALS):
        t0 = time.perf_counter()
        loss, grads = evaluate()
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    grads = {k: v.cpu() for k, v in grads.items()}
    params = ad.traverse(scene)
    fd = {}
    with torch.no_grad():
        for key, idx, eps in GRAD_FD:
            f = []
            for sgn in (1.0, -1.0):
                p = params[key].clone()
                p[idx] += sgn * eps
                f.append(ad.render_differentiable(
                    params.update({key: p}), integ.sample, seed=0,
                    spp=GRAD_SPP).double().mean().item())
            fd[key] = {"fd": (f[0] - f[1]) / (2 * eps), "eps": eps,
                       "grad": grads[key][idx].item()}
    spp_pass = default_spp_per_pass(W, H, GRAD_SPP)
    per_eval = integ.max_depth * (GRAD_SPP // spp_pass)
    ph.emit(width=W, height=H, max_depth=integ.max_depth, spp=GRAD_SPP,
            spp_per_pass=spp_pass, lanes_per_pass=W * H * spp_pass,
            keys=keys, loss=loss.item(), warmup_ms=warm_ms,
            ms_per_gradient=eval_ms, peak_mem_bytes=peak,
            launches={k: v for k, v in launches.items() if v},
            grads={k: v[1].tolist() for k, v in grads.items()},
            finite_difference=fd)
    for k, v in grads.items():
        require(bool(torch.isfinite(v).all()) and bool(v[1].abs().max() > 0),
                f"grad-grating: {k} gradient not finite and non-zero")
    fwd = 2 * per_eval * GRAD_EVALS
    want = {**NO_LAUNCHES, "intersect_q": fwd, "occluded_q": fwd,
            "grating_sample": fwd, "grating_lobe_sum_record": fwd,
            "grating_lobe_sum_bwd": per_eval * GRAD_EVALS}
    require(launches == want,
            f"grad-grating: launches {launches}, expected {want}")
    for key, r in fd.items():
        require(r["fd"] * r["grad"] > 0,
                f"grad-grating: {key} gradient {r['grad']} against the "
                f"finite difference {r['fd']}")
    profile_run("split-grad-grating", evaluate,
                sum(eval_ms) / len(eval_ms) / 1e3,
                "chip_smoke_profile_grad_grating.json")
    return launches


def grad_cbox(scene):
    """grad-cbox-512x512: on the Cornell box, depth 7 / rr 50, 2 spp a
    pass: PRB's primal against the path tracer's differentiable render
    (rtol 2e-4 / atol 2e-4, tests/test_prb.py's), PRB's base_color
    gradient against autograd through the path tracer (within 0.1 of
    the largest entry, tests/test_prb.py's bound), each timed with its
    peak memory, then ADAM_STEPS Adam steps of PRB gradients from the
    scene toward a target with the white wall's albedo halved: the loss
    must fall."""
    import torch

    from mitsuba3_plt_tpu_torch import ad, ops
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.prb import PRBIntegrator

    ph = Phase("grad-cbox-512x512")
    path = PathIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR)
    prb = PRBIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR)
    key = "materials.base_color"
    kw = dict(seed=0, spp=GRAD_CBOX_SPP)
    with torch.no_grad():
        img_p = ad.render_differentiable(scene, path.sample, **kw)
        img_r = ad.render_differentiable(scene, prb.sample, **kw)
    close = torch.isclose(img_r, img_p, rtol=2e-4, atol=2e-4)
    res, grads = {}, {}
    ops.reset_launch_counts()
    for name, integ in (("path", path), ("prb", prb)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, g = ad.render_loss_grad(scene, integ.sample, torch.mean, [key],
                                   **kw)
        torch.cuda.synchronize()
        grads[name] = g[key].cpu()
        res[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    launches = ops.launch_counts()
    a, b = grads["path"], grads["prb"]
    denom = max(a.abs().max().item(), b.abs().max().item())
    gap = (a - b).abs().max().item()

    params = ad.traverse(scene)
    target_albedo = params[key].clone()
    target_albedo[0] *= 0.5
    with torch.no_grad():
        target = ad.render_differentiable(
            params.update({key: target_albedo}), prb.sample, **kw)
    opt = ad.Adam(lr=0.1)
    p = {key: params[key]}
    state = opt.init(p)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(ADAM_STEPS):
        t0 = time.perf_counter()
        loss, g = ad.render_loss_grad(
            params.update(p), prb.sample,
            lambda img: torch.mean((img - target) ** 2), [key], **kw)
        p, state = opt.step(p, g, state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    W, H = scene.sensor.resolution
    ph.emit(width=W, height=H, max_depth=CBOX_DEPTH, spp=GRAD_CBOX_SPP,
            primal_close_share=close.float().mean().item(),
            primal_max_abs_diff=(img_r - img_p).abs().max().item(),
            image_mean=img_p.mean().item(), gradient=res,
            launches={k: v for k, v in launches.items() if v},
            grad_max=denom, grad_gap=gap,
            grad_base_color_prb=b.tolist(), adam_losses=losses,
            adam_step_ms=step_ms,
            adam_peak_mem_bytes=torch.cuda.max_memory_allocated())
    require(bool(close.all()), "grad-cbox: PRB's primal differs from the "
            "path tracer's")
    require(bool(torch.isfinite(b).all()) and denom > 0,
            "grad-cbox: gradients not finite and non-zero")
    require(gap < 0.1 * denom, f"grad-cbox: PRB's gradient {b.tolist()} "
            f"against the remat gradient {a.tolist()}")
    require(losses[-1] < losses[0], f"grad-cbox: Adam's loss {losses}")
    require(launches["intersect_q"] > 0 and launches["occluded_q"] > 0
            and sum(launches.values()) == launches["intersect_q"]
            + launches["occluded_q"],
            f"grad-cbox: launches {launches}")
    profile_run("split-grad-cbox-prb", lambda: ad.render_loss_grad(
        scene, prb.sample, torch.mean, [key], **kw), res["prb"]["ms"] / 1e3,
        "chip_smoke_profile_grad_cbox_prb.json")


def grad_boundary(name, eps, tol):
    """grad-boundary-<name>: tests/test_projective.py's scene `name` at
    BOUNDARY_W x BOUNDARY_W through the package's load_dict, the loss
    sum(ramp_x * image). render_loss_grad on the vertex rows at
    BOUNDARY_SPP spp with and without the boundary terms
    (BOUNDARY_SAMPLES edge samples a term), each timed after a warm-up
    with its launches (B1 and B2 only). The interior term must be zero;
    the moving object's x-translation gradient must lie within `tol` of a
    central difference of the port's own render on the card (the
    package's render, BOUNDARY_FD_SPP spp, seed 7, step `eps`: JAX's).
    Then one boundary gradient by kernel (torch.profiler)."""
    import torch

    import mitsuba3_plt_tpu_torch as mi
    from mitsuba3_plt_tpu_torch import ad, ops
    from mitsuba3_plt_tpu_torch.integrators import make_integrator
    from mitsuba3_plt_tpu_torch.scene.presets import (BOUNDARY_ROWS,
                                                      boundary_scene_dict)

    ph = Phase(f"grad-boundary-{name}")
    W = H = BOUNDARY_W
    # tests/test_projective.py's loss weights: a ramp in x
    wmap = (torch.arange(W, dtype=torch.float32, device="cuda") / W)[
        None, :, None].expand(H, W, 3)
    scene, meta = mi.load_dict(boundary_scene_dict(name, W, H),
                               device="cuda")
    integ = make_integrator(meta["integrator"])
    keys = ["geo.tri_p0", "geo.tri_p1", "geo.tri_p2"]

    def evaluate(boundary):
        return ad.render_loss_grad(
            scene, integ.sample, lambda img: (img * wmap).sum(), keys,
            seed=0, spp=BOUNDARY_SPP, geometry_boundary=boundary,
            boundary_samples=BOUNDARY_SAMPLES)

    ms, launches, grads = {}, {}, {}
    for boundary in (False, True):
        evaluate(boundary)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, g = evaluate(boundary)
        torch.cuda.synchronize()
        ms[boundary] = (time.perf_counter() - t0) * 1e3
        launches[boundary] = {k: v for k, v in ops.launch_counts().items()
                              if v}
        grads[boundary] = {k: v.cpu() for k, v in g.items()}
    rows = BOUNDARY_ROWS[name]
    grad_x = sum(float(grads[True][k][rows, 0].sum()) for k in keys)
    interior_max = max(float(v.abs().max()) for v in grads[False].values())
    f = []
    for delta in (eps, -eps):
        loaded = mi.load_dict(boundary_scene_dict(name, W, H, delta),
                              device="cuda")
        img = mi.render(loaded, spp=BOUNDARY_FD_SPP, seed=7)
        f.append(float((img * wmap).double().sum()))
    fd = (f[0] - f[1]) / (2 * eps)
    split_res = profile_run(f"split-grad-boundary-{name}",
                            lambda: evaluate(True), ms[True] / 1e3,
                            f"chip_smoke_profile_grad_boundary_{name}.json")
    rel = abs(grad_x - fd) / max(abs(fd), 1e-30)
    ph.emit(width=W, height=H, max_depth=integ.max_depth, spp=BOUNDARY_SPP,
            boundary_samples=BOUNDARY_SAMPLES, faces=scene.geo.n_faces,
            ms_per_gradient_with_boundary=ms[True],
            ms_per_gradient_without=ms[False],
            boundary_ms=ms[True] - ms[False],
            device_busy_ms=split_res["device_busy_ms"],
            device_idle_share=split_res["device_idle_share"],
            launches_with_boundary=launches[True],
            launches_without=launches[False], interior_max=interior_max,
            grad_x=grad_x, finite_difference=fd, fd_eps=eps,
            fd_spp=BOUNDARY_FD_SPP, rel_error=rel, tolerance=tol)
    require(interior_max == 0.0, f"grad-boundary-{name}: the interior "
            "term on the vertex rows is not zero")
    require(all(bool(torch.isfinite(v).all())
                for v in grads[True].values()),
            f"grad-boundary-{name}: gradients not finite")
    require(abs(fd) > 0 and rel < tol, f"grad-boundary-{name}: gradient "
            f"{grad_x} against the central difference {fd}")
    for boundary, counts in launches.items():
        require(set(counts) == {"intersect_q", "occluded_q"},
                f"grad-boundary-{name}: launches {counts}")
    require(all(launches[True].get(k, 0) > launches[False].get(k, 0)
                for k in ("intersect_q", "occluded_q")),
            f"grad-boundary-{name}: the boundary terms launched no B1/B2")


def grad_grating_polarized(scene, integ):
    """grad-grating-800x600-plt-polarized: render_loss_grad of the mean S0
    image on the four grating parameters under RGB_POLARIZED, PLT depth 7
    / rr 50, GRAD_SPP spp (four checkpointed passes of 480,000 lanes): a
    warm-up and one timed evaluation (ms, peak memory), finite gradients
    non-zero on the grating's row, B1-B3 and B4's recording instance
    twice a bounce and pass and B4b once, and the height's gradient within
    POL_HEIGHT_TOL of a central difference of the polarized render on the
    card (step GRAD_FD's, 1e-4). Then one evaluation by kernel. Returns
    the timed evaluation's launches."""
    import torch

    from mitsuba3_plt_tpu_torch import ad, ops
    from mitsuba3_plt_tpu_torch.ad.render import default_spp_per_pass
    from mitsuba3_plt_tpu_torch.config import RGB_POLARIZED

    ph = Phase("grad-grating-800x600-plt-polarized")
    W, H = scene.sensor.resolution
    keys = list(GRAD_KEYS)

    def evaluate():
        return ad.render_loss_grad(scene, integ.sample, torch.mean, keys,
                                   seed=0, spp=GRAD_SPP, cfg=RGB_POLARIZED)

    t0 = time.perf_counter()
    evaluate()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    grads = {k: v.cpu() for k, v in grads.items()}
    key, idx, eps = GRAD_FD[0]
    params = ad.traverse(scene)
    f = []
    with torch.no_grad():
        for sgn in (1.0, -1.0):
            p = params[key].clone()
            p[idx] += sgn * eps
            f.append(ad.render_differentiable(
                params.update({key: p}), integ.sample, seed=0, spp=GRAD_SPP,
                cfg=RGB_POLARIZED).double().mean().item())
    fd = (f[0] - f[1]) / (2 * eps)
    got = grads[key][idx].item()
    split_res = profile_run("split-grad-grating-polarized", evaluate,
                            eval_ms / 1e3,
                            "chip_smoke_profile_grad_grating_polarized.json")
    spp_pass = default_spp_per_pass(W, H, GRAD_SPP)
    per_eval = integ.max_depth * (GRAD_SPP // spp_pass)
    ph.emit(width=W, height=H, max_depth=integ.max_depth, spp=GRAD_SPP,
            spp_per_pass=spp_pass, lanes_per_pass=W * H * spp_pass,
            keys=keys, loss=loss.item(), warmup_ms=warm_ms,
            ms_per_gradient=eval_ms, peak_mem_bytes=peak,
            device_busy_ms=split_res["device_busy_ms"],
            device_idle_share=split_res["device_idle_share"],
            launches={k: v for k, v in launches.items() if v},
            grads={k: v[1].tolist() for k, v in grads.items()},
            height_grad=got, height_fd=fd, fd_eps=eps,
            height_rel_error=abs(got - fd) / abs(fd),
            tolerance=POL_HEIGHT_TOL)
    for k, v in grads.items():
        require(bool(torch.isfinite(v).all()) and bool(v[1].abs().max() > 0),
                f"grad-grating-polarized: {k} gradient not finite and "
                "non-zero")
    fwd = 2 * per_eval
    want = {**NO_LAUNCHES, "intersect_q": fwd, "occluded_q": fwd,
            "grating_sample": fwd, "grating_lobe_sum_record": fwd,
            "grating_lobe_sum_bwd": per_eval}
    require(launches == want,
            f"grad-grating-polarized: launches {launches}, expected {want}")
    require(abs(got - fd) <= POL_HEIGHT_TOL * abs(fd),
            f"grad-grating-polarized: height gradient {got} against the "
            f"central difference {fd}")
    return launches


def grad_cbox_stokes():
    """grad-cbox-stokes: the Stokes path (main-cbox-stokes' integrator,
    depth 7 / rr 50) at 512 x 512, GRAD_CBOX_SPP spp. On the diffuse box
    the S0 image's base_color gradient against the scalar path tracer's
    (whether equal to the bit, and the largest gap: within 1e-5 of the
    largest entry). On the conductor box each index's (eta_re, eta_im of
    the box's row) against a central difference of the Stokes render
    (step 1e-2, within STOKES_ETA_TOL). On the glass box the index's
    gradient against the CPU's (the plain versions) on the 128 x 128 box,
    within GLASS_CPU_TOL of the largest entry; its central differences at
    full size are printed beside it, not held (its lobe pdf and hit
    distances are detached: ROADMAP C8). Each gradient is timed."""
    import torch

    from mitsuba3_plt_tpu_torch import ad, ops
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.stokes import (
        PolarizedPathIntegrator, StokesIntegrator)
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box

    ph = Phase("grad-cbox-stokes")
    stokes = StokesIntegrator(PolarizedPathIntegrator(CBOX_DEPTH, CBOX_RR),
                              forward_basis=False)
    path = PathIntegrator(CBOX_DEPTH, CBOX_RR)
    kw = dict(seed=0, spp=GRAD_CBOX_SPP)
    res = {}

    def timed(name, scene, sample, loss, keys, **extra):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, g = ad.render_loss_grad(scene, sample, loss, keys, **kw, **extra)
        torch.cuda.synchronize()
        res[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "launches": {k: v for k, v in
                                  ops.launch_counts().items() if v}}
        return {k: v.cpu() for k, v in g.items()}

    base = ["materials.base_color"]
    diffuse = cornell_box(CBOX_W, CBOX_H, device="cuda")
    timed("warm-up", diffuse, stokes.sample,
          lambda img: img[..., 3:6].mean(), base)
    g_s = timed("diffuse-stokes-s0", diffuse, stokes.sample,
                lambda img: img[..., 3:6].mean(), base)[base[0]]
    g_p = timed("diffuse-path", diffuse, path.sample, torch.mean,
                base)[base[0]]
    del diffuse
    s0_gap = (g_s - g_p).abs().max().item()
    s0_scale = g_p.abs().max().item()

    def central(scene, key, idx, eps, spp):
        params = ad.traverse(scene)
        f = []
        with torch.no_grad():
            for sgn in (1.0, -1.0):
                p = params[key].clone()
                p[idx] += sgn * eps
                f.append(ad.render_differentiable(
                    params.update({key: p}), stokes.sample, seed=0,
                    spp=spp).double().mean().item())
        return (f[0] - f[1]) / (2 * eps)

    cond = cornell_box(CBOX_W, CBOX_H, box_material="conductor",
                       device="cuda")
    eta_keys = ["materials.eta_re", "materials.eta_im"]
    g_c = timed("conductor-eta", cond, stokes.sample, torch.mean, eta_keys)
    conductor = {}
    for key in eta_keys:
        idx = (3, 0) if key == "materials.eta_re" else (3, 1)
        conductor[key] = {"grad": g_c[key][idx].item(),
                          "fd": central(cond, key, idx, 1e-2,
                                        GRAD_CBOX_SPP)}
    del cond
    glass = cornell_box(CBOX_W, CBOX_H, box_material="dielectric",
                        device="cuda")
    key, idx = "materials.eta_re", (3, 0)
    g_g = timed("glass-eta", glass, stokes.sample, torch.mean, [key])
    glass_fd = {eps: central(glass, key, idx, eps, 4 * GRAD_CBOX_SPP)
                for eps in (5e-2, 1e-2)}
    del glass
    small = {}
    for dev in ("cuda", "cpu"):
        scene = cornell_box(128, 128, box_material="dielectric", device=dev)
        _, g = ad.render_loss_grad(scene, stokes.sample, torch.mean, [key],
                                   seed=0, spp=4)
        small[dev] = g[key].cpu()
    small_gap = (small["cuda"] - small["cpu"]).abs().max().item()
    small_scale = small["cpu"].abs().max().item()
    ph.emit(width=CBOX_W, height=CBOX_H, max_depth=CBOX_DEPTH,
            spp=GRAD_CBOX_SPP, gradients=res,
            s0_equal_to_the_bit=bool(torch.equal(g_s, g_p)),
            s0_max_gap=s0_gap, s0_largest=s0_scale,
            conductor=conductor, conductor_tolerance=STOKES_ETA_TOL,
            glass_eta_grad=g_g[key][idx].item(),
            glass_eta_fd={str(k): v for k, v in glass_fd.items()},
            glass_fd_spp=4 * GRAD_CBOX_SPP,
            glass_128_card=small["cuda"][idx].item(),
            glass_128_cpu=small["cpu"][idx].item(),
            glass_128_gap=small_gap, glass_128_largest=small_scale)
    require(s0_scale > 0 and s0_gap <= 1e-5 * s0_scale,
            f"grad-cbox-stokes: S0 gradient {g_s.tolist()} against the "
            f"path's {g_p.tolist()}")
    for k, r in conductor.items():
        require(r["fd"] != 0 and abs(r["grad"] - r["fd"])
                <= STOKES_ETA_TOL * abs(r["fd"]),
                f"grad-cbox-stokes: conductor {k} {r}")
    require(bool(torch.isfinite(g_g[key]).all()) and g_g[key][idx] != 0,
            "grad-cbox-stokes: the glass index gradient not finite and "
            "non-zero")
    require(small_scale > 0 and small_gap <= GLASS_CPU_TOL * small_scale,
            f"grad-cbox-stokes: the glass index gradient on the card "
            f"{small['cuda'].tolist()} against the CPU's "
            f"{small['cpu'].tolist()}")
    for name, r in res.items():
        require(set(r["launches"]) == {"intersect_q", "occluded_q"},
                f"grad-cbox-stokes: {name} launches {r['launches']}")


def tf32_grad_cbox(scene):
    """tf32-grad-cbox: grad-cbox's path-tracer base_color gradient with the
    caller's TF32 flags off, on, and off again: the gradient with TF32 on
    equal to the one with it off (the renders take full float32 products
    whatever the caller set) to the bit, or, if two runs with it off
    differ (atomic sums), within four times their gap; and the flags come
    back as the caller set them."""
    import torch

    from mitsuba3_plt_tpu_torch import ad
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator

    ph = Phase("tf32-grad-cbox")
    path = PathIntegrator(CBOX_DEPTH, CBOX_RR)
    key = ["materials.base_color"]
    out, after = [], []
    for on in (False, True, False):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        _, g = ad.render_loss_grad(scene, path.sample, torch.mean, key,
                                   seed=0, spp=GRAD_CBOX_SPP)
        out.append(g[key[0]].cpu())
        after.append((torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32))
    gap = (out[1] - out[0]).abs().max().item()
    run_gap = (out[2] - out[0]).abs().max().item()
    ph.emit(equal_to_the_bit=bool(torch.equal(out[1], out[0])),
            max_gap=gap, run_to_run_gap=run_gap,
            largest=out[0].abs().max().item(), flags_after=after)
    require(after == [(False, False), (True, True), (False, False)],
            f"tf32-grad-cbox: flags after the gradients {after}")
    require(gap <= 4 * run_gap,
            f"tf32-grad-cbox: gradients differ by {gap} with TF32 on, "
            f"{run_gap} between two runs with it off")


def gradients_only():
    """`python3 chip_smoke.py --gradients`: the card line and the
    gradient phases of the boundary terms, polarized PLT, the Stokes path
    and the TF32 flags, each as in the full run."""
    import torch

    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import (cornell_box,
                                                      grating_scene)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Phase("card").emit(nvidia_smi=nvidia_smi_line(),
                       device=torch.cuda.get_device_name(0))
    for name, eps, tol in BOUNDARY_CELLS:
        grad_boundary(name, eps, tol)
    grad_grating_polarized(grating_scene(MAIN_W, MAIN_H, device="cuda"),
                           PLTIntegrator(MAIN_DEPTH, MAIN_RR))
    grad_cbox_stokes()
    tf32_grad_cbox(cornell_box(CBOX_W, CBOX_H, device="cuda"))


def hemisphere_rays(scene, p, ng, live, rng):
    """Bounce-like and shadow rays from surface points p [n, 3] with face
    normals ng (numpy): origins pushed off along ng as the integrator does,
    cosine-hemisphere directions about ng, and shadow rays to the scene's
    point light with maxt at its distance. Lanes that are not live get the
    integrator's canonical dead rays (o = 1e8, d = +z; shadow maxt 0)."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.core import math as m

    n = len(p)
    org = p + ng * m.RayEpsilon
    a = np.cross(ng, np.where(np.abs(ng[:, :1]) > 0.9, [[0.0, 1.0, 0.0]],
                              [[1.0, 0.0, 0.0]]))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    bb = np.cross(ng, a)
    u1, u2 = rng.random(n), rng.random(n)
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    d = (a * (r * np.cos(phi))[:, None] + bb * (r * np.sin(phi))[:, None]
         + ng * np.sqrt(1 - u1)[:, None])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to_l = scene.emitters.position[0].cpu().numpy().astype(np.float64) - org
    dist = np.linalg.norm(to_l, axis=-1)
    lv = live[:, None]
    dead_o, dead_d = np.full((n, 3), 1e8), np.array([[0.0, 0.0, 1.0]])
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                  device=scene.device)
    bounce = (t(np.where(lv, org, dead_o)), t(np.where(lv, d, dead_d)),
              t(np.full(n, np.inf)))
    shadow = (t(np.where(lv, org, dead_o)),
              t(np.where(lv, to_l / dist[:, None], dead_d)),
              t(np.where(live, dist * (1.0 - m.ShadowEpsilon), 0.0)))
    return bounce, shadow


def camera_hit_rays(scene, cam, hit, rng):
    """The rays of the path's first bounce, lane for lane: from the camera
    rays' hits (t, prim from intersect_clu2), dead where they missed."""
    import numpy as np

    t, prim = hit[0].cpu().numpy(), hit[1].cpu().numpy()
    live = prim >= 0
    o, d = cam.o.cpu().numpy(), cam.d.cpu().numpy()
    p = o + d * np.where(live, t, 0.0)[:, None]
    ng = scene.geo.tri_attr[:, 0:3].cpu().numpy()[np.maximum(prim, 0)]
    return hemisphere_rays(scene, p.astype(np.float64),
                           ng.astype(np.float64), live, rng)


def random_surface_rays(scene, n, rng):
    """Incoherent rays: from random points of random faces, every lane
    live (neighbouring lanes start far apart)."""
    import numpy as np

    from mitsuba3_plt_tpu_torch.scene.shape import make_sphere

    mesh = make_sphere(MESH_SUBDIV)
    tri = mesh.faces[rng.integers(0, len(mesh.faces), n)]
    c = [mesh.vertices[tri[:, k]].astype(np.float64) for k in range(3)]
    ng = np.cross(c[1] - c[0], c[2] - c[0])
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    b1, b2 = rng.random(n), rng.random(n)
    flip = b1 + b2 > 1
    b1, b2 = np.where(flip, 1 - b1, b1), np.where(flip, 1 - b2, b2)
    p = c[0] + b1[:, None] * (c[1] - c[0]) + b2[:, None] * (c[2] - c[0])
    return hemisphere_rays(scene, p, ng, np.ones(n, bool), rng)


def dead_rays(n, dev):
    """n of the integrator's canonical dead rays (o = 1e8, d = +z): the
    mesh path's launches after the first bounce off the convex icosphere
    carry only these. maxt inf for a closest hit, 0 for a shadow ray."""
    import torch

    o = torch.full((n, 3), 1e8, device=dev)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=dev).repeat(n, 1)
    return ((o, d, torch.full((n,), float("inf"), device=dev)),
            (o, d, torch.zeros((n,), device=dev)))


def clu2_ops(n, counts, test_ops):
    """The operations of a clu2 walk's counts: the ray terms, a slab test
    for each root, group, super and cluster test, test_ops for each
    triangle."""
    slabs = sum(counts.get(k, 0) for k in ("root_tests", "group_tests",
                                           "super_tests", "cluster_tests"))
    return (n * CLU2_RAY_SETUP_OPS + slabs * SLAB_OPS
            + counts["triangle_tests"] * test_ops)


def check_clu2(scene, rng):
    """B5 and B6 against their plain walk on the mesh82k scene, to the bit,
    and the plain walk against the DFS walk without the gates
    (`intersect_clu2_dfs`, the first port's), to the bit. Closest hit: the
    camera rays, the first bounce's rays from their hits, incoherent rays
    from random surface points and canonical dead rays; any hit: the shadow
    rays of the first bounce and of the random points, and dead rays. Each
    row carries the plain walk's tests a ray, which its bound counts, and
    the DFS walk's beside them. The kernels line carries the path's own sets:
    camera rays (B5) and first-bounce shadow rays (B6). Returns (those two
    rows, the ray sets {label: (o, d, maxt)} but the dead ones, the kernels'
    ms on each {label: ms})."""
    import torch

    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    dev, ct = scene.device, scene.ctab2
    W, H = scene.sensor.resolution
    cam, _ = sample_rays(scene, Sampler.create(0, W * H * MESH_SPP_PASS,
                                               device=dev), W, H,
                         MESH_SPP_PASS)
    n = cam.o.shape[0]
    tables = (ct.supers, ct.boxes, ct.rows, ct.anchor)
    common = {"route": "cuda",
              "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_clu2.cu",
              "plain_timing": "the comparison call, once at full width",
              "library_ms": None, "n": n}

    def per_ray(counts):
        return {k: v / n for k, v in counts.items()}

    def closest(label, o, d, mt):
        counts, dfs = {}, {}
        got = isect.intersect_clu2(ct, o, d, mt)
        want, plain_ms = time_once(lambda: isect.intersect_clu2_plain(
            ct, o, d, mt, counts=counts))
        ref = isect.intersect_clu2_dfs(ct, o, d, mt, counts=dfs)
        prim_same = got[1] == want[1]
        frac_prim = prim_same.float().mean().item()
        both = prim_same & (want[1] >= 0)
        # tolerance: none. The kernel rounds every product and sum as the
        # plain walk does and walks in its order, so prim, t, u and v are
        # equal on every lane (the first port's floor, prim on all but 1
        # lane in 10,000, stays checked first); the gates change no result
        require(frac_prim >= 1 - 1e-4,
                f"intersect_clu2 {label} prim agreement {frac_prim}")
        require(all(torch.equal(got[k], want[k]) for k in range(4)),
                f"intersect_clu2 {label}: prim/t/u/v differ from the plain "
                f"walk")
        require(all(torch.equal(ref[k], want[k]) for k in range(4)),
                f"intersect_clu2 {label}: the gates changed a result")
        err = max((got[k][both] - want[k][both]).abs().max().item()
                  if both.any() else 0.0 for k in (0, 2, 3))
        times = kernel_times(lambda: isect.intersect_clu2(ct, o, d, mt))
        bnd = bound(nbytes(tables, o, d, mt, got),
                    clu2_ops(n, counts, Q_TEST_OPS))
        row = {"name": "intersect_clu2", **common,
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1352 "
                           "(pallas_intersect_clu2)",
               "max_abs_err": err, **times, "plain_ms": plain_ms,
               **bnd, "rays": label,
               "prim_agreement": frac_prim,
               "hit_share": (want[1] >= 0).float().mean().item(),
               "tests_per_ray": per_ray(counts),
               "dfs_tests_per_ray": per_ray(dfs),
               "dfs_bound_ms": bound(nbytes(tables, o, d, mt, got),
                                     clu2_ops(n, dfs, Q_TEST_OPS))["bound_ms"]}
        return row, got

    def anyhit(label, o, d, mt):
        counts, dfs = {}, {}
        occ = isect.occluded_clu2(ct, o, d, mt)
        occ_plain, plain_ms = time_once(lambda: isect.occluded_clu2_plain(
            ct, o, d, mt, counts=counts))
        ref = isect.occluded_clu2_dfs(ct, o, d, mt, counts=dfs)
        frac_occ = (occ == occ_plain).double().mean().item()
        # tolerance: none (the first port's floor, all but 1 lane in
        # 10,000, first)
        require(frac_occ >= 1 - 1e-4,
                f"occluded_clu2 {label} agreement {frac_occ}")
        require(frac_occ == 1.0,
                f"occluded_clu2 {label}: differs from the plain walk on "
                f"{1.0 - frac_occ} of lanes")
        require(torch.equal(ref, occ_plain),
                f"occluded_clu2 {label}: the gates changed a result")
        times = kernel_times(lambda: isect.occluded_clu2(ct, o, d, mt))
        bnd = bound(nbytes(tables, o, d, mt, occ),
                    clu2_ops(n, counts, Q_ANYHIT_TEST_OPS))
        return {"name": "occluded_clu2", **common,
                "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:1364 "
                            "(pallas_occluded_clu2)",
                "max_abs_err": 1.0 - frac_occ, **times,
                "plain_ms": plain_ms, **bnd,
                "rays": label, "occ_agreement": frac_occ,
                "occluded_share": occ_plain.float().mean().item(),
                "tests_per_ray": per_ray(counts),
                "dfs_tests_per_ray": per_ray(dfs),
                "dfs_bound_ms": bound(
                    nbytes(tables, o, d, mt, occ),
                    clu2_ops(n, dfs, Q_ANYHIT_TEST_OPS))["bound_ms"]}

    cam_row, cam_hit = closest("camera", cam.o, cam.d, cam.maxt)
    sets = {"camera": (cam.o, cam.d, cam.maxt)}
    sets["bounce"], sets["shadow"] = camera_hit_rays(scene, cam, cam_hit, rng)
    sets["bounce-random"], sets["shadow-random"] = random_surface_rays(
        scene, n, rng)
    rows = {"camera": cam_row, "shadow": anyhit("shadow", *sets["shadow"])}
    for label in ("bounce", "bounce-random"):
        rows[label] = closest(label, *sets[label])[0]
    rows["shadow-random"] = anyhit("shadow-random", *sets["shadow-random"])
    dead, dead_shadow = dead_rays(n, dev)
    rows["dead"] = closest("dead", *dead)[0]
    rows["dead-shadow"] = anyhit("dead", *dead_shadow)
    for label in ("bounce", "bounce-random", "shadow-random", "dead",
                  "dead-shadow"):
        emit({"phase": "kernels", **rows[label]})
    return ([rows["camera"], rows["shadow"]], sets,
            {label: r["ms"] for label, r in rows.items()})


def walk_stats(counts, rays_per_warp):
    """The plain WideBVH walk's per-ray counts (`ray_pops`, entries popped,
    and `ray_triangle_tests`): the mean a ray, the mean over warps of the
    most in the warp (rays_per_warp consecutive rays: a warp runs as long
    as its longest walk), and the most."""
    import torch.nn.functional as F

    out = {}
    for key, name in (("ray_pops", "pops"),
                      ("ray_triangle_tests", "triangle_tests")):
        c = counts[key].double()
        warp = F.pad(c, (0, (-c.numel()) % rays_per_warp))
        warp = warp.view(-1, rays_per_warp).amax(-1)
        out[name] = {"mean": c.mean().item(),
                     "warp_max_mean": warp.mean().item(),
                     "max": c.max().item()}
    return out


def check_bvh(scene, sets, clu2_ms, rng):
    """B7a and B7b over the WideBVH against their plain walks on the packet
    scene, and B7b's plain walk against the skip-link walk over the
    PacketBVH that it replaced (`_bvh_walk`), all to the bit. First the
    five 1,048,576-lane mesh82k ray sets of `check_clu2` and the all-dead
    sets, unsorted and sorted by the route's coherence sort, with the
    sort's own time and the clu2 kernel's time on the same set beside them;
    then the wavefront the regenerative path gives the kernels: the 131,072
    camera rays of its first iteration in Morton order and the shadow rays
    of their hits, sorted as the route sorts them, and whether that sort
    pays for B7b (`sort_pays`). The kernels line carries the latter two."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    pb, wb = scene.pbvh, scene.wbvh

    def sorted_rays(o, d, mt):
        """(the rays in the route's order, the permutation)."""
        perm, _ = scene._packet_perm(o, d)
        return (o[perm], d[perm], mt[perm]), perm

    def answer(any_hit, o, d, mt):
        """The wrapper's answer as one tensor: the flags, or prim."""
        if any_hit:
            return isect.occluded_bvh(wb, o, d, mt)
        return isect.intersect_bvh(wb, o, d, mt)[1]

    def one(label, any_hit, o, d, mt):
        """The kernel on (o, d, mt) as given: tolerance none, the kernel
        rounds every product and sum as the plain walk does and walks in
        its order, so prim, t, u, v and the occlusion flags are equal on
        every lane; B7b's flags equal the skip-link walk's too (the two
        walks enter the same leaves)."""
        n, counts = o.shape[0], {}
        if any_hit:
            got = isect.occluded_bvh(wb, o, d, mt)
            want, plain_ms = time_once(lambda: isect.occluded_bvh_plain(
                wb, o, d, mt, counts=counts))
            skip = {}
            ref = isect._bvh_walk(pb, o, d, mt, True, skip)[4]
            agree = (got == want).double().mean().item()
            err = 1.0 - agree
            require(torch.equal(ref, want),
                    f"occluded_bvh {label}: the WideBVH walk differs from "
                    f"the skip-link walk on "
                    f"{(ref != want).double().mean().item()} of lanes")
            times = kernel_times(lambda: isect.occluded_bvh(wb, o, d, mt))
            extra = {"occluded_share": want.float().mean().item(),
                     "skip_link_tests_per_ray": {
                         k: skip[k] / n for k in ("slab_tests",
                                                  "triangle_tests")},
                     "skip_link_bound_ms": bound(
                         nbytes(pb.nodes, pb.tri, o, d, mt, got),
                         n * BVH_RAY_SETUP_OPS + skip["slab_tests"]
                         * SLAB_OPS + skip["triangle_tests"]
                         * BVH_ANYHIT_TEST_OPS)["bound_ms"]}
        else:
            got = isect.intersect_bvh(wb, o, d, mt)
            want, plain_ms = time_once(lambda: isect.intersect_bvh_plain(
                wb, o, d, mt, counts=counts))
            agree = (got[1] == want[1]).double().mean().item()
            hit = want[1] >= 0
            err = max((got[k][hit] - want[k][hit]).abs().max().item()
                      if hit.any() else 0.0 for k in (0, 2, 3))
            require(all(torch.equal(got[k], want[k]) for k in (0, 2, 3)),
                    f"intersect_bvh {label}: t/u/v differ, max {err}")
            times = kernel_times(lambda: isect.intersect_bvh(wb, o, d, mt))
            extra = {"hit_share": hit.float().mean().item()}
        name = "occluded_bvh" if any_hit else "intersect_bvh"
        require(agree == 1.0, f"{name} {label}: agreement {agree}")
        ops = (n * BVH_RAY_SETUP_OPS + counts["slab_tests"] * SLAB_OPS
               + counts["triangle_tests"]
               * (BVH_ANYHIT_TEST_OPS if any_hit else BVH_TEST_OPS))
        bnd = bound(nbytes(wb.nodes, wb.tri, o, d, mt, got), ops)
        return {"name": name, "route": "cuda", "n": n,
                "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_bvh.cu",
                "plain_timing": "the comparison call, once",
                "library_ms": None,
                "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:"
                            + ("694 (pallas_bvh_occluded)" if any_hit
                               else "679 (pallas_bvh_intersect)"),
                "max_abs_err": err, **times, "plain_ms": plain_ms,
                **bnd, "rays": label, "agreement": agree, **extra,
                "walk_steps": counts["steps"],
                # a warp holds 32 / WIDE rays, one tile each
                "walk": walk_stats(counts, 32 // isect.WIDE),
                "wide_nodes": wb.nodes.shape[0], "stack": wb.stack,
                "stack_peak": counts["stack_peak"],
                "tests_per_ray": {k: counts[k] / n for k in
                                  ("slab_tests", "triangle_tests")}}

    n = next(iter(sets.values()))[0].shape[0]
    sets = dict(sets)
    sets["dead"], sets["dead-shadow"] = dead_rays(n, scene.device)
    for label, (o, d, mt) in sets.items():
        any_hit = label in ("shadow", "shadow-random", "dead-shadow")
        row = one(label, any_hit, o, d, mt)
        in_order, perm = sorted_rays(o, d, mt)
        require(torch.equal(answer(any_hit, *in_order),
                            answer(any_hit, o, d, mt)[perm]),
                f"{row['name']} {label}: sorted and unsorted rays differ")
        emit({"phase": "kernels", **row, "order": "unsorted",
              "sorted": kernel_times(lambda: answer(any_hit, *in_order)),
              "packet_perm_ms": time_ms(lambda: scene._packet_perm(o, d)),
              "gather_ms": time_ms(lambda: (o[perm], d[perm], mt[perm])),
              "clu2_ms": clu2_ms[label]})

    # the regenerative path's own wavefront
    cam, shadow = regen_wavefront(scene, rng)
    sort_pays(scene, *shadow)
    return [one("regen camera, sorted", False,
                *sorted_rays(cam.o, cam.d, cam.maxt)[0]),
            one("regen shadow, sorted", True, *sorted_rays(*shadow)[0])]


def sort_pays(scene, o, d, mt):
    """Whether the packet route's coherence sort pays for B7b on the given
    shadow rays: one line with the kernel's time on the rays unsorted and
    sorted, and the time of what the route adds around it, the sort
    (`_packet_perm`), the three gathers and the unsort of the flags; each
    as device time (`graph_ms`) and as the events' time of back-to-back
    calls (`time_ms`, the host's where it is the slower)."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    wb = scene.wbvh
    perm, inv = scene._packet_perm(o, d)
    in_order = (o[perm], d[perm], mt[perm])
    occ = isect.occluded_bvh(wb, *in_order)

    def around():
        p, i = scene._packet_perm(o, d)
        return o[p], d[p], mt[p], occ[i]

    times = {label: {"device_ms": graph_ms(fn), "wrapper_ms": time_ms(fn)}
             for label, fn in (
                 ("unsorted", lambda: isect.occluded_bvh(wb, o, d, mt)),
                 ("sorted", lambda: isect.occluded_bvh(wb, *in_order)),
                 ("sort_gathers_unsort", around))}
    pays = {k: times["sorted"][k] + times["sort_gathers_unsort"][k]
            < times["unsorted"][k] for k in ("device_ms", "wrapper_ms")}
    emit({"phase": "kernels", "sort_pays": "occluded_bvh",
          "rays": "regen shadow", "n": o.shape[0], **times, "pays": pays})


def regen_wavefront(scene, rng):
    """The regenerative path's first wavefront on the packet scene: its
    131,072 camera rays in Morton order, and the shadow rays of their
    first bounce (`camera_hit_rays`)."""
    import torch

    from mitsuba3_plt_tpu_torch.integrators.common import camera_rays_at
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    W, H = scene.sensor.resolution
    n = W * H * MESH_SPP_PASS // 8
    cam, _ = camera_rays_at(scene, 0, torch.arange(n, device=scene.device),
                            W, H, MESH_SPP_PASS, "morton")
    hit = isect.intersect_bvh(closest_table(scene), cam.o, cam.d, cam.maxt)
    return cam, camera_hit_rays(scene, cam, hit, rng)[1]


def closest_table(scene):
    """The packet scene's closest-hit table: its WideBVH, or, in a checkout
    from before the WideBVH (`--turns`), its PacketBVH."""
    return getattr(scene, "wbvh", None) or scene.pbvh


def anyhit_table(scene, isect):
    """The packet scene's table for `isect.occluded_bvh`, by the name of
    its first parameter: the WideBVH, or, in a checkout from before B7b
    took it (`--turns`), the PacketBVH."""
    import inspect

    first = next(iter(inspect.signature(isect.occluded_bvh).parameters))
    return scene.wbvh if first == "wbvh" else scene.pbvh


def check_brute(label, scene, sets, q_sass, plain_lanes=None):
    """B8a, B8b and B9 against their plain versions on the tool's ray sets
    {set: (o, d, maxt)} of one scene: each kernel runs on all lanes, as it
    is timed (B8b's grid, span and ray replacement depend on n), and its
    first `plain_lanes` lanes (all where None) are held to the plain
    version on those lanes; B8a is held on every step-th lane instead,
    the same count spread over the whole set (the lanes of every tile a
    block loops over). B8 must equal its plain version to the bit,
    and B8a on every lane its audit instance (`classic_audit`: every pair
    through the exact test), whose count of hits the filter would have
    dropped must be 0; B8a's bound is the smaller of its filter on every
    pair with the exact test on the candidates the audit counts
    (`bound_filter_ms`) and the whole test on every pair
    (`bound_full_test_ms`): the least work that computes the function,
    whichever path the kernel takes. B9's hit masks and prims must agree
    on >= 99.99% of lanes and t within
    rtol 1e-4 where both hit, and on every lane B9 must equal its
    filter-off instance to the bit (`mxu_unfiltered`: the same FP32 test of
    every pair), whose count of hits the filter would have dropped must be
    0. B9's bound is the tensor-core one (`tc_bound`: u', v' in 3xTF32, the
    filter, the FP32 test of the candidates this run counts), the CUDA-core
    one beside it; q_sass: `q_sass_counts`, for B9's step. Returns {set:
    [B8a row, B8b row, B9 row]}."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

    geo, F = scene.geo, scene.geo.n_faces
    p = geo.tri_isect[:F].cpu().numpy()
    w = torch.as_tensor(isect.regroup_tri_mxu(isect.pack_tri_mxu(
        p[:, 0:3], p[:, 3:6], p[:, 6:9])), device=scene.device)
    nt = isect._closest_rows(geo.tri_isect, F)
    out = {}
    for set_label, (o, d, mt) in sets.items():
        n = o.shape[0]
        m = n if plain_lanes is None else min(n, plain_lanes)
        part = (o[:m], d[:m], mt[:m])
        common = {"route": "cuda", "n": n, "plain_lanes": m,
                  "rays": f"{label} {set_label}", "library_ms": None,
                  "plain_timing": "the comparison call, once, on plain_lanes"}

        # B8a: closest hit, equal to the bit on every step-th lane; on
        # every lane equal to its audit instance (every pair through the
        # exact test), which counts the candidates and the hits the filter
        # would drop (none allowed)
        step = max(1, n // m)
        spread = tuple(x[::step][:m].contiguous() for x in (o, d, mt))
        full = isect.intersect_classic(geo.tri_isect, o, d, mt, F)
        got = tuple(x[::step][:m] for x in full)
        head = tuple(x[:m] for x in full)  # beside B9's first m lanes
        want, plain_ms = time_once(lambda: isect.intersect_classic_plain(
            geo.tri_isect, *spread, F))
        hit = want[1] >= 0
        err = max((got[k][hit] - want[k][hit]).abs().max().item()
                  if hit.any() else 0.0 for k in (0, 2, 3))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"intersect_classic {label} {set_label}: differs, max {err}")
        ref, cnt_c = classic_audit(geo.tri_isect, o, d, mt, F)
        require(all(torch.equal(a, b) for a, b in zip(full, ref))
                and cnt_c["dropped"] == 0,
                f"intersect_classic {label} {set_label}: differs from its "
                f"audit instance ({cnt_c['dropped']} hits dropped)")
        del full, ref
        times = kernel_times(lambda: isect.intersect_classic(
            geo.tri_isect, o, d, mt, F))
        # the least work that computes the function: the filter on every
        # pair and the exact test on this run's candidates, or the whole
        # test on every pair where that is less; both ride along
        tri_bytes = nbytes(geo.tri_isect[:nt], o, d, mt) + 16 * n
        bnd_filter = bound(tri_bytes, n * (CLASSIC_RAY_SETUP_OPS
                                           + nt * CLASSIC_FILTER_OPS)
                           + cnt_c["candidates"] * CLASSIC_TEST_OPS)
        bnd_full = bound(tri_bytes,
                         n * (CLASSIC_RAY_SETUP_OPS + nt * CLASSIC_TEST_OPS))
        bnd = min(bnd_filter, bnd_full, key=lambda b: b["bound_ms"])
        closest = {"name": "intersect_classic", **common,
                   "source": "mitsuba3_plt_tpu_torch/ops/csrc/"
                             "intersect_classic.cu",
                   "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:95 "
                               "(pallas_intersect)",
                   "max_abs_err": err, **times, "plain_ms": plain_ms,
                   **bnd, "bound_full_test_ms": bnd_full["bound_ms"],
                   "bound_filter_ms": bnd_filter["bound_ms"],
                   "candidates_per_ray": cnt_c["candidates"] / n,
                   "test_sass": classic_test(q_sass),
                   "agreement": 1.0,
                   "hit_share": hit.float().mean().item()}

        # B8b: any hit, equal to the bit; the tests a thread makes (up to
        # its first hit) counted on the compared lanes, scaled to n
        counts = {}
        occ = isect.occluded_classic(geo.tri_isect, o, d, mt, F)[:m]
        occ_plain, plain_a = time_once(lambda: isect.occluded_classic_plain(
            geo.tri_isect, *part, F, counts=counts))
        agree = (occ == occ_plain).double().mean().item()
        require(torch.equal(occ, occ_plain),
                f"occluded_classic {label} {set_label}: agreement {agree}")
        times_a = kernel_times(lambda: isect.occluded_classic(
            geo.tri_isect, o, d, mt, F))
        tests = counts["triangle_tests"] * n / m
        bnd_a = bound(nbytes(geo.tri_isect[:F], o, d, mt) + n,
                      n * CLASSIC_RAY_SETUP_OPS
                      + tests * CLASSIC_ANYHIT_TEST_OPS)
        anyhit = {"name": "occluded_classic", **common,
                  "source": "mitsuba3_plt_tpu_torch/ops/csrc/"
                            "intersect_classic.cu",
                  "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:183 "
                              "(pallas_occluded)",
                  "max_abs_err": 1.0 - agree, **times_a, "plain_ms": plain_a,
                  **bnd_a, "agreement": agree,
                  "occluded_share": occ_plain.float().mean().item(),
                  "tests_per_ray": tests / n}

        # B9: the MXU form, within its tolerance
        full_m = isect.intersect_mxu(w, o, d, mt, F)
        got_m = tuple(x[:m] for x in full_m)
        want_m, plain_m = time_once(lambda: isect.intersect_mxu_plain(
            w, *part, F))
        mhit, whit = got_m[1] >= 0, want_m[1] >= 0
        hit_agree = (mhit == whit).double().mean().item()
        prim_agree = (got_m[1] == want_m[1]).double().mean().item()
        both = mhit & whit
        t_off = int(((got_m[0][both] - want_m[0][both]).abs()
                     > 1e-4 * want_m[0][both].abs()).sum())
        require(min(hit_agree, prim_agree) >= 1 - 1e-4 and t_off == 0,
                f"intersect_mxu {label} {set_label}: hit {hit_agree} prim "
                f"{prim_agree}, {t_off} lanes beyond t rtol 1e-4")
        same = (got_m[1] == want_m[1]) & mhit
        err_m = max((got_m[k][same] - want_m[k][same]).abs().max().item()
                    if same.any() else 0.0 for k in (0, 2, 3))
        # and to the bit against the filter-off instance, on every lane
        ref_m, cnt = mxu_unfiltered(w, o, d, mt, F)
        require(all(torch.equal(a, b) for a, b in zip(full_m, ref_m))
                and cnt["dropped"] == 0,
                f"intersect_mxu {label} {set_label}: differs from its "
                f"filter-off instance ({cnt['dropped']} hits dropped)")
        del full_m, ref_m
        times_m = kernel_times(lambda: isect.intersect_mxu(w, o, d, mt, F))
        # the work of the mesh's F triangles: the zero rows that pad each
        # group to T_pad are the TPU's tile, and the kernel skips them
        t_pad = w.shape[0] // 4
        w_f = w.view(4, t_pad, 16)[:, :F].reshape(4 * F, 16)
        bnd_cc = bound(nbytes(w_f, o, d, mt) + 16 * n,
                       n * (MXU_RAY_SETUP_OPS + F * MXU_TEST_OPS),
                       n * F * MXU_TEST_FMAS)
        # the tensor-core form: u', v' of every pair in 3xTF32, the filter
        # on the CUDA cores, the FP32 test of this run's candidates
        cand = cnt["candidates"]
        bnd_m = tc_bound(nbytes(w_f, o, d, mt) + 16 * n,
                         n * F * MXU_TC_FLOP,
                         n * (MXU_RAY_SETUP_OPS + F * MXU_TC_OTHER_OPS)
                         + cand * MXU_TEST_OPS,
                         n * F * MXU_TC_OTHER_FMAS + cand * MXU_TEST_FMAS)
        k = n if plain_lanes is None else min(n, isect.MXU_CHUNK)
        phi = isect.mxu_features(o[:k], d[:k])
        mm_ms = time_ms(lambda: torch.matmul(phi, w_f.T), reps=3, calls=3)
        del phi
        mxu = {"name": "intersect_mxu", **common,
               "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_mxu.cu",
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:346 "
                           "(pallas_intersect_mxu)",
               "max_abs_err": err_m, **times_m, "plain_ms": plain_m,
               **bnd_m, "bound_cuda_cores_ms": bnd_cc["bound_ms"],
               "candidates_per_ray": cand / n,
               "step_sass": mxu_step(q_sass), "t_pad": t_pad, "n_tris": F,
               "hit_agreement": hit_agree, "prim_agreement": prim_agree,
               "matmul_ms": mm_ms, "matmul_lanes": k,
               "vs_classic": bi.agreement(head, got_m)}
        out[set_label] = [closest, anyhit, mxu]
        for r in out[set_label]:
            emit({"phase": "kernels", **r})
        del got, want, head, got_m, want_m
    return out


def check_clu(label, tabs, sets, plain_lanes=None, tab="ctab64"):
    """B10a and B10b against their plain versions over the mask-sort
    tool's table `tab` on its ray sets {set: (o, d, maxt)}: the closest hit
    on the non-shadow sets, the any hit on the shadow sets. Each kernel
    runs on all lanes, as it is timed (which rays share a warp decides
    whether B10a runs a cluster a lane or a tile a ray), and its output on
    `plain_lanes` lanes spread evenly over the set (all where None) must
    equal the plain version's on those lanes to the bit. The bound counts
    each ray's own slab and triangle tests (the plain version's counts,
    scaled to all lanes). Returns {set: row}."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    ct = tabs[tab]
    tables = (ct.boxes, ct.rows, ct.anchor)
    out = {}
    for set_label, (o, d, mt) in sets.items():
        any_hit = set_label.startswith("shadow")
        n = o.shape[0]
        step = 1 if plain_lanes is None else max(1, n // plain_lanes)
        part = tuple(x[::step].contiguous() for x in (o, d, mt))
        m = part[0].shape[0]
        counts = {}
        kernel = isect.occluded_clu if any_hit else isect.intersect_clu
        plain = (isect.occluded_clu_plain if any_hit
                 else isect.intersect_clu_plain)
        got = kernel(ct, o, d, mt)
        got = got[::step] if any_hit else tuple(x[::step] for x in got)
        want, plain_ms = time_once(lambda: plain(ct, *part, counts=counts))
        name = "occluded_clu" if any_hit else "intersect_clu"
        if any_hit:
            agree = (got == want).double().mean().item()
            require(torch.equal(got, want),
                    f"{name} {label} {set_label}: agreement {agree}")
            err = 1.0 - agree
            share = {"occluded_share": want.double().mean().item()}
            out_bytes = n
        else:
            hit = want[1] >= 0
            err = max((got[k][hit] - want[k][hit]).abs().max().item()
                      if hit.any() else 0.0 for k in (0, 2, 3))
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"{name} {label} {set_label}: differs, max {err}")
            share = {"hit_share": hit.double().mean().item()}
            out_bytes = 16 * n
        times = kernel_times(lambda: kernel(ct, o, d, mt))
        scale = n / m
        ops = (n * CLU_RAY_SETUP_OPS
               + counts["cluster_tests"] * scale * SLAB_OPS
               + counts["triangle_tests"] * scale
               * (Q_ANYHIT_TEST_OPS if any_hit else Q_TEST_OPS))
        bnd = bound(nbytes(tables, o, d, mt) + out_bytes, ops)
        row = {"name": name, "route": "cuda", "n": n, "plain_lanes": m,
               "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_clu.cu",
               "replaces": "mitsuba3_plt_tpu/ops/intersect_pallas.py:"
                           + ("1093 (pallas_occluded_clu)" if any_hit
                              else "1080 (pallas_intersect_clu)"),
               "rays": f"{label} {tab} {set_label}", "library_ms": None,
               "plain_timing": "the comparison call, once, on plain_lanes",
               "max_abs_err": err, **times, "plain_ms": plain_ms,
               **bnd, "agreement": 1.0 - err
               if any_hit else 1.0, **share, "boxes": ct.boxes.shape[0],
               "tests_per_ray": {k: v / m for k, v in counts.items()}}
        emit({"phase": "kernels", **row})
        out[set_label] = row
        del got, want
    return out


def check_sweep(label, scene, rays, q_sass, plain_lanes=None):
    """B11a at every unroll, with one and with two accumulators, and B11b
    at every unroll against their plain versions on the sweep's rays, on
    `plain_lanes` lanes spread evenly over the set (all where None). Both
    run on all lanes, as they are timed (which tiles a block takes, and
    whether it re-stages the table for each, depends on n), and run B1's
    and B2's row test. The closest hit is held at the compared lanes to its
    plain version (`q_close`) and on every lane to B1 over each of its
    groups' rows (`q_groups`, `b1_groups`; with one accumulator that is B1
    itself, to the bit). The any hit is held on every lane to B2 over the
    same rows with an infinite maxt taken as -1, to the bit, and at the
    compared lanes to its plain version as `check_q` holds B2 (1 - 1e-4 of
    lanes). Each bound counts the FFMAs a test of its instance's SASS
    (q_sass: `q_sass_counts`). The closest hit runs with maxt inf. The any
    hit is timed and bounded on the tool's maxt (0.99 of B1's t where B1
    hits, else 2.0: no lane is occluded, every lane tests every row), held
    to B2 there too, and checked on a mixed one (0.99 or 1.01 of B1's t on
    alternate lanes, inf on every third lane) so that lanes stop at a hit
    and the inf rule is held on the kernel's own output. A plain version
    depends on the unroll only through the rows it runs, so it is run once
    per row count. Returns {(kind, unroll, dual): row}."""
    import torch

    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    geo, F = scene.geo, scene.geo.n_faces
    q = (geo.tri_q, geo.tri_anchor)
    o, d, mt = rays
    n = o.shape[0]
    step = 1 if plain_lanes is None else max(1, n // plain_lanes)
    po, pd, pmt = (x[::step].contiguous() for x in (o, d, mt))
    m = po.shape[0]
    t0 = isect.intersect_q(*q, o, d, mt, F)[0]
    msh = torch.where(torch.isfinite(t0), t0 * 0.99, 2.0)
    lane = torch.arange(n, device=o.device)
    mix = torch.where(torch.isfinite(t0),
                      t0 * torch.where(lane % 2 == 0, 0.99, 1.01), 2.0)
    mix = torch.where(lane % 3 == 0, float("inf"), mix)
    pmix = mix[::step].contiguous()
    del t0, lane
    common = {"route": "cuda", "n": n, "plain_lanes": m,
              "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_sweep.cu",
              "rays": f"{label} sweep", "library_ms": None,
              "plain_timing": "the comparison call, once, on plain_lanes"}
    plain, out = {}, {}
    for unroll in isect.Q_VARIANT_UNROLLS:
        rows = isect.q_variant_rows(geo.tri_q.shape[0], F, unroll)
        for dual in (False, True):
            def call():
                return isect.intersect_q_variant(*q, o, d, mt, F, unroll,
                                                 dual)
            got = call()
            if (rows, dual) not in plain:
                plain[rows, dual] = time_once(
                    lambda: isect.intersect_q_variant_plain(
                        *q, po, pd, pmt, F, unroll, dual))
                plain[rows, dual, "B1"] = b1_groups(
                    q, (o, d, mt), rows, 2 if dual else 1)
            want, plain_ms = plain[rows, dual]
            name = (f"intersect_q_variant {label} unroll {unroll} dual "
                    f"{dual}")
            held = q_close(name, [x[::step] for x in got], want,
                           sweep=True)
            q_groups(name, got, plain[rows, dual, "B1"])
            times = kernel_times(call)
            fmas = sweep_fmas(q_sass, f"sweep_q_kernel<{unroll},"
                                      f"{2 if dual else 1},0>")
            bnd = bound(
                nbytes(geo.tri_q[:rows], geo.tri_anchor, o, d, mt) + 8 * n,
                n * (SWEEP_RAY_SETUP_OPS + rows * SWEEP_TEST_OPS
                     + (DUAL_MERGE_OPS if dual else 0)),
                n * rows * fmas)
            out["closest", unroll, dual] = {
                "name": "intersect_q_variant", **common,
                "replaces": "tools/experiments/isect_unroll_sweep.py:91 "
                            "(q_variant)",
                "unroll": unroll, "dual": dual, "rows": rows, **held,
                **times, "plain_ms": plain_ms, **bnd,
                "test_fmas": {"sass": fmas, "hand": Q_TEST_FMAS},
                "hit_share": (want[1] >= 0).double().mean().item()}
            del got
        name = f"occluded_q_variant {label} unroll {unroll}"
        occ = isect.occluded_q_variant(*q, o, d, mix, F, unroll)
        if rows not in plain:
            plain[rows] = time_once(lambda: isect.occluded_q_variant_plain(
                *q, po, pd, pmix, F, unroll))
            # B2 over the same rows, an infinite maxt taken as -1
            plain["B2", rows] = [isect.occluded_q(
                *q, o, d, torch.where(torch.isfinite(x), x, -1.0), rows)
                for x in (mix, msh)]
        want, plain_ms = plain[rows]
        agree = (occ[::step] == want).double().mean().item()
        # tolerance: B2's (`check_q`): only where t lies within rounding of
        # 0, maxt or a triangle boundary, at most 1 lane in 10,000
        require(agree >= 1 - 1e-4, f"{name}: plain agreement {agree}")
        require(torch.equal(occ, plain["B2", rows][0])
                and torch.equal(isect.occluded_q_variant(
                    *q, o, d, msh, F, unroll), plain["B2", rows][1]),
                f"{name}: differs from B2's with maxt inf as -1")
        require(bool(occ.any()) and not occ[::3].any(),
                f"{name}: no lane occluded, or an infinite maxt occluded")
        del occ
        times = kernel_times(lambda: isect.occluded_q_variant(
            *q, o, d, msh, F, unroll))
        if ("tests", rows) not in plain:
            plain["tests", rows] = km.anyhit_tests(
                *q, po, pd, msh[::step].contiguous(), rows) * n / m
        tests = plain["tests", rows]
        fmas = sweep_fmas(q_sass, f"sweep_a_kernel<{unroll}>")
        bnd = bound(
            nbytes(geo.tri_q[:rows], geo.tri_anchor, o, d, msh) + n,
            n * SWEEP_RAY_SETUP_OPS + tests * Q_ANYHIT_TEST_OPS,
            tests * fmas)
        out["any hit", unroll, False] = {
            "name": "occluded_q_variant", **common,
            "replaces": "tools/experiments/isect_unroll_sweep.py:203 "
                        "(a_variant)",
            "unroll": unroll, "dual": False, "rows": rows,
            "max_abs_err": 1.0 - agree, **times, "plain_ms": plain_ms,
            **bnd, "agreement": agree,
            "test_fmas": {"sass": fmas, "hand": Q_TEST_FMAS},
            "checked_occluded_share": want.double().mean().item(),
            "tests_per_ray": tests / n}
    for r in out.values():
        emit({"phase": "kernels", **r})
    return out


def check_macc(label, scene, rays, q_sass, plain_lanes=None):
    """B11c at every nacc on the multi-accumulator tool's rays (maxt inf),
    run on all lanes as it is timed: held to its plain version on
    `plain_lanes` lanes spread evenly over the set (all where None;
    `q_close`) and on every lane to B1 over each group's rows to the bit
    (t, prim, u, v: `q_groups`, `b1_groups`; it runs B1's row test); its
    bound counts the FFMAs a test of its instance's SASS (q_sass).
    Returns {nacc: row}."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    geo, F = scene.geo, scene.geo.n_faces
    q = (geo.tri_q, geo.tri_anchor)
    o, d, mt = rays
    n = o.shape[0]
    step = 1 if plain_lanes is None else max(1, n // plain_lanes)
    part = tuple(x[::step].contiguous() for x in (o, d, mt))
    m = part[0].shape[0]
    rows = isect.q_variant_rows(geo.tri_q.shape[0], F, isect.Q_MACC_UNROLL)
    out = {}
    for nacc in isect.Q_MACC_NACCS:
        def call():
            return isect.intersect_q_macc(*q, o, d, mt, F, nacc)
        got = call()
        want, plain_ms = time_once(lambda: isect.intersect_q_macc_plain(
            *q, *part, F, nacc))
        name = f"intersect_q_macc {label} nacc {nacc}"
        held = q_close(name, [x[::step] for x in got], want, sweep=True)
        q_groups(name, got, b1_groups(q, (o, d, mt), rows, nacc))
        times = kernel_times(call)
        fmas = sweep_fmas(q_sass, f"sweep_q_kernel<{isect.Q_MACC_UNROLL},"
                                  f"{nacc},1>")
        bnd = bound(
            nbytes(geo.tri_q[:rows], geo.tri_anchor, o, d, mt) + 16 * n,
            n * (MACC_RAY_SETUP_OPS + rows * MACC_TEST_OPS
                 + (nacc - 1) * MACC_MERGE_OPS),
            n * rows * fmas)
        out[nacc] = {
            "name": "intersect_q_macc", "route": "cuda", "n": n,
            "plain_lanes": m,
            "source": "mitsuba3_plt_tpu_torch/ops/csrc/intersect_sweep.cu",
            "replaces": "tools/experiments/isect_q_multiacc.py:100 "
                        "(intersect_macc)",
            "rays": f"{label} multiacc", "library_ms": None,
            "plain_timing": "the comparison call, once, on plain_lanes",
            "nacc": nacc, "rows": rows, **held, **times,
            "plain_ms": plain_ms, **bnd,
            "test_fmas": {"sass": fmas, "hand": Q_TEST_FMAS},
            "hit_share": (want[1] >= 0).double().mean().item()}
        emit({"phase": "kernels", **out[nacc]})
        del got, want
    return out


def check_fma(rng, dev):
    """B11d against its plain version at the probe's 8,192 x 128, on random
    x in [0.5, 2) and a in [0.98, 1.02) (a per row of the tile and lane)
    with some chains driven into the 3e38 clamp: within 1 ulp an element
    (the plain version forms x a + c in float64 and rounds it once more).
    Timed on the same inputs (an FFMA's time does not depend on its
    values)."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.ops import mfu
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    x = rng.uniform(0.5, 2.0, (km.FMA_ROWS, mfu.LANES)).astype(np.float32)
    a = rng.uniform(0.98, 1.02, (mfu.SUB, mfu.LANES)).astype(np.float32)
    x[3, :8] = 1e38
    a[5, :4] = 1.5
    x, a = (torch.as_tensor(v, device=dev) for v in (x, a))
    got = mfu.fma_roof(x, a)
    want, plain_ms = time_once(lambda: mfu.fma_roof_plain(x, a))
    ulps = (got.view(torch.int32).long() - want.view(torch.int32)).abs()
    max_ulp = int(ulps.max())
    fin = torch.isfinite(want)
    require(max_ulp <= 1 and torch.equal(fin, torch.isfinite(got))
            and bool((~fin).any()), f"fma_roof: {max_ulp} ulp")
    times = kernel_times(lambda: mfu.fma_roof(x, a))
    n = x.numel()
    # per element: FMA_ITERS + 3 FMAs (2 each), FMA_ITERS mins, 3 adds
    fmas = mfu.FMA_ITERS + 3
    bnd = bound(nbytes(x, a, got), n * (2 * fmas + mfu.FMA_ITERS + 3),
                n * fmas)
    row = {"name": "fma_roof", "route": "cuda", "n": n,
           "source": "mitsuba3_plt_tpu_torch/ops/csrc/fma_roof.cu",
           "replaces": "tools/experiments/kernel_mfu.py:79 (vpu_fma_roof)",
           "library_ms": None, "plain_timing": "the comparison call, once",
           "max_abs_err": (got[fin] - want[fin]).abs().max().item(),
           "max_ulp": max_ulp, "ulp_share": (ulps > 0).double().mean().item(),
           **times, "plain_ms": plain_ms, **bnd}
    emit({"phase": "kernels", **row})
    return row


def mask_sort_tool(scenes):
    """The cluster-mask sort tool on each (label, scene, tables, ray sets):
    the launches of one run on the Cornell box's depth1 and shadow1 sets,
    then per scene each sorted and Morton pipeline held to the unsorted
    kernel over the same table on every lane of every set, and one timed
    run, a row per route and set. Each cluster route agrees with q on >=
    99.99% of lanes (the JAX tool's check) on the JAX tool's sets (camera,
    bounce and shadow rays); on the incoherent set, whose origins lie
    inside the Cornell box's boxes, the bottoms and the floor are coplanar
    and tie exactly, and the first in table order wins, so there >= 99.99%
    of lanes must have the same prim or their hit at the same distance.
    Returns the launches."""
    import torch

    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms

    ph = Phase("mask-sort")
    _, cscene, ctabs, csets = scenes[0]
    pick = {k: csets[k] for k in ("depth1", "shadow1")}
    ops.reset_launch_counts()
    ms.run(cscene, pick, tabs=ctabs)
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_q": 1, "occluded_q": 1,
            "intersect_clu": 4, "occluded_clu": 4}
    require(launches == want, f"mask-sort launches {launches}")
    n_rows = 0
    for label, scene, tabs, sets in scenes:
        fns = ms.route_fns(scene, tabs)
        unsorted = {"m64": fns["clu"],
                    "m128": (ms._clu_fn(tabs["ctab128"], False),
                             ms._clu_fn(tabs["ctab128"], True)),
                    "clu-morton": fns["clu"]}
        for set_label, (o, d, mt) in sets.items():
            any_hit = set_label.startswith("shadow")
            for name, base in unsorted.items():
                got = fns[name][any_hit](o, d, mt)
                ref = base[any_hit](o, d, mt)
                same = (torch.equal(got, ref) if any_hit else
                        all(torch.equal(a, b) for a, b in zip(got, ref)))
                require(same, f"mask-sort {label} {set_label} {name}: "
                              "differs from the unsorted kernel")
        rows = ms.run(scene, sets, tabs=tabs,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3,
                                               warmup=1))
        for r in rows:
            emit({"phase": "mask-sort", "scene": label, **r})
            agree = (r["occ_agree"] if r["kind"] == "any hit"
                     else r["same_hit"] if r["set"] == "incoherent"
                     else r["prim_agree"])
            require(agree >= 0.9999, f"mask-sort {label} {r['set']} "
                                     f"{r['route']}: agreement {agree}")
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_run=launches,
            boxes={label: {k: t.boxes.shape[0] for k, t in tabs.items()}
                   for label, _, tabs, _ in scenes})
    return launches


def unroll_sweep_tool(scenes):
    """The unroll-sweep tool on each (label, scene, rays): the launches of
    one run on the Cornell box's rays, then one timed run per scene, a row
    per variant with its agreement with B1 or B2. Returns the launches."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    ph = Phase("unroll-sweep")
    _, cscene, crays = scenes[0]
    ops.reset_launch_counts()
    us.run(cscene, crays)
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_q": 1, "occluded_q": 1,
            "intersect_q_variant": len(us.CLOSEST),
            "occluded_q_variant": len(us.ANYHIT)}
    require(launches == want, f"unroll-sweep launches {launches}")
    n_rows = 0
    for label, scene, rays in scenes:
        rows = us.run(scene, rays,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3,
                                               warmup=1))
        for r in rows:
            emit({"phase": "unroll-sweep", "scene": label, **r})
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_run=launches)
    return launches


def q_multiacc_tool(scenes):
    """The multi-accumulator tool on each (label, scene, rays): the
    launches of one run on the Cornell box's rays, then one timed run per
    scene, a row per nacc with its prim agreement with B1, >= 0.99 (an
    exact tie across groups goes to the lower group, B1 takes the first
    row). Returns the launches."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_q_multiacc as qm

    ph = Phase("q-multiacc")
    _, cscene, crays = scenes[0]
    ops.reset_launch_counts()
    qm.run(cscene, crays)
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_q": 1,
            "intersect_q_macc": len(qm.NACCS)}
    require(launches == want, f"q-multiacc launches {launches}")
    n_rows = 0
    for label, scene, rays in scenes:
        rows = qm.run(scene, rays,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3,
                                               warmup=1))
        for r in rows:
            emit({"phase": "q-multiacc", "scene": label, **r})
            require(r["prim_agree"] >= 0.99,
                    f"q-multiacc {label} nacc {r['nacc']}: {r['prim_agree']}")
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_run=launches)
    return launches


def kernel_mfu_tool(q_scenes, dev, sass_text, specials):
    """The MFU tool: B11d's SASS (one FFMA and one FMNMX a chain a step,
    required), then one timed run of every probe, its launches counted
    outside the timers (each probe's own first call): the FMA probe chained
    at the JAX tool's 8,192 rows and at FMA_WIDE_ROWS (a grid of ~31
    waves, against ~4 whose last is partial), the HBM probe's roll chained
    and a copy, B1/B2 on each (label, scene, rays) of q_scenes, B5 on
    mesh_scene(1024, 1024, 6), B4 on the JAX tool's inputs (its work by
    `lobe_sum_count`); a row each against the measured and the published
    roofs. sass_text: `cuobjdump -sass` of the kernel library. Returns (the
    launches, the measured roofs)."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.ops import mfu
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    ph = Phase("kernel-mfu")
    sass = mfu.count_sass(sass_text, "fma_roof_kernel")
    require(sass["ffma"] == mfu.FMA_ITERS + 3
            and sass["fmnmx"] == mfu.FMA_ITERS, f"fma_roof SASS {sass}")
    mscene, bvh = km.clu2_setup(dev)
    timed = {k: 0 for k in NO_LAUNCHES}

    def untallied(measure):
        def run(*args):
            before = ops.launch_counts()
            ms = measure(*args)
            for k, v in ops.launch_counts().items():
                timed[k] += v - before[k]
            return ms
        return run

    timer = untallied(lambda fn: time_ms(fn, reps=3, calls=3, warmup=1))
    chained = untallied(chained_ms)
    ops.reset_launch_counts()
    rows = [km.fma_roof_probe(dev, chained, sass),
            km.fma_roof_probe(dev, chained, sass, FMA_WIDE_ROWS),
            km.hbm_probe(dev, chained, timer)]
    for label, scene, rays in q_scenes:
        rows += [dict(r, scene=label) for r in km.q_probe(scene, rays, timer)]
    rows.append(km.clu2_probe(mscene, bvh, timer))
    rows.append(km.lobe_sum_probe(dev, timer))
    launches = {k: v - timed[k] for k, v in ops.launch_counts().items()}
    want = {**NO_LAUNCHES, "fma_roof": 2, "intersect_q": len(q_scenes),
            "occluded_q": len(q_scenes), "intersect_clu2": 1,
            "grating_lobe_sum": 1}
    require(launches == want, f"kernel-mfu launches {launches}")
    roofs = km.roofs(rows[:2], rows[2])
    # the lobe sum against the roofs by its counted work (an FMA two
    # operations, two FLOP, one slot)
    lobe = rows[-1]
    count = lobe_sum_count(km.lobe_inputs(lobe["n"], dev), km.LOBE_HALF,
                           True, specials)
    lobe["flop"] = count["ops"]
    lobe["slots"] = count["ops"] - count["fma"]
    lobe["flop_per_s"] = lobe["flop"] / lobe["ms"] * 1e3
    lobe["slots_per_s"] = lobe["slots"] / lobe["ms"] * 1e3
    for r in rows:
        emit({"phase": "kernel-mfu", **km.shares(r, roofs)})
    require(rows[0]["finite"] and rows[1]["finite"] and rows[2]["correct"]
            and rows[-1]["finite"] and rows[-2]["hit_share"] > 0,
            "kernel-mfu: a probe's output is wrong")
    ph.emit(roofs=roofs, sass=sass, launches_one_run=launches,
            fma_roof_tflops=roofs["flops"] / 1e12,
            slot_roof_tslots=roofs["slots"] / 1e12,
            hbm_tb_per_s=roofs["bytes"] / 1e12)
    return launches, roofs


def isect_tool(scenes):
    """The intersection tool on each (label, scene, ray sets): the launches
    of one run on one set (the Cornell box's first bounce), then one timed
    run per scene, a row per route and set. Every closest-hit route must
    agree with brute-classic on hit or miss on >= 99.9% of lanes, every
    any-hit route on >= 99% (shadow rays start 1e-4 off a surface, where
    the q and classic forms round t = 0 apart). Returns the launches."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

    ph = Phase("isect-tool")
    _, cscene, csets = scenes[0]
    ops.reset_launch_counts()
    bi.run(cscene, {"depth1": csets["depth1"]})
    launches = ops.launch_counts()
    want = {**NO_LAUNCHES, "intersect_classic": 1, "occluded_classic": 1,
            "intersect_mxu": 1, "intersect_q": 1, "occluded_q": 1,
            "intersect_bvh": 2}
    require(launches == want, f"isect-tool launches {launches}")
    n_rows = 0
    for label, scene, sets in scenes:
        rows = bi.run(scene, sets,
                      timer=lambda fn: time_ms(fn, reps=3, calls=3, warmup=1))
        for r in rows:
            emit({"phase": "isect-tool", "scene": label, **r})
            worst = r["occ_agree"] if r["route"] in bi.ANYHIT else \
                r["hit_agree"]
            require(worst >= (0.99 if r["route"] in bi.ANYHIT else 0.999),
                    f"isect-tool {label} {r['set']} {r['route']}: {worst}")
        require({(r["set"], r["route"]) for r in rows} == {
            (s_, r_) for s_ in sets for r_ in bi.ROUTES
            if r_ in bi.ANYHIT or not s_.startswith("shadow")},
            f"isect-tool {label}: a route or a set is missing")
        n_rows += len(rows)
    ph.emit(rows=n_rows, launches_one_set=launches)
    return launches


# ---------------------------------------------------------------------------
# golden images, main paths and their device-time split
# ---------------------------------------------------------------------------

def golden_ztest(name, scene, integ, golden, spp_per_seed,
                 golden_dir=("tests", "golden"), **render_kw):
    """Render 4 seeds and z-test their mean against a golden image (under
    tests/golden/, or the port's own references under tests/golden_torch/,
    which the JAX package rendered on the CPU). Returns the mean image."""
    import numpy as np
    import torch

    from mitsuba3_plt_tpu_torch.integrators.common import render

    ph = Phase(name)
    ref = np.load(os.path.join(HERE, *golden_dir, golden))
    imgs = np.stack([render(scene, integ, seed=s, spp=spp_per_seed,
                            **render_kw).cpu().numpy()
                     for s in range(4)])
    mean, var = imgs.mean(0), imgs.var(0, ddof=1)
    sigma = np.sqrt((var + ref["var"]) / 4 + 1e-8)
    z = np.abs(mean - ref["mean"]) / sigma
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    thresh = -torch.special.ndtri(
        torch.tensor(alpha / 2, dtype=torch.float64)).item()
    n_fail = int((z > thresh).sum())
    ph.emit(pixels=int(z.size), fail=n_fail, max_z=float(z.max()),
            thresh=thresh, mean=float(mean.mean()),
            ref_mean=float(ref["mean"].mean()))
    require(n_fail == 0, f"{name} z-test: {n_fail} pixels fail")
    return mean


def degree_of_polarization(name, img):
    """The degree of linear polarization of a 15-channel Stokes image: it
    must reach 0.1 somewhere (the glass box polarizes) and stay at most
    1 + 1e-3 wherever S0 > 1e-3 (JAX tests/test_stokes.py's bounds)."""
    import numpy as np

    img = np.asarray(img)
    s0 = img[..., 3:6]
    dop = np.sqrt(img[..., 6:9] ** 2 + img[..., 9:12] ** 2) / np.maximum(
        s0, 1e-6)
    lit = s0 > 1e-3
    Phase(name).emit(max_dop=float(dop.max()),
                     max_dop_lit=float(dop[lit].max()),
                     lit_share=float(lit.mean()),
                     max_abs_s3=float(np.abs(img[..., 12:15]).max()))
    require(dop.max() > 0.1, f"{name}: degree of polarization below 0.1")
    require(dop[lit].max() <= 1.0 + 1e-3,
            f"{name}: degree of polarization above 1")


def collapse(scene, depth, rr):
    """On the diffuse box the Stokes image is the scalar path tracer's: S0
    and the RGB channels equal PathIntegrator's image to the bit, S1-S3
    exactly 0; the full Mueller transport (force_full) agrees at rtol 2e-5
    / atol 1e-6 (JAX tests/test_stokes.py's collapse test)."""
    import torch

    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.stokes import (
        PolarizedPathIntegrator, StokesIntegrator, depolarizer_collapse_ok)

    ph = Phase("collapse")
    require(depolarizer_collapse_ok(scene), "the diffuse box must collapse")
    kw = dict(seed=0, spp=COLLAPSE_SPP)
    ops.reset_launch_counts()
    stokes = render(scene, StokesIntegrator(PolarizedPathIntegrator(
        depth, rr)), **kw)
    launches = ops.launch_counts()
    scalar = render(scene, PathIntegrator(depth, rr), seed=0,
                    spp=COLLAPSE_SPP)
    full = render(scene, StokesIntegrator(PolarizedPathIntegrator(
        depth, rr, force_full=True)), **kw)
    torch.cuda.synchronize()
    equal = (torch.equal(stokes[..., 3:6], scalar)
             and torch.equal(stokes[..., :3], scalar))
    zero = bool((stokes[..., 6:] == 0).all())
    close = torch.isclose(full, stokes, rtol=2e-5, atol=1e-6)
    ph.emit(width=scene.sensor.resolution[0], spp=COLLAPSE_SPP,
            s0_equal=equal, s123_zero=zero,
            full_close_share=close.float().mean().item(),
            full_max_abs_diff=(full - stokes).abs().max().item(),
            full_max_abs_s123=full[..., 6:].abs().max().item(),
            image_mean=scalar.mean().item(),
            launches={k: v for k, v in launches.items() if v})
    require(equal and zero, "collapse: S0 differs from the scalar image")
    require(bool(close.all()), "collapse: force_full differs")
    require(launches["intersect_q"] == depth and launches["occluded_q"]
            == depth, "collapse: the brute kernels did not run")


def furnace(scene, integ, spp, albedo):
    """The white furnace (JAX tests/test_furnace.py's check at 64 x 64): the
    convex diffuse sphere's centre pixels within 3% of the albedo, the
    corner, which sees the environment of radiance 1, within 0.02 of 1."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render

    ph = Phase("furnace")
    W, H = scene.sensor.resolution
    ops.reset_launch_counts()
    img = render(scene, integ, seed=0, spp=spp).cpu()
    launches = ops.launch_counts()
    # the centre third of the frame lies inside the sphere's disc
    centre = img[H // 3:H - H // 3, W // 3:W - W // 3].mean().item()
    corner = img[:H // 8, :W // 8].mean().item()
    ph.emit(width=W, height=H, spp=spp, faces=scene.geo.n_faces,
            albedo=albedo, centre=centre,
            centre_rel_err=abs(centre - albedo) / albedo, corner=corner,
            launches={k: v for k, v in launches.items() if v})
    require(abs(centre - albedo) / albedo < 0.03,
            f"furnace: centre {centre} against albedo {albedo}")
    require(abs(corner - 1.0) < 0.02, f"furnace: corner {corner}")
    require(launches["intersect_q"] > 0 and launches["occluded_q"] > 0,
            "furnace: the brute kernels did not run")


def renderer(scene, integ, meta=None):
    """render(**kw) of the scene: `integrators.common.render` with `integ`,
    or, given a loaded scene's meta, the package's render((scene, meta)),
    which takes the meta's integrator, filter and sampler."""
    import mitsuba3_plt_tpu_torch as mi
    from mitsuba3_plt_tpu_torch.integrators.common import render

    if meta is not None:
        return lambda **kw: mi.render((scene, meta), **kw)
    return lambda **kw: render(scene, integ, **kw)


def main_path(name, scene, integ, spp_pass, per_pass, passes=TIMED_PASSES,
              meta=None, **render_kw):
    """One warm-up pass, then `passes` timed passes; per_pass gives the
    launches each kernel must make in a pass (ITER: one per iteration of
    the regenerative loop, which must run at least max_depth times a pass).
    With a loaded scene's meta the passes go through the package's
    render((scene, meta)) (`renderer`), whose integrator `integ` must be.
    Returns (the printed fields, the image)."""
    import torch

    from mitsuba3_plt_tpu_torch import ops

    ph = Phase(name)
    render = renderer(scene, integ, meta)
    W, H = scene.sensor.resolution
    warm = {}
    render(seed=0, spp=spp_pass, spp_per_pass=spp_pass, stats=warm,
           **render_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    spp = spp_pass * passes
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    img = render(seed=1, spp=spp, spp_per_pass=spp_pass, stats=stats,
                 **render_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    res = {"width": W, "height": H, "max_depth": integ.max_depth,
           "rr_depth": integ.rr_depth, "spp": spp, "spp_per_pass": spp_pass,
           "lanes_per_pass": stats["lanes_per_pass"],
           "iterations_per_pass": stats["regen_iterations"],
           **{k: getattr(v, "name", v) for k, v in render_kw.items()},
           "warmup_pass_s": warm["pass_s"][0], "pass_s": stats["pass_s"],
           "wall_s": wall, "camera_samples_per_s": W * H * spp / wall,
           "ms_per_spp": wall * 1e3 / spp, "peak_mem_bytes": peak,
           "launches": launches, "image_mean": mean, "finite": finite}
    ph.emit(**res)
    require(finite and mean > 0, f"{name} image not finite and non-zero")
    iters = stats["regen_iterations"]
    if ITER in per_pass.values():
        require(len(iters) == passes
                and min(iters) >= integ.max_depth,
                f"{name}: regenerative iterations per pass {iters}")
    for kname, count in launches.items():
        want = (sum(iters) if per_pass[kname] == ITER
                else per_pass[kname] * passes)
        require(count == want,
                f"{name}: {kname} launched {count} times, expected {want}")
    return res, img


def same_image(name, img, scene, integ, spp_pass):
    """A regenerative Morton-order image against the fixed-depth renders of
    the same seed: equal to the one in Morton order (the same samples in
    another schedule; rtol 2e-5 / atol 2e-6, the film sums in another
    order), and equal to noise to the scanline one (other samples per
    pixel): means within 1%."""
    import torch

    from mitsuba3_plt_tpu_torch.integrators.common import render

    ph = Phase(name + "-image")
    kw = dict(seed=1, spp=spp_pass * TIMED_PASSES, spp_per_pass=spp_pass)
    fixed = render(scene, integ, pixel_order="morton", **kw)
    scan = render(scene, integ, **kw)
    close = torch.isclose(img, fixed, rtol=2e-5, atol=2e-6)
    mean_gap = abs(img.mean().item() / scan.mean().item() - 1.0)
    ph.emit(max_abs_diff=(img - fixed).abs().max().item(),
            close_share=close.float().mean().item(),
            scanline_mean_gap=mean_gap,
            scanline_mean_abs_diff=(img - scan).abs().mean().item(),
            image_mean=img.mean().item())
    require(bool(close.all()), f"{name}: differs from the fixed-depth render")
    require(mean_gap < 0.01, f"{name}: mean differs from the scanline render")


def split(name, scene, integ, pass_s, spp_pass, out_file, meta=None,
          **render_kw):
    """Device time of one main-path pass by kernel name (torch.profiler);
    `meta` as in `main_path`. Returns the printed fields."""
    render = renderer(scene, integ, meta)
    return profile_run(name, lambda: render(seed=2, spp=spp_pass,
                                            spp_per_pass=spp_pass,
                                            **render_kw), pass_s, out_file)


def profile_run(name, run, pass_s, out_file):
    """Device time of one run() by kernel name (torch.profiler), against
    the wall time pass_s of an unprofiled run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ph = Phase(name)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # kernel-level events only: an aten op's row repeats the device
        # time of the kernels it launched
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": ev.key, "count": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    # clu2_kernel first: "q_kernel" must not take its rows
    ours = {"clu2_kernel": 0.0, "wide_anyhit_kernel": 0.0,
            "wide_kernel": 0.0, "q_kernel": 0.0, "lobe_sum_kernel": 0.0,
            "lobe_sum_bwd_kernel": 0.0, "sample_kernel": 0.0}
    n_kernels = 0
    per_launch = {}
    for r in rows:
        for key in ours:
            if key in r["name"]:
                ours[key] += r["device_ms"]
                # B1/B2, B5/B6, B7a/B7b a launch (one row per instance)
                if key not in ("lobe_sum_kernel", "lobe_sum_bwd_kernel",
                               "sample_kernel"):
                    per_launch[r["name"]] = {
                        "launches": r["count"], "device_ms": r["device_ms"],
                        "ms_per_launch": r["device_ms"] / r["count"]}
                break
        n_kernels += r["count"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_file), "w") as f:
        json.dump({"pass_wall_ms": pass_s * 1e3, "device_ms": total,
                   "ops": rows}, f, indent=1)
    res = dict(pass_wall_ms=pass_s * 1e3, device_busy_ms=total,
               device_idle_share=(1.0 - total / (pass_s * 1e3)
                                  if total > 0 else None),
               our_kernels_ms=ours, per_launch=per_launch,
               our_kernels_share_of_busy=(sum(ours.values()) / total
                                          if total > 0 else None),
               device_ops_launched=n_kernels, top_ops=rows[:12])
    ph.emit(**res)
    return res


# ---------------------------------------------------------------------------
# scene loading: the dict and XML loaders, the package's render and the CLI
# ---------------------------------------------------------------------------

def mesh82k_dict(width, height, subdiv):
    """The JAX package's mesh82k bench dict (bench.py::bench_mesh_heavy):
    the icosphere of `subdiv` as an in-memory mesh, diffuse 0.7, a point
    light of intensity 40 at (2, 2, 3), a 45-degree camera at (0, 0, 4)."""
    from mitsuba3_plt_tpu_torch.core import transform as tf
    from mitsuba3_plt_tpu_torch.scene.shape import make_sphere

    return {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": width,
                            "height": height}},
        "light": {"type": "point", "position": [2, 2, 3],
                  "intensity": [40, 40, 40]},
        "ball": {"type": "mesh", "mesh": make_sphere(subdiv),
                 "bsdf": {"type": "diffuse", "reflectance": 0.7}},
    }


def captured_load(load, *args, **kw):
    """(scene, meta, the arrays and static fields the loader handed the
    bridge, the load's seconds) of load(*args, **kw)."""
    import torch

    from mitsuba3_plt_tpu_torch.scene import loader

    got = {}
    bridge = loader.scene_from_arrays

    def capture(arrays, static, device="cuda"):
        got.update(arrays=arrays, static=static)
        return bridge(arrays, static, device=device)

    loader.scene_from_arrays = capture
    try:
        t0 = time.perf_counter()
        scene, meta = load(*args, **kw)
        if scene.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        loader.scene_from_arrays = bridge
    return scene, meta, got["arrays"], got["static"], seconds


def differing_keys(arrays, static, want):
    """The keys of (arrays, static) that differ from the preset's `want`
    pair, in value, dtype or shape, or that one side lacks."""
    import numpy as np

    (warrays, wstatic), out = want, []
    for key in sorted(set(arrays) | set(warrays)):
        a, b = arrays.get(key), warrays.get(key)
        if a is None or b is None or np.asarray(a).dtype != np.asarray(
                b).dtype or not np.array_equal(a, b):
            out.append(key)
    return out + [k for k in sorted(wstatic) if static[k] != wstatic[k]]


def write_scene(name, text):
    os.makedirs(LOADER_DIR, exist_ok=True)
    path = os.path.join(LOADER_DIR, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def beside(name, res, split_res, cell):
    """The loaded scene's main path `res` and its split beside its
    preset's, run earlier in the same call: `cell` is (the preset's
    main-path fields, its split's fields). main_path has already required
    each path's launches."""
    preset_res, preset_split = cell
    Phase(name + "-vs-preset").emit(
        ms_per_spp=res["ms_per_spp"],
        ms_per_spp_preset=preset_res["ms_per_spp"],
        launches_equal=res["launches"] == preset_res["launches"],
        device_busy_ms=split_res["device_busy_ms"],
        device_busy_ms_preset=preset_split["device_busy_ms"],
        device_ops_launched=split_res["device_ops_launched"],
        device_ops_launched_preset=preset_split["device_ops_launched"])


def loaders(cells, device="cuda"):
    """The loaders' phases on `device`: the mesh82k dict through load_dict
    (its arrays against the preset's, its path beside main-mesh82k), the
    Cornell box and the grating scene as XML through load_file and the
    package's render (beside main-cbox-gaussian and main), the XML box's
    golden, and the CLI's render of it against an in-process one. `cells`
    maps "mesh82k", "cbox" and "grating" to the presets' main-path and
    split fields (`beside`).
    """
    import numpy as np
    import torch

    import mitsuba3_plt_tpu_torch as mi
    from mitsuba3_plt_tpu_torch.integrators import make_integrator
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene import presets, xml_scenes
    from mitsuba3_plt_tpu_torch.utils.io import read_pfm

    ph = Phase("load-dict-mesh82k")
    dscene, dmeta, arrays, static, load_s = captured_load(
        mi.load_dict, mesh82k_dict(MESH_W, MESH_H, MESH_SUBDIV),
        device=device)
    t0 = time.perf_counter()
    want = presets.mesh_scene_arrays(MESH_W, MESH_H, MESH_SUBDIV)
    preset_s = time.perf_counter() - t0
    diff = differing_keys(arrays, static, want)
    ph.emit(load_s=load_s, preset_arrays_s=preset_s,
            faces=dscene.geo.n_faces, route=dscene.intersect_route(),
            arrays=len(arrays), ctab2_arrays=sorted(
                k for k in arrays if k.startswith("ctab2.")),
            differing=diff, meta=dmeta)
    require(not diff and dscene.intersect_route() == "clu2",
            f"load-dict-mesh82k: arrays differ from the preset's: {diff}")
    del want, arrays
    dinteg = PathIntegrator(max_depth=MESH_DEPTH, rr_depth=MESH_RR)
    d_res, _ = main_path("main-mesh82k-dict", dscene, dinteg, MESH_SPP_PASS,
                         MESH_LAUNCHES)
    d_split = split("split-mesh82k-dict", dscene, dinteg,
                    sum(d_res["pass_s"]) / TIMED_PASSES, MESH_SPP_PASS,
                    "chip_smoke_profile_mesh82k_dict.json")
    beside("main-mesh82k-dict", d_res, d_split, cells["mesh82k"])
    del dscene

    ph = Phase("cbox-xml-scene")
    cbox_xml = write_scene("cbox.xml", xml_scenes.cornell_box_xml(
        CBOX_W, CBOX_H, CBOX_SPP_PASS, CBOX_DEPTH, CBOX_RR))
    xscene, xmeta, arrays, static, load_s = captured_load(
        mi.load_file, cbox_xml, device=device)
    diff = differing_keys(arrays, static,
                          presets.cornell_box_arrays(CBOX_W, CBOX_H))
    ph.emit(load_s=load_s, faces=xscene.geo.n_faces,
            route=xscene.intersect_route(), meta=xmeta,
            tri_idx=xscene.emitters.tri_idx.tolist(),
            differing_from_preset=diff)
    require(xscene.intersect_route() == "brute"
            and xscene.emitters.tri_idx.tolist() == [[34, 35]],
            "the XML Cornell box: 36 faces, the brute route, the light's "
            "two triangles")
    xinteg = make_integrator(xmeta["integrator"])
    x_res, _ = main_path("main-cbox-xml", xscene, xinteg, CBOX_SPP_PASS,
                         CBOX_LAUNCHES, meta=xmeta)
    x_split = split("split-cbox-xml", xscene, xinteg,
                    sum(x_res["pass_s"]) / TIMED_PASSES, CBOX_SPP_PASS,
                    "chip_smoke_profile_cbox_xml.json", meta=xmeta)
    beside("main-cbox-xml", x_res, x_split, cells["cbox"])
    del xscene
    golden_ztest("golden-cbox-xml",
                 mi.load_file(cbox_xml, device=device, resx=32, resy=32)[0],
                 PathIntegrator(max_depth=4, rr_depth=9), "cbox_path.npz", 16)

    ph = Phase("grating-xml-scene")
    grating_xml = write_scene("grating.xml", xml_scenes.grating_scene_xml(
        MAIN_W, MAIN_H, MAIN_SPP_PASS, MAIN_DEPTH, MAIN_RR))
    gx, gmeta, arrays, static, load_s = captured_load(
        mi.load_file, grating_xml, device=device)
    diff = differing_keys(arrays, static,
                          presets.grating_scene_arrays(MAIN_W, MAIN_H))
    ph.emit(load_s=load_s, faces=gx.geo.n_faces, route=gx.intersect_route(),
            meta=gmeta, differing_from_preset=diff)
    ginteg = make_integrator(gmeta["integrator"])
    gx_res, _ = main_path("main-grating-xml", gx, ginteg, MAIN_SPP_PASS,
                          GRATING_LAUNCHES, meta=gmeta)
    gx_split = split("split-grating-xml", gx, ginteg,
                     sum(gx_res["pass_s"]) / TIMED_PASSES, MAIN_SPP_PASS,
                     "chip_smoke_profile_grating_xml.json", meta=gmeta)
    beside("main-grating-xml", gx_res, gx_split, cells["grating"])
    del gx

    ph = Phase("cli")
    out = os.path.join(LOADER_DIR, "cli", "cbox")
    cmd = [sys.executable, "-m", "mitsuba3_plt_tpu_torch.cli", cbox_xml,
           "-o", out, "--spp", str(CLI_SPP), "--resx", str(CLI_W),
           "--resy", str(CLI_W), "--device", device, "--quiet"]
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=HERE, check=True, timeout=600,
                   stdout=subprocess.DEVNULL)
    cli_s = time.perf_counter() - t0
    with open(out + "_params.json") as f:
        params = json.load(f)
    img = mi.render(mi.load_file(cbox_xml, device=device, resx=CLI_W,
                                 resy=CLI_W), spp=CLI_SPP, seed=0)
    img = img[..., :3].cpu().numpy()
    pfm = read_pfm(out + ".pfm")
    equal = bool(np.array_equal(pfm, img))
    ph.emit(subprocess_s=cli_s, equal_to_in_process=equal,
            max_abs_diff=float(np.abs(pfm - img).max()),
            png=os.path.exists(out + ".png"),
            time_per_sample=params["time_per_sample"],
            time_per_sample_steady=params["time_per_sample_steady"],
            load_time_s=params["load_time_s"],
            render_time_s=params["render_time_s"])
    require(equal, "cli: the .pfm differs from the in-process render")
    require(os.path.exists(out + ".png"), "cli: no .png")


# ---------------------------------------------------------------------------
# the camera and the film (samplers, sensors, reconstruction filters) and
# the analytic primitives
# ---------------------------------------------------------------------------

def camera_sensors(width, height, device):
    """{name: a Sensor of each of the seven types} on `device`, the poses
    of tests/test_torch_sensors.py."""
    import numpy as np

    from mitsuba3_plt_tpu_torch.core import transform as tf
    from mitsuba3_plt_tpu_torch.librender.sensor import Sensor

    tw = tf.look_at([0.3, 0.5, 3.0], [0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    subs = np.stack([tf.look_at([x, 0.2, 3.0], [x, 0.0, 0.0], [0, 1, 0])
                     for x in (-0.5, 0.0, 0.7, 1.0)])
    kw = dict(device=device)
    return {
        "perspective": Sensor.perspective(tw, 42.0, width, height,
                                          ppo=(0.01, -0.02), **kw),
        "orthographic": Sensor.orthographic(tw, width, height, 1.3, **kw),
        "thinlens": Sensor.thinlens(tw, 35.0, width, height, 0.08, 2.5,
                                    **kw),
        "batch": Sensor.batch_orthographic(subs, width // 4, height, 0.6,
                                           **kw),
        "radiancemeter": Sensor.radiancemeter(tw, **kw),
        "irradiancemeter": Sensor.irradiancemeter(tw, 0.4, 0.7, **kw),
        "distant": Sensor.distant([0.2, -1.0, 0.3], width, height,
                                  target=(0.1, 0.0, 0.0), radius=1.7, **kw),
    }


def cameras():
    """Every sampler type on every sensor type at CAM_W x CAM_H x CAM_SPP:
    the card's camera rays (o, d) and film positions uv against the port's
    own CPU rays, at atol 1e-5 (the ulps of sinf / cosf / sqrtf); each
    pair's largest difference and whether it reaches the bit."""
    from types import SimpleNamespace

    import torch

    from mitsuba3_plt_tpu_torch.core.rng import SAMPLER_TYPES
    from mitsuba3_plt_tpu_torch.integrators.common import camera_rays_at

    ph = Phase("cameras")
    pairs, worst = [], 0.0
    gpu_sensors = camera_sensors(CAM_W, CAM_H, "cuda")
    for sname, cpu_sensor in camera_sensors(CAM_W, CAM_H, "cpu").items():
        W, H = cpu_sensor.resolution
        lanes = torch.arange(W * H * CAM_SPP, dtype=torch.int64)
        for stype in SAMPLER_TYPES:
            got = camera_rays_at(SimpleNamespace(sensor=gpu_sensors[sname]),
                                 7, lanes.cuda(), W, H, CAM_SPP,
                                 sampler_type=stype)
            want = camera_rays_at(SimpleNamespace(sensor=cpu_sensor), 7,
                                  lanes, W, H, CAM_SPP, sampler_type=stype)
            trio = ((got[0].o, want[0].o), (got[0].d, want[0].d),
                    (got[1], want[1]))
            diffs = [(a.cpu() - b).abs().max().item() for a, b in trio]
            worst = max(worst, *diffs)
            pairs.append({"sensor": sname, "sampler": stype,
                          "lanes": int(lanes.numel()),
                          "bit_equal": all(torch.equal(a.cpu(), b)
                                           for a, b in trio),
                          "max_abs_o": diffs[0], "max_abs_d": diffs[1],
                          "max_abs_uv": diffs[2]})
    ph.emit(width=CAM_W, height=CAM_H, spp=CAM_SPP, pairs=pairs,
            bit_equal=sum(p["bit_equal"] for p in pairs),
            n_pairs=len(pairs), max_abs_err=worst)
    require(worst <= 1e-5, f"cameras: card rays {worst} from the CPU's")


def first_pass(scene, integ, spp_pass):
    """(uv, values, valid) of a render's first pass (seed 0)."""
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays

    W, H = scene.sensor.resolution
    sampler = Sampler.create(0, W * H * spp_pass, device=scene.device
                             ).fork(0)
    ray, uv = sample_rays(scene, sampler, W, H, spp_pass)
    values, valid = integ.sample(scene, sampler, ray)
    return uv, values, valid


SPLAT_LAYOUTS = ("channel_major", "per_tap")


def splat_other_layout(block, pos_uv, values, active, spp, layout):
    """`ImageBlock.put_ordered_filtered`'s sum in one of the two other
    layouts `film` times beside it: "channel_major", the lanes as [C+1,
    spp, H, W] with the filter's weights evaluated once an axis (the JAX
    package's layout up to 8 channels), or "per_tap", the port's own
    layout with each tap's weights evaluated where it is taken (the JAX
    package's above 8). Returns a copy of `block` with the sum added."""
    import dataclasses

    import torch

    from mitsuba3_plt_tpu_torch.librender.film import (FILTER_RADIUS,
                                                       _payload,
                                                       _shift_slices,
                                                       filter_eval)

    w, h, f = block.width, block.height, block.rfilter
    payload, _ = _payload(values, active)
    lane = torch.arange(values.shape[0], device=values.device) // spp
    jx = pos_uv[..., 0] * w - 0.5 - (lane % w).to(torch.float32)
    jy = pos_uv[..., 1] * h - 0.5 - (lane // w).to(torch.float32)
    taps = range(-FILTER_RADIUS[f], FILTER_RADIUS[f] + 1)
    c1 = payload.shape[-1]

    def channel_major():
        pay_t = payload.reshape(h, w, spp, c1).permute(3, 2, 0, 1
                                                       ).contiguous()
        jx_t = jx.reshape(h, w, spp).permute(2, 0, 1)   # [spp, h, w]
        jy_t = jy.reshape(h, w, spp).permute(2, 0, 1)
        wxs = [filter_eval(f, dx - jx_t) for dx in taps]
        wys = [filter_eval(f, dy - jy_t) for dy in taps]
        acc = torch.zeros((c1, h, w), device=values.device)
        for iy, dy in enumerate(taps):
            ysrc, ydst = _shift_slices(dy, h)
            for ix, dx in enumerate(taps):
                tap = (pay_t * (wxs[ix] * wys[iy])[None]).sum(dim=1)
                xsrc, xdst = _shift_slices(dx, w)
                acc[:, ydst, xdst] += tap[:, ysrc, xsrc]
        return acc.permute(1, 2, 0).reshape(h * w, c1)

    def per_tap():
        acc = torch.zeros((h, w, c1), device=values.device)
        for dy in taps:
            wy = filter_eval(f, dy - jy)
            ysrc, ydst = _shift_slices(dy, h)
            for dx in taps:
                wgt = filter_eval(f, dx - jx) * wy
                tap = (payload * wgt[..., None]).reshape(h * w, spp, c1).sum(
                    dim=1).reshape(h, w, c1)
                xsrc, xdst = _shift_slices(dx, w)
                acc[ydst, xdst] += tap[ysrc, xsrc]
        return acc.reshape(h * w, c1)

    fn = {"channel_major": channel_major, "per_tap": per_tap}[layout]
    return dataclasses.replace(block, data=block.data + fn())


def film(scene, integ, spp_pass):
    """On the Cornell box path's first pass (2,097,152 lanes at 512 x
    512), the ordered filtered splat (`put_ordered_filtered`) held to the
    scatter `put` (`index_add_`, whose order the card does not fix) at
    rtol 1e-4 / atol 1e-6 on every buffer entry but those whose sum
    cancels (the negative lobes of mitchell and lanczos), which are held
    to the bound of two float32 sums of n terms, 2 n 2^-24 times the sum
    of their magnitudes (`put_ordered_filtered(..., abs_weights=True)` of
    |value|; n = spp a pass times the (2r+1)^2 taps), and counted, for
    the gaussian, mitchell and lanczos filters on the 3-channel film and
    the gaussian on a 16-channel one (15 channels: the values, their
    square roots and the values times 2, 3 and 4; and the weight); each
    splat timed with CUDA events (`time_ms`); and the gaussian's at 4, 8
    and 16 channels with the weight beside the two other layouts
    (`splat_other_layout`), each held to it at rtol 1e-5 / atol 1e-6, by
    events and by device time (`graph_ms`).
    Returns the 3-channel inputs and the gaussian's ordered ms."""
    import torch

    from mitsuba3_plt_tpu_torch.librender.film import (FILTER_NAMES,
                                                       FILTER_RADIUS,
                                                       ImageBlock)

    ph = Phase("film")
    W, H = scene.sensor.resolution
    uv, values, valid = first_pass(scene, integ, spp_pass)
    wide = torch.cat([values, values.sqrt(), values * 2, values * 3,
                      values * 4], -1)
    rows = []
    for name, vals in (("gaussian", values), ("mitchell", values),
                       ("lanczos", values), ("gaussian", wide)):
        fid = FILTER_NAMES[name]

        def block():
            return ImageBlock.create(W, H, vals.shape[-1], "cuda", fid)

        def ordered():
            return block().put_ordered_filtered(uv, vals, valid, spp_pass)

        def scatter():
            return block().put(uv, vals, valid)

        a, b = ordered().data, scatter().data
        scale = block().put_ordered_filtered(uv, vals.abs(), valid, spp_pass,
                                             abs_weights=True).data
        diff = (a - b).abs()
        close = torch.isclose(a, b, rtol=1e-4, atol=1e-6)
        n_terms = spp_pass * (2 * FILTER_RADIUS[fid] + 1) ** 2
        within = close | (diff <= 2 * n_terms * 2.0 ** -24 * scale)
        row = {"filter": name, "channels": vals.shape[-1],
               "lanes": int(vals.shape[0]), "entries": a.numel(),
               "close_share": close.float().mean().item(),
               "outside_rtol_entries": int((~close).sum()),
               "max_abs_diff": diff.max().item(),
               "max_diff_over_abs_sum": (
                   diff / scale.clamp_min(1e-30)).max().item(),
               "ordered_ms": time_ms(ordered, reps=5, calls=5),
               "scatter_ms": time_ms(scatter, reps=5, calls=5)}
        require(bool(within.all()), f"film: {name} x {vals.shape[-1]}: "
                "the ordered splat differs from the scatter")
        rows.append(row)
    layouts = []
    gauss = FILTER_NAMES["gaussian"]
    for c in (3, 7, 15):
        vals = wide[:, :c]

        def ours():
            return ImageBlock.create(W, H, c, "cuda", gauss
                                     ).put_ordered_filtered(uv, vals, valid,
                                                            spp_pass)

        a = ours().data
        row = {"channels_with_weight": c + 1,
               "ms": time_ms(ours, reps=5, calls=5),
               "device_ms": graph_ms(ours, calls=3, reps=5)}
        for other in SPLAT_LAYOUTS:
            def fn():
                return splat_other_layout(ImageBlock.create(
                    W, H, c, "cuda", gauss), uv, vals, valid, spp_pass,
                    other)

            b = fn().data
            require(bool(torch.isclose(b, a, rtol=1e-5, atol=1e-6).all()),
                    f"film: the {other} layout differs at {c + 1} channels")
            row[f"{other}_ms"] = time_ms(fn, reps=5, calls=5)
            row[f"{other}_device_ms"] = graph_ms(fn, calls=3, reps=5)
            row[f"{other}_max_abs_diff"] = (b - a).abs().max().item()
        layouts.append(row)
    ph.emit(width=W, height=H, spp_per_pass=spp_pass, splats=rows,
            layouts=layouts)
    return (uv, values, valid), rows[0]["ordered_ms"]


def split_splat(name, inputs, spp_pass, width, height, splat_ms, out_file):
    """Device time of one gaussian ordered splat of a pass's inputs by
    kernel (torch.profiler), against its event time splat_ms."""
    from mitsuba3_plt_tpu_torch.librender.film import (FILTER_GAUSSIAN,
                                                       ImageBlock)

    uv, values, valid = inputs
    profile_run(name, lambda: ImageBlock.create(
        width, height, values.shape[-1], "cuda", FILTER_GAUSSIAN
    ).put_ordered_filtered(uv, values, valid, spp_pass), splat_ms / 1e3,
        out_file)


def turns(root):
    """`python3 chip_smoke.py --turns ROOT`: B1, B2, B4, B7a, B7b, B5, B6
    and the tool kernels B8a, B8b, B9, B10a, B10b, B11a, B11b, B11c of the
    package in ROOT (this checkout, or another commit unpacked there) timed
    at the paths' and the tools' shapes, as one JSON line: B1 and B2 on the
    kernels phase's sets (`turns_q`), with their SASS instructions a test
    and the sweep's (B11a, B11b, B11c) and B9's step (`q_sass_counts`); B4
    on the kernels phase's main case (half 3, separable, 1,920,000 lanes);
    on the mesh82k packet scene (1,048,576 lanes a set, unsorted and sorted
    by the route) B7a on the camera,
    bounce and bounce-random sets and B7b on the shadow, shadow-random and
    all-dead sets, and both on the regenerative wavefront's 131,072 rays,
    sorted; B5 and B6 on the six sets of `turns_clu2`; B8a, B8b, B9, B10a,
    B10b and B11 on the tools' sets of `turns_tools`. B1, B2, B5, B6, B7,
    B8, B9, B10 and B11 are timed by `kernel_times` (device time where the
    wrapper takes longer than the kernel). The lobe sum's forward and
    backward through the public API (`turns_lobe_pair`) on B4's main case
    and on the grating box path's first lobe-sum inputs, with B4's two
    instances and B4b alone where ROOT has the recording instance; the
    gradient cells' ms a gradient and peak memory (`turns_grad`). The
    kernels build in ROOT. Run it over two checkouts in turns (parent,
    change, change, parent) within one chip call to compare them on one
    card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np

    import mitsuba3_plt_tpu_torch as pkg
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.ops import build
    from mitsuba3_plt_tpu_torch.ops import grating as gops
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene

    require(os.path.dirname(os.path.abspath(pkg.__file__))
            == os.path.join(root, "mitsuba3_plt_tpu_torch"),
            f"--turns {root}: imported {pkg.__file__}")
    t0 = time.perf_counter()
    build.load_library()
    with open(build.library_file() + ".log") as f:
        registers, spills = ptxas_report(f.read())
    rng = np.random.default_rng(0)
    ins = lobe_sum_inputs(rng, MAIN_W * MAIN_H * MAIN_SPP_PASS, 0, 0.0,
                          "cuda")
    lobe_ms = time_ms(lambda: gops.grating_lobe_sum(
        **ins, half=3, separable=True, n_channels=3))
    cot = torch.as_tensor(rng.normal(size=(ins["q"].shape[0], 3)).astype(
        np.float32), device="cuda")
    pair = {"main": turns_lobe_pair(gops, [ins[k] for k in LOBE_SUM_ARGS],
                                    cot, 3, True)}
    del ins, cot
    box_args, box_kw = grating_box_inputs(
        cornell_box(CBOX_W, CBOX_H, box_material="grating", device="cuda"),
        PLTIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR),
        CBOX_SPP_PASS)["grating_lobe_sum"]
    cot = torch.as_tensor(rng.normal(size=(box_args[0].shape[0], 3)).astype(
        np.float32), device="cuda")
    pair["grating box"] = turns_lobe_pair(gops, list(box_args), cot,
                                          box_kw["half"],
                                          box_kw["separable"])
    del box_args, cot
    grad_ms = turns_grad()
    scene = mesh_scene(MESH_W, MESH_H, MESH_SUBDIV, accel="packet",
                       device="cuda")
    table, any_table = closest_table(scene), anyhit_table(scene, isect)
    W, H = scene.sensor.resolution
    cam, _ = sample_rays(scene, Sampler.create(
        0, W * H * MESH_SPP_PASS, device="cuda"), W, H, MESH_SPP_PASS)
    n = cam.o.shape[0]
    closest = {"camera": (cam.o, cam.d, cam.maxt)}
    closest["bounce"], shadow = camera_hit_rays(
        scene, cam, isect.intersect_bvh(table, cam.o, cam.d, cam.maxt), rng)
    closest["bounce-random"], shadow_random = random_surface_rays(scene, n,
                                                                  rng)
    anyhit = {"shadow": shadow, "shadow-random": shadow_random,
              "dead": dead_rays(n, "cuda")[1]}
    rcam, rshadow = regen_wavefront(scene, rng)

    def both_orders(kernel, tab, rays):
        out = {}
        for label, (o, d, mt) in rays.items():
            perm, _ = scene._packet_perm(o, d)
            in_order = (o[perm], d[perm], mt[perm])
            out[label] = {
                "unsorted": kernel_times(lambda: kernel(tab, o, d, mt)),
                "sorted": kernel_times(lambda: kernel(tab, *in_order))}
        return out

    def regen(kernel, tab, o, d, mt):
        perm, _ = scene._packet_perm(o, d)
        in_order = (o[perm], d[perm], mt[perm])
        return kernel_times(lambda: kernel(tab, *in_order))

    bvh_ms = both_orders(isect.intersect_bvh, table, closest)
    bvh_ms["regen camera, sorted"] = regen(isect.intersect_bvh, table,
                                           rcam.o, rcam.d, rcam.maxt)
    occ_ms = both_orders(isect.occluded_bvh, any_table, anyhit)
    occ_ms["regen shadow, sorted"] = regen(isect.occluded_bvh, any_table,
                                           *rshadow)
    del scene, closest, anyhit, rcam, rshadow
    clu2_ms = turns_clu2(isect, rng)
    tool_ms = turns_tools(isect)
    q_ms = turns_q(isect)
    emit({"turns": root, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line(), "lobe_sum_ms": lobe_ms,
          "lobe_pair": pair, "grad": grad_ms,
          "intersect_bvh_ms": bvh_ms, "occluded_bvh_ms": occ_ms,
          "closest_table": type(table).__name__,
          "anyhit_table": type(any_table).__name__, "clu2_ms": clu2_ms,
          **tool_ms, "q_ms": q_ms,
          "q_sass": {k: c.get("per_test", c)
                     for k, c in q_sass_counts(build.library_file()).items()},
          "registers": {k: v for k, v in registers.items()
                        if k.startswith(("lobe_sum", "bvh", "wide",
                                         "anyhit", "clu", "classic",
                                         "q_kernel", "sweep", "mxu"))},
          "spills": spills, "seconds": time.perf_counter() - t0})


def turns_lobe_pair(gops, args, cot, half, separable):
    """The lobe sum's forward and backward through the public API both
    checkouts share: `grating_lobe_sum` on inputs that require grad, then
    the gradients of its differentiable inputs with the cotangent `cot`,
    by `time_ms` ("pair_ms": the host's time where it is the slower) and
    on the device ("pair_device_ms": a CUDA graph of the pair,
    `graph_ms`); B4 and B4b alone (`kernel_times`, B4b on the device),
    B4b on the bits of B4's recording instance where the checkout has it
    (`grating_lobe_sum_record`, timed too)."""
    import torch

    no_grad = ("lobes", "gtype", "a_cone")
    xs = [t.detach().clone().requires_grad_(name not in no_grad)
          for name, t in zip(LOBE_SUM_ARGS, args)]
    want = [x for name, x in zip(LOBE_SUM_ARGS, xs) if name not in no_grad]

    def pair():
        y = gops.grating_lobe_sum(*xs, half=half, separable=separable,
                                  n_channels=3)
        return torch.autograd.grad(y, want, cot)
    out = {"n": cot.shape[0], "half": half, "separable": separable,
           "pair_ms": time_ms(pair), "pair_device_ms": graph_ms(pair),
           "lobe_sum": kernel_times(lambda: gops.grating_lobe_sum(
               *args, half=half, separable=separable, n_channels=3))}
    if hasattr(gops, "grating_lobe_sum_record"):
        _, sel = gops.grating_lobe_sum_record(args, half, separable)
        out["lobe_sum_record"] = kernel_times(
            lambda: gops.grating_lobe_sum_record(args, half, separable))
        out["lobe_sum_bwd"] = kernel_times(
            lambda: gops.grating_lobe_sum_bwd(args, cot, half, separable,
                                              sel), device=True)
    else:
        out["lobe_sum_bwd"] = kernel_times(
            lambda: gops.grating_lobe_sum_bwd(args, cot, half, separable),
            device=True)
    return out


def turns_grad(reps=3):
    """The gradient cells through the public API both checkouts share
    (`ad.render_loss_grad` of the mean image): grad-grating-800x600-plt's
    four grating parameters (PLT depth 7, GRAD_SPP spp) and
    grad-cbox-512x512's base_color through the path tracer and PRB
    (GRAD_CBOX_SPP spp), each a warm-up and `reps` timed evaluations ending
    in a device sync: {cell: {"ms": [...], "peak_mem_bytes"}}."""
    import torch

    from mitsuba3_plt_tpu_torch import ad
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.integrators.prb import PRBIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, grating_scene

    cells = (
        ("grad-grating", grating_scene(MAIN_W, MAIN_H, device="cuda"),
         PLTIntegrator(max_depth=MAIN_DEPTH, rr_depth=MAIN_RR),
         list(GRAD_KEYS), GRAD_SPP),
        ("grad-cbox-path", cornell_box(CBOX_W, CBOX_H, device="cuda"),
         PathIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR),
         ["materials.base_color"], GRAD_CBOX_SPP),
        ("grad-cbox-prb", cornell_box(CBOX_W, CBOX_H, device="cuda"),
         PRBIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR),
         ["materials.base_color"], GRAD_CBOX_SPP))
    out = {}
    for name, scene, integ, keys, spp in cells:
        def evaluate():
            ad.render_loss_grad(scene, integ.sample, torch.mean, keys,
                                seed=0, spp=spp)
            torch.cuda.synchronize()
        evaluate()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            evaluate()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms": ms,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    return out


def turns_q(isect):
    """B1 and B2 of the package `isect` belongs to, timed by `kernel_times`
    on the kernels phase's sets: {set: times}, the grating's camera and
    shadow-like rays (`grating_q_rays`, 1,920,000 each) and the Cornell box
    path's own first closest-hit and any-hit rays (`path_q_rays`,
    2,097,152 each)."""
    import numpy as np

    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, grating_scene

    gscene = grating_scene(MAIN_W, MAIN_H, device="cuda")
    cscene = cornell_box(CBOX_W, CBOX_H, device="cuda")
    sets = {"grating": (gscene, grating_q_rays(
                gscene, MAIN_W * MAIN_H * MAIN_SPP_PASS,
                np.random.default_rng(0))),
            "cbox path": (cscene, path_q_rays(
                cscene, PathIntegrator(max_depth=CBOX_DEPTH,
                                       rr_depth=CBOX_RR), CBOX_SPP_PASS))}
    out = {}
    for label, (scene, (closest, shadow)) in sets.items():
        g = scene.geo
        out[f"B1 {label}"] = kernel_times(lambda: isect.intersect_q(
            g.tri_q, g.tri_anchor, *closest, g.n_faces))
        out[f"B2 {label}"] = kernel_times(lambda: isect.occluded_q(
            g.tri_q, g.tri_anchor, *shadow, g.n_faces))
    return out


def turns_clu2(isect, rng):
    """B5 and B6 of the package `isect` belongs to, timed by `kernel_times`
    on the mesh82k clu2 scene's sets of the kernels phase at 1,048,576
    lanes: {set: times}, B5 on the camera, bounce, bounce-random and dead
    rays, B6 on the shadow, shadow-random and dead rays (the dead sets, a
    few hundredths of a ms, by device time: a CUDA graph)."""
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
    from mitsuba3_plt_tpu_torch.scene.presets import mesh_scene

    scene = mesh_scene(MESH_W, MESH_H, MESH_SUBDIV, device="cuda")
    ct = scene.ctab2
    W, H = scene.sensor.resolution
    cam, _ = sample_rays(scene, Sampler.create(
        0, W * H * MESH_SPP_PASS, device="cuda"), W, H, MESH_SPP_PASS)
    n = cam.o.shape[0]
    closest = {"camera": (cam.o, cam.d, cam.maxt)}
    closest["bounce"], shadow = camera_hit_rays(
        scene, cam, isect.intersect_clu2(ct, cam.o, cam.d, cam.maxt), rng)
    closest["bounce-random"], shadow_random = random_surface_rays(
        scene, n, rng)
    closest["dead"], dead_shadow = dead_rays(n, "cuda")
    anyhit = {"shadow": shadow, "shadow-random": shadow_random,
              "dead": dead_shadow}
    out = {f"B5 {label}": kernel_times(lambda: isect.intersect_clu2(ct, *r))
           for label, r in closest.items()}
    out.update({f"B6 {label}": kernel_times(
        lambda: isect.occluded_clu2(ct, *r)) for label, r in anyhit.items()})
    return out


def turns_tools(isect):
    """The tool kernels of the package `isect` belongs to, timed by
    `kernel_times` on the Cornell box and the 5,120-face icosphere: {
    "classic_ms": B8a, B8b and B9 on the intersection tool's coherent and
    incoherent sets, "clu_ms": B10a on the mask-sort tool's incoherent and
    depth0-depth3 sets and B10b on its shadow0-shadow3 sets, each over
    ctab64 and ctab128, all at 1,048,576 lanes a set, "sweep_ms": B1 and
    B11a at unroll 8, 16 and 32 with one and two accumulators and B11b at
    unroll 8, 16 and 32 (the tool's maxt) on the unroll sweep's TOOL_LANES
    rays,
    B11c at every nacc on MACC_LANES of them
    (`isect_unroll_sweep.sweep_rays`)}; B8b also
    on the intersection tool's sets of the 20,480-face icosphere, a table
    too large for its shared memory, with its bound (published peaks) from
    the tests the plain version counts on CHUNKED_COUNT_LANES of each
    set's lanes."""
    import torch

    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    classic_ms, clu_ms, sweep_ms = {}, {}, {}
    for label, scene in (
            ("cbox", cornell_box(CBOX_W, CBOX_H, device="cuda")),
            ("mesh5k", mesh_scene(CBOX_W, CBOX_H, TOOL_SUBDIV,
                                  device="cuda"))):
        g, F = scene.geo, scene.geo.n_faces
        p = g.tri_isect[:F].cpu().numpy()
        w = torch.as_tensor(isect.regroup_tri_mxu(isect.pack_tri_mxu(
            p[:, 0:3], p[:, 3:6], p[:, 6:9])), device="cuda")
        for set_label, (o, d, mt) in bi.ray_sets(scene, TOOL_LANES,
                                                 0).items():
            classic_ms[f"B8a {label} {set_label}"] = kernel_times(
                lambda: isect.intersect_classic(g.tri_isect, o, d, mt, F))
            classic_ms[f"B8b {label} {set_label}"] = kernel_times(
                lambda: isect.occluded_classic(g.tri_isect, o, d, mt, F))
            classic_ms[f"B9 {label} {set_label}"] = kernel_times(
                lambda: isect.intersect_mxu(w, o, d, mt, F))
        sets = ms.ray_sets(scene, TOOL_LANES // (CBOX_W * CBOX_H), 0)
        for tab_label, ct in ms.tables(scene).items():
            for set_label, (o, d, mt) in sets.items():
                any_hit = set_label.startswith("shadow")
                kernel = isect.occluded_clu if any_hit else isect.intersect_clu
                key = (f"{'B10b' if any_hit else 'B10a'} {label} {tab_label} "
                       f"{set_label}")
                clu_ms[key] = kernel_times(lambda: kernel(ct, o, d, mt))
        del sets
        q = (g.tri_q, g.tri_anchor)
        o, d, mt = us.sweep_rays(scene, TOOL_LANES, 0)
        sweep_ms[f"B1 {label}"] = kernel_times(
            lambda: isect.intersect_q(*q, o, d, mt, F))
        for unroll in (8, 16, 32):
            for dual in (False, True):
                key = f"B11a {label} unroll {unroll}{' dual' * dual}"
                sweep_ms[key] = kernel_times(
                    lambda: isect.intersect_q_variant(*q, o, d, mt, F,
                                                      unroll, dual))
        t0 = isect.intersect_q(*q, o, d, mt, F)[0]
        msh = torch.where(torch.isfinite(t0), t0 * 0.99, 2.0)
        for unroll in (8, 16, 32):
            sweep_ms[f"B11b {label} unroll {unroll}"] = kernel_times(
                lambda: isect.occluded_q_variant(*q, o, d, msh, F, unroll))
        o, d, mt = us.sweep_rays(scene, MACC_LANES, 0)
        for nacc in isect.Q_MACC_NACCS:
            sweep_ms[f"B11c {label} nacc {nacc}"] = kernel_times(
                lambda: isect.intersect_q_macc(*q, o, d, mt, F, nacc))
        del o, d, mt, t0, msh
    scene = mesh_scene(CBOX_W, CBOX_H, CHUNKED_SUBDIV, device="cuda")
    g, F = scene.geo, scene.geo.n_faces
    for set_label, (o, d, mt) in bi.ray_sets(scene, TOOL_LANES, 0).items():
        times = kernel_times(
            lambda: isect.occluded_classic(g.tri_isect, o, d, mt, F))
        # its bound: the tests up to each ray's first hit, counted by the
        # plain version on the first CHUNKED_COUNT_LANES lanes, scaled
        n, m, counts = o.shape[0], CHUNKED_COUNT_LANES, {}
        isect.occluded_classic_plain(g.tri_isect, o[:m], d[:m], mt[:m], F,
                                     counts=counts)
        tests = counts["triangle_tests"] * n / m
        classic_ms[f"B8b mesh20k {set_label}"] = dict(
            times, tests_per_ray=tests / n,
            **bound(nbytes(g.tri_isect[:F], o, d, mt) + n,
                    n * CLASSIC_RAY_SETUP_OPS
                    + tests * CLASSIC_ANYHIT_TEST_OPS))
    return {"classic_ms": classic_ms, "clu_ms": clu_ms, "sweep_ms": sweep_ms}


def film_only():
    """`python3 chip_smoke.py --film`: the card line and the `film`
    phase alone (the ordered splat against the scatter and the two
    layouts, on the Cornell box path's first pass)."""
    import torch

    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box

    Phase("card").emit(nvidia_smi=nvidia_smi_line(),
                       device=torch.cuda.get_device_name(0))
    film(cornell_box(CBOX_W, CBOX_H, device="cuda"),
         PathIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR),
         CBOX_SPP_PASS)


def main():
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--turns":
        turns(sys.argv[2])
        return
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    if sys.argv[1:] == ["--film"]:
        film_only()
        return
    if sys.argv[1:] == ["--gradients"]:
        gradients_only()
        return
    import numpy as np

    from mitsuba3_plt_tpu_torch.config import RGB_POLARIZED
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.integrators.stokes import (
        PolarizedPathIntegrator, StokesIntegrator)
    from mitsuba3_plt_tpu_torch.librender.film import FILTER_GAUSSIAN
    from mitsuba3_plt_tpu_torch.ops import build, mfu
    from mitsuba3_plt_tpu_torch.scene.presets import (analytic_scene,
                                                      cornell_box,
                                                      furnace_scene,
                                                      grating_scene,
                                                      mesh_scene)
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    ph = Phase("card")
    ph.emit(nvidia_smi=smi, device=kind, torch=torch.__version__,
            cuda=torch.version.cuda, count=torch.cuda.device_count())

    ph = Phase("build")
    build.load_library()
    registers, spills = ptxas_report(build.build_log)
    sass = mfu.library_sass()
    specials = mfu.special_fn_counts(sass)
    q_sass = q_sass_counts(build.library_file())
    ph.emit(sources=list(build.SOURCES), registers=registers, spills=spills,
            special_fn_fast_paths=specials, q_sass=q_sass)

    ph = Phase("mesh82k-scene")
    mscene = mesh_scene(MESH_W, MESH_H, MESH_SUBDIV, device="cuda")
    ct = mscene.ctab2
    ph.emit(faces=mscene.geo.n_faces, route=mscene.intersect_route(),
            supers=list(ct.supers.shape), boxes=list(ct.boxes.shape),
            rows=list(ct.rows.shape))
    require(mscene.intersect_route() == "clu2", "mesh82k must route to clu2")
    ph = Phase("mesh82k-packet-scene")
    pscene = mesh_scene(MESH_W, MESH_H, MESH_SUBDIV, accel="packet",
                        device="cuda")
    ph.emit(faces=pscene.geo.n_faces, route=pscene.intersect_route(),
            nodes=list(pscene.pbvh.nodes.shape),
            tri=list(pscene.pbvh.tri.shape),
            wide_nodes=list(pscene.wbvh.nodes.shape),
            wide_stack=pscene.wbvh.stack)
    require(pscene.intersect_route() == "packet",
            "mesh82k with packet tables must route to packet")

    ph = Phase("cbox-scene")
    cscene = cornell_box(CBOX_W, CBOX_H, device="cuda")
    em = cscene.emitters
    ph.emit(faces=cscene.geo.n_faces, route=cscene.intersect_route(),
            tri_isect=list(cscene.geo.tri_isect.shape),
            emitter_types=list(em.present_types),
            tri_idx=em.tri_idx.tolist(), tri_cdf=em.tri_cdf.tolist(),
            area=em.area.tolist())
    require(cscene.geo.n_faces == 36 and cscene.intersect_route() == "brute"
            and em.tri_idx.tolist() == [[34, 35]],
            "the Cornell box must have 36 faces, the brute route and a "
            "two-triangle light")
    ph = Phase("isect-sets")
    tscene = mesh_scene(CBOX_W, CBOX_H, TOOL_SUBDIV, device="cuda")
    csets = {**bi.ray_sets(cscene, TOOL_LANES, 0),
             **bi.cbox_ray_sets(cscene, TOOL_LANES // (CBOX_W * CBOX_H), 0)}
    tsets = bi.ray_sets(tscene, TOOL_LANES, 0)
    spp = TOOL_LANES // (CBOX_W * CBOX_H)
    mask_scenes = [(label, sc, ms.tables(sc), ms.ray_sets(sc, spp, 0))
                   for label, sc in (("cbox", cscene), ("mesh5k", tscene))]
    sweep_scenes = [(label, sc, us.sweep_rays(sc, TOOL_LANES, 0))
                    for label, sc in (("cbox", cscene), ("mesh5k", tscene))]
    macc_scenes = [(label, sc, us.sweep_rays(sc, MACC_LANES, 0))
                   for label, sc in (("cbox", cscene), ("mesh5k", tscene))]
    ph.emit(cbox_sets=list(csets), mesh_faces=tscene.geo.n_faces,
            mesh_sets=list(tsets), lanes=TOOL_LANES,
            mask_sets=list(mask_scenes[0][3]),
            clusters={label: {k: t.boxes.shape[0] for k, t in tabs.items()}
                      for label, _, tabs, _ in mask_scenes})

    ph = Phase("kernels")
    n = MAIN_W * MAIN_H * MAIN_SPP_PASS
    rng = np.random.default_rng(0)
    iscene = grating_scene(MAIN_W, MAIN_H, device="cuda")
    rows = check_q("grating", iscene, *grating_q_rays(iscene, n, rng),
                   q_sass)
    rows.append(check_sample(n, rng, "cuda"))
    rows.append(check_lobe_sum(n, rng, "cuda", specials))
    clu2_rows, ray_sets, clu2_ms = check_clu2(mscene, rng)
    rows += clu2_rows + check_bvh(pscene, ray_sets, clu2_ms, rng)
    del ray_sets
    for r in rows:
        emit({"phase": "kernels", **r})
    # B1 and B2 at the Cornell box path's shape: its own first camera and
    # shadow rays (2,097,152 lanes, 36 faces); printed with the measured
    # roofs below
    cinteg = PathIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR)
    cbox_q = check_q("cbox path", cscene, *path_q_rays(
        cscene, cinteg, CBOX_SPP_PASS), q_sass)
    # B1 and B2 on the dielectric box path's second closest-hit and any-hit
    # calls: the first rays that leave the surfaces, refracted ones from
    # origins just inside the glass among them; B3 and B4 on the grating
    # box path's own first calls (half = 2)
    boxes = {box: cornell_box(CBOX_W, CBOX_H, box_material=box,
                              device="cuda") for _, box, _, _ in CBOX_BOXES}
    cbox_q += check_q("cbox-dielectric path bounce 1", boxes["dielectric"],
                      *path_q_rays(boxes["dielectric"], cinteg,
                                   CBOX_SPP_PASS, call=1), q_sass,
                      bounce=True)
    pinteg = PLTIntegrator(max_depth=CBOX_DEPTH, rr_depth=CBOX_RR)
    box_inputs = grating_box_inputs(boxes["grating"], pinteg, CBOX_SPP_PASS)
    grating_box = check_grating_box(box_inputs, specials)
    # B4b on the main path's lane count (four cases) and on the grating
    # box's own NEE inputs
    bwd_main, bwd_box = check_lobe_sum_bwd(n, rng, "cuda", specials,
                                           box_inputs)
    del box_inputs
    rows.append(bwd_main)
    pick = {k: csets[k] for k in ("coherent", "incoherent")}
    brute = check_brute("cbox", cscene, pick, q_sass)
    check_brute("mesh5k", tscene, tsets, q_sass, PLAIN_LANES)
    rows += brute["incoherent"]
    # the Cornell box at full size on both tables: its incoherent rays
    # start inside the boxes, whose bottoms tie the floor exactly
    _, _, ctabs, cmask = mask_scenes[0]
    for tab in ctabs:
        check_clu("cbox", ctabs, cmask, tab=tab)
    _, _, ttabs, tmask = mask_scenes[1]
    clu = check_clu("mesh5k", ttabs,
                    {k: tmask[k] for k in ("incoherent", "depth0",
                                           "shadow0")}, PLAIN_LANES)
    rows += [clu["incoherent"], clu["shadow0"]]
    check_sweep("cbox", cscene, sweep_scenes[0][2], q_sass)
    sweep = check_sweep("mesh5k", tscene, sweep_scenes[1][2], q_sass,
                        PLAIN_LANES)
    rows += [sweep["closest", 16, False], sweep["any hit", 16, False]]
    check_macc("cbox", cscene, macc_scenes[0][2], q_sass)
    macc = check_macc("mesh5k", tscene, macc_scenes[1][2], q_sass,
                      PLAIN_LANES)
    rows += [macc[8], check_fma(rng, "cuda")]
    ph.emit(checked=[r["name"] for r in rows])
    tool_launches = isect_tool([("cbox", cscene, csets),
                                ("mesh5k", tscene, tsets)])
    del csets, tsets, pick
    mask_launches = mask_sort_tool(mask_scenes)
    sweep_launches = unroll_sweep_tool(sweep_scenes)
    macc_launches = q_multiacc_tool(macc_scenes)
    mfu_launches, roofs = kernel_mfu_tool(macc_scenes, "cuda", sass,
                                          specials)
    for r in cbox_q + grating_box:
        emit({"phase": "kernels", **r, **measured_bound(r, roofs),
              "launches_per_pass": CBOX_PLT_LAUNCHES[r["name"]]})
    for r in (bwd_main, bwd_box):
        # the slots of B4b's warps, each branch and bit loop as long as its
        # slowest lane's, against the measured roof: the floor its
        # divergence sets
        emit({"phase": "kernels", **r, **measured_bound(r, roofs),
              "warp_measured_bound_ms":
                  r["count"]["warp_slots"] / roofs["slots"] * 1e3})
    # the tools' rays and tables (~0.5 GB) must not count in the main
    # paths' peak memory
    del mask_scenes, sweep_scenes, macc_scenes, ttabs, tmask, ctabs, cmask

    golden_ztest("golden", grating_scene(24, 24, coherence=1e3,
                                         device="cuda"),
                 PLTIntegrator(max_depth=3, rr_depth=9), "grating_plt.npz", 12)
    golden_ztest("golden-mesh20k", mesh_scene(32, 32, 5, device="cuda"),
                 PathIntegrator(max_depth=3, rr_depth=9), "mesh20k_path.npz",
                 8)
    golden_ztest("golden-mesh20k-packet",
                 mesh_scene(32, 32, 5, accel="packet", device="cuda"),
                 PathIntegrator(max_depth=3, rr_depth=9), "mesh20k_path.npz",
                 8)
    golden_ztest("golden-cbox", cornell_box(32, 32, device="cuda"),
                 PathIntegrator(max_depth=4, rr_depth=9), "cbox_path.npz", 16)
    for name, box, method, golden in GOLDEN_BOXES:
        integ = (PathIntegrator if method == "path" else PLTIntegrator)(
            max_depth=4, rr_depth=9)
        golden_ztest(name, cornell_box(32, 32, box_material=box,
                                       device="cuda"),
                     integ, golden, 16, ("tests", "golden_torch"))
    golden_ztest("golden-cbox-gaussian", cornell_box(32, 32, device="cuda"),
                 PathIntegrator(max_depth=4, rr_depth=9),
                 "cbox_gaussian_path.npz", 16, ("tests", "golden_torch"),
                 rfilter=FILTER_GAUSSIAN)
    golden_ztest("golden-analytic",
                 analytic_scene(32, 32, device="cuda")[0],
                 PathIntegrator(max_depth=4, rr_depth=9),
                 "analytic_path.npz", 16, ("tests", "golden_torch"),
                 sampler_type="multijitter")
    furnace(furnace_scene(FURNACE_W, FURNACE_H, albedo=FURNACE_ALBEDO,
                          device="cuda"),
            PathIntegrator(max_depth=6, rr_depth=20), FURNACE_SPP,
            FURNACE_ALBEDO)
    # polarized transport: the JAX package's own golden of the glass box
    # (StokesIntegrator() with its defaults, 15 channels), its degree of
    # polarization, and the diffuse box's collapse to the scalar path
    stokes_mean = golden_ztest(
        "golden-cbox-stokes", cornell_box(24, 24, box_material="dielectric",
                                          device="cuda"),
        StokesIntegrator(), "cbox_stokes.npz", 12)
    degree_of_polarization("dop-golden-cbox-stokes", stokes_mean)
    collapse(cornell_box(COLLAPSE_W, COLLAPSE_H, device="cuda"), CBOX_DEPTH,
             CBOX_RR)

    gscene = grating_scene(MAIN_W, MAIN_H, device="cuda")
    ginteg = PLTIntegrator(max_depth=MAIN_DEPTH, rr_depth=MAIN_RR)
    g_res, _ = main_path("main", gscene, ginteg, MAIN_SPP_PASS,
                         GRATING_LAUNCHES)
    g_split = split("split", gscene, ginteg,
                    sum(g_res["pass_s"]) / TIMED_PASSES, MAIN_SPP_PASS,
                    "chip_smoke_profile.json")

    minteg = PathIntegrator(max_depth=MESH_DEPTH, rr_depth=MESH_RR)
    m_res, _ = main_path("main-mesh82k", mscene, minteg, MESH_SPP_PASS,
                         MESH_LAUNCHES)
    m_split = split("split-mesh82k", mscene, minteg,
                    sum(m_res["pass_s"]) / TIMED_PASSES, MESH_SPP_PASS,
                    "chip_smoke_profile_mesh82k.json")

    p_res, p_img = main_path("main-mesh82k-packet", pscene, minteg,
                             MESH_SPP_PASS, PACKET_LAUNCHES, **REGEN)
    same_image("main-mesh82k-packet", p_img, pscene, minteg, MESH_SPP_PASS)
    split("split-mesh82k-packet", pscene, minteg,
          sum(p_res["pass_s"]) / TIMED_PASSES, MESH_SPP_PASS,
          "chip_smoke_profile_mesh82k_packet.json", **REGEN)
    _, r_img = main_path("main-mesh82k-regen", mscene, minteg, MESH_SPP_PASS,
                         REGEN_CLU2_LAUNCHES, **REGEN)
    same_image("main-mesh82k-regen", r_img, mscene, minteg, MESH_SPP_PASS)

    c_res, _ = main_path("main-cbox", cscene, cinteg, CBOX_SPP_PASS,
                         CBOX_LAUNCHES)
    split("split-cbox", cscene, cinteg, sum(c_res["pass_s"]) / TIMED_PASSES,
          CBOX_SPP_PASS, "chip_smoke_profile_cbox.json")
    # the camera and the film: the Cornell box through the Gaussian filter
    # (the film JAX's mi.render gives a preset) beside main-cbox, the
    # analytic scene through the thinlens camera and multijitter sampler
    cg_res, _ = main_path("main-cbox-gaussian", cscene, cinteg,
                          CBOX_SPP_PASS, CBOX_LAUNCHES,
                          rfilter=FILTER_GAUSSIAN)
    Phase("main-cbox-gaussian-vs-box").emit(
        ms_per_spp_gaussian=cg_res["ms_per_spp"],
        ms_per_spp_box=c_res["ms_per_spp"],
        ms_per_spp_difference=cg_res["ms_per_spp"] - c_res["ms_per_spp"],
        peak_mem_bytes_gaussian=cg_res["peak_mem_bytes"],
        peak_mem_bytes_box=c_res["peak_mem_bytes"])
    cg_split = split("split-cbox-gaussian", cscene, cinteg,
                     sum(cg_res["pass_s"]) / TIMED_PASSES, CBOX_SPP_PASS,
                     "chip_smoke_profile_cbox_gaussian.json",
                     rfilter=FILTER_GAUSSIAN)
    loaders({"mesh82k": (m_res, m_split), "cbox": (cg_res, cg_split),
             "grating": (g_res, g_split)})
    splat_inputs, splat_ms = film(cscene, cinteg, CBOX_SPP_PASS)
    split_splat("split-cbox-gaussian-splat", splat_inputs, CBOX_SPP_PASS,
                CBOX_W, CBOX_H, splat_ms,
                "chip_smoke_profile_cbox_gaussian_splat.json")
    del splat_inputs
    cameras()
    ph = Phase("analytic-scene")
    ascene, ameta = analytic_scene(CBOX_W, CBOX_H, device="cuda")
    g = ascene.geo
    ph.emit(faces=g.n_faces, spheres=g.n_spheres, disks=g.n_disks,
            cylinders=g.n_cylinders, route=ascene.intersect_route(),
            sensor_type=ascene.sensor.stype_static,
            emitter_types=list(ascene.emitters.present_types), meta=ameta)
    require((g.n_faces, g.n_spheres, g.n_disks, g.n_cylinders)
            == (2, 1, 1, 1) and ascene.intersect_route() == "brute",
            "the analytic scene: one floor, one sphere, disk and cylinder")
    a_res, a_img = main_path("main-analytic", ascene, cinteg, CBOX_SPP_PASS,
                             CBOX_LAUNCHES, sampler_type="multijitter")
    require(a_img.max().item() > 4.0, "main-analytic: the sphere light "
            "is not seen")
    split("split-analytic", ascene, cinteg,
          sum(a_res["pass_s"]) / TIMED_PASSES, CBOX_SPP_PASS,
          "chip_smoke_profile_analytic.json", sampler_type="multijitter")
    for name, box, method, per_pass in CBOX_BOXES:
        integ = cinteg if method == "path" else pinteg
        b_res, _ = main_path(name, boxes[box], integ, CBOX_SPP_PASS,
                             per_pass)
        if box == "dielectric":
            split("split-cbox-dielectric", boxes[box], integ,
                  sum(b_res["pass_s"]) / TIMED_PASSES, CBOX_SPP_PASS,
                  "chip_smoke_profile_cbox_dielectric.json")

    # the polarized paths (bench.py's rgb_polarized rows): polarized PLT on
    # the grating scene, film S0 (B1-B4), and the stokes wrapper of the
    # Mueller path tracer on the glass box, 15 channels (B1, B2)
    del boxes
    pol_res, _ = main_path("main-grating-polarized", gscene, ginteg,
                           POL_SPP_PASS, POL_GRATING_LAUNCHES, POL_PASSES,
                           cfg=RGB_POLARIZED)
    split("split-grating-polarized", gscene, ginteg,
          sum(pol_res["pass_s"]) / POL_PASSES, POL_SPP_PASS,
          "chip_smoke_profile_grating_polarized.json", cfg=RGB_POLARIZED)
    sscene = cornell_box(CBOX_W, CBOX_H, box_material="dielectric",
                         device="cuda")
    sinteg = StokesIntegrator(PolarizedPathIntegrator(CBOX_DEPTH, CBOX_RR),
                              forward_basis=False)
    st_res, st_img = main_path("main-cbox-stokes", sscene, sinteg,
                               POL_SPP_PASS, POL_CBOX_LAUNCHES, POL_PASSES)
    degree_of_polarization("dop-main-cbox-stokes", st_img.cpu())
    split("split-cbox-stokes", sscene, sinteg,
          sum(st_res["pass_s"]) / POL_PASSES, POL_SPP_PASS,
          "chip_smoke_profile_cbox_stokes.json")

    # the gradient paths: B1-B4 and B4b through PLT on the grating scene
    # (B4b's launches in the kernels line are these), the path tracer and
    # PRB on the Cornell box (B1, B2)
    grad_launches = grad_grating(gscene, ginteg)
    grad_cbox(cscene)
    # geometry gradients: the boundary terms on tests/test_projective.py's
    # scenes (B1, B2); polarized gradients: PLT on the grating scene (B1-B3,
    # B4's recording instance, B4b) and the Stokes path on the boxes (B1,
    # B2); and the renders' TF32 flags
    for name, eps, tol in BOUNDARY_CELLS:
        grad_boundary(name, eps, tol)
    grad_grating_polarized(gscene, ginteg)
    grad_cbox_stokes()
    tf32_grad_cbox(cscene)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "wrapper_ms", "ms_by", "plain_ms", "bound_ms", "bound_by",
            "measured_bound_ms", "measured_bound_by", "library_ms")
    kernels = []
    for r in rows:
        own = (p_res["launches"] if PACKET_LAUNCHES[r["name"]]
               else m_res["launches"] if MESH_LAUNCHES[r["name"]]
               else tool_launches if r["name"] in TOOL_KERNELS
               else mask_launches if r["name"] in MASK_KERNELS
               else sweep_launches if r["name"] in SWEEP_KERNELS
               else macc_launches if r["name"] in MACC_KERNELS
               else mfu_launches if r["name"] in MFU_KERNELS
               else grad_launches if r["name"] == "grating_lobe_sum_bwd"
               else g_res["launches"])
        r = dict(r, launches=own[r["name"]], **measured_bound(r, roofs))
        if r["name"] == "grating_lobe_sum":
            # B4's recording instance runs on the gradient path only
            r["record_launches"] = grad_launches["grating_lobe_sum_record"]
        row = {k: r[k] for k in keys}
        row.update({k: r[k] for k in ("test_fmas", "bound_cuda_cores_ms",
                                      "max_err_of_largest", "record_ms",
                                      "record_launches",
                                      "vjp_bound_ms", "vjp_bound_by",
                                      "bound_full_test_ms",
                                      "bound_filter_ms",
                                      "candidates_per_ray", "step_sass",
                                      "test_sass")
                    if k in r})
        kernels.append(row)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
