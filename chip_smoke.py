"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. environment: the card's name and power limit; the CUDA kernels'
     sources are built from wgsparkl_tpu_torch/csrc, one nvcc each,
     all started together (set-up), and the ptxas reports of kernels G, I
     and E printed;
  2. the 3D main path at full size (sand_box_3d with the paddle, 1,002,001
     particles, 4 x 8 x 4 blocks, 1024 particles per job): one warm frame of
     20 substeps, then timed frames; no job-table overflow in any frame,
     finite positions, and every kernel of the path (A-E) launched by that
     run, and the job-gate histogram of one more substep; then the same
     with `fold_vel` (the grid update inside kernel B; 2 timed frames);
  3. the 3D collider-free path at full size (the same lattice, models and
     grid with no body, spinning at 1 rad/s about its vertical centre
     line), the same checks for its kernels (F, B, C, D, E);
  4. the 2D path at full size (sand_column_2d, 490,000 particles, 8 x 8
     blocks, 512 particles per job): one warm frame of 10 substeps, then
     timed frames, with the same checks for its kernels (G, H, I, the dim=2
     entry of C, and D, E); a replayed frame of the 3D and of the 2D main
     path held to CUPTI's record of it (`replay_traced`: each kernel's
     launches, those the host issued plus those inside the frame graph's
     replay, as CUPTI counts them, and the same kernels and state as the
     eager frame); again with `fold_vel` (inside kernel I);
     path 6, the same column stirred at its foot by a kinematic ball and a
     kinematic capsule (`full_scene_stirred_2d`), in the dense CDF mode its
     moving colliders take (the node CDF on all 2.99M nodes every substep)
     and chan-free (2 timed frames each, job-gate histograms); then the 2D
     neo-Hookean path at full size (elastic_blocks_2d, 490,000 particles,
     15 substeps a frame), and the column on cells three times as wide (36
     particles a cell, group 2048: kernel H's jobs span several of its
     chunks; 2 timed frames); path 7 (examples/sand2.py at SCALE=1:
     490,000 particles, floor and walls, three kinematic stirrers and two
     dynamic plates, `sand2_scene`: the port's runner's `build`) and path
     8 (the 3D main path with two dynamic plates on the sand,
     `full_scene_plates`), one warm and 2 timed frames each: the same
     checks, exactly one rigid-solve launch a substep, the plates moved,
     finite body states, and path 7's rigid update of a substep run again
     under torch.cuda.set_sync_debug_mode("error"); paths 9-11, the mesh
     colliders (`cut2_scene`, `cut3_scene`, `hf3_scene`, the runners'
     `build`: examples/elastic_cut2.py, elastic_cut3.py and
     heightfield3.py at SCALE=1, 490,000, 75,000 and 202,500 particles),
     one warm and 2 timed frames
     each: the same checks, exactly one mesh_cdf launch a substep and a
     mesh pass with finite keys; path 12, the sparse domain at full size
     (bench.py's BENCH_SPARSE=1 run: the main path's lattice, 4^3 blocks,
     group 1024, max_jobs = kmax 2688, amax 10752, the CDF mode the
     construction-time pick chooses), one warm and 2 timed frames: the
     same checks (no job, occupied-block or active-slot overflow), and the
     most occupied and active blocks of a substep (StepDiag); path 12b,
     path 11 built sparse, one warm and 2 timed frames: the same checks
     and exactly one slot-addressed mesh_cdf launch a substep; paths 13
     and 13b, the main path's scene (its 1,002,001 particles, five static
     walls, the kinematic paddle, 20 substeps) and the 2D column (490,000
     particles, 10 substeps) on the dense transfer (`dense_scene`,
     `dense_scene_2d`: the row-major grid), path 13w, path 13 with one
     material a particle (`wide_scene`: kernel C's [16, M] material
     table, M past 10^6), and path 14, the main scene on
     the blocked transfer (4^3 blocks, group 256, the automatic job
     table), one warm and 2 timed frames each: finite positions, exactly
     one launch each of dense_pcdf, dense_p2g and dense_g2p a substep,
     steps/s, and on path 14 its live jobs within max_jobs (a host check);
     path 16, examples/dam_break3.py at SCALE 1.25 (BASELINE config 3:
     250,000 fluid and 15,625 elastic particles, five static walls, by 8,
     group 1024, 20 substeps; `dam_break_path`) through the port's user
     surfaces: the runner's build, a warm frame through MpmPipeline.step,
     2 timed frames through Testbed.run, no StepDiag fault and a healthy
     diagnostics.check after every frame, kernels A-E launched, steps/s;
     a Testbed frame equal to a step_pallas frame from the same state, a
     checkpoint of the full-size state saved, loaded and stepped bit for
     bit, prep_instances finite in all six modes, the last frame's PLY
     (both in a temporary directory), time_passes and one frame under
     utils/profiling.profile_step (device time, idle share);
     path 17 (`substep_paths`), the one-substep entry points at full
     size: from the state of a warm frame, 20 calls of substep_pallas on
     the main path's scene, of substep on path 13's and of substep_blocked
     on path 14's, each against one frame of 20 substeps (step_pallas,
     step_dense) from the same state: ids and affinity words equal,
     floats within compare_states' tolerances (the largest differences
     and whether every leaf is bit-equal printed), each kernel of the
     path launched once a call, and the wall of a call against the
     frame's over 20; then time_passes on path 13's state (the struct-form
     node_cdf, p2g, g2p and particle_update, 11 launches each);
     paths 15-15d, multi-device stepping (`parallel_paths`), the ranks
     spawned processes sharing the card through gloo (each buffer staged
     through pinned host memory; again on NCCL, a card a rank, where the
     machine has one a rank), each printing its backend and world size:
     15, the main scene padded to 1,002,004 lanes and particle-sharded over
     4 ranks; 15b, the main scene in 4 x slabs on its grid widened to 112
     x-nodes; 15c, the 2D column in 2 slabs; 15d, path 12 in 4 slabs
     (halo_cap 2048, the peak boundary plane printed); one substep, then
     the rest of a frame: no StepDiag fault on any rank, every live
     particle kept, bodies bit-equal across ranks, every kernel launched,
     after the substep the gathered state within 1e-5 in position and
     1e-4 in velocity of the unsharded step on the same grid (the frame's
     difference printed), steps/s labelled as a correctness run;
  5. each kernel against its plain PyTorch version at full size, on the
     inputs of a substep of each scene with its lattice lowered into a
     collider (onto the paddle in 3D, 1.5 cells into the floor in 2D), so
     that the CPIC impulses carry load, of the collider-free scene (F) and
     of the 2D neo-Hookean scene (C-2D's neo-Hookean branch); C's 3D
     neo-Hookean branch on the 3D inputs; A and B on a substep of path 5
     lowered onto its capsule, in each CDF mode (entries `*_shapes` and
     `*_chan_free`; tiles, affinity rows and per-particle rows bit for
     bit); B and I with `fold_vel` on the lowered inputs (`g2p_fold`,
     `g2p2d_fold`) and G, H and I on path 6 lowered into the floor in the
     chan-free mode (`*2d_chan_free`), bit for bit, and G on path 6
     lowered in the dense mode (`pcdf2d_dense`); G on its particle-CDF
     rows and on the sorted rows it patches in place, as the 2D substep
     calls it; H on a substep of the
     neo-Hookean path (`p2g2d_neo`) and on the 36-particle-a-cell column
     lowered into its floor (`p2g2d_chunks`), bit for bit; B's main entry
     (`g2p`) bit for bit too; E on eleven edge cases (no flag, every flag,
     more flags than cap, below one tile, a million lanes, R = 1 and 2)
     bit for bit; the in-kernel math probe and its table; the
     P2G ablation probe at the TPU probe's sizes (1,002,001
     particles, 1300 live jobs of 1536): its four stages for its three
     node-side cores (scan, lists, pairs), each stage's time, each core's
     full stage equal to its plain version bit for bit; each kernel with
     its stated tolerance, its time and its bound (CUDA events); beside
     kernel C, the share of lanes and of 32-lane warps whose F the
     Drucker-Prager return map replaced (such a warp runs C's second SVD);
     the rigid solve bit for bit on a substep of path 7 and of path 8 with
     the plates pressed into the floor and into each other (active
     dynamic-static and dynamic-dynamic contacts) and on the JAX
     package's joint scenes (30 chained rigid updates each, the kernel path
     equal to the plain path); kernel C's fracture branch at full size
     with four materials (the 3D lattice spinning on the paddle, the 2D
     elastic blocks in their floor; affinity and phase rows bit for bit);
     the mesh pass (kernel mesh_cdf) on a substep of paths 10 and 9 with
     the block lowered onto the blades and of path 11 (`mesh_cdf`,
     `mesh_cdf2d`, `mesh_cdf_heightfield`: keys and affinity words bit
     for bit), and A and H on those substeps' mesh tiles (`p2g_cdf_mesh`,
     `p2g2d_mesh`, bit for bit); A, B and C on a substep of path 12 with
     its lattice lowered onto the paddle (`p2g_cdf_sparse`, `g2p_sparse`,
     `update_rows_sparse`: tiles, impulses and every row bit for bit),
     and the mesh pass's slot-addressed entry on a substep of path 11
     built sparse with its lattice lowered onto the heightfield
     (`mesh_cdf_sparse`, keys and words bit for bit); the dense transfer's
     kernels on a substep of path 13 lowered onto the paddle and of path
     13b lowered 1.5 cells into its floor (`dense_pcdf`, `dense_p2g`,
     `dense_g2p` and their `*2d` entries: every output bit for bit, P2G's
     grid part beside `index_put_(accumulate=True)` under
     torch.use_deterministic_algorithms(True)); kernel C on a substep of
     path 13w lowered onto the paddle (`update_rows_wide`: one material a
     particle, every row bit for bit); the struct forms on path 13
     lowered (`p2g_struct`, `g2p_struct`: ops/transfer.p2g and g2p over
     dense_p2g and dense_g2p; `particle_update_struct`: kernel C reading
     the rigid velocity from the rows, on g2p's outputs), each against the
     same function with its kernel swapped for the plain version, every
     output bit for bit; A, F and H beside the same
     call on their (particle, node) pairs (`tile_pairs_library`); the
     window scatter's pull on the recorded substeps of the lowered 3D main
     path and 2D column (`scatter_pull`, `scatter_pull2d`: every grid row,
     the ghost's included, bit for bit against the plain version and
     `add_rows` into zeros, the library yardstick, the mass channel against
     the substep's own grid;
     the sparse paths must launch none); every
     kernel of paths 15-15d on the rows of one rank (`record_rank`:
     `*_sharded`, `*_spatial`, `*_spatial2d`, `*_spatial_sparse`; 2D:
     kernel I's premise after the second sort);
  5. (path 5) the 3D analytic-shapes path at full size: the main path's
     lattice, models, grid and job table with a static halfspace floor,
     the four static side walls, a kinematic capsule paddle and a kinematic
     ball (`shapes_scene`), once in the gathered-hybrid CDF mode, which the
     construction-time heuristic must pick, and once in the chan-free mode
     (fewer frames); steps/s and the job-gate histogram of each;
  6. the kernel path against the plain path on small scenes (3D: 10
     substeps of the sand box, 5 of a lattice lowered onto the paddle, 10
     of the collider-free lattice and of the neo-Hookean sand box; 2D: 10
     substeps of the sand column, the elastic blocks and the collider-free
     column; 5 substeps each of the analytic-shapes scene lowered onto its
     capsule in both CDF modes, of the 16-collider scene, of a scene whose
     colliders all move and of the 2D sand column stirred by a kinematic
     ball and capsule; `fold_vel`: 10 substeps each of the sand box, the
     collider-free lattice and the 2D sand column; the 2D chan-free mode: 5
     substeps of the stirred column and of the column lowered into its
     floor, folded too, each with gated jobs; dynamic bodies: 5 substeps of
     a small sand2 with its plates pressed into the floor and each other
     and of the 3D lattice on a dynamic plate held by a ball joint; 5
     substeps each of four materials with fracture in 3D and 2D; mesh
     colliders: 5 substeps each of the trimesh ramp and cuboid floor at by
     4 and by 8, the 2D polyline tent, a kinematic spinning trimesh paddle
     in the sand box and the smallest elastic_cut3 block pressed onto its
     blades with fracture; the sparse domain: 10 substeps of the sand box
     and of tests/test_sparse_domain.py's ballistic spray, 5 of its
     trimesh ramp, of the sand box at kmax 8, amax 16, whose overflow
     must be reported, and of the sand box lowered onto its floor and
     paddle in the chan-free mode, with gated jobs; the dense and blocked
     transfers: 10 substeps of the dense sand box and of the dense 2D
     column, 5 of the CPIC oracle scene with its dynamic plate, of the
     dense trimesh ramp and of tests/test_blocked.py's box with bodies on
     the blocked transfer at max_jobs 8; 3 substeps each of the
     256-material lattice (each particle its own lambda) in 2D and on a
     floor in 3D, dense and blocked): 40 scenes, equal bit for bit to
     the plain path on the card, and within tolerance of the plain path on
     the CPU (affinity
     words exact); then the sand box built sparse and bounded at by 4, 20
     substeps on the card, within tests/test_sparse_domain.py's tolerances
     (whether they are bit-equal is printed); then five 2-rank scenes
     (`parallel_small_scenes`: particle-sharded pallas and dense sand
     boxes, the spatial 3D lattice, 2D column and sparse lattice with
     lateral velocities, migrants landing), the kernel path equal to the
     plain path bit for bit on every rank.
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

SUBSTEPS = 20
TIMED_FRAMES = 3
# Path 5 in the chan-free mode, the folded runs and path 6.
TIMED_FRAMES_SHORT = 2
NXZ, NY = 77, 169           # 1,002,001 particles (the reference bench sizing)
BY, GROUP = 8, 1024
# The 2D throughput scene: sand_column_2d at 700 x 700 (490,000 particles),
# the sizing of tools/profile_bench.py and tools/measure_configs.py.
NX2, NY2, H2, GROUP2, SUBSTEPS2 = 700, 700, 0.2, 512, 10
# The 2D neo-Hookean scene: elastic_blocks_2d at 700 x 700 (490,000
# particles), BASELINE config 1's constitutive model, 15 substeps a frame.
SUBSTEPS_NEO2 = 15
# Path 6: the 2D throughput scene stirred by a kinematic ball and capsule,
# placed as on the small column (sand_column_2d(nx=24, ny=48, cell width
# 0.5): 6 wide) and scaled by the full column's width (140 cells of 0.2).
STIR_SCALE = NX2 * H2 / (24 * 0.5)
# Path 7: examples/sand2.py at SCALE = N_SAND2 / 700 (700 x 700 particles).
N_SAND2 = 700
# Path 9: examples/elastic_cut2.py at SCALE = N_CUT2 / 700 (700 x 700
# particles); paths 10 and 11 (elastic_cut3, heightfield3) at SCALE =
# CUT3_SCALE, HF3_SCALE.  The port's runners build them.
N_CUT2, CUT3_SCALE, HF3_SCALE = 700, 1.0, 1.0
# The small sand2 of phase 6: the runner's smallest lattice (48 x 48).
SAND2_SMALL = 48 / 700
SUBSTEPS_CUT2 = 15
# Path 16: examples/dam_break3.py at SCALE 1.25 (BASELINE config 3, "~256k
# particles, mixed constitutive models"): 250,000 fluid and 15,625 elastic
# particles, by 8, group 1024, 20 substeps a frame.
DAM_SCALE = 1.25
DEVICE = "cuda:0"
# The H100 SXM's published peaks (fp32 outside the tensor cores, HBM3).
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# f32 operations of one collider's CDF at one node (transfer.cuh
# collider_cdf: two quaternion rotations, the projection, reach, distance).
CDF_OPS = 90
# The same for one 2D collider (transfer2d.cuh collider_cdf2: two 2D
# rotations, the projection, reach, distance).
CDF_OPS_2D = 40

# TPU kernel each CUDA kernel replaces (the pallas_call site).
REPLACES = {
    "p2g_cdf": "wgsparkl_tpu/ops/pallas_cdf.py:517",
    "g2p": "wgsparkl_tpu/ops/pallas_transfer.py:987",
    "update_rows": "wgsparkl_tpu/ops/update_rows.py:191",
    "permute": "wgsparkl_tpu/ops/permute.py:216",
    "compact": "wgsparkl_tpu/ops/compact.py:102",
    "pcdf2d": "wgsparkl_tpu/ops/pallas_transfer2d.py:820",
    "p2g2d": "wgsparkl_tpu/ops/pallas_transfer2d.py:402",
    "g2p2d": "wgsparkl_tpu/ops/pallas_transfer2d.py:584",
    "update_rows2d": "wgsparkl_tpu/ops/update_rows.py:191",
    "p2g": "wgsparkl_tpu/ops/pallas_transfer.py:723",
    "update_rows_neo_hookean": "wgsparkl_tpu/ops/update_rows.py:191",
    "update_rows2d_neo_hookean": "wgsparkl_tpu/ops/update_rows.py:191",
    "math_probe": "tools/probe_mosaic_math.py:44",
    "p2g_ablation": "tools/ablate_kernels.py:106",
    "p2g_cdf_shapes": "wgsparkl_tpu/ops/pallas_cdf.py:517",
    "g2p_shapes": "wgsparkl_tpu/ops/pallas_transfer.py:987",
    "p2g_cdf_chan_free": "wgsparkl_tpu/ops/pallas_cdf.py:517",
    "g2p_chan_free": "wgsparkl_tpu/ops/pallas_transfer.py:987",
    "g2p_fold": "wgsparkl_tpu/ops/pallas_transfer.py:987",
    "g2p2d_fold": "wgsparkl_tpu/ops/pallas_transfer2d.py:584",
    "pcdf2d_chan_free": "wgsparkl_tpu/ops/pallas_transfer2d.py:820",
    "pcdf2d_dense": "wgsparkl_tpu/ops/pallas_transfer2d.py:820",
    "p2g2d_chan_free": "wgsparkl_tpu/ops/pallas_transfer2d.py:402",
    "g2p2d_chan_free": "wgsparkl_tpu/ops/pallas_transfer2d.py:584",
    "p2g2d_neo": "wgsparkl_tpu/ops/pallas_transfer2d.py:402",
    "p2g2d_chunks": "wgsparkl_tpu/ops/pallas_transfer2d.py:402",
    "update_rows_fracture": "wgsparkl_tpu/ops/update_rows.py:191",
    "update_rows2d_fracture": "wgsparkl_tpu/ops/update_rows.py:191",
    # Port-only: the JAX package's rigid solve is plain XLA (a lax.scan of
    # contact impulses and the joint sweeps), no pallas_call.
    "rigid_solve": "wgsparkl_tpu/rigid/contacts.py:183",
    "rigid_solve_3d": "wgsparkl_tpu/rigid/contacts.py:183",
    "rigid_solve_joints": "wgsparkl_tpu/rigid/joints.py:168",
    # Port-only: the JAX package's mesh node-CDF pass is plain XLA (a
    # lax.scan over a sample job table with scatter-min/max), no pallas_call.
    "mesh_cdf": "wgsparkl_tpu/ops/rigid_cdf.py:89",
    "mesh_cdf_heightfield": "wgsparkl_tpu/ops/rigid_cdf.py:89",
    "mesh_cdf2d": "wgsparkl_tpu/ops/rigid_cdf.py:89",
    "p2g_cdf_mesh": "wgsparkl_tpu/ops/pallas_cdf.py:517",
    "p2g2d_mesh": "wgsparkl_tpu/ops/pallas_transfer2d.py:402",
    # The sparse domain (path 12): A, B and C on slot-addressed tiles, and
    # the mesh pass's slot-addressed entry (the JAX package's
    # mesh_node_cdf_sparse, plain XLA).
    "p2g_cdf_sparse": "wgsparkl_tpu/ops/pallas_cdf.py:517",
    "g2p_sparse": "wgsparkl_tpu/ops/pallas_transfer.py:987",
    "update_rows_sparse": "wgsparkl_tpu/ops/update_rows.py:191",
    "mesh_cdf_sparse": "wgsparkl_tpu/ops/rigid_cdf.py:235",
    # Port-only: the JAX package's dense transfer is plain XLA (a gather
    # and a scatter-add over (particle, stencil node) pairs), no pallas_call.
    "dense_pcdf": "wgsparkl_tpu/collision/cdf.py:166",
    "dense_p2g": "wgsparkl_tpu/ops/transfer.py:51",
    "dense_g2p": "wgsparkl_tpu/ops/transfer.py:132",
    "dense_pcdf2d": "wgsparkl_tpu/collision/cdf.py:166",
    "dense_p2g2d": "wgsparkl_tpu/ops/transfer.py:51",
    "dense_g2p2d": "wgsparkl_tpu/ops/transfer.py:132",
    # Kernel C on the dense transfer with one material a particle (path
    # 13w): the material table [16, M] past the pallas path's 128 lanes.
    "update_rows_wide": "wgsparkl_tpu/ops/update_rows.py:191",
    # The JAX package's struct forms (plain XLA) over the port's kernels:
    # ops/transfer.p2g and g2p (dense_p2g, dense_g2p) and
    # ops/particle_update.particle_update (kernel C, `rv_rows`).
    "p2g_struct": "wgsparkl_tpu/ops/transfer.py:52",
    "g2p_struct": "wgsparkl_tpu/ops/transfer.py:128",
    "particle_update_struct": "wgsparkl_tpu/ops/particle_update.py:28",
    # Port-only: the JAX package's window scatter is plain XLA (one-hot
    # matmuls, banded or whole, picked by scatter_tiles_auto), no pallas_call.
    "scatter_pull": "wgsparkl_tpu/pipeline.py:783",
    "scatter_pull2d": "wgsparkl_tpu/pipeline.py:783",
}
SOURCE = {"update_rows2d": "update_rows", "update_rows_neo_hookean": "update_rows",
          "update_rows2d_neo_hookean": "update_rows", "p2g_cdf_shapes": "p2g_cdf",
          "p2g_cdf_chan_free": "p2g_cdf", "g2p_shapes": "g2p", "g2p_chan_free": "g2p",
          "g2p_fold": "g2p", "g2p2d_fold": "g2p2d", "pcdf2d_chan_free": "pcdf2d",
          "pcdf2d_dense": "pcdf2d", "p2g2d_chan_free": "p2g2d", "g2p2d_chan_free": "g2p2d",
          "p2g2d_neo": "p2g2d", "p2g2d_chunks": "p2g2d",
          "update_rows_fracture": "update_rows", "update_rows2d_fracture": "update_rows",
          "rigid_solve_3d": "rigid_solve", "rigid_solve_joints": "rigid_solve",
          "mesh_cdf_heightfield": "mesh_cdf", "mesh_cdf2d": "mesh_cdf",
          "p2g_cdf_mesh": "p2g_cdf", "p2g2d_mesh": "p2g2d",
          "p2g_cdf_sparse": "p2g_cdf", "g2p_sparse": "g2p",
          "update_rows_sparse": "update_rows", "mesh_cdf_sparse": "mesh_cdf",
          "dense_pcdf2d": "dense_pcdf", "dense_p2g2d": "dense_p2g",
          "dense_g2p2d": "dense_g2p", "update_rows_wide": "update_rows",
          "p2g_struct": "dense_p2g", "g2p_struct": "dense_g2p",
          "particle_update_struct": "update_rows", "scatter_pull2d": "scatter_pull"}
# The rows of the [PCHAN, NPAD] input matrix that kernel C reads (csrc/
# update_rows.cu, update_kernel and update2d_kernel); it replaces the others
# with G2P rows, particle-CDF rows or new values.
C_ROWS_READ_3D = (*range(0, 3), 6, *range(21, 40), *range(44, 48))
C_ROWS_READ_2D = (0, 1, 4, *range(13, 24), *range(27, 32))
# The sparse domain's paths keep the slot scatter (add_rows); the bounded
# ones scatter through kernel scatter_pull.
KERNELS_SPARSE = ("p2g_cdf", "g2p", "update_rows", "permute", "compact")
KERNELS_3D = KERNELS_SPARSE + ("scatter_pull",)
KERNELS_2D = ("pcdf2d", "p2g2d", "g2p2d", "update_rows2d", "permute", "compact",
              "scatter_pull")
KERNELS_FREE = ("p2g", "g2p", "update_rows", "permute", "compact", "scatter_pull")
KERNELS_7 = KERNELS_2D + ("rigid_solve",)
KERNELS_8 = KERNELS_3D + ("rigid_solve",)
KERNELS_9 = KERNELS_2D + ("mesh_cdf",)
KERNELS_10 = KERNELS_3D + ("mesh_cdf",)
# Paths 13, 13b (the dense transfer) and 14 (the blocked transfer).
KERNELS_DENSE = ("dense_pcdf", "dense_p2g", "dense_g2p", "update_rows")
KERNELS_DENSE_2D = ("dense_pcdf", "dense_p2g", "dense_g2p", "update_rows2d")
KERNELS_BLOCKED = KERNELS_DENSE + ("permute", "compact")
# Path 12: bench.py's BENCH_SPARSE=1 run (its lines 104-154): the main
# path's lattice in the sparse domain, 4^3 blocks, group 1024, its job
# table (n // 400 + 256) // 128 * 128 and the defaults kmax = max_jobs,
# amax = 4 kmax.
BY_SPARSE = 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def launches_run(wt) -> dict:
    """{kernel: its launches since the counts were reset}: those the host
    issued (wt.launch_counts) and those inside frame-graph replays
    (wt.replayed_launch_counts: a replay runs what its capture issued,
    which replay_traced holds to CUPTI's record of a replayed frame)."""
    host, replayed = wt.launch_counts(), wt.replayed_launch_counts()
    return {k: host[k] + replayed[k] for k in host}


def launches_split(wt, kernels) -> str:
    """The launches of `kernels` the host issued and those inside replays,
    labelled, for a report line."""
    host, replayed = wt.launch_counts(), wt.replayed_launch_counts()
    return (f"host-issued { {k: host[k] for k in kernels} }, in graph replays "
            f"{ {k: replayed[k] for k in kernels} }")


def ptxas_reports(_cuda, kernels):
    """Start nvcc with `_cuda.NVCC_FLAGS` plus -Xptxas -v on copies of the
    sources named in kernels {source: entry kernel}, into _build/ptxas/ (the
    kernels' own builds stay unhashed by -v); returns a function that waits
    and gives each kernel's ptxas lines (registers, stack frame, spills)."""
    out_dir = _cuda._BUILD / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_cuda._SRC),
         "-o", str(out_dir / f"lib{name}.so"), str(_cuda._SRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in kernels}

    def wait():
        lines = {}
        for name, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                fail(f"nvcc -Xptxas -v failed for {name}.cu:\n{err}")
            keep, lines[name] = False, []
            for line in err.splitlines():
                if "Compiling entry function" in line:
                    keep = kernels[name] in line
                elif keep and ("bytes stack frame" in line or "Used" in line):
                    lines[name].append(line.strip())
        return lines

    return wait


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move nbytes and do flops f32 operations."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def c_cost(rows_read, krows, pcdf_rows, pchan, npad, ce, flops_per_lane):
    """(bytes, flops) of kernel C: on every lane it reads rows_read of the
    row matrix and the sorted id and writes all pchan rows; only the ce
    covered lanes read their krows G2P rows and pcdf_rows particle-CDF
    rows."""
    return (4 * ((len(rows_read) + 1 + pchan) * npad + (krows + pcdf_rows) * ce),
            ce * flops_per_lane)


def compact_edge_cases(compact, dev) -> None:
    """Kernel E bit for bit against its plain version and a second launch:
    N below one 16384-lane tile and over 61 of them, a multiple of 1024 and
    not, no flag, every flag, more flags than cap, R = 1 and 2, and a flag
    view off a 16-byte boundary (tests/test_torch_permute_compact.py's
    cases and a million lanes)."""
    import numpy as np

    rng = np.random.default_rng(6)
    cases = [(0.01, 8192, 300, 2), (0.05, 8192, 300, 2), (0.0, 8192, 300, 2),
             (1e-3, 10_000, 300, 1), (0.05, 700, 300, 2), (1.0, 3000, 4000, 2),
             (0.05, 8192, 100, 1), (1.0, 5000, 1000, 1), (1e-3, 1_000_003, 9000, 1),
             (1.0, 1_000_003, 20_000, 2), (0.3, 5001, 6000, 1)]
    for density, n, cap, r in cases:
        vals = torch.as_tensor(rng.integers(0, 2 ** 24, (r, n)).astype(np.float32),
                               device=dev)
        flag = torch.as_tensor(rng.random(n) < density, device=dev)
        if n == 5001:
            vals, flag = vals[:, 1:].contiguous(), flag[1:]
        k, again = compact.compact_flagged(vals, flag, cap), compact.compact_flagged(
            vals, flag, cap)
        p = compact.compact_plain(vals, flag, cap)
        for a, b in ((k, p), (k, again)):
            if not (torch.equal(a[0], b[0]) and bool(a[1]) == bool(b[1])):
                fail(f"compact: edge case (density {density}, N {n}, cap {cap}, "
                     f"R {r}) differs from the plain version or a second launch")
    print(f"compact: {len(cases)} edge cases equal to the plain version and a "
          "second launch bit for bit", flush=True)


@contextlib.contextmanager
def plain_versions():
    """Route both paths' kernel calls to their plain versions (on any
    device) for the duration of the block, the frame graphs dropped on both
    sides."""
    from wgsparkl_tpu_torch import pipeline
    from wgsparkl_tpu_torch.collision import cdf
    from wgsparkl_tpu_torch.ops import (
        blocked, compact, g2p, p2g, p2g_cdf, permute, rigid_cdf, transfer, transfer2d,
        update_rows,
    )
    from wgsparkl_tpu_torch.rigid import solve

    swaps = [(pipeline, "rigid_solve", solve.rigid_solve_plain),
             (pipeline, "dense_pcdf", cdf.pcdf_rows_plain),
             (pipeline, "dense_p2g", transfer.p2g_plain),
             (pipeline, "dense_g2p", transfer.g2p_plain),
             (rigid_cdf, "mesh_node_cdf", rigid_cdf.mesh_node_cdf_plain),
             (rigid_cdf, "mesh_node_cdf_sparse", rigid_cdf.mesh_node_cdf_sparse_plain),
             (pipeline, "p2g_cdf_tiles", p2g_cdf.p2g_cdf_plain),
             (pipeline, "p2g_tiles", p2g.p2g_plain),
             (pipeline, "g2p_rows", g2p.g2p_plain),
             (pipeline, "update_rows", update_rows.update_plain),
             (pipeline, "permute_lanes", permute.permute_plain),
             (compact, "compact_flagged", compact.compact_plain),
             (blocked, "scatter_tiles_pull", blocked.scatter_tiles_pull_plain),
             (pipeline, "pcdf_rows2d", transfer2d.pcdf_plain),
             (pipeline, "p2g_tiles2d", transfer2d.p2g_plain),
             (pipeline, "g2p_rows2d", transfer2d.g2p_plain),
             (pipeline, "update_rows2d", update_rows.update2d_plain)]
    saved = [getattr(m, a) for m, a, _ in swaps]
    pipeline.drop_frame_graphs()    # a graph replays what its capture called
    for m, a, f in swaps:
        setattr(m, a, f)
    try:
        yield
    finally:
        for (m, a, _), f in zip(swaps, saved):
            setattr(m, a, f)
        pipeline.drop_frame_graphs()


def full_scene(dev, **mpm_kw):
    """The 3D main path at full size: 1,002,001 particles."""
    from wgsparkl_tpu_torch import scenes

    n_est = NXZ * NXZ * NY
    max_jobs = (n_est // (100 * BY) + 256) // 128 * 128
    return scenes.sand_box_3d(nxz=NXZ, ny=NY, cell_width=1.0, with_paddle=True,
                              device=dev, by=BY, group=GROUP, max_jobs=max_jobs,
                              **mpm_kw)


def full_scene_sparse(dev, **mpm_kw):
    """Path 12: the main path's 1,002,001 particles in the sparse domain,
    sized as bench.py sizes its BENCH_SPARSE=1 run."""
    from wgsparkl_tpu_torch import scenes

    n_est = NXZ * NXZ * NY
    max_jobs = (n_est // (100 * BY_SPARSE) + 256) // 128 * 128
    return scenes.sand_box_3d(nxz=NXZ, ny=NY, cell_width=1.0, with_paddle=True,
                              device=dev, by=BY_SPARSE, group=GROUP,
                              max_jobs=max_jobs, sparse=True, **mpm_kw)


def spray_scene(device):
    """tests/test_sparse_domain.py's ballistic spray: a 6^3 lattice of
    elastic-plastic particles (E 1e5) at 12 m/s in random directions from
    numpy default_rng(0), no collider, no gravity, cell 0.5, dt 0.02, on a
    nominal 4-unit grid it soon leaves (sparse, group 64)."""
    import numpy as np

    from wgsparkl_tpu_torch.grid import GridConfig
    from wgsparkl_tpu_torch.models import DruckerPrager, ElasticCoefficients
    from wgsparkl_tpu_torch.models.drucker_prager import drucker_prager_arrays
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData
    from wgsparkl_tpu_torch.solver import Models, Particles

    rng = np.random.default_rng(0)
    pos = np.stack(np.meshgrid(*([np.arange(6) * 0.5] * 3), indexing="ij"),
                   -1).reshape(-1, 3) + 1.0
    n = len(pos)
    vel = rng.normal(size=(n, 3)) * 12.0
    elast = ElasticCoefficients.from_young_modulus(1.0e5, 0.2)
    dpm = drucker_prager_arrays([DruckerPrager.new(1.0e5, 0.2)])
    models = Models.from_arrays(n, elast.lam, elast.mu,
                                dp={k: np.full(n, v[0]) for k, v in dpm.items()},
                                device=device)
    p = Particles.from_arrays(pos.astype(np.float32), density=1000.0, radius=0.25,
                              device=device)
    p = dataclasses.replace(p, vel=torch.as_tensor(vel.astype(np.float32),
                                                   device=p.pos.device))
    return MpmData(SimulationParams.new(2e-2, np.zeros(3), device=device), p,
                   models, [], 0.5,
                   grid=GridConfig.from_bounds(np.zeros(3), np.full(3, 4.0), 0.5),
                   group=64, sparse=True)


def dense_scene(dev, **mpm_kw):
    """Paths 13 (transfer="dense") and 14 ("blocked"): the main path's scene,
    sand_box_3d(nxz=77, ny=169, with_paddle=True), 1,002,001 particles, on
    the row-major grid (4^3 blocks for the blocked sort, the JAX package's
    group 256 and automatic job table)."""
    from wgsparkl_tpu_torch import scenes

    return scenes.sand_box_3d(nxz=NXZ, ny=NY, cell_width=1.0, with_paddle=True,
                              device=dev, **mpm_kw)


def dense_scene_2d(dev, **mpm_kw):
    """Path 13b: the 2D throughput column (490,000 particles) on the dense
    transfer."""
    from wgsparkl_tpu_torch import scenes

    return scenes.sand_column_2d(nx=NX2, ny=NY2, cell_width=H2, device=dev,
                                 transfer="dense", **mpm_kw)


def cpic_scene(device, plate=True):
    """tests/test_cpic_oracle.py's scene on the dense transfer: an elastic
    and sand block on a static floor pushed by a kinematic wall, under a
    dynamic plate (two-way coupled, no body contacts)."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.grid import GridConfig
    from wgsparkl_tpu_torch.models import ElasticCoefficients
    from wgsparkl_tpu_torch.models.drucker_prager import (
        DruckerPrager, drucker_prager_arrays,
    )
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    rng = np.random.default_rng(3)
    xs, ys, zs = np.arange(8) * 0.25 - 1.0, np.arange(5) * 0.25 + 0.15, np.arange(6) * 0.25 - 0.7
    pos = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    pos = (pos + rng.uniform(-0.02, 0.02, pos.shape)).astype(np.float32)
    n = len(pos)
    elast = ElasticCoefficients.from_young_modulus(5.0e5, 0.2)
    dp = {k: np.full(n, v[0]) for k, v in drucker_prager_arrays(
        [DruckerPrager.new(5.0e5, 0.2)]).items()}
    bodies = [RigidBodyDesc(Collider.cuboid(4.0, 0.5, 4.0), (0.0, -0.5, 0.0)),
              RigidBodyDesc(Collider.cuboid(0.25, 1.5, 2.0), (-1.6, 1.0, 0.0),
                            body_type="kinematic", linvel=(0.4, 0.0, 0.0))]
    if plate:
        bodies.append(RigidBodyDesc(Collider.cuboid(0.5, 0.25, 0.5), (0.4, 1.72, -0.2),
                                    body_type="dynamic", density=400.0))
    return MpmData(SimulationParams.new(1e-3, [0.0, -9.81, 0.0], device=device),
                   Particles.from_arrays(pos, density=1200.0, radius=0.125, device=device),
                   Models.from_arrays(n, elast.lam, elast.mu, dp=dp,
                                      phase=(pos[:, 0] > 0.0).astype(np.float32),
                                      device=device),
                   bodies, 0.5, grid=GridConfig.from_bounds(
                       np.array([-4.0, -2.0, -4.0]), np.array([4.0, 4.0, 4.0]), 0.5),
                   transfer="dense", body_contacts=False)


def blocked_box(device):
    """tests/test_blocked.py's 3D scene with bodies (512 jittered particles
    on a static floor beside a dynamic ball, cell width 0.5) on the blocked
    transfer, group 64, at max_jobs 8: the table drops lanes."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.models import ElasticCoefficients
    from wgsparkl_tpu_torch.models.drucker_prager import (
        DruckerPrager, drucker_prager_arrays,
    )
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    h = 0.5
    rng = np.random.default_rng(0)
    xs = np.arange(8) * h / 2 + h / 4
    g = np.meshgrid(xs, xs + 1.0, xs, indexing="ij")
    pos = (np.stack([a.ravel() for a in g], -1)
           + rng.uniform(-0.05 * h, 0.05 * h, (512, 3))).astype(np.float32)
    m = ElasticCoefficients.from_young_modulus(1e6, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(1e6, 0.2)] * 512)
    return MpmData(SimulationParams.new(1 / 600, [0.0, -9.81, 0.0], device=device),
                   Particles.from_arrays(pos, density=1500.0, radius=h / 4, device=device),
                   Models.from_arrays(512, m.lam, m.mu, dp=dp, device=device),
                   [RigidBodyDesc(Collider.cuboid(10.0, 0.5, 10.0), (1.0, -0.5, 1.0)),
                    RigidBodyDesc(Collider.ball(0.8), (1.0, 0.3, 1.0), body_type="dynamic",
                                  density=500.0)],
                   h, grid_bounds=(np.array([-2.0, -1.0, -2.0]), np.array([4.0, 4.0, 4.0])),
                   transfer="blocked", group=64, job_chunk=8, max_jobs=8,
                   body_contacts=False)


def wide_scene(dev):
    """Path 13w: path 13's scene (the main scene on the dense transfer) with
    one material a particle: each particle's elastic lambda is the sand's
    times 0.9 + 0.2 k / N (k its index; f32 values 111 apart, past the f32
    spacing of 64 there), so the material table has N lanes' worth of
    materials (rounded up to a multiple of 128)."""
    import numpy as np

    from wgsparkl_tpu_torch.pipeline import MpmData

    base = dense_scene(dev, transfer="dense")
    m = base.state.models
    n = base.num_particles
    scale = torch.as_tensor(0.9 + 0.2 * np.arange(n) / n, dtype=torch.float32,
                            device=m.lam.device)
    models = dataclasses.replace(m, lam=m.lam * scale, mat_id=None, mat_table=None)
    return MpmData(base.params, base.state.particles, models, base.bodies_desc,
                   base.config.grid.cell_width, grid=base.config.grid,
                   transfer="dense")


def many_materials(device, transfer: str, dim: int):
    """The scene of the port's 128-material fault: 256 particles, each its
    own lambda (linspace(1e4, 2e4, 256)), mu 1e4, density 1000, radius
    0.0625, spacing 0.25 from 2 on each axis in [0, 8]^d, cell 0.5, dt 1e-3:
    in 2D a 16 x 16 lattice with no collider, in 3D 16 x 4 x 4 on a floor
    cuboid, strained from the start, F = diag(1.2, 0.85[, 1]), so that each
    particle's stress depends on its own material
    (tests/test_torch_many_materials.py); group 64 when blocked."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    counts = (16, 16) if dim == 2 else (16, 4, 4)
    g = np.meshgrid(*(2.0 + 0.25 * np.arange(c) for c in counts), indexing="ij")
    pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
    bodies = ([] if dim == 2 else
              [RigidBodyDesc(Collider.cuboid(10.0, 0.5, 10.0), (4.0, 1.0, 4.0))])
    kw = {} if transfer == "dense" else dict(group=64, job_chunk=8)
    gravity = [0.0, -9.81] + [0.0] * (dim - 2)
    data = MpmData(SimulationParams.new(1e-3, gravity, device=device),
                   Particles.from_arrays(pos, density=1000.0, radius=0.0625,
                                         device=device),
                   Models.from_arrays(256, np.linspace(1e4, 2e4, 256), 1e4,
                                      device=device),
                   bodies, 0.5, grid_bounds=(np.zeros(dim), np.full(dim, 8.0)),
                   transfer=transfer, **kw)
    data.state.particles.def_grad[:] = torch.diag(
        torch.tensor((1.2, 0.85, 1.0)[:dim], device=device))
    return data


def dense_paths(wt, card, kind, launches, frames=TIMED_FRAMES_SHORT):
    """Paths 13, 13w, 13b and 14 at full size: one warm and `frames` timed
    frames each, exactly one launch of each dense kernel a substep; path
    13w's material table must hold one material a particle (kernel C's
    wide table: `update_rows_wide`'s launches); path 14's live jobs must
    fit its table (a check of this script's, on the host)."""
    from wgsparkl_tpu_torch.pipeline import step_dense

    for tag, make, substeps, kernels, what in (
            ("", lambda: dense_scene(DEVICE, transfer="dense"), SUBSTEPS, KERNELS_DENSE,
             "path 13: 3D dense transfer"),
            ("_wide", lambda: wide_scene(DEVICE), SUBSTEPS, KERNELS_DENSE,
             "path 13w: 3D dense transfer, one material a particle"),
            ("2d", lambda: dense_scene_2d(DEVICE), SUBSTEPS2, KERNELS_DENSE_2D,
             "path 13b: 2D dense transfer"),
            ("_blocked", lambda: dense_scene(DEVICE, transfer="blocked"), SUBSTEPS,
             KERNELS_BLOCKED, "path 14: 3D blocked transfer")):
        data = make()
        cfg = data.config
        if cfg.transfer != ("blocked" if tag == "_blocked" else "dense"):
            fail(f"{what}: built as {cfg}")
        if tag == "_wide":
            table = tuple(data.state.models.mat_table.shape)
            if cfg.n_materials != data.num_particles or table[1] < cfg.n_materials:
                fail(f"{what}: {cfg.n_materials} materials in a {table} table")
            print(f"{what}: {cfg.n_materials} materials, material table {table}",
                  flush=True)
        counts, state = run_frames(wt, data, substeps, kernels, what, card, kind, frames)
        for k in KERNELS_DENSE[:3]:
            if counts[k] != (1 + frames) * substeps:
                fail(f"{what}: {counts[k]} {k} launches, not one a substep "
                     f"({(1 + frames) * substeps})")
        if tag == "_blocked":
            rec = {}
            step_dense(state, data.params, cfg, 1, record=rec)
            need, live = int(rec["jobs"]["needed"]), int(rec["live"])
            print(f"{what}: {need} live jobs of max_jobs {cfg.max_jobs} (group "
                  f"{cfg.group}), {live} of {data.num_particles} lanes in a live job",
                  flush=True)
            if need > cfg.max_jobs:
                fail(f"{what}: the live jobs overflow the job table")
        elif tag == "_wide":
            launches["update_rows_wide"] = counts["update_rows"]
        else:
            launches.update((f"{k}{tag}", counts[k]) for k in KERNELS_DENSE[:3])
        del data, state
        torch.cuda.empty_cache()


def _state_gaps(a, b, what):
    """Two states of the same particles: ids and affinity words equal,
    positions within 1e-5, velocities and F within 1e-4, bodies within
    1e-6 (tests/torch_port_helpers.compare_states' tolerances); prints the
    largest differences and whether every leaf is equal bit for bit.
    Particles are matched by id."""
    from wgsparkl_tpu_torch.utils import checkpoint

    ia = torch.argsort(a.particles.ids)
    ib = torch.argsort(b.particles.ids)
    pa, pb = a.particles, b.particles
    if not torch.equal(pa.ids[ia], pb.ids[ib]):
        fail(f"{what}: the particle ids differ")
    if not torch.equal(pa.cdf_affinity[ia], pb.cdf_affinity[ib]):
        fail(f"{what}: affinity words differ")
    gaps = {}
    for f, tol in (("pos", 1e-5), ("vel", 1e-4), ("def_grad", 1e-4)):
        gaps[f] = float((getattr(pa, f)[ia] - getattr(pb, f)[ib]).abs().max())
        if not gaps[f] <= tol:
            fail(f"{what}: {f} differs by {gaps[f]:.3e} > {tol}")
    for f in ("pos", "rot", "linvel", "angvel"):
        gaps[f"bodies.{f}"] = float((getattr(a.bodies, f)
                                     - getattr(b.bodies, f)).abs().max())
        if not gaps[f"bodies.{f}"] <= 1e-6:
            fail(f"{what}: bodies.{f} differs by {gaps[f'bodies.{f}']:.3e}")
    la, lb = checkpoint.named_leaves(a), checkpoint.named_leaves(b)
    same = all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(la, lb))
    print(f"{what}: largest differences "
          f"{ {k: float(f'{v:.3e}') for k, v in gaps.items()} }; every leaf "
          f"bit-equal: {same}", flush=True)


def substep_paths(wt, card, kind, launches):
    """Path 17: the one-substep entry points at full size.  From the state of
    one warm frame, SUBSTEPS calls of substep_pallas on the main path's
    scene (1,002,001 particles, by 8, group 1024), of substep on path 13's
    and of substep_blocked on path 14's, each set against one frame of
    SUBSTEPS substeps (step_pallas, step_dense) from the same state: ids
    and affinity words equal, floats within compare_states' tolerances
    (bit-equality expected), and each kernel of the path launched once a
    call (A-E; dense_pcdf, dense_p2g, dense_g2p, C; blocked also D, E).
    Prints the wall of a call against the frame's wall over SUBSTEPS (the
    difference is the per-call pack and unpack, and for substep_pallas the
    static colliders' node CDF that the frame hoists).  Then time_passes
    on path 13's state, whose passes are the struct-form node_cdf, p2g,
    g2p and particle_update (their entries' launches)."""
    from wgsparkl_tpu_torch.pipeline import (step_dense, step_pallas, substep,
                                             substep_blocked, substep_pallas)
    from wgsparkl_tpu_torch.utils.timing import time_passes

    for make, call, frame, kernels, what in (
            (lambda: full_scene(torch.device(DEVICE)), substep_pallas, step_pallas,
             KERNELS_3D, "path 17: substep_pallas (3D main path)"),
            (lambda: dense_scene(DEVICE, transfer="dense"), substep, step_dense,
             KERNELS_DENSE, "path 17: substep (path 13's scene)"),
            (lambda: dense_scene(DEVICE, transfer="blocked"), substep_blocked,
             step_dense, KERNELS_BLOCKED, "path 17: substep_blocked (path 14's scene)")):
        data = make()
        cfg, params = data.config, data.params
        state0 = frame(data.state, params, cfg, SUBSTEPS)
        torch.cuda.synchronize()
        wt.reset_launch_counts()
        t0 = time.time()
        state = state0
        for _ in range(SUBSTEPS):
            state = call(state, params, cfg)
        torch.cuda.synchronize()
        call_ms = (time.time() - t0) * 1e3 / SUBSTEPS
        counts, split = launches_run(wt), launches_split(wt, kernels)
        bad = {k: counts[k] for k in kernels if counts[k] != SUBSTEPS}
        if bad:
            fail(f"{what}: launches {bad}, not one a call ({SUBSTEPS} calls)")
        t0 = time.time()
        ref = frame(state0, params, cfg, SUBSTEPS)
        torch.cuda.synchronize()
        frame_ms = (time.time() - t0) * 1e3
        pos = state.particles.pos
        if not bool(torch.isfinite(pos).all()):
            fail(f"{what}: non-finite positions")
        _state_gaps(state, ref, what)
        print(f"{what} on {kind} ({card}): {data.num_particles} particles; a call "
              f"{call_ms:.3f} ms, the frame {frame_ms:.3f} ms / {SUBSTEPS} = "
              f"{frame_ms / SUBSTEPS:.3f} ms a substep; launches "
              f"{ {k: counts[k] for k in kernels} } ({split})", flush=True)
        if call is substep:
            wt.reset_launch_counts()
            passes = time_passes(state, params, cfg)
            counts = launches_run(wt)
            for k, name in (("dense_p2g", "p2g_struct"), ("dense_g2p", "g2p_struct"),
                            ("update_rows", "particle_update_struct")):
                if counts[k] != 11:
                    fail(f"{what}: time_passes launched {k} {counts[k]} times, not 11")
                launches[name] = counts[k]
            print(f"{what}: time_passes (struct-form passes, ms a call, CUDA events) "
                  f"{ {k: round(v, 4) for k, v in passes.passes.items()} }", flush=True)
        del data, state0, state, ref
        torch.cuda.empty_cache()


@contextlib.contextmanager
def swapped(module, name, fn):
    """module.name is fn for the duration of the block, the frame graphs
    (which replay what their capture called) dropped on both sides."""
    from wgsparkl_tpu_torch import pipeline

    saved = getattr(module, name)
    pipeline.drop_frame_graphs()
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)
        pipeline.drop_frame_graphs()


def struct_checks(state, data, rec, check):
    """Phase 5b's struct-form entries on path 13's lowered state (`rec`: its
    last substep): ops/transfer.p2g and g2p and
    ops/particle_update.particle_update, the kernel route (dense_p2g,
    dense_g2p, kernel C with `rv_rows`) against the same function with the
    kernel swapped for its plain version, every output bit for bit.  The
    particle update takes g2p's outputs, as the JAX package's substep
    does, with the signed distances lowered by 0.1 cell.  Costs (4 bytes a value read or written once): p2g reads 20
    values a particle (position, velocity, mass, affine, affinity, normal)
    and the node affinity and closest body, writes the grid, ~50
    operations a pair and ~60 more an impulse pair; g2p reads 3d + 2 values
    a particle and the grid velocity, node affinity and closest body,
    writes 3d + d^2 a particle, ~(4 + 3 d^2) operations a stencil node;
    particle_update is kernel C's c_cost with the rigid-velocity rows read."""
    from wgsparkl_tpu_torch.ops import rows as R
    from wgsparkl_tpu_torch.ops import transfer as dtr
    from wgsparkl_tpu_torch.ops import update_rows as upd
    from wgsparkl_tpu_torch.ops.particle_update import particle_update
    from wgsparkl_tpu_torch.rigid import body as body_mod

    cfg, params = data.config, data.params
    grid, nc = cfg.grid, cfg.num_colliders
    d, m, n = grid.dim, grid.num_nodes, state.particles.count
    bodies = body_mod.update_world_mass_properties(state.bodies)
    p, models = state.particles, state.models
    node_aff, node_closest = rec["node_aff"], rec["node_closest"]
    node, vals = dtr.p2g_pairs(dtr.particle_rows(p.pos, p.vel, p.mass, p.affine),
                               dtr.particle_cdf_rows(p.cdf_affinity, p.cdf_normal,
                                                     p.cdf_signed_distance),
                               n, None, node_aff, node_closest, R.body_table(bodies),
                               grid, nc)
    npairs, nimp = node.shape[0], int((vals[:, d + 1:] != 0).any(1).sum())
    mmv = vals[:, :d + 1].contiguous()
    del vals
    lib_out = torch.zeros((m, d + 1), dtype=torch.float32, device=p.pos.device)

    def library():
        torch.use_deterministic_algorithms(True)
        try:
            lib_out.zero_()
            lib_out.index_put_((node,), mmv, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(False)

    def plain(module, name, fn, run):
        """run() with module.name swapped for its plain version fn."""
        def go():
            with swapped(module, name, fn):
                return run()
        return go

    args_p = (p, models, bodies, node_aff, node_closest, grid, nc)
    run_p = lambda: dtr.p2g(*args_p)  # noqa: E731
    check("p2g_struct", run_p, plain(dtr, "dense_p2g", dtr.p2g_plain, run_p),
          lambda k, q: [],
          lambda k, q: [(lbl, a, b) for lbl, a, b in zip(
              ("grid momentum", "grid mass", "linear impulses", "angular impulses"), k, q)],
          lambda q: None if float(q[2].abs().max()) > 0.0 else "no CPIC impulse",
          cost=(4 * (20 * n + 2 * m + (d + 1) * m), npairs * 50 + nimp * 60),
          library=library)
    del node, mmv, lib_out
    args_g = (p, bodies, rec["grid_vel"], node_aff, node_closest, grid, nc)
    run_g = lambda: dtr.g2p(*args_g)  # noqa: E731
    check("g2p_struct", run_g, plain(dtr, "dense_g2p", dtr.g2p_plain, run_g),
          lambda k, q: [],
          lambda k, q: [(lbl, a, b) for lbl, a, b in zip(
              ("velocity", "velocity gradient", "rigid velocity"), k, q)],
          lambda q: None if float(q[2].abs().max()) > 0.0 else "no rigid velocity",
          cost=(4 * ((3 * d + 2) * n + (d + 2) * m + (3 * d + d * d) * n),
                n * 3 ** d * (4 + 3 * d * d)))
    new_vel, grad, rv = run_g()
    # The particle CDF keeps a particle's distance on its own side of a
    # collider (>= 0 but where it crossed), so few lanes penetrate: the
    # distances lowered by 0.1 cell make the lanes near a collider take
    # kernel C's contact projection, which reads the rigid velocity.
    pu = dataclasses.replace(p, vel=new_vel, affine=grad, cdf_rigid_vel=rv,
                             cdf_signed_distance=p.cdf_signed_distance
                             - 0.1 * grid.cell_width)

    def run_u():
        q, mo = particle_update(pu, models, params, grid, cfg.elastic_model)
        return (q.pos, q.vel, q.affine, q.def_grad, mo.phase,
                *(mo.dp_state[k] for k in sorted(mo.dp_state)))

    pen = (pu.cdf_signed_distance < -0.05 * grid.cell_width) & (rv.abs().sum(1) > 0)
    check("particle_update_struct", run_u,
          plain(upd, "update_rows", upd.update_plain, run_u), lambda k, q: [],
          lambda k, q: [(f"output {i}", a, b) for i, (a, b) in enumerate(zip(k, q))],
          lambda q: (None if int(pen.sum()) > 0
                     else "no penetrating lane reads a rigid velocity"),
          cost=c_cost(C_ROWS_READ_3D + (41, 42, 43), 12, 6, R.PCHAN, n, n, 6000))
    print(f"struct-form entries on path 13 lowered: {n} particles, {npairs} P2G pairs "
          f"({nimp} impulse pairs), {int(pen.sum())} penetrating lanes with a rigid "
          "velocity", flush=True)


def _same_state(a, b, what):
    """Every leaf of two states equal bit for bit (utils/checkpoint's
    leaves: particles, models, bodies)."""
    from wgsparkl_tpu_torch.utils import checkpoint

    la, lb = checkpoint.named_leaves(a), checkpoint.named_leaves(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        fail(f"{what}: the states hold other leaves")
    for (name, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            fail(f"{what}: {name} differs")


def dam_break_path(wt, card, kind, frames=TIMED_FRAMES_SHORT):
    """Path 16: examples/dam_break3.py at SCALE DAM_SCALE (BASELINE config 3)
    through the port's user surfaces: the runner's build, a warm frame
    through MpmPipeline.step, `frames` timed frames through Testbed.run (a
    synchronise at each frame's end), no StepDiag fault and a healthy
    diagnostics.check after every frame, finite positions, kernels A-E
    launched; then a Testbed frame against a step_pallas frame from the same
    state, a checkpoint of the full-size state saved and loaded (in a
    temporary directory outside the repo) and a frame from each, bit for
    bit; prep_instances in all six modes and the last frame's PLY;
    time_passes; `frames` frames of run_frames' loop against the Testbed's;
    one frame under profile_step (the device's idle share in that frame)."""
    import os
    import tempfile

    from wgsparkl_tpu_torch import render
    from wgsparkl_tpu_torch.examples import dam_break3
    from wgsparkl_tpu_torch.pipeline import MpmPipeline, step_pallas, step_with_diag
    from wgsparkl_tpu_torch.testbed import Testbed
    from wgsparkl_tpu_torch.utils import diagnostics, time_passes
    from wgsparkl_tpu_torch.utils.profiling import profile_step

    what = "path 16: dam break (config 3)"
    data = dam_break3.build(DAM_SCALE, DEVICE, transfer="pallas", group=GROUP, by=BY)
    cfg, n = data.config, data.num_particles
    nf, ne = dam_break3.counts(DAM_SCALE)
    if (n != 2 * nf ** 3 + ne ** 3 or (cfg.transfer, cfg.by, cfg.group) != ("pallas", BY, GROUP)
            or cfg.static_slots != (0, 1, 2, 3, 4) or cfg.n_materials != 2):
        fail(f"{what}: built as {cfg} with {n} particles")
    mode = "chan-free" if cfg.chan_free else "gathered hybrid"
    print(f"{what}: {n} particles ({2 * nf ** 3} fluid + {ne ** 3} elastic), grid "
          f"{cfg.grid.shape}, max_jobs {cfg.max_jobs}, CDF mode {mode}", flush=True)
    reports = []

    def health(tb):
        if tb.diag.any_overflow():
            fail(f"{what}: step diagnostics of frame {tb.frame}: {tb.diag.summary()}")
        rep = diagnostics.check(tb.data)
        if not rep.ok or rep.out_of_grid:
            fail(f"{what}: health check of frame {tb.frame}: {rep.summary()}")
        reports.append(rep)

    wt.reset_launch_counts()
    t0 = time.time()
    diag = MpmPipeline().step(data, SUBSTEPS)
    torch.cuda.synchronize()
    print(f"{what}: warm frame through MpmPipeline.step ({SUBSTEPS} substeps) "
          f"{time.time() - t0:.2f} s", flush=True)
    tb = Testbed(data, SUBSTEPS, on_frame=health)
    tb.diag = diag
    health(tb)
    stats = tb.run(frames)
    counts = launches_run(wt)
    pos = tb.data.state.particles.pos
    if tuple(pos.shape) != (n, 3) or not bool(torch.isfinite(pos).all()) \
            or not stats["finite"]:
        fail(f"{what}: non-finite or misshapen positions")
    if min(counts[k] for k in KERNELS_3D) <= 0:
        fail(f"{what}: a kernel of the path never launched: {counts}")
    ms = sum(tb.frame_ms)
    sps = frames * SUBSTEPS / (ms / 1e3)
    print(f"{what} on {kind} ({card}): {n} particles, {frames * SUBSTEPS} substeps "
          f"in {ms / 1e3:.3f} s through Testbed.run -> {sps:.3f} steps/s, "
          f"{sps * n / 1e6:.2f} M particle-updates/s; frame ms "
          f"{[round(x, 3) for x in tb.frame_ms]}; StepDiag OK and diagnostics.check "
          f"healthy after all {len(reports)} frames ({reports[-1].summary()}); "
          f"launches { {k: counts[k] for k in KERNELS_3D} } "
          f"({launches_split(wt, KERNELS_3D)})", flush=True)
    # A Testbed frame is a step_pallas frame from the same state.
    start = tb.data.state
    ref = step_pallas(start, data.params, cfg, SUBSTEPS)
    tb.step_frame()
    _same_state(tb.data.state, ref, f"{what}: Testbed frame against step_pallas")
    # Checkpoint of the full-size state, and a frame from each side.
    tmp = tempfile.mkdtemp(prefix="wgsparkl_dam_break_")
    path = os.path.join(tmp, "state.npz")
    t0 = time.time()
    tb.save_checkpoint(path)
    saved = tb.data.state
    tb.load_checkpoint(path)
    _same_state(tb.data.state, saved, f"{what}: checkpoint round trip")
    _same_state(step_pallas(tb.data.state, data.params, cfg, SUBSTEPS),
                step_pallas(saved, data.params, cfg, SUBSTEPS),
                f"{what}: a frame from the loaded state")
    print(f"{what}: a Testbed frame equals a step_pallas frame from the same state "
          f"bit for bit; checkpoint ({os.path.getsize(path) / 1e6:.1f} MB) saved and "
          f"loaded bit for bit in {time.time() - t0:.2f} s, and a frame from the "
          "loaded state equals one from the saved state", flush=True)
    for name, m in render.MODES.items():
        inst = render.prep_instances(tb.data.state.particles, mode=m,
                                     cell_width=cfg.grid.cell_width)
        if tuple(inst["color"].shape) != (n, 3) or not bool(
                torch.isfinite(inst["color"]).all()):
            fail(f"{what}: prep_instances mode {name} not finite")
    ply = os.path.join(tmp, f"frame_{tb.frame:05d}.ply")
    tb.write_frame(ply)
    with open(ply) as f:
        head = [next(f) for _ in range(3)]
    print(f"{what}: prep_instances finite in all {len(render.MODES)} modes; "
          f"{ply}: {head[2].strip()}, {os.path.getsize(ply) / 1e6:.1f} MB", flush=True)
    os.remove(path)
    os.remove(ply)
    os.rmdir(tmp)
    ts = time_passes(tb.data.state, data.params, cfg, iters=5)
    print(f"{what}: time_passes (the dense transfer's passes on this state, CUDA "
          f"events, ms a call):\n{ts.report()}", flush=True)
    # Run_frames' loop on the same state: step_with_diag frames, one
    # synchronise after the last (the Testbed synchronises after each).
    st = tb.data.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        st, _ = step_with_diag(st, data.params, cfg, SUBSTEPS)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / frames
    print(f"{what}: Testbed.run frames {ms / frames:.3f} ms each against run_frames' "
          f"loop {loop_ms:.3f} ms a frame ({frames} frames from the state after them): "
          f"ratio {ms / frames / loop_ms:.4f}", flush=True)
    del st
    # One frame under torch.profiler (utils/profiling.py; the Testbed's
    # frames have warmed it): its kernels', copies' and fills' device time
    # against the same frame's own wall (the profiler on), and against the
    # median unprofiled Testbed frame wall (another frame: printed apart).
    pstats = {}
    rows = profile_step(tb.data, SUBSTEPS, top=100_000, warmup_frames=0, stats=pstats)
    dev_ms, pwall = sum(r[0] for r in rows), pstats["wall_ms"]
    wall = sorted(tb.frame_ms)[len(tb.frame_ms) // 2]
    print(f"{what}: profiled frame: device time {dev_ms:.3f} ms ({dev_ms / SUBSTEPS:.3f} "
          f"ms a substep), its own wall {pwall:.3f} ms: idle share "
          f"{1.0 - dev_ms / pwall:.3f}; the median unprofiled Testbed frame wall "
          f"{wall:.3f} ms (another frame); the largest (ms a substep, op):", flush=True)
    for _, per, op, loc, _ in rows[:8]:
        print(f"  {per:8.4f}  {op}  {loc}", flush=True)
    del data, tb, start, ref, saved, inst
    torch.cuda.empty_cache()


# ---- paths 15-15d: multi-device stepping (wgsparkl_tpu_torch/parallel) ----
# The ranks share the one card through gloo, each buffer staged through
# pinned host memory; where the machine has a card a rank, the path runs
# again on NCCL.  Correctness runs: their steps/s are no multi-device speed.
WORLD_15 = 4
MIGRATION_CAP = 2048
# Path 15d's halo_cap: its boundary planes hold at most ~800 active blocks.
HALO_CAP_15D = 2048
# The rows of one rank are held against the plain versions (record_rank).
RECORD_KEYS = ("rows", "unsorted", "perm", "sorted_ids", "jobs", "bcells", "jbody",
               "ntiles", "btable", "moving", "static_desc", "chan_free", "alldesc",
               "pdata", "mm", "imp", "pcdf", "ftiles", "krows", "mtable",
               "covered_end", "live_below", "nb_total", "act", "fold_vel")


def _tree(fn, x):
    """fn on every tensor / array of a record's nested dicts and tuples."""
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    return x


def record_rank(world: int) -> int:
    """The rank whose rows are recorded: a middle rank, which receives
    migrants from both sides, where there is one, else rank 0 (on the
    small 2-rank scenes the rank that most migrants reach)."""
    return 1 if world > 2 else 0


def record_after(comm, state, params, cfg, more: int = 0):
    """Rank hook after a path's frames: one more substep, every rank with
    its exchanges, recording the kernels' inputs and outputs, then `more`
    substeps.  Returns (the recording rank's record as numpy, None on the
    others; the last state as numpy when more, else None)."""
    from wgsparkl_tpu_torch.parallel import domain
    from wgsparkl_tpu_torch.pipeline import step_pallas

    rec = {}
    state = step_pallas(state, params, cfg, 1, record=rec, comm=comm)
    if more:
        state = step_pallas(state, params, cfg, more, comm=comm)
    kept = (_tree(lambda t: t.cpu().numpy(), {k: rec[k] for k in RECORD_KEYS if k in rec})
            if comm.rank == record_rank(comm.world) else None)
    return kept, (domain.map_state(lambda t: t.cpu().numpy(), state) if more else None)


def plain_setup():
    """Rank set-up: route every kernel call of the rank to its plain version
    (for the rank's whole life)."""
    plain_versions().__enter__()


def widened(data, world: int):
    """data with its grid (the sparse domain's nominal grid) widened at the
    high x end to whole slabs of `world` ranks, particles unchanged: the
    main scene's 108 x-nodes (27 blocks of 4) to 112 (28 blocks, 7 a slab
    on 4 ranks)."""
    from wgsparkl_tpu_torch.ops import blocked as bk

    g = data.config.grid
    bx = bk.block_shape(g.dim)[0]
    nbx = -(-(g.shape[0] // bx) // world) * world
    data.config = dataclasses.replace(data.config, grid=dataclasses.replace(
        g, shape=(nbx * bx,) + tuple(g.shape[1:])))
    return data


def spatial_scene(device, dim: int = 3, sparse: bool = False):
    """tests/test_parallel.py's spatial scenes: in 3D (its _spatial_scene)
    a 24 x 8 x 8 elastic lattice over a floor with lateral velocities of up
    to 12 m/s (seed 7), 10 x-blocks; in 2D a 64 x 16 column with up to 14
    m/s (seed 11) on a 120-node-wide grid; group 64."""
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.grid import GridConfig
    from wgsparkl_tpu_torch.models import ElasticCoefficients
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    if dim == 3:
        rng = np.random.default_rng(7)
        grid = GridConfig.from_bounds(np.zeros(3), np.array([32.0, 16.0, 8.0]), 1.0)
        axes = (np.arange(24) * 0.5 + 10.0, np.arange(8) * 0.5 + 2.0,
                np.arange(8) * 0.5 + 2.0)
        vmax, floor = 12.0, RigidBodyDesc(Collider.cuboid(40.0, 1.0, 40.0),
                                          (16.0, -0.9, 4.0))
    else:
        rng = np.random.default_rng(11)
        grid = GridConfig.from_bounds(np.zeros(2), np.array([120.0, 24.0]), 1.0)
        axes = (np.arange(64) * 0.5 + 44.0, np.arange(16) * 0.5 + 2.0)
        vmax, floor = 14.0, RigidBodyDesc(Collider.cuboid(200.0, 1.0), (60.0, -0.9))
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, dim)
    n = len(pos)
    vel = np.zeros((n, dim), np.float32)
    vel[:, 0] = rng.uniform(-vmax, vmax, n)
    p = Particles.from_arrays(pos.astype(np.float32), density=1000.0, radius=0.25,
                              device=device)
    p.vel = torch.as_tensor(vel, device=device)
    e = ElasticCoefficients.from_young_modulus(1.0e6, 0.2)
    models = Models.from_arrays(n, e.lam, e.mu, phase=1.0, device=device)
    params = SimulationParams.new(dt=2e-3, gravity=np.eye(dim)[1] * -9.81, device=device)
    return MpmData(params, p, models, [floor], 1.0, grid=grid, group=64, job_chunk=8,
                   sparse=sparse)


def live_by_id(state, n: int, what: str):
    """(ids, positions, velocities) of the live lanes (id >= 0, mass > 0) of
    a gathered state, by id; fails unless there are n of them."""
    p = state.particles
    ids, mass = np.asarray(p.ids), np.asarray(p.mass)
    live = (ids >= 0) & (mass > 0)
    if int(live.sum()) != n or len(np.unique(ids[live])) != n:
        fail(f"{what}: {int(live.sum())} live particles ({len(np.unique(ids[live]))} "
             f"distinct ids), not {n}")
    o = np.argsort(ids[live])
    return ids[live][o], np.asarray(p.pos)[live][o], np.asarray(p.vel)[live][o]


def run_ranks(data, cfg, world, frames, what, backend="gloo", after=None,
              setup=None, pad=False):
    """data's state (padded to the world with zero-mass lanes when pad)
    sharded over `world` ranks (spatially under a spatial cfg) and stepped
    there frame by frame; returns launch.step_job's results."""
    from wgsparkl_tpu_torch.parallel import domain, launch

    state = data.state
    if pad:
        state = domain.pad_state(state, cfg.grid, domain.pad_particle_count(
            data.num_particles, world))
    shards = [domain.shard_state_spatial(state, cfg, r) if cfg.spatial_devices
              else domain.shard_state(state, r, world) for r in range(world)]
    shards = [domain.map_state(lambda t: t.cpu().numpy(), s) for s in shards]
    params = dataclasses.replace(data.params, gravity=data.params.gravity.cpu())
    devices = ([f"cuda:{r}" for r in range(world)] if backend == "nccl"
               else [DEVICE] * world)
    print(f"{what}: backend {backend}, world size {world}, ranks on {devices}"
          + (" (buffers staged through pinned host memory)"
             if backend == "gloo" and DEVICE != "cpu" else ""), flush=True)
    del state
    torch.cuda.empty_cache()
    return launch.run(launch.step_job, world, args=(params, cfg, frames, after),
                      rank_args=[(s,) for s in shards], backend=backend,
                      devices=devices, setup=setup, timeout=900)


def check_ranks(res, what, n, kernels):
    """The gates of a multi-device run: no StepDiag fault on any rank in any
    frame, finite positions, every live particle kept, the bodies bit-equal
    across the ranks, every kernel of the path launched.  Returns the
    launch counts summed over the ranks."""
    from wgsparkl_tpu_torch.parallel import domain

    for i in range(len(res[0]["diags"])):
        diag = res[0]["diags"][i]
        bad = {k: v.tolist() for k, v in diag.items()
               if k in ("job_overflow", "sparse_occ_overflow", "sparse_act_overflow",
                        "migration_dropped", "live_lost", "halo_dropped") and v.max() > 0}
        if bad:
            fail(f"{what}: frame {i}: StepDiag faults per rank {bad}")
    last = [r["states"][-1] for r in res]
    st = domain.gather_state(last)
    if not np.isfinite(st.particles.pos).all():
        fail(f"{what}: non-finite positions")
    live_by_id(st, n, what)
    for f in ("pos", "rot", "linvel", "angvel"):
        a, b = getattr(last[0].bodies, f), getattr(last[-1].bodies, f)
        if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            fail(f"{what}: body {f} differs between rank 0 and rank {len(res) - 1}")
    counts = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
    if min(counts[k] for k in kernels) <= 0:
        fail(f"{what}: a kernel of the path never launched: {counts}")
    return counts


def parallel_paths(wt, card, kind, launches, records):
    """Paths 15, 15b, 15c, 15d at full size (the ranks gloo-staged on the
    one card; again on NCCL where there is a card a rank): one substep and
    the rest of a frame.  After the substep the gathered state, matched by
    id, must be within 1e-5 in position and 1e-4 in velocity of the
    unsharded step on the same grid (the frame's difference is printed);
    check_ranks' gates after each.  launches gets the ranks' summed
    counts; records the recording rank's last substep, for phase 5."""
    from wgsparkl_tpu_torch.ops import blocked as bk
    from wgsparkl_tpu_torch.parallel import domain, spatial_config
    from wgsparkl_tpu_torch.pipeline import step_pallas, step_with_diag

    def path_15():
        return full_scene(DEVICE), None

    def path_15b():
        d = widened(full_scene(DEVICE), WORLD_15)
        return d, spatial_config(d.config, WORLD_15, MIGRATION_CAP)

    def path_15c():
        d = widened(full_scene_2d(DEVICE), 2)
        return d, spatial_config(d.config, 2, MIGRATION_CAP)

    def path_15d():
        d = widened(full_scene_sparse(DEVICE), WORLD_15)
        return d, spatial_config(d.config, WORLD_15, MIGRATION_CAP, HALO_CAP_15D)

    for tag, make, world, substeps, kernels, what in (
            ("sharded", path_15, WORLD_15, SUBSTEPS, KERNELS_3D,
             "path 15: main scene particle-sharded"),
            ("spatial", path_15b, WORLD_15, SUBSTEPS, KERNELS_3D,
             "path 15b: main scene in x slabs"),
            ("spatial2d", path_15c, 2, SUBSTEPS2, KERNELS_2D,
             "path 15c: 2D column in x slabs"),
            ("spatial_sparse", path_15d, WORLD_15, SUBSTEPS, KERNELS_SPARSE,
             "path 15d: sparse main scene in x slabs")):
        data, cfg_sp = make()
        base = data.config
        cfg = cfg_sp or base
        n = data.num_particles
        print(f"{what}: {n} particles, grid {base.grid.shape} ({bk.num_blocks(base.grid)} "
              f"blocks), max_jobs {base.max_jobs}, migration_cap "
              f"{cfg.migration_cap if cfg_sp else '-'}, halo_cap "
              f"{cfg.halo_cap if cfg_sp and cfg.sparse else '-'}", flush=True)
        # The unsharded step on the same grid: one substep, then the frame.
        ref1, diag = step_with_diag(data.state, data.params, base, 1)
        ref = step_pallas(ref1, data.params, base, substeps - 1)
        if diag.any_overflow():
            fail(f"{what}: the unsharded substep: {diag.summary()}")
        refs = [domain.map_state(lambda t: t.cpu().numpy(), s) for s in (ref1, ref)]
        refs = [live_by_id(s, n, what + " (unsharded)") for s in refs]
        del ref1, ref
        for backend in ("gloo", "nccl"):
            if backend == "nccl" and torch.cuda.device_count() < world:
                print(f"{what}: NCCL not run ({torch.cuda.device_count()} card(s) for "
                      f"{world} ranks; NCCL takes one card a rank)", flush=True)
                continue
            res = run_ranks(data, cfg, world, [1, substeps - 1], f"{what} [{backend}]",
                            backend, after=record_after, pad=cfg_sp is None)
            counts = check_ranks(res, f"{what} [{backend}]", n, kernels)
            errs = []
            for i, (rid, rpos, rvel) in enumerate(refs):
                ids, pos, vel = live_by_id(domain.gather_state(
                    [r["states"][i] for r in res]), n, what)
                if not np.array_equal(ids, rid):
                    fail(f"{what}: the ranks' ids differ from the unsharded step's")
                errs.append((float(np.abs(pos - rpos).max()),
                             float(np.abs(vel - rvel).max())))
            if not (errs[0][0] <= 1e-5 and errs[0][1] <= 1e-4):
                fail(f"{what} [{backend}]: after one substep {errs[0][0]:.3e} in position, "
                     f"{errs[0][1]:.3e} in velocity from the unsharded step "
                     "(bounds 1e-5, 1e-4)")
            diag = res[0]["diags"][-1]
            shipped = sum(d["migrated"] for d in res[0]["diags"])
            per_rank = [int(((r["states"][-1].particles.ids >= 0)
                             & (r["states"][-1].particles.mass > 0)).sum()) for r in res]
            secs = res[0]["seconds"]
            sps = (substeps - 1) / secs[1]
            print(f"{what} [{backend}]: against the unsharded step after one substep "
                  f"{errs[0][0]:.3e} in position, {errs[0][1]:.3e} in velocity; after "
                  f"the frame ({substeps} substeps) {errs[1][0]:.3e}, {errs[1][1]:.3e}; "
                  f"every live particle kept, no StepDiag fault, bodies bit-equal "
                  f"across ranks; per rank: live particles {per_rank}, migrants "
                  f"shipped in the frame {shipped.tolist()}, dropped "
                  f"{diag['migration_dropped'].tolist()}"
                  + (f", peak occupied / active blocks {diag['sparse_n_occ'].tolist()} / "
                     f"{diag['sparse_n_active'].tolist()}, peak boundary-plane active "
                     f"blocks {diag['halo_n_plane'].tolist()} (halo_cap {cfg.halo_cap}), "
                     f"halo dropped {diag['halo_dropped'].tolist()}" if cfg.sparse else "")
                  + f"; launches { {k: counts[k] for k in kernels} }", flush=True)
            print(f"{what} [{backend}]: {substeps - 1} substeps in {secs[1]:.3f} s -> "
                  f"{sps:.3f} steps/s ({backend}-staged, one card: correctness only)"
                  if backend == "gloo" else
                  f"{what} [nccl]: {substeps - 1} substeps in {secs[1]:.3f} s -> "
                  f"{sps:.3f} steps/s on {world} cards", flush=True)
            if backend == "gloo":
                launches.update((f"{k}_{tag}", counts[k]) for k in kernels)
                records[tag] = (_tree(torch.as_tensor, res[record_rank(world)]["after"][0]),
                                cfg, data.params.dt)
            del res
        del data
        torch.cuda.empty_cache()


def tile_pairs_library(pdata, jobs, bcells, h: float, wsh, maxj: int):
    """The library yardstick of a P2G into job-window tiles (kernels A, F,
    H): index_put_(accumulate=True) under deterministic algorithms (a sort
    of the pair indices) of the (particle, stencil node) pairs of the
    covered lanes, each the weighted momentum with the affine term and the
    mass, into [maxj * window nodes, d + 1].  The pairs are built here, as
    for the dense P2G's row; returns (the call, the pair count)."""
    from wgsparkl_tpu_torch.ops import rows as R
    from wgsparkl_tpu_torch.ops import rows2d as R2

    d = len(wsh)
    L = R if d == 3 else R2
    wvol = int(np.prod(wsh))
    jid, lane = R.job_lanes(jobs)
    pd = pdata[:, lane]
    bc = bcells.to(torch.int64)[jid]
    w, nidx, valid = R.stencil([pd[a] for a in range(d)], bc, R.f32(1.0 / h), wsh)
    coords, rest = [], nidx
    for a in reversed(range(d)):
        coords.insert(0, rest % wsh[a])
        rest = rest // wsh[a]
    dp = [(coords[a] + bc[:, a:a + 1]).to(torch.float32) * h - pd[a][:, None]
          for a in range(d)]
    m = pd[L.PM][:, None]
    vals = []
    for i in range(d):
        mp = m * pd[L.VX + i][:, None]
        for j in range(d):
            mp = mp + pd[L.A0 + i * d + j][:, None] * dp[j]
        vals.append(w * mp)
    vals.append(w * m)
    node = (jid[:, None] * wvol + nidx)[valid]
    vals = torch.stack(vals, -1)[valid].contiguous()
    out = torch.zeros((maxj * wvol, d + 1), dtype=torch.float32, device=pdata.device)

    def library():
        torch.use_deterministic_algorithms(True)
        try:
            out.zero_()
            out.index_put_((node,), vals, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(False)

    return library, int(node.shape[0])


def jobs_premise(rec, what: str) -> None:
    """Kernel I's premise (it owns its whole output) on a recorded 2D
    substep: the live jobs are the table's first slots and cover the
    sorted lanes [0, covered_end) in one run."""
    ln, st = rec["jobs"]["len"].cpu(), rec["jobs"]["start"].cpu()
    k = int((ln > 0).sum())
    ok = (k > 0 and bool((ln[:k] > 0).all()) and int(st[0]) == 0
          and torch.equal(st[1:k], (st[:k - 1] + ln[:k - 1]).to(st.dtype))
          and int(rec["covered_end"]) == int(ln[:k].sum()))
    if not ok:
        fail(f"{what}: the live jobs do not cover lanes [0, end) in one run")
    print(f"{what}: kernel I's premise holds ({k} live jobs cover lanes [0, "
          f"{int(rec['covered_end'])}) in one run)", flush=True)


def _same_leaves(a, b, what: str) -> None:
    """Two states (numpy leaves) equal bit for bit, leaf by leaf."""
    from wgsparkl_tpu_torch.parallel import domain

    flat = []
    domain.map_state(lambda x: flat.append(x) or x, a)
    other = []
    domain.map_state(lambda x: other.append(x) or x, b)
    for x, y in zip(flat, other):
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            fail(f"{what}: the kernel path's state differs from the plain path's")


def parallel_small_scenes(dev) -> None:
    """Phase 6's multi-device scenes on 2 ranks sharing the card (gloo): the
    kernel path against the plain path (ranks whose kernel calls go to the
    plain versions), every leaf of every rank's state bit for bit, the
    bodies bit-equal across the ranks.  The spatial scenes run a substep,
    then record the second (where the first migrants land on rank 0), then
    8 more: migrants must have landed on the recording rank in the recorded
    substep, and in 2D kernel I's premise must hold after its second
    sort."""
    from wgsparkl_tpu_torch import scenes
    from wgsparkl_tpu_torch.ops import rows as R
    from wgsparkl_tpu_torch.ops import rows2d as R2
    from wgsparkl_tpu_torch.parallel import domain, launch, spatial_config

    world = 2
    cases = {
        "particle-sharded 3D sand box": (lambda: scenes.sand_box_3d(
            nxz=8, ny=16, device=dev, by=BY, group=256), {}, 5, KERNELS_3D),
        "3D lattice in x slabs with lateral velocities": (
            lambda: spatial_scene(dev), dict(migration_cap=512), 1, KERNELS_3D),
        "2D column in x slabs with lateral velocities": (
            lambda: spatial_scene(dev, 2), dict(migration_cap=512), 1, KERNELS_2D),
        "sparse 3D lattice in x slabs": (
            lambda: spatial_scene(dev, 3, True), dict(migration_cap=512, halo_cap=256),
            1, KERNELS_SPARSE),
        "particle-sharded 3D dense sand box": (lambda: scenes.sand_box_3d(
            nxz=8, ny=16, device=dev, transfer="dense"), {}, 5, KERNELS_DENSE),
    }
    jobs = [[] for _ in range(world)]
    for make, sp, steps, _ in cases.values():
        d = make()
        cfg = spatial_config(d.config, world, **sp) if sp else d.config
        params = dataclasses.replace(d.params, gravity=d.params.gravity.cpu())
        for r in range(world):
            shard = (domain.shard_state_spatial(d.state, cfg, r) if sp
                     else domain.shard_state(d.state, r, world))
            jobs[r].append((domain.map_state(lambda t: t.cpu().numpy(), shard), params,
                            cfg, [steps],
                            functools.partial(record_after, more=8) if sp else None))
    run = dict(world=world, rank_args=[(j,) for j in jobs], devices=[DEVICE] * world)
    kern = launch.run(launch.step_jobs, **run)
    plain = launch.run(launch.step_jobs, setup=plain_setup, **run)
    for i, (what, (_, sp, steps, kernels)) in enumerate(cases.items()):
        counts = {k: sum(r[i]["launches"][k] for r in kern) for k in kernels}
        if min(counts.values()) <= 0:
            fail(f"{what}: a kernel of the path never launched: {counts}")
        for r in range(world):
            _same_leaves(kern[r][i]["states"][-1], plain[r][i]["states"][-1],
                         f"{what}, rank {r}")
            if sp:
                _same_leaves(kern[r][i]["after"][1], plain[r][i]["after"][1],
                             f"{what}, rank {r}, substep 10")
            faults = {k: v.tolist() for k, v in kern[r][i]["diags"][-1].items()
                      if k in ("job_overflow", "migration_dropped", "live_lost",
                               "halo_dropped", "sparse_occ_overflow",
                               "sparse_act_overflow") and v.max() > 0}
            if faults:
                fail(f"{what}: StepDiag faults {faults}")
        last = [r[i]["after"][1] if sp else r[i]["states"][-1] for r in kern]
        b0, b1 = last[0].bodies, last[-1].bodies
        if not all(np.array_equal(getattr(b0, f).view(np.uint32),
                                  getattr(b1, f).view(np.uint32))
                   for f in ("pos", "rot", "linvel", "angvel")):
            fail(f"{what}: the bodies differ between the ranks")
        if sp:
            rec = _tree(torch.as_tensor, kern[record_rank(world)][i]["after"][0])
            cfg = jobs[0][i][2]
            pm = R.PM if cfg.grid.dim == 3 else R2.PM
            npad = rec["unsorted"].shape[1]
            moved = int((rec["unsorted"][pm, npad - 2 * cfg.migration_cap:] > 0).sum())
            if moved == 0:
                fail(f"{what}: no migrant landed on rank {record_rank(world)} in the "
                     "recorded substep")
            if cfg.grid.dim == 2:
                jobs_premise(rec, f"{what} ({moved} migrants landed)")
    print(f"multi-device small scenes on {world} ranks ({'; '.join(cases)}): the "
          "kernel path equals the plain path bit for bit on every rank, bodies "
          "bit-equal across ranks", flush=True)

# The entries of the kernel line that paths 15-15d add: each kernel on the
# rows of one rank (record_rank) of a path.
PARALLEL_KERNELS = {"sharded": KERNELS_3D, "spatial": KERNELS_3D,
                    "spatial2d": KERNELS_2D, "spatial_sparse": KERNELS_SPARSE}
for _tag, _ks in PARALLEL_KERNELS.items():
    for _k in _ks:
        REPLACES[f"{_k}_{_tag}"] = REPLACES[_k]
        SOURCE[f"{_k}_{_tag}"] = SOURCE.get(_k, _k)


def full_scene_2d(dev, **mpm_kw):
    """The 2D path at full size: 490,000 particles."""
    from wgsparkl_tpu_torch import scenes

    return scenes.sand_column_2d(nx=NX2, ny=NY2, cell_width=H2, device=dev,
                                 group=GROUP2, **mpm_kw)


def full_scene_stirred_2d(dev, chan_free=False, shift=None):
    """Path 6 at full size: the 2D path's 490,000-particle column, models,
    grid, floor and job table size, stirred (stirred_column, STIR_SCALE) in
    the dense CDF mode (the default for these colliders) or chan-free;
    shift moves the lattice."""
    d = full_scene_2d(dev)
    if shift is not None:
        d.state.particles.pos += torch.tensor(shift, device=dev)
    return stirred_column(d, STIR_SCALE, chan_free, group=GROUP2,
                          max_jobs=d.config.max_jobs)


def collider_free(d, jitter: float = 0.0, elastic: bool = False, **mpm_kw):
    """Scene d's lattice, models and grid with no body, spinning
    (scenes.spin_velocities); elastic: elastic_blocks_2d's models (E = 5e6,
    nu = 0.2, phase 1, no fracture) in place of d's."""
    from wgsparkl_tpu_torch.models import ElasticCoefficients
    from wgsparkl_tpu_torch.pipeline import MpmData
    from wgsparkl_tpu_torch.scenes import spin_velocities
    from wgsparkl_tpu_torch.solver import Models

    p, models = d.state.particles, d.state.models
    dev = p.pos.device
    vel = spin_velocities(p.pos.cpu(), jitter)
    p = dataclasses.replace(p, vel=torch.as_tensor(vel, device=dev))
    if elastic:
        e = ElasticCoefficients.from_young_modulus(5.0e6, 0.2)
        models = Models.from_arrays(p.count, e.lam, e.mu, phase=1.0,
                                    max_stretch=-1.0, device=dev)
    return MpmData(d.params, p, models, [], d.config.grid.cell_width,
                   grid=d.config.grid, **mpm_kw)


def full_scene_free(dev):
    """The 3D collider-free path at full size: the main path's 1,002,001-
    particle lattice, models, grid and job table size with no body."""
    d = full_scene(dev)
    return collider_free(d, by=BY, group=GROUP, max_jobs=d.config.max_jobs)


def coarser_grid(d, factor: int, **mpm_kw):
    """Scene d's particles, models, bodies and grid bounds on cells `factor`
    times as wide: factor^dim times the particles a cell."""
    from wgsparkl_tpu_torch.pipeline import MpmData

    g = d.config.grid
    lo = [o * g.cell_width for o in g.origin_cell]
    hi = [(o + n) * g.cell_width for o, n in zip(g.origin_cell, g.shape)]
    return MpmData(d.params, d.state.particles, d.state.models, d.bodies_desc,
                   g.cell_width * factor, grid_bounds=(lo, hi), **mpm_kw)


def full_scene_dense_2d(dev, shift=None):
    """The 2D path's 490,000-particle column, models and floor on cells
    three times as wide (36 particles a cell, 2304 a full 8 x 8 block; group
    2048), so that kernel H's jobs span several of its chunks; shift moves
    the lattice."""
    d = full_scene_2d(dev)
    if shift is not None:
        d.state.particles.pos += torch.tensor(shift, device=dev)
    return coarser_grid(d, 3, group=2048)


def full_scene_neo_2d(dev):
    """The 2D neo-Hookean path at full size: 490,000 particles."""
    from wgsparkl_tpu_torch import scenes

    return scenes.elastic_blocks_2d(n_side=NX2, cell_width=H2, device=dev,
                                    group=GROUP2, elastic_model="neo_hookean")


def shapes_scene(d, chan_free=None, **mpm_kw):
    """Path 5: scene d's lattice, models and grid (a sand_box_3d) with every
    analytic collider shape: a static halfspace at the origin in place of
    the floor cuboid (whose top face is y = 0), d's four static side walls,
    a kinematic capsule paddle (half height 28, radius 1.5) at (0, 2, 0)
    lying along z and spinning about y at -1 rad/s, and a kinematic ball
    (radius 2.5) at (10, 2, 10) spinning about y at 1 rad/s.  chan_free:
    the CDF mode (None: the construction-time heuristic)."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc

    bodies = ([RigidBodyDesc(Collider.halfspace(), (0.0, 0.0, 0.0))]
              + list(d.bodies_desc[1:5])
              + [RigidBodyDesc(Collider.capsule(28.0, 1.5), (0.0, 2.0, 0.0),
                               rotation=(np.pi / 2, 0.0, 0.0), body_type="kinematic",
                               angvel=(0.0, -1.0, 0.0)),
                 RigidBodyDesc(Collider.ball(2.5), (10.0, 2.0, 10.0),
                               body_type="kinematic", angvel=(0.0, 1.0, 0.0))])
    p = d.state.particles
    return MpmData(d.params, p, d.state.models, bodies, d.config.grid.cell_width,
                   grid=d.config.grid, chan_free=chan_free, **mpm_kw)


def full_scene_shapes(dev, chan_free=None, shift=None):
    """Path 5 at full size: the main path's 1,002,001-particle lattice,
    models, grid and job table size with the analytic-shapes bodies; shift
    moves the lattice."""
    d = full_scene(dev)
    if shift is not None:
        d.state.particles.pos += torch.tensor(shift, device=dev)
    return shapes_scene(d, chan_free, by=BY, group=GROUP, max_jobs=d.config.max_jobs)


def sixteen_colliders(device):
    """The JAX package's 16-collider scene (tests/test_pallas_transfer.py,
    test_pallas_16_colliders_affinity_bits): 15 static balls through a
    falling sand lattice and a floor cuboid last, so that the affinity
    words reach bits 15 and 31; by=4, group=128."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.models import DruckerPrager, ElasticCoefficients
    from wgsparkl_tpu_torch.models.drucker_prager import drucker_prager_arrays
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.scenes import _lattice
    from wgsparkl_tpu_torch.solver import Models, Particles

    pos = _lattice((8, 12, 8), 1.0, (-2.0, 1.2, -2.0))
    n = len(pos)
    elast = ElasticCoefficients.from_young_modulus(2.0e9, 0.2)
    dp = drucker_prager_arrays([DruckerPrager.new(2.0e9, 0.2)])
    models = Models.from_arrays(n, elast.lam, elast.mu,
                                dp={k: np.full(n, v[0]) for k, v in dp.items()},
                                device=device)
    rng = np.random.RandomState(7)
    bodies = [RigidBodyDesc(Collider.ball(0.55),
                            tuple(rng.uniform((-2.5, 0.5, -2.5), (2.5, 4.0, 2.5))))
              for _ in range(15)]
    bodies.append(RigidBodyDesc(Collider.cuboid(40.0, 1.0, 40.0), (0.0, -1.0, 0.0)))
    return MpmData(
        SimulationParams.new((1.0 / 60.0) / 20, [0.0, -9.81, 0.0], device=device),
        Particles.from_arrays(pos, density=2700.0, radius=0.25, device=device),
        models, bodies, 1.0,
        grid_bounds=(np.array([-8.0, -2.0, -8.0]), np.array([8.0, 12.0, 8.0])),
        group=128)


def all_kinematic(device):
    """Every collider kinematic (the per-substep dense node CDF): the small
    sand box lattice lowered 3 cells onto path 5's capsule paddle, over a
    halfspace floor sliding along x, with a ball spinning at its corner."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc

    d = scenes_small_3d(device, (0.0, -3.0, 0.0))
    bodies = [
        RigidBodyDesc(Collider.halfspace(), (0.0, 0.0, 0.0), body_type="kinematic",
                      linvel=(0.5, 0.0, 0.0)),
        RigidBodyDesc(Collider.capsule(28.0, 1.5), (0.0, 2.0, 0.0),
                      rotation=(np.pi / 2, 0.0, 0.0), body_type="kinematic",
                      angvel=(0.0, -1.0, 0.0)),
        RigidBodyDesc(Collider.ball(1.0), (2.0, 6.0, 2.0), body_type="kinematic",
                      angvel=(1.0, 0.0, 0.0)),
    ]
    return MpmData(d.params, d.state.particles, d.state.models, bodies, 1.0,
                   grid=d.config.grid, by=BY, group=256)


def example_scene(name, device, scale=1.0, shift=None, plates=None, vel=None,
                  max_stretch=None, **mpm_kw):
    """examples/<name>.py's scene from the port's runner
    (`wgsparkl_tpu_torch.examples.<name>.build(scale, device, **mpm_kw)`),
    with this script's variants applied to the built scene: shift moves the
    lattice, vel gives it a velocity, plates ((x, y), (x, y)) moves the two
    dynamic plates (bodies 6 and 7), max_stretch sets every particle's.  A
    varied scene is configured again from its varied particles, bodies and
    models, on the built grid (the chan-free heuristic reads positions)."""
    import importlib

    from wgsparkl_tpu_torch.pipeline import MpmData

    d = importlib.import_module(f"wgsparkl_tpu_torch.examples.{name}").build(
        scale, device, **mpm_kw)
    if shift is None and plates is None and vel is None and max_stretch is None:
        return d
    p, m, bodies = d.state.particles, d.state.models, list(d.bodies_desc)
    if shift is not None:
        p = dataclasses.replace(p, pos=p.pos + torch.tensor(shift, device=p.pos.device))
    if vel is not None:
        p = dataclasses.replace(p, vel=torch.tensor(vel, device=p.pos.device).expand_as(
            p.vel).clone())
    if plates is not None:
        bodies[6:8] = [dataclasses.replace(b, translation=tuple(x))
                       for b, x in zip(bodies[6:8], plates)]
    if max_stretch is not None:
        m = dataclasses.replace(m, max_stretch=torch.full_like(m.max_stretch,
                                                               max_stretch))
    return MpmData(d.params, p, m, bodies, d.config.grid.cell_width, grid=d.config.grid,
                   **mpm_kw)


def sand2_scene(device, scale=1.0, **kw):
    """Path 7: examples/sand2.py (the two-way coupling demo) at SCALE scale:
    a max(48, 700 scale)^2 Drucker-Prager lattice, a floor and two walls,
    three kinematic stirrers, two dynamic plates of density 500 and 2000,
    dt (1/60)/10 (example_scene's variants)."""
    return example_scene("sand2", device, scale, **kw)


def sand2_pressed(n_side):
    """Plate positions of path 7 for the rigid kernel's checks: the light
    plate sunk 0.05 (5 slops) into the floor, the heavy one on it, 0.2 to
    the side and sunk 0.05 into it (a dynamic-dynamic contact)."""
    e = n_side * 0.2 / 2
    return ((e * 0.4, 0.25), (e * 0.4 + 0.2, 0.8))


def cut2_scene(device, scale=1.0, **kw):
    """Path 9: examples/elastic_cut2.py at SCALE scale: a max(48, 700
    scale)^2 elastic block with fracture over a sine-wave polyline ground
    and six polyline blades, gravity x 2, dt (1/60)/15, group 256."""
    return example_scene("elastic_cut2", device, scale, **kw)


def cut3_scene(device, scale=1.0, **kw):
    """Path 10: examples/elastic_cut3.py at SCALE scale: a 50 x 30 x 50
    elastic block at SCALE 1 (75,000 particles) falling onto a cuboid floor
    and three thin trimesh blades, gravity x 4, dt (1/60)/20, group 256, by
    4."""
    return example_scene("elastic_cut3", device, scale, **kw)


def hf3_scene(device, scale=1.0, **kw):
    """Path 11: examples/heightfield3.py at SCALE scale: a 45 x 100 x 45
    Drucker-Prager lattice at SCALE 1 (202,500 particles) dropped on a 48 x
    48 random rolling heightfield (numpy default_rng(0)), dt (1/60)/20,
    group 256."""
    return example_scene("heightfield3", device, scale, **kw)


def ramp_scene(device, by=4, **mpm_kw):
    """tests/test_mesh_colliders.py `_mesh_scene` on the pallas path: an
    elastic 6^3 block 0.2 above a tilted two-triangle trimesh ramp, with a
    static cuboid floor, cell width 0.5, group 64."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.models import ElasticCoefficients
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    h = 0.5
    verts = np.array([[-4, 0.0, -4], [4, 1.6, -4], [4, 1.6, 4], [-4, 0.0, 4]], np.float32)
    ramp = Collider.trimesh(verts, np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    xs = np.arange(6) * h / 2 + h / 4
    g = np.meshgrid(xs - 0.75, xs + 0.95, xs - 0.75, indexing="ij")
    pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
    m = ElasticCoefficients.from_young_modulus(1e6, 0.2)
    return MpmData(SimulationParams.new(1 / 600, [0, -9.81, 0], device=device),
                   Particles.from_arrays(pos, density=1000.0, radius=h / 4, device=device),
                   Models.from_arrays(len(pos), m.lam, m.mu, phase=1.0, device=device),
                   [RigidBodyDesc(ramp, (0.0, 0.0, 0.0)),
                    RigidBodyDesc(Collider.cuboid(6.0, 0.5, 6.0), (0.0, -1.2, 0.0))],
                   h, grid_bounds=(np.array([-4.0, -2.0, -4.0]), np.array([4.0, 6.0, 4.0])),
                   group=64, by=by, **mpm_kw)


def tent_scene(device):
    """tests/test_mesh_colliders.py's 2D polyline tent over a cuboid floor
    (an elastic 10 x 10 block, cell width 0.5, group 64)."""
    import numpy as np

    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.models import ElasticCoefficients
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc
    from wgsparkl_tpu_torch.solver import Models, Particles

    h = 0.5
    poly = Collider.polyline(np.array([[-4.0, 0.0], [0.0, 1.0], [4.0, 0.0]], np.float32),
                             np.array([[0, 1], [1, 2]], np.int32))
    xs = np.arange(10) * h / 2 + h / 4
    g = np.meshgrid(xs - 1.25, xs + 1.2, indexing="ij")
    pos = np.stack([a.ravel() for a in g], -1).astype(np.float32)
    m = ElasticCoefficients.from_young_modulus(1e6, 0.2)
    return MpmData(SimulationParams.new(1 / 600, [0, -9.81], device=device),
                   Particles.from_arrays(pos, density=1000.0, radius=h / 4, device=device),
                   Models.from_arrays(len(pos), m.lam, m.mu, phase=1.0, device=device),
                   [RigidBodyDesc(poly, (0.0, 0.0)),
                    RigidBodyDesc(Collider.cuboid(6.0, 0.5), (0.0, -1.2))],
                   h, grid_bounds=(np.array([-4.0, -2.0]), np.array([4.0, 6.0])), group=64)


def paddle_scene(device):
    """The small sand box (sand_box_3d(nxz=8, ny=16)) lowered 3 cells, with
    its cuboid paddle replaced by a kinematic trimesh paddle (a 4 x 12 quad
    at the paddle's pose) spinning at 2 rad/s about y; by 8, group 256."""
    import numpy as np

    from wgsparkl_tpu_torch import scenes
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc

    d = scenes.sand_box_3d(nxz=8, ny=16, with_paddle=False, device=device)
    quad = Collider.trimesh(
        np.array([[0, -2, -6], [0, -2, 6], [0, 2, 6], [0, 2, -6]], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    paddle = RigidBodyDesc(quad, (0.0, 2.0, 0.0), rotation=(0.0, 0.0, -0.5),
                           body_type="kinematic", angvel=(0.0, -2.0, 0.0))
    p = d.state.particles
    p.pos -= torch.tensor([0.0, 3.0, 0.0], device=device)
    return MpmData(d.params, p, d.state.models, list(d.bodies_desc) + [paddle], 1.0,
                   grid=d.config.grid, by=BY, group=256)


def stirred_column(d, scale=1.0, chan_free=False, **mpm_kw):
    """Scene d's lattice, models, grid and floor (a sand_column_2d) with a
    kinematic ball and a kinematic capsule stirring the column's foot (the
    reference's sand2 stirrers): on the small column (nx=24, cell width
    0.5) a ball of radius 0.8 at (-1.5, 1.5) spinning at 1 rad/s and a
    capsule (half height 1.0, radius 0.3) at (1.5, 1.2), turned 1.2 rad
    and spinning at -1 rad/s; every length times `scale`.  chan_free: the
    CDF mode (False: the dense mode, which these colliders take)."""
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc

    s = scale
    bodies = list(d.bodies_desc) + [
        RigidBodyDesc(Collider.ball(0.8 * s), (-1.5 * s, 1.5 * s),
                      body_type="kinematic", angvel=1.0),
        RigidBodyDesc(Collider.capsule(1.0 * s, 0.3 * s), (1.5 * s, 1.2 * s),
                      rotation=1.2, body_type="kinematic", angvel=-1.0),
    ]
    return MpmData(d.params, d.state.particles, d.state.models, bodies,
                   d.config.grid.cell_width, grid=d.config.grid,
                   chan_free=chan_free, **mpm_kw)


def small_column_2d(device, shift=None, **mpm_kw):
    """The small 2D sand column of the CPU tests (24 x 48 at cell width
    0.5, group 128); shift moves its lattice."""
    from wgsparkl_tpu_torch import scenes

    d = scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, group=128,
                              device=device, **mpm_kw)
    if shift is not None:
        d.state.particles.pos += torch.tensor(shift, device=device)
    return d


def stirred_column_2d(device, chan_free=False):
    """The small 2D sand column stirred (stirred_column at scale 1)."""
    return stirred_column(small_column_2d(device), chan_free=chan_free, group=128)


def scenes_small_3d(device, shift=None, **kw):
    """The small 3D sand box of the CPU tests (8 x 16 x 8 lattice, by=8 and
    group=256 unless kw says otherwise); shift moves its lattice."""
    from wgsparkl_tpu_torch import scenes

    d = scenes.sand_box_3d(nxz=8, ny=16, device=device, **{"by": BY, "group": 256, **kw})
    if shift is not None:
        d.state.particles.pos += torch.tensor(shift, device=device)
    return d


def plates_3d(plates):
    """Path 8's two dynamic cuboid plates (12 x 1 x 12 cells, sand2's
    densities 500 and 2000) at the positions `plates`."""
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import RigidBodyDesc

    return [RigidBodyDesc(Collider.cuboid(6.0, 0.5, 6.0), tuple(xyz), rotation=rot,
                          body_type="dynamic", density=rho)
            for xyz, rot, rho in zip(plates, ((0.0, 0.2, 0.0), (0.0, -0.3, 0.0)),
                                     (500.0, 2000.0))]


def plates_on_top():
    """Path 8's plate positions: on the lattice's top surface (y = 5 + NY /
    2, 89.5 at full size) sunk one cell, 9 cells either side of the
    paddle."""
    y = 5.0 + NY / 2 - 0.5
    return ((-9.0, y, -9.0), (9.0, y, 9.0))


# For the rigid kernel's checks: the light plate sunk 2 slops into the
# floor and the heavy one on it, sunk 2 slops into it.
PLATES_3D_PRESSED = ((-12.0, 0.4, -12.0), (-7.0, 1.3, -7.0))


def full_scene_plates(dev, plates=None):
    """Path 8 at full size: the 3D main path (1,002,001 particles, its
    walls, paddle, grid and job table size) with the two dynamic plates of
    plates_3d: 8 bodies."""
    from wgsparkl_tpu_torch.pipeline import MpmData

    d = full_scene(dev)
    return MpmData(d.params, d.state.particles, d.state.models,
                   list(d.bodies_desc) + plates_3d(plates or plates_on_top()), 1.0,
                   grid=d.config.grid,
                   by=BY, group=GROUP, max_jobs=d.config.max_jobs)


def plate_joint_3d(device):
    """The small 3D sand box lattice (no paddle) lowered 4 cells onto a
    dynamic plate sunk 2 slops into the floor, the plate's top centre held
    by a ball joint to a fixed ball inside the lattice."""
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import MpmData, RigidBodyDesc

    d = scenes_small_3d(device, (0.0, -4.0, 0.0), with_paddle=False)
    bodies = list(d.bodies_desc) + [
        RigidBodyDesc(Collider.cuboid(1.2, 0.6, 1.2), (0.3, 0.5, -0.2),
                      rotation=(0.0, 0.3, 0.0), body_type="dynamic", density=2000.0),
        RigidBodyDesc(Collider.ball(0.3), (0.3, 3.0, -0.2))]
    return MpmData(d.params, d.state.particles, d.state.models, bodies, 1.0,
                   grid=d.config.grid, by=BY, group=256, chan_free=False,
                   joints=((5, 6, (0.0, 0.6, 0.0), (0.0, -1.9, 0.0)),))


def four_materials(d, shift, spin, stretch):
    """Scene d's lattice moved by shift (spinning at 1 rad/s when spin),
    bodies and grid with four materials striped by lane: lam x (1, 2, 1,
    1.5), mu x (1, 1, 0.5, 1), max_stretch -1 on stripe 0 and `stretch` on
    the others, every lane intact (phase 1): kernel C's fracture check
    fires (tests/test_torch_materials_fracture.py's scenes).  d's blocks,
    group and job table size."""
    import numpy as np

    from wgsparkl_tpu_torch.pipeline import MpmData
    from wgsparkl_tpu_torch.scenes import spin_velocities
    from wgsparkl_tpu_torch.solver import Models

    p, m = d.state.particles, d.state.models
    dev, n = p.pos.device, p.count
    stripe = np.arange(n) % 4
    lam = m.lam.cpu().numpy() * np.array([1.0, 2.0, 1.0, 1.5], np.float32)[stripe]
    mu = m.mu.cpu().numpy() * np.array([1.0, 1.0, 0.5, 1.0], np.float32)[stripe]
    models = Models.from_arrays(n, lam, mu, dp={k: v.cpu().numpy() for k, v in m.dp.items()},
                                phase=1.0, max_stretch=np.where(stripe == 0, -1.0, stretch),
                                device=dev)
    pos = p.pos + torch.tensor(shift, device=dev)
    vel = (torch.as_tensor(spin_velocities(p.pos.cpu().numpy()), device=dev) if spin
           else p.vel)
    p = dataclasses.replace(p, pos=pos, vel=vel)
    c = d.config
    return MpmData(d.params, p, models, d.bodies_desc, c.grid.cell_width, grid=c.grid,
                   by=c.by, group=c.group, max_jobs=c.max_jobs, chan_free=c.chan_free)


def joint_scenes():
    """(name, bodies, dim, joints) of tests/test_joints.py's scenes and a 2D
    scene of a ball, a fixed and a prismatic joint on a kinematic anchor."""
    from wgsparkl_tpu_torch.collision.shapes import Collider
    from wgsparkl_tpu_torch.pipeline import RigidBodyDesc

    D, z = "dynamic", (0.0, 0.0, 0.0)
    anchor = RigidBodyDesc(Collider.ball(0.1), (0.0, 10.0, 0.0))
    rod = RigidBodyDesc(Collider.cuboid(0.1, 1.0, 0.1), (1.0, 9.0, 0.0), body_type=D)
    yield "pendulum", [anchor, rod], 3, ((1, 0, (0.0, 1.0, 0.0), z),)
    yield "chain", [anchor,
                    RigidBodyDesc(Collider.cuboid(0.1, 0.5, 0.1), (0.5, 9.5, 0.0),
                                  body_type=D, density=800.0),
                    RigidBodyDesc(Collider.cuboid(0.1, 0.5, 0.1), (1.0, 8.5, 0.0),
                                  body_type=D, density=800.0)], 3, \
        ((1, 0, (0.0, 0.5, 0.0), z), (2, 1, (0.0, 0.5, 0.0), (0.0, -0.5, 0.0)))
    yield "fixed", [anchor, rod], 3, ((1, 0, (-1.0, 1.0, 0.0), z, "fixed"),)
    yield "revolute", [anchor, RigidBodyDesc(Collider.cuboid(1.0, 0.1, 0.1),
                                             (1.0, 10.0, 0.0), body_type=D)], 3, \
        ((1, 0, (-1.0, 0.0, 0.0), z, "revolute", (0.0, 0.0, 1.0)),)
    for ax in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.3, 0.2, 0.9)):
        yield f"prismatic {ax}", [anchor, RigidBodyDesc(
            Collider.cuboid(0.3, 0.2, 0.2), (0.0, 10.0, 0.0), rotation=(0.1, 0.0, 0.2),
            body_type=D)], 3, ((1, 0, z, z, "prismatic", ax),)
    yield "2D ball, fixed and prismatic", [
        RigidBodyDesc(Collider.ball(0.1), (0.0, 10.0), body_type="kinematic",
                      linvel=(0.1, 0.0), angvel=0.5),
        RigidBodyDesc(Collider.cuboid(0.1, 1.0), (1.0, 9.0), rotation=0.3, body_type=D),
        RigidBodyDesc(Collider.cuboid(0.1, 0.5), (1.5, 8.0), body_type=D)], 2, \
        ((1, 0, (0.0, 1.0), (0.0, 0.0)), (2, 1, (0.0, 0.5), (0.0, -1.0), "fixed"),
         (2, 0, (0.0, 0.0), (0.0, 0.0), "prismatic", (0.0, 1.0)))


def rigid_rig(descs, dim, joints, dev):
    """(bodies with fresh mass properties, params, config) of a bodies-only
    scene: every dynamic body contact-resolved, dt 1/240."""
    import numpy as np

    from wgsparkl_tpu_torch.grid import GridConfig
    from wgsparkl_tpu_torch.params import SimulationParams
    from wgsparkl_tpu_torch.pipeline import MpmConfig, _normalize_joints, build_rigid_world
    from wgsparkl_tpu_torch.rigid import body

    cfg = MpmConfig(grid=GridConfig.from_bounds(np.full(dim, -8.0), np.full(dim, 16.0), 0.5),
                    collider_types=tuple(d.collider.shape_type for d in descs),
                    dynamic_slots=tuple(i for i, d in enumerate(descs)
                                        if d.body_type == "dynamic"),
                    coupling=(2,) * len(descs),
                    joints=_normalize_joints(joints, descs, dim))
    params = SimulationParams.new(1.0 / 240, [0.0, -9.81, 0.0][:dim], device=dev)
    return (body.update_world_mass_properties(build_rigid_world(descs, dim, dev)),
            params, cfg)


@contextlib.contextmanager
def captured_rigid_solve():
    """Record the arguments of every rigid_solve call the pipeline makes
    in the block (and make it): yields the list."""
    from wgsparkl_tpu_torch import pipeline

    calls, real = [], pipeline.rigid_solve

    def capture(*args):
        calls.append(args)
        return real(*args)

    with swapped(pipeline, "rigid_solve", capture):
        yield calls


def active_pairs(world, tab):
    """{(b, c, two_way): active samples} of a rigid solve's inputs (plain
    candidates)."""
    from wgsparkl_tpu_torch.rigid import contacts

    B = contacts.BodyScalars(world)
    out = {}
    for pair in tab.pairs:
        _, _, depth = contacts.candidates(B, *pair[:4], tab.offsets)
        k = int((depth > 0.0).sum())
        if k:
            out[(pair[0], pair[2], pair[4])] = k
    return out


def rigid_cost(tab, world, active: int):
    """(bytes, flops) of a rigid solve: the world's pose, mass, shape and
    prescribed-velocity tables and the static tables read once, the
    velocities read and written; ~150 operations a contact sample's terms,
    ~190 an active sample's impulse a sweep, ~400 a joint's terms and ~110
    its impulse a sweep."""
    from wgsparkl_tpu_torch.rigid import contacts, joints

    nj = len(tab.joint_rows)
    k = len(tab.cand_t) if tab.pairs else 0
    read = sum(getattr(world, f).numel() for f in (
        "rot", "pos", "world_com", "inv_mass", "inv_inertia_world", "shape_params",
        "linvel", "angvel"))
    vel = world.linvel.numel() + world.angvel.numel()
    nbytes = 4 * (read + 2 * vel + tab.pair_t.numel() + 2 * k + tab.offsets.numel()
                  + nj * 19)
    flops = (150 * k + 190 * active * contacts.CONTACT_ITERATIONS + 400 * nj
             + 110 * nj * joints.JOINT_ITERATIONS)
    return nbytes, flops


def gate_histogram(rec) -> dict:
    """Live jobs of a recorded substep by gate level."""
    jb = rec["jbody"][rec["jobs"]["len"] > 0]
    return {lvl: int((jb == lvl).sum()) for lvl in (0, 1, 2)}


def _to(state, device):
    """A copy of a SimState with every tensor on `device`."""
    def mv(obj):
        return dataclasses.replace(obj, **{
            f.name: (getattr(obj, f.name).to(device)
                     if isinstance(getattr(obj, f.name), torch.Tensor)
                     else {k: v.to(device) for k, v in getattr(obj, f.name).items()}
                     if isinstance(getattr(obj, f.name), dict)
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)})

    return dataclasses.replace(state, particles=mv(state.particles),
                               models=mv(state.models), bodies=mv(state.bodies),
                               meshes=state.meshes and state.meshes.to(device))


def run_frames(wt, data, substeps, kernels, what, card, kind,
               frames=TIMED_FRAMES, gates=False):
    """One warm and `frames` timed frames through step_with_diag, with
    the launch counts set to 0 just before and read just after; gates:
    then print the job-gate histogram of one more substep.  Returns
    (launch counts, the last state)."""
    from wgsparkl_tpu_torch.pipeline import step_pallas, step_with_diag

    cfg, n = data.config, data.num_particles
    print(f"{what}: {n} particles, grid {cfg.grid.shape}, max_jobs "
          f"{cfg.max_jobs}, static slots {cfg.static_slots}", flush=True)
    wt.reset_launch_counts()
    state, diags = data.state, []
    t0 = time.time()
    state, diag = step_with_diag(state, data.params, cfg, substeps)
    diags.append(diag)
    torch.cuda.synchronize()
    print(f"{what}: warm frame ({substeps} substeps) {time.time() - t0:.2f} s",
          flush=True)
    t0 = time.time()
    for _ in range(frames):
        state, diag = step_with_diag(state, data.params, cfg, substeps)
        diags.append(diag)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = launches_run(wt)
    pos = state.particles.pos
    if tuple(pos.shape) != (n, cfg.grid.dim) or not bool(torch.isfinite(pos).all()):
        fail(f"{what}: non-finite or misshapen positions")
    for i, d in enumerate(diags):
        if d.any_overflow():
            fail(f"{what}: step diagnostics of frame {i} (0 = warm): {d.summary()}")
    if min(counts[k] for k in kernels) <= 0:
        fail(f"{what}: a kernel of the path never launched: {counts}")
    steps = frames * substeps
    sps = steps / elapsed
    print(f"{what} on {kind} ({card}): {n} particles, {steps} substeps in "
          f"{elapsed:.3f} s -> {sps:.3f} steps/s, {sps * n / 1e6:.2f} M "
          f"particle-updates/s; diag of all {len(diags)} frames OK; launches "
          f"{ {k: counts[k] for k in kernels} } ({launches_split(wt, kernels)})",
          flush=True)
    if cfg.sparse:
        print(f"{what}: at most {max(int(d.sparse_n_occ) for d in diags)} occupied "
              f"blocks (kmax {cfg.kmax}) and {max(int(d.sparse_n_active) for d in diags)} "
              f"active blocks (amax {cfg.amax}) in a substep", flush=True)
    if gates:
        rec = {}
        step_pallas(state, data.params, cfg, 1, record=rec)
        print(f"{what}: live jobs by gate level {gate_histogram(rec)} in a substep "
              "after the timed frames", flush=True)
    return counts, state


def csrc_kernels() -> dict:
    """{__global__ function of a csrc/*.cu file: the file's stem}: what a
    wrapper's launch runs (the kernels of the .cuh headers left out)."""
    import re

    from wgsparkl_tpu_torch import _cuda

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return {fn: name for name in _cuda.sources()
            for fn in pat.findall((_cuda._SRC / f"{name}.cu").read_text())}


def traced_kernels(run, names) -> collections.Counter:
    """run() and a synchronise under torch.profiler, the device's activity
    alone: {kernel of `names`: the launches of it CUPTI recorded}."""
    import os
    import re
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    pats = {fn: re.compile(rf"(?<![A-Za-z0-9_]){fn}(?![A-Za-z0-9_])") for fn in names}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            out.update(fn for fn, p in pats.items() if p.search(e["name"]))
    return out


def replay_traced(wt, frame, state, what):
    """A frame-graph replay held to CUPTI's record of it: (the problems
    found, a report line).  frame(state) -> state steps one kernel-path
    frame on the card.  Two frames capture the key and replay it; then the
    next frame runs from one state twice under the profiler: eagerly (a
    profiler keeps frames eager, pipeline.frame_graph_reason) and as a
    replay (that reason bound to None for it).  In each, the kernels of
    every csrc source that CUPTI records equal its wrappers' launches (one
    kernel a launch): the eager frame's host-issued; the replayed frame's
    host-issued (the pack, the unpack) plus those its
    replay adds (wt.replayed_launch_counts).  The two record the same
    kernels, and their states are bit-equal."""
    from wgsparkl_tpu_torch import pipeline

    names = csrc_kernels()
    # CUPTI sees a graph's kernels where it was set up before the capture.
    from torch.profiler import _utils as profiler_utils

    pipeline.drop_frame_graphs()
    profiler_utils._init_for_cuda_graphs()
    state = frame(frame(state))
    torch.cuda.synchronize()
    problems, runs = [], {}
    for how in ("eager", "replayed"):
        replays = pipeline.frame_graph_stats()["replays"]
        wt.reset_launch_counts()
        out, reason = [], pipeline.frame_graph_reason
        if how == "replayed":
            pipeline.frame_graph_reason = lambda *a, **k: None
        try:
            traced = traced_kernels(lambda: out.append(frame(state)), names)
        finally:
            pipeline.frame_graph_reason = reason
        if pipeline.frame_graph_stats()["replays"] - replays != (how == "replayed"):
            problems.append(f"{what}: the {how} frame ran "
                            f"{pipeline.frame_graph_stats()['replays'] - replays} replays")
        by_source = collections.Counter()
        for fn, c in traced.items():
            by_source[names[fn]] += c
        counted = collections.Counter()
        for k, c in launches_run(wt).items():
            counted[SOURCE.get(k, k)] += c
        counted = +counted
        if by_source != counted:
            problems.append(f"{what}: the {how} frame's csrc kernels by source, CUPTI "
                            f"{dict(by_source)}, the launch counts {dict(counted)}")
        runs[how] = (out[0], traced, launches_split(wt, sorted(
            k for k, c in launches_run(wt).items() if c)))
    if runs["eager"][1] != runs["replayed"][1]:
        problems.append(f"{what}: CUPTI's kernels eager {dict(runs['eager'][1])}, "
                        f"replayed {dict(runs['replayed'][1])}")
    for a, b in zip(*(pipeline._leaves(runs[h][0]) for h in runs)):
        if a.shape != b.shape or not torch.equal(a, b):
            problems.append(f"{what}: the replayed frame's state differs from the eager one")
            break
    report = (f"{what}: CUPTI trace of a replayed frame: {sum(runs['replayed'][1].values())} "
              f"csrc kernel launches {dict(runs['replayed'][1])}, as many as the eager "
              f"frame's; the counts {runs['replayed'][2]}; state bit-equal to the eager "
              "frame's")
    return problems, report


def mesh_inputs(data, state):
    """The mesh pass's inputs at state's body poses: (world samples, world
    vertices, primitives, slots, grid, by)."""
    from wgsparkl_tpu_torch.ops import rigid_cdf
    from wgsparkl_tpu_torch.rigid import body as body_mod

    bodies = body_mod.update_world_mass_properties(state.bodies)
    sw, vw = rigid_cdf.world_transform(state.meshes, bodies)
    m, cfg = state.meshes, data.config
    return sw, vw, m.sample_prim, m.sample_cid, cfg.grid, cfg.by


def mesh_paths(wt, card, kind, launches, frames=TIMED_FRAMES_SHORT):
    """Paths 9-11 (elastic_cut2, elastic_cut3, heightfield3 at full size):
    one warm and `frames` timed frames each, exactly one mesh_cdf launch a
    substep, and a mesh pass with finite keys at the last state."""
    from wgsparkl_tpu_torch.ops import rigid_cdf

    for tag, make, substeps, kernels, what in (
            ("mesh_cdf2d", lambda: cut2_scene(DEVICE, N_CUT2 / 700), SUBSTEPS_CUT2,
             KERNELS_9,
             "path 9: elastic_cut2"),
            ("mesh_cdf", lambda: cut3_scene(DEVICE, CUT3_SCALE), SUBSTEPS, KERNELS_10,
             "path 10: elastic_cut3"),
            ("mesh_cdf_heightfield", lambda: hf3_scene(DEVICE, HF3_SCALE), SUBSTEPS,
             KERNELS_10, "path 11: heightfield3")):
        data = make()
        cfg = data.config
        if cfg.cdf_chan_free or not cfg.mesh_cids or set(cfg.mesh_cids) & set(
                cfg.static_slots):
            fail(f"{what}: built as {cfg}")
        print(f"{what}: {data.state.meshes.count} mesh samples of slots "
              f"{cfg.mesh_cids}, grid {cfg.grid.shape}", flush=True)
        counts, state = run_frames(wt, data, substeps, kernels, what, card, kind,
                                   frames, gates=True)
        if counts["mesh_cdf"] != (1 + frames) * substeps:
            fail(f"{what}: {counts['mesh_cdf']} mesh_cdf launches, not one a substep "
                 f"({(1 + frames) * substeps})")
        key, word = rigid_cdf.mesh_node_cdf(*mesh_inputs(data, state))
        fin = int((key < rigid_cdf.INF_KEY).sum())
        if fin < 100 or not bool((word != 0).any()):
            fail(f"{what}: the mesh pass is empty ({fin} finite keys)")
        frac = ("" if tag == "mesh_cdf_heightfield" else
                f"; {int((state.models.phase == 0.0).sum())} of {data.num_particles} "
                "lanes fractured")
        print(f"{what}: {fin} nodes with a mesh key{frac}", flush=True)
        launches[tag] = counts["mesh_cdf"]
        if tag == "mesh_cdf2d":
            launches["p2g2d_mesh"] = counts["p2g2d"]
        elif tag == "mesh_cdf":
            launches["p2g_cdf_mesh"] = counts["p2g_cdf"]
        del data, state, key, word
        torch.cuda.empty_cache()


def main() -> None:
    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    try:
        import wgsparkl_tpu_torch as wt
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")
    from wgsparkl_tpu_torch import _cuda, scenes
    from wgsparkl_tpu_torch.math import probe
    from wgsparkl_tpu_torch.ops import (
        ablation, compact, g2p, p2g, p2g_cdf, permute, transfer2d, update_rows,
    )
    from wgsparkl_tpu_torch.ops import blocked as bk
    from wgsparkl_tpu_torch.ops import rows as R
    from wgsparkl_tpu_torch.ops import rows2d as R2
    from wgsparkl_tpu_torch.pipeline import step_pallas, step_with_diag

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)

    def mark(what):
        """Where the run's time goes: seconds since the start at each
        section."""
        print(f"-- {what} from {time.time() - t_start:.1f} s", flush=True)

    # ---- 1. build ----
    t0 = time.time()
    ptxas = ptxas_reports(_cuda, {"pcdf2d": "pcdf2d_kernel", "g2p2d": "g2p2d_kernel",
                                  "compact": "compact_kernel"})
    _cuda.build(_cuda.sources())
    for name in _cuda.sources():
        _cuda.load(name)
    for name, lines in ptxas().items():
        print(f"ptxas {name}: {'; '.join(lines)}", flush=True)
    print(f"built {len(_cuda.sources())} kernel sources in {time.time() - t0:.1f} s",
          flush=True)

    # Launches per kernel entry of the result line: each from the run of
    # the path that drives it.
    launches = {}
    mark("paths 2-4")
    # ---- 2. the 3D main path at full size ----
    counts, _ = run_frames(wt, full_scene(dev), SUBSTEPS, KERNELS_3D,
                           "3D main path", card, kind, gates=True)
    launches.update((k, counts[k]) for k in KERNELS_3D)
    torch.cuda.empty_cache()
    # The same with the grid update folded into kernel B.
    counts, _ = run_frames(wt, full_scene(dev, fold_vel=True), SUBSTEPS,
                           KERNELS_3D, "3D main path (fold_vel)", card, kind,
                           TIMED_FRAMES_SHORT, gates=True)
    launches["g2p_fold"] = counts["g2p"]
    torch.cuda.empty_cache()
    # ---- 3. the 3D collider-free path at full size ----
    data = full_scene_free(dev)
    counts, state = run_frames(wt, data, SUBSTEPS, KERNELS_FREE,
                               "3D collider-free path", card, kind)
    launches["p2g"] = counts["p2g"]
    if counts["p2g_cdf"] or counts["pcdf2d"]:
        fail(f"3D collider-free path: a particle-CDF kernel launched: {counts}")
    # Kernel F's inputs: a substep after the timed frames.
    rec_f = {}
    step_pallas(state, data.params, data.config, 1, record=rec_f)
    cfg_f = data.config
    del data, state
    torch.cuda.empty_cache()
    # ---- 4. the 2D paths at full size: sand column, neo-Hookean blocks ----
    counts, _ = run_frames(wt, full_scene_2d(dev), SUBSTEPS2, KERNELS_2D,
                           "2D path", card, kind)
    launches.update((k, counts[k]) for k in KERNELS_2D if k != "scatter_pull")
    launches["scatter_pull2d"] = counts["scatter_pull"]
    torch.cuda.empty_cache()
    # A replayed frame of each main path against CUPTI's record of it.
    if dev.type == "cuda":
        for make, substeps, what in ((full_scene, SUBSTEPS, "3D main path"),
                                     (full_scene_2d, SUBSTEPS2, "2D path")):
            data = make(dev)
            problems, report = replay_traced(
                wt, lambda st: step_pallas(st, data.params, data.config, substeps),
                data.state, what)
            if problems:
                fail("; ".join(problems))
            print(report, flush=True)
            del data
            torch.cuda.empty_cache()
    counts, _ = run_frames(wt, full_scene_2d(dev, fold_vel=True), SUBSTEPS2,
                           KERNELS_2D, "2D path (fold_vel)", card, kind,
                           TIMED_FRAMES_SHORT, gates=True)
    launches["g2p2d_fold"] = counts["g2p2d"]
    torch.cuda.empty_cache()
    # Path 6: the stirred column, dense (the default for its colliders),
    # then chan-free.
    for chan_free in (False, True):
        data = full_scene_stirred_2d(dev, chan_free)
        if data.config.chan_free != chan_free or data.config.static_slots != (0,):
            fail(f"path 6: built as {data.config}")
        mode = "chan-free" if chan_free else "dense"
        counts, _ = run_frames(wt, data, SUBSTEPS2, KERNELS_2D,
                               f"2D stirred column ({mode})", card, kind,
                               TIMED_FRAMES_SHORT, gates=True)
        if not chan_free:
            launches["pcdf2d_dense"] = counts["pcdf2d"]
        del data
        torch.cuda.empty_cache()
    launches.update((f"{k}_chan_free", counts[k]) for k in KERNELS_2D[:3])
    data = full_scene_neo_2d(dev)
    counts, state = run_frames(wt, data, SUBSTEPS_NEO2, KERNELS_2D,
                               "2D neo-Hookean path", card, kind)
    launches["update_rows2d_neo_hookean"] = counts["update_rows2d"]
    launches["p2g2d_neo"] = counts["p2g2d"]
    rec_n = {}
    step_pallas(state, data.params, data.config, 1, record=rec_n)
    rec_n["cfg"], rec_n["dt"] = data.config, data.params.dt
    del data, state
    torch.cuda.empty_cache()
    counts, _ = run_frames(wt, full_scene_dense_2d(dev), SUBSTEPS2, KERNELS_2D,
                           "2D column at 36 particles a cell", card, kind,
                           TIMED_FRAMES_SHORT)
    launches["p2g2d_chunks"] = counts["p2g2d"]
    torch.cuda.empty_cache()
    mark("path 5")
    # ---- 5. path 5: the 3D analytic shapes at full size, both CDF modes ----
    data = full_scene_shapes(dev)
    if data.config.chan_free:
        fail("path 5: the CDF-mode heuristic picked chan-free, not the gathered hybrid")
    for tag, frames in (("shapes", TIMED_FRAMES), ("chan_free", TIMED_FRAMES_SHORT)):
        if tag == "chan_free":
            data = full_scene_shapes(dev, chan_free=True)
        mode = "chan-free" if data.config.chan_free else "gathered"
        counts, _ = run_frames(wt, data, SUBSTEPS, KERNELS_3D,
                               f"3D analytic-shapes path ({mode})", card, kind,
                               frames, gates=True)
        launches[f"p2g_cdf_{tag}"] = counts["p2g_cdf"]
        launches[f"g2p_{tag}"] = counts["g2p"]
        del data
        torch.cuda.empty_cache()

    mark("paths 7-8")
    # ---- path 7: examples/sand2.py at SCALE=1 (dynamic plates, 2D) ----
    # ---- path 8: the 3D main path with two dynamic plates ----
    for tag, make, substeps, kernels, what, plates in (
            ("rigid_solve", lambda: sand2_scene(dev, N_SAND2 / 700, group=GROUP2),
             SUBSTEPS2, KERNELS_7,
             "path 7: sand2 with dynamic plates", (6, 7)),
            ("rigid_solve_3d", lambda: full_scene_plates(dev), SUBSTEPS, KERNELS_8,
             "path 8: 3D main path with dynamic plates", (6, 7))):
        data = make()
        pos0 = data.state.bodies.pos.clone()
        counts, state = run_frames(wt, data, substeps, kernels, what, card, kind,
                                   TIMED_FRAMES_SHORT, gates=True)
        body = torch.cat([state.bodies.pos, state.bodies.rot, state.bodies.linvel,
                          state.bodies.angvel], 1)
        moved = (state.bodies.pos[list(plates)] - pos0[list(plates)]).norm(dim=1)
        mode = ("chan-free" if data.config.chan_free
                else "gathered hybrid" if data.config.grid.dim == 3 else "dense")
        print(f"{what}: CDF mode {mode}; plates moved {moved.tolist()}; plate positions "
              f"{state.bodies.pos[list(plates)].tolist()}", flush=True)
        if not bool(torch.isfinite(body).all()) or not bool((moved > 0.0).all()):
            fail(f"{what}: non-finite body state or a plate that did not move")
        if counts["rigid_solve"] != (1 + TIMED_FRAMES_SHORT) * substeps:
            fail(f"{what}: {counts['rigid_solve']} rigid-solve launches, not one a "
                 f"substep ({(1 + TIMED_FRAMES_SHORT) * substeps})")
        launches[tag] = counts["rigid_solve"]
        if tag == "rigid_solve":
            # The rigid update of a substep issues no host sync (a pageable
            # host-to-device copy would be one).
            from wgsparkl_tpu_torch import pipeline

            got, real = [], pipeline.rigid_bodies_update
            with swapped(pipeline, "rigid_bodies_update",
                         lambda *a: got.append(a) or real(*a)):
                step_pallas(state, data.params, data.config, 1)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                real(*got[0])
            except RuntimeError as e:
                fail(f"{what}: the rigid update synchronises with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            print(f"{what}: the rigid update of a substep ran under "
                  "torch.cuda.set_sync_debug_mode('error') with no host sync", flush=True)
        del data, state
        torch.cuda.empty_cache()
    mark("paths 9-11")
    # ---- paths 9-11: mesh colliders at full size ----
    mesh_paths(wt, card, kind, launches)
    mark("paths 12-12b")
    # ---- path 12: the 3D main path in the sparse domain ----
    data = full_scene_sparse(dev)
    cfg = data.config
    if not cfg.sparse or cfg.by != BY_SPARSE:
        fail(f"path 12: built as {cfg}")
    print(f"path 12: sparse domain, kmax {cfg.kmax}, amax {cfg.amax}, CDF mode "
          f"{'chan-free' if cfg.cdf_chan_free else 'slot channel grid'} (the "
          "construction-time pick)", flush=True)
    counts, state = run_frames(wt, data, SUBSTEPS, KERNELS_SPARSE,
                               "path 12: sparse 3D main path", card, kind,
                               TIMED_FRAMES_SHORT, gates=True)
    if counts["scatter_pull"]:
        fail(f"path 12: {counts['scatter_pull']} scatter_pull launches: the sparse "
             "domain's slot scatter is add_rows")
    launches.update((f"{k}_sparse", counts[k]) for k in ("p2g_cdf", "g2p", "update_rows"))
    del data, state
    torch.cuda.empty_cache()
    # Path 12b: path 11 (heightfield3 at SCALE=1) built sparse, the slot
    # channel grid with the mesh pass's slot entry every substep.
    data = hf3_scene(dev, HF3_SCALE, sparse=True)
    cfg = data.config
    if not cfg.sparse or not cfg.mesh_cids or cfg.cdf_chan_free:
        fail(f"path 12b: built as {cfg}")
    counts, state = run_frames(wt, data, SUBSTEPS, KERNELS_SPARSE,
                               "path 12b: heightfield3 built sparse", card, kind,
                               TIMED_FRAMES_SHORT)
    if counts["mesh_cdf_sparse"] != (1 + TIMED_FRAMES_SHORT) * SUBSTEPS:
        fail(f"path 12b: {counts['mesh_cdf_sparse']} mesh_cdf_sparse launches, not "
             f"one a substep ({(1 + TIMED_FRAMES_SHORT) * SUBSTEPS})")
    launches["mesh_cdf_sparse"] = counts["mesh_cdf_sparse"]
    del data, state
    torch.cuda.empty_cache()
    mark("paths 13-14")
    # ---- paths 13, 13w, 13b, 14: the dense and blocked transfers ----
    dense_paths(wt, card, kind, launches)
    mark("path 17")
    substep_paths(wt, card, kind, launches)
    mark("path 16")
    # ---- path 16: the config-3 dam break through the host surfaces ----
    dam_break_path(wt, card, kind)
    mark("paths 15-15d")
    # ---- paths 15-15d: multi-device stepping, ranks sharing the card ----
    records = {}
    parallel_paths(wt, card, kind, launches, records)

    checks = []

    def check(name, run_k, run_p, pairs, exact=(), require=None, cost=None,
              library=None):
        """The kernel must give the same bits on two launches.
        pairs(k, p) -> [(label, kernel tensor, plain tensor, rtol)]: each
        must agree within rtol * max(1, max |plain|); exact(k, p) -> pairs
        that must be equal bit for bit; require(p) -> an error message when
        the plain output does not exercise the kernel; cost -> (bytes,
        flops) the function needs on these inputs; library -> one PyTorch
        call computing the same function, timed as a yardstick."""
        out_k = run_k()
        again = run_k()
        out_p = run_p()
        torch.cuda.synchronize()
        why = require(out_p) if require else None
        if why:
            fail(f"{name}: {why}")
        as_tuple = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
        if not all(torch.equal(a, b) for a, b in zip(as_tuple(out_k), as_tuple(again))):
            fail(f"{name}: two launches on the same inputs differ")
        for label, a, b in (exact(out_k, out_p) if exact else ()):
            if not torch.equal(a, b):
                e = float((a.double() - b.double()).abs().max())
                fail(f"{name}: {label} differs from the plain version (max {e:.3e})")
        err, bad, lines = 0.0, [], []
        for label, a, b, rtol in pairs(out_k, out_p):
            e = float((a.double() - b.double()).abs().max())
            tol = rtol * max(1.0, float(b.abs().max()))
            if not e <= tol:
                bad.append(f"{label}: max abs err {e:.3e} > tolerance {tol:.3e}")
            err = max(err, e)
            lines.append((e, f"{name} {label}: max abs err {e:.3e} "
                             f"(tolerance {tol:.3e})"))
        # Every pair when there are few, else the worst.
        for _, line in (lines if len(lines) <= 3 else [max(lines)]):
            print(line, flush=True)
        if bad:
            fail(f"{name} disagrees with its plain version: " + "; ".join(bad))
        ms = cuda_ms(run_k)
        plain_ms = cuda_ms(run_p, reps=2)
        library_ms = cuda_ms(library) if library else None
        bound_ms, bound_by = bound(*cost)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms if library_ms is None else round(library_ms, 4)} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {cost[0] / 1e6:.1f} MB, "
              f"{cost[1] / 1e9:.3f} GFLOP)", flush=True)
        checks.append({"name": name, "route": "cuda",
                       "source": f"wgsparkl_tpu_torch/csrc/{SOURCE.get(name, name)}.cu",
                       "replaces": REPLACES[name], "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms})

    def g2p_cost(ce, pg, nj, njg, wv, tiles=True, fold=False, evals=0):
        """Kernel B's (bytes, flops): 3 position rows a covered particle and
        8 more (velocity, normal, affinity) a particle of a gated job, the
        live jobs' grid tiles (3 velocity columns; with fold momentum and
        mass), the gated jobs' node tiles (none chan-free), 12 rows out a
        particle; ~27 x 24 operations a particle, ~27 x 40 more in a gated
        job, ~12 a window node to fold, CDF_OPS a collider's CDF at a
        node."""
        return (4 * (3 * ce + 8 * pg + nj * wv * (4 if fold else 3)
                     + (njg * wv * 4 if tiles else 0) + 12 * ce),
                ce * (30 + 27 * 24) + pg * 27 * 40 + (nj * wv * 12 if fold else 0)
                + evals * CDF_OPS)

    def p2g2d_cost(ce, pg, nj, njg, nc, tiles=True, evals=0):
        """Kernel H's (bytes, flops): 9 rows a covered particle (position,
        velocity, mass, affine matrix) and 4 more (normal, affinity) a
        particle of a gated job, 3 columns of the gated jobs' node tiles
        (none chan-free), the tiles' 3 columns out, the gated jobs'
        impulses; 9 pairs of 7 multiply-adds a particle, ~31 more
        operations a pair in a gated job, CDF_OPS_2D a collider's CDF at a
        node."""
        return (4 * (9 * ce + 4 * pg + (njg * 100 * 3 if tiles else 0)
                     + nj * 100 * 3 + njg * 3 * nc),
                ce * (20 + 9 * 7 * 2) + pg * 9 * 31 + evals * CDF_OPS_2D)

    def g2p2d_cost(ce, pg, nj, njg, width, tiles=True, fold=False, evals=0):
        """Kernel I's (bytes, flops): 2 position rows a covered particle and
        6 more (velocity, normal, affinity) a particle of a gated job, the
        live jobs' grid tiles (2 velocity columns; with fold momentum and
        mass), 3 columns of the gated jobs' node tiles (none chan-free),
        all 8 rows of the output's width written; 9 nodes of 16 operations
        a particle, 9 x 37 more in a gated job, 8 a window node to fold,
        CDF_OPS_2D a collider's CDF at a node."""
        return (4 * (2 * ce + 6 * pg + nj * 100 * (3 if fold else 2)
                     + (njg * 100 * 3 if tiles else 0) + 8 * width),
                ce * (12 + 9 * 16) + pg * 9 * 37 + (nj * 100 * 8 if fold else 0)
                + evals * CDF_OPS_2D)

    def pcdf2d_cost(pg, njg, nc, width, npad, tiles=True, evals=0):
        """Kernel G's (bytes, flops): 4 rows a particle of a gated job
        (position, affinity), 3 columns of the gated jobs' node tiles (none
        chan-free), all 8 rows of the output's width and the 4 patched rows
        of the NPAD particle lanes written; ~9 x (3 nc + 22) + 80 operations
        a particle of a gated job, CDF_OPS_2D a collider's CDF at a node."""
        return (4 * (4 * pg + (njg * 100 * 3 if tiles else 0) + 8 * width + 4 * npad),
                pg * (9 * (3 * nc + 22) + 80) + evals * CDF_OPS_2D)

    def check_pcdf2d(name, args, stats, tiles=True, evals=0):
        """Kernel G as the 2D substep calls it, patching the sorted rows in
        place: its particle-CDF rows and the patched rows bit for bit.  A
        side's first two calls patch fresh copies of args[0]; later calls
        (the timing) patch the second copy again, the same work."""
        def in_place(fn):
            fresh = [args[0].clone(), args[0].clone()]
            rows = []

            def run():
                if fresh:
                    rows[:] = [fresh.pop()]
                return fn(rows[0], *args[1:]), rows[0]
            return run

        _, pg, _, njg = stats
        npad = args[0].shape[1]
        check(name, in_place(transfer2d.pcdf_rows), in_place(transfer2d.pcdf_plain),
              lambda k, p: [], lambda k, p: [("rows", k[0], p[0]),
                                             ("patched rows", k[1], p[1])],
              lambda p: (None if int((p[0][0] != 0).sum()) > 100
                         else "few particles near a collider"),
              cost=pcdf2d_cost(pg, njg, args[8], npad + GROUP2 + 128, npad, tiles, evals))

    def job_stats(rec):
        """(covered particles, of them in gated jobs, live jobs, gated live
        jobs) of a recorded substep."""
        ln, jb = rec["jobs"]["len"], rec["jbody"]
        live = ln > 0
        return (int(rec["covered_end"]), int(ln[live & (jb > 0)].sum()),
                int(live.sum()), int((live & (jb > 0)).sum()))

    def check_scatter(name, rec, cfg):
        """The window scatter's pull on a recorded substep, every grid row
        (the ghost's included) bit for bit against the plain version and
        add_rows into zeros (index_put_(accumulate=True), the library
        yardstick), and its mass channel against the substep's own grid
        (whose momentum the substep turned into velocity).  Bytes: the live jobs' window rows
        read once (one 16-byte load a node), the grid written once, cum and
        the live jobs' blocks read."""
        d, nb = cfg.grid.dim, bk.num_blocks(cfg.grid, cfg.by)
        mm, src, shape = rec["mm"], rec["src"], tuple(rec["grid_mm"].shape)
        nbt, bsd = shape[0] - 1, shape[1]
        pull = (rec["jobs"]["block"], rec["cum"], nb, cfg.by)
        live = int((rec["jobs"]["len"] > 0).sum())

        def library():
            return bk.scatter_tiles(torch.zeros(shape, device=dev), mm, src)

        added = library()
        print(f"{name} inputs: {live} live jobs of {src.shape[0]}, {nbt} blocks of "
              f"{bsd} nodes, {int((added[nbt] != 0).any(-1).sum())} ghost nodes "
              "nonzero", flush=True)
        bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
        check(name,
              lambda: bk.scatter_tiles_pull(torch.empty(shape, device=dev), mm, *pull),
              lambda: bk.scatter_tiles_pull_plain(torch.empty(shape, device=dev), mm,
                                                  *pull),
              lambda k, p: [],
              lambda k, p: [("grid", bits(k), bits(p)),
                            ("substep's mass", bits(k[..., d]),
                             bits(rec["grid_mm"][..., d])),
                            ("add_rows", bits(k), bits(added))],
              lambda p: None if live else "no live job",
              cost=(16 * live * src.shape[1] + 4 * (nbt + 1) * bsd * (d + 1)
                    + 4 * (nbt + live), 0),
              library=library)

    mark("phase 5")
    # ---- 5a. 3D kernels vs plain versions at full size, under contact load ----
    # The 3D scene with its lattice lowered 3 cells onto the paddle: the
    # main path's shapes, with gated jobs whose CPIC impulses are nonzero.
    data = full_scene(dev)
    cfg = data.config
    data.state.particles.pos += torch.tensor([0.0, -3.0, 0.0], device=dev)
    state, diag = step_with_diag(data.state, data.params, cfg, 2)
    rec = {}
    step_pallas(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    if diag.any_overflow():
        fail(f"step diagnostics of the lowered scene: {diag.summary()}")
    h, npad = cfg.grid.cell_width, rec["rows"].shape[1]
    nc = cfg.num_colliders
    # The substep patched the particle CDF into pdata after kernel A ran:
    # kernel A reads the rows as they were before (rows 0..23 of the sorted
    # matrix), kernel B the patched ones.
    args_a = (rec["rows"][:24].contiguous(), rec["ntiles"], rec["btable"],
              rec["jobs"], rec["bcells"], rec["jbody"], h, BY, GROUP, npad, nc,
              rec["moving"])
    args_b = (rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"],
              rec["jobs"], rec["bcells"], rec["jbody"], h, BY, GROUP, npad, nc,
              rec["moving"])
    nb_total = rec["nb_total"]
    args_c = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
              rec["covered_end"], rec["btable"], rec["mtable"], data.params.dt,
              h, nc, max(cfg.n_materials, 1), nb_total)
    sids = rec["sorted_ids"]
    is_first = torch.ones_like(sids, dtype=torch.bool)
    is_first[1:] = sids[1:] != sids[:-1]
    vals_e = torch.clamp(sids, max=nb_total + 1).to(torch.float32)[None, :]
    cap_e = min(nb_total + 3, npad)
    ce, pg, nj, njg = job_stats(rec)
    wv = rec["ntiles"].shape[1]
    n_first = int(is_first.sum())
    print(f"3D kernel inputs: {ce} covered particles ({pg} in gated jobs), "
          f"{nj} live jobs ({njg} gated; by gate level {gate_histogram(rec)}), "
          f"NPAD {npad}", flush=True)

    # Costs, counted from these inputs: 4 bytes a float read or written once;
    # f32 operations per particle and stencil node from the kernel sources.
    # Tolerances: kernel A's window tiles and impulses follow the plain
    # version's order of sums bit for bit (the lists order; the impulses
    # over window nodes in node order, then over jobs in job order); the
    # per-particle outputs of A and B follow the plain operation order (B's
    # bit for bit); C differs from its plain version only through libm
    # (expf, logf, sinf); D and E move integers and must be exact.
    lib_a, n_pairs = tile_pairs_library(rec["rows"], rec["jobs"], rec["bcells"], h,
                                        R.window_geom(BY)[0], rec["jobs"]["len"].shape[0])
    print(f"p2g_cdf library yardstick: {n_pairs} (particle, node) pairs", flush=True)
    check("p2g_cdf",
          lambda: p2g_cdf.p2g_cdf_tiles(*args_a),
          lambda: p2g_cdf.p2g_cdf_plain(*args_a),
          lambda k, p: [("mm tiles", k[0], p[0], 1e-5),
                        ("impulses", k[1], p[1], 1e-4),
                        ("particle cdf", k[2][:, :ce], p[2][:, :ce], 1e-5)],
          lambda k, p: [("affinity rows", k[2][[0, 5]], p[2][[0, 5]]),
                        ("mm tiles", k[0], p[0]), ("impulses", k[1], p[1])],
          lambda p: (None if float(p[1].abs().max()) > 1.0
                     else "the plain impulses are ~0: no contact load"),
          cost=(4 * (24 * ce + nj * wv * 4 + nj * wv * 8 + 8 * ce + njg * 8 * 128),
                ce * (30 + 27 * 13 * 2) + pg * (27 * (3 * nc + 58) + 200)),
          library=lib_a)
    del lib_a
    check("g2p",
          lambda: g2p.g2p_rows(*args_b), lambda: g2p.g2p_plain(*args_b),
          lambda k, p: [], lambda k, p: [("rows", k[:, :ce], p[:, :ce])],
          cost=g2p_cost(ce, pg, nj, njg, wv))
    # Kernel B folded, on the same substep with the grid update left to it:
    # its tiles hold raw momentum and mass, and it folds each window node
    # once (~12 operations) as the plain version does, bit for bit.
    rec_fold = {}
    step_pallas(state, data.params, dataclasses.replace(cfg, fold_vel=True), 1,
                record=rec_fold)
    args_bf = ((rec_fold["pdata"], rec_fold["ftiles"]) + args_b[2:]
               + ((), False, True))
    check("g2p_fold",
          lambda: g2p.g2p_rows(*args_bf), lambda: g2p.g2p_plain(*args_bf),
          lambda k, p: [], lambda k, p: [("rows", k[:, :ce], p[:, :ce])],
          cost=g2p_cost(ce, pg, nj, njg, wv, fold=True))
    del rec_fold, args_bf
    # Lanes whose F the Drucker-Prager return map replaced: their plastic
    # state rows change (the plain output against the input).  Kernel C
    # decomposes such a lane's F a second time, and so does its whole warp.
    plain_c = update_rows.update_plain(*args_c)
    dps = slice(R.R_DPS0, R.R_DPS0 + 3)
    proj = (plain_c[dps] != rec["rows"][dps]).any(0)
    warps = proj[:npad // 32 * 32].reshape(-1, 32).any(1)
    print(f"update_rows inputs: Drucker-Prager replaced F on "
          f"{float(proj[:ce].float().mean()):.4f} of the covered lanes; "
          f"{float(warps.float().mean()):.4f} of the 32-lane warps hold such a lane",
          flush=True)
    del plain_c, proj, warps
    check("update_rows",
          lambda: update_rows.update_rows(*args_c),
          lambda: update_rows.update_plain(*args_c),
          lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
          lambda k, p: [(f"row {r}", k[r], p[r]) for r in (16, 20, 21, 22)],
          cost=c_cost(C_ROWS_READ_3D, 12, 6, rec["rows"].shape[0], npad, ce, 6000))
    # The neo-Hookean branch (one SVD fewer, a determinant and a logf).
    check("update_rows_neo_hookean",
          lambda: update_rows.update_rows(*args_c, elastic_model="neo_hookean"),
          lambda: update_rows.update_plain(*args_c, elastic_model="neo_hookean"),
          lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
          lambda k, p: [(f"row {r}", k[r], p[r]) for r in (16, 20, 21, 22)],
          cost=c_cost(C_ROWS_READ_3D, 12, 6, rec["rows"].shape[0], npad, ce, 4500))
    check("permute",
          lambda: permute.permute_lanes(rec["unsorted"], rec["perm"]),
          lambda: permute.permute_plain(rec["unsorted"], rec["perm"]),
          lambda k, p: [], lambda k, p: [("rows", k, p)],
          cost=(4 * (2 * rec["unsorted"].shape[0] * npad + npad), 0),
          library=lambda: rec["unsorted"].index_select(1, rec["perm"]))
    # Kernel E needs a byte of flag a lane, the value of each flagged lane
    # and its (R + 1) rows of cap columns out.
    check("compact",
          lambda: compact.compact_flagged(vals_e, is_first, cap_e),
          lambda: compact.compact_plain(vals_e, is_first, cap_e),
          lambda k, p: [], lambda k, p: [("values", k[0], p[0]), ("ok", k[1], p[1])],
          cost=(npad + 4 * n_first + 4 * 2 * cap_e, 0))
    compact_edge_cases(compact, dev)
    check_scatter("scatter_pull", rec, cfg)
    del rec, args_a, args_b, args_c, data, state
    torch.cuda.empty_cache()

    # ---- 5a'. A and B on path 5 lowered onto its capsule, both CDF modes ----
    for tag, chan_free in (("shapes", False), ("chan_free", True)):
        data = full_scene_shapes(dev, chan_free, shift=(0.0, -3.0, 0.0))
        cfg = data.config
        state, diag = step_with_diag(data.state, data.params, cfg, 2)
        rec = {}
        step_pallas(state, data.params, cfg, 1, record=rec)
        torch.cuda.synchronize()
        if diag.any_overflow():
            fail(f"step diagnostics of lowered path 5 ({tag}): {diag.summary()}")
        h, npad, nc = cfg.grid.cell_width, rec["rows"].shape[1], cfg.num_colliders
        mode = (rec["moving"], rec["static_desc"], rec["chan_free"])
        args_a = (rec["rows"][:24].contiguous(), rec["ntiles"], rec["btable"],
                  rec["jobs"], rec["bcells"], rec["jbody"], h, BY, GROUP, npad, nc,
                  *mode)
        args_b = (rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"],
                  rec["jobs"], rec["bcells"], rec["jbody"], h, BY, GROUP, npad, nc,
                  *mode)
        ce, pg, nj, njg = job_stats(rec)
        hist = gate_histogram(rec)
        wv = R.window_geom(BY)[1]
        # Node CDF evaluations: chan-free, every window node of a level-1
        # job against the static colliders and of a level-2 job against
        # all; gathered, the level-2 jobs' nodes against the moving ones.
        n_st, n_mv = len(rec["static_desc"]), len(rec["moving"])
        evals = wv * (hist[1] * n_st + hist[2] * (n_st + n_mv) if chan_free
                      else hist[2] * n_mv)
        tile_bytes = 0 if chan_free else 4 * nj * wv * 4
        print(f"path 5 kernel inputs ({tag}): {ce} covered particles ({pg} in "
              f"gated jobs), live jobs by gate level {hist}, {evals} node-collider "
              f"CDF evaluations, NPAD {npad}", flush=True)
        check(f"p2g_cdf_{tag}",
              lambda: p2g_cdf.p2g_cdf_tiles(*args_a),
              lambda: p2g_cdf.p2g_cdf_plain(*args_a),
              lambda k, p: [("impulses", k[1], p[1], 1e-4)],
              lambda k, p: [("mm tiles", k[0], p[0]), ("impulses", k[1], p[1]),
                            ("particle cdf rows", k[2][:, :ce], p[2][:, :ce])],
              lambda p: (None if float(p[1].abs().max()) > 1.0
                         else "the plain impulses are ~0: no contact load"),
              cost=(tile_bytes + 4 * (24 * ce + nj * wv * 8 + 8 * ce + njg * 8 * 128),
                    ce * (30 + 27 * 13 * 2) + pg * (27 * (3 * nc + 58) + 200)
                    + evals * CDF_OPS))
        check(f"g2p_{tag}",
              lambda: g2p.g2p_rows(*args_b), lambda: g2p.g2p_plain(*args_b),
              lambda k, p: [], lambda k, p: [("rows", k[:, :ce], p[:, :ce])],
              cost=g2p_cost(ce, pg, nj, njg, wv, tiles=not chan_free, evals=evals))
        del rec, args_a, args_b, data, state
        torch.cuda.empty_cache()

    # ---- 5b. 2D kernels vs plain versions at full size, under contact load ----
    # The 2D scene with its lattice lowered 1.5 cells into the floor: gated
    # jobs whose incompatible pairs give kernel H nonzero impulses.
    data = full_scene_2d(dev)
    cfg = data.config
    data.state.particles.pos += torch.tensor([0.0, -1.5 * H2], device=dev)
    state, diag = step_with_diag(data.state, data.params, cfg, 2)
    rec = {}
    step_pallas(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    if diag.any_overflow():
        fail(f"step diagnostics of the lowered 2D scene: {diag.summary()}")
    h, npad, nc = H2, rec["rows"].shape[1], cfg.num_colliders
    jobs = (rec["jobs"], rec["bcells"], rec["jbody"], h)
    args_g = (rec["rows"], rec["ntiles"]) + jobs + (GROUP2, npad, nc)
    args_h = (rec["pdata"], rec["ntiles"], rec["btable"]) + jobs + (nc,)
    args_i = ((rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"]) + jobs
              + (GROUP2, npad, nc))
    args_c2 = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
               rec["covered_end"], rec["btable"], rec["mtable"], data.params.dt,
               h, nc, max(cfg.n_materials, 1), rec["nb_total"])
    ce, pg, nj, njg = job_stats(rec)
    wv = 100
    print(f"2D kernel inputs: {ce} covered particles ({pg} in gated jobs), "
          f"{nj} live jobs ({njg} gated), NPAD {npad}", flush=True)
    # G, H and I sum in the plain versions' order: bit for bit.  The dim=2
    # entry of C differs from its plain version only through libm.
    check_pcdf2d("pcdf2d", args_g, job_stats(rec))
    lib_h, n_pairs = tile_pairs_library(rec["pdata"], rec["jobs"], rec["bcells"], h,
                                        R2.WSH, rec["jobs"]["len"].shape[0])
    print(f"p2g2d library yardstick: {n_pairs} (particle, node) pairs", flush=True)
    check("p2g2d",
          lambda: transfer2d.p2g_tiles(*args_h),
          lambda: transfer2d.p2g_plain(*args_h),
          lambda k, p: [], lambda k, p: [("mm tiles", k[0], p[0]),
                                         ("impulses", k[1], p[1])],
          lambda p: (None if float(p[1].abs().max()) > 1e-3
                     else "the plain impulses are ~0: no contact load"),
          cost=p2g2d_cost(ce, pg, nj, njg, nc), library=lib_h)
    del lib_h
    width = npad + GROUP2 + 128
    check("g2p2d",
          lambda: transfer2d.g2p_rows(*args_i),
          lambda: transfer2d.g2p_plain(*args_i),
          lambda k, p: [], lambda k, p: [("rows", k, p)],
          cost=g2p2d_cost(ce, pg, nj, njg, width))
    # Kernel I folded, on the same substep with the grid update left to it.
    rec_fold = {}
    step_pallas(state, data.params, dataclasses.replace(cfg, fold_vel=True), 1,
                record=rec_fold)
    args_if = ((rec_fold["pdata"], rec_fold["ftiles"]) + args_i[2:]
               + ((), False, True))
    check("g2p2d_fold",
          lambda: transfer2d.g2p_rows(*args_if),
          lambda: transfer2d.g2p_plain(*args_if),
          lambda k, p: [], lambda k, p: [("rows", k, p)],
          cost=g2p2d_cost(ce, pg, nj, njg, width, fold=True))
    del rec_fold, args_if
    check("update_rows2d",
          lambda: update_rows.update_rows2d(*args_c2),
          lambda: update_rows.update2d_plain(*args_c2),
          lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
          lambda k, p: [(f"row {r}", k[r], p[r]) for r in (9, 12, 13, 14)],
          cost=c_cost(C_ROWS_READ_2D, 6, 5, rec["rows"].shape[0], npad, ce, 400))
    check_scatter("scatter_pull2d", rec, cfg)
    del rec, args_g, args_h, args_i, args_c2, data, state
    torch.cuda.empty_cache()

    # ---- 5b'. G dense on path 6 lowered into the floor ----
    data = full_scene_stirred_2d(dev, False, shift=(0.0, -1.5 * H2))
    cfg = data.config
    state, diag = step_with_diag(data.state, data.params, cfg, 2)
    rec = {}
    step_pallas(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    if diag.any_overflow() or cfg.chan_free or cfg.static_slots != (0,):
        fail(f"lowered path 6 (dense): {diag.summary()}, built as {cfg}")
    args_g = ((rec["rows"], rec["ntiles"], rec["jobs"], rec["bcells"], rec["jbody"],
               H2, GROUP2, rec["rows"].shape[1], cfg.num_colliders, rec["btable"],
               rec["alldesc"], False))
    check_pcdf2d("pcdf2d_dense", args_g, job_stats(rec))
    del rec, args_g, data, state
    torch.cuda.empty_cache()

    # ---- 5b''. G, H and I chan-free on path 6 lowered into the floor ----
    data = full_scene_stirred_2d(dev, True, shift=(0.0, -1.5 * H2))
    cfg = data.config
    state, diag = step_with_diag(data.state, data.params, cfg, 2)
    rec = {}
    step_pallas(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    if diag.any_overflow():
        fail(f"step diagnostics of lowered path 6: {diag.summary()}")
    npad, nc = rec["rows"].shape[1], cfg.num_colliders
    jobs = (rec["jobs"], rec["bcells"], rec["jbody"], H2)
    mode = (rec["alldesc"], True)
    args_g = (rec["rows"], rec["ntiles"]) + jobs + (GROUP2, npad, nc,
                                                    rec["btable"]) + mode
    args_h = (rec["pdata"], rec["ntiles"], rec["btable"]) + jobs + (nc,) + mode
    args_i = ((rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"]) + jobs
              + (GROUP2, npad, nc) + mode)
    ce, pg, nj, njg = job_stats(rec)
    # Node CDF evaluations: every collider at every window node of a gated
    # job (the kernels evaluate them again each, as the plain versions do).
    evals = njg * wv * nc
    print(f"path 6 kernel inputs (chan-free, lowered): {ce} covered particles "
          f"({pg} in gated jobs), {nj} live jobs ({njg} gated), {evals} "
          f"node-collider CDF evaluations a kernel, NPAD {npad}", flush=True)
    check_pcdf2d("pcdf2d_chan_free", args_g, job_stats(rec), tiles=False,
                 evals=evals)
    check("p2g2d_chan_free",
          lambda: transfer2d.p2g_tiles(*args_h),
          lambda: transfer2d.p2g_plain(*args_h),
          lambda k, p: [], lambda k, p: [("mm tiles", k[0], p[0]),
                                         ("impulses", k[1], p[1])],
          lambda p: (None if float(p[1].abs().max()) > 1e-3
                     else "the plain impulses are ~0: no contact load"),
          cost=p2g2d_cost(ce, pg, nj, njg, nc, tiles=False, evals=evals))
    check("g2p2d_chan_free",
          lambda: transfer2d.g2p_rows(*args_i),
          lambda: transfer2d.g2p_plain(*args_i),
          lambda k, p: [], lambda k, p: [("rows", k, p)],
          cost=g2p2d_cost(ce, pg, nj, njg, npad + GROUP2 + 128, tiles=False,
                          evals=evals))
    del rec, args_g, args_h, args_i, data, state
    torch.cuda.empty_cache()

    # ---- 5c. C-2D's neo-Hookean branch on a substep of the neo-Hookean path ----
    r = rec_n
    args_n = (r["rows"], r["krows"], r["pcdf"], r["sorted_ids"], r["covered_end"],
              r["btable"], r["mtable"], r["dt"], H2, r["cfg"].num_colliders,
              max(r["cfg"].n_materials, 1), r["nb_total"])
    ce = int(r["covered_end"])
    check("update_rows2d_neo_hookean",
          lambda: update_rows.update_rows2d(*args_n, elastic_model="neo_hookean"),
          lambda: update_rows.update2d_plain(*args_n, elastic_model="neo_hookean"),
          lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
          lambda k, p: [(f"row {r}", k[r], p[r]) for r in (9, 12, 13, 14)],
          cost=c_cost(C_ROWS_READ_2D, 6, 5, r["rows"].shape[0], r["rows"].shape[1],
                      ce, 340))
    # Kernel H on the same substep (the blocks on their floor and walls).
    args_hn = ((r["pdata"], r["ntiles"], r["btable"], r["jobs"], r["bcells"],
                r["jbody"], H2, r["cfg"].num_colliders))
    ce, pg, nj, njg = job_stats(r)
    print(f"2D neo-Hookean kernel inputs: {ce} covered particles ({pg} in gated "
          f"jobs), {nj} live jobs ({njg} gated)", flush=True)
    check("p2g2d_neo",
          lambda: transfer2d.p2g_tiles(*args_hn),
          lambda: transfer2d.p2g_plain(*args_hn),
          lambda k, p: [], lambda k, p: [("mm tiles", k[0], p[0]),
                                         ("impulses", k[1], p[1])],
          cost=p2g2d_cost(ce, pg, nj, njg, r["cfg"].num_colliders))
    del rec_n, r, args_n, args_hn
    torch.cuda.empty_cache()

    # ---- 5c'. kernel H on jobs of several chunks, under contact load ----
    # The 36-particle-a-cell column lowered 1.5 of its cells into the floor.
    data = full_scene_dense_2d(dev, shift=(0.0, -1.5 * 3 * H2))
    cfg = data.config
    state, diag = step_with_diag(data.state, data.params, cfg, 2)
    rec = {}
    step_pallas(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    if diag.any_overflow():
        fail(f"step diagnostics of the lowered dense column: {diag.summary()}")
    nc = cfg.num_colliders
    args_hc = ((rec["pdata"], rec["ntiles"], rec["btable"], rec["jobs"],
                rec["bcells"], rec["jbody"], cfg.grid.cell_width, nc))
    ce, pg, nj, njg = job_stats(rec)
    longest = int(rec["jobs"]["len"].max())
    print(f"2D dense-column kernel inputs: {ce} covered particles ({pg} in gated "
          f"jobs), {nj} live jobs ({njg} gated), the longest {longest} particles",
          flush=True)
    if longest <= R2.P2G_CHUNK:
        fail(f"dense column: no job longer than H's chunk ({longest})")
    check("p2g2d_chunks",
          lambda: transfer2d.p2g_tiles(*args_hc),
          lambda: transfer2d.p2g_plain(*args_hc),
          lambda k, p: [], lambda k, p: [("mm tiles", k[0], p[0]),
                                         ("impulses", k[1], p[1])],
          lambda p: (None if float(p[1].abs().max()) > 1e-3
                     else "the plain impulses are ~0: no contact load"),
          cost=p2g2d_cost(ce, pg, nj, njg, nc))
    del rec, args_hc, data, state
    torch.cuda.empty_cache()

    mark("phase 5g-5j")
    # ---- 5g. the rigid solve on substeps of paths 7 and 8 with the plates
    # pressed into the floor and into each other, and on the joint scenes ----
    from wgsparkl_tpu_torch.rigid import body as body_mod
    from wgsparkl_tpu_torch.rigid import solve

    for name, make in (
            ("rigid_solve", lambda: sand2_scene(dev, N_SAND2 / 700,
                                                plates=sand2_pressed(N_SAND2),
                                                group=GROUP2)),
            ("rigid_solve_3d", lambda: full_scene_plates(dev, PLATES_3D_PRESSED))):
        data = make()
        with captured_rigid_solve() as calls:
            step_pallas(data.state, data.params, data.config, 1)
        world, lin, ang, dt_r, slop, tab = calls[0]
        act = active_pairs(world, tab)
        print(f"{name} inputs: active contact samples by (dynamic body, collider, "
              f"two-way) {act}", flush=True)
        if not any(k[2] for k in act) or not any(not k[2] for k in act):
            fail(f"{name}: no active dynamic-dynamic or dynamic-static contact: {act}")
        check(name,
              lambda: solve.rigid_solve(world, lin, ang, dt_r, slop, tab),
              lambda: solve.rigid_solve_plain(world, lin, ang, dt_r, slop, tab),
              lambda k, p: [], lambda k, p: [("linvel", k[0], p[0]), ("angvel", k[1], p[1])],
              cost=rigid_cost(tab, world, sum(act.values())))
        del data, world, lin, ang, tab, calls
        torch.cuda.empty_cache()
    # The joint scenes: 30 chained rigid updates (random CPIC impulses on the
    # first), the kernel path equal to the plain path bit for bit.
    import numpy as np
    from wgsparkl_tpu_torch import pipeline

    joint_inputs = None
    for jname, descs, dim, joints in joint_scenes():
        bodies, params_r, cfg_r = rigid_rig(descs, dim, joints, dev)
        rng = np.random.default_rng(1)
        na = 3 if dim == 3 else 1
        li = torch.as_tensor(rng.normal(size=(len(descs), dim)).astype(np.float32), device=dev)
        ai = torch.as_tensor(rng.normal(size=(len(descs), na)).astype(np.float32), device=dev)
        bk = bp = bodies
        for step in range(30):
            with captured_rigid_solve() as calls:
                ok = pipeline.rigid_bodies_update(bk, li, ai, params_r, cfg_r)
            with plain_versions():
                op = pipeline.rigid_bodies_update(bp, li, ai, params_r, cfg_r)
            for f in ("pos", "rot", "linvel", "angvel"):
                if not torch.equal(getattr(ok, f), getattr(op, f)):
                    fail(f"joint scene {jname}: body {f} of the kernel path differs from "
                         f"the plain path at update {step}")
            if jname == "chain" and step == 10:
                joint_inputs = calls[0]
            bk = body_mod.update_world_mass_properties(ok)
            bp = body_mod.update_world_mass_properties(op)
            li, ai = li * 0.0, ai * 0.0
    print("joint scenes (" + "; ".join(j[0] for j in joint_scenes()) + "): 30 rigid "
          "updates each, the kernel path equal to the plain path bit for bit", flush=True)
    world, lin, ang, dt_r, slop, tab = joint_inputs
    check("rigid_solve_joints",
          lambda: solve.rigid_solve(world, lin, ang, dt_r, slop, tab),
          lambda: solve.rigid_solve_plain(world, lin, ang, dt_r, slop, tab),
          lambda k, p: [], lambda k, p: [("linvel", k[0], p[0]), ("angvel", k[1], p[1])],
          cost=rigid_cost(tab, world, 0))
    del joint_inputs, world, lin, ang, tab

    # ---- 5h. kernel C's fracture branch at full size: four materials ----
    for name, make, fn, plain, rows_read, krows, pc_rows, flops, exact_rows in (
            ("update_rows_fracture",
             lambda: four_materials(full_scene(dev), (0.0, -3.0, 0.0), True, 1.0005),
             update_rows.update_rows, update_rows.update_plain, C_ROWS_READ_3D, 12, 6,
             6000, (16, 20, 21, 22, R.R_PHASE)),
            ("update_rows2d_fracture",
             lambda: four_materials(scenes.elastic_blocks_2d(
                 n_side=NX2, cell_width=H2, device=dev, group=GROUP2), (0.0, -1.5 * H2),
                 False, 1.00005),
             update_rows.update_rows2d, update_rows.update2d_plain, C_ROWS_READ_2D, 6, 5,
             400, (9, 12, 13, 14, R2.R_PHASE))):
        data = make()
        cfg = data.config
        state, diag = step_with_diag(data.state, data.params, cfg, 2)
        rec = {}
        step_pallas(state, data.params, cfg, 1, record=rec)
        torch.cuda.synchronize()
        if diag.any_overflow() or cfg.n_materials != 4:
            fail(f"{name}: {diag.summary()}, {cfg.n_materials} materials")
        args_fc = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
                   rec["covered_end"], rec["btable"], rec["mtable"], data.params.dt,
                   cfg.grid.cell_width, cfg.num_colliders, cfg.n_materials,
                   rec["nb_total"])
        ph_row = exact_rows[-1]
        check(name, lambda: fn(*args_fc), lambda: plain(*args_fc),
              lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
              lambda k, p: [(f"row {r}", k[r], p[r]) for r in exact_rows],
              lambda p: (None if int((p[ph_row] != rec["rows"][ph_row]).sum()) > 10
                         else "fewer than 10 lanes fractured in the substep"),
              cost=c_cost(rows_read, krows, pc_rows, rec["rows"].shape[0],
                          rec["rows"].shape[1], int(rec["covered_end"]), flops))
        del data, state, rec, args_fc
        torch.cuda.empty_cache()

    # ---- 5i. the mesh pass on paths 9-11, A and H on their mesh tiles ----
    # Each scene with its lattice lowered onto the blades (paths 9 and 10)
    # or as built (path 11): a substep's inputs after two substeps.  The
    # kernel and its plain version spell every operation out in one order
    # and take the minimum and the OR: bit for bit.
    from wgsparkl_tpu_torch.ops import rigid_cdf

    for name, make in (
            ("mesh_cdf", lambda: cut3_scene(dev, CUT3_SCALE, shift=(0.0, -7.0, 0.0))),
            ("mesh_cdf_heightfield", lambda: hf3_scene(dev, HF3_SCALE)),
            ("mesh_cdf2d", lambda: cut2_scene(dev, N_CUT2 / 700,
                                              shift=(0.0, -13.0 * N_CUT2 / 700)))):
        data = make()
        cfg = data.config
        state, diag = step_with_diag(data.state, data.params, cfg, 2)
        rec = {}
        step_pallas(state, data.params, cfg, 1, record=rec)
        torch.cuda.synchronize()
        if diag.any_overflow():
            fail(f"{name}: step diagnostics of the lowered scene: {diag.summary()}")
        args_m = mesh_inputs(data, state)
        sw = args_m[0]
        d = cfg.grid.dim
        nodes = int(np.prod(cfg.grid.shape))
        # Samples whose stencil base lies in the grid (the others add nothing).
        rel = (torch.round(sw / cfg.grid.cell_width) - 1
               - torch.tensor(cfg.grid.origin_cell, device=dev))
        s_in = int(((rel >= 0) & (rel < torch.tensor(cfg.grid.shape, device=dev)))
                   .all(1).sum())
        pairs = s_in * 3 ** d
        print(f"{name} inputs: {sw.shape[0]} samples ({s_in} in the grid), "
              f"{args_m[1].shape[0]} vertices, {pairs} sample-node pairs, {nodes} "
              f"nodes", flush=True)
        # Bytes: samples, primitives, slots and vertices read once, the two
        # node grids written once; operations: ~60 (3D) / 10 (2D) a sample
        # for its primitive, ~35 / 15 a pair.
        check(name,
              lambda: rigid_cdf.mesh_node_cdf(*args_m),
              lambda: rigid_cdf.mesh_node_cdf_plain(*args_m),
              lambda k, p: [], lambda k, p: [("keys", k[0], p[0]), ("words", k[1], p[1])],
              lambda p: (None if int((p[0] < rigid_cdf.INF_KEY).sum()) > 100
                         and bool((p[1] != 0).any()) else "an empty mesh pass"),
              cost=(4 * (sw.shape[0] * (2 * d + 1) + args_m[1].numel()) + 8 * nodes,
                    sw.shape[0] * (60 if d == 3 else 10) + pairs * (35 if d == 3 else 15)))
        mesh_bits = sum(1 << c for c in cfg.mesh_cids)
        ce, pg, nj, njg = job_stats(rec)
        h, npad, nc = cfg.grid.cell_width, rec["rows"].shape[1], cfg.num_colliders

        def touched(aff_lo):
            """Some covered lane's particle CDF names a mesh slot."""
            return bool(((aff_lo[:ce].to(torch.int32) & mesh_bits) != 0).any())

        if name == "mesh_cdf":
            args_a = (rec["rows"][:24].contiguous(), rec["ntiles"], rec["btable"],
                      rec["jobs"], rec["bcells"], rec["jbody"], h, cfg.by, cfg.group,
                      npad, nc, rec["moving"], rec["static_desc"], rec["chan_free"])
            wv = R.window_geom(cfg.by)[1]
            print(f"p2g_cdf_mesh inputs: {ce} covered particles ({pg} in gated jobs), "
                  f"live jobs by gate level {gate_histogram(rec)}", flush=True)
            check("p2g_cdf_mesh",
                  lambda: p2g_cdf.p2g_cdf_tiles(*args_a),
                  lambda: p2g_cdf.p2g_cdf_plain(*args_a),
                  lambda k, p: [("impulses", k[1], p[1], 1e-4)],
                  lambda k, p: [("mm tiles", k[0], p[0]), ("impulses", k[1], p[1]),
                                ("particle cdf rows", k[2][:, :ce], p[2][:, :ce])],
                  lambda p: None if touched(p[2][0]) else "no lane near a mesh",
                  cost=(4 * (24 * ce + nj * wv * 4 + nj * wv * 8 + 8 * ce
                             + njg * 8 * 128),
                        ce * (30 + 27 * 13 * 2) + pg * (27 * (3 * nc + 58) + 200)))
            del args_a
        elif name == "mesh_cdf2d":
            args_h = (rec["pdata"], rec["ntiles"], rec["btable"], rec["jobs"],
                      rec["bcells"], rec["jbody"], h, nc, rec["alldesc"], rec["chan_free"])
            print(f"p2g2d_mesh inputs: {ce} covered particles ({pg} in gated jobs), "
                  f"{nj} live jobs ({njg} gated)", flush=True)
            check("p2g2d_mesh",
                  lambda: transfer2d.p2g_tiles(*args_h),
                  lambda: transfer2d.p2g_plain(*args_h),
                  lambda k, p: [], lambda k, p: [("mm tiles", k[0], p[0]),
                                                 ("impulses", k[1], p[1])],
                  lambda p: (None if touched(rec["pdata"][R2.AFF])
                             else "no lane near a mesh"),
                  cost=p2g2d_cost(ce, pg, nj, njg, nc))
            del args_h
        del data, state, rec, args_m, sw
        torch.cuda.empty_cache()

    # ---- 5j. path 12: A, B and C on slot-addressed tiles; the mesh pass's
    # slot entry on path 11 built sparse ----
    # Path 12 with its lattice lowered 3 cells onto the paddle: a substep's
    # inputs after two substeps.  A's tiles and impulses, B's rows and all
    # of C's rows bit for bit.
    from wgsparkl_tpu_torch.ops import blocked

    data = full_scene_sparse(dev)
    cfg = data.config
    data.state.particles.pos += torch.tensor([0.0, -3.0, 0.0], device=dev)
    state, diag = step_with_diag(data.state, data.params, cfg, 2)
    rec = {}
    step_pallas(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    if diag.any_overflow():
        fail(f"step diagnostics of lowered path 12: {diag.summary()}")
    h, npad, nc = cfg.grid.cell_width, rec["rows"].shape[1], cfg.num_colliders
    mode = (rec["moving"], rec["static_desc"], rec["chan_free"])
    args_a = (rec["rows"][:24].contiguous(), rec["ntiles"], rec["btable"], rec["jobs"],
              rec["bcells"], rec["jbody"], h, cfg.by, GROUP, npad, nc, *mode)
    args_b = (rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"], rec["jobs"],
              rec["bcells"], rec["jbody"], h, cfg.by, GROUP, npad, nc, *mode)
    args_c = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
              rec["covered_end"], rec["btable"], rec["mtable"], data.params.dt, h, nc,
              max(cfg.n_materials, 1), rec["live_below"])
    ce, pg, nj, njg = job_stats(rec)
    wv = R.window_geom(cfg.by)[1]
    n_act = int((rec["act"] < blocked.SPARSE_SENTINEL).sum())
    print(f"path 12 kernel inputs (lowered): {ce} covered particles ({pg} in gated "
          f"jobs), live jobs by gate level {gate_histogram(rec)}, {n_act} active "
          f"slots, the longest job {int(rec['jobs']['len'].max())} particles, NPAD "
          f"{npad}", flush=True)
    check("p2g_cdf_sparse",
          lambda: p2g_cdf.p2g_cdf_tiles(*args_a),
          lambda: p2g_cdf.p2g_cdf_plain(*args_a),
          lambda k, p: [("impulses", k[1], p[1], 1e-4)],
          lambda k, p: [("mm tiles", k[0], p[0]), ("impulses", k[1], p[1]),
                        ("particle cdf rows", k[2][:, :ce], p[2][:, :ce])],
          lambda p: (None if float(p[1].abs().max()) > 1.0
                     else "the plain impulses are ~0: no contact load"),
          cost=(4 * (24 * ce + nj * wv * 4 + nj * wv * 8 + 8 * ce + njg * 8 * 128),
                ce * (30 + 27 * 13 * 2) + pg * (27 * (3 * nc + 58) + 200)))
    check("g2p_sparse",
          lambda: g2p.g2p_rows(*args_b), lambda: g2p.g2p_plain(*args_b),
          lambda k, p: [], lambda k, p: [("rows", k[:, :ce], p[:, :ce])],
          cost=g2p_cost(ce, pg, nj, njg, wv))
    check("update_rows_sparse",
          lambda: update_rows.update_rows(*args_c),
          lambda: update_rows.update_plain(*args_c),
          lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
          lambda k, p: [(f"row {r}", k[r], p[r]) for r in range(k.shape[0])],
          cost=c_cost(C_ROWS_READ_3D, 12, 6, rec["rows"].shape[0], npad, ce, 6000))
    del rec, args_a, args_b, args_c, data, state
    torch.cuda.empty_cache()
    # The slot-addressed mesh pass on path 11 built sparse, its lattice
    # lowered 15.5 cells onto the heightfield (the active slots reach the
    # surface only there): a substep's inputs after two substeps, keys and
    # words bit for bit.
    data = hf3_scene(dev, HF3_SCALE, shift=(0.0, -15.5, 0.0), sparse=True)
    cfg = data.config
    wt.reset_launch_counts()
    state, diag = step_with_diag(data.state, data.params, cfg, 2)
    rec = {}
    step_pallas(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    n_mesh = launches_run(wt)["mesh_cdf_sparse"]
    if diag.any_overflow() or not cfg.sparse or not cfg.mesh_cids or n_mesh != 3:
        fail(f"path 11 built sparse: {diag.summary()}, {n_mesh} mesh_cdf_sparse "
             f"launches in 3 substeps, built as {cfg}")
    sw, vw, prim, cid, grid, _ = mesh_inputs(data, state)
    args_m = (sw, vw, prim, cid, grid, rec["act"], cfg.amax)
    n_act = int((rec["act"] < blocked.SPARSE_SENTINEL).sum())
    pairs = sw.shape[0] * 27
    print(f"mesh_cdf_sparse inputs: {sw.shape[0]} samples, {vw.shape[0]} vertices, "
          f"{n_act} active slots of amax {cfg.amax}", flush=True)
    # Bytes: samples, primitives, slots, vertices and the active table read
    # once, the two slot node grids written once; operations: ~60 a sample,
    # ~35 a pair (as the bounded mesh_cdf entry), and the slot lookups the
    # function needs: a sample's 27 nodes fall in at most 8 blocks, each a
    # binary search of ceil(log2(amax + 1)) probes of ~3 operations.
    probes = int(np.ceil(np.log2(cfg.amax + 1)))
    check("mesh_cdf_sparse",
          lambda: rigid_cdf.mesh_node_cdf_sparse(*args_m),
          lambda: rigid_cdf.mesh_node_cdf_sparse_plain(*args_m),
          lambda k, p: [], lambda k, p: [("keys", k[0], p[0]), ("words", k[1], p[1])],
          lambda p: (None if int((p[0] < rigid_cdf.INF_KEY).sum()) > 100
                     and bool((p[1] != 0).any()) else "an empty mesh pass"),
          cost=(4 * (sw.shape[0] * 7 + vw.numel() + n_act) + 8 * (cfg.amax + 1) * 64,
                sw.shape[0] * (60 + 8 * probes * 3) + pairs * 35))
    del data, state, rec, args_m, sw, vw
    torch.cuda.empty_cache()

    mark("phase 5d-5f")
    # ---- 5d. kernel F on a substep of the collider-free path ----
    r = rec_f
    args_f = (r["pdata"], r["ntiles"], r["btable"], r["jobs"], r["bcells"],
              r["jbody"], cfg_f.grid.cell_width, BY, cfg_f.num_colliders)
    ce, _, nj, _ = job_stats(r)
    maxj, wv = r["jobs"]["len"].shape[0], r["mm"].shape[1]
    print(f"3D collider-free kernel inputs: {ce} covered particles, {nj} live "
          f"jobs of {maxj}", flush=True)
    # Bit for bit: every node sums its pairs in the lists order, as the
    # plain version does.
    lib_f, _ = tile_pairs_library(r["pdata"], r["jobs"], r["bcells"],
                                  cfg_f.grid.cell_width, R.window_geom(BY)[0], maxj)
    check("p2g",
          lambda: p2g.p2g_tiles(*args_f), lambda: p2g.p2g_plain(*args_f),
          lambda k, p: [], lambda k, p: [("mm tiles", k[0], p[0]),
                                         ("impulses", k[1], p[1])],
          lambda p: (None if float(p[0][..., 3].sum()) > 0.0
                     else "no mass reached the grid"),
          cost=(4 * (16 * ce + maxj * wv * 8), ce * (40 + 27 * 28) + nj * wv * 20),
          library=lib_f)
    del lib_f
    del rec_f, r, args_f
    torch.cuda.empty_cache()

    # ---- 5e. the in-kernel math probe (the H100 counterpart of the TPU's) ----
    for line in probe.probe_table(dev):
        print(f"math probe: {line}", flush=True)
    px, py = probe.probe_inputs(dev)
    wt.reset_launch_counts()
    probe.math_probe(px, py)
    launches["math_probe"] = launches_run(wt)["math_probe"]
    # Relative error: the kernel's logf, rsqrtf and sqrtf against PyTorch's
    # CUDA calls, 4 ulps at most (the exp(log x / 2) chain's ulp of log x).
    check("math_probe",
          lambda: probe.math_probe(px, py), lambda: probe.math_probe_plain(px, py),
          lambda k, p: [(f"{n} (relative)", k[i].double() / p[i].double(),
                         torch.ones_like(p[i], dtype=torch.float64), 2.0 ** -21)
                        for i, n in enumerate(probe.NAMES)],
          cost=(4 * 11 * px.numel(), 30 * px.numel()))

    # ---- 5f. the P2G ablation probe (the H100 counterpart of the TPU's) ----
    # Its full-size synthetic jobs; every stage of every core, each core's
    # full stage held against its plain version bit for bit.
    inputs = ablation.probe_inputs(device=dev)
    wt.reset_launch_counts()
    try:
        lines, _ = ablation.stage_table(inputs)
    except RuntimeError as e:
        fail(str(e))
    launches["p2g_ablation"] = launches_run(wt)["p2g_ablation"]
    for line in lines:
        print(f"p2g ablation: {line}", flush=True)
    lens_a = inputs[2]
    ce_a, nj_a = int(lens_a.sum()), int((lens_a > 0).sum())
    maxj_a = lens_a.shape[0]
    wv_a = R.window_geom(ablation.BY)[2]
    check("p2g_ablation",
          lambda: ablation.p2g_ablation(*inputs),
          lambda: ablation.p2g_ablation_plain(*inputs),
          lambda k, p: [], lambda k, p: [("full tiles", k, p)],
          lambda p: (None if float(p[..., 3].sum()) > 0.0
                     else "no mass reached the grid"),
          cost=(4 * (16 * ce_a + 5 * maxj_a + maxj_a * wv_a * 8),
                ce_a * (40 + 27 * 28) + nj_a * wv_a * 20))
    del inputs
    torch.cuda.empty_cache()

    mark("phase 5b (dense)")
    # ---- 5b. the dense transfer's kernels at full size ----
    # A substep of path 13 with its lattice lowered onto the paddle and of
    # path 13b lowered 1.5 cells into its floor, so that the CPIC impulses
    # carry load.  Every output bit for bit (the plain versions sum in the
    # kernels' order).  Costs, counted from these inputs (4 bytes a value
    # read or written once): dense_pcdf reads d + 2 rows a particle and the
    # node distance and affinity, writes 8 rows, ~(8 + 3 nc + (d + 1)(2d +
    # 5)) operations a stencil node and ~250 for the solve; dense_p2g reads
    # d^2 + 3d + 3 rows a particle, its sorted lane and the cell starts, the
    # node affinity and closest body, writes the grid, ~50 operations a
    # pair and ~60 more an impulse pair; dense_g2p reads 3d + 2 rows a
    # particle and the grid velocity, node affinity and closest body,
    # writes its 16 (8) rows, ~(4 + 3 d^2) operations a stencil node.
    from wgsparkl_tpu_torch.collision import cdf as dcdf
    from wgsparkl_tpu_torch.ops import transfer as dtr
    from wgsparkl_tpu_torch.pipeline import step_dense

    for tag, make, shift in (
            ("", lambda: dense_scene(dev, transfer="dense"), (0.0, -3.0, 0.0)),
            ("2d", lambda: dense_scene_2d(dev), (0.0, -1.5 * H2))):
        data = make()
        cfg = data.config
        data.state.particles.pos += torch.tensor(shift, device=dev)
        state = step_dense(data.state, data.params, cfg, 2)
        rec = {}
        step_dense(state, data.params, cfg, 1, record=rec)
        torch.cuda.synchronize()
        n, nc, grid = state.particles.count, cfg.num_colliders, cfg.grid
        d, m, rows = grid.dim, grid.num_nodes, rec["rows"]
        npad, kk = rows.shape[1], 3 ** grid.dim
        mext = int(np.prod([s_ + 2 for s_ in grid.shape]))
        args_1 = (rows, n, rec["node_dist"], rec["node_aff"], grid, nc)
        check(f"dense_pcdf{tag}", lambda: dcdf.dense_pcdf(*args_1),
              lambda: dcdf.pcdf_rows_plain(*args_1), lambda k, p: [],
              lambda k, p: [("particle-CDF rows", k, p)],
              lambda p: (None if int((p[0, :n] != 0).sum()) > 100
                         else "few particles near a collider"),
              cost=(4 * ((d + 2) * n + 8 * npad + 2 * m),
                    n * (kk * (8 + 3 * nc + (d + 1) * (2 * d + 5)) + 250)))
        args_2 = (rows, rec["pcdf"], n, rec["live"], rec["node_aff"],
                  rec["node_closest"], rec["btable"], grid, nc, state.bodies.count)
        node, vals = dtr.p2g_pairs(*args_2[:-1])
        mmv = vals[:, :d + 1].contiguous()
        nimp = int((vals[:, d + 1:] != 0).any(1).sum())
        lib_out = torch.zeros((m, d + 1), dtype=torch.float32, device=dev)

        def library():
            torch.use_deterministic_algorithms(True)
            try:
                lib_out.zero_()
                lib_out.index_put_((node,), mmv, accumulate=True)
            finally:
                torch.use_deterministic_algorithms(False)

        print(f"dense_p2g{tag} inputs: {n} particles, {node.shape[0]} pairs on "
              f"{m} nodes ({nimp} impulse pairs)", flush=True)
        check(f"dense_p2g{tag}", lambda: dtr.dense_p2g(*args_2),
              lambda: dtr.p2g_plain(*args_2), lambda k, p: [],
              lambda k, p: [("grid", k[0], p[0]), ("linear impulses", k[1], p[1]),
                            ("angular impulses", k[2], p[2])],
              lambda p: None if float(p[1].abs().max()) > 0.0 else "no CPIC impulse",
              cost=(4 * ((d * d + 3 * d + 4) * n + mext + 1 + (d + 3) * m),
                    node.shape[0] * 50 + nimp * 60), library=library)
        del node, vals, mmv, lib_out
        args_3 = (rows, rec["pcdf"], n, rec["live"], rec["grid_vel"], rec["node_aff"],
                  rec["node_closest"], rec["btable"], grid, nc)
        check(f"dense_g2p{tag}", lambda: dtr.dense_g2p(*args_3),
              lambda: dtr.g2p_plain(*args_3), lambda k, p: [],
              lambda k, p: [("G2P rows", k, p)],
              cost=(4 * ((3 * d + 2) * n + rec["krows"].shape[0] * npad + (d + 2) * m),
                    n * kk * (4 + 3 * d * d)))
        if not tag:
            struct_checks(state, data, rec, check)
        del data, state, rec, rows, args_1, args_2, args_3
        torch.cuda.empty_cache()

    # ---- 5b'''. kernel C with the wide material table (path 13w lowered) ----
    # A substep of path 13w (one material a particle) lowered onto the
    # paddle: kernel C reads each lane's 11 constants at its own lane of the
    # [16, M] table; every row bit for bit.  Cost: c_cost's rows, plus the
    # 11 table rows read once.
    data = wide_scene(dev)
    cfg = data.config
    data.state.particles.pos += torch.tensor((0.0, -3.0, 0.0), device=dev)
    state = step_dense(data.state, data.params, cfg, 2)
    rec = {}
    step_dense(state, data.params, cfg, 1, record=rec)
    torch.cuda.synchronize()
    n, npad, mtab = state.particles.count, rec["rows"].shape[1], rec["mtable"]
    args_w = (rec["rows"], rec["krows"], rec["pcdf"],
              torch.zeros(npad, dtype=torch.int32, device=dev),
              torch.full((1,), n, dtype=torch.int32, device=dev), rec["btable"], mtab,
              data.params.dt, cfg.grid.cell_width, cfg.num_colliders, rec["n_mat"], 1)
    print(f"update_rows_wide inputs: {n} particles, {rec['n_mat']} materials in a "
          f"{tuple(mtab.shape)} table", flush=True)
    check("update_rows_wide",
          lambda: update_rows.update_rows(*args_w, centered=True),
          lambda: update_rows.update_plain(*args_w, centered=True),
          lambda k, p: [],
          lambda k, p: [(f"row {r}", k[r], p[r]) for r in range(k.shape[0])],
          lambda p: (None if rec["n_mat"] > 128 and mtab.shape[1] >= rec["n_mat"]
                     else "the table is not wide"),
          cost=(c_cost(C_ROWS_READ_3D, 12, 6, rec["rows"].shape[0], npad, n, 6000)[0]
                + 4 * 11 * rec["n_mat"],
                c_cost(C_ROWS_READ_3D, 12, 6, rec["rows"].shape[0], npad, n, 6000)[1]))
    del data, state, rec, args_w, mtab
    torch.cuda.empty_cache()

    mark("phase 5k")
    # ---- 5k. paths 15-15d: each kernel on the rows of one rank ----
    # The recording rank's substep after a path's frame (a middle rank,
    # receiving migrants from both sides on the spatial paths): the same
    # entries and tolerances as the single-device paths', the rows of a
    # rank holding mass-0 slack lanes and migrants landed on the tail pads.
    for tag, (rec, cfg_r, dt) in records.items():
        rec = _tree(lambda t: t.to(dev), rec)
        h, npad, nc = cfg_r.grid.cell_width, rec["rows"].shape[1], cfg_r.num_colliders
        d = cfg_r.grid.dim
        ce, pg, nj, njg = job_stats(rec)
        pm = R.PM if d == 3 else R2.PM
        cap = cfg_r.migration_cap
        moved = (int((rec["unsorted"][pm, npad - 2 * cap:] > 0).sum())
                 if cfg_r.spatial_devices else 0)
        print(f"{tag} kernel inputs (rank {record_rank(cfg_r.spatial_devices or WORLD_15)}"
              f"): {ce} covered particles ({pg} in gated jobs), {nj} live jobs ({njg} "
              f"gated), NPAD {npad}, {moved} migrants on the tail pads", flush=True)
        if d == 3:
            mode = (rec["moving"], rec["static_desc"], rec["chan_free"])
            args_a = (rec["rows"][:24].contiguous(), rec["ntiles"], rec["btable"],
                      rec["jobs"], rec["bcells"], rec["jbody"], h, cfg_r.by, cfg_r.group,
                      npad, nc, *mode)
            args_b = (rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"],
                      rec["jobs"], rec["bcells"], rec["jbody"], h, cfg_r.by, cfg_r.group,
                      npad, nc, *mode)
            args_c = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
                      rec["covered_end"], rec["btable"], rec["mtable"], dt, h, nc,
                      max(cfg_r.n_materials, 1), rec["live_below"])
            wv = R.window_geom(cfg_r.by)[1]
            check(f"p2g_cdf_{tag}",
                  lambda: p2g_cdf.p2g_cdf_tiles(*args_a),
                  lambda: p2g_cdf.p2g_cdf_plain(*args_a),
                  lambda k, p: [("impulses", k[1], p[1], 1e-4)],
                  lambda k, p: [("mm tiles", k[0], p[0]), ("impulses", k[1], p[1]),
                                ("particle cdf rows", k[2][:, :ce], p[2][:, :ce])],
                  cost=(4 * (24 * ce + nj * wv * 4 + nj * wv * 8 + 8 * ce + njg * 8 * 128),
                        ce * (30 + 27 * 13 * 2) + pg * (27 * (3 * nc + 58) + 200)))
            check(f"g2p_{tag}",
                  lambda: g2p.g2p_rows(*args_b), lambda: g2p.g2p_plain(*args_b),
                  lambda k, p: [], lambda k, p: [("rows", k[:, :ce], p[:, :ce])],
                  cost=g2p_cost(ce, pg, nj, njg, wv))
            check(f"update_rows_{tag}",
                  lambda: update_rows.update_rows(*args_c),
                  lambda: update_rows.update_plain(*args_c),
                  lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
                  lambda k, p: [(f"row {r}", k[r], p[r]) for r in (16, 20, 21, 22)],
                  cost=c_cost(C_ROWS_READ_3D, 12, 6, rec["rows"].shape[0], npad, ce, 6000))
            del args_a, args_b, args_c
        else:
            jobs = (rec["jobs"], rec["bcells"], rec["jbody"], h)
            args_g = (rec["rows"], rec["ntiles"]) + jobs + (cfg_r.group, npad, nc)
            args_h = (rec["pdata"], rec["ntiles"], rec["btable"]) + jobs + (nc,)
            args_i = ((rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"]) + jobs
                      + (cfg_r.group, npad, nc))
            args_c2 = (rec["rows"], rec["krows"], rec["pcdf"], rec["sorted_ids"],
                       rec["covered_end"], rec["btable"], rec["mtable"], dt, h, nc,
                       max(cfg_r.n_materials, 1), rec["nb_total"])
            jobs_premise(rec, f"{tag} (rank {record_rank(cfg_r.spatial_devices)})")
            check_pcdf2d(f"pcdf2d_{tag}", args_g, job_stats(rec))
            check(f"p2g2d_{tag}",
                  lambda: transfer2d.p2g_tiles(*args_h),
                  lambda: transfer2d.p2g_plain(*args_h),
                  lambda k, p: [], lambda k, p: [("mm tiles", k[0], p[0]),
                                                 ("impulses", k[1], p[1])],
                  cost=p2g2d_cost(ce, pg, nj, njg, nc))
            check(f"g2p2d_{tag}",
                  lambda: transfer2d.g2p_rows(*args_i),
                  lambda: transfer2d.g2p_plain(*args_i),
                  lambda k, p: [], lambda k, p: [("rows", k, p)],
                  cost=g2p2d_cost(ce, pg, nj, njg, npad + cfg_r.group + 128))
            check(f"update_rows2d_{tag}",
                  lambda: update_rows.update_rows2d(*args_c2),
                  lambda: update_rows.update2d_plain(*args_c2),
                  lambda k, p: [(f"row {r}", k[r], p[r], 1e-4) for r in range(k.shape[0])],
                  lambda k, p: [(f"row {r}", k[r], p[r]) for r in (9, 12, 13, 14)],
                  cost=c_cost(C_ROWS_READ_2D, 6, 5, rec["rows"].shape[0], npad, ce, 400))
            del args_g, args_h, args_i, args_c2
        # D on the substep's last sort (under migration the second), E on its
        # sorted keys' run starts (a lane-index row: sparse keys pass E's
        # exact f32).
        check(f"permute_{tag}",
              lambda: permute.permute_lanes(rec["unsorted"], rec["perm"]),
              lambda: permute.permute_plain(rec["unsorted"], rec["perm"]),
              lambda k, p: [], lambda k, p: [("rows", k, p)],
              cost=(4 * (2 * rec["unsorted"].shape[0] * npad + npad), 0),
              library=lambda: rec["unsorted"].index_select(1, rec["perm"]))
        sids = rec["sorted_ids"]
        first = torch.ones_like(sids, dtype=torch.bool)
        first[1:] = sids[1:] != sids[:-1]
        vals = torch.arange(npad, device=dev, dtype=torch.float32)[None, :]
        cap_e = min((cfg_r.amax if cfg_r.sparse else int(rec["nb_total"])) + 3, npad)
        check(f"compact_{tag}",
              lambda: compact.compact_flagged(vals, first, cap_e),
              lambda: compact.compact_plain(vals, first, cap_e),
              lambda k, p: [], lambda k, p: [("values", k[0], p[0]), ("ok", k[1], p[1])],
              cost=(npad + 4 * int(first.sum()) + 4 * 2 * cap_e, 0))
        del rec, sids, first, vals
        torch.cuda.empty_cache()
    del records

    mark("phase 6")
    # ---- 6. kernel path vs plain path on small scenes ----
    def agree(sk, sp, what):
        ik = torch.argsort(sk.particles.ids.cpu())
        ip = torch.argsort(sp.particles.ids.cpu())
        for name, tol in (("pos", 1e-5), ("vel", 1e-4), ("def_grad", 1e-4)):
            e = float((getattr(sk.particles, name).cpu()[ik]
                       - getattr(sp.particles, name).cpu()[ip]).abs().max())
            if not e <= tol:
                fail(f"{what}: {name} differs from the plain path by {e}")
        if not torch.equal(sk.particles.cdf_affinity.cpu()[ik],
                           sp.particles.cdf_affinity.cpu()[ip]):
            fail(f"{what}: affinity words differ from the plain path")

    def same(sk, sg, what):
        """The kernel path and the plain path on the card: every sum in the
        same order, so the same bits."""
        for name in ("pos", "vel", "def_grad", "affine", "cdf_affinity"):
            if not torch.equal(getattr(sk.particles, name),
                               getattr(sg.particles, name)):
                fail(f"{what}: {name} differs from the plain path on the card")
        for name in ("pos", "rot", "linvel", "angvel"):
            if not torch.equal(getattr(sk.bodies, name), getattr(sg.bodies, name)):
                fail(f"{what}: body {name} differs from the plain path on the card")

    def small(device, shift=None):
        d = scenes.sand_box_3d(nxz=8, ny=16, device=device, by=BY, group=256)
        if shift is not None:
            d.state.particles.pos += torch.tensor(shift, device=device)
        return d

    dk, dp = small(dev), small("cpu")
    sk = step_pallas(dk.state, dk.params, dk.config, 10)
    with plain_versions():
        same(sk, step_pallas(dk.state, dk.params, dk.config, 10), "small scene")
    agree(sk, step_pallas(dp.state, dp.params, dp.config, 10), "small scene")
    # Lattice lowered onto the paddle: CPIC impulses and level-2 ghosts.
    dk, dp = small(dev, (0.0, -3.0, 0.0)), small("cpu", (0.0, -3.0, 0.0))
    sk = step_pallas(dk.state, dk.params, dk.config, 5)
    with plain_versions():
        same(sk, step_pallas(dk.state, dk.params, dk.config, 5), "contact scene")
    # Against the CPU, each substep starts both paths from the CPU state:
    # the penetrating start amplifies roundoff from substep to substep.
    sp = dp.state
    for _ in range(5):
        sk = step_pallas(_to(sp, dev), dk.params, dk.config, 1)
        sp_next = step_pallas(sp, dp.params, dp.config, 1)
        agree(sk, sp_next, "contact scene")
        sp = sp_next
    # 10 substeps each: the two small 2D scenes, and the collider-free and
    # neo-Hookean scenes of the CPU tests.  The collider-free 3D lattice
    # carries elastic models: with the sand's, the jittered spin leaves
    # particles at the Drucker-Prager cone tip, where roundoff picks the
    # return map's branch.
    small_10 = {
        "2D sand column": lambda device: scenes.sand_column_2d(
            nx=24, ny=48, cell_width=0.5, group=128, device=device),
        "2D elastic blocks": lambda device: scenes.elastic_blocks_2d(
            n_side=24, cell_width=0.5, group=128, device=device),
        "3D collider-free lattice": lambda device: collider_free(
            scenes.sand_box_3d(nxz=8, ny=16, with_paddle=False, device=device),
            jitter=0.5, elastic=True, by=BY, group=256),
        "2D collider-free column": lambda device: collider_free(
            scenes.sand_column_2d(nx=24, ny=48, cell_width=0.5, device=device),
            jitter=0.5, group=128),
        "3D neo-Hookean sand box": lambda device: scenes.sand_box_3d(
            nxz=8, ny=16, device=device, by=BY, group=256,
            elastic_model="neo_hookean"),
        "3D sand box (fold_vel)": lambda device: scenes_small_3d(
            device, fold_vel=True),
        "3D collider-free lattice (fold_vel)": lambda device: collider_free(
            scenes.sand_box_3d(nxz=8, ny=16, with_paddle=False, device=device),
            jitter=0.5, elastic=True, by=BY, group=256, fold_vel=True),
        "2D sand column (fold_vel)": lambda device: small_column_2d(
            device, fold_vel=True),
        # The sparse domain: tests/test_sparse_domain.py's box and spray.
        "3D sparse sand box": lambda device: scenes.sand_box_3d(
            nxz=8, ny=16, device=device, group=64, sparse=True),
        "3D sparse ballistic spray (collider-free)": spray_scene,
    }
    for what, make in small_10.items():
        dk, dp = make(dev), make("cpu")
        wt.reset_launch_counts()
        sk = step_pallas(dk.state, dk.params, dk.config, 10)
        counts = launches_run(wt)
        if what == "3D neo-Hookean sand box":
            launches["update_rows_neo_hookean"] = counts["update_rows"]
        if dk.config.num_colliders == 0 and dk.config.grid.dim == 3 and not counts["p2g"]:
            fail(f"{what}: kernel F never launched: {counts}")
        if ("fold_vel" in what) != dk.config.fold_vel:
            fail(f"{what}: built with fold_vel={dk.config.fold_vel}")
        if ("sparse" in what) != dk.config.sparse or (dk.config.sparse and min(
                counts[k] for k in (KERNELS_SPARSE if dk.config.num_colliders
                                    else KERNELS_FREE[:-1])) <= 0):
            fail(f"{what}: built with sparse={dk.config.sparse}, launches {counts}")
        with plain_versions():
            same(sk, step_pallas(dk.state, dk.params, dk.config, 10), what)
        agree(sk, step_pallas(dp.state, dp.params, dp.config, 10), what)
    print("small scenes (3D sand box, contact, collider-free and neo-Hookean; "
          "2D sand column, elastic blocks and collider-free column; the 3D sand "
          "box, the 3D collider-free lattice and the 2D sand column folded; the "
          "sparse sand box and spray): kernel path equals the plain path on the "
          "card and agrees with it on the CPU", flush=True)
    # Sparse against bounded on the card: the 8 x 16 sand box (by 4, group
    # 64) built both ways, 20 substeps, held to tests/test_sparse_domain.py's
    # tolerances (positions 1e-5, velocities 1e-4, affinity words exact,
    # body positions 1e-6).
    db, ds = (scenes.sand_box_3d(nxz=8, ny=16, device=dev, group=64, sparse=sp)
              for sp in (False, True))
    sb = step_pallas(db.state, db.params, db.config, 20)
    ss = step_pallas(ds.state, ds.params, ds.config, 20)
    ib, is_ = torch.argsort(sb.particles.ids), torch.argsort(ss.particles.ids)
    errs = {f: float((getattr(ss.particles, f)[is_] - getattr(sb.particles, f)[ib])
                     .abs().max()) for f in ("pos", "vel", "def_grad", "affine")}
    body_err = float((ss.bodies.pos - sb.bodies.pos).abs().max())
    if (not errs["pos"] <= 1e-5 or not errs["vel"] <= 1e-4 or not body_err <= 1e-6
            or not torch.equal(ss.particles.cdf_affinity[is_],
                               sb.particles.cdf_affinity[ib])):
        fail(f"sparse box against bounded: max differences {errs}, bodies {body_err}, "
             "or affinity words differ")
    bit = all(v == 0.0 for v in errs.values()) and all(
        torch.equal(getattr(ss.bodies, f), getattr(sb.bodies, f))
        for f in ("pos", "rot", "linvel", "angvel"))
    print(f"sparse sand box against bounded (by 4, 20 substeps, on the card): max "
          f"differences {errs}, bodies {body_err}; affinity words equal; bit-equal: "
          f"{bit}", flush=True)
    del db, ds, sb, ss
    # The analytic-shapes slice, 5 substeps each; against the CPU each
    # substep starts both paths from the CPU state (contact from the start).
    small_5 = {
        "3D analytic shapes on the capsule (gathered)": lambda device: shapes_scene(
            scenes_small_3d(device, (0.0, -3.0, 0.0), with_paddle=False), False,
            by=BY, group=256),
        "3D analytic shapes on the capsule (chan-free)": lambda device: shapes_scene(
            scenes_small_3d(device, (0.0, -3.0, 0.0), with_paddle=False), True,
            by=BY, group=256),
        "3D 16 colliders": sixteen_colliders,
        "3D all colliders kinematic": all_kinematic,
        "2D sand column stirred by a kinematic ball and capsule": stirred_column_2d,
        "2D stirred column (chan-free)": lambda device: stirred_column_2d(device,
                                                                          True),
        "2D sand column in its floor (chan-free, fold_vel)": lambda device:
            small_column_2d(device, (0.0, -0.75), chan_free=True, fold_vel=True),
        "2D sand2 with dynamic plates pressed into the floor and each other":
            lambda device: sand2_scene(device, SAND2_SMALL, plates=sand2_pressed(48),
                                       shift=(0.0, -4.55),
                                       group=128, chan_free=False),
        "3D dynamic plate on a ball joint": plate_joint_3d,
        "3D four materials with fracture": lambda device: four_materials(
            scenes_small_3d(device), (0.0, -3.0, 0.0), True, 1.0005),
        "2D four materials with fracture": lambda device: four_materials(
            scenes.elastic_blocks_2d(n_side=24, cell_width=0.5, group=128, device=device),
            (0.0, -0.75), False, 1.00005),
        # Mesh colliders (the dense CDF mode with the mesh pass).
        "3D trimesh ramp and cuboid floor (mesh)": lambda device: ramp_scene(device),
        "3D trimesh ramp and cuboid floor, by 8 (mesh)": lambda device: ramp_scene(
            device, BY),
        "2D polyline tent and cuboid floor (mesh)": tent_scene,
        "3D sand box with a kinematic spinning trimesh paddle (mesh)": paddle_scene,
        "3D small elastic_cut3 pressed onto its blades with fracture (mesh)":
            lambda device: cut3_scene(device, 0.2, shift=(0.0, -7.0, 0.0),
                                      max_stretch=1.0002, vel=(0.0, -4.0, 0.0),
                                      group=64),
        # The sparse domain: the ramp (the slot channel grid with the
        # slot-addressed mesh pass) and the box past its capacities.
        "3D sparse trimesh ramp and cuboid floor (mesh)": lambda device: ramp_scene(
            device, sparse=True),
        "3D sparse sand box at kmax 8, amax 16 (overflow)": lambda device:
            scenes.sand_box_3d(nxz=8, ny=16, device=device, group=64, sparse=True,
                               kmax=8, amax=16),
        # The chan-free mode in the sparse domain: every collider in-kernel
        # at window nodes placed from the packed keys' block coordinates.
        "3D sparse sand box lowered onto its floor and paddle (chan-free)":
            lambda device: scenes_small_3d(device, (0.0, -4.5, 0.0), by=BY_SPARSE,
                                           group=64, sparse=True, chan_free=True),
    }
    for what, make in small_5.items():
        dk, dp = make(dev), make("cpu")
        if (("chan-free" in what) != dk.config.chan_free
                or ("fold_vel" in what) != dk.config.fold_vel):
            fail(f"{what}: built in the wrong CDF mode or fold setting")
        wt.reset_launch_counts()
        sk = step_pallas(dk.state, dk.params, dk.config, 5)
        counts = launches_run(wt)
        kernels = ((KERNELS_SPARSE if dk.config.sparse else KERNELS_3D)
                   if dk.config.grid.dim == 3 else KERNELS_2D)
        if min(counts[k] for k in kernels) <= 0:
            fail(f"{what}: a kernel of the path never launched: {counts}")
        if dk.config.dynamic_slots and counts["rigid_solve"] != 5:
            fail(f"{what}: {counts['rigid_solve']} rigid-solve launches in 5 substeps")
        if "joint" in what:
            launches["rigid_solve_joints"] = counts["rigid_solve"]
        mesh_key = "mesh_cdf_sparse" if dk.config.sparse else "mesh_cdf"
        if dk.config.mesh_cids and counts[mesh_key] != 5:
            fail(f"{what}: {counts[mesh_key]} {mesh_key} launches in 5 substeps")
        if "overflow" in what:
            _, dg = step_with_diag(dk.state, dk.params, dk.config, 1)
            if not (int(dg.sparse_occ_overflow) > 0 and int(dg.sparse_act_overflow) > 0):
                fail(f"{what}: the overflow is not reported: {dg.summary()}")
            print(f"{what}: {dg.summary()}", flush=True)
        if "fracture" in what:
            c_name = "update_rows" if dk.config.grid.dim == 3 else "update_rows2d"
            if "four materials" in what:
                launches[f"{c_name}_fracture"] = counts[c_name]
            if not bool((sk.models.phase == 0.0).any()):
                fail(f"{what}: no lane fractured")
        if dk.config.chan_free and (dk.config.grid.dim == 2 or dk.config.sparse):
            # A chan-free scene proves nothing if no job is gated.
            rec = {}
            step_pallas(dk.state, dk.params, dk.config, 1, record=rec)
            hist = gate_histogram(rec)
            if hist[1] + hist[2] == 0:
                fail(f"{what}: no job gated")
        with plain_versions():
            same(sk, step_pallas(dk.state, dk.params, dk.config, 5), what)
        sp = dp.state
        for _ in range(5):
            sk = step_pallas(_to(sp, dev), dk.params, dk.config, 1)
            sp_next = step_pallas(sp, dp.params, dp.config, 1)
            agree(sk, sp_next, what)
            sp = sp_next
    print("small analytic-shapes, dynamic-body, fracture and mesh scenes ("
          + "; ".join(small_5) + "): kernel path "
          "equals the plain path on the card and agrees with it on the CPU "
          "substep by substep", flush=True)
    # The dense and blocked transfers: (substeps, scene), against the CPU
    # substep by substep.
    small_dense = {
        "3D dense sand box": (10, lambda device: scenes.sand_box_3d(
            nxz=8, ny=16, device=device, transfer="dense")),
        "3D dense CPIC oracle scene with its dynamic plate": (5, cpic_scene),
        "2D dense sand column": (10, lambda device: scenes.sand_column_2d(
            nx=24, ny=48, cell_width=0.5, device=device, transfer="dense")),
        "3D dense trimesh ramp and cuboid floor (mesh)": (5, lambda device: ramp_scene(
            device, transfer="dense")),
        "3D blocked box with bodies at max_jobs 8": (5, blocked_box),
        # More than 128 materials (each particle its own lambda): the wide
        # material table on both transfers.
        "2D 256-material lattice (dense)": (3, lambda device: many_materials(
            device, "dense", 2)),
        "2D 256-material lattice (blocked)": (3, lambda device: many_materials(
            device, "blocked", 2)),
        "3D 256-material lattice on a floor (dense)": (3, lambda device: many_materials(
            device, "dense", 3)),
        "3D 256-material lattice on a floor (blocked)": (3, lambda device: many_materials(
            device, "blocked", 3)),
    }
    for what, (steps, make) in small_dense.items():
        dk, dp = make(dev), make("cpu")
        wt.reset_launch_counts()
        sk = step_dense(dk.state, dk.params, dk.config, steps)
        counts = launches_run(wt)
        # A collider-free scene takes no particle CDF (dense_pcdf).
        need = KERNELS_DENSE[:3] if dk.config.num_colliders else KERNELS_DENSE[1:3]
        if min(counts[k] for k in need) != steps:
            fail(f"{what}: not one launch of each dense kernel a substep: {counts}")
        if "256-material" in what:
            if dk.config.n_materials != 256 or dk.state.models.mat_table.shape[1] != 256:
                fail(f"{what}: {dk.config.n_materials} materials")
            # Each particle's own material matters: with the ids reversed
            # (particle k reads material 255 - k) the velocities move off.
            m = dk.state.models
            rev = dataclasses.replace(dk.state, models=dataclasses.replace(
                m, mat_id=m.mat_id.flip(0)))
            gap = float((step_dense(rev, dk.params, dk.config, steps).particles.vel
                         - sk.particles.vel).abs().max())
            if not gap > 1e-4:
                fail(f"{what}: reversed material ids move the velocities by {gap} only")
        if dk.config.mesh_cids and counts["mesh_cdf"] != steps:
            fail(f"{what}: {counts['mesh_cdf']} mesh_cdf launches in {steps} substeps")
        if "max_jobs" in what:
            rec = {}
            step_dense(dk.state, dk.params, dk.config, 1, record=rec)
            if not int(rec["jobs"]["needed"]) > dk.config.max_jobs:
                fail(f"{what}: the job table does not overflow")
        with plain_versions():
            same(sk, step_dense(dk.state, dk.params, dk.config, steps), what)
        sp = dp.state
        for _ in range(steps):
            sk = step_dense(_to(sp, dev), dk.params, dk.config, 1)
            sp_next = step_dense(sp, dp.params, dp.config, 1)
            agree(sk, sp_next, what)
            sp = sp_next
    print("small dense and blocked scenes (" + "; ".join(small_dense) + "): kernel "
          "path equals the plain path on the card and agrees with it on the CPU "
          "substep by substep", flush=True)
    mark("phase 6 (2-rank scenes)")
    parallel_small_scenes(dev)
    for c in checks:
        c["launches"] = launches[c["name"]]
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)

    print(json.dumps({"kernels": checks}), flush=True)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
