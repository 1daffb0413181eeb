"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--keep-store DIR]

``--keep-store DIR`` also writes the resumed store of the ``rgbd_sessions``
phase, its stored images and depth dropped, to ``DIR/resumed_stripped.db``
(for ``scripts/jax_global_ba.py``, the JAX twin's global BA on the CPU).

Phases — any failure ends the run with a non-zero exit code:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel of the path from ``rtabmap_tpu_torch/csrc``
   (one nvcc per source, all at once) into ``build/``;
3. kernels: holds each kernel against its plain PyTorch version on the card
   with exact equality, and times kernel, plain version, one PyTorch
   library call of the same function, and the bound: the vocabulary 2-NN
   (K1) at Q=400 against the 262144-row slab with 70% valid words, against
   a slab whose valid words are the prefix of 31853 rows (the BOW cell's
   end state) both whole and as the prefix the dictionary passes, and at a
   ragged Q=37 x W=5000; the 3-D 1-NN (K2) at the LiDAR path's shapes, a
   28800-point VLP-16 scan against a 2048- and a 16384-point odometry map
   and against another scan, each unmasked and with the scans' 5 cm voxel
   masks (queries and points), and at the edge cases: a ragged 37 x 5000
   with 30% invalid and duplicated points, with and without a 30% query
   mask, no valid point, no valid query, one valid query and point, 1 x 1;
   K2's compaction kernel against its plain version in every case, and at
   the edges of its tiles (``compact_edge_cases``, the case list of
   ``rtabmap_tpu_torch/ops/cuda/compact_cases.py``: T-1 to 4T+1 points or
   query flags, all, none or only the last one valid, each with its flags
   aligned and at a byte offset that is not a multiple of 16); K2 at the RGB-D +
   LiDAR path's destinations: a 28800-point scan against three VLP-16
   scans assembled in one node's frame (131072 rows, the scan-proximity
   slab) and against the whole map's scans (4194304 rows, at most 65536
   valid after the 5 cm voxel hash: the global scan map); one masked
   search and the global scan map's compaction under
   ``torch.cuda.set_sync_debug_mode("error")`` (they must not sync).
   Kernel times are one eager call each (``kernel_ms``, as the earlier
   slices timed them, the kernels line's ``ms``) and the device time of a
   CUDA graph of ten calls (``graph_ms``);
4. slice ``bow_mapping``: the appearance-only tick —
   ``FeatureExtractor.extract`` -> ``Rtabmap.process`` with
   RGBD/Enabled=false on cuda, 640x480 renders of two 150-frame laps, 400
   keypoints, the default 262144-word vocabulary, 1024 node slots; lap 2
   must close with lap-1 nodes of the same viewpoint at least as often as
   the threshold below;
5. slice ``lidar_mapping``: ``run_lidar_mapping`` (scan-to-map ICP
   odometry, proximity closures, dense pose graph, voxel map) on cuda over
   ``lidar_trajectory(150, radius=2.0)`` with sensor-frame noise of
   sigma 0.01 m: first at the parity width 16 x 225, held against the JAX
   package's CPU run of the same sequence (``scripts/jax_lidar_mapping.py``),
   then at the full VLP-16 width 16 x 1800 = 28800 points a scan with a
   16384-point local map, held against the simulator's ground truth, timed;
6. slice ``rgbd_mapping``: the default metric RGB-D tick through
   ``run_dataset`` (``FeatureExtractor.extract`` -> ``OdometryF2M.process``
   -> ``Rtabmap.process``: F2M visual odometry with local bundle
   adjustment, PnP registration, proximity closures, incremental graph
   optimization) on cuda (``tools/rgbd_laps.py``): first the JAX package's
   end-to-end test sequence (``tests/test_slam_e2e.py``: 58 frames at
   320x240, 384 keypoints, 128 node slots), held against the JAX package's
   CPU run of it (``scripts/jax_rgbd_laps.py``); then the full width, two
   60-frame laps at 640x480 with 512 keypoints, the 262144-word vocabulary,
   1024 node slots and the 2000-point F2M map, held against the ground
   truth and the JAX CPU run's closures; this full-width run is the
   ``rgbd_sessions`` mapping session below (the same frames, camera,
   parameters and seed), written into its store, so it runs once and is
   held to both phases' checks. Both check that the F2M map, the
   vocabulary and node slabs and the posterior lie on the card and that
   K1 launched once per quantize call;
7. slice ``rgbd_sessions``: the map store's user path
   (``tools/rgbd_sessions.py``) on cuda at the same full width, three
   sessions against one SQLite store in a temporary directory: mapping
   (the two 60-frame laps into a fresh store, ``repair_graph()``,
   ``close()``: the rgbd_mapping phase's full-width run), resume
   (``Rtabmap.load``, odometry restarted at the identity, two 85-frame
   laps; the merged graph passes 256 nodes, so its full solves run
   ``optimize_pcg`` at 512 padded nodes) and localization
   (``Mem/IncrementalMemory`` false, 20 frames). Held to the ground truth
   (no lost frame, map ATE <= 0.08 m, a localization under 0.1 m), to the
   JAX package's lowest closure and localization counts over four seeds
   (``scripts/jax_rgbd_sessions.py``; the localization runs once for each
   of six seeds, each on its own copy of the resumed store, and the mean
   of their localized counts is held), to a frozen map in localization
   (WM holds only stored nodes, the node count within the STM ring plus a
   margin, the stored sessions' rows unchanged), and to the store's rows
   (nodes, links, one statistics row a frame). The resumed session must
   reach ``optimize_pcg`` and link to the first session; its merged graph
   is then solved again by ``optimize_pcg`` with the CG loop eager and as
   the captured CUDA graph, which must agree;
8. slice ``rgbd_scan``: RGB-D + LiDAR SLAM (``tools/rgbd_scan.py``): the
   RGB-D frames with a VLP-16 scan each, through packets, passed as
   ``scan=`` with a local grid as ``grid=``, neighbour-link refining and
   epipolar verification on. The parity sequence (test_slam_e2e's 58
   frames at 320x240, 16 x 225 scans, intermediate nodes at
   ``Rtabmap/DetectionRate`` 0.5) is held to the JAX package's CPU runs
   (``scripts/jax_rgbd_scan.py``); the full width (two 60-frame laps at
   640x480, 16 x 1800 scans, into a store) to the ground truth: no lost
   frame, ATE, refinings, a scan-proximity link, the epipolar check on
   every accepted closure, the assembled occupancy grid on the walls; the
   localization in that store with ``RGBD/ProximityGlobalScanMap`` (20
   frames) to the stored scans, the global scan map's registrations and
   their errors, and the localized frames. K2 must launch in all three
   scan stages (neighbour refining, scan proximity, the global scan map):
   31 searches and one compaction a registration;
9. slice ``map_tools``: what a user runs on a finished map store
   (``tools/cli.py``'s store tools and the engine's maintenance API). First
   the same inputs on the card and with ``device="cpu"`` (12 frames of the
   parity trajectory at 320x240: TSDF fusion, surface nets, the texture
   bake and ``texture_mesh``; ``bundle_adjust_large`` against its CPU run and
   the dense ``bundle_adjust``), held to the tolerances stated at
   ``MT_VOXEL_TOL``. Then the full width, on copies of the ``rgbd_sessions``
   stores: on the mapping session's store ``reprocess`` (every node
   recreated, 90% of the session's loops, K1 once a quantize call),
   ``detect_more_loop_closures`` at 0.25 m (map ATE at most 1.1 x before),
   ``export`` in the five pose formats read back, ``recovery`` (the same
   nodes and links); on the resumed store (two sessions)
   ``global_bundle_adjustment`` (its path, poses on SO(3), its anchors in
   place, a lower cost, map ATE at most 1.1 x that of the twin's problem,
   the rotations kept as stored, and at most 0.08 m) and ``export_cloud``
   as a cloud, ``--mesh`` (90% of the vertices
   within two voxels of one of the hall's six planes) and ``--texture``
   (observed texels correlated at least 0.8 with the hall's own texture),
   each file read back equal. The compaction kernel's library call (a
   ``nonzero`` and an ``index_select``) is timed in the kernels phase.
10. slice ``stereo``: stereo and visual-inertial SLAM through the dataset
   tools (``tools/stereo_datasets.py``): each run writes its synthetic
   layout (rendered on the card, written by the port's PNG writer) into a
   temporary directory and runs the port's CLI tool on it on the card:
   the RGB-D parity trajectory as a KITTI stereo layout at 320x240
   (``kitti_dataset``), held to the JAX package's CPU runs of the same
   files (``scripts/jax_stereo_datasets.py``); EuRoC cam0's geometry at
   752x480, two 60-frame laps (``euroc_dataset``), held to the ground
   truth and the JAX closures; KITTI 00's calibration at 1241x376, 40
   frames with a poses file (``kitti_dataset``: no lost frame, the KITTI
   errors reported); a CID-SIMS layout at 640x480 with 16-bit depth and a
   200 Hz ``imu.txt`` (``cid_sims_dataset --gt --imu 0`` and ``--imu 1``),
   every tracked pose's roll and pitch held to the integrated IMU's; then
   ``stereo_eval`` on the full run's first pair, dense SGBM and sparse LK
   on the card held to the same tool on the CPU. Each run prints the
   median and p90 of ``extract_ms`` (with the LK disparities), ``imu_ms``,
   ``odom_ms`` and ``process_ms``; K1 must launch once a quantize call.
11. slice ``learned``: the learned front end (``Kp/DetectorStrategy`` 11,
   SuperPoint, and ``Vis/CorNNType`` 6, the bundled attentional matcher;
   ``tools/rgbd_laps.py --learned``). Card against CPU on the same inputs:
   SuperPoint on a 640x480 frame in float32 and bfloat16, both SuperGlue
   matchers (the distilled one and the official architecture on seeded
   random weights) on two frames' 512 keypoints, and the learned stereo
   extraction on the EuRoC layout's first pair (752x480); the networks'
   times (SuperPoint at 640x480 and 752x480, the matcher at 512 x 512 and
   its Sinkhorn, the official forward). Then three runs held to the JAX
   package's CPU runs (``scripts/jax_rgbd_laps.py --learned``, seeds
   0-3): ``full-revisit`` (two laps at 640x480, the second repeating the
   first) with ground-truth poses straight into ``Rtabmap.process``: the
   closures, their errors and the ATE; ``full`` the same way: each lap-2
   frame's highest hypothesis and its value against the seed-0 JAX run;
   ``parity`` through ``run_dataset`` (F2M on SuperPoint features): loops
   and lost frames. Each run keeps Vis/CorNNType 6 and calls the matcher;
   K1 launches once a quantize call and is timed at the closure run's end
   state.
12. slice ``navigation`` (between ``rgbd_sessions`` and ``map_tools``):
   navigation on a saved map (``tools/navigation.py``) on copies of the
   mapping session's store. ``db_edit set_label`` labels ``dock`` (lap 1's
   first node) and ``desk`` (its frame 30), read back by ``db_edit nodes``;
   the store is loaded in localization mode with ``Rtabmap/MemoryThr`` 60
   (lap 1 goes to LTM on the first tick) and lap 1 is driven at 640x480
   from frame 30 back to frame 0 through ``run_dataset``, the goal sent as
   soon as a path reaches the dock. Held to the JAX package's CPU runs
   (``scripts/jax_navigation.py``, seeds 0-3): the path runs from the
   current node to the dock, the current goal never moves back along it, a
   tick pages a path node back from the store outside the hypothesis'
   neighbourhood, the goal is reached within the JAX highest frame + 2, no
   virtual link is left, K1 launches once a quantize call, every statistic
   is finite; K1 timed at the drive's end state. Then ``set_goal_pose``
   (desk's pose 0.2 m further out snaps to desk; 50 m off is refused),
   ``compute_path`` and ``set_goal`` on the card equal to the CPU's, the
   dot-graph, prediction and log-file dumps read back,
   ``delete_last_location`` persisted and ``reset_memory`` on a further
   copy, and a traced 2-frame run of the RGB-D parity sequence through
   ``run_dataset`` (``Tpu/ProfileDir``) with its device busy share.
13. slice ``classical``: the classical front ends and the other visual
   odometries. Card against CPU on the same inputs: the four response
   maps (GFTT, Harris, DoG, FAST) and the SIFT descriptors of a 640x480
   frame, their sign-LSH words, ``gms_filter`` and a ``Vis/CorNNType`` 7
   registration, and F2F and mono over 6 frames; the PnP-RANSAC's CUDA
   graph against its eager ops (equal); each strategy's extraction time. Then, through ``run_dataset``, ``Kp/DetectorStrategy``
   2 (ORB) at the full width (two 60-frame laps at 640x480), 1 (SIFT ->
   sign-LSH words) and 2 with ``Vis/CorNNType`` 7 (GMS) on the parity
   sequence, and, through ``tools/odometries.py``, F2F (``Odom/Strategy``
   1) over the full width's first lap and mono over
   ``tests/test_odometry_mono.py``'s strafe at 640x480; each held to the
   JAX package's CPU runs of the same frames (``scripts/jax_rgbd_laps.py
   --strategy``, ``scripts/jax_odometries.py``, seeds 0-3); K1 launches
   once a quantize call and is timed at the ORB run's end state.

Each slice zeroes the launch counts of its kernels right before each run
and reads them right after; they must equal the calls the run made (K1:
one launch a quantize call; K2: one search launch a search, one
compaction launch a prepared destination; in ``rgbd_scan`` 31 searches
and one compaction a registration of a scan stage). The kernels line's
``launches`` sums the slices that launch each kernel; a K2 search launch
is two CUDA kernels (``nn3d_chunks``, ``nn3d_merge``), a compaction launch
one or two (``nn3d_compact_scatter``, after ``nn3d_compact_count`` in a
plan of more than ``K2.COMPACT_ONE_PASS_TILES`` tiles a kind; the LiDAR
and ``rgbd_scan`` runs print those plans as
``nn3d_compact_count_launches``, and ``rgbd_scan`` fails without one).

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rtabmap_tpu_torch.datasets import synthetic as SYN
from rtabmap_tpu_torch.datasets.synthetic import VLP16_AZIMUTH
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as CAMERA
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.maps import mesh as MESH
from rtabmap_tpu_torch.maps import texture as TEX
from rtabmap_tpu_torch.maps import tsdf as TSDF
from rtabmap_tpu_torch.core.frame import FeatureExtractor
from rtabmap_tpu_torch.memory.db import Database
from rtabmap_tpu_torch.models import superglue as SGM
from rtabmap_tpu_torch.models import superglue_official as SGO
from rtabmap_tpu_torch.models import superpoint as SPM
from rtabmap_tpu_torch.ops.cloud import estimate_normals, voxel_filter
from rtabmap_tpu_torch.ops.cuda import build
from rtabmap_tpu_torch.ops.cuda import compact_cases as CC
from rtabmap_tpu_torch.ops.cuda import nn3d as K2
from rtabmap_tpu_torch.ops.cuda import vocab_knn as K1
from rtabmap_tpu_torch.optim import ba as BA
from rtabmap_tpu_torch.optim import pose_graph as PG
from rtabmap_tpu_torch.tools import cli as CLI
from rtabmap_tpu_torch.tools import dataset_runner as DR
from rtabmap_tpu_torch.tools import bow_laps
from rtabmap_tpu_torch.tools import lidar_mapping as LM
from rtabmap_tpu_torch.tools import navigation as NAV
from rtabmap_tpu_torch.tools import rgbd_laps
from rtabmap_tpu_torch.tools import rgbd_scan as RSC
from rtabmap_tpu_torch.tools import rgbd_sessions
from rtabmap_tpu_torch.tools import stereo_datasets as SD
from rtabmap_tpu_torch.tools.export_poses import import_poses
from rtabmap_tpu_torch.utils import metrics
from rtabmap_tpu_torch.utils.params import Parameters

# H100 SXM dense peaks (NVIDIA data sheet): HBM bytes/s, int8 tensor op/s,
# and FP32-pipe instructions/s outside the tensor cores: the data sheet's
# 67 TFLOP/s counts an FMA as two operations, so 33.5e12 instructions.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32_INSTR_PER_S = 67e12 / 2

FRAMES_PER_LAP = bow_laps.FRAMES_PER_LAP
# Lap-2 ticks that close with a lap-1 node of the same viewpoint (+-3
# frames): the JAX package's own CPU run of this sequence
# (scripts/jax_bow_laps.py) counts JAX_LAP2_SAME_VIEW. The port on the card
# must reach 90% of it: float sums run in another order on the card (blur
# products, likelihood reductions, atomics in the Bayes scatter), which can
# move a near-tie keypoint or hypothesis.
JAX_LAP2_SAME_VIEW = 97
LAP2_THRESHOLD = int(0.9 * JAX_LAP2_SAME_VIEW)

# The LiDAR sequence: 150 frames, one closed 12.6 m loop at 0.084 m a frame
# (walking speed at 10 Hz), sensor-frame noise sigma 0.01 m.
LIDAR_FRAMES = 150
LIDAR_NOISE = 0.01
PARITY_AZIMUTH = 225          # parity width: 16 x 225 = 3600 points
# The JAX package's CPU run of the parity-width sequence
# (scripts/jax_lidar_mapping.py: 381.2 s on an 8-core CPU host): 150 nodes,
# 139 proximity closures, 0 lost frames, ATE 0.02543 m after the graph
# solve. The card must reach 90% of the closures, lose no more frames and
# stay within 0.01 m of that ATE: sums run in another order on the card
# (and the normals of near-collinear ring neighbourhoods are ill-
# conditioned), which moves a borderline registration.
JAX_LIDAR_CLOSURES = 139
JAX_LIDAR_LOST = 0
JAX_LIDAR_ATE = 0.025430718484748708
# Full width: the bound the JAX package's own scan-odometry test holds its
# odometry to (tests/test_scan_odometry.py), here for the solved graph.
FULL_WIDTH_ATE = 0.05

# The RGB-D parity sequence (tests/test_slam_e2e.py's): the JAX package's
# CPU run (scripts/jax_rgbd_laps.py) closes 11 loops, adds 2 proximity
# links, loses no frame and ends at a SLAM ATE of 0.02919 m. The card must
# reach 90% of the loops, lose no more frames and stay within 0.02 m of
# that ATE, and inside test_slam_e2e's 0.08 m: the RANSAC draws differ
# (a torch generator against jax.random) and sums run in another order on
# the card, which moves a borderline registration or keyframe.
JAX_RGBD_LOOPS = 11
JAX_RGBD_LOST = 0
JAX_RGBD_ATE = 0.029193185743422653
RGBD_ATE_BOUND = 0.08
# The full-width sequence: the JAX CPU run (scripts/jax_rgbd_laps.py)
# closes 61 loops, adds 25 proximity links, loses no frame, odometry ATE
# 0.02997 m, SLAM ATE 0.02330 m. The card must reach 90% of its loops (the
# same reasons as above); against the ground truth it must lose no frame
# and stay within RGBD_ATE_BOUND and within 1.1 x its own odometry's ATE.
JAX_RGBD_FULL_LOOPS = 61
# Words in the vocabulary at the end of that run: the prefix K1 scans on
# the run's last quantize calls.
RGBD_FULL_WORDS = 24054

# Words in the vocabulary at the end of the three sessions below (the
# port's first run of them on the card): the prefix K1 scans last.
SESSIONS_END_WORDS = 48802

# The three sessions against one store (tools/rgbd_sessions.py): the JAX
# package's CPU runs of them (scripts/jax_rgbd_sessions.py, seeds 0-3:
# the RANSAC draws differ between the packages, and between seeds) give
# the lowest loop closures of the mapping and resume sessions and the
# fewest localized frames; the card must reach 90% of each.
# Seeds 0-3: mapping 61, 56, 54, 55 loops; resume 134, 156, 156, 143
# loops; localization 18, 16, 18, 17 frames localized. (Seeds 4-7 read
# mapping 52, 57, 61, 56, resume 136, 152, 144, 151 and localization 17,
# 19, 18, 20; the thresholds stay those of seeds 0-3.)
JAX_SESSIONS_MIN = {"mapping": ("loops", 54), "resume": ("loops", 134),
                    "localization": ("localized", 16)}
# The localized count of one run turns on a few frames whose odometry-cache
# check lands near its RGBD/OptimizeMaxError gate: on one stored map, runs
# that differ only in their RANSAC seed read 15 to 18 in either package
# on the CPU, and 11 to 19 on the card.
# So the localization session runs on copies of the resumed store with
# these seeds (odometry S, engine 42 + S), each held to every per-run
# check, and the mean of their localized counts to the threshold. Six
# seeds: eight read means of 16.1 and 16.2 on the card, four
# 15.25 in one run (15, 15, 15, 16; PERF.md section 6), close to the
# threshold of 14; six keep most of the cut that holds the whole script
# inside the limit on a slow host.
LOCALIZATION_SEEDS = tuple(range(6))
LOCALIZATION_ERROR_BOUND = 0.1   # tests/test_localization.py's bound
# Frozen map: nodes past the stored ones, at most the STM ring plus this
# margin (tests/test_localization.py's).
FROZEN_MARGIN = 6

# RGB-D + LiDAR, the parity sequence: the JAX package's CPU runs
# (scripts/jax_rgbd_scan.py, seeds 0-3) all close 5 loops, add 21 scan-ICP
# proximity links, refine no neighbour link (each processed node follows an
# intermediate node, which carries no scan) and make 29 intermediate nodes,
# losing no frame. The card must make the same intermediate nodes, lose no
# frame and reach 90% of the lowest of the rest.
JAX_SCAN_MIN = {"loops": 5, "proximity_scan": 21, "refined": 0}
JAX_SCAN_INTERMEDIATE = 29
# The full width: refined on 90% of the nodes with a predecessor, 90% of
# the rgbd_mapping full-width loop threshold, 90% of the assembled grid's
# occupied cells within two cells of a wall; localization: the
# rgbd_sessions threshold of localized frames, each global scan-map
# localization within LOCALIZATION_ERROR_BOUND.
SCAN_LOOPS_THRESHOLD = int(0.9 * int(0.9 * JAX_RGBD_FULL_LOOPS))
SCAN_LOCALIZED_THRESHOLD = max(int(0.9 * JAX_SESSIONS_MIN["localization"][1]), 1)
# searches a register_scans call asks K2 for (icp's 30 iterations + 1)
SEARCHES_PER_REGISTRATION = 31


# The stereo and visual-inertial runs (tools/stereo_datasets.py: the dataset
# tools on synthetic layouts). The JAX package's CPU runs of the same
# layout files (scripts/jax_stereo_datasets.py, seeds 0-3; the RANSAC draws
# differ between the packages and between seeds):
# - parity (KITTI layout, 58 frames at 320x240): 12 loops and 0 lost at
#   every seed, SLAM ATE 0.03561, 0.04329, 0.03238, 0.03454 m. The card
#   must reach 90% of the lowest loops, lose no more frames and stay within
#   0.02 m of the highest ATE (and inside RGBD_ATE_BOUND);
# - full (EuRoC layout, 120 frames at 752x480): 66 loops, 29 proximity
#   links and 0 lost at every seed, SLAM ATE 0.02988, 0.03311, 0.02865,
#   0.03202 m (odometry 0.0582-0.0610 m). The card must lose no frame,
#   stay within RGBD_ATE_BOUND and 1.1 x its odometry's ATE, and reach 90%
#   of the lowest loops;
# - kitti (KITTI 00's calibration, 40 frames at 1241x376): 0 lost at every
#   seed, 1-2 loops, SLAM ATE 0.02487, 0.02847, 0.02592, 0.02213 m; 75% of
#   the first frame's keypoints keep a stereo point. The card must lose
#   none, and report the KITTI errors (0: the run is shorter than the 100 m
#   segments);
# - imu0 / imu1 (CID-SIMS layout with imu.txt, 58 frames at 640x480): 24
#   and 2 loops at every seed, 0 lost. The complementary filter (imu1) of
#   both packages turns its correction the wrong way under tilt and drifts
#   (its roll reaches pi), so that run closes few loops in both. The card
#   must reach 90% of the lowest loops, and every tracked pose's roll and
#   pitch equal the integrated IMU's within 1e-4 rad.
JAX_STEREO = {"parity": {"loops": 12, "lost": 0, "ate_max": 0.04328690567452365},
              "full": {"loops": 66, "lost": 0}, "kitti": {"lost": 0},
              "imu0": {"loops": 24}, "imu1": {"loops": 2}}
STEREO_ATE_MARGIN = 0.02
IMU_ROLL_PITCH_TOL = 1e-4
# stereo_eval on the full run's first pair, card against CPU: the SGBM's
# valid masks equal except at near-ties (at most 0.2% of the pixels flip),
# disparities within 1e-3 px; the sparse LK within 1e-4 px, at most 2
# keypoints flipping at a threshold.
SGBM_FLIP_SHARE, SGBM_TOL, LK_TOL, LK_FLIPS = 2e-3, 1e-3, 1e-4, 2
# Words in the vocabulary at the end of the port's full stereo run on the
# card (the prefix K1 scans on its last quantize calls; the port's first
# card run of it, the JAX CPU runs end at 27790).
STEREO_FULL_WORDS = 27791


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def _event_ms(run, reps: int) -> list:
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one eager call of ``fn``
    after warm-up: the card waits for the host's launch, so a small
    kernel's time includes its wrapper's. Every ``ms``, ``plain_ms`` and
    ``library_ms`` is timed so, as in the earlier slices."""
    for _ in range(warmup):
        fn()
    return float(np.median(_event_ms(fn, reps)))


def graph_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call of ``fn``: ``inner`` calls captured in one
    CUDA graph and replayed, median of ``reps`` CUDA-event timings over
    ``inner``; the host's launch time is left out."""
    fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    return float(np.median(_event_ms(g.replay, reps))) / inner


# ------------------------------------------------------------------ kernels


def knn2_case(Q: int, W: int, seed: int, n_prefix: int = 0):
    """Seeded +-1 slab with duplicated rows (ties) and 30% invalid words,
    or, with ``n_prefix``, valid words exactly the first ``n_prefix`` rows;
    queries drawn half from the slab's valid rows, one zero (invalid
    keypoint) row."""
    rng = np.random.default_rng(seed)
    slab = (rng.integers(0, 2, (W, 256), dtype=np.int8) * 2 - 1).astype(np.int8)
    dup = rng.integers(0, W, W // 10)
    slab[rng.integers(0, W, W // 10)] = slab[dup]
    valid = rng.random(W) >= 0.3
    if n_prefix:
        valid = np.arange(W) < n_prefix
    q = (rng.integers(0, 2, (Q, 256), dtype=np.int8) * 2 - 1).astype(np.int8)
    q[: Q // 2] = slab[rng.integers(0, n_prefix or W, Q // 2)]
    q[-1] = 0
    dev = torch.device("cuda")
    return (torch.from_numpy(q).to(dev), torch.from_numpy(slab).to(dev),
            torch.from_numpy(valid).to(dev))


def knn2_library(q, slab, valid):
    """One PyTorch library product + top-k computing the same 2-NN (the
    yardstick; the port never calls it)."""
    sim = torch._int_mm(q, slab.T)
    d2 = torch.where(valid, 256 - sim, 1 << 20)
    return torch.topk(d2, 2, dim=1, largest=False)


def knn2_bound_ms(Q: int, W: int, n_valid: int) -> tuple:
    """Least time for the work these inputs need: the valid words' rows
    read once, the queries and flags read once, the (Q,2) outputs written
    once; 2*Q*n_valid*256 int8 operations."""
    bytes_ = Q * 256 + W + n_valid * 256 + Q * 2 * 8
    ops = 2.0 * Q * n_valid * 256
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_knn2():
    """K1 bit for bit against its plain version; times at the path's
    shapes. Returns the kernels-line entry at the dictionary's prefix call
    of the BOW cell's end state (Q=400 x 31853 valid rows)."""
    rows = {}
    # BOW cell's end state: 31853 words in the 262144-row slab; the RGB-D
    # full-width run's end state: RGBD_FULL_WORDS words, 512 queries
    cases = (("full-70", 400, 262144, 0, 0), ("end-state", 400, 262144, 3, 31853),
             ("rgbd-end-state", 512, 262144, 4, RGBD_FULL_WORDS),
             ("sessions-end-state", 512, 262144, 5, SESSIONS_END_WORDS),
             ("stereo-end-state", 512, 262144, 6, STEREO_FULL_WORDS),
             ("ragged", 37, 5000, 1, 0))
    for name, Q, W, seed, n_prefix in cases:
        q, slab, valid = knn2_case(Q, W, seed, n_prefix)
        calls = [(name, slab, valid)]
        if n_prefix:   # the call the dictionary makes: its valid prefix only
            calls.append((name + "-prefix", slab[:n_prefix], valid[:n_prefix]))
        for label, sl, va in calls:
            # torch._int_mm takes a multiple of 8 rows: the rows after the
            # prefix are invalid, so the padded call computes the same 2-NN
            w8 = -(-sl.shape[0] // 8) * 8
            lib_args = (slab[:w8], valid[:w8])
            d, i = K1.knn2(q, sl, va)
            torch.cuda.synchronize()
            dr, ir = K1.knn2_reference(q, sl, va)
            if not (torch.equal(d, dr) and torch.equal(i, ir)):
                bad = int(((d != dr).any(1) | (i != ir).any(1)).sum())
                fail(f"vocab_knn2 disagrees with its plain version ({label}, Q={Q} "
                     f"W={sl.shape[0]}) on {bad} queries")
            if label.endswith("-prefix") and not (torch.equal(d, rows[name]["_d"])
                                                  and torch.equal(i, rows[name]["_i"])):
                fail(f"vocab_knn2 on the valid prefix differs from the whole slab ({name})")
            bound, bound_by = knn2_bound_ms(Q, sl.shape[0], int(va.sum()))
            row = {"kernel": "vocab_knn2", "case": label, "Q": Q, "W": sl.shape[0],
                   "n_valid": int(va.sum()), "equal": True,
                   "kernel_ms": time_ms(lambda: K1.knn2(q, sl, va)),
                   "graph_ms": graph_ms(lambda: K1.knn2(q, sl, va)),
                   "plain_ms": time_ms(lambda: K1.knn2_reference(q, sl, va), reps=10),
                   "library_ms": time_ms(lambda: knn2_library(q, *lib_args)),
                   "bound_us": bound * 1e3, "bound_by": bound_by}
            print(json.dumps(row), flush=True)
            rows[label] = dict(row, _d=d, _i=i)
    main_shape = rows["end-state-prefix"]
    return {"name": "vocab_knn2", "route": "cuda",
            "source": "rtabmap_tpu_torch/csrc/vocab_knn.cu",
            "replaces": "rtabmap_tpu/ops/pallas/vocab_knn.py:80",
            "max_abs_err": 0.0, "ms": main_shape["kernel_ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_us"] * 1e-3,
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"]}


# K2 cases timed beside their bound
NN3D_PATH = ("odometry-2048", "odometry", "closure",
             "odometry-2048-masked", "odometry-masked", "closure-masked",
             "scan-proximity", "global-scan-map")
# a (Q, N) float32 matrix past this does not fit the card beside its
# temporaries: no one library call computes the 1-NN there
LIBRARY_MAX_BYTES = 20e9


def scan_slab_cases():
    """K2 at the RGB-D + LiDAR path's destinations, from the full-width
    sequence's VLP-16 scans (tools/rgbd_scan.py), assembled as the engine
    assembles them: ``scan-proximity``, a lap-2 scan (its 5 cm voxel flags
    as the query mask) against three lap-1 scans in the first one's frame
    (86400 points padded to 131072, the slab's voxel flags); and
    ``global-scan-map``, a localization scan (every point a query) against
    the scans of the 120 mapped and 10 localization frames in the map
    frame (3744000 points padded to 4194304, at most 65536 valid after the
    voxel hash)."""
    dev = torch.device("cuda")
    spec = rgbd_laps.sequence_spec("full")
    world, poses = spec["world"], spec["poses"]
    loc = rgbd_sessions.session_poses("localization")
    tensor = lambda P: torch.as_tensor(np.asarray(P, np.float32), device=dev)  # noqa: E731

    def scan(P):
        return RSC.vlp16_scan(P, world, VLP16_AZIMUTH, dev)[0]

    def slab(frame_pose, node_poses):
        pts, valid = [], []
        for P in node_poses:
            s = scan(P)
            pts.append(T.apply(tensor(T.np_relative(frame_pose, P))[None], s.xyz()[None])[0])
            valid.append(s.valid)
        pts, valid = torch.cat(pts), torch.cat(valid)
        pad = (1 << (pts.shape[0] - 1).bit_length()) - pts.shape[0]
        pts = torch.nn.functional.pad(pts, (0, 0, 0, pad)).contiguous()
        valid = torch.nn.functional.pad(valid, (0, pad))
        return pts, voxel_filter(pts, valid, 0.05)

    cur = scan(poses[63])
    moved = T.apply(tensor(T.np_relative(poses[1], poses[63]))[None], cur.xyz()[None])[0]
    prox_pts, prox_valid = slab(poses[1], poses[1:4])
    cases = [("scan-proximity", moved.contiguous(), prox_pts, prox_valid,
              voxel_filter(cur.xyz(), cur.valid, 0.05))]
    q = scan(loc[5])
    moved = T.apply(tensor(T.np_relative(poses[0], loc[5]))[None], q.xyz()[None])[0]
    map_pts, map_valid = slab(poses[0], list(poses) + list(loc[:10]))
    cases.append(("global-scan-map", moved.contiguous(), map_pts, map_valid, q.valid))
    return cases


def nn3d_cases():
    """(name, src, dst, dst_valid, src_valid) on the card. The LiDAR path
    shapes use two consecutive VLP-16 scans of the slice's sequence: the
    odometry search takes a scan against the local map (voxel-filtered
    points of the other scan, spread over it): 2048 points as in the
    parity-width run (OdomF2M/ScanMaxSize), 16384 as in the full-width run;
    the closure search a scan against a voxel-filtered scan. Each path
    shape runs unmasked (every query searched, as before the query mask)
    and masked with the scan's 5 cm voxel flags, as the path calls it.
    Then the edge cases."""
    dev = torch.device("cuda")
    _, scans = LM.sensor_sequence(2, noise=LIDAR_NOISE, device=dev)
    (a, a_valid), (b, b_valid) = list(scans)
    a_mask = voxel_filter(a, a_valid, 0.05)
    b_mask = voxel_filter(b, b_valid, 0.05)
    idx = torch.nonzero(a_mask)[:, 0]
    cases = []
    for name, m in (("odometry-2048", 2048), ("odometry", LM.VLP16_MAP_CAPACITY)):
        # a full map holds valid points only; repeat the scan's to fill it
        sel = idx.repeat(-(-m // idx.numel()))[:m] if m > idx.numel() else \
            idx[:: max(1, idx.numel() // m)][:m]
        ones = torch.ones(m, dtype=torch.bool, device=dev)
        cases.append((name, b, a[sel].contiguous(), ones, None))
        cases.append((name + "-masked", b, a[sel].contiguous(), ones, b_mask))
    cases.append(("closure", b, a, a_mask, None))
    cases.append(("closure-masked", b, a, a_mask, b_mask))
    rng = np.random.default_rng(2)
    dst = rng.normal(size=(5000, 3)).astype(np.float32)
    dst[rng.integers(0, 5000, 500)] = dst[rng.integers(0, 5000, 500)]
    src = rng.normal(size=(37, 3)).astype(np.float32)
    src[:18] = dst[rng.integers(0, 5000, 18)]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    ragged_valid = t(rng.random(5000) >= 0.3)
    cases.append(("ragged", t(src), t(dst), ragged_valid, None))
    cases.append(("ragged-masked", t(src), t(dst), ragged_valid, t(rng.random(37) >= 0.3)))
    pts64, pts1000 = t(rng.normal(size=(64, 3)).astype(np.float32)), \
        t(rng.normal(size=(1000, 3)).astype(np.float32))
    cases.append(("no-valid-point", pts64, pts1000, t(np.zeros(1000, bool)), None))
    cases.append(("no-valid-point-masked", pts64, pts1000, t(np.zeros(1000, bool)),
                  t(rng.random(64) >= 0.3)))
    cases.append(("no-valid-query", pts64, pts1000, t(np.ones(1000, bool)),
                  t(np.zeros(64, bool))))
    cases.append(("one-of-each", pts64, pts1000, t(np.arange(1000) == 617),
                  t(np.arange(64) == 40)))
    cases.append(("one", t(np.ones((1, 3), np.float32)), t(np.zeros((1, 3), np.float32)),
                  t(np.ones(1, bool)), None))
    return cases + compact_edge_cases() + scan_slab_cases()


def compact_edge_cases():
    """K2's compaction at the edges of its tiles: every case of
    ``compact_cases.NAMES``, its flags aligned and 5 bytes into a larger
    tensor (an address that is not a multiple of 16)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    cases = []
    for name in CC.NAMES:
        points, flags, q_flags = CC.flag_case(name)
        dst = torch.from_numpy(points).to(dev)
        n_query = 64 if q_flags is None else q_flags.size
        src = torch.from_numpy(rng.normal(size=(n_query, 3)).astype(np.float32)).to(dev)
        for offset in (0, 5):
            valid = CC.on_device(flags, dev, offset)
            if offset and valid.data_ptr() % 16 == 0:
                fail("the misaligned compaction case's flags are 16-byte aligned")
            cases.append((f"{name}-at-{offset}", src, dst, valid,
                          CC.on_device(q_flags, dev, offset)))
    return cases


def nn3d_library(src, dst, valid, src_valid):
    """One PyTorch library distance call + masks + min computing the same
    nearest neighbour (the yardstick; the port never calls it)."""
    d, i = torch.cdist(src, dst).masked_fill(~valid, float("inf")).min(dim=1)
    if src_valid is None:
        return d, i
    return d.masked_fill(~src_valid, float("inf")), i.masked_fill(~src_valid, 0)


def nn3d_bound_ms(Q: int, N: int, n_query: int, n_point: int) -> tuple:
    """Least time for the work these inputs need. Pairs: only those of a
    valid query (all Q without a query mask) and a valid point: no caller
    reads a masked query's result, and an invalid point cannot be a
    neighbour. Each pair costs 8 FP32-pipe instructions: 3 subtractions,
    3 multiplications and 2 additions, none of which the bit-exact
    contract lets fuse into an FMA, at 33.5e12 a second. The compare and
    the two selects of the running minimum are not counted: which pipe
    issues them is not documented, and on the integer/logic pipe (64
    lanes an SM, half the FP32 pipe's 128) their 3 take less time than
    the 8, so only the 8 surely bound the time. Bytes: the valid queries and
    points (12 bytes each) and both masks read once, the (d, idx)
    outputs (8 bytes a query) written once."""
    bytes_ = 12 * n_query + 12 * n_point + N + Q + 8 * Q
    ops = 8.0 * n_query * n_point
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / F32_INSTR_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compact_bound_ms(Q: int, N: int, n_point: int) -> tuple:
    """Least time of K2's compaction: both masks read once (a byte a flag)
    and the valid points only (12 bytes each: the contract reads no
    invalid one), the compacted points (16 bytes) and their indices, the
    query order and the counts written once; no arithmetic to speak of."""
    bytes_ = N + Q + 12 * n_point + 20 * n_point + 4 * Q + 8
    return bytes_ / HBM_BYTES_PER_S * 1e3, "bytes"


def compact_library(dst, valid, src_valid):
    """The compaction by library calls: ``torch.nonzero`` of the flags and
    ``index_select`` of the points (and the query order); timed beside the
    kernel, used nowhere in the port."""
    idx = torch.nonzero(valid)[:, 0]
    pts = dst.index_select(0, idx)
    if src_valid is None:
        return pts, idx
    return pts, idx, torch.cat([torch.nonzero(src_valid)[:, 0], torch.nonzero(~src_valid)[:, 0]])


def check_compact(name, dst, valid, src_valid):
    """K2's compaction kernel against its plain version: the valid points
    and their indices in order, the query order, the counts."""
    plan = K2.nn3d_prepare(dst, valid, src_valid)
    torch.cuda.synchronize()
    d4, dl, ql, counts = K2.nn3d_compact_reference(dst, valid, src_valid)
    n_pt = d4.shape[0]
    got = plan.counts.cpu()
    ok = (int(got[0]) == int(counts[0]) and torch.equal(plan.dst4[:n_pt], d4)
          and torch.equal(plan.dlist[:n_pt], dl) and (ql is None) == (plan.qlist is None))
    if ql is not None:
        ok = ok and int(got[1]) == int(counts[1]) and torch.equal(plan.qlist, ql)
    if not ok:
        fail(f"nn3d_compact disagrees with its plain version ({name})")


def check_nn3d():
    rows, cases = {}, nn3d_cases()
    for name, src, dst, valid, src_valid in cases:
        check_compact(name, dst, valid, src_valid)
        d, i = K2.nn3d(src, dst, valid, src_valid)
        torch.cuda.synchronize()
        dr, ir = K2.nn3d_reference(src, dst, valid, src_valid)
        if not (torch.equal(d, dr) and torch.equal(i, ir)):
            bad = int(((d != dr) | (i != ir)).sum())
            fail(f"nn3d disagrees with its plain version on {bad} of {src.shape[0]} "
                 f"queries ({name}, Q={src.shape[0]} N={dst.shape[0]})")
        Q, N = src.shape[0], dst.shape[0]
        n_query = Q if src_valid is None else int(src_valid.sum())
        n_point = int(valid.sum())
        row = {"kernel": "nn3d", "case": name, "Q": Q, "N": N, "valid_queries": n_query,
               "valid_points": n_point, "equal": True}
        if name == "global-scan-map":
            # the normals register_scans rebuilds on this slab each frame
            row["normals_ms"] = time_ms(lambda: estimate_normals(dst, valid), reps=3,
                                        warmup=1)
        if name in NN3D_PATH:
            plan = K2.nn3d_prepare(dst, valid, src_valid)
            bound, bound_by = nn3d_bound_ms(Q, N, n_query, n_point)
            cbound, _ = compact_bound_ms(0 if src_valid is None else Q, N, n_point)
            search = lambda: K2.nn3d_search(src, plan)  # noqa: E731
            prepare = lambda: K2.nn3d_prepare(dst, valid, src_valid)  # noqa: E731
            big = Q * N > 1e10   # the plain version takes seconds a call there
            library = None
            if 4.0 * Q * N <= LIBRARY_MAX_BYTES:
                library = time_ms(lambda: nn3d_library(src, dst, valid, src_valid), reps=10)
            row.update(kernel_ms=time_ms(search), graph_ms=graph_ms(search),
                       compact_ms=time_ms(prepare), compact_graph_ms=graph_ms(prepare),
                       compact_plain_ms=time_ms(lambda: K2.nn3d_compact_reference(
                           dst, valid, src_valid)),
                       compact_library_ms=time_ms(lambda: compact_library(dst, valid,
                                                                          src_valid)),
                       plain_ms=time_ms(lambda: K2.nn3d_reference(src, dst, valid, src_valid),
                                        reps=1 if big else 10, warmup=0 if big else 3),
                       library_ms=library,
                       bound_us=bound * 1e3, bound_by=bound_by, compact_bound_us=cbound * 1e3)
        print(json.dumps(row), flush=True)
        rows[name] = row
    # K2 a full-width frame: 16 odometry and 16 closure searches, by each
    # timing (PR 2's 12.2 ms a frame was timed as kernel_ms)
    frame = {key: 16 * rows["odometry-masked"][key] + 16 * rows["closure-masked"][key]
             for key in ("kernel_ms", "graph_ms")}
    print(json.dumps({"kernel": "nn3d", "full_width_frame": frame}), flush=True)
    check_no_sync(next(c for c in cases if c[0] == "global-scan-map"))
    main_shape = rows["odometry-masked"]
    k2 = {"name": "nn3d", "route": "cuda", "source": "rtabmap_tpu_torch/csrc/nn3d.cu",
          "replaces": "rtabmap_tpu/ops/pallas/nn3d.py:56", "max_abs_err": 0.0,
          "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
          "bound_ms": main_shape["bound_us"] * 1e-3, "bound_by": main_shape["bound_by"],
          "library_ms": main_shape["library_ms"]}
    _, src, dst, valid, src_valid = next(c for c in cases if c[0] == "odometry-masked")
    cb, cb_by = compact_bound_ms(src.shape[0], dst.shape[0], int(valid.sum()))
    compact = {"name": "nn3d_compact", "route": "cuda",
               "source": "rtabmap_tpu_torch/csrc/nn3d.cu",
               "replaces": "rtabmap_tpu/ops/pallas/nn3d.py:56", "max_abs_err": 0.0,
               "ms": main_shape["compact_ms"], "plain_ms": main_shape["compact_plain_ms"],
               "bound_ms": cb, "bound_by": cb_by,
               "library_ms": main_shape["compact_library_ms"]}
    return k2, compact


def check_no_sync(global_case):
    """A masked search, compaction included, and the global scan map's
    compaction under sync-debug "error": any host synchronization inside
    the wrappers raises."""
    _, scans = LM.sensor_sequence(2, noise=LIDAR_NOISE, device=torch.device("cuda"))
    (a, a_valid), (b, b_valid) = list(scans)
    a_mask, b_mask = voxel_filter(a, a_valid, 0.05), voxel_filter(b, b_valid, 0.05)
    _, _, g_dst, g_valid, g_src_valid = global_case
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, i = K2.nn3d(b, a, a_mask, b_mask)
        plan = K2.nn3d_prepare(g_dst, g_valid, g_src_valid)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if int(plan.counts[0]) != int(g_valid.sum()):
        fail("the global scan map's compaction under sync-debug counted "
             f"{int(plan.counts[0])} of {int(g_valid.sum())} valid points")
    print(json.dumps({"kernel": "nn3d", "sync_debug": "error", "synced": False,
                      "queries": b.shape[0], "global_scan_map_rows": g_dst.shape[0]}),
          flush=True)


# -------------------------------------------------------------------- slice


def run_slice():
    """Two laps of the appearance-only tick on the card (tools/bow_laps.py);
    returns the vocabulary kernel's launches during the run."""
    K1.knn2.launches = 0
    res = bow_laps.run(torch.device("cuda"), FRAMES_PER_LAP, size=(640, 480))
    launches = K1.knn2.launches
    slam = res.slam
    mem = slam.memory
    for name, t in (("vocabulary slab", mem.vocab.slab), ("word flags", mem.vocab.word_valid),
                    ("node words", mem.node_words), ("word counts", mem.word_nw),
                    ("posterior", slam.bayes.posterior)):
        if t.device.type != "cuda":
            fail(f"{name} lies on {t.device}")
    quantize_calls = sum("TimingMem/Add new words/ms" in s.data for s in res.stats)
    if launches != quantize_calls or launches == 0:
        fail(f"vocab_knn2 launched {launches} times for {quantize_calls} quantize calls")
    for st in res.stats:
        for k, v in st.data.items():
            if not np.isfinite(v):
                fail(f"statistic {k} = {v}")
    if res.lap2_same_view < LAP2_THRESHOLD:
        fail(f"lap 2 closed with the same viewpoint {res.lap2_same_view} times, "
             f"threshold {LAP2_THRESHOLD} (JAX CPU run: {JAX_LAP2_SAME_VIEW})")
    print(json.dumps({"slice": "bow_mapping", "resolution": [640, 480],
                      "lap2_threshold": LAP2_THRESHOLD,
                      "jax_cpu_lap2_same_view": JAX_LAP2_SAME_VIEW,
                      "vocab_knn2_launches": launches, **res.summary()}), flush=True)
    return launches


def run_lidar(n_azimuth: int, map_capacity: int) -> dict:
    """One LiDAR mapping run on the card (tools/lidar_mapping.py) over the
    slice's sequence at ``n_azimuth`` x 16; checks that every state tensor
    lies on the card and that K2 launched its search once for each search
    the tool asked for and its compaction once for each destination the
    tool prepared."""
    dev = torch.device("cuda")
    gt, scans = LM.sensor_sequence(LIDAR_FRAMES, n_azimuth=n_azimuth, noise=LIDAR_NOISE,
                                   device=dev)
    K2.nn3d_search.launches = K2.nn3d_prepare.launches = K2.nn3d_prepare.count_launches = 0
    out = LM.run_lidar_mapping(scans, gt_poses=gt, device=dev, map_capacity=map_capacity)
    launches, compactions = K2.nn3d_search.launches, K2.nn3d_prepare.launches
    count_passes = K2.nn3d_prepare.count_launches
    st = out["odometry"].state
    for name, t in (("map points", st.map_pts), ("map normals", st.map_nrm),
                    ("map flags", st.map_valid), ("odometry pose", st.pose),
                    ("graph poses", out["graph"].poses), ("graph information", out["graph"].edges_info),
                    ("voxel bricks", out["voxel_map"].bricks)):
        if t.device.type != "cuda":
            fail(f"{name} lies on {t.device}")
    if launches != out["nn3d_searches"] or launches == 0:
        fail(f"nn3d launched {launches} times for {out['nn3d_searches']} searches")
    if compactions != out["nn3d_plans"] or compactions == 0:
        fail(f"nn3d_compact launched {compactions} times for {out['nn3d_plans']} "
             "prepared destinations")
    poses = np.stack([out["poses"][i] for i in sorted(out["poses"])])
    if not (np.isfinite(poses).all() and np.isfinite(out["ate_slam"])):
        fail("non-finite poses or ATE")
    res = {"slice": "lidar_mapping", "points": n_azimuth * 16, "frames": LIDAR_FRAMES,
           "map_capacity": map_capacity,
           "nn3d_launches": launches, "nn3d_compact_launches": compactions,
           "nn3d_compact_count_launches": count_passes, **LM.summary(out)}
    print(json.dumps(res), flush=True)
    return res


def run_lidar_slices() -> tuple:
    """The parity-width run against the JAX CPU numbers, then the full-width
    run against the ground truth; returns K2's search and compaction
    launches in the latter."""
    par = run_lidar(PARITY_AZIMUTH, 2048)
    if par["closures"] < int(0.9 * JAX_LIDAR_CLOSURES):
        fail(f"parity width: {par['closures']} closures, JAX CPU {JAX_LIDAR_CLOSURES}")
    if par["lost"] > JAX_LIDAR_LOST:
        fail(f"parity width: {par['lost']} lost frames, JAX CPU {JAX_LIDAR_LOST}")
    if par["ate_slam"] > JAX_LIDAR_ATE + 0.01:
        fail(f"parity width: ATE {par['ate_slam']:.4f} m, JAX CPU {JAX_LIDAR_ATE:.4f} m")
    full = run_lidar(VLP16_AZIMUTH, LM.VLP16_MAP_CAPACITY)
    if full["lost"] != 0 or full["nodes"] != LIDAR_FRAMES:
        fail(f"full width: {full['nodes']} nodes, {full['lost']} lost")
    if full["ate_slam"] > FULL_WIDTH_ATE:
        fail(f"full width: ATE {full['ate_slam']:.4f} m > {FULL_WIDTH_ATE} m")
    return full["nn3d_launches"], full["nn3d_compact_launches"]


def run_rgbd(name: str, run_fn=None, slice_name: str = "rgbd_mapping") -> dict:
    """One RGB-D SLAM run on the card (``run_fn``, by default
    tools/rgbd_laps.py's sequence ``name``, returning its summary); checks
    that the state lies on the card, that K1 launched once per quantize
    call and that every statistic is finite. The summary keeps the raw
    run's engine under ``"slam"``."""
    K1.knn2.launches = 0
    out = run_fn() if run_fn else rgbd_laps.run_sequence(name, torch.device("cuda"))
    launches = K1.knn2.launches
    run = out.pop("run")
    slam, odom = run["slam"], run["odom"]
    mem = slam.memory
    for label, t in (("F2M map points", odom.state.map_pts),
                     ("F2M map descriptors", odom.state.map_desc),
                     ("vocabulary slab", mem.vocab.slab), ("node words", mem.node_words),
                     ("node points", mem.node_pts), ("word counts", mem.word_nw),
                     ("posterior", slam.bayes.posterior)):
        if t.device.type != "cuda":
            fail(f"{name}: {label} lies on {t.device}")
    if launches != out["quantize_calls"] or launches == 0:
        fail(f"{name}: vocab_knn2 launched {launches} times for {out['quantize_calls']} "
             "quantize calls")
    for st in slam.stats_history:
        for k, v in st.data.items():
            if not np.isfinite(v):
                fail(f"{name}: statistic {k} = {v}")
    poses = np.stack(list(slam.get_optimized_poses().values()))
    if not (np.isfinite(poses).all() and np.isfinite(out["ate_slam"])):
        fail(f"{name}: non-finite poses or ATE")
    res = {"slice": slice_name, "sequence": name, "vocab_knn2_launches": launches,
           **out}
    print(json.dumps(res), flush=True)
    res["slam"] = slam
    return res


def mapping_session(path: str):
    """The full-width sequence as rgbd_sessions' mapping session, into the
    store at ``path``: (rgbd_laps' summary, the session's summary, which
    holds the raw run). One run serves both phases' checks: it is
    rgbd_laps' full sequence (the same frames, camera, parameters and seed),
    with the store, ``repair_graph()`` and ``close()`` added. rgbd_laps'
    summary is taken of the tick's own output, before the repair."""
    poses = rgbd_sessions.session_poses("mapping")
    session = next(rgbd_sessions.iter_sessions(
        path, torch.device("cuda"), seed=LOCALIZATION_SEEDS[0], sessions=("mapping",),
        on_run=lambda name, run: rgbd_laps.summary(run, poses)))
    return session.pop("on_run"), session


def run_rgbd_slices(path: str) -> tuple:
    """The parity sequence against the JAX CPU numbers, then the full width
    against the ground truth, written into the store at ``path`` as the
    sessions' mapping session; returns (K1's launches in both, the mapping
    session's summary and K1 launches)."""
    par = run_rgbd("parity")
    if par["loops"] < int(0.9 * JAX_RGBD_LOOPS):
        fail(f"RGB-D parity: {par['loops']} loops, JAX CPU {JAX_RGBD_LOOPS}")
    if par["lost"] > JAX_RGBD_LOST:
        fail(f"RGB-D parity: {par['lost']} lost frames, JAX CPU {JAX_RGBD_LOST}")
    if par["ate_slam"] > min(JAX_RGBD_ATE + 0.02, RGBD_ATE_BOUND):
        fail(f"RGB-D parity: ATE {par['ate_slam']:.4f} m, JAX CPU {JAX_RGBD_ATE:.4f} m")
    held = {}

    def full_into_store():
        out, held["session"] = mapping_session(path)
        return out
    full = run_rgbd("full", full_into_store)
    if full["lost"] != 0 or full["ate_slam_frames"] != full["frames"]:
        fail(f"RGB-D full width: {full['lost']} lost, {full['ate_slam_frames']} of "
             f"{full['frames']} frames in the graph")
    if full["ate_slam"] > min(RGBD_ATE_BOUND, 1.1 * full["ate_odom"]):
        fail(f"RGB-D full width: ATE {full['ate_slam']:.4f} m (odometry "
             f"{full['ate_odom']:.4f} m, bound {RGBD_ATE_BOUND} m)")
    if full["loops"] < int(0.9 * JAX_RGBD_FULL_LOOPS):
        fail(f"RGB-D full width: {full['loops']} loops, JAX CPU {JAX_RGBD_FULL_LOOPS}")
    return (par["vocab_knn2_launches"] + full["vocab_knn2_launches"],
            (held["session"], full["vocab_knn2_launches"]))


def check_session(res: dict, launches: int, frames_before: int):
    """The checks every session shares, then the session's own."""
    name = res["session"]
    if launches != res["quantize_calls"] or launches == 0:
        fail(f"{name}: vocab_knn2 launched {launches} times for {res['quantize_calls']} "
             "quantize calls")
    if res["lost"] != 0:
        fail(f"{name}: {res['lost']} lost frames")
    key, jax_min = JAX_SESSIONS_MIN[name]
    if name != "localization" and res[key] < max(int(0.9 * jax_min), 1):
        fail(f"{name}: {res[key]} {key}, JAX CPU lowest over seeds {jax_min}")
    store = res["store"]
    if store["statistics_rows"] != frames_before + res["frames"]:
        fail(f"{name}: {store['statistics_rows']} statistics rows for "
             f"{frames_before + res['frames']} processed frames")
    if name != "localization":
        if not res["map_ate"] <= RGBD_ATE_BOUND:
            fail(f"{name}: map ATE {res['map_ate']:.4f} m > {RGBD_ATE_BOUND} m")
        if (store["node_rows"], store["link_rows"]) != (res["nodes"], res["links"]):
            fail(f"{name}: the store holds {store['node_rows']} nodes and "
                 f"{store['link_rows']} links, the map {res['nodes']} and {res['links']}")
    if name == "resume":
        if not res["pcg_solves"] or min(s["nodes"] for s in res["pcg_solves"]) <= 400:
            fail("resume: no full solve went through optimize_pcg")
        if res["inter_session_links"] == 0:
            fail("resume: no link between the sessions")
    if name == "localization":
        if not res["loc_err_m"]["min"] < LOCALIZATION_ERROR_BOUND:
            fail(f"localization: best error {res['loc_err_m']['min']} m, bound "
                 f"{LOCALIZATION_ERROR_BOUND} m")
        if not (res["wm_only_stored"] and res["wm_equals_stored_resident"]):
            fail("localization: WM holds nodes that are not the stored map's")
        if res["nodes"] > res["stored_nodes"] + res["stm_size"] + FROZEN_MARGIN:
            fail(f"localization: {res['nodes']} nodes from {res['stored_nodes']} stored")
        if store["node_rows_before_session"] != res["stored_nodes"]:
            fail(f"localization: the stored sessions now have "
                 f"{store['node_rows_before_session']} rows, {res['stored_nodes']} before")


def check_pcg_graph(slam) -> dict:
    """``optimize_pcg`` on the resumed map's merged graph, padded as the
    engine pads it: the CG loop eager and as the captured CUDA graph must
    give the same poses (within 1e-4 m: float32 atomics in ``index_add_``
    may order sums differently); both timed (host clock to a sync)."""
    ids, poses, ef, et, meas, info, switch, priors = slam._build_graph()
    g, _ = slam._padded_graph(poses, ef, et, meas, info, switch, priors, 0)
    N = g.poses.shape[0]
    cg = int(min(max(60, N), 1024))
    out, ms = {}, {}
    for label, graphs in (("graph", True), ("eager", False), ("graph_again", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, chi2 = PG.optimize_pcg(g, iters=12, cg_iters=cg, graphs=graphs)
        float(chi2)
        ms[label] = (time.perf_counter() - t0) * 1e3
        out[label] = res.poses[: len(ids)].cpu().numpy()
    diff = float(np.abs(out["graph"] - out["eager"]).max())
    row = {"slice": "rgbd_sessions", "pcg_check": {
        "nodes": len(ids), "padded": N, "edges": len(ef), "cg_iters": cg, "lm_iters": 12,
        "graph_ms": ms["graph_again"], "eager_ms": ms["eager"],
        "first_graph_ms_with_capture": ms["graph"], "max_abs_diff_m": diff}}
    print(json.dumps(row), flush=True)
    if N <= 400:
        fail(f"resume: the merged graph pads to {N} nodes, not past the dense solver's 400")
    if not (np.isfinite(out["graph"]).all() and diff <= 1e-4):
        fail(f"optimize_pcg: the captured CG loop differs from the eager one by {diff} m")
    return row


def check_dense_graph(slam) -> dict:
    """``optimize_dense`` on the mapping session's graph, padded as the
    engine pads it: 12 LM iterations eager and as the captured CUDA graph
    must give the same poses (within 1e-3 m, tests/test_torch_pose_graph.py's
    bound: float32 atomics in ``index_add_`` order sums differently, and
    the LM's float32 Cholesky of a system whose diagonal spans 1 .. 1e8
    amplifies that); both timed (host clock to a sync)."""
    ids, poses, ef, et, meas, info, switch, priors = slam._build_graph()
    g, _ = slam._padded_graph(poses, ef, et, meas, info, switch, priors, 0)
    out, ms = {}, {}
    for label, graphs in (("graph", True), ("eager", False), ("graph_again", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, chi2 = PG.optimize_dense(g, iters=12, graphs=graphs)
        float(chi2)
        ms[label] = (time.perf_counter() - t0) * 1e3
        out[label] = res.poses[: len(ids)].cpu().numpy()
    diff = float(np.abs(out["graph"] - out["eager"]).max())
    row = {"slice": "rgbd_sessions", "dense_check": {
        "nodes": len(ids), "padded": int(g.poses.shape[0]), "edges": len(ef), "lm_iters": 12,
        "graph_ms": ms["graph_again"], "eager_ms": ms["eager"],
        "first_graph_ms_with_capture": ms["graph"], "max_abs_diff_m": diff}}
    print(json.dumps(row), flush=True)
    if not (np.isfinite(out["graph"]).all() and diff <= 1e-3):
        fail(f"optimize_dense: the captured LM differs from the eager one by {diff} m")
    return row


def run_sessions(path: str, mapping: tuple, keep_dir: str) -> tuple:
    """The three sessions on the card (tools/rgbd_sessions.py) against the
    store at ``path``: the mapping session is rgbd_mapping's full-width run
    (``mapping``: its summary and K1 launches, held here to the sessions'
    checks), then the resume and the localization once a seed of
    LOCALIZATION_SEEDS on its own copy of the resumed store; the closed
    mapping and resumed stores are copied into ``keep_dir``
    (``mapping.db``, ``resumed.db``) for the map tools. Returns (K1's
    launches in the resume and the localizations, the sessions' summaries
    by name)."""
    dev = torch.device("cuda")
    total, frames = 0, 0
    summaries = {}
    with tempfile.TemporaryDirectory() as tmp:
        seeds = os.path.join(tmp, "map.db")
        sessions = rgbd_sessions.iter_sessions(path, dev, seed=LOCALIZATION_SEEDS[0],
                                               sessions=("resume", "localization"))
        runs = [("mapping", lambda: mapping)] + [
            (name, lambda: (next(sessions), None)) for name in ("resume", "localization")]
        for s in LOCALIZATION_SEEDS[1:]:
            runs.append(("localization", lambda s=s: (next(rgbd_sessions.iter_sessions(
                f"{seeds}.seed{s}", dev, seed=s, sessions=("localization",))), None)))
        localized = []
        for name, run_session in runs:
            K1.knn2.launches = 0
            t0 = time.perf_counter()
            res, launches = run_session()
            if launches is None:
                launches = K1.knn2.launches
            else:                      # counted in the rgbd_mapping phase
                total -= launches
            run = res.pop("run")
            slam = run["slam"]
            mem = slam.memory
            for label, t in (("vocabulary slab", mem.vocab.slab), ("node words", mem.node_words),
                             ("word counts", mem.word_nw), ("posterior", slam.bayes.posterior),
                             ("F2M map points", run["odom"].state.map_pts)):
                if t.device.type != "cuda":
                    fail(f"{name}: {label} lies on {t.device}")
            for st in slam.stats_history:
                for k, v in st.data.items():
                    if not np.isfinite(v):
                        fail(f"{name}: statistic {k} = {v}")
            pcg_ms = sum(s["ms"] for s in res["pcg_solves"])
            res.update(vocab_knn2_launches=launches,
                       time_in_solves_ms={"pcg": pcg_ms, "dense": res["dense_solves"]["ms_total"],
                                          "process": float(np.sum(run["process_ms"]))})
            if name != "mapping":                     # timed in the rgbd_mapping phase
                res["seconds"] = time.perf_counter() - t0
            if name == "localization":
                res["seed"] = LOCALIZATION_SEEDS[len(localized)]
                localized.append(res["localized"])
            print(json.dumps({"slice": "rgbd_sessions", **res}), flush=True)
            check_session(res, launches, frames)
            if name == "mapping":
                check_dense_graph(slam)
                shutil.copyfile(path, os.path.join(keep_dir, "mapping.db"))
            if name == "resume":
                check_pcg_graph(slam)
                for s in LOCALIZATION_SEEDS[1:]:      # the resumed store, closed
                    shutil.copyfile(path, f"{seeds}.seed{s}")
                shutil.copyfile(path, os.path.join(keep_dir, "resumed.db"))
            summaries.setdefault(name, res)
            if name != "localization":
                frames += res["frames"]
            total += launches
    threshold = max(int(0.9 * JAX_SESSIONS_MIN["localization"][1]), 1)
    print(json.dumps({"slice": "rgbd_sessions", "localized_by_seed": dict(
        zip(LOCALIZATION_SEEDS, localized)), "mean": float(np.mean(localized)),
        "threshold": threshold}), flush=True)
    if np.mean(localized) < threshold:
        fail(f"localization: {np.mean(localized)} frames localized on average over seeds "
             f"{LOCALIZATION_SEEDS} ({localized}), JAX CPU lowest over seeds "
             f"{JAX_SESSIONS_MIN['localization'][1]}")
    return total, summaries


# the engine's three scan stages, each one register_scans (K2) a call
SCAN_STAGES = {"refining": "_refine_neighbor_link",
               "scan_proximity": "_proximity_scan_multi",
               "global_scan_map": "_localize_global_scan"}


def instrument_scan_stages():
    """Wrap the engine's scan stages to count their calls and the K2
    launches inside them; returns (the counts, a function undoing it)."""
    counts = {name: {} for name in SCAN_STAGES}
    originals = {attr: getattr(Rtabmap, attr) for attr in SCAN_STAGES.values()}

    def wrap(orig, c):
        def counted(self, *a, **k):
            s0, p0 = K2.nn3d_search.launches, K2.nn3d_prepare.launches
            t0 = time.perf_counter()
            try:
                return orig(self, *a, **k)
            finally:
                # each stage ends in a fetch to the host: the wall time is whole
                c["ms"].append((time.perf_counter() - t0) * 1e3)
                c["calls"] += 1
                c["searches"] += K2.nn3d_search.launches - s0
                c["compactions"] += K2.nn3d_prepare.launches - p0
        return counted

    for name, attr in SCAN_STAGES.items():
        setattr(Rtabmap, attr, wrap(originals[attr], counts[name]))
    return counts, lambda: [setattr(Rtabmap, a, f) for a, f in originals.items()]


def scan_run(label: str, fn, stages) -> tuple:
    """One rgbd_scan run with the launch counts zeroed right before it and
    read right after; checks K1 against the quantize calls, every K2
    launch against the scan stages' registrations, the engine's state on
    the card and finite statistics. Returns (summary, raw run, launches:
    K1, K2's searches, its compactions and the compactions that ran the
    count pass: those of more than ``K2.COMPACT_ONE_PASS_TILES`` tiles)."""
    for c in stages.values():
        c.update(calls=0, searches=0, compactions=0, ms=[])
    K1.knn2.launches = K2.nn3d_search.launches = K2.nn3d_prepare.launches = 0
    K2.nn3d_prepare.count_launches = 0
    t0 = time.perf_counter()
    res, run = fn()
    launches = (K1.knn2.launches, K2.nn3d_search.launches, K2.nn3d_prepare.launches,
                K2.nn3d_prepare.count_launches)
    slam = run["slam"]
    mem = slam.memory
    scans = [s.scan.data for s in mem.signatures.values() if s.scan is not None]
    if not scans:
        fail(f"{label}: no node holds a scan")
    for what, t in (("a node's scan", scans[-1]), ("vocabulary slab", mem.vocab.slab),
                    ("posterior", slam.bayes.posterior)):
        if t.device.type != "cuda":
            fail(f"{label}: {what} lies on {t.device}")
    if launches[0] != res["quantize_calls"] or launches[0] == 0:
        fail(f"{label}: vocab_knn2 launched {launches[0]} times for {res['quantize_calls']} "
             "quantize calls")
    regs = {"refining": stages["refining"]["calls"],
            "scan_proximity": stages["scan_proximity"]["calls"],
            "global_scan_map": slam.global_scan_calls}
    for name, c in stages.items():
        if (c["searches"], c["compactions"]) != (SEARCHES_PER_REGISTRATION * regs[name],
                                                 regs[name]):
            fail(f"{label}: {name} launched nn3d {c['searches']} and nn3d_compact "
                 f"{c['compactions']} times for {regs[name]} registrations")
    if (launches[1], launches[2]) != (sum(c["searches"] for c in stages.values()),
                                      sum(c["compactions"] for c in stages.values())):
        fail(f"{label}: nn3d launched outside the scan stages")
    if launches[3] > launches[2]:
        fail(f"{label}: nn3d_compact ran its count pass {launches[3]} times in "
             f"{launches[2]} compactions")
    for st in slam.stats_history:
        for k, v in st.data.items():
            if not np.isfinite(v):
                fail(f"{label}: statistic {k} = {v}")
    res.update(seconds=time.perf_counter() - t0, vocab_knn2_launches=launches[0],
               nn3d_launches=launches[1], nn3d_compact_launches=launches[2],
               nn3d_compact_count_launches=launches[3],
               stages={k: {**{n: v[n] for n in ("calls", "searches", "compactions")},
                           "registrations": regs[k], "ms": rgbd_sessions._ms(v["ms"])}
                       for k, v in stages.items()})
    print(json.dumps({"slice": "rgbd_scan", **res}), flush=True)
    return res, run, launches


def run_scan_slice() -> tuple:
    """The three rgbd_scan runs on the card (parity, full width into a
    store, localization in it); returns the phase's (K1, K2, K2 compaction)
    launches; fails if no compaction ran its count pass."""
    dev = torch.device("cuda")
    stages, undo = instrument_scan_stages()
    total = np.zeros(4, np.int64)
    try:
        par, _, n = scan_run("parity", lambda: RSC.run_mapping("parity", dev), stages)
        total += n
        if par["lost"] != 0 or par["intermediate_nodes"] != JAX_SCAN_INTERMEDIATE:
            fail(f"rgbd_scan parity: {par['lost']} lost, {par['intermediate_nodes']} "
                 f"intermediate nodes (JAX CPU {JAX_SCAN_INTERMEDIATE})")
        for key, jax_min in JAX_SCAN_MIN.items():
            if par[key] < int(0.9 * jax_min):
                fail(f"rgbd_scan parity: {par[key]} {key}, JAX CPU lowest {jax_min}")
        if par["stages"]["scan_proximity"]["searches"] == 0:
            fail("rgbd_scan parity: the scan proximity never reached nn3d")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "map.db")
            db = Database(path)
            try:
                full, run, n = scan_run("full", lambda: RSC.run_mapping("full", dev, db=db),
                                        stages)
                saved = RSC.host_scans(run["slam"])
                run["slam"].close()
            finally:
                db.close()
            total += n
            if full["lost"] != 0:
                fail(f"rgbd_scan full width: {full['lost']} lost frames")
            if not full["map_ate"] <= min(FULL_WIDTH_ATE, 1.1 * full["ate_odom"]):
                fail(f"rgbd_scan full width: map ATE {full['map_ate']:.4f} m (odometry "
                     f"{full['ate_odom']:.4f} m, bound {FULL_WIDTH_ATE} m)")
            if full["refined"] < 0.9 * (full["frames"] - 1):
                fail(f"rgbd_scan full width: {full['refined']} links refined of "
                     f"{full['frames'] - 1}")
            if full["proximity_scan"] < 1:
                fail("rgbd_scan full width: no scan-proximity link")
            if not 0 < full["accepted_closures"] == full["epipolar_on_accepted"]:
                fail(f"rgbd_scan full width: the epipolar check ran on "
                     f"{full['epipolar_on_accepted']} of {full['accepted_closures']} closures")
            if full["loops"] < SCAN_LOOPS_THRESHOLD:
                fail(f"rgbd_scan full width: {full['loops']} loops, threshold "
                     f"{SCAN_LOOPS_THRESHOLD}")
            if full["occupied_near_wall"] < 0.9:
                fail(f"rgbd_scan full width: {full['occupied_near_wall']:.3f} of the occupied "
                     "cells near a wall")
            for name in ("refining", "scan_proximity"):
                if full["stages"][name]["searches"] == 0:
                    fail(f"rgbd_scan full width: {name} never reached nn3d")
            db = Database(path)
            try:
                loc, _, n = scan_run("localization", lambda: RSC.run_localization(
                    db, dev, saved_scans=saved), stages)
            finally:
                db.close()
            total += n
        if not 0 < loc["scans_read_back"] == loc["scans_equal"] == len(saved):
            fail(f"rgbd_scan localization: {loc['scans_equal']} of {len(saved)} stored scans "
                 "read back equal")
        if loc["stages"]["global_scan_map"]["searches"] == 0:
            fail("rgbd_scan localization: the global scan map never reached nn3d")
        if loc["scan_localized"] and not loc["scan_loc_err_max_m"] < LOCALIZATION_ERROR_BOUND:
            fail(f"rgbd_scan localization: a global scan-map localization is "
                 f"{loc['scan_loc_err_max_m']:.3f} m off")
        if loc["localized"] < SCAN_LOCALIZED_THRESHOLD or loc["lost"] != 0:
            fail(f"rgbd_scan localization: {loc['localized']} frames localized (threshold "
                 f"{SCAN_LOCALIZED_THRESHOLD}), {loc['lost']} lost")
    finally:
        undo()
    if total[3] == 0:
        fail("rgbd_scan: no compaction ran nn3d_compact_count")
    return tuple(int(x) for x in total[:3])


# ------------------------------------------------------------------- stereo


def stereo_run(run: str, root: str) -> tuple:
    """Write the run's layout (rendered on the card) and run its dataset
    tool on the card; checks the state lies on the card, K1 launched once a
    quantize call and every statistic is finite. Returns (summary, K1
    launches)."""
    dev = torch.device("cuda")
    args = SD.write_layout(run, root, dev)
    K1.knn2.launches = 0
    out = CLI.main(args + ["--device", "cuda"])
    launches = K1.knn2.launches
    res = SD.summary(out)
    slam, odom = out["slam"], out["odom"]
    for label, t in (("F2M map points", odom.state.map_pts),
                     ("vocabulary slab", slam.memory.vocab.slab),
                     ("node words", slam.memory.node_words),
                     ("posterior", slam.bayes.posterior)):
        if t.device.type != "cuda":
            fail(f"stereo {run}: {label} lies on {t.device}")
    if launches != res["quantize_calls"] or launches == 0:
        fail(f"stereo {run}: vocab_knn2 launched {launches} times for "
             f"{res['quantize_calls']} quantize calls")
    for st in slam.stats_history:
        for k, v in st.data.items():
            if not np.isfinite(v):
                fail(f"stereo {run}: statistic {k} = {v}")
    if not np.isfinite(out["est_odom"]).all():
        fail(f"stereo {run}: non-finite odometry poses")
    res = {"slice": "stereo", "run": run, "tool": args[0], "vocab_knn2_launches": launches,
           **res}
    print(json.dumps(res), flush=True)
    return res, launches


def stereo_eval_check(root: str) -> dict:
    """stereo_eval on the full run's first pair on the card and on the CPU:
    dense SGBM and sparse LK held to each other."""
    cam0 = os.path.join(root, "full", "MH_synth", "mav0", "cam0", "data")
    name = sorted(os.listdir(cam0))[0]
    pair = [os.path.join(cam0, name), os.path.join(cam0, "..", "..", "cam1", "data", name)]
    card = CLI.main(["stereo_eval", *pair, "64", "--device", "cuda"])
    cpu = CLI.main(["stereo_eval", *pair, "64", "--device", "cpu"])
    dc, dh = card["dense"], cpu["dense"]
    flips = int(((dc > 0) != (dh > 0)).sum())
    both = (dc > 0) & (dh > 0)
    sgbm_err = float(np.abs(dc[both] - dh[both]).max()) if both.any() else 0.0
    ok_c, ok_h = card["sparse_ok"], cpu["sparse_ok"]
    lk_flips = int((ok_c != ok_h).sum())
    lk_both = ok_c & ok_h
    lk_err = float(np.abs(card["sparse"][lk_both] - cpu["sparse"][lk_both]).max()) \
        if lk_both.any() else 0.0
    if flips > SGBM_FLIP_SHARE * dc.size or sgbm_err > SGBM_TOL or not both.any():
        fail(f"stereo_eval: SGBM card vs CPU: {flips} valid flags flip, disparities "
             f"{sgbm_err:.2e} px apart")
    if lk_flips > LK_FLIPS or lk_err > LK_TOL or not np.allclose(card["uv"], cpu["uv"],
                                                                 atol=1e-3):
        fail(f"stereo_eval: LK card vs CPU: {lk_flips} flags flip, disparities "
             f"{lk_err:.2e} px apart")
    res = {"slice": "stereo", "run": "stereo_eval", "size": list(dc.shape[::-1]),
           "sgbm_ms_card": card["sgbm_ms"], "sgbm_ms_cpu": cpu["sgbm_ms"],
           "sgbm_flips": flips, "sgbm_max_err_px": sgbm_err, "lk_flips": lk_flips,
           "lk_max_err_px": lk_err, "dense_density": card["dense_density"],
           "sparse_n": card["sparse_n"]}
    print(json.dumps(res), flush=True)
    return res


def run_stereo_slice() -> int:
    """The stereo and visual-inertial runs through the dataset tools on the
    card (parity, full width, KITTI geometry, the IMU with both filters),
    then stereo_eval; returns K1's launches in the phase."""
    total = 0
    with tempfile.TemporaryDirectory() as root:
        runs = {}
        for run in SD.RUNS:
            runs[run], n = stereo_run(run, root)
            total += n
        par, full, kit = runs["parity"], runs["full"], runs["kitti"]
        ref = JAX_STEREO["parity"]
        if par["loops"] < int(0.9 * ref["loops"]) or par["lost"] > ref["lost"]:
            fail(f"stereo parity: {par['loops']} loops, {par['lost']} lost (JAX CPU "
                 f"{ref['loops']}, {ref['lost']})")
        if not par.get("ate_slam", np.inf) <= min(ref["ate_max"] + STEREO_ATE_MARGIN,
                                                  RGBD_ATE_BOUND):
            fail(f"stereo parity: SLAM ATE {par.get('ate_slam')} m, JAX CPU at most "
                 f"{ref['ate_max']:.4f} m")
        if full["lost"] != 0 or "ate_slam" not in full:
            fail(f"stereo full width: {full['lost']} lost frames")
        if not full["ate_slam"] <= min(RGBD_ATE_BOUND, 1.1 * full["ate_odom"]):
            fail(f"stereo full width: SLAM ATE {full['ate_slam']:.4f} m (odometry "
                 f"{full['ate_odom']:.4f} m, bound {RGBD_ATE_BOUND} m)")
        if full["loops"] < int(0.9 * JAX_STEREO["full"]["loops"]):
            fail(f"stereo full width: {full['loops']} loops, JAX CPU "
                 f"{JAX_STEREO['full']['loops']}")
        if kit["lost"] != 0 or "ate_slam" not in kit or "kitti_t_err_pct" not in kit:
            fail(f"stereo KITTI geometry: {kit['lost']} lost frames, keys {sorted(kit)}")
        for run in ("imu0", "imu1"):
            r = runs[run]
            if r["loops"] < int(0.9 * JAX_STEREO[run]["loops"]):
                fail(f"stereo {run}: {r['loops']} loops, JAX CPU {JAX_STEREO[run]['loops']}")
            if r.get("imu_frames", 0) < r["frames"] - r["lost"] or \
                    not r["imu_roll_pitch_max_diff_rad"] <= IMU_ROLL_PITCH_TOL:
                fail(f"stereo {run}: tracked roll/pitch {r.get('imu_roll_pitch_max_diff_rad')} "
                     f"rad off the IMU's on {r.get('imu_frames')} frames")
        stereo_eval_check(root)
    return total


# ------------------------------------------------------------------ learned

# The learned front end (Kp/DetectorStrategy 11, Vis/CorNNType 6) against
# the JAX package's CPU runs of the same sequences
# (PYTHONPATH=. python scripts/jax_rgbd_laps.py --learned [--gt-odometry]
# --sequence S --seed N, seeds 0-3; PERF.md section 6):
# - full-revisit with ground-truth odometry (the exact second lap): loops
#   at least 90% of the JAX lowest, the closure links' median translation
#   error at most the JAX highest median + 5 mm, SLAM ATE at most
#   RGBD_ATE_BOUND;
# - full with ground-truth odometry (appearance parity with the seed-0 JAX
#   run): each lap-2 frame's highest hypothesis the JAX run's lap-1 node or
#   its neighbour (ids 1 apart) on at least 90% of the frames, its value
#   within 0.02 on every frame, the loop count equal. Not the same id on
#   90%: SuperPoint's bfloat16 sums round differently on each device, and
#   a lap-2 frame between two lap-1 views tips to either (the same id on
#   85% of the frames with the port on the CPU, PERF.md section 6), the
#   value moving at most 0.012;
# - parity through run_dataset (F2M on SuperPoint features, as users launch
#   it): loops at least 90% of the JAX lowest, lost frames at most the JAX
#   highest + 2; the ATE printed beside the JAX runs'.
# (seeds 0-3: full-revisit 60 loops each, closure median errors
# 5.21e-7-5.43e-7 m; full 0 loops each; parity 6, 9, 7, 6 loops, 42, 39,
# 41, 42 lost, SLAM ATE 0.0901, 0.1118, 0.0976, 0.0956 m over its 10
# optimized poses)
JAX_LEARNED = {"full-revisit": {"loops_min": 60, "closure_err_median_max": 5.431839784590307e-07},
               "full": {"loops": 0},
               "parity": {"loops_min": 6, "lost_max": 42,
                          "ate_slam": [0.0901, 0.1118, 0.0976, 0.0956]}}
# scripts/jax_rgbd_laps.py --learned --gt-odometry --sequence full, seed 0:
# lap 2's highest hypothesis per frame (the seed moves only the RANSAC, so
# seeds 1-3 give the same ids and values)
JAX_LEARNED_FULL_LAP2_IDS = (
    1, 2, 3, 4, 5, 5, 7, 8, 9, 10, 10, 12, 13, 14, 15, 16, 17, 18, 18, 20,
    21, 22, 22, 23, 25, 26, 27, 28, 29, 30, 31, 31, 33, 34, 35, 36, 37, 38, 39, 40,
    40, 41, 43, 42, 45, 46, 47, 48, 49, 50, 51, 52, 53, 53, 55, 55, 57, 58, 58, 61,
)
JAX_LEARNED_FULL_LAP2_VALUES = (
    0.079991, 0.068805, 0.063395, 0.065255, 0.047859, 0.054451, 0.062417, 0.070013,
    0.08208, 0.071654, 0.072492, 0.070094, 0.080744, 0.071264, 0.077199, 0.078073,
    0.086606, 0.077906, 0.062892, 0.068362, 0.071377, 0.073669, 0.084742, 0.075602,
    0.065907, 0.067872, 0.073401, 0.075202, 0.080828, 0.088806, 0.082192, 0.074002,
    0.071685, 0.068728, 0.079555, 0.080401, 0.087002, 0.087707, 0.092547, 0.098255,
    0.089358, 0.087781, 0.084365, 0.078335, 0.08127, 0.085415, 0.07762, 0.076614,
    0.072626, 0.075278, 0.09043, 0.096505, 0.097903, 0.100882, 0.093623, 0.085271,
    0.080504, 0.083479, 0.087631, 0.100965,
)

LEARNED_CLOSURE_MARGIN = 0.005
LEARNED_HYP_SHARE, LEARNED_HYP_TOL, LEARNED_LOST_MARGIN = 0.9, 0.02, 2
LAP = 60
# Card against CPU on the same frame: SuperPoint's logits within 1e-4 of
# their largest magnitude in float32 (cuDNN and the CPU sum the products in
# other orders; TF32 off) and within 1e-2 in bfloat16 (a sum that crosses a
# bfloat16 rounding boundary moves one unit, 2^-8 relative, and spreads
# through the later layers), the valid keypoint sets overlapping (shared /
# union) at least 0.99 and 0.95; the matchers' confidences within 1e-4,
# idx and valid equal except where a confidence lies within 1e-4 of the
# threshold (the official forward's log-assignment within 1e-4 too); the
# learned stereo extraction's LK disparities at the card's
# keypoints within LK_TOL, at most LK_FLIPS flags flipping.
SP_TOL = {"float32": (1e-4, 0.99), "bfloat16": (1e-2, 0.95)}
SG_TOL = 1e-4


def _overlap(kps_a, kps_b) -> float:
    a = {tuple(u) for u, v in zip(kps_a.uv.cpu().numpy(), kps_a.valid.cpu().numpy()) if v}
    b = {tuple(u) for u, v in zip(kps_b.uv.cpu().numpy(), kps_b.valid.cpu().numpy()) if v}
    return len(a & b) / max(len(a | b), 1)


def learned_frame(k: int):
    """Frame ``k`` of the full-width sequence rendered on the card."""
    spec = rgbd_laps.sequence_spec("full")
    W, H = spec["size"]
    cam = CAMERA.CameraModel.make(spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    g, d = SYN.render(spec["poses"][k], cam, SYN.World(rgbd_laps.FULL_WORLD,
                                                       SYN.DEFAULT_WORLD.seed), device="cuda")
    return cam, g, d


def check_superpoint() -> list:
    """SuperPoint on one 640x480 frame, card against CPU, in both dtypes;
    returns the card's bfloat16 extractions of frames 0 and 1 (keypoints,
    descriptors) for the matchers."""
    _cam, g, _d = learned_frame(0)
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        card = SPM.SuperPoint.distilled(device="cuda", dtype=dt)
        cpu = SPM.SuperPoint.distilled(device="cpu", dtype=dt)
        (lc, dc), (lh, dh) = card.forward(g), cpu.forward(g.cpu())
        err = float((lc.cpu() - lh).abs().max() / lh.abs().max())
        derr = float((dc.cpu() - dh).abs().max() / dh.abs().max())
        kc, kh = card.extract(g, 512, conf_threshold=0.01)[0], cpu.extract(
            g.cpu(), 512, conf_threshold=0.01)[0]
        ov = _overlap(kc, kh)
        tol, min_ov = SP_TOL[name]
        res = {"slice": "learned", "check": "superpoint", "dtype": name,
               "logits_rel_err": err, "desc_rel_err": derr, "keypoints_card": int(kc.valid.sum()),
               "keypoints_cpu": int(kh.valid.sum()), "keypoint_overlap": ov}
        print(json.dumps(res), flush=True)
        if not (err <= tol and derr <= tol and ov >= min_ov):
            fail(f"SuperPoint {name} card vs CPU: {res}")
    sp = SPM.SuperPoint.distilled(device="cuda")
    return [sp.extract(learned_frame(k)[1], 512, conf_threshold=0.01) for k in (0, 1)]


def _matches_agree(label, card, cpu, threshold):
    """(idx, valid, conf) of both devices: conf within SG_TOL, idx and
    valid equal except where conf lies within SG_TOL of the threshold."""
    (ic, vc, cc), (ih, vh, ch) = [tuple(x.cpu() for x in m) for m in (card, cpu)]
    err = float((cc - ch).abs().max())
    near = (ch - threshold).abs() <= SG_TOL
    bad = int((((vc != vh) | ((ic != ih) & vh)) & ~near).sum())
    res = {"slice": "learned", "check": label, "matches_card": int(vc.sum()),
           "matches_cpu": int(vh.sum()), "conf_max_abs_err": err, "disagreeing_rows": bad}
    print(json.dumps(res), flush=True)
    if err > SG_TOL or bad:
        fail(f"{label} card vs CPU: {res}")


def official_params(seed: int = 0) -> dict:
    """Seeded random parameters in the official SuperGlue layout (18 layers,
    256 wide; PyTorch's default Linear scale, BatchNorm at unit variance)."""
    rng = np.random.default_rng(seed)

    def lin(o, i):
        b = 1.0 / np.sqrt(i)
        return {"w": rng.uniform(-b, b, (o, i)).astype(np.float32),
                "b": rng.uniform(-b, b, (o,)).astype(np.float32)}

    def bn(c):
        return {"gamma": np.ones(c, np.float32), "beta": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}

    dims = (3, 32, 64, 128, 256)
    blocks = [{"linear": lin(dims[i + 1], dims[i]), "bn": bn(dims[i + 1])} for i in range(4)]
    layers = [{"q": lin(256, 256), "k": lin(256, 256), "v": lin(256, 256),
               "out": lin(256, 256), "mlp0": {"linear": lin(512, 512), "bn": bn(512)},
               "mlp1": lin(256, 512)} for _ in SGO.LAYER_TYPES]
    return {"kenc": {"blocks": blocks, "final": lin(256, 256)}, "gnn": {"layers": layers},
            "final": lin(256, 256), "bin_score": 1.0}


def check_matchers(ex) -> dict:
    """Both matchers on frames 0 and 1, card against CPU, and their times at
    512 x 512."""
    (ka, da, fa), (kb, db, fb) = ex
    sc = torch.full((512,), 0.5, device="cuda")
    args = (fa, ka.uv, sc, ka.valid, fb, kb.uv, sc, kb.valid)
    wh = (640.0, 480.0)
    card, cpu = SGM.SuperGlueMatcher.distilled("cuda"), SGM.SuperGlueMatcher.distilled("cpu")
    _matches_agree("superglue distilled", card.match(*args, image_wh=wh),
                   cpu.match(*(a.cpu() for a in args), image_wh=wh), 0.2)
    params = official_params()
    pc, ph = SGO.to_device(params, "cuda"), SGO.to_device(params, "cpu")
    oargs = (ka.uv, sc, fa, kb.uv, sc, fb, 640.0, 480.0)
    zc = SGO.superglue_apply(pc, *oargs, iters=50)
    zh = SGO.superglue_apply(ph, *(a.cpu() if torch.is_tensor(a) else a for a in oargs),
                             iters=50)
    z_err = float((zc.cpu() - zh).abs().max())
    print(json.dumps({"slice": "learned", "check": "superglue official log-assignment",
                      "z_max_abs_err": z_err}), flush=True)
    if not z_err <= SG_TOL:
        fail(f"superglue official card vs CPU: log-assignment {z_err:.2e} apart")
    _matches_agree("superglue official", SGO.match_from_scores(zc),
                   SGO.match_from_scores(zh), 0.2)
    # times at 512 x 512: the matcher, its Sinkhorn alone, the official
    # forward at the registration's 50 iterations
    with torch.no_grad():
        na = (ka.uv / torch.tensor(wh, device="cuda")) * 2 - 1
        nb = (kb.uv / torch.tensor(wh, device="cuda")) * 2 - 1
        scores, dustbin = card.net(fa, na, sc, ka.valid, fb, nb, sc, kb.valid)
    times = {"slice": "learned", "check": "matcher_times", "K": 512,
             "superglue_match_ms": time_ms(lambda: card.match(*args, image_wh=wh)),
             "sinkhorn_ms": time_ms(lambda: SGM.log_sinkhorn(scores, dustbin, ka.valid,
                                                             kb.valid)),
             "official_apply_ms": time_ms(lambda: SGO.superglue_apply(pc, *oargs, iters=50))}
    times["sinkhorn_share"] = times["sinkhorn_ms"] / times["superglue_match_ms"]
    for size in ((640, 480), (752, 480)):
        W, H = size
        net = SPM.SuperPoint.distilled(device="cuda")
        img = torch.rand((H, W), device="cuda")
        times[f"superpoint_forward_ms_{W}x{H}"] = time_ms(lambda: net.forward(img))
    print(json.dumps(times), flush=True)
    return times


def check_stereo_learned(root: str) -> dict:
    """extract_stereo_learned on the EuRoC layout's first pair (752x480),
    card against CPU: the keypoint sets, and the LK disparities at the
    card's keypoints."""
    from rtabmap_tpu_torch.datasets.readers import EurocDataset
    from rtabmap_tpu_torch.ops import stereo as ST

    args = SD.write_layout("full", root, torch.device("cuda"), frames=1)
    ds = EurocDataset(args[-1])
    fr = next(iter(ds))
    p = Parameters(rgbd_laps.LEARNED)
    out = {}
    for dev in ("cuda", "cpu"):
        fe = FeatureExtractor(ds.camera, p, max_kp=512, device=dev)
        out[dev] = DR.extract_stereo_learned(fe, fr.gray, fr.right, ds.stereo)[0]
    ov = _overlap(out["cuda"], out["cpu"])
    kc = out["cuda"]
    disp = {}
    for dev in ("cuda", "cpu"):
        gl, gr = (torch.from_numpy(np.array(x, np.float32)).to(dev) for x in (fr.gray, fr.right))
        d, ok = ST.lk_stereo_disparity(gl, gr, kc.uv.to(dev), kc.valid.to(dev))
        disp[dev] = (d.cpu().numpy(), ok.cpu().numpy())
    flips = int((disp["cuda"][1] != disp["cpu"][1]).sum())
    both = disp["cuda"][1] & disp["cpu"][1]
    err = float(np.abs(disp["cuda"][0][both] - disp["cpu"][0][both]).max()) if both.any() else 0.0
    res = {"slice": "learned", "check": "stereo_learned",
           "size": [ds.camera.width, ds.camera.height], "keypoints": int(kc.valid.sum()),
           "stereo_points": int(kc.valid3d.sum()), "keypoint_overlap": ov,
           "lk_flips": flips, "lk_max_err_px": err}
    print(json.dumps(res), flush=True)
    if ov < SP_TOL["bfloat16"][1] or flips > LK_FLIPS or err > LK_TOL or not both.any():
        fail(f"learned stereo extraction card vs CPU: {res}")
    return res


def learned_run(name: str, gt: bool) -> tuple:
    """One learned run on the card; checks the state on the card, K1 once
    a quantize call, the matcher still selected and called, finite
    statistics. Returns (summary, K1 launches, engine)."""
    K1.knn2.launches = 0
    out = rgbd_laps.run_sequence(name, torch.device("cuda"),
                                 params=Parameters(rgbd_laps.LEARNED), gt_odometry=gt)
    launches = K1.knn2.launches
    run = out.pop("run")
    slam = run["slam"]
    mem = slam.memory
    label = f"learned {name}{' gt' if gt else ''}"
    for what, t in (("vocabulary slab", mem.vocab.slab), ("node words", mem.node_words),
                    ("posterior", slam.bayes.posterior),
                    ("matcher", next(mem.py_matcher.net.parameters()))):
        if t.device.type != "cuda":
            fail(f"{label}: {what} lies on {t.device}")
    if launches != out["quantize_calls"] or launches == 0:
        fail(f"{label}: vocab_knn2 launched {launches} times for "
             f"{out['quantize_calls']} quantize calls")
    if mem.cor_nn_type != 6 or mem.matcher_calls == 0:
        fail(f"{label}: Vis/CorNNType {mem.cor_nn_type}, {mem.matcher_calls} matcher calls")
    for st in slam.stats_history:
        for k, v in st.data.items():
            if not np.isfinite(v):
                fail(f"{label}: statistic {k} = {v}")
    if not np.isfinite(out["ate_slam"]):
        fail(f"{label}: non-finite ATE")
    # where a frame's process() time goes: each stage's mean over the frames
    stages = {}
    for st in slam.stats_history:
        for k, v in st.data.items():
            if k.startswith("Timing/") and k != "Timing/Total/ms":
                stages[k] = stages.get(k, 0.0) + v / len(slam.stats_history)
    top = dict(sorted(stages.items(), key=lambda kv: -kv[1])[:5])
    res = {"slice": "learned", "sequence": name, "gt_odometry": gt,
           "vocab_knn2_launches": launches, "stage_mean_ms": top,
           **{k: v for k, v in out.items() if k not in ("hyp_ids", "hyp_values")}}
    print(json.dumps(res), flush=True)
    return out, launches, slam


def k1_at_end_state(slam, case: str = "learned-end-state") -> dict:
    """K1 at a run's end state: the last frame's 512 descriptors against
    the dictionary's valid prefix, as the quantize call passes it."""
    voc = slam.memory.vocab
    n = max(voc.n_words, 1)
    sl, va = voc.slab[:n], voc.word_valid[:n]
    last = slam.memory.signatures[max(slam.memory.signatures)]
    q = torch.from_numpy(np.ascontiguousarray(last.desc)).to("cuda")
    d, i = K1.knn2(q, sl, va)
    dr, ir = K1.knn2_reference(q, sl, va)
    if not (torch.equal(d, dr) and torch.equal(i, ir)):
        fail(f"vocab_knn2 disagrees with its plain version at the {case}")
    w8 = -(-n // 8) * 8
    bound, bound_by = knn2_bound_ms(q.shape[0], n, int(va.sum()))
    row = {"kernel": "vocab_knn2", "case": case, "Q": q.shape[0], "W": n,
           "n_valid": int(va.sum()), "equal": True,
           "kernel_ms": time_ms(lambda: K1.knn2(q, sl, va)),
           "graph_ms": graph_ms(lambda: K1.knn2(q, sl, va)),
           "plain_ms": time_ms(lambda: K1.knn2_reference(q, sl, va), reps=10),
           "library_ms": time_ms(lambda: knn2_library(q, voc.slab[:w8], voc.word_valid[:w8])),
           "bound_us": bound * 1e3, "bound_by": bound_by}
    print(json.dumps(row), flush=True)
    return row


def run_learned_slice() -> int:
    """The learned front end: SuperPoint, both matchers and the learned
    stereo extraction card against CPU, their times, then the closure run,
    the appearance-parity run and the parity run through run_dataset, held
    to the JAX CPU runs; K1 at the closure run's end state. Returns K1's
    launches in the phase."""
    ex = check_superpoint()
    check_matchers(ex)
    with tempfile.TemporaryDirectory() as root:
        check_stereo_learned(root)
    total = 0
    rev, n, slam = learned_run("full-revisit", gt=True)
    total += n
    ref = JAX_LEARNED["full-revisit"]
    if rev["loops"] < int(0.9 * ref["loops_min"]):
        fail(f"learned full-revisit: {rev['loops']} loops, JAX CPU lowest {ref['loops_min']}")
    if not rev["closure_err_median_m"] <= ref["closure_err_median_max"] + LEARNED_CLOSURE_MARGIN:
        fail(f"learned full-revisit: closures' median error {rev['closure_err_median_m']} m, "
             f"JAX CPU highest {ref['closure_err_median_max']} m")
    if not rev["ate_slam"] <= RGBD_ATE_BOUND:
        fail(f"learned full-revisit: SLAM ATE {rev['ate_slam']} m")
    k1_at_end_state(slam)
    del slam
    full, n, _ = learned_run("full", gt=True)
    total += n
    ref = JAX_LEARNED["full"]
    ids, vals = np.asarray(full["hyp_ids"][LAP:]), np.asarray(full["hyp_values"][LAP:])
    jids = np.asarray(JAX_LEARNED_FULL_LAP2_IDS)
    dv = np.abs(vals - np.asarray(JAX_LEARNED_FULL_LAP2_VALUES))
    res = {"slice": "learned", "check": "appearance_parity",
           "lap2_same_hypothesis": float((ids == jids).mean()),
           "lap2_same_or_neighbour": float((np.abs(ids - jids) <= 1).mean()),
           "value_max_abs_diff": float(dv.max()), "loops": full["loops"],
           "jax_loops": ref["loops"], "value_median": float(np.median(vals)),
           "value_max": float(vals.max())}
    print(json.dumps(res), flush=True)
    if res["lap2_same_or_neighbour"] < LEARNED_HYP_SHARE or \
            res["value_max_abs_diff"] > LEARNED_HYP_TOL or full["loops"] != ref["loops"]:
        fail(f"learned full: appearance parity {res}")
    par, n, _ = learned_run("parity", gt=False)
    total += n
    ref = JAX_LEARNED["parity"]
    print(json.dumps({"slice": "learned", "check": "parity", "ate_slam": par["ate_slam"],
                      "jax_ate_slam": ref["ate_slam"]}), flush=True)
    if par["loops"] < int(0.9 * ref["loops_min"]) or \
            par["lost"] > ref["lost_max"] + LEARNED_LOST_MARGIN:
        fail(f"learned parity: {par['loops']} loops, {par['lost']} lost (JAX CPU lowest "
             f"{ref['loops_min']} loops, highest {ref['lost_max']} lost)")
    return total


# ---------------------------------------------------------------- classical

# The classical front ends and the other visual odometries against the JAX
# package's CPU runs of the same frames, seeds 0-3 (the RANSAC draws differ
# between the packages and between seeds):
# PYTHONPATH=. python scripts/jax_rgbd_laps.py --strategy 2 --sequence full --seed S,
# ... --strategy 1 --sequence parity --seed S,
# ... --strategy 2 --cor-nn-type 7 --sequence parity --seed S and
# PYTHONPATH=. python scripts/jax_odometries.py --seed S:
# - full-orb (Kp/DetectorStrategy 2, ORB = FAST + rotated BRIEF, two laps
#   at 640x480): 59, 52, 52, 60 loops, 0 lost, SLAM ATE 0.02455, 0.02097,
#   0.03213, 0.01740 m (odometry 0.0304-0.0407 m);
# - parity-sift (1, DoG + SIFT -> sign-LSH words): 10, 8, 6, 6 loops, 0
#   lost, SLAM ATE 0.03851, 0.02205, 0.05979, 0.04141 m;
# - parity-orb-gms (2 with Vis/CorNNType 7): FAST keeps about 30 of 384
#   keypoints a frame at 320x240 and F2M loses 57 of 58 frames at every
#   seed (0 loops, SLAM ATE 0.5484 m over the 10 optimized poses): the
#   twin's behaviour, which the port keeps (ROADMAP.md section 3);
# - f2f (Odom/Strategy 1 over full's first lap): 0 lost, odometry ATE
#   0.01936, 0.01734, 0.01654, 0.02194 m;
# - mono (the strafe at 640x480): initialised at frame 1, 0 lost, Sim(3)
#   RMSE 0.556%, 0.559%, 0.539%, 0.539% of the trajectory's span.
# The card must reach 90% of the lowest loops and lose no more frames than
# the highest; full width: the SLAM ATE at most RGBD_ATE_BOUND and 1.1 x
# the run's own odometry ATE; parity width: at most the JAX highest +
# CLASSICAL_ATE_MARGIN; F2F's odometry ATE at most the JAX highest +
# CLASSICAL_ATE_MARGIN; mono initialised no later than the JAX latest
# frame, its RMSE at most the JAX highest share of the span +
# MONO_SHARE_MARGIN.
JAX_CLASSICAL = {
    "full-orb": {"loops_min": 52, "lost_max": 0},
    "parity-sift": {"loops_min": 6, "lost_max": 0, "ate_max": 0.05979386788977717},
    "parity-orb-gms": {"loops_min": 0, "lost_max": 57, "ate_max": 0.5483569469033548},
    "f2f": {"lost_max": 0, "ate_max": 0.021938856437859446},
    "mono": {"init_max": 1, "lost_max": 0, "share_max": 0.005585718212408894},
}
CLASSICAL_ATE_MARGIN, MONO_SHARE_MARGIN = 0.02, 0.01
# Card against CPU on the same inputs: each response map within 1e-5 of its
# largest magnitude and the SIFT descriptors within 1e-5 (unit norm): sums
# in another order; an LSH bit may differ only where |x.R| < LSH_EPS (the
# two products round differently near 0); the GMS masks exactly (whole-
# number counts); F2F poses and the GMS registration within 1e-4 on the
# same features and the same RANSAC draws (float32 sums in another order);
# mono poses within 5e-3: the bootstrap (after one frame: 640x480 passes
# OdomMono/InitMinFlow's 8 px at once) takes the homography, whose
# decomposition of a near-rotation amplifies the last-bit differences of
# the two devices' float32 SVDs, and the map inherits it (the card read
# 7.1e-4 at the bootstrap and 1.75e-3 at most over 8 frames; the port's
# CPU against the JAX twin reads 2.6e-4 on 160x120 frames for the same
# reason, tests/test_torch_odometry_mono.py).
CL_RESP_TOL, CL_SIFT_TOL, LSH_EPS, CL_POSE_TOL = 1e-5, 1e-5, 1e-5, 1e-4
CL_MONO_POSE_TOL = 5e-3
CL_ODOM_FRAMES = 6   # frames of each odometry run held card against CPU
# Kp/DetectorStrategy of the runs: 6 GFTT/BRIEF (the default), 2 ORB (FAST +
# rotated BRIEF), 0 SURF (DoG + BRIEF), 1 SIFT (DoG + SIFT -> sign-LSH words)
CL_EXTRACT_STRATEGIES = (6, 2, 0, 1)


def _odometry_same_inputs(name: str, feats_cuda: list, cam) -> float:
    """One odometry (``f2f`` or ``mono``) over the same features on the
    CPU and on the card, seed 0 on both: the RANSAC samples come from a CPU
    generator on either device and map onto the match flags, which are
    exact (integer Hamming distances), so both runs draw the same samples.
    Returns the largest pose difference."""
    from rtabmap_tpu_torch.odometry import create_odometry
    from rtabmap_tpu_torch.tools.odometries import MONO_PARAMS

    params = Parameters({"Odom/Strategy": 1} if name == "f2f" else MONO_PARAMS)
    strategy = None if name == "f2f" else "mono"
    cpu = create_odometry(cam, params, strategy=strategy, device="cpu")
    card = create_odometry(cam, params, strategy=strategy, device="cuda")
    diffs = []
    for i, f in enumerate(feats_cuda):
        pc, _, _ = cpu.process(type(f)(*(t.cpu() for t in f)))
        pd, _, _ = card.process(f)
        if (pc is None) != (pd is None):
            fail(f"classical {name}: frame {i} tracked on one device only")
        if pc is not None:
            diffs.append(float((pd.cpu() - pc).abs().max()))
    tol = CL_POSE_TOL if name == "f2f" else CL_MONO_POSE_TOL
    if len(diffs) < 3 or max(diffs) > tol:
        fail(f"classical {name}: card and CPU poses differ by {diffs} (tolerance {tol})")
    return diffs


def _gms_registration_same_inputs(fa, fb, cam) -> dict:
    """``Memory.compute_transform`` with ``Vis/CorNNType`` 7 between two
    frames' features (GFTT/BRIEF at 640x480, three frames apart: the GMS
    filter has its 30 mutual matches and drops some) on the card and on
    the CPU, the same generator seed: the same mutual and GMS masks (exact),
    so the same draws; inliers equal, transforms within CL_POSE_TOL."""
    from rtabmap_tpu_torch.memory import memory as MEM

    out = []
    for dev in ("cpu", "cuda"):
        mem = MEM.Memory(Parameters({"Vis/CorNNType": 7, "Tpu/VocabularyCapacity": 1024}),
                         node_capacity=8, words_per_frame=512, device=dev)
        for i, f in enumerate((fa, fb)):
            mem.signatures[i + 1] = MEM.Signature(
                id=i + 1, map_id=0, stamp=float(i), pose=np.eye(3, 4, dtype=np.float32),
                desc=f.desc.cpu().numpy(), uv=f.uv.cpu().numpy(), pts3d=f.pts3d.cpu().numpy(),
                valid3d=(f.valid3d & f.valid).cpu().numpy())
        t, _, inl = mem.compute_transform(1, 2, cam, torch.Generator().manual_seed(0))
        out.append((t, inl, dict(mem.last_registration)))
    (tc, ic, rc), (td, id_, rd) = out
    if tc is None or td is None or ic != id_ or rc["matches"] != rd["matches"]:
        fail(f"classical: GMS registration card {id_} inliers / {rd['matches']} matches, "
             f"CPU {ic} / {rc['matches']}")
    diff = float(np.abs(np.asarray(td) - np.asarray(tc)).max())
    if diff > CL_POSE_TOL:
        fail(f"classical: GMS registration transforms differ by {diff}")
    return {"inliers": ic, "matches": rc["matches"], "transform_max_diff": diff}


def _pnp_graph_same_as_eager(fa, fb, cam) -> dict:
    """The odometry's PnP-RANSAC (B's pixels against A's 3D, B's own 3D as
    the query, a guess in the pool) through its captured CUDA graph, twice
    (capture, then a replay), and eagerly, on the same inputs and draws:
    every output equal. Returns both times (one call each)."""
    from rtabmap_tpu_torch.ops import matching as MT
    from rtabmap_tpu_torch.ops import ransac as RS

    m = MT.match_nndr(fb.desc, fb.valid, fa.desc, fa.valid & fa.valid3d)
    pts = fa.pts3d[m.idx.long()]
    query = torch.where(fb.valid3d[:, None], fb.pts3d, 0.0)
    idx = RS.pnp_sample_indices(torch.Generator().manual_seed(0), m.valid, 256, True)
    guess = torch.eye(3, 4, device=pts.device)

    def pnp(graphs):
        return RS.ransac_pnp(pts, fb.uv, m.valid, cam, guess=guess, pts3d_query=query,
                             indices=idx, graphs=graphs)

    outs = [pnp(True), pnp(True), pnp(False)]
    for out in outs[:2]:
        if not all(torch.equal(a, b) for a, b in zip(out, outs[2])):
            fail("classical: the PnP-RANSAC's CUDA graph and its eager ops disagree")
    return {"equal": True, "inliers": int(outs[2].num_inliers),
            "graph_ms": time_ms(lambda: pnp(True), reps=10),
            "eager_ms": time_ms(lambda: pnp(False), reps=10)}


def classical_same_inputs() -> dict:
    """(f) The classical front end and the odometries on the card held to
    the CPU on the same inputs, and each strategy's extraction time at
    640x480."""
    from rtabmap_tpu_torch.core import frame as FR
    from rtabmap_tpu_torch.ops import features as FT
    from rtabmap_tpu_torch.ops import image as IM
    from rtabmap_tpu_torch.ops import matching as MT
    from rtabmap_tpu_torch.tools import odometries as OD

    dev = torch.device("cuda")
    spec = OD.run_spec("f2f")
    W, H = spec["size"]
    cam = CAMERA.CameraModel.make(spec["f"], spec["f"], spec["c"][0], spec["c"][1], W, H)
    grays, depths = SYN.render_sequence(spec["poses"][:CL_ODOM_FRAMES], cam,
                                        SYN.World(spec["world"], 0), device=dev)
    g = grays[0]
    res = {"slice": "classical", "check": "same_inputs"}
    for name in ("gftt", "harris", "dog", "fast"):
        rc = FT.RESPONSE_FNS[name](g).cpu()
        rp = FT.RESPONSE_FNS[name](g.cpu())
        err = float((rc - rp).abs().max() / rp.abs().max())
        res[f"{name}_response_rel_err"] = err
        if not err <= CL_RESP_TOL:
            fail(f"classical: {name} response card/CPU relative error {err}")
    kps, _ = FT.detect_and_describe(g, 512, detector="dog", descriptor="brief")
    blur = IM.gaussian_blur(g, sigma=2.0, radius=4)
    dc = FT.describe_sift(blur, kps)
    dp = FT.describe_sift(blur.cpu(), FT.Keypoints(*(t.cpu() for t in kps)))
    res["sift_max_abs_err"] = float((dc.cpu() - dp).abs().max())
    if not res["sift_max_abs_err"] <= CL_SIFT_TOL:
        fail(f"classical: SIFT descriptors card/CPU differ by {res['sift_max_abs_err']}")
    bc, bp = FR.lsh_binarize(dc, kps.valid).cpu(), FR.lsh_binarize(dc.cpu(), kps.valid.cpu())
    x = dc.cpu() / torch.clamp(torch.linalg.norm(dc.cpu(), dim=-1, keepdim=True), min=1e-8)
    proj = (x @ FR.lsh_planes("cpu")).abs()
    flips = bc != bp
    res["lsh_flips"] = int(flips.sum())
    if flips.any() and float(proj[flips].max()) >= LSH_EPS:
        fail(f"classical: an LSH bit flipped at |x.R| = {float(proj[flips].max())}")
    rng = np.random.default_rng(0)
    uv_a = rng.uniform([10, 10], [W - 10, H - 10], (400, 2)).astype(np.float32)
    uv_b = uv_a + np.array([8.0, -3.0], np.float32)
    uv_b[300:] = rng.uniform([10, 10], [W - 10, H - 10], (100, 2))
    ok = torch.from_numpy(rng.random(400) < 0.95)
    a, b = torch.from_numpy(uv_a), torch.from_numpy(uv_b)
    kc = MT.gms_filter(a.to(dev), b.to(dev), ok.to(dev), (H, W), (H, W)).cpu()
    kp = MT.gms_filter(a, b, ok, (H, W), (H, W))
    if not torch.equal(kc, kp) or not kp.any():
        fail("classical: GMS masks differ between card and CPU")
    res["gms_kept"] = int(kp.sum())
    fe = FeatureExtractor(cam, None, max_kp=512, device=dev)
    feats = [fe.extract(grays[i], depths[i])[0] for i in range(CL_ODOM_FRAMES)]
    res["pnp_graph"] = _pnp_graph_same_as_eager(feats[0], feats[3], cam)
    res["gms_registration"] = _gms_registration_same_inputs(feats[0], feats[3], cam)
    res["f2f_pose_diffs"] = _odometry_same_inputs("f2f", feats, cam)
    mspec = OD.run_spec("mono")
    mcam = CAMERA.CameraModel.make(mspec["f"], mspec["f"], mspec["c"][0], mspec["c"][1], W, H)
    mgrays, _ = SYN.render_sequence(mspec["poses"][:CL_ODOM_FRAMES], mcam,
                                    SYN.World(mspec["world"], 0), device=dev)
    mfe = FeatureExtractor(mcam, None, max_kp=512, device=dev)
    mfeats = [mfe.extract(mgrays[i])[0] for i in range(CL_ODOM_FRAMES)]
    res["mono_pose_diffs"] = _odometry_same_inputs("mono", mfeats, mcam)
    # each strategy's extraction of one 640x480 frame (RGB-D), eager
    for strategy in CL_EXTRACT_STRATEGIES:
        ex = FeatureExtractor(cam, Parameters({"Kp/DetectorStrategy": strategy}), max_kp=512,
                              device=dev)
        res[f"extract_ms_strategy_{strategy}"] = time_ms(lambda: ex.extract(g, depths[0]),
                                                         reps=10)
    print(json.dumps(res), flush=True)
    return res


def classical_rgbd(label: str, sequence: str, strategy: int, cor_nn_type=None) -> dict:
    """One rgbd_laps run through run_dataset with a classical front end;
    run_rgbd's checks plus the strategy and correspondence mode kept."""
    params = rgbd_laps.front_end_params(strategy=strategy, cor_nn_type=cor_nn_type)
    out = run_rgbd(label, lambda: rgbd_laps.run_sequence(sequence, torch.device("cuda"),
                                                         params=params), "classical")
    slam = out["slam"]
    if cor_nn_type is not None and slam.memory.cor_nn_type != cor_nn_type:
        fail(f"classical {label}: Vis/CorNNType {slam.memory.cor_nn_type}")
    if int(slam.params["Kp/DetectorStrategy"]) != strategy:
        fail(f"classical {label}: Kp/DetectorStrategy {slam.params['Kp/DetectorStrategy']}")
    return out


def _hold_rgbd(label: str, out: dict, full: bool):
    ref = JAX_CLASSICAL[label]
    if out["loops"] < int(0.9 * ref["loops_min"]) or out["lost"] > ref["lost_max"]:
        fail(f"classical {label}: {out['loops']} loops, {out['lost']} lost (JAX CPU lowest "
             f"{ref['loops_min']} loops, highest {ref['lost_max']} lost)")
    bound = (min(RGBD_ATE_BOUND, 1.1 * out["ate_odom"]) if full
             else ref["ate_max"] + CLASSICAL_ATE_MARGIN)
    if not out["ate_slam"] <= bound:
        fail(f"classical {label}: SLAM ATE {out['ate_slam']} m, bound {bound} m")


def run_classical_slice() -> tuple:
    """The classical front ends and the other odometries: (f) card against
    CPU; (a) ORB at full width through run_dataset, K1 timed at its end
    state; (b) SIFT words and (c) ORB with GMS on the parity sequence; (d)
    F2F over the full sequence's first lap; (e) mono over the strafe.
    Returns (K1's launches in the phase, K1's end-state row)."""
    from rtabmap_tpu_torch.tools import odometries as OD

    classical_same_inputs()
    total = 0
    full = classical_rgbd("full-orb", "full", 2)
    total += full["vocab_knn2_launches"]
    if full["ate_slam_frames"] != full["frames"]:
        fail(f"classical full-orb: {full['ate_slam_frames']} of {full['frames']} frames "
             "in the graph")
    _hold_rgbd("full-orb", full, True)
    row = k1_at_end_state(full.pop("slam"), case="orb-full-end-state")
    for label, sequence, strategy, cor in (("parity-sift", "parity", 1, None),
                                           ("parity-orb-gms", "parity", 2, 7)):
        out = classical_rgbd(label, sequence, strategy, cor)
        total += out["vocab_knn2_launches"]
        _hold_rgbd(label, out, False)
    for name in ("f2f", "mono"):
        out = OD.run_odometry(name, torch.device("cuda"))
        out.pop("est")
        print(json.dumps({"slice": "classical", **out}), flush=True)
        ref = JAX_CLASSICAL[name]
        if out["lost"] > ref["lost_max"] or "ate_odom" not in out:
            fail(f"classical {name}: {out['lost']} lost (JAX CPU highest {ref['lost_max']})")
        if name == "f2f" and not out["ate_odom"] <= ref["ate_max"] + CLASSICAL_ATE_MARGIN:
            fail(f"classical f2f: odometry ATE {out['ate_odom']} m, JAX CPU highest "
                 f"{ref['ate_max']} m")
        if name == "mono" and (out["initialized_at"] > ref["init_max"] or not
                               out["ate_share_of_span"] <= ref["share_max"] + MONO_SHARE_MARGIN):
            fail(f"classical mono: initialised at frame {out['initialized_at']}, RMSE "
                 f"{out['ate_share_of_span']} of the span (JAX CPU {ref})")
    return total, row


# ---------------------------------------------------------------- map tools

# Same inputs on the card and the CPU (the stated tolerances): tsdf and
# weight differ by more than 1e-5 on at most 0.1% of the voxels (a voxel
# centre that projects within float32 rounding of a pixel boundary reads
# the neighbouring depth pixel); a voxel whose sign differs between the two
# volumes lies within 1e-3 of the zero crossing on both; surface nets of one
# volume give the same vertices and faces on either device; given the same
# scores the bake's face_camera is exact and its atlas within 1e-4
# (index_add_ sums in another order); the whole texture_mesh agrees on
# face_camera for 99.9% of the faces; bundle_adjust_large's poses within
# 1e-4 of its CPU run and of the dense solve.
MT_VOXEL_TOL, MT_VOXEL_SHARE, MT_FLIP_TSDF = 1e-5, 1e-3, 1e-3
MT_ATLAS_TOL, MT_FACE_CAMERA_SHARE, MT_BA_TOL = 1e-4, 0.999, 1e-4
# The full-width checks: detect_more_loop_closures at a 0.25 m radius (each
# accepted closure is one graph solve and one gate; many of the padded
# subgraph solves run all 100 LM iterations, ROADMAP.md section 3), its
# map ATE after at most 1.1 x before. On one mapping store on the card
# (scripts/detect_more_radius.py) the tool's 1 m sweep took 282 s (1,258
# solves, 362 closures, ATE 0.74 x before), 0.5 m 130 s (598 solves, 321
# closures, 0.52 x); on another store on a slower host 0.5 m took 165 s
# in the whole script, 0.35 m 92.9 s (226 closures, 0.91 x), 0.3 m 45.8 s
# (122, 0.93 x), 0.25 m 36.4 s (108, 0.85 x): the cut that keeps the whole
# script, with the navigation phase, inside the limit on that host
# (PERF.md section 6). 90% of the mesh's
# vertices within two voxels of one of the hall's planes; texels of
# observed faces correlated at least 0.8 with the hall's texture; the
# reprocessed loops at least 90% of the mapping session's.
# The global BA is held to its path, finite poses on SO(3) (1e-4), its two
# anchor cameras where they were (1e-5 m), a lower cost, and a map ATE of
# at most 1.1 x that of the twin's problem (the rotations kept as stored,
# solved the same way on the same map) and at most RGBD_ATE_BOUND. Not to
# 1.1 x its ATE before: the twin's objective (tracks of shared word ids
# within 0.10 m) moves the map off the ground truth in this hall, in the
# JAX package on the CPU too (scripts/jax_global_ba.py on the port's
# stores, PERF.md); the ratio is printed.
MT_RADIUS, MT_ATE_RATIO, MT_ON_PLANES, MT_TEXEL_CORR = 0.25, 1.1, 0.9, 0.8
MT_BA_TWIN_RATIO = 1.1
MT_SO3_TOL, MT_ANCHOR_TOL = 1e-4, 1e-5
# Pose files print six decimals; in formats 1, 3 and 4 the rotation passes
# a quaternion or Euler angles in float32, which hold only rotations: those
# are held on the poses whose rotation is orthonormal within 1e-5 (a weak
# frame's DLT rotation can stay off SO(3) in both packages), and counted.
# TORO's Euler angles lose precision as the pitch nears +-90 degrees (the
# cameras' frame reaches it: d pitch = d R20 / cos(pitch)), so format 3 is
# held to the tolerance over max(|cos(pitch)|, 0.01).
MT_POSE_FILE_TOL, MT_ORTHONORMAL = 1e-5, 1e-5
# Meshes read back: the PLY prints 5 decimals, the OBJ 6 (and its UVs pass
# through 1 - v in float32).
MT_PLY_TOL, MT_OBJ_TOL = 1e-5, 2e-6


def _sync():
    torch.cuda.synchronize()


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def ba_problem(Nc: int = 12, Np: int = 2000, seed: int = 0) -> BA.BAProblem:
    """Cameras 8 cm apart along x looking at a cloud 5 m ahead, every point
    seen by every camera, exact observations; the first two cameras fixed
    at the truth, the others and the points perturbed (host float32)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(Np, 3)) * 0.8 + [1.0, 0.0, 5.0]).astype(np.float32)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (Nc, 1, 1))
    poses[:, 0, 3] = -0.08 * np.arange(Nc)
    ci = np.repeat(np.arange(Nc), Np)
    pi = np.tile(np.arange(Np), Nc)
    pc = pts[pi] + poses[ci][:, :, 3]
    uv = (pc[:, :2] / pc[:, 2:3]).astype(np.float32)
    noisy = poses.copy()
    noisy[2:, :, 3] += 0.01 * rng.normal(size=(Nc - 2, 3)).astype(np.float32)
    fixed = np.zeros(Nc, bool)
    fixed[:2] = True
    return BA.BAProblem(*(torch.from_numpy(x) for x in (
        noisy, pts + 0.02 * rng.normal(size=pts.shape).astype(np.float32), ci, pi, uv,
        np.ones(len(ci), bool), fixed)))


def map_tools_same_inputs() -> dict:
    """Part (a): the TSDF fusion, surface nets, texture bake and
    bundle_adjust_large on the card and with device="cpu" on the same
    inputs: 12 frames of the parity trajectory at 320x240."""
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    spec = rgbd_laps.sequence_spec("parity")
    cam = CAMERA.CameraModel.make(spec["f"], spec["f"], *spec["c"], *spec["size"])
    world = SYN.World(spec["world"], SYN.DEFAULT_WORLD.seed)
    poses = spec["poses"][0:48:4]
    frames = [SYN.render(p, cam, world, device=dev) for p in poses]
    grays = [g for g, _ in frames]
    depths = [d for _, d in frames]
    lo, size, voxel = CLI.tsdf_box(np.stack([p[:, 3] for p in poses]),
                                   [d.cpu().numpy() for d in depths], 0.05)
    out, vols, ms = {}, {}, {}
    for label, d in (("cuda", dev), ("cpu", cpu)):
        vol = TSDF.TSDFVolume(lo, size, voxel=voxel, device=d)

        def fuse(vol=vol, d=d):
            for p, dep in zip(poses, depths):
                vol.integrate(dep.to(d), p, cam)
        _, ms[f"integrate_{label}"] = _timed(fuse)
        vols[label] = vol
    card, host = vols["cuda"], vols["cpu"]
    for name in ("tsdf", "weight"):
        diff = (getattr(card, name).cpu() - getattr(host, name)).abs()
        share = float((diff > MT_VOXEL_TOL).float().mean())
        out[f"{name}_share_beyond_tol"] = share
        if share > MT_VOXEL_SHARE:
            fail(f"map_tools: {name} differs by more than {MT_VOXEL_TOL} on {share:.2e} "
                 "of the voxels between the card and the CPU")
    known = (card.weight.cpu() >= 1) & (host.weight >= 1)
    flip = known & ((card.tsdf.cpu() > 0) != (host.tsdf > 0))
    far = flip & ((card.tsdf.cpu().abs() > MT_FLIP_TSDF) | (host.tsdf.abs() > MT_FLIP_TSDF))
    out.update(sign_flips=int(flip.sum()), sign_flips_off_zero=int(far.sum()))
    if int(far.sum()):
        fail(f"map_tools: {int(far.sum())} voxels change sign between the card and the CPU "
             f"at more than {MT_FLIP_TSDF} from the zero crossing")
    (v_h, f_h), ms["surface_nets_cpu"] = _timed(lambda: TSDF.surface_nets(
        host.tsdf, host.weight, lo, voxel))
    (v_x, f_x), ms["surface_nets_cuda"] = _timed(lambda: TSDF.surface_nets(
        host.tsdf.to(dev), host.weight.to(dev), lo, voxel))
    if not (torch.equal(v_x.cpu(), v_h) and torch.equal(f_x.cpu(), f_h)):
        fail("map_tools: surface nets of one volume differ between the card and the CPU")
    v_c, f_c = card.extract_mesh()
    out.update(vertices=int(v_h.shape[0]), faces=int(f_h.shape[0]),
               faces_card_volume=int(f_c.shape[0]))
    if f_h.shape[0] < 1000:
        fail(f"map_tools: the parity frames' mesh has {f_h.shape[0]} faces")

    host_in = (v_h, f_h, poses, cam, [g.cpu() for g in grays])
    card_in = (v_h.to(dev), f_h.to(dev), poses, cam, grays)
    scores, ms["scores_cpu"] = _timed(lambda: TEX.face_camera_scores(
        *host_in[:4], depths=[d.cpu() for d in depths]))
    scores_c, ms["scores_cuda"] = _timed(lambda: TEX.face_camera_scores(
        *card_in[:4], depths=depths))
    out["score_sign_differences"] = int(((scores_c.cpu() > 0) != (scores > 0)).sum())
    bake_h, ms["bake_cpu"] = _timed(lambda: TEX.bake_face_atlas(*host_in, scores=scores))
    bake_c, ms["bake_cuda"] = _timed(lambda: TEX.bake_face_atlas(*card_in, scores=scores.to(dev)))
    atlas_diff = float((bake_c.atlas.cpu() - bake_h.atlas).abs().max())
    out.update(atlas_px=int(bake_h.atlas.shape[0]), bake_atlas_max_abs_diff=atlas_diff,
               faces_observed=float((bake_h.face_camera >= 0).float().mean()))
    if not torch.equal(bake_c.face_camera.cpu(), bake_h.face_camera) or atlas_diff > MT_ATLAS_TOL:
        fail(f"map_tools: the bake on the card differs: atlas {atlas_diff}, face_camera "
             f"{int((bake_c.face_camera.cpu() != bake_h.face_camera).sum())} faces")
    tm_h, ms["texture_mesh_cpu"] = _timed(lambda: TEX.texture_mesh(
        *host_in, depths=[d.cpu() for d in depths]))
    tm_c, ms["texture_mesh_cuda"] = _timed(lambda: TEX.texture_mesh(*card_in, depths=depths))
    same = float((tm_c.face_camera.cpu() == tm_h.face_camera).float().mean())
    out["texture_mesh_face_camera_equal"] = same
    if same < MT_FACE_CAMERA_SHARE:
        fail(f"map_tools: texture_mesh's face_camera agrees on {same:.4f} of the faces")

    prob = ba_problem()
    card_prob = BA.BAProblem(*(x.to(dev) for x in prob))
    (large_c, cost_c), ms["ba_large_cuda"] = _timed(
        lambda: BA.bundle_adjust_large(card_prob, iters=10, cg_iters=60))
    (large_h, cost_h), ms["ba_large_cpu"] = _timed(
        lambda: BA.bundle_adjust_large(prob, iters=10, cg_iters=60))
    (dense_c, cost_d), ms["ba_dense_cuda"] = _timed(lambda: BA.bundle_adjust(card_prob, iters=10))
    d_cpu = float((large_c.poses.cpu() - large_h.poses).abs().max())
    d_dense = float((large_c.poses - dense_c.poses).abs().max())
    out["ba"] = {"cameras": int(prob.poses.shape[0]), "points": int(prob.points.shape[0]),
                 "observations": int(prob.uv.shape[0]), "cost_large": float(cost_c),
                 "cost_dense": float(cost_d), "poses_vs_cpu": d_cpu, "poses_vs_dense": d_dense}
    if not (d_cpu <= MT_BA_TOL and d_dense <= MT_BA_TOL):
        fail(f"map_tools: bundle_adjust_large's poses differ by {d_cpu} from its CPU run and "
             f"{d_dense} from the dense solve")
    out["ms"] = ms
    print(json.dumps({"slice": "map_tools", "same_inputs": out}), flush=True)
    return out


def _resume(path: str, cam, dev):
    """(engine resumed on the store at ``path`` without a new session, the
    store) at the sessions' sizes."""
    spec = rgbd_laps.sequence_spec("full")
    db = Database(path)
    return Rtabmap.load(db, cam, Parameters(), node_capacity=spec["node_capacity"],
                        words_per_frame=spec["max_kp"], new_session=False, device=dev), db


def planes_of(points_w: torch.Tensor, half_extent) -> tuple:
    """(distance to the nearest of the hall's six planes, its index 2 * axis
    + (1 for the + side)) of world points (..., 3)."""
    he = torch.tensor(half_extent, dtype=points_w.dtype, device=points_w.device)
    d = torch.stack([(points_w[..., a] - s * he[a]).abs() for a in range(3) for s in (-1, 1)],
                    dim=-1)
    dist, k = d.min(dim=-1)
    return dist, k


def texel_truth(tm, R, t, world: "SYN.World"):
    """(texels, the hall's texture there) of the observed faces: each texel's
    point carried to the world, its value_noise on the nearest plane as
    synthetic.render computes it."""
    F = tm.faces.shape[0]
    K = int(np.ceil(np.sqrt(F)))
    texel = tm.atlas.shape[0] // K
    dev = tm.atlas.device
    obs = tm.face_camera >= 0
    f = tm.faces[obs].long()
    bary = torch.from_numpy(TEX._face_grid(texel)).to(dev)
    v = tm.vertices
    pts = (bary[None, :, 0:1] * v[f[:, 0]][:, None] + bary[None, :, 1:2] * v[f[:, 1]][:, None]
           + bary[None, :, 2:3] * v[f[:, 2]][:, None])
    pw = pts @ torch.as_tensor(R, dtype=torch.float32, device=dev).T + torch.as_tensor(
        t, dtype=torch.float32, device=dev)
    _, k = planes_of(pw, world.half_extent)
    truth = torch.zeros(pw.shape[:-1], device=dev)
    for plane in range(6):
        axis, side = divmod(plane, 2)
        a1, a2 = [a for a in range(3) if a != axis]
        m = k == plane
        truth[m] = SYN.value_noise(pw[..., a1][m] * 0.5, pw[..., a2][m] * 0.5,
                                   seed=world.seed * 31 + axis * 2 + side)
    texels = tm.atlas.reshape(K, texel, K, texel).permute(0, 2, 1, 3).reshape(K * K, -1)[:F]
    return texels[obs], truth


def run_map_tools(stores: str, sessions: dict) -> int:
    """Part (a), then part (b): the store tools at full width on copies of
    the rgbd_sessions stores. Returns K1's launches (the reprocess)."""
    map_tools_same_inputs()
    dev = torch.device("cuda")
    cam_vals = rgbd_sessions.camera()
    cam = CAMERA.CameraModel.make(*cam_vals)
    cam_arg = ",".join(str(x) for x in cam_vals)
    work = os.path.join(stores, "work")
    os.makedirs(work, exist_ok=True)
    mapping, resumed = (os.path.join(stores, n) for n in ("mapping.db", "resumed.db"))

    def copy(src, name):
        dst = os.path.join(work, name)
        shutil.copyfile(src, dst)
        return dst

    db = Database(mapping, async_writes=False)
    n_nodes, n_links = len(db.node_infos()), len(db.all_links())
    stored_opt = db.load_admin()["optimized_poses"]
    db.close()
    rows = {"stored": {"nodes": n_nodes, "links": n_links}}

    # reprocess: the stored nodes through process() again
    K1.knn2.launches = 0
    # the store's camera: the engine's close() wrote it under __camera__
    slam, ms = _timed(lambda: CLI.main(["reprocess", copy(mapping, "re.db")]))
    launches = K1.knn2.launches
    hist = slam.stats_history
    quantize = sum("TimingMem/Add new words/ms" in st.data for st in hist)
    loops = sum(1 for st in hist if st.loop_closure_id > 0)
    nodes = len(slam.memory.signatures)
    rows["reprocess"] = {"nodes": nodes, "not_recreated": n_nodes - nodes, "loops": loops,
                         "session_loops": sessions["mapping"]["loops"], "quantize_calls": quantize,
                         "vocab_knn2_launches": launches, "ms": ms,
                         "process_ms_median": float(np.median([st.get("Timing/Total/ms")
                                                               for st in hist]))}
    if slam.memory.vocab.slab.device.type != "cuda":
        fail("reprocess: the vocabulary lies off the card")
    if launches != quantize or launches == 0:
        fail(f"reprocess: vocab_knn2 launched {launches} times for {quantize} quantize calls")
    if nodes != n_nodes or loops < int(0.9 * sessions["mapping"]["loops"]):
        fail(f"reprocess: {nodes} nodes of {n_nodes}, {loops} loops (the session's "
             f"{sessions['mapping']['loops']})")
    del slam

    # more loop closures on the mapping store, with the store's camera
    slam, db = _resume(copy(mapping, "detect.db"), cam, dev)
    ate0, _ = rgbd_sessions.map_ate(slam)
    n_solves = len(slam.solves)
    added, ms = _timed(lambda: slam.detect_more_loop_closures(cluster_radius=MT_RADIUS))
    ate1, _ = rgbd_sessions.map_ate(slam)
    iters = [s[1] for s in slam.solves[n_solves:]]
    rows["detect_more_loop_closures"] = {
        "radius": MT_RADIUS, "added": added, "ate_before": ate0, "ate_after": ate1,
        "solves": len(iters), "solve_iters_median": float(np.median(iters)) if iters else 0.0,
        "solves_at_iteration_budget": sum(i >= slam.optimizer_iterations for i in iters),
        "solve_ms_median": float(np.median([s[2] for s in slam.solves[n_solves:]]))
        if iters else 0.0, "ms": ms}
    db.close()
    if not ate1 <= MT_ATE_RATIO * ate0:
        fail(f"detect_more_loop_closures: map ATE {ate1:.4f} m after, {ate0:.4f} m before")

    # the pose files, read back
    errs = {}
    ids = sorted(stored_opt)
    rot_ok = {i: float(np.abs(stored_opt[i][:, :3].astype(np.float64).T
                              @ stored_opt[i][:, :3] - np.eye(3)).max()) <= MT_ORTHONORMAL
              for i in ids}
    for fmt in range(5):
        out = os.path.join(work, f"poses{fmt}.txt")
        CLI.main(["export", mapping, out, str(fmt)])
        back = import_poses(out, fmt)
        keys = ids if fmt in (3, 4) else list(range(len(ids)))
        if sorted(back) != keys:
            fail(f"export format {fmt}: {len(back)} poses read back of {len(ids)}")
        # the error over its tolerance, pose by pose
        errs[fmt] = max(float(np.abs(back[k] - stored_opt[i]).max()) * (
            max(abs(float(np.sqrt(max(0.0, 1.0 - float(stored_opt[i][2, 0]) ** 2)))), 0.01)
            if fmt == 3 else 1.0) for k, i in zip(keys, ids) if fmt in (0, 2) or rot_ok[i])
    rows["export"] = {"poses": len(ids), "max_err_by_format": errs,
                      "rotations_off_so3": sum(not v for v in rot_ok.values())}
    if max(errs.values()) > MT_POSE_FILE_TOL:
        fail(f"export: poses read back differ by {errs}")

    # recovery of a copy
    rec_path = os.path.join(work, "recovered.db")
    rec, ms = _timed(lambda: CLI.main(["recovery", copy(mapping, "damaged.db"), rec_path]))
    db = Database(rec_path, async_writes=False)
    rec_rows = (len(db.node_infos()), len(db.all_links()))
    db.close()
    rows["recovery"] = {**rec, "rows": rec_rows, "ms": ms}
    if (rec["nodes"], rec["links"]) != (n_nodes, n_links) or rec_rows != (n_nodes, n_links):
        fail(f"recovery: {rec} and {rec_rows} rows from {n_nodes} nodes, {n_links} links")
    print(json.dumps({"slice": "map_tools", "mapping_store": rows}), flush=True)

    # global bundle adjustment of the resumed store (two sessions)
    rows = {}
    slam, db = _resume(copy(resumed, "ba.db"), cam, dev)
    R, t = RSC.map_to_world(slam)          # the stored optimized poses onto the ground truth
    ate0, n_ate = rgbd_sessions.map_ate(slam)
    before = slam.get_optimized_poses()
    # the twin's problem on the same map: the rotations kept as stored
    ids, _, prob = slam.global_ba_problem(orthonormalize=False)
    out, _ = BA.bundle_adjust_large(prob, iters=10, huber=4.0 / cam.fx)
    as_twin = dict(before)
    as_twin.update(zip(ids, T.inverse(out.poses).cpu().numpy()))
    gt_ids = [i for i in sorted(as_twin) if i >= 0 and (sg := slam.memory.get(i)) is not None
              and sg.gt_pose is not None]
    ate_twin = metrics.ate_rmse(np.stack([as_twin[i] for i in gt_ids]),
                                np.stack([slam.memory.get(i).gt_pose for i in gt_ids]))
    ok, ms = _timed(slam.global_bundle_adjustment)
    stats = dict(slam.global_ba_stats or {})
    ate1, _ = rgbd_sessions.map_ate(slam)
    after = slam.get_optimized_poses()
    new = np.stack(list(after.values()))
    adjusted = sorted(i for i in after if (sg := slam.memory.get(i)) is not None
                      and sg.word_ids is not None)
    anchors = adjusted[:2]
    off_so3 = max(float(np.abs(after[i][:, :3].astype(np.float64).T @ after[i][:, :3]
                               - np.eye(3)).max()) for i in adjusted)
    anchor_moved = max(float(np.abs(after[i][:, 3] - before[i][:, 3]).max()) for i in anchors)
    stats.update(ok=ok, ms=ms, ate_before=ate0, ate_after=ate1, ate_ratio=ate1 / ate0,
                 ate_after_rotations_as_stored=ate_twin, ate_nodes=n_ate,
                 rotations_max_off_so3=off_so3, anchors_moved_m=anchor_moved)
    if stats.get("path") != "bundle_adjust_large":
        # a small problem: hold the implicit-Schur path on it directly
        ids, n_tracks, prob = slam.global_ba_problem()
        (_, cost), ms_large = _timed(lambda: BA.bundle_adjust_large(prob, huber=4.0 / cam.fx))
        stats["bundle_adjust_large_direct"] = {"cost": float(cost), "ms": ms_large}
        print(f"global BA: {len(ids)} x {n_tracks} stays under 600,000; "
              "bundle_adjust_large run on the same problem directly", flush=True)
        if not np.isfinite(float(cost)):
            fail("global BA: bundle_adjust_large on the map's problem is not finite")
    rows["global_bundle_adjustment"] = stats
    db.close()
    if not (ok and np.isfinite(new).all() and stats["cost_after"] < stats["cost_before"]
            and off_so3 <= MT_SO3_TOL and anchor_moved <= MT_ANCHOR_TOL):
        fail(f"global BA: {stats}")
    if not (ate1 <= MT_BA_TWIN_RATIO * ate_twin and ate1 <= RGBD_ATE_BOUND):
        fail(f"global BA: map ATE {ate1:.4f} m after, {ate0:.4f} m before, {ate_twin:.4f} m "
             "with the rotations as stored")

    # the cloud, the mesh and the textured mesh of the resumed store
    half = rgbd_laps.FULL_WORLD
    world = SYN.World(half, SYN.DEFAULT_WORLD.seed)
    ply = os.path.join(work, "cloud.ply")
    n_pts, ms = _timed(lambda: CLI.main(["export_cloud", resumed, ply, "--cam", cam_arg]))
    rows["cloud"] = {"points": n_pts, "ms": ms}
    if n_pts == 0 or MESH.read_ply_counts(ply)[0] != n_pts:
        fail(f"export_cloud: {n_pts} points, the file holds {MESH.read_ply_counts(ply)}")
    ply = os.path.join(work, "mesh.ply")
    ex, ms = _timed(lambda: CLI.main(["export_cloud", resumed, ply, "--mesh",
                                      "--cam", cam_arg]))
    verts, faces = ex.pop("mesh")
    n_faces = ex["faces"]
    vw = verts @ torch.as_tensor(R, dtype=torch.float32, device=dev).T + torch.as_tensor(
        t, dtype=torch.float32, device=dev)
    dist, plane = planes_of(vw, half)
    near = dist <= 2 * ex["voxel"]
    names = [f"{s}{a}" for a in "xyz" for s in "-+"]
    ex.update(ms_total=ms, on_planes=float(near.float().mean()), vertices_by_plane={
        names[k]: int(((plane == k) & near).sum()) for k in range(6)})
    rv, rf, _ = MESH.read_ply(ply)
    ex["ply_read_back_equal"] = bool(np.array_equal(rf, faces.cpu().numpy())
                                     and np.abs(rv - verts.cpu().numpy()).max() <= MT_PLY_TOL)
    rows["mesh"] = ex
    if n_faces == 0 or ex["on_planes"] < MT_ON_PLANES or not ex["ply_read_back_equal"]:
        fail(f"export_cloud --mesh: {ex}")
    obj = os.path.join(work, "mesh.obj")
    tex, ms = _timed(lambda: CLI.main(["export_cloud", resumed, obj, "--mesh", "--texture",
                                       "--cam", cam_arg]))
    tm = tex.pop("mesh")
    texels, truth = texel_truth(tm, R, t, world)
    corr = float(np.corrcoef(texels.reshape(-1).cpu().numpy(),
                             truth.reshape(-1).cpu().numpy())[0, 1])
    v2, f2, uv2, atlas2 = TEX.read_textured_obj(obj)
    atlas8 = (np.clip(tm.atlas.cpu().numpy(), 0, 1) * 255.0 + 0.5).astype(np.uint8)
    tex.update(ms_total=ms, faces_observed_share=tex["faces_observed"] / max(tex["faces"], 1),
               texel_truth_correlation=corr, obj_read_back_equal=bool(
                   np.array_equal(f2, tm.faces.cpu().numpy()) and np.array_equal(atlas2, atlas8)
                   and np.abs(v2 - tm.vertices.cpu().numpy()).max() <= MT_OBJ_TOL
                   and np.abs(uv2 - tm.uvs.cpu().numpy()).max() <= MT_OBJ_TOL))
    rows["textured_mesh"] = tex
    print(json.dumps({"slice": "map_tools", "resumed_store": rows}), flush=True)
    if corr < MT_TEXEL_CORR or not tex["obj_read_back_equal"]:
        fail(f"export_cloud --texture: correlation {corr:.3f}, read back "
             f"{tex['obj_read_back_equal']}")
    return launches


def keep_stripped(src: str, out_dir: str):
    """Copy the store at ``src`` to ``out_dir/resumed_stripped.db`` without
    its stored images and depth."""
    import sqlite3

    os.makedirs(out_dir, exist_ok=True)
    dst = os.path.join(out_dir, "resumed_stripped.db")
    shutil.copyfile(src, dst)
    con = sqlite3.connect(dst)
    con.execute("UPDATE Data SET image = NULL, depth = NULL")
    con.commit()
    con.execute("VACUUM")
    con.close()
    print(json.dumps({"kept_store": dst, "bytes": os.path.getsize(dst)}), flush=True)


# The navigation phase (tools/navigation.py) on a copy of the rgbd_sessions
# mapping store: labels through db_edit, the store loaded in localization
# mode with Rtabmap/MemoryThr 60, lap 1 driven from frame 30 back to the
# dock. The JAX package's CPU runs of the same drive on its own full-width
# stores (scripts/jax_navigation.py, seeds 0-3) reach the goal at frame 28
# each (planned after frame 1; paths of 23, 24, 19, 17 nodes with 5, 5, 6,
# 13 of them in LTM; 21, 24, 14, 16 ticks paging a path node outside the
# highest hypothesis' neighbourhood; no virtual link left). The
# resumed-session mode (a new mapping session with the same MemoryThr)
# aborts its path at every seed (status -1 three ticks after planning:
# the newest node of the new session has no optimized pose until a
# closure joins the map), so the phase drives localization mode.
JAX_NAV = {"reached_at_max": 28}
NAV_REACHED_MARGIN = 2
NAV_DESK_OFFSET = 0.2     # set_goal_pose's target: desk's pose plus 0.2 m, outward
NAV_FAR = 50.0            # a pose this far off the map is refused
NAV_TRACE_FRAMES = 2      # shows that Tpu/ProfileDir writes a trace


def _quiet(fn):
    """fn() with its standard output (db_edit's node listing) discarded."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _finite_stats(name, slam):
    for st in slam.stats_history:
        for k, v in st.data.items():
            if not np.isfinite(v):
                fail(f"{name}: statistic {k} = {v}")


def run_navigation_slice(stores: str) -> int:
    """Navigation on a saved map (tools/navigation.py) on copies of the
    mapping session's store: labels through db_edit, read back; the
    localization-mode drive to the dock with its checks; set_goal_pose to
    desk and a refused far pose; the path on the card equal to the CPU's;
    the map edits and dumps on further copies; a short traced run of the
    RGB-D parity sequence through run_dataset. Returns K1's launches
    in the drive."""
    dev = torch.device("cuda")
    work = os.path.join(stores, "nav")
    os.makedirs(work, exist_ok=True)
    nav = os.path.join(work, "nav.db")
    shutil.copyfile(os.path.join(stores, "mapping.db"), nav)
    dock, desk = _quiet(lambda: NAV.label_store(nav))
    listed = _quiet(lambda: CLI.main(["db_edit", nav, "nodes"]))
    labels = {r["id"]: r["label"] for r in listed if r["label"]}
    if labels != {dock: "dock", desk: "desk"}:
        fail(f"navigation: db_edit nodes reads the labels {labels}, set {dock}: dock, "
             f"{desk}: desk")
    for name in ("loaded", "edits", "cpu"):
        shutil.copyfile(nav, os.path.join(work, f"{name}.db"))

    K1.knn2.launches = 0
    t0 = time.perf_counter()
    tracker, run = NAV.navigate(nav, dev, seed=LOCALIZATION_SEEDS[0])
    drive_s = time.perf_counter() - t0
    launches = K1.knn2.launches
    slam = run["slam"]
    hist = slam.stats_history
    quantize = sum("TimingMem/Add new words/ms" in st.data for st in hist)
    res = tracker.summary()
    ticks = res.pop("ticks")
    planning = [t["planning_ms"] for t in ticks]
    res.update(lost=run["lost"], quantize_calls=quantize, vocab_knn2_launches=launches,
               localized=int(sum(st.get("Loop/Localized/") > 0 for st in hist)),
               goal_ids=[t["goal_id"] for t in ticks],
               paged_by_path_only=[t["paged_by_path_only"] for t in ticks],
               process_ms={"median": float(np.median(run["process_ms"])),
                           "p90": float(np.percentile(run["process_ms"], 90))},
               planning_ms={"median": float(np.median(planning)),
                            "p90": float(np.percentile(planning, 90))},
               drive_s=drive_s, dock=dock, desk=desk)
    print(json.dumps({"slice": "navigation", **res}), flush=True)
    _finite_stats("navigation", slam)
    path = res["path"]
    if not path or path[0] != res["start"] or path[-1] != dock:
        fail(f"navigation: path {path} does not run from the current node {res['start']} "
             f"to the dock {dock}")
    if not (res["goal_index_monotone"] and res["goal_ids_on_path"]):
        fail(f"navigation: the current goal moved backwards along the path: {res['goal_ids']}")
    if res["ticks_paging_by_path_only"] < 1:
        fail("navigation: no tick paged a path node back from the store outside the "
             "hypothesis' neighbourhood")
    limit = JAX_NAV["reached_at_max"] + NAV_REACHED_MARGIN
    if res["reached_at"] is None or res["reached_at"] > limit or res["status"] != 1:
        fail(f"navigation: goal reached at frame {res['reached_at']} (status {res['status']}),"
             f" JAX CPU highest {JAX_NAV['reached_at_max']}")
    if res["virtual_links_left"]:
        fail(f"navigation: {res['virtual_links_left']} virtual links left")
    if launches != quantize or launches == 0:
        fail(f"navigation: vocab_knn2 launched {launches} times for {quantize} quantize calls")
    if slam.memory.vocab.slab.device.type != "cuda":
        fail("navigation: the vocabulary lies off the card")
    k1_at_end_state(slam, "navigation-end-state")

    # set_goal_pose: desk's pose 0.2 m further out snaps to desk; 50 m off is refused
    p = np.asarray(slam.optimized_poses[desk], np.float32)
    radial = np.asarray([p[0, 3], 0.0, p[2, 3]], np.float32)
    target = p.copy()
    target[:3, 3] += NAV_DESK_OFFSET * radial / np.linalg.norm(radial)
    snapped = slam.set_goal_pose(target)
    offset = float(np.linalg.norm(slam._path_transform_to_goal[:3, 3]))
    snap_path = slam.get_path()
    far = target.copy()
    far[:3, 3] += NAV_FAR
    refused = not slam.set_goal_pose(far) and slam.path_status == -1
    row = {"slice": "navigation", "set_goal_pose": {"snapped": snapped,
           "goal": snap_path[-1] if snap_path else 0, "offset_m": offset, "far_refused": refused}}
    print(json.dumps(row), flush=True)
    if not (snapped and snap_path and snap_path[-1] == desk
            and abs(offset - NAV_DESK_OFFSET) < 1e-3 and refused):
        fail(f"navigation: set_goal_pose {row['set_goal_pose']}")

    # the dumps of the drive's engine, read back
    dot = os.path.join(work, "map.dot")
    edges = slam.generate_dot_graph(dot)
    text = open(dot).read()
    pred = os.path.join(work, "prediction.txt")
    slam.dump_prediction(pred)
    P = np.loadtxt(pred)
    log_f = slam.write_log_files(work)
    import csv

    with open(log_f) as f:
        log_rows = list(csv.reader(f))
    with open(os.path.join(work, "LogI.csv")) as f:
        logi_rows = list(csv.reader(f))
    cols = P[:, np.abs(P).sum(0) > 0]
    dumps = {"dot_edges": edges, "dot_edge_lines": text.count(" -- "),
             "prediction_shape": list(P.shape),
             "prediction_columns_sum_to_1": bool(np.allclose(cols.sum(0), 1.0, atol=1e-4)),
             "log_rows": [len(log_rows), len(logi_rows)],
             "log_columns": [len(log_rows[0]), len(logi_rows[0])]}
    print(json.dumps({"slice": "navigation", "dumps": dumps}), flush=True)
    if not (text.startswith("graph map {") and text.rstrip().endswith("}")
            and dumps["dot_edge_lines"] == edges > 0):
        fail(f"navigation: the dot file does not parse: {dumps}")
    if P.shape != (slam.memory.node_capacity + 1,) * 2 or not dumps["prediction_columns_sum_to_1"]:
        fail(f"navigation: the prediction matrix {dumps}")
    if not (len(log_rows) == len(logi_rows) == len(hist) + 1
            and all(len(r) == len(log_rows[0]) for r in log_rows)
            and np.isfinite(np.asarray(log_rows[1:], float)).all()):
        fail(f"navigation: the log files {dumps}")
    slam.memory.db.close()

    # the path on the card equals the path on the CPU, on the same store
    cam = CAMERA.CameraModel.make(*rgbd_sessions.camera())
    spec = rgbd_laps.sequence_spec("full")
    paths = {}
    for label, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        db = Database(os.path.join(work, "loaded.db" if label == "cuda" else "cpu.db"))
        e = Rtabmap.load(db, cam, Parameters(NAV.drive_params()),
                         node_capacity=spec["node_capacity"], words_per_frame=spec["max_kp"],
                         device=d)
        planned = e.compute_path(dock)
        ok = e.set_goal(dock)
        paths[label] = (planned, ok, e.get_path(), e.get_path_current_goal(),
                        [np.asarray(q).tolist() for q in e.get_path_next_poses()])
        db.close()
    print(json.dumps({"slice": "navigation", "card_vs_cpu": {
        "path": paths["cuda"][0], "equal": paths["cuda"] == paths["cpu"]}}), flush=True)
    if paths["cuda"] != paths["cpu"] or not paths["cuda"][1] or paths["cuda"][0][-1] != dock:
        fail(f"navigation: the card's path {paths['cuda'][:2]} differs from the CPU's "
             f"{paths['cpu'][:2]}")

    # map edits on a further copy: delete_last_location persists; reset_memory
    edits = os.path.join(work, "edits.db")
    db = Database(edits)
    e = Rtabmap.load(db, cam, None, node_capacity=spec["node_capacity"],
                     words_per_frame=spec["max_kp"], new_session=False, device=dev)
    n_before, last, map_id = len(db.node_infos()), e.get_last_location_id(), e.memory.map_id
    deleted = e.delete_last_location()
    db.flush()
    reader = Database(edits, async_writes=False)
    ids_after = [r["id"] for r in reader.node_infos()]
    reader.close()
    e.reset_memory()
    db.close()
    row = {"nodes_before": n_before, "deleted": last, "nodes_after": len(ids_after),
           "reset_wm": len(e.get_wm()), "reset_map_id": [map_id, e.memory.map_id]}
    print(json.dumps({"slice": "navigation", "edits": row}), flush=True)
    if not (deleted and len(ids_after) == n_before - 1 and last not in ids_after):
        fail(f"navigation: delete_last_location did not persist: {row}")
    if e.get_wm() or e.get_stm() or e.memory.signatures or e.memory.map_id != map_id + 1:
        fail(f"navigation: reset_memory left {row}")

    # a traced run of the RGB-D parity sequence through run_dataset (Tpu/ProfileDir)
    trace_dir = os.path.join(work, "trace")
    t0 = time.perf_counter()
    out = rgbd_laps.run_sequence("parity", dev, NAV_TRACE_FRAMES,
                                 params=Parameters({"Tpu/ProfileDir": trace_dir}))
    trace = out["run"]["trace"]
    row = {"frames": out["frames"], "seconds": time.perf_counter() - t0,
           "trace_bytes": os.path.getsize(trace["path"]) if trace["path"] else 0, **trace}
    print(json.dumps({"slice": "navigation", "trace": row}), flush=True)
    if not (row["trace_bytes"] > 0 and os.path.dirname(trace["path"]) == trace_dir
            and 0.0 < trace["device_busy_share"] <= 1.0 and trace["device_ops"] > 0):
        fail(f"navigation: the parity run's trace {row}")
    return launches


def main():
    keep = sys.argv[sys.argv.index("--keep-store") + 1] if "--keep-store" in sys.argv else None
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    reports = build.build_all([K1.SOURCE, K2.SOURCE])
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(reports)}), flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] {line.strip()}", file=sys.stderr)

    def phase(name, fn):
        t = time.perf_counter()
        out = fn()
        print(json.dumps({"phase": name, "seconds": time.perf_counter() - t}), flush=True)
        return out

    k1 = phase("kernels_vocab_knn2", check_knn2)
    k2, k2c = phase("kernels_nn3d", check_nn3d)
    k1["launches"] = phase("bow_mapping", run_slice)
    k2["launches"], k2c["launches"] = phase("lidar_mapping", run_lidar_slices)
    with tempfile.TemporaryDirectory() as stores:
        path = os.path.join(stores, "map.db")
        launches, mapping = phase("rgbd_mapping", lambda: run_rgbd_slices(path))
        k1["launches"] += launches
        launches, sessions = phase("rgbd_sessions", lambda: run_sessions(path, mapping, stores))
        k1["launches"] += launches
        k1["launches"] += phase("navigation", lambda: run_navigation_slice(stores))
        if keep:
            keep_stripped(os.path.join(stores, "resumed.db"), keep)
        k1["launches"] += phase("map_tools", lambda: run_map_tools(stores, sessions))
    scan_k1, scan_k2, scan_k2c = phase("rgbd_scan", run_scan_slice)
    k1["launches"] += phase("stereo", run_stereo_slice)
    k1["launches"] += phase("learned", run_learned_slice)
    launches, _ = phase("classical", run_classical_slice)
    k1["launches"] += launches
    k1["launches"] += scan_k1
    k2["launches"] += scan_k2
    k2c["launches"] += scan_k2c
    print(json.dumps({"total_seconds": time.perf_counter() - t0}), flush=True)

    print(card)
    print(json.dumps({"kernels": [k1, k2, k2c]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
