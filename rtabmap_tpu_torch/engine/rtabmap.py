"""The SLAM engine's per-frame ``process()`` state machine.

Port of ``rtabmap_tpu/engine/rtabmap.py`` over two configurations:

- appearance-only (``RGBD/Enabled=false``, RTAB-Map's BOWMapping): memory
  update + rehearsal, tf-idf likelihood -> Angeli adjustment -> Bayes
  posterior -> hypothesis accept (single-hypothesis and loop-ratio rules),
  LTM -> WM retrieval, the appearance-only closure link, WM -> LTM
  transfer and the statistics;
- the metric RGB-D tick (``RGBD/Enabled=true``, the default): on top of
  the above, the odometry neighbour link, the small-displacement and
  too-fast gates, the loop-closure transform by signature registration,
  proximity closures by time and by space (candidates within
  ``RGBD/LocalRadius`` clustered into paths, one batched registration
  dispatched early in the tick and collected after the appearance
  accept), graph optimization (the affected subgraph with
  ``Tpu/IncrementalOptimization``, else the connected component, dense
  LM) with the ``RGBD/OptimizeMaxError`` reject, graph repair after
  repeated rejections, and the pose statistics;
- with laser scans (``process(scan=LaserScan)``, the RGB-D + LiDAR robot):
  neighbour-link refining (``RGBD/NeighborLinkRefining``: each odometry
  link polished by scan ICP against the previous node's scan), the
  scan-ICP proximity fallback against the nearby nodes' scans assembled
  in the nearest node's frame when no visual proximity link was found,
  and in localization mode ``RGBD/ProximityGlobalScanMap``: the current
  scan registered against the whole map's scans. All three go through
  ``ops/icp.register_scans`` and so the K2 kernel. Scans are read in the
  node frame (``xyz()``; ``local_transform`` is not applied, as in the
  JAX twin);
- epipolar hypothesis verification (``VhEp/Enabled``: the shared unique
  words' fundamental-matrix RANSAC, gated by the twin's null model) and
  intermediate nodes (``Rtabmap/CreateIntermediateNodes``: a frame the
  ``Rtabmap/DetectionRate`` gate skips becomes a weight -1 node with no
  features, chained by odometry).

With a map store (``db``, a ``memory/db.Database``) every tick saves its
statistics row and, with ``Mem/BinDataKept``, the raw frame; ``close()``
checkpoints the resident signatures, the vocabulary, the optimized poses
and the parameters, and ``Rtabmap.load`` resumes from such a store: every
stored signature becomes an LTM record, the last session is paged into WM,
and ids and sessions continue. Localization mode (``Mem/IncrementalMemory``
false) keeps the loaded map frozen: a frame's closure links update the map
correction directly or, with ``RGBD/MaxOdomCacheSize``, after a check
against the rolling odometry cache (``_localize_with_odom_cache``), and
the loop threshold drops to ``RGBD/AggressiveLoopThr`` until a closure is
in the cache. ``set_initial_pose`` seeds the map correction.

The maintenance and query API works on a finished map (the store tools'
path, ``tools/cli.py``): ``detect_more_loop_closures`` (registrations
between nearby nodes, each accepted closure optimized and gated on its
own), ``refine_links``, ``reject_last_loop_closure``, ``add_user_link``,
``global_bundle_adjustment`` (tracks from shared word ids, two anchored
cameras; ``optim/ba.bundle_adjust_large`` past 600,000 cameras x tracks),
the getters, ``export_poses``, ``get_signature_copy`` and ``get_3d_map``;
labels and user data (``set_label``, ``set_user_data``, written through
to the store for a node in LTM), the map edits ``set_optimized_poses``,
``delete_last_location`` and ``reset_memory``, and the dumps
``generate_dot_graph``, ``dump_prediction`` and ``write_log_files``.

The topological planner (Rtabmap::computePath and updateGoalIndex):
``set_goal`` plans an A* path over the links to a node (``set_goal_pose``
to the nearest node of a pose), and every tick after it the retrieval
stage also pages the path's upcoming nodes back from LTM and the goal
tracking (``update_goal_index``) keeps the path chained by virtual links,
advances the current node and sub-goal, and ends the path when the goal
is reached (``path_status`` 1) or the robot is stuck (-1); the tick
reports ``Planning/Current goal id/``, ``Planning/Path length/`` and
``Planning/Status/``.

Raised as not yet ported, naming the slice that brings them: multi-device
meshes, landmarks and GPS priors.
"""
from __future__ import annotations

import os
import resource
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.bayes import filter as BF
from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.device import DeviceLike, resolve_device, to_numpy
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory.memory import (
    LINK_GLOBAL_CLOSURE, LINK_LANDMARK, LINK_LOCAL_SPACE_CLOSURE, LINK_LOCAL_TIME_CLOSURE,
    LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED, LINK_POSE_PRIOR, LINK_USER_CLOSURE,
    LINK_VIRTUAL_CLOSURE, Link, Memory, Signature,
)
from rtabmap_tpu_torch.optim import pose_graph as PG
from rtabmap_tpu_torch.utils.graph import PoseStore
from rtabmap_tpu_torch.utils.logging import Statistics, Timer, get_logger
from rtabmap_tpu_torch.utils.params import Parameters
from rtabmap_tpu_torch.vocab.dictionary import (
    adjust_likelihood, similarity_likelihood, tfidf_likelihood,
)

log = get_logger("engine")

CLOSURE_TYPES = (LINK_GLOBAL_CLOSURE, LINK_LOCAL_SPACE_CLOSURE, LINK_LOCAL_TIME_CLOSURE,
                 LINK_USER_CLOSURE)


def _appearance_step(word_ids, node_words, lik_valid, word_nw, n_resident,
                     nbr_idx, nbr_margin, wm_valid, posterior, kernel, vp_prior,
                     use_tfidf: bool):
    """Likelihood -> Angeli adjustment -> Bayes recursion -> hypothesis
    argmax, all on the device; returns (post, adj, best_slot, best_post,
    vp) as device tensors."""
    if use_tfidf:
        lik = tfidf_likelihood(word_ids, node_words, lik_valid, word_nw,
                               n_resident, word_nw.shape[0])
    else:
        lik = similarity_likelihood(word_ids, node_words, lik_valid)
    adj, virt = adjust_likelihood(lik, lik_valid)
    post = BF._predict_and_update(posterior, adj, virt, nbr_idx, nbr_margin,
                                  wm_valid, kernel, vp_prior)
    best_slot = torch.argmax(post[:-1])
    return post, adj, best_slot, post[best_slot], post[-1]


def info_from_cov(cov: np.ndarray, min_var: float = 1e-6, max_var: float = 1e4) -> np.ndarray:
    """Robust 6x6 information from covariance: symmetrize + eigenvalue clip."""
    c = np.asarray(cov, np.float64)
    c = 0.5 * (c + c.T)
    if not np.isfinite(c).all():
        return np.eye(6) * (1.0 / max_var)
    w, V = np.linalg.eigh(c)
    w = np.clip(w, min_var, max_var)
    return (V @ np.diag(1.0 / w) @ V.T).astype(np.float32)


def _not_ported(what: str, slice_: str):
    return NotImplementedError(f"{what} is not ported yet; it comes with {slice_}")


def _relative32(a, b) -> np.ndarray:
    """inverse(a) o b of two (3,4) host poses in float32 (the twin's jnp
    arithmetic)."""
    return T.relative(torch.as_tensor(np.asarray(a, np.float32)),
                      torch.as_tensor(np.asarray(b, np.float32))).numpy()


def _compose32(a, b) -> np.ndarray:
    return T.compose(torch.as_tensor(np.asarray(a, np.float32)),
                     torch.as_tensor(np.asarray(b, np.float32))).numpy()


def _pad_pow2(n: int, floor: int) -> int:
    return max(1 << max(n - 1, 1).bit_length(), floor)


class Rtabmap:
    """RTAB-Map engine on ``device`` (None = the CUDA card)."""

    def __init__(self, cam: C.CameraModel, params: Optional[Parameters] = None,
                 db=None, node_capacity: int = 1024, words_per_frame: int = 512,
                 seed: int = 42, mesh=None, device: DeviceLike = None):
        p = params or Parameters()
        if mesh is not None:
            raise _not_ported("a multi-device mesh", "the multi-chip slice")
        self.device = resolve_device(device)
        self.params = p
        self.cam = cam
        self.memory = Memory(p, node_capacity=node_capacity,
                             words_per_frame=words_per_frame, db=db, device=self.device)
        self.bayes = BF.BayesFilter(
            node_capacity,
            prediction_lc=[float(x) for x in str(p["Bayes/PredictionLC"]).split()],
            virtual_place_prior=float(p["Bayes/VirtualPlacePriorThr"]),
            device=self.device)
        self.loop_thr = float(p["Rtabmap/LoopThr"])
        self.loop_ratio = float(p["Rtabmap/LoopRatio"])
        # epipolar hypothesis verification (VhEp/*, EpipolarGeometry::check)
        self.vh_ep_enabled = bool(p["VhEp/Enabled"])
        self.vh_ep_match_count_min = int(p["VhEp/MatchCountMin"])
        self.vh_ep_ransac_param1 = float(p["VhEp/RansacParam1"])
        self.max_error = float(p["RGBD/OptimizeMaxError"])
        self.local_radius = float(p["RGBD/LocalRadius"])
        self.prox_max_paths = int(p["RGBD/ProximityMaxPaths"])
        self.prox_max_graph_depth = int(p["RGBD/ProximityMaxGraphDepth"])
        self.prox_filtering_radius = float(p["RGBD/ProximityPathFilteringRadius"])
        self.prox_odom_guess = bool(p["RGBD/ProximityOdomGuess"])
        self.max_loop_closure_distance = float(p["RGBD/MaxLoopClosureDistance"])
        self.proximity_by_time = bool(p["RGBD/ProximityByTime"])
        self.prox_merged_scan_cov_factor = float(p["RGBD/ProximityMergedScanCovFactor"])
        self.prox_global_scan_map = bool(p["RGBD/ProximityGlobalScanMap"])
        self._global_scan_cache = None  # (scan nodes when built, points, mask)
        self.neighbor_link_refining = bool(p["RGBD/NeighborLinkRefining"])
        self.time_thr = float(p["Rtabmap/TimeThr"])        # ms, 0 = off
        self.memory_thr = int(p["Rtabmap/MemoryThr"])      # nodes, 0 = off
        self.min_inliers = int(p["Vis/MinInliers"])
        self.optimizer_robust = bool(p["Optimizer/Robust"])
        self.optimizer_iterations = int(p["Optimizer/Iterations"])
        self.optimizer_epsilon = float(p["Optimizer/Epsilon"])
        self.optimize_from_graph_end = bool(p["RGBD/OptimizeFromGraphEnd"])
        self.incremental_optimization = bool(p["Tpu/IncrementalOptimization"])
        self.full_solve_every = int(p["Tpu/FullSolveEvery"])
        self.priors_ignored = bool(p["Optimizer/PriorsIgnored"])
        self._closures_since_full = 0
        self.rgbd_mode = bool(p["RGBD/Enabled"])
        self.detection_rate = float(p["Rtabmap/DetectionRate"])
        self.create_intermediate_nodes = bool(p["Rtabmap/CreateIntermediateNodes"])
        self.linear_update = float(p["RGBD/LinearUpdate"])
        self.angular_update = float(p["RGBD/AngularUpdate"])
        self.linear_speed_update = float(p["RGBD/LinearSpeedUpdate"])
        self.angular_speed_update = float(p["RGBD/AngularSpeedUpdate"])
        self.bin_data_kept = bool(p["Mem/BinDataKept"])
        self.retrieval_margin = 2  # graph-depth margin around the hypothesis

        # localization mode: the rolling odometry cache that verifies
        # localization links (reference: _odomCachePoses/_odomCacheConstraints,
        # RGBD/MaxOdomCacheSize)
        self.max_odom_cache_size = int(p["RGBD/MaxOdomCacheSize"])
        self.localization_smoothing = bool(p["RGBD/LocalizationSmoothing"])
        prior_err = max(float(p["RGBD/LocalizationPriorError"]), 1e-6)
        self.localization_prior_inf = 1.0 / (prior_err * prior_err)
        self.aggressive_loop_thr = float(p["RGBD/AggressiveLoopThr"])
        self._odom_cache_poses: Dict[int, np.ndarray] = {}   # id -> odometry pose
        self._odom_cache_links: Dict[Tuple[int, int], Link] = {}
        self._pending_initial_pose: Optional[np.ndarray] = None

        self.optimized_poses: Dict[int, np.ndarray] = PoseStore()
        self.map_correction = np.eye(3, 4, dtype=np.float32)
        self.last_hypothesis: Tuple[int, float] = (0, 0.0)
        self.loop_closure_id = 0
        self._last_process_stamp = -1e9
        self._last_pose: Optional[np.ndarray] = None
        self._distance_travelled: float = 0.0
        self._distance_at_last_loc: float = 0.0
        self._new_session_rebase = False
        self._last_localization_pose: Optional[np.ndarray] = None
        self._last_likelihood: Optional[np.ndarray] = None
        self._last_closest_node = None
        self._last_prox_path_stats = (0, 0)
        self._last_prox_counts: Optional[Tuple[int, int]] = None  # (visual, scan)
        self._last_scan_paths_checked = 0
        # registrations against the global scan map (localization mode)
        self.global_scan_calls = 0
        self._consecutive_rejections = 0
        # RANSAC draws of every registration the engine makes (a CPU
        # generator: the same samples on the CPU and on the card)
        self.generator = torch.Generator().manual_seed(seed)
        self.stats_history: List[Statistics] = []
        # (padded nodes, LM iterations, host ms) of every graph solve
        self.solves: List[Tuple[int, int, float]] = []
        # the last global_bundle_adjustment's problem, path and costs
        self.global_ba_stats: Optional[Dict] = None

        # the topological planner's goal tracking (reference:
        # Rtabmap::computePath and updateGoalIndex)
        self.goal_reached_radius = float(p["RGBD/GoalReachedRadius"])
        self.plan_stuck_iterations = int(p["RGBD/PlanStuckIterations"])
        self._path: List[Tuple[int, np.ndarray]] = []  # (node id, pose when planned)
        self._path_current_index = 0
        self._path_goal_index = 0
        self._path_transform_to_goal = np.eye(3, 4, dtype=np.float32)
        self._path_unreachable: set = set()
        self._path_stuck_count = 0
        self._path_stuck_dist = 0.0
        self.path_status = 0  # 0 idle or cleared, 1 goal reached, -1 aborted

    @classmethod
    def load(cls, db, cam: C.CameraModel, params: Optional[Parameters] = None,
             node_capacity: int = 1024, words_per_frame: int = 512,
             new_session: bool = True, **kw) -> "Rtabmap":
        """Resume from a map store (reference: Rtabmap::init on an existing
        database, Memory::loadDataFromDb): the vocabulary from the admin
        row, every stored signature as an LTM record, the last session
        paged into WM, ids continued, a new session unless
        ``new_session`` is false, the optimized poses restored. ``kw``
        goes to the constructor (``device``, ``seed``)."""
        from rtabmap_tpu_torch.vocab.dictionary import VWDictionary

        admin = db.load_admin()
        slam = cls(cam, params, db=db, node_capacity=node_capacity,
                   words_per_frame=words_per_frame, **kw)
        mem = slam.memory
        if admin["vocab"] is not None:
            v = admin["vocab"]
            slab = np.zeros((v["capacity"], v["slab"].shape[1]), np.int8)
            slab[: v["n_words"]] = v["slab"]
            valid = np.arange(v["capacity"]) < v["n_words"]
            mem.vocab = VWDictionary.from_state(
                {"slab": slab, "word_valid": valid, "n_words": v["n_words"],
                 "nndr": v["nndr"], "incremental": v["incremental"]}, device=slam.device)
            mem.word_nw = torch.zeros((mem.vocab.capacity,), dtype=torch.float32,
                                      device=slam.device)
        last_map = db.max_map_id()
        for sid in db.all_node_ids():
            sig = db.load_signature(sid)
            if sig is not None:
                mem.signatures[sid] = sig
        last_ids = sorted(i for i, s in mem.signatures.items() if s.map_id == last_map)
        budget = mem.node_capacity - mem.stm_size - 2
        for sig in mem.signatures.values():
            if sig.scan is not None:
                sig.scan = sig.scan.to(slam.device)
        for sid in last_ids[-budget:]:
            sig = mem.signatures[sid]
            sig.in_ltm = False
            mem._insert_slab(sig)
            mem._wm_append(sid)
        mem._next_id = db.max_node_id() + 1
        mem._map_id = last_map + 1 if new_session else last_map
        slam.optimized_poses.update(admin["optimized_poses"])
        return slam

    def close(self, map2d=None, opt_cloud=None, opt_mesh=None):
        """Checkpoint the map into the store (reference: Memory::close and
        saveOptimizedPoses): the WM and STM signatures, the parameters
        with the camera under ``__camera__`` (fx, fy, cx, cy, width,
        height; the store tools' ``reprocess`` reads it), the optimized
        poses, the vocabulary and any derived products given; then wait
        for the writes."""
        db = self.memory.db
        if db is None:
            return
        for i in list(self.memory.wm) + list(self.memory.stm):
            db.save_signature(self.memory.get(i))
        c = self.cam
        params = {**self.params.overrides(),
                  "__camera__": [c.fx, c.fy, c.cx, c.cy, c.width, c.height]}
        db.save_admin(params=params, optimized_poses=self.optimized_poses,
                      vocab=self.memory.vocab, map2d=map2d, opt_cloud=opt_cloud,
                      opt_mesh=opt_mesh)
        db.flush()

    def set_initial_pose(self, pose) -> None:
        """Seed the map correction: the next processed frame is placed at
        ``pose`` in the map frame (reference: Rtabmap::setInitialPose)."""
        self._pending_initial_pose = np.asarray(pose, np.float32)

    def trigger_new_map(self):
        """(reference: Rtabmap::triggerNewMap) clear the optimized-pose cache
        and start a new session, re-based at the last known map pose."""
        last = self.get_last_location_id()
        self._last_localization_pose = (
            np.asarray(self.optimized_poses[last])
            if last and last in self.optimized_poses else None)
        self.memory.new_map()
        self.bayes.reset()
        self.last_hypothesis = (0, 0.0)
        self._odom_cache_poses.clear()
        self._odom_cache_links.clear()
        if self.memory.incremental:
            self.optimized_poses.clear()
            self.map_correction = np.eye(3, 4, dtype=np.float32)
            self._new_session_rebase = True

    # ---------------------------------------------------------------- process
    def process(self, frame: FrameFeatures, odom_pose, covariance=None,
                stamp: float = 0.0, scan=None, user_data: Optional[bytes] = None,
                grid=None, env_sensors=None, global_desc=None, gt_pose=None,
                velocity=None, gps=None, landmarks=None, raw=None, descf=None,
                extra_stats: Optional[Dict[str, float]] = None) -> Statistics:
        if landmarks is not None:
            raise _not_ported("process() with landmarks", "a later slice")
        st = Statistics()
        if extra_stats:
            for k, v in extra_stats.items():
                st.add(k, v)
        timer = Timer()
        odom_pose = np.asarray(odom_pose, np.float32)
        cov = np.asarray(covariance) if covariance is not None else np.eye(6) * 1e-4

        # --- detection-rate gate
        if self.detection_rate > 0 and stamp > 0:
            if stamp - self._last_process_stamp < 1.0 / self.detection_rate - 1e-6:
                # with Rtabmap/CreateIntermediateNodes the skipped frame
                # stays in the odometry chain as a weight -1 node
                if self.create_intermediate_nodes and self.rgbd_mode:
                    self._add_intermediate_node(frame, odom_pose, cov, stamp, st)
                st.add("Rtabmap/Skipped", 1)
                return st
        self._last_process_stamp = stamp

        # --- odometry failure -> new session (covariance >= 9999 convention)
        if cov[0, 0] >= 9999.0 and self.memory.n_resident > 0:
            self.trigger_new_map()
        if self._new_session_rebase:
            if self._last_localization_pose is not None:
                self.map_correction = np.asarray(T.np_compose(
                    self._last_localization_pose, T.np_inverse(odom_pose)), np.float32)
            self._new_session_rebase = False
        if self._pending_initial_pose is not None:
            self.map_correction = np.asarray(T.np_compose(
                self._pending_initial_pose, T.np_inverse(odom_pose)), np.float32)
            self._pending_initial_pose = None
        mc_before = np.asarray(self.map_correction).copy()
        n_sigs_before = len(self.memory.signatures)

        # --- B. memory update
        with st.time_stage("Timing/Memory update/ms"):
            prev_id = self.memory.stm[-1] if self.memory.stm else None
            with st.time_stage("TimingMem/Signature creation/ms"):
                sig = self.memory.create_signature(frame, odom_pose, stamp, deferred=True)
            for k, v in self.memory.last_create_timings.items():
                st.add(k, v)
            st.add("TimingMem/Pre update/ms", 0.0)
            st.add("TimingMem/Joining dictionary update/ms", 0.0)
            sig.scan = None if scan is None else scan.to(self.device)
            sig.user_data = user_data
            sig.grid = grid
            if env_sensors:
                sig.env_sensors = list(env_sensors)
            if global_desc is not None:
                sig.global_desc = np.asarray(global_desc)
            if gt_pose is not None:
                sig.gt_pose = np.asarray(gt_pose, np.float32)
            if velocity is not None:
                sig.velocity = np.asarray(velocity, np.float32)
            if gps is not None:
                sig.gps = np.asarray(gps, np.float64)  # geodetic degrees: f64
            if raw is not None and self.memory.cor_type == 1:
                # optical-flow correspondences (Vis/CorType 1) need the pixels
                sig.image = to_numpy(raw[0])
            if descf is not None and self.memory.cor_nn_type == 6:
                # the matcher (Vis/CorNNType 6) needs the float descriptors
                sig.descf = to_numpy(descf).astype(np.float32)
            if raw is not None and self.bin_data_kept and self.memory.db is not None:
                # raw sensor data kept with the node (Mem/BinDataKept), copied
                # to the host here, compressed on the store's writer thread
                with st.time_stage("TimingMem/Compressing data/ms"):
                    self.memory.db.save_raw_frame(
                        sig.id, map_id=sig.map_id, stamp=stamp, pose=odom_pose,
                        image=to_numpy(raw[0]), depth=to_numpy(raw[1]))
            neighbor_link = None
            prev = self.memory.get(prev_id) if prev_id is not None else None
            if prev is not None and prev.map_id != sig.map_id:
                prev = None  # never chain odometry across a session break
            if prev is not None:
                t_ab = np.asarray(T.np_relative(prev.pose, odom_pose), np.float32)
                link_cov = cov
                if (self.neighbor_link_refining and sig.scan is not None
                        and prev.scan is not None):
                    t_ab, link_cov = self._refine_neighbor_link(sig.scan, prev.scan, t_ab,
                                                                cov, st)
                neighbor_link = Link(prev_id, sig.id, LINK_NEIGHBOR, t_ab,
                                     info_from_cov(link_cov))
            self.memory.add_to_stm(sig, neighbor_link)

        # --- C. metric gates: small displacement and too-fast movement
        # (before the appearance dispatch: they depend on poses only)
        small_displacement = False
        if self._last_pose is not None:
            d = T.np_relative(self._last_pose, odom_pose)
            lin = T.np_translation_norm(d)
            self._distance_travelled += lin
            if (self.rgbd_mode and self.linear_update > 0 and lin < self.linear_update
                    and self.angular_update > 0
                    and T.np_rotation_angle(d) < self.angular_update):
                small_displacement = True
        self._last_pose = odom_pose
        too_fast = False
        if velocity is not None and self.rgbd_mode:
            v = np.asarray(velocity, np.float64).ravel()
            lin_s = float(np.linalg.norm(v[:3]))
            ang_s = float(np.linalg.norm(v[3:6])) if v.size >= 6 else 0.0
            too_fast = ((self.linear_speed_update > 0 and lin_s > self.linear_speed_update)
                        or (self.angular_speed_update > 0
                            and ang_s > self.angular_speed_update))
        st.add("Memory/Fast movement/", float(too_fast))
        st.add("Memory/Small movement/", float(small_displacement))
        st.add("Memory/Distance travelled/m", self._distance_travelled)
        st.add("Loop/Distance since last loc/m",
               self._distance_travelled - self._distance_at_last_loc)
        st.add("Memory/Odometry variance lin/", float(cov[0, 0]))
        st.add("Memory/Odometry variance ang/", float(cov[5, 5]))

        # --- D0. appearance dispatch (enqueued before the create's fetch)
        wm_ids = list(self.memory.wm)
        app = None
        if wm_ids and not small_displacement and not too_fast:
            with st.time_stage("Timing/Posterior computation/ms"):
                app = self._dispatch_appearance(sig)

        # --- F0. proximity registration dispatch: the batched registration
        # and its copy to the host run while the host waits on the create's
        # fetch and the appearance accept (path ranking uses the last
        # tick's likelihood; nodes retrieved this tick join next tick)
        prox_ctx = None
        if (self.rgbd_mode and not small_displacement and self.local_radius > 0
                and self.memory.n_resident > 1):
            with st.time_stage("Timing/Proximity dispatch/ms"):
                prox_ctx = self._proximity_dispatch(sig, st)

        with st.time_stage("TimingMem/Signature finalize/ms"):
            self.memory.finalize_signature()
        if sig.valid3d is not None:
            st.add("Memory/Triangulated points/", float(np.sum(np.asarray(sig.valid3d))))

        with st.time_stage("TimingMem/Rehearsal/ms"):
            merged_id = self.memory.rehearsal(sig)
        if merged_id and merged_id != sig.id:
            # the current node merged away: continue on the survivor
            self.optimized_poses.pop(sig.id, None)
            sig = self.memory.get(merged_id)
            if app is not None:
                app = self._dispatch_appearance(sig)
            prox_ctx = None   # stale B side: re-run synchronously below
        st.add("Memory/RehearsalMerged", float(merged_id))

        # --- B2. localization mode: the rolling odometry cache (poses and
        # neighbour constraints the localization links are checked against)
        if not self.memory.incremental and self.max_odom_cache_size > 0:
            if self._odom_cache_poses:
                last_id = next(reversed(self._odom_cache_poses))
                t_oc = np.asarray(T.np_relative(self._odom_cache_poses[last_id], odom_pose),
                                  np.float32)
                self._odom_cache_links[(last_id, sig.id)] = Link(
                    last_id, sig.id, LINK_NEIGHBOR, t_oc, info_from_cov(cov))
            self._odom_cache_poses[sig.id] = odom_pose
            with st.time_stage("Timing/Cleaning neighbors/ms"):
                while len(self._odom_cache_poses) > self.max_odom_cache_size:
                    old = next(iter(self._odom_cache_poses))
                    del self._odom_cache_poses[old]
                    self._odom_cache_links = {k: v for k, v in self._odom_cache_links.items()
                                              if old not in k}

        # --- D. appearance hypothesis accept
        bad_sig = (self.memory.bad_signatures_ignored and
                   self.memory.is_bad_signature(sig))
        hypothesis_id, hypothesis_value = 0, 0.0
        if app is not None and not bad_sig:
            with st.time_stage("Timing/Likelihood computation/ms"):
                post, adj, best_slot, best_post, vp = app
                self.bayes.state = BF.BayesState(posterior=post)
                # one fetch: the three scalars and the likelihood row
                # (kept for proximity path ranking)
                host = torch.cat([torch.stack([best_slot.float(), best_post, vp]),
                                  adj.float()]).cpu().numpy()
                slot_f, best_post, vp = (float(x) for x in host[:3])
                self._last_likelihood = host[3:]
            sid = int(self.memory._slot_to_id[int(slot_f)])
            if sid > 0 and best_post > 0:
                # value = 1 - P(virtual place)
                hypothesis_id, hypothesis_value = sid, float(1.0 - vp)
            st.add("Loop/Highest hypothesis id/", hypothesis_id)
            st.add("Loop/Highest hypothesis value/", hypothesis_value)
            st.add("Loop/Vp hypothesis/", float(vp))

        # --- accept rules (reference order: single hypothesis -> loop ratio)
        _t_hyp = time.perf_counter()
        loop_thr = self.loop_thr
        if (not self.memory.incremental and self.rgbd_mode
                and loop_thr > self.aggressive_loop_thr
                and not any(lk.type in (LINK_GLOBAL_CLOSURE, LINK_LOCAL_SPACE_CLOSURE,
                                        LINK_LANDMARK)
                            for lk in self._odom_cache_links.values())):
            # not localized on the map yet: loop aggressively on it
            loop_thr = self.aggressive_loop_thr
        accepted_id = 0
        if hypothesis_id > 0 and hypothesis_value >= loop_thr:
            if len(wm_ids) <= 1:
                log.debug("rejected hypothesis: single hypothesis")
            elif (self.vh_ep_enabled
                  and not self._verify_hypothesis_ep(sig, hypothesis_id, st)):
                log.debug("rejected hypothesis: by epipolar geometry")
            elif (self.loop_ratio > 0 and
                  (self.last_hypothesis[1] == 0.0 or
                   hypothesis_value < self.loop_ratio * self.last_hypothesis[1])):
                log.debug("rejected hypothesis: loop ratio")
                st.add("Loop/Suppressed hypothesis id/", hypothesis_id)
            else:
                accepted_id = hypothesis_id
        st.add("Timing/Hypotheses creation/ms", (time.perf_counter() - _t_hyp) * 1000.0)
        st.add("Loop/Accepted hypothesis id/", accepted_id)
        st.add("Loop/RejectedHypothesis/",
               float(hypothesis_id > 0 and hypothesis_value >= loop_thr and accepted_id == 0))
        if self.last_hypothesis[1] > 0:
            st.add("Loop/Hypothesis ratio/", hypothesis_value / self.last_hypothesis[1])
        self.last_hypothesis = (hypothesis_id, hypothesis_value)

        # --- E. retrieval: page the hypothesis neighbourhood back from LTM,
        # and the planned path's upcoming nodes
        if hypothesis_id > 0 or self._path:
            with st.time_stage("Timing/Retrieval/ms"):
                near = (self._graph_neighborhood(hypothesis_id, self.retrieval_margin)
                        if hypothesis_id > 0 else [])
                near += [i for i, _ in self._path[self._path_current_index:
                                                  self._path_goal_index + 3]]
                ltm_ids = [i for i in dict.fromkeys(near)
                           if (s := self.memory.get(i)) is not None and s.in_ltm]
                st.add("Loop/Reactivate id/", ltm_ids[0] if ltm_ids else 0)
                if ltm_ids:
                    if self.memory.db is not None:
                        # the store's pending writes land before nodes are read back
                        with st.time_stage("Timing/Joining trash/ms"):
                            self.memory.db.flush()
                    with st.time_stage("Timing/Reactivation/ms"):
                        got = self.memory.retrieve(ltm_ids)
                    st.add("Memory/Retrieved/", len(got))
                    st.add("Memory/Signatures retrieved/", len(got))
                    st.add("Loop/Hypothesis reactivated/", float(hypothesis_id in got))

        # --- G. loop-closure link
        links_added: List[Link] = []
        if accepted_id > 0 and not self.rgbd_mode:
            # appearance-only: the hypothesis IS the loop closure
            self.loop_closure_id = accepted_id
            self.memory.add_link(Link(accepted_id, sig.id, LINK_GLOBAL_CLOSURE,
                                      np.eye(3, 4, dtype=np.float32),
                                      np.eye(6, dtype=np.float32)))
        elif accepted_id > 0:
            with st.time_stage("Timing/Add loop closure link/ms"):
                t_ab, lc_cov, inliers = self.memory.compute_transform(
                    accepted_id, sig.id, self.cam, self.generator,
                    min_inliers=self.min_inliers)
                st.add("Loop/Visual inliers/", inliers)
                reg = self.memory.last_registration
                st.add("Loop/Visual matches/", reg.get("matches", 0))
                st.add("Loop/Visual inliers ratio/", reg.get("inliers_ratio", 0.0))
                st.add("Loop/Visual variance/", reg.get("variance", 0.0))
                st.add("Loop/Visual inliers mean dist/m", reg.get("mean_dist", 0.0))
                st.add("Loop/Visual inliers distribution/", reg.get("distribution", 0.0))
                st.add("Loop/Linear variance/", reg.get("lin_variance", 0.0))
                st.add("Loop/Angular variance/", reg.get("ang_variance", 0.0))
                st.add("Loop/Visual words/", int(np.sum(np.asarray(sig.word_ids) >= 0)))
                if t_ab is not None:
                    lk = Link(accepted_id, sig.id, LINK_GLOBAL_CLOSURE, t_ab,
                              info_from_cov(lc_cov))
                    self.memory.add_link(lk)
                    links_added.append(lk)
                    self.loop_closure_id = accepted_id
                else:
                    accepted_id = 0

        # --- C2. proximity by time: register against resident STM nodes of
        # older sessions
        if self.rgbd_mode and self.proximity_by_time:
            with st.time_stage("Timing/Proximity by time/ms"):
                n_time = 0
                for old_id in list(self.memory.stm)[:-1]:
                    old = self.memory.get(old_id)
                    if old is None or old.map_id == sig.map_id:
                        continue
                    t_ab, pcov, _inl = self.memory.compute_transform(
                        old_id, sig.id, self.cam, self.generator,
                        min_inliers=self.min_inliers)
                    if t_ab is not None:
                        lk = Link(old_id, sig.id, LINK_LOCAL_TIME_CLOSURE, t_ab,
                                  info_from_cov(pcov))
                        self.memory.add_link(lk)
                        links_added.append(lk)
                        n_time += 1
                st.add("Proximity/Time links added/", n_time)
                st.add("Proximity/Time detections/", n_time)

        # --- F. proximity by space: collect the early dispatch, or run it
        # now when the rehearsal invalidated it
        if self.rgbd_mode and not small_displacement and self.local_radius > 0:
            with st.time_stage("Timing/Proximity by space/ms"):
                if prox_ctx is not None:
                    prox_links = self._proximity_collect(sig, prox_ctx, st)
                else:
                    prox_links = self._proximity_detection(sig, st)
                links_added.extend(prox_links)
                st.add("Proximity/Space links added/", len(prox_links))
                n_paths, n_checked = self._last_prox_path_stats
                st.add("Proximity/Space paths/", n_paths)
                st.add("Proximity/Space visual paths checked/", n_checked)
                n_vis, n_icp = (self._last_prox_counts if self._last_prox_counts is not None
                                else (len(prox_links), 0))
                st.add("Proximity/Space detections added visually/", n_vis)
                st.add("Proximity/Space detections added icp multi/", n_icp)
                if prox_links:
                    st.add("Proximity/Space last detection id/", prox_links[-1].from_id)
                if self._last_closest_node is not None:
                    st.add("Memory/Closest node distance/m", self._last_closest_node[0])
                    st.add("Memory/Closest node angle/rad", self._last_closest_node[1])

        # --- I. graph optimization (+ max-error reject gate), or in
        # localization mode the map correction from this frame's link
        if not self.memory.incremental:
            accepted_id = self._localize(st, sig, odom_pose, links_added, accepted_id)
        elif self.rgbd_mode:
            with st.time_stage("Timing/Map optimization/ms"):
                self._optimize(st, links_added)
        else:
            self.optimized_poses[sig.id] = odom_pose

        # repeated rejections mean an OLD wrong closure pins the graph:
        # delete the worst old closure links
        if st.get("Loop/Rejected by optimization/") > 0:
            self._consecutive_rejections += 1
            if self.memory.incremental and self._consecutive_rejections >= 2:
                removed = self.repair_graph(max_removals=2)
                st.add("Loop/Optimization max error removed count/", len(removed))
                if removed:
                    st.add("Loop/Optimization max error removed from id/", removed[0][0])
                    st.add("Loop/Optimization max error removed to id/", removed[0][1])
                self._consecutive_rejections = 0
        elif accepted_id > 0 or st.get("Loop/Localized/") > 0:
            self._consecutive_rejections = 0

        # --- H2. goal tracking on the planned path
        if self._path:
            with st.time_stage("Timing/Path planning/ms"):
                self.update_goal_index()
                st.add("Planning/Current goal id/", self.get_path_current_goal())
                st.add("Planning/Path length/", len(self.get_path()))
                st.add("Planning/Status/", self.path_status)

        # --- K. transfer (WM -> LTM)
        with st.time_stage("Timing/Memory cleanup/ms"):
            with st.time_stage("Timing/Forgetting/ms"):
                self._transfer(st, timer.elapsed() * 1000.0)

        # --- J/L statistics
        st.ref_id = sig.id
        st.loop_closure_id = self.loop_closure_id if accepted_id else 0
        if self.rgbd_mode:
            with st.time_stage("Timing/Statistics creation/ms"):
                self._pose_statistics(st, sig, mc_before)
        mem = self.memory
        st.add("Memory/Signatures removed/",
               max(n_sigs_before + 1 - len(mem.signatures), 0))
        if not mem.incremental:
            st.add("Memory/Odom cache poses/", len(self._odom_cache_poses))
            st.add("Memory/Odom cache links/", len(self._odom_cache_links))
        _t_fin = time.perf_counter()
        st.add("Memory/Working memory size/", len(mem.wm))
        st.add("Memory/Short time memory size/", len(mem.stm))
        st.add("Memory/Short time memory inter size/",
               sum(1 for i in mem.stm if (s := mem.get(i)) is not None and s.weight < 0))
        st.add("Memory/Working memory inter size/", mem.n_inter_wm)
        st.add("Proximity/Space scan paths checked/", self._last_scan_paths_checked)
        if accepted_id > 0 or st.get("Loop/Localized/") > 0:
            # localization covariance summary (MapToBase lin var/std); the
            # appearance-only closure has no registration: zero variance
            lin_var = (mem.last_registration.get("lin_variance", 0.0)
                       if self.rgbd_mode else 0.0)
            st.add("Loop/MapToBase lin var/m2", lin_var)
            st.add("Loop/MapToBase lin std/m", float(np.sqrt(max(lin_var, 0.0))))
        st.add("Memory/Local graph size/", mem.n_resident)
        st.add("Memory/Rehearsal sim/", mem.last_rehearsal_sim)
        st.add("Memory/Rehearsal id/", mem.last_rehearsal_id)
        st.add("Memory/Rehearsal merged/", st.get("Memory/RehearsalMerged"))
        st.add("Keypoint/Dictionary size/words", mem.vocab.n_words)
        st.add("Keypoint/Index memory usage/KB", mem.vocab.slab.numel() // 1024)
        st.add("Keypoint/Current frame/words", int(np.sum(np.asarray(sig.word_ids) >= 0)))
        st.add("Keypoint/Indexed words/words", mem.vocab.n_words)
        st.add("Loop/Id/", accepted_id)
        st.add("Loop/Map id/", sig.map_id)
        st.add("Loop/Last id/", self.loop_closure_id)
        if (accepted_id > 0 or st.get("Loop/Localized/") > 0
                or st.get("Proximity/Space links added/") > 0):
            # a (re)localization event resets the odometer
            self._distance_at_last_loc = self._distance_travelled
        if mem.db is not None and os.path.exists(mem.db.path):
            st.add("Memory/Database memory used/MB", os.path.getsize(mem.db.path) / 1e6)
        with st.time_stage("Timing/RAM estimation/ms"):
            st.add("Memory/RAM usage/MB",
                   resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0)
            slab_bytes = (mem.node_words.numel() * 4 + mem.node_uv.numel() * 4
                          + mem.node_pts.numel() * 4 + mem.node_valid.numel()
                          + mem.word_nw.numel() * 4
                          + mem.vocab.slab.numel() + mem.vocab.word_valid.numel())
            sig_bytes = len(mem.signatures) * mem.K * (mem.vocab.slab.shape[1]
                                                       + 4 + 8 + 12 + 1)
            st.add("Memory/RAM estimated/MB", (slab_bytes + sig_bytes) / 1e6)
        if "Memory/Images buffered/" not in st.data:
            st.add("Memory/Images buffered/", 0)
        st.add("Timing/Finalizing statistics/ms", (time.perf_counter() - _t_fin) * 1000.0)
        st.add("Timing/Total/ms", timer.elapsed() * 1000.0)
        self.stats_history.append(st)
        if mem.db is not None:
            # the tick's statistics row (DBDriver::addStatistics)
            mem.db.save_statistics(sig.id, stamp, st.data)
        return st

    def _add_intermediate_node(self, frame: FrameFeatures, odom_pose, cov, stamp: float,
                               st: Statistics):
        """A weight -1 node for a frame the detection rate skipped
        (reference: Rtabmap/CreateIntermediateNodes): it keeps the
        full-rate odometry chain in the graph with an empty feature set,
        out of rehearsal and the hypotheses."""
        mem = self.memory
        prev_id = mem.stm[-1] if mem.stm else None
        empty = FrameFeatures(*(torch.zeros_like(x) for x in frame))
        sig = mem.create_signature(empty, odom_pose, stamp, weight=-1)
        link = None
        prev = mem.get(prev_id) if prev_id is not None else None
        if prev is not None and prev.map_id == sig.map_id:
            t_ab = np.asarray(T.np_relative(prev.pose, odom_pose), np.float32)
            link = Link(prev_id, sig.id, LINK_NEIGHBOR, t_ab, info_from_cov(np.asarray(cov)))
        mem.add_to_stm(sig, link)
        self.optimized_poses[sig.id] = np.asarray(
            T.np_compose(self.map_correction, odom_pose), np.float32)
        st.ref_id = sig.id
        st.add("Memory/Short time memory inter size/",
               sum(1 for i in mem.stm if (s := mem.get(i)) is not None and s.weight < 0))
        st.add("Memory/Working memory inter size/", mem.n_inter_wm)

    def _refine_neighbor_link(self, scan, prev_scan, t_ab: np.ndarray, cov,
                              st: Statistics):
        """Neighbour-link refining (reference: RGBD/NeighborLinkRefining):
        the odometry link polished by scan ICP of this node's scan against
        the previous node's. One fetch brings the acceptance, the
        statistics and the refined link. Returns (link transform, link
        covariance)."""
        from rtabmap_tpu_torch.ops.icp import register_scans

        dev = self.device
        prev_scan = prev_scan.to(dev)
        with st.time_stage("Timing/Neighbor link refining/ms"):
            res, icp_cov = register_scans(
                scan.xyz(), scan.valid, prev_scan.xyz(), prev_scan.valid,
                guess=torch.as_tensor(t_ab, device=dev))
            # the scan's structural complexity (smallest over largest
            # eigenvalue of its points' covariance), summed in float64
            pv = scan.xyz().double()
            w = scan.valid.double()
            n_pts = w.sum()
            mu = (pv * w[:, None]).sum(0) / torch.clamp_min(n_pts, 1.0)
            X = (pv - mu) * w[:, None]
            scatter = X.T @ X
            host = torch.cat([
                torch.stack([res.valid.double(), res.correspondence_ratio.double(), n_pts]),
                scatter.reshape(-1), res.transform.double().reshape(-1),
                icp_cov.double().reshape(-1)]).cpu().numpy()
        accepted, ratio, n_pts = bool(host[0]), float(host[1]), float(host[2])
        st.add("NeighborLinkRefining/Accepted/", float(accepted))
        st.add("NeighborLinkRefining/ICP inliers ratio/", ratio)
        st.add("NeighborLinkRefining/Pts/", n_pts)
        st.add("NeighborLinkRefining/Inliers/", ratio * n_pts)
        if n_pts >= 10:
            w_eig = np.linalg.eigvalsh(host[3:12].reshape(3, 3))
            st.add("NeighborLinkRefining/ICP complexity/",
                   float(w_eig[0] / max(w_eig[-1], 1e-12)))
        else:
            st.add("NeighborLinkRefining/ICP complexity/", 0.0)
        if not accepted:
            return t_ab, cov
        # the refined link's deviation from the raw odometry
        t_ref = host[12:24].reshape(3, 4).astype(np.float32)
        link_cov = host[24:60].reshape(6, 6).astype(np.float32)
        dev_t = T.np_relative(np.asarray(t_ab, np.float32), t_ref)
        st.add("NeighborLinkRefining/ICP translation/m", float(T.np_translation_norm(dev_t)))
        st.add("NeighborLinkRefining/ICP rotation/rad", float(T.np_rotation_angle(dev_t)))
        st.add("NeighborLinkRefining/Variance/", float(np.max(np.diagonal(link_cov))))
        st.add("Odometry/Refined by scan/", 1)
        return t_ref, link_cov

    def _verify_hypothesis_ep(self, sig: Signature, hyp_id: int, st: Statistics) -> bool:
        """Epipolar verification of the loop hypothesis (reference:
        EpipolarGeometry::check): the unique shared words' correspondences,
        fundamental-matrix RANSAC, and the JAX twin's null-model gate in
        place of the reference's ``inliers >= VhEp/MatchCountMin``, which a
        RANSAC model fitting its own 8 samples always passes."""
        from rtabmap_tpu_torch.memory.memory import _shared_word_rows
        from rtabmap_tpu_torch.ops.epipolar import check_hypothesis

        with st.time_stage("Timing/Hypotheses validation/ms"):
            old = self.memory.get(hyp_id)
            if old is None or old.uv is None or sig.uv is None:
                return False
            mem = self.memory
            if (mem.cor_nn_type == 6 and old.descf is not None and sig.descf is not None
                    and mem._ensure_matcher() and mem.py_matcher is not None):
                # the learned stack: the bundled matcher's correspondences in
                # place of shared-word rows (binarized learned words are too
                # coarse for unique pairs)
                dev = self.device
                sc = torch.full((old.uv.shape[0],), 0.5, dtype=torch.float32, device=dev)
                idx, okm, _conf = mem.py_matcher.match(
                    old.descf, old.uv, sc, np.any(old.desc != 0, axis=1),
                    sig.descf, sig.uv, sc, np.any(sig.desc != 0, axis=1),
                    image_wh=(float(self.cam.width), float(self.cam.height)),
                    threshold=mem.pymatcher_threshold)
                okm = okm.cpu().numpy()
                ia = np.nonzero(okm)[0]
                ib = idx.cpu().numpy()[ia]
            else:
                ia, ib = _shared_word_rows(old.word_ids, sig.word_ids)
            st.add("Loop/Epipolar pairs/", len(ia))
            if len(ia) < self.vh_ep_match_count_min:
                return False
            # padded to the per-frame K, as the twin pads for one shape
            K = self.memory.K
            uv_a = np.zeros((K, 2), np.float32)
            uv_b = np.zeros((K, 2), np.float32)
            valid = np.zeros((K,), bool)
            n = min(len(ia), K)
            uv_a[:n] = old.uv[ia[:n]]
            uv_b[:n] = sig.uv[ib[:n]]
            valid[:n] = True
            dev = self.device
            _ok, _F, inl = check_hypothesis(
                torch.as_tensor(uv_a, device=dev), torch.as_tensor(uv_b, device=dev),
                torch.as_tensor(valid, device=dev), self.generator,
                min_pairs=self.vh_ep_match_count_min,
                threshold_px=self.vh_ep_ransac_param1, inlier_ratio=0.0)
            inliers = int(inl.sum())
            st.add("Loop/Epipolar inliers/", inliers)
            # a random point lies within RansacParam1 px of an epipolar line
            # with p ~ 2 thr diag / area; the best of the iterations lifts
            # the chance count to ~ mu + 3 sqrt(mu) + log(iters): clear the
            # 8 samples and that tail, and the reference's minimum
            p_chance = (2.0 * self.vh_ep_ransac_param1
                        * float(np.hypot(self.cam.width, self.cam.height))
                        / (float(self.cam.width) * float(self.cam.height)))
            mu = n * p_chance
            null_gate = int(np.ceil(8 + mu + 3.0 * np.sqrt(mu) + 5.0))
            return inliers >= max(self.vh_ep_match_count_min, null_gate)

    def _localize(self, st: Statistics, sig: Signature, odom_pose, links_added: List[Link],
                  accepted_id: int) -> int:
        """Localization mode's stage I: the first link added to this frame
        moves the map correction, checked against the odometry cache when
        it holds more than this frame; a link the cache contradicts is
        removed. A frame with no link, with RGBD/ProximityGlobalScanMap,
        registers its scan against the whole map's scans instead. Returns
        the accepted hypothesis id (0 once rejected)."""
        loc_link = links_added[0] if links_added else None
        if loc_link is None and self.prox_global_scan_map and sig.scan is not None:
            corrected = self._localize_global_scan(sig, odom_pose)
            if corrected is not None:
                self.map_correction = np.asarray(T.np_compose(
                    corrected, T.np_inverse(odom_pose)), np.float32)
                st.add("Loop/Localized/", 1)
                st.add("Proximity/Space detections added icp global/", 1)
        anchor = (self.optimized_poses.get(loc_link.from_id)
                  if loc_link is not None and loc_link.to_id == sig.id else None)
        if anchor is not None:
            if (self.max_odom_cache_size > 0 and len(self._odom_cache_poses) > 1
                    and sig.id in self._odom_cache_poses):
                with st.time_stage("Timing/Map optimization/ms"):
                    corrected = self._localize_with_odom_cache(
                        sig, [lk for lk in links_added if lk.to_id == sig.id], odom_pose, st)
                if corrected is not None:
                    self.map_correction = np.asarray(T.np_compose(
                        corrected, T.np_inverse(odom_pose)), np.float32)
                    st.add("Loop/Localized/", 1)
                else:
                    cleared = 0
                    for lk in links_added:
                        if lk.to_id == sig.id:
                            self.memory.remove_link(lk.from_id, lk.to_id)
                            cleared += 1
                    st.add("Loop/Rejected by optimization/", 1)
                    st.add("Loop/Proximity links cleared/", cleared)
                    self.loop_closure_id = 0
                    accepted_id = 0
            else:
                corrected = np.asarray(T.np_compose(anchor, loc_link.transform), np.float32)
                self.map_correction = np.asarray(T.np_compose(
                    corrected, T.np_inverse(odom_pose)), np.float32)
                st.add("Loop/Localized/", 1)
        self.optimized_poses[sig.id] = np.asarray(
            T.np_compose(self.map_correction, odom_pose), np.float32)
        return accepted_id

    def _localize_with_odom_cache(self, sig: Signature, loc_links: List[Link], odom_pose,
                                  st: Statistics) -> Optional[np.ndarray]:
        """Check and smooth a localization with the odometry cache
        (reference: Rtabmap.cpp's localization-mode cache optimization):
        optimize the cache poses with the map anchors held by priors of
        RGBD/LocalizationPriorError, and reject the localization when the
        worst edge-error ratio passes RGBD/OptimizeMaxError (the link would
        teleport the robot against its odometry). Returns the corrected
        map pose of the current node, or None to reject."""
        cache_ids = list(self._odom_cache_poses)
        id_set = set(cache_ids)
        cons: List[Link] = list(self._odom_cache_links.values()) + list(loc_links)
        anchors = sorted({e for lk in cons for e in (lk.from_id, lk.to_id)
                          if e not in id_set and e in self.optimized_poses})
        if not anchors:
            return None
        ids = anchors + cache_ids
        idx = {i: k for k, i in enumerate(ids)}
        mc = np.asarray(self.map_correction, np.float32)
        poses = np.stack([np.asarray(self.optimized_poses[i], np.float32) for i in anchors]
                         + [T.np_compose(mc, np.asarray(self._odom_cache_poses[i], np.float32))
                            for i in cache_ids]).astype(np.float32)
        ef, et, meas, info = [], [], [], []
        for lk in cons:
            if lk.from_id in idx and lk.to_id in idx:
                ef.append(idx[lk.from_id])
                et.append(idx[lk.to_id])
                meas.append(np.asarray(lk.transform, np.float32))
                info.append(np.asarray(lk.information, np.float32))
        if not ef:
            return None
        N, E, P = len(ids), len(ef), len(anchors)
        Np, Ep, Pp = (1 << max(n - 1, 1).bit_length() for n in (N, E, P))
        eye34 = np.eye(3, 4, dtype=np.float32)
        pad34 = lambda a, n: np.concatenate([a, np.tile(eye34, (n, 1, 1))])  # noqa: E731
        g = PG.make_graph(
            pad34(poses, Np - N), np.concatenate([ef, np.zeros(Ep - E, np.int64)]),
            np.concatenate([et, np.zeros(Ep - E, np.int64)]), pad34(np.stack(meas), Ep - E),
            np.concatenate([np.stack(info), np.tile(np.eye(6, dtype=np.float32), (Ep - E, 1, 1))]),
            node_valid=np.arange(Np) < N, edge_valid=np.arange(Ep) < E, root=0,
            priors_idx=np.concatenate([np.arange(P), np.zeros(Pp - P, np.int64)]),
            priors_meas=pad34(poses[:P], Pp - P),
            priors_info=np.concatenate([
                np.tile(np.eye(6, dtype=np.float32) * np.float32(self.localization_prior_inf),
                        (P, 1, 1)), np.zeros((Pp - P, 6, 6), np.float32)]),
            prior_valid=np.arange(Pp) < P, device=self.device)
        out, _chi2 = PG.optimize(g, iters=12)
        max_err = float(PG.solve_diagnostics(out)[0])
        st.add("Loop/Optimization max error ratio/", max_err)
        new_poses = out.poses.cpu().numpy()
        if not np.isfinite(new_poses[:N]).all() or not np.isfinite(max_err):
            return None
        if self.max_error > 0 and max_err > self.max_error:
            return None
        # accepted: the links join the cache, so later frames are checked
        # against them too; with RGBD/LocalizationSmoothing a link keeps
        # its optimized relative transform
        cur = new_poses[idx[sig.id]]
        for lk in loc_links:
            t = lk.transform
            if self.localization_smoothing:
                t = T.np_relative(new_poses[idx[lk.from_id]], cur)
            self._odom_cache_links[(lk.from_id, lk.to_id)] = Link(
                lk.from_id, lk.to_id, lk.type, t, lk.information)
        return cur

    def _pose_statistics(self, st: Statistics, sig: Signature, mc_before):
        """Odom-correction / MapToOdom / MapToBase / Gt/* statistics, host
        numpy throughout."""
        mc = self.map_correction

        def add6(prefix, pose):
            d6 = T.np_to_xyzrpy(pose)
            for k, name in enumerate(("x/m", "y/m", "z/m")):
                st.add(f"{prefix} {name}", float(d6[k]))
            for k, name in enumerate(("roll/deg", "pitch/deg", "yaw/deg")):
                st.add(f"{prefix} {name}", float(np.degrees(d6[3 + k])))

        delta = T.np_compose(mc, T.np_inverse(mc_before))
        st.add("Loop/Odom correction norm/m", T.np_translation_norm(delta))
        st.add("Loop/Odom correction angle/deg", float(np.degrees(T.np_rotation_angle(delta))))
        add6("Loop/Odom correction", delta)
        st.add("Loop/MapToOdom norm/m", T.np_translation_norm(mc))
        st.add("Loop/MapToOdom angle/deg", float(np.degrees(T.np_rotation_angle(mc))))
        add6("Loop/MapToOdom", mc)
        base = self.optimized_poses.get(sig.id)
        if base is not None:
            add6("Loop/MapToBase", base)
        if sig.gt_pose is not None:
            from rtabmap_tpu_torch.utils import metrics as MET

            est, gt = [], []
            for i in sorted(self.optimized_poses):
                s = self.memory.get(i)
                if s is None or s.gt_pose is None or i < 0:
                    continue
                est.append(np.asarray(self.optimized_poses[i]))
                gt.append(np.asarray(s.gt_pose))
            if len(est) >= 2:
                for k, v in MET.gt_error_stats(np.stack(est), np.stack(gt)).items():
                    st.add(k, v)

    def _dispatch_appearance(self, sig: Signature):
        """Host prep (STM mask, incremental neighbour table) + one device
        appearance step; returns device tensors without waiting."""
        mem = self.memory
        dev = self.device
        stm_slots = [mem.get(i).slot for i in mem.stm if mem.get(i).slot >= 0]
        lik_valid = mem.host_valid.copy()
        if stm_slots:
            lik_valid[stm_slots] = False
        depth = min(self.bayes.kernel.shape[0] - 2, 8)
        nbr_idx, nbr_margin = mem.ensure_neighbor_table(depth, 2 * depth + 1).flush()
        wid = (sig.pending_word_ids if sig.pending_word_ids is not None
               else torch.as_tensor(sig.word_ids, device=dev))
        return _appearance_step(
            wid, mem.node_words, torch.as_tensor(lik_valid, device=dev), mem.word_nw,
            float(mem.n_resident), torch.as_tensor(nbr_idx, device=dev),
            torch.as_tensor(nbr_margin, device=dev),
            torch.as_tensor(mem.host_wm, device=dev),
            self.bayes.posterior, self.bayes.kernel, self.bayes.vp_prior,
            use_tfidf=mem.tfidf_likelihood_used)

    # -------------------------------------------------------------- proximity
    def _graph_neighborhood(self, sid: int, depth: int) -> List[int]:
        out = {sid}
        frontier = [sid]
        for _ in range(depth):
            nxt = []
            for i in frontier:
                s = self.memory.get(i)
                if s is None:
                    continue
                for j in s.links:
                    if j not in out:
                        out.add(j)
                        nxt.append(j)
            frontier = nxt
        return sorted(out)

    def _cluster_paths(self, cand_ids: List[int]) -> List[List[int]]:
        """Candidate nodes segmented into paths: connected components over
        neighbour links within the candidate set (Rtabmap::getPaths)."""
        mem = self.memory
        cand = set(cand_ids)
        seen: set = set()
        paths: List[List[int]] = []
        for i in cand_ids:
            if i in seen:
                continue
            comp, frontier = [i], [i]
            seen.add(i)
            depth = 0
            while frontier and depth < max(self.prox_max_graph_depth, 1):
                nxt = []
                for a in frontier:
                    s = mem.get(a)
                    if s is None:
                        continue
                    for j, lk in s.links.items():
                        if (j in cand and j not in seen
                                and lk.type in (LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED)):
                            seen.add(j)
                            comp.append(j)
                            nxt.append(j)
                frontier = nxt
                depth += 1
            paths.append(comp)
        return paths

    def _proximity_detection(self, sig: Signature,
                             st: Optional[Statistics] = None) -> List[Link]:
        """Space closures: old nodes within RGBD/LocalRadius of the current
        optimized pose, clustered into paths, one registration against the
        most likely (else nearest) node of each of the top
        RGBD/ProximityMaxPaths paths, one closure per path."""
        return self._proximity_collect(sig, self._proximity_dispatch(sig, st), st)

    def _proximity_dispatch(self, sig: Signature, st: Optional[Statistics] = None):
        """Candidate search, path clustering and the batched registration's
        dispatch (no wait)."""
        mem = self.memory
        _t_search = time.perf_counter()
        cur_pose = self.optimized_poses.get(sig.id)
        if cur_pose is None:
            cur_pose = np.asarray(T.np_compose(self.map_correction, sig.pose), np.float32)
        recent = set(self._graph_neighborhood(sig.id, 6))  # skip the recent chain
        near_ids, near_d = self.optimized_poses.nearest_within(cur_pose[:3, 3],
                                                               self.local_radius)
        cands = []
        for i, d in zip(near_ids.tolist(), near_d.tolist()):
            if i in recent or i == sig.id or i not in mem.wm:
                continue
            if mem.get(i).slot < 0:
                continue
            cands.append((d, i))
        dist_by_id = {i: d for d, i in cands}
        if cands:
            d0, i0 = cands[0]
            ang = T.np_rotation_angle(T.np_relative(cur_pose, self.optimized_poses[i0]))
            self._last_closest_node = (d0, ang)
        else:
            self._last_closest_node = None

        def lik_of(i: int) -> float:
            s = mem.get(i)
            if s is None or s.slot < 0 or self._last_likelihood is None:
                return 0.0
            return float(self._last_likelihood[s.slot])

        # paths by (highest member likelihood, then proximity)
        paths = self._cluster_paths([i for _, i in cands])
        paths.sort(key=lambda pth: (max((lik_of(i) for i in pth), default=0.0),
                                    -min(dist_by_id[i] for i in pth)), reverse=True)
        filtering_radius = self.prox_filtering_radius
        if self.max_loop_closure_distance > 0 and (
                filtering_radius <= 0 or self.max_loop_closure_distance < filtering_radius):
            filtering_radius = self.max_loop_closure_distance
        if st is not None:
            st.add("Timing/Proximity by space search/ms",
                   (time.perf_counter() - _t_search) * 1000.0)
        _t_vis = time.perf_counter()
        pair_ids: List[int] = []
        pair_guesses: List[np.ndarray] = []
        for pth in paths:
            if self.prox_max_paths > 0 and len(pair_ids) >= self.prox_max_paths:
                break
            best_lik = max(pth, key=lik_of)
            i = best_lik if lik_of(best_lik) > 0 else min(pth, key=lambda j: dist_by_id[j])
            if i in mem.get(sig.id).links:
                continue
            if filtering_radius > 0 and dist_by_id[i] > filtering_radius:
                continue
            pair_ids.append(i)
            pair_guesses.append(np.asarray(
                T.np_relative(self.optimized_poses[i], cur_pose), np.float32))
        handles = None
        if pair_ids:
            handles = mem.compute_transform_batch_async(
                pair_ids, sig.id, self.cam, self.generator, pair_guesses,
                min_inliers=self.min_inliers, guess_window=self.prox_odom_guess)
        return {"pair_ids": pair_ids, "handles": handles, "paths": paths, "cands": cands,
                "cur_pose": cur_pose, "checked": len(pair_ids),
                "filtering_radius": filtering_radius, "t_vis": _t_vis, "sig_id": sig.id}

    def _proximity_collect(self, sig: Signature, ctx,
                           st: Optional[Statistics] = None) -> List[Link]:
        """Blocking half: fetch the batched registrations and add the
        accepted space closures."""
        mem = self.memory
        if ctx is None:
            return []
        out: List[Link] = []
        results = mem.collect_transform_batch(ctx["handles"]) if ctx["handles"] else []
        for i, (t_ab, cov, _inl) in zip(ctx["pair_ids"], results):
            if t_ab is None:
                continue
            if (ctx["filtering_radius"] > 0
                    and float(np.linalg.norm(t_ab[:3, 3])) > ctx["filtering_radius"]):
                continue  # resulting transform too large
            lk = Link(i, ctx["sig_id"], LINK_LOCAL_SPACE_CLOSURE, t_ab, info_from_cov(cov))
            mem.add_link(lk)
            out.append(lk)
        self._last_prox_path_stats = (len(ctx["paths"]), ctx["checked"])
        if st is not None:
            st.add("Timing/Proximity by space visual/ms",
                   (time.perf_counter() - ctx["t_vis"]) * 1000.0)
        # scan ICP against the nearby nodes' scans assembled in the nearest
        # one's frame (reference: Memory::computeIcpTransformMulti), when no
        # visual link was found and this node carries a scan
        self._last_prox_counts = (len(out), 0)
        if not out and sig.scan is not None and ctx["cands"]:
            scan_ids = [i for _, i in ctx["cands"][: self.prox_max_paths]
                        if mem.get(i).scan is not None]
            if scan_ids:
                out = self._proximity_scan_multi(sig, scan_ids, ctx["cur_pose"])
                self._last_prox_counts = (0, len(out))
        return out

    def _scan_slab(self, ids: List[int], poses: List[torch.Tensor]):
        """The scans of nodes ``ids`` carried by ``poses`` into one frame and
        concatenated in that order, padded with invalid rows to a power of
        two (the JAX twin's order and padding, which decide the points the
        voxel hash keeps) -> (points (N,3), mask (N,))."""
        pts, valid = [], []
        for i, P in zip(ids, poses):
            s = self.memory.get(i).scan.to(self.device)
            pts.append(T.apply(P[None], s.xyz()[None])[0])
            valid.append(s.valid)
        pts, valid = torch.cat(pts), torch.cat(valid)
        pad = (1 << max(pts.shape[0] - 1, 1).bit_length()) - pts.shape[0]
        return (torch.nn.functional.pad(pts, (0, 0, 0, pad)),
                torch.nn.functional.pad(valid, (0, pad)))

    def _proximity_scan_multi(self, sig: Signature, scan_ids: List[int],
                              cur_pose) -> List[Link]:
        """Register the current scan against the nearby nodes' scans
        assembled in the nearest node's frame; one closure link at most."""
        from rtabmap_tpu_torch.ops.icp import register_scans

        dev = self.device
        self._last_scan_paths_checked = len(scan_ids)
        anchor = scan_ids[0]
        anchor_pose = torch.as_tensor(np.asarray(self.optimized_poses[anchor]), device=dev)
        A_inv = T.inverse(anchor_pose)
        pts, valid = self._scan_slab(scan_ids, [
            T.compose(A_inv, torch.as_tensor(np.asarray(self.optimized_poses[i]), device=dev))
            for i in scan_ids])
        guess = T.relative(anchor_pose, torch.as_tensor(np.asarray(cur_pose), device=dev))
        res, icp_cov = register_scans(sig.scan.xyz(), sig.scan.valid, pts, valid, guess=guess)
        host = torch.cat([res.valid.float()[None], res.transform.reshape(-1),
                          icp_cov.reshape(-1)]).cpu().numpy()
        if not bool(host[0]):
            return []
        cov = host[13:49].reshape(6, 6) * self.prox_merged_scan_cov_factor
        lk = Link(anchor, sig.id, LINK_LOCAL_SPACE_CLOSURE, host[1:13].reshape(3, 4).copy(),
                  info_from_cov(cov))
        self.memory.add_link(lk)
        return [lk]

    def _localize_global_scan(self, sig: Signature, odom_pose) -> Optional[np.ndarray]:
        """Register the current scan against the whole map's scans
        (reference: RGBD/ProximityGlobalScanMap), assembled in the map frame
        and voxel-filtered once per count of scan nodes (the twin's cache).
        Returns the corrected map pose of the current node, or None."""
        from rtabmap_tpu_torch.ops.cloud import voxel_filter
        from rtabmap_tpu_torch.ops.icp import register_scans

        mem, dev = self.memory, self.device
        scan_nodes = [i for i in list(mem.wm) + list(mem.stm)
                      if i != sig.id and (s := mem.get(i)) is not None
                      and s.scan is not None and i in self.optimized_poses]
        if not scan_nodes:
            return None
        if (self._global_scan_cache is None
                or self._global_scan_cache[0] != len(scan_nodes)):
            pts, valid = self._scan_slab(scan_nodes, [
                torch.as_tensor(np.asarray(self.optimized_poses[i]), device=dev)
                for i in scan_nodes])
            self._global_scan_cache = (len(scan_nodes), pts, voxel_filter(pts, valid, 0.05))
        _, map_pts, map_valid = self._global_scan_cache
        guess = T.compose(torch.tensor(np.asarray(self.map_correction), device=dev),
                          torch.tensor(np.asarray(odom_pose), device=dev))
        self.global_scan_calls += 1
        res, _cov = register_scans(sig.scan.xyz(), sig.scan.valid, map_pts, map_valid,
                                   guess=guess, voxel=0.0)
        host = torch.cat([res.valid.float()[None],
                          T.orthonormalize(res.transform).reshape(-1)]).cpu().numpy()
        if not bool(host[0]):
            return None
        return host[1:13].reshape(3, 4).copy()

    # ------------------------------------------------------------ optimization
    def _build_graph(self):
        """Nodes and edges of the connected component holding the latest
        node (optimizeCurrentMap -> graph::getConnectedGraph); nodes outside
        it keep their previous optimized poses."""
        poses, links = self.memory.get_constraints(session_only=False)
        if poses:
            adj: Dict[int, List[int]] = {}
            for lk in links:
                if lk.from_id in poses and lk.to_id in poses:
                    adj.setdefault(lk.from_id, []).append(lk.to_id)
                    adj.setdefault(lk.to_id, []).append(lk.from_id)
            root = max(poses)
            comp, stack = {root}, [root]
            while stack:
                for nb in adj.get(stack.pop(), []):
                    if nb not in comp:
                        comp.add(nb)
                        stack.append(nb)
            poses = {i: p for i, p in poses.items() if i in comp}
            links = [lk for lk in links
                     if lk.from_id in comp and (lk.to_id in comp or lk.to_id < 0)]
        ids = sorted(poses)
        id_to_idx = {i: k for k, i in enumerate(ids)}

        def init_pose(i):
            # nodes without an optimized pose yet enter in the map frame
            p = self.optimized_poses.get(i)
            if p is None:
                p = T.np_compose(self.map_correction, np.asarray(poses[i], np.float32))
            return np.asarray(p, np.float32)

        pose_arr = (np.stack([init_pose(i) for i in ids]) if ids
                    else np.zeros((0, 3, 4), np.float32))
        ef, et, meas, info, switch = [], [], [], [], []
        pr_idx, pr_meas, pr_info = [], [], []
        for lk in links:
            if lk.type == LINK_POSE_PRIOR:
                if lk.from_id in id_to_idx:
                    pr_idx.append(id_to_idx[lk.from_id])
                    pr_meas.append(lk.transform)
                    pr_info.append(lk.information)
                continue
            if lk.from_id in id_to_idx and lk.to_id in id_to_idx:
                ef.append(id_to_idx[lk.from_id])
                et.append(id_to_idx[lk.to_id])
                meas.append(lk.transform)
                info.append(lk.information)
                switch.append(lk.type in CLOSURE_TYPES)
        if not self.priors_ignored and any(
                getattr(self.memory.get(i), "gps", None) is not None for i in ids):
            raise _not_ported("GPS priors (Optimizer/PriorsIgnored=false)",
                              "the utils/gps.py slice")
        priors = (np.array(pr_idx, np.int32),
                  np.stack(pr_meas) if pr_meas else np.zeros((0, 3, 4), np.float32),
                  np.stack(pr_info) if pr_info else np.zeros((0, 6, 6), np.float32))
        return (ids, pose_arr, np.array(ef, np.int32), np.array(et, np.int32),
                np.stack(meas) if meas else np.zeros((0, 3, 4), np.float32),
                np.stack(info) if info else np.zeros((0, 6, 6), np.float32),
                np.array(switch, bool), priors)

    def _padded_graph(self, poses, ef, et, meas, info, switch, priors, root_idx: int):
        """The PoseGraph on the device, padded to power-of-two buckets
        (floors 32 nodes, 64 edges, 16 priors: the same buckets as the JAX
        twin, so ``optimize`` picks the same solver on the same graph), and
        its padded switchable-edge mask."""
        N, E = poses.shape[0], len(ef)
        Np, Ep = _pad_pow2(N, 32), _pad_pow2(E, 64)
        eye34 = np.eye(3, 4, dtype=np.float32)
        poses_p = np.concatenate([poses, np.tile(eye34, (Np - N, 1, 1))])
        ef_p = np.concatenate([ef, np.zeros(Ep - E, np.int32)])
        et_p = np.concatenate([et, np.zeros(Ep - E, np.int32)])
        meas_p = np.concatenate([meas.reshape(-1, 3, 4), np.tile(eye34, (Ep - E, 1, 1))])
        info_p = np.concatenate([info.reshape(-1, 6, 6),
                                 np.tile(np.eye(6, dtype=np.float32)[None], (Ep - E, 1, 1))])
        pr_idx, pr_meas, pr_info = priors
        P = len(pr_idx)
        if P:
            Pp = _pad_pow2(P, 16)
            pr_idx = np.concatenate([pr_idx, np.zeros(Pp - P, np.int32)])
            pr_meas = np.concatenate([pr_meas, np.tile(eye34, (Pp - P, 1, 1))])
            pr_info = np.concatenate([pr_info, np.zeros((Pp - P, 6, 6), np.float32)])
            prior_valid = np.arange(Pp) < P
        else:
            prior_valid = np.zeros((0,), bool)
        g = PG.make_graph(poses_p, ef_p, et_p, meas_p, info_p,
                          node_valid=np.arange(Np) < N, edge_valid=np.arange(Ep) < E,
                          root=root_idx, priors_idx=pr_idx, priors_meas=pr_meas,
                          priors_info=pr_info, prior_valid=prior_valid, device=self.device)
        switch_p = torch.as_tensor(np.concatenate([switch, np.zeros(Ep - E, bool)]),
                                   device=self.device)
        return g, switch_p

    def _solve_padded(self, poses, ef, et, meas, info, switch, priors,
                      root_idx: int, st: Optional[Statistics] = None):
        """Solve the padded graph (``_padded_graph``) honouring
        Optimizer/Iterations with the Optimizer/Epsilon stop (chunks of up
        to 12 LM iterations, stop when a chunk improves chi2 by less than
        epsilon relative). Returns (out_graph, chi2, iters_done, max_err,
        diagnostics)."""
        dev = self.device
        E = len(ef)
        _t_solve = time.perf_counter()
        g, switch_p = self._padded_graph(poses, ef, et, meas, info, switch, priors, root_idx)
        budget = max(self.optimizer_iterations, 1)
        chunk = min(12, budget)
        if self.optimizer_robust:
            # DCS switchable closures; the anneal spans one optimize() call
            out, chi2 = PG.optimize(g, iters=chunk, switch_mask=switch_p)
            chi2 = float(chi2)
            iters_done = chunk
        else:
            prev = float(PG.graph_chi2(g))
            out, chi2 = g, prev
            iters_done = 0
            while iters_done < budget:
                n = min(chunk, budget - iters_done)
                out, chi2 = PG.optimize(out, iters=n)
                chi2 = float(chi2)
                iters_done += n
                if not np.isfinite(chi2) or \
                        abs(prev - chi2) <= self.optimizer_epsilon * max(prev, 1e-12):
                    break
                prev = chi2
        # one fetch for every diagnostic scalar
        diag = tuple(torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev)
                                  for x in PG.solve_diagnostics(out)]).cpu().tolist())
        max_err = diag[0] if E else 0.0
        self.solves.append((g.poses.shape[0], iters_done,
                            (time.perf_counter() - _t_solve) * 1000.0))
        if st is not None:
            st.add("Loop/Optimization max error ratio/", max_err)
            st.add("Loop/Optimization error/", float(chi2))
            st.add("Loop/Optimization iterations/", iters_done)
        return out, chi2, iters_done, max_err, diag

    def _shortest_path_ids(self, a: int, b: int, exclude_pairs: set) -> Optional[List[int]]:
        """BFS path a -> b over the resident link graph, ignoring the edges
        in ``exclude_pairs`` (the just-added closures). None when
        disconnected."""
        mem = self.memory
        prev = {a: 0}
        frontier = [a]
        while frontier and b not in prev:
            nxt = []
            for i in frontier:
                s = mem.get(i)
                if s is None:
                    continue
                for j in s.links:
                    if j < 0 or j in prev or (i, j) in exclude_pairs or (j, i) in exclude_pairs:
                        continue
                    prev[j] = i
                    nxt.append(j)
            frontier = nxt
        if b not in prev:
            return None
        path = [b]
        while path[-1] != a:
            path.append(prev[path[-1]])
        return path

    def _optimize_subgraph(self, st: Statistics, new_links: List[Link]) -> bool:
        """Incremental optimization: solve only the cycle the new links
        close (the shortest existing path between each closure's ends) plus
        a margin of 2, boundary nodes held at their optimized poses by
        strong priors (the affected-clique role of iSAM2). Returns True when
        handled, else the caller runs the full solve."""
        mem = self.memory
        if any(lk.to_id < 0 or lk.from_id < 0 for lk in new_links):
            return False
        exclude = {(lk.from_id, lk.to_id) for lk in new_links}
        sel: set = set()
        for lk in new_links:
            path = self._shortest_path_ids(lk.from_id, lk.to_id, exclude)
            if path is None:
                return False  # disconnected (e.g. the first inter-session link)
            sel.update(path)
        frontier = list(sel)
        for _ in range(2):
            nxt = []
            for i in frontier:
                s = mem.get(i)
                if s is None:
                    continue
                for j in s.links:
                    if j >= 0 and j not in sel:
                        sel.add(j)
                        nxt.append(j)
            frontier = nxt
        if len(sel) > 0.7 * mem.n_resident:
            return False  # the cycle covers most of the graph: full solve
        ids = sorted(i for i in sel if mem.get(i) is not None)
        if len(ids) < 2:
            return False
        idx = {i: k for k, i in enumerate(ids)}

        def init_pose(i):
            p = self.optimized_poses.get(i)
            if p is None:
                p = T.np_compose(self.map_correction, mem.get(i).pose)
            return np.asarray(p, np.float32)

        poses = np.stack([init_pose(i) for i in ids])
        ef, et, meas, info, switch = [], [], [], [], []
        pr_idx, pr_meas, pr_info = [], [], []
        seen, boundary = set(), set()
        for i in ids:
            for j, lk in mem.get(i).links.items():
                if lk.type == LINK_POSE_PRIOR:
                    pr_idx.append(idx[i])
                    pr_meas.append(np.asarray(lk.transform, np.float32))
                    pr_info.append(np.asarray(lk.information, np.float32))
                    continue
                if j not in idx:
                    if j >= 0 and lk.type in (LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED):
                        boundary.add(i)
                    continue
                key = (min(i, j), max(i, j))
                if key in seen:
                    continue
                seen.add(key)
                ef.append(idx[lk.from_id] if lk.from_id in idx else idx[i])
                et.append(idx[lk.to_id] if lk.to_id in idx else idx[j])
                meas.append(np.asarray(lk.transform, np.float32))
                info.append(np.asarray(lk.information, np.float32))
                switch.append(lk.type in CLOSURE_TYPES)
        if not ef:
            return False
        for i in sorted(boundary):   # hold the boundary at its optimized pose
            pr_idx.append(idx[i])
            pr_meas.append(poses[idx[i]])
            pr_info.append(np.eye(6, dtype=np.float32) * 1e4)
        priors = (np.asarray(pr_idx, np.int32),
                  np.stack(pr_meas) if pr_meas else np.zeros((0, 3, 4), np.float32),
                  np.stack(pr_info) if pr_info else np.zeros((0, 6, 6), np.float32))
        out, _chi2, _iters, max_err, _diag = self._solve_padded(
            poses, np.asarray(ef, np.int32), np.asarray(et, np.int32), np.stack(meas),
            np.stack(info), np.asarray(switch, bool), priors, root_idx=0, st=st)
        st.add("Loop/Optimization incremental/", 1)
        st.add("Loop/Optimization nodes/", len(ids))
        new_poses = out.poses.cpu().numpy()
        diverged = not np.isfinite(new_poses[: len(ids)]).all() or not np.isfinite(max_err)
        if diverged or (self.max_error > 0 and max_err > self.max_error):
            for lk in new_links:
                mem.remove_link(lk.from_id, lk.to_id)
            st.add("Loop/Rejected by optimization/", 1)
            self.loop_closure_id = 0
            return True
        for k, i in enumerate(ids):
            self.optimized_poses[i] = new_poses[k]
        self._update_map_correction(max(ids))
        return True

    def _optimize(self, st: Statistics, new_links: List[Link]):
        if not new_links:
            # the optimum is unchanged: map-correct the nodes created this tick
            for i in self.memory.stm:
                if i not in self.optimized_poses:
                    self.optimized_poses[i] = np.asarray(
                        T.np_compose(self.map_correction, self.memory.get(i).pose),
                        np.float32)
            return
        if (self.incremental_optimization and
                self._closures_since_full < self.full_solve_every and
                self._optimize_subgraph(st, new_links)):
            self._closures_since_full += 1
            return
        self._optimize_full(st, new_links)

    def _optimize_full(self, st: Statistics, new_links: List[Link]):
        """Solve the whole graph. On divergence, or when ``new_links`` take
        it past the RGBD/OptimizeMaxError gate, remove them and keep the
        old poses; with no new link only divergence keeps them."""
        self._closures_since_full = 0
        ids, poses, ef, et, meas, info, switch, priors = self._build_graph()
        if len(ids) < 2 or len(ef) < 1:
            for i in ids:
                self.optimized_poses[i] = np.asarray(
                    T.np_compose(self.map_correction, self.memory.get(i).pose), np.float32)
            if ids:
                self._update_map_correction(ids[-1])
            return
        n_reg = sum(1 for i in ids if i >= 0)
        # gauge root: the first node of the map, or the latest with
        # RGBD/OptimizeFromGraphEnd
        root_idx = n_reg - 1 if self.optimize_from_graph_end else 0
        out, _chi2, _iters, max_err, diag = self._solve_padded(
            poses, ef, et, meas, info, switch, priors, root_idx=root_idx, st=st)
        _max_err, max_ang_ratio, dlin_w, dang_w, k_lin, k_ang = diag
        st.add("Loop/Optimization max ang error ratio/", max_ang_ratio)
        st.add("Loop/Optimization max error/m", dlin_w)
        st.add("Loop/Optimization max ang error/deg", float(np.degrees(dang_w)))
        k_lin = min(int(k_lin), len(ef) - 1)
        k_ang = min(int(k_ang), len(ef) - 1)
        st.add("Loop/Optimization max error from id/", float(ids[int(ef[k_lin])]))
        st.add("Loop/Optimization max error to id/", float(ids[int(et[k_lin])]))
        st.add("Loop/Optimization max ang error from id/", float(ids[int(ef[k_ang])]))
        st.add("Loop/Optimization max ang error to id/", float(ids[int(et[k_ang])]))

        def propagate_missing():
            # keep every resident node addressable in the map frame
            for i in ids:
                if i >= 0 and i not in self.optimized_poses:
                    self.optimized_poses[i] = np.asarray(
                        T.np_compose(self.map_correction, self.memory.get(i).pose),
                        np.float32)

        new_poses = out.poses.cpu().numpy()
        diverged = not np.isfinite(new_poses[: len(ids)]).all() or not np.isfinite(max_err)
        if diverged or (new_links and self.max_error > 0 and max_err > self.max_error):
            # reject the new closures: remove their links, keep the old poses
            for lk in new_links:
                self.memory.remove_link(lk.from_id, lk.to_id)
            st.add("Loop/Rejected by optimization/", 1)
            self.loop_closure_id = 0
            propagate_missing()
            return
        self.optimized_poses.bulk_set(ids[:n_reg], new_poses[:n_reg])
        self._update_map_correction(ids[n_reg - 1])

    def _update_map_correction(self, last_id: int):
        self.map_correction = np.asarray(T.np_compose(
            self.optimized_poses[last_id], T.np_inverse(self.memory.get(last_id).pose)),
            np.float32)

    def repair_graph(self, max_removals: int = 5) -> List[Tuple[int, int]]:
        """Delete old closure links that keep the optimized graph above the
        RGBD/OptimizeMaxError gate (Rtabmap::repairGraph): while the worst
        edge-error ratio exceeds the gate, remove the closure link with the
        largest error and re-solve."""
        removed: List[Tuple[int, int]] = []
        for _ in range(max_removals):
            ids, poses, ef, et, meas, info, switch, priors = self._build_graph()
            if len(ids) < 2 or len(ef) < 1:
                break
            n_reg = sum(1 for i in ids if i >= 0)
            out, _chi2, _iters, max_err, _diag = self._solve_padded(
                poses, ef, et, meas, info, switch, priors, root_idx=n_reg - 1)
            if self.max_error <= 0 or not np.isfinite(max_err) or max_err <= self.max_error:
                break
            lin, ang = (x.cpu().numpy() for x in PG.edge_errors(out))
            err = np.maximum(lin, ang)[: len(ef)]
            target = None
            for e in np.argsort(-err):   # the worst CLOSURE edge, never odometry
                a, b = ids[int(ef[e])], ids[int(et[e])]
                lk = self.memory.get(a).links.get(b) if self.memory.get(a) else None
                if lk is not None and lk.type in CLOSURE_TYPES:
                    target = (a, b)
                    break
            if target is None:
                break
            self.memory.remove_link(*target)
            removed.append(target)
        if removed:
            self._optimize(Statistics(), [])
        return removed

    # ---------------------------------------------------------------- transfer
    def _transfer(self, st: Statistics, elapsed_ms: float = 0.0):
        mem = self.memory
        overflow = max(len(mem.wm) - self.memory_thr, 0) if self.memory_thr > 0 else 0
        n_recent = int(len(mem.wm) * mem.recent_wm_ratio)
        immune_global = (set(self._graph_neighborhood(self.loop_closure_id, 2))
                         if self.loop_closure_id else set())
        st.add("Memory/Immunized globally/", len(immune_global))
        st.add("Memory/Immunized locally/", len(mem.stm) + n_recent)
        st.add("Memory/Immunized locally max/", n_recent)
        if self.time_thr > 0 and elapsed_ms > self.time_thr:
            overflow = max(overflow, max(len(mem.wm) // 10, 1))
        # slab almost full -> force transfer
        free = len(mem._free_slots)
        if free < mem.stm_size + 2:
            overflow = max(overflow, mem.stm_size + 2 - free)
        if overflow <= 0:
            return
        ids = mem.removable_ids(overflow, immune_global)
        with st.time_stage("Timing/Emptying trash/ms"):
            for i in ids:
                mem.move_to_ltm(i)
        st.add("Memory/Transferred/", len(ids))

    # ------------------------------------------------------------- accessors
    def get_last_location_id(self) -> int:
        return self.memory.stm[-1] if self.memory.stm else (
            self.memory.wm[-1] if self.memory.wm else 0)

    def get_highest_hypothesis(self) -> Tuple[int, float]:
        return self.last_hypothesis

    def get_optimized_poses(self) -> Dict[int, np.ndarray]:
        return dict(self.optimized_poses)

    def get_graph(self):
        return self.memory.get_constraints(session_only=False)

    def get_wm(self) -> List[int]:
        return list(self.memory.wm)

    def get_stm(self) -> List[int]:
        return list(self.memory.stm)

    def get_wm_size(self) -> int:
        return len(self.memory.wm)

    def get_stm_size(self) -> int:
        return len(self.memory.stm)

    def is_in_stm(self, node_id: int) -> bool:
        return node_id in self.memory.stm

    def get_weights(self) -> Dict[int, int]:
        return {i: self.memory.get(i).weight for i in self.memory.wm + self.memory.stm}

    def get_total_mem_size(self) -> int:
        return len(self.memory.signatures)

    def get_pose(self, node_id: int):
        if node_id in self.optimized_poses:
            return np.asarray(self.optimized_poses[node_id])
        s = self.memory.get(node_id)
        return None if s is None else np.asarray(s.pose)

    def get_loop_closure_id(self) -> int:
        return self.loop_closure_id

    def get_map_correction(self) -> np.ndarray:
        return np.asarray(self.map_correction)

    def set_label(self, node_id: int, label: str) -> bool:
        s = self.memory.get(node_id)
        if s is None:
            return False
        s.label = label
        return True

    def set_user_data(self, node_id: int, data: Optional[bytes]) -> bool:
        """Attach or replace a node's opaque user data (Rtabmap::setUserData);
        a node in LTM is written through to the store."""
        s = self.memory.get(node_id)
        if s is None:
            return False
        s.user_data = data
        if s.in_ltm and self.memory.db is not None:
            self.memory.db.save_signature(s)
        return True

    def set_optimized_poses(self, poses: Dict[int, np.ndarray]) -> None:
        """Seed or override optimized poses (Rtabmap::setOptimizedPoses)."""
        self.optimized_poses.update({i: np.asarray(p, np.float32) for i, p in poses.items()})

    def delete_last_location(self) -> bool:
        """Drop the newest node, from the store too
        (Rtabmap::deleteLastLocation)."""
        last = self.get_last_location_id()
        if not last:
            return False
        self.memory.remove_node(last)
        if self.memory.db is not None:
            self.memory.db.delete_node(last)
        self.optimized_poses.pop(last, None)
        if self.loop_closure_id == last:
            self.loop_closure_id = 0
        return True

    def reset_memory(self) -> None:
        """Clear the map and start a new session; ids continue
        (Rtabmap::resetMemory)."""
        self.memory.clear()
        self.optimized_poses.clear()
        self.bayes.reset()
        self.map_correction = np.eye(3, 4, dtype=np.float32)
        self.loop_closure_id = 0
        self.last_hypothesis = (0, 0.0)
        self._last_pose = None
        self._odom_cache_poses.clear()
        self._odom_cache_links.clear()
        self.clear_path(0)

    # ---------------------------------------------------- the path planner
    def compute_path(self, goal_id: int) -> List[int]:
        """Topological path from the newest node to ``goal_id``, [] when the
        goal is unreachable (Rtabmap::computePath)."""
        from rtabmap_tpu_torch.utils import graph as G

        if not self.memory.stm and not self.memory.wm:
            return []
        start = (self.memory.stm or self.memory.wm)[-1]
        adj = G.links_to_adjacency(self.memory.signatures)
        return G.compute_path(self.optimized_poses, adj, start, goal_id)

    def set_goal(self, goal_id: int) -> bool:
        """Plan to a node and start tracking the path (path_status -1 when
        there is no path with optimized poses)."""
        ids = self.compute_path(goal_id)
        if not ids or any(i not in self.optimized_poses for i in ids):
            self.path_status = -1
            return False
        self.clear_path(0)
        self._path = [(i, np.asarray(self.optimized_poses[i], np.float32)) for i in ids]
        self._path_transform_to_goal = np.eye(3, 4, dtype=np.float32)
        self.path_status = 0
        return True

    def set_goal_pose(self, goal_pose, tolerance: float = -1.0) -> bool:
        """Plan to a metric pose: the nearest node within ``tolerance`` m
        (< 0: RGBD/LocalRadius, 0: unbounded) becomes the goal and the
        offset to the pose is kept as the goal transform."""
        goal_pose = np.asarray(goal_pose, np.float32)
        if tolerance < 0:
            tolerance = self.local_radius
        best, best_d = 0, float("inf")
        for i, pose in self.optimized_poses.items():
            d = float(np.linalg.norm(pose[:3, 3] - goal_pose[:3, 3]))
            if d < best_d:
                best, best_d = i, d
        if best == 0 or (tolerance > 0 and best_d > tolerance):
            self.path_status = -1
            return False
        if not self.set_goal(best):
            return False
        self._path_transform_to_goal = _relative32(self.optimized_poses[best], goal_pose)
        return True

    def clear_path(self, status: int):
        """Stop following the path: its virtual links go; ``status`` -1
        aborted, 1 reached, 0 cleared."""
        for i, _ in self._path:
            self.memory.remove_virtual_links(i)
        self._path = []
        self._path_current_index = 0
        self._path_goal_index = 0
        self._path_unreachable = set()
        self._path_stuck_count = 0
        self._path_stuck_dist = 0.0
        self.path_status = status

    def get_path(self) -> List[int]:
        """The path's remaining node ids, current node to the goal."""
        return [i for i, _ in self._path[self._path_current_index:]]

    def get_path_current_goal(self) -> int:
        """The intermediate goal node driven to now (0 without a path)."""
        if not self._path:
            return 0
        return self._path[self._path_goal_index][0]

    def get_path_next_poses(self) -> List[np.ndarray]:
        """Optimized poses from the current node to the current goal."""
        return [np.asarray(self.optimized_poses[i])
                for i, _ in self._path[self._path_current_index:self._path_goal_index + 1]
                if i in self.optimized_poses]

    def update_goal_index(self) -> None:
        """Track the path after a tick (Rtabmap::updateGoalIndex): chain the
        path's consecutive nodes with weak virtual links (information
        0.01 I) up to RGBD/LocalRadius ahead, end the path when the newest
        node is within RGBD/GoalReachedRadius of the goal, push the
        current goal to the farthest path node within the local radius,
        move the current index to the nearest path node, and count ticks
        without progress against RGBD/PlanStuckIterations."""
        if not self.rgbd_mode or not self._path:
            return
        for i, _ in self._path[:self._path_current_index]:
            self.memory.remove_virtual_links(i)
        dist_so_far = 0.0
        for k in range(self._path_current_index + 1, len(self._path)):
            ia, pa = self._path[k - 1]
            ib, pb = self._path[k]
            if self.local_radius > 0:
                dist_so_far += float(np.linalg.norm(pb[:3, 3] - pa[:3, 3]))
            sa, sb = self.memory.get(ia), self.memory.get(ib)
            if ia != ib and sa is not None and sb is not None and ib not in sa.links:
                self.memory.add_link(Link(ib, ia, LINK_VIRTUAL_CLOSURE, _relative32(pb, pa),
                                          np.eye(6, dtype=np.float32) * 0.01))
            if 0 < self.local_radius < dist_so_far:
                break

        cur_id = (self.memory.stm or self.memory.wm)[-1]
        cur_pose = self.optimized_poses.get(cur_id)
        if cur_pose is None:
            self.clear_path(-1)
            return

        goal_id, goal_pose0 = self._path[-1]
        goal_pose = self.optimized_poses.get(goal_id, goal_pose0)
        goal_abs = _compose32(goal_pose, self._path_transform_to_goal)
        if float(np.linalg.norm(cur_pose[:3, 3] - goal_abs[:3, 3])) < self.goal_reached_radius:
            self.clear_path(1)
            return

        # the farthest reachable intermediate goal within the local radius
        goal_index = self._path_current_index
        for k in range(self._path_current_index + 1, len(self._path)):
            if self._path[k][0] not in self.optimized_poses:
                break
            d = float(np.linalg.norm(self._path[k][1][:3, 3]
                                     - self._path[self._path_current_index][1][:3, 3]))
            if (goal_index == self._path_current_index and k == len(self._path) - 1) \
                    or k not in self._path_unreachable:
                goal_index = k
                if self.local_radius > 0 and d > self.local_radius:
                    break
        same_goal = goal_index == self._path_goal_index
        self._path_goal_index = goal_index

        # the nearest path node becomes the current index
        best_k, best_d = self._path_current_index, float("inf")
        for k in range(self._path_current_index, self._path_goal_index + 1):
            p = self.optimized_poses.get(self._path[k][0])
            if p is None:
                continue
            d = float(np.linalg.norm(cur_pose[:3, 3] - p[:3, 3]))
            if d < best_d:
                best_k, best_d = k, d
        same_current = best_k == self._path_current_index
        if not same_current:
            self._path_current_index = best_k
            self._path_unreachable.discard(best_k)

        # stuck: neither index moved and the distance to the goal did not drop
        if same_goal and same_current and self.plan_stuck_iterations > 0:
            d_goal = float(np.linalg.norm(
                cur_pose[:3, 3]
                - self.optimized_poses.get(self.get_path_current_goal(), goal_abs)[:3, 3]))
            if self._path_stuck_dist == 0.0 or d_goal < self._path_stuck_dist - 0.1:
                self._path_stuck_dist = d_goal
                self._path_stuck_count = 0
            else:
                self._path_stuck_count += 1
                if self._path_stuck_count > self.plan_stuck_iterations:
                    if self._path_goal_index < len(self._path) - 1:
                        self._path_unreachable.add(self._path_goal_index)
                        self._path_stuck_count = 0
                    else:
                        self.clear_path(-1)
        else:
            self._path_stuck_count = 0

    # ------------------------------------------------------------- dumps
    def generate_dot_graph(self, path: str) -> int:
        """GraphViz DOT file of the pose graph (Rtabmap::generateDOTGraph):
        closures as dashed red edges, landmarks as boxes; returns the
        edges written."""
        poses, links = self.get_graph()
        n = 0
        with open(path, "w") as fp:
            fp.write("graph map {\n  node [shape=circle];\n")
            for i in sorted(poses):
                p = np.asarray(poses[i])[:, 3]
                shape = "box" if i < 0 else "circle"
                fp.write(f'  n{abs(i)} [shape={shape}, pos="{p[0]:.2f},{p[1]:.2f}!", '
                         f'label="{i}"];\n')
            seen = set()
            for lk in links:
                key = (min(lk.from_id, lk.to_id), max(lk.from_id, lk.to_id))
                if key in seen:
                    continue
                seen.add(key)
                style = "" if lk.type == LINK_NEIGHBOR else " [style=dashed, color=red]"
                fp.write(f"  n{abs(lk.from_id)} -- n{abs(lk.to_id)}{style};\n")
                n += 1
            fp.write("}\n")
        return n

    def dump_prediction(self, path: str) -> None:
        """The dense Bayes prediction matrix over the resident nodes, as
        text (Rtabmap::dumpPrediction)."""
        mem = self.memory
        depth = min(self.bayes.kernel.shape[0] - 2, 8)
        nbr_idx, nbr_margin = mem.ensure_neighbor_table(depth, 2 * depth + 1).flush()
        P = BF.prediction_matrix(nbr_idx, nbr_margin, mem.host_wm,
                                 self.bayes.kernel.cpu().numpy(), float(self.bayes.vp_prior))
        np.savetxt(path, P, fmt="%.6f")

    def write_log_files(self, directory: str) -> str:
        """The statistics history as two CSV files (the reference's LogF and
        LogI): ``LogI.csv`` the keys whose every value is an integer,
        ``LogF.csv`` the rest; returns LogF's path."""
        import csv

        keys = sorted({k for st in self.stats_history for k in st.data})
        int_keys = [k for k in keys
                    if all(float(st.get(k, 0.0)).is_integer() for st in self.stats_history)]
        float_keys = [k for k in keys if k not in int_keys]

        def dump(path, cols, cast):
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["ref_id", "loop_id"] + cols)
                for st in self.stats_history:
                    w.writerow([st.ref_id, st.loop_closure_id] + [cast(st.get(k, 0.0))
                                                                  for k in cols])

        path_f = os.path.join(directory, "LogF.csv")
        dump(path_f, float_keys, float)
        dump(os.path.join(directory, "LogI.csv"), int_keys, lambda v: int(float(v)))
        return path_f

    def export_poses(self, path: str, fmt: int = 0, optimized: bool = True) -> int:
        """Write the trajectory in one of the reference's five formats
        (Rtabmap::exportPoses); returns the number of poses."""
        from rtabmap_tpu_torch.tools.export_poses import export_poses

        poses = (self.get_optimized_poses() if optimized else
                 {i: self.memory.get(i).pose for i in self.memory.wm + self.memory.stm})
        export_poses(path, fmt, poses)
        return len(poses)

    def get_signature_copy(self, node_id: int, with_words: bool = True,
                           with_scan: bool = False, with_user_data: bool = False,
                           with_grid: bool = False, with_global_descriptors: bool = False):
        """A detached copy of a node, loaded from the store if it is not in
        memory (Rtabmap::getSignatureCopy)."""
        import copy

        s = self.memory.get(node_id)
        if s is None and self.memory.db is not None:
            s = self.memory.db.load_signature(node_id)
        if s is None:
            return None
        out = copy.copy(s)
        out.links = dict(s.links)
        if not with_words:
            out.word_ids = out.desc = out.uv = out.pts3d = out.valid3d = None
        if not with_scan:
            out.scan = None
        if not with_user_data:
            out.user_data = None
        if not with_grid:
            out.grid = None
        if not with_global_descriptors:
            out.global_desc = None
        return out

    def get_3d_map(self, optimized: bool = True, global_map: bool = True):
        """(signatures, poses, constraints) of the current graph
        (Rtabmap::get3DMap)."""
        poses, links = self.memory.get_constraints(session_only=not global_map)
        if optimized:
            poses = {i: self.optimized_poses.get(i, p) for i, p in poses.items()}
        sigs = {i: self.memory.get(i) for i in poses}
        return sigs, {i: np.asarray(p) for i, p in poses.items()}, links

    # ------------------------------------------------------- maintenance ops
    def _register(self, from_id: int, to_id: int, guess=None):
        return self.memory.compute_transform(from_id, to_id, self.cam, self.generator,
                                             guess=guess, min_inliers=self.min_inliers)

    def detect_more_loop_closures(self, cluster_radius: float = 1.0,
                                  cluster_angle: float = 0.0, iterations: int = 1) -> int:
        """Offline: try a closure between every pair of nearby nodes not
        linked yet and re-optimize after each one accepted, gating it on
        its own, then solve the whole graph once an iteration that added
        any (Rtabmap::detectMoreLoopClosures). Returns the closures
        added."""
        from rtabmap_tpu_torch.utils import graph as G

        added_total = 0
        for _ in range(iterations):
            added = 0
            ids = [i for i in (self.memory.wm + self.memory.stm)
                   if self.memory.get(i) is not None]
            poses = {i: self.optimized_poses.get(i, self.memory.get(i).pose) for i in ids}
            for i in ids:
                near = G.find_nearest_nodes(poses[i], poses, radius=cluster_radius,
                                            angle=cluster_angle)
                for j, _d in near:
                    if j <= i or j in self.memory.get(i).links:
                        continue
                    guess = T.np_relative(poses[i], poses[j]).astype(np.float32)
                    t_ab, cov, _inl = self._register(i, j, guess)
                    if t_ab is None:
                        continue
                    lk = Link(i, j, LINK_USER_CLOSURE, t_ab, info_from_cov(cov))
                    self.memory.add_link(lk)
                    st = Statistics()
                    self._optimize(st, [lk])
                    if st.get("Loop/Rejected by optimization/"):
                        continue
                    added += 1
            added_total += added
            if not added:
                break
            # the incremental solves leave the graph short of its optimum:
            # solve it whole with the iteration's closures, ungated, as the
            # reference does after each iteration
            self._optimize_full(Statistics(), [])
        return added_total

    def refine_links(self) -> int:
        """Re-register every link from its stored transform and keep the
        new transform (Rtabmap::refineLinks); re-optimizes once."""
        refined = 0
        seen = set()
        for sid in list(self.memory.signatures):
            sig = self.memory.get(sid)
            if sig is None or sig.desc is None:
                continue
            for j, lk in list(sig.links.items()):
                if (j, sid) in seen or (sid, j) in seen:
                    continue
                seen.add((sid, j))
                other = self.memory.get(j)
                if other is None or other.desc is None:
                    continue
                t_ab, cov, _inl = self._register(lk.from_id, lk.to_id, lk.transform)
                if t_ab is not None:
                    self.memory.add_link(Link(lk.from_id, lk.to_id, lk.type, t_ab,
                                              info_from_cov(cov)))
                    refined += 1
        if refined:
            self._optimize(Statistics(), [])
        return refined

    def reject_last_loop_closure(self) -> bool:
        """Remove the newest closure link (by its larger node id) and
        re-optimize (Rtabmap::rejectLastLoopClosure)."""
        best = None
        for sig in self.memory.signatures.values():
            for lk in sig.links.values():
                if lk.type in CLOSURE_TYPES:
                    key = max(lk.from_id, lk.to_id)
                    if best is None or key > best[0]:
                        best = (key, lk.from_id, lk.to_id)
        if best is None:
            return False
        self.memory.remove_link(best[1], best[2])
        self.loop_closure_id = 0
        self._optimize(Statistics(), [])
        return True

    def add_user_link(self, from_id: int, to_id: int, transform=None) -> bool:
        """A user closure (Rtabmap::addLink): registered when no transform
        is given, then optimized."""
        if transform is None:
            t_ab, cov, _ = self._register(from_id, to_id)
            if t_ab is None:
                return False
            info = info_from_cov(cov)
        else:
            t_ab = np.asarray(transform, np.float32)
            info = np.eye(6, dtype=np.float32)
        lk = Link(from_id, to_id, LINK_USER_CLOSURE, t_ab, info)
        self.memory.add_link(lk)
        self._optimize(Statistics(), [lk])
        return True

    def global_bundle_adjustment(self, iters: int = 10) -> bool:
        """Bundle adjustment of every node with words and an optimized pose
        (Rtabmap::globalBundleAdjustment): a track is a word seen once in
        each of two or more nodes whose world points agree within 0.10 m,
        started at their mean; the first two cameras are fixed (frame and
        scale gauge). The dense Schur solve up to 600,000 cameras x tracks,
        ``bundle_adjust_large`` past it. The poses' rotations are projected
        onto SO(3) first (``global_ba_problem``). ``self.global_ba_stats``
        keeps the problem's size, the path and the costs."""
        from rtabmap_tpu_torch.optim import ba as BA

        built = self.global_ba_problem()
        if built is None:
            return False
        ids, n_tracks, prob = built
        fx = self.cam.fx
        # the dense Schur solve while its (Nc,Np,6,3) cross term is small,
        # the implicit Schur-CG once it would not be
        large = len(ids) * n_tracks > 600_000
        solve = BA.bundle_adjust_large if large else BA.bundle_adjust
        cost0 = float(BA._cost(prob, prob.poses, prob.points, 4.0 / fx))
        out, cost = solve(prob, iters=iters, huber=4.0 / fx)
        new = to_numpy(T.inverse(out.poses))
        self.global_ba_stats = {
            "cameras": len(ids), "tracks": n_tracks, "observations": int(prob.uv.shape[0]),
            "cameras_x_tracks": len(ids) * n_tracks,
            "path": "bundle_adjust_large" if large else "bundle_adjust",
            "cost_before": cost0, "cost_after": float(cost)}
        if not np.isfinite(new).all():
            return False
        for k, i in enumerate(ids):
            self.optimized_poses[i] = new[k]
        return True

    def global_ba_problem(self, track_tolerance: float = 0.10, orthonormalize: bool = True):
        """The global bundle adjustment's problem: (node ids, tracks,
        ``BAProblem`` of world-to-camera poses and normalized observations
        on the engine's device), or None when there are fewer than two
        nodes or ten tracks. A track's world points must agree within
        ``track_tolerance`` (m) of their mean (the twin's 0.10).
        ``orthonormalize=False`` keeps the rotations as they are, as the
        twin does (the problem to hold the port's against)."""
        from collections import defaultdict

        from rtabmap_tpu_torch.optim import ba as BA

        ids = [i for i in sorted(self.memory.signatures)
               if (s := self.memory.get(i)) is not None and s.word_ids is not None
               and i in self.optimized_poses]
        if len(ids) < 2:
            return None
        dev = self.device
        # A map's optimized rotations can sit off SO(3) (a weak frame's DLT
        # odometry rotation is, and the map corrections compose it on), and
        # the inverse by the transpose then moves a camera's position by as
        # much: project each rotation onto SO(3) first. (The twin inverts
        # the poses as they are.)
        pose_t = torch.from_numpy(np.stack([
            np.asarray(self.optimized_poses[i], np.float32) for i in ids])).to(dev)
        if orthonormalize:
            pose_t = T.orthonormalize(pose_t)
        pts_t = torch.from_numpy(np.stack([np.asarray(self.memory.get(i).pts3d, np.float32)
                                           for i in ids])).to(dev)
        world_all = to_numpy(T.apply(pose_t, pts_t))                 # (N,K,3)
        tracks = defaultdict(list)            # word -> [(camera, uv, world point)]
        for k_cam, i in enumerate(ids):
            s = self.memory.get(i)
            wids = np.asarray(s.word_ids)
            uniq, counts = np.unique(wids[wids >= 0], return_counts=True)
            keep = (wids >= 0) & ~np.isin(wids, uniq[counts > 1]) & np.asarray(s.valid3d, bool)
            for k in np.flatnonzero(keep):
                tracks[int(wids[k])].append((k_cam, s.uv[k], world_all[k_cam, k]))

        # word ids alias distinct points (quantization): keep the tracks
        # whose world points agree metrically
        def consistent(obs):
            pts = np.stack([o[2] for o in obs])
            return np.linalg.norm(pts - pts.mean(0), axis=1).max() < track_tolerance

        tracks = {w: obs for w, obs in tracks.items() if len(obs) >= 2 and consistent(obs)}
        if len(tracks) < 10:
            return None
        cam_idx, pt_idx, uvn, pts0 = [], [], [], []
        fx, fy, cx, cy = self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy
        for p, obs in enumerate(tracks.values()):
            pts0.append(np.mean([o[2] for o in obs], axis=0))
            for ck, uv, _ in obs:
                cam_idx.append(ck)
                pt_idx.append(p)
                uvn.append([(uv[0] - cx) / fx, (uv[1] - cy) / fy])
        fixed = torch.zeros(len(ids), dtype=torch.bool, device=dev)
        fixed[:2] = True
        prob = BA.BAProblem(
            poses=T.inverse(pose_t), points=torch.from_numpy(np.stack(pts0)).to(dev),
            cam_idx=torch.tensor(cam_idx, dtype=torch.int64, device=dev),
            pt_idx=torch.tensor(pt_idx, dtype=torch.int64, device=dev),
            uv=torch.from_numpy(np.asarray(uvn, np.float32)).to(dev),
            valid=torch.ones(len(cam_idx), dtype=torch.bool, device=dev), fixed_cams=fixed)
        return ids, len(tracks), prob
