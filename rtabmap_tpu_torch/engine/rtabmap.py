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
  repeated rejections, and the pose statistics.

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

Raised as not yet ported, naming the slice that brings them: epipolar
hypothesis verification (``VhEp/Enabled``), multi-device meshes, laser
scans (and with them neighbour-link refining, the scan-ICP proximity
fallback and global scan-map localization), landmarks, learned-descriptor
inputs, GPS priors and intermediate nodes. Not there yet: the path
planner and the maintenance API.
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
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory.memory import (
    LINK_GLOBAL_CLOSURE, LINK_LANDMARK, LINK_LOCAL_SPACE_CLOSURE, LINK_LOCAL_TIME_CLOSURE,
    LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED, LINK_POSE_PRIOR, LINK_USER_CLOSURE,
    Link, Memory, Signature,
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


def _host_array(x) -> Optional[np.ndarray]:
    """A raw image or depth map (tensor on any device, or array) on the host."""
    if x is None:
        return None
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
        if bool(p["VhEp/Enabled"]):
            raise _not_ported("epipolar hypothesis verification (VhEp/Enabled)",
                              "the ops/epipolar.py slice")
        if bool(p["Rtabmap/CreateIntermediateNodes"]):
            raise _not_ported("intermediate nodes (Rtabmap/CreateIntermediateNodes)",
                              "a later slice")
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
        self.max_error = float(p["RGBD/OptimizeMaxError"])
        self.local_radius = float(p["RGBD/LocalRadius"])
        self.prox_max_paths = int(p["RGBD/ProximityMaxPaths"])
        self.prox_max_graph_depth = int(p["RGBD/ProximityMaxGraphDepth"])
        self.prox_filtering_radius = float(p["RGBD/ProximityPathFilteringRadius"])
        self.prox_odom_guess = bool(p["RGBD/ProximityOdomGuess"])
        self.max_loop_closure_distance = float(p["RGBD/MaxLoopClosureDistance"])
        self.proximity_by_time = bool(p["RGBD/ProximityByTime"])
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
        self._consecutive_rejections = 0
        # RANSAC draws of every registration the engine makes (a CPU
        # generator: the same samples on the CPU and on the card)
        self.generator = torch.Generator().manual_seed(seed)
        self.stats_history: List[Statistics] = []
        # (padded nodes, LM iterations, host ms) of every graph solve
        self.solves: List[Tuple[int, int, float]] = []

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
        saveOptimizedPoses): the WM and STM signatures, the parameters,
        the optimized poses, the vocabulary and any derived products
        given; then wait for the writes."""
        db = self.memory.db
        if db is None:
            return
        for i in list(self.memory.wm) + list(self.memory.stm):
            db.save_signature(self.memory.get(i))
        db.save_admin(params=self.params.overrides(), optimized_poses=self.optimized_poses,
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
        for what, value, slice_ in (
                ("a laser scan", scan, "the engine's scan stages (neighbour-link "
                 "refining, the scan-ICP proximity fallback; ROADMAP 'Next' c.)"),
                ("landmarks", landmarks, "a later slice"),
                ("learned float descriptors", descf, "the learned-model slice")):
            if value is not None:
                raise _not_ported(f"process() with {what}", slice_)
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
            if raw is not None and self.bin_data_kept and self.memory.db is not None:
                # raw sensor data kept with the node (Mem/BinDataKept), copied
                # to the host here, compressed on the store's writer thread
                with st.time_stage("TimingMem/Compressing data/ms"):
                    self.memory.db.save_raw_frame(
                        sig.id, map_id=sig.map_id, stamp=stamp, pose=odom_pose,
                        image=_host_array(raw[0]), depth=_host_array(raw[1]))
            neighbor_link = None
            prev = self.memory.get(prev_id) if prev_id is not None else None
            if prev is not None and prev.map_id != sig.map_id:
                prev = None  # never chain odometry across a session break
            if prev is not None:
                t_ab = np.asarray(T.np_relative(prev.pose, odom_pose), np.float32)
                neighbor_link = Link(prev_id, sig.id, LINK_NEIGHBOR, t_ab, info_from_cov(cov))
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

        # --- E. retrieval: page the hypothesis neighbourhood back from LTM
        if hypothesis_id > 0:
            with st.time_stage("Timing/Retrieval/ms"):
                near = self._graph_neighborhood(hypothesis_id, self.retrieval_margin)
                ltm_ids = [i for i in near
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
                st.add("Proximity/Space detections added visually/", len(prox_links))
                st.add("Proximity/Space detections added icp multi/", 0)
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
        st.add("Proximity/Space scan paths checked/", 0)
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

    def _localize(self, st: Statistics, sig: Signature, odom_pose, links_added: List[Link],
                  accepted_id: int) -> int:
        """Localization mode's stage I: the first link added to this frame
        moves the map correction, checked against the odometry cache when
        it holds more than this frame; a link the cache contradicts is
        removed. Returns the accepted hypothesis id (0 once rejected)."""
        loc_link = links_added[0] if links_added else None
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
        return {"pair_ids": pair_ids, "handles": handles, "paths": paths,
                "checked": len(pair_ids), "filtering_radius": filtering_radius,
                "t_vis": _t_vis, "sig_id": sig.id}

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
        return out

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
        if diverged or (self.max_error > 0 and max_err > self.max_error):
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
