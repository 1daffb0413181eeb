"""The SLAM engine's per-frame ``process()`` state machine, appearance-only.

Port of ``rtabmap_tpu/engine/rtabmap.py`` over the branches that
``RGBD/Enabled=false`` takes — RTAB-Map's BOWMapping configuration:
memory update + rehearsal, tf-idf likelihood -> Angeli adjustment ->
Bayes posterior -> hypothesis accept (single-hypothesis and loop-ratio
rules), LTM -> WM retrieval around the hypothesis, the appearance-only
closure link, WM -> LTM transfer and the statistics.

Raised as not yet ported, naming the slice that brings them: the RGB-D
tick (``RGBD/Enabled=true``: registration, proximity, graph optimization),
localization mode, epipolar hypothesis verification, the map store
(``db``), multi-device meshes, laser scans, landmarks, raw-frame and
learned-descriptor inputs, and the path planner.
"""
from __future__ import annotations

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
    LINK_GLOBAL_CLOSURE, LINK_NEIGHBOR, Link, Memory, Signature,
)
from rtabmap_tpu_torch.utils.graph import PoseStore
from rtabmap_tpu_torch.utils.logging import Statistics, Timer, get_logger
from rtabmap_tpu_torch.utils.params import Parameters
from rtabmap_tpu_torch.vocab.dictionary import (
    adjust_likelihood, similarity_likelihood, tfidf_likelihood,
)

log = get_logger("engine")


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


class Rtabmap:
    """Appearance-only RTAB-Map engine on ``device`` (None = the CUDA card)."""

    def __init__(self, cam: C.CameraModel, params: Optional[Parameters] = None,
                 db=None, node_capacity: int = 1024, words_per_frame: int = 512,
                 mesh=None, device: DeviceLike = None):
        p = params or Parameters()
        if bool(p["RGBD/Enabled"]):
            raise _not_ported("RGBD/Enabled=true (the metric RGB-D tick)",
                              "the RGB-D slice; set RGBD/Enabled=false")
        if db is not None:
            raise _not_ported("the map store (db)", "the RGB-D slice (memory/db.py)")
        if mesh is not None:
            raise _not_ported("a multi-device mesh", "the multi-chip slice")
        if bool(p["VhEp/Enabled"]):
            raise _not_ported("epipolar hypothesis verification (VhEp/Enabled)",
                              "the RGB-D slice (ops/ransac.py)")
        self.device = resolve_device(device)
        self.params = p
        self.cam = cam
        self.memory = Memory(p, node_capacity=node_capacity,
                             words_per_frame=words_per_frame, device=self.device)
        self.bayes = BF.BayesFilter(
            node_capacity,
            prediction_lc=[float(x) for x in str(p["Bayes/PredictionLC"]).split()],
            virtual_place_prior=float(p["Bayes/VirtualPlacePriorThr"]),
            device=self.device)
        self.loop_thr = float(p["Rtabmap/LoopThr"])
        self.loop_ratio = float(p["Rtabmap/LoopRatio"])
        self.time_thr = float(p["Rtabmap/TimeThr"])        # ms, 0 = off
        self.memory_thr = int(p["Rtabmap/MemoryThr"])      # nodes, 0 = off
        self.detection_rate = float(p["Rtabmap/DetectionRate"])
        self.retrieval_margin = 2  # graph-depth margin around the hypothesis

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
        self.stats_history: List[Statistics] = []

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
        self.optimized_poses.clear()
        self.map_correction = np.eye(3, 4, dtype=np.float32)
        self._new_session_rebase = True

    # ---------------------------------------------------------------- process
    def process(self, frame: FrameFeatures, odom_pose, covariance=None,
                stamp: float = 0.0, scan=None, user_data: Optional[bytes] = None,
                grid=None, env_sensors=None, global_desc=None, gt_pose=None,
                velocity=None, gps=None, landmarks=None, raw=None, descf=None,
                extra_stats: Optional[Dict[str, float]] = None) -> Statistics:
        for what, value in (("a laser scan", scan), ("landmarks", landmarks),
                            ("raw frames", raw), ("learned float descriptors", descf)):
            if value is not None:
                raise _not_ported(f"process() with {what}", "a later slice")
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
            neighbor_link = None
            prev = self.memory.get(prev_id) if prev_id is not None else None
            if prev is not None and prev.map_id != sig.map_id:
                prev = None  # never chain odometry across a session break
            if prev is not None:
                t_ab = np.asarray(T.np_relative(prev.pose, odom_pose), np.float32)
                neighbor_link = Link(prev_id, sig.id, LINK_NEIGHBOR, t_ab, info_from_cov(cov))
            self.memory.add_to_stm(sig, neighbor_link)

        # --- C. odometry bookkeeping (the displacement and speed gates act
        # in RGB-D mode only)
        if self._last_pose is not None:
            self._distance_travelled += T.np_translation_norm(
                T.np_relative(self._last_pose, odom_pose))
        self._last_pose = odom_pose
        st.add("Memory/Fast movement/", 0.0)
        st.add("Memory/Small movement/", 0.0)
        st.add("Memory/Distance travelled/m", self._distance_travelled)
        st.add("Loop/Distance since last loc/m",
               self._distance_travelled - self._distance_at_last_loc)
        st.add("Memory/Odometry variance lin/", float(cov[0, 0]))
        st.add("Memory/Odometry variance ang/", float(cov[5, 5]))

        # --- D0. appearance dispatch (enqueued before the create's fetch)
        wm_ids = list(self.memory.wm)
        app = None
        if wm_ids:
            with st.time_stage("Timing/Posterior computation/ms"):
                app = self._dispatch_appearance(sig)

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
        st.add("Memory/RehearsalMerged", float(merged_id))

        # --- D. appearance hypothesis accept
        bad_sig = (self.memory.bad_signatures_ignored and
                   self.memory.is_bad_signature(sig))
        hypothesis_id, hypothesis_value = 0, 0.0
        if app is not None and not bad_sig:
            with st.time_stage("Timing/Likelihood computation/ms"):
                post, _adj, best_slot, best_post, vp = app
                self.bayes.state = BF.BayesState(posterior=post)
                slot_f, best_post, vp = torch.stack(
                    [best_slot.float(), best_post, vp]).cpu().tolist()
            sid = int(self.memory._slot_to_id[int(slot_f)])
            if sid > 0 and best_post > 0:
                # value = 1 - P(virtual place)
                hypothesis_id, hypothesis_value = sid, float(1.0 - vp)
            st.add("Loop/Highest hypothesis id/", hypothesis_id)
            st.add("Loop/Highest hypothesis value/", hypothesis_value)
            st.add("Loop/Vp hypothesis/", float(vp))

        # --- accept rules (reference order: single hypothesis -> loop ratio)
        _t_hyp = time.perf_counter()
        accepted_id = 0
        if hypothesis_id > 0 and hypothesis_value >= self.loop_thr:
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
               float(hypothesis_id > 0 and hypothesis_value >= self.loop_thr
                     and accepted_id == 0))
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
                    with st.time_stage("Timing/Reactivation/ms"):
                        got = self.memory.retrieve(ltm_ids)
                    st.add("Memory/Retrieved/", len(got))
                    st.add("Memory/Signatures retrieved/", len(got))
                    st.add("Loop/Hypothesis reactivated/", float(hypothesis_id in got))

        # --- G. appearance-only closure: the hypothesis IS the loop closure
        if accepted_id > 0:
            self.loop_closure_id = accepted_id
            self.memory.add_link(Link(accepted_id, sig.id, LINK_GLOBAL_CLOSURE,
                                      np.eye(3, 4, dtype=np.float32),
                                      np.eye(6, dtype=np.float32)))
        self.optimized_poses[sig.id] = odom_pose

        # --- K. transfer (WM -> LTM)
        with st.time_stage("Timing/Memory cleanup/ms"):
            with st.time_stage("Timing/Forgetting/ms"):
                self._transfer(st, timer.elapsed() * 1000.0)

        # --- J/L statistics
        st.ref_id = sig.id
        st.loop_closure_id = self.loop_closure_id if accepted_id else 0
        mem = self.memory
        st.add("Memory/Signatures removed/",
               max(n_sigs_before + 1 - len(mem.signatures), 0))
        _t_fin = time.perf_counter()
        st.add("Memory/Working memory size/", len(mem.wm))
        st.add("Memory/Short time memory size/", len(mem.stm))
        st.add("Memory/Short time memory inter size/",
               sum(1 for i in mem.stm if (s := mem.get(i)) is not None and s.weight < 0))
        st.add("Memory/Working memory inter size/", mem.n_inter_wm)
        st.add("Proximity/Space scan paths checked/", 0)
        if accepted_id > 0:
            # no metric registration in this mode: zero link variance
            st.add("Loop/MapToBase lin var/m2", 0.0)
            st.add("Loop/MapToBase lin std/m", 0.0)
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
        if accepted_id > 0:
            # a (re)localization event resets the odometer
            self._distance_at_last_loc = self._distance_travelled
        with st.time_stage("Timing/RAM estimation/ms"):
            import resource

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
        return st

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
