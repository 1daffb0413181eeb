"""Memory: signatures, the STM -> WM -> LTM lifecycle and the device slabs.

Port of ``rtabmap_tpu/memory/memory.py``: host ``Signature`` records
(ids, pose, links, weights) are the control plane; fixed-capacity device
slabs aligned by WM slot (word lists (N,K), keypoint uv/3D, the per-word
signature counts) are the data plane the likelihood reads. Spilled
signatures leave the slabs and survive as host records; retrieval
re-inserts them into free slots.

Signature registration (``compute_transform*``, the reference's
Memory::computeTransform -> RegistrationVis) re-matches the stored
descriptors by mutual NNDR and runs PnP-RANSAC with Kabsch hypotheses;
several candidates register as one batched call, and its asynchronous
form enqueues the work and starts non-blocking copies into pinned host
memory, collected with one synchronization.

With a map store (``db``, a ``memory/db.Database``) a signature moved to
LTM, reduced or merged away is saved or deleted there, a removed link is
deleted there, and a retrieval of an id that is not in ``signatures``
loads it from there. In localization mode (``Mem/IncrementalMemory``
false) the map is frozen: signatures leaving the STM are deleted instead
of joining WM, and rehearsal only accumulates weight.

``Vis/CorType`` 1 tracks A's keypoints into B's image by KLT where both
signatures kept their image (the engine keeps it for that mode), else
registers by descriptors, as the twin does. ``Vis/CorNNType`` 6 takes the
correspondences from the attentional matcher where both signatures kept
their float descriptors (``descf``): the bundled ``SuperGlueMatcher`` or,
with ``PyMatcher/Path`` (or ``set_superglue``), the official architecture;
a missing or unreadable weights file raises (the twin falls back to NNDR).
``Vis/CorNNType`` 7 filters the mutual descriptor matches by Grid Motion
Statistics (``ops/matching.gms_filter``) before the PnP-RANSAC.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.ops import matching as M
from rtabmap_tpu_torch.ops import ransac as R
from rtabmap_tpu_torch.utils.logging import get_logger
from rtabmap_tpu_torch.utils.params import Parameters
from rtabmap_tpu_torch.vocab.dictionary import VWDictionary

log = get_logger("memory")


# Link types (reference: Link.h:41-50)
LINK_NEIGHBOR = 0
LINK_GLOBAL_CLOSURE = 1
LINK_LOCAL_SPACE_CLOSURE = 2
LINK_LOCAL_TIME_CLOSURE = 3
LINK_USER_CLOSURE = 4
LINK_VIRTUAL_CLOSURE = 5
LINK_NEIGHBOR_MERGED = 6
LINK_POSE_PRIOR = 7
LINK_LANDMARK = 8
LINK_GRAVITY = 9


@dataclass
class Link:
    from_id: int
    to_id: int
    type: int
    transform: np.ndarray        # (3,4) T_from_to
    information: np.ndarray      # (6,6)


@dataclass
class Signature:
    id: int
    map_id: int
    stamp: float
    pose: np.ndarray             # (3,4) odometry pose
    weight: int = 0
    links: Dict[int, Link] = field(default_factory=dict)
    word_ids: Optional[np.ndarray] = None   # (K,) int32, -1 pad
    desc: Optional[np.ndarray] = None       # (K,D) +-1 int8 descriptors
    uv: Optional[np.ndarray] = None         # (K,2)
    pts3d: Optional[np.ndarray] = None      # (K,3) camera frame
    valid3d: Optional[np.ndarray] = None    # (K,)
    slot: int = -1               # WM device slot (-1 = not resident)
    pending_word_ids: Optional[torch.Tensor] = None  # device word ids while
                                 # a deferred create is in flight
    in_ltm: bool = False
    label: str = ""
    scan: Optional[object] = None   # a core/laser_scan.LaserScan
    user_data: Optional[bytes] = None
    grid: Optional[object] = None
    env_sensors: list = field(default_factory=list)
    global_desc: Optional[np.ndarray] = None
    gt_pose: Optional[np.ndarray] = None
    velocity: Optional[np.ndarray] = None
    gps: Optional[np.ndarray] = None
    image: Optional[np.ndarray] = None   # (H,W) gray, kept only for Vis/CorType 1
    descf: Optional[np.ndarray] = None   # (K,256) float descriptors, kept only
                                         # for Vis/CorNNType 6 (the matcher's input)


class IdList(list):
    """Insertion-ordered id list with O(1) membership (unique ids)."""

    def __init__(self, it=()):
        super().__init__(it)
        self._set = set(self)

    def append(self, x):
        super().append(x)
        self._set.add(x)

    def extend(self, it):
        it = list(it)
        super().extend(it)
        self._set.update(it)

    def remove(self, x):
        super().remove(x)
        self._set.discard(x)

    def pop(self, idx=-1):
        v = super().pop(idx)
        self._set.discard(v)
        return v

    def clear(self):
        super().clear()
        self._set.clear()

    def __contains__(self, x):
        return x in self._set


# The slab updates work IN PLACE on the device tensors (the JAX versions
# return new arrays).

def _registration_kernel(desc_a, valid_a, pts_a, uv_a, desc_b, valid_b3d, uv_b, pts_b,
                         guess, cam: C.CameraModel, generator: Optional[torch.Generator],
                         iters: int, reproj_px: float, min_inliers: int, nndr: float = 0.8,
                         window_px: float = 0.0, use_window: bool = False,
                         use_gms: bool = False, indices=None):
    """Signature registration A -> B: mutual NNDR descriptor matching plus
    PnP-RANSAC with Kabsch hypotheses, batched over any leading axes of
    the A side and the guess (the B side is broadcast). ``use_window``
    restricts both directions' candidates to ``window_px`` pixels around
    A's points projected into B through the guess (B-in-A). ``use_gms``
    re-ranks the mutual matches by Grid Motion Statistics (Vis/CorNNType
    7) when at least 30 exist. Returns (RansacResult, the mutual Matches
    of B -> A, (mean inlier range, inlier image spread))."""
    lead = desc_a.shape[:-2]
    desc_b, valid_b3d, uv_b, pts_b = (t.expand(*lead, *t.shape) for t in
                                      (desc_b, valid_b3d, uv_b, pts_b))
    valid_bd = (desc_b != 0).any(-1)
    if use_window:
        uv_proj, z_proj = C.project(T.apply(T.inverse(guess), pts_a), cam)
        valid_a = valid_a & (z_proj > 0)      # behind the camera never matches
        m_ba = M.match_nndr(desc_b, valid_bd, desc_a, valid_a, nndr=nndr,
                            guess_uv=uv_b, uv_b=uv_proj, window=window_px)
        m_ab = M.match_nndr(desc_a, valid_a, desc_b, valid_bd, nndr=nndr,
                            guess_uv=uv_proj, uv_b=uv_b, window=window_px)
    else:
        m_ba, m_ab = M.match_nndr_bidir(desc_b, valid_bd, desc_a, valid_a, nndr=nndr)
    mutual = M.cross_check(m_ba, m_ab)
    if use_gms:
        uv_a_m = torch.gather(uv_a.expand(*lead, *uv_a.shape[-2:]), -2,
                              m_ba.idx.long()[..., None].expand(*m_ba.idx.shape, 2))
        shape = (cam.height, cam.width)
        gms_ok = M.gms_filter(uv_b, uv_a_m, mutual, shape, shape)
        # GMS needs statistical support; below 30 matches keep NNDR's view
        enough = (mutual.sum(-1) >= 30)[..., None]
        mutual = torch.where(enough, mutual & gms_ok, mutual)
    mm = m_ba._replace(valid=mutual)
    sel = torch.gather(pts_a, -2, mm.idx.long()[..., None].expand(*mm.idx.shape, 3))
    res = R.ransac_pnp(sel, uv_b, mm.valid, cam, generator, iters=iters,
                       reproj_px=reproj_px, min_inliers=min_inliers, guess=guess,
                       pts3d_query=torch.where(valid_b3d[..., None], pts_b, 0.0),
                       indices=indices)
    # inlier statistics (RegistrationInfo inliersMeanDistance /
    # inliersDistribution): mean 3D range of the inliers and their
    # normalized image spread
    w = res.inliers.to(sel.dtype)
    n = torch.clamp_min(w.sum(-1), 1)
    mean_dist = (torch.linalg.norm(sel, dim=-1) * w).sum(-1) / n
    c = (uv_b * w[..., None]).sum(-2) / n[..., None]
    diag = float(np.sqrt(np.float32(cam.width) ** 2 + np.float32(cam.height) ** 2))
    spread = torch.sqrt((((uv_b - c[..., None, :]) ** 2).sum(-1) * w).sum(-1) / n) / diag
    return res, mm, (mean_dist, spread)


def _registration_kernel_batch(desc_a, valid_a, pts_a, uv_a, desc_b, valid_b3d, uv_b, pts_b,
                               guesses, cam: C.CameraModel,
                               generator: Optional[torch.Generator], iters: int,
                               reproj_px: float, min_inliers: int, nndr: float,
                               window_px: float, use_window: bool = False,
                               use_gms: bool = False, indices=None):
    """P independent A_i -> B registrations in one call: the A side
    (P,K,...) and ``guesses`` (P,3,4) carry the candidate axis, every
    operation of ``_registration_kernel`` runs batched over it."""
    return _registration_kernel(desc_a, valid_a, pts_a, uv_a, desc_b, valid_b3d, uv_b, pts_b,
                                guesses, cam, generator, iters, reproj_px, min_inliers,
                                nndr=nndr, window_px=window_px, use_window=use_window,
                                use_gms=use_gms, indices=indices)


def _to_host_async(tensors):
    """Start copies of device tensors into pinned host memory without
    waiting; returns (host tensors, event to wait on, or None on the CPU)."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


def _unique_flags(word_nw: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(W,) 1.0 at each distinct valid word of ``words``: duplicates count
    once (the reference counts signatures per word, not occurrences)."""
    W = word_nw.shape[0]
    flags = torch.zeros((W + 1,), dtype=word_nw.dtype, device=word_nw.device)
    flags.index_fill_(0, torch.where(words >= 0, words, W).long(), 1.0)
    return flags[:W]


def _nw_add(word_nw: torch.Tensor, words: torch.Tensor) -> None:
    word_nw += _unique_flags(word_nw, words)


def _nw_sub(word_nw: torch.Tensor, words: torch.Tensor) -> None:
    word_nw.sub_(_unique_flags(word_nw, words)).clamp_(min=0.0)


def _slab_set(node_words, node_uv, node_pts, node_valid, word_nw, slot: int,
              words, uv, pts) -> None:
    node_words[slot] = words
    node_uv[slot] = uv
    node_pts[slot] = pts
    node_valid[slot] = True
    _nw_add(word_nw, words)


def _slab_clear(node_words, node_valid, word_nw, slot: int, words) -> None:
    node_words[slot] = -1
    node_valid[slot] = False
    _nw_sub(word_nw, words)


class Memory:
    """STM/WM/LTM signature store + device slabs on ``device``."""

    _NBR_TYPES = (LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED)

    def __init__(self, params: Optional[Parameters] = None,
                 node_capacity: int = 1024, words_per_frame: int = 512,
                 vocab: Optional[VWDictionary] = None, db=None, device: DeviceLike = None):
        p = params or Parameters()
        self.device = resolve_device(device)
        self.params = p
        self.db = db
        self.stm_size = int(p["Mem/STMSize"])
        self.rehearsal_sim = float(p["Mem/RehearsalSimilarity"])
        self.recent_wm_ratio = float(p["Mem/RecentWmRatio"])
        self.incremental = bool(p["Mem/IncrementalMemory"])
        self.rehearsal_id_updated_to_new = bool(p["Mem/RehearsalIdUpdatedToNewOne"])
        self.rehearsal_weight_ignored_while_moving = bool(
            p["Mem/RehearsalWeightIgnoredWhileMoving"])
        self.rehearsal_max_distance = float(p["RGBD/LinearUpdate"])
        self.rehearsal_max_angle = float(p["RGBD/AngularUpdate"])
        self.reduce_graph = bool(p["Mem/ReduceGraph"])
        self.tfidf_likelihood_used = bool(p["Kp/TfIdfLikelihoodUsed"])
        self.bad_sign_ratio = float(p["Kp/BadSignRatio"])
        self.bad_signatures_ignored = bool(p["Mem/BadSignaturesIgnored"])
        self.kp_max_features = int(p["Kp/MaxFeatures"])
        # correspondence knobs (RegistrationVis Vis/Cor*)
        self.cor_type = int(p["Vis/CorType"])          # 0 features, 1 flow
        self.cor_nndr = float(p["Vis/CorNNDR"])
        self.cor_nn_type = int(p["Vis/CorNNType"])     # 6 SuperGlue, 7 GMS
        self.guess_win_size = float(p["Vis/CorGuessWinSize"])
        self.flow_win_size = int(p["Vis/CorFlowWinSize"])
        self.flow_iterations = int(p["Vis/CorFlowIterations"])
        self.flow_max_level = int(p["Vis/CorFlowMaxLevel"])
        # Vis/CorNNType 6: the attentional matcher, resolved on first use
        # (_ensure_matcher): official-architecture params (set_superglue or
        # PyMatcher/Path) or the bundled SuperGlueMatcher
        self.superglue_params = None
        self.py_matcher = None
        self.pymatcher_path = str(p["PyMatcher/Path"] or "")
        self.pymatcher_threshold = float(p["PyMatcher/Threshold"])
        self.matcher_calls = 0   # registrations through the matcher
        self.last_registration: Dict[str, float] = {}
        self.node_capacity = node_capacity
        self.K = words_per_frame
        self.vocab = vocab or VWDictionary(
            capacity=int(p["Tpu/VocabularyCapacity"]), nndr=float(p["Kp/NndrRatio"]),
            incremental=self.incremental, device=self.device)

        self._pending_create = None
        self._current_frame_dev = None  # latest frame's device tensors (B side
        self._current_frame_id = -1     # of a registration before finalize)
        self.signatures: Dict[int, Signature] = {}
        self.stm: List[int] = IdList()
        self.wm: List[int] = IdList()  # insertion-ordered (oldest first)
        self._next_id = 1
        self._map_id = 0
        self.last_create_timings: Dict[str, float] = {}
        self.last_rehearsal_sim = 0.0
        self.last_rehearsal_id = 0

        N, K, dev = node_capacity, words_per_frame, self.device
        self.node_words = torch.full((N, K), -1, dtype=torch.int32, device=dev)
        self.node_uv = torch.zeros((N, K, 2), dtype=torch.float32, device=dev)
        self.node_pts = torch.zeros((N, K, 3), dtype=torch.float32, device=dev)
        self.node_valid = torch.zeros((N,), dtype=torch.bool, device=dev)
        self.word_nw = torch.zeros((self.vocab.capacity,), dtype=torch.float32, device=dev)
        self._free_slots = list(range(N - 1, -1, -1))
        self._slot_to_id = np.full((N,), -1, np.int64)
        # host mirrors of the resident masks (slot-aligned) for the
        # per-tick appearance prep
        self.host_valid = np.zeros((N,), bool)
        self.host_wm = np.zeros((N,), bool)
        self.n_inter_wm = 0   # weight<0 (intermediate) nodes in WM
        self._nbr_table = None

    # ------------------------------------------------- Bayes neighbour table
    def ensure_neighbor_table(self, depth: int, max_neighbors: int):
        """Incrementally maintained BFS table over resident neighbour links
        (bayes.filter.IncrementalNeighborTable), seeded on first use."""
        from rtabmap_tpu_torch.bayes.filter import IncrementalNeighborTable

        t = self._nbr_table
        if t is None or t.depth != depth or t.max_neighbors != max_neighbors:
            t = IncrementalNeighborTable(self.node_capacity, depth, max_neighbors)
            resident = [self.signatures.get(sid) for sid in (self.wm + self.stm)]
            resident = [s for s in resident if s is not None and s.slot >= 0]
            for s in resident:
                t.add_node(s.slot)
            for s in resident:
                for j, lk in s.links.items():
                    o = self.signatures.get(j)
                    if o is not None and o.slot >= 0 and lk.type in self._NBR_TYPES:
                        t.add_edge(s.slot, o.slot)
            self._nbr_table = t
        return t

    def _nbr_edge(self, link: Link, add: bool):
        if self._nbr_table is None or link.type not in self._NBR_TYPES:
            return
        a = self.signatures.get(link.from_id)
        b = self.signatures.get(link.to_id)
        if a is None or b is None or a.slot < 0 or b.slot < 0:
            return
        if add:
            self._nbr_table.add_edge(a.slot, b.slot)
        else:
            self._nbr_table.remove_edge(a.slot, b.slot)

    def set_superglue(self, params) -> None:
        """Attach official SuperGlue weights (``models.convert.convert_superglue``)
        for Vis/CorNNType 6 matching."""
        from rtabmap_tpu_torch.models import superglue_official as sgo

        self.superglue_params = sgo.to_device(params, self.device)

    # ------------------------------------------------------------------ props
    @property
    def n_resident(self) -> int:
        return len(self.stm) + len(self.wm)

    @property
    def map_id(self) -> int:
        return self._map_id

    def new_map(self):
        self._map_id += 1

    def get(self, sid: int) -> Optional[Signature]:
        return self.signatures.get(sid)

    # -------------------------------------------------------------- creation
    def create_signature(self, frame: FrameFeatures, pose, stamp: float = 0.0,
                         weight: int = 0, deferred: bool = False) -> Signature:
        """Quantize features into words + allocate a WM slot (reference:
        Memory::createSignature). Quantization and the slab write are
        enqueued on the device; with ``deferred=True`` the host feature
        arrays stay None and ``pending_word_ids`` holds the device word ids
        until ``finalize_signature`` copies them back."""
        _t_q = _time.perf_counter()
        wid_dev, _new_dev, n_new_dev = self.vocab.quantize_async(frame.desc, frame.valid)
        self.last_create_timings = {
            "TimingMem/Add new words/ms": (_time.perf_counter() - _t_q) * 1000.0}
        sid = self._next_id
        self._next_id += 1
        ok3d_dev = frame.valid3d & frame.valid
        sig = Signature(id=sid, map_id=self._map_id, stamp=stamp,
                        pose=np.asarray(pose, np.float32), weight=weight)
        sig.pending_word_ids = wid_dev
        self._current_frame_dev = (frame.desc, frame.uv, frame.pts3d, ok3d_dev)
        self._current_frame_id = sid
        self.signatures[sid] = sig
        self._insert_slab(sig, uv_dev=frame.uv, pts_dev=frame.pts3d, words_dev=wid_dev)
        self._pending_create = (sig, (wid_dev, n_new_dev, frame.desc, frame.uv,
                                      frame.pts3d, ok3d_dev))
        if not deferred:
            self.finalize_signature()
        return sig

    def finalize_signature(self) -> None:
        """Complete the deferred create: copy the word ids and features to
        the host and catch the vocabulary counter up."""
        if self._pending_create is None:
            return
        (sig, handles), self._pending_create = self._pending_create, None
        wid, n_new, desc_h, uv_h, pts_h, ok3d_h = (h.cpu().numpy() for h in handles)
        self.vocab.commit_new_words(int(n_new))
        sig.word_ids = wid.astype(np.int32)
        sig.desc = desc_h.astype(np.int8)
        sig.uv = uv_h.astype(np.float32)
        sig.pts3d = pts_h.astype(np.float32)
        sig.valid3d = ok3d_h
        sig.pending_word_ids = None

    def _as_dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _insert_slab(self, sig: Signature, uv_dev=None, pts_dev=None, words_dev=None):
        if not self._free_slots:
            raise RuntimeError("WM slab capacity exhausted — transfer first")
        slot = self._free_slots.pop()
        sig.slot = slot
        self._slot_to_id[slot] = sig.id
        _slab_set(self.node_words, self.node_uv, self.node_pts, self.node_valid,
                  self.word_nw, slot,
                  self._as_dev(sig.word_ids, torch.int32) if words_dev is None else words_dev,
                  self._as_dev(sig.uv, torch.float32) if uv_dev is None else uv_dev,
                  self._as_dev(sig.pts3d, torch.float32) if pts_dev is None else pts_dev)
        self.host_valid[slot] = True
        if sig.id in self.wm:
            self.host_wm[slot] = True
        if self._nbr_table is not None:
            self._nbr_table.add_node(slot)
            for j, lk in sig.links.items():
                o = self.signatures.get(j)
                if o is not None and o.slot >= 0 and lk.type in self._NBR_TYPES:
                    self._nbr_table.add_edge(slot, o.slot)

    def _remove_slab(self, sig: Signature):
        if sig.slot < 0:
            return
        if self._nbr_table is not None:
            self._nbr_table.remove_node(sig.slot)
        _slab_clear(self.node_words, self.node_valid, self.word_nw, sig.slot,
                    self._as_dev(sig.word_ids, torch.int32))
        self.host_valid[sig.slot] = False
        self.host_wm[sig.slot] = False
        self._slot_to_id[sig.slot] = -1
        self._free_slots.append(sig.slot)
        sig.slot = -1

    # ----------------------------------------------------------------- links
    def add_link(self, link: Link):
        a = self.signatures.get(link.from_id)
        b = self.signatures.get(link.to_id)
        if a is not None:
            a.links[link.to_id] = link
        if b is not None:
            b.links[link.from_id] = Link(
                link.to_id, link.from_id, link.type,
                T.np_inverse(np.asarray(link.transform, np.float32)), link.information)
        self._nbr_edge(link, add=True)

    def remove_link(self, from_id: int, to_id: int):
        lk = (self.signatures[from_id].links.get(to_id)
              if from_id in self.signatures else None)
        if lk is not None:
            self._nbr_edge(lk, add=False)
        if from_id in self.signatures:
            self.signatures[from_id].links.pop(to_id, None)
        if to_id in self.signatures:
            self.signatures[to_id].links.pop(from_id, None)
        # the stored rows too: re-saving a signature upserts its remaining
        # links but deletes none, so a removed closure would come back
        if self.db is not None:
            self.db.delete_link(from_id, to_id)

    def remove_virtual_links(self, node_id: int):
        """Drop every virtual-closure link touching a node (reference:
        Memory::removeVirtualLinks; the planner's path chain)."""
        s = self.signatures.get(node_id)
        if s is None:
            return
        for other in [k for k, lk in s.links.items() if lk.type == LINK_VIRTUAL_CLOSURE]:
            self.remove_link(node_id, other)

    # -------------------------------------------------------------- lifecycle
    def add_to_stm(self, sig: Signature, neighbor_link: Optional[Link] = None):
        """(reference: Memory::addSignatureToStm.) Signatures leaving the
        STM are promoted to WM (reduced first with Mem/ReduceGraph); in
        localization mode they are deleted, and the loaded map stays
        frozen."""
        if neighbor_link is not None:
            self.add_link(neighbor_link)
        self.stm.append(sig.id)
        while len(self.stm) > self.stm_size:
            moved = self.stm.pop(0)
            if not self.incremental:
                self.delete_signature(moved)
            elif not (self.reduce_graph and self.reduce_node(moved)):
                self._wm_append(moved)

    def _wm_append(self, sid: int):
        self.wm.append(sid)
        s = self.signatures.get(sid)
        if s is not None and s.slot >= 0:
            self.host_wm[s.slot] = True
        if s is not None and s.weight < 0:
            self.n_inter_wm += 1

    def _wm_discard(self, sid: int):
        if sid in self.wm:
            self.wm.remove(sid)
            s = self.signatures.get(sid)
            if s is not None and s.weight < 0:
                self.n_inter_wm = max(self.n_inter_wm - 1, 0)

    def delete_signature(self, sid: int):
        """Drop a signature entirely (slab + links + record)."""
        sig = self.signatures.get(sid)
        if sig is None:
            return
        self._remove_slab(sig)
        for j in list(sig.links):
            self.remove_link(sid, j)
        del self.signatures[sid]

    def remove_node(self, sid: int):
        """delete_signature and the STM/WM lists (reference:
        Memory::deleteLocation)."""
        if sid in self.stm:
            self.stm.remove(sid)
        self._wm_discard(sid)
        self.delete_signature(sid)

    def clear(self):
        """Drop every signature and start a new session (reference: the
        Memory::init path behind Rtabmap::resetMemory). The store stays
        attached; ids continue."""
        for sid in list(self.signatures):
            self.remove_node(sid)
        self.stm.clear()
        self.wm.clear()
        self._map_id += 1

    def is_bad_signature(self, sig: Signature) -> bool:
        """Too few words for reliable loop closure (reference:
        Signature::isBadSignature, Kp/BadSignRatio of the feature budget)."""
        if sig.word_ids is None:
            return True
        budget = self.kp_max_features if self.kp_max_features > 0 else self.K
        n = int(np.sum(np.asarray(sig.word_ids) >= 0))
        return n < self.bad_sign_ratio * min(budget, self.K)

    def rehearsal(self, sig: Signature) -> int:
        """Compare to the previous STM signature and merge on similarity >=
        Mem/RehearsalSimilarity (reference: Memory::rehearsal). Returns the
        surviving id when a merge happened, else 0."""
        if self.is_bad_signature(sig) and self.bad_signatures_ignored:
            self.last_rehearsal_sim = 0.0
            self.last_rehearsal_id = 0
            return 0
        prev = None
        for i in reversed(self.stm):
            s = self.signatures.get(i)
            if s is not None and s.id != sig.id and s.weight >= 0:
                prev = s
                break
        if prev is None:
            self.last_rehearsal_sim = 0.0
            self.last_rehearsal_id = 0
            return 0
        sim = self.similarity(sig, prev)
        self.last_rehearsal_sim = sim
        self.last_rehearsal_id = prev.id if sim >= self.rehearsal_sim else 0
        if sim < self.rehearsal_sim:
            return 0
        if not self.incremental:
            # localization mode: weight accumulates on the transient node
            sig.weight = sig.weight + 1 + prev.weight
            return 0
        return self.rehearsal_merge(prev.id, sig.id)

    def rehearsal_merge(self, old_id: int, new_id: int) -> int:
        """Merge two consecutive similar nodes (reference:
        Memory::rehearsalMerge). Mem/RehearsalIdUpdatedToNewOne picks the
        survivor; a full merge needs the robot to be stationary. Returns
        the surviving id, or 0."""
        old = self.signatures.get(old_id)
        new = self.signatures.get(new_id)
        if old is None or new is None or not self.incremental:
            return 0
        lk = old.links.get(new_id)
        if lk is not None and lk.type not in (LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED):
            return 0  # already merged
        nb = new.links.get(old_id)
        moving = False
        if nb is not None:
            d = np.asarray(nb.transform, np.float32)
            moving = (T.np_translation_norm(d) > self.rehearsal_max_distance or
                      T.np_rotation_angle(d) > self.rehearsal_max_angle)
        if moving and self.rehearsal_weight_ignored_while_moving:
            return 0
        if moving or nb is None:
            # weight-only update (the reference's intermediate-merge fallback)
            if self.rehearsal_id_updated_to_new:
                new.weight = max(old.weight, 0) + new.weight + 1
                old.weight = 0
            else:
                old.weight = max(new.weight, 0) + old.weight + 1
                new.weight = 0
            return 0
        if self.rehearsal_id_updated_to_new:
            # keep NEW: rewire old's links (composed through the odometry
            # delta) onto the new node, then drop the old node
            keep, drop = new, old
            for j, l in list(drop.links.items()):
                if j == keep.id:
                    continue
                t = T.np_compose(np.asarray(nb.transform, np.float32),
                                 np.asarray(l.transform, np.float32))
                if j not in keep.links:
                    self.add_link(Link(keep.id, j, l.type, t, l.information))
            keep.label = keep.label or drop.label
        else:
            keep, drop = old, new
        keep.weight = max(drop.weight, 0) + keep.weight + 1
        self.remove_node(drop.id)
        if self.db is not None:
            self.db.delete_node(drop.id)
        return keep.id

    def reduce_node(self, sid: int) -> int:
        """Online graph reduction (reference: Memory::reduceNode): a node
        leaving STM with a closure link is removed and its partners are
        rewired to its odometry neighbours. Returns the id reduced to, or 0."""
        s = self.signatures.get(sid)
        if s is None or s.label:
            return 0

        def reducible(l: Link) -> bool:
            return (l.to_id != l.from_id and l.to_id > 0 and
                    l.type not in (LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED,
                                   LINK_VIRTUAL_CLOSURE, LINK_POSE_PRIOR,
                                   LINK_GRAVITY, LINK_LANDMARK) and
                    s.user_data is None)

        reduced_to = 0
        neighbors = {j: l for j, l in s.links.items() if l.type == LINK_NEIGHBOR}
        for j, l in s.links.items():
            if reducible(l):
                reduced_to = j
        if reduced_to == 0:
            return 0
        for j, l in list(s.links.items()):
            partner = self.signatures.get(j)
            if partner is None:
                continue
            if l.type not in (LINK_NEIGHBOR, LINK_NEIGHBOR_MERGED, LINK_VIRTUAL_CLOSURE):
                inv = T.np_inverse(np.asarray(l.transform, np.float32))
                for k, nbl in neighbors.items():
                    if self.signatures.get(k) is None or k == j or k in partner.links:
                        continue
                    t = T.np_compose(inv, np.asarray(nbl.transform, np.float32))
                    self.add_link(Link(j, k, LINK_NEIGHBOR_MERGED, t, nbl.information))
        if self.db is not None:   # kept in the store, linked (keepLinkedInDb)
            s.in_ltm = True
            self.db.save_signature(s)
        self.remove_node(sid)
        return reduced_to

    @staticmethod
    def similarity(a: Signature, b: Signature) -> float:
        wa = set(int(w) for w in a.word_ids if w >= 0)
        wb = set(int(w) for w in b.word_ids if w >= 0)
        if not wa or not wb:
            return 0.0
        return len(wa & wb) / float(max(len(wa), len(wb)))

    # --------------------------------------------------------------- transfer
    def removable_ids(self, count: int, immune: Optional[set] = None) -> List[int]:
        """Lowest-weight-then-oldest WM signatures, the most recent
        Mem/RecentWmRatio of WM and the STM immunized (reference:
        Memory::getRemovableSignatures)."""
        immune = set(immune or ())
        immune.update(self.stm)
        n_recent = int(len(self.wm) * self.recent_wm_ratio)
        if n_recent > 0:
            immune.update(self.wm[-n_recent:])
        cands = [self.signatures[i] for i in self.wm if i not in immune]
        cands.sort(key=lambda s: (s.weight, s.id))
        return [s.id for s in cands[:count]]

    def move_to_ltm(self, sid: int):
        """Spill: remove from WM and the slabs; the record stays on the host
        and is saved to the store when one is attached."""
        sig = self.signatures[sid]
        self._remove_slab(sig)
        self._wm_discard(sid)
        sig.in_ltm = True
        if self.db is not None:
            self.db.save_signature(sig)

    def retrieve(self, ids: List[int]) -> List[int]:
        """Page LTM signatures back into WM slots, loading from the store
        an id that is not in ``signatures`` (reference:
        Memory::reactivateSignatures)."""
        out = []
        for sid in ids:
            sig = self.signatures.get(sid)
            if sig is None and self.db is not None:
                sig = self.db.load_signature(sid)
                if sig is not None:
                    self.signatures[sid] = sig
            if sig is None or not sig.in_ltm:
                continue
            if not self._free_slots:
                break
            sig.in_ltm = False
            self._insert_slab(sig)
            self._wm_append(sid)
            out.append(sid)
        return out

    # --------------------------------------------------- pairwise registration
    def _b_side(self, b: Signature):
        """The registration target's tensors: the in-flight frame's device
        tensors while its deferred create is pending, else the host arrays."""
        if b.desc is None and self._current_frame_dev is not None \
                and self._current_frame_id == b.id:
            desc, uv, pts, ok3 = self._current_frame_dev
            return desc, ok3, uv, pts
        return (self._as_dev(b.desc, torch.int8), self._as_dev(b.valid3d, torch.bool),
                self._as_dev(b.uv, torch.float32), self._as_dev(b.pts3d, torch.float32))

    def compute_transform(self, from_id: int, to_id: int, cam: C.CameraModel,
                          generator: Optional[torch.Generator] = None, guess=None,
                          min_inliers: int = 20, reproj_px: float = 4.0, iters: int = 256,
                          guess_window: Optional[bool] = None, indices=None,
                          ) -> Tuple[Optional[np.ndarray], np.ndarray, int]:
        """Signature registration A -> B by stored-descriptor mutual NNDR and
        PnP-RANSAC; with a guess and ``guess_window`` the candidates are
        restricted to Vis/CorGuessWinSize pixels around the projection.
        With Vis/CorType 1 and both signatures' images kept, A's keypoints
        are tracked into B's image instead (``_compute_transform_flow``).
        With Vis/CorNNType 6 and both signatures' descf kept, the matcher's
        correspondences (``_compute_transform_superglue``).
        Returns (T_ab or None, covariance, inliers)."""
        a, b = self.signatures[from_id], self.signatures[to_id]
        has_guess = guess is not None
        if self.cor_type == 1 and a.image is not None and b.image is not None:
            return self._compute_transform_flow(a, b, cam, guess, generator, iters,
                                                reproj_px, min_inliers, indices)
        if (self.cor_nn_type == 6 and a.descf is not None and b.descf is not None
                and self._ensure_matcher()):
            return self._compute_transform_superglue(a, b, cam, guess, generator, iters,
                                                     reproj_px, min_inliers, indices)
        guess_t = (self._as_dev(guess, torch.float32) if has_guess
                   else T.identity(device=self.device))
        use_window = bool(guess_window) and has_guess and self.guess_win_size > 0
        b_desc, b_ok3, b_uv, b_pts = self._b_side(b)
        res, mm, (mean_d, spread) = _registration_kernel(
            self._as_dev(a.desc, torch.int8), self._as_dev(a.valid3d, torch.bool),
            self._as_dev(a.pts3d, torch.float32), self._as_dev(a.uv, torch.float32),
            b_desc, b_ok3, b_uv, b_pts, guess_t, cam, generator, iters, reproj_px,
            min_inliers, nndr=self.cor_nndr, window_px=self.guess_win_size,
            use_window=use_window, use_gms=self.cor_nn_type == 7, indices=indices)
        # one transfer for every output the host reads
        flat = torch.cat([res.transform.reshape(-1), res.covariance.reshape(-1),
                          torch.stack([res.success.float(), res.num_inliers.float(),
                                       mm.valid.sum().float(), mean_d, spread])]).cpu().numpy()
        transform, cov = flat[:12].reshape(3, 4), flat[12:48].reshape(6, 6)
        success, n_inl, n_match, mean_d, spread = flat[48:]
        self._record_registration_host(int(n_inl), cov, int(n_match), float(mean_d),
                                       float(spread))
        if not success:
            return None, np.eye(6) * 9999.0, int(n_inl)
        return transform.copy(), cov.copy(), int(n_inl)

    def compute_transform_batch(self, from_ids, to_id: int, cam: C.CameraModel,
                                generator: Optional[torch.Generator], guesses,
                                min_inliers: int = 20, reproj_px: float = 4.0,
                                iters: int = 256, guess_window: Optional[bool] = None,
                                indices=None):
        """Registrations {A_i} -> B in one batched call and one fetch.
        Returns [(T_ab or None, covariance, inliers), ...] per from_id."""
        if not from_ids:
            return []
        handles = self.compute_transform_batch_async(
            from_ids, to_id, cam, generator, guesses, min_inliers=min_inliers,
            reproj_px=reproj_px, iters=iters, guess_window=guess_window, indices=indices)
        return self.collect_transform_batch(handles)

    def compute_transform_batch_async(self, from_ids, to_id: int, cam: C.CameraModel,
                                      generator: Optional[torch.Generator], guesses,
                                      min_inliers: int = 20, reproj_px: float = 4.0,
                                      iters: int = 256, guess_window: Optional[bool] = None,
                                      indices=None):
        """Enqueue-only half of ``compute_transform_batch``: launches the
        batched registration and non-blocking copies of its outputs into
        pinned host memory, and returns handles for
        ``collect_transform_batch``. The target may be the frame whose
        deferred create is still in flight (its device tensors are used).
        With Vis/CorType 1 or Vis/CorNNType 6 each pair registers on its
        own, as the twin's batch does (``compute_transform``; ``indices``
        then holds each pair's draws along its first axis), and the handles
        hold the results."""
        if self.cor_type == 1 or self.cor_nn_type == 6:
            return ("done", [self.compute_transform(
                i, to_id, cam, generator, guess=g, min_inliers=min_inliers,
                reproj_px=reproj_px, iters=iters, guess_window=guess_window,
                indices=None if indices is None else tuple(x[k] for x in indices))
                for k, (i, g) in enumerate(zip(from_ids, guesses))])
        A = [self.signatures[i] for i in from_ids]
        b_desc, b_ok3, b_uv, b_pts = self._b_side(self.signatures[to_id])
        stack = lambda attr, dt: self._as_dev(np.stack([getattr(a, attr) for a in A]), dt)
        res, mm, (mean_d, spread) = _registration_kernel_batch(
            stack("desc", torch.int8), stack("valid3d", torch.bool),
            stack("pts3d", torch.float32), stack("uv", torch.float32),
            b_desc, b_ok3, b_uv, b_pts,
            self._as_dev(np.stack([np.asarray(g, np.float32) for g in guesses]), torch.float32),
            cam, generator, iters, reproj_px, min_inliers, self.cor_nndr, self.guess_win_size,
            use_window=bool(guess_window) and self.guess_win_size > 0,
            use_gms=self.cor_nn_type == 7, indices=indices)
        P = len(A)
        flat = torch.cat([res.transform.reshape(P, 12), res.covariance.reshape(P, 36),
                          torch.stack([res.success.float(), res.num_inliers.float(),
                                       mm.valid.sum(-1).float(), mean_d, spread], -1)], -1)
        return _to_host_async([flat])

    def collect_transform_batch(self, handles):
        """Blocking half: one synchronization, then per-pair results (see
        ``compute_transform_batch``)."""
        if handles[0] == "done":
            return handles[1]
        (flat,), ev = handles
        if ev is not None:
            ev.synchronize()
        flat = flat.numpy()
        out = []
        for row in flat:
            n_inl = int(row[49])
            if row[48]:
                out.append((row[:12].reshape(3, 4).copy(), row[12:48].reshape(6, 6).copy(),
                            n_inl))
            else:
                out.append((None, np.eye(6) * 9999.0, n_inl))
        last = flat[-1]   # stats of the last attempted registration
        self._record_registration_host(int(last[49]), last[12:48].reshape(6, 6),
                                       int(last[50]), float(last[51]), float(last[52]))
        return out

    def _ensure_matcher(self) -> bool:
        """Resolve the Vis/CorNNType 6 matcher on first use: PyMatcher/Path
        (an npz of the official architecture, the ``set_superglue`` role)
        or the bundled SuperGlueMatcher. A missing or unreadable weights
        file raises (the twin logs it and falls back to NNDR matching)."""
        if self.superglue_params is None and self.py_matcher is None:
            if self.pymatcher_path:
                from rtabmap_tpu_torch.models import superglue_official as sgo

                self.superglue_params = sgo.load_params(self.pymatcher_path, self.device)
            else:
                from rtabmap_tpu_torch.models.superglue import SuperGlueMatcher

                self.py_matcher = SuperGlueMatcher.distilled(device=self.device)
        return True

    def _compute_transform_superglue(self, a: Signature, b: Signature, cam: C.CameraModel,
                                     guess, generator, iters: int, reproj_px: float,
                                     min_inliers: int, indices=None):
        """The attentional matcher's correspondences (the reference's
        PyMatcher, Vis/CorNNType 6), then PnP-RANSAC from A's 3D to B's
        matched pixels. Keypoint scores are not kept per node: both
        networks take a flat 0.5."""
        self.matcher_calls += 1
        uv_a = self._as_dev(a.uv, torch.float32)
        b_desc, _b_ok3, uv_b, _b_pts = self._b_side(b)
        df_a = self._as_dev(a.descf, torch.float32)
        df_b = self._as_dev(b.descf, torch.float32)
        sc_a = torch.full((uv_a.shape[0],), 0.5, dtype=torch.float32, device=self.device)
        sc_b = torch.full((uv_b.shape[0],), 0.5, dtype=torch.float32, device=self.device)
        if self.py_matcher is not None:
            va = torch.any(self._as_dev(a.desc, torch.int8) != 0, dim=1)
            vb = torch.any(b_desc != 0, dim=1)
            idx_ab, match_valid, _conf = self.py_matcher.match(
                df_a, uv_a, sc_a, va, df_b, uv_b, sc_b, vb,
                image_wh=(float(cam.width), float(cam.height)),
                threshold=self.pymatcher_threshold)
        else:
            from rtabmap_tpu_torch.models.superglue_official import (
                match_from_scores, superglue_apply,
            )

            Z = superglue_apply(self.superglue_params, uv_a, sc_a, df_a, uv_b, sc_b, df_b,
                                float(cam.width), float(cam.height), iters=50)
            idx_ab, match_valid, _score = match_from_scores(Z)
        w = match_valid & self._as_dev(a.valid3d, torch.bool)
        res = R.ransac_pnp(self._as_dev(a.pts3d, torch.float32), uv_b[idx_ab.long()], w, cam,
                           generator, iters=iters, reproj_px=reproj_px,
                           min_inliers=min_inliers,
                           guess=None if guess is None else self._as_dev(guess, torch.float32),
                           indices=indices)
        flat = torch.cat([res.transform.reshape(-1), res.covariance.reshape(-1),
                          torch.stack([res.success.float(), res.num_inliers.float(),
                                       match_valid.sum().float()])]).cpu().numpy()
        transform, cov = flat[:12].reshape(3, 4), flat[12:48].reshape(6, 6)
        success, n_inl, n_match = flat[48:]
        self._record_registration_host(int(n_inl), cov, int(n_match))
        if not success:
            return None, np.eye(6) * 9999.0, int(n_inl)
        return transform.copy(), cov.copy(), int(n_inl)

    def _compute_transform_flow(self, a: Signature, b: Signature, cam: C.CameraModel, guess,
                                generator, iters: int, reproj_px: float, min_inliers: int,
                                indices=None):
        """Optical-flow correspondences (Vis/CorType 1, the reference's
        RegistrationVis flow path): A's keypoints LK-tracked into B's image,
        seeded by their projection under the guess, then PnP-RANSAC on A's
        3D. Vis/CorFlowWinSize is the whole window (klt_track takes its
        radius); with a guess one pyramid level and no motion bound (a loop
        closure moves far in the image)."""
        from rtabmap_tpu_torch.ops.flow import klt_track

        img_a = self._as_dev(a.image, torch.float32)
        img_b = self._as_dev(b.image, torch.float32)
        uv_a = self._as_dev(a.uv, torch.float32)
        pts_a = self._as_dev(a.pts3d, torch.float32)
        valid = self._as_dev(a.valid3d, torch.bool)
        guess_t = guess_uv = None
        if guess is not None:
            guess_t = self._as_dev(guess, torch.float32)
            xb = T.apply(T.inverse(guess_t), pts_a)
            uv_proj, z = C.project(xb, cam)
            guess_uv = torch.where((z > 0)[:, None], uv_proj, uv_a)
        uv_b, ok = klt_track(img_a, img_b, uv_a, valid, guess_uv=guess_uv,
                             win=max(self.flow_win_size // 2, 2), iters=self.flow_iterations,
                             levels=1 if guess is not None else self.flow_max_level,
                             max_move=1e9 if guess is not None else 100.0)
        in_frame = ((uv_b[:, 0] >= 0) & (uv_b[:, 0] < cam.width)
                    & (uv_b[:, 1] >= 0) & (uv_b[:, 1] < cam.height))
        w = valid & ok & in_frame
        res = R.ransac_pnp(pts_a, uv_b, w, cam, generator, iters=iters, reproj_px=reproj_px,
                           min_inliers=min_inliers, guess=guess_t, indices=indices)
        flat = torch.cat([res.transform.reshape(-1), res.covariance.reshape(-1),
                          torch.stack([res.success.float(), res.num_inliers.float(),
                                       w.sum().float()])]).cpu().numpy()
        transform, cov = flat[:12].reshape(3, 4), flat[12:48].reshape(6, 6)
        success, n_inl, n_match = flat[48:]
        self._record_registration_host(int(n_inl), cov, int(n_match))
        if not success:
            return None, np.eye(6) * 9999.0, int(n_inl)
        return transform.copy(), cov.copy(), int(n_inl)

    def _record_registration_host(self, inl: int, cov, matches: int, mean_dist: float = 0.0,
                                  distribution: float = 0.0):
        """Match-level stats of the LAST registration for the engine's
        Loop/Visual* statistics (RegistrationInfo)."""
        cov = np.asarray(cov)
        self.last_registration = {
            "matches": matches, "inliers": inl, "inliers_ratio": inl / max(matches, 1),
            "variance": float(max(cov[0, 0], cov[5, 5])),
            "lin_variance": float(cov[0, 0]), "ang_variance": float(cov[5, 5]),
            "mean_dist": mean_dist, "distribution": distribution}

    def get_constraints(self, session_only: bool = True):
        """Poses + links of the resident signatures for the optimizer
        (reference: Memory::getMetricConstraints)."""
        ids = list(self.wm + self.stm)
        if session_only:
            ids = [i for i in ids if self.signatures[i].map_id == self._map_id]
        idset = set(ids)
        poses = {i: self.signatures[i].pose for i in ids}
        links, seen = [], set()
        for i in ids:
            for j, lk in self.signatures[i].links.items():
                if j in idset and (j, i) not in seen:
                    seen.add((i, j))
                    links.append(lk)
                elif j < 0 and lk.type == LINK_LANDMARK:
                    links.append(lk)
        return poses, links


def _shared_word_rows(words_a: np.ndarray, words_b: np.ndarray):
    """Indices (ia, ib) of the unique words present in both signatures, in
    ``np.intersect1d``'s order (duplicated words are ambiguous and dropped,
    the reference's unique-word correspondence rule)."""

    def unique_rows(w):
        vals, idx, counts = np.unique(np.asarray(w), return_index=True, return_counts=True)
        keep = (vals >= 0) & (counts == 1)
        return vals[keep], idx[keep]

    va, ia = unique_rows(words_a)
    vb, ib = unique_rows(words_b)
    _, ca, cb = np.intersect1d(va, vb, return_indices=True)
    return ia[ca].astype(np.int32), ib[cb].astype(np.int32)
