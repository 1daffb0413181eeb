"""Memory: signatures, the STM -> WM -> LTM lifecycle and the device slabs.

Port of ``rtabmap_tpu/memory/memory.py`` minus registration: host
``Signature`` records (ids, pose, links, weights) are the control plane;
fixed-capacity device slabs aligned by WM slot (word lists (N,K),
keypoint uv/3D, the per-word signature counts) are the data plane the
likelihood reads. Spilled signatures leave the slabs and survive as host
records; retrieval re-inserts them into free slots.

Waiting for the RGB-D slice: the registration kernels, ``compute_transform*``
(visual, SuperGlue and optical-flow correspondences) and the map store.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from rtabmap_tpu_torch.core.frame import FrameFeatures
from rtabmap_tpu_torch.device import DeviceLike, resolve_device
from rtabmap_tpu_torch.geometry import transform as T
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
    user_data: Optional[bytes] = None
    grid: Optional[object] = None
    env_sensors: list = field(default_factory=list)
    global_desc: Optional[np.ndarray] = None
    gt_pose: Optional[np.ndarray] = None
    velocity: Optional[np.ndarray] = None
    gps: Optional[np.ndarray] = None


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
                 vocab: Optional[VWDictionary] = None, device: DeviceLike = None):
        p = params or Parameters()
        self.device = resolve_device(device)
        self.params = p
        self.stm_size = int(p["Mem/STMSize"])
        self.rehearsal_sim = float(p["Mem/RehearsalSimilarity"])
        self.recent_wm_ratio = float(p["Mem/RecentWmRatio"])
        self.incremental = bool(p["Mem/IncrementalMemory"])
        if not self.incremental:
            raise NotImplementedError(
                "Mem/IncrementalMemory=false (localization mode) is not ported "
                "yet; it comes with the pose-graph slice")
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
        self.node_capacity = node_capacity
        self.K = words_per_frame
        self.vocab = vocab or VWDictionary(
            capacity=int(p["Tpu/VocabularyCapacity"]), nndr=float(p["Kp/NndrRatio"]),
            incremental=self.incremental, device=self.device)

        self._pending_create = None
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

    # -------------------------------------------------------------- lifecycle
    def add_to_stm(self, sig: Signature, neighbor_link: Optional[Link] = None):
        """(reference: Memory::addSignatureToStm.) Signatures leaving the
        STM are promoted to WM (reduced first with Mem/ReduceGraph)."""
        if neighbor_link is not None:
            self.add_link(neighbor_link)
        self.stm.append(sig.id)
        while len(self.stm) > self.stm_size:
            moved = self.stm.pop(0)
            if self.reduce_graph and self.reduce_node(moved):
                continue
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
        if sid in self.stm:
            self.stm.remove(sid)
        self._wm_discard(sid)
        self.delete_signature(sid)

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
        return self.rehearsal_merge(prev.id, sig.id)

    def rehearsal_merge(self, old_id: int, new_id: int) -> int:
        """Merge two consecutive similar nodes (reference:
        Memory::rehearsalMerge). Mem/RehearsalIdUpdatedToNewOne picks the
        survivor; a full merge needs the robot to be stationary. Returns
        the surviving id, or 0."""
        old = self.signatures.get(old_id)
        new = self.signatures.get(new_id)
        if old is None or new is None:
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
        """Spill: remove from WM and the slabs; the record stays on the host."""
        sig = self.signatures[sid]
        self._remove_slab(sig)
        self._wm_discard(sid)
        sig.in_ltm = True

    def retrieve(self, ids: List[int]) -> List[int]:
        """Page LTM signatures back into WM slots (reference:
        Memory::reactivateSignatures)."""
        out = []
        for sid in ids:
            sig = self.signatures.get(sid)
            if sig is None or not sig.in_ltm:
                continue
            if not self._free_slots:
                break
            sig.in_ltm = False
            self._insert_slab(sig)
            self._wm_append(sid)
            out.append(sid)
        return out
