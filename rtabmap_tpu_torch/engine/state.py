"""Build a port engine from another engine's state held in numpy.

``engine_from_numpy`` takes the state of a running appearance-only engine
— the memory slabs, the slot maps and host masks, the signature records
and their links, the STM/WM id lists, the vocabulary ``state_dict()`` and
the Bayes posterior — as plain numpy arrays and Python values, and returns
a port ``Rtabmap`` that computes the same next tick. The JAX engine's
state maps onto it field by field (see ``tests/test_torch_engine_bow.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.memory.memory import IdList, Link, Signature
from rtabmap_tpu_torch.utils.params import Parameters
from rtabmap_tpu_torch.vocab.dictionary import VWDictionary

# Signature fields carried as they are (numpy arrays or Python values).
SIGNATURE_FIELDS = ("id", "map_id", "stamp", "pose", "weight", "word_ids", "desc",
                    "uv", "pts3d", "valid3d", "slot", "in_ltm", "label")


def engine_from_numpy(cam: C.CameraModel, params: Optional[Parameters],
                      state: Dict[str, Any], device: DeviceLike = None) -> Rtabmap:
    """``state`` keys:

    - ``vocab``: a ``VWDictionary.state_dict()``;
    - ``node_words`` (N,K) int32, ``node_valid`` (N,), ``node_uv``
      (N,K,2), ``node_pts`` (N,K,3), ``word_nw`` (W,) float32;
    - ``host_valid``, ``host_wm`` (N,) bool, ``slot_to_id`` (N,) int,
      ``free_slots`` (list, next free slot last);
    - ``signatures``: a list of dicts with ``SIGNATURE_FIELDS`` and
      ``links``, a list of (to_id, type, transform (3,4), information (6,6));
    - ``stm``, ``wm`` (id lists, oldest first), ``next_id``, ``map_id``,
      ``n_inter_wm``;
    - ``posterior`` (N+1,) float32;
    - engine scalars ``last_hypothesis`` (id, value), ``loop_closure_id``,
      ``last_pose`` (3,4) or None, ``distance_travelled``,
      ``distance_at_last_loc``, ``last_process_stamp``, and
      ``optimized_poses`` {id: (3,4)}.
    """
    node_words = np.asarray(state["node_words"])
    N, K = node_words.shape
    slam = Rtabmap(cam, params, node_capacity=N, words_per_frame=K, device=device)
    mem = slam.memory
    dev = slam.device
    mem.vocab = VWDictionary.from_state(state["vocab"], device=dev)

    def put(dst: torch.Tensor, src):
        dst.copy_(torch.from_numpy(np.array(src)).to(dst.dtype))

    put(mem.node_words, node_words)
    put(mem.node_valid, np.asarray(state["node_valid"], bool))
    put(mem.node_uv, np.asarray(state["node_uv"], np.float32))
    put(mem.node_pts, np.asarray(state["node_pts"], np.float32))
    mem.word_nw = torch.from_numpy(np.asarray(state["word_nw"], np.float32).copy()).to(dev)
    mem.host_valid = np.asarray(state["host_valid"], bool).copy()
    mem.host_wm = np.asarray(state["host_wm"], bool).copy()
    mem._slot_to_id = np.asarray(state["slot_to_id"], np.int64).copy()
    mem._free_slots = [int(s) for s in state["free_slots"]]

    for rec in state["signatures"]:
        sig = Signature(**{k: rec[k] for k in SIGNATURE_FIELDS})
        for to_id, typ, transform, information in rec["links"]:
            sig.links[int(to_id)] = Link(sig.id, int(to_id), int(typ),
                                         np.asarray(transform, np.float32),
                                         np.asarray(information, np.float32))
        mem.signatures[sig.id] = sig
    mem.stm = IdList(int(i) for i in state["stm"])
    mem.wm = IdList(int(i) for i in state["wm"])
    mem._next_id = int(state["next_id"])
    mem._map_id = int(state["map_id"])
    mem.n_inter_wm = int(state["n_inter_wm"])

    put(slam.bayes.state.posterior, np.asarray(state["posterior"], np.float32))
    hyp_id, hyp_value = state["last_hypothesis"]
    slam.last_hypothesis = (int(hyp_id), float(hyp_value))
    slam.loop_closure_id = int(state["loop_closure_id"])
    last_pose = state["last_pose"]
    slam._last_pose = None if last_pose is None else np.asarray(last_pose, np.float32)
    slam._distance_travelled = float(state["distance_travelled"])
    slam._distance_at_last_loc = float(state["distance_at_last_loc"])
    slam._last_process_stamp = float(state["last_process_stamp"])
    slam.optimized_poses.update(state["optimized_poses"])
    return slam
