"""SQLite map store: persistence, checkpoint/resume, multi-session.

Port of ``rtabmap_tpu/memory/db.py`` (the reference's ``DBDriverSqlite3``
and its asynchronous writer thread). Tables: Node, Data, Link, Word, Info,
Statistics, Admin. Array columns hold ``np.save`` bytes compressed by zlib
at level 1, exactly as the JAX package writes them, so a store written by
either package opens in the other with equal arrays.

Differences from the twin, none of them on disk:

- Laser scans and local occupancy grids (the ``scan`` and ``grid`` columns
  of Data) are carried as their stored blobs: the port has no
  ``LaserScan``/``LocalGrid`` yet, so ``load_signature`` puts the blob
  (``bytes``) into ``Signature.scan`` / ``Signature.grid`` and
  ``save_signature`` writes such a blob back unchanged; loading and
  re-saving a store written by the JAX package loses nothing. A grid given
  as a ``LocalGrid``-like named tuple of arrays is packed as the twin
  packs it; a scan given as anything but a blob raises.
- ``save_signature`` builds its row (every array packed) on the caller's
  thread from the signature's host arrays, and refuses a signature whose
  deferred create is still in flight: the writer thread never touches a
  device tensor. ``save_raw_frame`` takes host arrays and packs them on
  the writer thread.
"""
from __future__ import annotations

import io
import json
import queue
import sqlite3
import threading
import traceback
import zlib
from typing import Dict, List, Optional

import numpy as np

from rtabmap_tpu_torch.core.frame import EnvSensor
from rtabmap_tpu_torch.memory.memory import Link, Signature

_SCHEMA = """
CREATE TABLE IF NOT EXISTS Node (
    id INTEGER PRIMARY KEY,
    map_id INTEGER NOT NULL,
    weight INTEGER DEFAULT 0,
    stamp FLOAT DEFAULT 0,
    pose BLOB,
    label TEXT,
    ground_truth BLOB,
    velocity BLOB,
    gps BLOB
);
CREATE TABLE IF NOT EXISTS Data (
    id INTEGER PRIMARY KEY,
    word_ids BLOB,
    descriptors BLOB,
    keypoints BLOB,
    points3d BLOB,
    valid3d BLOB,
    image BLOB,
    depth BLOB,
    scan BLOB,
    user_data BLOB,
    calibration BLOB,
    grid BLOB,
    env_sensors BLOB,
    global_desc BLOB
);
CREATE TABLE IF NOT EXISTS Link (
    from_id INTEGER NOT NULL,
    to_id INTEGER NOT NULL,
    type INTEGER NOT NULL,
    transform BLOB,
    information BLOB,
    PRIMARY KEY (from_id, to_id, type)
);
CREATE TABLE IF NOT EXISTS Word (
    id INTEGER PRIMARY KEY,
    descriptor BLOB
);
CREATE TABLE IF NOT EXISTS Info (
    STM_size INTEGER,
    last_sign_added INTEGER,
    process_mem_used INTEGER,
    database_mem_used INTEGER,
    dictionary_size INTEGER,
    parameters TEXT,
    time_enter DATE
);
CREATE TABLE IF NOT EXISTS Statistics (
    id INTEGER,
    stamp FLOAT,
    data TEXT
);
CREATE TABLE IF NOT EXISTS Admin (
    version TEXT,
    opt_poses BLOB,
    opt_ids BLOB,
    vocab_slab BLOB,
    vocab_meta TEXT,
    map2d BLOB,
    opt_cloud BLOB,
    opt_mesh BLOB,
    time_enter DATE
);
"""

# Columns added after a schema version shipped, applied with ALTER TABLE on
# open (the reference's backward_compatibility migrations).
_MIGRATIONS = [
    ("Data", "scan BLOB"),
    ("Data", "user_data BLOB"),
    ("Data", "calibration BLOB"),
    ("Data", "grid BLOB"),
    ("Data", "env_sensors BLOB"),
    ("Data", "global_desc BLOB"),
    ("Admin", "map2d BLOB"),
    ("Admin", "opt_cloud BLOB"),
    ("Admin", "opt_mesh BLOB"),
    ("Node", "ground_truth BLOB"),
    ("Node", "velocity BLOB"),
    ("Node", "gps BLOB"),
]


def _pack_npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items() if v is not None})
    return zlib.compress(buf.getvalue(), 1)


def _unpack_npz(blob):
    if blob is None:
        return None
    with np.load(io.BytesIO(zlib.decompress(blob)), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _pack(arr) -> Optional[bytes]:
    if arr is None:
        return None
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return zlib.compress(buf.getvalue(), 1)


def _unpack(blob) -> Optional[np.ndarray]:
    if blob is None:
        return None
    return np.load(io.BytesIO(zlib.decompress(blob)), allow_pickle=False)


def _pack_scan(scan) -> Optional[bytes]:
    """A stored scan blob passes through unchanged; the port has no
    ``LaserScan`` to pack yet."""
    if scan is None or isinstance(scan, bytes):
        return scan
    raise NotImplementedError("saving a laser scan is not ported yet; it comes with "
                              "the core/laser_scan.py slice")


def _pack_grid(grid) -> Optional[bytes]:
    """A stored grid blob passes through unchanged; a ``LocalGrid``-like
    named tuple of arrays is packed as the twin packs it (valid cells
    only)."""
    if grid is None or isinstance(grid, bytes):
        return grid
    g = {k: np.asarray(v) for k, v in grid._asdict().items()}
    buf = io.BytesIO()
    np.savez(buf,
             ground=g["ground"][g["ground_valid"].astype(bool)],
             obstacles=g["obstacles"][g["obstacles_valid"].astype(bool)],
             empty=g["empty"][g["empty_valid"].astype(bool)])
    return zlib.compress(buf.getvalue(), 1)


class Database:
    """Threaded SQLite map store: writes go through one writer thread in
    order, reads run on the caller's thread after taking the lock."""

    VERSION = "rtabmap_tpu-0.1"

    def __init__(self, path: str = ":memory:", async_writes: bool = True):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.executescript(_SCHEMA)
        for table, coldef in _MIGRATIONS:
            have = {r[1] for r in self._conn.execute(f"PRAGMA table_info({table})")}
            if coldef.split()[0] not in have:
                self._conn.execute(f"ALTER TABLE {table} ADD COLUMN {coldef}")
        self._conn.commit()
        self._lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_writes
        self._stop = False
        self._error: Optional[Exception] = None
        if async_writes:
            self._thread = threading.Thread(target=self._writer_loop, daemon=True)
            self._thread.start()

    # ----------------------------------------------------------- writer thread
    def _writer_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception as e:  # the writer outlives a bad row; flush() reports it
                traceback.print_exc()
                self._error = self._error or e

    def _submit(self, fn, *args):
        if self._async and not self._stop:
            self._q.put((fn, args))
        else:
            fn(*args)

    def flush(self):
        """Wait for every queued write (the reference joins its trash
        thread before a retrieval); raises if a queued write failed."""
        if self._async and not self._stop:
            done = threading.Event()
            self._q.put((done.set, ()))
            done.wait()
        if self._error is not None:
            raise RuntimeError("a queued map-store write failed") from self._error

    def close(self):
        try:
            self.flush()
        finally:
            self._stop = True
            if self._async:
                self._q.put(None)
                self._thread.join(timeout=5)
            with self._lock:
                self._conn.commit()
                self._conn.close()

    # -------------------------------------------------------------- signatures
    def save_signature(self, sig: Signature) -> None:
        self._submit(self._save_signature_now, self._sig_row(sig))

    @staticmethod
    def _sig_row(sig: Signature) -> Dict:
        if sig.pending_word_ids is not None:
            raise RuntimeError(f"signature {sig.id} is saved before its deferred create "
                               "was finalized")
        links = [(lk.from_id, lk.to_id, lk.type, _pack(lk.transform), _pack(lk.information))
                 for lk in sig.links.values()]
        return {
            "id": sig.id, "map_id": sig.map_id, "weight": sig.weight,
            "stamp": sig.stamp, "pose": _pack(sig.pose), "label": sig.label,
            "ground_truth": _pack(sig.gt_pose), "velocity": _pack(sig.velocity),
            "gps": _pack(sig.gps),
            "word_ids": _pack(sig.word_ids), "descriptors": _pack(sig.desc),
            "keypoints": _pack(sig.uv), "points3d": _pack(sig.pts3d),
            "valid3d": _pack(sig.valid3d), "links": links,
            "user_data": sig.user_data, "scan": _pack_scan(sig.scan),
            "grid": _pack_grid(sig.grid),
            "env_sensors": (_pack(np.asarray([(e.type, e.value, e.stamp)
                                              for e in sig.env_sensors], np.float64))
                            if sig.env_sensors else None),
            "global_desc": _pack(sig.global_desc),
        }

    def _save_signature_now(self, row):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO Node"
                " (id,map_id,weight,stamp,pose,label,ground_truth,velocity,gps)"
                " VALUES (?,?,?,?,?,?,?,?,?)",
                (row["id"], row["map_id"], row["weight"], row["stamp"], row["pose"],
                 row["label"], row["ground_truth"], row["velocity"], row["gps"]))
            # upsert only this writer's columns: INSERT OR REPLACE would wipe
            # the raw image/depth columns of save_raw_frame
            cols = ("word_ids", "descriptors", "keypoints", "points3d", "valid3d",
                    "user_data", "scan", "grid", "env_sensors", "global_desc")
            self._conn.execute(
                f"INSERT INTO Data (id,{','.join(cols)}) VALUES ({','.join('?' * 11)})"
                " ON CONFLICT(id) DO UPDATE SET "
                + ",".join(f"{c}=excluded.{c}" for c in cols),
                (row["id"],) + tuple(row[c] for c in cols))
            for f, t, ty, tr, inf in row["links"]:
                self._conn.execute(
                    "INSERT OR REPLACE INTO Link (from_id,to_id,type,transform,information)"
                    " VALUES (?,?,?,?,?)", (f, t, ty, tr, inf))
            self._conn.commit()

    def load_signature(self, sid: int) -> Optional[Signature]:
        """The stored signature as an LTM record (``in_ltm`` set), with its
        outgoing links; None when the id is not stored."""
        with self._lock:
            node = self._conn.execute(
                "SELECT id,map_id,weight,stamp,pose,label,ground_truth,velocity,gps"
                " FROM Node WHERE id=?", (sid,)).fetchone()
            if node is None:
                return None
            data = self._conn.execute(
                "SELECT word_ids,descriptors,keypoints,points3d,valid3d,user_data,"
                "scan,grid,env_sensors,global_desc FROM Data WHERE id=?", (sid,)).fetchone()
            links = self._conn.execute(
                "SELECT from_id,to_id,type,transform,information FROM Link"
                " WHERE from_id=?", (sid,)).fetchall()
        sig = Signature(id=node[0], map_id=node[1], weight=node[2], stamp=node[3],
                        pose=_unpack(node[4]), label=node[5] or "")
        sig.gt_pose, sig.velocity, sig.gps = (_unpack(b) for b in node[6:9])
        if data is not None:
            (sig.word_ids, sig.desc, sig.uv, sig.pts3d,
             sig.valid3d) = (_unpack(b) for b in data[:5])
            sig.user_data, sig.scan, sig.grid = data[5], data[6], data[7]
            if data[8] is not None:
                sig.env_sensors = [EnvSensor(int(t), float(v), float(s))
                                   for t, v, s in _unpack(data[8])]
            sig.global_desc = _unpack(data[9])
        for f, t, ty, tr, inf in links:
            sig.links[t] = Link(f, t, ty, _unpack(tr), _unpack(inf))
        sig.in_ltm = True
        return sig

    # ------------------------------------------------------------- raw frames
    def save_raw_frame(self, sid: int, map_id: int = 0, stamp: float = 0.0, pose=None,
                       image: Optional[np.ndarray] = None,
                       depth: Optional[np.ndarray] = None,
                       calibration: Optional[bytes] = None) -> None:
        """Record a raw sensor frame (host arrays) in the Data table (the
        reference's DataRecorder); packed on the writer thread."""
        if pose is None:
            pose = np.eye(3, 4, dtype=np.float32)
        arrays = tuple(None if a is None else np.asarray(a) for a in (pose, image, depth))
        self._submit(self._save_raw_now, sid, map_id, stamp, arrays, calibration)

    def _save_raw_now(self, sid, map_id, stamp, arrays, calibration):
        pose, image, depth = (_pack(a) for a in arrays)
        with self._lock:
            # keep a full signature's Node row (weight, label, ground truth)
            self._conn.execute(
                "INSERT INTO Node (id,map_id,weight,stamp,pose,label)"
                " VALUES (?,?,0,?,?,'')"
                " ON CONFLICT(id) DO UPDATE SET stamp=excluded.stamp",
                (sid, map_id, stamp, pose))
            self._conn.execute(
                "INSERT INTO Data (id,image,depth,calibration) VALUES (?,?,?,?)"
                " ON CONFLICT(id) DO UPDATE SET image=excluded.image,"
                " depth=excluded.depth,calibration=excluded.calibration",
                (sid, image, depth, calibration))
            self._conn.commit()

    def load_raw_frame(self, sid: int):
        """-> (image, depth, calibration bytes) or None."""
        with self._lock:
            r = self._conn.execute(
                "SELECT image,depth,calibration FROM Data WHERE id=?", (sid,)).fetchone()
        if r is None:
            return None
        return _unpack(r[0]), _unpack(r[1]), r[2]

    def all_node_ids(self) -> List[int]:
        with self._lock:
            return [r[0] for r in self._conn.execute("SELECT id FROM Node ORDER BY id")]

    def node_infos(self) -> List[Dict]:
        """Per-node header rows without the Data blobs."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT id,map_id,weight,stamp,pose,ground_truth FROM Node ORDER BY id"
            ).fetchall()
        return [{"id": r[0], "map_id": r[1], "weight": r[2], "stamp": r[3],
                 "pose": _unpack(r[4]), "gt": _unpack(r[5])} for r in rows]

    def delete_node(self, sid: int) -> None:
        """Remove a node's rows (Node, Data, Statistics and every link
        touching it), so a deleted location stays deleted after resume."""
        self._submit(self._delete_node_now, sid)

    def _delete_node_now(self, sid: int) -> None:
        with self._lock:
            for table in ("Node", "Data", "Statistics"):
                self._conn.execute(f"DELETE FROM {table} WHERE id=?", (sid,))
            self._conn.execute("DELETE FROM Link WHERE from_id=? OR to_id=?", (sid, sid))
            self._conn.commit()

    def delete_link(self, from_id: int, to_id: int) -> None:
        """Remove a stored edge in both directions (a rejected or repaired
        closure stays gone after resume)."""
        self._submit(self._delete_link_now, from_id, to_id)

    def _delete_link_now(self, from_id: int, to_id: int) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM Link WHERE (from_id=? AND to_id=?) OR (from_id=? AND to_id=?)",
                (from_id, to_id, to_id, from_id))
            self._conn.commit()

    def all_links(self) -> List[Link]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT from_id,to_id,type,transform,information FROM Link").fetchall()
        return [Link(f, t, ty, _unpack(tr), _unpack(inf)) for f, t, ty, tr, inf in rows]

    # ------------------------------------------------------------- statistics
    def save_statistics(self, node_id: int, stamp: float, data: Dict[str, float]):
        self._submit(self._save_stats_now, node_id, stamp, json.dumps(data))

    def _save_stats_now(self, node_id, stamp, blob):
        with self._lock:
            self._conn.execute("INSERT INTO Statistics (id,stamp,data) VALUES (?,?,?)",
                               (node_id, stamp, blob))
            self._conn.commit()

    def load_statistics(self) -> List[Dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id,stamp,data FROM Statistics ORDER BY id").fetchall()
        return [{"id": r[0], "stamp": r[1], **json.loads(r[2])} for r in rows]

    # ------------------------------------------------------------------ admin
    def save_admin(self, params: Optional[Dict] = None,
                   optimized_poses: Optional[Dict[int, np.ndarray]] = None,
                   vocab=None, map2d=None, opt_cloud=None, opt_mesh=None):
        """Checkpoint the map's derived products beside the optimized poses
        and the vocabulary (``vocab``: a ``VWDictionary``; only its
        ``n_words`` valid rows are stored). map2d: (grid (H,W) int8,
        origin_xy (2,), cell_size); opt_cloud: (points (N,3)[, colors]);
        opt_mesh: (vertices, faces[, colors]). A product not given keeps
        its stored value."""
        self.flush()
        map2d_b = cloud_b = mesh_b = None
        if map2d is not None:
            grid2, origin, cell = map2d
            map2d_b = _pack_npz(grid=grid2, origin=origin, cell=np.float32(cell))
        if opt_cloud is not None:
            cloud_b = _pack_npz(points=opt_cloud[0],
                                colors=opt_cloud[1] if len(opt_cloud) > 1 else None)
        if opt_mesh is not None:
            mesh_b = _pack_npz(vertices=opt_mesh[0], faces=opt_mesh[1],
                               colors=opt_mesh[2] if len(opt_mesh) > 2 else None)
        opt_ids = opt_poses = None
        if optimized_poses:
            ids = sorted(optimized_poses)
            opt_ids = _pack(np.asarray(ids, np.int64))
            opt_poses = _pack(np.stack([np.asarray(optimized_poses[i]) for i in ids]))
        vocab_slab = vocab_meta = None
        if vocab is not None:
            n = vocab.n_words
            vocab_slab = _pack(vocab.slab[:n].cpu().numpy())
            vocab_meta = json.dumps({"n_words": n, "nndr": vocab.nndr,
                                     "incremental": vocab.incremental,
                                     "capacity": vocab.capacity})
        with self._lock:
            prev = self._conn.execute("SELECT map2d,opt_cloud,opt_mesh FROM Admin").fetchone()
            if prev is not None:
                map2d_b = map2d_b or prev[0]
                cloud_b = cloud_b or prev[1]
                mesh_b = mesh_b or prev[2]
            self._conn.execute("DELETE FROM Admin")
            self._conn.execute(
                "INSERT INTO Admin (version,opt_poses,opt_ids,vocab_slab,vocab_meta,"
                "map2d,opt_cloud,opt_mesh,time_enter) VALUES (?,?,?,?,?,?,?,?,datetime('now'))",
                (self.VERSION, opt_poses, opt_ids, vocab_slab, vocab_meta, map2d_b, cloud_b,
                 mesh_b))
            if params is not None:
                self._conn.execute("DELETE FROM Info")
                self._conn.execute(
                    "INSERT INTO Info (parameters,time_enter) VALUES (?,datetime('now'))",
                    (json.dumps(params),))
            self._conn.commit()

    def load_admin(self) -> Dict:
        with self._lock:
            row = self._conn.execute(
                "SELECT version,opt_poses,opt_ids,vocab_slab,vocab_meta,map2d,opt_cloud,"
                "opt_mesh FROM Admin").fetchone()
            info = self._conn.execute("SELECT parameters FROM Info").fetchone()
        out = {"version": None, "optimized_poses": {}, "vocab": None, "parameters": {},
               "map2d": None, "opt_cloud": None, "opt_mesh": None}
        if row is not None:
            out["version"] = row[0]
            if row[1] is not None and row[2] is not None:
                poses, ids = _unpack(row[1]), _unpack(row[2])
                out["optimized_poses"] = {int(i): poses[k] for k, i in enumerate(ids)}
            if row[3] is not None:
                out["vocab"] = {"slab": _unpack(row[3]), **json.loads(row[4])}
            out["map2d"] = _unpack_npz(row[5])
            out["opt_cloud"] = _unpack_npz(row[6])
            out["opt_mesh"] = _unpack_npz(row[7])
        if info is not None and info[0]:
            out["parameters"] = json.loads(info[0])
        return out

    def max_node_id(self) -> int:
        with self._lock:
            r = self._conn.execute("SELECT MAX(id) FROM Node").fetchone()
        return int(r[0]) if r and r[0] else 0

    def max_map_id(self) -> int:
        with self._lock:
            r = self._conn.execute("SELECT MAX(map_id) FROM Node").fetchone()
        return int(r[0]) if r and r[0] is not None else -1
