"""How the learned registration (``Vis/CorNNType`` 6) fares between nearby
views, in the JAX package and in the port, on the CPU.

Renders pose 0 and pose k of ``loop_trajectory(n)`` (k*360/n degrees
apart), extracts SuperPoint features in each package
(``Kp/DetectorStrategy`` 11), matches them with the bundled distilled
matcher and registers them (``Memory.compute_transform``, its PnP-RANSAC).
Prints one JSON line a case and package: the matcher's matches with 3D,
how many lie within 4 px of the true projection of A's 3D point into B,
and the registration's inliers.

Usage (from the repository root):
    PYTHONPATH=. python scripts/learned_registration_study.py
"""
from __future__ import annotations

import json

import numpy as np

CASES = (((120.0, 79.5, 59.5, 160, 120), 192, 1), ((120.0, 79.5, 59.5, 160, 120), 48, 1),
         ((300.0, 159.5, 119.5, 320, 240), 96, 1), ((300.0, 159.5, 119.5, 320, 240), 96, 0))


def correct_matches(a, b, idx, ok, f, cx, cy) -> tuple:
    """(matches with A's 3D, those within 4 px of A's point projected into B)."""
    pose_a, pose_b = np.vstack([a["pose"], [0, 0, 0, 1]]), np.vstack([b["pose"], [0, 0, 0, 1]])
    rel = np.linalg.inv(pose_b) @ pose_a          # A's camera frame -> B's
    x = a["pts3d"] @ rel[:3, :3].T + rel[:3, 3]
    u, v = x[:, 0] / x[:, 2] * f + cx, x[:, 1] / x[:, 2] * f + cy
    err = np.hypot(u - b["uv"][idx, 0], v - b["uv"][idx, 1])
    m = ok & a["valid3d"]
    return int(m.sum()), int((m & (err < 4.0)).sum())


def run_jax(cam, n, k) -> dict:
    import jax
    import jax.numpy as jnp

    from rtabmap_tpu.core.frame import FeatureExtractor
    from rtabmap_tpu.datasets import synthetic as S
    from rtabmap_tpu.geometry import camera as C
    from rtabmap_tpu.memory import memory as M
    from rtabmap_tpu.utils.params import Parameters

    f, cx, cy, W, H = cam
    jcam = C.CameraModel.make(f, f, cx, cy, W, H)
    p = Parameters({"Kp/DetectorStrategy": 11, "Vis/CorNNType": 6,
                    "Tpu/VocabularyCapacity": 1024})
    fe = FeatureExtractor(jcam, p, max_kp=128)
    mem = M.Memory(p, node_capacity=4, words_per_frame=128)
    poses = np.asarray(S.loop_trajectory(n))
    sigs = []
    for i, w in enumerate((0, k)):
        fr, descf = fe.extract(*S.render(jnp.asarray(poses[w]), jcam))
        s = {"uv": np.asarray(fr.uv), "desc": np.asarray(fr.desc),
             "pts3d": np.asarray(fr.pts3d), "valid3d": np.asarray(fr.valid3d & fr.valid),
             "descf": np.asarray(descf), "pose": poses[w]}
        mem.signatures[i + 1] = M.Signature(id=i + 1, map_id=0, stamp=float(i), **s)
        sigs.append(s)
    t, _cov, inl = mem.compute_transform(1, 2, jcam, jax.random.PRNGKey(3))
    a, b = sigs
    sc = jnp.full((128,), 0.5)
    idx, ok, _ = mem.py_matcher.match(
        jnp.asarray(a["descf"]), jnp.asarray(a["uv"]), sc, jnp.asarray(a["desc"].any(1)),
        jnp.asarray(b["descf"]), jnp.asarray(b["uv"]), sc, jnp.asarray(b["desc"].any(1)),
        image_wh=(float(W), float(H)), threshold=mem.pymatcher_threshold)
    n_m, n_ok = correct_matches(a, b, np.asarray(idx), np.asarray(ok), f, cx, cy)
    return {"matches_3d": n_m, "within_4px": n_ok, "inliers": inl, "success": t is not None}


def run_port(cam, n, k) -> dict:
    import torch

    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.datasets import synthetic as S
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.memory import memory as M
    from rtabmap_tpu_torch.utils.params import Parameters

    f, cx, cy, W, H = cam
    tcam = C.CameraModel.make(f, f, cx, cy, W, H)
    p = Parameters({"Kp/DetectorStrategy": 11, "Vis/CorNNType": 6,
                    "Tpu/VocabularyCapacity": 1024})
    fe = FeatureExtractor(tcam, p, max_kp=128, device="cpu")
    mem = M.Memory(p, node_capacity=4, words_per_frame=128, device="cpu")
    poses = S.loop_trajectory(n)
    sigs = []
    for i, w in enumerate((0, k)):
        fr, descf = fe.extract(*S.render(poses[w], tcam, device="cpu"))
        s = {"uv": fr.uv.numpy(), "desc": fr.desc.numpy(), "pts3d": fr.pts3d.numpy(),
             "valid3d": (fr.valid3d & fr.valid).numpy(), "descf": descf.numpy(),
             "pose": np.asarray(poses[w])}
        mem.signatures[i + 1] = M.Signature(id=i + 1, map_id=0, stamp=float(i), **s)
        sigs.append(s)
    t, _cov, inl = mem.compute_transform(1, 2, tcam, torch.Generator().manual_seed(3))
    a, b = sigs
    sc = torch.full((128,), 0.5)
    idx, ok, _ = mem.py_matcher.match(a["descf"], a["uv"], sc, a["desc"].any(1), b["descf"],
                                      b["uv"], sc, b["desc"].any(1), image_wh=(W, H),
                                      threshold=mem.pymatcher_threshold)
    n_m, n_ok = correct_matches(a, b, idx.numpy(), ok.numpy(), f, cx, cy)
    return {"matches_3d": n_m, "within_4px": n_ok, "inliers": inl, "success": t is not None}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    for cam, n, k in CASES:
        for pkg, fn in (("jax", run_jax), ("port", run_port)):
            print(json.dumps({"package": pkg, "size": [cam[3], cam[4]],
                              "degrees": 360.0 * k / n, **fn(cam, n, k)}), flush=True)


if __name__ == "__main__":
    main()
