"""Dataset benchmark loop: camera stream -> odometry -> SLAM -> ATE.

Port of ``run_dataset`` from ``rtabmap_tpu/tools/dataset_runner.py`` (the
reference's RgbdDataset main loop: odometry, covariance >= 9999 starts a
new map, the end-of-run ``graph::calcRMSE``) for RGB-D frames: each
frame's features go through ``OdometryF2M.process`` and
``Rtabmap.process``, with the frame's laser scan and local grid when it
carries them. With a map store (``db``) each frame's raw image and
depth go to ``process`` for the store. ``slam`` continues an engine the
caller made (e.g. ``Rtabmap.load`` of a store, for a resumed or a
localization session) with a new odometry. Stereo frames, IMU samples,
learned feature extraction, the KITTI error metrics and profile traces
raise ``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device


def _later(what: str, slice_: str):
    return NotImplementedError(f"{what} is not ported yet; it comes with {slice_}")


def run_dataset(frames: Iterable, camera, params=None, stereo_model=None,
                max_kp: int = 512, node_capacity: int = 1024, db=None,
                verbose: bool = True, max_frames: int = 0, kitti_errors: bool = False,
                imu_method: str = "madgwick", device: DeviceLike = None,
                seed: int = 0, slam=None) -> Dict:
    """Run odometry + SLAM over ``frames`` (``datasets.readers.Frame``
    records with depth) on ``device`` (None = the CUDA card); ``seed``
    shifts the RANSAC generators of the odometry (seed) and of a new
    engine (42 + seed); ``slam`` is an engine to continue instead (its
    own ``db`` is used). Returns the metrics, the trajectories and
    per-frame host times in ms: ``extract_ms``, ``odom_ms`` (ends in the
    odometry's fetch of the pose) and ``process_ms`` (ends in a device
    synchronize)."""
    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import transform as T
    from rtabmap_tpu_torch.odometry.f2m import OdometryF2M
    from rtabmap_tpu_torch.utils import metrics
    from rtabmap_tpu_torch.utils.params import Parameters

    dev = resolve_device(device)
    if stereo_model is not None:
        raise _later("stereo input", "the stereo/IMU slice (ops/stereo.py)")
    if kitti_errors:
        raise _later("the KITTI sequence errors", "the dataset-readers slice")
    p = params or Parameters()
    if str(p["Tpu/ProfileDir"]):
        raise _later("Tpu/ProfileDir traces",
                     "a later slice; use tools/rgbd_laps.py --profile")
    odom = OdometryF2M(camera, p, seed=seed, device=dev)
    if slam is None:
        slam = Rtabmap(camera, p, db=db, node_capacity=node_capacity,
                       words_per_frame=max_kp, seed=42 + seed, device=dev)
    keep_raw = slam.memory.db is not None
    use_odom_features = bool(p["Mem/UseOdomFeatures"])
    kp_budget = int(p["Kp/MaxFeatures"])
    if kp_budget <= 0 or kp_budget > max_kp:
        kp_budget = max_kp
    fe = FeatureExtractor(camera, p, max_kp=max_kp, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    est_odom, est_stamps, gt_poses = [], [], []
    times = {"extract_ms": [], "odom_ms": [], "process_ms": []}
    n_loops = n_lost = 0
    prev_wheel = None   # external odometry (CidSimsDataset --odom fallback)
    t0 = time.time()
    for i, fr in enumerate(frames):
        if max_frames and i >= max_frames:
            break
        if fr.imu:
            raise _later("IMU gravity alignment", "the stereo/IMU slice "
                         "(odometry/imu_filter.py)")
        if fr.depth is None:
            raise _later("frames without depth (stereo)", "the stereo/IMU slice")
        _t = time.perf_counter()
        feat, _ = fe.extract(fr.gray, fr.depth)
        sync()
        extract_ms = (time.perf_counter() - _t) * 1000.0
        capture_stats = {
            "TimingMem/Keypoints detection/ms": extract_ms,
            "TimingMem/Descriptors extraction/ms": 0.0, "TimingMem/Keypoints 3D/ms": 0.0,
            "TimingMem/Keypoints 3D motion/ms": 0.0, "TimingMem/Subpixel/ms": 0.0,
            "TimingMem/Post decimation/ms": 0.0, "TimingMem/Rectification/ms": 0.0,
            "TimingMem/Stereo correspondences/ms": 0.0,
            "TimingMem/Scan filtering/ms": 0.0, "TimingMem/Occupancy grid/ms": 0.0,
            "TimingMem/Markers detection/ms": 0.0, "Memory/Images buffered/": 0}
        _t = time.perf_counter()
        pose, cov, info = odom.process(feat)
        pose = None if pose is None else pose.cpu().numpy()
        odom_ms = (time.perf_counter() - _t) * 1000.0
        if pose is None:
            n_lost += 1
            if fr.odom_pose is not None and prev_wheel is not None and est_odom:
                # re-seed the odometry from the external odometry's delta
                pose = np.asarray(T.np_compose(
                    est_odom[-1], T.np_relative(prev_wheel, fr.odom_pose)), np.float32)
                odom.reset(pose)
            else:
                pose = odom.pose.cpu().numpy()
            cov = np.eye(6) * 9999.0
        else:
            cov = cov.cpu().numpy()
        if fr.odom_pose is not None:
            prev_wheel = fr.odom_pose
        slam_feat = feat
        if not use_odom_features:
            # an independent Kp/-budget feature set for the map node
            keep = torch.arange(feat.uv.shape[0], device=dev) < kp_budget
            slam_feat = feat._replace(valid=feat.valid & keep, valid3d=feat.valid3d & keep)
        _t = time.perf_counter()
        st = slam.process(slam_feat, pose, cov, stamp=fr.stamp, gt_pose=fr.gt_pose,
                          scan=fr.scan, grid=fr.grid,
                          raw=(fr.gray, fr.depth) if keep_raw else None,
                          extra_stats={"Odometry/TotalTime/ms": odom_ms, **capture_stats})
        sync()
        times["process_ms"].append((time.perf_counter() - _t) * 1000.0)
        times["extract_ms"].append(extract_ms)
        times["odom_ms"].append(odom_ms)
        n_loops += int(st.loop_closure_id > 0)
        est_odom.append(np.asarray(pose, np.float32))
        est_stamps.append(fr.stamp)
        gt_poses.append(fr.gt_pose)
        if verbose and (i + 1) % 50 == 0:
            print(f"frame {i+1}: odom inliers={info['inliers']} loops={n_loops} "
                  f"wm={int(st.get('Memory/Working memory size/'))} "
                  f"({(i+1)/(time.time()-t0):.1f} fps)")

    elapsed = time.time() - t0
    opt = slam.get_optimized_poses()
    ids = sorted(opt)
    est_slam = np.stack([opt[i] for i in ids]) if ids else np.zeros((0, 3, 4))
    out = {"frames": len(est_odom), "elapsed_s": elapsed,
           "fps": len(est_odom) / max(elapsed, 1e-9), "loops": n_loops, "lost": n_lost,
           "est_odom": np.stack(est_odom) if est_odom else np.zeros((0, 3, 4)),
           "est_slam": est_slam, "stamps": est_stamps, "slam": slam, "odom": odom, **times}
    have_gt = [k for k, g in enumerate(gt_poses) if g is not None]
    if len(have_gt) >= 5:
        gt = np.stack([gt_poses[k] for k in have_gt])
        out["ate_odom"] = metrics.ate_rmse(out["est_odom"][have_gt], gt)
        if est_slam.shape[0] == len(est_odom):
            out["ate_slam"] = metrics.ate_rmse(est_slam[have_gt], gt)
    if verbose:
        msg = (f"done: {out['frames']} frames in {elapsed:.1f}s ({out['fps']:.2f} fps), "
               f"{n_loops} loops, {n_lost} lost")
        if "ate_slam" in out:
            msg += f", ATE slam={out['ate_slam']:.4f} odom={out['ate_odom']:.4f}"
        print(msg)
    return out
