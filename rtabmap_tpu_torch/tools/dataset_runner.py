"""Dataset benchmark loop: camera stream -> odometry -> SLAM -> ATE.

Port of ``run_dataset`` from ``rtabmap_tpu/tools/dataset_runner.py`` (the
reference's dataset tools' main loop: odometry, covariance >= 9999 starts
a new map, the end-of-run ``graph::calcRMSE``, KittiDataset's
calcKittiSequenceErrors). RGB-D frames are extracted with depth; stereo
frames (a right image and ``stereo_model``) by GFTT/BRIEF, or SuperPoint
with ``Kp/DetectorStrategy`` 11/15/16, on the left image and LK
disparities at its keypoints (``ops/stereo.py``; SuperPoint wants H and W
multiples of 8: EuRoC's 752x480 is; on KITTI's 1241x376 the 2x2 pools
floor, as the twin's VALID pools do, and the last column gets no score). A frame's
IMU samples (at most ``IMU_PAD``) are integrated from the previous
frame's orientation by the Madgwick or complementary filter, and the
tracked pose takes its roll and pitch. Each frame's features go through
``OdometryF2M.process`` and ``Rtabmap.process``, with the frame's laser
scan and local grid when it carries them, and the learned strategies'
float descriptors (``descf``, for ``Vis/CorNNType`` 6). With a map store
(``db``) each frame's raw image and depth go to ``process`` for the store.
``slam`` continues an engine the caller made (e.g. ``Rtabmap.load`` of a
store, for a resumed or a localization session) with a new odometry.
With ``Tpu/ProfileDir`` set the run is traced (``utils/logging.profile_trace``:
``torch.profiler``, each frame a ``slam_tick#i`` range) into that
directory, and the output's ``trace`` gives the file and the device's busy
share of the traced wall time.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device

# IMU samples integrated per frame at most (the twin pads each frame's batch
# to this static length)
IMU_PAD = 64


def extract_stereo_learned(fe, gray, right, stereo_model):
    """SuperPoint (``fe``, a learned ``FeatureExtractor``) on the left image,
    3D from LK stereo at its keypoints -> (FrameFeatures, descf)."""
    from rtabmap_tpu_torch.core.frame import FrameFeatures
    from rtabmap_tpu_torch.ops.stereo import keypoints_3d_from_stereo

    gl, gr = fe._image(gray), fe._image(right)
    kps, desc, descf = fe.extract_superpoint(gl)
    pts, ok = keypoints_3d_from_stereo(kps.uv, kps.valid, gl, gr, stereo_model)
    return FrameFeatures(uv=kps.uv, desc=desc, pts3d=pts, valid=kps.valid, valid3d=ok,
                         angle=kps.angle, response=kps.response), descf


def run_dataset(frames: Iterable, camera, params=None, stereo_model=None,
                max_kp: int = 512, node_capacity: int = 1024, db=None,
                verbose: bool = True, max_frames: int = 0, kitti_errors: bool = False,
                imu_method: str = "madgwick", device: DeviceLike = None,
                seed: int = 0, slam=None) -> Dict:
    """Run odometry + SLAM over ``frames`` (``datasets.readers.Frame``
    records with depth, or a right image with ``stereo_model``) on
    ``device`` (None = the CUDA card); ``seed`` shifts the RANSAC
    generators of the odometry (seed) and of a new engine (42 + seed);
    ``slam`` is an engine to continue instead (its own ``db`` is used).
    ``imu_method`` is "madgwick" or "complementary"; ``kitti_errors``
    adds the KITTI translation and rotation errors. Returns the metrics,
    the trajectories, each frame's IMU orientation (``imu_quat``, None
    without samples) and whether it was tracked (``tracked``), and
    per-frame host times in ms: ``extract_ms`` (with
    the stereo disparities), ``imu_ms`` (frames with samples),
    ``odom_ms`` (ends in the odometry's fetch of the pose) and
    ``process_ms`` (ends in a device synchronize)."""
    from rtabmap_tpu_torch.core.frame import FeatureExtractor, FrameFeatures
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import transform as T
    from rtabmap_tpu_torch.odometry.f2m import OdometryF2M
    from rtabmap_tpu_torch.odometry.imu_filter import integrate_imu
    from rtabmap_tpu_torch.ops import features as F
    from rtabmap_tpu_torch.ops.stereo import keypoints_3d_from_stereo
    from rtabmap_tpu_torch.utils import metrics
    from rtabmap_tpu_torch.utils.logging import profile_trace
    from rtabmap_tpu_torch.utils.params import Parameters

    dev = resolve_device(device)
    p = params or Parameters()
    trace = profile_trace(str(p["Tpu/ProfileDir"]))
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

    def extract_stereo(gray, right):
        # GFTT/BRIEF on the left image, 3D from LK disparities at its keypoints
        gl, gr = fe._image(gray), fe._image(right)
        kps, desc = F.detect_and_describe(gl, max_kp)
        pts, ok = keypoints_3d_from_stereo(kps.uv, kps.valid, gl, gr, stereo_model)
        return FrameFeatures(uv=kps.uv, desc=desc, pts3d=pts, valid=kps.valid, valid3d=ok,
                             angle=kps.angle, response=kps.response)


    est_odom, est_stamps, gt_poses, imu_quats, tracked = [], [], [], [], []
    times = {"extract_ms": [], "imu_ms": [], "odom_ms": [], "process_ms": []}
    n_loops = n_lost = 0
    prev_wheel = None   # external odometry (CidSimsDataset --odom fallback)
    imu_q = prev_imu_t = None

    def tick(i, fr):
        # one frame: features, IMU, odometry, then the engine
        nonlocal n_loops, n_lost, prev_wheel, imu_q, prev_imu_t
        _t = time.perf_counter()
        stereo_used = False
        descf = None
        if fr.depth is not None:
            feat, descf = fe.extract(fr.gray, fr.depth)
        elif fr.right is not None:
            if stereo_model is None:
                raise ValueError("a frame with a right image needs stereo_model")
            if fe.learned:
                feat, descf = extract_stereo_learned(fe, fr.gray, fr.right, stereo_model)
            else:
                feat = extract_stereo(fr.gray, fr.right)
            stereo_used = True
        else:
            raise ValueError("frame has neither depth nor right image")
        sync()
        extract_ms = (time.perf_counter() - _t) * 1000.0
        capture_stats = {
            "TimingMem/Keypoints detection/ms": extract_ms,
            "TimingMem/Descriptors extraction/ms": 0.0, "TimingMem/Keypoints 3D/ms": 0.0,
            "TimingMem/Keypoints 3D motion/ms": 0.0, "TimingMem/Subpixel/ms": 0.0,
            "TimingMem/Post decimation/ms": 0.0, "TimingMem/Rectification/ms": 0.0,
            "TimingMem/Stereo correspondences/ms": extract_ms if stereo_used else 0.0,
            "TimingMem/Scan filtering/ms": 0.0, "TimingMem/Occupancy grid/ms": 0.0,
            "TimingMem/Markers detection/ms": 0.0, "Memory/Images buffered/": 0}
        imu_quat = None
        if fr.imu:
            # the frame's samples since the previous frame, integrated from
            # the previous orientation (dt 0 for the very first sample)
            _t = time.perf_counter()
            batch = fr.imu[:IMU_PAD]
            g_b = np.zeros((len(batch), 3), np.float32)
            a_b = np.zeros((len(batch), 3), np.float32)
            dt_b = np.zeros((len(batch),), np.float32)
            for s_i, (ts, gy, ac) in enumerate(batch):
                dt_b[s_i] = max(ts - prev_imu_t, 0.0) if prev_imu_t is not None else 0.0
                prev_imu_t = ts
                g_b[s_i], a_b[s_i] = gy, ac
            qs = integrate_imu(*(torch.from_numpy(x).to(dev) for x in (g_b, a_b, dt_b)),
                               q0=imu_q, method=imu_method)
            imu_q = imu_quat = qs[-1]
            sync()
            times["imu_ms"].append((time.perf_counter() - _t) * 1000.0)
        imu_quats.append(None if imu_quat is None else imu_quat.cpu().numpy())
        _t = time.perf_counter()
        pose, cov, info = odom.process(feat, imu_quat=imu_quat)
        pose = None if pose is None else pose.cpu().numpy()
        odom_ms = (time.perf_counter() - _t) * 1000.0
        tracked.append(pose is not None)
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
                          raw=(fr.gray, fr.depth) if keep_raw else None, descf=descf,
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

    t0 = time.time()
    with trace:
        for i, fr in enumerate(frames):
            if max_frames and i >= max_frames:
                break
            with trace.step(i):
                tick(i, fr)

    elapsed = time.time() - t0
    opt = slam.get_optimized_poses()
    ids = sorted(opt)
    est_slam = np.stack([opt[i] for i in ids]) if ids else np.zeros((0, 3, 4))
    out = {"frames": len(est_odom), "elapsed_s": elapsed,
           "fps": len(est_odom) / max(elapsed, 1e-9), "loops": n_loops, "lost": n_lost,
           "est_odom": np.stack(est_odom) if est_odom else np.zeros((0, 3, 4)),
           "est_slam": est_slam, "stamps": est_stamps, "slam": slam, "odom": odom,
           "imu_quat": imu_quats, "tracked": tracked, **times}
    if trace.dir:
        out["trace"] = {"path": trace.path, "wall_ms": trace.wall_us / 1e3,
                        "device_busy_ms": trace.busy_us / 1e3,
                        "device_busy_share": trace.busy_share,
                        "device_ops": trace.device_ops}
    have_gt = [k for k, g in enumerate(gt_poses) if g is not None]
    if len(have_gt) >= 5:
        gt = np.stack([gt_poses[k] for k in have_gt])
        eo = out["est_odom"][have_gt]
        es = est_slam[have_gt] if est_slam.shape[0] == len(est_odom) else None
        out["ate_odom"] = metrics.ate_rmse(eo, gt)
        if es is not None:
            out["ate_slam"] = metrics.ate_rmse(es, gt)
        if kitti_errors:
            out["kitti_t_err_pct"], out["kitti_r_err_deg_per_m"] = \
                metrics.kitti_sequence_errors(es if es is not None else eo, gt)
    if verbose:
        msg = (f"done: {out['frames']} frames in {elapsed:.1f}s ({out['fps']:.2f} fps), "
               f"{n_loops} loops, {n_lost} lost")
        if "ate_slam" in out:
            msg += f", ATE slam={out['ate_slam']:.4f} odom={out['ate_odom']:.4f}"
        if trace.dir:
            msg += (f"; trace {trace.path}, device busy share "
                    f"{trace.busy_share:.4f} of {trace.wall_us / 1e3:.1f} ms")
        print(msg)
    return out
