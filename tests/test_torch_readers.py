"""Dataset readers, their PNG codec and sensor.yaml reader, the synthetic
layout writer and the KITTI metric: the port against the JAX twins (and
PIL and PyYAML, which the twins use) on fixture layouts written here with
PIL from seeded numpy data.

Tolerances and why: images, stamps, associations, calibrations, IMU
samples and odometry rows exactly (the same bytes and text, parsed the
same way); ground-truth poses to 1e-6 (a float32 rotation from a
quaternion, products in another order); the KITTI errors to 1e-9
relative (float64 on both sides, the same segments).
"""

import numpy as np
import pytest
import yaml
from PIL import Image

from rtabmap_tpu.datasets import readers as JRD
from rtabmap_tpu.utils import metrics as JM
from rtabmap_tpu_torch.datasets import layouts as L
from rtabmap_tpu_torch.datasets import png as PNG
from rtabmap_tpu_torch.datasets import readers as RD
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.utils import metrics as M
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, N = 24, 32, 5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _image(kind, seed=0):
    rng = _rng(seed)
    if kind == "gray8":
        return rng.integers(0, 256, (H, W), dtype=np.uint8)
    if kind == "rgb":
        return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return rng.integers(0, 65536, (H, W), dtype=np.uint16)


@pytest.mark.parametrize("kind", ["gray8", "rgb", "gray16"])
def test_png_codec_matches_pil(tmp_path, kind):
    img = _image(kind)
    for f in range(5):                      # None, Sub, Up, Average, Paeth
        path = str(tmp_path / f"f{f}.png")
        PNG.write_png(path, img, filter_type=f)
        got = PNG.read_png(path)
        assert got.dtype == img.dtype and np.array_equal(got, img), f
        pil = Image.open(path)
        assert np.array_equal(np.asarray(pil).astype(img.dtype), img), f
        assert np.array_equal(PNG.to_gray8(got), np.asarray(pil.convert("L"))), f
    Image.fromarray(img).save(tmp_path / "pil.png")   # PIL's own filters and chunks
    assert np.array_equal(PNG.read_png(str(tmp_path / "pil.png")), img)


def test_png_refuses_other_formats(tmp_path):
    Image.fromarray(_image("rgb")).save(tmp_path / "a.jpg")
    with pytest.raises(ValueError, match="JPEG"):
        RD._load_gray(str(tmp_path / "a.jpg"))
    Image.fromarray(_image("gray8")).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="color type 3"):
        PNG.read_png(str(tmp_path / "p.png"))


ASL_YAML = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
FIXTURE_YAML = """sensor_type: camera
resolution: [32, 24]
intrinsics: [40.5, 41.0, 15.5,
             11.5]
distortion_coefficients: [0.0, 0.0, 0.0, 0.0]
baseline: 0.11
"""


@pytest.mark.parametrize("text", [ASL_YAML, FIXTURE_YAML], ids=["asl", "fixture"])
def test_sensor_yaml_keys_match_pyyaml(tmp_path, text):
    path = tmp_path / "sensor.yaml"
    path.write_text(text)
    got = RD.read_sensor_yaml(str(path))
    ref = yaml.safe_load(text.replace("%YAML:1.0\n", ""))
    for key in ("intrinsics", "resolution", "distortion_coefficients", "baseline"):
        assert got.get(key) == ref.get(key), key


def _same_frames(port_ds, jax_ds):
    pf, jf = list(port_ds), list(jax_ds)
    assert len(pf) == len(jf) == len(port_ds) == len(jax_ds) > 0
    for p, j in zip(pf, jf):
        assert p.stamp == j.stamp
        for name in ("gray", "depth", "right"):
            a, b = getattr(p, name), getattr(j, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        for name in ("gt_pose", "odom_pose"):
            a, b = getattr(p, name), getattr(j, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, err_msg=name)
        assert (p.imu is None) == (j.imu is None)
        if p.imu is not None:
            assert len(p.imu) == len(j.imu)
            for (ta, ga, aa), (tb, gb, ab) in zip(p.imu, j.imu):
                assert ta == tb and np.array_equal(ga, gb) and np.array_equal(aa, ab)
    return pf


def _same_camera(a, b):
    for k in ("fx", "fy", "cx", "cy"):
        assert getattr(a, k) == float(getattr(b, k)), k
    assert (a.width, a.height) == (b.width, b.height)
    assert (a.dist is None) == (b.dist is None)
    if a.dist is not None:
        np.testing.assert_array_equal(a.dist, np.asarray(b.dist))


def _gt_line(rng, stamp):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    return f"{stamp:.6f} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}"


def test_tum_reader_matches_the_twin(tmp_path):
    rng = _rng(3)
    root = tmp_path / "rgbd_dataset_freiburg1_synth"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb, depth, gt = [], [], []
    for i in range(N):
        s = 100.0 + 0.1 * i
        ds = s + (0.011 if i == 2 else 0.004)        # frame 2's depth: 11 ms off
        kind = "rgb" if i == 1 else "gray8"          # one colour frame
        Image.fromarray(_image(kind, i)).save(root / "rgb" / f"{s:.6f}.png")
        Image.fromarray(_image("gray16", i)).save(root / "depth" / f"{ds:.6f}.png")
        rgb.append(f"{s:.6f} rgb/{s:.6f}.png")
        depth.append(f"{ds:.6f} depth/{ds:.6f}.png")
        gt.append(_gt_line(rng, s + 0.003))
    depth.append("110.000000 depth/none.png")         # unassociated
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("# depth\n\n" + "\n".join(depth) + "\n")
    (root / "groundtruth.txt").write_text("# gt\n" + "\n".join(gt) + "\n")
    p, j = RD.TumRgbdDataset(str(root)), JRD.TumRgbdDataset(str(root))
    assert p.pairs == j.pairs and len(p.pairs) == N
    _same_camera(p.camera, j.camera)
    assert p.camera.fx == pytest.approx(RD.TUM_CALIB[1][0] * W / 640.0)
    frames = _same_frames(p, j)
    assert all(f.gt_pose is not None for f in frames)


def test_kitti_reader_matches_the_twin(tmp_path):
    rng = _rng(4)
    seq = tmp_path / "sequences" / "05"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    P0 = np.array([[40.5, 0, 15.5, 0], [0, 40.5, 11.5, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -40.5 * 0.537
    (seq / "calib.txt").write_text("".join(
        f"{n}: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n"
        for n, P in (("P0", P0), ("P1", P1), ("P2", P0))))
    (seq / "times.txt").write_text("\n".join(f"{0.1 * i:.6e}" for i in range(N)) + "\n")
    for i in range(N):
        for cam in ("image_0", "image_1"):
            Image.fromarray(_image("gray8", 10 * i + len(cam))).save(seq / cam / f"{i:06d}.png")
    poses = tmp_path / "05.txt"
    poses.write_text("\n".join(" ".join(repr(float(v)) for v in rng.normal(size=12))
                              for _ in range(N)))
    p, j = RD.KittiDataset(str(seq), str(poses)), JRD.KittiDataset(str(seq), str(poses))
    _same_camera(p.camera, j.camera)
    _same_camera(p.stereo.left, j.stereo.left)
    assert p.stereo.baseline == float(j.stereo.baseline) == pytest.approx(0.537)
    frames = _same_frames(p, j)
    assert all(f.right is not None and f.gt_pose is not None for f in frames)


def _euroc_dir(tmp_path, yaml_text):
    rng = _rng(5)
    mav = tmp_path / "MH" / "mav0"
    rows = ["#timestamp [ns],filename"]
    gt = ["#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z"]
    for cam in ("cam0", "cam1"):
        (mav / cam / "data").mkdir(parents=True)
        (mav / cam / "sensor.yaml").write_text(yaml_text)
    (mav / "state_groundtruth_estimate0").mkdir()
    for i in range(N):
        ns = 1403636579763555584 + i * 50000000
        for k, cam in enumerate(("cam0", "cam1")):
            if cam == "cam1" and i == 3:
                continue                              # a frame without its right image
            Image.fromarray(_image("gray8", 20 * i + k)).save(mav / cam / "data" / f"{ns}.png")
        rows.append(f"{ns},{ns}.png")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        gt.append(f"{ns + 1000}," + ",".join(repr(float(v)) for v in (*rng.normal(size=3), *q)))
    (mav / "cam0" / "data.csv").write_text("\n".join(rows) + "\n")
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text("\n".join(gt) + "\n")
    return str(tmp_path / "MH")


@pytest.mark.parametrize("yaml_text", [ASL_YAML.replace("%YAML:1.0\n", ""), FIXTURE_YAML,
                                       "intrinsics: [1.0, 2.0\nthis is not yaml {[\n"],
                         ids=["asl", "fixture", "unreadable"])
def test_euroc_reader_matches_the_twin(tmp_path, yaml_text):
    root = _euroc_dir(tmp_path, yaml_text)
    p, j = RD.EurocDataset(root), JRD.EurocDataset(root)
    _same_camera(p.camera, j.camera)
    _same_camera(p.stereo.left, j.stereo.left)
    assert p.stereo.baseline == float(j.stereo.baseline)
    frames = _same_frames(p, j)
    assert frames[3].right is None and frames[0].right is not None
    if "not yaml" in yaml_text:                       # the nominal cam0 values
        assert p.camera.fx == pytest.approx(458.654) and p.camera.dist is not None


def _cid_dir(tmp_path):
    rng = _rng(6)
    root = tmp_path / "cid"
    (root / "color").mkdir(parents=True)
    (root / "depth").mkdir()
    gt, odom, imu = [], [], []
    for i in range(N):
        s = 500.0 + 0.1 * i
        Image.fromarray(_image("gray8", i)).save(root / "color" / f"{s:.6f}.png")
        Image.fromarray(_image("gray16", i)).save(root / "depth" / f"{s + 0.02:.6f}.png")
        gt.append(_gt_line(rng, s))
        row = [f"{s:.6f}"] + ["0"] * 13
        row[8], row[13] = repr(float(rng.uniform(0, 1))), repr(float(rng.uniform(-1, 1)))
        odom.append(" ".join(row))
        for k in range(4):
            imu.append(f"{s - 0.1 + 0.025 * (k + 1):.6f} "
                       + " ".join(repr(float(v)) for v in rng.normal(size=6)))
    (root / "color" / "notes.txt").write_text("not a frame")
    (root / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    (root / "odom.txt").write_text("\n".join(odom) + "\n")
    (root / "imu.txt").write_text("# t gx gy gz ax ay az\n" + "\n".join(imu) + "\n")
    return str(root)


def test_cid_sims_reader_matches_the_twin(tmp_path):
    root = _cid_dir(tmp_path)
    for kw in ({}, {"use_odom": True, "use_imu": True}):
        p, j = RD.CidSimsDataset(root, **kw), JRD.CidSimsDataset(root, **kw)
        assert p.pairs == j.pairs and len(p.odom) == len(j.odom)
        _same_camera(p.camera, j.camera)
        frames = _same_frames(p, j)
    assert sum(len(f.imu) for f in frames) == 4 * N    # each sample once, up to the last stamp
    assert frames[-1].odom_pose is not None


def test_layout_writer_reads_back_in_both_packages(tmp_path):
    """The port's CID-SIMS layout (rendered, 16-bit depth, imu.txt) read by
    both readers alike; its IMU integrates to the ground truth's roll and
    pitch (Madgwick, within 5 mrad)."""
    import torch

    from rtabmap_tpu_torch.odometry.imu_filter import integrate_imu

    poses = L.ceiling_trajectory(8, 2)
    L.write_cid_sims(str(tmp_path / "cid"), poses, (64, 48), device="cpu")
    p = RD.CidSimsDataset(str(tmp_path / "cid"), use_imu=True)
    frames = _same_frames(p, JRD.CidSimsDataset(str(tmp_path / "cid"), use_imu=True))
    assert all(f.depth.max() > 0 for f in frames)
    q, prev = None, None
    for f, pose in zip(frames, poses):
        t = np.array([s[0] for s in f.imu])
        dt = np.diff(t, prepend=t[0] if prev is None else prev).astype(np.float32)
        prev = t[-1]
        q = integrate_imu(torch.tensor(np.stack([s[1] for s in f.imu])),
                          torch.tensor(np.stack([s[2] for s in f.imu])),
                          torch.from_numpy(dt), q0=q)[-1]
        rp = T.to_xyzrpy(T.from_quaternion(q)).numpy()[3:5]
        np.testing.assert_allclose(rp, T.np_to_xyzrpy(pose)[3:5], atol=5e-3)
        np.testing.assert_allclose(f.gt_pose, pose, atol=1e-6)


def test_kitti_sequence_errors_match_the_twin():
    rng = _rng(7)
    n = 1000                                   # ~1.2 km: every segment length 100-800 m
    yaw = np.cumsum(rng.normal(0, 0.02, n))
    step = np.stack([np.cos(yaw), np.sin(yaw), rng.normal(0, 0.01, n)], -1) * 1.2
    gt = np.zeros((n, 3, 4))
    gt[:, :, 3] = np.cumsum(step, 0)
    c, s = np.cos(yaw), np.sin(yaw)
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1], gt[:, 2, 2] = c, -s, s, c, 1.0
    est = gt.copy()
    est[:, :, 3] += np.cumsum(rng.normal(0, 0.02, (n, 3)), 0)
    drift = np.cumsum(rng.normal(0, 1e-4, n))
    est[:, 0, 0], est[:, 0, 1] = np.cos(yaw + drift), -np.sin(yaw + drift)
    est[:, 1, 0], est[:, 1, 1] = np.sin(yaw + drift), np.cos(yaw + drift)
    got = M.kitti_sequence_errors(est.astype(np.float32), gt.astype(np.float32))
    ref = JM.kitti_sequence_errors(est.astype(np.float32), gt.astype(np.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    assert got[0] > 0 and got[1] > 0
    d = M._trajectory_distances(gt)
    np.testing.assert_allclose(d, JM._trajectory_distances(gt), rtol=1e-12)
    assert d[-1] > 800 and M._KITTI_LENGTHS == JM._KITTI_LENGTHS
    assert M.kitti_sequence_errors(gt[:50], gt[:50]) == (0.0, 0.0)   # shorter than 100 m
