"""Stereo: the port's image pyramid, stereo camera, LK stereo disparities,
stereo keypoints and dense BM / SGBM against the JAX twins on the CPU, on
the same seeded numpy inputs (the stereo pairs rendered once by the
port's renderer and fed to both sides as the same arrays).

Tolerances and why: the pyramid to 1e-6 (float32 band products summed in
another order); the disparity conversions to 3e-7 relative (one float32
product and quotient; XLA's quotient on the CPU can differ by an ulp);
LK disparities to 1e-4 px and the dense SGBM's subpixel disparities to
1e-3 px (float32 patch sums in another order, over 24
Gauss-Newton steps, or 4 x 64 scanline steps); the integer BM
disparities exactly. The ``ok`` / valid masks are equal except at points
whose gated value lies within 1e-4 relative of its threshold (an order of
summation flips such a point); those points are counted and the count is
held small.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.geometry import camera as JC
from rtabmap_tpu.ops import image as JIM
from rtabmap_tpu.ops import stereo as JST
from rtabmap_tpu_torch.datasets import layouts as L
from rtabmap_tpu_torch.datasets.synthetic import loop_trajectory, render
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.ops import features as F
from rtabmap_tpu_torch.ops import image as IM
from rtabmap_tpu_torch.ops import stereo as ST
from torch_port_threads import one_torch_thread  # noqa: F401

ARGS = (120.0, 120.0, 80.0, 60.0)
BASELINE = 0.2
CAM = C.CameraModel.make(*ARGS, 160, 120)
STEREO = C.StereoCameraModel.make(*ARGS, BASELINE, 160, 120)
JSTEREO = JC.StereoCameraModel.make(*ARGS, BASELINE, 160, 120)
REL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """A rendered rectified pair and 128 GFTT keypoints of its left image."""
    pose = loop_trajectory(96)[5]
    left = render(pose, CAM, device="cpu")[0]
    right = render(L._right_pose(pose, BASELINE), CAM, device="cpu")[0]
    kps, _ = F.detect_and_describe(left, 128)
    return left.numpy(), right.numpy(), kps.uv.numpy(), kps.valid.numpy()


def _near(value, threshold):
    return np.abs(value - threshold) <= REL * max(abs(threshold), 1e-3)


def test_pyramid_matches_the_twin():
    img = np.random.default_rng(0).random((48, 64)).astype(np.float32)
    got = IM.pyramid(torch.from_numpy(img), 3)
    ref = JIM.pyramid(jnp.asarray(img), 3)
    assert [g.shape for g in got] == [r.shape for r in ref] == [(48, 64), (24, 32), (12, 16)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    assert IM.decimate(torch.from_numpy(img), 1).shape == (48, 64)


def test_stereo_camera_conversions():
    assert STEREO.left == STEREO.right and STEREO.baseline == float(JSTEREO.baseline)
    assert STEREO.left.fx == float(JSTEREO.left.fx) and STEREO.R is None
    v = np.random.default_rng(1).uniform(-2.0, 60.0, 256).astype(np.float32)
    v[:4] = [0.0, -0.0, 1e-6, 128.0]
    for port, jax_fn in ((C.disparity_to_depth, JC.disparity_to_depth),
                         (C.depth_to_disparity, JC.depth_to_disparity)):
        got = port(torch.from_numpy(v), STEREO).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_fn(jnp.asarray(v), JSTEREO)), rtol=3e-7,
                                   atol=0)
    assert (C.disparity_to_depth(torch.from_numpy(v), STEREO).numpy()[v <= 0] == 0).all()


# one compile a gate setting (eager, the twin's fori_loops compile each call)
_jax_lk = jax.jit(JST.lk_stereo_disparity, static_argnames=("max_disparity", "max_err"))


def _lk_both(pair, **kw):
    left, right, uv, valid = pair
    d_p, ok_p = ST.lk_stereo_disparity(*(torch.from_numpy(x) for x in (left, right, uv, valid)),
                                       **kw)
    d_j, ok_j = _jax_lk(*(jnp.asarray(x) for x in (left, right, uv, valid)), **kw)
    return d_p.numpy(), ok_p.numpy(), np.asarray(d_j), np.asarray(ok_j)


def test_lk_stereo_disparity_matches_the_twin(pair):
    left, right, uv, valid = pair
    # ungated by residual and range: the disparities themselves
    d_p, ok_p, d_j, ok_j = _lk_both(pair, max_disparity=1e9, max_err=1e9)
    both = ok_p & ok_j
    assert both.sum() >= 0.6 * valid.sum()
    np.testing.assert_allclose(d_p[both], d_j[both], atol=1e-4, rtol=0)
    d_any = np.where(ok_j, d_j, d_p)
    near = _near(d_any, 0.25) | _near(uv[:, 0] - d_any, 0.0)
    assert not ((ok_p != ok_j) & ~near).any()
    # the gates of the default call: the residual's rms, from the twin
    offs = JST._lk_offsets(3)
    uv_r = jnp.asarray(uv) - jnp.stack([jnp.asarray(d_j), jnp.zeros(len(d_j))], -1)
    res = (JST._patch_sample(jnp.asarray(left), jnp.asarray(uv), offs)
           - JST._patch_sample(jnp.asarray(right), uv_r, offs))
    rms = np.sqrt(np.mean(np.asarray(res) ** 2, -1))
    near |= _near(rms, 0.08) | _near(d_any, 128.0)
    d_p, ok_p, d_j, ok_j = _lk_both(pair)
    flips = int(((ok_p != ok_j) & near).sum())
    assert not ((ok_p != ok_j) & ~near).any()
    assert flips <= 2, flips                        # near-threshold points that flipped
    both = ok_p & ok_j
    assert both.sum() >= 0.5 * valid.sum()
    np.testing.assert_allclose(d_p[both], d_j[both], atol=1e-4, rtol=0)
    # disparity = fx * baseline / depth of the rendered scene: 4.5-12 px
    assert 4.0 < np.median(d_p[both]) < 13.0


def test_keypoints_3d_from_stereo_matches_the_twin(pair):
    left, right, uv, valid = pair
    pts_p, ok_p = ST.keypoints_3d_from_stereo(
        *(torch.from_numpy(x) for x in (uv, valid, left, right)), STEREO)
    pts_j, ok_j = jax.jit(lambda *a: JST.keypoints_3d_from_stereo(*a, JSTEREO))(
        *(jnp.asarray(x) for x in (uv, valid, left, right)))
    ok_p, ok_j = ok_p.numpy(), np.asarray(ok_j)
    both = ok_p & ok_j
    assert (ok_p != ok_j).sum() <= 2 and both.sum() >= 0.5 * valid.sum()
    # depth = fx * b / d: a 1e-4 px disparity moves a 3 m point by ~3e-5 relative
    np.testing.assert_allclose(pts_p.numpy()[both], np.asarray(pts_j)[both], rtol=1e-4,
                               atol=1e-5)
    assert not pts_p.numpy()[~ok_p].any()


def _dense_pair(seed=2, H=48, W=64, shift=5):
    rng = np.random.default_rng(seed)
    tex = rng.random((H, W + shift)).astype(np.float32)
    left = tex[:, :W].copy()                         # right[x - d] = left[x]
    right = tex[:, shift:].copy()
    right[:, W // 2:] = tex[:, W // 2 + 2: W + 2]    # a second depth: disparity 2 px
    return left, right


@pytest.mark.parametrize("method", ["bm", "sgbm"])
def test_dense_matchers_match_the_twin(method):
    left, right = _dense_pair()
    D = 16
    if method == "bm":
        got = ST.dense_bm_disparity(torch.from_numpy(left), torch.from_numpy(right), D).numpy()
        ref = np.asarray(JST.dense_bm_disparity(jnp.asarray(left), jnp.asarray(right), D))
        np.testing.assert_array_equal(got, ref)           # integer disparities
    else:
        got = ST.dense_sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right), D).numpy()
        ref = np.asarray(JST.dense_sgbm_disparity(jnp.asarray(left), jnp.asarray(right), D))
        flips = int(((got > 0) != (ref > 0)).sum())
        assert flips <= 0.002 * got.size, flips          # near-ties of the uniqueness test
        both = (got > 0) & (ref > 0)
        np.testing.assert_allclose(got[both], ref[both], atol=1e-3, rtol=0)
    assert (got[:, :D] == 0).all() and (got > 0).mean() > 0.3
    # the true disparities, 5 px left of the step and 2 px right of it
    assert np.median(np.round(got[:, D:28][got[:, D:28] > 0])) == 5


@pytest.mark.slow
def test_run_dataset_stereo_matches_the_twin(tmp_path):
    """The whole slice on the CPU: an 8-frame KITTI stereo layout through
    both packages' run_dataset into a store, which each package's
    Rtabmap.load resumes (slow: the JAX side's compiles of the stereo
    extraction, the odometry and the engine take most of its 30 s, half
    the slice's budget for quick tests). Equal lost frames; SLAM ATE
    within 0.01 m (the RANSAC draws differ between the packages)."""
    from rtabmap_tpu.datasets.readers import KittiDataset as JKitti
    from rtabmap_tpu.engine.rtabmap import Rtabmap as JRtabmap
    from rtabmap_tpu.memory.db import Database as JDatabase
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.memory.db import Database
    from rtabmap_tpu.tools.dataset_runner import run_dataset as j_run
    from rtabmap_tpu.utils.params import Parameters as JParameters
    from rtabmap_tpu_torch.datasets.readers import KittiDataset
    from rtabmap_tpu_torch.tools.dataset_runner import run_dataset
    from rtabmap_tpu_torch.utils.params import Parameters

    seq, gt = str(tmp_path / "sequences" / "00"), str(tmp_path / "poses" / "00.txt")
    L.write_kitti(seq, gt, loop_trajectory(64)[:8], (320, 240), (160.0, 160.0, 159.5, 119.5),
                  0.54, device="cpu")
    ds, jds = KittiDataset(seq, gt), JKitti(seq, gt)
    db, jdb = Database(str(tmp_path / "p.db")), JDatabase(str(tmp_path / "j.db"))
    out = run_dataset(iter(ds), ds.camera, Parameters({"Rtabmap/DetectionRate": 0}),
                      stereo_model=ds.stereo, kitti_errors=True, verbose=False, device="cpu",
                      db=db)
    jout = j_run(iter(jds), jds.camera, JParameters({"Rtabmap/DetectionRate": 0}),
                 stereo_model=jds.stereo, kitti_errors=True, verbose=False, db=jdb)
    out["slam"].close()
    jout["slam"].close()
    assert len(Rtabmap.load(db, ds.camera, device="cpu").memory.signatures) == 8
    assert len(JRtabmap.load(jdb, jds.camera).memory.signatures) == 8
    db.close()
    jdb.close()
    assert out["frames"] == jout["frames"] == 8
    assert out["lost"] == jout["lost"] == 0
    assert abs(out["ate_slam"] - jout["ate_slam"]) < 0.01, (out["ate_slam"], jout["ate_slam"])
    assert out["kitti_t_err_pct"] == jout["kitti_t_err_pct"] == 0.0
    st = out["slam"].stats_history[-1]
    assert st.get("TimingMem/Stereo correspondences/ms") > 0
