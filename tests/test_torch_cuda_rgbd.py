"""The RGB-D slice's modules on the card against the same modules on the
CPU, on the same inputs. Every test here is marked ``cuda`` and skips
without a card; the file imports no JAX (run it on the GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda_rgbd.py -m cuda``).

The CPU side is the one the parity tests hold against the JAX package, so
these tests carry that parity to the card. RANSAC samples are drawn once
on the CPU and passed to both sides (``indices=``).

Tolerances and why: match indices and flags, inlier masks and counts,
keyframe decisions, the F2M map's ids and order exactly; poses and map
points to 1e-4 (float32 sums in another order on the card, atomics in
``index_add_``); engine ticks: closure ids, link sets and statistic keys
exactly, optimized poses to 1e-3 (both engines draw the same RANSAC
samples from their CPU generators; float32 sums run in another order);
scan ticks alike, the refining and scan-closure flags exactly."""
import numpy as np
import pytest
import torch

from rtabmap_tpu_torch.core.frame import FeatureExtractor, FrameFeatures
from rtabmap_tpu_torch.datasets.synthetic import loop_trajectory, render
from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
from rtabmap_tpu_torch.geometry import camera as C
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory import memory as MEM
from rtabmap_tpu_torch.odometry import f2m as F
from rtabmap_tpu_torch.ops import matching as M
from rtabmap_tpu_torch.ops import ransac as R
from rtabmap_tpu_torch.utils.params import Parameters

CAM = C.CameraModel.make(120.0, 120.0, 80.0, 60.0, 160, 120)
K = 128


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(ways, n_loop=96):
    fe = FeatureExtractor(CAM, max_kp=K, device="cpu")
    poses = loop_trajectory(n_loop)
    return [(fe.extract(*render(poses[w], CAM, device="cpu"))[0], poses[w]) for w in ways]


def _to(fr, dev):
    return FrameFeatures(*(x.to(dev) for x in fr))


@pytest.mark.cuda
def test_f2m_odometry_on_the_card_equals_the_cpu():
    dev = _card()
    frames = _frames(range(6))
    cs = F.init_state(200, ba_frames=3, obs_capacity=K, device="cpu")
    gs = F.init_state(200, ba_frames=3, obs_capacity=K, device=dev)
    gen = torch.Generator().manual_seed(0)
    for fr, _ in frames:
        idx = None
        if cs.initialized:
            m = M.match_nndr(fr.desc, fr.valid, cs.map_desc, cs.map_valid)
            gm = M.match_nndr(fr.desc.to(dev), fr.valid.to(dev), gs.map_desc, gs.map_valid)
            assert torch.equal(gm.idx.cpu(), m.idx) and torch.equal(gm.valid.cpu(), m.valid)
            idx = R.pnp_sample_indices(gen, m.valid, 192, True)
        cs, cr = F.odom_step(cs, fr, CAM, reproj_px=2.0, keyframe_thr=0.8, indices=idx)
        gs, gr = F.odom_step(gs, _to(fr, dev), CAM, reproj_px=2.0, keyframe_thr=0.8,
                             indices=None if idx is None else tuple(i.to(dev) for i in idx))
        assert (gr.success, gr.num_matches, gr.num_inliers, gr.keyframe_added) == \
            (cr.success, cr.num_matches, cr.num_inliers, cr.keyframe_added)
        if cr.keyframe_added:
            cs, gs = F.local_ba_step(cs, CAM), F.local_ba_step(gs, CAM)
        for name in ("map_valid", "map_ids", "map_desc", "map_seen", "obs_ids"):
            assert torch.equal(getattr(gs, name).cpu(), getattr(cs, name)), name
        for name in ("pose", "map_pts", "kf_poses"):
            np.testing.assert_allclose(getattr(gs, name).cpu().numpy(),
                                       getattr(cs, name).numpy(), atol=1e-4, err_msg=name)


@pytest.mark.cuda
def test_batched_registration_on_the_card_equals_the_cpu():
    dev = _card()
    frames = _frames(range(4))
    a = [f for f, _ in frames[:3]]
    b = frames[3][0]
    stack = lambda attr: torch.stack([getattr(f, attr) for f in a])  # noqa: E731
    ok3 = lambda f: f.valid3d & f.valid  # noqa: E731
    args = (stack("desc"), torch.stack([ok3(f) for f in a]), stack("pts3d"), stack("uv"),
            b.desc, ok3(b), b.uv, b.pts3d, torch.eye(3, 4).expand(3, 3, 4), CAM)
    _, mm, _ = MEM._registration_kernel_batch(*args, torch.Generator(), 256, 4.0, 20, 0.8, 0.0)
    idx = R.pnp_sample_indices(torch.Generator().manual_seed(1), mm.valid, 256, True)
    cr, cm, cx = MEM._registration_kernel_batch(*args, None, 256, 4.0, 20, 0.8, 0.0,
                                                indices=idx)
    gargs = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in args)
    gr, gm, gx = MEM._registration_kernel_batch(*gargs, None, 256, 4.0, 20, 0.8, 0.0,
                                                indices=tuple(i.to(dev) for i in idx))
    assert torch.equal(gm.idx.cpu(), cm.idx) and torch.equal(gm.valid.cpu(), cm.valid)
    assert torch.equal(gr.inliers.cpu(), cr.inliers)
    assert torch.equal(gr.success.cpu(), cr.success) and bool(cr.success.any())
    np.testing.assert_allclose(gr.transform.cpu().numpy(), cr.transform.numpy(), atol=1e-4)
    for g, c in zip(gx, cx):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_rgbd_engine_ticks_on_the_card_equal_the_cpu():
    """tests/test_torch_engine_rgbd.py's ticks, port on the card against
    port on the CPU."""
    dev = _card()
    ticks = _frames(list(range(9)) + [2, 1, 0], n_loop=48)
    over = {"Tpu/VocabularyCapacity": 8192, "Mem/STMSize": 2}
    cs = Rtabmap(CAM, Parameters(over), node_capacity=32, words_per_frame=K, device="cpu")
    gs = Rtabmap(CAM, Parameters(over), node_capacity=32, words_per_frame=K, device=dev)
    closures = proximity = 0
    for i, (fr, pose) in enumerate(ticks):
        a = cs.process(fr, pose, stamp=float(i + 1))
        b = gs.process(_to(fr, dev), pose, stamp=float(i + 1))
        assert (b.ref_id, b.loop_closure_id) == (a.ref_id, a.loop_closure_id), i
        assert b.get("Proximity/Space links added/") == a.get("Proximity/Space links added/")
        assert set(b.data) == set(a.data)
        links = lambda s: sorted((i, j, lk.type) for i, g in s.memory.signatures.items()  # noqa: E731
                                 for j, lk in g.links.items())
        assert links(gs) == links(cs), i
        co, go = cs.get_optimized_poses(), gs.get_optimized_poses()
        for k in co:
            np.testing.assert_allclose(go[k], co[k], atol=1e-3)
        closures += int(a.loop_closure_id > 0)
        proximity += int(a.get("Proximity/Space links added/"))
    assert closures >= 1 and proximity >= 1


@pytest.mark.cuda
def test_scan_engine_ticks_on_the_card_equal_the_cpu():
    """The RGB-D + LiDAR tick (neighbour-link refining, the scan-ICP
    proximity fallback, VhEp) on the card against the CPU: the same
    frames and 16 x 120 VLP-16 scans through packets (tools/rgbd_scan.py),
    K2 launched on the card."""
    from rtabmap_tpu_torch.datasets.synthetic import DEFAULT_WORLD
    from rtabmap_tpu_torch.ops.cuda import nn3d as K2
    from rtabmap_tpu_torch.tools import rgbd_scan as RSC

    dev = _card()
    ways = list(range(9)) + [2, 1, 0]
    ticks = _frames(ways, n_loop=48)
    poses = loop_trajectory(48)
    scans = [RSC.sensor_scan(poses[w], DEFAULT_WORLD.half_extent, 120, torch.device("cpu"))[0]
             for w in ways]
    over = {"Tpu/VocabularyCapacity": 8192, "Mem/STMSize": 2, "VhEp/Enabled": True,
            "RGBD/NeighborLinkRefining": True, "Rtabmap/DetectionRate": 0}
    cs = Rtabmap(CAM, Parameters(over), node_capacity=32, words_per_frame=K, device="cpu")
    gs = Rtabmap(CAM, Parameters(over), node_capacity=32, words_per_frame=K, device=dev)
    K2.nn3d_search.launches = 0
    refined = 0
    for i, ((fr, pose), scan) in enumerate(zip(ticks, scans)):
        a = cs.process(fr, pose, stamp=float(i + 1), scan=scan)
        b = gs.process(_to(fr, dev), pose, stamp=float(i + 1), scan=scan.to(dev))
        assert (b.ref_id, b.loop_closure_id) == (a.ref_id, a.loop_closure_id), i
        assert set(b.data) == set(a.data), i
        for key in ("NeighborLinkRefining/Accepted/", "Proximity/Space links added/",
                    "Proximity/Space detections added icp multi/", "Loop/Epipolar pairs/"):
            assert b.get(key) == a.get(key), (i, key)
        links = lambda s: sorted((i, j, lk.type) for i, g in s.memory.signatures.items()  # noqa: E731
                                 for j, lk in g.links.items())
        assert links(gs) == links(cs), i
        co, go = cs.get_optimized_poses(), gs.get_optimized_poses()
        for k in co:
            np.testing.assert_allclose(go[k], co[k], atol=1e-3)
        refined += int(a.get("NeighborLinkRefining/Accepted/"))
    assert refined >= len(ways) - 2, refined
    assert K2.nn3d_search.launches > 0


def _planar_ring(n: int, seed: int = 0):
    """A noisy planar ring of ``n`` poses (radius 10 m) with odometry edges
    and a closure every 20 nodes to the node opposite: (init, ef, et, meas,
    info) as numpy, the init by dead reckoning."""
    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(n) / n
    gt = np.zeros((n, 3, 4), np.float32)
    gt[:, 0, 0] = gt[:, 1, 1] = np.cos(a + np.pi / 2)
    gt[:, 0, 1], gt[:, 1, 0] = -np.sin(a + np.pi / 2), np.sin(a + np.pi / 2)
    gt[:, 2, 2] = 1.0
    gt[:, 0, 3], gt[:, 1, 3] = 10 * np.cos(a), 10 * np.sin(a)
    ef = np.concatenate([np.arange(n - 1), np.arange(0, n, 20)])
    et = np.concatenate([np.arange(1, n), (np.arange(0, n, 20) + n // 2) % n])
    meas = T.relative(torch.from_numpy(gt[ef]), torch.from_numpy(gt[et])).numpy()
    meas[:, :2, 3] += rng.normal(0, 0.02, (len(ef), 2)).astype(np.float32)
    init = [torch.from_numpy(gt[0])]
    for k in range(n - 1):
        init.append(T.compose(init[-1], torch.from_numpy(meas[k])))
    info = np.tile(np.eye(6, dtype=np.float32) * 100.0, (len(ef), 1, 1))
    return torch.stack(init).numpy(), ef, et, meas, info


@pytest.mark.cuda
def test_optimize_pcg_on_the_card_equals_the_cpu():
    """A 480-node ring padded to the 512-node bucket, six LM steps of 512 CG
    iterations: the captured CUDA graph, the eager loop on the card and
    the CPU run (the one tests/test_torch_pose_graph.py holds to the JAX
    package) agree within 1e-3 m, chi2 within 1e-3 relative (float32
    sums in another order, atomics in ``index_add_``)."""
    from rtabmap_tpu_torch.optim import pose_graph as PG

    dev = _card()
    init, ef, et, meas, info = _planar_ring(480)
    N, E = 512, 512
    pad = lambda a, n: np.concatenate([a, np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))])  # noqa: E731
    args = (pad(init, N - 480), np.concatenate([ef, np.zeros(E - len(ef), np.int64)]),
            np.concatenate([et, np.zeros(E - len(et), np.int64)]), pad(meas, E - len(ef)),
            np.concatenate([info, np.tile(np.eye(6, dtype=np.float32), (E - len(ef), 1, 1))]))
    kw = dict(node_valid=np.arange(N) < 480, edge_valid=np.arange(E) < len(ef))
    cpu, cc = PG.optimize_pcg(PG.make_graph(*args, device="cpu", **kw), iters=6, cg_iters=512)
    g = PG.make_graph(*args, device=dev, **kw)
    for graphs in (True, False):
        out, c = PG.optimize_pcg(g, iters=6, cg_iters=512, graphs=graphs)
        np.testing.assert_allclose(out.poses.cpu().numpy(), cpu.poses.numpy(), atol=1e-3)
        assert abs(float(c) - float(cc)) <= 1e-3 * float(cc)
    assert float(cc) < 0.1 * float(PG.graph_chi2(PG.make_graph(*args, device="cpu", **kw)))
