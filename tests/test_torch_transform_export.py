"""Pose-format helpers and the pose files: the port's
``geometry/transform.py`` conversions and ``tools/export_poses.py`` against
the JAX twins on the same numpy poses.

Tolerances and why: quaternions, Euler angles, interpolated poses and
round trips within 1e-6 (float32 trigonometry and square roots in another
order; every pivot case of ``to_quaternion`` is covered, its choice is
exact); ``is_identity`` exactly; the pose files written by one package and
read by the other within 1e-5 (six printed decimals), the raw and KITTI
files byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.geometry import transform as JT
from rtabmap_tpu.memory.memory import Link as JLink
from rtabmap_tpu.tools import export_poses as JE
from rtabmap_tpu_torch.geometry import transform as T
from rtabmap_tpu_torch.memory.memory import Link
from rtabmap_tpu_torch.tools import export_poses as E
from torch_port_threads import one_torch_thread  # noqa: F401


def _poses(n=24, seed=0):
    """Poses over all four quaternion pivots: rotations near identity and
    near half turns about x, y and z, plus random ones."""
    rng = np.random.default_rng(seed)
    xyzrpy = rng.uniform(-1, 1, (n, 6)).astype(np.float32)
    xyzrpy[:, 3:] *= np.pi
    xyzrpy[0, 3:] = 0.0
    xyzrpy[1, 3:] = [np.pi - 0.01, 0.0, 0.0]
    xyzrpy[2, 3:] = [0.0, np.pi / 2 - 0.05, 0.0]
    xyzrpy[3, 3:] = [0.0, 0.0, np.pi - 0.01]
    xyzrpy[4, 3:] = [np.pi - 0.02, 0.01, np.pi - 0.03]
    return np.asarray(JT.from_xyzrpy(jnp.asarray(xyzrpy))), xyzrpy


@jax.jit
def _jax_reference(P, xyzrpy, cases, A, B):
    """Every JAX twin's output, in one compile (op-by-op calls compile each
    primitive)."""
    q = JT.to_quaternion(P)
    t = JT.translation(P)
    return dict(from_xyzrpy=JT.from_xyzrpy(xyzrpy), q=q, from_q_t=JT.from_quaternion(q, t),
                from_q=JT.from_quaternion(q), xyzrpy=JT.to_xyzrpy(P),
                tnorm=JT.translation_norm(P), m4=JT.to_matrix4(P),
                ident=JT.is_identity(cases),
                interp=[JT.interpolate(A, B, a) for a in (0.0, 0.3, 1.0)])


def test_conversions_match_the_twin():
    P, xyzrpy = _poses()
    Pt = torch.from_numpy(np.array(P))
    near = P.copy()
    near[:, :3, 3] *= 1e-8
    ident = np.tile(np.eye(3, 4, dtype=np.float32), (3, 1, 1))
    cases = np.concatenate([P[:4], near[:1], ident])
    ref = jax.tree_util.tree_map(np.asarray, _jax_reference(P, xyzrpy, cases, P[5:10], P[10:15]))
    np.testing.assert_allclose(T.from_xyzrpy(torch.from_numpy(xyzrpy)).numpy(),
                               ref["from_xyzrpy"], atol=1e-6)
    q = T.to_quaternion(Pt).numpy()
    np.testing.assert_allclose(q, ref["q"], atol=1e-6)
    q_ref, t_ref = torch.from_numpy(ref["q"]), T.translation(Pt)
    np.testing.assert_allclose(T.from_quaternion(q_ref, t_ref).numpy(), ref["from_q_t"], atol=1e-6)
    np.testing.assert_allclose(T.from_quaternion(q_ref).numpy(), ref["from_q"], atol=1e-6)
    np.testing.assert_allclose(T.to_xyzrpy(Pt).numpy(), ref["xyzrpy"], atol=1e-6)
    np.testing.assert_allclose(T.translation_norm(Pt).numpy(), ref["tnorm"], atol=1e-6)
    np.testing.assert_array_equal(T.to_matrix4(Pt).numpy(), ref["m4"])
    np.testing.assert_array_equal(T.is_identity(torch.from_numpy(cases)).numpy(), ref["ident"])
    for alpha, want in zip((0.0, 0.3, 1.0), ref["interp"]):
        np.testing.assert_allclose(T.interpolate(Pt[5:10], Pt[10:15], alpha).numpy(), want,
                                   atol=1e-5)


@pytest.mark.parametrize("fmt", [0, 1, 2, 3, 4])
def test_pose_files_cross_packages(tmp_path, fmt):
    P, _ = _poses(8, seed=fmt)
    poses = {i + 1: P[i] for i in range(len(P))}
    rng = np.random.default_rng(fmt)
    info = np.diag(rng.uniform(1, 100, 6)).astype(np.float32)
    links = [(1, 2, 0, P[1]), (2, 5, 1, P[3])]
    port_links = [Link(a, b, t, tr, info) for a, b, t, tr in links]
    jax_links = [JLink(a, b, t, tr, info) for a, b, t, tr in links]
    E.export_poses(str(tmp_path / "port.txt"), fmt, poses, links=port_links)
    JE.export_poses(str(tmp_path / "jax.txt"), fmt, poses, links=jax_links)
    if fmt in (0, 2):
        assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    keys = sorted(poses) if fmt in (3, 4) else list(range(len(poses)))
    for name, read in (("port", JE.import_poses), ("jax", E.import_poses),
                       ("port", E.import_poses)):
        back = read(str(tmp_path / f"{name}.txt"), fmt)
        assert sorted(back) == keys
        for k, i in zip(keys, sorted(poses)):
            np.testing.assert_allclose(np.asarray(back[k]), poses[i], atol=1e-5)
    with pytest.raises(ValueError):
        E.export_poses(str(tmp_path / "x.txt"), 5, poses)
