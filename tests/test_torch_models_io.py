"""The learned models' weights and the other served model: NetVLAD
(``models/netvlad.py``), the checkpoint converter (``models/convert.py``,
with the CLI's ``convert_model``), the npz round trips between the
packages, and the bundled weight copies, against the JAX twins.

Tolerances and why: the copies' sha256 and the converted trees exactly
(a data operation); NetVLAD's k-means codebook and VLAD descriptors within
1e-5 with the same initial centres injected (float32 products summed in
another order); a converted MagicLeap SuperPoint within 1e-4 of the
largest output magnitude in float32 in both packages (the twin's
converter test's tolerance is 2e-4)."""
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtabmap_tpu.models import convert as JCV
from rtabmap_tpu.models import netvlad as JNV
from rtabmap_tpu.models import superpoint as JSP
from rtabmap_tpu_torch.models import convert as CV
from rtabmap_tpu_torch.models import netvlad as NV
from rtabmap_tpu_torch.models import superglue as SG
from rtabmap_tpu_torch.models import superpoint as SP
from rtabmap_tpu_torch.tools import cli as CLI
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["superpoint_distilled.npz", "superglue_distilled.npz"])
def test_weight_copies_are_the_twins(name):
    digest = [hashlib.sha256(open(os.path.join(REPO, pkg, "models", "weights", name),
                                  "rb").read()).hexdigest()
              for pkg in ("rtabmap_tpu", "rtabmap_tpu_torch")]
    assert digest[0] == digest[1]
    path = SP.WEIGHTS if name.startswith("superpoint") else SG.WEIGHTS
    assert os.path.samefile(path, os.path.join(REPO, "rtabmap_tpu_torch", "models", "weights",
                                               name))


def _clustered(seed, n_per=40, dim=16, n_c=6):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_c, dim)).astype(np.float32) * 2
    desc = np.concatenate([c + 0.1 * rng.normal(size=(n_per, dim)) for c in centers])
    valid = rng.random(len(desc)) > 0.1
    return desc.astype(np.float32), valid


def test_kmeans_and_vlad_match_the_twin():
    desc, valid = _clustered(0)
    key = jax.random.PRNGKey(2)
    # the twin's initial centres, injected
    v = jnp.asarray(valid)
    init = np.asarray(jax.jit(lambda k: jax.random.choice(
        k, len(desc), (6,), replace=False,
        p=v.astype(jnp.float32) / jnp.maximum(jnp.sum(v), 1)))(key))
    jcb = np.asarray(JNV.kmeans_codebook(jnp.asarray(desc), jnp.asarray(valid), key,
                                         n_clusters=6, iters=10))
    tcb = NV.kmeans_codebook(torch.from_numpy(desc), torch.from_numpy(valid), n_clusters=6,
                             iters=10, init_idx=init).numpy()
    np.testing.assert_allclose(tcb, jcb, atol=1e-5)
    q, qv = _clustered(1, n_per=10)
    for soft in (True, False):
        jv = np.asarray(JNV.vlad(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(jcb), soft=soft))
        tv = NV.vlad(torch.from_numpy(q), torch.from_numpy(qv), torch.from_numpy(jcb),
                     soft=soft).numpy()
        np.testing.assert_allclose(tv, jv, atol=1e-5)
    # the facade: a generator's draws are distinct valid rows
    nv = NV.NetVLAD(n_clusters=6, device="cpu").fit(desc, valid, seed=3)
    assert nv.dim == 6 * 16
    g = nv.extract(q, qv)
    assert abs(float(torch.linalg.norm(g)) - 1.0) < 1e-5


def test_global_descriptor_index_matches_the_twin():
    rng = np.random.default_rng(4)
    gs = rng.normal(size=(7, 12)).astype(np.float32)
    gs /= np.linalg.norm(gs, axis=1, keepdims=True)
    ji, ti = JNV.GlobalDescriptorIndex(12, capacity=5), NV.GlobalDescriptorIndex(
        12, capacity=5, device="cpu")
    for i, g in enumerate(gs):     # wraps around the 5 slots
        ji.add(10 + i, jnp.asarray(g))
        ti.add(10 + i, g)
    for q in (gs[3], gs[6], -gs[5]):
        a = ji.query(jnp.asarray(q), k=4, exclude_ids=(12,))
        b = ti.query(q, k=4, exclude_ids=(12,))
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_allclose(b[1], a[1], atol=1e-6)


class MagicLeapSuperPoint(torch.nn.Module):
    """The MagicLeap SuperPointNet layer names (superpoint_v1.pt's layout)."""

    def __init__(self):
        super().__init__()
        conv = torch.nn.Conv2d
        for name, i, o, k in (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
                              ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
                              ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
                              ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
                              ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
                              ("convDa", 128, 256, 3), ("convDb", 256, 256, 1)):
            setattr(self, name, conv(i, o, k, 1, k // 2))


def test_converted_superpoint_loads_to_the_same_outputs(tmp_path):
    torch.manual_seed(1)
    pt = str(tmp_path / "superpoint_v1.pt")
    torch.save(MagicLeapSuperPoint().state_dict(), pt)
    tree_j, tree_t = JCV.convert_superpoint(pt), CV.convert_superpoint(pt)
    assert set(tree_j) == set(tree_t)
    for layer in tree_j:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(tree_t[layer][leaf], tree_j[layer][leaf])
    # one file, written by the port's CLI, read by both packages
    npz = str(tmp_path / "sp.npz")
    assert CLI.main(["convert_model", "superpoint", pt, npz]) == 0
    g = np.random.default_rng(2).random((32, 48)).astype(np.float32)
    js = JSP.SuperPoint.load_params(npz)
    jl, jd = JSP.SuperPointNet(dtype=jnp.float32).apply({"params": js.params},
                                                        jnp.asarray(g)[None, :, :, None])
    ts = SP.SuperPoint.load_params(npz, device="cpu", dtype=torch.float32)
    tl, td = ts.forward(g)
    for t, j in ((tl, jl), (td, jd)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()
    with pytest.raises(KeyError):
        CV.convert_superpoint({"encoder.0.weight": np.zeros((64, 1, 3, 3))})


def test_converted_netvlad_and_superglue_files(tmp_path):
    cent = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    sd = {"net_vlad.centroids": torch.from_numpy(cent), "alpha": torch.tensor(12.0)}
    a, b = JCV.convert_netvlad(sd), CV.convert_netvlad(sd)
    np.testing.assert_array_equal(b["codebook"], a["codebook"])
    assert b["alpha"] == a["alpha"] == 12.0
    pt = str(tmp_path / "netvlad.pt")
    torch.save(sd, pt)
    out = str(tmp_path / "netvlad.npz")
    assert CLI.main(["convert_model", "netvlad", pt, out]) == 0
    np.testing.assert_array_equal(np.load(out)["codebook"], cent)
    # an official SuperGlue checkpoint (MagicLeap layout, two layers) through the CLI
    from test_torch_superglue import _leaves, _state_dict

    sdg = {k: torch.from_numpy(np.array(v)) for k, v in _state_dict("magicleap", 2).items()}
    pt = str(tmp_path / "superglue_indoor.pth")
    torch.save(sdg, pt)
    out = str(tmp_path / "sg.npz")
    assert CLI.main(["convert_model", "superglue", pt, out]) == 0
    from rtabmap_tpu.models import superglue_official as JSGO

    got = dict(_leaves(JSGO.load_params(out)))
    for k, v in _leaves(JCV.convert_superglue(sdg)):
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert CLI.main(["convert_model", "resnet", pt, out]) == 1
