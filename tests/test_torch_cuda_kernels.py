"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``cuda`` and skips without
a card. This file imports no JAX; on the GPU machine run it without the
suite's conftest (which configures JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerance: none — the vocabulary 2-NN is integer arithmetic and both
versions rank in (dist, idx) order."""
import numpy as np
import pytest
import torch

from rtabmap_tpu_torch.ops.cuda import vocab_knn as V

# (Q, W, invalid share, rows duplicated to force ties)
CASES = {
    "main-path": (400, 262144, 0.3, True),
    "ragged": (37, 5000, 0.3, True),
    "no-valid-word": (64, 1024, 1.0, False),
    "one-row": (1, 1, 0.0, False),
    "one-tile": (64, 64, 0.0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_knn2_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Q, W, invalid, dup = CASES[name]
    rng = np.random.default_rng(len(name))
    s = (rng.integers(0, 2, (W, 256)) * 2 - 1).astype(np.int8)
    if dup:
        s[rng.integers(0, W, W // 10)] = s[rng.integers(0, W, W // 10)]
    valid = rng.random(W) >= invalid
    q = (rng.integers(0, 2, (Q, 256)) * 2 - 1).astype(np.int8)
    q[: Q // 2] = s[rng.integers(0, W, Q // 2)]
    q[-1] = 0
    args = [torch.from_numpy(a).cuda() for a in (q, s, valid)]
    before = V.knn2.launches
    d, i = V.knn2(*args)
    torch.cuda.synchronize()
    assert V.knn2.launches == before + 1
    dr, ir = V.knn2_reference(*args)
    assert torch.equal(d, dr)
    assert torch.equal(i, ir)
