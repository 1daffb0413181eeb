"""rtabmap_tpu_torch — the PyTorch/CUDA port of ``rtabmap_tpu``.

Module paths mirror the JAX package (``rtabmap_tpu/<path>`` ->
``rtabmap_tpu_torch/<path>``); the JAX package stays the reference each
module is held against. Kernels that the JAX package wrote in Pallas are
written by hand for Hopper under ``csrc/`` and bound in ``ops/cuda/``.

The port imports torch, numpy and the standard library only — never jax,
and nothing of ``rtabmap_tpu``.
"""

__version__ = "0.1.0"

from rtabmap_tpu_torch.utils.params import Parameters  # noqa: F401
