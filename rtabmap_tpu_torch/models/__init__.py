"""Port of ``rtabmap_tpu/models``: the served learned models (SuperPoint, the
two SuperGlue matchers, NetVLAD) and the weight converter. Weights load
from the JAX package's npz layout (copies under ``weights/``)."""
