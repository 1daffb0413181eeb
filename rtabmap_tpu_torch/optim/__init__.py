"""Graph-optimization strategy surface.

Port of ``rtabmap_tpu/optim/__init__.py``: the reference's
``Optimizer::create`` factory (``Optimizer/Strategy`` 0 = TORO, 1 = g2o,
2 = GTSAM, 3 = Ceres, all third-party CPU solvers of the same pose-graph
problem) maps each strategy id onto one of the package's own solvers,
``optim/pose_graph.optimize_dense`` (dense LM) or ``optimize_pcg``
(matrix-free PCG).
"""
from __future__ import annotations

from rtabmap_tpu_torch.optim import ba  # noqa: F401
from rtabmap_tpu_torch.optim import pose_graph  # noqa: F401
from rtabmap_tpu_torch.optim.pose_graph import (  # noqa: F401
    PoseGraph, make_graph, optimize, optimize_dense, optimize_pcg,
)

# the reference's Optimizer/Strategy numbering -> the solver
_STRATEGY_BACKEND = {
    0: "dense",   # TORO
    1: "dense",   # g2o
    2: "pcg",     # GTSAM
    3: "pcg",     # Ceres
}


def create_optimizer(params=None, strategy=None):
    """``optimize_dense`` or ``optimize_pcg`` for ``strategy`` (an id, or
    "dense"/"pcg"), by default ``Optimizer/Strategy`` of ``params``; an
    unknown id gives the dense solver."""
    if strategy is None:
        from rtabmap_tpu_torch.utils.params import Parameters

        p = params or Parameters()
        strategy = int(p["Optimizer/Strategy"])
    name = (strategy if isinstance(strategy, str)
            else _STRATEGY_BACKEND.get(int(strategy), "dense"))
    return optimize_dense if name == "dense" else optimize_pcg
