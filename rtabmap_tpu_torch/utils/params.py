"""Typed configuration registry with reference-compatible key names.

Capability parity: the reference's ``Parameters`` system
(RTAB-Map's corelib/include/rtabmap/core/Parameters.h:64-76,
corelib/src/Parameters.cpp) — 613 typed "Group/Name" keys with defaults and
descriptions, merged from defaults -> stored-map params -> .ini file -> CLI
``--Group/Name value`` arguments, persisted alongside maps so a map store is
self-describing.

The key names and default *values* are behavioral facts replicated from the
reference (extracted into ``param_defaults.json``); the implementation is
fresh. TPU-specific keys live under the ``Tpu/`` group and are additive.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

_DEFAULTS_PATH = os.path.join(os.path.dirname(__file__), "param_defaults.json")

_TYPE_CASTS = {
    "bool": lambda v: v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes", "on"),
    "int": int,
    "uint": int,
    "float": float,
    "str": str,
}

# TPU-native additions: static capacities for the slab-allocated device state
# and mesh controls. All additive — reference keys are untouched.
_TPU_PARAMS = {
    "Tpu/VocabularyCapacity": {"type": "int", "default": 262144, "desc": "Max visual words held on device (slab capacity for the matmul NN search)."},
    "Tpu/NodeCapacity": {"type": "int", "default": 4096, "desc": "Max graph nodes resident in the device working-memory slabs."},
    "Tpu/LinkCapacity": {"type": "int", "default": 16384, "desc": "Max graph links resident on device."},
    "Tpu/WordsPerFrame": {"type": "int", "default": 512, "desc": "Padded per-frame keypoint/word count (static shape)."},
    "Tpu/InvertedIndexRefs": {"type": "int", "default": 128, "desc": "Max node references tracked per word in the device inverted index."},
    "Tpu/MeshShape": {"type": "str", "default": "", "desc": "Device mesh as 'dp,mp' (empty = single chip)."},
    "Tpu/RansacBatch": {"type": "int", "default": 256, "desc": "Number of RANSAC hypotheses evaluated in one batched solve."},
    "Tpu/IncrementalOptimization": {"type": "bool", "default": True, "desc": "Optimize only the affected subgraph (loop cycle + margin) per closure, with periodic full solves (the iSAM2 role of OptimizerGTSAM)."},
    "Tpu/FullSolveEvery": {"type": "int", "default": 8, "desc": "Run a full-graph solve after this many incremental (subgraph) optimizations."},
    "Tpu/Bfloat16Descriptors": {"type": "bool", "default": True, "desc": "Store descriptor slabs in bfloat16 for MXU-friendly NN search."},
    "OdomMono/InitialBaseline": {"type": "float", "default": 1.0, "desc": "Metric length assigned to the unobservable bootstrap baseline (mono scale fix)."},
    "OdomMono/MinParallax": {"type": "float", "default": 0.5, "desc": "Minimum ray parallax (degrees) to triangulate a new mono landmark."},
}


class Parameters:
    """Immutable defaults + mutable overlay, with type-checked set()."""

    _defaults: Optional[Dict[str, Dict[str, Any]]] = None

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        if overrides:
            for k, v in overrides.items():
                self.set(k, v)

    # -- registry ------------------------------------------------------------
    @classmethod
    def registry(cls) -> Dict[str, Dict[str, Any]]:
        if cls._defaults is None:
            with open(_DEFAULTS_PATH) as f:
                cls._defaults = json.load(f)
            cls._defaults.update(_TPU_PARAMS)
        return cls._defaults

    @classmethod
    def default(cls, key: str) -> Any:
        return cls.registry()[key]["default"]

    @classmethod
    def describe(cls, key: str) -> str:
        return cls.registry()[key]["desc"]

    @classmethod
    def exists(cls, key: str) -> bool:
        return key in cls.registry()

    @classmethod
    def groups(cls) -> List[str]:
        return sorted({k.split("/")[0] for k in cls.registry()})

    # -- access --------------------------------------------------------------
    def get(self, key: str) -> Any:
        if key in self._values:
            return self._values[key]
        reg = self.registry()
        if key not in reg:
            raise KeyError(f"Unknown parameter '{key}'")
        return reg[key]["default"]

    def __getitem__(self, key: str) -> Any:
        return self.get(key)

    def set(self, key: str, value: Any) -> "Parameters":
        reg = self.registry()
        if key not in reg:
            raise KeyError(f"Unknown parameter '{key}'")
        cast = _TYPE_CASTS.get(reg[key]["type"], str)
        self._values[key] = cast(value)
        return self

    def update(self, other: Dict[str, Any]) -> "Parameters":
        for k, v in other.items():
            self.set(k, v)
        return self

    def overrides(self) -> Dict[str, Any]:
        return dict(self._values)

    def as_dict(self) -> Dict[str, Any]:
        out = {k: v["default"] for k, v in self.registry().items()}
        out.update(self._values)
        return out

    def copy(self) -> "Parameters":
        return Parameters(dict(self._values))

    # -- ingestion -----------------------------------------------------------
    @classmethod
    def parse_arguments(cls, argv: Iterable[str]) -> Tuple["Parameters", List[str]]:
        """Consume ``--Group/Name value`` pairs; return (params, remaining)."""
        params = cls()
        rest: List[str] = []
        it = list(argv)
        i = 0
        while i < len(it):
            a = it[i]
            if a.startswith("--") and "/" in a and cls.exists(a[2:]):
                key = a[2:]
                if cls.registry()[key]["type"] == "bool" and (
                    i + 1 >= len(it) or it[i + 1].startswith("--")
                ):
                    params.set(key, True)
                    i += 1
                else:
                    params.set(key, it[i + 1])
                    i += 2
            else:
                rest.append(a)
                i += 1
        return params, rest

    def read_ini(self, path: str) -> "Parameters":
        """Read a flat ini: lines 'Group/Name = value' (sections like
        '[Core]' are tolerated and ignored, matching reference ini layout
        where keys are Group\\Name under one section)."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith((";", "#", "[")):
                    continue
                if "=" not in line:
                    continue
                k, v = line.split("=", 1)
                k = k.strip().replace("\\", "/")
                v = v.strip()
                if self.exists(k):
                    self.set(k, v)
        return self

    def write_ini(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("[Core]\n")
            for k in sorted(self.registry()):
                v = self.get(k)
                if isinstance(v, bool):
                    v = "true" if v else "false"
                f.write(f"{k.replace('/', chr(92))} = {v}\n")

    @classmethod
    def show_usage(cls) -> str:
        lines = []
        for k in sorted(cls.registry()):
            e = cls.registry()[k]
            lines.append(f"  --{k}  [{e['type']}, default={e['default']}]  {e['desc']}")
        return "\n".join(lines)
