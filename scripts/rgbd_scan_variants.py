"""The full-width RGB-D + LiDAR run under the tool's scan and grid
settings, and what each does to the map and the grid (on the card).

Runs ``rtabmap_tpu_torch/tools/rgbd_scan.py``'s ``full`` run once a
variant and prints one JSON line each: the map ATE, the links' errors
against the ground truth by type (0 neighbour, 1 global closure, 2
proximity; median translation m and rotation degrees), the assembled
grid's occupied cells and their share within two cells of a wall, and the
heading error of the last 20 nodes (degrees, the map carried onto the
ground truth by ``rgbd_scan.map_to_world``). The variants:

- ``decoded``: each scan as the packets decode it (no 10 cm voxel filter),
  a 5 cm grid from every point;
- ``decoded-no-refining``: the same with RGBD/NeighborLinkRefining off;
- ``voxel``: the 10 cm scan voxel filter, a 5 cm grid from every point;
- ``voxel-band``: and the grid from the points within 0.5 m of the
  LiDAR's height;
- ``tool``: the tool's settings (and a 10 cm grid).

Usage (on a machine with a CUDA card, from the repository root):
    PYTHONPATH=. python scripts/rgbd_scan_variants.py [--variants NAME ...]
"""
from __future__ import annotations

import argparse
import json
import math
import time

VARIANTS = {  # name: (scan voxel filter, refining, grid cell, grid height band)
    "decoded": (False, True, 0.05, math.inf),
    "decoded-no-refining": (False, False, 0.05, math.inf),
    "voxel": (True, True, 0.05, math.inf),
    "voxel-band": (True, True, 0.05, 0.5),
    "tool": (True, True, 0.1, 0.5),
}


def link_errors(slam) -> dict:
    import numpy as np

    from rtabmap_tpu_torch.geometry import transform as T

    out = {}
    for i, s in slam.memory.signatures.items():
        for j, lk in s.links.items():
            o = slam.memory.get(j)
            if i < j and s.gt_pose is not None and o is not None and o.gt_pose is not None:
                d = T.np_relative(T.np_relative(s.gt_pose, o.gt_pose), lk.transform)
                out.setdefault(lk.type, []).append(
                    (T.np_translation_norm(d), np.degrees(T.np_rotation_angle(d))))
    return {k: {"n": len(v), "t_median_m": float(np.median([a for a, _ in v])),
                "r_median_deg": float(np.median([b for _, b in v]))}
            for k, v in sorted(out.items())}


def last_headings(slam, n: int = 20) -> dict:
    """Heading (about the world's vertical) error of the last ``n`` nodes."""
    import numpy as np

    from rtabmap_tpu_torch.tools import rgbd_scan as RSC

    opt = slam.get_optimized_poses()
    R, _ = RSC.map_to_world(slam)
    errs = []
    for i in sorted(opt)[-n:]:
        f1, f2 = (R @ np.asarray(opt[i])[:, :3])[:, 2], slam.memory.get(i).gt_pose[:, 2]
        errs.append(abs(float(np.degrees(np.arctan2(f1[0] * f2[2] - f1[2] * f2[0],
                                                    f1[0] * f2[0] + f1[2] * f2[2])))))
    return {"median_deg": float(np.median(errs)), "max_deg": float(np.max(errs))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    import torch

    from rtabmap_tpu_torch.tools import rgbd_scan as RSC

    dev = torch.device("cuda")
    vlp16_scan, params = RSC.vlp16_scan, dict(RSC.RUN_PARAMS["full"])
    saved = (RSC.GRID_CELL, RSC.GRID_HEIGHT)
    for name in args.variants:
        voxel, refining, RSC.GRID_CELL, RSC.GRID_HEIGHT = VARIANTS[name]

        def scan_as_decoded(*a, **k):
            scan, xyz_b, in_range = vlp16_scan(*a, **k)
            return scan._replace(valid=in_range), xyz_b, in_range

        RSC.vlp16_scan = vlp16_scan if voxel else scan_as_decoded
        RSC.RUN_PARAMS["full"] = {**params, "RGBD/NeighborLinkRefining": refining}
        t0 = time.perf_counter()
        res, run = RSC.run_mapping("full", dev)
        print(json.dumps({"variant": name, "seconds": time.perf_counter() - t0,
                          **{k: res[k] for k in ("map_ate", "ate_odom", "refined",
                                                 "occupied_cells", "occupied_near_wall")},
                          "link_errors": link_errors(run["slam"]),
                          "last_20_headings": last_headings(run["slam"])}), flush=True)
    RSC.vlp16_scan, RSC.RUN_PARAMS["full"] = vlp16_scan, params
    RSC.GRID_CELL, RSC.GRID_HEIGHT = saved


if __name__ == "__main__":
    main()
