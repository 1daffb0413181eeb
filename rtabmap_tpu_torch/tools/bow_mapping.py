"""Appearance-only loop-closure mapping over an image directory.

Port of ``rtabmap_tpu/tools/bow_mapping.py`` (the reference's BOWMapping
example): feed a directory of images through ``FeatureExtractor.extract``
-> ``Rtabmap.process`` with RGBD/Enabled=false and report the loop
closures.

Usage: python -m rtabmap_tpu_torch.tools.bow_mapping <dir> [--device cpu]
       [--Group/Name value...]
"""
from __future__ import annotations

import glob
import os
import sys
from typing import List, Tuple

import numpy as np
import torch

from rtabmap_tpu_torch.device import DeviceLike, resolve_device


def run(image_dir: str, params=None, max_kp: int = 400, max_images: int = 0,
        verbose: bool = True, device: DeviceLike = None) -> List[Tuple[int, int, float]]:
    """Returns a list of (frame_id, loop_with_id, hypothesis_value)."""
    from PIL import Image

    from rtabmap_tpu_torch.core.frame import FeatureExtractor
    from rtabmap_tpu_torch.engine.rtabmap import Rtabmap
    from rtabmap_tpu_torch.geometry import camera as C
    from rtabmap_tpu_torch.ops import image as im
    from rtabmap_tpu_torch.utils.params import Parameters

    dev = resolve_device(device)
    p = params or Parameters()
    p.set("RGBD/Enabled", False)
    files = sorted(
        glob.glob(os.path.join(image_dir, "*.jpg")) +
        glob.glob(os.path.join(image_dir, "*.png")),
        key=lambda f: (len(os.path.basename(f)), f),
    )
    if max_images:
        files = files[:max_images]
    if not files:
        raise FileNotFoundError(f"no images in {image_dir}")

    H, W = np.asarray(Image.open(files[0])).shape[:2]
    cam = C.CameraModel.make(W, W, W / 2 - 0.5, H / 2 - 0.5, W, H)  # nominal
    slam = Rtabmap(cam, p, node_capacity=max(len(files) + 16, 128),
                   words_per_frame=max_kp, device=dev)
    fe = FeatureExtractor(cam, p, max_kp=max_kp, device=dev)
    zero_depth = torch.zeros((H, W), dtype=torch.float32, device=dev)

    closures = []
    for i, f in enumerate(files):
        arr = torch.from_numpy(np.asarray(Image.open(f)).copy()).to(dev)
        gray = im.rgb_to_gray(arr) if arr.dim() == 3 else arr.float() / 255.0
        fr, _ = fe.extract(gray, zero_depth)
        st = slam.process(fr, np.eye(3, 4, dtype=np.float32), np.eye(6) * 9e-5,
                          stamp=float(i))
        hyp = st.get("Loop/Highest hypothesis value/", 0.0)
        if st.loop_closure_id:
            closures.append((st.ref_id, st.loop_closure_id, hyp))
            if verbose:
                print(f"frame {i+1} ({os.path.basename(f)}): LOOP CLOSURE with node "
                      f"{st.loop_closure_id} (hypothesis {hyp:.3f})")
        elif verbose and (i + 1) % 20 == 0:
            print(f"frame {i+1}: wm={int(st.get('Memory/Working memory size/'))} "
                  f"dict={int(st.get('Keypoint/Dictionary size/words'))} hyp={hyp:.3f}")
    if verbose:
        print(f"\n{len(closures)} loop closures over {len(files)} images; "
              f"dictionary={slam.memory.vocab.n_words} words")
    return closures


def main(argv=None):
    from rtabmap_tpu_torch.utils.params import Parameters

    argv = list(argv if argv is not None else sys.argv[1:])
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k:k + 2]
    params, rest = Parameters.parse_arguments(argv)
    if not rest:
        raise SystemExit(__doc__)
    run(rest[0], params, device=device)


if __name__ == "__main__":
    main()
