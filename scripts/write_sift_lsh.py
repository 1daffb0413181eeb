"""Write the sign-LSH hyperplanes that binarise SIFT-family descriptors.

The JAX package draws them in ``core/frame.extract_features`` as
``jax.random.normal(jax.random.PRNGKey(0), (128, 256))``. The PyTorch port
cannot draw from JAX's generator, so it ships that array as
``rtabmap_tpu_torch/core/sift_lsh.npy`` (float32, (128, 256)); this script
writes it, on the CPU, and ``tests/test_torch_sift_lsh.py`` holds the
shipped file to a fresh draw bit for bit (the draw depends on JAX's PRNG
settings, e.g. ``jax_threefry_partitionable``).

Usage: PYTHONPATH=. python scripts/write_sift_lsh.py [--check]
"""
import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "rtabmap_tpu_torch", "core", "sift_lsh.npy")


def draw() -> np.ndarray:
    from rtabmap_tpu.ops.features import DESC_DIM, SIFT_DIM

    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (SIFT_DIM, DESC_DIM)),
                      np.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the shipped file with a fresh draw, write nothing")
    args = ap.parse_args()
    r = draw()
    if args.check:
        same = np.array_equal(np.load(OUT), r)
        print(f"{OUT}: {'equal to' if same else 'DIFFERS from'} the JAX draw")
        sys.exit(0 if same else 1)
    np.save(OUT, r)
    print(f"wrote {OUT} {r.shape} {r.dtype}")


if __name__ == "__main__":
    main()
