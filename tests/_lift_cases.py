"""Inputs of the voxel-lift backward on the layouts its row index must
handle, for the CPU tests and the card tests alike.  Imports neither JAX
nor anything of the card."""

import numpy as np


def lift_case(kind, n, hw, c, v, seed=0):
    """Lift backward inputs (feat, pix, weight, g) as numpy arrays, half
    the weights nonzero.  kind "clipped": 55% of each view's pairs on its
    first 1% of rows, as voxels outside a view clip onto its edge, and 10%
    of the weights nonzero; "single_row": every pair of a view on one row;
    "zero_weight": every weight 0; "sparse_rows": pairs only on every 50th
    row, so most rows hold none; "dense": every weight nonzero."""
    rng = np.random.RandomState(seed)
    feat = rng.rand(n, hw, c).astype(np.float32)
    pix = rng.randint(0, hw, (n, v))
    share = 0.5
    if kind == "clipped":
        edge = rng.randint(0, max(hw // 100, 1), (n, v))
        pix = np.where(rng.rand(n, v) < 0.55, edge, pix)
        share = 0.1
    elif kind == "single_row":
        pix = np.repeat(rng.randint(0, hw, (n, 1)), v, axis=1)
    elif kind == "sparse_rows":
        pix = rng.randint(0, hw // 50, (n, v)) * 50
    elif kind == "dense":
        share = 1.0
    weight = (rng.rand(n, v) + (kind == "dense")) \
        * (rng.rand(n, v) < share) * (kind != "zero_weight")
    g = rng.randn(v, c)
    return (feat, pix.astype(np.int32), weight.astype(np.float32),
            g.astype(np.float32))
