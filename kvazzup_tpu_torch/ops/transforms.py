"""HEVC transform matrices (counterpart of kvazzup_tpu/ops/transforms.py).

The encoder's transforms are the flat Kronecker-stage products in
`ctu_kernels.fwd_transform_flat` / `inv_transform_flat`; this module only
builds their numpy matrices.
"""

from __future__ import annotations

import numpy as np

from ..core import tables


def transform_matrices(log2: int, dst: bool = False) -> np.ndarray:
    n = 1 << log2
    return tables.DST4 if (dst and n == 4) else tables.dct_matrix(n)
