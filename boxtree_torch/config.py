"""Global configuration and dtype policy for boxtree_torch.

The same policy as :mod:`boxtree_tpu.config` (``boxtree_tpu/config.py:45-67``):
integer box/particle ids and box levels are int32, Morton keys are int64,
coordinates are float32 or float64 (user choice).  Expansion coefficients
and potentials are of the wrangler's dtype: real (Laplace, real pairs) or
complex128 (Helmholtz), over float64 coordinates.

Float32 matrix products must stay float32: TF32 keeps about three decimal
digits, which would ruin the M2L/M2M/L2L translations the same way
reduced-precision matrix passes do.  Importing the package therefore turns
TF32 off for both cuBLAS and cuDNN.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# id dtypes
box_id_dtype = torch.int32
particle_id_dtype = torch.int32
box_level_dtype = torch.int32
morton_dtype = torch.int64


def as_torch_dtype(dtype):
    """A torch dtype from a torch or numpy dtype (or type, or its name),
    complex ones included."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype

#: Stretch factor applied to the root box extent so that scaled particle
#: coordinates are always strictly less than 1.
#: (mirrors ``boxtree_tpu.config.ROOT_EXTENT_STRETCH_FACTOR``)
ROOT_EXTENT_STRETCH_FACTOR = 1e-4


def max_morton_depth(dimensions: int) -> int:
    """Deepest tree level representable in a single signed-int64 Morton key
    (``dimensions * depth`` bits must fit in 62 bits)."""
    return 62 // dimensions
