"""Morton (Z-order) keys on int64 tensors, and the Morton-encode kernel.

Port of :mod:`boxtree_tpu.ops.morton` (``boxtree_tpu/ops/morton.py:37-125``)
with the same bit layout: the level-``l`` digit of a key occupies bits
``[d*(D-l), d*(D-l+1))``, and within each ``d``-bit digit axis 0 (x) holds
the *most* significant bit.

:func:`encode_points` is the wrapper of the hand-written CUDA kernel
``csrc/morton.cu`` (K1) on CUDA tensors and of its plain twin
:func:`encode_points_plain` on CPU tensors.  Both must give bit-identical
keys: the float steps run in the coordinates' dtype and in the reference's
order (subtract, divide, multiply by ``2**depth``, floor).
"""

from __future__ import annotations

import torch

from boxtree_torch import config
from boxtree_torch.ops import kernels

# 64-bit bit-spread magic constants (boxtree_tpu/ops/morton.py:20-34)
_SPREAD2_MASKS = [
    (16, 0x0000FFFF0000FFFF),
    (8, 0x00FF00FF00FF00FF),
    (4, 0x0F0F0F0F0F0F0F0F),
    (2, 0x3333333333333333),
    (1, 0x5555555555555555),
]

_SPREAD3_MASKS = [
    (32, 0x001F00000000FFFF),
    (16, 0x001F0000FF0000FF),
    (8, 0x100F00F00F00F00F),
    (4, 0x10C30C30C30C30C3),
    (2, 0x1249249249249249),
]


def _spread(x, dimensions: int):
    """Insert ``dimensions-1`` zero bits between the bits of ``x`` (int64)."""
    if dimensions == 1:
        return x
    if dimensions == 2:
        masks = _SPREAD2_MASKS
        x = x & 0xFFFFFFFF
    else:
        masks = _SPREAD3_MASKS
        x = x & 0x1FFFFF
    for shift, mask in masks:
        x = (x | (x << shift)) & mask
    return x


def _compact(x, dimensions: int):
    """Inverse of :func:`_spread`."""
    if dimensions == 1:
        return x
    if dimensions == 2:
        masks = _SPREAD2_MASKS
        final_mask = 0xFFFFFFFF
    else:
        masks = _SPREAD3_MASKS
        final_mask = 0x1FFFFF
    x = x & masks[-1][1]
    for i in range(len(masks) - 1, 0, -1):
        x = (x | (x >> masks[i][0])) & masks[i - 1][1]
    return (x | (x >> masks[0][0])) & final_mask


def _axis_mask(dimensions: int):
    if dimensions == 1:
        return -1
    if dimensions == 2:
        return _SPREAD2_MASKS[-1][1]
    return _SPREAD3_MASKS[-1][1]


def interleave(cells):
    """Encode integer cell coordinates into a Morton key.

    :arg cells: int64 tensor of shape ``(dimensions, n)``.
    :returns: int64 tensor of shape ``(n,)``.
    """
    dimensions = cells.shape[0]
    code = torch.zeros(cells.shape[1:], dtype=config.morton_dtype,
                       device=cells.device)
    for ax in range(dimensions):
        code = code | (_spread(cells[ax], dimensions)
                       << (dimensions - 1 - ax))
    return code


def deinterleave(code, dimensions: int):
    """Decode Morton keys back into per-axis cell coordinates.

    :returns: int64 tensor of shape ``(dimensions,) + code.shape``.
    """
    return torch.stack([
        _compact((code >> (dimensions - 1 - ax)) & _axis_mask(dimensions),
                 dimensions)
        for ax in range(dimensions)])


def cells_from_coords(coords, bbox_min, root_extent, depth: int):
    """Integer cell coordinates of particles at tree depth ``depth``:
    ``floor((coords - bbox_min) / root_extent * 2**depth)``, clamped.

    :arg coords: ``(dimensions, n)`` float tensor.
    :arg bbox_min: ``(dimensions,)`` float tensor.
    :arg root_extent: 0-d float tensor.
    """
    scaled = (coords - bbox_min[:, None]) / root_extent
    nbuckets = 1 << depth
    cells = torch.floor(scaled * float(nbuckets)).to(config.morton_dtype)
    return cells.clamp(0, nbuckets - 1)


def encode_points_plain(coords, bbox_min, root_extent, depth: int,
                        iota_bits=None):
    """Plain PyTorch twin of the K1 kernel: full-depth Morton keys, and
    with *iota_bits* the packed sort keys ``(code << iota_bits) | i``
    (``boxtree_tpu/tree/build.py:146-157``)."""
    codes = interleave(cells_from_coords(coords, bbox_min, root_extent,
                                         depth))
    if iota_bits is None:
        return codes
    iota = torch.arange(codes.shape[0], dtype=torch.int64,
                        device=codes.device)
    return (codes << iota_bits) | iota


def encode_points(coords, bbox_min, root_extent, depth: int,
                  iota_bits=None):
    """Full-depth Morton keys of particle coordinates (packed with the
    particle index when *iota_bits* is given).

    CPU tensors take :func:`encode_points_plain`; CUDA tensors launch the
    K1 kernel (``csrc/morton.cu``), which replaces
    ``boxtree_tpu/ops/morton.py:123`` ``encode_points`` together with the
    key packing of ``boxtree_tpu/tree/build.py:146-157``.
    """
    if coords.device.type == "cpu":
        return encode_points_plain(coords, bbox_min, root_extent, depth,
                                   iota_bits)
    dimensions, n = coords.shape
    if coords.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported coordinate dtype {coords.dtype}")
    if iota_bits is not None and dimensions * depth + iota_bits > 63:
        raise ValueError("packed Morton key would not fit in 63 bits")
    coords = coords.contiguous()
    bbox_min = bbox_min.to(coords.dtype).contiguous()
    root_extent = torch.as_tensor(root_extent, dtype=coords.dtype,
                                  device=coords.device).reshape(1)
    kernels.check_tensors(coords, bbox_min, root_extent, dtype=coords.dtype)
    out = torch.empty(n, dtype=config.morton_dtype, device=coords.device)
    kernels.launch(
        "morton_encode", coords.dtype, coords, n, bbox_min, root_extent,
        dimensions, depth, -1 if iota_bits is None else iota_bits, out)
    return out
