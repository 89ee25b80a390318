"""Tree data structures as frozen dataclasses of tensors.

Port of :mod:`boxtree_tpu.tree.containers` (``boxtree_tpu/tree/
containers.py:38-308``): :class:`box_flags_enum`, :class:`TreeOfBoxes` and
:class:`Tree` with the same field names, dtypes and conventions
(level-major box numbering, ``0`` as the no-child marker, CSR particle
ranges per box, particles in tree order).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar

import torch


class box_flags_enum:  # noqa: N801  (the reference's name)
    """Constants for the box flags bit field (``boxtree/tree.py:109-147``)."""

    dtype: ClassVar[torch.dtype] = torch.int32

    IS_SOURCE_BOX = 1 << 0
    IS_TARGET_BOX = 1 << 1
    IS_SOURCE_OR_TARGET_BOX = IS_SOURCE_BOX | IS_TARGET_BOX
    HAS_SOURCE_CHILD_BOXES = 1 << 2
    HAS_TARGET_CHILD_BOXES = 1 << 3
    HAS_SOURCE_OR_TARGET_CHILD_BOXES = (
        HAS_SOURCE_CHILD_BOXES | HAS_TARGET_CHILD_BOXES)
    IS_LEAF_BOX = 1 << 4

    HAS_CHILDREN = HAS_SOURCE_OR_TARGET_CHILD_BOXES


@dataclass(frozen=True)
class TreeOfBoxes:
    """A quad/octree of boxes (without particle data).

    ``root_extent`` is a 0-d tensor; ``box_centers`` is ``(dimensions,
    nboxes)``; ``box_child_ids`` is ``(2**dimensions, nboxes)``;
    ``box_morton_prefixes`` holds each box's level-local Morton prefix;
    ``level_start_box_nrs`` is a host tuple of ``nlevels + 1`` ints.
    """

    root_extent: Any
    box_centers: Any

    box_parent_ids: Any
    box_child_ids: Any
    box_levels: Any

    box_flags: Any
    box_morton_prefixes: Any

    level_start_box_nrs: tuple

    box_id_dtype: torch.dtype
    box_level_dtype: torch.dtype
    coord_dtype: torch.dtype

    sources_have_extent: bool
    targets_have_extent: bool
    extent_norm: Any
    stick_out_factor: float

    _is_pruned: bool
    max_depth: int

    @property
    def dimensions(self) -> int:
        return self.box_centers.shape[0]

    @property
    def nboxes(self) -> int:
        return self.box_centers.shape[1]

    @property
    def nlevels(self) -> int:
        return len(self.level_start_box_nrs) - 1

    @property
    def leaf_boxes(self):
        return torch.nonzero(
            self.box_flags & box_flags_enum.IS_LEAF_BOX)[:, 0].to(
                self.box_id_dtype)

    @property
    def bounding_box(self):
        lows = self.box_centers[:, 0] - 0.5 * self.root_extent
        return lows, lows + self.root_extent


@dataclass(frozen=True)
class Tree(TreeOfBoxes):
    """A quad/octree of particles sorted into boxes.

    ``sources``/``targets`` are ``(dimensions, n)`` in *tree order*
    (sorted by full-depth Morton key); ``user_source_ids`` gathers from
    user order into tree order and ``sorted_target_ids`` from tree order
    into user order (``boxtree/tree.py:426-438``).  ``box_id_of_source`` /
    ``box_id_of_target`` name each particle's owning (nonchild) box.
    """

    sources_are_targets: bool
    particle_id_dtype: torch.dtype

    sources: Any
    source_radii: Any
    targets: Any
    target_radii: Any

    user_source_ids: Any
    sorted_target_ids: Any

    box_source_starts: Any
    box_source_counts_nonchild: Any
    box_source_counts_cumul: Any
    box_target_starts: Any
    box_target_counts_nonchild: Any
    box_target_counts_cumul: Any

    box_source_bounding_box_min: Any
    box_source_bounding_box_max: Any
    box_target_bounding_box_min: Any
    box_target_bounding_box_max: Any

    box_id_of_source: Any
    box_id_of_target: Any

    @property
    def dimensions(self) -> int:
        return self.sources.shape[0]

    @property
    def nboxes(self) -> int:
        return self.box_levels.shape[0]

    @property
    def nsources(self) -> int:
        return self.sources.shape[1]

    @property
    def ntargets(self) -> int:
        return self.targets.shape[1]
