"""Carry trees and traversals between numpy and the port's containers.

:func:`tree_from_numpy` and :func:`traversal_from_numpy` take any object
with the field names of a ``Tree`` / ``FMMTraversalInfo`` (the JAX
package's containers included: every field goes through ``np.asarray``) and
return the port's containers on a given device, so a test can feed the
reference's tree and traversal to the port's wrangler;
:func:`rank_partition_from_numpy` and :func:`exchange_stages_from_numpy`
do the same for the distributed FMM's partition and multipole-exchange
schedule, and :func:`shards_from_numpy` and :func:`skeleton_from_numpy`
for the sharded build's per-rank arrays and box skeleton, so that the two
packages' results compare field for field.
:func:`to_numpy` goes the other way, for every container of the port
(trees, traversals, and the geometry results ``AreaQueryResult``,
``LeavesToBallsLookup`` and ``PeerListLookup``) and for tensors of any
dtype, complex included (a lazily conjugated tensor is conjugated
first).  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxtree_torch.config import as_torch_dtype
from boxtree_torch.traversal.containers import BuiltList, FMMTraversalInfo
from boxtree_torch.tree.containers import Tree


def _tensor(x, device):
    if x is None:
        return None
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def tree_from_numpy(tree, device="cpu"):
    """A :class:`~boxtree_torch.tree.containers.Tree` on *device* with the
    fields of *tree*."""
    values = {}
    for f in dataclasses.fields(Tree):
        v = getattr(tree, f.name)
        if f.name.endswith("_dtype"):
            values[f.name] = as_torch_dtype(v)
        elif f.name == "level_start_box_nrs":
            values[f.name] = tuple(int(x) for x in v)
        elif isinstance(v, (bool, int, float, str)) or v is None:
            values[f.name] = v
        else:
            values[f.name] = _tensor(v, device)
    return Tree(**values)


def _built_list(bl, device):
    return BuiltList(
        count=int(bl.count),
        starts=_tensor(bl.starts, device),
        lists=_tensor(bl.lists, device),
        num_nonempty_lists=int(bl.num_nonempty_lists),
        nonempty_indices=_tensor(bl.nonempty_indices, device))


def traversal_from_numpy(trav, device="cpu", tree=None):
    """An :class:`~boxtree_torch.traversal.containers.FMMTraversalInfo`
    on *device* with the fields of *trav* (and its tree, unless a port
    *tree* is given)."""
    values = {}
    for f in dataclasses.fields(FMMTraversalInfo):
        v = getattr(trav, f.name)
        if f.name == "tree":
            values[f.name] = (tree if tree is not None
                              else tree_from_numpy(v, device))
        elif f.name == "well_sep_is_n_away":
            values[f.name] = int(v)
        elif f.name == "from_sep_smaller_by_level":
            values[f.name] = tuple(_built_list(bl, device) for bl in v)
        elif f.name == "target_boxes_sep_smaller_by_source_level":
            values[f.name] = tuple(_tensor(x, device) for x in v)
        else:
            values[f.name] = _tensor(v, device)
    return FMMTraversalInfo(**values)


def rank_partition_from_numpy(rp, device="cpu"):
    """A :class:`~boxtree_torch.parallel.partition.RankPartition` on
    *device* with the fields of *rp* (int64 tensors)."""
    from boxtree_torch.parallel.partition import RankPartition

    values = {}
    for f in dataclasses.fields(RankPartition):
        v = getattr(rp, f.name)
        values[f.name] = (int(v) if f.name == "nranks" else torch.tensor(
            np.asarray(v, np.int64), device=device))
    return RankPartition(**values)


def exchange_stages_from_numpy(stages, device="cpu"):
    """Multipole-exchange stages ``(perm, send_idx, recv_idx, op)`` with
    the tables as int32 tensors on *device*."""
    return [(tuple(tuple(int(x) for x in p) for p in perm),
             torch.tensor(np.asarray(send, np.int32), device=device),
             torch.tensor(np.asarray(recv, np.int32), device=device), op)
            for perm, send, recv, op in stages]


def shards_from_numpy(arr, devices=("cpu",)):
    """A sharded array of the port (one tensor a rank) from the
    reference's ``(nranks, ...)`` per-rank array (or a tuple of such,
    giving a tuple); rank *r* on ``devices[r % len(devices)]``."""
    if isinstance(arr, tuple):
        return tuple(shards_from_numpy(a, devices) for a in arr)
    arr = np.asarray(arr)
    return [_tensor(arr[r], devices[r % len(devices)])
            for r in range(arr.shape[0])]


def skeleton_from_numpy(skel, devices=("cpu",)):
    """The reference's per-rank box skeleton dict (``sharded_box_skeleton``)
    in the port's layout: per-rank lists, ``nboxes`` as 0-d tensors."""
    return {key: shards_from_numpy(val, devices)
            for key, val in skel.items()}


def to_numpy(obj):
    """Tensors become numpy arrays, the port's containers dicts of their
    converted fields, tuples/lists tuples, dtypes numpy dtypes."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().resolve_conj().numpy()
    if isinstance(obj, torch.dtype):
        return torch.empty(0, dtype=obj).numpy().dtype
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(x) for x in obj)
    return obj
