#!/usr/bin/env python3
"""Smoke run of boxtree_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``boxtree_torch/csrc`` and drives twelve
paths of the port on the card, each with the kernels' launch counts set to
0 just before it and read just after:

- the main path of ``bench.py``: the counting FMM and the 3D Laplace FMM
  (order 8, real pairs, ``rscale="auto"``, float32) at 1e6 uniform points,
  checked against an exact count and a float64 direct sum (K1-K4, K28 P2M,
  K30 L2P);
- Config B: a level-restricted octree of 1e6 points on the unit sphere
  (float64), its 2:1 property checked by an area query, the traversal and
  the counting FMM on it, then 1e5 QBX-centre-like balls through the area
  query, leaves-to-balls, the space invader, and the peer lists, each held
  to a float64 brute force or an oracle (K1, K5-K8);
- the 3D Helmholtz FMM (complex128, order 12, k = 2, ``rscale="auto"``) at
  1e6 uniform points in float64, checked against a complex128 direct sum
  at 2,000 sampled targets (K1, K9-K11, K31 P2M, K32 L2P);
- the real-pair 3D Helmholtz FMM (``helmholtz_pairs_fmm``): the wrangler
  that ``pairs=None`` gives on the card (float64 ``[re | im]``
  coefficients, ``(n, 2)`` potentials), on the 3D Helmholtz path's tree
  and traversal with the real parts of its charges, against the complex
  wrangler's FMM on the same traversal and charges at every target (rel
  l-inf <= 1e-12) and the complex128 direct sum at 2,000 targets (< 1e-5),
  with no host read in M2L (K47-K51, the float64 entry points of K9-K11,
  K31 and K32, and K35-K37 in float64), K47-K51 against their twins at
  the path's own inputs; then K47-K51 against their twins at 1e5 points
  (``kernels_helmholtz_pairs``);
- the QBX extent tree: Config B's 1e6 sphere points as sources and 1e5
  QBX-like centres with radii as targets (stick-out factor 0.25), the
  traversal with its close lists, the counting FMM exact with the close
  lists and after merging them into List 1, and the 3D Laplace FMM (order
  10, float64) against a float64 direct sum at 2,000 sampled centres (K1-K4,
  K12-K15, K28, K30);
- the 2D Helmholtz FMM (complex128, order 16, k = 3, ``rscale="auto"``) at
  1e6 float64 points in the unit square, 4/15 of them clustered in
  [0.4, 0.5]^2, checked against a complex128 direct sum of ``(i/4) H_0``
  at 2,000 sampled targets, taken with ``torch.special``'s ``j0``/``y0``
  (held to ``scipy.special.hankel1`` first) (K1, K16-K18, K33 P2M, K34
  L2P); then the 2D wrangler at order 16 and k = 200 on 2e4 such points
  (a J recurrence from 954, past the 227 KiB a CTA that K17 / K18 once
  needed): its FMM, finite, and K17, K18, K33 and K34 against their twins
  at its inputs;
- the real-pair 2D Helmholtz FMM (``helmholtz2d_pairs_fmm``) likewise on
  the 2D Helmholtz path's tree (K52-K56, the float64 entry points of
  K16-K18, K33 and K34), K52-K56 against their twins at its inputs and
  at 1e5 points, and
  the pair wrangler at order 16, k = 200 on the 2e4 points above: its FMM
  through K52-K56 and K53-K56 against their twins;
- the 2D Laplace FMM (order 20, ``rscale="auto"``), complex128 and float64
  pairs on one tree, at 1e6 float64 points in the unit square, 24 % of
  them in [0.45, 0.55]^2, with real charges: the real parts against a
  float64 direct sum at 2,000 sampled targets, the pairs against the
  complex real part, the counting FMM on the same traversal; then the
  order-35 geometric line of ``tests/test_stability.py`` (K1, K19-K21,
  K38 P2M and K40 L2P, each once an FMM);
- the 2D Laplace double layer (order 20, ``rscale="auto"``): 1e6 sources
  on the five-armed starfish ``r = 1 + 0.25 cos 5 theta`` with their unit
  outward normals as dipoles and real normal weights, 2e5 targets in
  [-1.5, 1.5]^2, the complex128, float64 pairs and float32 pairs wranglers
  on one tree: the real parts against a float64 direct sum of ``w d . (s
  - t) / |t - s|^2`` at 2,000 sampled targets, the pairs against the
  complex real part (K1, K20, K39 dipole P2M, K40, K41 dipole P2P, K42
  dipole P2L, each once an FMM, and K35-K37);
- the 3D Laplace double layer (order 12, ``rscale="auto"``): 1e6 sources
  on the unit sphere (Config B's generator and seed) with their outward
  normals as dipoles and real normal weights, 2e5 targets uniform in
  [-1, 1]^3, the complex128 and the float64 pairs wranglers on one tree,
  the pairs with ``level_to_order`` and the complex128 single layer: the
  real parts against float64 direct sums at 2,000 sampled targets, the
  pairs against the complex real part (K1, K2-K4 complex128, K22 dipole
  P2P, K23 dipole P2L, K28 P2M and K30 L2P, K29 dipole P2M); each of its
  four FMMs must launch K28 (or K29, with dipoles) and K30 once;
- the 3D Helmholtz dipoles (``helmholtz3d_dipole_fmm``, order 12, k = 2,
  ``rscale="auto"``): the 3D double layer's 1e6 sphere sources with their
  normals as dipoles and real weights and its 2e5 targets, the complex128
  wrangler and the pairs that ``pairs=None`` gives on the card on one
  traversal: the complex potentials against a complex128 direct sum of
  ``w (d . grad_y) exp(ik r)/r`` at 2,000 sampled targets (< 1e-5), the
  pairs against the complex wrangler at every target (<= 1e-12), each FMM
  launching its layout's dipole P2M, P2P and P2L once (K57-K59, pairs
  K60-K62) and no charge P2M / P2P / P2L, with no host read; K57-K62
  against their twins at 1e5 sphere sources first
  (``kernels_helmholtz3d_dipole_small``: rscale ``"auto"`` with the
  normals and None with standard-normal dipoles, a source on its box's
  centre) and timed at the 1e6 inputs beside the charge kernels K31, K9,
  K11 (pairs K50, K47, K49) on the same inputs
  (``kernels_helmholtz3d_dipole``);
- the 2D Helmholtz dipoles (``helmholtz2d_dipole_fmm``, order 16, k = 3,
  ``rscale="auto"``): the 2D Helmholtz path's 1e6 clustered points, tree
  and traversal, standard-normal dipoles, the complex128 wrangler with the
  path's complex weights and the pairs that ``pairs=None`` gives on the
  card with their real parts: each against a complex128 direct sum of ``w
  (i/4) k H_1(k r) d . (x - y) / r`` at 2,000 sampled targets (< 1e-5;
  ``torch.special``'s ``j1``/``y1``, held to ``scipy.special.hankel1(1,
  .)`` first), the pairs against the complex wrangler on the same real
  weights at every target (<= 1e-12), each FMM launching its layout's
  dipole P2M, P2P and P2L once (K63-K65, pairs K66-K68) and no charge
  P2M / P2P / P2L, with no host read; K63-K68 against their twins at 1e5
  clustered points first (``kernels_helmholtz2d_dipole_small``: rscale
  ``"auto"`` and None, a source on its box's centre) and at the 1e6
  inputs, timed beside the charge kernels K33, K16, K18 (pairs K55, K52,
  K54) on the same inputs (``kernels_helmholtz2d_dipole``).

Every path builds its tree with K43 (phase A: leaf levels and box
counts, one launch and one host read per depth tried) and K44 (phase B,
one launch a level, no host read), Config B's restricted tree also with
K45 (the restriction's sweep, one launch a level a round) and K46 (its
recount); the main path's, Config B's and the 2D double layer's lines
give ``host_reads_per_build`` (device-to-host copies in a
``torch.profiler`` trace of one more build: 1 per depth tried, and 1 +
rounds + 1 restricted), held to those counts with the launches.  The
``kernels_tree`` lines hold K43 and K44 (and K45 / K46 on Config B's
tree) against their twins, every output equal and the box centres bit for
bit, on the main-path, Config B, extent and 2D double-layer trees.  The
``tree_options`` lines build the main path's 1e6 float32 points as a
non-adaptive tree, with int32 refine weights uniform in 1..9
(``max_leaf_refine_weight=150``) and in a given bbox ``[[-0.25, 1.25]] *
3``: each build's time, host reads and launches, ``tests/test_tree.py``'s
invariants (1,000 sampled boxes for containment and leaf weights), the
traversal and the counting FMM exact; the non-adaptive tree also runs the
order-8 float32 Laplace FMM against a float64 direct sum (rel l-inf <=
1e-3).

Every path builds its traversal with K24-K27 (the neighbour table, the
colleagues and List 2, Lists 4 and 3, List 1; the extent tree's Lists 3
and 4 come from K14/K15), and its line gives ``traversal_s`` beside
``traversal_plain_s``, the same traversal with the kernels' plain twins
on the card.  The ``kernels_traversal`` lines hold K24-K27 against their
twins bit for bit on the main-path, Config B, extent and 2D Laplace
trees.  The ``kernels_p2m_l2p`` lines hold K28-K30 against their twins at
the main path's, the extent path's and the double layer's inputs (each
box's multipole row to its own largest value; the twin of K29, a
``torch.func.jvp``, timed in one call); the ``kernels_p2m_l2p_helmholtz``
lines K31-K34 at the 1e6 Helmholtz paths' inputs (each coefficient column
to its own largest value), and each Helmholtz FMM must launch its P2M and
L2P kernels once.

Every FMM of the expansion wranglers runs M2M, M2L and L2L through K36,
K35 and K37 (``csrc/translate.cu``); each path's FMM line counts its host
reads (device-to-host copies in a ``torch.profiler`` trace of one FMM and
of its M2L stage alone), and its ``kernels_translation`` line holds
K35-K37 against their twins at the stage inputs of one more FMM (per
coefficient column, 1e-12 in float64 and complex128, 1e-5 in float32),
with their launches per FMM, times, bounds and the library yardstick (the
reference's own form on cuBLAS: per level a gathered ``(rows, m 2^d K)``
block times the ``(m 2^d K, 2^d K)`` block operator for M2L, a
``torch.matmul`` and an ``index_add_`` per (level, digit) for M2M and
L2L), on the main path (float32), the double layer (complex128, float64
pairs, ``level_to_order``), 3D Helmholtz, 2D Helmholtz, 2D Laplace
(complex128, float64 pairs) and the QBX extent tree (float64 pairs).  The
``laplace3d_stability`` phase runs ``tests/test_stability.py:28``'s
(3, 31) line on the card (17 levels, 1,024 coefficients a row): its FMM
within the reference's bar (3/4)^32, the M2L table's bytes and used keys,
K2-K4, K28-K30 and K35-K37 launched at that width and held to their
twins.

Every Laplace wrangler builds its M2L table in one launch of K69-K71
(3D) or K72-K74 (2D): on the main path, the QBX extent tree, the 2D
Laplace path, the 2D and 3D double layers and the order-31 line, an
``m2l_table`` line gives ``wrangler_setup_s`` beside ``m2l_table_s`` (the
table kernel, median of 5 synchronised calls with its inputs' upload) and
its twin's time on the same inputs, the operators, the table's bytes and
its bound, holds the kernel to its twin per operator (1e-12, float32
1e-6) and asserts one launch in the setup.  The ``rotation_m2l`` phase
runs ``m2l_mode="rotation"`` on two trees the script has already built,
the main path's (float32 pairs, order 8) and the 3D double layer's
(complex128 and float64 pairs, order 12, normals as dipoles): the
setup split (the edge plan by K75 / K76, the host's block fits, the
axial operators by K69), the edges, operators and rotation classes, the
second FMM's M2L stage (K77-K79) beside the dense K35 stage on the same
traversal, the potentials against the dense FMM (1e-12; float32 1e-5)
and the path's direct sum, one launch of K77-K79 and none of K35 an
FMM, 0 host reads in M2L (sync debug mode) and the peak memory; its
``kernels_rotation`` lines hold K75 / K76 to their twin exactly and
K77-K79 to theirs over the locals on every k-th operator group (at most
64), each entry point timed.

The ``distributed_fmm`` phase runs ``boxtree_torch.parallel``'s
``DistributedFMMRunner`` on the main path's traversal and wrangler (f32
pairs, order 8) with 4 ranks on the hypercube exchange, 4 on the allreduce
and 3 on the hypercube (fold-in and fold-out stages), all ranks on the
card: each against the single-device FMM on the same traversal at every
target (rel l-inf <= 1e-5) and the f64 direct sum (<= 1e-3), with
``dfmm_s`` beside ``fmm_s``, the setup, peak memory, each rank's List-2
pairs beside the traversal's (each must be fewer), the exchange's stages,
rows and bytes, rank 0's P2M / M2M / L2L / L2P (what every rank repeats)
beside the single FMM's, and K80-K82 launched (the allreduce K82 alone);
the counting runner exact at 3 and 4 ranks (``distributed_counting``);
``kernels_distributed`` holds K80 (pack), K81 (unpack, add and set) and
K82 (the weights' mask, the potentials' merge, the dense sum) to their
twins bit for bit at those shapes, with the library yardsticks
(``index_select``, ``index_add_`` / ``index_copy_``, ``torch.where``).

The ``sharded_build`` phase runs ``boxtree_torch.parallel.shard_build``'s
``sharded_build_tree`` with all ranks on the card: the main path's 1e6
uniform float32 points at 4 and 8 ranks, 1e6 points half in a cube of
edge 0.05 at 8 (the capacity retries), and 1e7 uniform points at 8.
Each tree must equal ``build_tree``'s field for field (centres bit for
bit), each build read the host 3 times (``read_count``; once more a
capacity retry of the sort or the permutation) and launch K1 and
K83-K88 (K87 once a rank, K88 once a rank a level); its line gives
``sbuild_s`` beside ``build_s`` (medians of 3 warm builds), the split of
one build, the capacity factors and radius, the bytes between ranks, the
peak memory and ``nboxes``; the counting FMM on the 4-rank tree must be
exact.  ``kernels_sharded_build`` holds K83-K88 to their twins bit for
bit at rank 0's calls of one 1e6 8-rank build (K88 at its level with the
most boxes), with the library yardsticks ``index_select`` (K85) and
``index_copy_`` (K86).

Every kernel is also held against its plain PyTorch twin at the shapes of
its path (K9-K11, K16-K18, K19-K21, K38-K42 and the 3D Laplace kernels at
1e5 points as well, a shallower tree; K19-K21, K38-K42, K2-K4 and K22-K23
on every entry point there; K47-K56 at 1e5 points only, timed alone at
their 1e6 path's inputs; K57-K68 at 1e5 points and at 1e6, a twin
slower than a second timed once there),
and timed beside it (median of 5 synchronised calls; 3 for the slow
Helmholtz twins at 1e6) and beside its bound, the least time the card
could take for the same work.  Each phase prints one JSON line; then come
the card's name and power limit as ``nvidia-smi`` reports them, the
per-kernel summary and, last, the ``{"ok": true, ...}`` line.  Any failed
phase raises, and the script exits non-zero.  Without a CUDA device it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

REPLACES = {
    "morton_encode": "boxtree_tpu/ops/morton.py:123",
    "p2p_laplace3d": "boxtree_tpu/models/expansion_base.py:1258",
    "m2p_laplace3d": "boxtree_tpu/models/expansion_base.py:1440",
    "p2l_laplace3d": "boxtree_tpu/models/expansion_base.py:1629",
    "restrict_demand": "boxtree_tpu/tree/level_restrict.py:42",
    "area_query_sweep": "boxtree_tpu/geometry/area_query.py:86",
    "space_invader_sweep": "boxtree_tpu/geometry/area_query.py:259",
    "peer_lists": "boxtree_tpu/geometry/area_query.py:341",
    "p2p_helmholtz3d": "boxtree_tpu/models/helmholtz3d.py:362",
    "m2p_helmholtz3d": "boxtree_tpu/models/helmholtz3d.py:341",
    "p2l_helmholtz3d": "boxtree_tpu/models/helmholtz3d.py:351",
    "stick_levels": "boxtree_tpu/tree/build.py:85",
    "box_extents": "boxtree_tpu/tree/build.py:536",
    "list4_ext": "boxtree_tpu/traversal/build.py:264",
    "list3_ext": "boxtree_tpu/traversal/build.py:398",
    "p2p_helmholtz2d": "boxtree_tpu/models/helmholtz.py:284",
    "m2p_helmholtz2d": "boxtree_tpu/models/helmholtz.py:275",
    "p2l_helmholtz2d": "boxtree_tpu/models/helmholtz.py:279",
    "p2p_laplace2d": "boxtree_tpu/models/laplace.py:232",
    "m2p_laplace2d": "boxtree_tpu/models/laplace.py:210",
    "p2l_laplace2d": "boxtree_tpu/models/laplace.py:221",
    "p2p_laplace3d_dipole": "boxtree_tpu/models/expansion_base.py:1314",
    "p2l_laplace3d_dipole": "boxtree_tpu/models/expansion_base.py:1688",
    "neighbor_table": "boxtree_tpu/traversal/neighbors.py:65",
    "row_lists_sl_l2": "boxtree_tpu/traversal/build.py:944",
    "lists_43": "boxtree_tpu/traversal/build.py:1151",
    "list1": "boxtree_tpu/traversal/build.py:1334",
    "p2m_laplace3d": "boxtree_tpu/models/expansion_base.py:652",
    "p2m_laplace3d_dipole": "boxtree_tpu/models/expansion_base.py:664",
    "l2p_laplace3d": "boxtree_tpu/models/expansion_base.py:1793",
    "p2m_helmholtz3d": "boxtree_tpu/models/helmholtz3d.py:316",
    "l2p_helmholtz3d": "boxtree_tpu/models/helmholtz3d.py:330",
    "p2m_helmholtz2d": "boxtree_tpu/models/helmholtz.py:267",
    "l2p_helmholtz2d": "boxtree_tpu/models/helmholtz.py:271",
    "m2l_translate": "boxtree_tpu/models/expansion_base.py:1016",
    "m2m_translate": "boxtree_tpu/models/expansion_base.py:684",
    "l2l_translate": "boxtree_tpu/models/expansion_base.py:723",
    "p2m_laplace2d": "boxtree_tpu/models/laplace.py:191",
    "p2m_laplace2d_dipole": "boxtree_tpu/models/expansion_base.py:664",
    "l2p_laplace2d": "boxtree_tpu/models/laplace.py:201",
    "p2p_laplace2d_dipole": "boxtree_tpu/models/expansion_base.py:1314",
    "p2l_laplace2d_dipole": "boxtree_tpu/models/expansion_base.py:1688",
    "tree_leaf_levels": "boxtree_tpu/tree/build.py:113",
    "tree_level_boxes": "boxtree_tpu/tree/build.py:262",
    "restrict_sweep": "boxtree_tpu/tree/level_restrict.py:42",
    "level_box_counts": "boxtree_tpu/tree/level_restrict.py:123",
    "m2l_table_3d": "boxtree_tpu/models/laplace.py:449",
    "m2l_table_2d": "boxtree_tpu/models/laplace.py:160",
    "m2l_classify_keys": "boxtree_tpu/models/particle_blocks.py:214",
    "m2l_classify_unpack": "boxtree_tpu/models/particle_blocks.py:214",
    "m2l_rotate": "boxtree_tpu/models/rotation_m2l.py:221",
    "pack_rows": "boxtree_tpu/parallel/distributed.py:494",
    "unpack_rows": "boxtree_tpu/parallel/distributed.py:498",
    "masked_merge": "boxtree_tpu/parallel/distributed.py:552",
    "bucket_pack": "boxtree_tpu/parallel/shard_sort.py:109",
    "rebalance_place": "boxtree_tpu/parallel/shard_sort.py:211",
    "permute_serve": "boxtree_tpu/parallel/shard_sort.py:327",
    "permute_unpack": "boxtree_tpu/parallel/shard_sort.py:342",
    "shard_leaf_levels": "boxtree_tpu/parallel/shard_build.py:296",
    "shard_box_skeleton": "boxtree_tpu/parallel/shard_build.py:713",
}
SOURCES = {
    "morton_encode": "boxtree_torch/csrc/morton.cu",
    "p2p_laplace3d": "boxtree_torch/csrc/p2p.cu",
    "m2p_laplace3d": "boxtree_torch/csrc/m2p.cu",
    "p2l_laplace3d": "boxtree_torch/csrc/p2l.cu",
    "restrict_demand": "boxtree_torch/csrc/restrict.cu",
    "area_query_sweep": "boxtree_torch/csrc/area_query.cu",
    "space_invader_sweep": "boxtree_torch/csrc/area_query.cu",
    "peer_lists": "boxtree_torch/csrc/peers.cu",
    "p2p_helmholtz3d": "boxtree_torch/csrc/helmholtz3d.cu",
    "m2p_helmholtz3d": "boxtree_torch/csrc/helmholtz3d.cu",
    "p2l_helmholtz3d": "boxtree_torch/csrc/helmholtz3d.cu",
    "stick_levels": "boxtree_torch/csrc/extents.cu",
    "box_extents": "boxtree_torch/csrc/extents.cu",
    "list4_ext": "boxtree_torch/csrc/close_lists.cu",
    "list3_ext": "boxtree_torch/csrc/close_lists.cu",
    "p2p_helmholtz2d": "boxtree_torch/csrc/helmholtz2d.cu",
    "m2p_helmholtz2d": "boxtree_torch/csrc/helmholtz2d.cu",
    "p2l_helmholtz2d": "boxtree_torch/csrc/helmholtz2d.cu",
    "p2p_laplace2d": "boxtree_torch/csrc/laplace2d.cu",
    "m2p_laplace2d": "boxtree_torch/csrc/laplace2d.cu",
    "p2l_laplace2d": "boxtree_torch/csrc/laplace2d.cu",
    "p2p_laplace3d_dipole": "boxtree_torch/csrc/p2p.cu",
    "p2l_laplace3d_dipole": "boxtree_torch/csrc/p2l.cu",
    "neighbor_table": "boxtree_torch/csrc/traversal.cu",
    "row_lists_sl_l2": "boxtree_torch/csrc/traversal.cu",
    "lists_43": "boxtree_torch/csrc/traversal.cu",
    "list1": "boxtree_torch/csrc/traversal.cu",
    "p2m_laplace3d": "boxtree_torch/csrc/p2m.cu",
    "p2m_laplace3d_dipole": "boxtree_torch/csrc/p2m.cu",
    "l2p_laplace3d": "boxtree_torch/csrc/l2p.cu",
    "p2m_helmholtz3d": "boxtree_torch/csrc/helmholtz3d.cu",
    "l2p_helmholtz3d": "boxtree_torch/csrc/helmholtz3d.cu",
    "p2m_helmholtz2d": "boxtree_torch/csrc/helmholtz2d.cu",
    "l2p_helmholtz2d": "boxtree_torch/csrc/helmholtz2d.cu",
    "m2l_translate": "boxtree_torch/csrc/translate.cu",
    "m2m_translate": "boxtree_torch/csrc/translate.cu",
    "l2l_translate": "boxtree_torch/csrc/translate.cu",
    "p2m_laplace2d": "boxtree_torch/csrc/laplace2d.cu",
    "p2m_laplace2d_dipole": "boxtree_torch/csrc/laplace2d.cu",
    "l2p_laplace2d": "boxtree_torch/csrc/laplace2d.cu",
    "p2p_laplace2d_dipole": "boxtree_torch/csrc/laplace2d.cu",
    "p2l_laplace2d_dipole": "boxtree_torch/csrc/laplace2d.cu",
    "tree_leaf_levels": "boxtree_torch/csrc/tree.cu",
    "tree_level_boxes": "boxtree_torch/csrc/tree.cu",
    "restrict_sweep": "boxtree_torch/csrc/restrict.cu",
    "level_box_counts": "boxtree_torch/csrc/tree.cu",
    "p2m_helmholtz3d_dipole": "boxtree_torch/csrc/helmholtz3d.cu",
    "p2p_helmholtz3d_dipole": "boxtree_torch/csrc/helmholtz3d.cu",
    "p2l_helmholtz3d_dipole": "boxtree_torch/csrc/helmholtz3d.cu",
    "p2m_helmholtz2d_dipole": "boxtree_torch/csrc/helmholtz2d.cu",
    "p2p_helmholtz2d_dipole": "boxtree_torch/csrc/helmholtz2d.cu",
    "p2l_helmholtz2d_dipole": "boxtree_torch/csrc/helmholtz2d.cu",
    "m2l_table_3d": "boxtree_torch/csrc/m2l_ops.cu",
    "m2l_table_2d": "boxtree_torch/csrc/m2l_ops.cu",
    "m2l_classify_keys": "boxtree_torch/csrc/rotation.cu",
    "m2l_classify_unpack": "boxtree_torch/csrc/rotation.cu",
    "m2l_rotate": "boxtree_torch/csrc/rotation.cu",
    "pack_rows": "boxtree_torch/csrc/exchange.cu",
    "unpack_rows": "boxtree_torch/csrc/exchange.cu",
    "masked_merge": "boxtree_torch/csrc/exchange.cu",
    **{name: "boxtree_torch/csrc/shard.cu" for name in (
        "bucket_pack", "rebalance_place", "permute_serve", "permute_unpack",
        "shard_leaf_levels", "shard_box_skeleton")},
}
#: K43 and K44, launched by every tree build (K45 and K46 by a restricted
#: one)
TREE_KERNELS = ("tree_leaf_levels", "tree_level_boxes")
RESTRICT_KERNELS = ("restrict_sweep", "level_box_counts")
#: K24-K27, launched by every traversal; the extent tree's Lists 3 and 4
#: come from K14/K15 instead of K26
TRAVERSAL_KERNELS = ("neighbor_table", "row_lists_sl_l2", "lists_43",
                     "list1")
EXTENT_TRAVERSAL_KERNELS = ("neighbor_table", "row_lists_sl_l2", "list1")
#: K28 and K30, launched once by each 3D Laplace FMM without dipoles
P2M_L2P_KERNELS = ("p2m_laplace3d", "l2p_laplace3d")
#: K35-K37, launched by every FMM of the expansion wranglers
FMM_TRANSLATE = ("m2l_translate", "m2m_translate", "l2l_translate")
MAIN_PATH_KERNELS = ("morton_encode", *TREE_KERNELS, *TRAVERSAL_KERNELS,
                     "p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d",
                     *P2M_L2P_KERNELS, *FMM_TRANSLATE, "m2l_table_3d")
CONFIG_B_KERNELS = ("morton_encode", *TREE_KERNELS, "restrict_demand",
                    *RESTRICT_KERNELS, *TRAVERSAL_KERNELS,
                    "area_query_sweep", "space_invader_sweep", "peer_lists")
EXTENT_KERNELS = ("morton_encode", *TREE_KERNELS, "stick_levels",
                  "box_extents", *EXTENT_TRAVERSAL_KERNELS, "list4_ext",
                  "list3_ext", "p2p_laplace3d", "m2p_laplace3d",
                  "p2l_laplace3d", *P2M_L2P_KERNELS, *FMM_TRANSLATE)
#: K31 and K32 (K33 and K34), launched once by each 3D (2D) Helmholtz FMM
HELMHOLTZ_P2M_L2P = ("p2m_helmholtz3d", "l2p_helmholtz3d")
HELMHOLTZ2D_P2M_L2P = ("p2m_helmholtz2d", "l2p_helmholtz2d")
HELMHOLTZ_KERNELS = ("morton_encode", *TREE_KERNELS, *TRAVERSAL_KERNELS,
                     "p2p_helmholtz3d", "m2p_helmholtz3d", "p2l_helmholtz3d",
                     *HELMHOLTZ_P2M_L2P, *FMM_TRANSLATE)
HELMHOLTZ2D_KERNELS = ("morton_encode", *TREE_KERNELS, *TRAVERSAL_KERNELS,
                       "p2p_helmholtz2d", "m2p_helmholtz2d",
                       "p2l_helmholtz2d", *HELMHOLTZ2D_P2M_L2P,
                       *FMM_TRANSLATE)
#: K38 and K40, launched once by each 2D Laplace FMM without dipoles
LAPLACE2D_P2M_L2P = ("p2m_laplace2d", "l2p_laplace2d")
LAPLACE2D_KERNELS = ("morton_encode", *TREE_KERNELS, *TRAVERSAL_KERNELS,
                     "p2p_laplace2d", "m2p_laplace2d", "p2l_laplace2d",
                     *LAPLACE2D_P2M_L2P, *FMM_TRANSLATE)
#: the kernels each 2D double-layer FMM launches once (K36 / K37 once a
#: level)
LAPLACE2D_DIPOLE_FMM = ("p2m_laplace2d_dipole", "p2p_laplace2d_dipole",
                        "m2p_laplace2d", "p2l_laplace2d_dipole",
                        "l2p_laplace2d", "m2l_translate")
LAPLACE2D_DIPOLE_KERNELS = ("morton_encode", *TREE_KERNELS,
                            *TRAVERSAL_KERNELS, *LAPLACE2D_DIPOLE_FMM,
                            "m2m_translate", "l2l_translate")
LAPLACE3D_KERNELS = ("morton_encode", *TREE_KERNELS, *TRAVERSAL_KERNELS,
                     "p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d",
                     "p2p_laplace3d_dipole", "p2l_laplace3d_dipole",
                     *P2M_L2P_KERNELS, "p2m_laplace3d_dipole",
                     *FMM_TRANSLATE)
#: rel l-inf tolerance of K2-K4 against their twins: float32 sums in
#: another order, with rsqrt/FMA rounding (a few ulp each)
KERNEL_RTOL = 1e-5
#: rel l-inf bound of the order-8 float32 FMM against the float64 direct
#: sum: truncation is 3e-5 to 6e-5, a TF32/bf16 slip shows as ~7e-3
FMM_RTOL = 1e-3
#: rel l-inf tolerance of K9-K11 against their twins: float64, with the
#: Bessel and harmonics recurrences rounded in another order (FMA
#: contraction) and the sums taken in another order
HELMHOLTZ_KERNEL_RTOL = 1e-10
#: rel l-inf bound of the order-12 Helmholtz FMM against the complex128
#: direct sum (``tests/test_helmholtz3d.py:94-112``'s bar)
HELMHOLTZ_FMM_RTOL = 1e-5
#: rel l-inf tolerance of K31-K34 (P2M and L2P of the 3D and 2D Helmholtz
#: wranglers) against their twins, multipoles per coefficient column:
#: float64, the recurrences with FMA contraction (K31, K32) or without
#: (K33, K34, the twin's step for step), the warp sums in another order
HELMHOLTZ_P2M_L2P_RTOL = 1e-12

#: K47-K56: the float64 entry points of the ten Helmholtz particle kernels,
#: the real-pair wranglers' layout (real charges, ``[re | im]`` rows), by
#: kernel: their number and the reference's pair hook they replace
PAIR_KERNELS = {
    "p2p_helmholtz3d": ("K47", "boxtree_tpu/models/helmholtz3d.py:513"),
    "m2p_helmholtz3d": ("K48", "boxtree_tpu/models/helmholtz3d.py:478"),
    "p2l_helmholtz3d": ("K49", "boxtree_tpu/models/helmholtz3d.py:494"),
    "p2m_helmholtz3d": ("K50", "boxtree_tpu/models/helmholtz3d.py:442"),
    "l2p_helmholtz3d": ("K51", "boxtree_tpu/models/helmholtz3d.py:461"),
    "p2p_helmholtz2d": ("K52", "boxtree_tpu/models/helmholtz.py:407"),
    "m2p_helmholtz2d": ("K53", "boxtree_tpu/models/helmholtz.py:391"),
    "p2l_helmholtz2d": ("K54", "boxtree_tpu/models/helmholtz.py:400"),
    "p2m_helmholtz2d": ("K55", "boxtree_tpu/models/helmholtz.py:378"),
    "l2p_helmholtz2d": ("K56", "boxtree_tpu/models/helmholtz.py:384"),
}
#: rel l-inf tolerance of K47-K56 against their twins, per coefficient
#: column and per potential lane: the math of K9-K11, K16-K18 and K31-K34
#: on another layout, rounded as theirs (1.1e-15 to 5.9e-15 measured on
#: the card at 2e4 points, 700 W)
HELMHOLTZ_PAIR_KERNEL_RTOL = 1e-12
#: rel l-inf bound of ``pot[:, 0] + 1j pot[:, 1]`` of a pair FMM against
#: the complex wrangler's potential on the same traversal and charges
#: (``tests/test_helmholtz3d.py:170``, ``tests/test_helmholtz.py:183``)
HELMHOLTZ_PAIRS_RTOL = 1e-12
#: with real charges some coefficient lanes are zero but for rounding (the
#: real lane of the 3D m = 0 and the 2D n = 0 multipoles): a lane whose
#: largest value is below this fraction of the array's is held to the
#: array's largest value
ZERO_LANE = 1e-12

#: rel l-inf tolerance of K16-K18 against their twins: float64; K16's H_0
#: comes from CUDA's j0/y0 (a few ulp), K17/K18 repeat the twin's
#: recurrence with FMA contraction, and the sums run in another order
HELMHOLTZ2D_KERNEL_RTOL = 1e-12
#: rel l-inf bound of the order-16 2D Helmholtz FMM against the complex128
#: direct sum (``tests/test_helmholtz.py:23-46``'s bar)
HELMHOLTZ2D_FMM_RTOL = 1e-5
#: largest |torch.special's j0 + i y0 - scipy's hankel1(0)| / |hankel1(0)|
#: allowed on the direct sum's arguments before it is trusted as reference:
#: 100 times below the FMM's bar (torch.special's j0/y0 are good to ~1e-8
#: relative for k r in [1, 5], ~1e-16 below 1)
BESSEL_CHECK_RTOL = 1e-7

#: rel l-inf tolerance of K19-K21 against their twins, by entry point:
#: complex128 and float64 pairs (logs, atan2 and powers rounded in another
#: order, FMA contraction, sums in another order), float32 pairs
LAPLACE2D_KERNEL_RTOL = {"c128": 1e-12, "f64": 1e-12, "f32": 1e-5}
#: rel l-inf bound of the order-20 2D Laplace FMM's real part against the
#: float64 direct sum (``tests/test_laplace.py:23-53``'s bar)
LAPLACE2D_FMM_RTOL = 1e-5
#: largest rel l-inf of the float64 pairs potentials from the complex
#: wrangler's real part (the same math in pair lanes)
LAPLACE2D_PAIRS_RTOL = 1e-10
#: rel l-inf bound of the order-35 line (``tests/test_stability.py:58``)
LAPLACE2D_STABILITY_RTOL = 0.5 ** 36
#: rel l-inf bounds of the 2D double layer (order 20) against the float64
#: direct sum: complex128 and float64 pairs ``tests/test_laplace.py:110``'s
#: bar; the float32 pairs 4 times the largest rel l-inf (5.91e-4, rounded
#: up) that ``scripts/torch_laplace2d_dipole_accuracy.py`` gave on the CPU
#: at 3e4 sources and 6e3 targets over seeds 7, 8 and 9: near the curve
#: the kernel's 1 / r^2 magnifies the float32 rounding of ``s - t``
LAPLACE2D_DIPOLE_RTOL = {"complex128": 1e-5, "float64_pairs": 1e-5,
                         "float32_pairs": 2.4e-3}

#: rel l-inf tolerance of K2-K4's complex128 entry points, K22 and K23
#: against their twins, by entry point: complex128 and float64 (the
#: recurrences rounded in another order, FMA contraction, sums in another
#: order; K23's tangents per coefficient column), float32
LAPLACE3D_KERNEL_RTOL = {"c128": 1e-12, "f64": 1e-12, "f32": 1e-5}
#: rel l-inf bound of the order-12 3D double layer's real part (and of the
#: single layer) against the float64 direct sum
#: (``tests/test_laplace.py:113-134``'s bar)
LAPLACE3D_FMM_RTOL = 1e-5
#: rel l-inf bound of the float64 pairs with ``level_to_order = 12 -
#: min(level, 4)`` against the same direct sum: 4.5 times the 4.45e-5 that
#: ``scripts/torch_laplace3d_accuracy.py`` gives on the CPU at 3e4 sources
#: and 6e3 targets (6 levels, orders 12 down to 8; the 1e6 tree's deeper
#: levels all run at order 8 too)
LAPLACE3D_L2O_RTOL = 2e-4
#: largest rel l-inf of the float64 pairs potentials from the complex
#: wrangler's real part (``tests/test_laplace.py:227``)
LAPLACE3D_PAIRS_RTOL = 1e-12

#: rel l-inf bound of the order-10 float64 Laplace FMM on the QBX extent
#: tree against the float64 direct sum (BASELINE.md's Config D bar)
EXTENT_FMM_RTOL = 1e-5

#: published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes
#: per second, and float32 / float64 operations per second outside the
#: tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def median_ms(fn, device, reps=5):
    times = []
    for _ in range(reps):
        _, dt = timed(fn, device)
        times.append(dt * 1e3)
    return sorted(times)[len(times) // 2]


def rel_linf(got, ref):
    import torch
    if not ref.is_complex():
        got, ref = got.to(torch.float64), ref.to(torch.float64)
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-300)


def rel_linf_per_coefficient(got, ref):
    """``(max_abs_err, rel)`` of (boxes, coefficients) expansions, each
    coefficient's column held to its own largest ``|ref|``: the columns
    span many decades, so one scale for all would hide the small ones."""
    import torch
    err = (got - ref).abs()
    scale = ref.abs().amax(0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return err.max().item(), (err.amax(0) / scale).max().item()


def rel_linf_per_lane(got, ref):
    """``(max_abs_err, rel)`` of ``(n, 2)`` potentials or ``[re | im]``
    expansions, each column held to its own largest ``|ref|``, a lane below
    ``ZERO_LANE`` of the array's largest to that largest."""
    import torch
    err = (got - ref).abs()
    scale = ref.abs().amax(0)
    top = scale.max()
    scale = torch.where(scale >= ZERO_LANE * top, scale, top)
    return err.max().item(), (err.amax(0) / scale).max().item()


def rel_linf_per_row(got, ref):
    """``(max_abs_err, rel)`` of (boxes, coefficients) expansions, each
    box's row held to its own largest ``|ref|`` (a row that is zero in
    *ref* must be zero in *got*)."""
    import torch
    if not ref.is_complex():
        got, ref = got.to(torch.float64), ref.to(torch.float64)
    err = (got - ref).abs().amax(1)
    scale = ref.abs().amax(1)
    zero = scale == 0
    if bool((err[zero] > 0).any()):
        return err.max().item(), float("inf")
    rel = (err[~zero] / scale[~zero]).max().item() if bool(
        (~zero).any()) else 0.0
    return err.max().item(), rel


def bound(work):
    """``(bound_ms, bound_by)`` of a kernel's work: the larger of its
    bytes over the memory rate and its operations over the peak rate of
    their type."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_ops = work.get("flops", 0) / PEAK_FLOPS[work.get("type", "float32")]
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# The bytes a list stage must move on this run's lists: each row's and each
# listed box's data once, however many rows list the box; the particles
# and coefficients of boxes no row reaches are not counted.

def _boxes(idx):
    import torch
    return torch.unique(idx.to(torch.int64))


def p2p_bytes(tgt, src, q, tst, tcn, sst, scn, tb, st, ls, out_elem):
    """P2P: the targets of the target boxes (coordinates read, potential
    written), the particles and charges of the listed source boxes, both
    sides' ranges and the CSR."""
    tboxes, sboxes = _boxes(tb), _boxes(ls)
    nt, ns = int(tcn[tboxes].sum()), int(scn[sboxes].sum())
    return (nt * (tgt.shape[0] * tgt.element_size() + out_elem)
            + ns * (src.shape[0] * src.element_size() + q.element_size())
            + tboxes.numel() * (tst.element_size() + tcn.element_size())
            + sboxes.numel() * (sst.element_size() + scn.element_size())
            + nbytes(tb, st, ls))


def m2p_bytes(tgt, tst, tcn, rows, st, ls, mp, centers, scale, out_elem):
    """M2P: the targets of the rows' boxes (read, potential written), the
    multipole, centre and scale of each listed box, the ranges and the
    CSR."""
    tboxes, sboxes = _boxes(rows), _boxes(ls)
    nt = int(tcn[tboxes].sum())
    return (nt * (tgt.shape[0] * tgt.element_size() + out_elem)
            + tboxes.numel() * (tst.element_size() + tcn.element_size())
            + sboxes.numel() * (mp.shape[1] * mp.element_size()
                                + centers.shape[0] * centers.element_size()
                                + scale.element_size())
            + nbytes(rows, st, ls))


def p2l_bytes(src, q, sst, scn, rows, st, ls, centers, scale, row_bytes):
    """P2L: the particles and charges of the listed source boxes, the
    centre and scale of each row's box, its *row_bytes* of coefficients
    read and written (added in place), the ranges and the CSR."""
    tboxes, sboxes = _boxes(rows), _boxes(ls)
    ns = int(scn[sboxes].sum())
    return (ns * (src.shape[0] * src.element_size() + q.element_size())
            + sboxes.numel() * (sst.element_size() + scn.element_size())
            + tboxes.numel() * (centers.shape[0] * centers.element_size()
                                + scale.element_size() + 2 * row_bytes)
            + nbytes(rows, st, ls))


# {{{ K1-K4: the kernels against their twins, and their work

def kernel_inputs(tree, trav, wrangler, q_tree):
    """Each kernel's wrapper, plain twin and arguments at the shapes the
    FMM gives them."""
    import torch

    from boxtree_torch import config
    from boxtree_torch.ops import laplace3d, morton

    coords = tree.sources
    n = coords.shape[1]
    iota_bits = max(1, int(n - 1).bit_length())
    depth = max(min(config.max_morton_depth(3), (63 - iota_bits) // 3), 1)
    lo = torch.amin(coords, dim=1)
    extent = (torch.max(torch.amax(coords, dim=1) - lo)
              * (1 + config.ROOT_EXTENT_STRETCH_FACTOR))
    w = wrangler
    mpoles = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [q_tree]))
    l3_rows, l3_starts, l3_lists = w._l3_csr
    l4_rows, l4_starts, l4_lists = w._l4_csr
    return {
        "morton_encode": (
            morton.encode_points, morton.encode_points_plain,
            (coords, lo, extent, depth, iota_bits)),
        "p2p_laplace3d": (
            laplace3d.p2p_laplace3d, laplace3d.p2p_laplace3d_plain,
            (w._targets, w._sources, q_tree, tree.box_target_starts,
             tree.box_target_counts_nonchild, tree.box_source_starts,
             tree.box_source_counts_nonchild, trav.target_boxes,
             trav.neighbor_source_boxes_starts,
             trav.neighbor_source_boxes_lists)),
        "m2p_laplace3d": (
            laplace3d.m2p_laplace3d, laplace3d.m2p_laplace3d_plain,
            (w._targets, tree.box_target_starts,
             tree.box_target_counts_nonchild, l3_rows, l3_starts, l3_lists,
             mpoles, w.centers, w.box_scale, w.order)),
        "p2l_laplace3d": (
            lambda *a: laplace3d.p2l_laplace3d(
                *a, w.local_expansion_zeros()),
            lambda *a: laplace3d.p2l_laplace3d_plain(
                *a, w.local_expansion_zeros()),
            (w._sources, q_tree, tree.box_source_starts,
             tree.box_source_counts_nonchild, l4_rows, l4_starts, l4_lists,
             w.centers, w.box_scale, w.order)),
    }


def kernel_work(inputs):
    """Bytes each of K1-K4 must move (each input it needs read once, each
    output written once; K2-K4 on this run's lists, by :func:`p2p_bytes`,
    :func:`m2p_bytes` and :func:`p2l_bytes`) and the float operations it
    must do, at *inputs*.

    - K1: per point, d coordinates read and one int64 key written; 3
      operations per coordinate (subtract, divide, multiply).
    - K2: per List-1 particle pair, 10 (difference 3, squared norm 5,
      multiply-add of the charge 2; the rsqrt is not counted).
    - K3: per (target particle, List-3 source box) pair, one multiply-add
      (2) per real coefficient, 2 (order + 1)^2 of them.
    - K4: per (List-4 source particle, target box) pair, the same.
    """
    import torch

    from boxtree_torch.ops.solid_harmonics import ncoeffs
    from boxtree_torch.traversal.containers import csr_rows

    def row_of(starts, lists):
        return csr_rows(starts, lists.shape[0])

    out = {}
    coords, lo, extent, _, _ = inputs["morton_encode"][2]
    n = coords.shape[1]
    out["morton_encode"] = dict(
        points=n, bytes=nbytes(coords, lo, extent) + 8 * n,
        flops=3 * coords.numel())

    (tgt, src, q, tst, tcn, sst, scn, tb, st, ls) = \
        inputs["p2p_laplace3d"][2]
    tcn64, scn64 = tcn.to(torch.int64), scn.to(torch.int64)
    pairs = int((tcn64[tb.to(torch.int64)[row_of(st, ls)]]
                 * scn64[ls.to(torch.int64)]).sum())
    out["p2p_laplace3d"] = dict(
        particle_pairs=pairs, flops=10 * pairs,
        bytes=p2p_bytes(tgt, src, q, tst, tcn, sst, scn, tb, st, ls,
                        tgt.element_size()))

    (tgt, tst, tcn, rows, st, ls, mp, centers, scale, order) = \
        inputs["m2p_laplace3d"][2]
    k = 2 * ncoeffs(order)
    pairs = int(tcn.to(torch.int64)[rows.to(torch.int64)[
        row_of(st, ls)]].sum())
    out["m2p_laplace3d"] = dict(
        target_box_pairs=pairs, coefficients=k, flops=2 * k * pairs,
        bytes=m2p_bytes(tgt, tst, tcn, rows, st, ls, mp, centers, scale,
                        tgt.element_size()))

    (src, q, sst, scn, rows, st, ls, centers, scale, order) = \
        inputs["p2l_laplace3d"][2]
    pairs = int(scn.to(torch.int64)[ls.to(torch.int64)].sum())
    out["p2l_laplace3d"] = dict(
        source_box_pairs=pairs, coefficients=k, flops=2 * k * pairs,
        bytes=p2l_bytes(src, q, sst, scn, rows, st, ls, centers, scale,
                        k * src.element_size()))
    return out


def check_kernels(inputs, device):
    """Run every kernel and its twin on the same inputs; raise on a
    mismatch.  Returns ``{name: {max_abs_err, rel_err, ms, plain_ms}}``."""
    import torch

    results = {}
    for name, (kernel, plain, args) in inputs.items():
        got, _ = timed(lambda: kernel(*args), device)
        ref, _ = timed(lambda: plain(*args), device)
        if name == "morton_encode":
            exact = torch.equal(got, ref)
            err = rel = float((got != ref).sum().item())
            if not exact:
                raise AssertionError(f"{name}: {int(err)} keys differ")
        else:
            err, rel = rel_linf(got, ref)
            if not rel <= KERNEL_RTOL:
                raise AssertionError(
                    f"{name}: rel l-inf {rel:.3e} > {KERNEL_RTOL}")
        ms = median_ms(lambda: kernel(*args), device)
        plain_ms = median_ms(lambda: plain(*args), device)
        results[name] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms)
    return results

# }}}


def direct_sum_f64(sources, charges, targets, chunk=1 << 16):
    """sum_s q_s / |t - s| over all sources, r = 0 skipped, in float64."""
    import torch
    src = sources.to(torch.float64)
    q = charges.to(torch.float64)
    tgt = targets.to(torch.float64)
    out = torch.zeros(tgt.shape[1], dtype=torch.float64, device=tgt.device)
    for c0 in range(0, src.shape[1], chunk):
        d = tgt[:, :, None] - src[:, None, c0:c0 + chunk]
        r2 = (d * d).sum(0)
        g = torch.where(r2 > 0, torch.rsqrt(torch.where(r2 > 0, r2, 1.0)),
                        0.0)
        out += g @ q[c0:c0 + chunk]
    return out


def run_main_path(device, card, trav_trees, translation, tree_trees,
                  n_kernels=200_000, n_main=1_000_000, order=8, nsample=2000):
    """The counting and the Laplace FMM at 1e6 uniform points (K1-K4),
    then K24-K27 and K43 / K44 against their twins on its tree; returns
    the K1-K4, K24-K27 and K43 / K44 summary entries."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import (
        ConstantOneExpansionWrangler,
        make_laplace_wrangler,
    )
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    # {{{ kernels vs twins on a surface tree (Lists 3 and 4 populated)

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, n_kernels))
    pts = torch.as_tensor((x / np.sqrt((x * x).sum(0))).astype(np.float32),
                          device=device)
    q = torch.as_tensor(rng.standard_normal(n_kernels).astype(np.float32),
                        device=device)
    tree = build_tree(pts, max_particles_in_box=30)
    trav = build_traversal(tree)
    wr = make_laplace_wrangler(trav, order=order, pairs=True,
                               rscale="auto", dtype=torch.float32)
    res = check_kernels(kernel_inputs(tree, trav, wr, wr.reorder_sources(q)),
                        device)
    emit({"phase": "kernels", "card": card, "points": n_kernels,
          "distribution": "sphere surface", "order": order,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "tolerance": {"morton_encode": "bit-exact",
                        "others_rel_linf": KERNEL_RTOL},
          "kernels": res})
    del tree, trav, wr

    # }}}

    # {{{ counting FMM at the main-path size (bench.py:106-107)

    rng = np.random.default_rng(17)
    pts_np = rng.random((3, n_main), dtype=np.float32)
    q_np = rng.standard_normal(n_main).astype(np.float32)
    pts = torch.as_tensor(pts_np, device=device)
    q = torch.as_tensor(q_np, device=device)

    tree, t_tree = timed(lambda: build_tree(pts, max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    w1 = ConstantOneExpansionWrangler(None, trav)
    pot, t_fmm = timed(lambda: drive_fmm(
        w1, [torch.ones(n_main, dtype=torch.float64, device=device)]),
        device)
    nbad = int((pot != n_main).sum())
    emit({"phase": "counting_fmm", "card": card, "points": n_main,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "build_s": t_tree, "traversal_s": t_trav, "fmm_s": t_fmm,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "exact": nbad == 0})
    if nbad:
        raise AssertionError(f"counting FMM: {nbad} potentials != {n_main}")
    del tree, trav, w1, pot

    # }}}

    # {{{ the main path: Laplace FMM at 1e6, every kernel counted

    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(pts, max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    wr, t_setup, table_launches = laplace_setup(
        lambda: make_laplace_wrangler(trav, order=order, pairs=True,
                                      rscale="auto", dtype=torch.float32),
        device)
    pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    stages = {}
    _, t_fmm_warm = timed(lambda: drive_fmm(wr, [q], timing_data=stages),
                          device)
    build_reads = build_host_reads(
        lambda: build_tree(pts, max_particles_in_box=30), tree, launches)

    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n_main, nsample, replace=False), device=device)
    ref = direct_sum_f64(pts, q, pts[:, sample])
    abs_err, rel = rel_linf(pot[sample], ref)
    finite = bool(torch.isfinite(pot).all())
    emit({"phase": "laplace_fmm", "card": card, "points": n_main,
          "order": order, "dtype": "float32", "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "build_s": t_tree,
          "traversal_s": t_trav, "wrangler_setup_s": t_setup,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "fmm_s": t_fmm, "fmm_warm_s": t_fmm_warm, "total_s": t_total,
          "stage_s": stages, **build_reads,
          "host_reads_per_fmm": fmm_host_reads(wr, q),
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "sampled_targets": nsample, "rel_linf_vs_f64_direct": rel,
          "abs_linf": abs_err, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    if not finite or tuple(pot.shape) != (n_main,):
        raise AssertionError("Laplace FMM: non-finite or misshapen output")
    if not rel <= FMM_RTOL:
        raise AssertionError(f"Laplace FMM: rel l-inf {rel:.3e} > "
                             f"{FMM_RTOL}")

    emit({"phase": "launches", "path": "laplace_fmm", "card": card,
          "launches": launches})
    missing = [k for k in MAIN_PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    check_p2m_l2p_launches(launches, "main path", 1)

    # }}}

    # the kernels against their twins at the main path's own shapes
    inputs = kernel_inputs(tree, trav, wr, wr.reorder_sources(q))
    res = check_kernels(inputs, device)
    work = kernel_work(inputs)
    emit({"phase": "kernels_main_path", "card": card, "points": n_main,
          "kernels": res, "work": work})
    pres, pwork = check_p2m_l2p(card, device, "main path", [
        ("f32", wr, wr.reorder_sources(q), P2M_L2P_KERNELS)])
    check_translation(card, device, "main path", [("f32", wr, q)],
                      translation)
    check_m2l_table(card, device, "main path", "f32", wr, t_setup,
                    table_launches)
    run_rotation(device, card, "main path", [
        ("f32", wr, dict(pairs=True, rscale="auto", dtype=torch.float32), q,
         sample, ref, FMM_RTOL)])
    tres, twork = check_traversal_kernels(tree, device, card, "main path",
                                          trav_trees)
    kres, kwork = check_tree_kernels(card, device, "main path", pts,
                                     dict(max_particles_in_box=30),
                                     tree_trees)
    dist_entries = run_distributed(device, card, trav, wr, pts, q, sample,
                                   ref, stages, order)
    dist_entries += run_sharded_build(device, card, pts)
    return dist_entries + [summary_entry(name, launches[name], r, work[name])
            for name, r in res.items()] + [
        summary_entry(name, launches[name], pres["f32"][name],
                      pwork["f32"][name]) for name in P2M_L2P_KERNELS] + [
        summary_entry(name, launches[name], tres[name], twork[name])
        for name in TRAVERSAL_KERNELS] + [
        summary_entry(name, launches[name], kres[name], kwork[name])
        for name in TREE_KERNELS]


# {{{ the distributed FMM (K80-K82)

#: K80-K82, the row moves of the distributed FMM (``csrc/exchange.cu``)
EXCHANGE_KERNELS = ("pack_rows", "unpack_rows", "masked_merge")
#: rel l-inf bound of the distributed float32 FMM against the single-device
#: FMM on the same traversal, every target: the partial multipoles of the
#: ranks are summed in another order (set before the first chip run)
DFMM_VS_FMM_RTOL = 1e-5
#: the runs of the ``distributed_fmm`` phase: (label, ranks, exchange)
DFMM_RUNS = (("hypercube_4", 4, "hypercube"), ("allreduce_4", 4, "allreduce"),
             ("hypercube_3", 3, "hypercube"))


def exchange_kernel(device, fn, plain, library, args, work, inplace):
    """One of K80-K82 against its twin at the path's inputs: equal exactly
    (they move and add values), timed beside the twin and the library
    yardstick; *inplace* names the argument the call updates (a fresh
    copy for each comparison)."""
    import torch

    def call(f):
        a = list(args)
        if inplace is not None:
            a[inplace] = a[inplace].clone()
        return f(*a)

    got, ref = call(fn), call(plain)
    sync(device)
    if not torch.equal(got, ref):
        raise AssertionError(f"{fn.__name__}: kernel != twin")
    scratch = list(args)
    if inplace is not None:
        scratch[inplace] = scratch[inplace].clone()
    bound_ms, bound_by = bound(work)
    return {"max_abs_err": 0.0,
            "ms": median_ms(lambda: fn(*scratch), device),
            "plain_ms": median_ms(lambda: plain(*scratch), device),
            "library_ms": median_ms(lambda: library(*scratch), device),
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work}


def check_exchange_kernels(card, device, runner, q):
    """K80-K82 at the main path's distributed shapes: the weights' mask of
    rank 0 (1e6 sources), its multipoles (nboxes x K) packed and unpacked
    at the largest hypercube stage's table, the potentials' merge (1e6
    targets) and the allreduce's dense sum."""
    import torch

    from boxtree_torch.ops import exchange

    w, v = runner.wranglers[0], runner.rank_traversals[0]
    resp, bos = runner._resp[0], runner._box_of_source[0]
    q_tree = w.reorder_sources(q)
    mine = exchange.masked_merge(torch.zeros_like(q_tree), q_tree, resp, bos)
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                            [mine]))
    perm, send_idx, recv_idx, _ = max(
        runner._stages, key=lambda st: st[1][st[0][0][0]].shape[0])
    src, dst = perm[0]
    sidx, ridx = send_idx[src], recv_idx[dst]
    nvalid = int((sidx >= 0).sum())
    row = mp.shape[1] * mp.element_size()
    idx_bytes = sidx.numel() * 4
    send = exchange.pack_rows(mp, sidx)
    valid = ridx[ridx >= 0].to(torch.int64)
    recv_valid = send[:nvalid]
    pot = torch.zeros(w.tree.ntargets, dtype=w.dtype, device=device)
    x = torch.randn(pot.shape, generator=torch.Generator(device=device)
                    .manual_seed(3), device=device, dtype=w.dtype)
    keep_t, pmap = runner._resp_out[0], runner._pot_box_map
    pmap64, bos64 = pmap.to(torch.int64), bos.to(torch.int64)

    def merge_bytes(x, keep, box_map):
        """K82's bytes: the map and the keep flags read, and of the rows
        kept (this run's count) x read and out read and written; a row
        not kept is skipped before x or out is touched."""
        kept = int(keep[box_map.to(torch.int64)].sum())
        return (nbytes(box_map) + keep.numel() * keep.element_size()
                + 3 * kept * (nbytes(x) // x.shape[0]))
    res = {
        "pack_rows": exchange_kernel(
            device, exchange.pack_rows, exchange.pack_rows_plain,
            lambda m, i: m.index_select(0, valid), (mp, sidx),
            {"bytes": idx_bytes + nvalid * row + sidx.numel() * row},
            None),
        "unpack_rows_add": exchange_kernel(
            device, exchange.unpack_rows, exchange.unpack_rows_plain,
            lambda m, i, r, op: m.index_add_(0, valid, recv_valid),
            (mp, ridx, send, "add"),
            {"bytes": idx_bytes + nvalid * row * 3}, 0),
        "unpack_rows_set": exchange_kernel(
            device, exchange.unpack_rows, exchange.unpack_rows_plain,
            lambda m, i, r, op: m.index_copy_(0, valid, recv_valid),
            (mp, ridx, send, "set"),
            {"bytes": idx_bytes + nvalid * row * 2}, 0),
        "masked_merge": exchange_kernel(
            device, exchange.masked_merge,
            exchange.masked_merge_plain,
            lambda o, xx, k, m: o.add_(torch.where(k[pmap64], xx, 0)),
            (pot, x, keep_t, pmap),
            {"bytes": merge_bytes(x, keep_t, pmap)},
            0),
        "masked_merge_weights": exchange_kernel(
            device, exchange.masked_merge,
            exchange.masked_merge_plain,
            lambda o, xx, k, m: o.add_(torch.where(k[bos64], xx, 0)),
            (torch.zeros_like(q_tree), q_tree, resp, bos),
            {"bytes": merge_bytes(q_tree, resp, bos)}, 0),
        "masked_merge_dense": exchange_kernel(
            device, exchange.masked_merge,
            exchange.masked_merge_plain, lambda o, xx: o.add_(xx),
            (torch.zeros_like(mp), mp), {"bytes": 3 * nbytes(mp)}, 0),
    }
    shapes = {"multipoles": list(mp.shape), "dtype": str(mp.dtype),
              "stage_rows": sidx.numel(), "stage_rows_valid": nvalid,
              "targets": w.tree.ntargets, "sources": w.tree.nsources}
    emit({"phase": "kernels_distributed", "card": card, "shapes": shapes,
          "tolerance": "bit-exact", "kernels": res})
    return res


def run_distributed(device, card, trav, wr, pts, q, sample, ref, stages,
                    order):
    """The distributed FMM on the main path's traversal (f32 pairs, order
    8): 4 ranks hypercube, 4 allreduce and 3 hypercube, all on the card,
    against the single-device FMM on the same traversal (every target) and
    the f64 direct sum; the counting runner exact at 3 and 4 ranks; K80-K82
    launched on the path and held to their twins (``kernels_distributed``).
    Returns the K80-K82 summary entries."""
    import torch

    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_laplace_wrangler
    from boxtree_torch.ops import kernels
    from boxtree_torch.parallel import DistributedFMMRunner

    t_phase = time.perf_counter()

    def factory(t):
        return make_laplace_wrangler(t, order=order, pairs=True,
                                     rscale="auto", dtype=torch.float32)

    single, fmm_s = timed(lambda: drive_fmm(wr, [q]), device)
    global_l2 = int(trav.from_sep_siblings_lists.shape[0])
    kept, launches_4 = None, None
    for label, nranks, how in DFMM_RUNS:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        runner, setup_s = timed(lambda: DistributedFMMRunner(
            nranks, trav, wrangler_factory=factory,
            communicate_mpoles=how), device)
        kernels.reset_launch_counts()
        pot, dfmm_s = timed(lambda: runner.drive_dfmm(q), device)
        launches = kernels.launch_counts()
        _, dfmm_warm_s = timed(lambda: runner.drive_dfmm(q), device)
        # what the ranks run twice over: P2M over every source row (the
        # weights masked), M2M over the whole tree, L2P over every target
        # row; rank 0's stages timed alone, on zeros
        w0, v0 = runner.wranglers[0], runner.rank_traversals[0]
        zq = torch.zeros(trav.tree.nsources, dtype=torch.float32,
                         device=device)
        zl = w0.local_expansion_zeros()
        rank0_s = {
            "form_multipoles": timed(lambda: w0.form_multipoles(
                None, None, [zq]), device)[1],
            "coarsen_multipoles": timed(lambda: w0.coarsen_multipoles(
                None, None, zl), device)[1],
            "refine_locals": timed(lambda: w0.refine_locals(
                None, v0.target_or_target_parent_boxes, zl), device)[1],
            "eval_locals": timed(lambda: w0.eval_locals(None, None, zl),
                                 device)[1]}
        del zl
        row_bytes = w0.ncoeff * 4
        if runner._stages:
            exchange_bytes = sum(len(perm) * send[0].numel() * row_bytes
                                 for perm, send, _, _ in runner._stages)
        else:
            exchange_bytes = nranks * trav.tree.nboxes * row_bytes
        _, rel_fmm = rel_linf(pot, single)
        abs_err, rel_direct = rel_linf(pot[sample], ref)
        finite = bool(torch.isfinite(pot).all())
        emit({"phase": "distributed_fmm", "card": card, "run": label,
              "ranks": nranks, "communicate_mpoles": how,
              "placement": runner.placement, "points": trav.tree.nsources,
              "order": order, "dtype": "float32", "setup_s": setup_s,
              "dfmm_s": dfmm_s, "dfmm_warm_s": dfmm_warm_s, "fmm_s": fmm_s,
              "single_stage_s": stages, "rank0_stage_s": rank0_s,
              "list2_pairs": runner.list2_pairs,
              "list2_pairs_global": global_l2,
              "mpole_comm_stats": runner.mpole_comm_stats,
              "mpole_rows_sent": runner.mpole_rows_sent,
              "exchange_bytes": exchange_bytes,
              "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                              if device.type == "cuda" else None),
              "rel_linf_vs_fmm": rel_fmm, "rel_linf_vs_f64_direct":
              rel_direct, "abs_linf": abs_err, "finite": finite,
              "launches": {k: launches[k] for k in (
                  *EXCHANGE_KERNELS, "p2m_laplace3d", "m2m_translate",
                  "p2p_laplace3d", "m2l_translate", "m2p_laplace3d",
                  "p2l_laplace3d", "l2l_translate", "l2p_laplace3d")}})
        if not finite or tuple(pot.shape) != tuple(single.shape):
            raise AssertionError(f"distributed FMM {label}: non-finite or "
                                 "misshapen output")
        if not rel_fmm <= DFMM_VS_FMM_RTOL:
            raise AssertionError(f"distributed FMM {label}: rel l-inf "
                                 f"{rel_fmm:.3e} vs the FMM > "
                                 f"{DFMM_VS_FMM_RTOL}")
        if not rel_direct <= FMM_RTOL:
            raise AssertionError(f"distributed FMM {label}: rel l-inf "
                                 f"{rel_direct:.3e} vs the direct sum > "
                                 f"{FMM_RTOL}")
        if not max(runner.list2_pairs) < global_l2:
            raise AssertionError(f"distributed FMM {label}: a rank's List 2 "
                                 f"{runner.list2_pairs} is not below the "
                                 f"traversal's {global_l2}")
        want = EXCHANGE_KERNELS if how == "hypercube" else ("masked_merge",)
        missing = [k for k in want if launches[k] <= 0]
        if missing or launches["m2l_translate"] != nranks:
            raise AssertionError(f"distributed FMM {label}: kernels not "
                                 f"launched: {missing}, K35 "
                                 f"{launches['m2l_translate']}")
        if label == "hypercube_4":
            kept, launches_4 = runner, launches
        else:
            del runner
        del pot

    counting = {}
    for nranks, how in ((3, "hypercube"), (4, "hypercube"),
                        (4, "allreduce")):
        n = trav.tree.nsources
        runner, setup_s = timed(lambda: DistributedFMMRunner(
            nranks, trav, communicate_mpoles=how), device)
        pot, dfmm_s = timed(lambda: runner.drive_dfmm(
            torch.ones(n, dtype=torch.float64, device=device)), device)
        nbad = int((pot != n).sum())
        counting[f"{how}_{nranks}"] = {"setup_s": setup_s, "dfmm_s": dfmm_s,
                                       "exact": nbad == 0}
        if nbad:
            raise AssertionError(f"distributed counting FMM ({nranks} "
                                 f"ranks, {how}): {nbad} potentials != {n}")
        del runner, pot
    emit({"phase": "distributed_counting", "card": card, "runs": counting})

    res = check_exchange_kernels(card, device, kept, q)
    emit({"phase": "distributed_done", "card": card,
          "seconds": time.perf_counter() - t_phase})
    entries = []
    for name, key, beside in (
            ("pack_rows", "pack_rows", ()),
            ("unpack_rows", "unpack_rows_add", ("unpack_rows_set",)),
            ("masked_merge", "masked_merge", ("masked_merge_weights",
                                              "masked_merge_dense"))):
        r = res[key]
        entry = summary_entry(name, launches_4[name], r, r["work"])
        entry["library_ms"] = r["library_ms"]
        for other in beside:
            entry[other] = {k: res[other][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        entries.append(entry)
    return entries

# }}}


# {{{ the sharded tree build (K83-K88)

#: K83-K88, the per-rank steps of the sharded tree build
#: (``csrc/shard.cu``)
SHARD_KERNELS = ("bucket_pack", "rebalance_place", "permute_serve",
                 "permute_unpack", "shard_leaf_levels", "shard_box_skeleton")
#: the runs of the ``sharded_build`` phase: (label, points, distribution,
#: ranks); the 1e6 uniform points are the main path's
SBUILD_RUNS = (("uniform_4", 1_000_000, "uniform", 4),
               ("uniform_8", 1_000_000, "uniform", 8),
               ("clustered_8", 1_000_000, "clustered", 8),
               ("uniform_1e7_8", 10_000_000, "uniform", 8))
#: host reads of one sharded build at one depth without a retry: the
#: sort's counts and flags, the leaf levels' counts, the permutation's
#: flags; each capacity retry of the sort or the permutation reads its
#: flags once more
SBUILD_HOST_READS = 3


def capacity_tries(factor):
    """The tries of a capacity loop that starts at 2 and doubles."""
    import math
    return int(math.log2(factor / 2.0)) + 1


def cube_cluster_points(n, seed):
    """``tests/test_shard_build.py:138-143`` at size *n*: half the points
    in the cube ``[0, 0.05]^3``, half in the unit cube, float32, the
    cluster first."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.random((3, n // 2), dtype=np.float32) * np.float32(0.05),
        rng.random((3, n - n // 2), dtype=np.float32)], axis=1)


def tree_diff(tree, ref):
    """The fields in which two trees differ (tensors compared exactly,
    dtype included)."""
    import dataclasses

    import torch
    bad = []
    for f in dataclasses.fields(ref):
        a, b = getattr(tree, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            if not (isinstance(a, torch.Tensor) and a.dtype == b.dtype
                    and torch.equal(a, b)):
                bad.append(f.name)
        elif a != b:
            bad.append(f.name)
    return bad


def capture_shard_calls(fn):
    """Run *fn* with every K83-K88 wrapper of ``ops.shard`` keeping its
    arguments (K88's rows cloned before the call, which updates them);
    returns ``{name: [(args, kwargs), ...]}`` in call order."""
    from boxtree_torch.ops import shard

    calls = {name: [] for name in SHARD_KERNELS}
    saved = {name: getattr(shard, name) for name in SHARD_KERNELS}

    def wrap(name):
        def call(*args, **kwargs):
            kept = list(args)
            if name == "shard_box_skeleton":
                kept[9] = {k: v.clone() for k, v in args[9].items()}
            calls[name].append((kept, dict(kwargs)))
            return saved[name](*args, **kwargs)
        return call
    try:
        for name in SHARD_KERNELS:
            setattr(shard, name, wrap(name))
        fn()
    finally:
        for name, f in saved.items():
            setattr(shard, name, f)
    return calls


def check_shard_kernels(card, device, calls, launches):
    """K83-K88 against their twins at the shapes of one build (rank 0's
    calls: the sort's pack, its rebalance placement, the permutation's
    serve and unpack, phase A, and phase B at its level with the most box
    starts), every output equal; each timed (median of 5) beside its twin
    (one call), its byte bound (what the call reads and writes in this
    run) and the library yardstick where one PyTorch call computes the
    same function.  Returns ``{name: result}``."""
    import torch

    from boxtree_torch.ops import shard

    def fresh(args, i):
        a = list(args)
        a[i] = {k: v.clone() for k, v in a[i].items()}
        return a

    def outs(x):
        if isinstance(x, dict):
            return list(x.values())
        return list(x) if isinstance(x, (tuple, list)) else [x]

    res, shapes = {}, {}
    for name in SHARD_KERNELS:
        if name == "shard_box_skeleton":
            rank0 = [c for c in calls[name] if c[1]["rank"] == 0]
            args, kw = max(rank0, key=lambda c: int((
                (c[0][1] >= c[1]["level"]) & (c[0][2] < c[1]["level"])
            ).sum()))
        else:
            args, kw = calls[name][0]
        kernel, plain = getattr(shard, name), getattr(shard, f"{name}_plain")
        if name == "rebalance_place":
            plain = lambda segs, per, nv, device=None: \
                shard.rebalance_place_plain(segs, per, nv)   # noqa: E731
        inplace = 9 if name == "shard_box_skeleton" else None

        def run(f):
            a = fresh(args, inplace) if inplace is not None else args
            return f(*a, **kw)
        got, want = outs(run(kernel)), outs(run(plain))
        sync(device)
        if len(got) != len(want) or not all(
                g.dtype == w.dtype and torch.equal(g, w.to(g.device))
                for g, w in zip(got, want)):
            raise AssertionError(f"{name}: kernel != twin at the sharded "
                                 "build's shapes")
        work, library = shard_work(name, args, kw, got)
        # K88 rewrites the same rows on each timed call: one copy for all
        a = fresh(args, inplace) if inplace is not None else args
        r = {"max_abs_err": 0.0,
             "ms": median_ms(lambda: kernel(*a, **kw), device),
             "plain_ms": timed(lambda: plain(*a, **kw), device)[1] * 1e3,
             "library_ms": (median_ms(library, device) if library else None),
             "launches_per_build": launches[name]}
        r["bound_ms"], r["bound_by"] = bound(work)
        r["work"] = work
        res[name] = r
        shapes[name] = {k: v for k, v in work.items() if k != "bytes"}
    emit({"phase": "kernels_sharded_build", "card": card,
          "run": "uniform_8", "tolerance": "bit-exact", "kernels": res,
          "all_to_all": all_to_all_cost(device, calls)})
    return res


def all_to_all_cost(device, calls):
    """What one ``all_to_all`` of the sort's key buffers costs with the
    ranks on one card (``nranks`` stacking copies of ``nranks`` blocks),
    median of 5, beside its bytes; a build makes two in the sort (keys,
    payload) and three in the permutation."""
    import torch

    from boxtree_torch.parallel.mesh import Mesh

    nranks, cap = calls["bucket_pack"][0][0][2].shape[0] - 1, \
        calls["bucket_pack"][0][0][3]
    mesh = Mesh([device] * nranks)
    bufs = [torch.zeros((nranks, cap), dtype=torch.int64, device=device)
            for _ in range(nranks)]
    mesh.all_to_all(bufs)
    mesh.bytes_between_ranks = 0
    mesh.all_to_all(bufs)
    moved = mesh.bytes_between_ranks
    return {"ms": median_ms(lambda: mesh.all_to_all(bufs), device),
            "bytes_between_ranks": moved,
            "bytes_copied": nranks * nbytes(bufs[0]),
            "per_build": 5}


def shard_work(name, args, kw, got):
    """The bytes one K83-K88 call moves on this run's data (each value it
    reads and writes once; a skipped pad or an unsent key not counted),
    and the library yardstick (a function, or None)."""
    import torch

    from boxtree_torch.ops import shard

    i8 = 8
    if name == "bucket_pack":
        local, vals, starts, cap = args[:4]
        nv = 0 if vals is None else vals.shape[0]
        lens = (starts[1:] - starts[:-1]).clamp(max=cap)
        sent = int(lens.sum())
        nb = starts.shape[0] - 1
        return {"sent": sent, "slots": nb * cap, "payloads": nv,
                "bytes": sent * i8 * (1 + nv) + nbytes(starts)
                + nb * cap * i8 * (1 + nv)}, None
    if name == "rebalance_place":
        segs, per, nv = args[:3]
        moved = sum(s[2] for s in segs)
        return {"segments": len(segs), "moved": moved, "per": per,
                "bytes": moved * i8 * (1 + nv) + per * i8 * (1 + nv)
                + len(segs) * (4 + nv) * i8}, None
    if name == "permute_serve":
        got_o, got_s, data, base = args[:4]
        valid = got_o != shard.PAD
        nvalid = int(valid.sum())
        row = data.shape[1] * data.element_size()
        loc = (got_o[valid] - base).contiguous()
        # every request's location and reply row; the slot, the data row
        # and the inverse entry of the valid ones only
        return {"requests": got_o.numel(), "valid": nvalid,
                "bytes": nbytes(got_o) + nvalid * (i8 + row + i8)
                + got_o.numel() * row}, lambda: data.index_select(0, loc)
    if name == "permute_unpack":
        reply, starts, j_sorted = args[:3]
        per, k = j_sorted.shape[0], reply.shape[2]
        row = k * reply.element_size()
        rows_t = torch.empty((per, k), dtype=reply.dtype,
                             device=reply.device)
        out = torch.empty_like(rows_t)
        return {"per": per, "k": k,
                "bytes": per * (2 * row + i8) + nbytes(starts)}, \
            lambda: out.index_copy_(0, j_sorted, rows_t)
    if name == "shard_leaf_levels":
        codes, cumw, summ = args[:3]
        per = codes.shape[0]
        return {"per": per, "bytes": per * (i8 + 4) + nbytes(summ)
                + (nbytes(cumw) if cumw is not None else 0)
                + nbytes(got[1])}, None
    codes, leaf, thr, cs, ca, prev_cs, summ, prev_summ = args[:8]
    level = kw["level"]
    per = codes.shape[0]
    active = leaf >= level
    nactive = int(active.sum())
    nstarts = int((active & (thr < level)).sum())
    # leaf of every particle, thr of the active ones; at a box start its
    # code, cs, two ca (and below the root prev_cs) read, and its row
    # written: id, prefix, start, cumulative count (int64), level (int32),
    # and below the root its parent and the child link in its parent's row
    up = level > 0
    reads = per * 4 + nactive * 4 + nstarts * (4 + up) * i8
    writes = nstarts * (4 * i8 + 4 + 2 * up * i8)
    return {"per": per, "level": level, "active": nactive,
            "boxes": nstarts,
            "bytes": reads + writes + nbytes(summ)
            + (nbytes(prev_summ) if up else 0)}, None


def run_sharded_build(device, card, pts_main):
    """``boxtree_torch.parallel.shard_build.sharded_build_tree`` on the
    card, ranks on the card: 1e6 uniform points (the main path's) at 4 and
    8 ranks, 1e6 clustered points at 8 and 1e7 uniform at 8.  Each tree
    equals ``build_tree``'s field for field (centres bit for bit); each
    line gives ``sbuild_s`` beside ``build_s`` (medians of 3 warm builds),
    the split of one more build, the capacity factors and radius, the host
    reads (held to 3, and 1 more a capacity retry) and launches of one
    build, the bytes between ranks,
    the peak memory and ``nboxes``; the counting FMM on the 4-rank tree is
    exact; K83-K88 against their twins at the 1e6 8-rank shapes
    (``kernels_sharded_build``).  Returns the K83-K88 summary entries."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import ConstantOneExpansionWrangler
    from boxtree_torch.ops import kernels
    from boxtree_torch.parallel.mesh import Mesh
    from boxtree_torch.parallel.shard_build import sharded_build_tree
    from boxtree_torch.traversal import build_traversal

    t_phase = time.perf_counter()
    launches_8 = checked = None
    for label, n, dist, nranks in SBUILD_RUNS:
        if dist == "clustered":
            pts = torch.as_tensor(cube_cluster_points(n, 19), device=device)
        elif n == pts_main.shape[1]:
            pts = pts_main
        else:
            pts = torch.as_tensor(np.random.default_rng(23).random(
                (3, n), dtype=np.float32), device=device)
        mesh = Mesh([device] * nranks)

        def sbuild(**kw):
            return sharded_build_tree(pts, mesh, max_particles_in_box=30,
                                      **kw)

        def build():
            return build_tree(pts, max_particles_in_box=30)
        ref = build()
        torch.cuda.reset_peak_memory_stats(device)
        mem0 = torch.cuda.memory_allocated(device)
        kernels.reset_launch_counts()
        mesh.bytes_between_ranks = 0
        tree = sbuild()
        sync(device)
        launches = kernels.launch_counts()
        bytes_between = mesh.bytes_between_ranks
        peak_gb = (torch.cuda.max_memory_allocated(device) - mem0) / 2**30
        bad = tree_diff(tree, ref)
        reads = read_count(sbuild)
        calls = op_count(sbuild)
        build_s = median_ms(build, device, reps=3) / 1e3
        sbuild_s = median_ms(sbuild, device, reps=3) / 1e3
        info = {}
        sbuild(timing_data=info)
        expect_reads = (SBUILD_HOST_READS - 2
                        + capacity_tries(info["capacity_factor"])
                        + capacity_tries(info["permute_capacity_factor"]))
        line = {"phase": "sharded_build", "card": card, "run": label,
                "points": n, "distribution": dist, "ranks": nranks,
                "placement": mesh.placement(), "nboxes": tree.nboxes,
                "nlevels": tree.nlevels, "depth": info["depth"],
                "build_s": build_s, "sbuild_s": sbuild_s,
                "split_s": info["stage_s"],
                "capacity_factor": info["capacity_factor"],
                "radius": info["radius"],
                "permute_capacity_factor": info["permute_capacity_factor"],
                "host_reads_per_build": reads,
                "host_reads_expected": expect_reads,
                "aten_calls_per_build": calls,
                "aten_calls_per_build_tree": op_count(build),
                "bytes_between_ranks": bytes_between,
                "peak_mem_gb_above_input": peak_gb,
                "launches": {k: launches[k] for k in (
                    "morton_encode", *SHARD_KERNELS, *TREE_KERNELS)},
                "equal_to_build_tree": not bad}
        if nranks == 4:
            w1 = ConstantOneExpansionWrangler(None, build_traversal(tree))
            pot = drive_fmm(w1, [torch.ones(n, dtype=torch.float64,
                                            device=device)])
            line["counting_fmm_exact"] = bool((pot == n).all())
            del w1, pot
        emit(line)
        if bad:
            raise AssertionError(f"sharded build {label}: fields differ "
                                 f"from build_tree: {bad}")
        if line.get("counting_fmm_exact") is False:
            raise AssertionError(f"sharded build {label}: counting FMM "
                                 "not exact")
        if reads != expect_reads:
            raise AssertionError(f"sharded build {label}: {reads} host "
                                 f"reads, expected {expect_reads}")
        missing = [k for k in ("morton_encode", *SHARD_KERNELS)
                   if launches[k] <= 0]
        if missing or launches["shard_box_skeleton"] != nranks * tree.nlevels \
                or launches["shard_leaf_levels"] != nranks:
            raise AssertionError(f"sharded build {label}: launches "
                                 f"{line['launches']}")
        if label == "uniform_8":
            launches_8 = launches
            checked = check_shard_kernels(
                card, device, capture_shard_calls(sbuild), launches)
        del tree, ref, pts
    emit({"phase": "sharded_build_done", "card": card,
          "seconds": time.perf_counter() - t_phase})
    entries = []
    for name in SHARD_KERNELS:
        r = checked[name]
        entry = summary_entry(name, launches_8[name], r, r["work"])
        entry["library_ms"] = r["library_ms"]
        entries.append(entry)
    return entries

# }}}


def summary_entry(name, launches, res, work):
    from boxtree_torch.ops import kernels

    bound_ms, bound_by = bound(work)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "entry_points": kernels._entry_names(name)}


def entry_point_numbers(launches, res, work):
    """One more entry point's numbers, beside a summary entry's."""
    bound_ms, bound_by = bound(work)
    return {"launches": launches, "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by}


# {{{ the traversal (K24-K27)

def plain_traversal_s(tree, device):
    """The traversal of *tree* with the plain twins of K24-K27 on the
    card (the traversal before K24-K27), one synchronised call."""
    from boxtree_torch.traversal import build_traversal
    return timed(lambda: build_traversal(tree, _plain=True), device)[1]


def traversal_work(inp, outputs):
    """Each of K24-K27's bytes on this tree: the arrays it reads, once,
    and its outputs, once (the target mask a byte a box)."""
    table = nbytes(inp.ntable)
    work = {
        "neighbor_table": table + inp.lsb[-1] + nbytes(
            inp.prefixes, inp.parents, inp.child_rows, inp.flags),
        "row_lists_sl_l2": table + nbytes(
            inp.parents, inp.prefixes, inp.child_rows, inp.totp_boxes,
            *outputs["row_lists_sl_l2"]),
        "list1": table + nbytes(
            inp.prefixes, inp.flags, inp.target_boxes, inp.part_boxes,
            inp.tgt_row_of_box, *outputs["list1"]),
    }
    if "lists_43" in outputs:
        work["lists_43"] = table + nbytes(
            inp.parents, inp.prefixes, inp.flags, inp.totp_boxes,
            *outputs["lists_43"])
    return {name: {"bytes": b} for name, b in work.items()}


def check_traversal_kernels(tree, device, card, label, trees):
    """K24-K27 against their plain twins on *tree*, bit for bit (K26 only
    where the targets have no extents), each timed beside its twin and
    its bound, and the whole traversal with the kernels and with the
    twins; emits a ``kernels_traversal`` line, keeps the results in the
    dict *trees* under *label* and returns ``(results, work)``."""
    import torch

    from boxtree_torch.ops import traversal as tops
    from boxtree_torch.traversal import build_traversal
    from boxtree_torch.traversal.build import list_inputs

    (targs, tkw), inp = list_inputs(tree)
    cases = {
        "neighbor_table": (lambda: tops.neighbor_table(*targs, **tkw),
                           lambda: tops.neighbor_table_plain(*targs, **tkw)),
        "row_lists_sl_l2": (lambda: tops.row_lists_sl_l2(inp),
                            lambda: tops.row_lists_sl_l2_plain(inp)),
        "lists_43": (lambda: tops.lists_43(inp),
                     lambda: tops.lists_43_plain(inp)),
        "list1": (lambda: tops.list1(inp), lambda: tops.list1_plain(inp)),
    }
    if inp.ext:
        del cases["lists_43"]
    res, outputs = {}, {}
    for name, (kernel, plain) in cases.items():
        got, ref = _flat(kernel()), _flat(plain())
        if len(got) != len(ref) or not all(
                g.dtype == r.dtype and g.shape == r.shape
                and torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"{name} != plain twin on the {label} "
                                 "tree")
        outputs[name] = got
        res[name] = dict(max_abs_err=0.0, ms=median_ms(kernel, device),
                         plain_ms=median_ms(plain, device))
    work = traversal_work(inp, outputs)
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bound(work[name])
    emit({"phase": "kernels_traversal", "card": card, "tree": label,
          "dimensions": tree.dimensions, "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "tolerance": "bit-exact",
          "kernels": res, "work": work,
          "entries": {name: [int(t.numel()) for t in out]
                      for name, out in outputs.items()},
          "traversal_ms": median_ms(lambda: build_traversal(tree), device,
                                    reps=3),
          "traversal_plain_ms": median_ms(
              lambda: build_traversal(tree, _plain=True), device, reps=3)})
    trees[label] = res
    return res, work

# }}}


# {{{ Config B

def sphere_points(n, seed):
    """*n* points on the unit sphere: normalised standard normals
    (``make_surface_particle_array``'s construction), float64."""
    import numpy as np
    x = np.random.default_rng(seed).standard_normal((3, n))
    norm = np.sqrt((x * x).sum(0))
    return x / np.where(norm == 0, 1, norm)


def _box_radius(tree, levels):
    return tree.root_extent / (1 << (levels.to(int) + 1))


def check_two_to_one(tree):
    """Every pair of touching leaves differs by at most one level: an
    area query with each leaf's box, radius times (1 + 1e-9), as the ball
    (``tests/test_geometry.py:162-178``).  Returns the pair count."""
    import torch

    from boxtree_torch import box_flags_enum
    from boxtree_torch.geometry import AreaQueryBuilder
    from boxtree_torch.traversal.containers import csr_rows

    leaves = torch.nonzero(tree.box_flags & box_flags_enum.IS_LEAF_BOX)[:, 0]
    lev = tree.box_levels[leaves]
    aq = AreaQueryBuilder()(tree, tree.box_centers[:, leaves],
                            _box_radius(tree, lev) * (1 + 1e-9))
    lists = aq.leaves_near_ball_lists.to(torch.int64)
    rows = csr_rows(aq.leaves_near_ball_starts, lists.shape[0])
    worst = int((lev[rows] - tree.box_levels[lists]).abs().max())
    if worst > 1:
        raise AssertionError(f"2:1 violated: touching leaves {worst} "
                             f"levels apart")
    return int(lists.shape[0]), worst


def brute_force_keys(tree, centers, radii, balls, chunk=64):
    """Sorted ``(ball << 32) | leaf`` keys of the sampled *balls*, from
    every leaf, in float64."""
    import torch

    from boxtree_torch import box_flags_enum

    leaves = torch.nonzero(tree.box_flags & box_flags_enum.IS_LEAF_BOX)[:, 0]
    lc = tree.box_centers[:, leaves]
    lrad = _box_radius(tree, tree.box_levels[leaves])
    keys = []
    for c0 in range(0, balls.shape[0], chunk):
        b = balls[c0:c0 + chunk]
        dist = (lc[:, None, :] - centers[:, b][:, :, None]).abs().amax(0)
        bi, li = torch.nonzero(dist <= lrad[None, :] + radii[b][:, None],
                               as_tuple=True)
        keys.append((b[bi] << 32) | leaves[li])
    return torch.sort(torch.cat(keys)).values


def check_peers_oracle(tree, pl, boxes, chunk=64):
    """Peers are adjacent and at the box's level or coarser, and every
    adjacent box at the box's level is a peer
    (``tests/test_geometry.py:142-158``), for the sampled *boxes*."""
    import torch

    rad = _box_radius(tree, tree.box_levels)
    starts = pl.peer_list_starts.to(torch.int64)
    lists = pl.peer_lists.to(torch.int64)
    levels = tree.box_levels
    for c0 in range(0, boxes.shape[0], chunk):
        b = boxes[c0:c0 + chunk]
        dist = (tree.box_centers[:, None, :]
                - tree.box_centers[:, b][:, :, None]).abs().amax(0)
        adjacent = dist <= (rad[None, :] + rad[b][:, None]) * (1 + 1e-9)
        member = torch.zeros_like(adjacent)
        for i, box in enumerate(b.tolist()):
            peers = lists[starts[box]:starts[box + 1]]
            member[i, peers] = True
            if not bool((levels[peers] <= levels[box]).all()):
                raise AssertionError(f"box {box}: a finer peer")
        if bool((member & ~adjacent).any()):
            raise AssertionError("a peer that is not adjacent")
        same = adjacent & (levels[None, :] == levels[b][:, None])
        if bool((same & ~member).any()):
            raise AssertionError("an adjacent same-level box is no peer")


def run_config_b(device, card, trav_trees, tree_trees, n=1_000_000,
                 nballs=100_000, nsample=1000, seed=15):
    """Config B on 1e6 sphere points; returns the K5-K8 and K45 / K46
    summary entries and the K1 launches of this path."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree, config
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.geometry import (
        AreaQueryBuilder,
        LeavesToBallsLookupBuilder,
        PeerListFinder,
        SpaceInvaderQueryBuilder,
    )
    from boxtree_torch.models import ConstantOneExpansionWrangler
    from boxtree_torch.ops import area_query as aq_ops, kernels, peers, restrict
    from boxtree_torch.traversal import build_traversal
    from boxtree_torch.traversal.containers import csr_rows
    from boxtree_torch.tree.build import _phase_a
    from boxtree_torch.tree.level_restrict import restrict_leaf_levels

    pts = torch.as_tensor(sphere_points(n, seed), device=device)
    rng = np.random.default_rng(seed + 1)
    anchor = torch.as_tensor(rng.choice(n, nballs, replace=False),
                             device=device)
    radii = torch.as_tensor(rng.uniform(0.005, 0.02, nballs), device=device)
    centers = pts[:, anchor] * (1 + radii)   # pushed out along the normal
    kind = "adaptive-level-restricted"

    # {{{ the path, counted

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_build = timed(lambda: build_tree(
        pts, kind=kind, max_particles_in_box=30), device)
    (pairs_2to1, worst), t_2to1 = timed(lambda: check_two_to_one(tree),
                                        device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    pot, t_fmm = timed(lambda: drive_fmm(
        ConstantOneExpansionWrangler(None, trav),
        [torch.ones(n, dtype=torch.float64, device=device)]), device)
    aq, t_aq = timed(lambda: AreaQueryBuilder()(tree, centers, radii),
                     device)
    l2b, t_l2b = timed(lambda: LeavesToBallsLookupBuilder()(
        tree, centers, radii), device)
    si, t_si = timed(lambda: SpaceInvaderQueryBuilder()(
        tree, centers, radii), device)
    pl, t_pl = timed(lambda: PeerListFinder()(tree), device)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    # }}}

    # {{{ checks

    nbad = int((pot != n).sum())
    if nbad:
        raise AssertionError(f"counting FMM: {nbad} potentials != {n}")
    build_reads = build_host_reads(lambda: build_tree(
        pts, kind=kind, max_particles_in_box=30), tree, launches,
        restricted=True)
    sample = torch.as_tensor(rng.choice(nballs, nsample, replace=False),
                             device=device).sort().values
    lists = aq.leaves_near_ball_lists.to(torch.int64)
    rows = csr_rows(aq.leaves_near_ball_starts, lists.shape[0])
    keys = (rows << 32) | lists
    in_sample = torch.isin(rows, sample)
    if not torch.equal(keys[in_sample],
                       brute_force_keys(tree, centers, radii, sample)):
        raise AssertionError("area query != float64 brute force")
    inv = torch.sort((lists << 32) | rows).values
    inv_starts = torch.searchsorted(
        inv >> 32, torch.arange(tree.nboxes + 1, device=device))
    if not (torch.equal(l2b.balls_near_box_starts.to(torch.int64),
                        inv_starts)
            and torch.equal(l2b.balls_near_box_lists.to(torch.int64),
                            inv & 0xFFFFFFFF)):
        raise AssertionError("leaves-to-balls != inverted area query")
    b_rows = csr_rows(l2b.balls_near_box_starts,
                      l2b.balls_near_box_lists.shape[0])
    b_balls = l2b.balls_near_box_lists.to(torch.int64)
    dist = (centers[:, b_balls] - tree.box_centers[:, b_rows]).abs().amax(0)
    si_ref = torch.zeros(tree.nboxes, dtype=torch.float32, device=device)
    si_ref = si_ref.scatter_reduce(0, b_rows, dist.to(torch.float32),
                                   reduce="amax")
    if not torch.equal(si.view(torch.int32), si_ref.view(torch.int32)):
        raise AssertionError("space invader != max over leaves-to-balls")
    boxes = torch.as_tensor(rng.choice(tree.nboxes, nsample, replace=False),
                            device=device)
    check_peers_oracle(tree, pl, boxes)

    emit({"phase": "config_b", "card": card, "points": n,
          "distribution": "unit sphere", "dtype": "float64",
          "max_particles_in_box": 30, "seed": seed,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "build_s": t_build, **build_reads,
          "restriction_rounds": launches["restrict_sweep"] // (
              tree.nlevels - 1), "two_to_one_s": t_2to1,
          "two_to_one_pairs": pairs_2to1, "worst_level_gap": worst,
          "traversal_s": t_trav, "counting_fmm_s": t_fmm,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "counting_fmm_exact": True, "nballs": nballs,
          "ball_leaf_pairs": int(lists.shape[0]), "area_query_s": t_aq,
          "leaves_to_balls_s": t_l2b, "space_invader_s": t_si,
          "peer_lists_s": t_pl, "peer_list_entries":
              int(pl.peer_lists.shape[0]), "total_s": t_total,
          "sampled_balls": nsample, "sampled_boxes": nsample,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    emit({"phase": "launches", "path": "config_b", "card": card,
          "launches": launches})
    missing = [k for k in CONFIG_B_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on Config B's path: "
                             f"{missing}")

    # }}}

    # {{{ K5-K8 against their twins at these shapes

    iota_bits = max(1, int(n - 1).bit_length())
    depth = max(min(config.max_morton_depth(3), (63 - iota_bits) // 3), 1)
    codes_s, _, leaf0, counts0, n_unfit, _, _ = _phase_a(
        pts, 30, dimensions=3, depth=depth)
    if n_unfit:
        raise AssertionError("Config B needs the full Morton depth")
    max_level = int(torch.nonzero(counts0)[-1, 0])
    res, work = {}, {}

    lev_k, cnt_k, rounds = restrict_leaf_levels(
        codes_s, leaf0, dimensions=3, depth=depth, max_level=max_level)
    lev_p, cnt_p, rounds_p = restrict_leaf_levels(
        codes_s, leaf0, dimensions=3, depth=depth, max_level=max_level,
        plain=True)
    if not (torch.equal(lev_k, lev_p) and torch.equal(cnt_k, cnt_p)
            and rounds == rounds_p):
        raise AssertionError("restriction with K5 != plain twin")

    def demand_round(fn):
        lev = leaf0
        for m in range(max_level, 1, -1):
            lev = fn(codes_s, lev, m=m, dimensions=3, depth=depth)
        return lev

    k_lev = demand_round(restrict.demand_pass)
    p_lev = demand_round(restrict.demand_pass_plain)
    res["restrict_demand"] = dict(
        max_abs_err=float((k_lev != p_lev).sum()),
        ms=median_ms(lambda: demand_round(restrict.demand_pass), device),
        plain_ms=median_ms(lambda: demand_round(restrict.demand_pass_plain),
                           device))
    if res["restrict_demand"]["max_abs_err"]:
        raise AssertionError("K5 demand pass != plain twin")
    nlev_demand = max_level - 1
    work["restrict_demand"] = dict(
        levels=nlev_demand, rounds=rounds,
        bytes=nlev_demand * (nbytes(codes_s, leaf0) + nbytes(leaf0)))

    def compare(name, kernel, plain, equal, work_of):
        got, ref = kernel(), plain()
        if not equal(got, ref):
            raise AssertionError(f"{name} != plain twin")
        res[name] = dict(max_abs_err=0.0, ms=median_ms(kernel, device),
                         plain_ms=median_ms(plain, device))
        work[name] = work_of(got)

    profile = sweep_profile(tree, centers, radii)
    tree_bytes = nbytes(tree.box_child_ids, tree.box_centers,
                        tree.box_levels, tree.box_flags)
    ball_bytes = nbytes(centers, radii)
    ops_per_pair = (4 * 3 + 2) * (1 << 3)   # per frontier pair, 8 children
    compare("area_query_sweep",
            lambda: aq_ops.ball_leaf_keys(tree, centers, radii),
            lambda: aq_ops.ball_leaf_keys(tree, centers, radii, plain=True),
            torch.equal,
            lambda keys: dict(
                type="float64", frontier_pairs=profile["pairs"],
                hits=profile["hits"], levels=profile["levels"],
                flops=ops_per_pair * profile["pairs"],
                bytes=tree_bytes + ball_bytes + 8 * profile["pairs"]
                + 8 * profile["hits"] + 8 * profile["next"]))
    compare("space_invader_sweep",
            lambda: aq_ops.space_invader(tree, centers, radii),
            lambda: aq_ops.space_invader_plain(tree, centers, radii),
            lambda a, b: torch.equal(a.view(torch.int32),
                                     b.view(torch.int32)),
            lambda out: dict(
                type="float64", frontier_pairs=profile["pairs"],
                flops=ops_per_pair * profile["pairs"],
                bytes=tree_bytes + ball_bytes + 8 * profile["pairs"]
                + 8 * profile["next"] + nbytes(out)))
    lsb = tree.level_start_box_nrs
    compare("peer_lists",
            lambda: peers.peer_lists(tree.box_morton_prefixes,
                                     tree.box_flags, dimensions=3, lsb=lsb),
            lambda: peers.peer_lists_plain(tree.box_morton_prefixes,
                                           tree.box_flags, dimensions=3,
                                           lsb=lsb),
            lambda a, b: torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            lambda out: dict(
                boxes=tree.nboxes, entries=int(out[1].shape[0]),
                bytes=nbytes(tree.box_morton_prefixes, tree.box_flags,
                             *out)))
    emit({"phase": "kernels_config_b", "card": card, "points": n,
          "restriction_rounds": rounds, "tolerance": "exact",
          "kernels": res, "work": work})
    check_traversal_kernels(tree, device, card, "Config B", trav_trees)
    kres, kwork = check_tree_kernels(
        card, device, "Config B", pts,
        dict(kind=kind, max_particles_in_box=30), tree_trees)

    # }}}

    return ([summary_entry(name, launches[name], res[name], work[name])
             for name in ("restrict_demand", "area_query_sweep",
                          "space_invader_sweep", "peer_lists")] + [
        summary_entry(name, launches[name], kres[name], kwork[name])
        for name in RESTRICT_KERNELS], launches)


def sweep_profile(tree, centers, radii):
    """Frontier pairs, hits and next pairs of the area-query sweep over
    all levels (the data-dependent work of K6 and K7)."""
    import torch

    from boxtree_torch.ops.area_query import expand_frontier_plain

    dev = centers.device
    nballs = centers.shape[1]
    ball_idx = torch.arange(nballs, dtype=torch.int32, device=dev)
    box_idx = torch.zeros(nballs, dtype=torch.int32, device=dev)
    out = dict(pairs=0, hits=0, next=0, levels=0)
    while ball_idx.shape[0]:
        out["pairs"] += int(ball_idx.shape[0])
        out["levels"] += 1
        hits, ball_idx, box_idx = expand_frontier_plain(
            ball_idx, box_idx, centers, radii, tree)
        out["hits"] += int(hits.shape[0])
        out["next"] += int(ball_idx.shape[0])
    return out

# }}}


# {{{ the Helmholtz FMM (K9-K11)

def helmholtz_inputs(trav, wrangler, q_tree):
    """K9-K11's wrappers, plain twins and arguments at the shapes the
    Helmholtz FMM gives them."""
    from boxtree_torch.ops import helmholtz3d

    w = wrangler
    tree = trav.tree
    mpoles = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [q_tree]))
    l3_rows, l3_starts, l3_lists = w._l3_csr
    l4_rows, l4_starts, l4_lists = w._l4_csr
    return {
        "p2p_helmholtz3d": (
            helmholtz3d.p2p_helmholtz3d, helmholtz3d.p2p_helmholtz3d_plain,
            (w._targets, w._sources, q_tree, tree.box_target_starts,
             tree.box_target_counts_nonchild, tree.box_source_starts,
             tree.box_source_counts_nonchild, trav.target_boxes,
             trav.neighbor_source_boxes_starts,
             trav.neighbor_source_boxes_lists, w.k)),
        "m2p_helmholtz3d": (
            helmholtz3d.m2p_helmholtz3d, helmholtz3d.m2p_helmholtz3d_plain,
            (w._targets, tree.box_target_starts,
             tree.box_target_counts_nonchild, l3_rows, l3_starts, l3_lists,
             mpoles, w.centers, w.box_scale, w.k, w.order)),
        "p2l_helmholtz3d": (
            lambda *a: helmholtz3d.p2l_helmholtz3d(
                *a, w.local_expansion_zeros()),
            lambda *a: helmholtz3d.p2l_helmholtz3d_plain(
                *a, w.local_expansion_zeros()),
            (w._sources, q_tree, tree.box_source_starts,
             tree.box_source_counts_nonchild, l4_rows, l4_starts, l4_lists,
             w.centers, w.box_scale, w._w_nm, w.k, w.order)),
    }


def helmholtz_work(inputs):
    """Bytes K9-K11 must move (each input they need read once, each output
    written once, on this run's lists: :func:`p2p_bytes` and its kin) and
    the float64 operations they must do, at *inputs*.

    - K9: per List-1 particle pair, 20 (difference 3, squared norm 5,
      complex kernel times charge and add 12; the square root, divide and
      sincos are not counted); K47, its pair entry point, 12 (the kernel
      times a real charge and added 4).
    - K10: per (target particle, List-3 source box) pair, with ``nc = (p +
      1)^2`` coefficients: 8 per coefficient (the complex multiply-add of
      multipole and harmonic into the sum over ``m``), 8 per order ``n``
      (that sum times the radial factor ``h_n s^n``, added to the
      potential), 10 per harmonic of order ``m >= 0`` (the recurrence), and
      3 per step of the Bessel recurrences (``p + 25`` down, ``p`` up,
      ``p`` scalings).
    - K11: per (List-4 source particle, target box) pair: 8 per
      coefficient (the complex multiply-add of ``q h_n s^n`` and the
      conjugate harmonic into the box's sum over sources; ``w_nm`` is
      applied once per box, after that sum), 6 per order ``n`` (``q`` times
      the radial factor; 2 for K49's real charge), and the same
      recurrences; then 6 per coefficient of each target box (the ``w_nm``
      product; 2 for K49's ``i w_c``).

    Charges are 16 bytes (complex128) or 8 (K47-K49's real ones); a
    potential is 16 bytes and a coefficient 16 (complex128, or a ``[re |
    im]`` pair) in both layouts.  Each of the three in *inputs* is
    counted; K11's per-box products are also given alone, as
    ``row_flops``.
    """
    import torch

    from boxtree_torch.ops.solid_harmonics import ncoeffs
    from boxtree_torch.traversal.containers import csr_rows

    def row_of(starts, lists):
        return csr_rows(starts, lists.shape[0])

    out = {}
    if "p2p_helmholtz3d" in inputs:
        (tgt, src, q, tst, tcn, sst, scn, tb, st, ls, _) = \
            inputs["p2p_helmholtz3d"][2]
        tcn64, scn64 = tcn.to(torch.int64), scn.to(torch.int64)
        pairs = int((tcn64[tb.to(torch.int64)[row_of(st, ls)]]
                     * scn64[ls.to(torch.int64)]).sum())
        out["p2p_helmholtz3d"] = dict(
            type="float64", particle_pairs=pairs,
            flops=(20 if q.is_complex() else 12) * pairs,
            bytes=p2p_bytes(tgt, src, q, tst, tcn, sst, scn, tb, st, ls, 16))

    def common(order):
        return 10 * (order + 1) * (order + 2) // 2 + 3 * (3 * order + 25)

    if "m2p_helmholtz3d" in inputs:
        (tgt, tst, tcn, rows, st, ls, mp, centers, scale, _, order) = \
            inputs["m2p_helmholtz3d"][2]
        nc = ncoeffs(order)
        pairs = int(tcn.to(torch.int64)[rows.to(torch.int64)[
            row_of(st, ls)]].sum())
        out["m2p_helmholtz3d"] = dict(
            type="float64", target_box_pairs=pairs, coefficients=nc,
            flops=(8 * nc + 8 * (order + 1) + common(order)) * pairs,
            bytes=m2p_bytes(tgt, tst, tcn, rows, st, ls, mp, centers, scale,
                            16))

    if "p2l_helmholtz3d" in inputs:
        (src, q, sst, scn, rows, st, ls, centers, scale, w_nm, _, order) = \
            inputs["p2l_helmholtz3d"][2]
        nc = ncoeffs(order)
        per_q, per_w = (6, 6) if q.is_complex() else (2, 2)
        pairs = int(scn.to(torch.int64)[ls.to(torch.int64)].sum())
        out["p2l_helmholtz3d"] = dict(
            type="float64", source_box_pairs=pairs, coefficients=nc,
            flops=((8 * nc + per_q * (order + 1) + common(order)) * pairs
                   + per_w * nc * rows.shape[0]),
            row_flops=per_w * nc * rows.shape[0],
            bytes=p2l_bytes(src, q, sst, scn, rows, st, ls, centers, scale,
                            nc * 16) + nbytes(w_nm))
    return out


def helmholtz_p2m_l2p_inputs(w, q_tree):
    """K31 and K32 (a 3D wrangler *w*) or K33 and K34 (2D): wrappers, plain
    twins and arguments at the shapes the Helmholtz FMM of *w* gives them,
    L2P at this FMM's locals."""
    from boxtree_torch.ops import helmholtz2d, helmholtz3d

    mod = helmholtz3d if w.dim == 3 else helmholtz2d
    tree = w.tree
    tail = (w.k, w.order) if w.dim == 3 else (w.k, w.order, w._nstart)
    w_nm = (w._w_nm,) if w.dim == 3 else ()
    args = {
        "p2m": (w._sources, q_tree, tree.box_source_starts,
                tree.box_source_counts_nonchild, w._source_rows, w.centers,
                w.box_scale, *w_nm, *tail),
        "l2p": (w._targets, tree.box_target_starts,
                tree.box_target_counts_nonchild, w._target_rows,
                fmm_locals(w, q_tree).contiguous(), w.centers, w.box_scale,
                *tail)}
    out = {}
    for stage, a in args.items():
        name = f"{stage}_helmholtz{w.dim}d"
        out[name] = (getattr(mod, name), getattr(mod, f"{name}_plain"), a)
    return out


def helmholtz_p2m_l2p_work(inputs):
    """Bytes K31-K34 must move and the float64 operations they must do at
    *inputs*: each particle of the rows once (coordinates and charge, or
    coordinates read and potential written), each row box's range, centre
    and scale once, L2P's local rows read once, P2M's whole multipole array
    written once (and K31's ``w_nm`` read).  Per particle:

    - 3D (``nc = (p + 1)^2``): the ``j_n`` recurrence (3 per step of ``p +
      25`` down, 1 per step of ``p`` up), the harmonics (10 per ``(n, m >=
      0)``), 10 per coefficient (K31: ``j_n`` times the conjugate harmonic
      2, times ``q`` 6, summed 2; K32: ``j_n s^-n`` times the harmonic 2,
      times the local coefficient and added 8; K50 with a real ``q`` 6) and
      K32's 1 per order (the ``s^-n`` scaling); K31 then 8 per coefficient
      of each row (``s^-n`` and ``w_nm``; K50 4, by ``i w_c``);
    - 2D (``nc = 2p + 1``, ``ns`` the even start): the offset and its
      norm 9, the J recurrence (4 per step down, 1 per product, 2 per even
      order for the Neumann sum, 1 per order ``J_n``); per order ``m``, for
      ``+m`` and for ``-m`` each, 10 (K33: ``J`` times the phase and
      ``s^-m`` 4, times ``(i/4) q`` 6; K55 with a real ``q`` 6) or 12
      (K34: 4, then the complex multiply-add 8).

    ``log``, ``sincos``, ``pow`` and ``atan2`` are not counted.  A P2M
    reads each charge's 16 bytes (complex128) or 8 (K50, K55), and K50 a
    real ``w_c`` of 8 bytes a coefficient.  The per-row products of a 3D
    P2M are also given alone, as ``row_flops``."""
    import torch

    from boxtree_torch.ops.cylinder_bessel import even_start

    out = {}
    for name, (_, _, args) in inputs.items():
        pts = args[0]
        dim = pts.shape[0]
        p2m = name.startswith("p2m_")
        real_q = p2m and not args[1].is_complex()
        starts, counts, rows = args[2:5] if p2m else args[1:4]
        centers = args[5]
        order = args[-1] if dim == 3 else args[-2]
        npart = int(counts.to(torch.int64)[rows.to(torch.int64)].sum())
        nrows = int(rows.numel())
        per_row = (starts.element_size() + counts.element_size()
                   + dim * centers.element_size() + 8)
        per_part = dim * pts.element_size() + (8 if real_q else 16)
        if dim == 3:
            nc = (order + 1) ** 2
            flops = (3 * (order + 25) + order
                     + 10 * (order + 1) * (order + 2) // 2
                     + (6 if real_q else 10) * nc)
            row_flops = (4 if real_q else 8) * nc * nrows if p2m else 0
            flops = flops * npart + (row_flops if p2m
                                     else (order + 1) * npart)
        else:
            nc = 2 * order + 1
            row_flops = 0
            ns = even_start(args[-1], order)
            per_order = (6 if real_q else 10) if p2m else 12
            flops = (9 + 5 * ns + 2 * (ns // 2) + (order + 1)
                     + per_order * (2 * order + 1)) * npart
        if p2m:
            written = centers.shape[1] * nc * 16 + (
                nbytes(args[7]) if dim == 3 else 0)
        else:
            written = 0
            per_row += nc * 16
        out[name] = dict(
            type="float64", particles=npart, rows=nrows, coefficients=nc,
            flops=flops, row_flops=row_flops,
            bytes=npart * per_part + nrows * per_row + nbytes(rows)
            + written)
    return out


def check_p2m_l2p_helmholtz(card, device, path, w, q_tree, plain_reps=3):
    """K31 / K32 or K33 / K34 against their twins at the inputs of wrangler
    *w*'s FMM (:func:`helmholtz_p2m_l2p_inputs`); raises on a mismatch,
    emits a ``kernels_p2m_l2p_helmholtz`` line and returns ``(results,
    work)``, each result with its bound."""
    inputs = helmholtz_p2m_l2p_inputs(w, q_tree)
    work = helmholtz_p2m_l2p_work(inputs)
    res = check_list_kernels(inputs, device, plain_reps=plain_reps,
                             rtol=HELMHOLTZ_P2M_L2P_RTOL, slow_s=1.0)
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bound(work[name])
    emit({"phase": "kernels_p2m_l2p_helmholtz", "card": card, "path": path,
          "order": w.order, "k": w.k,
          "tolerance_rel_linf": HELMHOLTZ_P2M_L2P_RTOL,
          "p2m_rel": "per coefficient", "kernels": res, "work": work})
    return res, work


def check_p2m_l2p_helmholtz_launches(launches, path, names):
    """The FMM of a Helmholtz path launches its P2M and L2P kernels once."""
    got = {name: launches[name] for name in names}
    if got != dict.fromkeys(names, 1):
        raise AssertionError(f"{path}: P2M / L2P launches {got}, expected "
                             "one each")


def check_list_kernels(inputs, device, plain_reps,
                       rtol=HELMHOLTZ_KERNEL_RTOL, slow_s=None, rel_fn=None,
                       detail=None):
    """Run list kernels (K2-K4, K9-K11, K16-K23, K41, K42) or K28-K34,
    K38-K40 and their twins on the same inputs; raise on a rel l-inf above
    *rtol* (a P2L's local coefficients and a Helmholtz or 2D Laplace P2M's
    multipoles each held to their own column's scale, a 3D Laplace P2M's
    multipoles box by box to their row's; every output by *rel_fn* when it
    is given).  Returns ``{name: {max_abs_err,
    rel_err, ms, plain_ms, plain_reps}}``: the kernel's median of 5, the
    twin's median of *plain_reps*, or its first call alone when that took
    more than *slow_s* seconds; and what *detail* (``(got, ref) -> dict``)
    makes of the outputs, when given."""
    results = {}
    for name, (kernel, plain, args) in inputs.items():
        got = kernel(*args)
        ref, t_plain = timed(lambda: plain(*args), device)
        err, rel = (rel_fn if rel_fn is not None
                    else rel_linf_per_coefficient
                    if name.startswith(("p2l_", "p2m_helmholtz",
                                        "p2m_laplace2d"))
                    else rel_linf_per_row if name.startswith("p2m_")
                    else rel_linf)(got, ref)
        more = {} if detail is None else detail(got, ref)
        if not rel <= rtol:
            raise AssertionError(f"{name}: rel l-inf {rel:.3e} > {rtol} "
                                 f"{more}")
        del got, ref
        reps = 1 if slow_s is not None and t_plain > slow_s else plain_reps
        results[name] = dict(
            max_abs_err=err, rel_err=rel,
            ms=median_ms(lambda: kernel(*args), device),
            plain_ms=t_plain * 1e3 if reps == 1 else median_ms(
                lambda: plain(*args), device, reps=reps),
            plain_reps=reps, **more)
    return results


def direct_sum_helmholtz(sources, charges, targets, k, chunk=1 << 15):
    """sum_s q_s exp(ik|t - s|) / |t - s| over all sources, r = 0 skipped,
    in complex128."""
    import torch
    out = torch.zeros(targets.shape[1], dtype=torch.complex128,
                      device=targets.device)
    for c0 in range(0, sources.shape[1], chunk):
        d = targets[:, :, None] - sources[:, None, c0:c0 + chunk]
        r2 = (d * d).sum(0)
        ok = r2 > 0
        r = torch.sqrt(torch.where(ok, r2, 1.0))
        g = torch.where(ok, torch.polar(1.0 / r, k * r), 0)
        out += g @ charges[c0:c0 + chunk]
    return out


# {{{ the real-pair Helmholtz wranglers (K47-K56)

def helmholtz_pair_inputs(w, q_tree):
    """K47-K51 (a 3D pair wrangler *w*) or K52-K56 (2D): wrappers, plain
    twins and arguments at the shapes the FMM of *w* gives them, on real
    tree-order charges *q_tree* (L2P at this FMM's locals)."""
    inputs = (helmholtz_inputs if w.dim == 3 else helmholtz2d_inputs)(
        w.traversal, w, q_tree)
    inputs.update(helmholtz_p2m_l2p_inputs(w, q_tree))
    return inputs


def helmholtz_pair_work(inputs, dim):
    """The bytes and float64 operations of K47-K51 (*dim* 3) or K52-K56 at
    *inputs*: :func:`helmholtz_work` or :func:`helmholtz2d_work` and
    :func:`helmholtz_p2m_l2p_work`, which count the real charges' 8
    bytes and their cheaper products."""
    work = (helmholtz_work if dim == 3 else helmholtz2d_work)(inputs)
    work.update(helmholtz_p2m_l2p_work(
        {n: v for n, v in inputs.items() if n.startswith(("p2m_", "l2p_"))}))
    return work


def pair_entry(name, launches, res, work, small):
    """The summary entry of the float64 entry point of kernel *name*
    (K47-K56): its launches on the 1e6 pair path and its numbers against
    its twin there (*res*, *work*), with those at 1e5 points (*small*)."""
    number, replaces = PAIR_KERNELS[name]
    e = summary_entry(name, launches, res, work)
    e.update(name=f"{name}_f64", kernel=number, replaces=replaces,
             entry_points=[f"{name}_f64"], at_1e5=small)
    return e


def check_pair_kernels(card, device, dim, pts, q, k, order, launches):
    """K47-K51 (*dim* 3) or K52-K56 against their twins on the pair
    wrangler of *pts* (order *order*, wavenumber *k*, ``rscale="auto"``)
    with real user-order charges *q*, each result per coefficient column
    or potential lane; emits a ``kernels_helmholtz_pairs`` line with
    *launches*, the pair path's, and returns the results."""
    from boxtree_torch import build_tree
    from boxtree_torch.models import make_helmholtz_wrangler
    from boxtree_torch.traversal import build_traversal

    tree = build_tree(pts, max_particles_in_box=30)
    w = make_helmholtz_wrangler(build_traversal(tree), k, order,
                                rscale="auto", pairs=True)
    if w._l3_csr is None or not w._l4_csr[2].numel():
        raise AssertionError(f"Lists 3 and 4 empty at {pts.shape[1]} "
                             "points")
    inputs = helmholtz_pair_inputs(w, w.reorder_sources(q))
    work = helmholtz_pair_work(inputs, dim)
    res = check_list_kernels(inputs, device, plain_reps=3,
                             rtol=HELMHOLTZ_PAIR_KERNEL_RTOL, slow_s=1.0,
                             rel_fn=rel_linf_per_lane)
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bound(work[name])
        r["launches"] = launches[f"{name}_f64"]
    emit({"phase": "kernels_helmholtz_pairs", "card": card, "dim": dim,
          "points": pts.shape[1], "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "order": order, "k": k,
          "tolerance_rel_linf": HELMHOLTZ_PAIR_KERNEL_RTOL,
          "rel": "per coefficient column and per potential lane",
          "launches_from": f"the 1e6 pair FMM ({dim}D)",
          "kernels": {PAIR_KERNELS[n][0]: {"entry_point": f"{n}_f64", **r}
                      for n, r in res.items()},
          "work": work})
    return res


def run_helmholtz_pairs(device, card, translation, trav, pts, q, k, order,
                        direct_sum, nsample=2000):
    """The real-pair wrangler on the traversal *trav* of a complex
    Helmholtz path (its 1e6 points *pts*), real charges *q*: the complex
    wrangler's FMM on the same traversal and charges first (the
    reference), then the pair wrangler that ``pairs=None`` gives on the
    card, its setup and FMM timed, every kernel counted by entry point,
    its potentials against the complex ones at every target and against
    *direct_sum* at *nsample* targets, its host reads, its peak memory
    and the M2L tables' bytes; then K47-K56 against their twins at its
    inputs (every coefficient column and potential lane to
    ``HELMHOLTZ_PAIR_KERNEL_RTOL``; a twin that takes more than a second
    is timed once), with their bounds, and K35-K37 on the pair layout
    (``kernels_translation``).  Emits a ``helmholtz_pairs_fmm`` or
    ``helmholtz2d_pairs_fmm`` line and returns ``(launches by entry
    point, {name: numbers at the path's inputs}, {name: work})``."""
    import numpy as np
    import torch

    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_helmholtz_wrangler
    from boxtree_torch.ops import kernels

    dim = trav.tree.dimensions
    phase = "helmholtz_pairs_fmm" if dim == 3 else "helmholtz2d_pairs_fmm"
    n = pts.shape[1]
    wc = make_helmholtz_wrangler(trav, k, order, rscale="auto", pairs=False)
    ref_c = drive_fmm(wc, [q.to(torch.complex128)])
    c128_table = wc._m2l_plan.nbytes
    del wc
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    w, t_setup = timed(lambda: make_helmholtz_wrangler(
        trav, k, order, rscale="auto"), device)
    pot, t_fmm = timed(lambda: drive_fmm(w, [q]), device)
    entries = kernels.entry_launch_counts()
    launches = kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    stages = {}
    _, t_fmm_warm = timed(lambda: drive_fmm(w, [q], timing_data=stages),
                          device)
    got = torch.complex(pot[:, 0], pot[:, 1])
    _, rel_c = rel_linf(got, ref_c)
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n, nsample, replace=False), device=device)
    abs_d, rel_d = rel_linf(got[sample], direct_sum(
        pts, q.to(torch.complex128), pts[:, sample], k))
    reads = fmm_host_reads(w, q)
    if device.type == "cuda":
        reads["fmm_sync_debug"] = sync_free(lambda: drive_fmm(w, [q]))
        reads["multipole_to_local_sync_debug"] = m2l_syncs(w, q)
    finite = bool(torch.isfinite(pot).all())
    inputs = helmholtz_pair_inputs(w, w.reorder_sources(q))
    work = helmholtz_pair_work(inputs, dim)
    path = check_list_kernels(inputs, device, plain_reps=3,
                              rtol=HELMHOLTZ_PAIR_KERNEL_RTOL, slow_s=1.0,
                              rel_fn=rel_linf_per_lane)
    for name, r in path.items():
        r["bound_ms"], r["bound_by"] = bound(work[name])
    del inputs
    emit({"phase": phase, "card": card, "points": n, "k": k,
          "order": order, "rscale": "auto", "dtype": "float64 pairs",
          "wrangler": type(w).__name__, "pairs_rule": "pairs=None on CUDA",
          "nboxes": trav.tree.nboxes, "nlevels": trav.tree.nlevels,
          "coefficients": w.ncoeff, "wrangler_setup_s": t_setup,
          "fmm_s": t_fmm, "fmm_warm_s": t_fmm_warm, "stage_s": stages,
          "host_reads_per_fmm": reads, "peak_mem_gb": peak,
          "m2l_table_bytes": w._m2l_plan.nbytes,
          "m2l_table_bytes_c128": c128_table,
          "m2l_used_keys": len(w._m2l_plan.used),
          "rel_linf_vs_c128_wrangler": rel_c,
          "bar_vs_c128": HELMHOLTZ_PAIRS_RTOL,
          "sampled_targets": nsample, "rel_linf_vs_c128_direct": rel_d,
          "abs_linf": abs_d, "bar_vs_direct": HELMHOLTZ_FMM_RTOL,
          "finite": finite,
          "entry_launches": {e: c for e, c in entries.items()
                             if c and "helmholtz" in e},
          "kernels_at_path": {PAIR_KERNELS[nm][0]: r
                              for nm, r in path.items()},
          "work_at_path": work})
    if type(w).__name__ != f"Helmholtz{dim}DPairsExpansionWrangler":
        raise AssertionError(f"{phase}: pairs=None on the card gave "
                             f"{type(w).__name__}")
    if not finite or tuple(pot.shape) != (n, 2) \
            or pot.dtype != torch.float64:
        raise AssertionError(f"{phase}: non-finite or misshapen output")
    if not rel_c <= HELMHOLTZ_PAIRS_RTOL:
        raise AssertionError(f"{phase}: rel l-inf {rel_c:.3e} against the "
                             f"complex wrangler > {HELMHOLTZ_PAIRS_RTOL}")
    if not rel_d < HELMHOLTZ_FMM_RTOL:
        raise AssertionError(f"{phase}: rel l-inf {rel_d:.3e} against the "
                             f"direct sum >= {HELMHOLTZ_FMM_RTOL}")
    if device.type == "cuda" and not reads_free(reads):
        raise AssertionError(f"{phase}: host reads {reads}")
    names = [nm for nm in PAIR_KERNELS if nm.endswith(f"{dim}d")]
    bad = {e: entries[e] for nm in names for e in (f"{nm}_f64",
                                                   f"{nm}_c128")
           if (entries[e] == 0) == e.endswith("_f64")}
    once = {nm: entries[f"{nm}_f64"] for nm in names
            if nm.startswith(("p2m_", "l2p_"))}
    if device.type == "cuda" and (bad or set(once.values()) != {1} or any(
            launches[nm] <= 0 for nm in FMM_TRANSLATE)):
        raise AssertionError(f"{phase}: launches by entry point {bad}, "
                             f"P2M / L2P {once}")
    check_translation(card, device, f"helmholtz{dim}d", [("f64", w, q)],
                      translation)
    return entries, path, work


def run_helmholtz(device, card, translation, n_kernels=100_000,
                  n_main=1_000_000, k=2.0,
                  order=12, nsample=2000):
    """K9-K11 against their twins at 1e5 points, then the Helmholtz FMM at
    1e6 uniform points (K1, K9-K11, K31, K32) and K9-K11, K31 and K32
    against their twins at its shapes; returns their summary entries."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_helmholtz_wrangler
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    def complex_charges(rng, n):
        return torch.as_tensor(rng.standard_normal(n)
                               + 1j * rng.standard_normal(n), device=device)

    # {{{ kernels vs twins at 1e5 uniform points

    rng = np.random.default_rng(21)
    pts = torch.as_tensor(rng.random((3, n_kernels)), device=device)
    q = complex_charges(rng, n_kernels)
    tree = build_tree(pts, max_particles_in_box=30)
    trav = build_traversal(tree)
    wr = make_helmholtz_wrangler(trav, k, order, rscale="auto", pairs=False)
    if wr._l3_csr is None or not wr._l4_csr[2].numel():
        raise AssertionError(f"Lists 3 and 4 empty at {n_kernels} points")
    small = check_list_kernels(
        helmholtz_inputs(trav, wr, wr.reorder_sources(q)), device,
        plain_reps=5)
    emit({"phase": "kernels_helmholtz_small", "card": card,
          "points": n_kernels, "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "order": order, "k": k,
          "tolerance_rel_linf": HELMHOLTZ_KERNEL_RTOL,
          "p2l_helmholtz3d_rel": "per coefficient", "kernels": small})
    del tree, trav, wr

    # }}}

    # {{{ the path: Helmholtz FMM at 1e6, every kernel counted

    rng = np.random.default_rng(17)
    pts = torch.as_tensor(rng.random((3, n_main)), device=device)
    q = complex_charges(rng, n_main)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(pts, max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    wr, t_setup = timed(lambda: make_helmholtz_wrangler(
        trav, k, order, pairs=False, rscale="auto"), device)
    pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    stages = {}
    _, t_fmm_warm = timed(lambda: drive_fmm(wr, [q], timing_data=stages),
                          device)
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n_main, nsample, replace=False), device=device)
    ref = direct_sum_helmholtz(pts, q, pts[:, sample], k)
    abs_err, rel = rel_linf(pot[sample], ref)
    finite = bool(torch.isfinite(pot).all())
    emit({"phase": "helmholtz_fmm", "card": card, "points": n_main,
          "distribution": "uniform unit cube", "k": k, "order": order,
          "rscale": "auto", "dtype": "complex128", "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "build_s": t_tree,
          "traversal_s": t_trav, "wrangler_setup_s": t_setup,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "fmm_s": t_fmm, "fmm_warm_s": t_fmm_warm, "total_s": t_total,
          "stage_s": stages, "host_reads_per_fmm": fmm_host_reads(wr, q),
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "sampled_targets": nsample, "rel_linf_vs_c128_direct": rel,
          "abs_linf": abs_err, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    if not finite or tuple(pot.shape) != (n_main,) \
            or pot.dtype != torch.complex128:
        raise AssertionError("Helmholtz FMM: non-finite or misshapen output")
    if not rel < HELMHOLTZ_FMM_RTOL:
        raise AssertionError(f"Helmholtz FMM: rel l-inf {rel:.3e} >= "
                             f"{HELMHOLTZ_FMM_RTOL}")
    emit({"phase": "launches", "path": "helmholtz_fmm", "card": card,
          "launches": launches})
    missing = [name for name in HELMHOLTZ_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the Helmholtz path: "
                             f"{missing}")
    check_p2m_l2p_helmholtz_launches(launches, "Helmholtz FMM",
                                     HELMHOLTZ_P2M_L2P)

    # }}}

    # the kernels against their twins at the path's own shapes (the twins
    # of K10 and K11 take seconds a call here: a twin slower than a second
    # is timed once, the others by a median of 3)
    inputs = helmholtz_inputs(trav, wr, wr.reorder_sources(q))
    work = helmholtz_work(inputs)
    res = check_list_kernels(inputs, device, plain_reps=3, slow_s=1.0)
    emit({"phase": "kernels_helmholtz", "card": card, "points": n_main,
          "order": order, "k": k,
          "tolerance_rel_linf": HELMHOLTZ_KERNEL_RTOL,
          "p2l_helmholtz3d_rel": "per coefficient", "kernels": res,
          "work": work})
    pres, pwork = check_p2m_l2p_helmholtz(card, device, "helmholtz_fmm", wr,
                                          wr.reorder_sources(q))
    check_translation(card, device, "helmholtz3d", [("c128", wr, q)],
                      translation)
    res.update(pres)
    work.update(pwork)
    out = [summary_entry(name, launches[name], res[name], work[name])
           for name in res]
    del inputs, wr

    # the real-pair wrangler on the same traversal with the charges' real
    # parts, then K47-K51 against their twins on the 1e5 points above
    entries, path, pwork = run_helmholtz_pairs(
        device, card, translation, trav, pts, q.real.contiguous(), k, order,
        direct_sum_helmholtz, nsample)
    del tree, trav
    rng = np.random.default_rng(21)
    pts = torch.as_tensor(rng.random((3, n_kernels)), device=device)
    q = torch.as_tensor(rng.standard_normal(n_kernels), device=device)
    small = check_pair_kernels(card, device, 3, pts, q, k, order, entries)
    return out + [pair_entry(name, entries[f"{name}_f64"], path[name],
                             pwork[name], small[name]) for name in path]

# }}}


# {{{ the Helmholtz dipoles (K57-K62 in 3D, K63-K68 in 2D)

#: K57-K68: the dipole kernels' entry points, by kernel and layout: their
#: number and the reference's program they replace (the jax.jvp of a hook
#: in expansion_base.py; on the pair layout of the pair class's hook).  A
#: dipole FMM must launch no charge kernel of the same name less
#: ``_dipole`` (K31 / K9 / K11, K33 / K16 / K18 and their pair entry
#: points)
DIPOLE_KERNELS = {
    "p2m_helmholtz3d_dipole": {
        "c128": ("K57", "boxtree_tpu/models/expansion_base.py:664"),
        "f64": ("K60", "boxtree_tpu/models/helmholtz3d.py:442")},
    "p2p_helmholtz3d_dipole": {
        "c128": ("K58", "boxtree_tpu/models/expansion_base.py:1314"),
        "f64": ("K61", "boxtree_tpu/models/helmholtz3d.py:513")},
    "p2l_helmholtz3d_dipole": {
        "c128": ("K59", "boxtree_tpu/models/expansion_base.py:1688"),
        "f64": ("K62", "boxtree_tpu/models/helmholtz3d.py:494")},
    "p2m_helmholtz2d_dipole": {
        "c128": ("K63", "boxtree_tpu/models/expansion_base.py:664"),
        "f64": ("K66", "boxtree_tpu/models/helmholtz.py:378")},
    "p2p_helmholtz2d_dipole": {
        "c128": ("K64", "boxtree_tpu/models/expansion_base.py:1314"),
        "f64": ("K67", "boxtree_tpu/models/helmholtz.py:407")},
    "p2l_helmholtz2d_dipole": {
        "c128": ("K65", "boxtree_tpu/models/expansion_base.py:1688"),
        "f64": ("K68", "boxtree_tpu/models/helmholtz.py:400")},
}
#: rel l-inf tolerance of K57-K68 against their twins, per coefficient
#: column and potential lane: no looser than their charge kernels' (K9 /
#: K11 ``HELMHOLTZ_KERNEL_RTOL``, K31 / K33 ``HELMHOLTZ_P2M_L2P_RTOL``,
#: K16 / K18 ``HELMHOLTZ2D_KERNEL_RTOL``, K47-K56
#: ``HELMHOLTZ_PAIR_KERNEL_RTOL``)
DIPOLE_KERNEL_RTOL = {
    ("c128", "p2m_helmholtz3d_dipole"): HELMHOLTZ_P2M_L2P_RTOL,
    ("c128", "p2p_helmholtz3d_dipole"): HELMHOLTZ_KERNEL_RTOL,
    ("c128", "p2l_helmholtz3d_dipole"): HELMHOLTZ_KERNEL_RTOL,
    ("f64", "p2m_helmholtz3d_dipole"): HELMHOLTZ_PAIR_KERNEL_RTOL,
    ("f64", "p2p_helmholtz3d_dipole"): HELMHOLTZ_PAIR_KERNEL_RTOL,
    ("f64", "p2l_helmholtz3d_dipole"): HELMHOLTZ_PAIR_KERNEL_RTOL,
    ("c128", "p2m_helmholtz2d_dipole"): HELMHOLTZ_P2M_L2P_RTOL,
    ("c128", "p2p_helmholtz2d_dipole"): HELMHOLTZ2D_KERNEL_RTOL,
    ("c128", "p2l_helmholtz2d_dipole"): HELMHOLTZ2D_KERNEL_RTOL,
    ("f64", "p2m_helmholtz2d_dipole"): HELMHOLTZ_PAIR_KERNEL_RTOL,
    ("f64", "p2p_helmholtz2d_dipole"): HELMHOLTZ_PAIR_KERNEL_RTOL,
    ("f64", "p2l_helmholtz2d_dipole"): HELMHOLTZ_PAIR_KERNEL_RTOL}


def _helmholtz_ops(dim):
    from boxtree_torch.ops import helmholtz2d, helmholtz3d
    return helmholtz3d if dim == 3 else helmholtz2d


def helmholtz_dipole_inputs(w, q_tree, sources=None):
    """K57-K59 (a complex 3D wrangler *w* with dipoles), K60-K62 (3D
    pairs), K63-K65 (2D) or K66-K68 (2D pairs): wrappers, plain twins and
    arguments at the shapes the FMM of *w* gives them on tree-order
    charges *q_tree*, the tree-order sources replaced by *sources* if
    given; P2L into zero locals."""
    tree, trav = w.tree, w.traversal
    src = w._sources if sources is None else sources
    # 3D: the weights w_nm, k, order; 2D: k, order, the recurrence's start
    if w.dim == 3:
        tail, p2p_tail = (w._w_nm, w.k, w.order), (w.k,)
    else:
        tail, p2p_tail = (w.k, w.order, w._nstart), (w.k, w._nstart)
    d = w.dim
    args = {
        f"p2m_helmholtz{d}d_dipole": (
            src, q_tree, w.dipole_vec, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, w.centers,
            w.box_scale, *tail),
        f"p2p_helmholtz{d}d_dipole": (
            w._targets, src, q_tree, w.dipole_vec, tree.box_target_starts,
            tree.box_target_counts_nonchild, tree.box_source_starts,
            tree.box_source_counts_nonchild, trav.target_boxes,
            trav.neighbor_source_boxes_starts,
            trav.neighbor_source_boxes_lists, *p2p_tail),
        f"p2l_helmholtz{d}d_dipole": (
            src, q_tree, w.dipole_vec, tree.box_source_starts,
            tree.box_source_counts_nonchild, *w._l4_csr, w.centers,
            w.box_scale, *tail)}
    mod = _helmholtz_ops(d)
    out = {}
    for name, a in args.items():
        kernel = getattr(mod, name)
        plain = getattr(mod, f"{name}_plain")
        if name.startswith("p2l_"):
            out[name] = (
                lambda *x, k=kernel: k(*x, w.local_expansion_zeros()),
                lambda *x, k=plain: k(*x, w.local_expansion_zeros()), a)
        else:
            out[name] = (kernel, plain, a)
    return out


def less_dipoles(name, args):
    """The arguments of dipole kernel *name* (K57-K68) without the dipoles:
    those of the charge kernel it differentiates (K31, K9, K11, K33, K16,
    K18 or their pair entry points)."""
    i = 3 if name.startswith("p2p_") else 2
    return args[:i] + args[i + 1:]


def helmholtz2d_dipole_flops(name, w, args):
    """The float64 operations K63-K68 must do at *args*, from *w*, the
    work of their charge kernel on the same arguments less the dipoles
    (its pair and particle counts).  Square roots, ``j1``/``y1``,
    ``atan2``, ``sincos`` and ``pow`` are not counted.

    - K64 / K67, per List-1 particle pair with ``r > 0``: K16's 16 (K52's
      12), then 7 more: the projection ``k d . (t - s) / r`` 5 and the
      factor's two products with ``(i/4) H_1`` 2.
    - K63 / K66 (per particle) and K65 / K68 (per (source particle, target
      box) pair): the offset and its norm 9, the dipole's ``d / s`` times
      ``s`` 4; one recurrence to order ``p + 1`` from ``ns =
      even_start(nstart, p + 1)``: K63 ``J`` only as K33 (5 a step down, 2
      per even order, 1 per order), K65 ``J`` and ``Y`` as K18 (5 a step
      down, 7 per pair of orders, 4 per order, 10 for ``Y_0``, ``Y_1``);
      each ladder basis ``C_m = Z_|m| e^{-+i |m| th}``, ``|m| <= p + 1``,
      once: K63 the ``p + 2`` real products ``J e^{-i m th}`` 2 each (the
      ``-m`` ones by sign), K65 all ``2p + 3`` complex products 6 each;
      then per coefficient ``n = -p..p``: the tangent ``(k/2) [(d_x - i
      d_y) C_{n-1} - (d_x + i d_y) C_{n+1}]`` 16, times ``(i/4) q`` 6 (2
      for the pairs' real ``q``), times ``s^-+|n|`` 2 and summed over the
      sources 2; K65 then 2 per coefficient of each target box."""
    if name.startswith("p2p_"):
        return w["flops"] + 7 * w["particle_pairs"]
    q, order, nstart = args[1], args[-2], args[-1]
    from boxtree_torch.ops.cylinder_bessel import even_start
    ns, nc = even_start(nstart, order + 1), 2 * order + 1
    per_coeff = (26 if q.is_complex() else 22) * nc
    if name.startswith("p2m_"):
        per = (13 + 5 * ns + 2 * (ns // 2) + (order + 2)
               + 2 * (order + 2) + per_coeff)
        return per * w["particles"]
    per = (13 + 5 * ns + 7 * (ns // 2) + 4 * (order + 2) + 10
           + 6 * (2 * order + 3) + per_coeff)
    return per * w["source_box_pairs"] + w["row_flops"]


def helmholtz_dipole_work(inputs):
    """Bytes K57-K68 must move and the float64 operations they must do at
    *inputs*: the bytes of their charge kernels on the same arguments less
    the dipoles (:func:`helmholtz_work` for K58 / K59, K61 / K62,
    :func:`helmholtz2d_work` for K64 / K65, K67 / K68,
    :func:`helmholtz_p2m_l2p_work` for the P2Ms) and 8 bytes of dipole
    read a coordinate for each source (24 in 3D, 16 in 2D).  Operations:
    K57-K62, which run their charge kernels' loops on dual numbers, each
    per-pair or per-particle operation of the charge kernel twice (on a
    value and on its tangent; the per-row ``w_nm`` products and P2L sums
    once); K63-K68, which take the ladder identity, their own
    (:func:`helmholtz2d_dipole_flops`)."""
    import torch

    charge = {name.removesuffix("_dipole"): (None, None,
                                             less_dipoles(name, args))
              for name, (_, _, args) in inputs.items()}
    dim = next(iter(inputs.values()))[2][0].shape[0]
    work = (helmholtz_work if dim == 3 else helmholtz2d_work)(
        {n: v for n, v in charge.items() if not n.startswith("p2m_")})
    work.update(helmholtz_p2m_l2p_work({n: v for n, v in charge.items()
                                        if n.startswith("p2m_")}))
    out = {}
    for name, (_, _, args) in inputs.items():
        cname = name.removesuffix("_dipole")
        w = dict(work[cname])
        if dim == 3:
            w["flops"] = 2 * w["flops"] - w.pop("row_flops", 0)
        else:
            w["flops"] = helmholtz2d_dipole_flops(name, w, charge[cname][2])
            w.pop("row_flops", None)
        if name.startswith("p2m_"):
            nsrc = w["particles"]
        else:
            scn, ls = (args[7], args[10]) if name.startswith("p2p_") \
                else (args[4], args[7])
            nsrc = int(scn.to(torch.int64)[_boxes(ls)].sum())
        w["bytes"] += 8 * dim * nsrc
        out[name] = w
    return out


def charge_kernel_ms(w, inputs, device):
    """The times of the charge kernels that K57-K68 differentiate (K31, K9,
    K11, K33, K16, K18 or their pair entry points) on the dipole kernels'
    *inputs* less the dipoles (median of 5): the yardstick of a dipole
    kernel's cost."""
    mod = _helmholtz_ops(w.dim)
    out = {}
    for name, (_, _, args) in inputs.items():
        charge = getattr(mod, name.removesuffix("_dipole"))
        a = less_dipoles(name, args)
        if name.startswith("p2l_"):
            out[name] = median_ms(
                lambda: charge(*a, w.local_expansion_zeros()), device)
        else:
            out[name] = median_ms(lambda: charge(*a), device)
    return out


def worst_columns(got, ref, top=3, dim=3):
    """The *top* coefficient columns ``(n, m)`` (*dim* 3) or ``n`` (2) of
    (boxes, coefficients) expansions by rel l-inf error against *ref* (the
    pairs' ``[re | im]`` lanes taken as one complex column), each with that
    error, its absolute error, its scale (the column's largest ``|ref|``)
    over the array's largest, and the box of its largest error: where a
    dipole P2M's gap from its twin lies."""
    import torch
    if not ref.is_complex():
        h = ref.shape[1] // 2
        got = torch.complex(got[:, :h], got[:, h:])
        ref = torch.complex(ref[:, :h], ref[:, h:])
    err = (got - ref).abs()
    col_err, box = err.max(0)
    scale = ref.abs().amax(0)
    rel = col_err / torch.where(scale > 0, scale, torch.ones_like(scale))
    out = []
    for i in rel.argsort(descending=True)[:top].tolist():
        if dim == 3:
            n = int(i ** 0.5)
            nm = {"n": n, "m": i - n * n - n}
        else:
            nm = {"n": i - (ref.shape[1] - 1) // 2}
        out.append({**nm, "rel_err": rel[i].item(),
                    "abs_err": col_err[i].item(),
                    "scale_over_largest": (scale[i] / scale.max()).item(),
                    "box": int(box[i])})
    return out


def check_dipole_kernels(inputs, device, layout, plain_reps=1, slow_s=None):
    """K57-K59 / K63-K65 (*layout* ``"c128"``) or K60-K62 / K66-K68
    (``"f64"``) against their twins on *inputs* (:func:`check_list_kernels`,
    each at its own bar: the complex expansions per coefficient column,
    the pairs per lane; the P2M's :func:`worst_columns` beside).  Returns
    ``{name: numbers}``."""
    res = {}
    for name, inp in inputs.items():
        dim = 2 if "2d_" in name else 3
        res.update(check_list_kernels(
            {name: inp}, device, plain_reps=plain_reps,
            rtol=DIPOLE_KERNEL_RTOL[layout, name], slow_s=slow_s,
            rel_fn=rel_linf_per_lane if layout == "f64" else None,
            detail=(lambda got, ref, dim=dim: {"worst_columns": worst_columns(
                got, ref, dim=dim)}) if name.startswith("p2m_") else None))
    return res


def centre_source(w):
    """The tree-order sources of wrangler *w* with the first source of its
    first P2M row moved exactly onto that box's centre (r = 0: the dipole
    P2M's limit)."""
    box = int(w._source_rows[0])
    src = w._sources.clone()
    src[:, int(w.tree.box_source_starts[box])] = w.centers[:, box]
    return src


def direct_sum_helmholtz_dipole(sources, dipoles, charges, targets, k,
                                chunk=1 << 14):
    """sum_s q_s (d_s . grad_s) exp(ik|t - s|) / |t - s| over all sources,
    r = 0 skipped, in complex128: ``G'(r) d . (s - t) / r`` with ``G' =
    (ik - 1/r) G``; *charges* ``(nsources,)`` give ``(ntargets,)``,
    ``(nsources, m)`` give ``(ntargets, m)``."""
    import torch
    out = torch.zeros((targets.shape[1],) + tuple(charges.shape[1:]),
                      dtype=torch.complex128, device=targets.device)
    for c0 in range(0, sources.shape[1], chunk):
        d = sources[:, None, c0:c0 + chunk] - targets[:, :, None]
        r2 = (d * d).sum(0)
        ok = r2 > 0
        r = torch.sqrt(torch.where(ok, r2, 1.0))
        g = torch.polar(1.0 / r, k * r) * (1j * k - 1.0 / r)
        cos = (dipoles[:, None, c0:c0 + chunk] * d).sum(0) / r
        out += torch.where(ok, g * cos, 0) @ charges[c0:c0 + chunk]
    return out


def dipole_kernels_small(device, card, trav, q, k, order, cases, info):
    """K57-K62 (a 3D traversal *trav*) or K63-K68 (2D) against their twins
    at *trav*'s sources (``kernels_helmholtz{3,2}d_dipole_small``): per
    layout, each case ``(rscale, kind, dipoles)`` of *cases* once, with
    the complex charges *q* (c128) or their real part (f64) and the first
    source of the first P2M row moved onto its box's centre; the first
    case's inputs give the bounds.  *info* goes into the emitted line.
    Returns ``{layout: results}`` of the first case."""
    from boxtree_torch.models import make_helmholtz_wrangler

    t0 = time.perf_counter()
    tree = trav.tree
    dim = tree.dimensions
    small, small_work, first = {}, {}, {}
    for layout in ("c128", "f64"):
        for i, (rscale, kind, dip) in enumerate(cases):
            w = make_helmholtz_wrangler(trav, k, order, rscale=rscale,
                                        pairs=layout == "f64",
                                        dipole_vec=dip)
            if w._l3_csr is None or not w._l4_csr[2].numel():
                raise AssertionError("Lists 3 and 4 empty at "
                                     f"{tree.nsources} sources")
            qq = w.reorder_sources(q if layout == "c128"
                                   else q.real.contiguous())
            inputs = helmholtz_dipole_inputs(w, qq, centre_source(w))
            res = check_dipole_kernels(inputs, device, layout)
            small[f"{layout}-{rscale}-{kind}"] = res
            if i == 0:
                small_work[layout] = helmholtz_dipole_work(inputs)
                for name, r in res.items():
                    r["bound_ms"], r["bound_by"] = bound(
                        small_work[layout][name])
                first[layout] = res
    emit({"phase": f"kernels_helmholtz{dim}d_dipole_small", "card": card,
          **info, "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "order": order, "k": k,
          **({"recurrence_start": w._nstart} if dim == 2 else {}),
          "charges": "complex normal (c128), their real part (f64)",
          "source_on_centre": "the first source of the first P2M row",
          "tolerance_rel_linf": {f"{lay}/{nm}": v for (lay, nm), v
                                 in DIPOLE_KERNEL_RTOL.items()
                                 if f"{dim}d_" in nm},
          "rel": "per coefficient column (c128 P2M / P2L), per lane (f64)",
          "kernels": small, "work": small_work,
          "phase_s": time.perf_counter() - t0})
    return first


def dipole_path(device, card, trav, sources, targets, weights, dipoles, k,
                order, nsample, direct_sum, fmm_rtol, needed, at_1e5, info):
    """The Helmholtz dipole FMM on traversal *trav* (3D: K57-K62, 2D:
    K63-K68; ``helmholtz{3,2}d_dipole_fmm``): the complex wrangler and the
    pairs that ``pairs=None`` gives on the card, ``rscale="auto"``, with
    *dipoles* and their layout's *weights* (``{"c128": complex, "f64":
    real}``), one FMM each (the launches of each counted), a second with
    stage times, their host reads (by trace, and by a run under sync debug
    mode).  Each is held against *direct_sum* (complex128) at *nsample*
    of *targets* below *fmm_rtol*, and the pairs against the complex
    wrangler on the same real weights at every target; each FMM launches
    its layout's three dipole entry points once and no charge P2M / P2P /
    P2L, and every kernel of *needed* ran since the caller zeroed the
    counts.  Then the dipole kernels against their twins at its inputs,
    beside their bounds and their charge kernels
    (``kernels_helmholtz{3,2}d_dipole``).  *info* goes into the FMM's
    line, *at_1e5* (:func:`dipole_kernels_small`) into the summary entries
    it returns."""
    import numpy as np
    import torch

    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_helmholtz_wrangler
    from boxtree_torch.ops import kernels

    t_path = time.perf_counter()
    dim = trav.tree.dimensions
    table = {n: v for n, v in DIPOLE_KERNELS.items() if f"{dim}d_" in n}
    label = f"{dim}D dipole FMM"
    ws, pots, t_setup, t_fmm, per_fmm = {}, {}, {}, {}, {}
    for layout, pairs in (("c128", False), ("f64", None)):
        ws[layout], t_setup[layout] = timed(lambda: make_helmholtz_wrangler(
            trav, k, order, rscale="auto", pairs=pairs,
            dipole_vec=dipoles), device)
        before = kernels.entry_launch_counts()
        pots[layout], t_fmm[layout] = timed(
            lambda: drive_fmm(ws[layout], [weights[layout]]), device)
        per_fmm[layout] = {e: c - before[e] for e, c in
                           kernels.entry_launch_counts().items()}
    t_setup_fmms = time.perf_counter() - t_path
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    launches = kernels.launch_counts()
    stages, t_warm, reads = {}, {}, {}
    for layout, w in ws.items():
        qq = weights[layout]
        stages[layout] = {}
        _, t_warm[layout] = timed(lambda: drive_fmm(
            w, [qq], timing_data=stages[layout]), device)
        reads[layout] = fmm_host_reads(w, qq)
        if device.type == "cuda":
            # the second witness: the traces of these FMMs have come back
            # without device events
            reads[layout]["fmm_sync_debug"] = sync_free(
                lambda: drive_fmm(w, [qq]))
            reads[layout]["multipole_to_local_sync_debug"] = m2l_syncs(w, qq)
    pc, pp = pots["c128"], pots["f64"]
    # the pairs' reference at every target: the complex wrangler on the
    # same real weights
    qr = weights["f64"].to(torch.complex128)
    pc_real = (pc if torch.equal(weights["c128"], qr)
               else drive_fmm(ws["c128"], [qr]))
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        targets.shape[1], nsample, replace=False), device=device)
    ref = direct_sum(sources, dipoles, torch.stack([weights["c128"], qr], 1),
                     targets[:, sample], k)
    pp_c = torch.complex(pp[:, 0], pp[:, 1])
    abs_err, rel = rel_linf(pc[sample], ref[:, 0])
    _, rel_pairs_direct = rel_linf(pp_c[sample], ref[:, 1])
    _, rel_pairs = rel_linf(pp_c, pc_real)
    finite = bool(torch.isfinite(pc).all() and torch.isfinite(pp).all())
    once = {layout: {name: per_fmm[layout][f"{name}_{layout}"]
                     for name in table} for layout in ws}
    charge = {layout: {f"{old}_{lay}": per_fmm[layout][f"{old}_{lay}"]
                       for old in (n.removesuffix("_dipole") for n in table)
                       for lay in ("c128", "f64")} for layout in ws}
    emit({"phase": f"helmholtz{dim}d_dipole_fmm", "card": card, **info,
          "k": k, "order": order, "rscale": "auto",
          "wranglers": {lay: type(w).__name__ for lay, w in ws.items()},
          "pairs_rule": "pairs=None on CUDA",
          "nboxes": trav.tree.nboxes, "nlevels": trav.tree.nlevels,
          "setup_s": t_setup, "fmm_s": t_fmm, "fmm_warm_s": t_warm,
          "setup_and_fmms_s": t_setup_fmms, "stage_s": stages,
          "host_reads_per_fmm": reads, "peak_mem_gb": peak,
          "sampled_targets": nsample, "rel_linf_vs_c128_direct": rel,
          "abs_linf": abs_err, "bar_vs_direct": fmm_rtol,
          "pairs_rel_linf_vs_c128_direct": rel_pairs_direct,
          "pairs_rel_linf_vs_c128_wrangler": rel_pairs,
          "bar_pairs_vs_c128": HELMHOLTZ_PAIRS_RTOL,
          "dipole_launches_per_fmm": once,
          "charge_launches_per_fmm": charge, "launches": launches,
          "finite": finite, "phase_s": time.perf_counter() - t_path})
    pair_class = f"Helmholtz{dim}DPairsExpansionWrangler"
    if type(ws["f64"]).__name__ != pair_class:
        raise AssertionError(f"{label}: pairs=None on the card gave "
                             f"{type(ws['f64']).__name__}")
    if not finite or tuple(pc.shape) != (targets.shape[1],) \
            or tuple(pp.shape) != (targets.shape[1], 2):
        raise AssertionError(f"{label}: non-finite or misshapen output")
    for kind, err in (("complex", rel), ("pairs", rel_pairs_direct)):
        if not err < fmm_rtol:
            raise AssertionError(f"{label}: {kind} rel l-inf {err:.3e} >= "
                                 f"{fmm_rtol} against the direct sum")
    if not rel_pairs <= HELMHOLTZ_PAIRS_RTOL:
        raise AssertionError(f"{label}: pairs rel l-inf {rel_pairs:.3e} > "
                             f"{HELMHOLTZ_PAIRS_RTOL}")
    for layout in ws:
        check_once_per_fmm(once[layout], f"{label} {layout}", list(table))
        if any(charge[layout].values()):
            raise AssertionError(f"{label} {layout}: charge kernels "
                                 f"launched {charge[layout]}")
        r = reads[layout]
        if device.type == "cuda" and not reads_free(r):
            raise AssertionError(f"{label} {layout}: host reads {r}")
    missing = [e for e in needed if launches[e] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: "
                             f"{missing}")

    # the dipole kernels against their twins at the path's inputs, beside
    # their bounds and their charge kernels on the same inputs (a twin
    # slower than a second is timed once: the P2M and P2L ones take
    # seconds a call here)
    at_path, path_work = {}, {}
    t_twins = time.perf_counter()
    for layout, w in ws.items():
        inputs = helmholtz_dipole_inputs(w, w.reorder_sources(
            weights[layout]))
        path_work[layout] = helmholtz_dipole_work(inputs)
        at_path[layout] = check_dipole_kernels(inputs, device, layout,
                                               plain_reps=3, slow_s=1.0)
        charge_ms = charge_kernel_ms(w, inputs, device)
        for name, r in at_path[layout].items():
            r["bound_ms"], r["bound_by"] = bound(path_work[layout][name])
            r["charge_kernel_ms"] = charge_ms[name]
            r["launches"] = per_fmm[layout][f"{name}_{layout}"]
        del inputs
    emit({"phase": f"kernels_helmholtz{dim}d_dipole", "card": card,
          "sources": sources.shape[1], "targets": targets.shape[1],
          "order": order, "k": k,
          "tolerance_rel_linf": {f"{lay}/{nm}": v for (lay, nm), v
                                 in DIPOLE_KERNEL_RTOL.items()
                                 if f"{dim}d_" in nm},
          "kernels": at_path, "work": path_work,
          "twins_s": time.perf_counter() - t_twins,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None),
          "path_s": time.perf_counter() - t_path})
    del ws

    out = []
    for name, by_layout in table.items():
        for layout, (number, replaces) in by_layout.items():
            r = at_path[layout][name]
            out.append({
                "name": name if layout == "c128" else f"{name}_f64",
                "kernel": number, "route": "cuda", "source": SOURCES[name],
                "replaces": replaces, "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "charge_kernel_ms": r["charge_kernel_ms"],
                "entry_points": [f"{name}_{layout}"],
                "at_1e5": at_1e5[layout][name]})
    return out


def run_helmholtz3d_dipoles(device, card, n_kernels=100_000,
                            n_main=1_000_000, n_targets=200_000, k=2.0,
                            order=12, nsample=2000, seed=15):
    """K57-K62 against their twins at 1e5 sphere sources and 2e4 targets
    (:func:`dipole_kernels_small`: rscale ``"auto"`` with the normals and
    None with standard-normal dipoles); then the 3D Helmholtz dipole FMM
    (:func:`dipole_path`) at 1e6 sphere sources (the 3D double layer's
    points, normals as dipoles, real weights) and 2e5 targets, its tree
    and traversal built and counted here.  Returns the summary entries of
    K57-K62."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    t_phases = time.perf_counter()
    src_np, tgt_np, w_np = laplace3d_points(n_kernels, n_kernels // 5,
                                            seed + 20)
    src = torch.as_tensor(src_np, device=device)
    rng = np.random.default_rng(seed + 21)
    qc = torch.as_tensor(w_np + 1j * rng.standard_normal(n_kernels),
                         device=device)
    normal = torch.as_tensor(rng.standard_normal((3, n_kernels)),
                             device=device)
    tree = build_tree(src, targets=torch.as_tensor(tgt_np, device=device),
                      max_particles_in_box=30)
    # each rscale and each kind of dipole once a layout: the twin of the
    # dipole P2L takes 3-6 s a call here
    at_1e5 = dipole_kernels_small(
        device, card, build_traversal(tree), qc, k, order,
        [("auto", "normals", src), (None, "standard_normal", normal)],
        {"sources": n_kernels, "targets": n_kernels // 5})
    del tree

    src_np, tgt_np, w_np = laplace3d_points(n_main, n_targets, seed)
    src = torch.as_tensor(src_np, device=device)
    tgt = torch.as_tensor(tgt_np, device=device)
    q = torch.as_tensor(w_np, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    tree, t_tree = timed(lambda: build_tree(src, targets=tgt,
                                            max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    out = dipole_path(
        device, card, trav, src, tgt, {"c128": q.to(torch.complex128),
                                       "f64": q}, src, k, order, nsample,
        direct_sum_helmholtz_dipole, HELMHOLTZ_FMM_RTOL,
        ("morton_encode", *TREE_KERNELS, *TRAVERSAL_KERNELS,
         "m2p_helmholtz3d", "l2p_helmholtz3d", *FMM_TRANSLATE), at_1e5,
        {"sources": n_main, "targets": n_targets,
         "distribution": "sources on the unit sphere, targets uniform in "
                         "[-1, 1]^3", "seed": seed,
         "weights": "real normal (c128: as complex)",
         "dipoles": "outward unit normals", "max_particles_in_box": 30,
         "build_s": t_tree, "traversal_s": t_trav,
         "list_edges": {
             "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
             "l1_particle_pairs": l1_pairs(
                 tree.box_target_counts_nonchild,
                 tree.box_source_counts_nonchild, trav.target_boxes,
                 trav.neighbor_source_boxes_starts,
                 trav.neighbor_source_boxes_lists),
             "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
             "l4": int(trav.from_sep_bigger_lists.shape[0])}})
    emit({"phase": "helmholtz3d_dipole_phases", "card": card,
          "helmholtz3d_dipole_phases_s": time.perf_counter() - t_phases})
    return out

# }}}


# {{{ the QBX extent tree (K12-K15)

def extent_inputs(tree, pts, centres, radii):
    """Each of K12-K15's wrapper, plain twin and arguments as the extent
    path calls them: K12 on the merged particles of the user's *pts*,
    *centres* and *radii* in the bounding box ``_phase_a`` takes, K13 on
    the source side (no radii) and the target side, K14 and K15 on the
    arguments ``build_traversal`` gives them."""
    import torch

    from boxtree_torch.ops import close_lists, extents
    from boxtree_torch.traversal.build import close_list_inputs
    from boxtree_torch.tree.build import _root_box

    coords = torch.cat([pts, centres], dim=1)
    rad = torch.cat([torch.zeros_like(pts[0]), radii])
    lo, root = _root_box(coords, rad)
    k12_kw = dict(dimensions=tree.dimensions, depth=tree.max_depth,
                  extent_norm=tree.extent_norm,
                  stick_out_factor=tree.stick_out_factor)
    k13 = [(getattr(tree, f"{what}s"), getattr(tree, f"{what}_radii"),
            getattr(tree, f"box_{what}_starts"),
            getattr(tree, f"box_{what}_counts_nonchild"), tree.box_centers,
            tree.box_child_ids) for what in ("source", "target")]
    (a4, kw4), (a3, kw3) = close_list_inputs(tree)
    kw3 = dict(kw3, crit="precise_linf", min_nsources=0)
    lsb = tree.level_start_box_nrs
    return {
        "stick_levels": (
            lambda: extents.stick_levels(coords, rad, lo, root, **k12_kw),
            lambda: extents.stick_levels_plain(coords, rad, lo, root,
                                               **k12_kw),
            (coords, rad)),
        "box_extents": (
            lambda: [extents.box_extents(*a, lsb=lsb) for a in k13],
            lambda: [extents.box_extents_plain(*a, lsb=lsb) for a in k13],
            k13),
        "list4_ext": (
            lambda: close_lists.list4_ext(*a4, **kw4),
            lambda: close_lists.list4_ext_plain(*a4, **kw4), (a4, kw4)),
        "list3_ext": (
            lambda: close_lists.list3_ext(*a3, **kw3),
            lambda: close_lists.list3_ext_plain(*a3, **kw3), (a3, kw3)),
    }


def _flat(out):
    """A kernel's output as a flat list of tensors."""
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in _flat(part)]


def _distinct(work, key):
    """The number of distinct ids a twin's *work* gathered under *key*."""
    return int(work[key].shape[0]) if key in work else 0


def extent_work(inputs, outputs, tree):
    """Bytes each of K12-K15 must move (each input it needs read once,
    each output written once) and the float64 operations it must do on
    this run's data, counting add, sub, mul, abs, max and ldexp as one
    each.

    - K12: per particle 3 operations per coordinate for its cell, then
      per level it tries (its stick level + 1, at most the depth) 3 for
      the cell's size, half and stick-out and 9 per coordinate (centre 3,
      the two l-inf tests 6).
    - K13, both sides: per particle 2 per coordinate (+- radius, where
      there are radii) and 2 (min, max), per child link 2 per coordinate;
      bytes: the particles, their radii, every box's range, centre and
      bounding boxes, the child ids of the boxes above the finest level.
    - K14 and K15: what the plain twin counts on the same inputs
      (``work=``) of the rows, table rows, parents and candidates the
      kernel reads and of the criteria it evaluates.  K14: a box centre
      3 per coordinate, a sep-bigger test 3 per coordinate + 6; per row
      two centres, per probe (a candidate at its level, a source box, not
      touching) a centre and a test, per parent test one more.  K15
      (``precise_linf``): the target's centre and bounding-box centre and
      half extents 7 per coordinate per probe (a target box at its level
      that does not touch ``w``), a sep-smaller test 5 per coordinate + 2,
      a chain test a centre and a test more.
    """
    import torch

    from boxtree_torch.ops import close_lists

    d = tree.dimensions
    m = 3 ** d
    out = {}
    coords, radii = inputs["stick_levels"][2]
    stick = outputs["stick_levels"]
    visited = int(torch.clamp(stick.to(torch.int64) + 1,
                              max=tree.max_depth).sum())
    out["stick_levels"] = dict(
        type="float64", particles=coords.shape[1], levels_tried=visited,
        flops=3 * coords.numel() + (3 + 9 * d) * visited,
        bytes=nbytes(coords, radii) + 4 * coords.shape[1])

    lsb = tree.level_start_box_nrs
    nchild_links = int((tree.box_child_ids > 0).sum())
    k13_flops = k13_bytes = 0
    for x, r, starts, counts, centers, _ in inputs["box_extents"][2]:
        k13_flops += ((2 * (r is not None) + 2) * x.numel()
                      + 2 * d * nchild_links)
        k13_bytes += (nbytes(x, starts, counts, centers)
                      + (nbytes(r) if r is not None else 0)
                      + 4 * tree.box_child_ids.shape[0] * lsb[-2])
    out["box_extents"] = dict(
        type="float64", particles=sum(
            a[0].shape[1] for a in inputs["box_extents"][2]),
        boxes=tree.nboxes, flops=k13_flops,
        bytes=k13_bytes + nbytes(*_flat(outputs["box_extents"])))

    (a4, kw4), (a3, kw3) = inputs["list4_ext"][2], inputs["list3_ext"][2]
    w4, w3 = {}, {}
    close_lists.list4_ext_plain(*a4, **kw4, work=w4)
    close_lists.list3_ext_plain(*a3, **kw3, work=w3)
    geo = a4[-1]
    out["list4_ext"] = dict(
        type="float64", rows=w4["rows"], probes=w4["probes"],
        parent_tests=w4["parent_tests"],
        table_rows=_distinct(w4, "table_rows"),
        entries=int(outputs["list4_ext"][1].shape[0]
                    + outputs["list4_ext"][3].shape[0]),
        flops=(6 * d * w4["rows"] + (6 * d + 6) * w4["probes"]
               + (3 * d + 6) * w4["parent_tests"]),
        bytes=(20 * w4["rows"] + 4 * _distinct(w4, "parent_reads")
               + 4 * (m - 1) * _distinct(w4, "table_rows")
               + 4 * _distinct(w4, "flag_reads")
               + nbytes(geo.bbox_min) + nbytes(*outputs["list4_ext"])))
    itemsize = geo.bbox_min.element_size()
    out["list3_ext"] = dict(
        type="float64", boxes=w3["boxes"], rows=w3["rows"],
        probes=w3["probes"], chain_tests=w3["chain_tests"],
        w_tests=w3["w_tests"], table_rows=_distinct(w3, "table_rows"),
        entries=sum(int(t.shape[0]) for t in _flat(outputs["list3_ext"])),
        flops=(3 * d * w3["rows"] + 7 * d * w3["probes"]
               + (8 * d + 2) * w3["chain_tests"]
               + (5 * d + 2) * w3["w_tests"]),
        bytes=(4 * w3["boxes"] + 8 * w3["rows"]
               + 4 * _distinct(w3, "parent_reads")
               + 4 * m * _distinct(w3, "table_rows")
               + 8 * _distinct(w3, "tgt_reads")
               + 2 * d * itemsize * _distinct(w3, "bbox_reads")
               + 4 * _distinct(w3, "src_cumul_reads")
               + nbytes(geo.bbox_min)
               + nbytes(*_flat(outputs["list3_ext"]))))
    return out


def run_extents(device, card, trav_trees, translation, tree_trees,
                n=1_000_000, ncenters=100_000, order=10, nsample=2000,
                seed=15):
    """The QBX extent tree: Config B's sphere points and balls as sources
    and targets with radii, the traversal with its close lists, the
    counting FMM and the order-10 float64 Laplace FMM (K1-K4, K12-K15),
    then K12-K15 against their twins at the path's own inputs, and K28 /
    K30; returns the K12-K15 summary entries and K28 / K30's numbers
    here."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import (
        ConstantOneExpansionWrangler,
        make_laplace_wrangler,
    )
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    pts = torch.as_tensor(sphere_points(n, seed), device=device)
    rng = np.random.default_rng(seed + 1)
    anchor = torch.as_tensor(rng.choice(n, ncenters, replace=False),
                             device=device)
    radii = torch.as_tensor(rng.uniform(0.005, 0.02, ncenters),
                            device=device)
    centres = pts[:, anchor] * (1 + radii)   # pushed out along the normal
    q = torch.as_tensor(np.random.default_rng(seed + 2).standard_normal(n),
                        device=device)
    ones = [torch.ones(n, dtype=torch.float64, device=device)]

    # {{{ the path, counted

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(
        pts, targets=centres, target_radii=radii, stick_out_factor=0.25,
        max_particles_in_box=30), device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    pot1, t_count = timed(lambda: drive_fmm(
        ConstantOneExpansionWrangler(None, trav), ones), device)
    merged, t_merge = timed(trav.merge_close_lists, device)
    pot2, t_count2 = timed(lambda: drive_fmm(
        ConstantOneExpansionWrangler(None, merged), ones), device)
    wr, t_setup, table_launches = laplace_setup(
        lambda: make_laplace_wrangler(trav, order=order, pairs=True,
                                      rscale="auto", dtype=torch.float64),
        device)
    pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    # }}}

    # {{{ checks

    nbad = [int((p != n).sum()) for p in (pot1, pot2)]
    build_reads = build_host_reads(lambda: build_tree(
        pts, targets=centres, target_radii=radii, stick_out_factor=0.25,
        max_particles_in_box=30), tree, launches)
    stages = {}
    _, t_fmm_warm = timed(lambda: drive_fmm(wr, [q], timing_data=stages),
                          device)
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        ncenters, nsample, replace=False), device=device)
    ref = direct_sum_f64(pts, q, centres[:, sample])
    abs_err, rel = rel_linf(pot[sample], ref)
    finite = bool(torch.isfinite(pot).all())
    internal = (tree.box_flags & 16) == 0
    emit({"phase": "extent_fmm", "card": card, "points": n,
          "distribution": "unit sphere", "centres": ncenters,
          "radii": [0.005, 0.02], "stick_out_factor": 0.25,
          "extent_norm": tree.extent_norm, "from_sep_smaller_crit":
              "precise_linf", "dtype": "float64", "order": order,
          "rscale": "auto", "seed": seed, "nboxes": tree.nboxes,
          "nlevels": tree.nlevels,
          "internal_boxes_with_targets": int(
              (tree.box_target_counts_nonchild[internal] > 0).sum()),
          "targets_in_internal_boxes": int(
              tree.box_target_counts_nonchild[internal].sum()),
          "build_s": t_tree, **build_reads,
          "traversal_s": t_trav,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "counting_fmm_s": t_count, "merge_close_lists_s": t_merge,
          "counting_fmm_merged_s": t_count2,
          "counting_exact": nbad == [0, 0],
          "wrangler_setup_s": t_setup, "fmm_s": t_fmm,
          "fmm_warm_s": t_fmm_warm, "total_s": t_total, "stage_s": stages,
          "host_reads_per_fmm": fmm_host_reads(wr, q),
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0]),
              "l3_close": int(trav.from_sep_close_smaller_lists.shape[0]),
              "l4_close": int(trav.from_sep_close_bigger_lists.shape[0]),
              "l1_merged": int(
                  merged.neighbor_source_boxes_lists.shape[0])},
          "sampled_targets": nsample, "rel_linf_vs_f64_direct": rel,
          "abs_linf": abs_err, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    if nbad != [0, 0]:
        raise AssertionError(f"counting FMM on the extent tree: {nbad} "
                             f"potentials != {n} (close lists, merged)")
    if not finite or tuple(pot.shape) != (ncenters,):
        raise AssertionError("extent Laplace FMM: non-finite or misshapen "
                             "output")
    if not rel < EXTENT_FMM_RTOL:
        raise AssertionError(f"extent Laplace FMM: rel l-inf {rel:.3e} >= "
                             f"{EXTENT_FMM_RTOL}")
    emit({"phase": "launches", "path": "extent_fmm", "card": card,
          "launches": launches})
    missing = [name for name in EXTENT_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the extent path: "
                             f"{missing}")
    check_p2m_l2p_launches(launches, "extent path", 1)
    pres, pwork = check_p2m_l2p(card, device, "extent", [
        ("f64", wr, wr.reorder_sources(q), P2M_L2P_KERNELS)])
    check_m2l_table(card, device, "qbx extent tree", "f64", wr, t_setup,
                    table_launches)
    check_translation(card, device, "qbx extent tree", [("f64", wr, q)],
                      translation)

    # }}}

    # {{{ K12-K15 against their twins at these inputs, exactly

    inputs = extent_inputs(tree, pts, centres, radii)
    res, outputs = {}, {}
    for name, (kernel, plain, _) in inputs.items():
        got, ref = _flat(kernel()), _flat(plain())
        if len(got) != len(ref) or not all(
                torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"{name} != plain twin")
        outputs[name] = kernel()
        res[name] = dict(max_abs_err=0.0, ms=median_ms(kernel, device),
                         plain_ms=median_ms(plain, device))
    work = extent_work(inputs, outputs, tree)
    emit({"phase": "kernels_extents", "card": card, "points": n,
          "centres": ncenters, "tolerance": "exact", "kernels": res,
          "work": work})
    check_traversal_kernels(tree, device, card, "extent", trav_trees)
    check_tree_kernels(card, device, "extent", pts, dict(
        targets=centres, target_radii=radii, stick_out_factor=0.25,
        max_particles_in_box=30), tree_trees)

    # }}}

    return [summary_entry(name, launches[name], res[name], work[name])
            for name in res], {
        name: entry_point_numbers(launches[name], pres["f64"][name],
                                  pwork["f64"][name])
        for name in P2M_L2P_KERNELS}

# }}}


# {{{ the 2D Helmholtz FMM (K16-K18)

def clustered_square_points(n, seed):
    """``tests/test_helmholtz.py:23-46``'s points at *n*: uniform in the
    unit square, the first 4/15 (its 400 of 1,500) uniform in [0.4,
    0.5]^2; then complex standard-normal charges from the same stream."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pts = rng.random((2, n))
    m = round(n * 400 / 1500)
    pts[:, :m] = 0.1 * rng.random((2, m)) + 0.4
    q = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return pts, q


def helmholtz2d_inputs(trav, wrangler, q_tree):
    """K16-K18's wrappers, plain twins and arguments at the shapes the 2D
    Helmholtz FMM gives them."""
    from boxtree_torch.ops import helmholtz2d

    w = wrangler
    tree = trav.tree
    mpoles = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [q_tree]))
    return {
        "p2p_helmholtz2d": (
            helmholtz2d.p2p_helmholtz2d, helmholtz2d.p2p_helmholtz2d_plain,
            (w._targets, w._sources, q_tree, tree.box_target_starts,
             tree.box_target_counts_nonchild, tree.box_source_starts,
             tree.box_source_counts_nonchild, trav.target_boxes,
             trav.neighbor_source_boxes_starts,
             trav.neighbor_source_boxes_lists, w.k, w._nstart)),
        "m2p_helmholtz2d": (
            helmholtz2d.m2p_helmholtz2d, helmholtz2d.m2p_helmholtz2d_plain,
            (w._targets, tree.box_target_starts,
             tree.box_target_counts_nonchild, *w._l3_csr, mpoles, w.centers,
             w.box_scale, w.k, w.order, w._nstart)),
        "p2l_helmholtz2d": (
            lambda *a: helmholtz2d.p2l_helmholtz2d(
                *a, w.local_expansion_zeros()),
            lambda *a: helmholtz2d.p2l_helmholtz2d_plain(
                *a, w.local_expansion_zeros()),
            (w._sources, q_tree, tree.box_source_starts,
             tree.box_source_counts_nonchild, *w._l4_csr, w.centers,
             w.box_scale, w.k, w.order, w._nstart)),
    }


def l1_pairs(tcounts, scounts, target_boxes, starts, lists):
    """Particle pairs of List 1."""
    import torch

    from boxtree_torch.traversal.containers import csr_rows

    rows = target_boxes.to(torch.int64)[csr_rows(starts, lists.shape[0])]
    return int((tcounts.to(torch.int64)[rows]
                * scounts.to(torch.int64)[lists.to(torch.int64)]).sum())


def list1_pairs(tcounts, scounts, target_boxes, starts, lists):
    """Particle pairs of List 1 (sources = targets) less each target with
    itself: the pairs a P2P evaluates when no two particles coincide."""
    import torch
    return l1_pairs(tcounts, scounts, target_boxes, starts, lists) \
        - int(tcounts.to(torch.int64)[target_boxes.to(torch.int64)].sum())


def helmholtz2d_work(inputs):
    """Bytes K16-K18 must move (each input they need read once, each output
    written once, on this run's lists: :func:`p2p_bytes` and its kin) and
    the float64 operations they must do, at *inputs*.

    - K16: per List-1 particle pair with ``r > 0`` (the pairs of each
      target with itself are not evaluated), 16: difference 2, squared
      norm 3, ``k r`` 1, ``(i/4) H_0`` 2, times the charge and added 8 (4
      for K52's real charge).  The square root and CUDA's ``j0``/``y0`` are
      not counted.
    - K17, per (target particle, List-3 source box) pair, and K18, per
      (List-4 source particle, target box) pair: the offset and its norm 9;
      the J recurrence from ``ns`` (the even start order): 4 per step down
      (``2n/x - r`` and the reciprocal), 1 per product, 7 per pair of
      orders for the three sums, then 4 per order for ``J_n``, ``Y_n``, and
      10 for ``Y_0``, ``Y_1`` (the log, ``atan2``, ``sincos`` and ``pow``
      are not counted); per order ``m = 0..p``, K17 16 (``H_m`` times the
      phase 6, times ``s^m`` 2, times the multipole and added 8) and 18 more
      for ``-m`` (the sign 2); K18 14 (phase 6, ``s^m`` 2, times ``(i/4)
      q`` 6; K54's real charge 2 in place of 6), 16 more for ``-m`` (12 for
      K54) and 2 per coefficient for the sum over sources, then 2 per
      coefficient of each target box.

    Bytes as in :func:`helmholtz_work`: K52-K54's real charges 8 bytes.
    Each of the three in *inputs* is counted; K18's per-box adds are also
    given alone, as ``row_flops``.
    """
    import torch

    from boxtree_torch.ops.cylinder_bessel import even_start
    from boxtree_torch.traversal.containers import csr_rows

    def row_of(starts, lists):
        return csr_rows(starts, lists.shape[0])

    def common(order, nstart):
        ns = even_start(nstart, order)
        return ns, 9 + 5 * ns + 7 * (ns // 2) + 4 * (order + 1) + 10

    out = {}
    if "p2p_helmholtz2d" in inputs:
        (tgt, src, q, tst, tcn, sst, scn, tb, st, ls, _, _) = \
            inputs["p2p_helmholtz2d"][2]
        pairs = list1_pairs(tcn, scn, tb, st, ls)
        out["p2p_helmholtz2d"] = dict(
            type="float64", particle_pairs=pairs,
            flops=(16 if q.is_complex() else 12) * pairs,
            bytes=p2p_bytes(tgt, src, q, tst, tcn, sst, scn, tb, st, ls, 16))

    if "m2p_helmholtz2d" in inputs:
        (tgt, tst, tcn, rows, st, ls, mp, centers, scale, _, order,
         nstart) = inputs["m2p_helmholtz2d"][2]
        ns, per_pair = common(order, nstart)
        pairs = int(tcn.to(torch.int64)[rows.to(torch.int64)[
            row_of(st, ls)]].sum())
        out["m2p_helmholtz2d"] = dict(
            type="float64", target_box_pairs=pairs, recurrence_start=ns,
            coefficients=2 * order + 1,
            flops=(per_pair + 16 * (order + 1) + 18 * order) * pairs,
            bytes=m2p_bytes(tgt, tst, tcn, rows, st, ls, mp, centers, scale,
                            16))

    if "p2l_helmholtz2d" in inputs:
        (src, q, sst, scn, rows, st, ls, centers, scale, _, order,
         nstart) = inputs["p2l_helmholtz2d"][2]
        real_q = not q.is_complex()
        ns, per_pair = common(order, nstart)
        nc = 2 * order + 1
        pairs = int(scn.to(torch.int64)[ls.to(torch.int64)].sum())
        out["p2l_helmholtz2d"] = dict(
            type="float64", source_box_pairs=pairs, recurrence_start=ns,
            coefficients=nc,
            flops=((per_pair + (10 if real_q else 14) * (order + 1)
                    + (12 if real_q else 16) * order + 2 * nc) * pairs
                   + 2 * nc * rows.shape[0]),
            row_flops=2 * nc * rows.shape[0],
            bytes=p2l_bytes(src, q, sst, scn, rows, st, ls, centers, scale,
                            nc * 16))
    return out


def direct_sum_helmholtz2d(sources, charges, targets, k, chunk=1 << 15):
    """sum_s q_s (i/4) H_0(k |t - s|) over all sources, r = 0 skipped, in
    complex128, with ``torch.special``'s ``bessel_j0``/``bessel_y0``
    (independent of the port's recurrences and of K16's ``j0``/``y0``)."""
    import torch
    out = torch.zeros(targets.shape[1], dtype=torch.complex128,
                      device=targets.device)
    for c0 in range(0, sources.shape[1], chunk):
        d = targets[:, :, None] - sources[:, None, c0:c0 + chunk]
        r = torch.sqrt((d * d).sum(0))
        ok = r > 0
        kr = k * torch.where(ok, r, 1.0)
        g = torch.complex(-0.25 * torch.special.bessel_y0(kr),
                          0.25 * torch.special.bessel_j0(kr))
        out += torch.where(ok, g, 0) @ charges[c0:c0 + chunk]
    return out


def check_hankel_against_scipy(pts, k, seed, n=10_000, nu=0):
    """``torch.special``'s ``j0 + i y0`` (*nu* 0) or ``j1 + i y1`` (1)
    against ``scipy.special.hankel1(nu, .)`` at ``k |p_i - p_j|`` for *n*
    pairs of the points: half random pairs (the direct sum's distances),
    half neighbours in tree order (short distances).  Returns the worst
    relative error of the complex value, which never vanishes."""
    import numpy as np
    import torch
    from scipy import special as sp

    npts = pts.shape[1]
    rng = np.random.default_rng(seed)
    i = rng.integers(0, npts, n)
    j = np.concatenate([rng.integers(0, npts, n // 2),
                        np.minimum(i[n // 2:] + 1, npts - 1)])
    i, j = (torch.as_tensor(v, device=pts.device) for v in (i, j))
    d = pts[:, i] - pts[:, j]
    x = k * torch.sqrt((d * d).sum(0))
    x = x[x > 0]
    j, y = ((torch.special.bessel_j0, torch.special.bessel_y0) if nu == 0
            else (torch.special.bessel_j1, torch.special.bessel_y1))
    got = torch.complex(j(x), y(x)).cpu().numpy()
    ref = sp.hankel1(nu, x.cpu().numpy())
    return float((np.abs(got - ref) / np.abs(ref)).max()), int(x.numel())


def run_helmholtz2d(device, card, translation, n_kernels=100_000,
                    n_main=1_000_000,
                    k=3.0, order=16, nsample=2000, seed=23):
    """K16-K18 against their twins at 1e5 points, then the 2D Helmholtz
    FMM at 1e6 clustered points (K1, K16-K18, K33, K34) and K16-K18, K33
    and K34 against their twins at its shapes, the real-pair wrangler and
    the dipoles (:func:`run_helmholtz_pairs`,
    :func:`run_helmholtz2d_dipoles`) on its traversal, then
    :func:`large_k_kernels`; returns their summary entries."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_helmholtz_wrangler
    from boxtree_torch.ops import helmholtz2d, kernels
    from boxtree_torch.traversal import build_traversal
    from boxtree_torch.tree.containers import box_flags_enum

    def on_card(pts, q):
        return (torch.as_tensor(pts, device=device),
                torch.as_tensor(q, device=device))

    t_phases = time.perf_counter()

    # {{{ kernels vs twins at 1e5 points of the same distribution

    pts, q = on_card(*clustered_square_points(n_kernels, seed + 1))
    tree = build_tree(pts, max_particles_in_box=30)
    trav = build_traversal(tree)
    wr = make_helmholtz_wrangler(trav, k, order, rscale="auto", pairs=False)
    if wr._l3_csr is None or not wr._l4_csr[2].numel():
        raise AssertionError(f"Lists 3 and 4 empty at {n_kernels} points")
    small = check_list_kernels(
        helmholtz2d_inputs(trav, wr, wr.reorder_sources(q)), device,
        plain_reps=5, rtol=HELMHOLTZ2D_KERNEL_RTOL)
    emit({"phase": "kernels_helmholtz2d_small", "card": card,
          "points": n_kernels, "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "order": order, "k": k,
          "recurrence_start": wr._nstart,
          "tolerance_rel_linf": HELMHOLTZ2D_KERNEL_RTOL,
          "p2l_helmholtz2d_rel": "per coefficient", "kernels": small})
    del tree, trav, wr

    # }}}

    # {{{ the path: 2D Helmholtz FMM at 1e6, every kernel counted

    pts, q = on_card(*clustered_square_points(n_main, seed))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(pts, max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    wr, t_setup = timed(lambda: make_helmholtz_wrangler(
        trav, helmholtz_k=k, order=order, rscale="auto", pairs=False),
        device)
    pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    stages = {}
    _, t_fmm_warm = timed(lambda: drive_fmm(wr, [q], timing_data=stages),
                          device)
    h0_rel, h0_n = check_hankel_against_scipy(pts, k, seed + 2)
    if not h0_rel <= BESSEL_CHECK_RTOL:
        raise AssertionError(f"torch.special j0/y0 vs scipy hankel1: "
                             f"{h0_rel:.3e} > {BESSEL_CHECK_RTOL}")
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n_main, nsample, replace=False), device=device)
    ref = direct_sum_helmholtz2d(pts, q, pts[:, sample], k)
    abs_err, rel = rel_linf(pot[sample], ref)
    finite = bool(torch.isfinite(pot).all())
    l1 = list1_pairs(tree.box_target_counts_nonchild,
                     tree.box_source_counts_nonchild, trav.target_boxes,
                     trav.neighbor_source_boxes_starts,
                     trav.neighbor_source_boxes_lists)
    emit({"phase": "helmholtz2d_fmm", "card": card, "points": n_main,
          "distribution": "unit square, 4/15 in [0.4, 0.5]^2", "seed": seed,
          "k": k, "order": order, "rscale": "auto", "dtype": "complex128",
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "nleaves": int(((tree.box_flags & box_flags_enum.IS_LEAF_BOX)
                          != 0).sum()),
          "rscale_min": float(wr._rscale_np.min()),
          "recurrence_start": wr._nstart,
          "build_s": t_tree, "traversal_s": t_trav,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "wrangler_setup_s": t_setup, "fmm_s": t_fmm,
          "fmm_warm_s": t_fmm_warm, "total_s": t_total, "stage_s": stages,
          "host_reads_per_fmm": fmm_host_reads(wr, q),
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l1_particle_pairs": l1,
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "h0_check": {"pairs": h0_n, "rel_vs_scipy": h0_rel},
          "sampled_targets": nsample, "rel_linf_vs_c128_direct": rel,
          "abs_linf": abs_err, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    if not finite or tuple(pot.shape) != (n_main,) \
            or pot.dtype != torch.complex128:
        raise AssertionError("2D Helmholtz FMM: non-finite or misshapen "
                             "output")
    if not rel < HELMHOLTZ2D_FMM_RTOL:
        raise AssertionError(f"2D Helmholtz FMM: rel l-inf {rel:.3e} >= "
                             f"{HELMHOLTZ2D_FMM_RTOL}")
    emit({"phase": "launches", "path": "helmholtz2d_fmm", "card": card,
          "launches": launches})
    missing = [name for name in HELMHOLTZ2D_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the 2D Helmholtz "
                             f"path: {missing}")
    check_p2m_l2p_helmholtz_launches(launches, "2D Helmholtz FMM",
                                     HELMHOLTZ2D_P2M_L2P)

    # }}}

    # the kernels against their twins at the path's own shapes (K16's
    # twin takes seconds a call here: a twin slower than a second is timed
    # once, the others by a median of 3)
    inputs = helmholtz2d_inputs(trav, wr, wr.reorder_sources(q))
    work = helmholtz2d_work(inputs)
    res = check_list_kernels(inputs, device, plain_reps=3, slow_s=1.0,
                             rtol=HELMHOLTZ2D_KERNEL_RTOL)
    grid = helmholtz2d.launch_grid(device, tree.nboxes)
    emit({"phase": "kernels_helmholtz2d", "card": card, "points": n_main,
          "order": order, "k": k,
          "tolerance_rel_linf": HELMHOLTZ2D_KERNEL_RTOL,
          "p2l_helmholtz2d_rel": "per coefficient", "kernels": res,
          "launches": {name: launches[name] for name in res},
          "work": work, "scratch_grid": grid,
          "scratch_bytes": helmholtz2d.scratch_bytes(grid, order,
                                                     wr._nstart)})
    pres, pwork = check_p2m_l2p_helmholtz(card, device, "helmholtz2d_fmm",
                                          wr, wr.reorder_sources(q))
    check_translation(card, device, "helmholtz2d", [("c128", wr, q)],
                      translation)
    res.update(pres)
    work.update(pwork)
    out = [summary_entry(name, launches[name], res[name], work[name])
           for name in res]
    del wr, inputs

    # the real-pair wrangler on the same traversal with the charges' real
    # parts, then K52-K56 against their twins on the 1e5 points above
    entries, path, pwork = run_helmholtz_pairs(
        device, card, translation, trav, pts, q.real.contiguous(), k, order,
        direct_sum_helmholtz2d, nsample)
    out += run_helmholtz2d_dipoles(
        device, card, trav, pts, q, k, order, n_kernels, nsample, seed,
        {"build_s": t_tree, "traversal_s": t_trav})
    del tree, trav
    pts, q = on_card(*clustered_square_points(n_kernels, seed + 1))
    small = check_pair_kernels(card, device, 2, pts, q.real.contiguous(),
                               k, order, entries)
    out += [pair_entry(name, entries[f"{name}_f64"], path[name],
                       pwork[name], small[name]) for name in path]
    large_k_kernels(device, card, seed + 3)
    emit({"phase": "helmholtz2d_phases", "card": card,
          "helmholtz2d_phases_s": time.perf_counter() - t_phases})
    return out


# {{{ the 2D Helmholtz dipoles (K63-K68)

def direct_sum_helmholtz2d_dipole(sources, dipoles, charges, targets, k,
                                  chunk=1 << 14):
    """sum_s q_s (d_s . grad_s) (i/4) H_0(k |t - s|) = sum_s q_s (i/4) k
    H_1(k r) d_s . (t - s) / r over all sources, r = 0 skipped, in
    complex128, with ``torch.special``'s ``bessel_j1``/``bessel_y1``
    (independent of the port's recurrences and of K64's ``j1``/``y1``);
    *charges* ``(nsources, m)`` complex128 give ``(ntargets, m)``."""
    import torch
    out = torch.zeros((targets.shape[1], charges.shape[1]),
                      dtype=torch.complex128, device=targets.device)
    for c0 in range(0, sources.shape[1], chunk):
        d = targets[:, :, None] - sources[:, None, c0:c0 + chunk]
        r = torch.sqrt((d * d).sum(0))
        ok = r > 0
        rs = torch.where(ok, r, 1.0)
        kr = k * rs
        proj = k * (dipoles[:, None, c0:c0 + chunk] * d).sum(0) / rs
        g = torch.complex(-0.25 * torch.special.bessel_y1(kr) * proj,
                          0.25 * torch.special.bessel_j1(kr) * proj)
        out += torch.where(ok, g, 0) @ charges[c0:c0 + chunk]
    return out


def run_helmholtz2d_dipoles(device, card, trav, pts, q, k, order,
                            n_kernels, nsample, seed, tree_times):
    """K63-K68 against their twins at *n_kernels* clustered points
    (:func:`dipole_kernels_small`: rscale ``"auto"`` and None,
    standard-normal dipoles); then the 2D Helmholtz dipole FMM
    (:func:`dipole_path`) on the 2D Helmholtz path's traversal *trav* of
    its 1e6 points *pts*: standard-normal dipoles, the path's complex
    weights *q* (c128) and their real parts (f64), ``torch.special``'s
    ``j1``/``y1`` held to scipy first.  *tree_times* are the shared tree's
    and traversal's.  Returns the summary entries of K63-K68."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    t_phases = time.perf_counter()
    pts_np, q_np = clustered_square_points(n_kernels, seed + 1)
    pts_s = torch.as_tensor(pts_np, device=device)
    dip_s = torch.as_tensor(np.random.default_rng(seed + 30).standard_normal(
        (2, n_kernels)), device=device)
    at_1e5 = dipole_kernels_small(
        device, card, build_traversal(build_tree(
            pts_s, max_particles_in_box=30)),
        torch.as_tensor(q_np, device=device), k, order,
        [("auto", "standard_normal", dip_s),
         (None, "standard_normal", dip_s)], {"points": n_kernels})

    tree = trav.tree
    n = pts.shape[1]
    dip = torch.as_tensor(np.random.default_rng(seed + 31).standard_normal(
        (2, n)), device=device)
    h1_rel, h1_n = check_hankel_against_scipy(pts, k, seed + 32, nu=1)
    if not h1_rel <= BESSEL_CHECK_RTOL:
        raise AssertionError(f"torch.special j1/y1 vs scipy hankel1: "
                             f"{h1_rel:.3e} > {BESSEL_CHECK_RTOL}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    out = dipole_path(
        device, card, trav, pts, pts, {"c128": q, "f64": q.real.contiguous()},
        dip, k, order, nsample, direct_sum_helmholtz2d_dipole,
        HELMHOLTZ2D_FMM_RTOL,
        ("m2p_helmholtz2d", "l2p_helmholtz2d", *FMM_TRANSLATE), at_1e5,
        {"points": n,
         "distribution": "unit square, 4/15 in [0.4, 0.5]^2 (the 2D "
                         "Helmholtz path's points, tree and traversal)",
         "seed": seed, "weights": {"c128": "complex normal",
                                   "f64": "their real part"},
         "dipoles": "standard normal", "max_particles_in_box": 30,
         **tree_times, "tree_and_traversal": "shared with helmholtz2d_fmm",
         "list_edges": {
             "l1_particle_pairs": list1_pairs(
                 tree.box_target_counts_nonchild,
                 tree.box_source_counts_nonchild, trav.target_boxes,
                 trav.neighbor_source_boxes_starts,
                 trav.neighbor_source_boxes_lists),
             "l4": int(trav.from_sep_bigger_lists.shape[0])},
         "h1_check": {"pairs": h1_n, "rel_vs_scipy": h1_rel}})
    emit({"phase": "helmholtz2d_dipole_phases", "card": card,
          "helmholtz2d_dipole_phases_s": time.perf_counter() - t_phases})
    return out

# }}}


def large_k_kernels(device, card, seed, n=20_000, k=200.0, order=16):
    """Past the old shared-memory limit: the 2D Helmholtz wrangler at
    order 16 and k = 200 on *n* clustered points of the unit square (a
    recurrence from 954 where K17 / K18 once refused above about 56 times
    the root extent), one FMM (finite values, K33 and K34 once), then K17,
    K18, K33 and K34 against their twins at its inputs."""
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_helmholtz_wrangler
    from boxtree_torch.ops import helmholtz2d, kernels
    from boxtree_torch.ops.cylinder_bessel import even_start
    from boxtree_torch.traversal import build_traversal

    pts_np, q_np = clustered_square_points(n, seed)
    pts = torch.as_tensor(pts_np, device=device)
    q = torch.as_tensor(q_np, device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    wr = make_helmholtz_wrangler(trav, k, order, rscale="auto", pairs=False)
    kernels.reset_launch_counts()
    pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
    launches = kernels.launch_counts()
    check_p2m_l2p_helmholtz_launches(launches, "2D Helmholtz FMM at large k",
                                     HELMHOLTZ2D_P2M_L2P)
    finite = bool(torch.isfinite(pot).all())
    if not finite or tuple(pot.shape) != (n,):
        raise AssertionError("2D Helmholtz FMM at large k: non-finite or "
                             "misshapen output")
    tq = wr.reorder_sources(q)
    inputs = {name: v for name, v in helmholtz2d_inputs(
        trav, wr, tq).items() if name != "p2p_helmholtz2d"}
    inputs.update(helmholtz_p2m_l2p_inputs(wr, tq))
    res = check_list_kernels(inputs, device, plain_reps=1,
                             rtol=HELMHOLTZ2D_KERNEL_RTOL, slow_s=1.0)
    grid = helmholtz2d.launch_grid(device, trav.tree.nboxes)
    emit({"phase": "kernels_helmholtz2d_large_k", "card": card, "points": n,
          "order": order, "k": k, "root_extent": float(trav.tree.root_extent),
          "nboxes": trav.tree.nboxes, "nlevels": trav.tree.nlevels,
          "recurrence_start": even_start(wr._nstart, order),
          "scratch_grid": grid,
          "scratch_bytes": helmholtz2d.scratch_bytes(grid, order,
                                                     wr._nstart),
          "fmm_s": t_fmm, "finite": finite,
          "tolerance_rel_linf": HELMHOLTZ2D_KERNEL_RTOL,
          "rel": "per coefficient (P2L, P2M), potentials (M2P, L2P)",
          "kernels": res,
          "launches": {name: launches[name] for name in res}})

    # the pair wrangler there: its FMM through K52-K56, then K53-K56
    # against their twins
    del wr, inputs
    q = q.real.contiguous()
    wr = make_helmholtz_wrangler(trav, k, order, rscale="auto")
    kernels.reset_launch_counts()
    pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
    entries = kernels.entry_launch_counts()
    names = [nm for nm in PAIR_KERNELS if nm.endswith("2d")]
    launched = {f"{nm}_f64": entries[f"{nm}_f64"] for nm in names}
    finite = bool(torch.isfinite(pot).all())
    if not finite or tuple(pot.shape) != (n, 2):
        raise AssertionError("2D pair FMM at large k: non-finite or "
                             "misshapen output")
    if device.type == "cuda" and (
            launched["p2m_helmholtz2d_f64"] != 1
            or launched["l2p_helmholtz2d_f64"] != 1
            or not all(launched.values())
            or any(entries[f"{nm}_c128"] for nm in names)):
        raise AssertionError(f"2D pair FMM at large k: launches {launched}")
    tq = wr.reorder_sources(q)
    inputs = {name: v for name, v in helmholtz_pair_inputs(wr, tq).items()
              if name != "p2p_helmholtz2d"}
    res = check_list_kernels(inputs, device, plain_reps=1,
                             rtol=HELMHOLTZ_PAIR_KERNEL_RTOL, slow_s=1.0,
                             rel_fn=rel_linf_per_lane)
    emit({"phase": "kernels_helmholtz2d_pairs_large_k", "card": card,
          "points": n, "order": order, "k": k,
          "wrangler": type(wr).__name__, "fmm_s": t_fmm, "finite": finite,
          "tolerance_rel_linf": HELMHOLTZ_PAIR_KERNEL_RTOL,
          "rel": "per coefficient column and per potential lane",
          "kernels": {PAIR_KERNELS[nm][0]: r for nm, r in res.items()},
          "launches": launched})

# }}}


# {{{ the 2D Laplace FMM (K19-K21)

def laplace2d_points(n, seed):
    """``tests/test_laplace.py:27-31``'s points at *n*: uniform in the unit
    square, the first 24 % (its 600 of 2,500) uniform in [0.45, 0.55]^2;
    then real standard-normal charges from the same stream."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pts = rng.random((2, n))
    m = round(n * 600 / 2500)
    pts[:, :m] = 0.1 * rng.random((2, m)) + 0.45
    return pts, rng.standard_normal(n)


#: K19-K21, then K38 and K40
LAPLACE2D_CHARGE_KERNELS = ("p2p_laplace2d", "m2p_laplace2d",
                            "p2l_laplace2d", *LAPLACE2D_P2M_L2P)
#: K39, K41 and K42
LAPLACE2D_DIPOLE_ONLY = ("p2m_laplace2d_dipole", "p2p_laplace2d_dipole",
                         "p2l_laplace2d_dipole")


def laplace2d_inputs(trav, wrangler, q_tree,
                     names=LAPLACE2D_CHARGE_KERNELS):
    """K19-K21 and K38-K42's wrappers, plain twins and arguments at the
    shapes the 2D Laplace FMM of *wrangler* (complex or pairs; with
    dipoles for K39, K41 and K42) gives them, K40 the masked locals of
    this FMM; *names* picks them."""
    from boxtree_torch.ops import laplace2d

    w = wrangler
    tree = trav.tree
    l1 = (tree.box_target_starts, tree.box_target_counts_nonchild,
          tree.box_source_starts, tree.box_source_counts_nonchild,
          trav.target_boxes, trav.neighbor_source_boxes_starts,
          trav.neighbor_source_boxes_lists)
    l4 = (tree.box_source_starts, tree.box_source_counts_nonchild,
          *w._l4_csr, w.centers, w.box_scale, w.order)
    src_rows = (tree.box_source_starts, tree.box_source_counts_nonchild,
                w._source_rows, w.centers, w.box_scale, w.order)
    dip = (w.dipole_vec,) if w.dipole_vec is not None else ()
    out = {}
    for name in names:
        if name.startswith("p2p_"):
            args = (w._targets, w._sources, q_tree,
                    *(dip if name.endswith("dipole") else ()), *l1)
        elif name == "m2p_laplace2d":
            mp = w.coarsen_multipoles(None, None, w.form_multipoles(
                None, None, [q_tree]))
            args = (w._targets, tree.box_target_starts,
                    tree.box_target_counts_nonchild, *w._l3_csr, mp,
                    w.centers, w.box_scale, w.order)
        elif name.startswith("p2l_"):
            args = (w._sources, q_tree,
                    *(dip if name.endswith("dipole") else ()), *l4)
        elif name.startswith("p2m_"):
            args = (w._sources, q_tree,
                    *(dip if name.endswith("dipole") else ()), *src_rows)
        else:
            args = (w._targets, tree.box_target_starts,
                    tree.box_target_counts_nonchild, w._target_rows,
                    w._mask_levels(fmm_locals(w, q_tree)).contiguous(),
                    w.centers, w.box_scale, w.order)
        kernel = getattr(laplace2d, name)
        plain = getattr(laplace2d, f"{name}_plain")
        if name.startswith("p2l_"):
            out[name] = (
                lambda *a, k=kernel: k(*a, w.local_expansion_zeros()),
                lambda *a, k=plain: k(*a, w.local_expansion_zeros()), args)
        else:
            out[name] = (kernel, plain, args)
    return out


def laplace2d_work(inputs):
    """Bytes K19-K21 and K38-K42 must move (each input they need read
    once, each output written once, on this run's lists: :func:`p2p_bytes`
    and its kin; the dipoles of the listed or owned sources too) and the
    float operations they must do, at *inputs*, for the entry point the
    inputs take (complex128, or real pairs of the points' type).  Logs,
    ``hypot`` and ``atan2`` are not counted.

    - K19, per List-1 particle pair with ``r > 0`` (with sources =
      targets, not each target with itself), 8: difference 2, ``r^2`` 3, the half 1, times the charge
      and added 2; 10 with complex charges (two real sums).  K41 16 (18):
      ``r^2`` and its tangent 8, the tangent over ``r^2`` and halved 2.
    - K20, per (target particle, List-3 source box) pair: the scaled offset
      4; complex: ``log s`` added 1, times ``a_0`` 6, ``1/w`` 5, then per
      order ``k >= 1`` 14 (the power 6, times ``a_k`` 6, added 2); pairs:
      ``r^2`` 3, ``log`` halves and sums 2, the ``a_0`` lanes 3, ``1/w`` 3,
      then per order 10 (the power 6, the lanes 4).
    - K21, per (List-4 source particle, target box) pair: the offset 4;
      complex: ``log s`` 1, times ``q`` 6, ``1/z0`` 5, per order 14 (power
      6, times ``-q`` 6, over ``l`` 2), and 2 per coefficient for the sum
      over sources; pairs: ``r^2`` 3, logs 2, times ``q`` 2, ``1/z0`` 3,
      per order 12 (power 6, both lanes 6), and 1 per coefficient lane for
      the sum; then each row's coefficients added into the output.  K42
      the same with the power and ``1/z0`` on dual numbers: per order 10
      more (the tangent of the power), ``1/z0`` and the logs' tangents 12
      more, the dipole over ``s`` 2.
    - K38, per source of the rows: the offset 4, then per order ``k >= 1``
      the power 6, times ``-q`` 6 (2 a lane for the pairs' real charges),
      over ``k`` 2, and the warp sums 2; K39 the power's tangent 10 more a
      order and the dipole over ``s`` 2.
    - K40, per target of the rows: the offset 4, then per order the power
      6 and the multiply-add 8 (complex) or 4 (the pairs' real part).
    """
    import torch

    from boxtree_torch.traversal.containers import csr_rows

    out = {}
    for name, (_, _, args) in inputs.items():
        typ = str(args[0].dtype).removeprefix("torch.")
        dipole = name.endswith("dipole")
        if name.startswith("p2p_"):
            tgt, src, q = args[:3]
            tst, tcn, sst, scn, tb, st, ls = args[-7:]
            cplx = q.is_complex()
            # sources = targets: less each target with itself
            pairs = (list1_pairs if tgt is src else l1_pairs)(
                tcn, scn, tb, st, ls)
            nb = p2p_bytes(tgt, src, q, tst, tcn, sst, scn, tb, st, ls,
                           q.element_size())
            if dipole:
                nb += int(scn[_boxes(ls)].sum()) * 2 * src.element_size()
            per = (16 if dipole else 8) + (2 if cplx else 0)
            out[name] = dict(type=typ, particle_pairs=pairs,
                             flops=per * pairs, bytes=nb)
        elif name == "m2p_laplace2d":
            (tgt, tst, tcn, rows, st, ls, mp, centers, scale, order) = args
            cplx = mp.is_complex()
            pairs = int(tcn.to(torch.int64)[rows.to(torch.int64)[
                csr_rows(st, ls.shape[0])]].sum())
            per = (16 + 14 * order) if cplx else (15 + 10 * order)
            out[name] = dict(
                type=typ, target_box_pairs=pairs, coefficients=mp.shape[1],
                flops=per * pairs,
                bytes=m2p_bytes(tgt, tst, tcn, rows, st, ls, mp, centers,
                                scale, mp.element_size()))
        elif name.startswith("p2l_"):
            src, q = args[:2]
            sst, scn, rows, st, ls, centers, scale, order = args[-8:]
            cplx = q.is_complex()
            nc = order + 1 if cplx else 2 * (order + 1)
            pairs = int(scn.to(torch.int64)[ls.to(torch.int64)].sum())
            per = (16 + 14 * order + 2 * nc) if cplx \
                else (14 + 12 * order + nc)
            if dipole:
                per += 14 + 10 * order
            nb = p2l_bytes(src, q, sst, scn, rows, st, ls, centers, scale,
                           nc * q.element_size())
            if dipole:
                nb += int(scn[_boxes(ls)].sum()) * 2 * src.element_size()
            out[name] = dict(
                type=typ, source_box_pairs=pairs, coefficients=nc,
                flops=per * pairs + (2 if cplx else 1) * nc * rows.shape[0],
                bytes=nb)
        else:
            # K38-K40: the rows' own particles
            pts, order = args[0], args[-1]
            centers, scale = args[-3], args[-2]
            starts, counts, rows = (args[1:4] if name == "l2p_laplace2d"
                                    else args[-6:-3])
            npart = int(counts.to(torch.int64)[rows.to(torch.int64)].sum())
            per_row = (starts.element_size() + counts.element_size()
                       + 2 * centers.element_size() + scale.element_size())
            if name == "l2p_laplace2d":
                loc = args[4]
                cplx = loc.is_complex()
                per_part = 2 * pts.element_size() + loc.element_size()
                per_row += loc.shape[1] * loc.element_size()
                written = 0
                per = 4 + (14 if cplx else 10) * order
            else:
                q = args[1]
                cplx = q.is_complex()
                per_part = (2 * pts.element_size() + q.element_size()
                            + (2 * pts.element_size() if dipole else 0))
                written = (centers.shape[1] * (order + 1)
                           * (1 if cplx else 2) * q.element_size())
                per = 4 + (16 if cplx else 12) * order
                if dipole:
                    per += 2 + 10 * order
            out[name] = dict(
                type=typ, particles=npart, rows=int(rows.numel()),
                flops=per * npart,
                bytes=(npart * per_part + int(rows.numel()) * per_row
                       + nbytes(rows) + written))
    return out


def direct_sum_log2d(sources, charges, targets, chunk=1 << 15):
    """sum_s q_s log |t - s| over all sources, r = 0 skipped, in
    float64."""
    import torch
    out = torch.zeros(targets.shape[1], dtype=torch.float64,
                      device=targets.device)
    for c0 in range(0, sources.shape[1], chunk):
        d = targets[:, :, None] - sources[:, None, c0:c0 + chunk]
        r2 = (d * d).sum(0)
        ok = r2 > 0
        g = torch.where(ok, 0.5 * torch.log(torch.where(ok, r2, 1.0)), 0.0)
        out += g @ charges[c0:c0 + chunk]
    return out


def laplace2d_dipole_points(nsources, ntargets, seed):
    """The 2D double layer's inputs: *nsources* points on the five-armed
    starfish ``r(theta) = 1 + 0.25 cos 5 theta`` (meshmode's
    ``NArmedStarfish(5, 0.25)``) at angles uniform from *seed*, their unit
    outward normals as dipoles, *ntargets* targets uniform in [-1.5,
    1.5]^2 and standard-normal weights, all float64 numpy arrays from one
    stream: ``(sources, normals, targets, weights)``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.0, 2 * np.pi, nsources)
    r, dr = 1 + 0.25 * np.cos(5 * th), -1.25 * np.sin(5 * th)
    tx = dr * np.cos(th) - r * np.sin(th)
    ty = dr * np.sin(th) + r * np.cos(th)
    nrm = np.stack([ty, -tx]) / np.hypot(tx, ty)
    src = np.stack([r * np.cos(th), r * np.sin(th)])
    tgt = rng.uniform(-1.5, 1.5, (2, ntargets))
    return src, nrm, tgt, rng.standard_normal(nsources)


def direct_sum_dipole2d(sources, dipoles, charges, targets, chunk=1 << 15):
    """sum_s q_s d_s . (s - t) / |t - s|^2 over all sources, r = 0
    skipped, in float64."""
    import torch
    out = torch.zeros(targets.shape[1], dtype=torch.float64,
                      device=targets.device)
    for c0 in range(0, sources.shape[1], chunk):
        d = sources[:, None, c0:c0 + chunk] - targets[:, :, None]
        r2 = (d * d).sum(0)
        ok = r2 > 0
        g = torch.where(ok, (dipoles[:, None, c0:c0 + chunk] * d).sum(0)
                        / torch.where(ok, r2, 1.0), 0.0)
        out += g @ charges[c0:c0 + chunk]
    return out


def run_laplace2d(device, card, trav_trees, translation, n_kernels=100_000,
                  n_main=1_000_000, order=20, nsample=2000, seed=20,
                  stability_order=35):
    """K19-K21 against their twins at 1e5 points on every entry point,
    then the 2D Laplace FMM at 1e6 clustered points, complex128 and
    float64 pairs on one tree (K1, K19-K21), the order-35 line, and
    K19-K21 against their twins at the path's shapes; returns the K19-K21
    summary entries (the complex128 entry points')."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import (
        ConstantOneExpansionWrangler,
        make_laplace_wrangler,
    )
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal
    from boxtree_torch.tree.containers import box_flags_enum

    t_phases = time.perf_counter()
    entries = {"c128": dict(pairs=False),
               "f64": dict(pairs=True, dtype=torch.float64),
               "f32": dict(pairs=True, dtype=torch.float32)}

    # {{{ kernels vs twins at 1e5 points, every entry point

    pts_np, q_np = laplace2d_points(n_kernels, seed + 1)
    pts = torch.as_tensor(pts_np, device=device)
    # complex charges for the complex128 entry points, their real part for
    # the pairs
    qc = torch.as_tensor(q_np + 1j * np.random.default_rng(
        seed + 3).standard_normal(n_kernels), device=device)
    # standard-normal dipoles for K39, K41 and K42
    dip = torch.as_tensor(np.random.default_rng(seed + 4).standard_normal(
        (2, n_kernels)), device=device)
    tree = build_tree(pts, max_particles_in_box=20)
    trav = build_traversal(tree)
    small = {}
    for name, kw in entries.items():
        wr = make_laplace_wrangler(trav, order, rscale="auto", **kw)
        wd = make_laplace_wrangler(trav, order, rscale="auto",
                                   dipole_vec=dip, **kw)
        if wr._l3_csr is None or not wr._l4_csr[2].numel():
            raise AssertionError(f"Lists 3 and 4 empty at {n_kernels} "
                                 "points")
        q = wr.reorder_sources(qc if name == "c128" else qc.real)
        small[name] = check_list_kernels(
            {**laplace2d_inputs(trav, wr, q),
             **laplace2d_inputs(trav, wd, q, LAPLACE2D_DIPOLE_ONLY)},
            device, plain_reps=5, rtol=LAPLACE2D_KERNEL_RTOL[name])
    emit({"phase": "kernels_laplace2d_small", "card": card,
          "points": n_kernels, "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "order": order, "rscale": "auto",
          "charges": "complex normal (c128), their real part (pairs)",
          "dipoles": "standard normal (K39, K41, K42)",
          "tolerance_rel_linf": LAPLACE2D_KERNEL_RTOL,
          "p2l_p2m_rel": "per coefficient", "kernels": small})
    del tree, trav, wr, wd

    # }}}

    # {{{ the path: both 2D Laplace FMMs at 1e6, every kernel counted

    pts_np, q_np = laplace2d_points(n_main, seed)
    pts = torch.as_tensor(pts_np, device=device)
    q = torch.as_tensor(q_np, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(pts, max_particles_in_box=20),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    wc, t_setup_c, table_c = laplace_setup(lambda: make_laplace_wrangler(
        trav, order, pairs=False, rscale="auto"), device)
    before = kernels.launch_counts()
    pot_c, t_fmm_c = timed(lambda: drive_fmm(wc, [q]), device)
    per_fmm = {"complex128": launches_since(before)}
    wp, t_setup_p, table_p = laplace_setup(lambda: make_laplace_wrangler(
        trav, order, pairs=True, rscale="auto"), device)
    before = kernels.launch_counts()
    pot_p, t_fmm_p = timed(lambda: drive_fmm(wp, [q]), device)
    per_fmm["float64_pairs"] = launches_since(before)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    stages_c, stages_p = {}, {}
    _, t_warm_c = timed(lambda: drive_fmm(wc, [q], timing_data=stages_c),
                        device)
    _, t_warm_p = timed(lambda: drive_fmm(wp, [q], timing_data=stages_p),
                        device)
    pot1, t_count = timed(lambda: drive_fmm(
        ConstantOneExpansionWrangler(None, trav),
        [torch.ones(n_main, dtype=torch.float64, device=device)]), device)
    nbad = int((pot1 != n_main).sum())
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n_main, nsample, replace=False), device=device)
    ref = direct_sum_log2d(pts, q, pts[:, sample])
    abs_c, rel_c = rel_linf(pot_c.real[sample], ref)
    abs_p, rel_p = rel_linf(pot_p[sample], ref)
    _, rel_pc = rel_linf(pot_p, pot_c.real)
    finite = bool(torch.isfinite(pot_c).all()
                  and torch.isfinite(pot_p).all())
    emit({"phase": "laplace2d_fmm", "card": card, "points": n_main,
          "distribution": "unit square, 24 % in [0.45, 0.55]^2",
          "seed": seed, "charges": "real normal", "order": order,
          "rscale": "auto", "max_particles_in_box": 20,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "nleaves": int(((tree.box_flags & box_flags_enum.IS_LEAF_BOX)
                          != 0).sum()),
          "rscale_min": float(wc._rscale_np.min()),
          "build_s": t_tree, "traversal_s": t_trav,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "wrangler_setup_s": {"complex128": t_setup_c,
                               "float64_pairs": t_setup_p},
          "fmm_s": {"complex128": t_fmm_c, "float64_pairs": t_fmm_p},
          "fmm_warm_s": {"complex128": t_warm_c, "float64_pairs": t_warm_p},
          "total_s": t_total,
          "stage_s": {"complex128": stages_c, "float64_pairs": stages_p},
          "host_reads_per_fmm": {"complex128": fmm_host_reads(wc, q),
                                 "float64_pairs": fmm_host_reads(wp, q)},
          "counting_fmm_s": t_count, "counting_exact": nbad == 0,
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l1_particle_pairs": list1_pairs(
                  tree.box_target_counts_nonchild,
                  tree.box_source_counts_nonchild, trav.target_boxes,
                  trav.neighbor_source_boxes_starts,
                  trav.neighbor_source_boxes_lists),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "sampled_targets": nsample,
          "rel_linf_vs_f64_direct": {"complex128": rel_c,
                                     "float64_pairs": rel_p},
          "abs_linf": {"complex128": abs_c, "float64_pairs": abs_p},
          "pairs_vs_complex_rel_linf": rel_pc, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    if not finite or tuple(pot_c.shape) != (n_main,) \
            or pot_c.dtype != torch.complex128 \
            or tuple(pot_p.shape) != (n_main,) \
            or pot_p.dtype != torch.float64:
        raise AssertionError("2D Laplace FMM: non-finite or misshapen "
                             "output")
    if nbad:
        raise AssertionError(f"2D counting FMM: {nbad} potentials != "
                             f"{n_main}")
    for name, rel in (("complex128", rel_c), ("float64 pairs", rel_p)):
        if not rel < LAPLACE2D_FMM_RTOL:
            raise AssertionError(f"2D Laplace FMM ({name}): rel l-inf "
                                 f"{rel:.3e} >= {LAPLACE2D_FMM_RTOL}")
    if not rel_pc <= LAPLACE2D_PAIRS_RTOL:
        raise AssertionError(f"2D Laplace pairs vs complex: rel l-inf "
                             f"{rel_pc:.3e} > {LAPLACE2D_PAIRS_RTOL}")
    emit({"phase": "launches", "path": "laplace2d_fmm", "card": card,
          "launches": launches,
          "p2m_l2p_per_fmm": {name: {k: c[k] for k in LAPLACE2D_P2M_L2P}
                              for name, c in per_fmm.items()}})
    missing = [name for name in LAPLACE2D_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the 2D Laplace "
                             f"path: {missing}")
    for name, counts in per_fmm.items():
        check_once_per_fmm(counts, f"2D Laplace FMM {name}",
                           LAPLACE2D_P2M_L2P)
    check_m2l_table(card, device, "laplace2d", "c128", wc, t_setup_c,
                    table_c)
    check_m2l_table(card, device, "laplace2d", "f64", wp, t_setup_p,
                    table_p)
    check_translation(card, device, "laplace2d",
                      [("c128", wc, q), ("f64", wp, q)], translation)

    # }}}

    # {{{ the order-35 line (tests/test_stability.py:28-65)

    line = np.array([2.0 ** -i for i in range(15)])
    line = np.hstack([line, 3 - line])
    src_np = np.vstack([line, np.zeros(30)])
    tgt_np = src_np * (1 + 1e-3)
    d = src_np[:, None, :] - tgt_np[:, :, None]
    ref_line = 0.5 * np.log((d * d).sum(0)) @ np.ones(30)
    tree_l = build_tree(torch.as_tensor(src_np, device=device),
                        targets=torch.as_tensor(tgt_np, device=device),
                        max_particles_in_box=2)
    trav_l = build_traversal(tree_l)
    stab = {}
    for name, pairs in (("complex128", False), ("float64_pairs", True)):
        w = make_laplace_wrangler(trav_l, stability_order, pairs=pairs,
                                  rscale="auto")
        before = kernels.launch_counts()
        pot = drive_fmm(w, [torch.ones(30, dtype=torch.float64,
                                       device=device)]).real.cpu().numpy()
        counts = launches_since(before)
        check_once_per_fmm(counts, f"2D Laplace order-35 line {name}",
                           LAPLACE2D_P2M_L2P)
        stab[name] = dict(
            nan=bool(np.isnan(pot).any()), coefficients=w.ncoeff,
            launches={k: counts[k] for k in LAPLACE2D_P2M_L2P},
            rel_linf_vs_direct=float(np.abs(pot - ref_line).max()
                                     / np.abs(ref_line).max()))
    emit({"phase": "laplace2d_stability", "card": card, "points": 30,
          "order": stability_order, "rscale": "auto",
          "nlevels": tree_l.nlevels, "bound": LAPLACE2D_STABILITY_RTOL,
          "results": stab})
    if tree_l.nlevels < 15:
        raise AssertionError(f"the line tree has {tree_l.nlevels} levels")
    for name, r in stab.items():
        if r["nan"] or not (r["rel_linf_vs_direct"]
                            < LAPLACE2D_STABILITY_RTOL):
            raise AssertionError(f"2D Laplace order-35 line ({name}): {r}")

    # }}}

    # the kernels against their twins at the path's own shapes
    res, work = {}, {}
    for name, w in (("c128", wc), ("f64", wp)):
        inputs = laplace2d_inputs(trav, w, w.reorder_sources(q))
        work[name] = laplace2d_work(inputs)
        res[name] = check_list_kernels(inputs, device, plain_reps=3,
                                       rtol=LAPLACE2D_KERNEL_RTOL[name])
        for kname, r in res[name].items():
            r["bound_ms"], r["bound_by"] = bound(work[name][kname])
    emit({"phase": "kernels_laplace2d", "card": card, "points": n_main,
          "order": order, "tolerance_rel_linf": LAPLACE2D_KERNEL_RTOL,
          "p2l_p2m_rel": "per coefficient", "kernels": res,
          "launches": {name: launches[name] for name in res["c128"]},
          "work": work,
          "laplace2d_phases_s": time.perf_counter() - t_phases})
    check_traversal_kernels(tree, device, card, "2D Laplace", trav_trees)
    return [summary_entry(name, launches[name], res["c128"][name],
                          work["c128"][name]) for name in res["c128"]]


def launches_since(before):
    """The kernels' launches since the counts *before*."""
    from boxtree_torch.ops import kernels
    return {k: n - before[k] for k, n in kernels.launch_counts().items()}


def check_once_per_fmm(counts, path, names):
    """An FMM launched each of the kernels *names* exactly once: the twins
    and ``torch.func.jvp`` launch nothing."""
    got = {k: counts[k] for k in names}
    if got != dict.fromkeys(names, 1):
        raise AssertionError(f"{path}: launches {got}, expected one each")


def run_laplace2d_dipole(device, card, tree_trees, n_main=1_000_000,
                         n_targets=200_000, order=20, nsample=2000, seed=22):
    """The 2D Laplace double layer at full width: 1e6 starfish sources
    (:func:`laplace2d_dipole_points`) with their normals as dipoles and
    real normal weights, 2e5 targets in [-1.5, 1.5]^2, one tree, the
    complex128, float64 pairs and float32 pairs FMMs (order 20,
    ``rscale="auto"``, 20 a box) against a float64 direct sum at 2,000
    sampled targets and each other; then K39-K42 against their twins at
    the path's shapes.  Returns the K39, K41 and K42 summary entries (the
    complex128 entry points', the float64 pairs' beside them)."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_laplace_wrangler
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    t_phase = time.perf_counter()
    src, nrm, tgt, q = (torch.as_tensor(a, device=device)
                        for a in laplace2d_dipole_points(n_main, n_targets,
                                                         seed))
    runs = {"complex128": dict(pairs=False),
            "float64_pairs": dict(pairs=True, dtype=torch.float64),
            "float32_pairs": dict(pairs=True, dtype=torch.float32)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(src, targets=tgt,
                                            max_particles_in_box=20),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    ws, pots, t_setup, t_fmm, per_fmm = {}, {}, {}, {}, {}
    tables = {}
    for name, kw in runs.items():
        ws[name], t_setup[name], tables[name] = laplace_setup(
            lambda: make_laplace_wrangler(trav, order, rscale="auto",
                                          dipole_vec=nrm, **kw), device)
        before = kernels.launch_counts()
        pots[name], t_fmm[name] = timed(lambda: drive_fmm(ws[name], [q]),
                                        device)
        per_fmm[name] = launches_since(before)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    stages, t_warm = {}, {}
    for name, w in ws.items():
        stages[name] = {}
        _, t_warm[name] = timed(lambda: drive_fmm(
            w, [q], timing_data=stages[name]), device)
    build_reads = build_host_reads(lambda: build_tree(
        src, targets=tgt, max_particles_in_box=20), tree, launches)
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n_targets, nsample, replace=False), device=device)
    ref = direct_sum_dipole2d(src, nrm, q, tgt[:, sample])
    rel, abs_err = {}, {}
    for name, pot in pots.items():
        abs_err[name], rel[name] = rel_linf(pot.real[sample], ref)
    _, rel_pc = rel_linf(pots["float64_pairs"], pots["complex128"].real)
    finite = all(bool(torch.isfinite(p).all()) for p in pots.values())
    emit({"phase": "laplace2d_dipole_fmm", "card": card, "sources": n_main,
          "targets": n_targets,
          "distribution": "sources on the starfish r = 1 + 0.25 cos 5 theta,"
                          " targets uniform in [-1.5, 1.5]^2", "seed": seed,
          "weights": "real normal", "dipoles": "unit outward normals",
          "order": order, "rscale": "auto", "max_particles_in_box": 20,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "build_s": t_tree, "traversal_s": t_trav,
          "wrangler_setup_s": t_setup, "fmm_s": t_fmm, "fmm_warm_s": t_warm,
          "total_s": t_total, "stage_s": stages,
          **build_reads,
          "host_reads_per_fmm": {name: fmm_host_reads(w, q)
                                 for name, w in ws.items()},
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l1_particle_pairs": l1_pairs(
                  tree.box_target_counts_nonchild,
                  tree.box_source_counts_nonchild, trav.target_boxes,
                  trav.neighbor_source_boxes_starts,
                  trav.neighbor_source_boxes_lists),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "sampled_targets": nsample,
          "rel_linf_vs_f64_direct": rel, "abs_linf": abs_err,
          "bounds": LAPLACE2D_DIPOLE_RTOL,
          "pairs_vs_complex_rel_linf": rel_pc, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    for name, pot in pots.items():
        dt = {"complex128": torch.complex128, "float64_pairs": torch.float64,
              "float32_pairs": torch.float32}[name]
        if tuple(pot.shape) != (n_targets,) or pot.dtype != dt:
            raise AssertionError(f"2D double layer ({name}): misshapen "
                                 "output")
    if not finite:
        raise AssertionError("2D double layer: non-finite output")
    for name, r in rel.items():
        if not r < LAPLACE2D_DIPOLE_RTOL[name]:
            raise AssertionError(f"2D double layer ({name}): rel l-inf "
                                 f"{r:.3e} >= {LAPLACE2D_DIPOLE_RTOL[name]}")
    if not rel_pc <= LAPLACE2D_PAIRS_RTOL:
        raise AssertionError(f"2D double layer pairs vs complex: rel l-inf "
                             f"{rel_pc:.3e} > {LAPLACE2D_PAIRS_RTOL}")
    emit({"phase": "launches", "path": "laplace2d_dipole_fmm", "card": card,
          "launches": launches,
          "per_fmm": {name: {k: c[k] for k in (
              *LAPLACE2D_DIPOLE_FMM, "m2m_translate", "l2l_translate",
              "p2m_laplace2d", "p2p_laplace2d", "p2l_laplace2d")}
              for name, c in per_fmm.items()}})
    missing = [k for k in LAPLACE2D_DIPOLE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the 2D double "
                             f"layer: {missing}")
    for name, w in ws.items():
        check_m2l_table(card, device, "laplace2d double layer", name, w,
                        t_setup[name], tables[name])
    for name, counts in per_fmm.items():
        check_once_per_fmm(counts, f"2D double layer {name}",
                           LAPLACE2D_DIPOLE_FMM)
        charge = {k: counts[k] for k in ("p2m_laplace2d", "p2p_laplace2d",
                                         "p2l_laplace2d") if counts[k]}
        if charge:
            raise AssertionError(f"2D double layer {name}: charge kernels "
                                 f"launched {charge}")

    # K39-K42 against their twins at the path's own shapes
    names = ("p2m_laplace2d_dipole", "p2p_laplace2d_dipole",
             "p2l_laplace2d_dipole", "l2p_laplace2d")
    res, work = {}, {}
    for key, name in (("c128", "complex128"), ("f64", "float64_pairs")):
        w = ws[name]
        inputs = laplace2d_inputs(trav, w, w.reorder_sources(q), names)
        work[key] = laplace2d_work(inputs)
        res[key] = check_list_kernels(inputs, device, plain_reps=3,
                                      rtol=LAPLACE2D_KERNEL_RTOL[key],
                                      slow_s=0.5)
        for kname, r in res[key].items():
            r["bound_ms"], r["bound_by"] = bound(work[key][kname])
    emit({"phase": "kernels_laplace2d_dipole", "card": card,
          "sources": n_main, "targets": n_targets, "order": order,
          "tolerance_rel_linf": LAPLACE2D_KERNEL_RTOL,
          "p2l_p2m_rel": "per coefficient", "kernels": res,
          "launches": {k: launches[k] for k in names}, "work": work,
          "laplace2d_dipole_phases_s": time.perf_counter() - t_phase})
    check_tree_kernels(card, device, "2D double layer", src,
                       dict(targets=tgt, max_particles_in_box=20),
                       tree_trees)
    out = {}
    for name in names:
        entry = summary_entry(name, launches[name], res["c128"][name],
                              work["c128"][name])
        entry["entry_point"] = "c128"
        entry["f64"] = entry_point_numbers(launches[name], res["f64"][name],
                                           work["f64"][name])
        out[name] = entry
    return out

# }}}


# {{{ K28-K30: P2M and L2P of the 3D Laplace wranglers

def fmm_locals(w, q_tree):
    """The local expansions that ``drive_fmm`` hands to L2P: the stages
    up to L2L on the wrangler's traversal, as ``boxtree_torch.fmm.drive``
    calls them."""
    trav = w.traversal
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [q_tree]))
    lsb, totp = (trav.level_start_target_or_target_parent_box_nrs,
                 trav.target_or_target_parent_boxes)
    loc = w.multipole_to_local(lsb, totp, trav.from_sep_siblings_starts,
                               trav.from_sep_siblings_lists, mp)
    loc = w.form_locals(lsb, totp, trav.from_sep_bigger_starts,
                        trav.from_sep_bigger_lists, [q_tree], loc)
    return w.refine_locals(lsb, totp, loc)


def p2m_l2p_inputs(w, q_tree, names):
    """K28, K29 or K30's wrapper, plain twin and arguments at the shapes
    the 3D Laplace FMM of wrangler *w* gives them (K30 the masked locals
    of this FMM)."""
    from boxtree_torch.ops import laplace3d

    tree = w.tree
    src_rows = (tree.box_source_starts, tree.box_source_counts_nonchild,
                w._source_rows, w.centers, w.box_scale, w.order)
    out = {}
    for name in names:
        if name == "p2m_laplace3d":
            args = (w._sources, q_tree, *src_rows)
        elif name == "p2m_laplace3d_dipole":
            args = (w._sources, q_tree, w.dipole_vec, *src_rows)
        else:
            args = (w._targets, tree.box_target_starts,
                    tree.box_target_counts_nonchild, w._target_rows,
                    w._mask_levels(fmm_locals(w, q_tree)).contiguous(),
                    w.centers, w.box_scale, w.order)
        out[name] = (getattr(laplace3d, name),
                     getattr(laplace3d, f"{name}_plain"), args)
    return out


def p2m_l2p_work(inputs):
    """Bytes K28-K30 must move and the float operations they must do at
    *inputs*: each particle of the rows once (3 coordinates, its charge
    and 3 dipole components, or its potential written), each row box's
    range, centre and scale once, K30's local rows read once, K28 / K29's
    whole multipole array written once; per particle a multiply-add per
    real coefficient of the pairs (2 each), a complex one per complex
    coefficient (8 each), for K29 each coefficient's tangent by the
    charge; the recurrences and their tangents not counted."""
    import torch

    from boxtree_torch.ops.solid_harmonics import ncoeffs

    out = {}
    for name, (_, _, args) in inputs.items():
        pts, order = args[0], args[-1]
        centers, scale = args[-3], args[-2]
        starts, counts, rows = (args[1:4] if name == "l2p_laplace3d"
                                else args[-6:-3])
        cplx = (args[4] if name == "l2p_laplace3d" else args[1]).is_complex()
        npart = int(counts.to(torch.int64)[rows.to(torch.int64)].sum())
        per_row = (starts.element_size() + counts.element_size()
                   + centers.shape[0] * centers.element_size()
                   + scale.element_size())
        if name == "l2p_laplace3d":
            loc = args[4]
            per_part = 3 * pts.element_size() + loc.element_size()
            per_row += loc.shape[1] * loc.element_size()
            written = 0
        else:
            q = args[1]
            per_part = 3 * pts.element_size() + q.element_size()
            if name == "p2m_laplace3d_dipole":
                per_part += 3 * pts.element_size()
            written = (centers.shape[1] * ncoeffs(order)
                       * (1 if cplx else 2) * q.element_size())
        per = 8 * ncoeffs(order) if cplx else 4 * ncoeffs(order)
        out[name] = dict(
            type=str(pts.dtype).removeprefix("torch."), particles=npart,
            rows=int(rows.numel()), flops=per * npart,
            bytes=(npart * per_part + int(rows.numel()) * per_row
                   + nbytes(rows) + written))
    return out


def check_p2m_l2p(card, device, path, cases, slow_s=0.2):
    """K28-K30 against their twins at a path's inputs: *cases* is
    ``[(entry point, wrangler, tree-order charges, names)]``; raises on a
    mismatch, emits a ``kernels_p2m_l2p`` line and returns ``(results,
    work)`` by entry point, each result with its bound.  A twin whose
    first call takes more than *slow_s* seconds (K29's, the JVP, at the
    double layer's 1e6 sources) is timed by that call alone."""
    res, work = {}, {}
    for key, w, q_tree, names in cases:
        inputs = p2m_l2p_inputs(w, q_tree, names)
        work.setdefault(key, {}).update(p2m_l2p_work(inputs))
        res.setdefault(key, {}).update(check_list_kernels(
            inputs, device, plain_reps=3,
            rtol=LAPLACE3D_KERNEL_RTOL[key], slow_s=slow_s))
        for name in names:
            r = res[key][name]
            r["bound_ms"], r["bound_by"] = bound(work[key][name])
    emit({"phase": "kernels_p2m_l2p", "card": card, "path": path,
          "tolerance_rel_linf": {k: LAPLACE3D_KERNEL_RTOL[k] for k in res},
          "p2m_rel": "per box row", "kernels": res, "work": work})
    return res, work


def check_p2m_l2p_launches(launches, path, fmms, dipole_fmms=0):
    """Each 3D Laplace FMM of a path launches K28 (K29 with dipoles) and
    K30 exactly once: the twins and ``torch.func.jvp`` launch nothing."""
    want = {"p2m_laplace3d": fmms - dipole_fmms,
            "p2m_laplace3d_dipole": dipole_fmms, "l2p_laplace3d": fmms}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{path}: K28-K30 launches {got}, expected "
                             f"{want}")

# }}}


# {{{ the 3D Laplace double-layer FMM (K2-K4 complex128, K22, K23)

def laplace3d_points(nsources, ntargets, seed):
    """``tests/test_laplace.py:113-134``'s double layer at *nsources*:
    sources on the unit sphere from Config B's generator
    (:func:`sphere_points`) with seed *seed*, their outward unit normals
    as dipoles; *ntargets* uniform targets in [-1, 1]^3 and standard-normal
    weights from the next seed's stream."""
    import numpy as np
    src = sphere_points(nsources, seed)
    rng = np.random.default_rng(seed + 1)
    return src, rng.random((3, ntargets)) * 2 - 1, \
        rng.standard_normal(nsources)


def laplace3d_inputs(trav, wrangler, q_tree, names=None):
    """K2-K4, K22 and K23's wrappers, plain twins and arguments at the
    shapes the 3D Laplace FMM of *wrangler* (complex128 or pairs, with
    dipoles) gives them; *names* picks some."""
    from boxtree_torch.ops import laplace3d

    w = wrangler
    tree = trav.tree
    l1 = (tree.box_target_starts, tree.box_target_counts_nonchild,
          tree.box_source_starts, tree.box_source_counts_nonchild,
          trav.target_boxes, trav.neighbor_source_boxes_starts,
          trav.neighbor_source_boxes_lists)
    l4 = (tree.box_source_starts, tree.box_source_counts_nonchild,
          *w._l4_csr, w.centers, w.box_scale, w.order)
    names = names or ("p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d",
                      "p2p_laplace3d_dipole", "p2l_laplace3d_dipole")
    out = {}
    for name in names:
        if name == "p2p_laplace3d":
            args = (w._targets, w._sources, q_tree, *l1)
        elif name == "p2p_laplace3d_dipole":
            args = (w._targets, w._sources, q_tree, w.dipole_vec, *l1)
        elif name == "m2p_laplace3d":
            mp = w.coarsen_multipoles(None, None, w.form_multipoles(
                None, None, [q_tree]))
            args = (w._targets, tree.box_target_starts,
                    tree.box_target_counts_nonchild, *w._l3_csr, mp,
                    w.centers, w.box_scale, w.order)
        elif name == "p2l_laplace3d":
            args = (w._sources, q_tree, *l4)
        else:
            args = (w._sources, q_tree, w.dipole_vec, *l4)
        kernel = getattr(laplace3d, name)
        plain = getattr(laplace3d, f"{name}_plain")
        if name.startswith("p2l_"):
            out[name] = (
                lambda *a, k=kernel: k(*a, w.local_expansion_zeros()),
                lambda *a, k=plain: k(*a, w.local_expansion_zeros()), args)
        else:
            out[name] = (kernel, plain, args)
    return out


def laplace3d_work(inputs):
    """Bytes K2-K4, K22 and K23 must move (:func:`p2p_bytes` and its kin,
    on this run's lists) and the float operations they must do, at
    *inputs*, for the entry point the inputs take (complex128, or real
    pairs of the points' type); the counts of :func:`kernel_work` for K2-K4,
    with complex charges and coefficients:

    - K2, per List-1 particle pair with ``r > 0``: 10, 12 with complex
      charges (rsqrt not counted); K22 18 (the dot with the dipole 5, the
      cube of ``1/r`` 2, times it 1), 20 with complex charges.
    - K3, per (target particle, List-3 source box) pair: a multiply-add per
      real coefficient of the pairs (2 each), a complex one per complex
      coefficient (8 each); the recurrence not counted.
    - K4 and K23, per (List-4 source particle, target box) pair: the same
      per coefficient (for K23, each coefficient's tangent by the charge);
      the recurrence and its tangent not counted.
    """
    import torch

    from boxtree_torch.ops.solid_harmonics import ncoeffs
    from boxtree_torch.traversal.containers import csr_rows

    out = {}
    for name, (_, _, args) in inputs.items():
        # the charges, or the multipoles
        cplx = args[{"m2p_laplace3d": 6}.get(
            name, 2 if name.startswith("p2p_") else 1)].is_complex()
        typ = str(args[0].dtype).removeprefix("torch.")
        if name.startswith("p2p_"):
            tgt, src, q = args[:3]
            rest = args[-7:]
            pairs = l1_pairs(rest[1], rest[3], *rest[4:])
            per = (18 if "dipole" in name else 10) + (2 if cplx else 0)
            nb = p2p_bytes(tgt, src, q, *rest, q.element_size())
            if "dipole" in name:
                sboxes = _boxes(rest[6])
                nb += int(rest[3][sboxes].sum()) * 3 * src.element_size()
            out[name] = dict(type=typ, particle_pairs=pairs,
                             flops=per * pairs, bytes=nb)
            continue
        order = args[-1]
        per = 8 * ncoeffs(order) if cplx else 4 * ncoeffs(order)
        if name == "m2p_laplace3d":
            (tgt, tst, tcn, rows, st, ls, mp, centers, scale, _) = args
            pairs = int(tcn.to(torch.int64)[rows.to(torch.int64)[
                csr_rows(st, ls.shape[0])]].sum())
            out[name] = dict(
                type=typ, target_box_pairs=pairs, flops=per * pairs,
                bytes=m2p_bytes(tgt, tst, tcn, rows, st, ls, mp, centers,
                                scale, mp.element_size()))
            continue
        src, q = args[:2]
        sst, scn, rows, st, ls, centers, scale = args[-8:-1]
        pairs = int(scn.to(torch.int64)[ls.to(torch.int64)].sum())
        nb = p2l_bytes(src, q, sst, scn, rows, st, ls, centers, scale,
                       2 * ncoeffs(order) * src.element_size())
        if "dipole" in name:
            nb += int(scn[_boxes(ls)].sum()) * 3 * src.element_size()
        out[name] = dict(type=typ, source_box_pairs=pairs,
                         flops=per * pairs, bytes=nb)
    return out


def direct_sum_dipole_f64(sources, dipoles, charges, targets,
                          chunk=1 << 14):
    """sum_s q_s d_s . (t - s) / |t - s|^3 over all sources, r = 0 skipped,
    in float64."""
    import torch
    out = torch.zeros(targets.shape[1], dtype=torch.float64,
                      device=targets.device)
    for c0 in range(0, sources.shape[1], chunk):
        d = targets[:, :, None] - sources[:, None, c0:c0 + chunk]
        r2 = (d * d).sum(0)
        ok = r2 > 0
        g = torch.where(ok, (dipoles[:, None, c0:c0 + chunk] * d).sum(0)
                        * torch.where(ok, r2, 1.0) ** -1.5, 0.0)
        out += g @ charges[c0:c0 + chunk]
    return out


def run_laplace3d(device, card, translation, n_kernels=100_000,
                  n_main=1_000_000,
                  n_targets=200_000, order=12, nsample=2000, seed=15):
    """K2-K4's complex128 entry points, K22 and K23 against their twins at
    1e5 sphere points on every entry point; then the 3D Laplace double
    layer at 1e6 sphere points and 2e5 targets (K1, K2-K4 complex128, K22,
    K23): the complex128 and the float64 pairs wranglers with dipoles and
    the pairs with ``level_to_order`` on one tree, and the complex128
    single layer; then the kernels against their twins at the path's
    shapes, and K28-K30 likewise.  Returns ``{kernel: (launches, result,
    work, float64 result, float64 work)}`` of the complex128 entry points,
    with the float64 pairs' K22, K23, K29 and K30 results (else None)."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_laplace_wrangler
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    t_phases = time.perf_counter()
    entries = {"c128": dict(pairs=False),
               "f64": dict(pairs=True, dtype=torch.float64),
               "f32": dict(pairs=True, dtype=torch.float32)}

    # {{{ kernels vs twins at 1e5 sources, every entry point

    src_np, tgt_np, w_np = laplace3d_points(n_kernels, n_kernels // 5,
                                            seed + 10)
    src = torch.as_tensor(src_np, device=device)
    tgt = torch.as_tensor(tgt_np, device=device)
    qc = torch.as_tensor(w_np + 1j * np.random.default_rng(
        seed + 12).standard_normal(n_kernels), device=device)
    tree = build_tree(src, targets=tgt, max_particles_in_box=30)
    trav = build_traversal(tree)
    small = {}
    for name, kw in entries.items():
        wr = make_laplace_wrangler(trav, order, rscale="auto",
                                   dipole_vec=src, **kw)
        if wr._l3_csr is None or not wr._l4_csr[2].numel():
            raise AssertionError(f"Lists 3 and 4 empty at {n_kernels} "
                                 "sources")
        q = wr.reorder_sources(qc if name == "c128" else qc.real)
        small[name] = check_list_kernels(
            laplace3d_inputs(trav, wr, q), device, plain_reps=3,
            rtol=LAPLACE3D_KERNEL_RTOL[name], slow_s=3.0)
    emit({"phase": "kernels_laplace3d_small", "card": card,
          "sources": n_kernels, "targets": n_kernels // 5,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels, "order": order,
          "rscale": "auto",
          "charges": "complex normal (c128), their real part (pairs)",
          "dipoles": "outward unit normals",
          "tolerance_rel_linf": LAPLACE3D_KERNEL_RTOL,
          "p2l_rel": "per coefficient", "kernels": small})
    del tree, trav, wr

    # }}}

    # {{{ the path: the double layer at 1e6, every kernel counted

    src_np, tgt_np, w_np = laplace3d_points(n_main, n_targets, seed)
    src = torch.as_tensor(src_np, device=device)
    tgt = torch.as_tensor(tgt_np, device=device)
    q = torch.as_tensor(w_np, device=device)
    l2o = lambda lev: order - min(lev, 4)  # noqa: E731
    runs = {"complex128": dict(order=order, pairs=False, dipole_vec=src),
            "float64_pairs": dict(order=order, pairs=True, dipole_vec=src),
            "float64_pairs_level_to_order": dict(
                level_to_order=l2o, pairs=True, dipole_vec=src),
            "complex128_single_layer": dict(order=order, pairs=False)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(src, targets=tgt,
                                            max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    ws, pots, t_setup, t_fmm, per_fmm = {}, {}, {}, {}, {}
    tables = {}
    for name, kw in runs.items():
        ws[name], t_setup[name], tables[name] = laplace_setup(
            lambda: make_laplace_wrangler(trav, rscale="auto", **kw), device)
        before = kernels.launch_counts()
        pots[name], t_fmm[name] = timed(lambda: drive_fmm(ws[name], [q]),
                                        device)
        per_fmm[name] = {k: n - before[k]
                         for k, n in kernels.launch_counts().items()}
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    stages, t_warm = {}, {}
    for name, w in ws.items():
        stages[name] = {}
        _, t_warm[name] = timed(lambda: drive_fmm(
            w, [q], timing_data=stages[name]), device)
    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n_targets, nsample, replace=False), device=device)
    ref_dl = direct_sum_dipole_f64(src, src, q, tgt[:, sample])
    ref_sl = direct_sum_f64(src, q, tgt[:, sample])
    rel, abs_err = {}, {}
    for name, pot in pots.items():
        abs_err[name], rel[name] = rel_linf(
            pot.real[sample], ref_sl if name.endswith("single_layer")
            else ref_dl)
    _, rel_pc = rel_linf(pots["float64_pairs"], pots["complex128"].real)
    finite = all(bool(torch.isfinite(p).all()) for p in pots.values())
    emit({"phase": "laplace3d_fmm", "card": card, "sources": n_main,
          "targets": n_targets,
          "distribution": "sources on the unit sphere, targets uniform in "
                          "[-1, 1]^3", "seed": seed,
          "weights": "real normal", "dipoles": "outward unit normals",
          "order": order, "level_to_order": "order - min(level, 4)",
          "rscale": "auto", "max_particles_in_box": 30,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "level_orders": [int(x) for x in
                           ws["float64_pairs_level_to_order"].level_orders],
          "build_s": t_tree, "traversal_s": t_trav,
          "traversal_plain_s": plain_traversal_s(tree, device),
          "wrangler_setup_s": t_setup, "fmm_s": t_fmm, "fmm_warm_s": t_warm,
          "total_s": t_total, "stage_s": stages,
          "host_reads_per_fmm": {name: fmm_host_reads(w, q)
                                 for name, w in ws.items()},
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l1_particle_pairs": l1_pairs(
                  tree.box_target_counts_nonchild,
                  tree.box_source_counts_nonchild, trav.target_boxes,
                  trav.neighbor_source_boxes_starts,
                  trav.neighbor_source_boxes_lists),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "sampled_targets": nsample,
          "rel_linf_vs_f64_direct": rel, "abs_linf": abs_err,
          "bounds": {"double_layer": LAPLACE3D_FMM_RTOL,
                     "level_to_order": LAPLACE3D_L2O_RTOL,
                     "pairs_vs_complex": LAPLACE3D_PAIRS_RTOL},
          "pairs_vs_complex_rel_linf": rel_pc, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    for name, pot in pots.items():
        dt = torch.complex128 if name.startswith("complex") \
            else torch.float64
        if tuple(pot.shape) != (n_targets,) or pot.dtype != dt:
            raise AssertionError(f"3D Laplace FMM ({name}): misshapen "
                                 "output")
    if not finite:
        raise AssertionError("3D Laplace FMM: non-finite output")
    for name, r in rel.items():
        bar = (LAPLACE3D_L2O_RTOL if name.endswith("level_to_order")
               else LAPLACE3D_FMM_RTOL)
        if not r < bar:
            raise AssertionError(f"3D Laplace FMM ({name}): rel l-inf "
                                 f"{r:.3e} >= {bar}")
    if not rel_pc <= LAPLACE3D_PAIRS_RTOL:
        raise AssertionError(f"3D Laplace pairs vs complex: rel l-inf "
                             f"{rel_pc:.3e} > {LAPLACE3D_PAIRS_RTOL}")
    emit({"phase": "launches", "path": "laplace3d_fmm", "card": card,
          "launches": launches,
          "p2m_l2p_per_fmm": {
              name: {k: c[k] for k in (*P2M_L2P_KERNELS,
                                       "p2m_laplace3d_dipole")}
              for name, c in per_fmm.items()}})
    missing = [name for name in LAPLACE3D_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the 3D Laplace "
                             f"path: {missing}")
    for name, counts in per_fmm.items():
        check_p2m_l2p_launches(counts, f"3D Laplace FMM {name}", 1,
                               int("dipole_vec" in runs[name]))
    check_translation(card, device, "double layer", [
        ("c128", ws["complex128"], q), ("f64", ws["float64_pairs"], q),
        ("f64_level_to_order", ws["float64_pairs_level_to_order"], q)],
        translation)
    for name, w in ws.items():
        check_m2l_table(card, device, "double layer", name, w,
                        t_setup[name], tables[name])
    run_rotation(device, card, "double layer", [
        (label, ws[name], dict(pairs=pairs, rscale="auto", dipole_vec=src),
         q, sample, ref_dl, LAPLACE3D_FMM_RTOL)
        for label, name, pairs in (("c128", "complex128", False),
                                   ("f64", "float64_pairs", True))])

    # }}}

    # the kernels against their twins at the path's own shapes: complex128
    # (K2-K4 from the single layer, K22 / K23 from the double layer), and
    # K22 / K23 on the float64 pairs
    res, work = {}, {}
    for key, w, names in (
            ("c128", ws["complex128_single_layer"],
             ("p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d")),
            ("c128_dipole", ws["complex128"],
             ("p2p_laplace3d_dipole", "p2l_laplace3d_dipole")),
            ("f64", ws["float64_pairs"],
             ("p2p_laplace3d_dipole", "p2l_laplace3d_dipole"))):
        inputs = laplace3d_inputs(trav, w, w.reorder_sources(q), names)
        work[key] = laplace3d_work(inputs)
        res[key] = check_list_kernels(
            inputs, device, plain_reps=3,
            rtol=LAPLACE3D_KERNEL_RTOL[key.split("_")[0]], slow_s=3.0)
        for kname, r in res[key].items():
            r["bound_ms"], r["bound_by"] = bound(work[key][kname])
    emit({"phase": "kernels_laplace3d", "card": card, "sources": n_main,
          "targets": n_targets, "order": order,
          "tolerance_rel_linf": LAPLACE3D_KERNEL_RTOL,
          "p2l_rel": "per coefficient", "kernels": res,
          "launches": {name: launches[name] for name in LAPLACE3D_KERNELS},
          "work": work,
          "laplace3d_phases_s": time.perf_counter() - t_phases})
    pres, pwork = check_p2m_l2p(card, device, "double layer", [
        ("c128", ws["complex128_single_layer"],
         ws["complex128_single_layer"].reorder_sources(q), P2M_L2P_KERNELS),
        ("c128", ws["complex128"], ws["complex128"].reorder_sources(q),
         ("p2m_laplace3d_dipole",)),
        ("f64", ws["float64_pairs"], ws["float64_pairs"].reorder_sources(q),
         ("p2m_laplace3d_dipole", "l2p_laplace3d"))])
    c128 = {**res["c128"], **res["c128_dipole"], **pres["c128"]}
    c128_work = {**work["c128"], **work["c128_dipole"], **pwork["c128"]}
    f64, f64_work = {**res["f64"], **pres["f64"]}, {**work["f64"],
                                                     **pwork["f64"]}
    return {name: (launches[name], r, c128_work[name], f64.get(name),
                   f64_work.get(name))
            for name, r in c128.items()}

# }}}


# {{{ K69-K74: the M2L tables; K75-K79: the rotation M2L

#: K69-K71 (3D) and K72-K74 (2D): one launch a Laplace wrangler setup
TABLE_KERNELS = ("m2l_table_3d", "m2l_table_2d")
#: per-operator rel l-inf bar of the tables against their twins: float64
#: steps in the twins' order (3D: each rounded as the twin rounds it; 2D:
#: CUDA's log / atan2 in M[0][0]); float32 the cast of those values
M2L_TABLE_RTOL = {"complex128": 1e-12, "float64": 1e-12, "float32": 1e-6}
#: the table kernels' numbers by kernel and "path layout" (summary)
M2L_TABLES = {}
#: K75 / K76 (List 2 classified) and K77-K79 (the rotation M2L)
ROTATION_KERNELS = ("m2l_classify_keys", "m2l_classify_unpack",
                    "m2l_rotate")
#: rel l-inf bar of K77-K79 against their twin over the locals (atomic
#: sums in another order)
ROTATION_RTOL = {"complex128": 1e-12, "float64": 1e-12, "float32": 1e-5}
#: rel l-inf bar of the rotation FMM against the dense FMM on the same
#: traversal: float64 / complex128 the reference's own
#: (tests/test_laplace.py:166-198); float32 set before the first chip run
#: from scripts/torch_rotation_accuracy.py on the CPU (1e5 main-path
#: points, order 8, seeds 17-19: at most 3.85e-7, each FMM 3.4e-5 to
#: 8.3e-5 from the float64 direct sum): 26 times that, for the card's
#: other summation order (K35's tiles, K77-K79's atomics)
ROTATION_VS_DENSE_RTOL = {"complex128": 1e-12, "float64": 1e-12,
                          "float32": 1e-5}
#: operator groups of the main path's (and the double layer's) rotation
#: M2L that its twin is held to: every k-th group, at most this many
ROTATION_TWIN_GROUPS = 64
#: the rotation kernels' numbers by "path layout" (summary)
ROTATION = {}


def _dt(dtype):
    return str(dtype).removeprefix("torch.")


def laplace_setup(make, device):
    """A Laplace wrangler from *make*, its setup seconds (synchronised)
    and the launches of K69-K74 in it."""
    from boxtree_torch.ops import kernels

    before = kernels.launch_counts()
    w, t = timed(make, device)
    since = launches_since(before)
    return w, t, {k: since[k] for k in TABLE_KERNELS}


def m2l_table_work(w):
    """Bytes the table kernel must move (the table written once, its
    inputs read once) and its float64 operations: in 3D about 10 a value
    of the order-2p basis and 2 an operator entry (the sign product), in
    2D 8 a power of 1 / z0 and 2 an entry."""
    nops, k = w._m2l_opsT.shape[:2]
    p, es = w.order, w._m2l_opsT.element_size()
    kc = k if w.dtype.is_complex else k // 2
    per_op = (10 * (2 * p + 1) ** 2 if w.dim == 3 else 8 * (2 * p + 2))
    return dict(type="float64", operators=nops,
                table_bytes=nops * k * k * es,
                bytes=nops * k * k * es + nops * (w.dim + 2) * 8,
                flops=nops * (per_op + 2 * kc * kc))


def check_m2l_table(card, device, path, label, w, setup_s, launches):
    """The wrangler's table kernel: launched once in its setup (checked on
    the card), timed (median of 5, synchronised) as its launch alone on
    inputs already on the card (``ms``) and as its wrapper, the inputs'
    preparation and upload included (``wrapper_ms``), beside its twin
    (median of 3; one call where that takes over 0.2 s) on the wrangler's
    own table inputs, and held to it per operator.  Emits an
    ``m2l_table`` line."""
    import torch

    from boxtree_torch.ops import kernels, m2l_ops

    name = "m2l_table_3d" if w.dim == 3 else "m2l_table_2d"
    if device.type == "cuda" and launches != {
            k: int(k == name) for k in TABLE_KERNELS}:
        raise AssertionError(f"{path} {label}: table launches {launches}, "
                             f"expected one of {name}")
    fn = getattr(m2l_ops, name)
    plain = getattr(m2l_ops, f"{name}_plain")
    args = (*w._m2l_table_args, w.order, w.dtype, device, w.level_orders)
    got = fn(*args)
    ref, t_plain = timed(lambda: plain(*args), device)
    if not torch.equal(got, w._m2l_opsT):
        raise AssertionError(f"{path} {label}: the table differs from the "
                             "wrangler's")
    gd = torch.view_as_real(got) if got.is_complex() else got.double()
    rd = torch.view_as_real(ref) if ref.is_complex() else ref.double()
    err = (gd - rd).abs().flatten(1).amax(1)
    scale = rd.abs().flatten(1).amax(1)
    rel = (err / scale.clamp(min=1e-300)).max().item() if len(err) else 0.0
    tol = M2L_TABLE_RTOL[_dt(w.dtype)]
    bit_equal = bool(torch.equal(
        gd.contiguous().view(torch.int64 if gd.dtype == torch.float64
                             else torch.int32),
        rd.contiguous().view(torch.int64 if rd.dtype == torch.float64
                             else torch.int32))) if gd.dtype == rd.dtype \
        else bool(torch.equal(got, ref))
    del got, ref, gd, rd
    work = m2l_table_work(w)
    largs = m2l_ops.table_launch_args(w.dim, *args)
    r = dict(launches=launches[name],
             max_abs_err=err.max().item() if len(err) else 0.0,
             rel_err=rel, bit_equal=bit_equal,
             ms=median_ms(lambda: kernels.launch(name, w.dtype, *largs),
                          device),
             wrapper_ms=median_ms(lambda: fn(*args), device),
             plain_ms=(t_plain * 1e3 if t_plain > 0.2 else median_ms(
                 lambda: plain(*args), device, reps=3)))
    r["bound_ms"], r["bound_by"] = bound(work)
    emit({"phase": "m2l_table", "card": card, "path": path,
          "layout": label, "kernel": name, "wrangler_setup_s": setup_s,
          "m2l_table_s": r["ms"] / 1e3,
          "m2l_table_wrapper_s": r["wrapper_ms"] / 1e3,
          "m2l_table_plain_s": r["plain_ms"] / 1e3,
          "operators": work["operators"],
          "table_bytes": work["table_bytes"], "bound_ms": r["bound_ms"],
          "bound_by": r["bound_by"], "rel_err_per_operator": rel,
          "tolerance": tol, "bit_equal_to_twin": bit_equal,
          "launches_in_setup": launches[name]})
    if not rel <= tol:
        raise AssertionError(f"{path} {label}: {name} rel {rel:.3e} > {tol}")
    M2L_TABLES.setdefault(name, {})[f"{path} {label}"] = (r, work)
    return r


def m2l_table_entries():
    """Summary entries of K69-K74: the main path's (3D) and the 2D Laplace
    path's (2D) numbers, every other path's beside them."""
    out = []
    for name, first in (("m2l_table_3d", "main path f32"),
                        ("m2l_table_2d", "laplace2d c128")):
        by_path = M2L_TABLES[name]
        r, work = by_path[first]
        e = summary_entry(name, r["launches"], r, work)
        e["wrapper_ms"] = r["wrapper_ms"]
        e["paths"] = {k: {f: v[0][f] for f in (
            "launches", "max_abs_err", "ms", "wrapper_ms", "plain_ms",
            "bound_ms", "bound_by", "bit_equal")} for k, v in by_path.items()
            if k != first}
        out.append(e)
    return out


def classify_inputs(w):
    """K75 / K76's arguments for the edge plan of wrangler *w*."""
    import torch

    trav, tree, plan = w.traversal, w.tree, w.m2l_plan
    args = (tree.box_morton_prefixes, tree.box_levels.to(torch.int32),
            trav.from_sep_siblings_starts.to(torch.int32),
            trav.from_sep_siblings_lists.to(torch.int32),
            trav.target_or_target_parent_boxes.to(torch.int32),
            torch.as_tensor(plan._table, device=w.device))
    kw = dict(dim=3, radius=plan._radius, nclasses=plan.nclasses,
              npossible=tree.nlevels * plan.nclasses)
    return args, kw


def classify_work(args, kw):
    """Bytes K75 and K76 must move: K75 reads the CSR, the rows' boxes,
    both boxes' prefixes and levels (each box once) and writes a key an
    edge; K76 reads the keys and the CSR and writes the two boxes an edge
    and the histogram."""
    prefixes, levels, starts, lists, totp, table = args
    e = lists.shape[0]
    boxes = nbytes(prefixes, levels)
    csr = nbytes(starts, lists, totp)
    return {"m2l_classify_keys": dict(type="float64", edges=e,
                                      bytes=csr + boxes + nbytes(table)
                                      + 8 * e),
            "m2l_classify_unpack": dict(type="float64", edges=e,
                                        bytes=8 * e + csr + 8 * e
                                        + 8 * (kw["npossible"] + 1))}


def rotation_work(w, edges):
    """K77-K79's work: a complex multiply-add (8 real operations) per
    entry of the edge's rotate and unrotate blocks (sum_n (2n+1)^2 each)
    and axial blocks (sum_m (p+1-|m|)^2), per edge; bytes: the source and
    target rows once, the edges and the blocks.  Its bound takes K35's
    rates (``translation_bound``): the tile's rows times one class's
    blocks are block products of the shape the FP64 tensor cores run."""
    import torch

    from boxtree_torch.ops import rotation

    p = w.order
    _, nb = rotation.rotation_offsets(p)
    _, na = rotation.axial_offsets(p)
    e = edges.nedges
    k, es = w.ncoeff, w.multipole_expansion_zeros()[:1].element_size()
    nrows = (int(torch.unique(edges.src).numel())
             + int(torch.unique(edges.tgt).numel()))
    blocks = w._m2l_rot.blocks.flat(w.real_dtype)
    return dict(type="float32" if w.dtype == torch.float32 else "float64",
                edges=e, flops=8 * e * (2 * nb + na),
                bytes=nrows * k * es + 8 * e + nbytes(*blocks))


def run_rotation(device, card, path, cases):
    """The rotation M2L on a path's tree and traversal (no rebuild): per
    case ``(label, dense wrangler, factory keywords, user-order weights,
    sampled targets, float64 direct sum there, its bar)``, the rotation
    wrangler's setup split (plan, block fits, axial operators), its
    edges, operators and rotation classes, two FMMs (the second's M2L
    stage beside the dense one's K35 on the same traversal), its
    potentials against the dense FMM and the direct sum, the launches of
    one FMM (K77-K79 once, no K35), 0 host reads in M2L (sync debug
    mode), the peak memory; then K75 / K76 against their twin (exactly)
    and K77-K79 against theirs on every k-th operator group (at most
    ROTATION_TWIN_GROUPS), each timed."""
    import numpy as np
    import torch

    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_laplace_wrangler
    from boxtree_torch.ops import kernels, rotation

    t_phase = time.perf_counter()
    for label, dense, kw, q, sample, ref_direct, direct_bar in cases:
        trav = dense.traversal
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        before = kernels.launch_counts()
        w, t_setup = timed(lambda: make_laplace_wrangler(
            trav, dense.order, m2l_mode="rotation", **kw), device)
        in_setup = launches_since(before)
        plan, rot = w.m2l_plan, w._m2l_rot
        drive_fmm(w, [q])
        before = kernels.launch_counts()
        stages = {}
        pot, t_fmm = timed(lambda: drive_fmm(w, [q], timing_data=stages),
                           device)
        per_fmm = launches_since(before)
        dense_stages = {}
        pot_dense = drive_fmm(dense, [q], timing_data=dense_stages)
        _, rel_dense = rel_linf(pot, pot_dense)
        abs_direct, rel_direct = rel_linf(pot.real[sample], ref_direct)
        syncs = m2l_syncs(w, q) if device.type == "cuda" else None
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else None)
        tol_dense = ROTATION_VS_DENSE_RTOL[_dt(w.dtype)]
        emit({"phase": "rotation_m2l", "card": card, "path": path,
              "layout": label, "order": w.order,
              "wrangler_setup_s": t_setup,
              "setup_split_s": w.rotation_setup_s,
              "list2_edges": plan.edges.nedges, "operators": plan.nops,
              "rotation_classes": rot.nrotations,
              "blocks_bytes": rot.blocks.nbytes,
              "fmm_s": t_fmm, "stage_s": stages,
              "m2l_rotation_s": stages["multipole_to_local"],
              "m2l_dense_k35_s": dense_stages["multipole_to_local"],
              "launches_in_setup": {k: in_setup[k] for k in (
                  *TABLE_KERNELS, *ROTATION_KERNELS)},
              "launches_per_fmm": {k: per_fmm[k] for k in (
                  *ROTATION_KERNELS, "m2l_translate")},
              "rel_linf_vs_dense": rel_dense,
              "tolerance_vs_dense": tol_dense,
              "rel_linf_vs_f64_direct": rel_direct,
              "abs_linf_vs_f64_direct": abs_direct, "bar": direct_bar,
              "m2l_host_syncs": syncs, "peak_mem_gb": peak})
        if device.type == "cuda":
            want = {"m2l_classify_keys": 1, "m2l_classify_unpack": 1,
                    "m2l_table_3d": 1, "m2l_table_2d": 0}
            got = {k: in_setup[k] for k in want}
            if got != want:
                raise AssertionError(f"{path} {label}: setup launches "
                                     f"{got}, expected {want}")
            if per_fmm["m2l_rotate"] != 1 or per_fmm["m2l_translate"]:
                raise AssertionError(f"{path} {label}: FMM launches "
                                     f"{per_fmm}")
        if not bool(torch.isfinite(pot).all()) or pot.shape != \
                pot_dense.shape:
            raise AssertionError(f"{path} {label}: rotation FMM output")
        if not rel_dense <= tol_dense:
            raise AssertionError(f"{path} {label}: rotation vs dense "
                                 f"{rel_dense:.3e} > {tol_dense}")
        if not rel_direct < direct_bar:
            raise AssertionError(f"{path} {label}: rotation vs direct "
                                 f"{rel_direct:.3e} >= {direct_bar}")

        # K75 / K76 against their twin, exactly
        args, ckw = classify_inputs(w)
        got = rotation.classify_edges(*args, **ckw)
        ref, t_plain = timed(lambda: rotation.classify_edges_plain(
            *args, **ckw), device)
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        if not equal or not torch.equal(got[0], plan.tgt):
            raise AssertionError(f"{path} {label}: K75 / K76 differ from "
                                 "their twin")
        prefixes, levels, starts, lists, totp, table = args
        nedges, nrows = lists.shape[0], starts.shape[0] - 1
        bits = rotation.key_bits(nedges)
        cwork = classify_work(args, ckw)
        plain_ms = (t_plain * 1e3 if t_plain > 1.0 else median_ms(
            lambda: rotation.classify_edges_plain(*args, **ckw), device,
            reps=3))
        cres = {name: dict(ms=None) for name in ROTATION_KERNELS[:2]}
        sort_ms = None
        if device.type == "cuda":
            # each entry point alone, and the sort between them
            keys = torch.empty(nedges, dtype=torch.int64, device=device)
            outs = [torch.empty(nedges, dtype=torch.int32, device=device)
                    for _ in range(2)]
            hist = torch.zeros(ckw["npossible"] + 1, dtype=torch.int64,
                               device=device)

            def k75():
                kernels.launch("m2l_classify_keys", None, *args, nedges,
                               nrows, 3, ckw["radius"], ckw["nclasses"],
                               ckw["npossible"], bits, keys)

            k75()
            skeys = torch.sort(keys).values

            def k76():
                hist.zero_()
                kernels.launch("m2l_classify_unpack", None, skeys, starts,
                               lists, totp, nedges, nrows, bits, *outs, hist)

            cres["m2l_classify_keys"]["ms"] = median_ms(k75, device)
            cres["m2l_classify_unpack"]["ms"] = median_ms(k76, device)
            sort_ms = median_ms(lambda: torch.sort(keys), device)
            if not torch.equal(outs[0], plan.tgt):
                raise AssertionError(f"{path} {label}: K76 alone differs")
        for name, r in cres.items():
            r.update(max_abs_err=0.0, plain_ms=plain_ms,
                     launches=in_setup[name])
            r["bound_ms"], r["bound_by"] = bound(cwork[name])

        # K77-K79 against their twin on a sample of operator groups
        mp = w.coarsen_multipoles(None, None, w.form_multipoles(
            None, None, [w.reorder_sources(q)]))
        edges, blocks = plan.edges, rot.blocks
        step = max(1, -(-plan.nops // ROTATION_TWIN_GROUPS))
        ops = np.arange(0, plan.nops, step)
        sub = edges.select(ops)
        got = rotation.m2l_rotation(mp, sub, blocks)
        ref, t_twin = timed(lambda: rotation.m2l_rotation_plain(
            mp, sub, blocks), device)
        err, rel = rel_linf(got, ref)
        del got, ref
        tol = ROTATION_RTOL[_dt(w.dtype)]
        rwork = rotation_work(w, edges)
        rres = dict(
            launches=per_fmm["m2l_rotate"], max_abs_err=err, rel_err=rel,
            ms=median_ms(lambda: rotation.m2l_rotation(mp, edges, blocks),
                         device),
            ms_on_sample=median_ms(lambda: rotation.m2l_rotation(
                mp, sub, blocks), device),
            plain_ms=(t_twin * 1e3 if t_twin > 1.0 else median_ms(
                lambda: rotation.m2l_rotation_plain(mp, sub, blocks),
                device, reps=3)),
            plain_on=f"{len(ops)} of {plan.nops} operator groups, "
                     f"{sub.nedges} of {edges.nedges} edges",
            dense_k35_ms=median_ms(lambda: dense.multipole_to_local(
                None, trav.target_or_target_parent_boxes,
                trav.from_sep_siblings_starts, trav.from_sep_siblings_lists,
                mp), device))
        rres["bound_ms"], rres["bound_by"], rres["bound_rate"] = \
            translation_bound(rwork)
        emit({"phase": "kernels_rotation", "card": card, "path": path,
              "layout": label, "tolerance_rel_linf": tol,
              "rel": "over the locals", "classify_equal_to_twin": equal,
              "classify": cres, "sort_ms": sort_ms,
              "classify_plain": "the twin's whole classification, sort "
                                "included, beside each entry point",
              "rotate": rres, "work": {"classify": cwork,
                                       "rotate": rwork}})
        if not rel <= tol:
            raise AssertionError(f"{path} {label}: K77-K79 rel {rel:.3e} "
                                 f"> {tol}")
        ROTATION[f"{path} {label}"] = {
            **{name: (r, cwork[name]) for name, r in cres.items()},
            "m2l_rotate": (rres, rwork)}
        del w, mp, pot, pot_dense
    emit({"phase": "rotation_m2l_done", "card": card, "path": path,
          "seconds": time.perf_counter() - t_phase})


def rotation_entries():
    """Summary entries of K75-K79: the main path's numbers, the double
    layer's beside them."""
    out = []
    first = "main path f32"
    for name in ROTATION_KERNELS:
        r, work = ROTATION[first][name]
        e = summary_entry(name, r["launches"], r, work)
        e["bound_ms"], e["bound_by"] = r["bound_ms"], r["bound_by"]
        e["paths"] = {k: {f: v[name][0][f] for f in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")} for k, v in ROTATION.items() if k != first}
        if name == "m2l_rotate":
            e["plain_on"], e["bound_rate"] = r["plain_on"], r["bound_rate"]
        out.append(e)
    return out

# }}}


# {{{ K43-K46: the tree build

def tree_kernel_inputs(particles, build_kw, device):
    """K43's arguments as ``build_tree`` gives them for *particles* and
    *build_kw* (the depth of its first try), and what phase B and the
    restriction take after it."""
    from boxtree_torch.tree.build import _build_inputs, _sort_keys

    inp = _build_inputs(particles, device=device, **build_kw)
    codes_s, order, w_s, stick_s, bbox_min, root = _sort_keys(inp.merged,
                                                              **inp.keys)
    return dict(inp=inp, codes_s=codes_s, order=order, w_s=w_s,
                stick_s=stick_s, bbox_min=bbox_min, root_extent=root)


def check_tree_kernels(card, device, label, particles, build_kw, trees):
    """K43 and K44 (on a restricted tree also K45, one round's sweep after
    the first demand pass, and K46) against their plain twins on the card
    at the inputs ``build_tree(particles, **build_kw)`` gives them, every
    output equal (box centres bit for bit); each timed beside its twin
    (one call) and its byte bound.  Emits a ``kernels_tree`` line, keeps
    the results in the dict *trees* under *label* and returns ``(results,
    work)``."""
    import torch

    from boxtree_torch.ops import restrict
    from boxtree_torch.ops import tree as tree_ops
    from boxtree_torch.tree.build import _extent_order
    from boxtree_torch.tree.level_restrict import (
        consistency_sweep,
        restrict_leaf_levels,
    )

    t = tree_kernel_inputs(particles, build_kw, device)
    inp = t["inp"]
    d, depth = inp.keys["dimensions"], inp.keys["depth"]
    codes_s = t["codes_s"]
    n = codes_s.shape[0]
    cdt = inp.merged.dtype
    res, work, outputs = {}, {}, {}

    def compare(name, kernel, plain):
        got, ref = _flat(kernel()), _flat(plain())
        if len(got) != len(ref) or not all(
                g.dtype == r.dtype and g.shape == r.shape
                and torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"{name} != plain twin on the {label} "
                                 "tree")
        res[name] = dict(max_abs_err=0.0, ms=median_ms(kernel, device),
                         plain_ms=timed(plain, device)[1] * 1e3)
        outputs[name] = got

    k43_args = (codes_s, t["w_s"], t["stick_s"], inp.max_weight)
    k43_kw = dict(dimensions=d, depth=depth, adaptive=inp.adaptive)
    compare("tree_leaf_levels",
            lambda: tree_ops.leaf_levels(*k43_args, **k43_kw),
            lambda: tree_ops.leaf_levels_plain(*k43_args, **k43_kw))
    leaf, packed = outputs["tree_leaf_levels"]
    packed = packed.cpu()
    if int(packed[depth + 2]):
        raise AssertionError(f"{label}: particles unfit at depth {depth}")
    counts = packed[:depth + 2]
    work["tree_leaf_levels"] = dict(bytes=nbytes(
        codes_s, leaf, packed, *[x for x in (t["w_s"], t["stick_s"])
                                 if x is not None]))
    rounds = None
    if build_kw.get("kind") == "adaptive-level-restricted":
        max_level = int(torch.nonzero(counts)[-1, 0])
        lev = leaf
        for m in range(max_level, 1, -1):
            lev = restrict.demand_pass(codes_s, lev, m=m, dimensions=d,
                                       depth=depth)
        sweep_kw = dict(dimensions=d, depth=depth, max_level=max_level)
        compare("restrict_sweep",
                lambda: consistency_sweep(codes_s, lev, **sweep_kw),
                lambda: consistency_sweep(codes_s, lev, plain=True,
                                          **sweep_kw))
        work["restrict_sweep"] = dict(levels=max_level, bytes=nbytes(
            codes_s, lev, lev))
        leaf, counts, rounds = restrict_leaf_levels(
            codes_s, leaf, dimensions=d, depth=depth, max_level=max_level)
        compare("level_box_counts",
                lambda: tree_ops.level_box_counts(codes_s, leaf, **sweep_kw),
                lambda: tree_ops.level_box_counts_plain(codes_s, leaf,
                                                        **sweep_kw))
        counts = counts.cpu()
        work["level_box_counts"] = dict(bytes=nbytes(codes_s, leaf, counts))
    nlevels = int(torch.nonzero(counts)[-1, 0]) + 1
    lsb = tuple(int(x) for x in torch.cat([
        counts.new_zeros(1), torch.cumsum(counts[:nlevels], 0)]))
    has_ext = inp.keys["radii"] is not None
    codes_b, leaf_b = codes_s, leaf
    if has_ext:
        codes_b, _, leaf_b = _extent_order(codes_s, t["order"], leaf,
                                           dimensions=d, depth=depth)
    k44_args = (codes_b, leaf_b, t["bbox_min"].to(cdt),
                torch.as_tensor(t["root_extent"]).to(cdt))
    k44_kw = dict(dimensions=d, depth=depth, level_starts=lsb,
                  has_extents=has_ext)
    compare("tree_level_boxes",
            lambda: list(tree_ops.box_levels(*k44_args, **k44_kw).values()),
            lambda: list(tree_ops.box_levels_plain(*k44_args,
                                                   **k44_kw).values()))
    work["tree_level_boxes"] = dict(levels=nlevels, boxes=lsb[-1],
                                    bytes=nbytes(codes_b, leaf_b, *outputs[
                                        "tree_level_boxes"]))
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bound(work[name])
    emit({"phase": "kernels_tree", "card": card, "tree": label,
          "particles": n, "dimensions": d, "depth": depth,
          "dtype": str(cdt).replace("torch.", ""), "nlevels": nlevels,
          "nboxes": lsb[-1], "restriction_rounds": rounds,
          "tolerance": "bit-exact", "kernels": res, "work": work})
    trees[label] = res
    return res, work


def build_host_reads(build, tree, launches, restricted=False):
    """The host reads of one more call of *build*, counted by
    :func:`read_count` and held to K43's one packed read (one more a
    restriction round and one for the recount, the rounds from K45's
    launches); the launches of K43-K46 held to one K43 launch and one K44
    launch a level (K45 once a level below the deepest a round, K46
    once).  A ``torch.profiler`` trace of a third call (:func:`host_reads`)
    is the second witness, for the reads made inside an op: it can lose
    events (a trace of the restricted build once showed 4 of its 5 reads)
    but never invent one, so it must not count more device-to-host copies
    than expected.  Returns ``host_reads_per_build`` and
    ``host_reads_traced``."""
    reads = read_count(build)
    traced = host_reads(build)
    expect = 1
    if launches["tree_leaf_levels"] != 1:
        raise AssertionError(f"K43 launched {launches['tree_leaf_levels']} "
                             "times in one build (one depth tried)")
    if launches["tree_level_boxes"] != tree.nlevels:
        raise AssertionError(f"K44 launched {launches['tree_level_boxes']} "
                             f"times for {tree.nlevels} levels")
    if restricted:
        max_level = tree.nlevels - 1
        rounds = launches["restrict_sweep"] // max_level
        if (launches["restrict_sweep"] != rounds * max_level
                or launches["level_box_counts"] != 1 or rounds < 1):
            raise AssertionError(f"K45 / K46 launches {launches}")
        expect += rounds + 1
    elif launches["restrict_sweep"] or launches["level_box_counts"]:
        raise AssertionError("K45 / K46 launched by an unrestricted build")
    if reads != expect:
        raise AssertionError(f"{reads} host reads in one build, expected "
                             f"{expect}")
    if traced is not None and traced > expect:
        raise AssertionError(f"the trace of one build shows {traced} "
                             f"device-to-host copies, expected {expect}")
    return {"host_reads_per_build": reads, "host_reads_traced": traced}


def check_tree_invariants(tree, particles, *, max_weight, weights=None,
                          kind="adaptive", bbox=None, nsample=1000,
                          seed=3):
    """``tests/test_tree.py:44-127``'s invariants on the card: the order
    round trip, every particle once, level-major numbering, parents and
    children, counts, flags and child centres on all boxes; containment
    and the leaf weight bound on *nsample* sampled boxes; one leaf level
    for the non-adaptive kind; centres inside a given *bbox*."""
    import numpy as np
    import torch

    from boxtree_torch import box_flags_enum as F

    dev = tree.sources.device
    n = particles.shape[1]
    nb = tree.nboxes
    levels = tree.box_levels.to(torch.int64)
    parents = tree.box_parent_ids.to(torch.int64)
    children = tree.box_child_ids.to(torch.int64)
    starts = tree.box_source_starts.to(torch.int64)
    nonchild = tree.box_source_counts_nonchild.to(torch.int64)
    cumul = tree.box_source_counts_cumul.to(torch.int64)
    ids = tree.user_source_ids.to(torch.int64)
    root = float(tree.root_extent)
    checks = {}
    checks["order"] = torch.equal(tree.sources, particles[:, ids])
    checks["counts"] = int(nonchild.sum()) == n == int(cumul[0])
    checks["levels"] = bool((levels[1:] >= levels[:-1]).all()) and int(
        parents[0]) == 0 and int(levels[0]) == 0 and bool(
        (levels[parents[1:]] == levels[1:] - 1).all())
    has = children > 0
    child_sum = torch.where(has, cumul[children], 0).sum(0)
    checks["cumul"] = bool((nonchild + child_sum == cumul).all())
    checks["duality"] = bool((parents[children[has]] == torch.nonzero(
        has)[:, 1]).all())
    is_leaf = ~has.any(0)
    flags = tree.box_flags
    checks["flags"] = bool(((flags & F.IS_LEAF_BOX != 0) == is_leaf).all()
                           and ((flags & F.IS_SOURCE_BOX != 0)
                                == (nonchild > 0)).all())
    checks["internal_empty"] = bool((nonchild[~is_leaf] == 0).all())
    c_box = torch.nonzero(has)[:, 1]
    off = (tree.box_centers[:, children[has]]
           - tree.box_centers[:, c_box]).abs().double()
    expect = root / 2.0 ** (levels[children[has]] + 1).double()
    eps = float(torch.finfo(tree.box_centers.dtype).eps)
    checks["child_centres"] = bool(
        ((off - expect).abs() <= 8 * root * eps).all())
    rng = np.random.default_rng(seed)
    sample = torch.as_tensor(rng.choice(nb, min(nsample, nb), replace=False),
                             device=dev)
    cnt = nonchild[sample]
    box_of = torch.repeat_interleave(sample, cnt)
    first = torch.repeat_interleave(starts[sample], cnt)
    pos = (first + torch.arange(int(cnt.sum()), device=dev)
           - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt))
    pts = tree.sources[:, pos].double()
    rad = (root / 2.0 ** (levels[box_of] + 1).double())
    tol = 4 * root * eps
    checks["containment"] = bool(
        ((pts - tree.box_centers[:, box_of].double()).abs()
         <= rad + tol).all())
    w = (torch.ones(n, dtype=torch.int64, device=dev) if weights is None
         else weights.to(torch.int64))
    box_w = torch.zeros(nb, dtype=torch.int64, device=dev).index_add_(
        0, box_of, w[ids[pos]])
    checks["leaf_weight"] = bool((box_w[sample[is_leaf[sample]]]
                                  <= max_weight).all())
    if kind == "non-adaptive":
        checks["one_leaf_level"] = int(torch.unique(levels[is_leaf]).numel()
                                       ) == 1
    if bbox is not None:
        lo, hi = bbox[0][0], bbox[0][1]
        checks["centres_in_bbox"] = bool(
            ((tree.box_centers >= lo) & (tree.box_centers <= hi)).all())
        checks["root_extent"] = root == hi - lo
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tree invariants violated: {bad}")
    return sorted(checks)


def run_tree_options(device, card, n=1_000_000, order=8, nsample=2000):
    """The non-adaptive kind, refine weights and a given bbox at the main
    path's width: 1e6 uniform float32 points (its seed 17), (a)
    ``kind="non-adaptive"``, (b) int32 weights uniform in 1..9 from the
    seed with ``max_leaf_refine_weight=150``, (c) ``bbox = [[-0.25,
    1.25]] * 3``, each built on the card (K43, K44, one host read), its
    invariants checked, its traversal and counting FMM exact; (a) also the
    order-8 float32 Laplace FMM against a float64 direct sum."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import (
        ConstantOneExpansionWrangler,
        make_laplace_wrangler,
    )
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    rng = np.random.default_rng(17)
    pts = torch.as_tensor(rng.random((3, n), dtype=np.float32),
                          device=device)
    q = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=device)
    weights = torch.as_tensor(rng.integers(1, 10, n).astype(np.int32),
                              device=device)
    bbox = [[-0.25, 1.25]] * 3
    builds = {
        "non_adaptive": dict(kind="non-adaptive", max_particles_in_box=30),
        "refine_weights": dict(refine_weights=weights,
                               max_leaf_refine_weight=150),
        "given_bbox": dict(bbox=bbox, max_particles_in_box=30),
    }
    out = {}
    for name, kw in builds.items():
        kernels.reset_launch_counts()
        tree, t_build = timed(lambda: build_tree(pts, **kw), device)
        launches = kernels.launch_counts()
        reads = build_host_reads(lambda: build_tree(pts, **kw), tree,
                                 launches)
        checked = check_tree_invariants(
            tree, pts, max_weight=kw.get("max_particles_in_box", 150),
            weights=kw.get("refine_weights"), kind=kw.get("kind"),
            bbox=kw.get("bbox"))
        trav, t_trav = timed(lambda: build_traversal(tree), device)
        pot, t_count = timed(lambda: drive_fmm(
            ConstantOneExpansionWrangler(None, trav),
            [torch.ones(n, dtype=torch.float64, device=device)]), device)
        nbad = int((pot != n).sum())
        line = {"phase": "tree_options", "card": card, "build": name,
                "points": n, "dtype": "float32",
                "options": {k: v for k, v in kw.items()
                            if k != "refine_weights"},
                "nboxes": tree.nboxes, "nlevels": tree.nlevels,
                "leaf_levels": sorted(set(tree.box_levels[
                    (tree.box_flags & 16) != 0].tolist())),
                "build_s": t_build, **reads,
                "launches": {k: launches[k] for k in TREE_KERNELS},
                "invariants": checked, "traversal_s": t_trav,
                "counting_fmm_s": t_count, "counting_exact": nbad == 0}
        if name == "refine_weights":
            line["options"]["refine_weights"] = "int32 uniform in 1..9"
        if nbad:
            emit(line)
            raise AssertionError(f"counting FMM on the {name} tree: {nbad} "
                                 f"potentials != {n}")
        if name == "non_adaptive":
            wr, t_setup = timed(lambda: make_laplace_wrangler(
                trav, order=order, pairs=True, rscale="auto",
                dtype=torch.float32), device)
            pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
            sample = torch.as_tensor(np.random.default_rng(5).choice(
                n, nsample, replace=False), device=device)
            abs_err, rel = rel_linf(pot[sample], direct_sum_f64(
                pts, q, pts[:, sample]))
            line.update(order=order, wrangler_setup_s=t_setup, fmm_s=t_fmm,
                        sampled_targets=nsample,
                        rel_linf_vs_f64_direct=rel, abs_linf=abs_err,
                        finite=bool(torch.isfinite(pot).all()))
            del wr
        emit(line)
        if name == "non_adaptive" and not (line["finite"]
                                            and rel <= FMM_RTOL):
            raise AssertionError(f"Laplace FMM on the non-adaptive tree: "
                                 f"rel l-inf {rel:.3e} > {FMM_RTOL}")
        out[name] = line
        del tree, trav, pot
    return out

# }}}


# {{{ K35-K37: M2L, M2M and L2L

#: rel l-inf tolerance of K35-K37 against their twins, per coefficient
#: column (the pairs' two lanes as one complex coefficient): float64 and
#: complex128 sums in another order (the twin of K35 is the edge form, one
#: matmul per operator), float32 likewise
TRANSLATE_RTOL = {"float32": 1e-5, "float64": 1e-12, "complex128": 1e-12}
#: the same at order 31 (the stability line): dot products of 1,024
#: complex terms, against 33-338 on the paths, summed in another order
#: (the CUDA tests' float64 pairs there lie 2.1e-12 apart)
LINE_TRANSLATE_RTOL = 1e-11
#: the peak rates of K35-K37's bounds: float32 outside the tensor cores,
#: float64 and complex128 on the FP64 tensor cores (NVIDIA's H100 SXM data
#: sheet, dense, 700 W; a complex multiply-add counts 8 real operations)
TRANSLATE_PEAK = {"float32": (67e12, "67 TFLOP/s float32 (SIMT)"),
                  "float64": (67e12, "67 TFLOP/s float64 (FP64 tensor "
                                     "cores)")}


def host_reads(fn):
    """Device-to-host copies (the host reads) during one call of *fn*,
    from a ``torch.profiler`` trace (its Chrome export, as
    ``scripts/torch_fmm_profile.py`` reads it); None if the trace shows no
    device activity."""
    import json
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return None
    return sum(e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
               for e in dev)


def fmm_host_reads(w, q):
    """Host reads of one ``drive_fmm`` of wrangler *w* on user-order
    charges *q*, and of its M2L stage alone."""
    from boxtree_torch.fmm import drive_fmm

    trav = w.traversal
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [w.reorder_sources(q)]))
    return {"fmm": host_reads(lambda: drive_fmm(w, [q])),
            "multipole_to_local": host_reads(lambda: w.multipole_to_local(
                trav.level_start_target_or_target_parent_box_nrs,
                trav.target_or_target_parent_boxes,
                trav.from_sep_siblings_starts, trav.from_sep_siblings_lists,
                mp))}


def read_count(fn):
    """The host reads during one call of *fn*, counted on the host by a
    ``TorchDispatchMode``: every aten call that takes a CUDA tensor and
    gives a Python number (``.item()``, ``bool()``, ``int()``) or a CPU
    tensor (``.cpu()``, ``.tolist()``, a copy into host memory).  A read
    that an op makes inside itself (``nonzero``'s count) is not seen
    here; the trace of :func:`host_reads` sees it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    scalar = torch.ops.aten._local_scalar_dense.default

    class Reads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in tree_leaves((args, kwargs))) and (
                    func is scalar or any(
                        isinstance(t, torch.Tensor) and not t.is_cuda
                        for t in tree_leaves(out))):
                self.n += 1
            return out

    torch.cuda.synchronize()
    with Reads() as mode:
        fn()
    torch.cuda.synchronize()
    return mode.n


def op_count(fn):
    """The aten calls during one call of *fn*, counted on the host by a
    ``TorchDispatchMode`` (what a host-bound call pays for)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    with Ops() as mode:
        fn()
    torch.cuda.synchronize()
    return mode.n


def sync_free(fn):
    """0 when *fn* runs with PyTorch's CUDA sync debug mode set to raise,
    so that no host read or other synchronising call happens in it; raises
    otherwise.  A second witness beside :func:`host_reads`, whose traces
    came back without device events on the 1e6 3D Helmholtz trees (of M2L
    alone, a 0.3 s kernel, and of the whole dipole FMM)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return 0


def reads_free(reads):
    """True when :func:`fmm_host_reads`' traces of an FMM and of its M2L
    show no host read, a trace without device events (None, it measured
    nothing) counting only when the run under sync debug mode beside it
    (``fmm_sync_debug``, ``multipole_to_local_sync_debug``) was clean."""
    return all(reads[k] == 0 or reads[k] is None
               and reads[f"{k}_sync_debug"] == 0
               for k in ("fmm", "multipole_to_local"))


def m2l_syncs(w, q):
    """:func:`sync_free` of the M2L stage of wrangler *w* (user-order
    charges *q*)."""
    trav = w.traversal
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [w.reorder_sources(q)]))
    return sync_free(lambda: w.multipole_to_local(
        trav.level_start_target_or_target_parent_box_nrs,
        trav.target_or_target_parent_boxes,
        trav.from_sep_siblings_starts, trav.from_sep_siblings_lists, mp))


def translation_rel(got, ref):
    """``(max_abs_err, rel)`` of (boxes, coefficients) expansions per
    coefficient column, the pairs' ``[re | im]`` lanes as one complex
    coefficient (an ``m = 0`` imaginary lane is zero but for rounding); a
    column that is zero in *ref* must be zero in *got*."""
    import torch
    if not ref.is_complex():
        k = ref.shape[1] // 2
        got, ref = (torch.complex(x[:, :k].double(), x[:, k:].double())
                    for x in (got, ref))
    err = (got - ref).abs()
    ecol, scale = err.amax(0), ref.abs().amax(0)
    zero = scale == 0
    if bool((ecol[zero] > 0).any()):
        return err.max().item(), float("inf")
    return err.max().item(), (ecol[~zero] / scale[~zero]).max().item()


def m2m_twin_stage(w, mp):
    """``coarsen_multipoles`` with K36's twin."""
    from boxtree_torch.ops import translate
    out, lsb = mp.clone(), w._lsb
    for lev in range(w.tree.nlevels - 1, 2, -1):
        translate.m2m_translate_plain(out, w._m2m_opsT[lev], w._child,
                                      lsb[lev - 1], lsb[lev] - lsb[lev - 1])
    return out


def l2l_twin_stage(w, loc):
    """``refine_locals`` with K37's twin."""
    from boxtree_torch.ops import translate
    out = loc.clone()
    for lev in range(1, w.tree.nlevels):
        translate.l2l_translate_plain(out, w._l2l_opsT[lev],
                                      w._l2l_rows[lev], w._tgt_child)
    return out


def shift_groups(w, which):
    """The library yardstick of M2M (*which* ``"m2m"``) or L2L: today's
    form before K36 / K37, one gather, ``torch.matmul`` and ``index_add_``
    per (level, digit), its ``(level, digit, rows, sources)`` groups
    built here (host reads) and not timed."""
    import torch
    groups = []
    if which == "m2m":
        lsb = w._lsb
        for lev in range(w.tree.nlevels - 1, 2, -1):
            par = torch.arange(lsb[lev - 1], lsb[lev], device=w.device)
            ch = w._child[lsb[lev - 1]:lsb[lev]].to(torch.int64)
            for q in range(ch.shape[1]):
                ok = ch[:, q] >= 0
                groups.append((lev, q, par[ok], ch[ok, q]))
    else:
        for lev in range(1, w.tree.nlevels):
            rows = w._l2l_rows[lev].to(torch.int64)
            tc = w._tgt_child[rows].to(torch.int64)
            for q in range(tc.shape[1]):
                ok = tc[:, q] >= 0
                groups.append((lev, q, tc[ok, q], rows[ok]))
    return groups


def shift_library(x, ops, groups):
    out = x.clone()
    for lev, q, dst, src in groups:
        out.index_add_(0, dst, out[src] @ ops[lev][q])
    return out


def m2l_library_plan(w):
    """The library yardstick of M2L: the reference's own form
    (``expansion_base.py:1016``) on cuBLAS, per level a gather of the
    target parents' colleagues' children, ``(rows, m 2^d K)``, times the
    ``(m 2^d K, 2^d K)`` block operator of the level's table entries.
    Returns per level ``(gather ids, block operator, target rows, their
    product rows)``, built here and not timed."""
    import torch
    plan = w._m2l_plan
    k, nboxes = w.ncoeff, w.tree.nboxes
    m, nchild = plan.pmap.shape[1], plan.child.shape[1]
    rows, lev_of = plan.rows.to(torch.int64), plan.row_level.to(torch.int64)
    child = plan.child.to(torch.int64)
    out = []
    for lev in sorted({lev for lev, _ in plan.used}):
        sel = torch.nonzero((lev_of == lev) & (rows >= 0))[:, 0]
        pm = plan.pmap[sel].to(torch.int64)
        src = torch.where(pm[..., None] >= 0, child[pm.clamp(min=0)], -1)
        src = torch.where(src >= 0, src, nboxes).reshape(sel.shape[0], -1)
        op = plan.opid[lev].to(torch.int64)                 # (m, qs, qt)
        blk = torch.where((op >= 0)[..., None, None],
                          plan.ops[op.clamp(min=0)], 0)
        blk = blk.permute(0, 1, 3, 2, 4).reshape(m * nchild * k, nchild * k)
        tgt = plan.tgt_child[rows[sel]].to(torch.int64).reshape(-1)
        ok = torch.nonzero(tgt >= 0)[:, 0]
        out.append((src, blk.contiguous(), tgt[ok], ok))
    return out


def m2l_library(mp, lib_plan, chunk_bytes=1 << 30):
    import torch
    k = mp.shape[1]
    mpz = torch.cat([mp, mp.new_zeros(1, k)])
    out = torch.zeros_like(mp)
    for src, blk, tgt, ok in lib_plan:
        n, width = src.shape
        y = mp.new_empty(n, blk.shape[1])
        chunk = max(1, chunk_bytes // (width * k * mp.element_size()))
        for c0 in range(0, n, chunk):
            y[c0:c0 + chunk] = mpz[src[c0:c0 + chunk]].reshape(
                -1, width * k) @ blk
        out[tgt] = y.reshape(-1, k)[ok]
    return out


def translation_work(w):
    """Bytes K35-K37 must move in one FMM (each input row read once, each
    output row written once, the operators and the index tables read
    once) and the operations they must do: a multiply-add (2 real
    operations, 8 complex) per coefficient pair of every List-2 edge
    (K35), every child box below level 3 (K36) and every
    target-or-target-parent child (K37)."""
    import torch
    plan = w._m2l_plan
    k, es = w.ncoeff, w.multipole_expansion_zeros()[:1].element_size()
    mac = 8 if w.dtype.is_complex else 2
    typ = "float32" if w.dtype == torch.float32 else "float64"
    lsb, nl = w._lsb, w.tree.nlevels
    starts = plan.l2_starts.to(torch.int64)
    nedges = int(plan.l2_lists.shape[0])
    nsrc = int(torch.unique(plan.l2_lists).numel())
    ntgt = int((starts[1:] > starts[:-1]).sum())
    nchildren = lsb[nl] - lsb[3] if nl > 3 else 0
    nparents = lsb[nl - 1] - lsb[2] if nl > 3 else 0
    nl2l = sum(int((w._tgt_child[w._l2l_rows[lev].to(torch.int64)] >= 0)
                   .sum()) for lev in range(1, nl))
    nl2l_par = sum(int(w._l2l_rows[lev].numel()) for lev in range(1, nl))
    return {
        "m2l_translate": dict(
            type=typ, list2_edges=nedges, flops=mac * k * k * nedges,
            bytes=((nsrc + ntgt) * k * es + nbytes(
                plan.ops, plan.opid, plan.rows, plan.pmap, plan.row_level,
                plan.child, plan.tgt_child))),
        "m2m_translate": dict(
            type=typ, children=nchildren, flops=mac * k * k * nchildren,
            bytes=((nchildren + 2 * nparents) * k * es + nbytes(
                w._child, *(w._m2m_opsT[lev] for lev in range(3, nl))))),
        "l2l_translate": dict(
            type=typ, children=nl2l, flops=mac * k * k * nl2l,
            bytes=((nl2l_par + 2 * nl2l) * k * es + nbytes(
                w._tgt_child, *(w._l2l_opsT[lev] for lev in range(1, nl))))),
    }


def translation_bound(work):
    """``(bound_ms, bound_by, rate)`` of one of K35-K37's work."""
    rate, label = TRANSLATE_PEAK[work["type"]]
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_ops = work["flops"] / rate
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations", label
    return t_bytes * 1e3, "bytes", "3.35 TB/s HBM3"


def check_translation(card, device, path, cases, translation, library=True,
                      rtol=None):
    """K35-K37 against their twins at the stage inputs of a second FMM on
    a path: *cases* is ``[(entry point, wrangler, user-order charges)]``.
    For each: one more ``drive_fmm`` counts the kernels' launches per FMM;
    the kernel's time (median of 5, the stage as the FMM runs it), the
    twin's (median of 3, or one call over 3 s) and the library
    yardstick's (median of 5; None without *library*), each kernel held to
    its twin per coefficient column.  Emits a ``kernels_translation`` line
    and records the results in *translation* by path and entry point;
    raises on a mismatch."""
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.ops import kernels, translate

    res, works = {}, {}
    for key, w, q in cases:
        q_tree = w.reorder_sources(q)
        kernels.reset_launch_counts()
        drive_fmm(w, [q])
        per_fmm = kernels.launch_counts()
        trav, plan = w.traversal, w._m2l_plan
        mp = w.form_multipoles(None, None, [q_tree])
        mp_up = w.coarsen_multipoles(None, None, mp)
        loc = w.form_locals(None, trav.target_or_target_parent_boxes,
                            trav.from_sep_bigger_starts,
                            trav.from_sep_bigger_lists, [q_tree],
                            translate.m2l_translate(mp_up, plan))
        lib = lib_m2l = None
        if library:
            lib_m2l = m2l_library_plan(w)
            g_m2m, g_l2l = shift_groups(w, "m2m"), shift_groups(w, "l2l")
            lib = {"m2l_translate": lambda: m2l_library(mp_up, lib_m2l),
                   "m2m_translate": lambda: shift_library(mp, w._m2m_opsT,
                                                          g_m2m),
                   "l2l_translate": lambda: shift_library(loc, w._l2l_opsT,
                                                          g_l2l)}
        fns = {"m2l_translate": (
                   lambda: translate.m2l_translate(mp_up, plan),
                   lambda: translate.m2l_translate_plain(mp_up, plan)),
               "m2m_translate": (
                   lambda: w.coarsen_multipoles(None, None, mp),
                   lambda: m2m_twin_stage(w, mp)),
               "l2l_translate": (
                   lambda: w.refine_locals(None, None, loc),
                   lambda: l2l_twin_stage(w, loc))}
        tol = rtol or TRANSLATE_RTOL[str(w.dtype).removeprefix("torch.")]
        works[key] = translation_work(w)
        res[key] = {}
        for name, (kern, twin) in fns.items():
            got = kern()
            ref, t_twin = timed(twin, device)
            err, rel = translation_rel(got, ref)
            if not rel <= tol:
                raise AssertionError(f"{path} {key} {name}: rel l-inf "
                                     f"{rel:.3e} > {tol}")
            rel_lib = (translation_rel(lib[name](), ref)[1] if library
                       else None)
            del got, ref
            reps = 1 if t_twin > 3.0 else 3
            r = dict(max_abs_err=err, rel_err=rel, library_rel_err=rel_lib,
                     ms=median_ms(kern, device),
                     plain_ms=(t_twin * 1e3 if reps == 1 else
                               median_ms(twin, device, reps=reps)),
                     plain_reps=reps,
                     library_ms=(median_ms(lib[name], device) if library
                                 else None),
                     launches_per_fmm=per_fmm[name])
            if device.type == "cuda" and per_fmm[name] <= 0:
                raise AssertionError(f"{path} {key}: {name} not launched "
                                     "by its FMM")
            r["bound_ms"], r["bound_by"], r["bound_rate"] = \
                translation_bound(works[key][name])
            res[key][name] = r
        del lib, lib_m2l
    emit({"phase": "kernels_translation", "card": card, "path": path,
          "tolerance_rel_linf": {k: rtol or TRANSLATE_RTOL[str(
              w.dtype).removeprefix("torch.")] for k, w, _ in cases},
          "rel": "per coefficient column, pair lanes as one coefficient",
          "library": ("M2L: per level a gather of (rows, m 2^d K) and one "
                      "torch.matmul with the (m 2^d K, 2^d K) block operator;"
                      " M2M / L2L: torch.matmul + index_add_ per (level, "
                      "digit)") if library else None,
          "kernels": res, "work": works})
    translation.setdefault(path, {}).update(
        {key: (res[key], works[key]) for key in res})
    return res, works


def translation_entries(translation):
    """The summary entries of K35-K37: the main path's float32 numbers,
    every other path's and entry point's beside them."""
    out = []
    main = translation["main path"]["f32"]
    for name in FMM_TRANSLATE:
        r, work = main[0][name], main[1][name]
        e = summary_entry(name, r["launches_per_fmm"], r, work)
        e["bound_ms"], e["bound_by"], e["bound_rate"] = translation_bound(
            work)
        e["library_ms"] = r["library_ms"]
        e["paths"] = {
            f"{path} {key}": {
                "launches": rk[name]["launches_per_fmm"],
                **{f: rk[name][f] for f in (
                    "max_abs_err", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "bound_rate")}}
            for path, by_key in translation.items()
            for key, (rk, _) in by_key.items()
            if (path, key) != ("main path", "f32")}
        out.append(e)
    return out


def run_laplace3d_stability(device, card, translation, order=31,
                            nsources=30):
    """``tests/test_stability.py:28-65``'s (3, 31) case on the card: the
    geometric line (17 levels, separate targets), the complex128 wrangler
    at order 31 with ``rscale="auto"`` (1,024 coefficients a row), its
    FMM against a float64 direct sum within the reference's bar
    (3/4)^(p+1); K2-K4, K28 and K30 (the FMM) and K29 (called on the same
    rows with unit dipoles) launched at that width and held to their
    twins, and K35-K37 likewise (a ``kernels_translation`` line, without
    the library yardstick, whose block operator would take ~29 GB a
    level)."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_laplace_wrangler
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    line = np.array([2.0 ** -i for i in range(nsources // 2)])
    line = np.hstack([line, 3 - line])
    zero = np.zeros(nsources)
    src_np = np.vstack([line, zero, zero])
    tgt_np = src_np * (1 + 1e-3)
    src = torch.as_tensor(src_np, device=device)
    tree = build_tree(src, targets=torch.as_tensor(tgt_np, device=device),
                      max_particles_in_box=2)
    trav = build_traversal(tree)
    w, t_setup, table_launches = laplace_setup(
        lambda: make_laplace_wrangler(trav, order, rscale="auto",
                                      pairs=False), device)
    q = torch.ones(nsources, dtype=torch.float64, device=device)
    kernels.reset_launch_counts()
    pot, t_fmm = timed(lambda: drive_fmm(w, [q]), device)
    launches = kernels.launch_counts()
    diff = src_np[:, None, :] - tgt_np[:, :, None]
    ref = (1 / np.sqrt((diff * diff).sum(0))).sum(1)
    got = pot.real.cpu().numpy()
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    bar = 0.75 ** (order + 1)
    q_tree = w.reorder_sources(q)
    dip = torch.nn.functional.normalize(torch.as_tensor(
        np.random.default_rng(31).standard_normal((3, nsources)),
        device=device), dim=0)
    w.dipole_vec = dip[:, tree.user_source_ids.to(torch.int64)].contiguous()
    inputs = {**laplace3d_inputs(trav, w, q_tree, (
        "p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d")),
        **p2m_l2p_inputs(w, q_tree, (*P2M_L2P_KERNELS,
                                     "p2m_laplace3d_dipole"))}
    w.dipole_vec = None
    kernels.reset_launch_counts()
    kres = check_list_kernels(inputs, device, plain_reps=3,
                              rtol=LAPLACE3D_KERNEL_RTOL["c128"], slow_s=3.0)
    launches["p2m_laplace3d_dipole"] = kernels.launch_counts()[
        "p2m_laplace3d_dipole"]
    names = ("p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d",
             *P2M_L2P_KERNELS, "p2m_laplace3d_dipole", *FMM_TRANSLATE)
    emit({"phase": "laplace3d_stability", "card": card, "order": order,
          "coefficients": w.ncoeff, "sources": nsources,
          "nlevels": tree.nlevels, "nboxes": tree.nboxes,
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "m2l_table_bytes": w._m2l_plan.nbytes,
          "m2l_used_keys": len(w._m2l_plan.used),
          "wrangler_setup_s": t_setup, "fmm_s": t_fmm,
          "rel_linf_vs_f64_direct": rel, "bar": bar,
          "launched_at_width": {n: launches[n] for n in names},
          "launched_by": "the FMM; K29 by its comparison with its twin",
          "kernels_vs_twins": kres,
          "tolerance_rel_linf": LAPLACE3D_KERNEL_RTOL["c128"]})
    if not rel < bar or not np.isfinite(got).all():
        raise AssertionError(f"order-{order} line: rel l-inf {rel:.3e} >= "
                             f"{bar:.3e}")
    missing = [n for n in names if launches[n] <= 0]
    if device.type == "cuda" and missing:
        raise AssertionError(f"order-{order} line: not launched {missing}")
    check_translation(card, device, "line tree order 31",
                      [("c128", w, q)], translation, library=False,
                      rtol=LINE_TRANSLATE_RTOL)
    check_m2l_table(card, device, "line tree order 31", "c128", w, t_setup,
                    table_launches)

# }}}


def _ptxas_summary(log):
    """Registers / spills per kernel from ``nvcc -Xptxas -v``: its "Used
    ... registers" line, and the stack frame and spill line before it."""
    out, entry, frame = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            frame = ""
        elif entry and "spill stores" in line:
            frame = f"; {line.strip()}"
        elif entry and "Used" in line and "registers" in line:
            out[entry] = line.split(":", 1)[-1].strip() + frame
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the package must be there before anything is printed
    from boxtree_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = kernels.build()
    emit({"phase": "build", "card": card,
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": lib.build_seconds,
          "library": str(lib.path.relative_to(lib.path.parents[3])),
          "ptxas": _ptxas_summary(lib.build_log)})

    t_script = time.perf_counter()
    trav_trees, translation, tree_trees = {}, {}, {}
    entries = run_main_path(device, card, trav_trees, translation,
                            tree_trees)
    run_tree_options(device, card)
    b_entries, _ = run_config_b(device, card, trav_trees, tree_trees)
    h_entries = run_helmholtz(device, card, translation)
    e_entries, e_p2m_l2p = run_extents(device, card, trav_trees, translation,
                                       tree_trees)
    h2_entries = run_helmholtz2d(device, card, translation)
    l2_entries = run_laplace2d(device, card, trav_trees, translation)
    l2d = run_laplace2d_dipole(device, card, tree_trees)
    # K40 keeps the 2D Laplace path's complex128 numbers, with the double
    # layer's beside them; K39, K41 and K42 stand by the double layer's
    # complex128 entry points, the float64 pairs' beside them
    for e in l2_entries:
        if e["name"] in l2d:
            e["double_layer"] = {
                k: l2d[e["name"]][k] for k in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by")}
    l2d_entries = [l2d[name] for name in LAPLACE2D_DIPOLE_ONLY]
    l3 = run_laplace3d(device, card, translation)
    run_laplace3d_stability(device, card, translation)
    hd_entries = run_helmholtz3d_dipoles(device, card)
    # K2-K4 keep the main path's float32 numbers, with those of their
    # complex128 entry points beside them; K22 and K23 stand by their
    # complex128 entry points, the float64 pairs' beside them.
    # K28 and K30 keep the main path's float32 numbers, with those of their
    # complex128 entry points (the double layer) and of the extent path's
    # float64 pairs beside them; K29 stands by its complex128 entry point
    for e in entries:
        if e["name"] in l3:
            launches, res, work = l3[e["name"]][:3]
            e["c128"] = entry_point_numbers(launches, res, work)
        if e["name"] in e_p2m_l2p:
            e["f64_extent"] = e_p2m_l2p[e["name"]]
    l3_entries = []
    for name in ("p2p_laplace3d_dipole", "p2l_laplace3d_dipole",
                 "p2m_laplace3d_dipole"):
        launches, res, work, res64, work64 = l3[name]
        entry = summary_entry(name, launches, res, work)
        entry["entry_point"] = "c128"
        entry["f64"] = entry_point_numbers(launches, res64, work64)
        l3_entries.append(entry)
    # K24-K27 and K43 / K44 stand by the main path's numbers, K45 / K46
    # by Config B's, the other trees' beside
    for e in entries + b_entries:
        for name, trees, own in (
                (TRAVERSAL_KERNELS, trav_trees, "main path"),
                (TREE_KERNELS, tree_trees, "main path"),
                (RESTRICT_KERNELS, tree_trees, "Config B")):
            if e["name"] in name:
                e["trees"] = {label: res[e["name"]]
                              for label, res in trees.items()
                              if label != own and e["name"] in res}
    emit({"phase": "done", "card": card,
          "seconds_after_build": time.perf_counter() - t_script})
    print(card, flush=True)
    emit({"kernels": entries + b_entries + h_entries + e_entries
          + h2_entries + l2_entries + l2d_entries + l3_entries
          + translation_entries(translation) + hd_entries
          + m2l_table_entries() + rotation_entries()})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
