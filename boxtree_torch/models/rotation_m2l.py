"""Point-and-shoot ("rotation") M2L for the 3D Laplace wranglers.

Port of :mod:`boxtree_tpu.models.rotation_m2l` (``rotation_m2l.py:
85-240``), the counterpart of boxtree's pyfmmlib rotation data: instead
of one dense ``(K, K)`` operator per edge (O(p^4) work), each List-2 edge
runs rotate -> axial translate -> rotate back (O(p^3)).  With ``R`` the
rotation taking the translation's direction to +z and ``W_A`` / ``W_S``
the per-degree blocks with ``A(R x) = W_A A(x)`` and ``S(R x) = W_S
S(x)`` for the regular and the irregular basis,

    ``T(t) = conj(W_A)^T T(|t| z) W_S^-T``,

so a multipole row runs ``L = ((M W_S^-1) T(|t| z)^T) conj(W_A)``.  The
axial operator ``T(|t| z)`` vanishes but for ``m_out = -m_in``: one
``(p+1-|m|)^2`` block per ``m``.

The rotation blocks are fit on the host in numpy, per rotation class (the
offsets divided by their GCD), by least squares on the reference's
seed-42 sample of unit vectors, with the port's own numpy solid harmonics;
the axial operators come from the port's M2L table builder
(:func:`boxtree_torch.ops.m2l_ops.m2l_table_3d`, K69 on the card) at the
translations ``(0, 0, |t|)``, in complex128.  The blocks are stored once
per rotation class with each operator's class index, where the reference
stores them once per operator, and applied by
:func:`boxtree_torch.ops.rotation.m2l_rotation` (K77-K79).

Only the 3D Laplace wranglers take it: on the 3D Helmholtz wranglers the
reference fails its own delta-sparsity check of the axial operators
(``rotation_m2l.py:213-215``: the Helmholtz coefficients do not rotate
with the Laplace S basis blocks), so the port refuses there.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from boxtree_torch.ops import m2l_ops, rotation
from boxtree_torch.ops import solid_harmonics as sh


def _rotation_to_z(u):
    """3x3 rotation R with R u = z (u a unit vector)."""
    z = np.array([0.0, 0.0, 1.0])
    c = float(u @ z)
    if c > 1 - 1e-12:
        return np.eye(3)
    if c < -1 + 1e-12:
        return np.diag([1.0, -1.0, -1.0])     # 180 deg about x
    axis = np.cross(u, z)
    s = np.linalg.norm(axis)
    axis = axis / s
    kx = np.array([[0, -axis[2], axis[1]],
                   [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + s * kx + (1 - c) * (kx @ kx)


def _fit_rotation_blocks(R, p, sample, basis=None):
    """Per-degree blocks ``W_n`` with ``B_n(R x) = W_n B_n(x)`` for the
    basis ``B`` (default the regular basis; ``sh.irregular`` for the S
    basis, which rotates with other blocks), fit by least squares on the
    unit vectors *sample* ``(3, S)``."""
    basis = basis or sh.regular
    a_x = basis(sample, p)                    # (S, K)
    a_rx = basis(R @ sample, p)
    blocks = []
    for n in range(p + 1):
        sl = slice(n * n, (n + 1) * (n + 1))
        wt, *_ = np.linalg.lstsq(a_x[:, sl], a_rx[:, sl], rcond=None)
        blocks.append(wt.T)                   # W_n (column convention)
    return blocks


def axial_index(p):
    """``(rows, cols)`` into a transposed ``(K, K)`` table: the entries of
    each ``m``'s axial block ``A_m[n' - |m|, n - |m|] = T[(n, m), (n',
    -m)]``, ``m = -p .. p``, each block row-major."""
    rows, cols = [], []
    for m in range(-p, p + 1):
        ns = np.arange(abs(m), p + 1)
        src = ns * ns + ns - m                # (n', -m): the table's row
        dst = ns * ns + ns + m                # (n, m): its column
        rows.append(np.repeat(src, len(ns)))
        cols.append(np.tile(dst, len(ns)))
    return np.concatenate(rows), np.concatenate(cols)


class RotationM2L:
    """Precomputed rotation M2L of a 3D Laplace wrangler over its edge
    plan (``wrangler.m2l_plan``, a :class:`~boxtree_torch.models.
    particle_blocks.M2LPlan`); see the module doc.

    .. attribute:: blocks

        :class:`~boxtree_torch.ops.rotation.RotationBlocks`.

    .. attribute:: nrotations

        Number of rotation classes.

    .. attribute:: seconds

        Host seconds of the setup's parts: ``blocks`` (the fits) and
        ``axial`` (the axial operators, ending in the check's host read).
    """

    def __init__(self, wrangler):
        t0 = time.perf_counter()
        plan = wrangler.m2l_plan
        p = wrangler.order
        self.order = p
        self.pairs = not wrangler.dtype.is_complex
        dev = wrangler.device
        root = wrangler.root_extent

        # rotation classes: GCD-normalized integer directions
        rc_of_op = np.zeros(plan.nops, np.int64)
        dirs = {}
        ts, rs, levels = [], [], []
        for opi, (lev, c) in enumerate(plan.used):
            v = plan.offsets[c].astype(np.int64)
            g = math.gcd(math.gcd(abs(int(v[0])), abs(int(v[1]))),
                         abs(int(v[2])))
            key = tuple(v // max(g, 1))
            rc_of_op[opi] = dirs.setdefault(key, len(dirs))
            ts.append(v.astype(np.float64) * (root / (1 << lev)))
            rs.append(float(wrangler._rscale_np[lev]))
            levels.append(lev)
        self.nrotations = len(dirs)

        rng = np.random.default_rng(42)
        sample = rng.standard_normal((3, 2 * p + 7))
        sample /= np.linalg.norm(sample, axis=0)

        # per rotation class, degree after degree: W_S^-1 (rotate) and
        # conj(W_A) (unrotate), for row vectors
        _, nb = rotation.rotation_offsets(p)
        rot = np.zeros((len(dirs), nb), np.complex128)
        unrot = np.zeros((len(dirs), nb), np.complex128)
        for rc, key in enumerate(dirs):       # insertion order = rc id
            u = np.asarray(key, np.float64)
            u /= np.linalg.norm(u)
            rz = _rotation_to_z(u)
            wa = _fit_rotation_blocks(rz, p, sample)
            ws = _fit_rotation_blocks(rz, p, sample, basis=sh.irregular)
            rot[rc] = np.concatenate(
                [np.linalg.inv(b).ravel() for b in ws])
            unrot[rc] = np.concatenate([np.conj(b).ravel() for b in wa])

        # the axial blocks, from the M2L table at (0, 0, |t|)
        t1 = time.perf_counter()
        t_ax = np.zeros((plan.nops, 3))
        if plan.nops:
            t_ax[:, 2] = np.linalg.norm(np.stack(ts), axis=1)
        table = m2l_ops.m2l_table_3d(t_ax, rs, levels, p, torch.complex128,
                                     dev)
        rows, cols = axial_index(p)
        ax = table[:, torch.as_tensor(rows, device=dev),
                   torch.as_tensor(cols, device=dev)].contiguous()
        # everything outside the delta pattern m_out = -m_in must be 0
        nm_m = np.concatenate([np.arange(-n, n + 1) for n in range(p + 1)])
        off = torch.as_tensor(nm_m[:, None] + nm_m[None, :] != 0,
                              device=dev)
        if plan.nops:
            ratio = (table.abs() * off).amax(dim=(1, 2)) / table.abs().amax(
                dim=(1, 2)).clamp(min=1e-300)
            offpat = float(ratio.max())
            if offpat > 1e-10:
                raise AssertionError(
                    f"axial M2L operator not delta-sparse: {offpat}")

        self.seconds = {"blocks": t1 - t0,
                        "axial": time.perf_counter() - t1}
        self.blocks = rotation.RotationBlocks(
            order=p,
            rc_of_op=torch.as_tensor(rc_of_op.astype(np.int32), device=dev),
            rot=torch.as_tensor(rot, device=dev),
            unrot=torch.as_tensor(unrot, device=dev), ax=ax)

    def apply(self, mpole_exps, edges):
        """Local expansions of the rotation M2L of *mpole_exps* over the
        operator-sorted *edges*."""
        return rotation.m2l_rotation(mpole_exps, edges, self.blocks)
