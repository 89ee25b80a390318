"""What the M2L kernel K35 computes, in plain torch from the plan's own
tables, for the CPU tests: the kernel cannot run here, and its twin is the
edge form, so this holds the tables K35 reads (the padded target parents,
their colleague slots, the ``opid`` map, the child tables) to the
reference."""

import torch


def parent_block_m2l(mpole, plan):
    """K35 over *plan* (a :class:`boxtree_torch.ops.translate.ParentBlockPlan`):
    per level, per (slot j, source digit qs, target digit qt) with an
    operator, the sources of the plan's (pair, row) table times the
    operator, summed into the target children that are
    target-or-target-parent boxes."""
    out = torch.zeros_like(mpole)
    rows = plan.rows.to(torch.int64)
    src = plan.src.to(torch.int64)
    nlevels, m, nchild, _ = plan.opid.shape
    for lev in range(nlevels):
        r = torch.nonzero((rows >= 0) & (plan.row_level == lev))[:, 0]
        if not r.numel():
            continue
        acc = mpole.new_zeros(r.shape[0], nchild, mpole.shape[1])
        for jq in range(m * nchild):
            s = src[jq, r]
            ok = s >= 0
            if not bool(ok.any()):
                continue
            a = mpole[s[ok]]
            for qt in range(nchild):
                o = int(plan.opid[lev].reshape(m * nchild, nchild)[jq, qt])
                if o >= 0:
                    acc[ok, qt] += a @ plan.ops[o]
        tgt = plan.tgt_child[rows[r]].to(torch.int64)
        out[tgt[tgt >= 0]] = acc[tgt >= 0]
    return out


def check_rows(plan, tree, pad):
    """The plan's target parents: each level's padded to a multiple of
    *pad* rows, ascending within the level, one level above the row's
    level, and exactly the parents with a target-or-target-parent
    child; the kernel's tables contiguous int32, the source table the
    colleagues' children."""
    for t in (plan.opid, plan.rows, plan.pmap, plan.src, plan.row_level,
              plan.child, plan.tgt_child):
        assert t.dtype == torch.int32 and t.is_contiguous()
    assert plan.ops.is_contiguous()
    # the (pair, row) source table: the colleagues' children by digit
    col = plan.pmap.to(torch.int64)
    want = torch.where((col >= 0)[..., None],
                       plan.child.to(torch.int64)[col.clamp(min=0)], -1)
    assert torch.equal(plan.src.to(torch.int64),
                       want.reshape(col.shape[0], -1).T)
    rows = plan.rows.to(torch.int64)
    lev = plan.row_level.to(torch.int64)
    assert rows.shape[0] % pad == 0
    assert bool((lev[1:] >= lev[:-1]).all())
    for lv in torch.unique(lev).tolist():
        seg = rows[lev == lv]
        assert seg.shape[0] % pad == 0
        real = seg[seg >= 0]
        assert bool((real[1:] > real[:-1]).all())
        assert bool((tree.box_levels.to(torch.int64)[real] == lv - 1).all())
    want = torch.nonzero((plan.tgt_child >= 0).any(dim=1)
                         & (tree.box_levels.to(torch.int64) >= 1))[:, 0]
    assert torch.equal(torch.sort(rows[rows >= 0]).values, want)
