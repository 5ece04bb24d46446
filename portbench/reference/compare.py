"""The numbers that decide ``correct``: each the widest gap, or a share of
mismatches, between what the program produced and what the plain reference
computes from the same inputs. A cell compares those that
``portbench/limits/<cell>.json`` gives a limit; the others are printed as
evidence."""

from __future__ import annotations

import torch


def _max(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def compared(ref, prog_weight, sparse: bool):
    """The voxels whose state the program has to match: on a brick volume
    those the reference has in the truncation band (weight > 0 and |d| <
    0.999, which the brick route must update exactly as the dense fusion
    does), on a dense volume every one either side observed."""
    if sparse:
        return (ref.weight > 0) & (torch.abs(ref.sdf.float()) < 0.999)
    return (ref.weight > 0) | (prog_weight > 0)


def fusion_numbers(prog, ref, sparse: bool) -> dict:
    """prog: the program's (sdf, weight, nsample, color) at the voxels the
    reference fused; ref: the reference's ``Fused``; the voxels compared
    as ``compared`` says.

    sdf_gap: the widest |d| gap (d in units of max_dist_neg) over compared
    voxels; color_gap: the widest color gap (0..255) where both observed;
    count_mismatch: the share of compared voxels whose weight or nsample
    differ."""
    p_d, p_w, p_n, p_c = prog
    r_d, r_w = ref.sdf.float(), ref.weight.float()
    cmp = compared(ref, p_w, sparse)
    sdf_gap = _max(torch.abs(p_d - r_d)[cmp])
    counts = cmp & ((p_w != r_w) | (p_n != ref.nsample))
    both = cmp & (p_w > 0) & (r_w > 0)
    out = dict(sdf_gap=sdf_gap, count_mismatch=float(counts.sum()) / max(1, int(cmp.sum())))
    if ref.color is not None and p_c is not None:
        out["color_gap"] = _max(torch.abs(p_c - ref.color.float())[both])
    return out


def render_numbers(prog, ref: dict) -> dict:
    """prog: a render_view result; ref: the reference render of the same
    pose on the same state. depth_gap_mm: the widest depth gap where both
    hit; hit_mismatch: pixels hit by one side only, a share of the
    reference's hits; normal_gap, rgb_gap: the widest gaps where both
    have them."""
    pd, rd = prog.depth, ref["depth"]
    ph, rh = ~torch.isnan(pd), ~torch.isnan(rd)
    both = ph & rh
    out = dict(depth_gap_mm=_max(torch.abs(pd - rd)[both]) * 1e3,
               hit_mismatch=float((ph ^ rh).sum()) / max(1, int(rh.sum())))
    pn, rn = prog.normals, ref["normals"]
    nb = ~torch.isnan(pn[..., 0]) & ~torch.isnan(rn[..., 0])
    out["normal_gap"] = _max(torch.abs(pn - rn)[nb])
    if prog.rgb is not None and "rgb" in ref:
        cb = ~torch.isnan(prog.rgb[..., 0]) & ~torch.isnan(ref["rgb"][..., 0])
        out["rgb_gap"] = _max(torch.abs(prog.rgb - ref["rgb"])[cb])
    return out

