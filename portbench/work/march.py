"""The work of the ray march of one render, counted by the frozen plain
march of ``reference/march.py`` on the same state and pose: nearest-voxel
samples of the march and the backtrack, refined rays (two trilinear queries
each), rays with normals (six more). Operation counts per item are those
counted from ``csrc/raycast.cu`` in ``cpu_tsdf_tpu_torch/ops/raycast_kernel.py``;
the bytes are only the rays' inputs and the 8 output channels (the field's
reads are left out, so the bound is never overstated)."""

from __future__ import annotations

import torch

from portbench.reference.march import render

OPS_PER_SAMPLE = 30
OPS_PER_REFINE = 180
OPS_PER_NORMAL = 535


def render_work(cfg, field, pose, max_steps: int) -> tuple:
    """(bytes, operations) of the march of one render."""
    dev = field.rd.device
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("samples", "refined", "normals")}
    render(cfg, field, pose, max_steps, counts)
    n_rays = cfg.image_width * cfg.image_height
    ops = (int(counts["samples"]) * OPS_PER_SAMPLE + int(counts["refined"]) * OPS_PER_REFINE
           + int(counts["normals"]) * OPS_PER_NORMAL)
    return n_rays * (6 + 8) * 4, ops
