"""Port parity: the port's render against the JAX package's Pallas ray-march
kernel (interpret mode on the CPU), at tests/test_pallas_raycast.py's
tolerances.

The Pallas kernel anchors each (brick, tile) pair's march at the pair's own
segment entry, so its brackets can sit up to half a cell from the global
grid that the port (and the JAX package's XLA march) walks; the gates are
therefore the Pallas test's own: validity agreement > 0.97, median depth
error < 1e-4, 80 % of depths within 2 mm, normals within a median of 0.5
degrees. One interpret-mode render of the 64x48 scene costs about a minute
on a CPU, so this file makes exactly one and both tests share it. Its pair
list holds 1024 pairs: the scene needs fewer (512 do not overflow, so the
render is the kernel's and not the XLA fallback's), and the interpreter's
work grows with the list (4096 pairs give the same render bit for bit in
twice the time).
"""

import numpy as np
import pytest

from cpu_tsdf_tpu.ops.pallas_raycast import render_view_pallas
from cpu_tsdf_tpu_torch import render_view

from test_torch_render import _scene
import torch_common  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def renders():
    jbv, tbv, pose, _ = _scene()
    rp = render_view_pallas(jbv, pose, colored=True, r_budget=1024, pair_budget=1024,
                            interpret=True)
    return rp, render_view(tbv, pose, colored=True)


def test_depth_matches_pallas_kernel(renders):
    rp, rt = renders
    dp, dt = np.asarray(rp.depth), rt.depth.numpy()
    vp, vt = ~np.isnan(dp), ~np.isnan(dt)
    both = vp & vt
    err = np.abs(dp[both] - dt[both])
    print(f"vs Pallas: validity agreement {(vp == vt).mean():.4f}, depth error median "
          f"{np.median(err):.3g}, within 2 mm {(err < 2e-3).mean():.4f}")
    assert vt.sum() > 800
    assert (vp == vt).mean() > 0.97
    assert np.median(err) < 1e-4
    assert (err < 2e-3).mean() > 0.8


def test_normals_and_colors_match_pallas_kernel(renders):
    rp, rt = renders
    npk, nt = np.asarray(rp.normals), rt.normals.numpy()
    bn = ~np.isnan(npk[..., 0]) & ~np.isnan(nt[..., 0])
    dots = np.clip((npk[bn] * nt[bn]).sum(-1), -1, 1)
    print(f"vs Pallas: normal angle median {np.median(np.degrees(np.arccos(dots))):.3g} "
          f"deg over {bn.sum()} normals")
    assert bn.sum() > 600
    assert np.median(np.degrees(np.arccos(dots))) < 0.5
    assert (dots > 0.99).mean() > 0.9
    cp, ct = np.asarray(rp.rgb), rt.rgb.numpy()
    bc = ~np.isnan(cp[..., 0]) & ~np.isnan(ct[..., 0])
    assert bc.sum() > 500
    np.testing.assert_allclose(ct[bc].mean(0), cp[bc].mean(0), atol=2.0)
