"""Camera-pose refinement against a fused TSDF volume.

Port of ``cpu_tsdf_tpu.refine``. The residual is point-to-TSDF
(KinectFusion-style): the observed depth image is backprojected, moved by
the pose estimate, and the trilinear TSDF is read there
(``ops.interpolate.tsdf_value_vol``); the fused surface is the zero level
set, so |TSDF| measures the registration error. It does not go through the
ray march. The pose is parameterized in the se(3) tangent at the current
estimate (a left-multiplied twist), so the estimate stays on SE(3).

Every 3x3 and 4x4 product, and the Gauss-Newton normal equations, are
written as elementwise products and sums: they stay full float32 on the
card whatever ``torch.backends.cuda.matmul.allow_tf32`` says (a TF32
product keeps about three decimal digits, which would wreck the step's
conditioning as bf16 does on the TPU).

A step (:func:`_step`) and the residual (:func:`_residual`) are programs of
fixed shapes with no host sync, the counterparts of the JAX package's
jitted ``refine_pose_step`` and ``_residual_jit``: on the card each runs as
a CUDA graph (``graph.refine_graphed``) keyed by the volume, the depth's
shape and ``downsample_by``, its pose, depth and step scale static input
buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import tracing
from .geometry import div_const


def _mm(a, b):
    """a @ b for [n, k] x [k, m] in full float32 (elementwise, no TF32)."""
    return (a[:, :, None] * b[None, :, :]).sum(1)


def exp_se3(twist):
    """Exponential map se(3) -> SE(3) as a float32 [4, 4] tensor; twist =
    (v[3], w[3]) on any device.

    Below |w| = 1e-6 the map is the identity rotation and V = I, selected by
    ``torch.where`` as the JAX package does, so the derivative of the pose
    with respect to w is exactly 0 there (the other branch's tangents stay
    finite and are not selected)."""
    if not torch.is_tensor(twist):
        twist = torch.tensor(twist, dtype=torch.float32)
    v, w = twist[:3], twist[3:]
    theta = torch.sqrt(torch.sum(w * w) + 1e-20)
    zero = torch.zeros_like(theta)
    K = torch.stack([
        torch.stack([zero, -w[2], w[1]]),
        torch.stack([w[2], zero, -w[0]]),
        torch.stack([-w[1], w[0], zero]),
    ]) / theta
    s, c = torch.sin(theta), torch.cos(theta)
    eye = torch.eye(3, dtype=torch.float32, device=twist.device)
    KK = _mm(K, K)
    R = eye + s * K + (1.0 - c) * KK
    V = eye + (1.0 - c) / theta * K + (theta - s) / theta * KK
    small = theta < 1e-6
    R = torch.where(small, eye, R)
    V = torch.where(small, eye, V)
    t = (V * v[None, :]).sum(1)
    # made on the device: a row copied from the host would be a host sync
    bottom = torch.eye(4, dtype=torch.float32, device=twist.device)[3:]
    return torch.cat([torch.cat([R, t[:, None]], 1), bottom], 0)


def _compose(a, b):
    """4x4 pose composition a @ b in full float32."""
    return _mm(a, b)


def depth_residual(vol, pose, depth_obs, downsample_by: int = 1,
                   max_steps: int = 256, *, graph: Optional[bool] = None):
    """Point-to-TSDF alignment loss: the mean Huber (delta = 0.01 m) of the
    valid points' residuals, as a 0-dim tensor. `max_steps` is accepted and
    unused, as in the JAX package. graph: None = the residual's CUDA graph
    on the card, eager on the CPU; False = eager; True on the CPU raises."""
    from .graph import refine_graphed, resolve_graph

    dev = vol.device
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    depth_obs = torch.as_tensor(depth_obs, dtype=torch.float32, device=dev)
    if resolve_graph(graph, dev):
        return refine_graphed("residual", vol, [pose, depth_obs], downsample_by)
    return _residual(vol, pose, depth_obs, downsample_by=downsample_by)


def _residual(vol, pose, depth_obs, downsample_by: int):
    """depth_residual on device tensors: fixed shapes, no host sync."""
    r, valid = _alignment_residuals(vol, pose, depth_obs, downsample_by)
    delta = 0.01
    hub = torch.where(torch.abs(r) < delta, 0.5 * r * r,
                      delta * (torch.abs(r) - 0.5 * delta))
    hub = torch.where(valid, hub, torch.zeros_like(hub))
    return torch.sum(hub) / torch.clamp(torch.sum(valid), min=1)


def _alignment_residuals(vol, pose, depth_obs, downsample_by: int):
    """Per-point TSDF residuals (meters) and validity for the alignment."""
    from .ops.interpolate import tsdf_value_vol

    cfg = vol.config
    dev = vol.device
    obs = depth_obs[::downsample_by, ::downsample_by]
    H, W = obs.shape
    uu = torch.arange(W, dtype=torch.float32, device=dev)[None, :] * downsample_by
    vv = torch.arange(H, dtype=torch.float32, device=dev)[:, None] * downsample_by
    x = div_const(uu - cfg.principal_point_x, cfg.focal_length_x) * obs
    y = div_const(vv - cfg.principal_point_y, cfg.focal_length_y) * obs
    ok = ~torch.isnan(obs)
    zs = torch.where(ok, obs, torch.ones_like(obs))
    xs = torch.where(ok, x, torch.zeros_like(x))
    ys = torch.where(ok, y, torch.zeros_like(y))
    px = pose[0, 0] * xs + pose[0, 1] * ys + pose[0, 2] * zs + pose[0, 3]
    py = pose[1, 0] * xs + pose[1, 1] * ys + pose[1, 2] * zs + pose[1, 3]
    pz = pose[2, 0] * xs + pose[2, 1] * ys + pose[2, 2] * zs + pose[2, 3]
    val, valid = tsdf_value_vol(vol, px.reshape(-1), py.reshape(-1), pz.reshape(-1))
    return val * cfg.max_dist_neg, valid & ok.reshape(-1)


def refine_pose_step(vol, pose, depth_obs, downsample_by: int = 1,
                     max_steps: int = 256, lr=1.0, *, graph: Optional[bool] = None):
    """One damped Gauss-Newton step on the se(3) tangent. Returns
    (new_pose, loss) as tensors on the volume's device. `lr` (a number or a
    0-dim tensor) acts as the step scale (1.0 = full GN step) and its
    inverse as Levenberg damping.

    The Jacobian is taken by forward mode (``torch.func.jacfwd``, six
    tangents) at the zero twist, where :func:`exp_se3` selects its small
    branch: the rotation columns of J are exactly 0 and every step moves
    the translation only (the JAX package's semantics). graph: None = the
    step's CUDA graph on the card, eager on the CPU; False = eager; True on
    the CPU raises. The tracing call ``refine_pose_step``."""
    from .graph import refine_graphed, resolve_graph

    dev = vol.device
    with tracing.call("refine_pose_step", dev):
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        depth_obs = torch.as_tensor(depth_obs, dtype=torch.float32, device=dev)
        # a fill on the device, not a copy of a host number
        lr = (lr.to(device=dev, dtype=torch.float32) if torch.is_tensor(lr)
              else torch.full((), float(lr), dtype=torch.float32, device=dev))
        if resolve_graph(graph, dev):
            return refine_graphed("step", vol, [pose, depth_obs, lr], downsample_by)
        return _step(vol, pose, depth_obs, lr, downsample_by=downsample_by)


def _step(vol, pose, depth_obs, lr, downsample_by: int):
    """refine_pose_step on device tensors (lr a 0-dim tensor): fixed
    shapes, no host sync."""
    J, r0, valid = _jacobian(vol, pose, depth_obs, downsample_by)
    delta = _damped_step(J, r0, lr)
    loss = torch.sum(r0 * r0) / torch.clamp(torch.sum(valid), min=1)
    return _compose(exp_se3(delta), pose), loss


def _jacobian(vol, pose, depth_obs, downsample_by: int):
    """(J [N, 6], masked residuals r0 [N], valid [N]) of the alignment
    residual with respect to a left twist of `pose`, at the zero twist."""

    def res_fn(twist):
        r, valid = _alignment_residuals(vol, _compose(exp_se3(twist), pose),
                                        depth_obs, downsample_by)
        return torch.where(valid, r, torch.zeros_like(r)), valid

    twist0 = torch.zeros(6, dtype=torch.float32, device=vol.device)
    r0, valid = res_fn(twist0)
    # forward mode: 6 tangents, cheaper than reverse mode for a 6-dim input
    J = torch.func.jacfwd(lambda t: res_fn(t)[0])(twist0)
    return J, r0, valid


def _damped_step(J, r0, lr):
    """The damped Gauss-Newton twist: lam = (1 / max(lr, 1e-6) - 1) + 1e-3,
    scaled by trace(JtJ) / 6, and the twist norm capped at 5 cm / 0.05
    rad. ``solve_ex`` does not check for errors (that check is a host
    sync); where the system is singular (no valid point: JtJ = 0) the twist
    is NaN, as the JAX package's LU solve gives there."""
    dev = J.device
    JtJ = (J[:, :, None] * J[:, None, :]).sum(0)
    Jtr = (J * r0[:, None]).sum(0)
    lam = (1.0 / torch.clamp(lr, min=1e-6) - 1.0) + 1e-3
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    delta, info = torch.linalg.solve_ex(JtJ + lam * torch.trace(JtJ) / 6.0 * eye, Jtr)
    delta = torch.where(info == 0, -delta, float("nan"))
    nrm = torch.linalg.vector_norm(delta)
    return torch.where(nrm > 0.05, delta * (0.05 / nrm), delta)


def refine_pose(vol, pose_init, depth_obs, iters: int = 20,
                downsample_by: int = 2, max_steps: int = 256,
                lr: float = 1.0, *, graph: Optional[bool] = None) -> Tuple[torch.Tensor, list]:
    """Levenberg-style pose refinement: damped Gauss-Newton steps, accepted
    only when they lower the alignment residual (lr = 1.0 means undamped GN;
    a rejected step quarters the step scale, an accepted one doubles it up
    to lr). Returns (pose, losses): the refined float32 [4, 4] pose on the
    volume's device and the best loss after each iteration (one host sync
    an iteration). graph: the step's and the residual's route, as in
    :func:`refine_pose_step`."""
    dev = vol.device
    pose = torch.as_tensor(pose_init, dtype=torch.float32, device=dev)
    depth_obs = torch.as_tensor(depth_obs, dtype=torch.float32, device=dev)
    best = float(depth_residual(vol, pose, depth_obs, downsample_by, max_steps, graph=graph))
    losses = [best]
    step = lr
    for _ in range(iters):
        cand, _ = refine_pose_step(vol, pose, depth_obs, downsample_by, max_steps, step,
                                   graph=graph)
        cand_loss = float(depth_residual(vol, cand, depth_obs, downsample_by, max_steps,
                                         graph=graph))
        if cand_loss < best:
            pose = cand
            best = cand_loss
            step = min(step * 2.0, lr)
        else:
            step *= 0.25
            if step < lr * 1e-4:
                break
        losses.append(best)
    return pose, losses
