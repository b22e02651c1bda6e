"""The plain reference of an unbound (3D Gaussian Splatting) training step.

Plain PyTorch on `reference.py`'s own functions, imported as they are: the
Gaussians' leaves are world-space (no FLAME, no binding), activated as 3DGS
activates them (exp of the scales, normalised rotations, sigmoid of the
opacity), then `reference.project`, `reference.sh_colors`,
`reference.tile_lists` and the block compositing of
`reference.render_screen` / `reference.backward_screen`, the L1 + D-SSIM
loss with `reference.ssim`, the densification statistics and Adam. There
is no regulariser: the reference's unbound step has none. It imports
nothing of the program.
"""
from __future__ import annotations

import dataclasses

import torch

from . import reference
from .reference import GAUSS_LEAVES, Precision, TrainState


def world(g: dict):
    """3DGS's activations of world-space leaves: (means, scales, rotations,
    opacity, SH)."""
    return (g["means"], torch.exp(g["log_scales"]), reference.quat_normalize(g["quats"]),
            torch.sigmoid(g["logit_opacity"][:, 0]), torch.cat([g["sh_dc"], g["sh_rest"]], 1))


def geometry(g: dict, alive, cam: dict):
    """Projection, view colours and the screen opacity (zero where culled)."""
    means, scales, quats, opacity, sh = world(g)
    proj = reference.project(means, scales, quats, cam, alive)
    colors = reference.sh_colors(means, sh, cam["camera_center"])
    return proj, colors, torch.where(proj["mask"], opacity, torch.zeros_like(opacity))


def render(g: dict, alive, cam: dict, bg, tile: int,
           prec: Precision = Precision()) -> reference.Frame:
    """One view, no gradient."""
    with torch.no_grad():
        proj, colors, opac = geometry(g, alive, cam)
        lists = reference.tile_lists(proj, opac, cam["height"], cam["width"], tile)
        screen = (proj["mean2d"], proj["conic"], colors, opac)
    return reference.render_screen(screen, lists, cam, bg, tile, prec)


def learning_rates(opt: dict, step: int, spatial_lr_scale: float) -> dict:
    """The Gaussians' rates of the recipe (`reference.learning_rates`, which
    also names FLAME's, unused here)."""
    rates = reference.learning_rates(
        dict(opt, flame_expr_lr=0.0, flame_pose_lr=0.0, flame_trans_lr=0.0), step,
        spatial_lr_scale)
    return {k: rates[k] for k in GAUSS_LEAVES}


def adam_step(st: TrainState, grads: dict, lrs: dict) -> TrainState:
    """Adam (β 0.9 / 0.999, ε 1e-15) of every leaf at step `st.step + 1`."""
    step = st.step + 1
    c1, c2 = 1 - 0.9 ** step, 1 - 0.999 ** step
    mu, nu, new = {}, {}, {}
    with torch.no_grad():
        for k, p in st.leaves.items():
            mu[k] = 0.9 * st.mu[k] + 0.1 * grads[k]
            nu[k] = 0.999 * st.nu[k] + 0.001 * grads[k] * grads[k]
            new[k] = p - lrs[k] * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-15)
    return dataclasses.replace(st, leaves=new, mu=mu, nu=nu, step=step)


def step_grads(st: TrainState, gt, cam: dict, bg, opt: dict, tile: int,
               prec: Precision = Precision(), fault: str = "") -> tuple:
    """The loss of one view and its gradients: (loss, gradients by leaf,
    densification increments (accum, denom), the view's compositor work).
    `fault` "half_image" takes the loss over the top half of the rows."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in st.leaves.items()}
    proj, colors, opac = geometry(leaves, st.alive, cam)
    screen = tuple(x.detach().requires_grad_() for x in
                   (proj["mean2d"], proj["conic"], colors, opac))
    lists = reference.tile_lists({k: v.detach() for k, v in proj.items()}, opac.detach(),
                                 cam["height"], cam["width"], tile)
    frame = reference.render_screen(screen, lists, cam, bg, tile, prec)
    img = frame.image.detach().requires_grad_()
    pred, target = img, gt
    if fault == "half_image":
        pred, target = img[: img.shape[0] // 2], gt[: img.shape[0] // 2]
    lam = opt["lambda_dssim"]
    loss = ((1 - lam) * (pred - target).abs().mean()
            + lam * (1 - reference.ssim(pred.permute(2, 0, 1), target.permute(2, 0, 1), prec)))
    (g_img,) = torch.autograd.grad(loss, img)
    reference.backward_screen(frame, g_img, cam, bg, tile, prec)
    torch.autograd.backward([proj["mean2d"], proj["conic"], colors, opac],
                            [s.grad for s in screen])
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad) for k, v in leaves.items()}
    visible = proj["radius"] > 0
    gm = screen[0].grad * torch.tensor([cam["width"] * 0.5, cam["height"] * 0.5],
                                       device=img.device)
    zero = torch.zeros((), device=img.device)
    accum = torch.where(visible, torch.linalg.norm(gm, dim=-1), zero)
    return float(loss.detach()), grads, (accum, visible.float()), frame.work


def train_step(st: TrainState, gt, cam: dict, bg, opt: dict, tile: int,
               prec: Precision = Precision(), fault: str = "") -> tuple:
    """One step: (new state, loss, gradients by leaf, the view's compositor
    work). `opt` holds the recipe's rates and `spatial_lr_scale`."""
    loss, grads, (accum, denom), work = step_grads(st, gt, cam, bg, opt, tile, prec, fault)
    st = dataclasses.replace(st, grad_accum=st.grad_accum + accum, denom=st.denom + denom)
    lrs = learning_rates(opt, st.step + 1, opt["spatial_lr_scale"])
    return adam_step(st, grads, lrs), loss, grads, work
