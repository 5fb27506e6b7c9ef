"""Image warping / resampling as torch ops.

Port of colmap_tpu/image/warp.py (reference: src/colmap/image/warp.h,
WarpImageBetweenCameras, WarpImageWithHomography): every warp is a dense
bilinear gather over the target pixel grid, on the device of the image it
is given. The border rules are the JAX module's: a tap outside the image
reads `fill`, so a sample near the border blends towards it.
"""

from __future__ import annotations

import torch

from colmap_tpu_torch.sensor import models as cm


def bilinear_sample(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Sample [H, W] (or [H, W, C]) image at float coords; fill outside."""
    h, w = image.shape[:2]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    if image.ndim == 3:
        fy, fx = fy[..., None], fx[..., None]
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if image.ndim == 3:
            inb = inb[..., None]
        return torch.where(inb, v, torch.full_like(v, fill))

    return ((1 - fy) * (1 - fx) * tap(y0i, x0i)
            + (1 - fy) * fx * tap(y0i, x0i + 1)
            + fy * (1 - fx) * tap(y0i + 1, x0i)
            + fy * fx * tap(y0i + 1, x0i + 1))


def warp_with_homography(image: torch.Tensor, H_dst_from_src: torch.Tensor,
                         out_shape: tuple) -> torch.Tensor:
    """Warp so that out(x) = image(H^-1 x).

    H maps source pixel -> destination pixel (reference:
    WarpImageWithHomography, warp.cc).
    """
    oh, ow = out_shape
    Hinv = torch.linalg.inv(H_dst_from_src)
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=image.device),
        torch.arange(ow, dtype=torch.float32, device=image.device),
        indexing="ij")
    src = [Hinv[r, 0] * xs + Hinv[r, 1] * ys + Hinv[r, 2] for r in range(3)]
    sz = torch.where(torch.abs(src[2]) < 1e-12,
                     torch.full_like(src[2], 1e-12), src[2])
    return bilinear_sample(image, src[1] / sz, src[0] / sz)


def warp_between_cameras(image: torch.Tensor,
                         src_model_id: int, src_params: torch.Tensor,
                         dst_model_id: int, dst_params: torch.Tensor,
                         out_shape: tuple) -> torch.Tensor:
    """out(x_dst) = image(img_from_cam_src(cam_from_img_dst(x_dst))).

    Reference: WarpImageBetweenCameras (warp.cc), used by undistortion.
    """
    oh, ow = out_shape
    ys, xs = torch.meshgrid(
        torch.arange(oh, device=image.device),
        torch.arange(ow, device=image.device), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.float32) + 0.5
    uv = cm.cam_from_img(dst_model_id, dst_params, xy)
    src_xy = (cm.img_from_cam(src_model_id, src_params, uv) - 0.5).reshape(
        oh, ow, 2)
    return bilinear_sample(image, src_xy[..., 1], src_xy[..., 0])
