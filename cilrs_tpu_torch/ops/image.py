"""Resizing, ImageNet normalization and train-time augmentation (port of
``cilrs_tpu/ops/image.py``).

Preprocessing matches the reference inference path: resize to 200x88, scale
to [0, 1], normalize. ``augment_batch`` is split in two: ``draw_augment``
takes every random draw of one batch from an explicit ``torch.Generator``
(the per-sample apply masks, brightness, contrast, hue and saturation shifts,
noise and cutout centres, shaped as the JAX function draws them), and
``apply_augment`` is the pure function of (images, draws), which the tests
drive with the JAX package's own draws. Plain torch, on [B, H, W, 3] images
in [0, 1].
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TARGET_H, TARGET_W = 88, 200

# Probability that each augmentation applies to a sample (the notebook's
# Albumentations stack, cilrs_tpu/ops/image.py:85-93).
P_BRIGHTNESS_CONTRAST = 0.5
P_HSV = 0.3
P_BLUR = 0.2
P_NOISE = 0.2
P_CUTOUT = 0.3


@functools.cache
def _mean_std(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    # Made once a device: building them from Python lists on every call is a
    # synchronous host-to-device copy, which would stall the launch queue.
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize(img01: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize an NHWC image already in [0, 1]."""
    mean, std = _mean_std(img01.device)
    return (img01 - mean) / std


def resize_frame(img: torch.Tensor, height: int = TARGET_H, width: int = TARGET_W) -> torch.Tensor:
    """Bilinear resize [..., H, W, C] -> [..., height, width, C] in float32.
    Antialiased when it shrinks, as ``jax.image.resize(method="bilinear")``
    is (half-pixel centres)."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    x = img.float().reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(lead + (height, width, c))


def preprocess_frame(img: torch.Tensor, resize: bool = True) -> torch.Tensor:
    """uint8 (0-255) or float (0-1) RGB frame(s) -> normalized float32 NHWC input."""
    x = img.float()
    if img.dtype == torch.uint8:
        x = x / 255.0
    if resize and (img.shape[-3] != TARGET_H or img.shape[-2] != TARGET_W):
        x = resize_frame(x)
    return normalize(torch.clamp(x, 0.0, 1.0))


def _vec_rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    diff = mx - mn + 1e-8
    h = torch.where(
        mx == r, (g - b) / diff % 6.0,  # % is floor-mod, as jnp's
        torch.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0),
    ) / 6.0
    s = diff / (mx + 1e-8)
    return torch.stack([h % 1.0, s, mx], dim=-1)


def _vec_hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    # jnp.select over i == 0..5: exactly one sector holds, so pick it by index.
    i = (i.to(torch.int32) % 6).long()[..., None]
    r = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, i)[..., 0]
    g = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, i)[..., 0]
    b = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, i)[..., 0]
    return torch.stack([r, g, b], dim=-1)


def _blur3(img: torch.Tensor) -> torch.Tensor:
    """3x3 [0.25, 0.5, 0.25] blur as two separable passes, edges replicated."""
    k0, k1, k2 = 0.25, 0.5, 0.25
    xp = torch.cat([img[:, :1], img, img[:, -1:]], dim=1)
    x = xp[:, :-2] * k0 + xp[:, 1:-1] * k1 + xp[:, 2:] * k2
    xp = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    return xp[:, :, :-2] * k0 + xp[:, :, 1:-1] * k1 + xp[:, :, 2:] * k2


def draw_augment(gen: torch.Generator, b: int, h: int, w: int) -> dict:
    """Every random draw ``augment_batch`` makes for a [b, h, w, 3] batch, on
    ``gen``'s device: apply masks (bool) and parameters, shaped as in the JAX
    function (per-sample [b, 1, 1, 1] or [b, 1, 1]; noise [b, h, w, 3])."""
    dev = gen.device

    def u(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    s4, s3 = (b, 1, 1, 1), (b, 1, 1)
    return {
        "apply_bc": u(s4) < P_BRIGHTNESS_CONTRAST,
        "brightness": u(s4, -0.2, 0.2),
        "contrast": u(s4, 0.8, 1.2),
        "apply_hsv": u(s4) < P_HSV,
        "dh": u(s3, -0.05, 0.05),
        "ds": u(s3, 0.85, 1.15),
        "apply_blur": u(s4) < P_BLUR,
        "apply_noise": u(s4) < P_NOISE,
        "noise": torch.randn((b, h, w, 3), generator=gen, device=dev) * 0.02,
        "apply_cut": u(s4) < P_CUTOUT,
        "cy": u(s3) * h,
        "cx": u(s3) * w,
    }


def apply_augment(images: torch.Tensor, d: dict) -> torch.Tensor:
    """The augmentation of ``cilrs_tpu/ops/image.py:augment_batch`` with the
    draws ``d`` (see ``draw_augment``): brightness/contrast, HSV jitter, blur,
    gaussian noise and one cutout rectangle, each where its mask is set, then
    a clip to [0, 1]. ``images`` [B, H, W, 3] float32 in [0, 1]."""
    _, H, W, _ = images.shape
    x = images
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = torch.where(d["apply_bc"], (x - mean) * d["contrast"] + mean + d["brightness"], x)

    hsv = _vec_rgb_to_hsv(x.clamp(0.0, 1.0))
    hsv = torch.stack([(hsv[..., 0] + d["dh"]) % 1.0, (hsv[..., 1] * d["ds"]).clamp(0, 1),
                       hsv[..., 2]], dim=-1)
    x = torch.where(d["apply_hsv"], _vec_hsv_to_rgb(hsv), x)
    x = torch.where(d["apply_blur"], _blur3(x), x)
    x = torch.where(d["apply_noise"], x + d["noise"], x)

    yy = torch.arange(H, device=x.device)[None, :, None]
    xx = torch.arange(W, device=x.device)[None, None, :]
    inside = ((yy - d["cy"]).abs() < H * 0.1) & ((xx - d["cx"]).abs() < W * 0.1)
    x = torch.where(d["apply_cut"] & inside[..., None], 0.0, x)
    return x.clamp(0.0, 1.0)


def augment_batch(gen: torch.Generator, images: torch.Tensor, batch: int | None = None,
                  rows: slice = slice(None)) -> torch.Tensor:
    """Draw on ``gen`` and augment [B, H, W, 3] images in [0, 1]. With
    ``batch``, the draws are those of a batch of that many images, of which
    ``images`` are ``rows``: a rank's block of a global batch gets the draws
    that one device gets for those rows."""
    b, h, w, _ = images.shape
    d = draw_augment(gen, batch or b, h, w)
    return apply_augment(images, {k: v[rows] for k, v in d.items()})
