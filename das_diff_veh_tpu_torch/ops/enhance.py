"""f-v map enhancement: CLAHE + box blur (mirrors
``das_diff_veh_tpu/ops/enhance.py``; the reference's ``fv_map_enhance``,
modules/utils.py:613-619: normalize -> uint8 -> CLAHE(clipLimit=100,
tileGridSize=(100, 10)) -> 10x10 blur).

OpenCV's CLAHE as integer tensor work: reflect-101 padding so the tiles
divide the image, one ``bincount`` over ``tile*256 + value`` for every
tile's histogram, the clip and OpenCV's redistribution of the excess, the
LUTs (float64 ``round(cdf * 255 / area)``), then per-pixel bilinear
interpolation between the four neighbouring LUTs in float64, computed as
the JAX package's compiled CPU program computes it: XLA turns the division
by the tile size into a product with its reciprocal and fuses each product
with the sum that follows (a fused multiply-add, one rounding).  The port
evaluates those multiply-adds exactly (:func:`_fma`, from error-free
transformations), so it rounds the same float64 values to the same
integers on every device.

The box blur sums each 10x10 patch exactly (integer values, float64) and
divides by the patch area, so its ``round`` sees the exact mean.  The JAX
package convolves in float32, whose summation order decides ties (an exact
mean of k + 0.5) either way; everywhere else the two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from das_diff_veh_tpu_torch.device import on_device


def _pad_reflect101(img: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """cv2 BORDER_REFLECT_101 padding on the bottom/right edges, repeated
    when a pad is wider than the image (numpy's "reflect")."""
    while pad_h > 0:
        n = min(pad_h, img.shape[0] - 1)
        img = torch.cat([img, img[-1 - n:-1].flip(0)], dim=0)
        pad_h -= n
    while pad_w > 0:
        n = min(pad_w, img.shape[1] - 1)
        img = torch.cat([img, img[:, -1 - n:-1].flip(1)], dim=1)
        pad_w -= n
    return img


_SPLITTER = 134217729.0   # 2**27 + 1: Veltkamp's split of a float64


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``(s, e)`` with ``s = fl(a + b)`` and ``s + e = a + b`` exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``(p, e)`` with ``p = fl(a * b)`` and ``p + e = a * b`` exactly
    (Dekker's product on Veltkamp's halves)."""
    def split(x):
        c = _SPLITTER * x
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, in float64 with no fused instruction:
    Boldo and Melquiond's emulated FMA, whose inner sum is rounded to odd."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    # round to odd: an inexact sum whose last bit is even moves one ulp
    # toward the exact value
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((e != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def clahe_u8(img, clip_limit: float = 100.0, tiles: tuple[int, int] = (100, 10),
             device=None) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of a uint8-valued
    image (values 0..255, any integer or float dtype).  ``tiles`` is cv2's
    ``(tilesX, tilesY)``.  Returns int32 values 0..255 on the image's device
    (numpy goes to ``device``, ``None`` = the card)."""
    tx, ty = tiles
    img = on_device(img, device).to(torch.int32)
    dev = img.device
    H, W = img.shape
    th = -(-H // ty)
    tw = -(-W // tx)
    imgp = _pad_reflect101(img, ty * th - H, tx * tw - W)

    # per-tile histograms: one bincount over tile*256 + value
    Hp, Wp = ty * th, tx * tw
    row_tile = torch.arange(Hp, device=dev) // th
    col_tile = torch.arange(Wp, device=dev) // tw
    tile_id = row_tile[:, None] * tx + col_tile[None, :]
    flat_id = (tile_id * 256 + imgp).reshape(-1)
    hist = torch.bincount(flat_id, minlength=ty * tx * 256).reshape(ty * tx, 256)

    # clip + redistribute (OpenCV semantics)
    area = th * tw
    clip = max(int(clip_limit * area / 256.0), 1)
    clipped = torch.clamp(hist, max=clip)
    excess = torch.sum(hist - clipped, dim=1, keepdim=True)
    bin_incr = excess // 256
    residual = excess - bin_incr * 256
    hist2 = clipped + bin_incr
    # OpenCV adds 1 at i = 0, step, 2*step, ... while the residual lasts
    step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
    i = torch.arange(256, device=dev)[None, :]
    gets_one = (i % step == 0) & (i // step < residual)
    hist2 = hist2 + gets_one.to(hist2.dtype)

    # LUTs
    scale = 255.0 / area
    luts = torch.clamp(torch.round(torch.cumsum(hist2, dim=1).to(torch.float64) * scale),
                       0, 255)

    # bilinear interpolation between tile LUTs, with the JAX package's
    # float64 roundings: the coordinate fma(i + 0.5, 1 / t, -0.5), each
    # blend fma(a, 1 - w, fl(b * w))
    def axis(n, t):
        i = torch.arange(n, device=dev, dtype=torch.float64) + 0.5
        f = _fma(i, torch.full_like(i, 1.0 / t), torch.full_like(i, -0.5))
        lo = torch.floor(f)
        return lo.to(torch.int64), f - lo                 # tile below, weight
    y1, wy = axis(H, th)
    x1, wx = axis(W, tw)
    y1c = torch.clamp(y1, 0, ty - 1)[:, None]
    y2c = torch.clamp(y1 + 1, 0, ty - 1)[:, None]
    x1c = torch.clamp(x1, 0, tx - 1)[None, :]
    x2c = torch.clamp(x1 + 1, 0, tx - 1)[None, :]
    wy, wx = wy[:, None], wx[None, :]
    flat = luts.reshape(-1)
    v = img.to(torch.int64)
    lut_at = lambda tyi, txi: flat[(tyi * tx + txi) * 256 + v]
    blend = lambda a, b, w: _fma(a, 1 - w, b * w)
    top = blend(lut_at(y1c, x1c), lut_at(y1c, x2c), wx)
    bot = blend(lut_at(y2c, x1c), lut_at(y2c, x2c), wx)
    out = blend(top, bot, wy)
    return torch.clamp(torch.round(out), 0, 255).to(torch.int32)


def box_blur_u8(img, ksize: int = 10, device=None) -> torch.Tensor:
    """cv2.blur semantics: the mean of each ``ksize x ksize`` patch with
    BORDER_REFLECT_101 edges and the anchor at ``ksize // 2`` (an even kernel
    reaches ``ksize//2`` up/left and ``ksize//2 - 1`` down/right), rounded
    half to even.  The patch sums are exact.  Returns int32 0..255."""
    img = on_device(img, device).to(torch.float64)
    a = ksize // 2
    b = ksize - 1 - a
    img = torch.cat([img[1:1 + a].flip(0), img, img[-1 - b:-1].flip(0)], dim=0)
    img = torch.cat([img[:, 1:1 + a].flip(1), img, img[:, -1 - b:-1].flip(1)], dim=1)
    ones = torch.ones((1, 1, ksize, ksize), dtype=torch.float64, device=img.device)
    sums = F.conv2d(img[None, None], ones)[0, 0]
    return torch.clamp(torch.round(sums / (ksize * ksize)), 0, 255).to(torch.int32)


def fv_map_enhance(fv_map, clip_limit: float = 100.0, tiles: tuple[int, int] = (100, 10),
                   blur_ksize: int = 10, device=None) -> torch.Tensor:
    """The reference's fv_map_enhance: normalize by ``(fv - min) / max``
    (the raw max, not the range), quantize to uint8 by truncation, CLAHE,
    then the box blur.  Returns int32 values 0..255."""
    fv = on_device(fv_map, device)
    mx = torch.max(fv)
    fv = (fv - torch.min(fv)) / torch.where(mx != 0, mx, torch.ones_like(mx))
    u8 = torch.clamp(fv * 255.0, 0, 255).to(torch.int32)   # C-cast truncation
    eq = clahe_u8(u8, clip_limit=clip_limit, tiles=tiles)
    return box_blur_u8(eq, ksize=blur_ksize)
