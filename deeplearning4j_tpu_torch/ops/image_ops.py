"""Image ops: colour conversions, resizes, crops, photometric
adjustments and detection helpers.

Counterpart of ``deeplearning4j_tpu/ops/image_ops.py`` (the reference's
``headers/images.h``), registered under the JAX package's names.
Channels are the trailing axis, as there.

The resizes are ``jax.image.resize``'s: half-pixel centres and, on a
downscale, the kernel widened by the scale (``antialias=True``);
"linear" is the triangle kernel, "cubic" Keys' with a = -0.5 (torch's
bicubic takes -0.75), and Lanczos of radius 3 or 5. ``F.interpolate``
matches none of this in general, so each spatial axis gets jax's
scale-and-translate weights as one ``[in, out]`` matrix, applied as a
product. "nearest" gathers ``floor((i + 0.5) * in / out)``.
``non_max_suppression`` is greedy NMS over a stable descending sort,
``min(n, max_out)`` rounds of tensor ops with no host sync, padded
with -1 (int32).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import op

# -- colour space conversions ---------------------------------------------

_YIQ = np.array([[0.299, 0.587, 0.114],
                 [0.595716, -0.274453, -0.321263],
                 [0.211456, -0.522591, 0.311135]], np.float32)
_YUV = np.array([[0.299, 0.587, 0.114],
                 [-0.14714119, -0.28886916, 0.43601035],
                 [0.61497538, -0.51496512, -0.10001026]], np.float32)
_MATS = {"yiq": _YIQ, "rgb_from_yiq": np.linalg.inv(_YIQ),
         "yuv": _YUV, "rgb_from_yuv": np.linalg.inv(_YUV)}


def _mix(x, name):
    """``x[..., c]`` mixed by the 3x3 matrix ``name`` (rows: outputs)."""
    m = torch.as_tensor(_MATS[name], device=x.device)
    return torch.matmul(x, m.T.to(x.dtype))


@op("rgb_to_yiq", "images")
def rgb_to_yiq(x):
    return _mix(x, "yiq")


@op("yiq_to_rgb", "images")
def yiq_to_rgb(x):
    return _mix(x, "rgb_from_yiq")


@op("rgb_to_yuv", "images")
def rgb_to_yuv(x):
    return _mix(x, "yuv")


@op("yuv_to_rgb", "images")
def yuv_to_rgb(x):
    return _mix(x, "rgb_from_yuv")


@op("rgb_to_grs", "images")
def rgb_to_grs(x):
    w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=x.dtype,
                     device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


@op("rgb_to_hsv", "images")
def rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    diff = mx - mn
    one = torch.ones_like(diff)
    zero = torch.zeros_like(diff)
    safe = torch.where(diff == 0, one, diff)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0))
    h = torch.where(diff == 0, zero, h) / 6.0
    s = torch.where(mx == 0, zero, diff / torch.where(mx == 0, one, mx))
    return torch.stack([h, s, mx], dim=-1)


@op("hsv_to_rgb", "images")
def hsv_to_rgb(x):
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    # (r, g, b) for sector i = 0..5
    table = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q))
    out = []
    for ch in range(3):
        val = torch.zeros_like(v)
        for sector in range(5, -1, -1):
            val = torch.where(i == sector, table[sector][ch], val)
        out.append(val)
    return torch.stack(out, dim=-1)


# -- resize family --------------------------------------------------------

def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius):
    def fill(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        den = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return fill


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _weight_mat(in_size, out_size, kernel, antialias, device):
    """jax.image's ``compute_weight_mat`` (f32): the ``[in, out]``
    weights of output sample ``j`` over the input pixels."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = torch.float32
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        in_size, dtype=f32, device=device)[:, None]) / kernel_scale
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(in_size, out_size, device):
    off = (torch.arange(out_size, dtype=torch.float32, device=device)
           + 0.5) * in_size / out_size
    return torch.floor(off).long()


def _resize(x, size, method, antialias=True):
    """``x`` ``[B, H, W, C]`` or ``[H, W, C]`` resized to ``size`` (h, w)."""
    if x.dim() not in (3, 4):
        raise ValueError("resize expects [B,H,W,C] or [H,W,C]")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    size = tuple(int(s) for s in size)
    h_ax = x.dim() - 3
    for ax, n in zip((h_ax, h_ax + 1), size):
        m = x.shape[ax]
        if m == n:
            continue
        if method == "nearest":
            x = torch.index_select(x, ax, _nearest_index(m, n, x.device))
            continue
        w = _weight_mat(m, n, _KERNELS[method], antialias,
                        x.device).to(x.dtype)
        x = torch.movedim(torch.matmul(torch.movedim(x, ax, -1), w), -1, ax)
    return x


@op("resize_bilinear", "images")
def resize_bilinear(x, size=None, height=None, width=None, **_):
    return _resize(x, size or (height, width), "linear")


@op("resize_nearest_neighbor", "images")
def resize_nearest_neighbor(x, size=None, height=None, width=None, **_):
    return _resize(x, size or (height, width), "nearest")


@op("resize_bicubic", "images")
def resize_bicubic(x, size=None, height=None, width=None, **_):
    return _resize(x, size or (height, width), "cubic")


@op("resize_area", "images")
def resize_area(x, size=None, height=None, width=None, **_):
    """Area resize as the JAX package's: the antialiased linear resize."""
    return _resize(x, size or (height, width), "linear")


_METHODS = {0: "linear", 1: "cubic", 2: "nearest", 3: "linear", 4: "linear",
            "bilinear": "linear", "bicubic": "cubic", "nearest": "nearest",
            "area": "linear", "lanczos3": "lanczos3",
            "lanczos5": "lanczos5", "gaussian": "linear",
            "mitchellcubic": "cubic"}


@op("image_resize", "images", aliases=("resize_images",))
def image_resize(x, size, method="bilinear", **_):
    return _resize(x, size, _METHODS.get(method, "linear"))


@op("crop_and_resize", "images")
def crop_and_resize(image, boxes, box_indices, crop_size, method="bilinear",
                    extrapolation_value=0.0):
    """TF CropAndResize: normalized boxes ``[y1, x1, y2, x2]``, each
    sampled at ``crop_size`` align-corners points (bilinear, or nearest
    by rounding); ``[N, ch, cw, C]``."""
    ch, cw = int(crop_size[0]), int(crop_size[1])
    H, W = image.shape[1], image.shape[2]
    nearest = _METHODS.get(method, "linear") == "nearest"
    dev = image.device
    y1, x1, y2, x2 = (boxes[:, i:i + 1] for i in range(4))
    ys = y1 * (H - 1) + torch.arange(ch, device=dev) / max(ch - 1, 1) \
        * (y2 - y1) * (H - 1)
    xs = x1 * (W - 1) + torch.arange(cw, device=dev) / max(cw - 1, 1) \
        * (x2 - x1) * (W - 1)
    n = box_indices.long()[:, None, None]

    def at(yi, xi):
        return image[n, yi[:, :, None], xi[:, None, :]]   # [N, ch, cw, C]

    if nearest:
        return at(torch.clamp(torch.round(ys).long(), 0, H - 1),
                  torch.clamp(torch.round(xs).long(), 0, W - 1))
    y0 = torch.clamp(torch.floor(ys).long(), 0, H - 1)
    y1i = torch.clamp(y0 + 1, 0, H - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, W - 1)
    x1i = torch.clamp(x0 + 1, 0, W - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
            + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)


# -- photometric adjustments ----------------------------------------------

@op("adjust_contrast", "images", aliases=("adjust_contrast_v2",))
def adjust_contrast(x, factor=1.0):
    mean = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - mean) * factor + mean


@op("adjust_saturation", "images")
def adjust_saturation(x, factor=1.0):
    hsv = rgb_to_hsv(x)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


@op("adjust_hue", "images")
def adjust_hue(x, delta=0.0):
    hsv = rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


# -- detection helpers ----------------------------------------------------

def _pairwise_iou(a, b):
    """IoU of every box of ``a`` [n, 4] against every box of ``b``
    [m, 4], the JAX op's per-pair formula."""
    a, b = a[:, None, :], b[None, :, :]
    y1 = torch.maximum(a[..., 0], b[..., 0])
    x1 = torch.maximum(a[..., 1], b[..., 1])
    y2 = torch.minimum(a[..., 2], b[..., 2])
    x2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(y2 - y1, min=0) * torch.clamp(x2 - x1, min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def _greedy_nms(overlap_rows, scores, max_output_size, threshold,
                score_threshold):
    """Greedy selection: ``overlap_rows(i)`` is the overlap of the box at
    sorted position ``i`` with every box in sorted order."""
    n = scores.shape[0]
    max_out = int(max_output_size)
    dev = scores.device
    order = torch.argsort(-scores, stable=True)
    eligible = scores[order] > score_threshold
    positions = torch.arange(n, device=dev)
    slots = torch.arange(max_out, device=dev)
    selected = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    suppressed = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(min(n, max_out)):
        avail = ~suppressed & eligible
        # a 1-element index tensor: a 0-d one would be read on the host
        idx = torch.argmax(avail.to(torch.uint8)).reshape(1)
        do = avail.any() & (count < max_out)
        slot = (slots == torch.clamp(count, 0, max_out - 1)) & do
        selected = torch.where(slot, order[idx].to(torch.int32), selected)
        count = count + do.to(torch.int64)
        suppressed = suppressed | (avail & (overlap_rows(idx)[0] > threshold)) \
            | (positions == idx)
    return selected


@op("non_max_suppression", "images", differentiable=False,
    aliases=("non_max_suppression_v3",))
def non_max_suppression(boxes, scores, max_output_size, iou_threshold=0.5,
                        score_threshold=-math.inf):
    """Greedy NMS returning selected indices (padded with -1)."""
    order = torch.argsort(-scores, stable=True)
    ious = _pairwise_iou(boxes[order], boxes[order])
    return _greedy_nms(lambda i: ious[i], scores, max_output_size,
                       iou_threshold, score_threshold)


@op("non_max_suppression_overlaps", "images", differentiable=False)
def non_max_suppression_overlaps(overlaps, scores, max_output_size,
                                 overlap_threshold=0.5,
                                 score_threshold=-math.inf):
    """NMS over a precomputed pairwise overlap matrix."""
    order = torch.argsort(-scores, stable=True)
    ranked = overlaps[order][:, order]
    return _greedy_nms(lambda i: ranked[i], scores, max_output_size,
                       overlap_threshold, score_threshold)


@op("draw_bounding_boxes", "images", differentiable=False)
def draw_bounding_boxes(images, boxes, colors=None):
    """Draw box outlines (normalized ``[y1, x1, y2, x2]``, ``[B, n, 4]``)
    onto images ``[B, H, W, C]``, later boxes over earlier ones."""
    B, H, W, C = images.shape
    if colors is None:
        colors = torch.ones((1, C), dtype=images.dtype, device=images.device)
    colors = torch.as_tensor(colors, device=images.device)
    n_boxes = boxes.shape[1]
    if colors.shape[0] != n_boxes:
        colors = torch.broadcast_to(colors, (n_boxes, C))
    yy = torch.arange(H, device=images.device)[None, :, None]
    xx = torch.arange(W, device=images.device)[None, None, :]
    out = images
    for k in range(n_boxes):
        box = boxes[:, k]
        y1 = torch.round(box[:, 0] * (H - 1)).to(torch.int32)[:, None, None]
        x1 = torch.round(box[:, 1] * (W - 1)).to(torch.int32)[:, None, None]
        y2 = torch.round(box[:, 2] * (H - 1)).to(torch.int32)[:, None, None]
        x2 = torch.round(box[:, 3] * (W - 1)).to(torch.int32)[:, None, None]
        on_edge = (((yy == y1) | (yy == y2)) & (xx >= x1) & (xx <= x2)) \
            | (((xx == x1) | (xx == x2)) & (yy >= y1) & (yy <= y2))
        out = torch.where(on_edge[..., None], colors[k].to(out.dtype), out)
    return out
