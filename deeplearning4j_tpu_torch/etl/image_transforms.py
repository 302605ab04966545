"""Composable image transforms for the ETL pipeline.

Reference: ``datavec-data/datavec-data-image/.../image/transform/`` —
ImageTransform (single-image op), PipelineImageTransform (probabilistic
chain), ImageTransformProcess (builder), and the concrete transforms
(Resize/Crop/RandomCrop/Flip/Rotate/Scale/Box/ColorConversion). The
reference wraps OpenCV Mats; here images are CHW float32 numpy arrays (the
ImageRecordReader's output format), transformed with numpy + PIL so the
whole pipeline stays host-side and feeds device batches directly.

Transforms are deterministic given the Random handed to ``transform`` —
matching the reference's ``transform(ImageWritable, Random)`` contract.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _chw_to_pil(img: np.ndarray):
    from PIL import Image
    chans = [Image.fromarray(c.astype(np.float32), mode="F") for c in img]
    return chans


def _pil_to_chw(chans) -> np.ndarray:
    return np.stack([np.asarray(c, dtype=np.float32) for c in chans])


class ImageTransform:
    """Base transform (reference ImageTransform.java)."""

    def transform(self, img: np.ndarray,
                  rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, img, rng=None):
        return self.transform(img, rng)


class ResizeImageTransform(ImageTransform):
    """Resize to (height, width) (reference ResizeImageTransform.java)."""

    def __init__(self, new_height: int, new_width: int):
        self.h, self.w = int(new_height), int(new_width)

    def transform(self, img, rng=None):
        from PIL import Image
        chans = [c.resize((self.w, self.h), Image.BILINEAR)
                 for c in _chw_to_pil(img)]
        return _pil_to_chw(chans)


class CropImageTransform(ImageTransform):
    """Deterministic margin crop (reference CropImageTransform.java:
    crop top/left/bottom/right pixels)."""

    def __init__(self, crop_top: int = 0, crop_left: int = 0,
                 crop_bottom: int = 0, crop_right: int = 0):
        self.t, self.l = int(crop_top), int(crop_left)
        self.b, self.r = int(crop_bottom), int(crop_right)

    def transform(self, img, rng=None):
        _, h, w = img.shape
        return img[:, self.t:h - self.b or None, self.l:w - self.r or None]


class RandomCropTransform(ImageTransform):
    """Random crop to a fixed (height, width)
    (reference RandomCropTransform.java)."""

    def __init__(self, height: int, width: int, seed: Optional[int] = None):
        self.h, self.w = int(height), int(width)
        self._rng = np.random.RandomState(seed) if seed is not None else None

    def transform(self, img, rng=None):
        rng = rng or self._rng or np.random
        _, h, w = img.shape
        if h < self.h or w < self.w:
            raise ValueError(f"image {h}x{w} smaller than crop "
                             f"{self.h}x{self.w}")
        top = rng.randint(0, h - self.h + 1)
        left = rng.randint(0, w - self.w + 1)
        return img[:, top:top + self.h, left:left + self.w]


class FlipImageTransform(ImageTransform):
    """Flip (reference FlipImageTransform.java, OpenCV flip codes:
    0 = around x-axis (vertical), 1 = around y-axis (horizontal),
    -1 = both; None = random choice per call)."""

    def __init__(self, flip_mode: Optional[int] = 1):
        self.mode = flip_mode

    def transform(self, img, rng=None):
        mode = self.mode
        if mode is None:
            rng = rng or np.random
            mode = rng.choice([-1, 0, 1])
        if mode == 0:
            return img[:, ::-1, :].copy()
        if mode == 1:
            return img[:, :, ::-1].copy()
        return img[:, ::-1, ::-1].copy()


class RotateImageTransform(ImageTransform):
    """Rotate by angle degrees, optionally jittered
    (reference RotateImageTransform.java)."""

    def __init__(self, angle: float, jitter: float = 0.0):
        self.angle, self.jitter = float(angle), float(jitter)

    def transform(self, img, rng=None):
        angle = self.angle
        if self.jitter:
            rng = rng or np.random
            angle = angle + rng.uniform(-self.jitter, self.jitter)
        from PIL import Image
        chans = [c.rotate(angle, resample=Image.BILINEAR)
                 for c in _chw_to_pil(img)]
        return _pil_to_chw(chans)


class ScaleImageTransform(ImageTransform):
    """Scale height/width by (possibly jittered) factors
    (reference ScaleImageTransform.java)."""

    def __init__(self, dx: float, dy: Optional[float] = None,
                 jitter: float = 0.0):
        self.dx = float(dx)
        self.dy = float(dy if dy is not None else dx)
        self.jitter = float(jitter)

    def transform(self, img, rng=None):
        dx, dy = self.dx, self.dy
        if self.jitter:
            rng = rng or np.random
            dx += rng.uniform(-self.jitter, self.jitter)
            dy += rng.uniform(-self.jitter, self.jitter)
        _, h, w = img.shape
        return ResizeImageTransform(max(1, int(round(h * dy))),
                                    max(1, int(round(w * dx)))).transform(img)


class BoxImageTransform(ImageTransform):
    """Pad/crop onto a fixed canvas without rescaling
    (reference BoxImageTransform.java)."""

    def __init__(self, height: int, width: int):
        self.h, self.w = int(height), int(width)

    def transform(self, img, rng=None):
        c, h, w = img.shape
        out = np.zeros((c, self.h, self.w), img.dtype)
        src_t = max(0, (h - self.h) // 2)
        src_l = max(0, (w - self.w) // 2)
        dst_t = max(0, (self.h - h) // 2)
        dst_l = max(0, (self.w - w) // 2)
        ch, cw = min(h, self.h), min(w, self.w)
        out[:, dst_t:dst_t + ch, dst_l:dst_l + cw] = \
            img[:, src_t:src_t + ch, src_l:src_l + cw]
        return out


class ColorConversionTransform(ImageTransform):
    """RGB <-> grayscale (the useful subset of the reference's OpenCV
    ColorConversionTransform.java codes)."""

    def __init__(self, conversion: str = "rgb2gray"):
        if conversion not in ("rgb2gray", "gray2rgb"):
            raise ValueError(f"unsupported conversion {conversion!r}")
        self.conversion = conversion

    def transform(self, img, rng=None):
        if self.conversion == "rgb2gray":
            if img.shape[0] != 3:
                raise ValueError("rgb2gray needs 3 channels")
            w = np.asarray([0.299, 0.587, 0.114], img.dtype)
            return np.tensordot(w, img, axes=1)[None]
        if img.shape[0] != 1:
            raise ValueError("gray2rgb needs 1 channel")
        return np.repeat(img, 3, axis=0)


class NormalizeImageTransform(ImageTransform):
    """Scale to [0,1] and optionally standardize per channel (the
    ImagePreProcessingScaler role folded into the transform pipeline)."""

    def __init__(self, max_value: float = 255.0,
                 mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None):
        self.max_value = float(max_value)
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def transform(self, img, rng=None):
        out = img.astype(np.float32) / self.max_value
        if self.mean is not None:
            out = out - self.mean[:, None, None]
        if self.std is not None:
            out = out / self.std[:, None, None]
        return out


class MultiImageTransform(ImageTransform):
    """Apply transforms in sequence (reference MultiImageTransform.java)."""

    def __init__(self, *transforms: ImageTransform):
        self.transforms = list(transforms)

    def transform(self, img, rng=None):
        for t in self.transforms:
            img = t.transform(img, rng)
        return img


class PipelineImageTransform(ImageTransform):
    """Probabilistic chain (reference PipelineImageTransform.java): each
    (transform, probability) fires independently; shuffle=True applies
    them in random order."""

    def __init__(self, steps: Sequence, shuffle: bool = False,
                 seed: Optional[int] = None):
        self.steps: List[Tuple[ImageTransform, float]] = [
            s if isinstance(s, tuple) else (s, 1.0) for s in steps]
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed) if seed is not None else None

    def transform(self, img, rng=None):
        rng = rng or self._rng or np.random
        order = list(range(len(self.steps)))
        if self.shuffle:
            rng.shuffle(order)
        for i in order:
            t, p = self.steps[i]
            if p >= 1.0 or rng.rand() < p:
                img = t.transform(img, rng)
        return img


class ImageTransformProcess:
    """Builder over the transform chain
    (reference ImageTransformProcess.java)."""

    class Builder:
        def __init__(self):
            self._steps: List[ImageTransform] = []

        def resize_image_transform(self, h, w):
            self._steps.append(ResizeImageTransform(h, w))
            return self

        def crop_image_transform(self, *a, **k):
            self._steps.append(CropImageTransform(*a, **k))
            return self

        def random_crop_transform(self, h, w, seed=None):
            self._steps.append(RandomCropTransform(h, w, seed))
            return self

        def flip_image_transform(self, mode=1):
            self._steps.append(FlipImageTransform(mode))
            return self

        def rotate_image_transform(self, angle, jitter=0.0):
            self._steps.append(RotateImageTransform(angle, jitter))
            return self

        def scale_image_transform(self, dx, dy=None, jitter=0.0):
            self._steps.append(ScaleImageTransform(dx, dy, jitter))
            return self

        def color_conversion_transform(self, conversion):
            self._steps.append(ColorConversionTransform(conversion))
            return self

        def normalize_image_transform(self, *a, **k):
            self._steps.append(NormalizeImageTransform(*a, **k))
            return self

        def build(self):
            return ImageTransformProcess(self._steps)

    @staticmethod
    def builder() -> "ImageTransformProcess.Builder":
        return ImageTransformProcess.Builder()

    def __init__(self, steps: Sequence[ImageTransform]):
        self.steps = list(steps)

    def execute(self, img: np.ndarray,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        for t in self.steps:
            img = t.transform(img, rng)
        return img

    __call__ = execute
