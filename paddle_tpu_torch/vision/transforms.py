"""Image transforms (port of paddle_tpu's `vision/transforms.py`, itself
after paddle's python/paddle/vision/transforms/): the functional ops and
the transform classes on numpy HWC arrays, PIL-free. `ToTensor` gives a
CHW float32 array; the device copy happens in the DataLoader's consumer.
The random transforms draw from Python's `random`, as the JAX package's
do, so one `random.seed` gives both packages the same images.
"""
from __future__ import annotations

import numbers
import random as pyrandom

import numpy as np

__all__ = ["Compose", "BaseTransform", "ToTensor", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Normalize", "Transpose", "BrightnessTransform",
           "ContrastTransform", "SaturationTransform", "HueTransform",
           "ColorJitter", "Pad", "RandomRotation", "Grayscale",
           "RandomResizedCrop", "to_tensor", "resize", "hflip", "vflip",
           "normalize", "crop", "center_crop", "pad"]


def _hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


# ---- functional -----------------------------------------------------------

def to_tensor(img, data_format="CHW"):
    img = _hwc(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return img


def resize(img, size, interpolation="bilinear"):
    img = _hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h <= w:
            nh, nw = size, max(1, int(size * w / h))
        else:
            nh, nw = max(1, int(size * h / w)), size
    else:
        nh, nw = size
    if (nh, nw) == (h, w):
        return img
    # vectorised nearest/bilinear on numpy (PIL-free; loaders stay lean)
    ys = np.linspace(0, h - 1, nh)
    xs = np.linspace(0, w - 1, nw)
    if interpolation == "nearest":
        out = img[np.round(ys).astype(int)[:, None],
                  np.round(xs).astype(int)[None, :]]
    else:
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        f = img.astype(np.float32)
        top = f[y0][:, x0] * (1 - fx) + f[y0][:, x1] * fx
        bot = f[y1][:, x0] * (1 - fx) + f[y1][:, x1] * fx
        out = top * (1 - fy) + bot * fy
        if img.dtype == np.uint8:
            out = np.clip(out, 0, 255).astype(np.uint8)
        else:
            out = out.astype(img.dtype)
    return out


def hflip(img):
    return _hwc(img)[:, ::-1]


def vflip(img):
    return _hwc(img)[::-1]


def crop(img, top, left, height, width):
    return _hwc(img)[top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _hwc(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = img.shape[:2]
    th, tw = output_size
    return crop(img, max(0, (h - th) // 2), max(0, (w - tw) // 2), th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    img = _hwc(img)
    if isinstance(padding, int):
        pl = pr = pt = pb = padding
    elif len(padding) == 2:
        pl = pr = padding[0]
        pt = pb = padding[1]
    else:
        pl, pt, pr, pb = padding
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(img, ((pt, pb), (pl, pr), (0, 0)), mode=mode, **kw)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    img = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    return (img - mean.reshape(shape)) / std.reshape(shape)


# ---- class transforms -----------------------------------------------------

class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, *inputs):
        if len(inputs) == 1:
            return self._apply_image(inputs[0])
        return tuple(self._apply_image(i) for i in inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        img = _hwc(img)
        if self.padding is not None:
            img = pad(img, self.padding, self.fill, self.padding_mode)
        th, tw = self.size
        h, w = img.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            # pad() unpacks (left, top, right, bottom)
            img = pad(img, (0, 0, max(0, tw - w), max(0, th - h)), self.fill,
                      self.padding_mode)
            h, w = img.shape[:2]
        if h < th or w < tw:
            raise ValueError(
                f"RandomCrop: image ({h}x{w}) smaller than crop size "
                f"({th}x{tw}); pass pad_if_needed=True")
        top = pyrandom.randint(0, h - th)
        left = pyrandom.randint(0, w - tw)
        return crop(img, top, left, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * pyrandom.uniform(*self.scale)
            ar = pyrandom.uniform(*self.ratio)
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = pyrandom.randint(0, h - ch)
                left = pyrandom.randint(0, w - cw)
                return resize(crop(img, top, left, ch, cw), self.size,
                              self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size,
                      self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return hflip(img) if pyrandom.random() < self.prob else _hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if pyrandom.random() < self.prob else _hwc(img)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return _hwc(img).transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding, self.fill, self.mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _hwc(img)
        img = _hwc(img)
        factor = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        out = img.astype(np.float32) * factor
        return (np.clip(out, 0, 255).astype(np.uint8)
                if img.dtype == np.uint8 else out.astype(img.dtype))


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _hwc(img)
        img = _hwc(img)
        factor = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        mean = img.astype(np.float32).mean()
        out = (img.astype(np.float32) - mean) * factor + mean
        return (np.clip(out, 0, 255).astype(np.uint8)
                if img.dtype == np.uint8 else out.astype(img.dtype))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return _hwc(img)
        img = _hwc(img)
        factor = pyrandom.uniform(max(0, 1 - self.value), 1 + self.value)
        f = img.astype(np.float32)
        gray = f.mean(axis=2, keepdims=True)
        out = gray + (f - gray) * factor
        return (np.clip(out, 0, 255).astype(np.uint8)
                if img.dtype == np.uint8 else out.astype(img.dtype))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        # cheap hue shift via channel roll mix (full HSV omitted on purpose:
        # loaders must stay numpy-only and fast)
        if self.value == 0:
            return _hwc(img)
        img = _hwc(img)
        if img.shape[2] != 3:
            return img
        alpha = pyrandom.uniform(-self.value, self.value)
        f = img.astype(np.float32)
        out = (1 - abs(alpha)) * f + abs(alpha) * np.roll(
            f, 1 if alpha > 0 else -1, axis=2)
        return (np.clip(out, 0, 255).astype(np.uint8)
                if img.dtype == np.uint8 else out.astype(img.dtype))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        pyrandom.shuffle(order)
        for i in order:
            img = self.ts[i]._apply_image(img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.fill = fill

    def _apply_image(self, img):
        img = _hwc(img)
        angle = pyrandom.uniform(*self.degrees)
        theta = np.deg2rad(angle)
        h, w = img.shape[:2]
        cy, cx = (h - 1) / 2, (w - 1) / 2
        yy, xx = np.mgrid[0:h, 0:w]
        ys = (yy - cy) * np.cos(theta) - (xx - cx) * np.sin(theta) + cy
        xs = (yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta) + cx
        yi = np.clip(np.round(ys).astype(int), 0, h - 1)
        xi = np.clip(np.round(xs).astype(int), 0, w - 1)
        out = img[yi, xi]
        invalid = (ys < 0) | (ys > h - 1) | (xs < 0) | (xs > w - 1)
        out[invalid] = self.fill
        return out


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        img = _hwc(img)
        if img.shape[2] == 1:
            gray = img.astype(np.float32)
        else:
            gray = (0.299 * img[:, :, 0] + 0.587 * img[:, :, 1]
                    + 0.114 * img[:, :, 2]).astype(np.float32)[:, :, None]
        out = np.repeat(gray, self.num_output_channels, axis=2)
        return out.astype(img.dtype)


# reference package layout (vision/transforms/__init__.py imports the
# `transforms` and `functional` submodules): one module carries both
# the transform classes and the functional verbs here; the aliases keep
# `paddle.vision.transforms.functional.resize`-style paths working
import sys as _sys                                         # noqa: E402
transforms = functional = _sys.modules[__name__]
