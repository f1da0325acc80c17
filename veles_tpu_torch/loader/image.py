"""Image loaders — decode, colour space, scale, crop, mirror, rotation
and Sobel, with the label taken from the path (the port of
``veles_tpu/loader/image.py``).

All decode and transform work stays on the host (numpy, and PIL when
it is installed); the device sees only ready float32 tensors.  Two
serving modes:

- :class:`FileImageLoader` — streaming: decodes each minibatch's files
  on demand (datasets larger than RAM), per minibatch, so the prefetch
  pipeline (``loader/prefetch.py``) hides the decode behind the step;
- :class:`FullBatchFileImageLoader` — decodes every image once at
  ``load_data`` into the device-resident ``FullBatchLoader`` dataset.

The parent directory's name is the label unless ``filename_re`` (its
first group) or :meth:`FileImageLoaderBase.get_image_label` says
otherwise.  PIL is optional, as in the reference: ``.npy`` images
decode without it (``numpy.load``), and so do the nearest-neighbour
resize and right-angle rotations of non-uint8 sources.
"""

import os
import re

import numpy

from veles_tpu_torch.loader.base import TRAIN, VALID, Loader
from veles_tpu_torch.loader.fullbatch import (
    FullBatchLoader, FullBatchLoaderMSE)

#: extensions FileImageLoaderBase scans for (ref: image.py MODE_* lists)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif",
                    ".tiff", ".ppm", ".webp", ".npy")


def _pil():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


class ImagePipeline(object):
    """The shared decode → color-space → scale → crop → mirror pipeline
    (ref: image.py:106 scale/crop/mirror/color-space attrs).

    All transforms are host-side numpy/PIL; output is float32 HWC in
    [0, 1] (uint8 sources) ready for the device.  Random crop, mirror
    and rotation draw from ``prng`` (the loader's generator).
    """

    def __init__(self, color_space="RGB", scale=None,
                 scale_maintain_aspect_ratio=False, crop=None,
                 mirror=False, rotation=None, add_sobel=False,
                 prng=None):
        #: "RGB" | "GRAY" — PIL mode conversion target
        self.color_space = color_space
        #: (width, height) to scale to, or a float ratio, or None
        self.scale = scale
        self.scale_maintain_aspect_ratio = scale_maintain_aspect_ratio
        #: (width, height) crop window, or None
        self.crop = crop
        #: False | True (always flip) | "random"
        self.mirror = mirror
        #: rotation augmentation (ref: veles/loader/image.py rotate
        #: support): a fixed angle in degrees, or (lo, hi) sampled per
        #: train image, or None
        self.rotation = rotation
        # silently skipping a configured RANDOM augmentation would be a
        # lie — every sampling transform needs the sampler.  (crop
        # without a prng is fine: center crop is its defined
        # deterministic/eval semantic.)
        if prng is None:
            if isinstance(rotation, (tuple, list)):
                raise ValueError("ranged rotation requires a prng")
            if mirror == "random":
                raise ValueError('mirror="random" requires a prng')
        #: append a Sobel gradient-magnitude channel (ref: image.py
        #: add_sobel — the reference used OpenCV; 2 numpy convolutions
        #: suffice)
        self.add_sobel = add_sobel
        self.prng = prng

    # -- steps -----------------------------------------------------------------

    def decode(self, path):
        """File → numpy HWC uint8/float array."""
        if path.endswith(".npy"):
            return numpy.load(path)
        Image = _pil()
        if Image is None:
            raise RuntimeError("PIL unavailable — cannot decode %s" % path)
        img = Image.open(path)
        mode = "L" if self.color_space in ("GRAY", "L") else "RGB"
        if img.mode != mode:
            img = img.convert(mode)
        arr = numpy.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    def _scale(self, arr):
        if self.scale is None:
            return arr
        h, w = arr.shape[:2]
        if isinstance(self.scale, float):
            tw, th = int(round(w * self.scale)), int(round(h * self.scale))
        else:
            tw, th = self.scale
        if (w, h) == (tw, th):
            return arr
        if self.scale_maintain_aspect_ratio:
            # fit inside (tw, th), pad with zeros (ref: image.py
            # background fill on aspect-preserving scale)
            ratio = min(tw / w, th / h)
            sw, sh = int(round(w * ratio)), int(round(h * ratio))
            resized = self._resize(arr, sw, sh)
            out = numpy.zeros((th, tw) + arr.shape[2:], arr.dtype)
            y0, x0 = (th - sh) // 2, (tw - sw) // 2
            out[y0:y0 + sh, x0:x0 + sw] = resized
            return out
        return self._resize(arr, tw, th)

    @staticmethod
    def _resize(arr, tw, th):
        Image = _pil()
        if Image is not None and arr.dtype == numpy.uint8:
            img = Image.fromarray(arr.squeeze() if arr.shape[2] == 1
                                  else arr)
            out = numpy.asarray(img.resize((tw, th), Image.BILINEAR))
            if out.ndim == 2:
                out = out[:, :, None]
            return out
        # nearest-neighbour fallback for float/npy sources
        h, w = arr.shape[:2]
        yi = numpy.clip((numpy.arange(th) * h / th).astype(int), 0, h - 1)
        xi = numpy.clip((numpy.arange(tw) * w / tw).astype(int), 0, w - 1)
        return arr[yi][:, xi]

    def _crop(self, arr, random):
        if self.crop is None:
            return arr
        cw, ch = self.crop
        h, w = arr.shape[:2]
        if h < ch or w < cw:
            raise ValueError("crop %s exceeds image %s" %
                             ((cw, ch), (w, h)))
        if random and self.prng is not None:
            y0 = int(self.prng.randint(0, h - ch + 1))
            x0 = int(self.prng.randint(0, w - cw + 1))
        else:
            y0, x0 = (h - ch) // 2, (w - cw) // 2
        return arr[y0:y0 + ch, x0:x0 + cw]

    def _rotate(self, arr, random):
        if self.rotation is None:
            return arr
        if isinstance(self.rotation, (tuple, list)):
            if not random:
                return arr  # ranged rotation is a train-time augment
            lo, hi = self.rotation
            angle = float(lo) + float(self.prng.rand()) * \
                (float(hi) - float(lo))
        else:
            angle = float(self.rotation)
        if not angle:
            return arr
        Image = _pil()
        if Image is not None and arr.dtype == numpy.uint8:
            squeeze = arr.shape[2] == 1
            img = Image.fromarray(arr.squeeze() if squeeze else arr)
            out = numpy.asarray(img.rotate(
                angle, resample=Image.BILINEAR))
            if out.ndim == 2:
                out = out[:, :, None]
            return out
        # float/npy fallback: right-angle steps only (arbitrary-angle
        # float interpolation isn't worth hand-rolling here) — a
        # configured angle that can't be honored must fail loudly, not
        # silently round
        if angle % 90.0:
            raise ValueError(
                "rotation=%s needs PIL + uint8 input; float/npy "
                "sources support multiples of 90 only" % angle)
        k = int(angle / 90.0) % 4
        return numpy.rot90(arr, k) if k else arr

    def _mirror(self, arr, random):
        if not self.mirror:
            return arr
        if self.mirror == "random":
            if not random or self.prng is None \
                    or self.prng.randint(0, 2) == 0:
                return arr
        return arr[:, ::-1]

    def _sobel(self, arr):
        if not self.add_sobel:
            return arr
        gray = arr.mean(axis=2)
        gx = numpy.zeros_like(gray)
        gy = numpy.zeros_like(gray)
        gx[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
        gy[1:-1, :] = gray[2:, :] - gray[:-2, :]
        mag = numpy.sqrt(gx * gx + gy * gy)
        mx = mag.max()
        if mx > 0:
            mag = mag / mx * (255.0 if arr.dtype == numpy.uint8 else 1.0)
        return numpy.concatenate(
            [arr, mag[:, :, None].astype(arr.dtype)], axis=2)

    def __call__(self, arr, augment=False):
        """Full pipeline; ``augment`` enables the random crop/mirror
        variants (train class only)."""
        arr = self._scale(arr)
        arr = self._rotate(arr, augment)
        arr = self._crop(arr, augment)
        arr = self._mirror(arr, augment)
        arr = self._sobel(arr)
        if arr.dtype == numpy.uint8:
            arr = arr.astype(numpy.float32) / 255.0
        return numpy.ascontiguousarray(arr, numpy.float32)


class FileImageLoaderBase(object):
    """Directory/glob scanning + label-from-path mixin
    (ref: loader/file_image.py:53).

    ``test_paths`` / ``validation_paths`` / ``train_paths`` are lists of
    directories (scanned recursively for :data:`IMAGE_EXTENSIONS`) or
    explicit file paths.
    """

    def __init__(self, *args, test_paths=(), validation_paths=(),
                 train_paths=(), filename_re=None, **kwargs):
        # keyword-only own args; positionals (workflow) pass through the
        # cooperative chain untouched
        super(FileImageLoaderBase, self).__init__(*args, **kwargs)
        self.class_paths = [list(test_paths), list(validation_paths),
                            list(train_paths)]
        #: optional regex whose first group is the label
        #: (ref: file_loader.py label regex support)
        self.filename_re = re.compile(filename_re) if filename_re else None
        self.class_keys = [[], [], []]

    def scan_files(self):
        warn = getattr(self, "warning", None)
        for ci, paths in enumerate(self.class_paths):
            keys = []
            for p in paths:
                if os.path.isdir(p):
                    for dirpath, _, files in sorted(os.walk(p)):
                        for fn in sorted(files):
                            if fn.lower().endswith(IMAGE_EXTENSIONS):
                                keys.append(os.path.join(dirpath, fn))
                elif os.path.isfile(p):
                    keys.append(p)
            if self.filename_re is not None:
                # drop files the label regex can't classify — a single
                # stray file would otherwise crash label mapping later
                matched = [k for k in keys
                           if self.get_image_label(k) is not None]
                if len(matched) != len(keys) and warn is not None:
                    warn("%d file(s) did not match filename_re and were "
                         "skipped", len(keys) - len(matched))
                keys = matched
            self.class_keys[ci] = keys

    def get_image_label(self, path):
        """Label for one file: regex group if configured, else the parent
        directory name (ref convention)."""
        if self.filename_re is not None:
            m = self.filename_re.search(os.path.basename(path))
            return m.group(1) if m else None
        return os.path.basename(os.path.dirname(path))


class FileImageLoader(FileImageLoaderBase, Loader):
    """Streaming image loader (ref: ImageLoader + FileImageLoaderBase
    composed): decodes each minibatch's files on demand — for corpora
    that don't fit in RAM.  Augmentation (random crop/mirror) applies to
    train-class minibatches only."""

    def __init__(self, workflow, color_space="RGB", scale=None,
                 scale_maintain_aspect_ratio=False, crop=None, mirror=False,
                 rotation=None, add_sobel=False, **kwargs):
        # path kwargs are consumed by the FileImageLoaderBase mixin, the
        # rest by Loader
        super(FileImageLoader, self).__init__(workflow, **kwargs)
        self.pipeline = ImagePipeline(
            color_space=color_space, scale=scale,
            scale_maintain_aspect_ratio=scale_maintain_aspect_ratio,
            crop=crop, mirror=mirror, rotation=rotation,
            add_sobel=add_sobel, prng=self.prng)

    def load_data(self):
        self.scan_files()
        self.class_lengths[:] = [len(k) for k in self.class_keys]
        self._all_keys = sum(self.class_keys, [])
        if not self._all_keys:
            raise ValueError("%s: no image files found" % self)
        # labels come from paths alone — build the mapping here so the
        # analysis pass never decodes pixels just to collect labels
        labels = {self.get_image_label(k) for k in self._all_keys}
        labels.discard(None)
        if labels and not all(
                isinstance(l, (int, numpy.integer)) for l in labels):
            self.labels_mapping = {
                l: i for i, l in enumerate(sorted(labels))}
        # probe one image for the sample shape
        self._sample_shape = self.pipeline(
            self.pipeline.decode(self._all_keys[0])).shape

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self._sample_shape,
            numpy.float32))

    def iterate_train(self):
        lo = self.class_end_offsets[VALID]
        hi = self.class_end_offsets[TRAIN]
        step = max(1, self.max_minibatch_size)
        for start in range(lo, hi, step):
            keys = self._all_keys[start:min(start + step, hi)]
            data = numpy.stack([
                self.pipeline(self.pipeline.decode(k)) for k in keys])
            yield data, [self.get_image_label(k) for k in keys]

    def fill_minibatch(self):
        augment = self.minibatch_class == TRAIN
        idx = self.minibatch_indices.mem[:self.minibatch_size]
        for i, sample_idx in enumerate(idx):
            key = self._all_keys[int(sample_idx)]
            self.minibatch_data.mem[i] = self.pipeline(
                self.pipeline.decode(key), augment=augment)
            self.raw_minibatch_labels[i] = self.get_image_label(key)


class FullBatchImageLoader(FullBatchLoader):
    """FullBatch variant fed by in-memory images
    (ref: loader/fullbatch_image.py:56): subclasses provide decoded
    samples via :meth:`load_images`; the pipeline materializes them once
    into ``original_data`` and training runs from device memory."""

    hide_from_registry = True

    def __init__(self, workflow, color_space="RGB", scale=None,
                 scale_maintain_aspect_ratio=False, crop=None, mirror=False,
                 rotation=None, add_sobel=False, **kwargs):
        super(FullBatchImageLoader, self).__init__(workflow, **kwargs)
        self.pipeline = ImagePipeline(
            color_space=color_space, scale=scale,
            scale_maintain_aspect_ratio=scale_maintain_aspect_ratio,
            crop=crop, mirror=mirror, rotation=rotation,
            add_sobel=add_sobel, prng=self.prng)

    def load_images(self):
        """Yield (class_index, image_array, label) triples."""
        raise NotImplementedError()

    def load_data(self):
        per_class = [[], [], []]
        labels_per_class = [[], [], []]
        for ci, arr, label in self.load_images():
            per_class[ci].append(self.pipeline(arr))
            labels_per_class[ci].append(label)
        self.class_lengths[:] = [len(c) for c in per_class]
        samples = sum(per_class, [])
        if not samples:
            raise ValueError("%s: load_images produced nothing" % self)
        self.original_data = numpy.stack(samples)
        labels = sum(labels_per_class, [])
        if any(l is not None for l in labels):
            # original_labels stays RAW — fullbatch._post_load applies
            # labels_mapping (pre-mapping would double-map to -1)
            if not all(isinstance(l, (int, numpy.integer)) for l in labels):
                self.labels_mapping = {
                    l: i for i, l in enumerate(sorted(set(labels)))}
            self.original_labels = list(labels)


class FullBatchFileImageLoader(FileImageLoaderBase, FullBatchImageLoader):
    """Directory-scanning FullBatch image loader (the reference's most
    used image entry point: FullBatchAutoLabelFileImageLoader)."""

    def load_images(self):
        self.scan_files()
        for ci, keys in enumerate(self.class_keys):
            for k in keys:
                yield ci, self.pipeline.decode(k), self.get_image_label(k)


class FullBatchImageLoaderMSE(FullBatchLoaderMSE, FullBatchImageLoader):
    """MSE (target-image) variant (ref: fullbatch_image.py:179-268 +
    image_mse.py): :meth:`load_images` additionally yields the target
    image; targets flow through the same pipeline."""

    def load_images(self):
        """Yield (class_index, image_array, target_array)."""
        raise NotImplementedError()

    def load_data(self):
        per_class, targets_per_class = [[], [], []], [[], [], []]
        for ci, arr, target in self.load_images():
            per_class[ci].append(self.pipeline(arr))
            targets_per_class[ci].append(self.pipeline(target))
        self.class_lengths[:] = [len(c) for c in per_class]
        samples = sum(per_class, [])
        if not samples:
            raise ValueError("%s: load_images produced nothing" % self)
        self.original_data = numpy.stack(samples)
        self.original_targets = numpy.stack(sum(targets_per_class, []))
