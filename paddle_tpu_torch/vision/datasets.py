"""Vision datasets (port of paddle_tpu's `vision/datasets.py`, after
paddle's python/paddle/vision/datasets/): MNIST, FashionMNIST, Cifar10,
Cifar100, Flowers and VOC2012 from their standard local files, the
folder datasets DatasetFolder and ImageFolder, and FakeData. Nothing is
downloaded: a missing file raises `RuntimeError` naming it. Samples are
numpy (or PIL images, where a dataset's backend is 'pil'); the
DataLoader makes them tensors.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData",
           "Flowers", "VOC2012", "DatasetFolder", "ImageFolder"]


class FakeData(Dataset):
    """Deterministic synthetic images and labels (torchvision's FakeData;
    paddle has none): sample i is drawn from `default_rng(seed + i)`."""

    def __init__(self, num_samples=1000, image_shape=(1, 28, 28),
                 num_classes=10, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        label = int(rng.integers(0, self.num_classes))
        # class-dependent mean so models can actually learn from it
        img = rng.normal(loc=label / self.num_classes, scale=0.3,
                         size=self.image_shape).astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)

    def __len__(self):
        return self.num_samples


def _require(path, name):
    if path is None or not os.path.exists(path):
        raise RuntimeError(
            f"{name}: datasets are read from local files only (nothing is "
            f"downloaded) — pass the local file path (got {path!r}), or "
            f"use vision.datasets.FakeData for synthetic samples")
    return path


class MNIST(Dataset):
    """idx-format MNIST (reference: vision/datasets/mnist.py parses the same
    gzip idx files it downloads)."""

    NAME = "MNIST"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.mode = mode
        self.transform = transform
        _require(image_path, self.NAME)
        _require(label_path, self.NAME)
        with gzip.open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(f.read(), np.uint8).reshape(
                n, rows, cols)
        with gzip.open(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        if self.transform is not None:
            img = self.transform(self.images[idx])
        else:
            img = self.images[idx].astype(np.float32)[None]  # CHW
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "FashionMNIST"


class Cifar10(Dataset):
    """python-pickle CIFAR tarball (reference: vision/datasets/cifar.py)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        _require(data_file, "Cifar10")
        self.transform = transform
        self.mode = mode
        data, labels = [], []
        with tarfile.open(data_file) as tf:
            want = self._member_names(mode)
            names = [m for m in tf.getmembers()
                     if any(w in m.name for w in want) and m.isfile()]
            for m in sorted(names, key=lambda m: m.name):
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                data.append(d[b"data"])
                labels += list(d.get(b"labels", d.get(b"fine_labels", [])))
        self.data = np.concatenate(data).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    @staticmethod
    def _member_names(mode):
        return ("data_batch",) if mode == "train" else ("test_batch",)

    def __getitem__(self, idx):
        if self.transform is not None:
            img = self.transform(self.data[idx].transpose(1, 2, 0))
        else:
            img = self.data[idx].astype(np.float32)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    # CIFAR-100 archive members are named 'train'/'test' (not data_batch_*)
    @staticmethod
    def _member_names(mode):
        return ("train",) if mode == "train" else ("test",)


# ---------------------------------------------------------------------------
# archive / folder datasets
# ---------------------------------------------------------------------------

_FLOWERS_MODE_FLAG = {"train": "trnid", "valid": "valid", "test": "tstid"}


class Flowers(Dataset):
    """Oxford 102 Flowers from the standard local archives (reference:
    vision/datasets/flowers.py — same 102flowers.tgz tarball layout
    jpg/image_%05d.jpg, imagelabels.mat, setid.mat; the files are taken
    as paths instead of downloaded)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, backend="pil"):
        if backend not in ("pil", "cv2"):
            raise ValueError(
                f"Expected backend one of ['pil', 'cv2'], got {backend}")
        if mode.lower() not in _FLOWERS_MODE_FLAG:
            raise ValueError(f"mode must be train/valid/test, got {mode}")
        self.backend = backend
        self.flag = _FLOWERS_MODE_FLAG[mode.lower()]
        self.transform = transform
        self.data_file = _require(data_file, "Flowers(data_file=...)")
        self.label_file = _require(label_file, "Flowers(label_file=...)")
        self.setid_file = _require(setid_file, "Flowers(setid_file=...)")

        import scipy.io as scio
        self.data_tar = None      # opened lazily per process: TarFile
        self.name2mem = None      # is unpicklable (spawned DataLoader
        self._ensure_tar()        # workers re-open their own handle)
        self.labels = scio.loadmat(self.label_file)["labels"][0]
        self.indexes = scio.loadmat(self.setid_file)[self.flag][0]

    def _ensure_tar(self):
        if self.data_tar is None:
            self.data_tar = tarfile.open(self.data_file)
            self.name2mem = {m.name: m
                             for m in self.data_tar.getmembers()}

    def __getstate__(self):
        state = dict(self.__dict__)
        state["data_tar"] = None
        state["name2mem"] = None
        return state

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image
        self._ensure_tar()
        index = int(self.indexes[idx])
        label = np.array([self.labels[index - 1]])
        raw = self.data_tar.extractfile(
            self.name2mem["jpg/image_%05d.jpg" % index]).read()
        image = Image.open(_io.BytesIO(raw))
        if self.backend == "cv2":
            image = np.array(image)
        if self.transform is not None:
            image = self.transform(image)
        if self.backend == "pil":
            return image, label.astype("int64")
        return np.asarray(image, np.float32), label.astype("int64")

    def __len__(self):
        return len(self.indexes)

    def __del__(self):
        if getattr(self, "data_tar", None):
            self.data_tar.close()


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs from the standard local tarball
    (reference: vision/datasets/voc2012.py — VOCdevkit/VOC2012 layout:
    ImageSets/Segmentation/{train,trainval,val}.txt listing stems under
    JPEGImages/*.jpg + SegmentationClass/*.png)."""

    _SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    _DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    _LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
    # reference MODE_FLAG_MAP (voc2012.py:37): 'train' means the
    # combined trainval split; 'test' falls back to train.txt
    _MODE_FLAG = {"train": "trainval", "valid": "val", "test": "train",
                  "trainval": "trainval"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 backend="pil"):
        if backend not in ("pil", "cv2"):
            raise ValueError(
                f"Expected backend one of ['pil', 'cv2'], got {backend}")
        if mode.lower() not in self._MODE_FLAG:
            raise ValueError(
                f"mode must be train/valid/test/trainval, got {mode}")
        self.backend = backend
        self.flag = self._MODE_FLAG[mode.lower()]
        self.transform = transform
        self.data_file = _require(data_file, "VOC2012(data_file=...)")

        self.data_tar = None      # lazy per-process (see Flowers)
        self.name2mem = None
        self._ensure_tar()
        self.data, self.labels = [], []
        listing = self.data_tar.extractfile(
            self.name2mem[self._SET_FILE.format(self.flag)])
        for line in listing:
            stem = line.strip().decode("utf-8")
            if not stem:
                continue
            self.data.append(self._DATA_FILE.format(stem))
            self.labels.append(self._LABEL_FILE.format(stem))

    def _ensure_tar(self):
        if self.data_tar is None:
            self.data_tar = tarfile.open(self.data_file)
            self.name2mem = {m.name: m
                             for m in self.data_tar.getmembers()}

    def __getstate__(self):
        state = dict(self.__dict__)
        state["data_tar"] = None
        state["name2mem"] = None
        return state

    def __getitem__(self, idx):
        import io as _io

        from PIL import Image
        self._ensure_tar()
        img = Image.open(_io.BytesIO(self.data_tar.extractfile(
            self.name2mem[self.data[idx]]).read()))
        lab = Image.open(_io.BytesIO(self.data_tar.extractfile(
            self.name2mem[self.labels[idx]]).read()))
        if self.backend == "cv2":
            img, lab = np.array(img), np.array(lab)
        if self.transform is not None:
            img = self.transform(img)
        if self.backend == "cv2":
            return (np.asarray(img, np.float32),
                    np.asarray(lab, np.float32))
        return img, lab

    def __len__(self):
        return len(self.data)

    def __del__(self):
        if getattr(self, "data_tar", None):
            self.data_tar.close()


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def _pil_loader(path):
    from PIL import Image
    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


class DatasetFolder(Dataset):
    """root/class_x/*.ext layout -> (sample, class_index) pairs
    (reference: vision/datasets/folder.py:62). Attributes: classes,
    class_to_idx, samples, targets."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        if extensions is not None and is_valid_file is not None:
            raise ValueError(
                "pass either extensions or is_valid_file, not both")
        self.root = root
        self.transform = transform
        self.loader = loader or _pil_loader
        self.extensions = extensions if extensions is not None \
            else (None if is_valid_file else IMG_EXTENSIONS)
        classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        if not classes:
            raise RuntimeError(f"no class folders under {root!r}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        if is_valid_file is None:
            exts = (self.extensions,) if isinstance(
                self.extensions, str) else tuple(self.extensions)
            is_valid_file = lambda p: p.lower().endswith(exts)
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    p = os.path.join(dirpath, fn)
                    if is_valid_file(p):
                        self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(
                f"found 0 files in subfolders of {root!r} with "
                f"extensions {self.extensions}")
        self.targets = [t for _, t in self.samples]

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat/recursive image listing WITHOUT labels (reference:
    vision/datasets/folder.py:219): every valid file under root is one
    sample; __getitem__ returns [sample]."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        if extensions is not None and is_valid_file is not None:
            raise ValueError(
                "pass either extensions or is_valid_file, not both")
        self.root = root
        self.transform = transform
        self.loader = loader or _pil_loader
        if extensions is None:
            exts = IMG_EXTENSIONS
        else:
            exts = (extensions,) if isinstance(extensions, str) \
                else tuple(extensions)
        if is_valid_file is None:
            is_valid_file = lambda p: p.lower().endswith(exts)
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                p = os.path.join(dirpath, fn)
                if is_valid_file(p):
                    self.samples.append(p)
        if not self.samples:
            raise RuntimeError(f"found 0 image files under {root!r}")

    def __getitem__(self, idx):
        sample = self.loader(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)


# reference package layout (vision/datasets/{mnist,cifar,flowers,folder,
# voc2012}.py): the classes live in this one module; the names alias it
# so `paddle.vision.datasets.mnist.MNIST`-style paths resolve
import sys as _sys                                         # noqa: E402
mnist = cifar = flowers = folder = voc2012 = _sys.modules[__name__]
