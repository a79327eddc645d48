"""The port's vision input path against the JAX package's: every transform
and functional op on the same images under the same `random.seed`
(bit-equal), image loading and backends, and every dataset read from the
same local files, written here (MNIST / FashionMNIST idx files, CIFAR-10
/ 100 tarballs, Flowers and VOC2012 archives, class folders of .npy and
.png files, FakeData)."""
import gzip
import io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.vision.datasets as jds                      # noqa: E402
import paddle_tpu.vision.image as jimage                      # noqa: E402
import paddle_tpu.vision.transforms as jT                     # noqa: E402

import paddle_tpu_torch.vision as tvision                     # noqa: E402
import paddle_tpu_torch.vision.datasets as tds                # noqa: E402
import paddle_tpu_torch.vision.image as timage                # noqa: E402
import paddle_tpu_torch.vision.transforms as tT               # noqa: E402


def _img(seed, shape=(20, 26, 3), dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(dtype)


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _transform_cases():
    """name -> build(module): a transform (or functional op) per case."""
    return {
        "to_tensor": lambda m: m.ToTensor(),
        "to_tensor_hwc": lambda m: m.ToTensor(data_format="HWC"),
        "resize_int": lambda m: m.Resize(12),
        "resize_pair_nearest": lambda m: m.Resize((9, 31),
                                                  interpolation="nearest"),
        "random_crop": lambda m: m.RandomCrop(11),
        "random_crop_pad": lambda m: m.RandomCrop(
            (30, 30), padding=2, pad_if_needed=True, fill=7),
        "random_crop_reflect": lambda m: m.RandomCrop(
            8, padding=(1, 2), padding_mode="reflect"),
        "center_crop": lambda m: m.CenterCrop(13),
        "hflip": lambda m: m.RandomHorizontalFlip(0.5),
        "vflip": lambda m: m.RandomVerticalFlip(0.5),
        "normalize_hwc": lambda m: m.Normalize(
            mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            data_format="HWC"),
        "normalize_scalar_chw": lambda m: m.Compose([
            m.Transpose(), m.Normalize(0.5, 0.25)]),
        "transpose": lambda m: m.Transpose((1, 0, 2)),
        "pad_edge": lambda m: m.Pad((1, 2, 3, 4), padding_mode="edge"),
        "pad_symmetric": lambda m: m.Pad(3, padding_mode="symmetric"),
        "brightness": lambda m: m.BrightnessTransform(0.4),
        "contrast": lambda m: m.ContrastTransform(0.4),
        "saturation": lambda m: m.SaturationTransform(0.4),
        "hue": lambda m: m.HueTransform(0.3),
        "color_jitter": lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.2),
        "rotation": lambda m: m.RandomRotation(25, fill=3),
        "grayscale": lambda m: m.Grayscale(3),
        "random_resized_crop": lambda m: m.RandomResizedCrop(14),
        "imagenet_train": lambda m: m.Compose([
            m.RandomResizedCrop(16), m.RandomHorizontalFlip(),
            m.Normalize(mean=[123.675, 116.28, 103.53],
                        std=[58.395, 57.12, 57.375], data_format="HWC"),
            m.Transpose()]),
        "eval_pipeline": lambda m: m.Compose([
            m.Resize(18), m.CenterCrop(16), m.ToTensor(),
            m.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])]),
    }


@pytest.mark.parametrize("name", sorted(_transform_cases()))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_transform_matches_jax_bit_for_bit(name, dtype):
    make = _transform_cases()[name]
    jt, tt = make(jT), make(tT)
    for k in range(4):
        img = _img(k, dtype=getattr(np, dtype))
        if dtype == "float32":
            img = np.abs(img) * 60
        random.seed(100 + k)
        want = jt(img)
        random.seed(100 + k)
        got = tt(img)
        _same(got, want, f"{name} {dtype} image {k}")


def _functional_cases():
    return {
        "to_tensor": lambda m, x: m.to_tensor(x),
        "resize": lambda m, x: m.resize(x, (7, 40)),
        "resize_short": lambda m, x: m.resize(x, 10),
        "hflip": lambda m, x: m.hflip(x),
        "vflip": lambda m, x: m.vflip(x),
        "crop": lambda m, x: m.crop(x, 2, 3, 9, 11),
        "center_crop": lambda m, x: m.center_crop(x, (8, 12)),
        "pad": lambda m, x: m.pad(x, (1, 2), fill=9),
        "normalize": lambda m, x: m.normalize(x, [1, 2, 3], [2, 3, 4],
                                              data_format="HWC"),
        "gray_2d": lambda m, x: m.resize(x[:, :, 0], 11),
    }


@pytest.mark.parametrize("name", sorted(_functional_cases()))
def test_functional_op_matches_jax(name):
    fn = _functional_cases()[name]
    for k in range(3):
        img = _img(20 + k)
        _same(fn(tT, img), fn(jT, img), f"{name} {k}")
    assert tT.functional is tT and tT.transforms is tT


def test_transform_multiple_inputs_and_errors():
    a, b = _img(1), _img(2)
    random.seed(3)
    got = tT.RandomHorizontalFlip(1.0)(a, b)
    random.seed(3)
    want = jT.RandomHorizontalFlip(1.0)(a, b)
    for g, w in zip(got, want):
        _same(g, w)
    with pytest.raises(ValueError, match="smaller than crop"):
        tT.RandomCrop(40)(a)


# ------------------------------------------------------------ image I/O

def test_image_backend_and_load(tmp_path):
    arr = _img(5)
    np.save(tmp_path / "a.npy", arr)
    np.savez(tmp_path / "b.npz", img=arr)
    assert timage.get_image_backend() == jimage.get_image_backend() \
        == "numpy"
    _same(timage.image_load(str(tmp_path / "a.npy")), arr)
    _same(tvision.image_load(str(tmp_path / "b.npz")), arr)
    for mod in (timage, jimage):
        with pytest.raises(ValueError, match="Expected backend"):
            mod.set_image_backend("cv2")
        with pytest.raises(ValueError):
            mod.image_load(str(tmp_path / "a.png"), backend="numpy")
    pil = pytest.importorskip("PIL.Image")
    pil.fromarray(arr).save(tmp_path / "c.png")
    try:
        tvision.set_image_backend("pil")
        assert tvision.get_image_backend() == "pil"
        got = np.asarray(timage.image_load(str(tmp_path / "c.png")))
        want = np.asarray(jimage.image_load(str(tmp_path / "c.png"),
                                            backend="pil"))
        _same(got, want)
        _same(got, arr)
    finally:
        tvision.set_image_backend("numpy")


# ------------------------------------------------------------- datasets

def _same_sample(g, w, what):
    if isinstance(w, (list, tuple)):
        assert isinstance(g, type(w)) and len(g) == len(w), what
        for i, (a, b) in enumerate(zip(g, w)):
            _same_sample(a, b, f"{what}[{i}]")
    elif hasattr(w, "size") and not isinstance(w, np.ndarray) \
            and not np.isscalar(w):
        _same(np.asarray(g), np.asarray(w), what)          # a PIL image
    else:
        ga, wa = np.asarray(g), np.asarray(w)
        assert ga.dtype == wa.dtype, (what, ga.dtype, wa.dtype)
        np.testing.assert_array_equal(ga, wa, err_msg=what)


def _same_dataset(td, jd, what):
    assert len(td) == len(jd) > 0, what
    for i in range(len(jd)):
        _same_sample(td[i], jd[i], f"{what}[{i}]")


def _write_idx(tmp_path, n=7, rows=5, cols=4):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (n, rows, cols), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
def test_mnist_from_idx_files(tmp_path, name):
    ip, lp = _write_idx(tmp_path)
    _same_dataset(getattr(tds, name)(ip, lp), getattr(jds, name)(ip, lp),
                  name)
    tf = lambda m: m.Compose([m.ToTensor(), m.Normalize([0.5], [0.5])])
    _same_dataset(getattr(tds, name)(ip, lp, transform=tf(tT)),
                  getattr(jds, name)(ip, lp, transform=tf(jT)), name)


def _write_cifar(tmp_path, hundred):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "cifar.tar.gz")
    with tarfile.open(path, "w:gz") as tf:
        names = (["train", "test"] if hundred
                 else ["data_batch_1", "data_batch_2", "test_batch"])
        for nm in names:
            d = {b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                 (b"fine_labels" if hundred else b"labels"):
                 rng.integers(0, 10, 3).tolist()}
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar/{nm}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))
    return path


@pytest.mark.parametrize("name", ["Cifar10", "Cifar100"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cifar_from_a_tarball(tmp_path, name, mode):
    path = _write_cifar(tmp_path, name == "Cifar100")
    _same_dataset(getattr(tds, name)(path, mode=mode),
                  getattr(jds, name)(path, mode=mode), f"{name} {mode}")
    t = getattr(tds, name)(path, mode=mode,
                           transform=tT.RandomCrop(28, padding=4))
    j = getattr(jds, name)(path, mode=mode,
                           transform=jT.RandomCrop(28, padding=4))
    random.seed(0)
    got = [t[i] for i in range(len(t))]
    random.seed(0)
    want = [j[i] for i in range(len(j))]
    _same_sample(got, want, f"{name} {mode} transformed")


def test_missing_files_raise():
    for mod in (tds, jds):
        with pytest.raises(RuntimeError, match="local file"):
            mod.MNIST(None, None)
        with pytest.raises(RuntimeError):
            mod.Cifar10("/nonexistent/cifar.tar.gz")
        with pytest.raises(RuntimeError):
            mod.Flowers("/nonexistent/a.tgz", "/x", "/y")


def test_fake_data_matches_jax():
    _same_dataset(tds.FakeData(9, (3, 8, 8), 5, seed=3),
                  jds.FakeData(9, (3, 8, 8), 5, seed=3), "FakeData")


def _write_folders(root, ext, n_per=3):
    rng = np.random.default_rng(2)
    for c in ("cat", "dog", "emu"):
        os.makedirs(os.path.join(root, c, "sub"))
        for i in range(n_per):
            arr = rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
            where = os.path.join(root, c, "sub" if i == 0 else "",
                                 f"{i}{ext}")
            if ext == ".npy":
                np.save(where, arr)
            else:
                from PIL import Image
                Image.fromarray(arr).save(where)
    open(os.path.join(root, "cat", "notes.txt"), "w").close()


def test_dataset_and_image_folders_of_npy(tmp_path):
    _write_folders(str(tmp_path), ".npy")
    tf = lambda m: m.Compose([m.RandomResizedCrop(8), m.Transpose()])
    td = tds.DatasetFolder(str(tmp_path), loader=np.load,
                           extensions=(".npy",), transform=tf(tT))
    jd = jds.DatasetFolder(str(tmp_path), loader=np.load,
                           extensions=(".npy",), transform=tf(jT))
    assert td.classes == jd.classes == ["cat", "dog", "emu"]
    assert td.class_to_idx == jd.class_to_idx
    assert td.samples == jd.samples and td.targets == jd.targets
    random.seed(8)
    t = [td[i] for i in range(len(td))]
    random.seed(8)
    j = [jd[i] for i in range(len(jd))]
    for i, (a, b) in enumerate(zip(t, j)):
        _same_sample(a, b, f"DatasetFolder[{i}]")
    ti = tds.ImageFolder(str(tmp_path), loader=np.load, extensions=".npy")
    ji = jds.ImageFolder(str(tmp_path), loader=np.load, extensions=".npy")
    assert ti.samples == ji.samples
    _same_dataset(ti, ji, "ImageFolder")
    valid = lambda p: p.endswith("1.npy")
    assert tds.DatasetFolder(str(tmp_path), loader=np.load,
                             is_valid_file=valid).samples == \
        jds.DatasetFolder(str(tmp_path), loader=np.load,
                          is_valid_file=valid).samples
    for mod in (tds, jds):
        with pytest.raises(ValueError):
            mod.DatasetFolder(str(tmp_path), extensions=".npy",
                              is_valid_file=valid)
        with pytest.raises(RuntimeError):
            mod.DatasetFolder(str(tmp_path), loader=np.load,
                              extensions=(".jpg",))


def test_dataset_folder_of_png_through_pil(tmp_path):
    pytest.importorskip("PIL.Image")
    _write_folders(str(tmp_path), ".png")
    td, jd = tds.DatasetFolder(str(tmp_path)), jds.DatasetFolder(
        str(tmp_path))
    assert td.samples == jd.samples
    _same_dataset(td, jd, "DatasetFolder png")
    _same_dataset(tds.ImageFolder(str(tmp_path)),
                  jds.ImageFolder(str(tmp_path)), "ImageFolder png")


def _jpeg_bytes(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _png_bytes(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _add(tf, name, raw):
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    tf.addfile(info, io.BytesIO(raw))


def test_flowers_from_local_archives(tmp_path):
    pytest.importorskip("PIL.Image")
    scio = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(3)
    data = str(tmp_path / "102flowers.tgz")
    with tarfile.open(data, "w:gz") as tf:
        for i in range(1, 7):
            _add(tf, "jpg/image_%05d.jpg" % i, _jpeg_bytes(
                rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)))
    labels, setid = str(tmp_path / "labels.mat"), str(tmp_path / "setid.mat")
    scio.savemat(labels, {"labels": np.array([[3, 1, 4, 1, 5, 9]])})
    scio.savemat(setid, {"trnid": np.array([[1, 3, 5]]),
                         "valid": np.array([[2]]),
                         "tstid": np.array([[4, 6]])})
    for mode in ("train", "valid", "test"):
        for backend in ("pil", "cv2"):
            td = tds.Flowers(data, labels, setid, mode=mode, backend=backend)
            jd = jds.Flowers(data, labels, setid, mode=mode, backend=backend)
            _same_dataset(td, jd, f"Flowers {mode} {backend}")
            # spawned workers unpickle it and reopen the archive
            _same_dataset(pickle.loads(pickle.dumps(td)), jd, "pickled")


def test_voc2012_from_a_local_tarball(tmp_path):
    pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    data = str(tmp_path / "voc.tar")
    stems = ["2007_000032", "2007_000039", "2008_000001"]
    with tarfile.open(data, "w") as tf:
        base = "VOCdevkit/VOC2012/"
        for split, members in (("trainval", stems), ("val", stems[:1]),
                               ("train", stems[1:])):
            _add(tf, base + f"ImageSets/Segmentation/{split}.txt",
                 ("\n".join(members) + "\n").encode())
        for s in stems:
            _add(tf, base + f"JPEGImages/{s}.jpg", _jpeg_bytes(
                rng.integers(0, 256, (8, 10, 3), dtype=np.uint8)))
            _add(tf, base + f"SegmentationClass/{s}.png", _png_bytes(
                rng.integers(0, 21, (8, 10), dtype=np.uint8)))
    for mode in ("train", "valid", "test"):
        for backend in ("pil", "cv2"):
            _same_dataset(tds.VOC2012(data, mode=mode, backend=backend),
                          jds.VOC2012(data, mode=mode, backend=backend),
                          f"VOC2012 {mode} {backend}")
    assert tds.mnist is tds and tds.folder is tds
