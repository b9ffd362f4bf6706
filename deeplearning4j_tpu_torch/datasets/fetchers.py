"""Dataset fetchers (counterpart of ``deeplearning4j_tpu/datasets/fetchers.py``;
reference deeplearning4j-core/.../datasets/fetchers/). Nothing is
downloaded:

- Iris comes from scikit-learn's bundled copy where scikit-learn is
  installed, else from the same seeded synthetic stand-in;
- MNIST, EMNIST, CIFAR-10, SVHN, TinyImageNet and LFW are read from files
  already on disk under ``$DL4J_TPU_DATA_DIR`` (or
  ``~/.deeplearning4j_tpu``), in the layouts the reference caches (idx,
  CIFAR binary batches, ``.mat``, ``.npy``), else generated: each class
  lights a patch at a class-specific place over noise, learnable, so
  training on it converges.

Every generated set is the JAX package's: the same numpy draws in the same
order, so both packages get bitwise the same arrays from the same seed.
The arrays are numpy, on the host; a network moves each batch to its
device when it trains on it.
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from typing import Tuple

import numpy as np

log = logging.getLogger(__name__)


def _one_hot(y: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(y), n), np.float32)
    out[np.arange(len(y)), y] = 1.0
    return out


def iris_data() -> Tuple[np.ndarray, np.ndarray]:
    """(150, 4) features normalized to [0,1] per column, (150, 3) one-hot."""
    try:
        from sklearn.datasets import load_iris  # bundled csv, no network
        d = load_iris()
        x = d.data.astype(np.float32)
        y = d.target.astype(np.int64)
    except Exception:
        rng = np.random.default_rng(6)
        means = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]],
                         np.float32)
        x = np.concatenate([m + 0.3 * rng.standard_normal((50, 4)).astype(np.float32)
                            for m in means])
        y = np.repeat(np.arange(3), 50)
    x = (x - x.min(0)) / (x.max(0) - x.min(0))
    return x.astype(np.float32), _one_hot(y, 3)


def _data_dir() -> str:
    return os.environ.get("DL4J_TPU_DATA_DIR",
                          os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu"))


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad idx image magic {magic}"
        return np.frombuffer(f.read(n * rows * cols), np.uint8).reshape(n, rows * cols)


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx label magic {magic}"
        return np.frombuffer(f.read(n), np.uint8)


def _find_mnist_files(train: bool):
    base = os.path.join(_data_dir(), "mnist")
    stem = "train" if train else "t10k"
    for ext in ("", ".gz"):
        img = os.path.join(base, f"{stem}-images-idx3-ubyte{ext}")
        lab = os.path.join(base, f"{stem}-labels-idx1-ubyte{ext}")
        if os.path.exists(img) and os.path.exists(lab):
            return img, lab
    return None


def synthetic_mnist(num_examples: int, seed: int = 123) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped learnable dataset (see module docstring)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, num_examples)
    x = rng.uniform(0.0, 0.25, (num_examples, 28, 28)).astype(np.float32)
    # class k lights a 8x8 patch anchored on a 2x5 grid + a class-scaled stripe
    rows = (y // 5) * 12 + 2
    cols = (y % 5) * 5 + 1
    for i in range(num_examples):
        r, c = rows[i], cols[i]
        x[i, r:r + 8, c:c + 8] += 0.7
    x = np.clip(x, 0.0, 1.0)
    return x.reshape(num_examples, 784), _one_hot(y, 10)


def mnist_data(num_examples: int = 60000, train: bool = True,
               seed: int = 123) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 784) float32 in [0,1] + (n, 10) one-hot, real if cached locally."""
    found = _find_mnist_files(train)
    if found is not None:
        x = _read_idx_images(found[0]).astype(np.float32) / 255.0
        y = _read_idx_labels(found[1])
        n = min(num_examples, len(x))
        return x[:n], _one_hot(y[:n], 10)
    n = min(num_examples, 60000 if train else 10000)
    return synthetic_mnist(n, seed=seed if train else seed + 1)


# --------------------------------------------------------------------------
# Image dataset fetchers beyond MNIST (reference datasets/fetchers/:
# EmnistDataFetcher, SvhnDataFetcher, TinyImageNetFetcher and
# datasets/iterator/impl/CifarDataSetIterator, LFWDataSetIterator). Same
# zero-egress contract as MNIST: load from a local cache directory when
# present, else generate a deterministic class-conditional synthetic set that
# is learnable so end-to-end tests stay meaningful.

def synthetic_images(num_examples: int, side: int, channels: int,
                     num_classes: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, side, side, channels) float32 NHWC in [0,1] + one-hot labels.
    Class k lights a patch whose position and channel mix are k-specific."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_examples)
    x = rng.uniform(0.0, 0.25,
                    (num_examples, side, side, channels)).astype(np.float32)
    grid = max(int(np.ceil(np.sqrt(num_classes))), 1)
    patch = max(side // (grid + 1), 3)
    cell = max((side - patch) // max(grid - 1, 1), 1)
    for i in range(num_examples):
        k = y[i]
        r = (k // grid) * cell
        c = (k % grid) * cell
        ch = k % channels
        x[i, r:r + patch, c:c + patch, ch] += 0.7
    return np.clip(x, 0.0, 1.0), _one_hot(y, num_classes)


def _read_cifar_bin(paths) -> Tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for p in paths:
        raw = np.frombuffer(open(p, "rb").read(), np.uint8).reshape(-1, 3073)
        ys.append(raw[:, 0])
        # stored CHW planar -> NHWC
        xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    x = np.concatenate(xs).astype(np.float32) / 255.0
    return x, _one_hot(np.concatenate(ys), 10)


def cifar10_data(num_examples: int = 50000, train: bool = True,
                 seed: int = 321) -> Tuple[np.ndarray, np.ndarray]:
    """(n, 32, 32, 3) + (n, 10); real CIFAR-10 if the binary batches are
    cached under ``$DL4J_TPU_DATA_DIR/cifar10/cifar-10-batches-bin``."""
    base = os.path.join(_data_dir(), "cifar10", "cifar-10-batches-bin")
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    paths = [os.path.join(base, n) for n in names]
    if all(os.path.exists(p) for p in paths):
        x, y = _read_cifar_bin(paths)
        n = min(num_examples, len(x))
        return x[:n], y[:n]
    n = min(num_examples, 50000 if train else 10000)
    return synthetic_images(n, 32, 3, 10, seed if train else seed + 1)


_EMNIST_CLASSES = {"complete": 62, "merge": 47, "balanced": 47,
                   "letters": 26, "digits": 10, "mnist": 10}


def emnist_data(split: str = "balanced", num_examples: int = 10000,
                train: bool = True, seed: int = 555) -> Tuple[np.ndarray, np.ndarray]:
    """EMNIST (reference EmnistDataFetcher): (n, 784) + one-hot over the
    split's class count. Real data from IDX files under
    ``$DL4J_TPU_DATA_DIR/emnist`` (``emnist-<split>-train-images-idx3-ubyte``)."""
    if split not in _EMNIST_CLASSES:
        raise ValueError(f"Unknown EMNIST split {split!r}; "
                         f"one of {sorted(_EMNIST_CLASSES)}")
    n_classes = _EMNIST_CLASSES[split]
    stem = "train" if train else "test"
    base = os.path.join(_data_dir(), "emnist")
    for ext in ("", ".gz"):
        img = os.path.join(base, f"emnist-{split}-{stem}-images-idx3-ubyte{ext}")
        lab = os.path.join(base, f"emnist-{split}-{stem}-labels-idx1-ubyte{ext}")
        if os.path.exists(img) and os.path.exists(lab):
            x = _read_idx_images(img).astype(np.float32) / 255.0
            y = _read_idx_labels(lab).astype(np.int64)
            # letters split is 1-indexed in the source files
            if split == "letters" and y.min() == 1:
                y = y - 1
            n = min(num_examples, len(x))
            return x[:n], _one_hot(y[:n], n_classes)
    x, y = synthetic_images(num_examples, 28, 1, n_classes,
                            seed if train else seed + 1)
    return x.reshape(len(x), 784), y


def emnist_num_classes(split: str) -> int:
    return _EMNIST_CLASSES[split]


def svhn_data(num_examples: int = 10000, train: bool = True,
              seed: int = 777) -> Tuple[np.ndarray, np.ndarray]:
    """SVHN cropped-digits (reference SvhnDataFetcher): (n, 32, 32, 3) +
    (n, 10). Real data from ``$DL4J_TPU_DATA_DIR/svhn/{train,test}_32x32.mat``."""
    path = os.path.join(_data_dir(), "svhn",
                        ("train" if train else "test") + "_32x32.mat")
    if os.path.exists(path):
        try:
            from scipy.io import loadmat
            m = loadmat(path)
            x = m["X"].transpose(3, 0, 1, 2).astype(np.float32) / 255.0
            y = m["y"].reshape(-1).astype(np.int64) % 10  # label "10" is digit 0
            n = min(num_examples, len(x))
            return x[:n], _one_hot(y[:n], 10)
        except Exception as e:
            log.warning("SVHN cache at %s exists but failed to load (%s); "
                        "falling back to synthetic data", path, e)
    return synthetic_images(num_examples, 32, 3, 10,
                            seed if train else seed + 1)


def tiny_imagenet_data(num_examples: int = 5000, train: bool = True,
                       seed: int = 999) -> Tuple[np.ndarray, np.ndarray]:
    """TinyImageNet (reference TinyImageNetFetcher): (n, 64, 64, 3) + 200
    classes. Real data requires the unpacked ``tiny-imagenet-200`` directory
    under the cache dir; otherwise synthetic."""
    base = os.path.join(_data_dir(), "tiny-imagenet-200")
    if os.path.isdir(base):
        try:
            return _load_tiny_imagenet_dir(base, num_examples, train)
        except Exception as e:
            log.warning("TinyImageNet cache at %s exists but failed to load "
                        "(%s); falling back to synthetic data", base, e)
    return synthetic_images(num_examples, 64, 3, 200,
                            seed if train else seed + 1)


def _load_tiny_imagenet_dir(base, num_examples, train):
    # JPEG decoding without PIL/tf: defer to numpy-readable .npy cache the
    # user can produce once; the raw-archive path needs an image decoder this
    # environment does not ship.
    x = np.load(os.path.join(base, "train_x.npy" if train else "val_x.npy"))
    y = np.load(os.path.join(base, "train_y.npy" if train else "val_y.npy"))
    n = min(num_examples, len(x))
    return (x[:n].astype(np.float32) / (255.0 if x.max() > 1.5 else 1.0),
            _one_hot(y[:n].astype(np.int64), 200))


def lfw_data(num_examples: int = 1000, train: bool = True, side: int = 40,
             num_classes: int = 5749, seed: int = 1111) -> Tuple[np.ndarray, np.ndarray]:
    """LFW faces (reference LFWDataSetIterator): (n, side, side, 3). Real
    data via sklearn's fetch_lfw_people cache if present locally; else
    synthetic."""
    try:
        from sklearn.datasets import fetch_lfw_people
        d = fetch_lfw_people(color=True, download_if_missing=False)
        x = d.images.astype(np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        # nearest-neighbor resize to the requested square side
        h, w = x.shape[1], x.shape[2]
        ri = np.clip((np.arange(side) * h) // side, 0, h - 1)
        ci = np.clip((np.arange(side) * w) // side, 0, w - 1)
        x = x[:, ri][:, :, ci]
        y = d.target.astype(np.int64)
        # deterministic 80/20 train/test split
        cut = int(len(x) * 0.8)
        x, y = (x[:cut], y[:cut]) if train else (x[cut:], y[cut:])
        n = min(num_examples, len(x))
        return x[:n], _one_hot(y[:n], int(d.target.max()) + 1)
    except Exception as e:
        if not isinstance(e, ImportError) and "download_if_missing" not in str(e):
            log.warning("LFW load failed (%s); falling back to synthetic", e)
    return synthetic_images(num_examples, side, 3, min(num_classes, 64),
                            seed if train else seed + 1)
