"""(x, y) datasets backed by host numpy arrays.

Counterpart of ``eeyore_tpu/datasets/xydataset.py`` (``one_hot``,
``XYDataset``, ``from_eeyore``, ``XYIDataset``, ``IDataset``,
``EmptyXYDataset``), with its own copy of the bundled CSVs. Data stays on
the host; callers move it to their device.
"""

from pathlib import Path

import numpy as np

_DATA_ROOT = Path(__file__).resolve().parent / "data"

data_paths = {
    "xor": _DATA_ROOT / "xor",
    "iris": _DATA_ROOT / "iris",
    "banknotes": _DATA_ROOT / "banknotes",
}


def one_hot(indices, num_classes=None):
    indices = np.asarray(indices, dtype=np.int64)
    if num_classes is None:
        num_classes = int(indices.max()) + 1
    out = np.zeros(indices.shape + (num_classes,))
    np.put_along_axis(out, indices[..., None], 1.0, axis=-1)
    return out


class XYDataset:
    def __init__(self, x, y):
        self.set_data(x, y)

    def __repr__(self):
        return "XYDataset"

    def __len__(self):
        return len(self.x)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def set_data(self, x, y):
        self.x = np.asarray(x)
        self.y = np.asarray(y)

    @classmethod
    def from_file(cls, path=None, xfile="x.csv", yfile="y.csv", xskiprows=1, yskiprows=1,
                  xusecols=None, yusecols=None, xndmin=2, yndmin=2, dtype=np.float64,
                  xonehot=False, yonehot=False):
        path = Path(path) if path is not None else Path.cwd()
        x = np.loadtxt(path / xfile, dtype=dtype, delimiter=",", skiprows=xskiprows,
                       usecols=xusecols, ndmin=xndmin, encoding="utf-8-sig")
        if xonehot:
            x = one_hot(x.astype(np.int64)).astype(dtype)
        y = np.loadtxt(path / yfile, dtype=dtype, delimiter=",", skiprows=yskiprows,
                       usecols=yusecols, ndmin=yndmin, encoding="utf-8-sig")
        if yonehot:
            y = one_hot(np.squeeze(y).astype(np.int64)).astype(dtype)
        return cls(x, y)

    @classmethod
    def from_eeyore(cls, data_name, xndmin=2, yndmin=2, dtype=np.float64, xonehot=False,
                    yonehot=False):
        """Load a bundled dataset (xor / iris / banknotes) by name."""
        if data_name not in data_paths:
            raise ValueError(
                f"unknown bundled dataset {data_name!r}; available: {sorted(data_paths)}")
        return cls.from_file(path=data_paths[data_name], xndmin=xndmin, yndmin=yndmin,
                             dtype=dtype, xonehot=xonehot, yonehot=yonehot)


class XYIDataset(XYDataset):
    """Index-returning variant: ``__getitem__`` gives (x, y, idx)."""

    def __repr__(self):
        return "XYIDataset: indexed XYDataset"

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx], idx

    @classmethod
    def from_xydataset(cls, xydataset):
        return cls(xydataset.x, xydataset.y)


class IDataset:
    """Wrap any (x, y) dataset so ``__getitem__`` also returns the index."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __repr__(self):
        return "IDataset: indexed Dataset"

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        x, y = self.dataset[idx]
        return x, y, idx

    @property
    def x(self):
        return self.dataset.x

    @property
    def y(self):
        return self.dataset.y


class EmptyXYDataset(XYDataset):
    """One empty (x, y) pair, so that sampling a distribution can reuse the
    batch-driven loop."""

    def __init__(self, dtype=np.float64):
        super().__init__(np.zeros((1, 0), dtype=dtype), np.zeros((1, 0), dtype=dtype))

    def __repr__(self):
        return "Empty XYDataset"
