"""CSV chain files: one file per recorded key in a directory.

Counterpart of ``eeyore_tpu/chains/chain_file.py``: per-key CSVs
(``sample.csv``, ``target_val.csv``, ...) in the reference's formats, "%.18e"
for floats and "%d" for ``accepted``, appended to by default, and parsed
back into a ``ChainList`` by ``to_chainlist``. Written and read with numpy
(``savetxt``, ``loadtxt``); a tensor on the card comes to the host once per
column.
"""

from pathlib import Path

import numpy as np
import torch

from eeyore_tpu_torch.chains.chain import Chain
from eeyore_tpu_torch.utils.host import host_array

DEFAULT_FMT = {"sample": "%.18e", "target_val": "%.18e", "grad_val": "%.18e",
               "momentum": "%.18e", "hamiltonian": "%.18e", "accepted": "%d"}


class ChainFile(Chain):
    def __init__(self, keys=("sample", "target_val", "accepted"), path=None, mode="a"):
        self.path = Path(path) if path is not None else Path.cwd()
        self.mode = mode
        self.path.mkdir(parents=True, exist_ok=True)
        self.reset(keys=keys)

    def reset(self, keys=("sample", "target_val", "accepted")):
        self.vals = {key: open(self.path / (key + ".csv"), self.mode) for key in keys}

    def close(self):
        for f in self.vals.values():
            f.close()

    def update(self, state, reset=True, close=True, fmt=None):
        """Append one row per key from ``state`` {key: value}."""
        fmt = fmt or DEFAULT_FMT
        if reset:
            self.reset(keys=self.vals.keys())
        for key, f in self.vals.items():
            v = state[key]
            if hasattr(v, "__array__"):  # arrays and tensors
                np.savetxt(f, host_array(v).ravel()[np.newaxis], fmt=fmt.get(key, "%.18e"),
                           delimiter=",")
            else:
                f.write(str(v) + "\n")
        if close:
            self.close()

    def update_all(self, arrays, fmt=None):
        """Append stacked columns {key: [n_iter, ...]}, one ``savetxt`` per key."""
        fmt = fmt or DEFAULT_FMT
        self.close()
        for key in self.vals.keys():
            a = host_array(arrays[key])
            with open(self.path / (key + ".csv"), self.mode) as f:
                np.savetxt(f, a.reshape(a.shape[0], -1), fmt=fmt.get(key, "%.18e"),
                           delimiter=",")

    def to_chainlist(self, keys=None, dtype=np.float64):
        """Parse the files of ``keys`` (of sample, target_val, grad_val and
        accepted) back into a ``ChainList`` of CPU tensors: ``dtype`` for
        the floats, int64 for ``accepted``."""
        from eeyore_tpu_torch.chains.chain_list import ChainList

        wanted = ("sample", "target_val", "grad_val", "accepted")
        keys = [k for k in (keys or self.vals.keys()) if k in wanted]
        columns = {}
        for key in keys:
            rows = np.loadtxt(self.path / (key + ".csv"), delimiter=",", dtype=np.float64,
                              ndmin=2)
            if key == "accepted":
                columns[key] = torch.as_tensor(rows[:, 0].astype(np.int64))
            elif key == "target_val":
                columns[key] = torch.as_tensor(rows[:, 0].astype(dtype))
            else:
                columns[key] = torch.as_tensor(rows.astype(dtype))
        return ChainList.from_arrays(columns)
