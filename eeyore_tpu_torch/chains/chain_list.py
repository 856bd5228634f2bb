"""Columnar in-memory record of one chain.

Counterpart of ``eeyore_tpu/chains/chain_list.py``: one stacked tensor per
recorded key (``from_arrays``), plus a row-at-a-time ``update`` whose rows
are stacked onto the columns on first read. The statistics are the float64
PyTorch ones of ``eeyore_tpu_torch.stats``. ``save``/``load`` keep the
columns in one ``.npz``; ``to_chainfile`` writes the reference's CSVs.
"""

from pathlib import Path

import numpy as np
import torch

import eeyore_tpu_torch.stats as st
from eeyore_tpu_torch.chains.chain import Chain


class ChainList(Chain):
    def __init__(self, keys=("sample", "target_val", "accepted"), vals=None):
        self.reset(keys=keys, vals=vals)

    def reset(self, keys=("sample", "target_val", "accepted"), vals=None):
        if vals is not None:
            keys = tuple(vals.keys())
        self._keys = tuple(keys)
        self._columns = {}
        self._staging = {k: list(vals[k]) if vals is not None else [] for k in self._keys}

    @classmethod
    def from_arrays(cls, arrays):
        """Adopt stacked tensors {key: [n_iter, ...]} wholesale."""
        chain = cls(keys=tuple(arrays))
        chain._columns = {k: torch.as_tensor(v) for k, v in arrays.items()}
        return chain

    def keys(self):
        return self._keys

    def column(self, key):
        """The consolidated [n_iter, ...] tensor of one recorded key."""
        pending = self._staging.get(key)
        if pending:
            tail = torch.stack([torch.as_tensor(r) for r in pending])
            head = self._columns.get(key)
            self._columns[key] = tail if head is None or head.numel() == 0 \
                else torch.cat([head, tail], dim=0)
            pending.clear()
        got = self._columns.get(key)
        return torch.zeros((0,)) if got is None else got

    @property
    def vals(self):
        """Dict-of-rows view of the columns."""
        return {k: list(self.column(k)) for k in self._keys}

    def update(self, state):
        for k in self._keys:
            self._staging[k].append(state[k])

    def __repr__(self):
        return f"Markov chain containing {len(self)} samples."

    def __len__(self):
        head = self._columns.get("sample")
        return len(self._staging.get("sample", ())) + (0 if head is None else head.shape[0])

    def num_samples(self):
        return len(self)

    def num_params(self):
        return self.column("sample").shape[-1]

    def get_samples(self):
        return self.column("sample")

    def get_sample(self, idx):
        return self.column("sample")[idx]

    def get_param(self, idx):
        return self.column("sample")[:, idx]

    def get_target_vals(self):
        return self.column("target_val")

    def get_grad_vals(self):
        return self.column("grad_val")

    def get_grad_val(self, idx):
        return self.column("grad_val")[idx]

    def state(self, idx=-1):
        """{key: the row ``idx`` of each recorded key}."""
        current = {}
        for k in self._keys:
            col = self.column(k)
            if -len(col) <= idx < len(col):
                current[k] = col[idx]
            else:
                print(f"WARNING: chain does not have values for {k}.")
        return current

    def mean(self):
        return self.get_samples().mean(dim=0)

    def running_mean(self, idx):
        return st.running_mean(self.get_param(idx))

    def running_means(self):
        return st.running_mean(self.get_samples(), axis=0)

    def mc_cov(self, method="inse", adjust=False):
        return st.mc_cov(self.get_samples(), method=method, adjust=adjust, rowvar=False)

    def mc_se(self, mc_cov_mat=None, method="inse", adjust=False):
        if mc_cov_mat is not None:
            return st.mc_se_from_cov(mc_cov_mat)
        return st.mc_se(self.get_samples(), method=method, adjust=adjust, rowvar=False)

    def mc_cor(self, mc_cov_mat=None, method="inse", adjust=False):
        if mc_cov_mat is not None:
            return st.cor_from_cov(mc_cov_mat)
        return st.mc_cor(self.get_samples(), method=method, adjust=adjust, rowvar=False)

    def multi_ess(self, mc_cov_mat=None, method="inse", adjust=False):
        return st.multi_ess(self.get_samples(), mc_cov_mat=mc_cov_mat, method=method,
                            adjust=adjust)

    def acceptance_rate(self):
        """Accepted moves per recorded iteration; with per-sub-block flags
        [n_iter, B] (Gibbs), the sum over blocks per iteration."""
        return float(torch.sum(self.column("accepted"))) / len(self)

    def block_acceptance_rate(self):
        """Per-sub-block acceptance [B] of a Gibbs chain (reference
        chain_list.py:98-99)."""
        return self.column("accepted").to(torch.float64).mean(dim=0)

    def save(self, path):
        """Every column into one ``.npz`` (on the host)."""
        np.savez(path, **{k: self.column(k).detach().cpu().numpy() for k in self._keys})

    def load(self, path):
        """Replace the columns by those of a ``.npz`` written by ``save``
        (either package's), as CPU tensors."""
        name = str(path)
        with np.load(name if name.endswith(".npz") else name + ".npz") as data:
            self._keys = tuple(data.files)
            self._columns = {k: torch.as_tensor(data[k]) for k in data.files}
            self._staging = {k: [] for k in data.files}

    def to_chainfile(self, keys=None, path=None, mode="a", fmt=None):
        """Write every column of ``keys`` to the reference's CSVs (one file a
        key), one pass a key."""
        from eeyore_tpu_torch.chains.chain_file import ChainFile

        keys = tuple(keys) if keys is not None else self._keys
        chainfile = ChainFile(keys=keys, path=Path(path) if path else Path.cwd(), mode=mode)
        chainfile.update_all({k: self.column(k) for k in keys}, fmt=fmt)
        chainfile.close()
        return chainfile

    def to_kanga(self, keys=None):
        """Convert to ``kanga.chains.ChainArray`` (numpy columns) for kanga's
        plotting stack; kanga is an optional dependency."""
        try:
            from kanga.chains import ChainArray
        except ImportError as e:
            raise ImportError(
                "ChainList.to_kanga requires the optional 'kanga' package "
                "(pip install kanga)") from e

        wanted = set(keys or self._keys) & {"sample", "target_val", "grad_val", "accepted"}
        return ChainArray({k: self.column(k).detach().cpu().numpy() for k in wanted})
