"""Columnar in-memory record of one chain.

Counterpart of ``eeyore_tpu/chains/chain_list.py``: one stacked tensor per
recorded key (``from_arrays``), plus a row-at-a-time ``update`` whose rows
are stacked onto the columns on first read. The statistics are the float64
PyTorch ones of ``eeyore_tpu_torch.stats``. The file methods (CSV chain
files, ``save``/``load``, ``to_kanga``) are not ported yet.
"""

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

    def get_target_vals(self):
        return self.column("target_val")

    def mean(self):
        return self.get_samples().mean(dim=0)

    def mc_cov(self, method="inse", adjust=False):
        return st.mc_cov(self.get_samples(), method=method, adjust=adjust, rowvar=False)

    def mc_se(self, mc_cov_mat=None, method="inse", adjust=False):
        if mc_cov_mat is not None:
            return st.mc_se_from_cov(mc_cov_mat)
        return st.mc_se(self.get_samples(), method=method, adjust=adjust, rowvar=False)

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
