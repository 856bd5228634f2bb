"""Cross-chain diagnostics over stacked chain tensors.

Counterpart of ``eeyore_tpu/chains/chain_lists.py``: every recorded key is
one [num_chains, num_iters, ...] tensor, the output layout of a batched run.
Per-chain statistics, their ``*_summary`` aggregators, ``multi_rhat`` and the
keyed ``summary`` are float64 PyTorch (``eeyore_tpu_torch.stats``), on the
tensors' device. ``from_file`` reads the reference's CSV chain files.
"""

import numpy as np
import torch

import eeyore_tpu_torch.stats as st
from eeyore_tpu_torch.chains.chain_file import ChainFile

_DEFAULT_KEYS = ("sample", "target_val", "accepted")


def _chain_mean(values):
    return torch.mean(values, dim=0)


def _scalar_mean(values):
    return sum(values) / len(values)


class ChainLists:
    def __init__(self, keys=_DEFAULT_KEYS, vals=None):
        self.reset(keys=keys, vals=vals)

    def reset(self, keys=_DEFAULT_KEYS, vals=None):
        if vals is None:
            self._tensors = {k: None for k in keys}
        else:
            self._tensors = {k: torch.as_tensor(v) for k, v in vals.items()}

    @classmethod
    def from_chain_list(cls, chain_lists, keys=_DEFAULT_KEYS):
        """Stack the columns of ``keys`` that every ``ChainList`` holds."""
        shared = [k for k in keys if all(k in c.keys() for c in chain_lists)]
        return cls(keys=tuple(shared),
                   vals={k: torch.stack([c.column(k) for c in chain_lists]) for k in shared})

    @classmethod
    def from_arrays(cls, arrays):
        """Adopt {key: [num_chains, num_iters, ...]} from a batched run."""
        return cls(keys=tuple(arrays), vals=arrays)

    @classmethod
    def from_file(cls, paths, keys=_DEFAULT_KEYS, mode="a", dtype=np.float64):
        """One chain per directory of CSV chain files (``ChainFile``)."""
        loaded = [ChainFile(keys=keys, path=p, mode=mode).to_chainlist(dtype=dtype)
                  for p in paths]
        return cls.from_chain_list(loaded, keys=keys)

    def keys(self):
        return tuple(self._tensors)

    def tensor(self, key):
        """The stacked [num_chains, num_iters, ...] tensor of one key (None
        if the key was never recorded)."""
        return self._tensors.get(key)

    @property
    def vals(self):
        """Nested-list view: {key: [chain [rows]]}."""
        return {k: [list(chain) for chain in v] if v is not None else []
                for k, v in self._tensors.items()}

    def __repr__(self):
        return f"{len(self)} Markov chains, each containing {self.num_samples()} samples."

    def __len__(self):
        return self.num_chains()

    def num_chains(self):
        return self.tensor("sample").shape[0]

    def num_samples(self):
        return self.tensor("sample").shape[1]

    def num_params(self):
        return self.tensor("sample").shape[2]

    def get_chain(self, idx, key="sample"):
        """Chain ``idx`` of one key, [num_iters, ...] (a ladder's coldest
        chain: ``get_chain(sampler.default_indicator())``)."""
        return self.tensor(key)[idx]

    def get_samples(self):
        return self.tensor("sample")

    def get_target_vals(self):
        return self.tensor("target_val")

    def get_grad_vals(self):
        return self.tensor("grad_val")

    def _each_chain(self, fn):
        draws = self.tensor("sample")
        return [fn(draws[c]) for c in range(draws.shape[0])]

    # ---- per-chain statistics and summaries ----

    def mean(self):
        return self.tensor("sample").mean(dim=1)

    def mean_summary(self, g=_chain_mean):
        return g(self.mean())

    def mc_cov(self, method="inse", adjust=False):
        return torch.stack(self._each_chain(
            lambda d: st.mc_cov(d, method=method, adjust=adjust, rowvar=False)))

    def mc_cov_summary(self, g=_chain_mean, method="inse", adjust=False):
        return g(self.mc_cov(method=method, adjust=adjust))

    def mc_se(self, mc_cov_mat=None, method="inse", adjust=False):
        if mc_cov_mat is not None:
            return torch.stack([st.mc_se_from_cov(s) for s in mc_cov_mat])
        return torch.stack(self._each_chain(
            lambda d: st.mc_se(d, method=method, adjust=adjust, rowvar=False)))

    def mc_se_summary(self, g=_chain_mean, mc_cov_mat=None, method="inse", adjust=False):
        return g(self.mc_se(mc_cov_mat=mc_cov_mat, method=method, adjust=adjust))

    def mc_cor(self, mc_cov_mat=None, method="inse", adjust=False):
        if mc_cov_mat is not None:
            return torch.stack([st.cor_from_cov(s) for s in mc_cov_mat])
        return torch.stack(self._each_chain(
            lambda d: st.mc_cor(d, method=method, adjust=adjust, rowvar=False)))

    def mc_cor_summary(self, g=_chain_mean, mc_cov_mat=None, method="inse", adjust=False):
        return g(self.mc_cor(mc_cov_mat=mc_cov_mat, method=method, adjust=adjust))

    def acceptance(self):
        flags = self.tensor("accepted")
        return [float(torch.sum(flags[c])) / self.num_samples()
                for c in range(self.num_chains())]

    def acceptance_summary(self, g=_scalar_mean):
        return g(self.acceptance())

    def multi_ess(self, mc_cov_mat=None, method="inse", adjust=False):
        draws = self.tensor("sample")
        return [st.multi_ess(draws[c], mc_cov_mat=None if mc_cov_mat is None else mc_cov_mat[c],
                             method=method, adjust=adjust)
                for c in range(draws.shape[0])]

    def multi_ess_summary(self, g=_scalar_mean, mc_cov_mat=None, method="inse", adjust=False):
        return g(self.multi_ess(mc_cov_mat=mc_cov_mat, method=method, adjust=adjust))

    def multi_rhat(self, mc_cov_mat=None, method="inse", adjust=False):
        return st.multi_rhat(self.get_samples(), mc_cov_mat=mc_cov_mat, method=method,
                             adjust=adjust)

    def summary(self, keys=("multi_ess", "multi_rhat"),
                g_mean_summary=_chain_mean,
                g_mc_se_summary=_chain_mean,
                g_acceptance_summary=_scalar_mean,
                g_multi_ess_summary=_scalar_mean,
                mc_cov_mat=None, method="inse", adjust=False):
        if mc_cov_mat is None and not {"mc_se", "multi_ess", "multi_rhat"}.isdisjoint(keys):
            mc_cov_mat = self.mc_cov(method=method, adjust=adjust)
        producers = {
            "mean": lambda: self.mean_summary(g=g_mean_summary),
            "mc_se": lambda: self.mc_se_summary(g=g_mc_se_summary, mc_cov_mat=mc_cov_mat),
            "acceptance": lambda: self.acceptance_summary(g=g_acceptance_summary),
            "multi_ess": lambda: self.multi_ess_summary(
                g=g_multi_ess_summary, mc_cov_mat=mc_cov_mat),
            "multi_rhat": lambda: self.multi_rhat(mc_cov_mat=mc_cov_mat)[0],
        }
        return {k: producers[k]() for k in keys if k in producers}
