"""Run monitoring over many chains: acceptance, target-value and tuned-step
summaries.

Counterpart of ``eeyore_tpu/samplers/monitor.py``. ``summarize_run`` reads
the stacked tensors of ``sample_chains(..., return_arrays=True)`` or a
``ChainLists``, on any device, and optionally the final kernel state for the
tuner's settings; the statistics are numpy's on the host, as in the JAX
package, so the same arrays give the same dictionary.
"""

import numpy as np

from eeyore_tpu_torch.utils.host import host_array


def _get(arrays, key):
    if hasattr(arrays, "tensor"):  # ChainLists
        return host_array(arrays.tensor(key)) if key in arrays.keys() else None
    return host_array(arrays.get(key))


def summarize_run(arrays, state=None, quantiles=(0.05, 0.5, 0.95)):
    """Summary across chains: acceptance quantiles and its mean, the chains
    that accept almost nothing, the spread of the final target values and
    the chains whose final value is not finite, and with ``state`` the
    tuned step and trajectory length."""
    out = {}
    accepted = _get(arrays, "accepted")
    if accepted is not None:
        if accepted.ndim == 3:  # blocked Gibbs: [chains, iters, blocks]
            rates = accepted.mean(axis=1)
            out["block_acceptance_mean"] = rates.mean(axis=0).tolist()
            rates = rates.mean(axis=1)
        else:
            rates = accepted.mean(axis=1)
        out["acceptance_quantiles"] = {
            f"q{int(q*100)}": float(np.quantile(rates, q)) for q in quantiles}
        out["acceptance_mean"] = float(rates.mean())
        out["num_stuck_chains"] = int(np.sum(rates < 0.01))

    accept_stat = _get(arrays, "accept_stat")
    if accept_stat is not None:
        # NUTS: `accepted` means "the sample moved", accept_stat is the
        # Metropolis statistic to compare with other kernels' acceptance
        out["accept_stat_mean"] = float(accept_stat.mean())

    target = _get(arrays, "target_val")
    if target is not None:
        finals = target[:, -1]
        out["final_target_quantiles"] = {
            f"q{int(q*100)}": float(np.quantile(finals, q)) for q in quantiles}
        out["num_diverged_chains"] = int(np.sum(~np.isfinite(finals)))

    if state is not None:
        step = host_array(getattr(state, "step", None))
        if step is not None:
            out["tuned_step"] = {"mean": float(step.mean()), "min": float(step.min()),
                                 "max": float(step.max())}
        num_steps = host_array(getattr(state, "num_steps", None))
        if num_steps is not None:
            out["tuned_num_steps"] = {"mean": float(num_steps.mean()),
                                      "max": int(num_steps.max())}
    return out
