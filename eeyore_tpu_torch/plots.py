"""Chain plotting helpers: traces, running means, marginal histograms,
autocorrelation.

Counterpart of ``eeyore_tpu/plots.py`` (the reference delegates these to
kanga). Each helper takes one parameter's draws (``chain.get_param(i)``) as
a tensor on any device or an array, returns ``(fig, ax)`` and never calls
``plt.show()``. matplotlib is imported when a plot is made, not before.
"""

import numpy as np

from eeyore_tpu_torch.utils.host import host_array


def _draws(draws, dtype=None):
    return np.asarray(host_array(draws), dtype=dtype).reshape(-1)


def _axes(ax, title, xlabel, ylabel):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    return ax.figure, ax


def trace(draws, title=None, xlabel="Iteration", ylabel="Parameter value",
          ax=None, **kwargs):
    """Trace plot of one parameter's draws."""
    draws = _draws(draws)
    fig, ax = _axes(ax, title, xlabel, ylabel)
    ax.plot(np.arange(len(draws)), draws, linewidth=0.7, **kwargs)
    return fig, ax


def running_mean(draws, title=None, xlabel="Iteration", ylabel="Running mean",
                 ax=None, **kwargs):
    """Running-mean plot (the cumulative mean at each iteration)."""
    draws = _draws(draws, np.float64)
    means = np.cumsum(draws) / np.arange(1, len(draws) + 1)
    fig, ax = _axes(ax, title, xlabel, ylabel)
    ax.plot(np.arange(len(means)), means, **kwargs)
    return fig, ax


def hist(draws, bins=30, density=True, title=None, xlabel="Parameter value",
         ylabel="Relative frequency", ax=None, **kwargs):
    """Marginal histogram of one parameter's draws."""
    draws = _draws(draws)
    fig, ax = _axes(ax, title, xlabel, ylabel)
    ax.hist(draws, bins=bins, density=density, **kwargs)
    return fig, ax


def acf(draws, max_lag=50, title=None, xlabel="Lag",
        ylabel="Autocorrelation", ax=None, **kwargs):
    """Stem plot of the autocorrelation function up to ``max_lag``."""
    draws = _draws(draws, np.float64)
    centered = draws - draws.mean()
    denom = np.dot(centered, centered)
    lags = np.arange(min(max_lag, len(draws) - 1) + 1)
    rho = np.asarray([np.dot(centered[:len(centered) - k], centered[k:]) / denom
                      for k in lags])
    fig, ax = _axes(ax, title, xlabel, ylabel)
    ax.stem(lags, rho, **kwargs)
    return fig, ax


def chain_summary_figure(chain, params=None, bins=30):
    """One figure for a chain: a row a parameter, with its trace, running
    mean and histogram."""
    import matplotlib.pyplot as plt

    samples = host_array(chain.get_samples())
    params = list(range(samples.shape[1]) if params is None else params)
    fig, axes = plt.subplots(len(params), 3, figsize=(12, 2.5 * len(params)), squeeze=False)
    for row, i in enumerate(params):
        draws = samples[:, i]
        trace(draws, ylabel=rf"$\theta_{{{i}}}$", ax=axes[row][0])
        running_mean(draws, ax=axes[row][1])
        hist(draws, bins=bins, ax=axes[row][2])
    fig.tight_layout()
    return fig
