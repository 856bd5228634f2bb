"""Experiment harness: the epoch-based ``run`` and the many-chain
``benchmark`` of the reference's samplers, on the batched runners.

Counterpart of ``eeyore_tpu/samplers/harness.py``, with a ``torch.Generator``
in place of the key; the generator advances as the harness draws from it.

- ``run(num_epochs, num_burnin_epochs)``: iterations are epochs x batches,
  burn-in discarded; ``verbose=True`` runs the generic path in segments of
  ``verbose_step`` iterations and prints each segment's wall, giving the
  chain of the silent generic run from the same generator state.
- ``benchmark(num_chains, ...)``: runs batches of ``batch_chains`` chains
  from prior (or given) inits until ``num_chains`` chains pass
  ``check_conditions(chain, runtime)``, and writes each to ``run<i>/`` as
  CSVs with ``runtime.txt``, the errors under ``errors/`` and the counts in
  ``run_counts.txt``, as the JAX package writes them. The runtime of a chain
  is its batch's wall (ended by ``torch.cuda.synchronize()`` on the card)
  over ``batch_chains``: chains of a batch share every launch, so no chain
  has a wall of its own.

A batch that raises ``RuntimeError`` or ``FloatingPointError`` from the
sampler counts its chains as runtime errors and is retried, as in JAX. The
errors of a kernel's build or launch, and CUDA errors, are not the sampler's
numbers going wrong: they propagate, so that a broken kernel is never
written off as failed chains (and retried forever under
``max_attempts=None``).
"""

import re
import time
from datetime import timedelta
from pathlib import Path

import torch

from eeyore_tpu_torch.chains import ChainList
from eeyore_tpu_torch.datasets import DataCounter, as_schedule
from eeyore_tpu_torch.samplers.runner import (
    _check_thin,
    _prepare,
    _resolve_auto_budget,
    _run_generic,
    sample_chain,
    sample_chains,
)

_DEVICE_ERROR = re.compile(r"cuda|cublas|cusolver|nvcc|nvrtc", re.IGNORECASE)


def is_kernel_or_device_error(err):
    """Whether ``err`` comes from a kernel's build or launch or from the
    card, not from the numbers of a run."""
    from eeyore_tpu_torch.ops._build import KernelError

    accelerator_error = getattr(torch, "AcceleratorError", None)
    if isinstance(err, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    if accelerator_error is not None and isinstance(err, accelerator_error):
        return True
    return bool(_DEVICE_ERROR.search(str(err)))


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SamplerHarness:
    """Binds a transition kernel and data into the reference's sampler API."""

    def __init__(self, kernel, data, theta0=None, generator=None):
        self.kernel = kernel
        self.schedule = as_schedule(data)
        model = kernel.model
        self.device = torch.device(getattr(model, "device", "cuda"))
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(0))
        self.theta0 = None if theta0 is None else self._theta(theta0)
        self.chain = ChainList(keys=self.kernel.state_keys)
        self.counter = DataCounter(
            batch_size=self.schedule.x.shape[1],
            sample_size=self.schedule.x.shape[0] * self.schedule.x.shape[1],
            num_batches=self.schedule.num_batches,
        )
        self.final_state = None

    def _theta(self, theta):
        """``theta`` on the model's device, in its dtype."""
        dtype = getattr(self.kernel.model, "dtype", None)
        return torch.as_tensor(theta).to(device=self.device, dtype=dtype)

    def get_model(self):
        return self.kernel.model

    def get_chain(self):
        return self.chain

    def get_sample(self, idx):
        return self.chain.get_sample(idx)

    def get_param(self, idx):
        return self.chain.get_param(idx)

    def reset(self, theta, generator=None, reset_chain=True):
        self.theta0 = self._theta(theta)
        if generator is not None:
            self.generator = generator
        if reset_chain:
            self.chain = ChainList(keys=self.kernel.state_keys)

    def run(self, num_epochs, num_burnin_epochs, verbose=False, verbose_step=100,
            record_thin=1, backend="auto", record_keys=None):
        """Run one chain for ``num_epochs`` epochs, the first
        ``num_burnin_epochs`` discarded; returns its ``ChainList``.

        With no ``theta0``, the initial state is a draw from the model's
        prior. ``backend`` and ``record_keys`` are ``sample_chain``'s: on
        the card "auto" sends eligible kernels to a whole-loop kernel.
        ``verbose=True`` runs the generic path in segments of
        ``verbose_step`` iterations, printing each segment's wall after
        waiting for the device."""
        if self.theta0 is None:
            self.theta0 = self.get_model().prior.sample(self.generator)
        self.counter.set_epoch_info(num_epochs, num_burnin_epochs)
        start = time.perf_counter()
        if verbose:
            chain, state = self._run_segmented(verbose_step, record_thin)
        else:
            chain, state = sample_chain(
                self.kernel, self.generator, self.theta0, self.schedule,
                self.counter.num_iters, self.counter.num_burnin_iters,
                return_state=True, record_thin=record_thin, backend=backend,
                record_keys=record_keys,
            )
        _synchronize(self.device)
        runtime = time.perf_counter() - start
        if verbose:
            print(f"{self.counter.num_iters} iterations "
                  f"({self.counter.num_epochs} epochs, {self.counter.num_burnin_epochs} burn-in) "
                  f"in {timedelta(seconds=runtime)}")
        self.chain = chain
        self.final_state = state
        self.last_runtime = runtime
        return chain

    def _segment_ends(self, verbose_step, record_thin):
        """The iterations after which a verbose run reports: burn-in in
        segments of ``verbose_step``, then segments whose length is a
        multiple of ``record_thin``."""
        num_iters, num_burnin = self.counter.num_iters, self.counter.num_burnin_iters
        ends, pos = [], 0
        while pos < num_burnin:
            pos += min(verbose_step, num_burnin - pos)
            ends.append(pos)
        unit = max(record_thin, verbose_step - verbose_step % record_thin)
        while pos < num_iters:
            pos += min(unit, num_iters - pos)
            ends.append(pos)
        return ends

    def _run_segmented(self, verbose_step, record_thin):
        """The generic path of ``sample_chain``, the same draws in the same
        order, with a report after each segment (reference
        serial_sampler.py:41-50)."""
        kernel = self.kernel
        num_iters, num_burnin = self.counter.num_iters, self.counter.num_burnin_iters
        _check_thin(num_iters, num_burnin, record_thin)
        theta0s, schedule = _prepare(kernel, self.theta0[None], self.schedule, num_iters,
                                     num_burnin, record_thin)
        _resolve_auto_budget(kernel, self.generator, schedule, theta0s)
        kernel.recompute_current = schedule.num_batches != 1
        kernel.num_burnin_iters = num_burnin
        ends = self._segment_ends(verbose_step, record_thin)
        clock = {"start": time.perf_counter(), "last": 0}

        def report(i, state):
            done = i + 1
            if done not in ends:
                return
            _synchronize(theta0s.device)
            now = time.perf_counter()
            epoch = (done - 1) // self.counter.num_batches + 1
            print(f"Iteration {done}/{num_iters}, epoch {epoch}/"
                  f"{self.counter.num_epochs}: last {done - clock['last']} iterations "
                  f"in {timedelta(seconds=now - clock['start'])}")
            clock["start"], clock["last"] = now, done

        state, recorded = _run_generic(kernel, self.generator, theta0s, schedule, num_iters,
                                       num_burnin, tuple(kernel.state_keys), record_thin,
                                       on_iteration=report)
        return ChainList.from_arrays({k: v[0] for k, v in recorded.items()}), state

    def to_chainfile(self, path=None, mode="a"):
        self.chain.to_chainfile(path=path, mode=mode)

    def _write_error(self, path, count, text):
        err_path = path / "errors"
        err_path.mkdir(parents=True, exist_ok=True)
        with open(err_path / f"error{count}.txt", "w") as f:
            f.write(f"{text}\n")

    def _inits(self, init, succeeded, batch_chains):
        """A batch's initial states: ``init[succeeded + c]`` while the list
        lasts, prior draws past its end."""
        theta0s = self.get_model().prior.sample(self.generator, (batch_chains,))
        if init is not None:
            for c in range(min(batch_chains, max(len(init) - succeeded, 0))):
                theta0s[c] = self._theta(init[succeeded + c])
        return theta0s

    def benchmark(self, num_chains, num_epochs, num_burnin_epochs, path,
                  init=None, check_conditions=None, verbose=False,
                  batch_chains=None, max_attempts=None, backend="auto"):
        """Simulate until ``num_chains`` chains pass ``check_conditions``;
        returns the accepted chains as ``ChainList``s. Writes
        ``run<i>/{<key>.csv, runtime.txt}``, ``errors/error<n>.txt`` and
        ``run_counts.txt`` under ``path``.

        ``max_attempts=None`` retries batches until the quota is met
        (reference serial_sampler.py:72). An ``init`` list is indexed by the
        success count, so a failed init is tried again and later entries are
        reached once earlier chains succeed. A chain with a non-finite
        sample counts as a runtime error. The ``runtime`` given to
        ``check_conditions`` and written to ``runtime.txt`` is the batch's
        wall over ``batch_chains``, the same for every chain of a batch."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        self.counter.set_epoch_info(num_epochs, num_burnin_epochs)
        batch_chains = batch_chains or num_chains

        succeeded, failed_conditions, failed_errors = 0, 0, 0
        accepted = []
        attempts = 0
        while succeeded < num_chains and (max_attempts is None or attempts < max_attempts):
            attempts += 1
            theta0s = self._inits(init, succeeded, batch_chains)
            start = time.perf_counter()
            try:
                arrays = sample_chains(
                    self.kernel, self.generator, theta0s, self.schedule,
                    self.counter.num_iters, self.counter.num_burnin_iters,
                    return_arrays=True, backend=backend,
                )
                _synchronize(theta0s.device)
            except (RuntimeError, FloatingPointError) as err:
                if is_kernel_or_device_error(err):
                    raise
                failed_errors += batch_chains
                self._write_error(path, failed_errors, err)
                continue
            runtime = (time.perf_counter() - start) / batch_chains
            arrays = {k: v.detach().cpu() for k, v in arrays.items() if v is not None}
            finite = torch.isfinite(arrays["sample"]).flatten(1).all(1).tolist()

            for c in range(batch_chains):
                if succeeded >= num_chains:
                    break
                chain = ChainList.from_arrays({k: v[c] for k, v in arrays.items()})
                if not finite[c]:
                    failed_errors += 1
                    self._write_error(path, failed_errors, "non-finite samples in chain")
                    continue
                if (check_conditions is None) or check_conditions(chain, runtime):
                    succeeded += 1
                    run_path = path / ("run" + str(succeeded).zfill(len(str(num_chains))))
                    run_path.mkdir(parents=True, exist_ok=True)
                    chain.to_chainfile(path=run_path, mode="w")
                    with open(run_path / "runtime.txt", "w") as f:
                        f.write(f"{runtime}\n")
                    accepted.append(chain)
                    if verbose:
                        print(f"chain {succeeded}/{num_chains} accepted "
                              f"(acceptance {chain.acceptance_rate():.3f}, "
                              f"runtime {timedelta(seconds=runtime)})")
                else:
                    failed_conditions += 1
                    if verbose:
                        print("chain failed conditions")

        with open(path / "run_counts.txt", "w") as f:
            f.write(f"{succeeded},succesful\n")
            f.write(f"{failed_conditions},unmet_conditions\n")
            f.write(f"{failed_errors},runtime_errors\n")

        return accepted
