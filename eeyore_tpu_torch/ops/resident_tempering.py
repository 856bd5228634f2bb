"""Whole-loop power-posterior tempering on data staged in shared memory.

Counterpart of ``eeyore_tpu/ops/resident_tempering.py``: the within-rung
moves on every rung of many ladders and the even/odd swap rounds between
adjacent rungs run in one kernel, the tempering move of
``ops/resident_walk.py`` (``_make_resident`` with the ladder's
``temperatures``; on the card, move 3 of ``csrc/resident_walk.cu``, counted
under ``resident_walk.TEMPERING_KERNEL``). ``ladder_lane_constants`` is the
JAX package's per-lane form of the ladder, kept for comparison with it; the
kernels take the [L] temperatures and compute the rest from the chain index.

Layout: chain c = ladder * L + rung, ladder-major, rungs temperature
ascending with the coldest last, as the reference orders its chain list.
The kernel stores each chain's untempered log-target and applies the rung's
temperature at the accept tests, so a swap of the pair (i, i + 1) needs no
new evaluation: ``log_rate = (t_i - t_j)(base_j - base_i)``.
"""

import numpy as np

from eeyore_tpu_torch.ops.resident_walk import _make_resident
from eeyore_tpu_torch.samplers.power_posterior import default_temperatures

# The ladder samplers of the reference (power_posterior_sampler.py:68-82)
# and the walk move that runs each within a rung.
LADDER_MOVES = {"MALA": "mala", "MetropolisHastings": "mh"}


def ladder_lane_constants(num_rungs, chain_block, temperatures):
    """Per-lane ladder constants for a ladder-major lane layout.

    Returns float32 [1, chain_block] arrays:
    - ``temps``: temperature of each lane's rung,
    - ``temps_right``: temperature of the lane one rung hotter→colder
      neighbour (lane + 1; arbitrary at ladder boundaries — always masked),
    - ``m_even`` / ``m_odd``: 1.0 where the lane is the LOWER member of an
      (even, even+1) / (odd, odd+1) rung pair, 0.0 elsewhere. Pairs never
      cross ladder boundaries (a lane with rung == L-1 is never lower).
    """
    L = int(num_rungs)
    if chain_block % L:
        raise ValueError(f"chain_block {chain_block} not a multiple of the "
                         f"ladder size {L}")
    temperatures = np.asarray(temperatures, dtype=np.float32)
    if temperatures.shape != (L,):
        raise ValueError(f"need {L} temperatures, got {temperatures.shape}")
    ladders = chain_block // L
    rung = np.tile(np.arange(L), ladders)
    temps = np.tile(temperatures, ladders)
    temps_right = np.roll(temps, -1)
    m_even = ((rung % 2 == 0) & (rung < L - 1)).astype(np.float32)
    m_odd = ((rung % 2 == 1) & (rung < L - 1)).astype(np.float32)
    return (temps.reshape(1, -1), temps_right.reshape(1, -1),
            m_even.reshape(1, -1), m_odd.reshape(1, -1))


def ladder_move(model, sampler, num_rungs, temperatures):
    """(the walk move of ``sampler`` within each rung, the ``num_rungs``
    temperatures, ``default_temperatures`` when None); raises for a tempered
    model (the ladder applies the temperatures), another sampler or another
    number of temperatures."""
    if getattr(model, "temperature", None) is not None:
        raise ValueError("pass an untempered model; the ladder applies temperatures")
    if sampler not in LADDER_MOVES:
        raise ValueError(f"unsupported ladder sampler {sampler!r} "
                         "(reference supports MetropolisHastings and MALA)")
    L = int(num_rungs)
    temperatures = np.asarray(default_temperatures(L) if temperatures is None else temperatures,
                              dtype=np.float32)
    if temperatures.shape != (L,):
        raise ValueError(f"need {L} temperatures, got {temperatures.shape}")
    return LADDER_MOVES[sampler], temperatures


def make_resident_tempering(model, x, y, num_rungs, step=0.01, sampler="MALA",
                            temperatures=None, between_step=10, num_iters=1000,
                            num_burnin_iters=0, chain_block=2048, record_thin=1,
                            record_extras=False, device="cuda"):
    """Whole-loop parallel tempering: ``fn(seed, theta0s [C, P])`` with ``C
    = num_ladders * num_rungs`` chains, ladder-major (rung varies fastest,
    coldest rung last in each ladder), a multiple of ``chain_block``.
    Returns ``(samples [kept, C, P], final [C, P], counts [C, 2])``, counts
    column 0 the post-burn-in within-rung accepts and column 1 the swap
    accepts (once per pair, on the lower member); with ``record_extras``
    also ``target_val [kept, C]`` (untempered) and ``accepted [kept, C]``
    (int32 moved flags).

    ``sampler`` is "MALA" (``step`` the Langevin step, with the asymmetric
    Hastings correction) or "MetropolisHastings" (``step`` the random-walk
    scale). Swaps run every ``between_step`` iterations with alternating
    even/odd parity. On a CUDA ``device`` every call is one launch of the
    kernel; on the CPU it runs the plain version.
    """
    move, temperatures = ladder_move(model, sampler, num_rungs, temperatures)
    return _make_resident(model, x, y, num_iters, num_burnin_iters, chain_block, record_thin,
                          move, step, temperatures=temperatures, between_step=between_step,
                          record_extras=record_extras, device=device)
