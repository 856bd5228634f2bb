"""Whole-loop power-posterior tempering on data of at most 32 rows folded
into the code as constants.

Counterpart of ``eeyore_tpu/ops/resident_tempering_dense.py``: the tempering
move of ``ops/resident_walk_dense.py`` (``_make_resident_dense`` with the
ladder's ``temperatures``; on the card, move 3 of
``csrc/resident_walk_dense.cu``, counted under
``resident_walk_dense.TEMPERING_KERNEL``), with the algebra of
``ops/resident_tempering.py`` on the dense body.

Chain id for ``fn(seed, theta0s [C, P])``: c = sublane * (C / 8) + column,
and the ladders lie along the ``chain_block / 8`` columns of each sublane
row, so callers enumerate chains as (sublane, ladder, rung) with rung
fastest; because C / 8 and the lane block are multiples of L, ``rung = c %
L``, as on staged data.
"""

from eeyore_tpu_torch.ops.resident_tempering import ladder_move
from eeyore_tpu_torch.ops.resident_walk_dense import _make_resident_dense


def make_resident_tempering_dense(model, x, y, num_rungs, step=0.01, sampler="MALA",
                                  temperatures=None, between_step=10, num_iters=1000,
                                  num_burnin_iters=0, chain_block=8192, record_thin=1,
                                  record_extras=False, device="cuda"):
    """Whole-loop parallel tempering, dense data: ``fn(seed, theta0s [C,
    P])`` with ``C = num_ladders * num_rungs`` chains (rung varies fastest;
    coldest rung last in each ladder). Returns the outputs of
    ``resident_tempering.make_resident_tempering``; ``chain_block`` is a
    multiple of 1024 whose eighth is a multiple of ``num_rungs``."""
    move, temperatures = ladder_move(model, sampler, num_rungs, temperatures)
    return _make_resident_dense(model, x, y, num_iters, num_burnin_iters, chain_block,
                                record_thin, move, step, temperatures=temperatures,
                                between_step=between_step, record_extras=record_extras,
                                device=device)
