"""The check that decides ``correct``, driven through a whole run on the
CPU at small sizes (the kernels' plain versions stand in for the card, the
look for a card skipped): sound runs read correct; the control (the
reference in bfloat16 in the program's place) reads not correct; and so does
the timed path broken underneath, once for each fault the cells can have: a
step that returns its state unchanged, half of the batch left out with the
mean over the rest, an answer altered where it is produced. (One chip: there
is no exchange between chips to leave out.)"""

import functools

import numpy as np
import pytest
import torch

import run
from harness import check
from harness.spec import Cell

SMALL = {
    "xor_hmc": {"traffic": {"chains": 1024, "iterations": 12}, "check": {"chains": 64}},
    "iris_mala": {"traffic": {"chains": 128, "iterations": 24, "burnin": 8},
                  "check": {"chains": 32}},
    "iris_hmc_da": {"traffic": {"chains": 256, "iterations": 16, "burnin": 6},
                    "check": {"groups": 1, "chains_per_group": 16, "burnin_groups": 1}},
    "xor_nuts_d3": {"traffic": {"chains": 1024, "iterations": 16, "burnin": 6},
                    "check": {"chains": 64, "tuning_group": 1024}},
}
MAKERS = {"resident_hmc": "make_resident_hmc", "resident_hmc_dense": "make_resident_hmc_dense",
          "resident_walk": "make_resident_mala",
          "resident_nuts_dense": "make_resident_nuts_dense"}
SEED = 2147483659


def _run(cell, control=False):
    result, lines = run.run_cell(Cell(cell), SEED, 0.0, False, device="cpu",
                                 overrides=SMALL[cell], control=control)
    return result


def _break(monkeypatch, cell, fault):
    """Plant ``fault`` in the maker that dispatch calls for the cell's kernel."""
    import importlib

    module = importlib.import_module(f"eeyore_tpu_torch.ops.{Cell(cell).kernel}")
    name = MAKERS[Cell(cell).kernel]
    maker = getattr(module, name)

    @functools.wraps(maker)
    def broken(model, x, y, *args, **kwargs):
        if fault == "half_batch":
            h = x.shape[0] // 2
            x = np.concatenate([x[:h], x[:h]])
            y = np.concatenate([y[:h], y[:h]])
        fn = maker(model, x, y, *args, **kwargs)

        def fn_broken(seed, theta0s, **kw):
            out = list(fn(seed, theta0s, **kw))
            if fault == "unchanged":
                out[0] = theta0s[None].expand_as(out[0])
                out[1] = theta0s
                out[2] = torch.zeros_like(out[2])
            elif fault == "altered":
                out[0] = out[0].clone()
                out[0][out[0].shape[0] // 2] += 1e-2
            return tuple(out)

        return fn_broken

    monkeypatch.setattr(module, name, broken)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct_and_control_is_not(cell):
    result = _run(cell, control=True)
    assert result["correct"], result["checks"]
    limits = Cell(cell).spec["limits"]
    ok, lines = check.verdict(result["control"], limits)
    assert not ok, lines
    assert result["control"]["gap"] > limits["gap"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    _break(monkeypatch, cell, fault)
    result = _run(cell)
    assert not result["correct"], result["checks"]


def test_nuts_work_counts_do_not_depend_on_the_replay_chunks(monkeypatch):
    # the kept transitions are replayed in chunks of rows: the live leaves,
    # U-turn tests and merges a chain did must come out the same however
    # they are cut, and within the budget of 7, 7 and 3 an iteration
    def counts():
        result, _ = run.run_cell(Cell("xor_nuts_d3"), SEED, 0.0, True, device="cpu",
                                 overrides=SMALL["xor_nuts_d3"])
        return result["notes"]["work_per_chain"]

    whole = counts()
    monkeypatch.setattr(check, "CHUNK", 100)
    chunked = counts()
    assert chunked == pytest.approx(whole, rel=1e-12)
    iters = SMALL["xor_nuts_d3"]["traffic"]["iterations"]
    assert 1 + iters < whole["evaluations"] <= 1 + 7 * iters
    assert whole["checks"] <= 7 * iters and iters <= whole["merges"] <= 3 * iters
