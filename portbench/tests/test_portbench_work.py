"""The work counts behind the roofline shares and mfu, against counts made
by hand."""

import numpy as np
import pytest

from work import mlp_eval

XOR = {"dims": [2, 2, 1], "loss": "binary_classification"}
IRIS = {"dims": [4, 3, 3], "loss": "multiclass_classification"}


def test_mlp221_one_row_with_zero_input_folding():
    # row (0, 1): the first layer's products with the 0 are no work, with the 1 an add:
    # forward 2 units x (0 + 1); layer 2: 2 multiply-adds (4); 2 sigmoids (6); the BCE
    # head 12; the row's sum 1; weight gradients layer 1 2 x (0 + 1), layer 2 4; bias
    # gradients 3; hidden deltas 2 x (2 + 3) = 10; prior 4 * 9 + 3 = 39
    assert mlp_eval.eval_ops(XOR, np.array([[0.0, 1.0]])) == 2 + 4 + 6 + 12 + 1 + 2 + 4 + 3 + 10 + 39
    # row (0, 0): no first-layer work at all
    assert mlp_eval.eval_ops(XOR, np.array([[0.0, 0.0]])) == 0 + 4 + 6 + 12 + 1 + 0 + 4 + 3 + 10 + 39
    # row (2, 3): every product a multiply-add
    assert mlp_eval.eval_ops(XOR, np.array([[2.0, 3.0]])) == 8 + 4 + 6 + 12 + 1 + 8 + 4 + 3 + 10 + 39


def test_mlp433_two_rows():
    x = np.array([[5.1, 3.5, 1.4, 0.2], [6.0, 1.0, 4.0, 1.3]])
    # first layer per row and unit: 4 inputs at 2 each, but the second row's 1.0 is an add
    first = 3 * (8 + 7)
    per_row = (2 * 3 * 3) + 3 * 3 + 1 + (4 * 3 + 1) + (2 * 3 + 1) + 2 * 3 * 3 + 6 + (2 * 3 * 3 + 3 * 3)
    assert mlp_eval.eval_ops(IRIS, x) == 2 * first + 2 * per_row + 4 * 27 + 3


def test_param_counts_and_bytes():
    assert mlp_eval.num_params([4, 3, 3]) == 27 and mlp_eval.num_params([2, 2, 1]) == 9
    # theta0 in, data in, samples, final and one float a chain out
    assert mlp_eval.io_bytes(XOR, 8, 3, 1, 4) == 4 * (8 * 9 + 4 * 3 + 3 * 8 * 9 + 8 * 9 + 8)


def test_nuts_full_budget_count_by_hand():
    from work import resident_nuts_dense

    traffic = {"chains": 2, "iterations": 3, "burnin": 1, "args": {"max_depth": 3}}
    x = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])
    iters, P = 3, 9
    # every leaf live: 7 leaves, 7 U-turn tests and 3 merges an iteration
    counts = {"evaluations": 1 + 7 * iters, "checks": 7 * iters, "merges": 3 * iters}
    per_iter = 7 * mlp_eval.eval_ops(XOR, x) + (2 * P + 1) + 7 * (8 * P + 13) + 7 * 5 * P + 3 * 10
    flops = resident_nuts_dense.work(XOR, traffic, x, counts)["flops"]
    assert flops == 2 * (mlp_eval.eval_ops(XOR, x) + iters * per_iter)


@pytest.mark.parametrize("step,live", [(1e-4, (7, 7, 3)), (1e3, (1, 0, 1))])
def test_nuts_reference_counts_live_leaves_only(step, live):
    # a tiny step never turns: the whole budget is live; a huge one diverges
    # at its first leaf, which ends the transition there
    import torch

    from reference import nuts
    from reference.mlp import MLPPosterior

    config = {**XOR, "hidden_activation": "sigmoid", "num_params": 9,
              "prior": {"kind": "iid_normal", "loc": 0.0, "scale": 1.0}}
    x = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]], dtype=torch.float64)
    y = torch.tensor([[0.0], [1.0], [1.0], [0.0]], dtype=torch.float64)
    post = MLPPosterior(config, x, y, torch.float64, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    theta = 0.1 * torch.randn((4, 9), generator=gen, dtype=torch.float64)
    draws = (torch.randn((4, 9), generator=gen, dtype=torch.float64),
             torch.rand((3, 4), generator=gen),
             [torch.rand((1 << d, 4), generator=gen, dtype=torch.float64) for d in range(3)],
             torch.rand((3, 4), generator=gen, dtype=torch.float64))
    val, grad = post.vg(theta)
    counts = {}
    nuts.transition(post.vg, theta, val, grad, draws, torch.full((4,), step, dtype=torch.float64),
                    3, counts=counts)
    for key, want in zip(("leaves", "checks", "merges"), live):
        assert counts[key].tolist() == [want] * 4, (key, counts[key])
