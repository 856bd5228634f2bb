"""Work of one call of the fixed-budget NUTS kernel, over the live leaves
only (a leaf after a U-turn or a divergence changes nothing, so the inputs
do not need it): a chain's evaluations (the first, then one a live leaf),
per iteration logp0 (2P + 1), per live leaf the leapfrog (6P), its kinetic
energy (2P) and the weight, statistic, logaddexp and multinomial test (13),
per U-turn test on a live leaf 5P, and per merged subtree 10. The counts
are the run's (``counts`` from the check's replay)."""

from work import mlp_eval


def work(config, traffic, x, counts):
    P = mlp_eval.num_params(config["dims"])
    C, iters = traffic["chains"], traffic["iterations"]
    kept = iters - traffic["burnin"]
    evaluations = counts["evaluations"]
    per_chain = (evaluations * mlp_eval.eval_ops(config, x) + iters * (2 * P + 1)
                 + (evaluations - 1) * (8 * P + 13) + counts["checks"] * 5 * P
                 + counts["merges"] * 10)
    return {"flops": C * per_chain,
            "bytes": mlp_eval.io_bytes(config, C, kept, 3, x.shape[0])}
