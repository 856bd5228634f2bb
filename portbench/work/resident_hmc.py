"""Work of one call of an HMC whole-loop kernel (``resident_hmc``): every
value-and-gradient evaluation the run needs (the first of each chain, then
one a leapfrog step) and per leapfrog step the position and momentum updates
(4P); per iteration the first half step (2P), the two kinetic energies (4P)
and the accept (7). The evaluations are the run's: ``counts["evaluations"]``
a chain, from the check (the fixed count untuned; tuned, the frozen steps
fitted to the call's outputs and the reference's replay of the burn-in)."""

from work import mlp_eval


def work(config, traffic, x, counts):
    evaluations_per_chain = counts["evaluations"]
    dims = config["dims"]
    P = mlp_eval.num_params(dims)
    C, iters = traffic["chains"], traffic["iterations"]
    kept = iters - traffic["burnin"]
    per_chain = (evaluations_per_chain * mlp_eval.eval_ops(config, x)
                 + (evaluations_per_chain - 1) * 4 * P + iters * (6 * P + 7))
    return {"flops": C * per_chain,
            "bytes": mlp_eval.io_bytes(config, C, kept, 1, x.shape[0])}
