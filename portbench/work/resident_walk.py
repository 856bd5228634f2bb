"""Work of one call of the walk kernel under MALA: 1 + iterations
evaluations a chain (value and gradient), and per iteration the proposal
(4P), the reverse drift and its distance (5P), |z|^2 (2P) and the accept
(6)."""

from work import mlp_eval


def work(config, traffic, x, counts):
    evaluations_per_chain = counts["evaluations"]
    P = mlp_eval.num_params(config["dims"])
    C, iters = traffic["chains"], traffic["iterations"]
    kept = iters - traffic["burnin"]
    per_chain = evaluations_per_chain * mlp_eval.eval_ops(config, x) + iters * (11 * P + 6)
    return {"flops": C * per_chain,
            "bytes": mlp_eval.io_bytes(config, C, kept, 1, x.shape[0])}
