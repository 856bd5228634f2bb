"""Transition-kernel protocol: samplers as functions of an explicit state.

Counterpart of ``eeyore_tpu/samplers/base.py``. Where the JAX package vmaps a
one-chain kernel over chains, the port writes the chain dimension out: a
state is a ``NamedTuple`` of ``[C, ...]`` tensors, and ``step`` moves every
chain at once. Randomness comes from a ``torch.Generator`` on the state's
device.

Minibatch semantics follow the reference: when the schedule has more than
one batch, the current state's target (and gradient) is recomputed on the
incoming batch before proposing (``recompute_current``); full-batch mode
caches it.
"""


class TransitionKernel:
    """Base transition kernel bound to a model.

    Subclasses define:
    - ``state_keys``: info keys recorded per iteration,
    - ``init(thetas [C, P], x, y, generator=None) -> state``,
    - ``step(state, x, y, iteration, generator=None) -> (state, info)``.
    """

    state_keys = ("sample", "target_val", "accepted")

    def __init__(self, model, recompute_current=False):
        self.model = model
        self.recompute_current = recompute_current

    def init(self, thetas, x, y, generator=None):
        raise NotImplementedError

    def step(self, state, x, y, iteration, generator=None):
        raise NotImplementedError

    def log_target(self, thetas, x, y):
        return self.model.log_target(thetas, x, y)

    def upto_grad_log_target(self, thetas, x, y):
        return self.model.upto_grad_log_target(thetas, x, y)
