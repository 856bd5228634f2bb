"""The system under test, built from a cell's files through the port's
public entry points: the model, the sampler, the job and its counters.

The benchmark makes the data and the starting states itself and hands the
same tensors to the program and to the reference.
"""

import functools
import importlib
import pkgutil

import numpy as np
import torch

from harness.spec import resolve


def load_csv(path, onehot_classes=None):
    """A dataset column file (a header row, comma-separated floats)."""
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2, encoding="utf-8-sig")
    if onehot_classes:
        data = np.eye(onehot_classes)[data[:, 0].astype(np.int64)]
    return data


def dataset(config, device):
    """(x, y) of the configuration's dataset as float32 tensors on ``device``."""
    ds = config["dataset"]
    x = load_csv(resolve(ds["x"]))
    y = load_csv(resolve(ds["y"]), ds.get("classes"))
    if x.shape[0] != ds["rows"] or y.shape[0] != ds["rows"]:
        raise ValueError(f"{ds['name']}: expected {ds['rows']} rows")
    return (torch.as_tensor(x, dtype=torch.float32, device=device),
            torch.as_tensor(y, dtype=torch.float32, device=device))


def _named(table, config, key, value):
    if value not in table:
        raise ValueError(f"{config['name']}: unknown {key} {value!r}")
    return table[value]


def build_model(config, device):
    """The port's float32 MLP as the configuration states it:
    ``hidden_activation``, ``output_activation`` (``sigmoid``, or null for
    linear; by default linear under the multiclass cross-entropy and sigmoid
    otherwise), ``loss`` with its ``loss_args`` and the iid Normal ``prior``."""
    from eeyore_tpu_torch.models import MLP, IIDNormalPrior, loss_functions, mlp

    if config["model"] != "mlp":
        raise ValueError(f"{config['name']}: unknown model {config['model']!r}")
    if config["dtype"] != "float32":
        raise ValueError(f"{config['name']}: dtype {config['dtype']!r}: the harness runs float32")
    dims = config["dims"]
    hidden = _named({"sigmoid": mlp.sigmoid, "relu": torch.relu, "tanh": torch.tanh},
                    config, "hidden_activation", config["hidden_activation"])
    default_out = None if config["loss"] == "multiclass_classification" else "sigmoid"
    out = _named({"sigmoid": mlp.sigmoid, None: None}, config, "output_activation",
                 config.get("output_activation", default_out))
    loss = _named(loss_functions, config, "loss", config["loss"])
    if config.get("loss_args"):
        loss = functools.partial(loss, **config["loss_args"])
    hp = mlp.Hyperparameters(dims=dims, bias=config["bias"],
                             activations=[hidden] * (len(dims) - 2) + [out])
    P = config["num_params"]
    prior = IIDNormalPrior(torch.full((P,), float(config["prior"]["loc"])),
                           torch.full((P,), float(config["prior"]["scale"])),
                           dtype=torch.float32, device=device)
    model = MLP(loss=loss, hparams=hp, prior=prior, dtype=torch.float32, device=device)
    if model.num_params != P:
        raise ValueError(f"{config['name']}: the port's MLP has {model.num_params} parameters")
    return model


def build_sampler(traffic, model):
    from eeyore_tpu_torch import samplers, tuners

    kwargs = dict(traffic["args"])
    if traffic["tuner"] is not None:
        kwargs["tuner"] = tuners.HMCDATuner(**traffic["tuner"])
    return getattr(samplers, traffic["sampler"])(model, **kwargs)


@functools.cache
def _counting_modules():
    import eeyore_tpu_torch.ops as ops

    modules = [importlib.import_module(f"{ops.__name__}.{info.name}")
               for info in pkgutil.iter_modules(ops.__path__)]
    return [m for m in modules if hasattr(m, "launch_counts")]


def launch_counts():
    """{kernel: launches so far} over every module of the port's ``ops``
    that counts its launches."""
    counts = {}
    for module in _counting_modules():
        counts.update(module.launch_counts)
    return counts


def kernel_last_info(kernel):
    """What the kernel's module kept of its last call (``last_info``)."""
    module = importlib.import_module(f"eeyore_tpu_torch.ops.{kernel}")
    return module.last_info[kernel]


def job(kernel_obj, theta0s, data, traffic, platform):
    """``call(generator)``: one sampling job through ``sample_chains`` as a
    user runs it, returning the ``ChainLists``."""
    from eeyore_tpu_torch.samplers import sample_chains

    def call(generator):
        return sample_chains(kernel_obj, generator, theta0s, data, traffic["iterations"],
                             traffic["burnin"], backend="auto", platform=platform)

    return call
