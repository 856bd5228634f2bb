"""Port, whole-loop blocked Gibbs: the generated CUDA texts and the plain
versions of ``resident_walk.make_resident_gibbs`` (staged data) and
``resident_walk_dense.make_resident_gibbs_dense`` (data as constants), what
CPU tensors run and what the CUDA kernels are held against on the card by
``chip_smoke.py``. The dense incremental body that ``gibbs_dense_source``
emits, read back by a numpy interpreter, equals the plain
``make_incremental_gibbs_dense`` (the same operations in the same order:
1e-6 relative) and writes exactly the cache entries the plain update
changes; ``gibbs_blocks_source`` compiles in the sweep of ``Gibbs``; runs
equal an explicit loop of the port's ``Gibbs.step_fn`` on the Gibbs stream
(``kernel_prng.gibbs_draws``), with exact extras and per-sub-block counts
(float32: 1e-5 relative, 2e-4 absolute on iris values of about 1e2, as the
walk tests); thinning; a dense and a staged run of XOR on one seed agree;
and the wrappers refuse CPU tensors."""

import re

import numpy as np
import pytest
import torch

from eeyore_tpu_torch.datasets import XYDataset
from eeyore_tpu_torch.models import MLP, loss_functions, mlp
from eeyore_tpu_torch.ops import kernel_prng, mlp_dense, resident_walk, resident_walk_dense
from eeyore_tpu_torch.ops.resident_walk import make_resident_gibbs
from eeyore_tpu_torch.ops.resident_walk_dense import make_resident_gibbs_dense
from eeyore_tpu_torch.samplers import Gibbs

XOR_X = np.array([[0., 0.], [0., 1.], [1., 0.], [1., 1.]])
XOR_Y = np.array([[0.], [1.], [1.], [0.]])


def problem(name):
    if name.startswith("xor"):
        dims = [2, 2, 1] if name == "xor" else [2, 3, 2, 1]
        model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32,
                    device="cpu", hparams=mlp.Hyperparameters(dims=dims))
        return model, XOR_X, XOR_Y
    ds = XYDataset.from_eeyore("iris", yonehot=True)
    if name == "iris30":
        ds.x, ds.y = ds.x[::5], ds.y[::5]
    model = MLP(loss=loss_functions["multiclass_classification"], dtype=torch.float32,
                device="cpu", hparams=mlp.Hyperparameters(
                    dims=[4, 3, 2, 3], activations=[mlp.sigmoid, mlp.sigmoid, None]))
    return model, ds.x, ds.y


def theta0s(C, P, seed=0, scale=0.3):
    return torch.as_tensor(scale * np.random.default_rng(seed).normal(size=(C, P)),
                           dtype=torch.float32)


# ---- the generated texts ----

def _translate(expr):
    m = re.fullmatch(r"(\S+) >= 0\.0f \? (\S+) : (\S+)", expr)
    if m:
        return f"np.where({m.group(1)} >= 0, {m.group(2)}, {m.group(3)})"
    expr = re.sub(r"(0x[0-9a-f.]+p[+-]\d+)f", r"f32(float.fromhex('\1'))", expr)
    expr = re.sub(r"\b(\d+\.\d+)f\b", r"f32(\1)", expr)
    for c_name, np_name in (("expf", "np.exp"), ("log1pf", "np.log1p"), ("logf", "np.log"),
                            ("fabsf", "np.abs"), ("fmaxf", "np.maximum")):
        expr = re.sub(rf"\b{c_name}\(", f"{np_name}(", expr)
    return expr


def _interpret(source, head, th, c):
    """Run the emitted C++ function whose definition starts with ``head``
    on float32 arrays: ``th`` (P [C] arrays) and the cache ``c`` (a list,
    written in place by init); returns (value or None, {entry: value} of
    the writes to n, {entry: entry} of the copies commit makes)."""
    body = source.split(head)[1].split("\n}")[0].splitlines()[1:]
    f32 = np.float32
    env = {"th": th, "c": c, "np": np, "f32": f32}
    written, copied = {}, {}
    with np.errstate(over="ignore"):
        for line in body:
            line = line.strip().rstrip(";")
            if line.startswith("const float "):
                name, expr = line[len("const float "):].split(" = ", 1)
                env[name] = np.asarray(eval(_translate(expr), env), dtype=f32)
            elif line.startswith(("c[", "n[")):
                target, expr = line.split(" = ", 1)
                i = int(target[2:-1])
                if expr.startswith("n["):
                    copied[i] = int(expr[2:-1])
                    continue
                value = np.asarray(eval(_translate(expr), env), dtype=f32)
                if target.startswith("c["):
                    c[i] = value
                else:
                    written[i] = value
            else:
                assert line.startswith("return "), line
                return (np.asarray(eval(_translate(line[len("return "):]), env)), written,
                        copied)
    return None, written, copied


@pytest.mark.parametrize("name", ["xor", "xor2321", "iris30"])
def test_gibbs_dense_source_is_the_same_program(name):
    model, x, y = problem(name)
    C, P = 64, model.num_params
    th = np.random.default_rng(1).normal(size=(P, C)).astype(np.float32)
    source = mlp_dense.gibbs_dense_source(model, x, y)
    keys, init, updates = mlp_dense.make_incremental_gibbs_dense(model, x, y)
    assert f"constexpr int kCache = {len(keys)};" in source
    val, cache = init(tuple(torch.as_tensor(t) for t in th))
    c = [None] * len(keys)
    got, _, _ = _interpret(source, "float init(", list(th), c)
    np.testing.assert_allclose(got, val.numpy(), rtol=1e-6, atol=1e-5)
    for want, have in zip(cache, c):
        np.testing.assert_allclose(have, want.numpy(), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(2)
    for u, unit in enumerate(updates):
        prop = th + rng.normal(size=th.shape).astype(np.float32)
        val_p, cache_p = updates[unit](tuple(torch.as_tensor(t) for t in prop), cache)
        got, written, _ = _interpret(source, f"float update<{u}>(", list(prop), list(c))
        np.testing.assert_allclose(got, val_p.numpy(), rtol=1e-6, atol=1e-5)
        changed = {i for i, (old, new) in enumerate(zip(cache, cache_p)) if new is not old}
        assert set(written) == changed, unit
        for i in changed:
            np.testing.assert_allclose(written[i], cache_p[i].numpy(), rtol=1e-6, atol=1e-6)
        _, _, copied = _interpret(source, f"void commit<{u}>(", None, None)
        assert copied == {i: i for i in changed}
    assert mlp_dense.gibbs_dense_work(model, x, y).keys() == updates.keys()


@pytest.mark.parametrize("dims,subblocks", [([2, 2, 1], None), ([2, 2, 1], [1, 1, 2]),
                                            ([2, 3, 2, 1], [1] * 6), ([4, 3, 2, 3], None)])
def test_gibbs_blocks_source_compiles_in_the_sweep(dims, subblocks):
    model = MLP(loss=loss_functions["binary_classification"], dtype=torch.float32, device="cpu",
                hparams=mlp.Hyperparameters(dims=dims))
    source = resident_walk.gibbs_blocks_source(model, subblocks)
    sweep = Gibbs(model, node_subblock_size=subblocks).sub_blocks

    def table(fn):
        text = source.split(f"static constexpr int {fn}(")[1].split("  }\n")[0]
        return {int(k): int(v) for k, v in re.findall(r"case (\d+): return (-?\d+);", text)}

    assert f"static constexpr int kB = {len(sweep)};" in source
    widths, units, index = table("width"), table("unit"), table("index")
    stride = int(re.search(r"const int i = b \* (\d+) \+ k;", source).group(1))
    assert widths == {b: len(idx) for b, (idx, _, _) in enumerate(sweep)}
    assert units == {b: block for b, (_, _, block) in enumerate(sweep)}
    assert index == {b * stride + k: p for b, (idx, _, _) in enumerate(sweep)
                     for k, p in enumerate(idx)}


# ---- the plain versions ----

def explicit_loop(model, x, y, scales, subblocks, th, seed, iters, burnin):
    """The port's ``Gibbs.step_fn`` stepped on the Gibbs stream's draws:
    [(sample, target_val, moved)] per iteration, and the post-burn-in
    per-sub-block accept counts [C, B]."""
    tx, ty = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    sampler = Gibbs(model, scales=scales, node_subblock_size=subblocks)
    state = sampler.init(th, tx, ty)
    chains = torch.arange(th.shape[0])
    rows, acc = [], torch.zeros(th.shape[0], sampler.num_sub_blocks)
    for t in range(iters):
        draws = [kernel_prng.gibbs_draws(seed, chains, t, b, len(idx))
                 for b, (idx, _, _) in enumerate(sampler.sub_blocks)]
        noise = [z.T for z, _ in draws]
        u = torch.stack([u for _, u in draws], dim=1)
        new, _ = sampler.step_fn(state, tx, ty, noise=noise, uniforms=u)
        if t >= burnin:
            acc += new.accepted
        rows.append((new.sample, new.target_val, torch.any(new.sample != state.sample, dim=1)))
        state = new
    return rows, acc


GIBBS_CASES = [("iris", None, 0.1, make_resident_gibbs, 64, 64, 2e-4),
               ("xor", None, 0.5, make_resident_gibbs, 256, 128, 1e-5),
               ("xor", None, 0.5, make_resident_gibbs_dense, 1024, 1024, 1e-5),
               ("xor2321", [1] * 6, 0.5, make_resident_gibbs_dense, 1024, 1024, 1e-5)]


@pytest.mark.parametrize("name,subblocks,scales,maker,C,chain_block,atol", GIBBS_CASES)
def test_run_equals_explicit_loop(name, subblocks, scales, maker, C, chain_block, atol):
    model, x, y = problem(name)
    iters, burnin, seed = 12, 4, 3
    th = theta0s(C, model.num_params)
    fn = maker(model, x, y, scales, subblocks, num_iters=iters, num_burnin_iters=burnin,
               chain_block=chain_block, record_extras=True, device="cpu")
    samples, final, acc, vals, flags = fn(seed, th)
    rows, n_acc = explicit_loop(model, x, y, scales, subblocks, th, seed, iters, burnin)
    B = n_acc.shape[1]
    for t in range(burnin, iters):
        sample, val, moved = rows[t]
        torch.testing.assert_close(samples[t - burnin], sample, rtol=1e-5, atol=atol)
        torch.testing.assert_close(vals[t - burnin], val, rtol=1e-5, atol=atol)
        assert torch.equal(flags[t - burnin].bool(), moved)
    torch.testing.assert_close(final, rows[-1][0], rtol=1e-5, atol=atol)
    assert acc.shape == (C, B) and torch.equal(acc, n_acc)
    assert 0 < acc.sum() < C * B * (iters - burnin)
    (_, _, plain_acc, _, _), info = fn.plain(seed, th)
    assert torch.equal(plain_acc, acc)
    assert info["evaluations"] == C * (1 + iters * B)
    module = resident_walk_dense if maker is make_resident_gibbs_dense else resident_walk
    assert torch.equal(module.last_info[module.GIBBS_KERNEL]["accept_counts"], acc)


@pytest.mark.parametrize("maker,chain_block", [(make_resident_gibbs, 128),
                                               (make_resident_gibbs_dense, 1024)])
def test_record_thin_and_extras(maker, chain_block):
    model, x, y = problem("xor")
    C, seed = 1024, 9
    th = theta0s(C, model.num_params, seed=3)
    kw = dict(num_iters=14, num_burnin_iters=2, chain_block=chain_block, record_extras=True,
              device="cpu")
    full = maker(model, x, y, 0.5, **kw)(seed, th)
    thin = maker(model, x, y, 0.5, record_thin=3, **kw)(seed, th)
    assert thin[0].shape == (4, C, 9) and full[0].shape == (12, C, 9)
    for a, b in zip(thin, full):
        if a.dim() >= 2 and a.shape[0] == 4:
            assert torch.equal(a, b[::3])
    assert torch.equal(thin[1], full[1]) and torch.equal(thin[2], full[2])
    samples, _, acc, _, flags = full
    assert torch.equal(flags[1:].bool(), torch.any(samples[1:] != samples[:-1], dim=-1))
    # a sweep that moved accepted at least one sub-block, and at most all
    assert bool((flags.sum(0).float() <= acc.sum(1)).all())
    plain = maker(model, x, y, 0.5, **{**kw, "record_extras": False})(seed, th)
    assert len(plain) == 3 and torch.equal(plain[0], samples)


def test_dense_and_staged_runs_of_one_seed_agree():
    """Both draw from the Gibbs stream keyed by the global chain, and the two
    bodies differ only in float32 rounding."""
    model, x, y = problem("xor")
    th = theta0s(2048, model.num_params, seed=5)
    kw = dict(num_iters=30, num_burnin_iters=10, device="cpu")
    staged = make_resident_gibbs(model, x, y, 0.5, chain_block=256, **kw)(11, th)
    dense = make_resident_gibbs_dense(model, x, y, 0.5, chain_block=1024, **kw)(11, th)
    close = torch.isclose(staged[0], dense[0], rtol=1e-4, atol=1e-4).all(dim=2).all(dim=0)
    assert close.float().mean().item() >= 0.99
    assert (staged[2] == dense[2]).all(dim=1).float().mean().item() >= 0.99


def test_gibbs_stream_layout():
    """Sub-block b's words are the walk stream's shifted by b * 2**16: b = 0
    gives the walk draws of its width, and a later sub-block's first pair is
    Threefry at counter (t, b * 2**16)."""
    chains = torch.arange(300, dtype=torch.int64)
    z, u = kernel_prng.gibbs_draws(7, chains, 5, 0, 5)
    wz, wu = kernel_prng.walk_draws(7, chains, 5, 5)
    assert torch.equal(z, wz) and torch.equal(u, wu)
    z3, u3 = kernel_prng.gibbs_draws(7, chains, 5, 3, 4)
    y0, y1 = kernel_prng.threefry2x32(7, chains, 5, 3 * 2 ** 16)
    z0, z1 = kernel_prng.normal(y0, y1)
    assert torch.equal(z3[0], z0) and torch.equal(z3[1], z1)
    a0, _ = kernel_prng.threefry2x32(7, chains, 5, 3 * 2 ** 16 + 2)
    assert torch.equal(u3, kernel_prng.uniform(a0))
    assert z3.shape == (4, 300) and not torch.equal(z3, z[:4])


def test_makers_check_their_arguments_and_wrappers_refuse_cpu_tensors():
    model, x, y = problem("xor")
    with pytest.raises(ValueError, match="1024"):
        make_resident_gibbs_dense(model, x, y, 0.5, chain_block=512, device="cpu")
    fn = make_resident_gibbs(model, x, y, 0.5, num_iters=4, chain_block=128, device="cpu")
    with pytest.raises(ValueError, match="multiple of chain_block"):
        fn(0, torch.zeros(100, 9))
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_walk.resident_walk_gibbs(None, torch.zeros(9, 128), *[torch.zeros(1)] * 6,
                                          resident_walk.ResidentWalkParams(), 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_walk_dense.resident_walk_dense_gibbs(
            None, torch.zeros(9, 1024), torch.zeros(3), resident_walk.ResidentWalkParams(), 256)
    assert resident_walk.launch_counts[resident_walk.GIBBS_KERNEL] == 0
    assert resident_walk_dense.launch_counts[resident_walk_dense.GIBBS_KERNEL] == 0
