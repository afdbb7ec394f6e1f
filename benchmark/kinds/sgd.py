"""SGD (``lbfgs_ffnn_torch.solvers.sgd``): a mix whose ``solve`` holds
:class:`SGDOptions`' fields; the reference runs sequential batches without
momentum."""

from __future__ import annotations

from benchmark import counts
from benchmark.drive import Kind, Program, batch_vag
from benchmark.reference import stochastic as ref_stochastic


def build(model, config, traffic, data, device):
    from lbfgs_ffnn_torch.solvers.sgd import SGDOptions
    return Program(model.batch_problem(config, traffic.get("lam", 0.0)),
                   SGDOptions(**traffic["solve"]), tuple(data), model.rows(data),
                   model.work(config), traffic, device)


def first_steps(p: Program, w0, seed, k):
    from lbfgs_ffnn_torch.solvers.sgd import sgd_warm_up
    return sgd_warm_up(p.problem, w0, *p.data, p.opts._replace(seed=seed), epochs=k)


def solve(p: Program, w0, seed):
    from lbfgs_ffnn_torch.solvers.sgd import sgd
    return sgd(p.problem, w0, *p.data, p.opts._replace(seed=seed))


def reference(obj, w0, data, traffic, seed, k):
    return ref_stochastic.sgd_epochs(obj, w0, data[0], data[1], traffic["solve"], seed, k)


def flops(p: Program, res):
    return res.n_iters * counts.sgd_epoch_flops(p.work, p.rows,
                                                p.opts.batch_size)


KIND = Kind(unit="epoch", length="epochs", build=build, first_steps=first_steps, solve=solve,
            flops=flops, batch_vag=batch_vag, reference=reference)
