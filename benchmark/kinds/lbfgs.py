"""Full-batch L-BFGS (``lbfgs_ffnn_torch.solvers.lbfgs``): a mix whose
``solve`` holds :class:`LBFGSOptions`' fields, on the whole training set."""

from __future__ import annotations

from benchmark import counts
from benchmark.drive import Kind, Program, last_state, probe_point, wrapped
from benchmark.reference import lbfgs as ref_lbfgs


def build(model, config, traffic, data, device):
    from lbfgs_ffnn_torch.solvers.lbfgs import LBFGSOptions
    return Program(model.problem(config, traffic.get("lam", 0.0)),
                   LBFGSOptions(**traffic["solve"]), tuple(data), model.rows(data),
                   model.work(config), traffic, device)


def first_steps(p: Program, w0, seed, k):
    from lbfgs_ffnn_torch.solvers.lbfgs import lbfgs_warm_up
    return lbfgs_warm_up(p.problem, w0, p.data, p.opts, iters=k)


def solve(p: Program, w0, seed):
    from lbfgs_ffnn_torch.solvers.lbfgs import lbfgs
    return lbfgs(p.problem, w0, p.data, p.opts)


def ring_after(p: Program, w0, seed):
    """The history and the gradient of a whole solve from ``w0``: its
    chunked entry's state after the last chunk of 7 iterations whose ring
    does not start at row 0 (a full ring after m pushes a multiple of m
    apart would)."""
    from lbfgs_ffnn_torch.solvers.lbfgs import lbfgs_chunked
    s = last_state(lambda cb: lbfgs_chunked(p.problem, w0, p.data, p.opts, chunk=7,
                                            callback=cb), wrapped)
    return s.hist, s.g


def full_vag(p: Program):
    w = probe_point(p)
    return (lambda: p.problem.value_and_grad(w, p.data)), p.rows


def reference(obj, w0, data, traffic, seed, k):
    return ref_lbfgs.steps(obj, w0, data, traffic["solve"], k)


def flops(p: Program, res):
    return counts.lbfgs_flops(p.work, p.rows, p.traffic["solve"]["m"],
                              res.n_iters, res.n_fevals, res.n_gevals)


KIND = Kind(unit="iter", length="max_iters", build=build, first_steps=first_steps, solve=solve,
            flops=flops, batch_vag=full_vag, reference=reference, ring_after=ring_after)
