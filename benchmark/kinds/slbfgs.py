"""S-LBFGS (``lbfgs_ffnn_torch.solvers.slbfgs``): a mix whose ``solve``
holds :class:`SLBFGSOptions`' fields; each solve's sampler seed is drawn
from the run's seed."""

from __future__ import annotations

import torch

from benchmark import counts
from benchmark.drive import Kind, Program, batch_vag, last_state, wrapped
from benchmark.reference import sampling as ref_sampling
from benchmark.reference import stochastic as ref_stochastic


def build(model, config, traffic, data, device):
    from lbfgs_ffnn_torch.solvers.slbfgs import SLBFGSOptions
    return Program(model.batch_problem(config, traffic.get("lam", 0.0)),
                   SLBFGSOptions(**traffic["solve"]), tuple(data), model.rows(data),
                   model.work(config), traffic, device)


def first_steps(p: Program, w0, seed, k):
    from lbfgs_ffnn_torch.solvers.slbfgs import slbfgs_warm_up
    return slbfgs_warm_up(p.problem, w0, *p.data, p.opts._replace(seed=seed), epochs=k)


def solve(p: Program, w0, seed):
    from lbfgs_ffnn_torch.solvers.slbfgs import slbfgs
    return slbfgs(p.problem, w0, *p.data, p.opts._replace(seed=seed))


def ring_after(p: Program, w0, seed):
    """The history and the anchor of a whole solve: its chunked entry's
    state after the last chunk of 10 epochs whose ring does not start at
    row 0."""
    from lbfgs_ffnn_torch.solvers.slbfgs import slbfgs_chunked
    s = last_state(lambda cb: slbfgs_chunked(p.problem, w0, *p.data,
                                             p.opts._replace(seed=seed), chunk=10,
                                             callback=cb), wrapped)
    return s.hist, s.w


def sampler_gap(p: Program, seed, k):
    """The program's draws for epochs ``0..k-1`` (every step's batch, the
    HVP batch of every pair, the anchor pick) against the reference's
    frozen draw, at the cell's rows and batch sizes: how many differ."""
    from lbfgs_ffnn_torch.ops.sampling import EpochSampler, device_seed
    n, dev, o = p.rows, p.device, p.opts
    b, b_h, L = o.batch_size, o.hvp_batch_size, o.L
    m_inner = n // b
    nb = (m_inner - 1) // L
    draws = EpochSampler(device_seed(seed, dev), n, b, b_h, o.sampler)
    wrong = 0
    for e in range(k):
        epoch = torch.tensor(e, dtype=torch.int32, device=dev)
        got = draws.batches(epoch, 0, m_inner)
        for t in range(m_inner):
            wrong += not torch.equal(got[t], ref_sampling.step_batch(seed, e, t, n, b, dev))
        for t in range(L, nb * L + 1, L):
            wrong += not torch.equal(draws.hvp_batch(epoch, t),
                                     ref_sampling.hvp_batch(seed, e, t, n, b_h, dev))
        count = min(m_inner + 1, L + 1)
        pick = draws.anchor(epoch, torch.tensor(count, device=dev))
        wrong += int(pick) != ref_sampling.anchor_pick(seed, e, count)
    return wrong


def reference(obj, w0, data, traffic, seed, k):
    return ref_stochastic.slbfgs_epochs(obj, w0, data[0], data[1], traffic["solve"], seed, k)


def flops(p: Program, res):
    o = p.opts
    return counts.slbfgs_solve_flops(p.work, p.rows, o.batch_size,
                                     o.hvp_batch_size, o.L, o.history, res.n_iters)


KIND = Kind(unit="epoch", length="epochs", build=build, first_steps=first_steps, solve=solve,
            flops=flops, batch_vag=batch_vag, reference=reference,
            # after one epoch the state's gnorm is the first anchor's ||mu||
            first_grad=lambda result: float(result.final_gnorm),
            ring_after=ring_after, clamp_gamma=True, sampler_gap=sampler_gap)
