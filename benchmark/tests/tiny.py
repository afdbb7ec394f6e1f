"""The cells at a size the CPU runs in seconds: the same files, fewer rows,
narrower layers and shorter solves; each history ring fills and wraps."""

import copy

from benchmark import catalog


def shrink(cell):
    cfg = dict(cell.config, n_train=600)
    cfg["dims"] = [784, 32, 10] if len(cfg["dims"]) == 3 else [784, 32, 16, 8, 10]
    tr = copy.deepcopy(cell.traffic)
    solve = tr["solve"]
    if "max_iters" in solve:
        solve["max_iters"] = solve["m"] + 12
    else:
        solve["epochs"] = 4
        solve["batch_size"] = 64
    if tr["solver"] == "slbfgs":
        solve.update(hvp_batch_size=32, L=3, history=3)
    return cell._replace(config=cfg, traffic=tr)


def tiny_cell(name, root=None):
    return shrink(catalog.load_cell(name, root))
