from lbfgs_ffnn_torch.utils.diagnostics import check_parallelism, sync_time
from lbfgs_ffnn_torch.utils.profiling import trace

__all__ = ["check_parallelism", "sync_time", "trace"]
