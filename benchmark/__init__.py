"""The benchmark of the PyTorch and CUDA port (``lbfgs_ffnn_torch``): one
cell a run, ``python3 -m benchmark.run``; see ``benchmark/run.py``."""
