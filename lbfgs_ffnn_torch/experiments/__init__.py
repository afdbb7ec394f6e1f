"""Experiment runners of the port (``python -m lbfgs_ffnn_torch.experiments.<name>``)."""
