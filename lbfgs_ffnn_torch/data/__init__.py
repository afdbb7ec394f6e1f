from lbfgs_ffnn_torch.data.idx import (
    read_idx_images,
    read_idx_labels_onehot,
    read_idx_labels_u8,
    write_idx_u8,
)
from lbfgs_ffnn_torch.data.datasets import (
    Dataset,
    load_fashion_mnist,
    load_mnist,
    synthetic_images_for_labels,
)

__all__ = [
    "read_idx_images",
    "read_idx_labels_onehot",
    "read_idx_labels_u8",
    "write_idx_u8",
    "Dataset",
    "load_fashion_mnist",
    "load_mnist",
    "synthetic_images_for_labels",
]
