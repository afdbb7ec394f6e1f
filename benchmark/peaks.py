"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
dense rates, at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,     # float32 outside the tensor cores
        "hbm_bytes": 3.35e12,   # bytes/s
        "l2_bytes": 50 * 2 ** 20,
    },
}


def of(kind: str) -> dict | None:
    """The peaks of a card, or None for a card not in the table (a share
    of its peak is then not reported)."""
    return PEAKS.get(kind)
