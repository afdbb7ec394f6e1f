"""The port's bench (``python -m lbfgs_ffnn_torch.experiments.bench``) on the
CPU with ``BENCH_QUICK=1`` at a further-reduced size through its ``sizes``
hook: one line on stdout, the root bench's contract JSON with a finite
value; the supplementary rows (the S-LBFGS row among them) and one "not
ported" line per unported row on stderr."""

import json
import math

from lbfgs_ffnn_torch.experiments import bench


def test_bench_prints_the_contract_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_QUICK", "1")
    out = bench.main(["--device", "cpu"], sizes=bench.Sizes(48, 3, 640, (1, 2), sl_epochs=2))
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line == out
    assert line["metric"] == "MNIST 784-128-10 full-batch L-BFGS m=10 step time"
    assert line["unit"] == "ms/iter" and math.isfinite(line["value"]) and line["value"] > 0
    assert abs(line["vs_baseline"] - 7.20 / line["value"]) <= 5e-4  # printed to 3 places
    err = captured.err
    for row, item in bench.UNPORTED.items():
        assert f"{row}: not ported (ROADMAP queue 1 item {item})" in err
    assert "bf16 ring parity gate" in err and "deep 784-256-128-64-10 m=100 [f32]" in err
    assert "two-loop m=100 n=640" in err
    assert "seeded labels" in err
    assert "S-LBFGS N=48 b=256 ms/epoch per seed 124: " in err
    assert "(reference CPU: 214.7 ms/epoch)" in err and "seed 126: 2 epochs" in err
    assert "S-LBFGS N=5000 b=256 ms/epoch: not ported" not in err
