"""The port's bench (``python -m lbfgs_ffnn_torch.experiments.bench``) on the
CPU with ``BENCH_QUICK=1`` at a further-reduced size through its ``sizes``
hook: one line on stdout, the root bench's contract JSON with a finite
value; the variant rows with their gates, the headline config, and the
supplementary rows (the S-LBFGS row among them) on stderr, no "not ported"
line. The headline choice is the root bench's rule, checked on fabricated
rows."""

import _torch_threads  # noqa: F401  (caps torch's threads per test worker)

import json
import math

import pytest

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
    assert "not ported" not in err
    for tag in bench.HEADLINE_ROWS[1:]:
        assert f"L-BFGS m=10 [{tag}] N=48: ms/iter per seed 124: " in err
        assert f"{tag} parity gate (exact f32 final loss" in err
    for tag in ("bf16 ring", "u8 traffic stack", "u8 + warm alpha"):
        assert f"deep 784-256-128-64-10 m=100 [{tag}]" in err
        assert f"deep [{tag}] parity gate" in err
    heads = [ln for ln in err.splitlines() if ln.startswith("headline config: ")]
    assert len(heads) == 1 and heads[0].split()[2].rstrip(";") in bench.HEADLINE_ROWS
    assert "bf16 ring parity gate" in err and "deep 784-256-128-64-10 m=100 [f32]" in err
    assert "two-loop m=100 n=640" in err
    assert "seeded labels" in err
    assert "S-LBFGS N=48 b=256 ms/epoch per seed 124: " in err
    assert "(reference CPU: 214.7 ms/epoch)" in err and "seed 126: 2 epochs" in err
    assert "S-LBFGS N=5000 b=256 ms/epoch: not ported" not in err


def _rows(ms, loss, acc):
    return [(124 + i, ms, 10, 20, loss, acc) for i in range(3)]


@pytest.mark.parametrize("case,expect", [
    # the fastest row that passes wins
    ({"bf16-traffic": (1.1, 1.0, 90.0), "u8-traffic": (0.9, 1.01, 90.0),
      "u8-warm": (0.8, 1.019, 89.8), "u8-warm-nr": (0.7, 1.03, 90.0)}, "u8-warm"),
    # a faster row that fails on accuracy loses to f32
    ({"bf16-traffic": (0.5, 1.0, 89.6), "u8-traffic": (1.5, 0.9, 91.0)}, "f32"),
    # a tie keeps f32
    ({"bf16-traffic": (1.2, 1.0, 90.0)}, "f32"),
    # within 2% of the loss plus 1e-6
    ({"u8-warm-nr": (1.0, 1.02 + 1e-6, 90.0)}, "u8-warm-nr"),
])
def test_headline_choice_is_the_root_benchs_rule(case, expect):
    rows = {"f32": _rows(1.2, 1.0, 90.0)}
    rows.update({tag: _rows(*v) for tag, v in case.items()})
    chosen, ms = bench.choose_headline(rows)
    assert chosen == expect
    assert ms == rows[expect][0][1]


def test_gate_reads_medians_over_seeds():
    """One bad seed of three does not fail the gate; two do."""
    f32 = _rows(1.0, 1.0, 90.0)
    one_bad = _rows(1.0, 1.0, 90.0)
    one_bad[0] = (124, 1.0, 10, 20, 5.0, 10.0)
    assert bench.gate(one_bad, f32)[0]
    two_bad = list(one_bad)
    two_bad[1] = (125, 1.0, 10, 20, 5.0, 10.0)
    assert not bench.gate(two_bad, f32)[0]


def test_variant_rows_are_the_root_benchs():
    """The headline rows' problems and options, as the root bench builds them."""
    spec = bench.mlp_spec(bench.DIMS, bench.ACTS)
    opts = bench.LBFGSOptions(max_iters=5, tol=1e-12, m=10, line_search="armijo",
                              ls_max_iters=20)
    rows = bench.variants(spec, opts)
    assert tuple(rows) == bench.HEADLINE_ROWS
    assert rows["f32"][1] == opts and rows["f32"][0].prepare is None
    bf16 = opts._replace(pair_dtype="bfloat16", prefix_dtype="bfloat16")
    assert rows["bf16-traffic"][1] == bf16 and rows["u8-traffic"][1] == bf16
    assert rows["u8-warm"][1] == bf16._replace(ls_alpha_init="warm", ls_alpha_growth=8.0)
    assert rows["u8-warm-nr"][1] == rows["u8-warm"][1]._replace(prefix_refresh=0)
    assert rows["u8-traffic"][0] is rows["u8-warm"][0] is rows["u8-warm-nr"][0]
    deep = bench.deep_variants(spec, opts._replace(m=100))
    assert tuple(deep) == ("f32", "bf16 ring", "u8 traffic stack", "u8 + warm alpha")
    assert deep["u8 + warm alpha"][1].ls_alpha_init == "warm"
