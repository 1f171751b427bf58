"""On the card: the control (the reference in TF32 in the program's place)
fails each cell's comparison and the program passes it, at the cell's own
sizes, on three seeds, for every cell of ``BENCHMARK.json``.
``python -m pytest benchmark/tests -m cuda`` on a GPU host."""

import pytest

from benchmark import compare, run
from benchmark.tools import controls

SPEC = run.spec_of()
SEEDS = (9001, 9002, 9003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_the_control_fails_and_the_program_passes(card, cell):
    c = run.cell_of(SPEC, cell)
    kind = run.traffic_of(c)["driver"]
    limits = run.config_of(SPEC, c)["limits"]
    rows = {"code_batch": controls.code_batch, "train": controls.train,
            "serve_open": controls.serve}[kind](cell, SEEDS)
    for r in rows:
        if kind == "train":
            names = [k for k in ("loss_rel", "grad_gap", "change_gap", "grad_median_gap",
                                 "change_median_gap") if k in limits]
            assert all(r["program"][k] <= limits[k] for k in names), r
            assert any(r["control"][k] > limits[k] for k in names), r
            assert any(r["half_batch"][k] > limits[k] for k in names), r
        else:
            names = compare.names(limits)
            assert all(r["program"][k] <= limits[k] for k in names), r
            assert any(r["control"][k] > limits[k] for k in names), r
