"""The neural-syntax configuration is files of its own: in a copy of the
repository, its cell runs at a small size with no file of the harness
changed, correct and with its wavefront readers read, and
``tools/controls.py`` reads its ``compared`` numbers with the program and
with the control as the side."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import run
from benchmark.tests.cpu import full_spec

ROOT = run.ROOT
SPEC = full_spec()
CELL = "neural_syntax-code-b8"

RUN = """
import json, sys
import pytest, torch
from benchmark import run, system
from benchmark.tests.cpu import patched_cuda, run_small
from benchmark.tools import controls

torch.set_num_threads(4)
assert run.ROOT == sys.argv[1]
tiny = json.loads(sys.argv[2])
cpu = torch.device("cpu")
with pytest.MonkeyPatch.context() as mp:
    mp.setattr(system, "JUDGE_PRECISION", "float32")
    with patched_cuda(mp):
        out = run_small("neural_syntax-code-tiny", 7, tiny, trace=1)
        mp.setattr(controls.torch, "device", lambda *a: cpu)
        rows = controls.code_batch("neural_syntax-code-tiny", [7], tiny)
print(json.dumps({"out": {k: out[k] for k in ("correct", "metrics", "checks", "readings")},
                  "row": rows[0]}))
"""


def test_the_neural_syntax_cell_is_files_of_its_own(tmp_path):
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny = {"driver": "code_batch", "batch": 2, "size": [128, 192], "pool": 2, "checked": 1,
            "traced": 1}
    (tmp_path / "benchmark" / "traffic" / "code_tiny.json").write_text(json.dumps(tiny))
    cell = "neural_syntax-code-tiny"
    spec = dict(SPEC)
    base = run.cell_of(SPEC, CELL)
    spec["workloads"] = SPEC["workloads"] + [dict(base, name=cell, traffic="code_tiny")]
    for kind in ("end_to_end", "per_layer"):
        spec[kind] = [dict(m, workloads=m["workloads"] + [cell])
                      if CELL in m.get("workloads", []) else m for m in SPEC[kind]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), json.dumps(tiny)],
                         cwd=tmp_path, check=True, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT])))
    got = json.loads(out.stdout.splitlines()[-1])
    res, row = got["out"], got["row"]
    assert res["correct"], res["checks"]
    limits = run.config_of(SPEC, base)["limits"]
    assert list(res["checks"]) == list(limits)
    want = {m["name"] for m in run.metrics_of(spec, run.cell_of(spec, cell), True)}
    assert {"wavefront_decode_ms.batch", "wavefront_step_us.batch", "wavefront_drain_us.batch",
            "wavefront_mfu.batch", "codec_mfu.batch", "gs_roofline.batch"} <= want
    assert set(res["metrics"]) == {m for m in want if not m.startswith("device_idle")}
    assert "context_row_share" in res["readings"]
    for side in ("program", "control"):
        assert set(limits) <= set(row[side]), (side, row[side])
        assert all(row[side][k] >= 0 for k in limits)
