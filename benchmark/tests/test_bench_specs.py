"""Everything the harness finds by name is there, and a new cell or metric
is a file of its own."""

import json
import os
import shutil
import subprocess
import sys

import torch

from benchmark import run
from benchmark.tests.cpu import full_spec

ROOT = run.ROOT
SPEC = full_spec()


def test_every_config_traffic_and_metric_loads_by_name():
    for cell in SPEC["workloads"]:
        config = run.config_of(SPEC, cell)
        assert config["name"] == cell["config"]
        traffic = run.traffic_of(cell)
        assert os.path.exists(os.path.join(run.BENCH_DIR, "drivers", f"{traffic['driver']}.py"))
        names = {m["name"] for m in run.metrics_of(SPEC, cell, False)}
        assert "setup_s" in names and len(names) >= 2
        layer = run.metrics_of(SPEC, cell, True)
        assert layer, cell["name"]
        for m in layer:
            assert m["moves"] in names, (cell["name"], m["name"])
    for m in SPEC["per_layer"]:
        reader = run.load_module(os.path.join(run.BENCH_DIR, "layer_metrics", f"{m['name']}.py"),
                                 f"benchmark.layer_metrics.{m['name']}")
        assert callable(reader.read)
    for c in SPEC["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_readers_give_nothing_where_nothing_was_recorded():
    from benchmark.spans import Recorder

    for m in SPEC["per_layer"]:
        reader = run.load_module(os.path.join(run.BENCH_DIR, "layer_metrics", f"{m['name']}.py"),
                                 f"benchmark.layer_metrics.{m['name']}")
        assert reader.read(Recorder(True)) is None, m["name"]


def test_a_new_cell_and_metric_are_files_of_their_own(tmp_path):
    """In a copy: a new mix file, a new reader file and their entries in
    BENCHMARK.json are all a new cell needs; no file of the harness
    changes."""
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = dict(SPEC)
    traffic = run.traffic_of(SPEC["workloads"][0])
    (tmp_path / "benchmark" / "traffic" / "code_b4.json").write_text(
        json.dumps(dict(traffic, batch=4)))
    (tmp_path / "benchmark" / "layer_metrics" / "passes.batch4.py").write_text(
        "def read(rec):\n    return rec.values.get('passes')\n")
    spec["workloads"] = SPEC["workloads"] + [dict(SPEC["workloads"][0], name="x-code-b4",
                                                  traffic="code_b4")]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["x-code-b4"])
                          if "workloads" in m else m for m in SPEC["end_to_end"]]
    spec["per_layer"] = SPEC["per_layer"] + [
        {"name": "passes.batch4", "unit": "passes", "better": "higher",
         "source": "program_counter", "layer": "Codec API", "moves": "codec_mps",
         "workloads": ["x-code-b4"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for c in SPEC["configs"]:
        dst = tmp_path / c["file"]
        assert dst.exists()
    code = ("import json, sys\n"
            "from benchmark import run\n"
            "from benchmark.spans import Recorder\n"
            "spec = run.spec_of()\n"
            "cell = run.cell_of(spec, 'x-code-b4')\n"
            "assert run.traffic_of(cell)['batch'] == 4\n"
            "names = [m['name'] for m in run.metrics_of(spec, cell, True)]\n"
            "assert 'passes.batch4' in names, names\n"
            "rec = Recorder(True); rec.values['passes'] = 3\n"
            "import os\n"
            "r = run.load_module(os.path.join(run.BENCH_DIR, 'layer_metrics', 'passes.batch4.py'),"
            " 'x')\n"
            "assert r.read(rec) == 3\n"
            "assert run.ROOT == sys.argv[1], run.ROOT\n")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, check=True,
                   env=dict(os.environ, PYTHONPATH=str(tmp_path)))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lic_tpu_torch_fake", object())
    assert "lic_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lic_tpu.fake", object())
    assert run.forbidden_modules() == ["lic_tpu.fake"]


def _imports(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, check=True, capture_output=True, text=True,
                         env=dict(os.environ, USE_FLAX="0"))
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    code = ("import os\n"
            "from benchmark import run, system, train_check, images, trace, roofline\n"
            "from benchmark.drivers import code_batch, train, serve_open\n"
            "from benchmark.tools import controls, knee\n"
            "import lic_tpu_torch.models, lic_tpu_torch.training, lic_tpu_torch.serving\n"
            "import lic_tpu_torch.data.datasets\n"
            "for m in run.spec_of()['per_layer']:\n"
            "    run.load_module(os.path.join(run.BENCH_DIR, 'layer_metrics', m['name'] + '.py'),"
            " m['name'])\n")
    tops = _imports(code)
    assert "lic_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN), tops & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _imports("import benchmark.reference, benchmark.weights, benchmark.compare")
    assert "lic_tpu_torch" not in tops
    assert not tops & set(run.FORBIDDEN)


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", SPEC["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_run_without_the_program_fails_and_prints_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
