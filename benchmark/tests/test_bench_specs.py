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


FIXTURE_MODULE = '''"""A configuration's own reference class: a σ rule of its own and a
compared number of its own."""

from ..weights import SIGMA_BIAS
from .model import ReferenceCodec


class FixtureCodec(ReferenceCodec):
    def leaf_rule(self, name, value):
        if name == "lrp_transforms.0.c2.bias":  # half of a leaf, as a σ half
            value = value.clone()
            value[value.shape[0] // 2:] += SIGMA_BIAS
        return value

    def compared(self, side, x, decoded):
        """The latent's largest gap from the reference's, over its largest
        value: the program's coder's model, or the control itself."""
        got = getattr(side, "model", side).analyze(x).double()
        want = self.analyze(x.to(self.dtype)).double()
        return {"latent_gap": float((got - want).abs().max() / want.abs().max())}
'''

FIXTURE_RUN = """
import json, os, sys
import pytest, torch
from benchmark import run, system, weights
from benchmark.tests.cpu import patched_cuda

torch.set_num_threads(4)
spec = run.spec_of()
cell = run.cell_of(spec, "fixture-code-tiny")
config = run.config_of(spec, cell)
assert run.ROOT == sys.argv[1] and config["reference"] == "fixture_model:FixtureCodec"
base = run.config_of(spec, run.cell_of(spec, "source_net-code-b8"))
a, b = system.make_weights(base, 7, "cpu"), system.make_weights(config, 7, "cpu")
leaf = "lrp_transforms.0.c2.bias"
half = len(a[leaf]) // 2
assert all(torch.equal(a[k], b[k]) for k in a if k != leaf)
assert torch.equal(b[leaf][:half], a[leaf][:half])
assert torch.equal(b[leaf][half:], a[leaf][half:] + weights.SIGMA_BIAS)
args = lambda trace: run.parse(["--workload", cell["name"], "--seed", "7", "--seconds", "0.5",
                                "--trace", str(trace)])
with pytest.MonkeyPatch.context() as mp:
    mp.setattr(system, "JUDGE_PRECISION", "float32")
    with patched_cuda(mp):
        sound = run.execute(args(1), torch.device("cpu"))
        path = os.path.join(run.ROOT, "benchmark", "configs", "fixture.json")
        limits = dict(config["limits"], latent_gap=sound["checks"]["latent_gap"]["value"] - 1e-6)
        with open(path, "w") as f:
            json.dump(dict(config, limits=limits), f)
        tight = run.execute(args(0), torch.device("cpu"))
print(json.dumps({"sound": {k: sound[k] for k in ("correct", "metrics", "checks")},
                  "tight": {k: tight[k] for k in ("correct", "checks")}}))
"""


def test_a_new_configuration_is_files_of_its_own(tmp_path):
    """In a copy: a configuration file naming a reference class in a new
    module (a subclass with a σ rule and a compared number of its own), a
    mix file and their entries in BENCHMARK.json are all a new
    configuration needs; no file of the harness changes.  Its cell runs on
    the CPU: correct with the added number held to its limit and the counts
    read, and not correct with that limit under its reading."""
    shutil.copytree(run.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    (bench / "reference" / "fixture_model.py").write_text(FIXTURE_MODULE)
    with open(os.path.join(ROOT, "benchmark", "configs", "source_net.json")) as f:
        config = json.load(f)
    config.update(name="fixture", reference="fixture_model:FixtureCodec",
                  limits=dict(config["limits"], latent_gap=1e-3))
    (bench / "configs" / "fixture.json").write_text(json.dumps(config))
    (bench / "traffic" / "code_tiny.json").write_text(json.dumps(
        {"driver": "code_batch", "batch": 2, "size": [128, 192], "pool": 2, "checked": 1,
         "traced": 1}))
    cell = "fixture-code-tiny"
    spec = dict(SPEC)
    spec["configs"] = SPEC["configs"] + [dict(SPEC["configs"][0], name="fixture",
                                              file="benchmark/configs/fixture.json")]
    spec["workloads"] = SPEC["workloads"] + [dict(SPEC["workloads"][0], name=cell,
                                                  config="fixture", traffic="code_tiny")]
    for kind in ("end_to_end", "per_layer"):
        spec[kind] = [dict(m, workloads=m["workloads"] + [cell])
                      if "source_net-code-b8" in m.get("workloads", []) else m
                      for m in SPEC[kind]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", FIXTURE_RUN, str(tmp_path)], cwd=tmp_path,
                         check=True, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT])))
    got = json.loads(out.stdout.splitlines()[-1])
    sound, tight = got["sound"], got["tight"]
    assert sound["correct"], sound["checks"]
    assert list(sound["checks"]) == ["decode_p5_err", "decode_p50_err", "latent_gap"]
    assert 0 <= sound["checks"]["latent_gap"]["value"] <= 1e-3
    want = {m["name"] for m in run.metrics_of(spec, run.cell_of(spec, cell), True)}
    assert {"codec_mfu.batch", "ga_roofline.batch", "gs_roofline.batch"} <= want
    assert set(sound["metrics"]) == {m for m in want if not m.startswith("device_idle")}
    assert not tight["correct"]
    gap, p50 = tight["checks"]["latent_gap"], tight["checks"]["decode_p50_err"]
    assert gap["value"] > gap["limit"] and p50["value"] <= p50["limit"]


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
