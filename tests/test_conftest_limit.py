"""The per-test time limit of the repo's root ``conftest.py``: a test whose
setup or call runs past ``TEST_TIME_LIMIT_S`` fails under its own name, is
cut short there, and the tests around it run as before.  Checked in a
pytest subprocess whose conftest loads the root conftest and lowers the
limit to 2 s."""

import os
import subprocess
import sys
import textwrap
import time

ROOT_CONFTEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "conftest.py")


def test_a_test_past_the_limit_fails_with_its_own_name(tmp_path):
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location("repo_conftest", {ROOT_CONFTEST!r})
        repo_conftest = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(repo_conftest)
        repo_conftest.TEST_TIME_LIMIT_S = 2
        pytest_runtest_setup = repo_conftest.pytest_runtest_setup
        pytest_runtest_call = repo_conftest.pytest_runtest_call
    """))
    (tmp_path / "test_limit.py").write_text(textwrap.dedent("""
        import time

        import pytest


        @pytest.fixture
        def slow_fixture():
            time.sleep(30)


        def test_sleeps_past_the_limit():
            time.sleep(30)


        def test_sound_after_it():
            time.sleep(0.1)


        def test_fixture_past_the_limit(slow_fixture):
            pass
    """))
    # no third-party plugins: the check stays a few seconds long
    env = {**os.environ, "PYTEST_DISABLE_PLUGIN_AUTOLOAD": "1"}
    start = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    took = time.monotonic() - start
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert ("test_limit.py::test_sleeps_past_the_limit ran past the 2 s limit in its call"
            in out), out
    assert ("test_limit.py::test_fixture_past_the_limit ran past the 2 s limit in its setup"
            in out), out
    assert "1 failed, 1 passed, 1 error" in out, out
    assert took < 30, (took, out)  # both sleeps were cut at the limit


def test_loadfile_hands_out_the_heaviest_files_first(tmp_path):
    """Under ``--dist loadfile`` the files of ``HEAVIEST_FIRST`` run first,
    in its order, and the rest after them in xdist's own order (most tests
    first)."""
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location("repo_conftest", {ROOT_CONFTEST!r})
        repo_conftest = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(repo_conftest)
        repo_conftest.HEAVIEST_FIRST = ("test_c.py", "test_b.py")
        pytest_xdist_make_scheduler = repo_conftest.pytest_xdist_make_scheduler
    """))
    for name, n in (("a", 3), ("b", 1), ("c", 1), ("d", 2)):
        (tmp_path / f"test_{name}.py").write_text(
            "".join(f"def test_{i}():\n    pass\n\n\n" for i in range(n)))
    env = {**os.environ, "PYTEST_DISABLE_PLUGIN_AUTOLOAD": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-p", "xdist",
         "-n", "1", "--dist", "loadfile", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    out = run.stdout + run.stderr
    assert run.returncode == 0, out
    order = [line.split("PASSED ")[1].split("::")[0] for line in out.splitlines()
             if "PASSED " in line]
    assert order == ["test_c.py", "test_b.py"] + ["test_a.py"] * 3 + ["test_d.py"] * 2, out
