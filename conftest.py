"""Pytest hooks for every test directory of the repo.

* A time limit per test phase: a test whose setup or call runs past
  ``TEST_TIME_LIMIT_S`` fails under its own name, with every thread's
  stack in the log, and the run goes on.
* Under ``--dist loadfile`` the files that hold a worker longest go out
  first (``HEAVIEST_FIRST``), so that none of them starts near the end of
  a run and sets its wall.  xdist's own order hands out the files with the
  most tests first, and the long files here have few tests.
"""

import faulthandler
import signal
import sys
import threading

import pytest

TEST_TIME_LIMIT_S = 600

# Files of tests/ whose summed setup + call + teardown came to 100 s or
# more in a tier-1 run (six xdist workers on an 8-core CPU host), longest
# first.  A file missing here only starts later.
HEAVIEST_FIRST = tuple(f"tests/{name}.py" for name in (
    "test_training", "test_compress", "test_parallel", "test_coverage", "test_models",
    "test_torch_port_latent_unet", "test_torch_port_unet", "test_components",
    "test_torch_port_flagship", "test_gain_units", "test_config_fuzz",
    "test_torch_port_repairs", "test_eval", "test_torch_port_cli", "test_torch_port_vr",
    "test_serving", "test_layers", "test_cli_codec", "test_torch_port_entroformer",
    "test_torch_port_han",
))


def _past_limit(nodeid, phase):
    def fire(signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        pytest.fail(f"{nodeid} ran past the {TEST_TIME_LIMIT_S} s limit in its {phase}")
    return fire


def _limited(item, phase):
    if threading.current_thread() is not threading.main_thread():
        return (yield)
    previous = signal.signal(signal.SIGALRM, _past_limit(item.nodeid, phase))
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT_S)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item, "call"))


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getoption("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class HeaviestFirst(LoadFileScheduling):
        def _assign_work_unit(self, node):
            heavy = next((f for f in HEAVIEST_FIRST if f in self.workqueue), None)
            if heavy is not None:
                self.workqueue.move_to_end(heavy, last=False)
            super()._assign_work_unit(node)

    return HeaviestFirst(config, log)
