import os
import subprocess
import sys

import pytest

# Tests see the real device count (1 CPU). Only the dry-run forces 512.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TESTS = os.path.dirname(os.path.abspath(__file__))
if TESTS not in sys.path:
    sys.path.insert(0, TESTS)

# Offline containers lack hypothesis; shim it so collection never dies.
import _hypothesis_compat  # noqa: E402

_hypothesis_compat.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: soak tests (traffic etc.) — opt-in via --runslow")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (skips without them)")
    if config.getoption("--lock-check"):
        # Instrument every repro.* Lock/RLock allocated from here on and
        # hook the engine's device-dispatch point, so the whole suite
        # doubles as the lock-order corpus (repro.analysis.locks).
        from repro.analysis import locks
        from repro.runtime import engine
        monitor = locks.install()
        engine._DISPATCH_NOTE = monitor.note_dispatch
        config._lock_monitor = monitor


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (traffic soak tests)")
    parser.addoption("--lock-check", action="store_true", default=False,
                     help="run under the repro.analysis lock-order "
                          "detector; fail the session on any cycle or "
                          "lock held across device dispatch")


@pytest.fixture(scope="session", autouse=True)
def _lock_check_verdict(request):
    """With --lock-check: assert an acyclic lock-order graph at session
    end (teardown failure -> nonzero pytest exit, report printed)."""
    yield
    monitor = getattr(request.config, "_lock_monitor", None)
    if monitor is None:
        return
    from repro.analysis import locks
    from repro.runtime import engine
    locks.uninstall()
    engine._DISPATCH_NOTE = None
    report = monitor.report()
    sys.stderr.write(f"\n[lock-check] {report}\n")
    assert not monitor.cycles(), f"lock-order cycles detected:\n{report}"
    assert not monitor.dispatch_violations, \
        f"locks held across device dispatch:\n{report}"


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow soak test: needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


def run_subprocess(code: str, n_devices: int = 8, timeout: int = 600):
    """Run python code in a fresh process with N fake CPU devices.

    Multi-device sharding/collective tests need a device count set before
    jax initialises, so they run out of process.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, env=env)
    if res.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}")
    return res.stdout


@pytest.fixture
def subproc():
    return run_subprocess
