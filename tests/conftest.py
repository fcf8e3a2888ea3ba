import os
import signal
import sys

import pytest

# Tests run on the single real CPU device (the 512-device fleet is ONLY for
# the dry-run process). Keep compilation light.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# The property tests use hypothesis when available; this container doesn't
# ship it, so fall back to the minimal random-sampling stub in _stubs/
# (real hypothesis, when installed, wins — it is found first).
try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.append(os.path.join(os.path.dirname(__file__), "_stubs"))

# Per-test watchdog: a stall bug (engine drain loop, gateway retry spin)
# must fail its own test with a diagnostic, not hang the whole suite.
# Override per test with @pytest.mark.timeout(seconds); 0 disables.
DEFAULT_TEST_TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT_S", "300"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test watchdog limit "
        f"(default {DEFAULT_TEST_TIMEOUT_S}s via REPRO_TEST_TIMEOUT_S)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skipped at run time without "
        "one (run them on the card with `pytest -m gpu`)")


@pytest.fixture(autouse=True)
def _test_watchdog(request):
    marker = request.node.get_closest_marker("timeout")
    limit = int(marker.args[0]) if marker and marker.args \
        else DEFAULT_TEST_TIMEOUT_S
    if limit <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _expired(signum, frame):
        raise TimeoutError(
            f"{request.node.nodeid} exceeded the {limit}s per-test "
            "watchdog (likely a drain/retry stall)")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
