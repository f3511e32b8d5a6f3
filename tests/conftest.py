import os

# Tests run single-device (the dry-run sets its own 512-device flag in a
# separate process; see src/repro/launch/dryrun.py).  Keep plan-cache IO
# out of $HOME during tests.
os.environ.setdefault("REPRO_PLAN_CACHE", "/tmp/repro_test_plans.json")
os.environ.setdefault("REPRO_PROGRAM_CACHE", "/tmp/repro_test_programs")

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skipped "
        "without one")
