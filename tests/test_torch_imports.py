"""The port and chip_smoke.py import neither jax nor the reference package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {repo!r}]
import importlib
for name in {mods!r}:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert all(sys.modules[m] is None for m in bad), bad
print("imported", len({mods!r}))
"""


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_port_imports_no_jax_and_no_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.tsmm" in mods and len(mods) > 25
    code = PROBE.format(src=str(REPO / "src"), repo=str(REPO), mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"imported {len(mods)}" in out.stdout
