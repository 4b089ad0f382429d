"""The port imports neither JAX nor anything of the JAX package, and its
GPU smoke script refuses to run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "repro_loaded": loaded,
                  "jax_loaded": [m for m in sys.modules if m.startswith("jax") and sys.modules[m]]}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.launch.ebft_run" in got["modules"]
    assert "repro_torch.kernels.masked_matmul.ops" in got["modules"]
    assert got["repro_loaded"] == []
    assert got["jax_loaded"] == []


def test_port_sources_name_no_jax_import():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.",
                                     "from repro.", "from repro import")), (path, s)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card here: the script exits non-zero and prints no result line.
    Alone in an empty directory, without the package, it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
