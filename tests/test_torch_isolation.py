"""The PyTorch port stands alone: it never imports JAX or the reference
package (``repro``), not even the reference's plain-Python modules.

A subprocess (this test process itself has both packages loaded) imports
every ``repro_torch`` module and runs a smoke-config forward on the CPU,
then checks ``sys.modules``.  The sources of the port and
``chip_smoke.py`` must not spell such an import either.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch import configs
from repro_torch.models import api
cfg = configs.get_config("internlm2_1_8b", smoke=True,
                         engine_spec="ozimmu_h-4:df32:fused")
model = api.get_model(cfg)
params = model.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
logits = model.forward(params, cfg, {"tokens": torch.zeros((1, 4),
                                                            dtype=torch.long)})
assert logits.shape == (1, 4, cfg.padded_vocab), logits.shape
assert bool(torch.isfinite(logits).all())
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("MODULES", len(names))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("MODULES", "BAD")))
    assert int(lines["MODULES"]) >= 20, out.stdout
    assert lines["BAD"] == "[]", out.stdout


FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                       r"import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
                       re.MULTILINE)


def test_port_sources_spell_no_forbidden_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
