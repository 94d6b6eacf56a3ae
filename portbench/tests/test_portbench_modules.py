"""No run loads JAX or the JAX package: top-level module names compared
whole (``finch_tpu_torch`` begins with ``finch_tpu`` and is allowed)."""

import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_compared_whole():
    f = harness.forbidden_modules
    assert f(["finch_tpu_torch", "finch_tpu_torch.cli", "jaxtyping",
              "numpy"]) == []
    assert f(["finch_tpu.ops.murmur3", "jax.numpy", "jaxlib", "flax.linen",
              "finch_tpu_torch"]) == ["finch_tpu", "flax", "jax", "jaxlib"]


SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[3])
from pathlib import Path
from portbench import harness
import tiny
root = tiny.make_root(Path(sys.argv[2]))
bench = harness.Bench(root)
for kind in ("entries", "gen", "e2e", "layer_metrics", "controls"):
    for p in sorted((root / "portbench" / kind).glob("*.py")):
        if p.name != "__init__.py":
            harness.load_module(p, kind)
import portbench.controls.run, portbench.trace, portbench.peaks
for cell in tiny.CELLS:
    harness.run_cell(root, cell, 9, 0.2, cell.endswith("small"),
                     device="cpu", require_card=False, log=lambda s: None)
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_a_run_loads_no_jax(tmp_path):
    p = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT), str(tmp_path / "b"),
         str(ROOT / "portbench" / "tests")],
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    top = json.loads(p.stdout.strip().splitlines()[-1])
    assert "finch_tpu_torch" in top
    assert not set(top) & set(harness.FORBIDDEN)
