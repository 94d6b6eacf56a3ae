"""finch_tpu_torch imports neither jax nor anything of finch_tpu, and
importing its modules starts no process (the process mesh's workers start
at first use)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import multiprocessing, pkgutil, importlib, sys
import finch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(finch_tpu_torch.__path__,
                                               "finch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "finch_tpu"
             or m.startswith("finch_tpu."))
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
assert not multiprocessing.active_children(), multiprocessing.active_children()
"""


def test_port_imports_no_jax_and_no_finch_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout.decode() + proc.stderr.decode()
