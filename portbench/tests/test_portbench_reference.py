"""The plain reference against the port on the CPU (``--device cpu``), at
tiny sizes: the port's outputs are judged equal to it on every route the
cells take."""

import json
import shutil

import pytest

from portbench import harness


def _run(root, cell, seed=2**31 + 5, seconds=0.3):
    return harness.run_cell(root, cell, seed, seconds, False, device="cpu",
                            require_card=False, log=lambda s: None)


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_sketch_matches_reference(tiny_root, tmp_path, backend):
    root = tmp_path / "b"
    shutil.copytree(tiny_root, root)
    conf = root / "portbench" / "configs" / "reads_tiny.json"
    c = json.loads(conf.read_text())
    c["backend"] = backend
    conf.write_text(json.dumps(c))
    r = _run(root, "reads_tiny.isolate_small")
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1
