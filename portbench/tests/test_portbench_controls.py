"""`correct` fails where it must: the cell's control (the reference with
a stated guarantee broken) and each fault planted in the port's timed
path underneath a run (a step that leaves its state unchanged, half of
each batch left out, an answer altered where it is made). The exchange
between cards has no fault here: every cell runs on one card."""

import pytest

from portbench import harness


def test_control_is_not_correct(tiny_root, tmp_path):
    bench = harness.Bench(tiny_root)
    c = bench.cell("reads_tiny.isolate_small")
    data = bench.load("gen", c.traffic["generator"]).generate(
        c.config, c.traffic, 17, tmp_path)
    control = bench.load("controls", c.config["entry"])
    nums = control.numbers(c.config, c.traffic, data, "cpu")
    assert max(nums.values()) > 0, nums


def _run(root, cell):
    return harness.run_cell(root, cell, 2**31 + 3, 0.2, False, device="cpu",
                            require_card=False, log=lambda s: None)


def _sketch_faults(monkeypatch, fault):
    from finch_tpu_torch.models.engine import TorchEngine

    step = TorchEngine.step_planes
    if fault == "state_unchanged":
        monkeypatch.setattr(TorchEngine, "step_planes",
                            lambda self, lo, hi, n: None)
    elif fault == "half_batch":
        monkeypatch.setattr(TorchEngine, "step_planes",
                            lambda self, lo, hi, n: step(self, lo, hi,
                                                         n // 2))
    else:
        from finch_tpu_torch.core import sketching

        made = sketching.kmercounts_from_arrays

        def altered(*args):
            out = made(*args)
            out[0].count += 1
            return out
        monkeypatch.setattr(sketching, "kmercounts_from_arrays", altered)


FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_sketch_fault_is_not_correct(tiny_root, monkeypatch, fault):
    _sketch_faults(monkeypatch, fault)
    r = _run(tiny_root, "reads_tiny.isolate_small")
    assert r["correct"] is False and r["failed"] >= 1
