"""Entry `finch_sketch_wide`: `finch_sketch` at wide k (32 <= k <= 63).

One operation is `finch sketch <fastq> -o <out>` through the port's CLI,
as in ``entries/finch_sketch.py``, whose set-up, operation and release it
reuses. Judged after the window against the wide plain reference
(``portbench/reference/sketch_wide.py``). Its snapshot adds the port's
``engine.step_wide`` meter (one call a wide step, the batch's k-mers as
items), which ``wide_roofline.wide`` prices; a program without that span
leaves it at 0.
"""

from __future__ import annotations

import json

from finch_tpu_torch.utils import get_meter
from portbench.entries import finch_sketch
from portbench.reference import sketch_wide as reference

STEP = "engine.step_wide"


class Cell(finch_sketch.Cell):
    def __init__(self, config, traffic, data, *, device, workdir, spans,
                 trace):
        # LaneProbe counts the k <= 31 kernels' lanes, which no wide step
        # calls: the wide steps are counted by the port's own meter
        super().__init__(config, traffic, data, device=device,
                         workdir=workdir, spans=spans, trace=False)

    def snapshot(self) -> dict:
        snap = super().snapshot()
        m = get_meter(STEP)
        snap["step_wide.calls"] = m.calls
        snap["step_wide.lanes"] = m.items
        return snap

    def judge(self):
        c = self.config
        ref = reference.reference_sketch(
            self.fastq, k=c["kmer_length"], n_hashes=c["n_hashes"],
            kmers_to_sketch=c["n_hashes"] * c["oversketch"],
            seed=c["hash_seed"], strand_filter=c["strand_filter"],
            err_filter=float(c["err_filter_percent"]), device=self.device)
        worst = {"header_fields_differing": 0, "entries_differing": 0}
        bad = 0
        for out in self.outputs:  # the operations that returned
            try:
                doc = json.loads(out.read_bytes())
            except (OSError, ValueError):
                doc = {}  # no readable .sk: every field and entry differs
            nums = reference.compare(doc, ref)
            bad += any(nums.values())
            for key, v in nums.items():
                worst[key] = max(worst[key], v)
        return [(key, v, 0) for key, v in worst.items()], bad
