"""Entry `finch_sketch`: one operation is `finch sketch <fastq> -o <out>`
through the port's CLI (``finch_tpu_torch.cli.run``), in process, with
the configuration's flags; it ends when the .sk file is written.

Judged after the window: every operation's .sk against the plain
reference (``portbench/reference/sketch.py``), computed once from the
same FASTQ. With a trace it also records, for each call of the extract
and dedup steps, the lanes handed to it (``LaneProbe``), which the
kernel roofline reader prices.
"""

from __future__ import annotations

import gc
import json

import torch

from finch_tpu_torch import cli
from finch_tpu_torch.ops import dedup, extract
from finch_tpu_torch.utils import get_meter
from portbench.reference import sketch as reference

METERS = ("parse_kmers", "engine_kmers")


class LaneProbe:
    """Counts the lanes of each call into the card's sketch steps: the
    extract (either form), tier D and tier D2. It wraps the module
    attributes that ``ops/bottomk.py`` calls through, keeping the wrapped
    functions' launch counters on the wrappers."""

    SITES = ((extract, "extract_candidates"), (dedup, "dedup_candidates"),
             (dedup, "dedup_slab_candidates"))

    def __init__(self):
        self.lanes = {"extract": 0, "extract_weighted": 0, "dedup": 0,
                      "dedup_slab": 0}
        self.calls = dict.fromkeys(self.lanes, 0)

    def install(self) -> None:
        for mod, name in self.SITES:
            fn = getattr(mod, name)
            if getattr(fn, "_portbench_probe", False):
                continue
            setattr(mod, name, self._wrap(fn, name))

    def _wrap(self, fn, name):
        probe = self

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name == "extract_candidates":
                kind = ("extract_weighted" if kwargs.get("weighted")
                        else "extract")
                lanes = args[0].numel()
            elif name == "dedup_candidates":
                kind, lanes = "dedup", args[0].numel()
            else:  # the slab holds 8 rows of 2048 per 32 x 2048 lanes
                kind, lanes = "dedup_slab", args[0].numel() * 4
            probe.lanes[kind] += lanes
            probe.calls[kind] += 1
            return out

        wrapper.__dict__.update(fn.__dict__)
        wrapper._portbench_probe = True
        wrapper.__wrapped__ = fn
        return wrapper


class Cell:
    span = "sketch"

    def __init__(self, config, traffic, data, *, device, workdir, spans,
                 trace):
        self.config, self.data, self.device = config, data, device
        self.workdir, self.spans = workdir, spans
        self.fastq = str(data["fastq"])
        self.flags = ["-k", str(config["kmer_length"]),
                      "-n", str(config["n_hashes"]),
                      "--oversketch", str(config["oversketch"]),
                      "--seed", str(config["hash_seed"]),
                      "--err-filter", str(config["err_filter_percent"]),
                      "--strand-filter", str(config["strand_filter"]),
                      "--backend", config["backend"], "--device", device]
        self.outputs = []
        self.probe = LaneProbe() if trace else None
        if self.probe is not None:
            self.probe.install()  # a site that is gone raises here

    def _sketch(self, out) -> None:
        cli.run(["sketch", self.fastq, "-o", str(out), *self.flags])

    def setup(self) -> None:
        self._sketch(self.workdir / "warm.sk")

    def op(self, i: int) -> dict:
        out = self.workdir / f"op_{i:05d}.sk"
        self._sketch(out)
        self.outputs.append(out)
        return {"kmers": self.data["kmers"]}

    def snapshot(self) -> dict:
        snap = {}
        for name in METERS:
            m = get_meter(name)
            snap[f"{name}.seconds"] = m.seconds
            snap[f"{name}.items"] = m.items
        if self.probe is not None:
            for kind, v in self.probe.lanes.items():
                snap[f"lanes.{kind}"] = v
                snap[f"calls.{kind}"] = self.probe.calls[kind]
        return snap

    def release(self) -> None:
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

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
