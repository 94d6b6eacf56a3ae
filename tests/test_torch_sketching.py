"""The port end to end on the CPU: its CLI (`backend torch`, `--device
cpu`) writes bytes equal to the frozen goldens, and its entry points raise
when no card is present unless the caller asks for the CPU."""

import gzip
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import finch_tpu_torch as ft
from finch_tpu_torch.core.sketching import sketch_stream
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models import engine as eng
from finch_tpu_torch.serialization.json_sk import multisketch_to_json_bytes

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "data", "goldens")
QUERY_FA = os.path.join(HERE, "data", "query.fa")
READS_FQ = os.path.join(HERE, "data", "reads.fastq")
# repo-relative inputs: they become the sketch names inside the goldens
QUERY_REL = "tests/data/query.fa"
READS_REL = "tests/data/reads.fastq"


def finch(tmp_path, *args) -> bytes:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "finch_tpu_torch.cli", "sketch",
         "--backend", "torch", "--device", "cpu", *args],
        capture_output=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    return proc.stdout


def _golden(name: str) -> bytes:
    with open(os.path.join(GOLD, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("golden,args", [
    ("query_mash_n10.sk", ["--n-hashes", "10", "-O", QUERY_REL]),
    ("query_scaled_n10.sk", ["-s", "scaled", "--n-hashes", "10", "-O",
                             QUERY_REL]),
    ("reads_filtered.sk", ["--n-hashes", "100", "-O", READS_REL]),
])
def test_cli_json_goldens(tmp_path, golden, args):
    assert finch(tmp_path, *args) == _golden(golden)


@pytest.mark.parametrize("flag,ext", [("-b", "bsk"), ("-B", "msh")])
def test_cli_binary_goldens(tmp_path, flag, ext):
    out = tmp_path / "q"
    finch(tmp_path, "--n-hashes", "10", flag, QUERY_REL, "-o", str(out))
    assert (tmp_path / f"q.{ext}").read_bytes() == \
        _golden(f"query_mash_n10.{ext}")


def test_reads_take_the_two_chunk_kernel_path():
    """reads.fastq (96k k-mers) pads to 131072 lanes: the extract path."""
    params = ft.SketchParams.mash(kmers_to_sketch=100 * 200, final_size=100)
    filters = ft.FilterParams(filter_on=None, err_filter=0.21,
                              strand_filter=0.1)
    engines = []
    sketch_stream(READS_FQ, READS_REL, params, filters, backend="torch",
                  device="cpu", engine_out=engines, parser_threads=1)
    stats = engines[0].stats
    assert sum(stats.get(f"tier_{t}", 0)
               for t in ("A", "B", "C", "D", "D2")) == 1


def test_hybrid_engine_migrates_exactly():
    """HybridEngine seeds the device state from the host fold
    (state_from_numpy) and goes on bit-identically."""
    params = ft.SketchParams.mash(kmers_to_sketch=500, final_size=500)
    rng = np.random.default_rng(12)
    hyb = eng.HybridEngine(params, batch_size=1 << 17, switch_after=50_000,
                           device="cpu")
    ref = eng.NumpyEngine(params)
    for _ in range(4):
        packed = rng.integers(0, 4 ** 21, size=40_000, dtype=np.uint64)
        rc = rng.integers(0, 2, size=40_000, dtype=np.uint64)
        comp = (packed << np.uint64(1)) | rc
        hyb.update((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                   (comp >> np.uint64(32)).astype(np.uint32))
        ref.update(packed, rc.astype(np.uint8))
    assert hyb._dev is not None
    for a, b in zip(hyb.finalize_arrays(), ref.finalize_arrays()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("params", [
    ft.SketchParams.mash(kmers_to_sketch=300, final_size=300),
    # 5% of 2 x 131072 k-mers stay below max_hash: the 4096-entry state
    # must grow (grow_state) and redo the step
    ft.SketchParams.scaled(kmers_to_sketch=100, scale=0.05),
], ids=["mash", "scaled_grows"])
def test_torch_engine_equals_numpy(params):
    """TorchEngine on (packed, rc) batches, through the extract path."""
    rng = np.random.default_rng(13)
    dev = eng.TorchEngine(params, batch_size=1 << 17, device="cpu")
    ref = eng.NumpyEngine(params)
    for _ in range(2):
        packed = rng.integers(0, 4 ** 21, size=1 << 17, dtype=np.uint64)
        rc = rng.integers(0, 2, size=1 << 17).astype(np.uint8)
        dev.update(packed, rc)
        ref.update(packed, rc)
    assert sum(dev.stats.get(f"tier_{t}", 0)
               for t in ("A", "B", "C", "D", "D2")) >= 2
    if params.sketch_type == "scaled":
        assert dev.capacity > 4096
    for a, b in zip(dev.finalize_arrays(), ref.finalize_arrays()):
        assert np.array_equal(a, b)


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = ft.SketchParams.mash(kmers_to_sketch=10, final_size=10)
    filters = ft.FilterParams(filter_on=None, err_filter=0.21,
                              strand_filter=0.1)
    for backend in ("auto", "torch"):
        with pytest.raises(FinchMessageError, match="no CUDA device"):
            ft.sketch_files([QUERY_FA], params, filters, backend=backend)
        with pytest.raises(FinchMessageError, match="no CUDA device"):
            ft.make_engine(params, backend=backend)
    # the host backends stay explicit user choices
    [s] = ft.sketch_files([QUERY_FA], params, filters, backend="native")
    assert len(s.hashes) == 10


def test_torch_engine_refuses_wide_k(monkeypatch):
    """Wide k is ported: TorchEngine takes 32 <= k <= 63 on the CPU when
    asked (the wide step on the device state) and refuses k >= 64, which
    the torch backend of make_engine folds on the host. Without a card
    both refuse every k."""
    wide = eng.TorchEngine(ft.SketchParams.mash(kmer_length=32),
                           device="cpu")
    assert not wide.wants_composite and len(wide.state) == 5
    xparams = ft.SketchParams.mash(kmer_length=101)
    with pytest.raises(FinchMessageError, match="folds k <= 63"):
        eng.TorchEngine(xparams, device="cpu")
    xwide = eng.make_engine(xparams, backend="torch", device="cpu")
    assert isinstance(xwide, eng.NumpyEngine)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in (32, 63):
        with pytest.raises(FinchMessageError, match="no CUDA device"):
            eng.TorchEngine(ft.SketchParams.mash(kmer_length=k))
    for k in (32, 63, 101):
        with pytest.raises(FinchMessageError, match="no CUDA device"):
            eng.make_engine(ft.SketchParams.mash(kmer_length=k),
                            backend="torch")


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_fifo_sketches_like_the_file(tmp_path, gz):
    """A FIFO cannot rewind after the parser sniffs its format: the port
    streams it through the fd reader (which replays the sniffed bytes)
    and writes the same sketch as for the regular file."""
    with open(READS_FQ, "rb") as f:
        data = f.read()
    if gz:
        data = gzip.compress(data)
    regular = tmp_path / "reads"
    regular.write_bytes(data)
    params = ft.SketchParams.mash(kmers_to_sketch=100 * 200, final_size=100)
    filters = ft.FilterParams(filter_on=None, err_filter=0.21,
                              strand_filter=0.1)
    want = multisketch_to_json_bytes([sketch_stream(
        str(regular), READS_REL, params, filters, backend="native")])
    for backend in ("native", "torch"):
        fifo = tmp_path / f"fifo_{backend}"
        os.mkfifo(fifo)

        def feed(path=fifo):
            with open(path, "wb") as f:
                f.write(data)

        writer = threading.Thread(target=feed, daemon=True)
        writer.start()
        got = sketch_stream(str(fifo), READS_REL, params, filters,
                            backend=backend, device="cpu")
        writer.join(timeout=60)
        assert multisketch_to_json_bytes([got]) == want, backend
