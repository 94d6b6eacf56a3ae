"""Sketch serialization: .sk (Mash JSON schema), .bsk (finch Cap'n Proto),
.msh (Mash Cap'n Proto).

Dispatch mirrors finch-rs/lib/src/lib.rs:96-117 `open_sketch_file`.
"""

from __future__ import annotations

from typing import List

from finch_tpu_torch.errors import FinchMessageError

FINCH_EXT = ".sk"
FINCH_BIN_EXT = ".bsk"
MASH_EXT = ".msh"


def open_sketch_file(path) -> List["Sketch"]:
    """Read sketches from .sk/.json (JSON), .bsk (finch capnp) or .msh
    (mash capnp) — lib.rs:96-117."""
    p = str(path)
    if p.endswith(MASH_EXT):
        from finch_tpu_torch.serialization.mash_msh import read_mash_file
        with open(p, "rb") as f:
            return read_mash_file(f.read())
    if p.endswith(FINCH_BIN_EXT):
        from finch_tpu_torch.serialization.finch_bsk import read_finch_file
        with open(p, "rb") as f:
            return read_finch_file(f.read())
    if p.endswith(FINCH_EXT) or p.endswith(".json"):
        from finch_tpu_torch.serialization.json_sk import read_sk_file
        with open(p, "rb") as f:
            return read_sk_file(f.read(), path=p)
    raise FinchMessageError("File suffix is not *.bsk, *.msh, or *.sk")
