"""Unified error taxonomy for the whole framework.

Mirror of the reference's single library-wide error type
(finch-rs/lib/src/errors.rs:5-25, ``FinchError`` with variants
Io / Capnproto / Needletail / IntError / FloatError / SchemaError /
Json / Message).  Every layer — native parser, core engines,
serialization, CLI, Python API — raises a subclass of :class:`FinchError`
so callers can catch one type, exactly as ``FinchResult`` propagates one
enum in the reference.

The numeric/schema/message subclasses also inherit ``ValueError`` so
pre-existing Python idioms (``except ValueError``) keep working; the IO
subclass likewise inherits ``OSError``.
"""

from __future__ import annotations

__all__ = [
    "FinchError",
    "FinchIoError",
    "FinchParseError",
    "FinchSchemaError",
    "FinchMessageError",
]


class FinchError(Exception):
    """Base of every error the framework raises (errors.rs:6)."""


class FinchIoError(FinchError, OSError):
    """File open/read/write failures (errors.rs ``Io`` variant)."""


class FinchParseError(FinchError):
    """FASTA/FASTQ parse failures (errors.rs ``Needletail`` variant)."""


class FinchSchemaError(FinchError, ValueError):
    """Malformed sketch files / schema mismatches (errors.rs
    ``Capnproto``/``SchemaError``/``Json``/``IntError``/``FloatError``)."""


class FinchMessageError(FinchError, ValueError):
    """Free-form library errors (errors.rs ``Message`` variant, the
    ``bail!`` macro)."""
