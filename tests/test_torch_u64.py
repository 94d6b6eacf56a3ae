"""finch_tpu_torch.u64 (u64 values as int64 bit patterns) against numpy
uint64 on the edge values and on random values."""

import numpy as np
import pytest
import torch

from finch_tpu_torch import u64

torch.set_num_threads(2)

EDGES = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1],
                 dtype=np.uint64)


def _values():
    rng = np.random.default_rng(7)
    rand = rng.integers(0, 2**64 - 1, size=200, dtype=np.uint64,
                        endpoint=True)
    return np.concatenate([EDGES, rand])


def test_numpy_roundtrip():
    a = _values()
    t = u64.from_numpy(a)
    assert t.dtype == torch.int64
    assert np.array_equal(u64.to_numpy(t), a)
    for v in EDGES:
        assert u64.to_u64(u64.to_i64(int(v))) == int(v)
    assert u64.to_i64(2**64 - 1) == u64.MAX


def test_compares_and_max():
    a = _values()
    b = np.roll(a, 3)
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    assert np.array_equal(u64.lt(ta, tb).numpy(), a < b)
    assert np.array_equal(u64.le(ta, tb).numpy(), a <= b)
    assert np.array_equal(u64.to_numpy(u64.maximum(ta, tb)),
                          np.maximum(a, b))
    for s in (0, 2**63, 2**64 - 1):
        assert np.array_equal(u64.le(ta, s).numpy(), a <= np.uint64(s))


@pytest.mark.parametrize("s", [0, 1, 5, 31, 32, 33, 62, 63])
def test_logical_shift(s):
    a = _values()
    assert np.array_equal(u64.to_numpy(u64.shr(u64.from_numpy(a), s)),
                          a >> np.uint64(s))


@pytest.mark.parametrize("r", [1, 27, 31, 33, 63])
def test_rotl(r):
    a = _values()
    exp = (a << np.uint64(r)) | (a >> np.uint64(64 - r))
    assert np.array_equal(u64.to_numpy(u64.rotl(u64.from_numpy(a), r)), exp)


def test_wrapping_arithmetic():
    a = _values()
    b = np.roll(a, 5)
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    with np.errstate(over="ignore"):
        assert np.array_equal(u64.to_numpy(ta * tb), a * b)
        assert np.array_equal(u64.to_numpy(ta + tb), a + b)


def test_sort_order():
    a = _values()
    vals, idx = u64.sort(u64.from_numpy(a))
    assert np.array_equal(u64.to_numpy(vals), np.sort(a))
    assert np.array_equal(a[idx.numpy()], np.sort(a))
    # 2-D along either axis
    m = a[:196].reshape(14, 14)
    for dim in (0, 1):
        got, _ = u64.sort(u64.from_numpy(m), dim=dim)
        assert np.array_equal(u64.to_numpy(got), np.sort(m, axis=dim))


def test_split_join():
    a = _values()
    lo, hi = u64.split(u64.from_numpy(a))
    assert lo.dtype == torch.int32 and hi.dtype == torch.int32
    assert np.array_equal(u64.to_numpy(lo),
                          (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert np.array_equal(u64.to_numpy(hi),
                          (a >> np.uint64(32)).astype(np.uint32))
    assert np.array_equal(u64.to_numpy(u64.join(lo, hi)), a)
