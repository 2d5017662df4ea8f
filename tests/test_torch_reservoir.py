"""The port's host ``RescoreReservoir`` against the JAX package's, on the
CPU: the same puts (new ids, ids refreshed in place, batches larger than
a bounded ring) give the same ``state_arrays`` bit for bit and the same
lookups. Unbounded, the port appends into a capacity that doubles where
the reference copies its whole pool on every put.
"""
import numpy as np
import pytest

from repro.index.store import RescoreReservoir as JReservoir
from repro_torch.index.store import RescoreReservoir

D = 12


def _puts(seed):
    """Batches of ascending new ids with some ids put again."""
    rng = np.random.default_rng(seed)
    out, nxt = [], 0
    for size in (5, 300, 1, 0, 2000, 37, 700):
        ids = np.arange(nxt, nxt + size)
        nxt += size
        if nxt > 50 and size:
            ids = np.concatenate([ids, rng.integers(0, nxt, 7)])
        out.append((ids, rng.standard_normal((ids.size, D))
                    .astype(np.float32)))
    return out


@pytest.mark.parametrize("max_bytes", [None, 900 * (4 * D + 8)])
def test_state_and_lookup_match_jax(max_bytes):
    j = JReservoir(D, max_bytes=max_bytes)
    t = RescoreReservoir(D, max_bytes=max_bytes)
    for ids, x in _puts(0):
        j.put(ids, x)
        t.put(ids, x)
        js, ts = j.state_arrays(), t.state_arrays()
        for key in ("rescore_rows", "rescore_ids"):
            assert ts[key].dtype == js[key].dtype
            np.testing.assert_array_equal(ts[key], js[key])
        assert len(t) == len(j) and t.evicted == j.evicted
        assert t.resident_bytes() == j.resident_bytes()
    probe = np.array([[0, 3, 5000, -1], [2999, 1200, 4, 42]])
    (tr, tf), (jr, jf) = t.lookup(probe), j.lookup(probe)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tr, jr)
    back = RescoreReservoir.restore(t.state_arrays(), D, max_bytes=max_bytes)
    for key, v in back.state_arrays().items():
        np.testing.assert_array_equal(v, t.state_arrays()[key])


def test_unbounded_growth_is_geometric_and_never_copies():
    """Each new segment is at least as large as the pool before it (a
    logarithmic count), and a segment, once made, is never replaced."""
    t = RescoreReservoir(D)
    t.put(np.arange(1000), np.zeros((1000, D), np.float32))
    first = t._segs[0][0]
    for i in range(200):
        lo = 1000 + i * 64
        t.put(np.arange(lo, lo + 64), np.full((64, D), i, np.float32))
        cap = sum(len(ids) for _, ids in t._segs)
        assert t._n <= cap <= 2 * t._n
    assert t._segs[0][0] is first and len(t._segs) <= 5
    assert len(t) == 1000 + 200 * 64
    rows, found = t.lookup(np.array([5, 1000, 1000 + 64 * 199 + 3]))
    assert found.all()
    np.testing.assert_array_equal(rows[:, 0], [0.0, 0.0, 199.0])
