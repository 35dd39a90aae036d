"""LRU frame-cache unit tests — the test set of the reference's
test/test_cache.c (15 libcheck cases: insert/find hit/miss/empty, LRU
eviction order via test_cache_replace :135-159, memory accounting
:167-180), adapted to the typed Python API (NULL-tolerance cases become
type errors by construction).
"""

import pytest

from libzseek_jax.runtime.cache import FrameCache


def test_new_rejects_bad_capacity():
    with pytest.raises(ValueError):
        FrameCache(0)
    with pytest.raises(ValueError):
        FrameCache(-3)


def test_find_empty():
    c = FrameCache(4)
    assert c.find(0) is None
    assert c.entries == 0
    assert c.misses == 1


def test_insert_find_hit():
    c = FrameCache(4)
    c.insert(7, b"seven")
    assert c.find(7) == b"seven"
    assert c.hits == 1 and c.misses == 0
    assert c.entries == 1


def test_find_miss_nonempty():
    c = FrameCache(4)
    c.insert(1, b"x")
    assert c.find(2) is None


def test_replace_same_key():
    c = FrameCache(2)
    c.insert(1, b"a")
    c.insert(1, b"bb")
    assert c.entries == 1
    assert c.find(1) == b"bb"


def test_lru_eviction_order():
    """reference test_cache_replace: fill, touch, insert -> evicts true LRU."""
    c = FrameCache(3)
    c.insert(1, b"one")
    c.insert(2, b"two")
    c.insert(3, b"three")
    assert c.find(1) == b"one"      # promote 1 to MRU; LRU is now 2
    c.insert(4, b"four")            # evicts 2
    assert c.find(2) is None
    assert c.find(1) == b"one"
    assert c.find(3) == b"three"
    assert c.find(4) == b"four"
    assert c.entries == 3


def test_eviction_chain():
    c = FrameCache(2)
    for i in range(10):
        c.insert(i, bytes([i]))
    assert c.entries == 2
    assert c.find(8) is not None and c.find(9) is not None
    for i in range(8):
        assert c.find(i) is None


def test_memory_accounting():
    c = FrameCache(2)
    base = c.memory_usage()
    c.insert(1, b"x" * 1000)
    assert c.memory_usage() >= base + 1000
    c.insert(2, b"y" * 500)
    m2 = c.memory_usage()
    c.insert(3, b"z" * 100)  # evicts 1 (1000 bytes)
    assert c.memory_usage() < m2
    c.insert(3, b"")  # replace shrinks
    assert c.memory_usage() <= m2


def test_capacity_one():
    c = FrameCache(1)
    c.insert(1, b"a")
    c.insert(2, b"b")
    assert c.find(1) is None
    assert c.find(2) == b"b"


def test_device_array_entries():
    import numpy as np
    c = FrameCache(2)
    arr = np.zeros(4096, np.uint8)
    c.insert(5, arr)
    assert c.memory_usage() >= 4096
    assert c.find(5) is arr
