"""The port's LruDict (spark_rapids_tpu_torch/utils/lru.py) case by case
against the reference's tests/test_lru.py, each sequence run through both
packages' LruDict with the same keys; plus the port's eviction hook,
which the capped tier's program cache uses to free a CUDA graph."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

from spark_rapids_tpu.utils import LruDict as JLruDict

from spark_rapids_tpu_torch.utils import LruDict


def _both(maxsize):
    return JLruDict(maxsize=maxsize), LruDict(maxsize=maxsize)


def test_insert_evicts_oldest_in_order():
    for d in _both(3):
        for k in "abcd":
            d[k] = k.upper()
        assert list(d) == ["b", "c", "d"]          # "a" was the oldest
        d["e"] = "E"
        assert list(d) == ["c", "d", "e"]


def test_get_refreshes_recency():
    for d in _both(3):
        for k in "abc":
            d[k] = k.upper()
        assert d.get("a") == "A"                   # refresh: "a" newest
        d["d"] = "D"
        assert "a" in d and "b" not in d           # "b" evicted instead
        assert list(d) == ["c", "a", "d"]


def test_get_miss_returns_default_without_insert():
    for d in _both(2):
        d["a"] = 1
        assert d.get("zz") is None
        assert d.get("zz", 7) == 7
        assert list(d) == ["a"]


def test_overwrite_refreshes_and_keeps_size():
    for d in _both(2):
        d["a"] = 1
        d["b"] = 2
        d["a"] = 10                                # overwrite = newest
        d["c"] = 3
        assert list(d) == ["a", "c"] and d["a"] == 10


def test_plain_getitem_does_not_refresh():
    for d in _both(2):
        d["a"] = 1
        d["b"] = 2
        assert d["a"] == 1                         # no refresh
        d["c"] = 3
        assert "a" not in d                        # "a" still the oldest


@pytest.mark.parametrize("ops", [
    "a b c d a? e b? f", "x x x y z x? w", "a? b c b? d e f a?"])
def test_same_order_as_the_reference(ops):
    """A mixed sequence of inserts and refreshing reads leaves the same
    keys in the same order in both packages."""
    j, t = _both(3)
    for op in ops.split():
        for d in (j, t):
            if op.endswith("?"):
                d.get(op[:-1])
            else:
                d[op] = op.upper()
        assert list(j) == list(t) and dict(j) == dict(t)


def test_on_evict_sees_each_evicted_value_once():
    gone = []
    d = LruDict(maxsize=2, on_evict=gone.append)
    for k in "abcd":
        d[k] = k.upper()
    assert gone == ["A", "B"] and list(d) == ["c", "d"]
    d["c"] = "C2"                                  # an overwrite evicts
    assert gone == ["A", "B"]                      # nothing
