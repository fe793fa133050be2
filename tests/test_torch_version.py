"""The port's build stamp (`spark_rapids_tpu_torch/version.py`) against the
JAX package's: the same six fields, the same values but the date."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import datetime

from spark_rapids_tpu import version as jversion
from spark_rapids_tpu_torch import version as tversion


def test_version_info_fields_equal_jax():
    got, want = tversion.version_info(), jversion.version_info()
    assert list(got) == ["version", "user", "revision", "branch", "date",
                         "url"]
    assert list(got) == list(want)
    for key in ("version", "user", "revision", "branch", "url"):
        assert got[key] == want[key], key
    assert tversion.__version__ == jversion.__version__
    stamp = datetime.datetime.fromisoformat(got["date"])
    assert stamp.tzinfo is not None
    assert tversion.version_info() is got        # computed once a process
