"""`spark_rapids_tpu_torch.api.CastStrings` end to end against the JAX
package's `api.CastStrings`: every method of CastStrings.java, on the same
inputs, bit for bit (values and validity; strings' offsets and chars), and
the ANSI error's row and string; then a chain through all eight."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import inspect

import numpy as np
import pytest

from spark_rapids_tpu import api as japi
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.ops.cast_string import CastError as JaxCastError
from spark_rapids_tpu_torch import api as tapi
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import ops as tops
from spark_rapids_tpu_torch.ops import cast_cuda
from torch_cast_inputs import EDGE, random_number_strings, with_nulls
from torch_cast_jax import (assert_same_error, assert_same_strings,
                            assert_same_values, numpy_columns,
                            string_columns)

STRINGS = with_nulls(EDGE + random_number_strings(31, 300), 32)


def test_every_method_of_the_jax_facade():
    """Method for method, with the JAX facade's parameter names."""
    for name, fn in inspect.getmembers(japi.CastStrings,
                                       inspect.isfunction):
        mine = getattr(tapi.CastStrings, name)
        assert list(inspect.signature(mine).parameters) == list(
            inspect.signature(fn).parameters), name
    assert len([m for m in vars(tapi.CastStrings)
                if not m.startswith("_")]) == 8


@pytest.mark.parametrize("method,args", [
    ("toInteger", (False, "INT32")), ("toInteger", (False, "INT8", False)),
    ("toFloat", (False, "FLOAT64")), ("toDecimal", (False, 12, 3)),
    ("toIntegersWithBase", (16, False, "INT64"))])
def test_string_methods_equal_jax(method, args):
    jc, tc = string_columns(STRINGS)

    def typed(mod, a):
        return tuple(mod.DType(mod.Kind[x]) if isinstance(x, str) else x
                     for x in a)
    got = getattr(tapi.CastStrings, method)(tc, *typed(tdt, args))
    want = getattr(japi.CastStrings, method)(jc, *typed(jdt, args))
    assert_same_values(got, want)


def test_ansi_error_equals_jax():
    jc, tc = string_columns(["1", None, "2", " 3x", "4"])
    with pytest.raises(JaxCastError) as want:
        japi.CastStrings.toInteger(jc, True, jdt.INT64)
    with pytest.raises(tops.CastError) as got:
        tapi.CastStrings.toInteger(tc, True, tdt.INT64)
    assert_same_error(got.value, want.value)
    assert (got.value.row_number, got.value.string_with_error) == (3, " 3x")


def test_number_methods_equal_jax():
    rng = np.random.default_rng(33)
    x = rng.normal(0, 1e5, 400)
    valid = rng.random(400) > 0.1
    jf, tf = numpy_columns(x, "FLOAT64", valid)
    assert_same_strings(tapi.CastStrings.fromFloat(tf),
                        japi.CastStrings.fromFloat(jf))
    assert_same_strings(tapi.CastStrings.fromFloatWithFormat(tf, 3),
                        japi.CastStrings.fromFloatWithFormat(jf, 3))
    d = rng.integers(-10**17, 10**17, 400)
    jd, td = numpy_columns(d, "DECIMAL64", valid, 18, 5)
    assert_same_strings(tapi.CastStrings.fromDecimal(td),
                        japi.CastStrings.fromDecimal(jd))
    ji, ti = numpy_columns(d, "INT64", valid)
    for base in (10, 16):
        assert_same_strings(tapi.CastStrings.fromIntegersWithBase(ti, base),
                            japi.CastStrings.fromIntegersWithBase(ji, base))


def test_round_trips_through_all_eight_on_the_cpu():
    """float -> string -> float, decimal -> string -> decimal, integer ->
    hex -> integer; each method runs its plain version once here."""
    rng = np.random.default_rng(34)
    cast_cuda.reset_counters()
    x = rng.normal(0, 1e3, 200)
    _, tf = numpy_columns(x, "FLOAT64")
    back = tapi.CastStrings.toFloat(tapi.CastStrings.fromFloat(tf), False,
                                    tdt.FLOAT64)
    # the cast builds digits * 10^exp in float64 as the reference does, not
    # a correctly rounded parse: within an ulp, not always the same bits
    np.testing.assert_allclose(back.data.numpy(), x, rtol=2.3e-16, atol=0)
    _, td = numpy_columns(rng.integers(-10**9, 10**9, 200), "DECIMAL64",
                          None, 12, 4)
    s = tapi.CastStrings.fromDecimal(td)
    np.testing.assert_array_equal(
        tapi.CastStrings.toDecimal(s, True, 12, 4).data.numpy(),
        td.data.numpy())
    _, ti = numpy_columns(rng.integers(0, 2**62, 200), "INT64")
    h = tapi.CastStrings.fromIntegersWithBase(ti, 16)
    np.testing.assert_array_equal(
        tapi.CastStrings.toIntegersWithBase(h, 16, False,
                                            tdt.INT64).data.numpy(),
        ti.data.numpy())
    assert tapi.CastStrings.toInteger(
        tapi.CastStrings.fromFloatWithFormat(tf, 0), False,
        tdt.INT64).null_count() >= 0
    assert all(v == 1 for v in cast_cuda.PLAIN_CALLS.values()), \
        cast_cuda.PLAIN_CALLS
    assert sum(cast_cuda.LAUNCHES.values()) == 0
