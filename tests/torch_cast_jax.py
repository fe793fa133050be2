"""Parity helpers of the port's cast tests: the same values as a JAX
package column and a port column, and comparisons of their buffers."""
import numpy as np
import torch

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JCol
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol


def string_columns(values):
    """(JAX column, port CPU column) of bytes/str/None values."""
    return (JCol.from_pylist(values, jdt.STRING),
            TCol.from_pylist(values, tdt.STRING, device="cpu"))


def numpy_columns(arr, kind, valid=None, precision=None, scale=None):
    """(JAX column, port CPU column) of a numpy data buffer."""
    if precision is not None:
        jt, tt = jdt.decimal(precision, scale), tdt.decimal(precision, scale)
    else:
        jt, tt = jdt.DType(jdt.Kind[kind]), tdt.DType(tdt.Kind[kind])
    return (JCol.from_numpy(arr, jt, validity=valid),
            TCol.from_numpy(arr, tt, valid, device="cpu"))


def _bits(a):
    a = np.ascontiguousarray(a)
    if a.dtype in (np.float32, np.uint32):
        return a.view(np.int32)
    if a.dtype in (np.float64, np.uint64):
        return a.view(np.int64)
    return a


def assert_same_values(got, want):
    """A port cast's column equals the JAX package's: validity, and the
    data's bits on every valid row (a rejected row's data is 0 in the
    port and whatever the JAX algebra computed in the JAX package)."""
    gv = got.null_mask.cpu().numpy()
    wv = np.asarray(want.null_mask)
    np.testing.assert_array_equal(gv, wv)
    gd = _bits(got.data.cpu().numpy())
    wd = _bits(np.asarray(want.data))
    assert gd.shape == wd.shape and gd.dtype == wd.dtype, (gd.dtype,
                                                            wd.dtype)
    np.testing.assert_array_equal(gd[gv], wd[wv])
    assert not gd[~gv].any(), "a rejected row's data is not 0"


def assert_same_strings(got, want):
    """Offsets, chars and validity equal, byte for byte."""
    np.testing.assert_array_equal(got.offsets.cpu().numpy(),
                                  np.asarray(want.offsets))
    np.testing.assert_array_equal(got.data.cpu().numpy(),
                                  np.asarray(want.data))
    np.testing.assert_array_equal(got.null_mask.cpu().numpy(),
                                  np.asarray(want.null_mask))


def assert_same_error(got, want):
    assert type(got).__name__ == "CastError"
    assert (got.row_number, got.string_with_error) == (
        want.row_number, want.string_with_error)


def assert_same_tensors(got, want):
    """Two port tensors of any dtype, bit for bit."""
    g, w = got, want
    if g.dtype in (torch.float32, torch.uint32):
        g, w = g.view(torch.int32), w.view(torch.int32)
    elif g.dtype in (torch.float64, torch.uint64):
        g, w = g.view(torch.int64), w.view(torch.int64)
    assert torch.equal(g, w)


def assert_same_column(got, want):
    """A port column equals a JAX package column in every buffer: the
    dtype's kind, the length, the data's bits on every row (null rows
    too), the validity (None where the JAX package's is None), the offsets
    and the children, recursively."""
    assert got.dtype.kind.value == want.dtype.kind.value, (got.dtype,
                                                           want.dtype)
    assert got.length == want.length
    assert (got.data is None) == (want.data is None)
    if got.data is not None:
        gd, wd = _bits(got.data.cpu().numpy()), _bits(np.asarray(want.data))
        assert gd.dtype == wd.dtype, (gd.dtype, wd.dtype)
        np.testing.assert_array_equal(gd, wd)
    assert (got.validity is None) == (want.validity is None), (
        got.validity, want.validity)
    if got.validity is not None:
        np.testing.assert_array_equal(got.validity.cpu().numpy(),
                                      np.asarray(want.validity))
    assert (got.offsets is None) == (want.offsets is None)
    if got.offsets is not None:
        np.testing.assert_array_equal(got.offsets.cpu().numpy(),
                                      np.asarray(want.offsets))
    assert len(got.children) == len(want.children)
    for g, w in zip(got.children, want.children):
        assert_same_column(g, w)
