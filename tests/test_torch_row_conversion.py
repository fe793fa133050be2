"""The port's JCUDF row conversion (spark_rapids_tpu_torch/ops/
row_conversion.py, row_conversion_cuda.py, api.RowConversion) against the
JAX package on the CPU, on the same numpy inputs: the layout, the row image
byte for byte, the columns read back (validity included), the optimized
path's limits, the string rejection, the int32 image-size check, the
registry's choice, and the kernels' word plan executed here by a numpy
mirror of csrc/row_conversion.cu. Bytes are compared exactly."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu.ops import row_conversion as jrc

from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.ops import registry
from spark_rapids_tpu_torch.ops import row_conversion as rc
from spark_rapids_tpu_torch.ops import row_conversion_cuda as rcc

# (numpy storage, port dtype, JAX dtype) of every fixed kind; the first
# nine are the reference bench's cycle (bench_row_conversion.py:17-24)
KINDS = [
    (np.int8, tdt.INT8, jdt.INT8),
    (np.int16, tdt.INT16, jdt.INT16),
    (np.int32, tdt.INT32, jdt.INT32),
    (np.int64, tdt.INT64, jdt.INT64),
    (np.float32, tdt.FLOAT32, jdt.FLOAT32),
    (np.float64, tdt.FLOAT64, jdt.FLOAT64),
    (np.bool_, tdt.BOOL, jdt.BOOL),
    (np.int32, tdt.DATE32, jdt.DATE32),
    (np.int64, tdt.TIMESTAMP_US, jdt.TIMESTAMP_US),
    (np.uint8, tdt.UINT8, jdt.UINT8),
    (np.int32, tdt.decimal(9, 2), jdt.decimal(9, 2)),
    (np.int64, tdt.decimal(18, 4), jdt.decimal(18, 4)),
    (np.uint32, tdt.decimal(38, 10), jdt.decimal(38, 10)),
    (np.int64, tdt.DType(tdt.Kind.TIMESTAMP_S), jdt.TIMESTAMP_S),
    (np.int64, tdt.DType(tdt.Kind.TIMESTAMP_MS), jdt.TIMESTAMP_MS),
]


def _values(rng, npt_, n, dec128):
    if dec128:
        return rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(
            np.uint32)
    if npt_ is np.bool_:
        return rng.random(n) > 0.5
    if np.issubdtype(npt_, np.floating):
        a = rng.standard_normal(n).astype(npt_)
        a[:min(n, 3)] = np.array([np.nan, -0.0, np.inf], npt_)[:n]
        return a
    ii = np.iinfo(npt_)
    return rng.integers(ii.min, ii.max, n, dtype=npt_, endpoint=True)


def tables(kinds, n, null_p, seed=0):
    """The same table in both packages."""
    rng = np.random.default_rng(seed)
    jcols, tcols = [], []
    for i, (npt_, td, jd) in enumerate(kinds):
        a = _values(rng, npt_, n, td.kind == tdt.Kind.DECIMAL128)
        v = (rng.random(n) > null_p) if null_p and i % 3 != 2 else None
        jcols.append(JColumn(dtype=jd, length=n, data=jnp.asarray(a),
                             validity=None if v is None else jnp.asarray(v)))
        tcols.append(Column(td, n, torch.tensor(a),
                            None if v is None else torch.tensor(v)))
    names = [f"c{i}" for i in range(len(kinds))]
    return JTable(jcols, names=names), Table(tcols, names)


def image(col):
    return col.children[0].data.numpy()


def assert_table_equal(got: Table, want: JTable):
    for tc, jc in zip(got.columns, want.columns):
        assert tc.dtype.kind.value == jc.dtype.kind.value
        d = tc.data.numpy()
        jd_ = np.asarray(jc.data)
        assert d.dtype == jd_.dtype
        npt.assert_array_equal(d.view(np.uint8), jd_.view(np.uint8))
        npt.assert_array_equal(tc.validity.numpy(), np.asarray(jc.validity))


# ---- layout and image --------------------------------------------------------

def test_layout_matches_the_reference():
    # RowConversion.java's example: a 1-byte, a 4-byte, a 2-byte and an
    # 8-byte column; each aligned to its width, validity after the last
    schema = [tdt.INT8, tdt.INT32, tdt.INT16, tdt.INT64]
    assert rc.row_layout(schema) == ([0, 4, 8, 16], 24, 32)
    for kinds in (KINDS, KINDS[:9] * 24, KINDS[:4] * 6, [KINDS[6]] * 17):
        assert rc.row_layout([k[1] for k in kinds]) == \
            tuple(jrc.row_layout([k[2] for k in kinds]))
    _, voff, size = rc.row_layout([k[1] for k in KINDS[:9] * 24])
    assert (voff, size) == (1152, 1184)        # the bench's general shape


@pytest.mark.parametrize("ncols,null_p", [(9, 0.0), (9, 0.2), (15, 0.3),
                                          (17, 0.1), (40, 0.1)])
def test_image_and_round_trip_match_jax(ncols, null_p):
    kinds = (KINDS * 3)[:ncols]
    jt, tt = tables(kinds, 37, null_p, seed=ncols)
    (jrows,) = jrc.convert_to_rows(jt)
    (trows,) = rc.convert_to_rows(tt)
    assert trows.dtype == tdt.list_(tdt.UINT8)
    npt.assert_array_equal(trows.offsets.numpy(), np.asarray(jrows.offsets))
    npt.assert_array_equal(image(trows), np.asarray(jrows.children[0].data))
    schema = [k[1] for k in kinds]
    back = rc.convert_from_rows(trows, schema)
    assert_table_equal(back, jrc.convert_from_rows(jrows,
                                                   [k[2] for k in kinds]))
    # the round trip gives the input back, validity included
    for tc, orig in zip(back.columns, tt.columns):
        npt.assert_array_equal(tc.data.numpy().view(np.uint8),
                               orig.data.numpy().view(np.uint8))
        npt.assert_array_equal(tc.validity.numpy(),
                               orig.null_mask.numpy())


def test_api_and_optimized_forms():
    kinds = KINDS[:9] * 2
    jt, tt = tables(kinds, 12, 0.2, seed=3)
    schema = [k[1] for k in kinds]
    (a,) = api.RowConversion.convertToRows(tt)
    (b,) = api.RowConversion.convertToRowsFixedWidthOptimized(tt)
    (j,) = jrc.convert_to_rows_fixed_width_optimized(jt)
    npt.assert_array_equal(image(a), image(b))
    npt.assert_array_equal(image(a), np.asarray(j.children[0].data))
    want = jrc.convert_from_rows_fixed_width_optimized(
        j, [k[2] for k in kinds])
    assert_table_equal(api.RowConversion.convertFromRows(a, *schema), want)
    assert_table_equal(api.RowConversion.convertFromRowsFixedWidthOptimized(
        a, *schema), want)


def test_optimized_limits_match_the_reference():
    wide = [tdt.INT8] * 100
    with pytest.raises(ValueError, match="< 100 columns"):
        rc.check_optimized_limits(wide)
    with pytest.raises(ValueError):
        jrc._check_optimized_limits([jdt.INT8] * 100)
    rc.check_optimized_limits([tdt.INT8] * 99)
    big = [tdt.decimal(38, 0)] * 64           # 1,024 + 8 validity bytes
    with pytest.raises(ValueError, match="exceeds 1024"):
        rc.check_optimized_limits(big)
    _, tt = tables(KINDS[3:4] * 99, 2, 0.0)
    (rows,) = rc.convert_to_rows(tt)
    assert rows.offsets[1] == 808          # 792 + 13 validity bytes, padded
    with pytest.raises(ValueError):
        rc.convert_to_rows_fixed_width_optimized(Table(
            list(tt.columns) * 2))
    with pytest.raises(ValueError):
        rc.convert_from_rows_fixed_width_optimized(rows, big)


def test_strings_and_nested_kinds_are_rejected():
    s = Column.from_pylist(["a", "b"], tdt.STRING, device="cpu")
    i = Column.from_pylist([1, 2], tdt.INT32, device="cpu")
    for fn in (lambda: rc.convert_to_rows(Table([i, s])),
               lambda: rc.row_layout([tdt.INT32, tdt.list_(tdt.INT32)]),
               lambda: api.RowConversion.convertFromRows(
                   rc.convert_to_rows(Table([i]))[0], tdt.STRING)):
        with pytest.raises(TypeError, match="fixed-width"):
            fn()
    with pytest.raises(TypeError):
        jrc.convert_to_rows(JTable([JColumn.from_pylist(["a"],
                                                        jdt.STRING)]))
    with pytest.raises(TypeError, match="LIST<UINT8>"):
        rc.convert_from_rows(i, [tdt.INT32])


def test_from_rows_checks_the_stride_and_reads_any_bool_byte():
    (rows,) = rc.convert_to_rows(Table([Column.from_pylist(
        [True, False, None], tdt.BOOL, device="cpu")]))
    assert rows.offsets.tolist() == [0, 8, 16, 24]
    img = rows.children[0].data.clone()
    img[8] = 2                                     # row 1's value byte
    t = rc.convert_from_rows(Column.make_list(rows.offsets, Column(
        tdt.UINT8, 24, img)), [tdt.BOOL])
    assert t.columns[0].data.tolist() == [True, True, False]
    assert t.columns[0].validity.tolist() == [True, True, False]
    bad = Column.make_list(torch.tensor([0, 8, 17, 24], dtype=torch.int32),
                           rows.children[0])
    with pytest.raises(ValueError, match="uniform 8-byte"):
        rc.convert_from_rows(bad, [tdt.BOOL])
    with pytest.raises(ValueError, match="uniform 16-byte"):
        rc.convert_from_rows(rows, [tdt.INT64])
    empty = rc.convert_to_rows(Table([Column.from_pylist([], tdt.INT64,
                                                         device="cpu")]))[0]
    assert empty.length == 0 and rc.convert_from_rows(
        empty, [tdt.INT64]).num_rows == 0


def test_image_past_int32_offsets_raises_before_allocating():
    """The reference's `arange(n + 1, int32) * row_size` wraps past 2^31 - 1
    bytes; the port raises. The column is a zero-stride view: nothing big
    is allocated."""
    n = 2 ** 31 // 16                    # 16-byte rows: 2^31 bytes
    col = Column(tdt.INT64, n, torch.zeros(1, dtype=torch.int64).expand(n))
    for fn in (rc.convert_to_rows, rcc.to_rows, rc.to_rows_plain):
        with pytest.raises(ValueError, match="int32 offset"):
            fn(Table([col]))
    ok = Column(tdt.INT64, n - 1, torch.zeros(1, dtype=torch.int64).expand(
        n - 1))
    rc.check_image_size(ok.length, 16)          # 2^31 - 16 bytes
    assert (n - 1) * 16 <= rc.MAX_IMAGE_BYTES < n * 16


# ---- registry and wrappers ---------------------------------------------------

def test_registry_chooses_by_device_and_counts(monkeypatch):
    assert registry.REGISTRY.select("row_conversion", None, "cpu").name == \
        "torch"
    assert registry.REGISTRY.select("row_conversion", None, "cuda").name == \
        "cuda"
    _, tt = tables(KINDS[:9], 20, 0.2)
    rcc.reset_counters()
    (rows,) = rc.convert_to_rows(tt)
    rc.convert_from_rows(rows, [c.dtype for c in tt.columns])
    assert rcc.PLAIN_CALLS == {"to_rows": 1, "from_rows": 1}
    # forced onto the kernels, CPU tensors raise: the kernels take CUDA
    # tensors only, and the registry is the one place that chooses
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "row_conversion=cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rc.convert_to_rows(tt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rc.convert_from_rows(rows, [c.dtype for c in tt.columns])
    assert rcc.PLAIN_CALLS == {"to_rows": 1, "from_rows": 1}
    assert rcc.LAUNCHES == {"to_rows": 0, "from_rows": 0}
    monkeypatch.setenv("SPARK_RAPIDS_TORCH_KERNELS", "row_conversion=nope")
    with pytest.raises(ValueError, match="unknown kernel"):
        rc.convert_to_rows(tt)


# ---- the kernels' word plan, executed by a numpy mirror ---------------------

def _mirror_to_rows(table: Table) -> np.ndarray:
    """csrc/row_conversion.cu's rc_to_rows_kernel: each tile staged as the
    kernel stages it, then every (row, word) assembled from the plan."""
    schema = tuple(c.dtype for c in table.columns)
    plan, words, _, (tile, vstage, zstage, size) = rcc.word_plan(schema)
    srcs = [[int(x) for x in plan[4 * w:4 * w + 4]] for w in range(words)]
    ncols = len(schema)
    stage = plan[4 * words + 3 * ncols:4 * words + 4 * ncols]
    n = table.num_rows
    cols = [c.data.contiguous().view(torch.uint8).reshape(n, -1).numpy()
            for c in table.columns]
    valid = [c.null_mask.numpy().astype(np.uint8) for c in table.columns]
    out = np.zeros((n, words, 4), np.uint8)

    def at(s, r):
        return (s & rcc.SRC_ADDR) + (r << ((s >> 24) & 7))
    for r0 in range(0, n, tile):
        rows = min(tile, n - r0)
        sm = np.full(size, 0xEE, np.uint8)        # unstaged bytes show
        sm[zstage:zstage + tile] = 0
        for c in range(ncols):
            w = cols[c].shape[1]
            sm[stage[c]:stage[c] + rows * w] = cols[c][r0:r0 + rows].reshape(
                -1)
        for b in range((ncols + 7) // 8):
            v = np.zeros(rows, np.uint8)
            for i in range(min(8, ncols - 8 * b)):
                v |= valid[8 * b + i][r0:r0 + rows] << i
            sm[vstage + b * tile:vstage + b * tile + rows] = v
        r = np.arange(rows)
        for w, quad in enumerate(srcs):
            if quad[0] & rcc.SRC_WHOLE:
                a = at(quad[0] & ~rcc.SRC_WHOLE, r)
                out[r0:r0 + rows, w] = sm[a[:, None] + np.arange(4)]
            else:
                for j in range(4):
                    out[r0:r0 + rows, w, j] = sm[at(quad[j], r)]
    return out.reshape(-1)


def _mirror_from_rows(img: np.ndarray, schema) -> list:
    """csrc/row_conversion.cu's rc_from_rows_kernel over every (column,
    row): the value at the column's offset into its slot of its output
    buffer (the plan's group and slot), its validity bit into row c of the
    (ncols, n) validity bytes; then each column read back from its slot."""
    plan, words, voff, _ = rcc.word_plan(tuple(schema))
    k = len(schema)
    width, offset, is_bool, _, group, slot = (
        plan[4 * words + i * k:4 * words + (i + 1) * k] for i in range(6))
    n = img.shape[0]
    groups, _, _ = rcc.out_groups(tuple(schema))
    gwidth = {g: w for g, w in zip(group, width)}
    bufs = [np.full(cnt * n * gwidth[g], 0xEE, np.uint8)
            for g, (_, _, cnt) in enumerate(groups)]
    valid = np.full((k, n), 0xEE, np.uint8)
    for c in range(k):
        v = img[:, offset[c]:offset[c] + width[c]]
        v = (v != 0).astype(np.uint8) if is_bool[c] else v
        at = slot[c] * n * width[c]
        bufs[group[c]][at:at + n * width[c]] = v.reshape(-1)
        valid[c] = (img[:, voff + c // 8] >> (c % 8)) & 1
    data = [bufs[group[c]][slot[c] * n * width[c]:(slot[c] + 1) * n
                           * width[c]] for c in range(k)]
    return data, list(valid != 0)


@pytest.mark.parametrize("ncols,n", [(1, 11), (9, 70), (17, 33), (24, 40),
                                     (216, 11), (1000, 15)])
def test_kernel_word_plan_equals_plain_version(ncols, n):
    kinds = (KINDS * 67)[:ncols]
    _, tt = tables(kinds, n, 0.25, seed=ncols)
    plain = rc.to_rows_plain(tt).numpy()
    npt.assert_array_equal(_mirror_to_rows(tt), plain)
    schema = [c.dtype for c in tt.columns]
    _, _, size = rc.row_layout(schema)
    data, valid = _mirror_from_rows(plain.reshape(-1, size), schema)
    want = rc.from_rows_plain(torch.tensor(plain).reshape(-1, size), schema)
    for d, v, c in zip(data, valid, want.columns):
        npt.assert_array_equal(d.reshape(-1), c.data.contiguous().view(
            torch.uint8).reshape(-1).numpy())
        npt.assert_array_equal(v, c.validity.numpy())


def test_kernel_staging_fits_shared_memory():
    """to_rows stages a tile of up to 32 rows in shared memory (values,
    packed validity bytes, a row of zeros): fewer rows for wide schemas,
    none past 227 KB a row (a stated limit)."""
    tile, stage, vstage, zstage, total = rcc.stage_layout(
        tuple(k[1] for k in KINDS[:9] * 24))
    assert (tile, vstage, zstage, total) == (32, 32 * 960, 32 * 987,
                                             32 * 988)
    assert all(o % 16 == 0 for o in stage)
    wide = (tdt.decimal(38, 0),) * 1000           # 16 KB of values a row
    tile, _, vstage, zstage, total = rcc.stage_layout(wide)
    assert (tile, vstage, total) == (14, 14 * 16000, 14 * (16000 + 125 + 1))
    with pytest.raises(ValueError, match="shared memory"):
        rcc.stage_layout((tdt.decimal(38, 0),) * 15000)
