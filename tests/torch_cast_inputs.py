"""Inputs shared by the port's cast tests: an edge corpus of strings and
seeded random strings shaped like numbers, made with numpy, as bytes."""
import numpy as np

EDGE = [
    b"", b" ", b"\t", b"\r\n", b"    ", b"\x00", b"1\x00", b"\x80\xff",
    b"\xc3\xa91", b"0", b"-0", b"+0", b"00", b"0e5", b"0\n", b"0f", b".",
    b"+e5", b"1e5 ", b"1e", b"1e+", b"1e-", b"e5", b"-", b"+", b"+-1",
    b"nan", b"NaN", b"nan ", b"-nan", b"nanx", b"inf", b"-Infinity",
    b"infx", b"INFINITY", b"+inf", b"infinity ", b"Infinit", b"1.5f",
    b"1.5d", b"1.5F ", b"1.5D\t", b"1.5ff", b"1..2", b"1.2.3", b"  12  ",
    b"\n12\r", b"1 2", b"12 .", b"-.5", b".5e1", b"5.", b"5.e2", b"12a",
    b"0x1A", b"ff", b"-FF", b"\x0c12", b"\x0b-7", b"7fffffff",
    b"9007199254740993", b"9999999999999999", b"99999999999999999",
    b"999999999999999999", b"9999999999999999999", b"99999999999999999999",
    b"18446744073709551615", b"18446744073709551616", b"1000000000000001",
    b"999999999999999", b"1000000000000000", b"1e308",
    b"1.7976931348623157e308", b"1.8e308", b"1e309", b"-1e309",
    b"4.9e-324", b"1e-310", b"-1e-310", b"2.2250738585072014e-308",
    b"2.2250738585072011e-308", b"1e-320", b"1e-400", b"1e-307",
    b"9.99999e-308", b"123456789012345678901234567890",
    b"0.000000000000000000001", b"1e-45", b"1.4e-45", b"1.17549435e-38",
    b"1.1754942e-38", b"3.4028235e38", b"3.5e38", b"1e9999", b"1e10000",
    b"127", b"128", b"-128", b"-129", b"32767", b"32768", b"-32769",
    b"2147483647", b"2147483648", b"-2147483648", b"-2147483649",
    b"9223372036854775807", b"9223372036854775808",
    b"-9223372036854775808", b"-9223372036854775809",
    b"0.5", b"0.49999", b"-0.5", b"9.5", b"99.95", b"999.5", b"1.05",
    b"12345.6789", b"-12345.6789e-3", b"1E2", b"1e+2", b"1.e", b"1.23E+",
    b"99999999999999999999999999999999999999",
    b"999999999999999999999999999999999999999",
    b"-0.0000000000000000000000000000000000001", b"1e38", b"1e-38",
    b"12345678901234567890.5", b"0.00001", b"100000", b"1e7",
]

_WS = [b" ", b"\t", b"\r", b"\n"]
_JUNK = [b"x", b".", b"e", b"E", b"+", b"-", b" ", b"f", b"d", b"\x00",
         b"\xc3\xa9", b"a", b"F", b"n", b"i"]


def _digits(rng, lo, hi):
    k = int(rng.integers(lo, hi + 1))
    return bytes(rng.integers(48, 58, size=k).astype(np.uint8))


def random_number_strings(seed, n, max_digits=24, junk_p=0.08):
    """n byte strings: optional whitespace, sign, digits, fraction,
    exponent, suffix and whitespace, each part present at random; about
    `junk_p` of them with one byte inserted, replaced or removed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = []
        if rng.random() < 0.1:
            parts.append(_WS[rng.integers(4)] * int(rng.integers(1, 3)))
        if rng.random() < 0.3:
            parts.append(b"-" if rng.random() < 0.6 else b"+")
        if rng.random() < 0.03:
            parts.append([b"nan", b"inf", b"Infinity", b"NAN"][
                rng.integers(4)])
        else:
            if rng.random() < 0.2:
                parts.append(b"0" * int(rng.integers(1, 4)))
            parts.append(_digits(rng, 0 if rng.random() < 0.1 else 1,
                                 max_digits))
            if rng.random() < 0.4:
                parts.append(b"." + _digits(rng, 0, max_digits // 2))
            if rng.random() < 0.25:
                parts.append(b"eE"[rng.integers(2):][:1]
                             + [b"", b"+", b"-"][rng.integers(3)]
                             + _digits(rng, 0, 4))
            if rng.random() < 0.05:
                parts.append(b"fFdD"[rng.integers(4):][:1])
        if rng.random() < 0.1:
            parts.append(_WS[rng.integers(4)] * int(rng.integers(1, 3)))
        s = bytearray(b"".join(parts))
        if rng.random() < junk_p:
            j = _JUNK[rng.integers(len(_JUNK))]
            i = int(rng.integers(0, len(s) + 1))
            act = rng.integers(3)
            if act == 0 or not s:
                s[i:i] = j
            elif act == 1:
                s[min(i, len(s) - 1):min(i, len(s) - 1) + 1] = j
            else:
                del s[min(i, len(s) - 1)]
        out.append(bytes(s))
    return out


def random_hex_strings(seed, n):
    """n byte strings for `conv`: whitespace (the regex class), a '-',
    hex or decimal digits and a tail."""
    rng = np.random.default_rng(seed)
    alpha = b"0123456789abcdefABCDEF"
    out = []
    for _ in range(n):
        s = b""
        if rng.random() < 0.2:
            s += [b" ", b"\t", b"\x0c", b"\x0b", b"\n"][rng.integers(5)]
        if rng.random() < 0.3:
            s += b"-"
        k = int(rng.integers(0, 22))
        s += bytes(alpha[i] for i in rng.integers(0, len(alpha), size=k))
        if rng.random() < 0.15:
            s += [b"x", b" 1", b"g", b".5", b"-"][rng.integers(5)]
        out.append(s)
    return out


def with_nulls(values, seed, p=0.1):
    rng = np.random.default_rng(seed)
    return [None if rng.random() < p else v for v in values]


# ---- the kernels' row functions built with the host's C++ compiler ---------

def build_host(name, tmp_dir):
    """csrc/<name>.cu compiled without nvcc (its row functions and the
    `host_*` loop over rows), loaded with ctypes; None without a host C++
    compiler."""
    import ctypes
    import pathlib
    import shutil
    import subprocess

    from spark_rapids_tpu_torch.ops import cuda_build
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    src = pathlib.Path(cuda_build.__file__).parent / "csrc" / f"{name}.cu"
    lib = pathlib.Path(tmp_dir) / f"lib{name}_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-x", "c++", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _p(t):
    return None if t is None else t.data_ptr()


def host_cast(lib, fn, col, out_type, *, ansi=False, strip=True, base=0,
              precision=None, scale=None, flags=True):
    """One of the string -> number kernels' host loops over a CPU column,
    as ops/cast_cuda.py launches it -> (data, validity, error flags).
    With `flags` False the loop gets a null flag buffer, as a launch does
    but under ANSI, and the flags come back None."""
    import ctypes

    import torch

    from spark_rapids_tpu_torch.ops import cast_cuda
    offsets, chars, valid = cast_cuda.string_buffers(col)
    n = col.length
    shape = (n,) + out_type.row_shape
    out = torch.zeros(shape, dtype=out_type.storage_dtype())
    ok = torch.zeros(n, dtype=torch.bool)
    err = torch.zeros(n, dtype=torch.bool) if flags else None
    P, I, N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    common = (offsets.data_ptr(), chars.data_ptr(), _p(valid), n)
    f = getattr(lib, fn)
    f.restype = I
    if fn == "host_to_integer":
        f.argtypes = [P, P, P, N, I, I, I, I, P, P, P]
        rc = f(*common, out.element_size(), int(strip), int(ansi), base,
               out.data_ptr(), ok.data_ptr(), _p(err))
    elif fn == "host_to_decimal":
        f.argtypes = [P, P, P, N, I, I, I, I, P, P, P]
        row = out.element_size() * (4 if out.dim() == 2 else 1)
        rc = f(*common, row, precision, scale, int(strip), out.data_ptr(),
               ok.data_ptr(), _p(err))
    else:
        f.argtypes = [P, P, P, N, P, P, I, P, P, P]
        pow10, steps = cast_cuda.float_tables("cpu")
        rc = f(*common, pow10.data_ptr(), steps.data_ptr(),
               int(out.dtype == torch.float32), out.data_ptr(),
               ok.data_ptr(), _p(err))
    assert rc == 0, f"{fn} declined its arguments"
    return out, ok, err


def host_to_string(lib, col, ns_op, param=0):
    """number_to_string.cu's two passes over a CPU column, as
    ops/cast_cuda.py runs them -> (offsets, chars)."""
    import ctypes

    import torch

    from spark_rapids_tpu_torch.dtypes import Kind
    from spark_rapids_tpu_torch.ops import cast_cuda
    n = col.length
    data = col.data.contiguous()
    valid = None if col.validity is None else col.validity.contiguous()
    row = data.element_size() * (4 if data.dim() == 2 else 1)
    flag = int(col.dtype.kind in (Kind.UINT8, Kind.UINT64))
    P, I, N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.host_number_to_string
    f.argtypes = [I, P, P, N, I, I, I, P, P, P, P]
    f.restype = I
    tables = cast_cuda.ryu_tables("cpu")
    lens = torch.zeros(n, dtype=torch.int32)
    args = (ns_op, data.data_ptr(), _p(valid), n, row, flag, param,
            tables.data_ptr())
    assert f(*args, lens.data_ptr(), None, None) == 0
    offsets = torch.zeros(n + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(lens, 0)
    chars = torch.zeros(max(int(offsets[-1]), 1), dtype=torch.uint8)
    assert f(*args, None, offsets.data_ptr(), chars.data_ptr()) == 0
    return offsets, chars[:int(offsets[-1])]


# golden vectors of the JAX package's cast tests, as strings: the ANSI
# corpus of tests/test_cast_string.py (the reference's cast_string.cpp)
# and the values of tests/test_float_to_string.py's golden lists; for
# the card, where the JAX tests cannot be imported
GOLDEN = [None, "+1", "-0", "4.2", "asdf", "98fe", "  00012", ".--e-37602.n",
          "\r\r\t\n11.12380", "-.2", ".3", ".", "+1.2", "\n123\n456\n",
          "1 2", "123", "1. 2", "+    7.6", "  12  ", "7.6.2", "15  ",
          "7  2  ", " 8.2  ", "3..14", "c0", "\r\r", "    ", "+\n",
          "100.0", "654321.25", "-12761.125", "0.0", "5.0", "-4.0", "NaN",
          "1.2345679E11", "-0.0", "1.1234567891234568",
          "1.234567891234568E-19", "8.395422232327942E11", "Infinity",
          "-Infinity"]
