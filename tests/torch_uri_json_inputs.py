"""Inputs shared by the port's parse_uri, from_json and bloom filter tests
and `chip_smoke.py`: URI, JSON and INT64 corpora made from seeds with
numpy, and the kernels' row code run through their host builds. Imports
neither JAX nor the JAX package."""
import ast
import ctypes
import json
import pathlib

import numpy as np
import torch

_TESTS = pathlib.Path(__file__).resolve().parent


def uri_suites():
    """The JAX tests' URI suites (SPARK_DATA, UTF8_DATA, IP4_DATA,
    IP6_DATA: the reference's ParseURITest.java data), read from
    tests/test_parse_uri.py's source, which imports the JAX package."""
    tree = ast.parse((_TESTS / "test_parse_uri.py").read_text())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", "")
            if name in ("SPARK_DATA", "UTF8_DATA", "IP4_DATA", "IP6_DATA"):
                found[name] = ast.literal_eval(node.value)
    return [u for k in ("SPARK_DATA", "UTF8_DATA", "IP4_DATA", "IP6_DATA")
            for u in found[k]]


# the JAX fuzz test's alphabet (tests/test_parse_uri.py test_fuzz_vs_oracle)
# and the bytes the tests add: NUL, bytes from 0x80, control and space
# characters, escapes, long runs
_URI_ALPHA = [c.encode() for c in
              "abc019.:/?#@[]%&=+-_~!$'()*,;^| \\éú✪"] + [
    b"%20", b"%zz", b"::", b"//", b"http://", b"a.b", b"1.2.3.4", b"[::1]",
    b":8080", b"\x00", b"\x80", b"\xc2\xa0", b"\xe2\x80\xa8", b"\xff",
    b"\r", b"\t", b"\n", b"%4E", b"q=1&", b"?a=b", b"&", b"=", b"[", b"]",
    b"\xed\xa0\x80", b"\xf0\x9f\x98\x80", b"255.", b"256.", b"%", b"::ffff"]
_URI_HEADS = [b"", b"http://", b"https://[", b"https://", b"//", b"ftp:",
              b"http://user@", b"http://[::1]:"]

URI_EDGE = [None, b"", b" ", b"\x00", b"http://a\x00b.com/",
            b"http://a.com/\x80",
            b"http://a.com/?q=\r", b"http:// a.com", b"http://a.com:8080",
            b"http://a.com:", b"http://a.com:x", b"http://a..com",
            b"http://-a.com", b"http://a-.com", b"http://a.com.",
            b"http://1a.com", b"http://a.1com", b"http://1.2.3.4.",
            b"http://01.002.3.255/", b"http://1.2.3.256/", b"http://[::]/",
            b"http://[::1%25eth0]/", b"http://[1:2:3:4:5:6:7:8:9]/",
            b"http://[1::2::3]/", b"http://[::1.2.3.4]/",
            b"http://[1.2.3.4::]/",
            b"http://[:1]/", b"http://[1:]/", b"http://[]/", b"http://[::1]x/",
            b"http://[::1]:80/", b"http://[::1]:8a/", b"mailto:a@b.com",
            b"a:b", b":a", b"a:", b"a:/", b"/a?b#c", b"?x=1", b"#f",
            b"http://a.com/%", b"http://a.com/%4", b"http://a.com/%4g",
            b"http://h/?a=1&a=2&=3&b", b"http://h/?&a=1", b"http://h/?a",
            b"http://h/?a=b=c&d=e", b"http://h/p?x=1#y=2",
            b"http://h/" + b"p" * 300 + b"?k=" + b"v" * 40,
            b"https://" + b"a" * 63 + b"." + b"b" * 200 + b".com/?q=1"]


def fuzz_uris(seed, n):
    """n URIs: a head and 0-14 pieces of the alphabet, one row in 20 with
    a long run, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = [_URI_HEADS[rng.integers(len(_URI_HEADS))]]
        parts += [_URI_ALPHA[i] for i in
                  rng.integers(0, len(_URI_ALPHA), int(rng.integers(0, 15)))]
        if rng.random() < 0.05:
            parts.insert(int(rng.integers(1, len(parts) + 1)),
                         b"x" * int(rng.integers(200, 320)))
        out.append(b"".join(parts))
    return out


def uri_corpus(seed=7, n=1200):
    """The JAX suites, the edge rows and n fuzzed rows, as bytes/None."""
    return ([u if u is None else u.encode() for u in uri_suites()]
            + URI_EDGE + fuzz_uris(seed, n))


def uri_params(seed, n):
    """A parameter a row for the column form: keys the corpus holds, '',
    a key with '=', and None."""
    rng = np.random.default_rng(seed)
    pool = [b"a", b"", b"q", b"query", None, b"b", b"a=b", b"k", b"x",
            b"param4", b"=", b"\x00"]
    return [pool[i] for i in rng.integers(0, len(pool), n)]


# ---- JSON ------------------------------------------------------------------

JSON_GOLDEN = [
    '{"Zipcode" : 704 , "ZipCodeType" : "STANDARD" , "City" : "PARC'
    ' PARQUE" , "State" : "PR"}',
    "{}", None,
    '{"category": "reference", "index": [4,{},null,{"a":[{ }, {}] } ], '
    '"author": "Nigel Rees", "title": "{}[], <=semantic-symbols-string", '
    '"price": 8.95}',
    '{"Zipcóde" : 704 , "ZípCodeTypé" : "\U00029e3d" , "City" : '
    '"\U0001F3F3" , "Stâte" : "\U0001F3F3"}',
    '{"a\\"b": "c\\nd", "e": "f\\\\"}',
    '{"a": {"x": [1, 2]}, "b": [ {"y": ":,"} ], "c": null, "d": true}',
    '{"k": 1, "k": 2}', "", "   ", "[1,2]", '"str"', "42", '{"a":1}',
]

JSON_EDGE = [
    '{"a":"x":"y", "b"}', '{"a":}', '{ "a" : "" , "b":"\\""}',
    '\t{"a": {"b": {"c": {"d": {"e": {"f": {"g": {"h": 1}}}}}}}}\r\n',
    '{"a": 1]', '{"a": "\x00\x80"}', '{"": ""}', '{"a": []}', '{"a": {}}',
    '{"a":{"b":[1,{"c":"}"}]}}', '{"q": "\\\\"}', '{"s": "a,b:c"}',
    '{"x":1}  ', '  {"x": 1 }', '{"a": "' + "v" * 300 + '"}', "\n", "{ }",
    '{"a": [1, 2], "b": {"c": [3, {"d": 4}]}}', '{"a": "\\u00e9"}',
]


def json_value(rng, depth):
    """A random JSON value at nesting level `depth` (containers to 8)."""
    kind = int(rng.integers(0, 7 if depth < 8 else 4))
    if kind == 0:
        return int(rng.integers(-10**6, 10**6))
    if kind == 1:
        return [True, False, None][int(rng.integers(3))]
    if kind == 2:
        return round(float(rng.uniform(-1e3, 1e3)), 3)
    if kind == 3:
        alpha = 'abc {}[]:,"\\é'
        return "".join(alpha[i] for i in
                       rng.integers(0, len(alpha), int(rng.integers(0, 10))))
    if kind == 4:
        return [json_value(rng, depth + 1)
                for _ in range(int(rng.integers(0, 3)))]
    return {f"n{i}": json_value(rng, depth + 1)
            for i in range(int(rng.integers(0, 3)))}


def json_objects(seed, n, max_pairs=8):
    """n JSON objects of 1-max_pairs pairs with nested values (to 8
    levels), some keys repeated, printed compact or indented."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, max_pairs + 1))
        pairs = [(f"k{int(rng.integers(0, 12))}", json_value(rng, 1))
                 for _ in range(k)]
        sep = [(", ", ": "), (",", ":"), (" , ", " : ")][int(rng.integers(3))]
        body = sep[0].join(json.dumps(key) + sep[1] + json.dumps(v)
                           for key, v in pairs)
        out.append("{" + body + "}")
    return out


def json_corpus(seed=11, n=600):
    return JSON_GOLDEN + JSON_EDGE + json_objects(seed, n)


def int64_values(seed, n, null_p=0.1):
    """(values, validity) numpy arrays: random INT64 over the whole range
    with a few edge values, and nulls."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    v[:6] = [0, -1, 1, 2**63 - 1, -2**63, 42][:min(6, n)]
    return v, rng.random(n) >= null_p


# ---- the kernels' row code through their host builds ------------------------

_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _ptr(t):
    return None if t is None else t.data_ptr()


def _buffers(col):
    from spark_rapids_tpu_torch.ops.cast_cuda import string_buffers
    return string_buffers(col)


def host_parse(lib, col, op, literal=None, params=None):
    """parse_uri.cu's two passes over a CPU column, as
    ops/parse_uri_cuda.py runs them -> a STRING column."""
    from spark_rapids_tpu_torch.columnar import make_string_column
    lib.host_spans.argtypes = [_I, _P, _P, _P, _N, _P, _P, _P, _I, _I, _P, _P,
                               _P]
    lib.host_copy.argtypes = [_P, _P, _P, _N, _P]
    offsets, chars, valid = _buffers(col)
    n = col.length
    start, length = (torch.zeros(n, dtype=torch.int32) for _ in range(2))
    out_valid = torch.zeros(n, dtype=torch.bool)
    p_off = p_chars = p_valid = None
    p_len = nonempty = 0
    if params is not None:
        p_off, p_chars, p_valid = _buffers(params)
    elif literal is not None:
        raw = literal.encode()
        p_chars = torch.tensor(list(raw) or [0], dtype=torch.uint8)
        p_len, nonempty = len(raw), 1
    code = {"protocol": 0, "host": 1, "query": 2}.get(op, 3)
    assert lib.host_spans(code, offsets.data_ptr(), chars.data_ptr(),
                          _ptr(valid), n, _ptr(p_off), _ptr(p_chars),
                          _ptr(p_valid), p_len, nonempty, start.data_ptr(),
                          length.data_ptr(), out_valid.data_ptr()) == 0
    lens = length if valid is None else torch.where(valid, length, 0)
    out_offsets = torch.zeros(n + 1, dtype=torch.int32)
    out_offsets[1:] = torch.cumsum(lens, 0)
    out = torch.zeros(max(int(out_offsets[-1]), 1), dtype=torch.uint8)
    assert lib.host_copy(chars.data_ptr(), start.data_ptr(),
                         out_offsets.data_ptr(), n, out.data_ptr()) == 0
    return make_string_column(out[:int(out_offsets[-1])], out_offsets,
                              out_valid)


def host_json_rows(lib, col):
    """map_utils.cu's first pass over a CPU column -> (err, valid_out,
    pairs, key_bytes, value_bytes)."""
    lib.host_rows.argtypes = [_P, _P, _P, _N, _P, _P, _P, _P, _P]
    offsets, chars, valid = _buffers(col)
    n = col.length
    err = torch.zeros(n, dtype=torch.uint8)
    valid_out = torch.zeros(n, dtype=torch.bool)
    counts = [torch.zeros(n, dtype=torch.int32) for _ in range(3)]
    assert lib.host_rows(offsets.data_ptr(), chars.data_ptr(), _ptr(valid), n,
                         err.data_ptr(), valid_out.data_ptr(),
                         *(c.data_ptr() for c in counts)) == 0
    return (err, valid_out, *counts)


def host_json_pairs(lib, col, pairs, key_bytes, value_bytes):
    """map_utils.cu's second pass -> ((key offsets, chars), (value
    offsets, chars))."""
    lib.host_pairs.argtypes = [_P, _P, _N, _P, _P, _P, _P, _P, _P, _P]
    offsets, chars, _ = _buffers(col)

    def scan(x):
        out = torch.zeros(x.shape[0] + 1, dtype=torch.int64)
        out[1:] = torch.cumsum(x, 0)
        return out
    ps, ks, vs = scan(pairs), scan(key_bytes), scan(value_bytes)
    total = int(ps[-1])
    ko, vo = (torch.zeros(total + 1, dtype=torch.int32) for _ in range(2))
    kc = torch.zeros(int(ks[-1]) + 1, dtype=torch.uint8)
    vc = torch.zeros(int(vs[-1]) + 1, dtype=torch.uint8)
    assert lib.host_pairs(offsets.data_ptr(), chars.data_ptr(), col.length,
                          ps.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                          ko.data_ptr(), vo.data_ptr(), kc.data_ptr(),
                          vc.data_ptr()) == 0
    return (ko, kc[:-1]), (vo, vc[:-1])


def host_bloom(lib, fn, data, *args):
    """bloom_filter.cu's host loops: "put" (validity, num_hashes, words,
    in place), "probe" (num_hashes, words) -> found, "indexes"
    (num_hashes, num_longs) -> (n, k) int64."""
    n = data.shape[0]
    if fn == "put":
        valid, k, words = args
        lib.host_put.argtypes = [_P, _P, _N, _I, _N, _P]
        assert lib.host_put(data.data_ptr(), _ptr(valid), n, k, words.numel(),
                            words.data_ptr()) == 0
        return words
    if fn == "probe":
        k, words = args
        found = torch.zeros(n, dtype=torch.bool)
        lib.host_probe.argtypes = [_P, _N, _I, _N, _P, _P]
        assert lib.host_probe(data.data_ptr(), n, k, words.numel(),
                              words.data_ptr(), found.data_ptr()) == 0
        return found
    k, num_longs = args
    out = torch.zeros((n, k), dtype=torch.int64)
    lib.host_indexes.argtypes = [_P, _N, _I, _N, _P]
    assert lib.host_indexes(data.data_ptr(), n, k, num_longs,
                            out.data_ptr()) == 0
    return out
