"""HTTP parity: the port's server (``hhrs_tpu_torch/serve/http.py`` on the
port's engine, on the CPU) against the JAX package's server on the same
artifact (hpo_r5) and data, side by side on ``127.0.0.1``.

Every request case of ``tests/test_serve.py``'s and ``tests/test_openapi.py``'s
HTTP tests goes to both servers. 200, 404 and 405 bodies must be equal
JSON; a 422 from ``/recommendations`` must list the same ``(type, loc)``
errors (the message text may differ); a 422 from ``/recommendations/batch``
must have the same status. ``/openapi.json`` parses to the same object and
``/docs`` is the same bytes; ``/metrics`` and ``/healthz`` have the same
keys and counts after the same traffic. The request validator is held to
pydantic's ``RecommendationRequest`` over generated JSON values.
"""

from __future__ import annotations

import json
import math
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import jsonschema
import pydantic
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hhrs_tpu.serve import http as jax_http
from hhrs_tpu.serve import openapi as jax_openapi
from hhrs_tpu.serve.engine import RecommendationEngine as JaxEngine
from hhrs_tpu.serve.schemas import RecommendationRequest as PydanticRequest
from hhrs_tpu_torch.serve import http as port_http
from hhrs_tpu_torch.serve import openapi as port_openapi
from hhrs_tpu_torch.serve import schemas
from hhrs_tpu_torch.serve.engine import RecommendationEngine
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = str(REPO / "benchmarks/results/hpo_r5/best")
DATA = str(REPO / "data")


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def servers(one_torch_thread):  # noqa: F811
    je = JaxEngine.from_dirs(ARTIFACT, DATA)
    te = RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu")
    jax_server, jax_base = _serve(ThreadingHTTPServer(("127.0.0.1", 0), jax_http.make_handler(je)))
    port_server, port_base = _serve(port_http.make_server(te, "127.0.0.1", 0))
    yield {"jax": jax_base, "port": port_base, "engine": te}
    for s in (jax_server, port_server):
        s.shutdown()
        s.server_close()


def _call(url, payload=None, method=None, raw: bytes | None = None):
    data = raw if raw is not None else (json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data is not None else {})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def both(servers, path, payload=None, method=None, raw=None):
    """(jax, port): each ``(status, content type, body bytes)``."""
    return tuple(_call(servers[k] + path, payload, method, raw) for k in ("jax", "port"))


def assert_same(servers, path, payload=None, method=None, raw=None) -> int:
    """Equal status, content type and JSON body (for a 422 from
    /recommendations: the same (type, loc) list; from the batch route: the
    status). Returns the status."""
    (sj, cj, bj), (sp, cp, bp) = both(servers, path, payload, method, raw)
    assert (sj, cj) == (sp, cp), (path, payload, sj, sp)
    if sj == 422 and path == "/recommendations":
        key = lambda body: [(e["type"], tuple(e["loc"])) for e in json.loads(body)["detail"]]  # noqa: E731
        assert key(bp) == key(bj), (payload, raw)
    elif sj == 422 and path == "/recommendations/batch":
        assert "detail" in json.loads(bp)
    else:
        assert json.loads(bp) == json.loads(bj), (path, payload)
    return sj


def _sweep(te, n=12):
    uni = te.gen.universe
    return [{"user_id": int(uni.user_ids[i % uni.n_users]), "city": uni.cities[i % len(uni.cities)],
             "type": ("friends", "personal")[i % 2], "lambda_param": (0.7, 1.0, 0.0, 0.3)[i % 4]}
            for i in range(n)]


def test_recommendations_equal(servers):
    te = servers["engine"]
    for body in _sweep(te) + [{"user_id": 424242, "city": "Atlantis"},
                              {"user_id": "15", "city": te.gen.universe.cities[0], "lambda_param": "0.5"}]:
        assert assert_same(servers, "/recommendations", body) == 200


@pytest.mark.parametrize("body", [
    {"user_id": 1, "city": "X", "lambda_param": 2.0},
    {"city": "X"},
    {"user_id": "not-an-int"},
    {"user_id": 15.5, "city": 3, "type": None, "lambda_param": -1},
    {"user_id": True, "city": "X", "lambda_param": float("nan")},
    [],
    "x",
])
def test_validation_errors_equal(servers, body):
    assert assert_same(servers, "/recommendations", body) in (200, 422)


@pytest.mark.parametrize("raw", [b"", b"{", b"[1]", b'{"user_id": 1, "city": "\\ud800"}',
                                 b'\xef\xbb\xbf{"user_id": 1, "city": "X"}', b'{"user_id": 01}'])
def test_invalid_json_bodies_equal(servers, raw):
    assert assert_same(servers, "/recommendations", raw=raw) == 422


def test_body_that_is_not_utf8():
    """A body that is not UTF-8 is a json_invalid 422 from the port. The
    JAX server answers it 500: pydantic cannot serialize the raw bytes it
    puts in the error's input (``ValidationError.json()`` raises)."""
    with pytest.raises(schemas.ValidationError) as e:
        schemas.RecommendationRequest.model_validate_json(b"\xff")
    assert [(x["type"], x["loc"]) for x in e.value.errors()] == [("json_invalid", [])]
    with pytest.raises(pydantic.ValidationError) as e:
        PydanticRequest.model_validate_json(b"\xff")
    assert [(x["type"], x["loc"]) for x in e.value.errors()] == [("json_invalid", ())]
    with pytest.raises(ValueError, match="serializing"):
        e.value.json()


@pytest.mark.parametrize("method,path", [
    ("GET", "/recommendations"), ("GET", "/recommendations/batch"), ("POST", "/similar_items"),
    ("POST", "/healthz"), ("POST", "/metrics"), ("POST", "/docs"), ("POST", "/openapi.json"),
    ("GET", "/nope"), ("POST", "/nope"),
])
def test_method_not_allowed_and_not_found(servers, method, path):
    want = 404 if path == "/nope" else 405
    assert assert_same(servers, path, {} if method == "POST" else None, method=method) == want


def test_similar_items_equal(servers):
    te = servers["engine"]
    some_item = int(next(iter(te.bundle.preproc.item_id_mapping)))
    for query, want in ((f"item_id={some_item}&n=3", 200), (f"item_id={some_item}", 200),
                        ("item_id=999999999&n=3", 404), (f"item_id={some_item}&n=99", 422),
                        ("", 422), ("item_id=abc", 422), (f"item_id={some_item}&n=0", 422)):
        assert assert_same(servers, "/similar_items?" + query) == want, query


def test_concurrent_requests(servers):
    """16 concurrent clients against each server: all 200, identical
    rankings for identical requests, and the port's equal to the JAX ones."""
    te = servers["engine"]
    uni = te.gen.universe
    payload = {"user_id": int(uni.user_ids[0]), "city": uni.cities[0], "type": "friends", "lambda_param": 0.7}
    similar = f"/similar_items?item_id={int(uni.item_ids[0])}&n=5"
    bodies = {}
    for side in ("jax", "port"):
        def hit(i, base=servers[side]):
            return _call(base + similar) if i % 4 == 3 else _call(base + "/recommendations", payload)

        with ThreadPoolExecutor(max_workers=16) as ex:
            results = list(ex.map(hit, range(32)))
        assert all(status == 200 for status, _, _ in results), side
        bodies[side] = [json.loads(b) for _, _, b in results]
    assert bodies["port"] == bodies["jax"]
    recs = [b for i, b in enumerate(bodies["port"]) if i % 4 != 3]
    assert all(b == recs[0] for b in recs)


def test_batch_endpoint_equal(servers):
    te = servers["engine"]
    reqs = _sweep(te, 3)
    assert assert_same(servers, "/recommendations/batch", {"requests": reqs}) == 200
    _, (_, _, body) = both(servers, "/recommendations/batch", {"requests": reqs})
    singles = [json.loads(both(servers, "/recommendations", r)[1][2]) for r in reqs]
    assert json.loads(body)["responses"] == singles
    assert assert_same(servers, "/recommendations/batch", {"requests": _sweep(te, 64)}) == 200


@pytest.mark.parametrize("body", [
    {"requests": []}, {"requests": [{"user_id": "x"}]}, [], None, "hi", {"requests": 5},
    {"requests": "x"}, {"requests": [{"user_id": 1, "city": "X"}] * 65},
])
def test_batch_endpoint_rejections_equal(servers, body):
    assert assert_same(servers, "/recommendations/batch", raw=json.dumps(body).encode()) == 422


def test_openapi_and_docs_equal(servers):
    (sj, cj, bj), (sp, cp, bp) = both(servers, "/openapi.json")
    assert sj == sp == 200 and cj == cp == "application/json"
    assert json.loads(bp) == json.loads(bj) == jax_openapi.build_openapi_spec()
    assert json.loads(port_openapi.openapi_json(64)) == json.loads(jax_openapi.openapi_json(64))
    (sj, cj, bj), (sp, cp, bp) = both(servers, "/docs")
    assert (sj, cj) == (sp, cp) == (200, "text/html") and bp == bj
    assert port_openapi.DOCS_HTML == jax_openapi.DOCS_HTML


def test_responses_match_the_published_schemas(servers):
    """The port's bodies validate against its own /openapi.json (the
    checks of tests/test_openapi.py)."""
    spec = json.loads(_call(servers["port"] + "/openapi.json")[2])
    defs = {"$defs": spec["components"]["schemas"]}

    def validate(path, method, code, instance):
        schema = spec["paths"][path][method]["responses"][str(code)]["content"]["application/json"]["schema"]
        text = json.dumps(dict(schema, **defs)).replace("#/components/schemas/", "#/$defs/")
        jsonschema.validate(instance=instance, schema=json.loads(text))

    te = servers["engine"]
    req = _sweep(te, 1)[0]
    item = int(next(iter(te.bundle.preproc.item_id_mapping)))
    for path, method, payload, code in (
            ("/recommendations", "post", req, 200),
            ("/recommendations", "post", {"user_id": "not-an-int"}, 422),
            ("/recommendations/batch", "post", {"requests": [req, req]}, 200),
            (f"/similar_items?item_id={item}&n=5", "get", None, 200),
            ("/similar_items?item_id=99999999", "get", None, 404),
            ("/healthz", "get", None, 200)):
        for status, _, body in both(servers, path, payload):  # the JAX server's too, to keep the counts equal
            assert status == code, path
            validate(path.split("?")[0], method, code, json.loads(body))
    html = _call(servers["port"] + "/docs")[2].decode()
    assert "/openapi.json" in html and "https://" not in html and "//cdn" not in html


def test_metrics_and_healthz_agree_after_the_same_traffic(servers):
    """Every earlier test sent each request to both servers, so their
    counts must agree (latencies differ)."""
    te = servers["engine"]
    assert_same(servers, "/recommendations", _sweep(te, 1)[0])
    (_, _, hj), (_, _, hp) = both(servers, "/healthz")
    hj, hp = json.loads(hj), json.loads(hp)
    assert set(hj) == set(hp) and set(hj["latency"]) == set(hp["latency"])
    assert hp["latency"]["count"] == hj["latency"]["count"] > 0
    assert hp["model"] == hj["model"] == ARTIFACT and hp["status"] == "ok"
    (_, cj, mj), (_, cp, mp) = both(servers, "/metrics")
    assert cj == cp == "text/plain; version=0.0.4"
    keys = lambda text: [line.rsplit(" ", 1)[0] for line in text.decode().splitlines()]  # noqa: E731
    assert keys(mp) == keys(mj)
    count = lambda text: [line for line in text.decode().splitlines()  # noqa: E731
                          if line.startswith("hhrs_recommend_requests_total")]
    assert count(mp) == count(mj) == [f"hhrs_recommend_requests_total {hp['latency']['count']}"]


def test_handler_sends_without_nagle_delay():
    """Headers and body leave in two writes: with Nagle's algorithm on, a
    keep-alive client may wait for its own delayed ACK on every request."""
    assert port_http.make_handler(object()).disable_nagle_algorithm is True


def test_fastapi_app_has_the_routes():
    pytest.importorskip("fastapi")
    app = port_http.create_fastapi_app(object())
    assert {"/similar_items", "/recommendations"} <= {r.path for r in app.routes}


# ---------------------------------------------------------------------------
# The validator against pydantic
# ---------------------------------------------------------------------------

_WS = "\t\n\x0b\x0c\r \x85\xa0 　\x1c"
_numchars = st.sampled_from(list("0123456789" * 3) + list("_.eE+- ") + list(_WS) + ["inf", "nan", "infinity", "١"])
_strings = st.one_of(
    st.lists(_numchars, max_size=14).map("".join),
    st.text(max_size=8),
    st.builds(lambda n, pre, post: pre + "1" * n + post, st.integers(4295, 4305),
              st.sampled_from(["", "-", "+", " ", "0", "-0"]), st.sampled_from(["", ".0", "_1", " ", ".5"])),
    st.sampled_from(["nan", "-inf", "Infinity", "1e400", "0.5", "15.0", "1_000", "9223372036854775808"]),
)
_floats = st.one_of(st.floats(), st.sampled_from([2.0 ** 63, -2.0 ** 63, 2.0 ** 63 - 1024, 1e300, -0.0]))
_ints = st.one_of(st.integers(), st.integers(-(2 ** 1100), 2 ** 1100),
                  st.sampled_from([2 ** 1024, -(2 ** 1024), 2 ** 1024 - 2 ** 970, 2 ** 1024 - 2 ** 971]))
_scalars = st.one_of(_ints, _floats, st.booleans(), st.none(), _strings)
_values = st.recursive(_scalars, lambda c: st.one_of(st.lists(c, max_size=3),
                                                    st.dictionaries(st.text(max_size=3), c, max_size=3)),
                       max_leaves=5)
_bodies = st.one_of(st.dictionaries(st.sampled_from(["user_id", "city", "type", "lambda_param", "x"]),
                                    _values, max_size=5), _values)
_JSON_TOKENS = [b"{", b"}", b"[", b"]", b'"user_id"', b'"city"', b'"lambda_param"', b":", b",", b'"X"', b"0",
                b"1", b"-", b".", b"e", b"+", b"NaN", b"Infinity", b"-Infinity", b"true", b"null", b'"\\ud800"',
                b'"\\ud83d\\ude00"', b" ", b"\x00", b"\xff", b"\xc3\xa9", b'"15"', b'"a\x01"', b"00"]


def _outcome(validate, error_type, value):
    """("ok", typed values) or ("error", [(type, loc), …])."""
    try:
        r = validate(value)
    except error_type as e:
        return "error", [(x["type"], tuple(x["loc"])) for x in e.errors()]
    return "ok", [(type(x).__name__, repr(x)) for x in (r.user_id, r.city, r.type, r.lambda_param)]


def _check(value, json_mode: bool):
    name = "model_validate_json" if json_mode else "model_validate"
    want = _outcome(getattr(PydanticRequest, name), pydantic.ValidationError, value)
    got = _outcome(getattr(schemas.RecommendationRequest, name), schemas.ValidationError, value)
    assert got == want, (repr(value)[:200], got, want)


@settings(max_examples=600, deadline=None, suppress_health_check=list(HealthCheck))
@given(_bodies)
def test_validator_matches_pydantic_on_values(value):
    _check(value, json_mode=False)


@settings(max_examples=600, deadline=None, suppress_health_check=list(HealthCheck))
@given(_bodies, st.sampled_from(["", "ws", "bom", "trail", "cut", "esc"]), st.integers(0, 200))
def test_validator_matches_pydantic_on_json_bodies(value, mutation, k):
    try:
        raw = json.dumps(value).encode()
    except (ValueError, OverflowError):
        return
    raw = {"": raw, "ws": b" \n" + raw + b"\t\r", "bom": b"\xef\xbb\xbf" + raw, "trail": raw + b" x",
           "cut": raw[:k % (len(raw) + 1)], "esc": raw.replace(b'"', b'"\\ud800', 1)}[mutation]
    _check(raw, json_mode=True)


@settings(max_examples=600, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.lists(st.sampled_from(_JSON_TOKENS), max_size=20))
def test_validator_matches_pydantic_on_token_soup(parts):
    _check(b"".join(parts), json_mode=True)


@pytest.mark.parametrize("value,json_mode", [
    ({"user_id": "15", "city": "X"}, False), ({"user_id": 15.0, "city": "X"}, False),
    ({"user_id": True, "city": "X"}, False), ({"user_id": 1, "city": "X", "lambda_param": "0.5"}, False),
    ({"user_id": 1, "city": "X", "lambda_param": math.nan}, False),
    ({"user_id": 1, "city": "X", "lambda_param": 10 ** 400}, False),
    (b'{"user_id": 1, "city": "X", "lambda_param": 1' + b"0" * 400 + b"}", True),
    (b'{"user_id": 1, "city": "X", "z": ' + b"[" * 201 + b"]" * 201 + b"}", True),
    (b'{"user_id": 1, "city": "X", "z": ' + b"[" * 200 + b"]" * 200 + b"}", True),
    (b'{"user_id": ' + b"1" * 4301 + b', "city": "X"}', True),
    ({"user_id": "+" + "1" * 4300, "city": "X"}, False), ({"user_id": " " + "1" * 4301, "city": "X"}, False),
])
def test_validator_matches_pydantic_on_corners(value, json_mode):
    """Lax coercion's corners: numeric strings, integral floats, bools,
    NaN, integers beyond float range, nesting depth, digit limits."""
    _check(value, json_mode)
