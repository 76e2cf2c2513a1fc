"""REST front: the reference's FastAPI contract (main.py:287-357) on a
stdlib HTTP server (counterpart of ``hhrs_tpu/serve/http.py``, same routes,
status codes and bodies).

Endpoints:
  POST /recommendations   → RecommendationResponse (422 invalid, 500 internal)
  POST /recommendations/batch → 1..HTTP_BATCH_PAD requests as one bucket
  GET  /similar_items?item_id=&n=   → SimilarItemsResponse (404 unknown item)
  GET  /healthz           → liveness, the served model, latency, wrapper stats
  GET  /metrics           → Prometheus text exposition
  GET  /openapi.json      → the OpenAPI 3.1 document (serve/openapi.py)
  GET  /docs              → a self-contained explorer of that document

Requests are validated by ``serve/schemas.py`` as pydantic validates them
in the JAX package. ``create_fastapi_app`` gives the same routes as a
FastAPI app where fastapi is installed.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from hhrs_tpu_torch.serve.openapi import DOCS_HTML, openapi_json
from hhrs_tpu_torch.serve.schemas import HTTP_BATCH_PAD, RecommendationRequest, ValidationError

log = logging.getLogger(__name__)


def _prometheus_metrics(engine) -> str:
    """Prometheus text exposition of the serve-path latency histogram."""
    s = engine.latency.summary()
    lines = [
        "# TYPE hhrs_recommend_requests_total counter",
        f"hhrs_recommend_requests_total {s['count']}",
        "# TYPE hhrs_recommend_latency_ms summary",
    ]
    for q, key in ((0.5, "p50_ms"), (0.9, "p90_ms"), (0.99, "p99_ms")):
        v = s.get(key)
        if v is not None and v == v:  # skip NaN before any traffic
            lines.append(f'hhrs_recommend_latency_ms{{quantile="{q}"}} {v:.3f}')
    stats_fn = getattr(engine, "cache_stats", None)
    if stats_fn is not None:  # CachedEngine wrapper active
        cs = stats_fn()
        lines += [
            "# TYPE hhrs_response_cache_hits_total counter",
            f"hhrs_response_cache_hits_total {cs['hits']}",
            "# TYPE hhrs_response_cache_misses_total counter",
            f"hhrs_response_cache_misses_total {cs['misses']}",
            "# TYPE hhrs_response_cache_entries gauge",
            f"hhrs_response_cache_entries {cs['entries']}",
        ]
    shadow_fn = getattr(engine, "shadow_stats", None)
    if shadow_fn is not None:  # ShadowEngine wrapper active
        ss = shadow_fn()
        lines += [
            "# TYPE hhrs_shadow_compared_total counter",
            f"hhrs_shadow_compared_total {ss['compared']}",
            "# TYPE hhrs_shadow_dropped_total counter",
            f"hhrs_shadow_dropped_total {ss['dropped']}",
            "# TYPE hhrs_shadow_errors_total counter",
            f"hhrs_shadow_errors_total {ss['errors']}",
        ]
        for key, metric in (("mean_overlap", "hhrs_shadow_mean_overlap"),
                            ("top1_agreement", "hhrs_shadow_top1_agreement")):
            if ss[key] is not None:
                lines += [f"# TYPE {metric} gauge", f"{metric} {ss[key]:.6f}"]
    canary_fn = getattr(engine, "canary_stats", None)
    if canary_fn is not None:  # CanaryEngine wrapper active
        cs = canary_fn()
        lines += [
            "# TYPE hhrs_canary_fraction gauge",
            f"hhrs_canary_fraction {cs['fraction']:.6f}",
            "# TYPE hhrs_canary_requests_total counter",
            f'hhrs_canary_requests_total{{arm="primary"}} {cs["primary_served"]}',
            f'hhrs_canary_requests_total{{arm="canary"}} {cs["canary_served"]}',
            "# TYPE hhrs_canary_errors_total counter",
            f"hhrs_canary_errors_total {cs['errors']}",
        ]
    return "\n".join(lines) + "\n"


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # The headers and the body leave in two writes; with Nagle's
        # algorithm on, the body may wait for the client's delayed ACK of
        # the headers on every keep-alive request.
        disable_nagle_algorithm = True
        # Reap idle keep-alive connections: without a timeout a persistent
        # client (scraper, LB health checker) parks a non-daemon handler
        # thread in readline() forever and graceful drain can never join it.
        timeout = 30

        def log_message(self, fmt, *args):  # route through logging, not stderr
            log.debug("%s - %s", self.address_string(), fmt % args)

        # ---------------- helpers ----------------
        def _send(self, code: int, payload, content_type="application/json"):
            body = (
                payload.encode() if isinstance(payload, str) else json.dumps(payload).encode()
            )
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # ---------------- routes ----------------
        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/similar_items":
                    return self._similar_items(parse_qs(url.query))
                if url.path == "/healthz":
                    payload = {
                        "status": "ok",
                        "model": getattr(engine, "artifacts_dir", None),
                        "latency": engine.latency.summary(),
                    }
                    stats_fn = getattr(engine, "cache_stats", None)
                    if stats_fn is not None:
                        payload["cache"] = stats_fn()
                    shadow_fn = getattr(engine, "shadow_stats", None)
                    if shadow_fn is not None:
                        payload["shadow"] = shadow_fn()
                    canary_fn = getattr(engine, "canary_stats", None)
                    if canary_fn is not None:
                        payload["canary"] = canary_fn()
                    # hot-swap count (model + data reloads) when a
                    # SwappableEngine is in the stack — wrappers delegate
                    # unknown attributes down to it
                    swaps = getattr(engine, "swap_count", None)
                    if swaps is not None:
                        payload["hot_swaps"] = swaps
                    return self._send(200, payload)
                if url.path == "/metrics":
                    return self._send(200, _prometheus_metrics(engine), "text/plain; version=0.0.4")
                if url.path == "/openapi.json":
                    return self._send(200, openapi_json(HTTP_BATCH_PAD),
                                      "application/json")
                if url.path == "/docs":
                    return self._send(200, DOCS_HTML, "text/html")
                if url.path in ("/recommendations", "/recommendations/batch"):
                    # known POST route hit with GET — FastAPI answers 405
                    return self._send(405, {"detail": "Method Not Allowed"})
                return self._send(404, {"detail": "Not Found"})
            except Exception as e:  # 500 + traceback log (reference main.py:354-357)
                log.error("CRITICAL ERROR during %s request: %s", url.path, e)
                traceback.print_exc()
                return self._send(500, {"detail": "Internal server error."})

        def do_POST(self):
            url = urlparse(self.path)
            try:
                if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                    # Unsupported framing: answer 411 and drop the
                    # connection — the unread chunked body would otherwise
                    # desync every later request on this keep-alive socket.
                    self.close_connection = True
                    return self._send(411, {"detail": "Length Required"})
                try:
                    length = max(0, int(self.headers.get("Content-Length", 0)))
                except ValueError:
                    self.close_connection = True  # unread body on the socket
                    return self._send(400, {"detail": "invalid Content-Length"})
                raw = self.rfile.read(length) if length else b"{}"
                if url.path == "/recommendations":
                    try:
                        req = RecommendationRequest.model_validate_json(raw)
                    except ValidationError as ve:
                        return self._send(422, {"detail": ve.errors()})
                    result = engine.recommend(
                        req.user_id, req.city, req.type, req.lambda_param
                    )
                    return self._send(200, result)
                if url.path == "/recommendations/batch":
                    # one replay of the HTTP_BATCH_PAD bucket for the whole list
                    try:
                        body = json.loads(raw)
                        if not isinstance(body, dict) or not isinstance(
                            body.get("requests"), list
                        ):
                            return self._send(
                                422, {"detail": "body must be {'requests': [...]}"}
                            )
                        reqs = [
                            RecommendationRequest.model_validate(r)
                            for r in body["requests"]
                        ]
                    except (ValidationError, json.JSONDecodeError,
                            UnicodeDecodeError, TypeError) as ve:
                        return self._send(422, {"detail": str(ve)})
                    if not reqs or len(reqs) > HTTP_BATCH_PAD:
                        return self._send(
                            422,
                            {"detail": f"requests must have 1..{HTTP_BATCH_PAD} items"},
                        )
                    results = engine.recommend_many(
                        [(r.user_id, r.city, r.type, r.lambda_param) for r in reqs],
                        pad_to=HTTP_BATCH_PAD,
                    )
                    return self._send(200, {"responses": results})
                if url.path in ("/similar_items", "/healthz", "/metrics",
                                "/docs", "/openapi.json"):
                    # known GET route hit with POST — FastAPI answers 405
                    return self._send(405, {"detail": "Method Not Allowed"})
                return self._send(404, {"detail": "Not Found"})
            except Exception as e:
                log.error("CRITICAL ERROR during %s request: %s", url.path, e)
                traceback.print_exc()
                return self._send(500, {"detail": "Internal server error."})

        def _similar_items(self, q):
            if "item_id" not in q:
                return self._send(422, {"detail": "item_id query parameter is required"})
            try:
                item_id = int(q["item_id"][0])
                n = int(q.get("n", ["10"])[0])
            except ValueError:
                return self._send(422, {"detail": "item_id and n must be integers"})
            if not 1 <= n <= 50:
                return self._send(422, {"detail": "n must be in [1, 50]"})
            ids = engine.similar_items(item_id, n)
            if ids is None:
                return self._send(404, {"detail": f"Hotel with ID {item_id} not found."})
            return self._send(200, {"similar_item_ids": ids})

    return Handler


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with a real accept backlog: socketserver's
    default of 5 drops the SYNs of a burst of new connections, and each
    dropped client retries after about a second."""

    request_queue_size = 128


def make_server(engine, host: str = "0.0.0.0", port: int = 8000) -> _Server:
    """A threaded server of ``engine`` bound to ``(host, port)`` (port 0
    picks a free one: ``server.server_address[1]``), not yet serving."""
    return _Server((host, port), make_handler(engine))


def serve_forever(engine, host: str = "0.0.0.0", port: int = 8000):
    server = make_server(engine, host, port)
    # Graceful drain: SIGTERM/SIGINT stop accepting, in-flight handlers
    # finish (non-daemon threads joined by server_close), then exit 0.
    server.daemon_threads = False

    def _drain(signum, frame):
        log.info("signal %d: draining in-flight requests and shutting down", signum)
        threading.Thread(target=server.shutdown, daemon=True).start()
        # A second signal must kill, not re-drain: restore the default
        # disposition so a stuck drain is still operator-stoppable.
        signal.signal(signum, signal.SIG_DFL)

    try:
        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    except ValueError:  # not the main thread (embedded use) — no handlers
        pass
    log.info("serving on %s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        close = getattr(engine, "close", None)
        if callable(close):
            close()  # stop the batcher's worker, free the engines' CUDA graphs
        log.info("shutdown complete")


def create_fastapi_app(engine):
    """Optional FastAPI front with the same contract (requires fastapi)."""
    from fastapi import Body, FastAPI, HTTPException, Query
    from fastapi.responses import JSONResponse

    app = FastAPI(title="Hybrid Recommendation API (TPU-native)", version="1.0")

    @app.get("/similar_items")
    def similar_items(item_id: int = Query(...), n: int = Query(10, ge=1, le=50)):
        ids = engine.similar_items(item_id, n)
        if ids is None:
            raise HTTPException(status_code=404, detail=f"Hotel with ID {item_id} not found.")
        return {"similar_item_ids": ids}

    @app.post("/recommendations")
    def recommendations(body=Body(...)):
        try:
            req = RecommendationRequest.model_validate(body)
        except ValidationError as ve:
            return JSONResponse(status_code=422, content={"detail": ve.errors()})
        try:
            return engine.recommend(req.user_id, req.city, req.type, req.lambda_param)
        except Exception as e:
            log.error("CRITICAL ERROR during /recommendations request: %s", e)
            traceback.print_exc()
            raise HTTPException(status_code=500, detail="Internal server error.")

    return app
