"""ModelServer: stdlib HTTP front end for the serving stack.

Counterpart of ``mxnet_tpu/serving/server.py``: ``/predict`` over a
``DynamicBatcher`` over an ``InferenceEngine`` (``ModelServer(model)``,
where ``model`` is an engine or anything an engine takes), and
``/generate`` over a ``GenerationScheduler`` (``generator=``); a server
may carry both. Endpoints (JSON):

- ``POST /predict``: body ``{"data": [...]}`` (one sample, no batch axis)
  or ``{"inputs": [[...], ...]}`` for a model of several inputs; optional
  ``"dtype"`` (default float32) and ``"timeout_ms"``. The reply is
  ``{"output": [...]}``, or ``{"outputs": [...]}`` for a model of several
  outputs. Failures: malformed body 400, ``ServerBusy``/``ServerClosed``/
  draining 503 (with ``Retry-After``), queue ``DeadlineExceeded`` 504, a
  model fault 500, a body over ``MXNET_HTTP_MAX_BODY`` 413.

- ``POST /generate``: body ``{"prompt": [token ids], "max_new_tokens": n,
  "temperature": t, "eos_id": id, "timeout_ms": ms, "stream": true}``.
  With ``stream`` (default) the reply is ``Transfer-Encoding: chunked``
  NDJSON, one ``{"token", "index"}`` line per generated token as the
  scheduler produces it, closed by a ``{"done": true, "reason", "n_tokens"}``
  line. ``stream=false`` returns ``{"tokens": [...], "reason": ...}``.
  Failures before the first token keep typed codes: malformed body or
  prompt 400, ``ServerBusy``/``ServerClosed``/draining 503 (with
  ``Retry-After``), queue ``DeadlineExceeded`` 504, a model fault 500. A
  fault after the first token becomes an in-band ``{"error": ...}`` line.
- ``GET /healthz``: ``{"status": "ok"}``; ``"degraded"`` with the
  breaker's snapshot while the circuit breaker is open or half-open;
  ``"draining"`` during shutdown.
- ``GET /metrics``: with ``/predict``, ``ServingMetrics.snapshot()``
  (QPS, latency percentiles, occupancy, queue depth, and the
  ``executor_cache`` gauge: the engine's CachedOp counters); with
  ``/generate``, the scheduler's stats and its
  ``GenerationMetrics.snapshot()`` under ``"generation"`` (its
  ``"compile"`` block: the generation programs' CachedOp counts); and
  the ``"breaker"``, ``"retry"`` and ``"datafeed"`` (every live
  ``DeviceFeed``'s counters) gauges.

Model faults feed a :class:`~mxnet_tpu_torch.resilience.CircuitBreaker`;
while it is open, ``/predict`` and ``/generate`` fast-fail with 503 +
``Retry-After`` instead of queueing doomed work. Backpressure, drain and
queue expiry are not faults and leave it alone.

The fleet routes (``/predict/<model>``, ROADMAP Queue A item 12),
telemetry and the gateway are not ported.
"""
from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from .. import config as _config
from ..resilience import retry as _retry
from ..resilience.breaker import CircuitBreaker
from .batcher import (DeadlineExceeded, DynamicBatcher, ServerBusy,
                      ServerClosed, ServingError)
from .engine import DEFAULT_BUCKETS, InferenceEngine
from .metrics import ServingMetrics

__all__ = ["ModelServer"]


def _tolist(row):
    """A reply row as JSON numbers (bfloat16 through float32)."""
    row = _np.asarray(row)
    if row.dtype.name == "bfloat16":
        row = row.astype(_np.float32)
    return row.tolist()


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet_tpu_torch_serving/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: /metrics replaces access logs
        pass

    def _reply(self, code, payload, headers=None):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        rid = getattr(self, "_request_id", None)
        if rid is not None:
            self.send_header("X-Request-Id", rid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        self._request_id = None
        srv = self.server.model_server
        path = self.path.partition("?")[0]
        if path == "/healthz":
            self._reply(200, srv.health())
        elif path == "/metrics":
            self._reply(200, srv.metrics_snapshot())
        else:
            self._reply(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):  # noqa: N802
        rid = self.headers.get("X-Request-Id") or uuid.uuid4().hex[:16]
        self._request_id = rid
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length < 0:
                raise ValueError("negative Content-Length")
        except (TypeError, ValueError):
            self.close_connection = True
            self._reply(400, {"error": "bad Content-Length"})
            return
        max_body = _config.get("MXNET_HTTP_MAX_BODY")
        if 0 < max_body < length:
            self.close_connection = True
            self._reply(413, {"error": "request body %d bytes exceeds "
                                       "MXNET_HTTP_MAX_BODY=%d"
                                       % (length, max_body)})
            return
        body = self.rfile.read(length)
        path = self.path.partition("?")[0]
        srv = self.server.model_server
        if path == "/generate" and srv.generator is not None:
            self._handle_generate(rid, srv, body)
        elif path == "/predict" and srv.batcher is not None:
            self._handle_predict(rid, srv, body)
        else:
            self._reply(404, {"error": "unknown path %s" % self.path})

    def _handle_predict(self, rid, srv, body):
        if srv.draining:
            self._reply(503, {"error": "server draining"},
                        headers={"Retry-After": "1"})
            return
        # parse before breaker admission: a malformed body (400) must never
        # hold a half-open probe slot
        try:
            payload = json.loads(body or b"{}")
            if "inputs" in payload:
                raw = payload["inputs"]
            elif "data" in payload:
                raw = [payload["data"]]
            else:
                raise ValueError('body needs "data" or "inputs"')
            dtype = payload.get("dtype", "float32")
            inputs = [_np.asarray(x, dtype=dtype) for x in raw]
            timeout_ms = payload.get("timeout_ms")
        except (ValueError, TypeError, KeyError, AttributeError) as e:
            self._reply(400, {"error": str(e)})
            return
        breaker = srv.breaker
        admission = breaker.allow() if breaker is not None else True
        if not admission:
            snap = breaker.snapshot()
            self._reply(503, {"error": "circuit open: %s" % snap["state"],
                              "breaker": snap},
                        headers={"Retry-After": str(max(1, int(round(
                            breaker.retry_after_s()))))})
            return
        try:
            row = srv.batcher.predict(*inputs, timeout_ms=timeout_ms,
                                      request_id=rid)
        except (ServerBusy, ServerClosed) as e:
            # backpressure and shutdown are not model faults
            if breaker is not None:
                breaker.release(admission)
            self._reply(503, {"error": str(e)}, headers={"Retry-After": "1"})
            return
        except DeadlineExceeded as e:
            if breaker is not None:
                breaker.release(admission)
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - model fault
            if breaker is not None:
                breaker.record_failure(admission)
            self._reply(500, {"error": "%s: %s" % (type(e).__name__, e)})
            return
        if breaker is not None:
            breaker.record_success(admission)
        if isinstance(row, tuple):
            self._reply(200, {"outputs": [_tolist(r) for r in row]})
        else:
            self._reply(200, {"output": _tolist(row)})

    def _write_chunk(self, payload):
        """One HTTP/1.1 chunk carrying one NDJSON line."""
        data = (json.dumps(payload) + "\n").encode("utf-8")
        self.wfile.write(b"%x\r\n" % len(data))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()

    def _handle_generate(self, rid, srv, body):
        if srv.draining:
            self._reply(503, {"error": "server draining"},
                        headers={"Retry-After": "1"})
            return
        try:
            payload = json.loads(body or b"{}")
            prompt = payload["prompt"]
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError('"prompt" must be a non-empty list of '
                                 'token ids')
            max_new = payload.get("max_new_tokens")
            max_new = None if max_new is None else int(max_new)
            temperature = float(payload.get("temperature", 0.0))
            eos_id = payload.get("eos_id")
            eos_id = None if eos_id is None else int(eos_id)
            timeout_ms = payload.get("timeout_ms")
            timeout_ms = None if timeout_ms is None else float(timeout_ms)
            stream = bool(payload.get("stream", True))
        except (ValueError, TypeError, KeyError, AttributeError) as e:
            self._reply(400, {"error": str(e)})
            return
        breaker = srv.breaker
        admission = breaker.allow() if breaker is not None else True
        if not admission:
            snap = breaker.snapshot()
            self._reply(503, {"error": "circuit open: %s" % snap["state"],
                              "breaker": snap},
                        headers={"Retry-After": str(max(1, int(round(
                            breaker.retry_after_s()))))})
            return

        def release():
            # not a model fault: the breaker must not count it
            if breaker is not None:
                breaker.release(admission)

        def failed():
            if breaker is not None:
                breaker.record_failure(admission)

        try:
            req = srv.generator.submit(
                prompt, max_new_tokens=max_new, temperature=temperature,
                eos_id=eos_id, timeout_ms=timeout_ms, request_id=rid)
        except (ServerBusy, ServerClosed) as e:
            release()
            self._reply(503, {"error": str(e)}, headers={"Retry-After": "1"})
            return
        except ServingError as e:  # PromptTooLong / bad request shape
            release()
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — submit-time fault
            failed()
            self._reply(500, {"error": "%s: %s" % (type(e).__name__, e)})
            return
        if not stream:
            try:
                toks = req.result()
            except DeadlineExceeded as e:
                release()
                self._reply(504, {"error": str(e)})
            except ServerClosed as e:
                release()
                self._reply(503, {"error": str(e)},
                            headers={"Retry-After": "1"})
            except Exception as e:  # noqa: BLE001 — model fault
                failed()
                self._reply(500, {"error": "%s: %s" % (type(e).__name__, e)})
            else:
                if breaker is not None:
                    breaker.record_success(admission)
                self._reply(200, {"tokens": toks,
                                  "reason": req.finish_reason})
            return
        # hold the status line until the first event, so failures before
        # the first token keep their typed codes
        kind, val = req.next_event()
        if kind == "error":
            if isinstance(val, DeadlineExceeded):
                release()
                self._reply(504, {"error": str(val)})
            elif isinstance(val, (ServerBusy, ServerClosed)):
                release()
                self._reply(503, {"error": str(val)},
                            headers={"Retry-After": "1"})
            else:
                failed()
                self._reply(500, {"error": "%s: %s"
                                  % (type(val).__name__, val)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("X-Request-Id", rid)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            if kind == "token":
                self._write_chunk({"token": val, "index": 0})
                for i, tok in enumerate(req.tokens(), start=1):
                    self._write_chunk({"token": tok, "index": i})
            self._write_chunk({"done": True, "request_id": rid,
                               "n_tokens": len(req.tokens_out),
                               "reason": req.finish_reason})
            self.wfile.write(b"0\r\n\r\n")
            if breaker is not None:
                breaker.record_success(admission)
        except Exception as e:  # noqa: BLE001 — fault mid-stream
            # the consumer is gone or the sequence failed: retire it at
            # the next iteration instead of decoding to budget for nobody
            req.cancel()
            if isinstance(e, (DeadlineExceeded, ServerClosed, OSError)):
                release()
            else:
                failed()
            try:
                self._write_chunk({"error": "%s: %s"
                                   % (type(e).__name__, e)})
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # noqa: BLE001
                pass
            self.close_connection = True


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """No traceback spam when a client disconnects mid-reply."""

    def handle_error(self, request, client_address):
        import sys
        if isinstance(sys.exc_info()[1],
                      (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)


class ModelServer:
    """HTTP listener over ``/predict`` and/or ``/generate``.

    ``model`` backs ``POST /predict``: an ``InferenceEngine``, or a model
    that one is built around (``buckets``, ``jit``; its retry is then left
    to the batcher). A ``DynamicBatcher`` (``max_batch_size``,
    ``max_latency_ms``, ``max_queue_size``, ``default_timeout_ms``,
    ``retry_policy``) coalesces the requests; ``metrics`` (a
    ``ServingMetrics``, made when None) is ``/metrics``. ``generator`` (a
    ``GenerationScheduler``) backs ``POST /generate``. Each is closed with
    the server; at least one is needed. ``port=0`` picks an ephemeral
    port. ``breaker=None`` builds a :class:`CircuitBreaker` from the
    ``MXNET_BREAKER_*`` knobs (``MXNET_BREAKER_FAILURE_THRESHOLD <= 0``
    disables it); pass a configured breaker, or False for none."""

    def __init__(self, model=None, host="127.0.0.1", port=8080,
                 buckets=None, jit=True, max_batch_size=32,
                 max_latency_ms=5.0, max_queue_size=128,
                 default_timeout_ms=None, metrics=None, breaker=None,
                 retry_policy=None, generator=None):
        if model is None and generator is None:
            raise ValueError("need a model or a generator")
        self.generator = generator
        self.metrics = metrics or ServingMetrics()
        if model is None:
            self.engine = None
        elif isinstance(model, InferenceEngine):
            self.engine = model
            self.metrics.set_cache_stats_fn(model.stats)
        else:
            # retry lives at the batcher (it re-runs the whole coalesced
            # batch); a second policy underneath would multiply attempts
            self.engine = InferenceEngine(
                model, buckets=buckets or DEFAULT_BUCKETS, jit=jit,
                metrics=self.metrics, retry_policy=False)
        self.batcher = None if self.engine is None else DynamicBatcher(
            self.engine, max_batch_size=max_batch_size,
            max_latency_ms=max_latency_ms, max_queue_size=max_queue_size,
            default_timeout_ms=default_timeout_ms, metrics=self.metrics,
            retry_policy=retry_policy)
        if breaker is None:
            threshold = _config.get("MXNET_BREAKER_FAILURE_THRESHOLD")
            breaker = CircuitBreaker(
                failure_threshold=threshold,
                recovery_ms=_config.get("MXNET_BREAKER_RECOVERY_MS"),
                half_open_probes=_config.get(
                    "MXNET_BREAKER_HALF_OPEN_PROBES"),
                name="serving") if threshold > 0 else False
        self.breaker = breaker or None
        self._draining = False
        self._httpd = _QuietThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.model_server = self
        self._thread = None

    @property
    def draining(self):
        return self._draining

    def health(self):
        """``ok`` | ``degraded`` (with the breaker's state, or the
        guardrails' or elastic's reason) | ``draining``: what a load
        balancer keys off. A co-resident training job's watchdog stall or
        NaN storm, a pending eviction notice, a wedged collective or lost
        members degrade this process too."""
        from ..resilience import elastic as _elastic
        from ..resilience import guardrails as _guardrails
        if self._draining:
            return {"status": "draining"}
        if self.breaker is not None:
            snap = self.breaker.snapshot()
            if snap["state"] != "closed":
                return {"status": "degraded", "breaker": snap}
        g = _guardrails.health()
        if g["status"] != "ok":
            return {"status": "degraded", "guardrails": g}
        e = _elastic.health()
        if e["status"] != "ok":
            return {"status": "degraded", "elastic": e}
        return {"status": "ok"}

    def metrics_snapshot(self):
        out = self.metrics.snapshot() if self.engine is not None else {}
        out["retry"] = _retry.all_stats()
        from ..parallel.datafeed import feed_stats
        out["datafeed"] = feed_stats()
        if self.generator is not None:
            out["scheduler"] = self.generator.stats()
            if self.generator.metrics is not None:
                out["generation"] = self.generator.metrics.snapshot()
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        from ..resilience import elastic as _elastic
        out["elastic"] = _elastic.membership_gauge()
        return out

    @property
    def address(self):
        """(host, port) actually bound; resolves port=0."""
        return self._httpd.server_address[:2]

    @property
    def url(self):
        host, port = self.address
        return "http://%s:%d" % (host, port)

    def start(self):
        """Serve in a background thread; returns self."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="model-server")
            self._thread.start()
        return self

    def stop(self, drain=True, timeout=10.0):
        """Shut down: flip to draining (new POSTs get 503), let the batcher
        and the scheduler finish (``drain``) or fail their work, then
        close the listener and release the engine's graphs."""
        self._draining = True
        if self.generator is not None:
            self.generator.close(drain=drain, timeout=timeout)
        if self.batcher is not None:
            self.batcher.close(drain=drain, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        if self.engine is not None:
            self.engine.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
