"""Prometheus text-format exposition + a stdlib ``/metrics`` endpoint.
A copy of the JAX package's ``obs/exporter.py``.

``render_text`` produces the text exposition format (version 0.0.4);
``parse_text`` is the inverse used by tests and by CI's mid-run scrape
assertions; ``MetricsServer`` serves it over ``http.server``.  All
stdlib, so any process can serve its own endpoint.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from repro_torch.obs.metrics import Registry, REGISTRY

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# A flattened series key: (metric name incl. suffix, sorted label pairs).
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(h: str) -> str:
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if v != int(v) else str(int(v))


def render_text(registry: Optional[Registry] = None) -> str:
    """Render every metric in *registry* in Prometheus text format."""
    reg = registry if registry is not None else REGISTRY
    lines = []
    for metric in reg.collect():
        if metric.help:
            lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for suffix, labelpairs, value in metric.samples():
            if labelpairs:
                body = ",".join(
                    f'{k}="{_escape_label_value(v)}"' for k, v in labelpairs)
                lines.append(
                    f"{metric.name}{suffix}{{{body}}} {_format_value(value)}")
            else:
                lines.append(
                    f"{metric.name}{suffix} {_format_value(value)}")
    return "\n".join(lines) + "\n"


def _parse_labels(body: str, where: str) -> Tuple[Tuple[str, str], ...]:
    """Parse the inside of a ``{...}`` label block, honouring escapes."""
    pairs = []
    i, n = 0, len(body)
    while i < n:
        eq = body.index("=", i)
        name = body[i:eq].strip()
        if body[eq + 1] != '"':
            raise ValueError(f"{where}: unquoted label value")
        j = eq + 2
        out = []
        while True:
            ch = body[j]
            if ch == "\\":
                nxt = body[j + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            elif ch == '"':
                break
            else:
                out.append(ch)
                j += 1
        pairs.append((name, "".join(out)))
        i = j + 1
        if i < n and body[i] == ",":
            i += 1
    return tuple(sorted(pairs))


def parse_text(text: str) -> Dict[SeriesKey, float]:
    """Inverse of :func:`render_text`: series key -> value.

    Keys are ``(name, sorted ((label, value), ...))`` — histogram bucket
    samples appear under ``<name>_bucket`` with their ``le`` label.
    """
    out: Dict[SeriesKey, float] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        where = f"line {lineno}"
        if "{" in line:
            name, rest = line.split("{", 1)
            body, tail = rest.rsplit("}", 1)
            labels = _parse_labels(body, where)
            value_str = tail.strip()
        else:
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"{where}: malformed sample {line!r}")
            name, value_str = parts
            labels = ()
        out[(name.strip(), labels)] = float(value_str)
    return out


def snapshot(registry: Optional[Registry] = None) -> Dict[str, float]:
    """Flatten the registry to ``{'name{l="v"}': value}`` — a JSON-able
    snapshot for ``BENCH_*.json`` records."""
    flat: Dict[str, float] = {}
    for (name, labels), value in parse_text(render_text(registry)).items():
        if labels:
            body = ",".join(f'{k}="{v}"' for k, v in labels)
            flat[f"{name}{{{body}}}"] = value
        else:
            flat[name] = value
    return flat


class _Handler(BaseHTTPRequestHandler):
    registry: Registry  # set per-server by MetricsServer

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = render_text(self.registry).encode("utf-8")
            ctype = CONTENT_TYPE
        except Exception as exc:  # surface scrape bugs to the scraper
            body = json.dumps({"error": repr(exc)}).encode("utf-8")
            self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: object) -> None:
        pass  # scrapes are not worth a log line each


class MetricsServer:
    """Minimal ``/metrics`` endpoint on a daemon thread.

    ``port=0`` binds an ephemeral port; read the real one from ``.port``.
    """

    def __init__(self, registry: Optional[Registry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        reg = registry if registry is not None else REGISTRY
        handler = type("BoundHandler", (_Handler,), {"registry": reg})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="metrics-http", daemon=True)
        t.start()
        self._thread = t
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.close()


def main(argv: Optional[list] = None) -> int:
    """Serve the process-wide registry (``python -m
    repro_torch.obs.exporter``)."""
    import argparse
    import time

    ap = argparse.ArgumentParser(description="serve /metrics")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    with MetricsServer(host=args.host, port=args.port) as srv:
        print(srv.url, flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
