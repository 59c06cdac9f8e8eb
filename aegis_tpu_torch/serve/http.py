"""Minimal HTTP routing layer on the standard library. A copy of
``aegis_tpu/serve/http.py`` (no JAX in it), held equal to it by
``tests/test_torch_server.py``.

fastapi/uvicorn are not part of this framework's dependency set, so the API
server (serve.server) runs on ``http.server.ThreadingHTTPServer`` with this
small router: path patterns with ``{param}`` segments, query-string coercion,
JSON / bytes responses, CORS, and a multipart/form-data file parser for the
upload endpoint.
"""

from __future__ import annotations

import json
import math
import re
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class Response:
    def __init__(self, content: bytes, media_type: str = "application/json",
                 status: int = 200, headers: Optional[Dict[str, str]] = None):
        self.content = content
        self.media_type = media_type
        self.status = status
        self.headers = headers or {}


def json_response(obj: Any, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), "application/json", status)


def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[str, bytes]]:
    """Parse multipart/form-data into {field: (filename, data)}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise HTTPError(400, "missing multipart boundary")
    boundary = b"--" + m.group(1).encode()
    fields: Dict[str, Tuple[str, bytes]] = {}
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        header_blob, data = part.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]+)"', headers)
        file_m = re.search(r'filename="([^"]*)"', headers)
        if name_m:
            fields[name_m.group(1)] = (
                file_m.group(1) if file_m else "", data
            )
    return fields


class Router:
    def __init__(self) -> None:
        self._routes: List[Tuple[str, re.Pattern, Callable]] = []

    def route(self, method: str, pattern: str):
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )

        def deco(fn):
            self._routes.append((method, regex, fn))
            return fn

        return deco

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def dispatch(self, method: str, path: str, query: Dict[str, str],
                 body: bytes, content_type: str) -> Response:
        for m, regex, fn in self._routes:
            if m != method:
                continue
            match = regex.match(path)
            if match:
                return fn(query=query, body=body, content_type=content_type,
                          **match.groupdict())
        raise HTTPError(404, f"no route for {method} {path}")


def coerce(query: Dict[str, str], name: str, default, cast=None):
    """Typed query-parameter access with defaults; malformed values are a
    CLIENT error (400), never a 500."""
    if name not in query:
        return default
    val = query[name]
    cast = cast or (type(default) if default is not None else str)
    if cast is bool:
        return val.lower() in ("1", "true", "yes", "on")
    try:
        # OverflowError: int(float('inf')); non-finite floats ('inf',
        # 'nan') parse but crash downstream — both are client errors.
        if cast is float or isinstance(default, float):
            out = float(val)
            if not math.isfinite(out):
                raise ValueError(val)
            return out
        if cast is int or isinstance(default, int):
            return int(float(val))
    except (ValueError, OverflowError):
        raise HTTPError(400, f"invalid value for '{name}': {val!r}")
    return val


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _respond(self, resp: Response) -> None:
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.media_type)
            self.send_header("Content-Length", str(len(resp.content)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, OPTIONS")
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(resp.content)

        def _handle(self, method: str) -> None:
            try:
                parsed = urllib.parse.urlparse(self.path)
                query = {
                    k: v[0]
                    for k, v in urllib.parse.parse_qs(parsed.query).items()
                }
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                ctype = self.headers.get("Content-Type", "")
                resp = router.dispatch(method, parsed.path, query, body, ctype)
                self._respond(resp)
            except HTTPError as e:
                self._respond(json_response({"detail": e.detail}, e.status))
            except BrokenPipeError:
                pass
            except Exception as e:
                traceback.print_exc()
                self._respond(json_response({"detail": str(e)}, 500))

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_OPTIONS(self):
            self._respond(Response(b"", "text/plain", 204))

    return Handler


def serve_forever(router: Router, host: str = "0.0.0.0", port: int = 8508):
    server = ThreadingHTTPServer((host, port), make_handler(router))
    server.serve_forever()
