"""The closed-loop REST client, a process of its own (standard library
only), so that it never holds the server's interpreter lock.

Driven over its standard input by ``loads/rest.py``: first one JSON line
({"port", "upload", "analyze", "names", "audio_s", "sizes"}) and the WAV
files' bytes back to back; then one JSON command a line, each answered
with one JSON line on its standard output:

  {"cmd": "once"}            one request of every take, in order
  {"cmd": "run", "seconds"}  takes in turn from the first, each request
                             sent when the one before has been answered,
                             until ``seconds`` have passed since the first
  {"cmd": "count", "n"}      n requests, takes in turn from the first
  {"cmd": "quit"}

A request is the upload of a take (POST, raw WAV body) and the analysis
of its session (POST), both on the client's one kept-alive HTTP/1.1
connection, as a browser tab (the SPA, the desktop app) sends them; its
time runs from the first byte of the upload to the last byte of the
analysis.  Each answer lists every request
with its start, the end of its upload and its end on the shared
monotonic clock (``time.perf_counter``), its status and the analysis
body.
"""

from __future__ import annotations

import http.client
import json
import sys
import time


class Conn:
    """The client's one kept-alive connection to the server."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def post(self, path: str, body: bytes, ctype: str):
        self.conn.request("POST", path, body=body,
                          headers={"Content-Type": ctype})
        resp = self.conn.getresponse()
        return resp.status, resp.read()


def request(conn: Conn, cfg: dict, wav: bytes, name: str) -> dict:
    t0 = time.perf_counter()
    status, body = conn.post(f"{cfg['upload']}?name={name}.wav", wav,
                             "audio/wav")
    out, t_up = None, time.perf_counter()
    if status == 200:
        sid = json.loads(body)["session_id"]
        status, body = conn.post(cfg["analyze"].format(sid=sid), b"",
                                 "application/json")
        out = body.decode("utf-8", "replace")
    t1 = time.perf_counter()
    return {"t0": t0, "t_up": t_up, "t1": t1, "status": status, "body": out}


def main() -> int:
    stdin = sys.stdin.buffer
    cfg = json.loads(stdin.readline())
    wavs = [stdin.read(n) for n in cfg["sizes"]]
    names = cfg["names"]
    conn = Conn(cfg["port"])
    print(json.dumps({"ready": True}), flush=True)
    for line in stdin:
        cmd = json.loads(line)
        items = []
        if cmd["cmd"] == "quit":
            break
        if cmd["cmd"] == "once":
            order = range(len(wavs))
        elif cmd["cmd"] == "count":
            order = [i % len(wavs) for i in range(int(cmd["n"]))]
        elif cmd["cmd"] == "run":
            order = None
        else:
            raise ValueError(f"unknown command {cmd!r}")
        if order is None:
            start = time.perf_counter()
            i = 0
            while time.perf_counter() - start < float(cmd["seconds"]):
                k = i % len(wavs)
                items.append({"take": k, **request(conn, cfg, wavs[k], names[k])})
                i += 1
        else:
            for k in order:
                items.append({"take": k, **request(conn, cfg, wavs[k], names[k])})
        print(json.dumps({"items": items}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
