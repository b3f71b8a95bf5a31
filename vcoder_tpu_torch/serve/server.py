"""HTTP model worker over :class:`Chat` (port of ``vcoder_tpu/serve/server.py``).

The FastChat-style worker API:

* ``POST /worker_generate_stream`` -- body: the Chat params dict
  (``prompt``, base64 ``images``/``segs``/``depths``, ``temperature``,
  ``top_p``, ``max_new_tokens``, ``stop``, ``lookahead``). Response:
  NUL-delimited JSON chunks ``{"text": ..., "error_code": 0}``, streamed
  with chunked transfer encoding as they decode; the chunked terminator is
  always sent, after a failure too.
* ``GET /health`` -- ``{"status": "ok", "model": <name>}``.

Stdlib only (``ThreadingHTTPServer``). Generation requests serialize through
one lock (one model on one card); a stalled client times out after 30 s and
releases it. Usage:

    python -m vcoder_tpu_torch.serve.server --model-path <ckpt> --port 21002
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, Optional

from vcoder_tpu_torch.serve.chat import Chat
from vcoder_tpu_torch.utils import build_logger

logger = logging.getLogger("worker")


class StreamingHandler(BaseHTTPRequestHandler):
    """The worker API's HTTP framing, shared by this worker and
    ``engine_server``'s: ``GET`` answers :meth:`get_json`'s payload (404 for
    ``None``), and ``POST /worker_generate_stream`` streams :meth:`stream`'s
    NUL-terminated chunks with chunked transfer encoding. A client that goes
    away closes the stream's generator (which frees what it holds); the
    chunked terminator is always sent, after a failure too."""

    protocol_version = "HTTP/1.1"
    # This worker holds its generation lock while streaming: a stalled
    # client must error out (releasing the lock), not block every request.
    socket_timeout = 30.0
    log = logger

    def setup(self):
        super().setup()
        self.connection.settimeout(self.socket_timeout)

    def log_message(self, fmt, *args):
        self.log.info("%s - %s" % (self.address_string(), fmt % args))

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def get_json(self, path: str) -> Optional[dict]:
        raise NotImplementedError

    def stream(self, params: dict) -> Iterator[bytes]:
        raise NotImplementedError

    def do_GET(self):
        payload = self.get_json(self.path)
        if payload is None:
            self._json(404, {"error": "not found"})
        else:
            self._json(200, payload)

    def do_POST(self):
        if self.path != "/worker_generate_stream":
            self._json(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            params = json.loads(self.rfile.read(length) or b"{}")
        except Exception as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data + b"\r\n")
            self.wfile.flush()

        gen = self.stream(params)
        try:
            for chunk in gen:
                send_chunk(chunk)
        except OSError:
            gen.close()  # GeneratorExit inside: the stream frees what it holds
        finally:
            try:
                send_chunk(b"")  # chunked-encoding terminator
            except OSError:
                self.close_connection = True


class WorkerHandler(StreamingHandler):
    chat: Chat = None  # bound by serve()
    lock: threading.Lock = None

    def get_json(self, path: str) -> Optional[dict]:
        return {"status": "ok", "model": self.chat.model_name} if path == "/health" else None

    def stream(self, params: dict) -> Iterator[bytes]:
        with self.lock:
            yield from self.chat.generate_stream_gate(params)


def serve(chat: Chat, host: str = "0.0.0.0", port: int = 21002) -> ThreadingHTTPServer:
    """Build the server (the caller runs ``serve_forever`` / ``shutdown``)."""
    handler = type("BoundWorkerHandler", (WorkerHandler,),
                   {"chat": chat, "lock": threading.Lock()})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", type=str, required=True)
    ap.add_argument("--model-base", type=str, default=None)
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    build_logger("worker", "worker.log")
    chat = Chat(args.model_path, args.model_base, load_8bit=args.load_8bit,
                load_4bit=args.load_4bit, device=args.device)
    httpd = serve(chat, args.host, args.port)
    logger.info(f"worker listening on {args.host}:{args.port} model={chat.model_name}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
