"""Concurrent HTTP model worker over a serving engine (port of
``vcoder_tpu/serve/engine_server.py``).

Every client is multiplexed onto ONE engine, the ``PagedServingEngine`` or,
with ``engine="slot"``, the slot engine ``ServingEngine``: a background
thread owns the engine and drives ``engine.step()``, each step decodes all
active streams at once, and per-request token queues fan the events back
out. Only the loop thread touches the engine; handlers talk to it through
thread-safe submit/cancel queues.

Same wire format as ``serve/server.py`` (and FastChat):

* ``POST /worker_generate_stream`` -- Chat params dict in, NUL-delimited
  ``{"text": ..., "error_code": 0}`` JSON chunks streamed out.
* ``GET /health`` -- worker status + model name.
* ``GET /stats`` -- engine step-timer percentiles, queue depth, active
  slots, prefix-cache counters.

Requests are prepared by ``Chat.prepare`` (the same validation as the
serialized worker; pixels are preprocessed on the device in the handler
thread, then handed to the engine as host arrays). A stop string CANCELS the
engine request, and so does a client that goes away, so no slot is stranded.

    python -m vcoder_tpu_torch.serve.engine_server --model-path <ckpt> \
        --port 21002 --max-batch 8 --page-size 128 [--kv-quant]
        [--speculative 4] [--prefix-cache] [--chunked-prefill 512]
    python -m vcoder_tpu_torch.serve.engine_server --model-path <ckpt> \
        --engine slot --max-len 2048 [--kv-quant] [--sync-every 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import queue
import threading
from http.server import ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Tuple

from vcoder_tpu_torch.serve.chat import Chat, PreparedRequest, json_chunk, stream_gate
from vcoder_tpu_torch.serve.server import StreamingHandler
from vcoder_tpu_torch.utils import build_logger

logger = logging.getLogger("engine_worker")


class TokenStream:
    """Per-request bridge from the engine loop thread to a consumer thread: a
    queue of (token, done, error) events. ``cancelled`` is set under the
    worker's lock, so a cancel that races admission (``request_id`` not yet
    assigned) still takes effect when the loop admits the request."""

    def __init__(self):
        self.request_id: Optional[int] = None
        self.cancelled = False
        self.q: "queue.Queue[Tuple[int, bool, Optional[str]]]" = queue.Queue()

    def __iter__(self):
        while True:
            tok, done, err = self.q.get()
            yield tok, done, err
            if done:
                return


class EngineWorker:
    """Owns the model (through a :class:`Chat`), the engine and the
    engine-loop thread; all engine access happens on the loop thread."""

    def __init__(
        self,
        model_path: str,
        model_base=None,
        model_name=None,
        load_8bit: bool = False,
        load_4bit: bool = False,
        device="cuda",
        tokenizer=None,
        engine: str = "paged",
        **engine_kw,
    ):
        if engine not in ("paged", "slot"):
            raise ValueError(f"unknown engine {engine!r}")
        self.chat = Chat(model_path, model_base, model_name=model_name, load_8bit=load_8bit,
                         load_4bit=load_4bit, device=device, tokenizer=tokenizer)
        model = self.chat.model
        if engine == "paged":
            from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine as engine_cls
        else:
            from vcoder_tpu_torch.serve.engine import ServingEngine as engine_cls

            engine_kw.pop("page_size", None)
        self.engine = engine_cls(model.config, model.params, device=self.chat.device,
                                 **engine_kw)
        self.model_name = self.chat.model_name
        self.eos_id = model.config.text.eos_token_id
        if hasattr(self.engine, "warmup_chunks"):
            # Run every group-chunk shape once before traffic arrives.
            self.engine.warmup_chunks()
        self._start_loop()

    @classmethod
    def from_engine(cls, engine, *, model_name: str, eos_id: int) -> "EngineWorker":
        """Wrap an already-built engine in the worker loop."""
        self = cls.__new__(cls)
        self.chat = None
        self.engine = engine
        self.model_name = model_name
        self.eos_id = eos_id
        self._start_loop()
        return self

    def _start_loop(self) -> None:
        self._cond = threading.Condition()
        self._submissions: List[Tuple[PreparedRequest, TokenStream]] = []
        self._cancels: List[int] = []
        self._streams: Dict[int, TokenStream] = {}
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, name="engine-loop", daemon=True)
        self._thread.start()

    # ---- consumer-side API (any thread) ----

    def submit(self, prep: PreparedRequest) -> TokenStream:
        handle = TokenStream()
        with self._cond:
            self._submissions.append((prep, handle))
            self._cond.notify()
        return handle

    def cancel(self, handle: TokenStream) -> None:
        with self._cond:
            handle.cancelled = True
            if handle.request_id is not None:
                self._cancels.append(handle.request_id)
            # else: the loop thread sees `cancelled` when it admits.
            self._cond.notify()

    def stats(self) -> dict:
        eng = self.engine
        out = {
            "model": self.model_name,
            "active_slots": int(sum(eng.active)),
            "queued": len(eng.queue),
            "timers": eng.timer.summary(),
        }
        if hasattr(eng, "prefix_stats"):
            out["prefix_cache"] = eng.prefix_stats()
        if hasattr(eng, "preemptions"):
            out["preemptions"] = eng.preemptions
        if eng.lora_ids:
            out["lora_adapters"] = sorted(eng.lora_ids)
        return out

    def shutdown(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout=30)

    # ---- engine loop (single thread owns the engine) ----

    def _drain_inbox(self) -> None:
        with self._cond:
            subs, self._submissions = self._submissions, []
            cancels, self._cancels = self._cancels, []
        for prep, handle in subs:
            with self._cond:
                if handle.cancelled:
                    continue
            rid = self.engine.add_request(
                prep.input_ids, images=prep.images, segs=prep.segs, depths=prep.depths,
                max_new_tokens=prep.max_new_tokens, temperature=prep.temperature,
                top_p=prep.top_p, lora=prep.lora,
            )
            with self._cond:
                handle.request_id = rid
                if handle.cancelled:
                    # Cancelled before admission: never decode it.
                    self.engine.cancel(rid)
                    continue
            self._streams[rid] = handle
        for rid in cancels:
            self.engine.cancel(rid)
            # The consumer has already stopped reading; just forget it.
            self._streams.pop(rid, None)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (
                    not self._stopping
                    and not self._submissions
                    and not self._cancels
                    and not self.engine.has_work()
                ):
                    self._cond.wait()
                if self._stopping:
                    # Fail in-flight streams before exiting; their consumers
                    # would block forever otherwise.
                    for handle in self._streams.values():
                        handle.q.put((self.eos_id, True, "server shutting down"))
                    self._streams.clear()
                    return
            self._drain_inbox()
            if not self.engine.has_work():
                continue
            try:
                events = self.engine.step()
            except Exception:
                logger.exception("engine step failed")
                # Fail every in-flight stream and drain the engine, or
                # has_work() stays true and the loop spins on the failing step.
                for handle in self._streams.values():
                    handle.q.put((self.eos_id, True, "engine step failed"))
                self._streams.clear()
                try:
                    for req in list(self.engine.queue):
                        self.engine.cancel(req.request_id)
                    for req in list(self.engine.slots):
                        if req is not None:
                            self.engine.cancel(req.request_id)
                    pending = getattr(self.engine, "_pending", None)
                    if pending is not None:
                        self.engine.cancel(pending.req.request_id)
                except Exception:
                    logger.exception("engine drain after failure")
                continue
            for rid, tok, done in events:
                handle = self._streams.get(rid)
                if handle is None:
                    continue
                err = self.engine.pop_error(rid) if done else None
                handle.q.put((tok, done, err))
                if done:
                    del self._streams[rid]


def _host(x):
    """Pixels for the engine: a device tensor comes back as a numpy array."""
    return x.float().cpu().numpy() if hasattr(x, "cpu") else x


class EngineWorkerHandler(StreamingHandler):
    worker: EngineWorker = None  # bound by serve()
    # A stalled client errors its own stream (cancelling its request)
    # rather than pinning a handler thread; no global lock here.
    socket_timeout = 300.0
    log = logger

    def get_json(self, path: str) -> Optional[dict]:
        if path == "/health":
            return {"status": "ok", "model": self.worker.model_name}
        return self.worker.stats() if path == "/stats" else None

    def stream(self, params: dict) -> Iterator[bytes]:
        return stream_gate(self._engine_chunks(params))

    def _engine_chunks(self, params: dict) -> Iterator[bytes]:
        """The response's chunks; a failure raises (``stream_gate`` turns it
        into an error chunk, never a silently empty completion)."""
        worker = self.worker
        prep = worker.chat.prepare(params)
        if prep.budget_error is not None:
            yield json_chunk(prep.ori_prompt + prep.budget_error, 0)
            return
        if prep.lora is not None and prep.lora not in worker.engine.lora_ids:
            raise ValueError(f"unknown LoRA adapter: {prep.lora}")
        prep = dataclasses.replace(prep, images=_host(prep.images), segs=_host(prep.segs),
                                   depths=_host(prep.depths))
        tokenizer = worker.chat.tokenizer
        handle = worker.submit(prep)
        generated: List[int] = []
        try:
            for tok, done, err in handle:
                if err is not None:
                    raise RuntimeError(f"request failed: {err}")  # admission or step
                if tok == worker.eos_id:
                    return  # EOS never surfaces as text
                generated.append(tok)
                text = tokenizer.decode(generated, skip_special_tokens=True)
                if prep.stop_str and text.endswith(prep.stop_str):
                    text = text[: -len(prep.stop_str)]
                    done = True
                    worker.cancel(handle)
                yield json_chunk(prep.ori_prompt + text, 0)
                if done:
                    return
        except GeneratorExit:
            # The client went away mid-stream (maybe before admission
            # assigned a request id): free the slot either way.
            worker.cancel(handle)
            raise


def serve(worker: EngineWorker, host: str = "0.0.0.0", port: int = 21002) -> ThreadingHTTPServer:
    """Build the server (the caller runs ``serve_forever`` / ``shutdown``)."""
    handler = type("BoundEngineWorkerHandler", (EngineWorkerHandler,), {"worker": worker})
    return ThreadingHTTPServer((host, port), handler)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", type=str, required=True)
    ap.add_argument("--model-base", type=str, default=None)
    ap.add_argument("--host", type=str, default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--engine", choices=["paged", "slot"], default="paged")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=4096)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--speculative", type=int, default=0)
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--chunked-prefill", type=int, default=0)
    ap.add_argument(
        "--lora", action="append", default=[], metavar="NAME=PATH",
        help="serve a PEFT adapter dir under NAME (repeatable); requests pick one via the "
        "'lora' param",
    )
    return ap


def worker_from_args(args) -> EngineWorker:
    """The :class:`EngineWorker` that ``main`` serves, from its parsed flags."""
    lora_adapters = None
    if args.lora:
        from vcoder_tpu_torch.lora import load_lora_adapter_dir

        lora_adapters = {}
        for spec in args.lora:
            name, _, path = spec.partition("=")
            if not path:
                raise ValueError(f"--lora expects NAME=PATH, got {spec!r}")
            lora_adapters[name] = load_lora_adapter_dir(path)
    engine_kw = dict(max_batch=args.max_batch, max_len=args.max_len, kv_quant=args.kv_quant,
                     speculative=args.speculative, sync_every=args.sync_every,
                     lora_adapters=lora_adapters)
    if args.engine == "paged":
        engine_kw.update(page_size=args.page_size, prefix_cache=args.prefix_cache,
                         chunked_prefill=args.chunked_prefill)
    return EngineWorker(args.model_path, args.model_base, load_8bit=args.load_8bit,
                        load_4bit=args.load_4bit, device=args.device, engine=args.engine,
                        **engine_kw)


def main(argv=None):
    args = build_parser().parse_args(argv)
    build_logger("engine_worker", "engine_worker.log")
    worker = worker_from_args(args)
    httpd = serve(worker, args.host, args.port)
    logger.info(f"engine worker listening on {args.host}:{args.port} model={worker.model_name} "
                f"engine={args.engine}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
