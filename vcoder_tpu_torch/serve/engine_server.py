"""Concurrent engine worker (port of ``TokenStream:49`` and ``EngineWorker:69``
of ``vcoder_tpu/serve/engine_server.py``).

Every client is multiplexed onto ONE engine: a background thread owns the
engine and drives ``engine.step()``, each step decodes all active streams at
once, and per-request token queues fan the events back out. Handlers talk to
the loop thread through thread-safe submit/cancel queues.

Ported: :meth:`EngineWorker.from_engine` (wrap an already-built engine),
``submit``, ``cancel``, ``stats``, ``shutdown`` and the loop. The checkpoint
constructor (which builds a ``Chat``), the HTTP handler, ``serve`` and
``main`` wait for the surfaces slice; the constructor raises.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, List, Optional, Tuple

from vcoder_tpu_torch.serve.chat import PreparedRequest

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
    """Owns an engine and the engine-loop thread; all engine access happens
    on the loop thread."""

    def __init__(self, model_path: str, *args, **kwargs):
        raise NotImplementedError(
            "building a worker from a checkpoint (Chat) is not ported yet; "
            "build the engine and use EngineWorker.from_engine(engine, ...)"
        )

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
