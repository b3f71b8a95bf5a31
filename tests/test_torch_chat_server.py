"""The serving surfaces against the JAX package on one tiny checkpoint.

The checkpoint is written by the JAX package's ``save_pretrained`` with a
``SimpleTokenizer`` whose vocabulary covers every id, and loaded by both
packages (in f32: both ``load_pretrained_model`` calls are wrapped to pass
``dtype=float32``). On it:

* ``Chat.generate_stream_gate`` yields byte-identical NUL-framed chunks to
  JAX's ``Chat`` (greedy at lookahead 0 and 8, the default lookahead, a
  sentinel mismatch, a full context);
* ``server.serve`` and ``engine_server.serve`` on port 0 stream the same
  texts as JAX's two workers, the engine worker with concurrent clients;
* the engine worker cancels on the stop string, answers ``/health`` and
  ``/stats``; with ``engine="slot"`` it serves the slot engine, whose text
  is ``generate``'s and the JAX slot worker's.

Every HTTP call has a socket timeout and every thread join a timeout, so a
hang fails a test instead of stalling the suite.
"""

import base64
import contextlib
import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.checkpoint import save_pretrained as jsave
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer
from vcoder_tpu_torch.png import encode_png

torch.set_num_threads(1)

TEMPLATE = "USER: ASSISTANT: what objects are in the image two people a car ."
PROMPT = "USER: <depth>\n<seg>\n<image>\nwhat objects are in the image ASSISTANT:"
ENGINE_KW = dict(max_batch=2, max_len=256, page_size=8, attn_impl="xla")
TIMEOUT = 60


def make_tiny_checkpoint(path, model_type="vcoder_ds_llava", seed=0):
    """A tiny checkpoint of ``model_type`` written by the JAX package, with a
    SimpleTokenizer whose vocabulary covers every id (so every generated
    token decodes to a word of its own). Returns (path, JAX config, JAX
    params)."""
    cfg = JConfig.tiny(model_type)
    params = jvcoder.init_vcoder_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)),
        params)
    tok = JTokenizer.build_from_texts([TEMPLATE])
    for i in range(len(tok.vocab), cfg.text.vocab_size):
        tok.convert_tokens_to_ids(f"w{i}")
    jsave(str(path), params, cfg)
    tok.save_pretrained(str(path))
    return str(path), cfg, params


@contextlib.contextmanager
def f32_loads():
    """Both packages' serving modules load checkpoints in f32."""
    import vcoder_tpu.builder as jb
    import vcoder_tpu.serve.chat as jchat
    import vcoder_tpu.serve.cli as jcli
    import vcoder_tpu_torch.builder as tb
    import vcoder_tpu_torch.serve.chat as tchat
    import vcoder_tpu_torch.serve.cli as tcli

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jchat, jcli):
            mp.setattr(mod, "load_pretrained_model",
                       functools.partial(jb.load_pretrained_model, dtype=jnp.float32))
        for mod in (tchat, tcli):
            mp.setattr(mod, "load_pretrained_model",
                       functools.partial(tb.load_pretrained_model, dtype=torch.float32))
        yield


def b64_png(seed, h=30, w=41):
    rgb = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    return base64.b64encode(encode_png(rgb)).decode()


def request(**kw):
    params = {"prompt": PROMPT, "images": [b64_png(1)], "segs": [b64_png(2)],
              "depths": [b64_png(3, 25, 19)], "temperature": 0.0, "max_new_tokens": 8,
              "stop": "</s>"}
    params.update(kw)
    return params


@pytest.fixture(scope="module")
def chats(tmp_path_factory):
    from vcoder_tpu.serve.chat import Chat as JChat
    from vcoder_tpu_torch.serve.chat import Chat as TChat

    path, _, _ = make_tiny_checkpoint(tmp_path_factory.mktemp("ckpt") / "vcoder_ds_llava-tiny")
    with f32_loads():
        jchat, tchat = JChat(path), TChat(path, device="cpu")
        yield path, jchat, tchat


@pytest.mark.parametrize("lookahead", [0, 8, None, "missing"])
def test_chat_stream_gate_matches_jax(chats, lookahead):
    """Greedy chunks at lookahead 0 and 8, and at the default 8 that a None
    or missing key means."""
    _, jchat, tchat = chats
    params = request() if lookahead == "missing" else request(lookahead=lookahead)
    ref = list(jchat.generate_stream_gate(dict(params)))
    got = list(tchat.generate_stream_gate(dict(params)))
    assert got == ref
    payloads = [json.loads(c[:-1]) for c in got]
    assert len(payloads) == 8 and all(p["error_code"] == 0 for p in payloads)
    assert all(c.endswith(b"\0") for c in got)
    assert tchat.is_seg and tchat.is_depth


@pytest.mark.parametrize("case", ["sentinel_mismatch", "budget_error", "seg_without_image"])
def test_chat_errors_match_jax(chats, case):
    _, jchat, tchat = chats
    if case == "sentinel_mismatch":
        params = request(prompt="USER: no sentinel ASSISTANT:")
    elif case == "budget_error":
        params = request(prompt=PROMPT + " w7" * 500)
    else:
        params = request(images=[], prompt="USER: what objects ASSISTANT:")
    ref = list(jchat.generate_stream_gate(params))
    got = list(tchat.generate_stream_gate(params))
    assert got == ref
    code = json.loads(got[-1][:-1])["error_code"]
    assert code == (1 if case == "sentinel_mismatch" else 0)
    if case == "budget_error":
        assert b"Exceeds max token length" in got[0]


def _post(base, params, timeout=TIMEOUT):
    req = urllib.request.Request(f"{base}/worker_generate_stream",
                                 data=json.dumps(params).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return [json.loads(c) for c in raw.split(b"\0") if c.strip()]


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=TIMEOUT) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def running(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


def test_chat_http_workers_match_jax(chats):
    from vcoder_tpu.serve import server as jserver
    from vcoder_tpu_torch.serve import server as tserver

    _, jchat, tchat = chats
    with running(jserver.serve(jchat, "127.0.0.1", 0)) as jbase, \
            running(tserver.serve(tchat, "127.0.0.1", 0)) as tbase:
        assert _get(tbase, "/health") == _get(jbase, "/health")
        for params in (request(), request(lookahead=0), request(prompt="no sentinel")):
            assert _post(tbase, params) == _post(jbase, params)


@pytest.fixture(scope="module")
def engine_workers(chats):
    from vcoder_tpu.serve.engine_server import EngineWorker as JWorker
    from vcoder_tpu_torch.serve.engine_server import EngineWorker as TWorker

    path = chats[0]
    with f32_loads():
        jw = JWorker(path, **ENGINE_KW)
        tw = TWorker(path, device="cpu", **ENGINE_KW)
    try:
        yield jw, tw
    finally:
        jw.shutdown()
        tw.shutdown()


def test_engine_workers_match_jax(engine_workers, chats):
    """Two concurrent clients on each worker stream JAX's texts, and the
    port's engine worker streams the port's Chat texts."""
    from vcoder_tpu.serve import engine_server as jes
    from vcoder_tpu_torch.serve import engine_server as tes

    jw, tw = engine_workers
    reqs = [request(), request(images=[b64_png(4)], prompt=PROMPT + " two people")]
    with running(jes.serve(jw, "127.0.0.1", 0)) as jbase, \
            running(tes.serve(tw, "127.0.0.1", 0)) as tbase:
        out = {}

        def client(key, base, params):
            out[key] = _post(base, params)

        threads = [threading.Thread(target=client, args=((name, i), base, p))
                   for name, base in (("jax", jbase), ("port", tbase)) for i, p in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert _get(tbase, "/health") == {"status": "ok", "model": "vcoder_ds_llava-tiny"}
        stats = _get(tbase, "/stats")
        assert stats["active_slots"] == 0 and stats["queued"] == 0
    for i in range(len(reqs)):
        assert out[("port", i)] == out[("jax", i)]
        assert len(out[("port", i)]) == 8
        assert all(p["error_code"] == 0 for p in out[("port", i)])
    chat_texts = [json.loads(c[:-1])["text"]
                  for c in chats[2].generate_stream_gate(request(lookahead=0))]
    assert [p["text"] for p in out[("port", 0)]] == chat_texts


def test_engine_worker_cancels_on_stop_string(engine_workers):
    """A stop string that the third token spells ends the stream there, and
    the engine request is cancelled (its slot freed) as in JAX."""
    from vcoder_tpu.serve import engine_server as jes
    from vcoder_tpu_torch.serve import engine_server as tes

    jw, tw = engine_workers
    full = None
    with running(tes.serve(tw, "127.0.0.1", 0)) as tbase, \
            running(jes.serve(jw, "127.0.0.1", 0)) as jbase:
        full = _post(tbase, request(max_new_tokens=40, stop=None))
        third = full[2]["text"][len(PROMPT):].split()[-1]
        params = request(max_new_tokens=40, stop=" " + third)
        got = _post(tbase, params)
        assert got == _post(jbase, params)
        stats = _get(tbase, "/stats")
    assert len(got) == 3 and got[-1]["text"] == full[1]["text"]
    assert stats["active_slots"] == 0 and stats["queued"] == 0


@pytest.mark.parametrize("case", ["sentinel_mismatch", "budget_error", "unknown_lora",
                                  "client_gone"])
def test_engine_worker_errors_match_jax(engine_workers, case):
    """A request that fails (a sentinel mismatch, an adapter the worker does
    not serve) streams JAX's one error chunk; a full context streams its
    message with ``error_code`` 0; a client that goes away mid-stream
    cancels its request, so no slot is stranded."""
    import http.client
    import time

    from vcoder_tpu.serve import engine_server as jes
    from vcoder_tpu_torch.serve import engine_server as tes

    jw, tw = engine_workers
    cancelled = []
    with running(tes.serve(tw, "127.0.0.1", 0)) as tbase, \
            running(jes.serve(jw, "127.0.0.1", 0)) as jbase, pytest.MonkeyPatch.context() as mp:
        mp.setattr(tw, "cancel", lambda h, cancel=tw.cancel: (cancelled.append(h), cancel(h)))
        if case == "client_gone":
            host, port = tbase[len("http://"):].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
            conn.request("POST", "/worker_generate_stream",
                         json.dumps(request(max_new_tokens=200, stop=None)),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.read1(1)  # the stream has begun
            conn.sock.shutdown(2)
            conn.close()
            deadline = time.monotonic() + TIMEOUT
            while time.monotonic() < deadline:
                stats = _get(tbase, "/stats")
                if stats["active_slots"] == 0 and stats["queued"] == 0:
                    break
                time.sleep(0.05)
            assert stats["active_slots"] == 0 and stats["queued"] == 0
            assert len(cancelled) == 1  # cancelled, not run to its end
            return
        params = {"sentinel_mismatch": request(prompt="USER: no sentinel ASSISTANT:"),
                  "budget_error": request(prompt=PROMPT + " w7" * 500),
                  "unknown_lora": request(lora="absent")}[case]
        got = _post(tbase, params)
        assert got == _post(jbase, params)
        assert _get(tbase, "/stats")["active_slots"] == 0
    assert len(got) == 1
    assert got[0]["error_code"] == (0 if case == "budget_error" else 1)
    if case == "budget_error":
        assert "Exceeds max token length" in got[0]["text"]


def test_engine_worker_serves_slot_engine(chats):
    """``EngineWorker(dir, engine="slot")`` builds the slot engine over the
    checkpoint and answers a request over HTTP with ``generate``'s tokens
    (the Chat worker's text at lookahead 0) and the JAX slot worker's
    chunks."""
    from vcoder_tpu.serve import engine_server as jes
    from vcoder_tpu_torch.serve import engine_server as tes
    from vcoder_tpu_torch.serve.engine import ServingEngine

    kw = dict(engine="slot", max_batch=2, max_len=256, attn_impl="xla")
    with f32_loads():
        jw = jes.EngineWorker(chats[0], **kw)
        tw = tes.EngineWorker(chats[0], device="cpu", **kw)
    try:
        assert type(tw.engine) is ServingEngine and tw.engine.cache.k.shape[2] == 257
        with running(jes.serve(jw, "127.0.0.1", 0)) as jbase, \
                running(tes.serve(tw, "127.0.0.1", 0)) as tbase:
            ref = _post(jbase, request(lookahead=0))
            got = _post(tbase, request(lookahead=0))
    finally:
        jw.shutdown()
        tw.shutdown()
    assert got == ref and len(got) == 8 and all(p["error_code"] == 0 for p in got)
    want = [json.loads(c[:-1])["text"]
            for c in chats[2].generate_stream_gate(request(lookahead=0))]
    assert [p["text"] for p in got] == want


def test_engine_worker_flags_build_the_served_worker(chats):
    """``main``'s flags keep the JAX worker's defaults (but ``--device
    cuda``), and ``worker_from_args`` builds the worker ``main`` serves: a
    paged engine at those settings (``--lora`` adapters included)."""
    from vcoder_tpu_torch.serve import engine_server as tes

    ap = tes.build_parser()
    d = ap.parse_args(["--model-path", chats[0]])
    assert (d.device, d.engine, d.max_batch, d.max_len, d.page_size, d.kv_quant, d.speculative,
            d.prefix_cache, d.chunked_prefill, d.lora) == ("cuda", "paged", 8, 4096, 128, False,
                                                           0, False, 0, [])
    args = ap.parse_args(["--model-path", chats[0], "--device", "cpu", "--max-batch", "2",
                          "--max-len", "256", "--page-size", "16", "--speculative", "3",
                          "--prefix-cache", "--chunked-prefill", "32"])
    with f32_loads():
        worker = tes.worker_from_args(args)
    try:
        eng = worker.engine
        assert (eng.max_batch, eng.page_size, eng.spec_k) == (2, 16, 3)
        assert eng.prefix_idx is not None and eng._cp_chunk == 32
        with running(tes.serve(worker, "127.0.0.1", 0)) as base:
            got = _post(base, request(max_new_tokens=5))
        assert len(got) == 5 and all(p["error_code"] == 0 for p in got)
    finally:
        worker.shutdown()
    # --engine slot: the slot engine at those flags (--page-size ignored).
    args = ap.parse_args(["--model-path", chats[0], "--device", "cpu", "--engine", "slot",
                          "--max-batch", "2", "--max-len", "256", "--kv-quant",
                          "--sync-every", "2"])
    with f32_loads():
        worker = tes.worker_from_args(args)
    try:
        eng = worker.engine
        assert (type(eng).__name__, eng.max_batch, eng.sync_every) == ("ServingEngine", 2, 2)
        assert eng.cache.quantized and eng.cache.k.shape[2] == 256 + 2
        with running(tes.serve(worker, "127.0.0.1", 0)) as base:
            got = _post(base, request(max_new_tokens=5))
        assert len(got) == 5 and all(p["error_code"] == 0 for p in got)
    finally:
        worker.shutdown()
