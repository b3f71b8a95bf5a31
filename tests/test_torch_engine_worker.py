"""``EngineWorker.from_engine`` over a tiny CPU paged engine of the port:
concurrent submits from several threads stream the same tokens as
``engine.run()`` on an identical engine; ``cancel`` ends a stream early and
frees its slot; ``shutdown`` ends the streams still open with an error."""

import threading

import numpy as np
import pytest
import torch

from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu_torch.models.vcoder import init_vcoder_params
from vcoder_tpu_torch.serve.chat import PreparedRequest
from vcoder_tpu_torch.serve.engine_server import EngineWorker
from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    params = init_vcoder_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    hw = cfg.vision.image_size
    rng = np.random.RandomState(1)
    pics = [[rng.randn(1, hw, hw, 3).astype(np.float32) for _ in range(3)] for _ in range(4)]
    return cfg, params, pics


def _engine(cfg, params, **kw):
    return PagedServingEngine(cfg, params, max_batch=2, max_len=256, page_size=8,
                              attn_impl="xla", eos_id=-1, device="cpu", **kw)


def _prep(i, pics, max_new=6):
    ids = [1, 30 + i, DEPTH_TOKEN_INDEX, 12, SEG_TOKEN_INDEX, 13, IMAGE_TOKEN_INDEX, 14, 40 + i]
    im, seg, dep = pics
    return PreparedRequest(ori_prompt="", input_ids=ids, images=im, segs=seg, depths=dep,
                           max_new_tokens=max_new, temperature=0.0, top_p=1.0, stop_str=None)


@pytest.mark.parametrize("kw", [{}, {"chunked_prefill": 16, "speculative": 3}],
                         ids=["dense_admission", "chunked_speculative"])
def test_concurrent_streams_match_run(setup, kw):
    cfg, params, pics = setup
    preps = [_prep(i, pics[i]) for i in range(4)]
    ref_eng = _engine(cfg, params, **kw)
    rids = [ref_eng.add_request(p.input_ids, images=p.images, segs=p.segs, depths=p.depths,
                                max_new_tokens=p.max_new_tokens) for p in preps]
    ref = ref_eng.run()

    eng = _engine(cfg, params, **kw)
    worker = EngineWorker.from_engine(eng, model_name="tiny", eos_id=-1)
    got = [None] * len(preps)

    def client(i):
        got[i] = [(tok, done, err) for tok, done, err in worker.submit(preps[i])]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(preps))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    worker.shutdown()
    assert not worker._thread.is_alive()
    for i, rid in enumerate(rids):
        assert [t for t, _, _ in got[i]] == ref[rid]
        assert [d for _, d, _ in got[i]] == [False] * 5 + [True]
        assert all(e is None for _, _, e in got[i])
    stats = worker.stats()
    assert stats["active_slots"] == 0 and stats["queued"] == 0 and stats["preemptions"] == 0


def test_cancel_and_shutdown_end_streams(setup):
    cfg, params, pics = setup
    eng = _engine(cfg, params)
    worker = EngineWorker.from_engine(eng, model_name="tiny", eos_id=-1)
    long = worker.submit(_prep(0, pics[0], max_new=200))
    it = iter(long)
    first = next(it)
    assert first[1] is False
    worker.cancel(long)  # the loop drops the stream and frees the slot
    short = worker.submit(_prep(1, pics[1], max_new=4))
    assert [d for _, d, _ in short] == [False, False, False, True]
    # A stream still open at shutdown ends with the shutdown error.
    hanging = worker.submit(_prep(2, pics[2], max_new=10**6))
    assert next(iter(hanging))[2] is None
    worker.shutdown()
    events = list(hanging)
    assert events[-1] == (-1, True, "server shutting down")
    assert not worker._thread.is_alive()
    assert not any(eng.row_pages[s] for s in range(eng.max_batch) if eng.slots[s] is None)


def test_checkpoint_constructor_serves_paged_and_slot(tmp_path):
    """``EngineWorker(model_path)`` loads the checkpoint through ``Chat``,
    builds a paged engine over it and serves; with ``engine="slot"`` it
    builds the slot engine, drops ``page_size`` as the JAX worker does, and
    serves the same tokens."""
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    params = init_vcoder_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    path = str(tmp_path / "vcoder_ds_llava-tiny")
    save_pretrained(path, params, cfg)
    SimpleTokenizer.build_from_texts(["USER: what ASSISTANT:"]).save_pretrained(path)
    worker = EngineWorker(path, device="cpu", max_batch=2, max_len=256, page_size=8,
                          attn_impl="xla")
    try:
        assert worker.chat.is_seg and worker.chat.is_depth and worker.model_name == "vcoder_ds_llava-tiny"
        hw = cfg.vision.image_size
        pics = [np.random.RandomState(i).randn(1, hw, hw, 3).astype(np.float32) for i in range(3)]
        events = list(worker.submit(_prep(0, pics, max_new=4)))
        assert [d for _, d, _ in events] == [False] * 3 + [True]
        assert all(e is None for _, _, e in events)
    finally:
        worker.shutdown()
    assert not worker._thread.is_alive()
    paged_events = events
    worker = EngineWorker(path, device="cpu", engine="slot", max_batch=2, max_len=256,
                          page_size=8, attn_impl="xla")
    try:
        assert type(worker.engine).__name__ == "ServingEngine"
        events = list(worker.submit(_prep(0, pics, max_new=4)))
    finally:
        worker.shutdown()
    assert events == paged_events
    with pytest.raises(ValueError, match="unknown engine"):
        EngineWorker(path, device="cpu", engine="dense")
