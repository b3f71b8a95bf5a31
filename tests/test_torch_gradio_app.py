"""The port's gradio demo, driven without gradio, against the JAX package's.

The same stub as ``tests/test_gradio_app.py`` (a minimal ``gradio`` module in
``sys.modules``) lets each of that file's tests run over both packages'
``serve/gradio_app.py`` (``app``): ``build_demo``'s wiring, ``add_text``'s
sentinel injection, and ``http_bot``'s streaming over a canned ``Chat``.
Then both packages' ``add_text`` and ``http_bot`` must produce the same
states, chatbot frames and payloads on the same inputs, moderation blocks
text through the port's ``utils.violates_moderation``, the demo's example
rows point at pictures that exist, and ``_require_gradio`` names gradio when
it is missing.
"""

import importlib
import os
import sys

import pytest

from tests.test_gradio_app import _CannedChat, _Component, _make_gradio_stub

PKGS = ["vcoder_tpu", "vcoder_tpu_torch"]


@pytest.fixture()
def gradio_stub(monkeypatch):
    stub = _make_gradio_stub()
    monkeypatch.setitem(sys.modules, "gradio", stub)
    _Component.created.clear()
    return stub


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.serve.gradio_app"),
            importlib.import_module(f"{pkg}.conversation"),
            importlib.import_module(f"{pkg}.constants"),
            importlib.import_module(f"{pkg}.utils"))


def test_build_demo_wires_submit_chain(gradio_stub, pkg):
    app, _, _, _ = _mods(pkg)
    demo = app.build_demo()
    assert isinstance(demo, gradio_stub.Blocks)
    wired = [(fn, inputs) for comp in _Component.created for (fn, inputs, _) in comp.callbacks]
    fns = [fn for fn, _ in wired]
    assert app.add_text in fns and app.http_bot in fns
    assert len(dict(wired)[app.add_text]) == 8
    assert len(dict(wired)[app.http_bot]) == 4


def test_build_demo_collects_all_callbacks(gradio_stub, pkg):
    _mods(pkg)[0].build_demo()
    assert sum(len(c.callbacks) for c in _Component.created) >= 6


def test_add_text_injects_sentinels(gradio_stub, pkg):
    from PIL import Image

    app, conv, const, _ = _mods(pkg)
    state = conv.conv_templates["llava_v1"].copy()
    img, seg, depth = (Image.new("RGB", (8, 8), c) for c in ("red", "green", "blue"))
    state = app.add_text(state, "what is here?", img, "Pad", seg, "Pad", depth, "Pad")[0]
    assert not state.skip_next
    msg = state.messages[-2][1]
    assert isinstance(msg, tuple) and len(msg) == 7
    assert msg[0].startswith(const.DEFAULT_DEPTH_TOKEN + "\n" + const.DEFAULT_SEG_TOKEN + "\n"
                             + const.DEFAULT_IMAGE_TOKEN + "\n")
    assert state.messages[-1][1] is None


def test_add_text_empty_input_skips(gradio_stub, pkg):
    app, conv, _, _ = _mods(pkg)
    out = app.add_text(conv.conv_templates["llava_v1"].copy(), "", None, "Pad", None, "Pad",
                       None, "Pad")
    assert out[0].skip_next
    assert out[0].messages == conv.conv_templates["llava_v1"].copy().messages


def _seeded_state(conv, question="hello"):
    state = conv.conv_templates["llava_v1"].copy()
    state.append_message(state.roles[0], question)
    state.append_message(state.roles[1], None)
    state.skip_next = False
    return state


def test_http_bot_streams_and_strips_cursor(gradio_stub, monkeypatch, pkg):
    app, conv, _, _ = _mods(pkg)
    chat = _CannedChat([" a", " b", " c"])
    monkeypatch.setattr(app, "chat", chat)
    frames = list(app.http_bot(_seeded_state(conv), 0.2, 0.7, 64))
    assert len(frames) == 5
    assert frames[-1][0].messages[-1][-1] == "a b c"
    assert (chat.last_payload["temperature"], chat.last_payload["top_p"],
            chat.last_payload["max_new_tokens"]) == (0.2, 0.7, 64)


def test_http_bot_error_shows_server_error(gradio_stub, monkeypatch, pkg):
    app, conv, _, utils = _mods(pkg)
    monkeypatch.setattr(app, "chat", _CannedChat([" a", " b"], error_at=1))
    frames = list(app.http_bot(_seeded_state(conv), 0.0, 1.0, 32))
    assert frames[-1][0].messages[-1][-1] == utils.server_error_msg


def test_http_bot_skip_next_passthrough(gradio_stub, monkeypatch, pkg):
    app, conv, _, _ = _mods(pkg)
    monkeypatch.setattr(app, "chat", _CannedChat([]))
    state = _seeded_state(conv)
    state.skip_next = True
    assert len(list(app.http_bot(state, 0.0, 1.0, 32))) == 1


# ---- both packages on the same inputs --------------------------------------


def _images(seed):
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            for h, w in ((40, 60), (500, 300), (33, 33))]


@pytest.mark.parametrize("with_depth", [True, False])
def test_add_text_then_http_bot_match_jax(gradio_stub, monkeypatch, with_depth):
    """Two turns: add_text's states and chatbot frames, then http_bot's
    frames and the payload it hands the Chat (prompt, b64 pictures, stop)."""
    runs = []
    for pkg in PKGS:
        app, conv, _, _ = _mods(pkg)
        img, seg, depth = _images(0)
        state = conv.conv_templates["llava_v1"].copy()
        out = []
        for turn, text in enumerate(["what is here?", "and then?"]):
            pics = (img, "Pad", seg, "Resize", depth if with_depth else None, "Crop")
            res = app.add_text(state, text, *(pics if turn == 0 else (None,) * 6))
            state = res[0]
            chat = _CannedChat([" x", " y"])
            monkeypatch.setattr(app, "chat", chat)
            frames = list(app.http_bot(state, 0.5, 0.9, 5000))
            out.append((res[1:], [f[1] for f in frames], chat.last_payload,
                        state.dict()))
        runs.append(out)
    assert runs[1] == runs[0]
    payload = runs[1][0][2]
    assert len(payload["images"]) == 1 and len(payload["segs"]) == 1
    assert len(payload["depths"]) == (1 if with_depth else 0)
    assert payload["max_new_tokens"] == 1536 and payload["stop"] == "</s>"


def test_moderation_blocks_text(gradio_stub, monkeypatch):
    from vcoder_tpu_torch import conversation, utils
    from vcoder_tpu_torch.serve import gradio_app

    monkeypatch.setattr(gradio_app, "violates_moderation", lambda text: "bad" in text)
    state = conversation.conv_templates["llava_v1"].copy()
    out = gradio_app.add_text(state, "a bad word", None, "Pad", None, "Pad", None, "Pad",
                              moderate=True)
    assert out[0].skip_next and out[2] == "moderation"
    # Without an OPENAI_API_KEY the port's hook flags nothing.
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert utils.violates_moderation("a bad word") is False


def test_examples_exist_and_gradio_is_named_when_missing(gradio_stub, monkeypatch):
    from vcoder_tpu_torch.serve import gradio_app

    gradio_app.build_demo()
    (examples,) = [c for c in _Component.created if type(c).__name__ == "Examples"]
    paths = [p for row in examples.kwargs["examples"] for p in row[:3] if p]
    assert len(paths) == 14 and all(os.path.exists(p) for p in paths)
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is not installed"):
        gradio_app.build_demo()


def test_main_builds_chat_on_the_device(gradio_stub, monkeypatch):
    from vcoder_tpu_torch.serve import chat as chat_mod
    from vcoder_tpu_torch.serve import gradio_app

    seen = {}

    class FakeChat:
        def __init__(self, path, **kw):
            seen.update(path=path, **kw)

    launched = {}

    class Demo:
        def queue(self, **kw):
            return self

        def launch(self, **kw):
            launched.update(kw)

    monkeypatch.setattr(chat_mod, "Chat", FakeChat)
    monkeypatch.setattr(gradio_app, "build_demo", lambda: Demo())
    monkeypatch.setattr(gradio_app, "build_logger", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["gradio_app", "--model-path", "ck", "--device", "cpu",
                                      "--port", "7861"])
    gradio_app.main()
    assert seen == {"path": "ck", "model_base": None, "load_8bit": False, "load_4bit": False,
                    "device": "cpu"}
    assert launched["server_port"] == 7861
