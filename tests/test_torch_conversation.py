"""The port's ``conversation.py``, prompt and image halves, against JAX's.

Each test of ``tests/test_conversation.py`` runs over both packages
(``pkg``). Then the image half (``get_images``/``get_segs``/``get_depths``
in the Pad, Resize, Crop and Default modes, ``_display_resize``,
``to_gradio_chatbot``) must give the same pictures and the same base64 text
as JAX's on the same messages, and ``_b64_png`` of a numpy array works
without PIL (the port's ``png.encode_png``) while the getters raise
``ImportError`` without it.
"""

import base64
import builtins
import importlib
import io

import numpy as np
import pytest

PKGS = ["vcoder_tpu", "vcoder_tpu_torch"]

SYSTEM_V1 = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions."
)


@pytest.fixture(params=PKGS)
def conv_mod(request):
    return importlib.import_module(f"{request.param}.conversation")


def test_vicuna_v1_two_style_render(conv_mod):
    conv = conv_mod.conv_templates["vicuna_v1"].copy()
    conv.append_message(conv.roles[0], "<image>\nWhat is in the image?")
    conv.append_message(conv.roles[1], None)
    assert conv.get_prompt() == SYSTEM_V1 + " USER: <image>\nWhat is in the image? ASSISTANT:"


def test_two_style_full_round_uses_sep2(conv_mod):
    conv = conv_mod.conv_templates["vicuna_v1"].copy()
    conv.append_message(conv.roles[0], "hello")
    conv.append_message(conv.roles[1], "hi there")
    assert conv.get_prompt().endswith("ASSISTANT: hi there</s>")


def test_tuple_message_text_extraction(conv_mod):
    conv = conv_mod.conv_templates["llava_v1"].copy()
    img = np.zeros((8, 8, 3), np.uint8)
    conv.append_message(conv.roles[0], ("<image>\ndescribe", img, "Pad", None, None, None, None))
    conv.append_message(conv.roles[1], None)
    assert "<image>\ndescribe" in conv.get_prompt()


def test_get_images_segs_depths_slots(conv_mod):
    pytest.importorskip("PIL")
    conv = conv_mod.default_conversation.copy()
    img = np.full((50, 30, 3), 10, np.uint8)
    seg = np.full((50, 30, 3), 20, np.uint8)
    conv.append_message(conv.roles[0], ("<seg>\n<image>\nq", img, "Pad", seg, "Pad", None, None))
    conv.append_message(conv.roles[1], None)
    imgs = conv.get_images(return_pil=True)
    segs = conv.get_segs(return_pil=True)
    depths = conv.get_depths(return_pil=True)
    assert len(imgs) == 1 and len(segs) == 1 and len(depths) == 0
    assert imgs[0].size[0] == imgs[0].size[1]
    assert isinstance(conv.get_images()[0], str)


def test_copy_independent(conv_mod):
    conv = conv_mod.default_conversation.copy()
    conv.append_message(conv.roles[0], "x")
    assert len(conv_mod.default_conversation.messages) == 0


def test_plain_style(conv_mod):
    conv = conv_mod.conv_templates["plain"].copy()
    conv.append_message("", "<image>\n")
    conv.append_message("", "a red bus")
    assert conv.get_prompt() == "<image>\n\na red bus\n"


# ---- the image half against JAX's ------------------------------------------


def _conversation(mod, modes, sizes, seed=0):
    rng = np.random.RandomState(seed)
    conv = mod.conv_templates["llava_v1"].copy()
    for turn, (mode, (h, w)) in enumerate(zip(modes, sizes)):
        pics = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(3)]
        conv.append_message(conv.roles[0], (f"<depth>\n<seg>\n<image>\nq{turn}", pics[0], mode,
                                            pics[1], mode, pics[2] if turn else None, mode))
        conv.append_message(conv.roles[1], f"answer {turn}")
    return conv


@pytest.mark.parametrize("mode", ["Pad", "Resize", "Crop", "Default"])
@pytest.mark.parametrize("size", [(50, 30), (900, 500), (420, 1700)])
def test_modality_getters_match_jax(mode, size):
    pytest.importorskip("PIL")
    convs = [_conversation(importlib.import_module(f"{p}.conversation"), [mode, mode],
                           [size, size[::-1]]) for p in PKGS]
    for getter in ("get_images", "get_segs", "get_depths"):
        pil = [getattr(c, getter)(return_pil=True) for c in convs]
        assert [im.size for im in pil[1]] == [im.size for im in pil[0]]
        for a, b in zip(*pil):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert getattr(convs[1], getter)() == getattr(convs[0], getter)()
    assert convs[1].to_gradio_chatbot() == convs[0].to_gradio_chatbot()


def test_display_resize_and_invalid_mode_match_jax():
    Image = pytest.importorskip("PIL.Image")
    jconv = importlib.import_module("vcoder_tpu.conversation")
    tconv = importlib.import_module("vcoder_tpu_torch.conversation")
    for w, h in ((1000, 300), (300, 1000), (500, 500), (350, 200)):
        im = Image.new("RGB", (w, h), "red")
        assert tconv._display_resize(im).size == jconv._display_resize(im).size
    for mod in (jconv, tconv):
        conv = _conversation(mod, ["Squash"], [(20, 20)])
        with pytest.raises(ValueError, match="Invalid image_process_mode"):
            conv.get_images()


def test_b64_png_of_numpy_needs_no_pil(monkeypatch):
    from vcoder_tpu_torch import conversation, png

    rgb = np.random.RandomState(0).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(png.decode_png(base64.b64decode(conversation._b64_png(rgb))),
                                  rgb)
    conv = _conversation(conversation, ["Pad"], [(20, 30)])
    with pytest.raises(ImportError):
        conv.get_images()
    with pytest.raises(ImportError):
        conv.to_gradio_chatbot()


def test_b64_png_of_a_pil_image_is_pils_png():
    Image = pytest.importorskip("PIL.Image")
    from vcoder_tpu import conversation as jconv
    from vcoder_tpu_torch import conversation as tconv

    im = Image.fromarray(np.random.RandomState(1).randint(0, 256, (7, 5, 3)).astype(np.uint8))
    assert tconv._b64_png(im) == jconv._b64_png(im)
    assert tconv._b64_jpeg(im) == jconv._b64_jpeg(im)
    buf = io.BytesIO(base64.b64decode(tconv._b64_jpeg(im)))
    assert Image.open(buf).format == "JPEG"
