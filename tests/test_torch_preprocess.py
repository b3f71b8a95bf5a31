"""The port's image preprocessing against the JAX package's portable path.

``VCODER_TPU_NATIVE_IO=0`` keeps the JAX side on ``jax.image.resize`` (not
its C++ route). Both outputs are mapped back to the 0..255 scale before
normalization; they must agree within 1 uint8 step (the rounding of a value
that lands within float noise of .5 may go either way).
"""

import os

import numpy as np
import pytest
import torch

from vcoder_tpu import preprocess as jpre
from vcoder_tpu_torch import preprocess as tpre

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")


def _to_u8_scale(x):
    x = np.asarray(x, np.float32)
    return (x * np.asarray(jpre.CLIP_IMAGE_STD) + np.asarray(jpre.CLIP_IMAGE_MEAN)) * 255.0


def _compare(arr, monkeypatch, aspect="pad"):
    monkeypatch.setenv("VCODER_TPU_NATIVE_IO", "0")
    ref = jpre.process_images([arr], image_aspect_ratio=aspect)
    out = tpre.process_images([arr], image_aspect_ratio=aspect, device="cpu")
    assert out.shape == (1, 336, 336, 3) and out.dtype == torch.float32
    diff = np.abs(_to_u8_scale(out.numpy()) - _to_u8_scale(ref))
    assert diff.max() <= 1.0 + 1e-3, diff.max()


@pytest.mark.parametrize("name", ["demo.jpg", "demo_pan.png", "demo_depth.png"])
def test_example_images_match_jax(name, monkeypatch):
    from PIL import Image

    arr = np.asarray(Image.open(os.path.join(EXAMPLES, name)).convert("RGB"))
    _compare(arr, monkeypatch)


@pytest.mark.parametrize("hw", [(100, 40), (37, 300), (336, 336), (20, 30), (500, 500)])
def test_synthetic_arrays_match_jax(hw, monkeypatch):
    rng = np.random.RandomState(sum(hw))
    arr = rng.randint(0, 256, hw + (3,), dtype=np.uint8)
    _compare(arr, monkeypatch)


def test_center_crop_aspect_matches_jax(monkeypatch):
    arr = np.random.RandomState(5).randint(0, 256, (90, 140, 3), dtype=np.uint8)
    _compare(arr, monkeypatch, aspect="square")


def test_expand2square_and_weights():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (50, 20, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tpre.expand2square(img), jpre.expand2square(img))
    assert tpre.BACKGROUND_COLOR == jpre.BACKGROUND_COLOR
    # Each output pixel's weights are normalized (antialiased downscale and
    # plain upscale alike).
    for n_in in (500, 100, 336):
        np.testing.assert_allclose(tpre.resize_weights(n_in, 336).sum(0), 1.0, atol=1e-5)
