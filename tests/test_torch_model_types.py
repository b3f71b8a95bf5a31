"""Greedy parity of all four model types against the JAX package (tiny
configs, f32): ``llava``; ``vcoder_llava`` with and without a seg;
``vcoder_it_llava`` with a seg, and text only; VCoder-DS with
``is_depth_zero``, with ``is_seg_zero``, and without depth. Then the same
through ``Chat``, which routes by the checkpoint's name, for a
``vcoder_llava``-named and a ``llava``-named checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import generation as jgen
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.constants import DEPTH_TOKEN_INDEX as DEP
from vcoder_tpu_torch.constants import IMAGE_TOKEN_INDEX as IMG
from vcoder_tpu_torch.constants import SEG_TOKEN_INDEX as SEG

torch.set_num_threads(1)

MAX_NEW = 8

# (model type, rows, modalities given, flags)
CASES = {
    "llava": ("llava", [[1, 5, IMG, 7, 8, 9], [1, 6, IMG, 7]], ("images",), {}),
    "vcoder_llava_seg": ("vcoder_llava", [[1, 5, SEG, IMG, 7, 8], [1, SEG, IMG, 9]],
                         ("images", "segs"), {}),
    "vcoder_llava_no_seg": ("vcoder_llava", [[1, 5, IMG, 7, 8], [1, IMG, 9]], ("images",), {}),
    "vcoder_it_llava_seg": ("vcoder_it_llava", [[1, 5, IMG, 6, 7, SEG, 8], [1, IMG, 6, SEG, 9]],
                            ("images", "segs"), {}),
    "vcoder_it_llava_text": ("vcoder_it_llava", [[1, 5, 6, 7], [1, 8, 9, 10, 11]], (), {}),
    "ds_depth_zero": ("vcoder_ds_llava", [[1, 5, DEP, SEG, IMG, 7], [1, DEP, SEG, IMG, 9, 10]],
                      ("images", "segs", "depths"), {"is_depth_zero": [True, False]}),
    "ds_seg_zero": ("vcoder_ds_llava", [[1, 5, DEP, SEG, IMG, 7], [1, DEP, SEG, IMG, 9, 10]],
                    ("images", "segs", "depths"), {"is_seg_zero": [False, True]}),
    "ds_no_depth": ("vcoder_ds_llava", [[1, 5, SEG, IMG, 7], [1, SEG, IMG, 9, 10, 11]],
                    ("images", "segs"), {}),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, mt in enumerate(("llava", "vcoder_llava", "vcoder_it_llava", "vcoder_ds_llava")):
        jcfg, tcfg = JConfig.tiny(mt), TConfig.tiny(mt)
        jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(10 + i), jcfg)
        rng = np.random.RandomState(i)
        jp = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)),
            jp)
        out[mt] = (jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_matches_jax_for_each_model_type(models, case):
    mt, rows, given, flags = CASES[case]
    jcfg, tcfg, jp, tp = models[mt]
    hw = jcfg.vision.image_size
    rng = np.random.RandomState(len(case))
    px = {k: rng.randn(len(rows), hw, hw, 3).astype(np.float32) for k in given}
    ref = jgen.generate(jp, jcfg, rows, **{k: jnp.asarray(v) for k, v in px.items()},
                        max_new_tokens=MAX_NEW, attn_impl="xla", **flags)
    out = tgen.generate(tp, tcfg, rows, **{k: torch.from_numpy(v) for k, v in px.items()},
                        max_new_tokens=MAX_NEW, **flags)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)


@pytest.mark.parametrize("name,model_type,prompt", [
    ("vcoder_llava-tiny", "vcoder_llava", "USER: <seg>\n<image>\nwhat objects ASSISTANT:"),
    ("llava-v1.5-tiny", "llava", "USER: <image>\nwhat objects ASSISTANT:"),
])
def test_chat_routes_by_name_as_jax(tmp_path, name, model_type, prompt):
    """A segs list beside a ``llava``-named checkpoint is ignored, as in
    JAX; the ``vcoder_llava``-named one splices it."""
    from tests.test_torch_chat_server import b64_png, f32_loads, make_tiny_checkpoint
    from vcoder_tpu.serve.chat import Chat as JChat
    from vcoder_tpu_torch.serve.chat import Chat as TChat

    path, _, _ = make_tiny_checkpoint(tmp_path / name, model_type=model_type, seed=3)
    with f32_loads():
        jchat, tchat = JChat(path), TChat(path, device="cpu")
    assert (tchat.is_seg, tchat.is_depth) == (jchat.is_seg, jchat.is_depth)
    assert tchat.is_seg == (model_type == "vcoder_llava")
    params = {"prompt": prompt, "images": [b64_png(1)], "segs": [b64_png(2)],
              "temperature": 0.0, "max_new_tokens": 6, "stop": "</s>"}
    for lookahead in (0, 8):
        ref = list(jchat.generate_stream_gate(dict(params, lookahead=lookahead)))
        got = list(tchat.generate_stream_gate(dict(params, lookahead=lookahead)))
        assert got == ref and b'"error_code": 0' in got[-1]
