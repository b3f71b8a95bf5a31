"""The interactive CLI: ``vcoder_tpu_torch.serve.cli.main`` against the JAX
package's on one tiny checkpoint (written by JAX, loaded in f32 by both),
with two turns piped on stdin: the same printed text, turn for turn. Then
the module runs as a program (``python -m``) on the CPU, in bf16.
"""

import argparse
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_chat_server import f32_loads, make_tiny_checkpoint
from vcoder_tpu_torch.png import encode_png

torch.set_num_threads(1)

TURNS = "what objects are in the image\nwhat else\n\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path, _, _ = make_tiny_checkpoint(d / "vcoder_ds_llava-tiny")
    rng = np.random.RandomState(5)
    pics = {}
    for name, (h, w) in (("image", (30, 41)), ("seg", (30, 41)), ("depth", (33, 20))):
        pics[name] = str(d / f"{name}.png")
        with open(pics[name], "wb") as f:
            f.write(encode_png(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)))
    return path, pics


def _args(path, pics, **kw):
    args = dict(model_path=path, model_base=None, image_file=pics["image"],
                seg_file=pics["seg"], depth_file=pics["depth"], conv_mode=None,
                temperature=0.0, max_new_tokens=10, lookahead=8, load_8bit=False,
                load_4bit=False, debug=False, image_aspect_ratio="pad")
    args.update(kw)
    return argparse.Namespace(**args)


def _run(main, args, monkeypatch):
    # Read stdout from a buffer of our own: importing the JAX package's chat
    # module points sys.stdout at its log.
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO(TURNS))
    monkeypatch.setattr(sys, "stdout", out)
    main(args)
    return out.getvalue()


@pytest.mark.parametrize("lookahead", [8, 0])
def test_cli_prints_what_jax_prints(files, monkeypatch, lookahead):
    from vcoder_tpu.serve import cli as jcli
    from vcoder_tpu_torch.serve import cli as tcli

    path, pics = files
    with f32_loads():
        ref = _run(jcli.main, _args(path, pics, device="cpu", lookahead=lookahead),
                   monkeypatch)
        got = _run(tcli.main, _args(path, pics, device="cpu", lookahead=lookahead),
                   monkeypatch)
    assert got == ref
    # Two answered turns, then the exit line.
    assert got.count("ASSISTANT: ") == 2 and got.rstrip().endswith("exit...")
    answers = [line.split("ASSISTANT: ", 1)[1] for line in got.splitlines()
               if "ASSISTANT: " in line]
    assert all(a.strip() for a in answers)


def test_cli_parser_defaults():
    from vcoder_tpu_torch.serve import cli as tcli

    args = tcli.build_parser().parse_args(["--image-file", "x.png"])
    assert (args.device, args.lookahead, args.temperature) == ("cuda", 8, 0.2)


def test_cli_refuses_urls():
    from vcoder_tpu_torch.serve import cli as tcli

    with pytest.raises(ValueError, match="no network"):
        tcli.load_image("https://example.invalid/a.png")


def test_cli_runs_as_a_program(files):
    path, pics = files
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "vcoder_tpu_torch.serve.cli", "--model-path", path,
         "--image-file", pics["image"], "--seg-file", pics["seg"], "--depth-file",
         pics["depth"], "--temperature", "0", "--max-new-tokens", "6", "--device", "cpu"],
        input=TURNS, capture_output=True, text=True, timeout=120, cwd=root,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("ASSISTANT: ") == 2 and "exit..." in proc.stdout
