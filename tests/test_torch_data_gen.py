"""The data-generation driver and the GPT-4V query: the port against the JAX
package, on the CPU and without a network.

``vcoder_tpu_torch.data_gen`` and ``vcoder_tpu_torch.eval.gpt4_query`` are
copies of the JAX package's modules. The seeds under
``playground/data/prompts/`` are read as data by both; the payload files of
the two CLIs must be byte-equal; the query modes run against a fake
``requests`` module put in ``sys.modules`` by the test, and must send the same
URL, headers and JSON and write the same records.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from vcoder_tpu import data_gen as jgen
from vcoder_tpu.eval import gpt4_query as jquery
from vcoder_tpu_torch import data_gen as tgen
from vcoder_tpu_torch.eval import gpt4_query as tquery

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = os.path.join(REPO, "playground", "data", "prompts")
SHOTS = {"conversation": 2, "detail_description": 3, "complex_reasoning": 3}
CAPS = [{"id": "a", "caps": "A dog on a couch.\nA brown dog lies on a sofa."},
        {"id": "b", "caps": "Two people ride bikes.\nperson: [0.1, 0.2, 0.5, 0.9]"}]


@pytest.mark.parametrize("task", sorted(SHOTS))
def test_seeds_complete_and_messages_equal_jax(task):
    assert tgen.TASK_TYPES == jgen.TASK_TYPES
    system_message, shots = tgen.load_seeds(SEEDS, task)
    assert (system_message, shots) == jgen.load_seeds(SEEDS, task)
    assert len(system_message) > 100 and len(shots) == SHOTS[task]
    for caps, conv in shots:
        assert caps.strip() and conv.strip()
    for rec in CAPS:
        msgs = tgen.build_messages(system_message, shots, rec["caps"])
        assert msgs == jgen.build_messages(system_message, shots, rec["caps"])
        assert [m["role"] for m in msgs] == ["system"] + ["user", "assistant"] * len(shots) + ["user"]


def test_missing_seeds_raise_like_jax(tmp_path):
    (tmp_path / "conversation").mkdir()
    (tmp_path / "conversation" / "system_message.txt").write_text("sys")
    for mod in (tgen, jgen):
        with pytest.raises(FileNotFoundError, match="no few-shot seeds"):
            mod.load_seeds(str(tmp_path), "conversation")


@pytest.mark.parametrize("task", ["conversation", "complex_reasoning"])
def test_cli_payload_file_is_byte_equal_to_jax(task, tmp_path):
    caps = tmp_path / "caps.jsonl"
    caps.write_text("".join(json.dumps(r) + "\n" for r in CAPS) + "\n")
    outs = {}
    for pkg in ("vcoder_tpu", "vcoder_tpu_torch"):
        out = tmp_path / pkg / "req.jsonl"
        r = subprocess.run([sys.executable, "-m", f"{pkg}.data_gen", "--type", task,
                            "--caps-file", str(caps), "--out", str(out),
                            "--temperature", "0.7"],
                           cwd=REPO, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == f"wrote {len(CAPS)} payloads to {out}"
        outs[pkg] = out.read_bytes()
    assert outs["vcoder_tpu_torch"] == outs["vcoder_tpu"]
    recs = [json.loads(line) for line in outs["vcoder_tpu_torch"].decode().splitlines()]
    assert [r["id"] for r in recs] == ["a", "b"]
    assert recs[0]["payload"]["model"] == "gpt-4" and recs[0]["payload"]["temperature"] == 0.7
    assert recs[1]["payload"]["messages"][-1]["content"] == CAPS[1]["caps"]


class _Response:
    def __init__(self, text):
        self._text = text

    def raise_for_status(self):
        pass

    def json(self):
        return {"choices": [{"message": {"content": self._text}}]}


@pytest.fixture
def fake_requests(monkeypatch):
    """A ``requests`` module that records every POST and answers it; no
    socket is opened."""
    calls = []

    def post(url, headers=None, json=None, timeout=None):
        calls.append(dict(url=url, headers=headers, json=json, timeout=timeout))
        return _Response(f"answer {len(calls)}")

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(post=post))
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    return calls


def _run_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def test_data_gen_query_mode_sends_and_writes_what_jax_does(fake_requests, tmp_path,
                                                            monkeypatch, capsys):
    caps = tmp_path / "caps.jsonl"
    caps.write_text("".join(json.dumps(r) + "\n" for r in CAPS))
    sent, written = {}, {}
    for name, mod in (("jax", jgen), ("torch", tgen)):
        out = tmp_path / name / "answers.jsonl"
        _run_main(mod, ["--type", "detail_description", "--caps-file", str(caps),
                        "--out", str(out), "--query", "--seed-dir", SEEDS], monkeypatch)
        sent[name] = list(fake_requests)
        fake_requests.clear()
        written[name] = out.read_bytes()
    assert sent["torch"] == sent["jax"] and len(sent["torch"]) == len(CAPS)
    call = sent["torch"][0]
    assert call["url"] == "https://api.openai.com/v1/chat/completions"
    assert call["headers"] == {"Authorization": "Bearer sk-test"}
    assert call["json"]["messages"][-1]["content"] == CAPS[0]["caps"]
    assert written["torch"] == written["jax"]
    recs = [json.loads(line) for line in written["torch"].decode().splitlines()]
    assert recs == [{"id": "a", "type": "detail_description", "text": "answer 1"},
                    {"id": "b", "type": "detail_description", "text": "answer 2"}]
    assert "wrote 2 answers" in capsys.readouterr().out


def test_data_gen_query_needs_a_key_like_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    caps = tmp_path / "caps.jsonl"
    caps.write_text(json.dumps(CAPS[0]) + "\n")
    for mod in (jgen, tgen):
        with pytest.raises(SystemExit, match="OPENAI_API_KEY"):
            _run_main(mod, ["--type", "conversation", "--caps-file", str(caps),
                            "--out", str(tmp_path / "o.jsonl"), "--query",
                            "--seed-dir", SEEDS], monkeypatch)


def test_gpt4_query_sends_and_writes_what_jax_does(fake_requests, tmp_path, monkeypatch):
    images = tmp_path / "val2017"
    images.mkdir()
    rng = np.random.RandomState(0)
    for key in ("000001.jpg", "000002.jpg"):
        (images / key).write_bytes(rng.bytes(64))
    (images / "skip.png").write_bytes(b"not a jpg")
    assert tquery.PROMPT == jquery.PROMPT
    sent, written = {}, {}
    for name, mod in (("jax", jquery), ("torch", tquery)):
        out = tmp_path / name / "gpt4"
        out.parent.mkdir()
        _run_main(mod, ["--image-folder", str(images), "--output-file", str(out),
                        "--sleep", "0"], monkeypatch)
        sent[name] = list(fake_requests)
        fake_requests.clear()
        written[name] = {t: (tmp_path / name / f"gpt4_{t}.txt").read_bytes()
                         for t in ("semantic", "instance", "panoptic")}
    assert sent["torch"] == sent["jax"] and len(sent["torch"]) == 3 * 2
    call = sent["torch"][0]
    assert call["url"] == "https://api.openai.com/v1/chat/completions"
    assert call["headers"] == {"Content-Type": "application/json",
                               "Authorization": "Bearer sk-test"}
    assert call["json"]["max_tokens"] == 300 and call["json"]["model"] == "gpt-4-vision-preview"
    url = call["json"]["messages"][0]["content"][1]["image_url"]["url"]
    assert url.startswith("data:image/jpeg;base64,")
    assert written["torch"] == written["jax"]
    text = written["torch"]["panoptic"].decode()
    assert text.count("Image: ") == 2 and "<<ANSWER>>: answer 5" in text


def test_gpt4_query_needs_a_key_like_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for mod in (jquery, tquery):
        with pytest.raises(SystemExit, match="OPENAI_API_KEY"):
            _run_main(mod, ["--image-folder", str(tmp_path)], monkeypatch)


def test_no_requests_import_in_the_payload_mode():
    """``requests`` is imported only inside the query paths, as in JAX."""
    import ast

    for mod in (tgen, tquery):
        tree = ast.parse(open(mod.__file__).read())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name for n in top for a in n.names}
        assert "requests" not in names
