"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, it is correct; with the timed path broken underneath (each
fault a cell can have on one chip), ``correct`` comes out false. The control
and the half-batch fault read above the tiny cells' limits. Without a card
the harness measures nothing. No module imports JAX or the JAX package."""

import ast
import subprocess
import sys

import pytest
import torch

from portbench import control, run, spec, weights

FIXTURE = spec.HERE / "tests" / "fixture"
BENCH = {"end_to_end": [{"name": "train_tokens_per_s", "unit": "tokens/s"},
                        {"name": "serve_tokens_per_s", "unit": "tokens/s"},
                        {"name": "setup_s", "unit": "s"}], "per_layer": []}
CPU = torch.device("cpu")


def execute(cell, fault=None, seed=21):
    """One untraced run; its window long enough that requests finish in it
    on a loaded host."""
    return run.execute(cell, seed, 2.0, False, CPU, bench=BENCH, base=FIXTURE, fault=fault)[0]


def unchanged(step_fn):
    """A step that returns its state unchanged."""
    def step(params, opt_state, batch):
        keep = {p: weights.leaf(params, p).detach().clone() for p in weights.trainable_paths(params)}
        state = {k: v.clone() for k, v in opt_state.items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        with torch.no_grad():
            for p, t in keep.items():
                weights.leaf(params, p).copy_(t)
            for k, v in state.items():
                opt_state[k].copy_(v)
        return params, opt_state, m
    return step


def half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest."""
    def step(params, opt_state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step_fn(params, opt_state, half)
    return step


def test_a_sound_training_run_is_correct():
    result = execute("tiny.train")
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.open"])
def test_a_traced_run_profiles_a_slice_after_the_window(cell):
    bench = {"end_to_end": [], "per_layer": [{"name": "device_idle.train", "unit": "%"},
                                             {"name": "ttft_p95_ms.host", "unit": "ms"}]}
    result, r = run.execute(cell, 4, 2.0, True, CPU, bench=bench, base=FIXTURE)
    assert result["correct"] and r.traced and r.traced[0].t0 >= r.t1
    assert r.trace.window_s > 0 and "device_ops" in result["breakdown"]
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_a_broken_training_step_is_not_correct(fault):
    result = execute("tiny.train", fault)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", ["tiny.backlog", "tiny.open"])
def test_a_token_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from vcoder_tpu_torch.serve import paged_engine

    assert execute(cell)["correct"]
    real = paged_engine._paged_decode_all_n

    def altered(*args, **kwargs):
        toks, nxt = real(*args, **kwargs)
        toks = (toks + 1) % 256
        return toks, toks[-1].clone()

    monkeypatch.setattr(paged_engine, "_paged_decode_all_n", altered)
    result = execute(cell)
    assert not result["correct"], result["check"]


def test_the_control_and_the_half_batch_read_above_the_limits():
    cell = spec.cell("tiny.train", FIXTURE / "cells")
    out = control.training(cell, 23, CPU, base=FIXTURE)
    for reading in (out["fp8"], out["half_batch"]):
        assert any(reading[k] > cell["check"][k] for k in cell["check"]), reading


def test_without_a_card_nothing_is_measured(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "ds-mistral-7b.train-s3", "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_the_command_exits_non_zero_without_a_card_or_a_port(tmp_path):
    import shutil

    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ds-mistral-7b.chat-open",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


BANNED = {"jax", "jaxlib", "flax", "vcoder_tpu"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not imported(f) & BANNED, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((spec.HERE / "reference").rglob("*.py")):
        assert "vcoder_tpu_torch" not in imported(f), f
        assert imported(f) <= {"__future__", "math", "typing", "torch", "portbench"}, f
