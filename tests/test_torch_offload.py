"""The port's optimizer-state offload (the zero3_offload analog) on the CPU.

``Trainer(offload_opt_state=True)`` / ``make_train_step(offload_shardings=...)``
keep every shaped state leaf in host memory (on a CPU mesh: ordinary CPU
memory, the same code path as the card's pinned memory minus the copy
streams) and stream it through staging buffers a chunk at a time. The
chunks are cut small here (``OFFLOAD_CHUNK_BYTES`` patched to 256 bytes) so
every leaf of the tiny model spans several of them.

* Against JAX: the ``full`` stage on ``VCoderConfig.tiny("vcoder_ds_llava")``,
  2 steps offloaded, from weights carried by ``from_jax_params``, against
  the JAX package's resident step (optax): the loss 1e-5 relative, every
  parameter and moment 1e-6 absolute + 1e-4 relative
  (``test_torch_train_step.py::test_four_steps_match_optax``'s tolerances).
* Against the port's resident step: bit-equal parameters and state, with
  and without ``gradient_accumulation_steps=2`` (the ``acc/`` leaves stream
  too); resume from an offloaded checkpoint is bit-exact; the ``full``
  stage's ``final/`` from ``train.train --offload-opt-state`` equals the
  resident run's byte for byte.
* The package surface of the same slice: the mesh requirement, the engines
  over a one-device mesh, the public names, ``profiling``'s trace,
  ``checkpoint.auto_upgrade`` and the streaming safetensors writer.
"""

import functools
import json
import os
import struct
import types

import jax
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.parallel.sharding import _path_str
from vcoder_tpu.train import step as jstep
from vcoder_tpu.train.collator import collate_batch as j_collate
from vcoder_tpu_torch.checkpoint import from_jax_params, read_safetensors, write_safetensors
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.parallel import (
    device_shardings_like,
    host_shardings,
    make_mesh,
    single_device_mesh,
)
from vcoder_tpu_torch.train import step as tstep
from vcoder_tpu_torch.train.collator import collate_batch as t_collate
from vcoder_tpu_torch.train.trainer import TrainArgs, Trainer
from vcoder_tpu_torch.tree import named_leaves

torch.set_num_threads(1)

STAGE = "full"


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(tstep, "OFFLOAD_CHUNK_BYTES", 256)


def _samples(cfg, n=2, seed=0):
    rng = np.random.RandomState(seed)
    S = cfg.vision.image_size
    out = []
    for i in range(n):
        n_q, n_a = 2 + i % 3, 3 + i % 4
        prompt = [1] + list(rng.randint(3, 200, n_q)) + [-200, -400, -300, 17]
        answer = list(rng.randint(3, 200, n_a)) + [2]
        out.append(dict(
            input_ids=prompt + answer,
            labels=[-100] * len(prompt) + answer,
            **{m: rng.randn(S, S, 3).astype(np.float32) for m in ("image", "seg", "depth")},
        ))
    return out


def _collate_kw(cfg):
    return dict(num_patches=cfg.vision.num_patches, ds_mode=True, use_seg=True,
                use_depth=True, image_size=cfg.vision.image_size, pad_multiple=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    np_params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), jp)
    samples = _samples(jcfg)
    jbatch = j_collate(samples, as_jnp=True, **_collate_kw(jcfg))
    tbatch = t_collate(samples, device="cpu", **_collate_kw(tcfg))
    return jcfg, tcfg, np_params, jbatch, tbatch


def _offloaded(tp, opt):
    """The offloaded step and its host-resident state over a CPU mesh."""
    state = tstep.init_opt_state(tp, opt, STAGE)
    host_sh = host_shardings(state, single_device_mesh("cpu"))
    state = {k: host_sh[k].place(t).clone() for k, t in state.items()}
    return state, (device_shardings_like(host_sh), host_sh)


def test_offloaded_full_stage_matches_jax_resident(setup):
    jcfg, tcfg, np_params, jbatch, tbatch = setup
    jopt = jstep.make_optimizer(1e-2, 10)
    jp = jax.tree.map(jax.numpy.asarray, np_params)
    jstate = jstep.init_opt_state(jp, jopt, STAGE)
    jfn = jstep.make_train_step(jcfg, jopt, stage=STAGE, attn_impl="xla", remat=False)
    topt = tstep.make_optimizer(1e-2, 10)
    tp = from_jax_params(np_params, tcfg, device="cpu")
    tstate, sh = _offloaded(tp, topt)
    tfn = tstep.make_train_step(tcfg, topt, stage=STAGE, attn_impl="auto", remat="dots",
                                offload_shardings=sh)
    for _ in range(2):
        jp, jstate, jm = jfn(jp, jstate, jbatch)
        tp, tstate, tm = tfn(tp, tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    jflat = {_path_str(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    np.testing.assert_allclose(tp["lm"]["layers"]["q_proj"].detach().numpy(), jflat["lm/layers/q_proj"],
                               atol=1e-6, rtol=1e-4)
    assert not np.allclose(jflat["lm/layers/q_proj"], np_params["lm"]["layers"]["q_proj"])
    for path, t in named_leaves(tp):
        np.testing.assert_allclose(t.detach().numpy(), jflat[path], atol=1e-6, rtol=1e-4, err_msg=path)
    jmu = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        names = [getattr(p, "name", None) for p in path]
        for field in ("mu", "nu"):
            if field in names:
                jmu[f"{field}/{_path_str(path[names.index(field) + 1:])}"] = np.asarray(leaf)
    assert set(jmu) == {k for k in tstate if k != "count"}
    for key, want in jmu.items():
        np.testing.assert_allclose(tstate[key].numpy(), want, atol=1e-6, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("accum", [1, 2], ids=["no_accum", "accum_2"])
def test_offloaded_step_is_bit_equal_to_resident(setup, accum):
    _, tcfg, np_params, _, _ = setup
    batches = [t_collate(_samples(tcfg, 2, seed), device="cpu", **_collate_kw(tcfg))
               for seed in range(4)]
    kw = dict(accum_steps=accum, max_grad_norm=1e-2)  # clipping engages

    def run(offload):
        opt = tstep.make_optimizer(1e-2, 10, **kw)
        tp = from_jax_params(np_params, tcfg, device="cpu")
        if offload:
            state, sh = _offloaded(tp, opt)
        else:
            state, sh = tstep.init_opt_state(tp, opt, STAGE), None
        fn = tstep.make_train_step(tcfg, opt, stage=STAGE, remat="dots", offload_shardings=sh)
        losses = [float(fn(tp, state, b)[2]["loss"]) for b in batches]
        return tp, state, losses, sh, fn

    rp, rs, rl, _, _ = run(False)
    op, os_, ol, (dev_sh, host_sh), fn = run(True)
    assert ol == rl
    for (path, a), (_, b) in zip(named_leaves(rp), named_leaves(op)):
        assert torch.equal(a, b), path
    assert set(rs) == set(os_)
    for key in rs:
        assert torch.equal(rs[key], os_[key]), key
    assert int(os_["count"]) == 4 // accum
    moved = tstep.trainable_leaves(op, STAGE)
    assert not torch.equal(moved["lm/layers/q_proj"],
                           torch.from_numpy(np_params["lm"]["layers"]["q_proj"]))
    # Every shaped leaf is in host memory and went through the staging
    # buffers, whose storage no state leaf or parameter shares; the 0-d leaves
    # stay on the device, apart from the host leaves.
    scalars = {"count"} | ({"mini_step", "gradient_step"} if accum > 1 else set())
    assert {k for k, s in host_sh.items() if not s.on_host} == scalars
    assert {s.memory_kind for k, s in host_sh.items() if s.on_host} == {"unpinned_host"}
    assert {s.memory_kind for s in dev_sh.values()} == {"device"}
    kinds = {"mu", "nu"} | ({"acc"} if accum > 1 else set())
    assert {k for k, _ in fn.stager.bufs} == kinds
    bufs = {b.untyped_storage().data_ptr() for b in fn.stager.bufs.values()}
    for key, t in os_.items():
        assert t.untyped_storage().data_ptr() not in bufs, key
    params = {t.untyped_storage().data_ptr() for _, t in named_leaves(op)}
    assert not params & {t.untyped_storage().data_ptr() for t in os_.values()}


def test_chunks_cover_each_leaf_along_axis_0():
    t = torch.zeros(5, 3, 7)  # rows of 84 bytes
    assert tstep.chunk_rows(t, 200) == [slice(0, 2), slice(2, 4), slice(4, 5)]
    assert tstep.chunk_rows(t, 10) == [slice(i, i + 1) for i in range(5)]
    assert tstep.chunk_rows(torch.zeros(())) == [Ellipsis]
    assert tstep.chunk_rows(torch.zeros(0, 4)) == []


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class _Samples:
    """An in-memory dataset with the ``VCoderDataset`` interface."""

    def __init__(self, cfg, n):
        self.samples = _samples(cfg, n, seed=5)
        self.modality_lengths = [len(s["input_ids"]) for s in self.samples]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _trainer(setup, tmp, offload=True, **kw):
    _, tcfg, np_params, _, _ = setup
    args = TrainArgs(output_dir=str(tmp), stage=STAGE, learning_rate=1e-2,
                     per_device_train_batch_size=2, offload_opt_state=offload,
                     dataloader_workers=0, prefetch_batches=0, save_steps=2, **kw)
    return Trainer(tcfg, from_jax_params(np_params, tcfg, device="cpu"), _Samples(tcfg, 8),
                   args, mesh=single_device_mesh("cpu"), device="cpu")


def test_trainer_offload_requires_mesh(setup, tmp_path):
    """The JAX package's ``test_trainer_offload_requires_mesh``."""
    _, tcfg, np_params, _, _ = setup
    args = TrainArgs(output_dir=str(tmp_path), stage=STAGE, offload_opt_state=True)
    with pytest.raises(ValueError, match="mesh"):
        Trainer(tcfg, from_jax_params(np_params, tcfg, device="cpu"), [], args, device="cpu")


def test_trainer_offload_places_the_state(setup, tmp_path):
    tr = _trainer(setup, tmp_path)
    assert tr.global_batch == 2 and tr.mesh.size == 1
    shaped = {k for k, t in tr.opt_state.items() if t.ndim}
    assert shaped == {k for k in tr.opt_state if k != "count"}
    assert all(tr.opt_state[k].device.type == "cpu" and not tr.opt_state[k].any()
               for k in shaped)
    assert tr.step_fn.stager.host_keys == frozenset(shaped)
    resident = _trainer(setup, tmp_path / "r", offload=False)
    assert resident.step_fn.stager is None and set(resident.opt_state) == set(tr.opt_state)


def test_resume_from_offloaded_checkpoint_is_bit_exact(setup, tmp_path):
    full = _trainer(setup, tmp_path / "full")
    full.train(max_steps=4)
    part = _trainer(setup, tmp_path / "part")
    part.train(max_steps=2)  # saves checkpoint-2
    state = read_safetensors(str(tmp_path / "part" / "checkpoint-2" / "state.safetensors"))
    assert {k[4:] for k in state if k.startswith("opt/")} == set(part.opt_state)
    resumed = _trainer(setup, tmp_path / "part")
    host = {k: t for k, t in resumed.opt_state.items() if t.ndim}
    assert resumed.maybe_resume() and resumed.step == 2
    assert all(resumed.opt_state[k] is t for k, t in host.items())  # read in place
    resumed.train(max_steps=4)
    for (path, a), (_, b) in zip(named_leaves(full.params), named_leaves(resumed.params)):
        assert torch.equal(a, b), path
    for key, t in full.opt_state.items():
        assert torch.equal(t, resumed.opt_state[key]), key


# ---------------------------------------------------------------------------
# The driver: train.train --stage full --offload-opt-state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llava_base(tmp_path_factory):
    from tests.test_train_pipeline import KEYS, _make_cost_tree
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.models.vcoder import init_vcoder_params
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    root = str(tmp_path_factory.mktemp("llava_data"))
    _make_cost_tree(root)
    mix = [{"id": str(i), "image": f"coco/train2017/{k}",
            "conversations": [{"from": "human", "value": "<image>\nWhat objects can be seen "
                                                          "in the image?"},
                              {"from": "gpt", "value": "two people, a car"}]}
           for i, k in enumerate(KEYS)]
    with open(os.path.join(root, "mix.json"), "w") as f:
        json.dump(mix, f)
    cfg = TConfig.tiny("llava")
    d = str(tmp_path_factory.mktemp("base") / "llava-tiny")
    save_pretrained(d, init_vcoder_params(cfg, seed=0, device="cpu", dtype=torch.float32), cfg)
    SimpleTokenizer.build_from_texts(
        ["USER: ASSISTANT: What objects can be seen in the image? two people, a car"]
    ).save_pretrained(d)
    return dict(root=root, base=d)


def test_driver_offloaded_full_stage_writes_the_resident_final(llava_base, tmp_path):
    from vcoder_tpu_torch.train import train as ttrain

    outs = {}
    for name, extra in (("resident", []), ("offloaded", ["--offload-opt-state"])):
        out = str(tmp_path / name)
        trainer = ttrain.main([
            "--stage", "full", "--model-path", llava_base["base"], "--output-dir", out,
            "--data-path", os.path.join(llava_base["root"], "mix.json"),
            "--image-folder", llava_base["root"], "--max-steps", "2", "--save-steps", "2",
            "--per-device-train-batch-size", "2", "--model-max-length", "128",
            "--device", "cpu"] + extra)
        assert trainer.step == 2 and trainer.mesh.size == 1
        assert (trainer.step_fn.stager is not None) == bool(extra)
        outs[name] = out
    files = sorted(os.listdir(os.path.join(outs["resident"], "final")))
    assert "model.safetensors" in files
    assert sorted(os.listdir(os.path.join(outs["offloaded"], "final"))) == files
    for f in files:
        with open(os.path.join(outs["resident"], "final", f), "rb") as a, \
                open(os.path.join(outs["offloaded"], "final", f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(outs["offloaded"], "final", "config.json")) as f:
        assert json.load(f)["model_type"] == "llava"
    # The package's lazy entry point loads what the stage wrote.
    import vcoder_tpu_torch

    tok, model, *_ = vcoder_tpu_torch.load_pretrained_model(
        os.path.join(outs["offloaded"], "final"), device="cpu")
    assert model.config.model_type == "llava" and tok is not None


# ---------------------------------------------------------------------------
# The engines over a one-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_engines_over_a_one_device_mesh_give_the_unmeshed_tokens(kind):
    from vcoder_tpu_torch.models.vcoder import init_vcoder_params
    from vcoder_tpu_torch.serve.engine import ServingEngine
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    cfg = TConfig.tiny("vcoder_ds_llava")
    params = init_vcoder_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    S = cfg.vision.image_size
    px = np.random.RandomState(1).randn(1, S, S, 3).astype(np.float32)
    make = (functools.partial(ServingEngine, max_len=256) if kind == "slot"
            else functools.partial(PagedServingEngine, max_len=256, page_size=8))
    got = []
    for mesh in (None, single_device_mesh("cpu")):
        eng = make(cfg, params, max_batch=2, attn_impl="xla", device="cpu", mesh=mesh)
        rids = [eng.add_request([1, 10 + i, 11, -200, -400, -300, 12, 13 + i], images=px,
                                segs=px, depths=px, max_new_tokens=4) for i in range(2)]
        res = eng.run()
        got.append([res[r] for r in rids])
    assert got[0] == got[1] and all(len(v) == 4 for v in got[0])
    # A plain mesh of two devices raises; two ranks of a process group serve.
    with pytest.raises(NotImplementedError, match="multi-device.*torch.distributed.run"):
        make(cfg, params, device="cpu", mesh=make_mesh(["cpu", "cpu"], data=2))
    from tests.test_torch_sharding import engine_rank
    from vcoder_tpu_torch.parallel import launch

    reqs = [([1, 10 + i, 11, -200, -400, -300, 12, 13 + i], px, 4) for i in range(2)]
    ranks = launch.spawn(engine_rank, 2, kind, (2, 1, 1), reqs, {"max_batch": 2},
                         timeout_s=120)
    assert ranks == [got[0]] * 2


# ---------------------------------------------------------------------------
# The package API, profiling, auto_upgrade, the safetensors writer
# ---------------------------------------------------------------------------


def _public(pkg):
    return {n for n, v in vars(pkg).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_package_api_matches_jax():
    import vcoder_tpu
    import vcoder_tpu_torch
    from vcoder_tpu_torch import load_pretrained_model, process_images  # noqa: F401
    from vcoder_tpu_torch import preprocess

    assert _public(vcoder_tpu_torch) == _public(vcoder_tpu)
    for name in _public(vcoder_tpu):
        ref = getattr(vcoder_tpu, name)
        if isinstance(ref, (int, str)):
            assert getattr(vcoder_tpu_torch, name) == ref, name
    pic = np.random.RandomState(0).randint(0, 256, (20, 30, 3), np.uint8)
    assert torch.equal(process_images([pic], device="cpu"),
                       preprocess.process_images([pic], device="cpu"))


def test_maybe_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    from vcoder_tpu_torch import profiling

    monkeypatch.delenv("VCODER_TPU_TRACE", raising=False)
    with profiling.maybe_trace() as d:
        assert d is None
    logdir = str(tmp_path / "trace")
    monkeypatch.setenv("VCODER_TPU_TRACE", logdir)
    with profiling.maybe_trace() as d:
        with profiling.annotate("offload-region"):
            torch.ones(8).sum()
    assert d == logdir
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "offload-region" for e in events)
    with pytest.raises(NotImplementedError):
        with profiling.trace(logdir, create_perfetto_link=True):
            pass


@pytest.mark.parametrize("model_type,name", [("llama", "llava-v0-7b"), ("llama", "vicuna-7b"),
                                             ("llava", "llava-v1.5-7b")])
def test_auto_upgrade_matches_jax(tmp_path, model_type, name, capsys):
    from vcoder_tpu.checkpoint import auto_upgrade as jup
    from vcoder_tpu_torch.checkpoint import auto_upgrade as tup

    written = {}
    for tag, fn in (("jax", jup), ("torch", tup)):
        d = tmp_path / tag / name
        d.mkdir(parents=True)
        with open(d / "config.json", "w") as f:
            json.dump({"model_type": model_type, "hidden_size": 8}, f)
        fn(str(d), assume_yes=True)
        written[tag] = ((d / "config.json").read_text(), capsys.readouterr().out)
    assert written["torch"] == written["jax"]
    upgraded = json.loads(written["torch"][0])["model_type"] == "llava"
    assert upgraded == ("llava" in name)


def test_auto_upgrade_asks_without_assume_yes(tmp_path, monkeypatch):
    from vcoder_tpu_torch.checkpoint import auto_upgrade

    d = tmp_path / "llava-v0"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "llama"}))
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    with pytest.raises(SystemExit, match="aborted"):
        auto_upgrade(str(d))
    assert json.loads((d / "config.json").read_text())["model_type"] == "llama"


def _writer_before_streaming(path, state):
    """The writer as it was before it streamed: every tensor's bytes first."""
    names = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
             "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool, "U8": torch.uint8}
    names = {v: k for k, v in names.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(state):
        t = state[name].detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    hdr += b" " * (-len(hdr) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)) + hdr + b"".join(blobs))


def test_streaming_writer_is_byte_identical_and_read_by_jax(tmp_path):
    from vcoder_tpu.checkpoint import load_safetensors_state

    g = torch.Generator().manual_seed(0)
    state = {"params/b": torch.randn(3, 5, generator=g).bfloat16(),
             "opt/mu/a": torch.randn(4, 2, generator=g)[:, 0],  # not contiguous
             "empty": torch.zeros(0, 3), "step": torch.tensor(7, dtype=torch.int64),
             "mask": torch.rand(2, 2, generator=g) > 0.5,
             "h": torch.randn(2, 3, 4, generator=g).half(),
             "i": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    old, new = str(tmp_path / "old.safetensors"), str(tmp_path / "new.safetensors")
    _writer_before_streaming(old, state)
    d = tmp_path / "ckpt"
    d.mkdir()
    write_safetensors(new, state)
    write_safetensors(str(d / "model.safetensors"), state)
    with open(old, "rb") as a, open(new, "rb") as b:
        assert a.read() == b.read()
    back = read_safetensors(new)
    assert all(torch.equal(back[k], state[k]) for k in state)
    jax_side = load_safetensors_state(str(d))
    assert set(jax_side) == set(state)
    assert np.array_equal(np.asarray(jax_side["opt/mu/a"]), state["opt/mu/a"].numpy())
    assert np.array_equal(np.asarray(jax_side["params/b"], np.float32),
                          state["params/b"].float().numpy())


def test_offload_never_pins_on_a_cpu_mesh():
    """Pinning raises on a CPU-only torch: a CPU mesh's host leaves are
    ordinary memory, and zeros are made there without a pin."""
    sh = host_shardings({"mu/x": torch.ones(3), "count": torch.zeros((), dtype=torch.int32)},
                        single_device_mesh("cpu"))
    assert sh["mu/x"].memory_kind == "unpinned_host" and not sh["count"].on_host
    z = sh["mu/x"].zeros(torch.empty(4, 2, device="meta"))
    assert z.device.type == "cpu" and z.shape == (4, 2) and not z.any()
    assert torch.equal(sh["mu/x"].place(torch.ones(2)), torch.ones(2))
