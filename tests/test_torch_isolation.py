"""The port stands alone and never runs quietly on the CPU.

* No module of ``vcoder_tpu_torch`` (nor ``chip_smoke.py``) imports ``jax``
  or ``vcoder_tpu``: the port copies what it needs.
* Without CUDA, the entry points raise unless the caller asks for the CPU.
* On CPU tensors the kernel wrappers take their plain versions: nothing is
  built or loaded, and the launch counters stay at 0.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.ops import _kernels
from vcoder_tpu_torch.ops import flash_attention as fa
from vcoder_tpu_torch.ops import vit_attention as va

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "vcoder_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "vcoder_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise paths need a CUDA-less host")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from vcoder_tpu_torch.builder import load_pretrained_model
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.models.vcoder import init_vcoder_params
    from vcoder_tpu_torch.preprocess import process_images

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_vcoder_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        process_images([np.zeros((8, 8, 3), np.uint8)])
    params = init_vcoder_params(cfg, device="cpu", dtype=torch.float32)
    save_pretrained(str(tmp_path), params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pretrained_model(str(tmp_path))
    model = load_pretrained_model(str(tmp_path), device="cpu")[1]
    assert model.device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions():
    fa.launches = va.launches = 0
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 20, 2, 8).astype(np.float32)) for _ in range(3))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)

    Dm, H = 16, 2
    layer = {n: torch.from_numpy(rng.randn(Dm, Dm).astype(np.float32))
             for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    layer.update({n: torch.zeros(Dm) for n in ("q_bias", "k_bias", "v_bias")})
    x = torch.from_numpy(rng.randn(2, 7, Dm).astype(np.float32))
    w = va.repack_block(layer, H)
    y = va.fused_block_attention(x, *w, n_heads=H)
    assert torch.equal(y, va.fused_block_attention_ref(x, *w, n_heads=H))

    assert fa.launches == 0 and va.launches == 0
    assert not _kernels._LIBS  # nothing was built or loaded


def test_other_devices_raise():
    q = torch.empty((1, 20, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(q, q, q, causal=True)


def test_paged_engine_and_worker_raise_without_cuda(no_cuda):
    from vcoder_tpu_torch.checkpoint import _map_tensors
    from vcoder_tpu_torch.models.vcoder import init_vcoder_params
    from vcoder_tpu_torch.serve.engine import ServingEngine
    from vcoder_tpu_torch.serve.engine_server import EngineWorker
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    params = init_vcoder_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServingEngine(cfg, params, max_len=256)  # device="cuda" by default
    with pytest.raises(NotImplementedError, match="from_engine"):
        EngineWorker("a/checkpoint")
    meta = _map_tensors(params, lambda t: t.to("meta"))
    with pytest.raises(ValueError, match="params lie on"):
        PagedServingEngine(cfg, meta, max_len=256, device="cpu")
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, params, device="cpu")  # the slot engine waits
    with pytest.raises(NotImplementedError):
        PagedServingEngine(cfg, params, max_len=256, device="cpu", lora_adapters={"a": {}})
    eng = PagedServingEngine(cfg, params, max_len=256, device="cpu")
    assert eng.k_pages.device.type == "cpu"


def test_paged_wrappers_take_the_plain_versions_on_cpu():
    from vcoder_tpu_torch.ops import paged_attention as pa

    pa.reset_launches()
    rng = np.random.RandomState(0)
    L, n, KH, page, D, B = 2, 6, 2, 8, 16, 2
    kp, vp = (torch.from_numpy(rng.randn(L, n, KH, page, D).astype(np.float32)) for _ in range(2))
    kq = torch.from_numpy(rng.randint(-127, 128, (L, n, KH, page, D)).astype(np.int8))
    ks = torch.from_numpy(rng.rand(L, n, KH, page).astype(np.float32))
    q = torch.from_numpy(rng.randn(B, 4, 4, D).astype(np.float32))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([12, 5], dtype=torch.int32)
    out = pa.carry_paged_attention_multi(q, kp, vp, table, lengths, 1, window=4)
    assert torch.equal(out, pa.carry_paged_attention_multi_ref(q, kp, vp, table, lengths, 1,
                                                               window=4))
    out = pa.carry_paged_attention_multi_q8(q, kq, kq, ks, ks, table, lengths, 0, window=4)
    assert torch.equal(out, pa.carry_paged_attention_multi_q8_ref(q, kq, kq, ks, ks, table,
                                                                  lengths, 0, window=4))
    out = pa.carry_paged_attention(q[:, 0], kp, vp, table, lengths, 1)
    assert torch.equal(out, pa.paged_attention_ref(q[:, 0], kp[1], vp[1], table, lengths))
    assert pa.launches_bf16 == pa.launches_q8 == pa.launches_k8 == 0
    assert not pa.launches_by_window and "paged_attn" not in _kernels._LIBS
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_attention(q[:, 0].to("meta"), kp[0], vp[0], table, lengths)


def test_quantized_matmul_wrappers_take_the_plain_versions_on_cpu():
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import quant as tq

    i4.launches = 0
    i8.reset_launches()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    qp = torch.from_numpy(rng.randint(-128, 128, (32, 40)).astype(np.int8))
    assert torch.equal(i4.int4_matmul(x, qp), i4.int4_matmul_ref(x, qp))
    a = torch.from_numpy(rng.randint(-127, 128, (20, 64)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (64, 24)).astype(np.int8))
    sa, sb = torch.rand(20, 1), torch.rand(1, 24)
    assert torch.equal(i8.int8_mm(a, b), i8.int8_mm_ref(a, b))
    assert torch.equal(i8.int8_mm_scaled(a, b, sa, sb), i8.int8_mm_scaled_ref(a, b, sa, sb))
    # Through qmatmul: the W8A8 branch and the int4 path below it.
    w4 = tq.quantize(torch.from_numpy(rng.randn(64, 24).astype(np.float32)), bits=4)
    tq.qmatmul(torch.randn(tq.W8A8_MIN_TOKENS, 64), w4)
    tq.qmatmul(torch.randn(2, 64), w4)
    assert i4.launches == i8.launches == i8.launches_scaled == 0
    assert "int4_matmul" not in _kernels._LIBS and "int8_mm" not in _kernels._LIBS
    with pytest.raises(ValueError, match="unsupported device"):
        i4.int4_matmul(x.to("meta"), qp.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        i8.int8_mm(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        i8.int8_mm_scaled(a.to("meta"), b.to("meta"), sa, sb)
