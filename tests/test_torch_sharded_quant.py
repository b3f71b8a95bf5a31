"""Quantized and LoRA-wrapped products split over the ``model`` axis
(``vcoder_tpu_torch/parallel/spmd.py``, ``ops/quant.py``) on 4 gloo ranks at
mesh ``(1, 2, 2)``, against the same products on one device (CPU, f32).

Each weight is a layer-stacked leaf sharded by the rules
(``parallel/sharding.py``: ``fsdp`` splits it at rest, ``model`` at use) and
taken through ``spmd.layer`` as the decoder takes it:

* the row-parallel W8A8 product (``o_proj``, the contraction split in two)
  is bit-equal to one device's, and so is the gradient of each rank's input
  columns; each rank's own absmax (not reduced over ``model``) would give
  other activation scales, and that route is shown to differ;
* the column-parallel W8A8 product's local columns are bit-equal to one
  device's columns;
* below the W8A8 threshold the row-parallel int8 upcast and int4 products
  sum f32 partials: within 1e-6 relative of one device (the sum rounds in
  another order);
* a LoRA over an int8 base in a row-parallel product (its term in the
  partial sum) and in a column-parallel one: within 1e-6 relative;
* the quantized lm_head split over its columns (``column_product``): equal.

Rank bodies import no JAX (nor does this module).
"""

import numpy as np
import pytest
import torch

from vcoder_tpu_torch.parallel import launch

torch.set_num_threads(1)

MESH = (1, 2, 2)
L, K, N, M, R = 2, 64, 48, 40, 8
HEADS = (4, 2)  # (q, kv) heads the model axis divides: the blocks split


def _weights():
    rng = np.random.RandomState(0)
    w = {k: torch.from_numpy(rng.randn(L, K, N).astype(np.float32)) * 0.1
         for k in ("o_proj", "q_proj")}
    head = torch.from_numpy(rng.randn(K, 64).astype(np.float32)) * 0.1
    a = torch.from_numpy(rng.randn(L, K, R).astype(np.float32)) * 0.1
    b = torch.from_numpy(rng.randn(L, R, N).astype(np.float32)) * 0.1
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    g = torch.from_numpy(rng.randn(M, N).astype(np.float32))
    return w, head, a, b, x, g


def _trees():
    """Layer stacks: W8A8/upcast int8, int4, and LoRA over int8, each for
    the row-parallel o_proj and the column-parallel q_proj; the int4 LM
    head."""
    from vcoder_tpu_torch.lora import LoraWeight
    from vcoder_tpu_torch.ops.quant import quantize

    w, head, a, b, _, _ = _weights()

    def stack(t, bits):
        qs = [quantize(t[i], bits) for i in range(L)]
        return type(qs[0])(torch.stack([q.q for q in qs]), torch.stack([q.scale for q in qs]),
                           bits)

    trees = {}
    for bits in (8, 4):
        trees[f"int{bits}"] = {k: stack(w[k], bits) for k in w}
    trees["lora"] = {k: LoraWeight(stack(w[k], 8), a.clone(), b.clone(), 2.0) for k in w}
    return trees, quantize(head, 4)


def _products(layers, x, rows, g=None):
    """(o_proj over ``rows`` of x, q_proj: this rank's columns) at layer 1,
    and dx of the first."""
    from vcoder_tpu_torch.ops.quant import qmatmul
    from vcoder_tpu_torch.parallel import spmd

    lp = spmd.layer(layers, 1, heads=HEADS, width=N)
    xr = x[:, rows].clone().requires_grad_(g is not None)
    if lp.get("tp_attn"):
        y_row = spmd.row_parallel(xr, lp["o_proj"], qmatmul)
    else:
        y_row = qmatmul(xr, lp["o_proj"])
    dx = None
    if g is not None:
        (y_row * g).sum().backward()
        dx = xr.grad
    y_col = qmatmul(x, lp["q_proj"])
    return y_row.detach(), y_col.detach(), dx


def _rank_body(rank, world):
    import torch.distributed as dist

    from vcoder_tpu_torch.ops import quant as tq
    from vcoder_tpu_torch.parallel import make_mesh, spmd, use_mesh
    from vcoder_tpu_torch.parallel.sharding import shard_leaf

    torch.set_num_threads(1)
    m = make_mesh(data=MESH[0], fsdp=MESH[1], model=MESH[2])
    mr, nm = m.local_rank("model"), m.shape["model"]
    rows = slice(mr * K // nm, (mr + 1) * K // nm)
    cols = slice(mr * N // nm, (mr + 1) * N // nm)
    _, _, _, _, x, g = _weights()
    trees, head = _trees()
    out = {}
    tq.W8A8_MIN_TOKENS, before = 16, tq.W8A8_MIN_TOKENS
    try:
        with use_mesh(m):
            for name, layers in trees.items():
                sharded = {k: shard_leaf(f"lm/layers/{k}", v, m) for k, v in layers.items()}
                for route, xs in (("w8a8", x), ("small", x[:8])):
                    y_row, y_col, dx = _products(sharded, xs, rows,
                                                 g[:len(xs)] if route == "w8a8" else None)
                    out[(name, route)] = dict(row=y_row.numpy(), col=y_col.numpy(),
                                              dx=None if dx is None else dx.numpy())
            # Each rank's own absmax: the partial products summed in f32.
            w = spmd.layer({"o_proj": shard_leaf("lm/layers/o_proj", trees["int8"]["o_proj"],
                                                 m)}, 1, heads=HEADS, width=N)["o_proj"]
            own = tq.w8a8_matmul(x[:, rows], w).clone()
            dist.all_reduce(own, group=m.device_mesh.get_group("model"))
            out["own_absmax"] = own.numpy()
            lm = shard_leaf("lm/lm_head", head, m)
            out["lm_head"] = spmd.column_product(x[:8], lm, tq.qmatmul).numpy()
            out["lm_head_q_local"] = tuple(lm.q.to_local().shape)
    finally:
        tq.W8A8_MIN_TOKENS = before
    return dict(out=out, rows=(rows.start, rows.stop), cols=(cols.start, cols.stop))


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(_rank_body, 4, timeout_s=180)


@pytest.fixture(scope="module")
def one_device():
    from vcoder_tpu_torch.ops import quant as tq

    _, _, _, _, x, g = _weights()
    trees, head = _trees()
    out = {}
    tq.W8A8_MIN_TOKENS, before = 16, tq.W8A8_MIN_TOKENS
    try:
        for name, layers in trees.items():
            for route, xs in (("w8a8", x), ("small", x[:8])):
                y_row, y_col, dx = _products(layers, xs, slice(None),
                                             g[:len(xs)] if route == "w8a8" else None)
                out[(name, route)] = dict(row=y_row.numpy(), col=y_col.numpy(),
                                          dx=None if dx is None else dx.numpy())
        out["lm_head"] = tq.qmatmul(x[:8], head).numpy()
    finally:
        tq.W8A8_MIN_TOKENS = before
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", ["int8", "int4", "lora"])
def test_row_parallel_w8a8_is_bit_equal(ranks, one_device, name):
    want = one_device[(name, "w8a8")]
    for res in ranks:
        got = res["out"][(name, "w8a8")]
        if name == "lora":  # the LoRA term is summed in f32 over the model ranks
            assert _rel(got["row"], want["row"]) <= 1e-6
        else:
            np.testing.assert_array_equal(got["row"], want["row"])
        # Straight-through backward: this rank's input columns of dx.
        np.testing.assert_array_equal(got["dx"], want["dx"][:, slice(*res["rows"])])
        assert np.abs(got["dx"]).max() > 0


def test_own_absmax_per_rank_would_differ(ranks, one_device):
    want = one_device[("int8", "w8a8")]["row"]
    for res in ranks:
        gap = _rel(res["out"]["own_absmax"], want)
        assert gap > 1e-4, gap  # quantization, not rounding, apart
        assert not np.array_equal(res["out"][("int8", "w8a8")]["row"],
                                  res["out"]["own_absmax"])


@pytest.mark.parametrize("name", ["int8", "int4", "lora"])
def test_column_parallel_products_are_local_columns(ranks, one_device, name):
    for route in ("w8a8", "small"):
        want = one_device[(name, route)]["col"]
        for res in ranks:
            got = res["out"][(name, route)]["col"]
            want_cols = want[:, slice(*res["cols"])]
            if name == "lora":
                assert _rel(got, want_cols) <= 1e-6
            else:
                np.testing.assert_array_equal(got, want_cols)


@pytest.mark.parametrize("name", ["int8", "int4", "lora"])
def test_row_parallel_f32_partials_below_threshold(ranks, one_device, name):
    want = one_device[(name, "small")]["row"]
    for res in ranks:
        assert _rel(res["out"][(name, "small")]["row"], want) <= 1e-6


def test_quantized_lm_head_split_over_columns(ranks, one_device):
    for res in ranks:
        # [K/2 packed rows over fsdp, 64 columns over model]
        assert res["out"]["lm_head_q_local"] == (K // 2 // MESH[1], 64 // MESH[2])
        np.testing.assert_array_equal(res["out"]["lm_head"], one_device["lm_head"])
