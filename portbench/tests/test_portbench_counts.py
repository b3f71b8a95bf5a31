"""The FLOP and byte counts behind ``mfu.*`` and the two rooflines, against
hand counts at small shapes, and the readers' arithmetic on a made-up run."""

import types

import pytest

from portbench import counts, spec

D = {"V": 256, "D": 32, "I": 64, "L": 2, "H": 4, "KH": 2, "HD": 8, "Dv": 16, "Iv": 32,
     "n_patches": 4, "patch": 14, "tower_blocks": 1}


def brute_causal(n, H, HD):
    """Products of QK^T and PV, pair by pair."""
    return sum(2 * HD * 2 for i in range(n) for j in range(i + 1)) * H


def test_layer_params_by_hand():
    # q, k, v, o: 32*32 + 2*32*16 + 32*32; gate, up, down: 3*32*64
    assert counts.layer_params(D) == 1024 + 1024 + 1024 + 6144


@pytest.mark.parametrize("lengths", [[3], [1, 5, 9]])
def test_flash_counts_by_hand(lengths):
    f, b = counts.flash_fwd_call(D, lengths)
    assert f == sum(brute_causal(n, 4, 8) for n in lengths)
    # q and o at 4 heads, k and v at 2, bf16; the log-sum-exp f32 a head
    assert b == sum(n * (4 * 8 * 2 + 2 * 8 * 2) * 2 + n * 4 * 4 for n in lengths)
    fb, bb = counts.flash_bwd_call(D, lengths)
    assert fb == 2.5 * f
    assert bb == sum(n * (3 * 32 + 2 * 16) * 2 + n * 16 + n * (32 + 2 * 16) * 2 for n in lengths)


def test_paged_decode_counts_by_hand():
    f, b = counts.paged_decode_call(D, [5, 7])
    assert f == (5 + 7) * 4 * 8 * 2 * 2
    assert b == (5 + 7) * 2 * 2 * 8 * 2 + 2 * (2 * 4 * 8 * 2)


def test_bound_takes_the_slower_of_compute_and_bandwidth():
    assert counts.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_by_hand():
    per_token = 2 * counts.layer_params(D)
    assert counts.decode_flops(D, 10) == 2 * (per_token + 4 * 4 * 8 * 10) + 2 * 32 * 256
    T = 5
    tower = 3 * (2 * 4 * (3 * 14 * 14) * 16 + (2 * T * (4 * 16 * 16 + 2 * 16 * 32) + 4 * T * T * 16))
    proj = 2 * 12 * (16 * 32 + 32 * 32)
    assert counts.tower_flops(D, 3) == tower
    assert counts.prefill_flops(D, 6) == tower + proj + 2 * (per_token * 6 + brute_causal(6, 4, 8)) \
        + 2 * 32 * 256
    fwd = tower + proj + 2 * (per_token * 6 + brute_causal(6, 4, 8))
    bwd = 2 * per_token * 6 + 2 * 2 * brute_causal(6, 4, 8)
    seg = 2 * 4 * (16 * 32 + 32 * 32) + 2 * 4 * 32 * 32
    assert counts.train_row_flops(D, 6, 0) == fwd + bwd + seg


def test_readers_on_a_made_up_run():
    from portbench.drive import Run, Step

    run = Run(kind="serve", cell={}, dims=D, seconds=1.0, t0=0.0, t1=2.0)
    run.steps = [Step(0, 1, tokens=3, contexts=[5, 7], prefills=[6]), Step(1, 2, tokens=0)]
    run.traced = [Step(2, 3, tokens=2, contexts=[5, 7]), Step(3, 4, tokens=1, prefills=[6])]
    run.trace = types.SimpleNamespace(device_time_s=lambda names: 1e-3, busy_s=0.5, window_s=2.0,
                                      busy_in_spans=lambda name: [0.1, 0.16])
    read = lambda n: spec.metric_reader(n).read(run)  # noqa: E731
    assert read("serve_tokens_per_s") == 1.5
    assert read("rows_per_step") == 3
    flops = counts.prefill_flops(D, 6) + counts.decode_flops(D, 5) + counts.decode_flops(D, 7)
    assert read("mfu.serve") == pytest.approx(100 * flops / (2.0 * 989e12))
    bound = 2 * counts.bound_s(*counts.paged_decode_call(D, [5, 7]))
    assert read("paged_attn_roofline") == pytest.approx(100 * bound / 1e-3)
    # A decode step keeps the device 0.1 s busy, an admitted position 0.01 s:
    # the window's two steps and six positions, 0.26 s of its 2 s.
    assert read("device_idle.backlog") == pytest.approx(87.0)
    run.trace = types.SimpleNamespace(device_time_s=lambda names: None, busy_s=0.5, window_s=2.0)
    assert read("paged_attn_roofline") is None  # nothing read: no number, not 0


def test_training_idle_scales_the_slice_by_padded_positions():
    from portbench.drive import Run, Step

    run = Run(kind="train", cell={}, dims=D, seconds=1.0, t0=0.0, t1=2.0)
    run.steps = [Step(0, 1, padded=8), Step(1, 2, padded=12)]
    run.traced = [Step(2, 3, padded=10)]
    run.trace = types.SimpleNamespace(busy_s=0.4, window_s=3.0)
    # 0.04 s a padded position in the slice, 20 positions in the window.
    assert spec.metric_reader("device_idle.train").read(run) == pytest.approx(60.0)
    run.steps[0].tokens, run.steps[1].tokens = 6, 9
    assert spec.metric_reader("pad_share.train").read(run) == pytest.approx(25.0)


def test_busy_time_inside_each_span():
    from portbench.trace import Trace

    tr = Trace.__new__(Trace)
    tr._union = [(0, 10), (20, 30), (40, 50)]
    tr.spans = [("step", 25, 60), ("feed", 0, 60), ("step", 5, 25)]
    assert tr.busy_in_spans("step") == pytest.approx([10e-9, 15e-9])
