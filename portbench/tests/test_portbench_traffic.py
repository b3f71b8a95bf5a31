"""Each mix is the same for a seed, keeps its stated ranges, and gives every
seed the same amount of work in another order."""

import numpy as np
import pytest

from portbench import spec, traffic

MIXES = ["train-s3", "decode-backlog", "chat-open"]
DIMS = {"ds-mistral-7b": spec.dims(spec.config("ds-mistral-7b")),
        "ds-deepseek-7b": spec.dims(spec.config("ds-deepseek-7b"))}


def items(mix, seed, n=None, dims=DIMS["ds-mistral-7b"]):
    """The first block of the mix (or ``n`` items)."""
    m = spec.mix(mix)
    tr = traffic.Traffic(m, seed, dims)
    return [tr.item(i) for i in range(n or m["block"])]


@pytest.mark.parametrize("mix", MIXES)
def test_a_seed_gives_the_same_items(mix):
    a, b = items(mix, 2**31 + 77), items(mix, 2**31 + 77)
    assert [x.ids for x in a] == [x.ids for x in b]
    assert [(x.out_len, x.due, x.labels) for x in a] == [(x.out_len, x.due, x.labels) for x in b]
    c = items(mix, 2**31 + 78)
    assert [x.ids for x in a] != [x.ids for x in c]


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_keep_their_ranges_and_multiset(mix):
    m = spec.mix(mix)
    a, c = items(mix, 1), items(mix, 99)
    n = [x.n_text for x in a]
    assert m["text"]["low"] <= min(n) and max(n) <= m["text"]["high"]
    assert sorted(n) == sorted(x.n_text for x in c)
    if "sizes_seed" in m:  # the same sizes in the same order for every seed
        assert n == [x.n_text for x in c]
    for x in a:
        assert x.expanded == x.n_text + 2 * 576
        assert x.ids.count(traffic.IMAGE) == x.ids.count(traffic.SEG) == 1
        assert x.ids.index(traffic.IMAGE) + 1 == x.ids.index(traffic.DEPTH)
        assert min(t for t in x.ids if t >= 0) >= traffic.FIRST_ID or x.ids[0] == 1
    if m["kind"] == "train":
        for x in a:
            assert len(x.labels) == len(x.ids)
            assert any(l != traffic.IGNORE for l in x.labels)
    else:
        o = [x.out_len for x in a]
        assert m["output"]["low"] <= min(o) and max(o) <= m["output"]["high"]
        assert sorted(o) == sorted(x.out_len for x in c)


def test_arrivals_are_poisson_gaps_at_the_stated_rate_in_every_seed():
    m = spec.mix("chat-open")
    a, c = items("chat-open", 3), items("chat-open", 4)
    gaps = np.diff([0.0] + [x.due for x in a])
    assert sorted(np.round(gaps, 9)) == sorted(np.round(np.diff([0.0] + [x.due for x in c]), 9))
    assert abs(gaps.mean() * m["rate_per_s"] - 1) < 0.05
    assert all(x.due == 0.0 for x in items("decode-backlog", 3, 8))


def test_pictures_are_seeded():
    import torch

    d = DIMS["ds-mistral-7b"]
    a = traffic.pictures(5, "chat-open", 3, d, "cpu")
    assert a.shape == (3, 336, 336, 3) and a.dtype == torch.bfloat16
    assert torch.equal(a, traffic.pictures(5, "chat-open", 3, d, "cpu"))
    assert not torch.equal(a, traffic.pictures(5, "chat-open", 4, d, "cpu"))
