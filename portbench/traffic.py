"""The one traffic generator: it reads a mix's data file and makes the rows
or requests of a run from ``--seed``.

Every seed gets the same multiset of sizes and the same arrival gaps, in
another order: within each block of ``block`` items the lengths (and gaps)
are the quantiles ``(i + 0.5) / block`` of the mix's distribution, shuffled
by the seed. So seeds change the order and the content, not the amount of
work. A mix that states ``sizes_seed`` shuffles its sizes by that number
instead, the same for every seed: the training mix, whose window takes the
batches the program's sampler draws from part of an epoch, so that every
seed's window holds the same work. Token ids are drawn from the seed; pictures are seeded, preprocessed
``[3, S, S, 3]`` stacks (RGB, seg, depth) made on the device in bf16.

A prompt is ``[bos] + system + <image><depth><seg> + question`` with the
sentinel cluster the VCoder-DS tokenizer emits (image, depth, seg), so it
splices to ``n_text + 2 * n_patches`` positions (the DS splice drops the
depth block). A training row is the same with an answer after the question
whose tokens are the labels.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from portbench import spec

IMAGE, SEG, DEPTH = -200, -300, -400
IGNORE = -100
FIRST_ID = 3  # below it: pad, bos and eos of the Llama-style vocabularies


@dataclasses.dataclass
class Item:
    index: int
    ids: List[int]
    n_text: int  # text positions, bos included
    expanded: int  # positions after the splice
    labels: Optional[List[int]] = None
    out_len: int = 0  # tokens to serve
    due: float = 0.0  # seconds after the first arrival


def quantiles(dist: dict, n: int, kind: str = "loguniform") -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    if kind == "loguniform":
        lo, hi = np.log(dist["low"]), np.log(dist["high"])
        return np.rint(np.exp(lo + u * (hi - lo))).astype(np.int64)
    if kind == "exponential":
        return -np.log1p(-u) / float(dist["rate_per_s"])
    raise ValueError(kind)


class Traffic:
    """Items of one mix under one seed, by index (deterministic and
    independent of the order they are asked for)."""

    def __init__(self, mix: dict, seed: int, dims: dict):
        self.mix, self.seed, self.dims = mix, seed, dims
        self.block = int(mix.get("block", 64))
        self._cache = {}
        self._due: List[float] = []

    def _draw(self, key: str, dist: dict, i: int, kind="loguniform"):
        b = i // self.block
        if (key, b) not in self._cache:
            vals = quantiles(dist, self.block, kind)
            seed = self.mix.get("sizes_seed", self.seed)
            perm = spec.seed_stream(seed, self.mix["name"], key, b).permutation(self.block)
            self._cache[(key, b)] = vals[perm]
        return self._cache[(key, b)][i % self.block]

    def due(self, i: int) -> float:
        """Arrival time of item ``i`` (0 for a backlog)."""
        if self.mix.get("arrival") != "poisson":
            return 0.0
        while len(self._due) <= i:
            k = len(self._due)
            last = self._due[-1] if self._due else 0.0
            self._due.append(last + float(self._draw("gap", self.mix, k, "exponential")))
        return self._due[i]

    def item(self, i: int) -> Item:
        d, m = self.dims, self.mix
        n_text = int(self._draw("text", m["text"], i))
        rng = spec.seed_stream(self.seed, m["name"], "ids", i)
        body = rng.integers(FIRST_ID, d["V"], size=n_text - 1).tolist()
        pre = (n_text - 1) // 4
        ids = [d["bos"]] + body[:pre] + [IMAGE, DEPTH, SEG] + body[pre:]
        it = Item(index=i, ids=ids, n_text=n_text, expanded=n_text + 2 * d["n_patches"])
        if m["kind"] == "train":
            # The answer: the second half of what follows the pictures.
            post = n_text - 1 - pre
            answer = post - post // 2
            it.labels = [IGNORE] * (len(ids) - answer) + ids[len(ids) - answer:]
        else:
            it.out_len = int(self._draw("output", m["output"], i))
            it.due = self.due(i)
        return it


def pictures(seed: int, mix_name: str, index: int, dims: dict, device):
    """The preprocessed ``[3, S, S, 3]`` stack (image, seg, depth) of item
    ``index``, bf16 on ``device``."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(spec.torch_seed(seed, mix_name, "pictures", index))
    S = dims["image"]
    return torch.randn((3, S, S, 3), generator=g, device=device, dtype=torch.bfloat16)
