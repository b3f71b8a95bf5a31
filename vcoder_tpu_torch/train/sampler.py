"""Length-grouped batch sampling.

Replicates the reference's LengthGroupedSampler megabatch logic
(reference: train/llava_trainer.py:37-130) with numpy RNG: shuffle, slice
world_size*batch_size megabatches, sort each by length descending, split
into per-device chunks of balanced total length. The modality-grouped
variant keeps multimodal and text-only samples in separate megabatch
streams; the VCoder trainers drop the language stream since every sample
is multimodal (reference: vcoder_llava_trainer.py:60-80).

A copy of ``vcoder_tpu/train/sampler.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(
    indices: Sequence[int], lengths: Sequence[int], num_chunks: int
) -> List[List[int]]:
    """Greedy balanced split (reference: llava_trainer.py:37-57)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    num_indices_per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    chunks_lengths = [0] * num_chunks
    for index in indices:
        shortest_chunk = chunks_lengths.index(min(chunks_lengths))
        chunks[shortest_chunk].append(index)
        chunks_lengths[shortest_chunk] += lengths[index]
        if len(chunks[shortest_chunk]) == num_indices_per_chunk:
            chunks_lengths[shortest_chunk] = float("inf")
    return chunks


def get_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    rng: Optional[np.random.RandomState] = None,
) -> List[int]:
    rng = rng or np.random.RandomState(0)
    indices = rng.permutation(len(lengths)).tolist()
    megabatch_size = world_size * batch_size
    megabatches = [
        indices[i : i + megabatch_size]
        for i in range(0, len(lengths), megabatch_size)
    ]
    megabatches = [
        sorted(m, key=lambda i: lengths[i], reverse=True)
        for m in megabatches
    ]
    megabatches = [
        split_to_even_chunks(m, lengths, world_size) for m in megabatches
    ]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    world_size: int,
    rng: Optional[np.random.RandomState] = None,
) -> List[int]:
    """reference: llava_trainer.py:60-86. Falls back to plain length
    grouping when one modality stream is empty (the VCoder trainers'
    all-multimodal case)."""
    rng = rng or np.random.RandomState(0)
    assert all(l != 0 for l in lengths), "Should not have zero length."
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    if not mm or not lang:
        return get_length_grouped_indices(
            [abs(l) for l in lengths], batch_size, world_size, rng
        )
    mm_indices, mm_lengths = zip(*mm)
    lang_indices, lang_lengths = zip(*lang)
    mm_shuffle = [
        mm_indices[i]
        for i in get_length_grouped_indices(
            mm_lengths, batch_size, world_size, rng
        )
    ]
    lang_shuffle = [
        lang_indices[i]
        for i in get_length_grouped_indices(
            lang_lengths, batch_size, world_size, rng
        )
    ]
    megabatch_size = world_size * batch_size
    mm_megabatches = [
        mm_shuffle[i : i + megabatch_size]
        for i in range(0, len(mm_shuffle), megabatch_size)
    ]
    lang_megabatches = [
        lang_shuffle[i : i + megabatch_size]
        for i in range(0, len(lang_shuffle), megabatch_size)
    ]
    last_mm = mm_megabatches[-1] if mm_megabatches else []
    last_lang = lang_megabatches[-1] if lang_megabatches else []
    additional_batch = last_mm + last_lang
    megabatches = mm_megabatches[:-1] + lang_megabatches[:-1]
    perm = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in perm]
    if additional_batch:
        megabatches.append(sorted(additional_batch))
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterable of dataset indices (reference: llava_trainer.py:99-130)."""

    def __init__(
        self,
        batch_size: int,
        world_size: int,
        lengths: Sequence[int],
        seed: int = 0,
        group_by_modality: bool = False,
    ):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = lengths
        self.seed = seed
        self.epoch = 0
        self.group_by_modality = group_by_modality

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.group_by_modality:
            idx = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng
            )
        else:
            idx = get_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng
            )
        return iter(idx)
