"""Leaf paths of the port's parameter trees.

A leaf's path is its dict keys and list indices joined by ``/``; a
quantized leaf contributes its ``q`` and ``scale`` fields and a LoRA wrapper
its ``base``, ``a``, ``b`` (and ``idx``) fields: the convention of
the JAX package's ``parallel/sharding.py::_path_str`` over its pytrees, of
which this is the port's copy for plain dictionaries (``quant.py`` builds the
same paths while it walks). Stage masks, adapter exports and trainer
checkpoints key their tensors by these paths, so they line up with the JAX
package's.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from vcoder_tpu_torch.lora import LoraWeight, MultiLoraWeight
from vcoder_tpu_torch.ops.quant import QuantizedTensor


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of ``tree``, depth first in key order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif isinstance(tree, QuantizedTensor):
        items = (("q", tree.q), ("scale", tree.scale))
    elif isinstance(tree, LoraWeight):
        items = (("base", tree.base), ("a", tree.a), ("b", tree.b))
    elif isinstance(tree, MultiLoraWeight):
        items = (("base", tree.base), ("a", tree.a), ("b", tree.b), ("idx", tree.idx))
    else:
        yield prefix, tree
        return
    for key, value in items:
        yield from named_leaves(value, f"{prefix}/{key}" if prefix else str(key))
