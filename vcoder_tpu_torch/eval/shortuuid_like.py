"""Tiny stand-in for the ``shortuuid`` dependency (answer ids only).

A copy of ``vcoder_tpu/eval/shortuuid_like.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step. Unlike that copy,
an id is always 22 characters: ``shortuuid`` pads a number with fewer
base-57 digits with the alphabet's first character, where the JAX copy
returns 21 (about one id in 45).
"""

import uuid as _uuid

_ALPHABET = "23456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def uuid() -> str:
    n = _uuid.uuid4().int
    out = []
    while n and len(out) < 22:
        n, r = divmod(n, len(_ALPHABET))
        out.append(_ALPHABET[r])
    return "".join(out).ljust(22, _ALPHABET[0])
