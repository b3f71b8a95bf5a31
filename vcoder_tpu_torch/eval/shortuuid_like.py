"""Tiny stand-in for the ``shortuuid`` dependency (answer ids only).

A copy of ``vcoder_tpu/eval/shortuuid_like.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.
"""

import uuid as _uuid

_ALPHABET = "23456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def uuid() -> str:
    n = _uuid.uuid4().int
    out = []
    while n and len(out) < 22:
        n, r = divmod(n, len(_ALPHABET))
        out.append(_ALPHABET[r])
    return "".join(out)
