"""Self-contained word-level tokenizer (HF call protocol).

Production checkpoints ship a sentencepiece Llama tokenizer loaded via
transformers (reference: model/builder.py AutoTokenizer). For offline
tests, demos, and training-from-scratch on machines with no tokenizer
assets, this word-level tokenizer implements the same protocol surface the
framework touches: ``tokenizer(text).input_ids`` with a leading BOS,
``decode``, ``bos/eos/pad_token_id``. It persists as
``vcoder_tokenizer.json`` inside a checkpoint directory, where
``vcoder_tpu_torch.builder._load_tokenizer`` discovers it.

A copy of ``vcoder_tpu/simple_tokenizer.py`` for the PyTorch port, which imports nothing
of ``vcoder_tpu``; keep the two in step.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Sequence

FILENAME = "vcoder_tokenizer.json"

# Special tokens lex as single units ("</s>" -> EOS), matching Llama
# sentencepiece behavior the preprocess masking arithmetic relies on.
_TOKEN_RE = re.compile(r"</s>|<s>|<pad>|<unk>|[a-zA-Z']+|\d|[^\sa-zA-Z\d]")


class Encoding:
    def __init__(self, input_ids: List[int]):
        self.input_ids = input_ids


class SimpleTokenizer:
    """Word-level vocab with BOS prefixing (Llama-like encode shape)."""

    def __init__(self, vocab=None, add_bos: bool = True):
        self.vocab = dict(vocab) if vocab else {
            "<pad>": 0,
            "<s>": 1,
            "</s>": 2,
            "<unk>": 3,
        }
        self.inv = {v: k for k, v in self.vocab.items()}
        self.add_bos = add_bos
        self.frozen = vocab is not None

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 3
    pad_token = "<pad>"
    bos_token = "<s>"
    eos_token = "</s>"
    unk_token = "<unk>"

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        return _TOKEN_RE.findall(text)

    def _id(self, word: str) -> int:
        if word not in self.vocab:
            if self.frozen:
                return self.unk_token_id
            idx = len(self.vocab)
            self.vocab[word] = idx
            self.inv[idx] = word
        return self.vocab[word]

    def __call__(self, text: str) -> Encoding:
        ids = [self._id(w) for w in self.tokenize(text)]
        if self.add_bos:
            ids = [self.bos_token_id] + ids
        return Encoding(ids)

    def encode(self, text: str) -> List[int]:
        return self(text).input_ids

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._id(tokens)
        return [self._id(t) for t in tokens]

    def decode(
        self, ids: Sequence[int], skip_special_tokens: bool = True
    ) -> str:
        words = []
        for i in ids:
            w = self.inv.get(int(i), "<unk>")
            if skip_special_tokens and w in ("<s>", "</s>", "<pad>"):
                continue
            words.append(w)
        out = " ".join(words)
        # Re-attach punctuation for readable round-trips.
        out = re.sub(r"\s+([,.:;!?])", r"\1", out)
        return out

    # ---- persistence ----

    def save_pretrained(self, model_dir: str) -> None:
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, FILENAME), "w") as f:
            json.dump({"vocab": self.vocab, "add_bos": self.add_bos}, f)

    @staticmethod
    def from_pretrained(model_dir: str) -> "SimpleTokenizer":
        with open(os.path.join(model_dir, FILENAME)) as f:
            data = json.load(f)
        return SimpleTokenizer(
            vocab=data["vocab"], add_bos=data.get("add_bos", True)
        )

    @staticmethod
    def build_from_texts(
        texts: Sequence[str], add_bos: bool = True
    ) -> "SimpleTokenizer":
        tok = SimpleTokenizer(add_bos=add_bos)
        for t in texts:
            tok(t)
        return tok
