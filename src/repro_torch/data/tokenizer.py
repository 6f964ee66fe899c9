"""Byte-level tokenizer (ids 0..255 = bytes; specials above)."""
from __future__ import annotations

import numpy as np

PAD = 256
BOS = 257
EOS = 258
VOCAB = 260  # padded to a small multiple


def encode(text: str, *, bos: bool = False, eos: bool = False) -> list[int]:
    ids = list(text.encode("utf-8"))
    if bos:
        ids = [BOS] + ids
    if eos:
        ids = ids + [EOS]
    return ids


def decode(ids) -> str:
    bs = bytes(int(i) for i in ids if 0 <= int(i) < 256)
    return bs.decode("utf-8", errors="replace")


def pad_batch(seqs: list[list[int]], length: int, *, left: bool = True) -> np.ndarray:
    out = np.full((len(seqs), length), PAD, np.int32)
    for i, s in enumerate(seqs):
        s = s[-length:] if left else s[:length]
        if left:
            out[i, length - len(s):] = s
        else:
            out[i, :len(s)] = s
    return out
