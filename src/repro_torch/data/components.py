"""ML-specific pipeline components: tokenize, pack, split, dedup, filter.

These are the paper's "transform the original data to get a derived version
of the dataset" made concrete for LM training: text records in, fixed-length
packed token sequences out — the snapshot a training job checks out.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..core.dataset import Record
from ..core.transforms import Component, RunContext

__all__ = ["ByteTokenizer", "TokenizeComponent", "PackComponent",
           "SplitComponent", "DedupComponent", "LengthFilterComponent",
           "encode_packed", "decode_packed"]

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_SPECIALS = 3


class ByteTokenizer:
    """Deterministic byte-level tokenizer (vocab = 256 + specials).

    Production swaps in a learned BPE via the same interface; for platform/
    training tests a dependency-free reversible tokenizer is the right tool.
    """

    vocab_size = 256 + _SPECIALS

    def encode(self, text: bytes, add_bos: bool = True,
               add_eos: bool = True) -> List[int]:
        ids = [b + _SPECIALS for b in text]
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids) -> bytes:
        return bytes(int(i) - _SPECIALS for i in ids
                     if int(i) >= _SPECIALS)


class TokenizeComponent(Component):
    """text record -> token-array record (.npy payload)."""

    per_record = True  # record-wise + deterministic: incremental-safe

    def __init__(self, tokenizer: Optional[ByteTokenizer] = None,
                 name: str = "tokenize") -> None:
        super().__init__(name=name)
        self.tok = tokenizer or ByteTokenizer()

    def process(self, records, ctx: RunContext) -> Iterator[Record]:
        for rec in records:
            ids = np.asarray(self.tok.encode(rec.data), np.int32)
            buf = io.BytesIO()
            np.save(buf, ids, allow_pickle=False)
            ctx.bump(f"{self.name}.tokens", float(ids.size))
            yield Record(rec.record_id, buf.getvalue(),
                         {**rec.attrs, "n_tokens": int(ids.size),
                          "format": "tokens.npy"})


class PackComponent(Component):
    """Token records -> packed fixed-length sequences with segment ids.

    Documents are concatenated greedily; each output record holds
    ``tokens``, ``segments`` (per-token document index within the pack) and
    ``positions`` (restarting at each document) plus the source record ids
    (lineage at *record* granularity: revoking a source doc identifies the
    packs that contain it).
    """

    def __init__(self, seq_len: int, name: str = "pack") -> None:
        super().__init__(name=name, seq_len=seq_len)
        self.seq_len = seq_len

    def process(self, records, ctx: RunContext) -> Iterator[Record]:
        L = self.seq_len + 1          # +1 so tokens/labels both get seq_len
        buf_tokens: List[int] = []
        buf_segments: List[int] = []
        buf_positions: List[int] = []
        buf_sources: List[str] = []
        seg = 0
        out_idx = 0

        def flush():
            nonlocal buf_tokens, buf_segments, buf_positions, buf_sources, \
                seg, out_idx
            toks = np.asarray(buf_tokens[:L], np.int32)
            segs = np.asarray(buf_segments[:L], np.int32)
            pos = np.asarray(buf_positions[:L], np.int32)
            if toks.size < L:
                pad = L - toks.size
                toks = np.pad(toks, (0, pad), constant_values=PAD_ID)
                segs = np.pad(segs, (0, pad), constant_values=-1)
                pos = np.pad(pos, (0, pad))
            rec = Record(
                f"pack-{ctx.shard_index:03d}-{out_idx:06d}",
                encode_packed(toks, segs, pos),
                {"format": "packed.bin", "seq_len": self.seq_len,
                 "sources": json.dumps(buf_sources)})
            buf_tokens = buf_tokens[L:]
            buf_segments = buf_segments[L:]
            buf_positions = buf_positions[L:]
            buf_sources = []
            out_idx += 1
            return rec

        for rec in records:
            ids = np.load(io.BytesIO(rec.data), allow_pickle=False)
            buf_tokens.extend(int(i) for i in ids)
            buf_segments.extend([seg] * ids.size)
            buf_positions.extend(range(ids.size))
            buf_sources.append(rec.record_id)
            seg += 1
            while len(buf_tokens) >= L:
                ctx.bump(f"{self.name}.packs")
                yield flush()
        if buf_tokens:
            ctx.bump(f"{self.name}.packs")
            yield flush()


class SplitComponent(Component):
    """Deterministically assign split attrs by record-id hash."""

    per_record = True

    def __init__(self, eval_fraction: float = 0.05, name: str = "split"):
        super().__init__(name=name, eval_fraction=eval_fraction)
        self.eval_fraction = eval_fraction

    def process(self, records, ctx):
        for rec in records:
            h = int(hashlib.sha256(rec.record_id.encode()).hexdigest()[:8], 16)
            split = "eval" if (h % 10_000) < self.eval_fraction * 10_000 \
                else "train"
            yield Record(rec.record_id, rec.data, {**rec.attrs, "split": split})


class DedupComponent(Component):
    """Exact-content dedup (content hash) — classic data-cleanup stage."""

    def __init__(self, name: str = "dedup"):
        super().__init__(name=name)

    def process(self, records, ctx):
        seen = set()
        for rec in records:
            h = hashlib.sha256(rec.data).hexdigest()
            if h in seen:
                ctx.bump(f"{self.name}.dropped")
                continue
            seen.add(h)
            yield rec


class LengthFilterComponent(Component):
    per_record = True

    def __init__(self, min_bytes: int = 1, max_bytes: int = 1 << 20,
                 name: str = "length_filter"):
        super().__init__(name=name, min_bytes=min_bytes, max_bytes=max_bytes)
        self.min_bytes, self.max_bytes = min_bytes, max_bytes

    def process(self, records, ctx):
        for rec in records:
            if self.min_bytes <= len(rec.data) <= self.max_bytes:
                yield rec
            else:
                ctx.bump(f"{self.name}.dropped")


# Packed-sequence payload format.  v1 datasets stored ``.npz`` blobs, but
# ``np.load``'s zipfile parsing costs ~700us per record — far more than the
# loader's entire per-batch budget — so packs are now a raw header + three
# little-endian int32 arrays.  ``decode_packed`` sniffs the magic and falls
# back to npz so pre-existing checked-in datasets stay readable.
_PACK_MAGIC = b"RPK1"
_PACK_HDR = struct.Struct("<4sI")


def encode_packed(tokens: np.ndarray, segments: np.ndarray,
                  positions: np.ndarray) -> bytes:
    """Serialize one packed sequence (three equal-length int32 arrays)."""
    n = len(tokens)
    if len(segments) != n or len(positions) != n:
        raise ValueError("packed arrays must share one length")
    return (_PACK_HDR.pack(_PACK_MAGIC, n)
            + np.ascontiguousarray(tokens, "<i4").tobytes()
            + np.ascontiguousarray(segments, "<i4").tobytes()
            + np.ascontiguousarray(positions, "<i4").tobytes())


def decode_packed(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if data[:4] == _PACK_MAGIC:
        (_, n) = _PACK_HDR.unpack_from(data)
        arr = np.frombuffer(data, dtype="<i4", count=3 * n,
                            offset=_PACK_HDR.size)
        return arr[:n], arr[n:2 * n], arr[2 * n:]
    z = np.load(io.BytesIO(data), allow_pickle=False)  # legacy npz payloads
    return z["tokens"], z["segments"], z["positions"]
