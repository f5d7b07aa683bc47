from .components import (ByteTokenizer, DedupComponent,
                         LengthFilterComponent, PackComponent,
                         SplitComponent, TokenizeComponent, decode_packed)
from .loader import DeviceFeed, LoaderState, ShardedSnapshotLoader

__all__ = [
    "ByteTokenizer", "DedupComponent", "LengthFilterComponent",
    "PackComponent", "SplitComponent", "TokenizeComponent", "decode_packed",
    "DeviceFeed", "LoaderState", "ShardedSnapshotLoader",
]
