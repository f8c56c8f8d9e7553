from .batching import BUCKETS, LengthBucketBatcher, pick_bucket
from .packing import pack_pair_arrays, pack_sequences, packing_efficiency
from .pairs import build_pair_batches
from .tokenization import WordPieceTokenizer, load_tokenizer, train_wordpiece_vocab

__all__ = [
    "BUCKETS",
    "LengthBucketBatcher",
    "pick_bucket",
    "pack_pair_arrays",
    "pack_sequences",
    "packing_efficiency",
    "build_pair_batches",
    "WordPieceTokenizer",
    "load_tokenizer",
    "train_wordpiece_vocab",
]
