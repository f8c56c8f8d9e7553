from .batching import BUCKETS, LengthBucketBatcher, pad_to_bucket, pick_bucket
from .packing import pack_pair_arrays, pack_sequences, packing_efficiency
from .pairs import (
    build_packed_pair_batches,
    build_pair_batches,
    build_sequence_batches,
    packed_pair_batches_from_rows,
)
from .tokenization import WordPieceTokenizer, load_tokenizer, train_wordpiece_vocab

__all__ = [
    "BUCKETS",
    "LengthBucketBatcher",
    "pad_to_bucket",
    "pick_bucket",
    "pack_pair_arrays",
    "pack_sequences",
    "packing_efficiency",
    "build_pair_batches",
    "build_packed_pair_batches",
    "build_sequence_batches",
    "packed_pair_batches_from_rows",
    "WordPieceTokenizer",
    "load_tokenizer",
    "train_wordpiece_vocab",
]
