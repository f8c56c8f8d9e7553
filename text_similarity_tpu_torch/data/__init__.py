from .batching import BUCKETS, LengthBucketBatcher, pick_bucket
from .pairs import build_pair_batches
from .tokenization import WordPieceTokenizer, load_tokenizer, train_wordpiece_vocab

__all__ = [
    "BUCKETS",
    "LengthBucketBatcher",
    "pick_bucket",
    "build_pair_batches",
    "WordPieceTokenizer",
    "load_tokenizer",
    "train_wordpiece_vocab",
]
