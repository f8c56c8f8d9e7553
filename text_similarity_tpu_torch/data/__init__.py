from .batching import BUCKETS, LengthBucketBatcher, pick_bucket
from .tokenization import WordPieceTokenizer, load_tokenizer, train_wordpiece_vocab

__all__ = [
    "BUCKETS",
    "LengthBucketBatcher",
    "pick_bucket",
    "WordPieceTokenizer",
    "load_tokenizer",
    "train_wordpiece_vocab",
]
