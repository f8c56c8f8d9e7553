from .lexicon import Lexicon, demo_lexicon, name_topics
from .logging import JsonlRunLog, get_logger

__all__ = ["JsonlRunLog", "get_logger", "Lexicon", "demo_lexicon", "name_topics"]
