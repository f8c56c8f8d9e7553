from .logging import JsonlRunLog, get_logger

__all__ = ["JsonlRunLog", "get_logger"]
