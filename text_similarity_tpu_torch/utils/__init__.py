from .logging import get_logger

__all__ = ["get_logger"]
