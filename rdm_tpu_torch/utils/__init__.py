from .logging import get_logger, makedirs  # noqa: F401
