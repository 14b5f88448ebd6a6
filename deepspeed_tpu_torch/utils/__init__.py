from .logging import log_dist, logger

__all__ = ["log_dist", "logger"]
