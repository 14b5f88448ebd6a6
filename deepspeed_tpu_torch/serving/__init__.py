from .batcher import PrefixEntry, SlotBatcher
from .config import ServingConfig

__all__ = ["PrefixEntry", "ServingConfig", "SlotBatcher"]
