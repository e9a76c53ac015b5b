"""Quantized serving: the contiguous and paged engines, the page pool, and
the restack of the PTQ artifact into serving params (:mod:`.qparams`)."""

from repro_torch.serve.engine import AgreedClock, PagedServingEngine, Request, ServingEngine
from repro_torch.serve.kv_cache import PagePool

__all__ = ["AgreedClock", "PagedServingEngine", "Request", "ServingEngine", "PagePool"]
