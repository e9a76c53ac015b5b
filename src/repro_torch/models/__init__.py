from repro_torch.models.model import (
    ModelPlan,
    cache_shapes,
    decode_step,
    init_cache,
    init_paged_cache,
    init_params,
    make_plan,
    paged_cache_shapes,
    paged_decode_step,
    paged_prefill_chunk,
    prefill,
    train_loss,
)

__all__ = [
    "ModelPlan",
    "make_plan",
    "init_params",
    "init_cache",
    "cache_shapes",
    "train_loss",
    "prefill",
    "decode_step",
    "paged_cache_shapes",
    "init_paged_cache",
    "paged_prefill_chunk",
    "paged_decode_step",
]
