"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(:mod:`.ref`) and the dispatch between them (:mod:`.ops`)."""
