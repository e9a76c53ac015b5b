from repro_torch.data.pipeline import SPLITS, DataConfig, SyntheticCorpus, make_batch_fn

__all__ = ["SPLITS", "DataConfig", "SyntheticCorpus", "make_batch_fn"]
