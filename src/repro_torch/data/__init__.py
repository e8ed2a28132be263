from repro_torch.data.pipeline import MemmapTokens, SyntheticLM, make_pipeline

__all__ = ["SyntheticLM", "MemmapTokens", "make_pipeline"]
