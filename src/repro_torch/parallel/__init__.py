from repro_torch.parallel.context import ParallelContext

__all__ = ["ParallelContext"]
