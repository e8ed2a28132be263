from repro_torch.runtime.resilience import ElasticMesh, StepWatchdog, run_resilient

__all__ = ["StepWatchdog", "ElasticMesh", "run_resilient"]
