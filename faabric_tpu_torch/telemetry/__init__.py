from faabric_tpu_torch.telemetry.metrics import MetricsRegistry, get_metrics

__all__ = ["MetricsRegistry", "get_metrics"]
