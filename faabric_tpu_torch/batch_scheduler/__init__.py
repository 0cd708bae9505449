from faabric_tpu_torch.batch_scheduler.decision import SchedulingDecision

__all__ = ["SchedulingDecision"]
