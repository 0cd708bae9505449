from faabric_tpu_torch.util.device import resolve_device

__all__ = ["resolve_device"]
