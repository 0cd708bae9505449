"""The invocation ingress (reference ``faabric_tpu/ingress/``).

Admission control and batched scheduling ticks between the endpoints
(the planner's RPC and REST surfaces) and the planner core: see
``admission.py`` and ``tick.py``.
"""

from faabric_tpu_torch.ingress.admission import (
    AdmissionController,
    AdmissionVerdict,
    IngressShedError,
)
from faabric_tpu_torch.ingress.tick import IngressCoordinator

__all__ = [
    "AdmissionController",
    "AdmissionVerdict",
    "IngressCoordinator",
    "IngressShedError",
]
