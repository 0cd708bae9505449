"""Distributed state KV (reference src/state).

Counterpart of ``faabric_tpu/state/``, less the Redis authority
(``ROADMAP.md`` Queue 1 #9 part D).
"""

from faabric_tpu_torch.state.backend import (
    MasterMemoryAuthority,
    RemoteAuthority,
    SharedFileAuthority,
    StaleStateEpoch,
    StateAuthority,
)
from faabric_tpu_torch.state.device_handle import (
    DeviceHandleError,
    DeviceHandleRegistry,
    DeviceStateHandle,
    StaleDeviceHandle,
    get_device_handle_registry,
    reset_device_handles,
)
from faabric_tpu_torch.state.kv import STATE_CHUNK_SIZE, StateKeyValue
from faabric_tpu_torch.state.placement import place_backup, ring_order
from faabric_tpu_torch.state.remote import (
    StateCalls,
    StateClient,
    StateServer,
    clear_mock_state_requests,
    get_mock_state_pushes,
)
from faabric_tpu_torch.state.replica import StateReplica
from faabric_tpu_torch.state.state import State

__all__ = [
    "DeviceHandleError",
    "DeviceHandleRegistry",
    "DeviceStateHandle",
    "StaleDeviceHandle",
    "get_device_handle_registry",
    "reset_device_handles",
    "MasterMemoryAuthority",
    "RemoteAuthority",
    "STATE_CHUNK_SIZE",
    "SharedFileAuthority",
    "StaleStateEpoch",
    "State",
    "StateAuthority",
    "StateCalls",
    "StateClient",
    "StateServer",
    "StateKeyValue",
    "StateReplica",
    "clear_mock_state_requests",
    "get_mock_state_pushes",
    "place_backup",
    "ring_order",
]
