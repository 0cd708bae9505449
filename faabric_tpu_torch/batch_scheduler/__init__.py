"""Pluggable batch-scheduling policies (reference src/batch-scheduler)."""

from faabric_tpu_torch.batch_scheduler.decision import (
    DO_NOT_MIGRATE,
    MUST_FREEZE,
    NOT_ENOUGH_SLOTS,
    SchedulingDecision,
    do_not_migrate_decision,
    is_sentinel_decision,
    must_freeze_decision,
    not_enough_slots_decision,
)
from faabric_tpu_torch.batch_scheduler.decision_cache import (
    CachedDecision,
    DecisionCache,
    get_decision_cache,
)
from faabric_tpu_torch.batch_scheduler.scheduler import (
    BatchScheduler,
    DecisionType,
    HostMap,
    HostState,
    InFlightReqs,
    copy_host_map,
    get_batch_scheduler,
    minimise_num_of_migrations,
    reset_batch_scheduler,
)
from faabric_tpu_torch.batch_scheduler.bin_pack import (
    BinPackScheduler,
    locality_score,
)
from faabric_tpu_torch.batch_scheduler.compact import CompactScheduler
from faabric_tpu_torch.batch_scheduler.spot import SpotScheduler

__all__ = [
    "DO_NOT_MIGRATE",
    "MUST_FREEZE",
    "NOT_ENOUGH_SLOTS",
    "BatchScheduler",
    "BinPackScheduler",
    "CachedDecision",
    "CompactScheduler",
    "DecisionCache",
    "DecisionType",
    "HostMap",
    "HostState",
    "InFlightReqs",
    "SchedulingDecision",
    "SpotScheduler",
    "copy_host_map",
    "do_not_migrate_decision",
    "get_batch_scheduler",
    "get_decision_cache",
    "is_sentinel_decision",
    "locality_score",
    "minimise_num_of_migrations",
    "must_freeze_decision",
    "not_enough_slots_decision",
    "reset_batch_scheduler",
]
