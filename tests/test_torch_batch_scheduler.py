"""The port's batch scheduler and planner placements against the JAX
package's.

Mirrors ``tests/unit/test_batch_scheduler.py`` on the port's policies,
then holds them to the reference over a seeded matrix: host maps
(slots, used slots, device counts, spot taints) and requests (NEW,
SCALE_CHANGE and DIST_CHANGE, plain and MPI, two tenants), built in both
packages from the same values. Bin-pack, compact and spot must return
equal decisions: hosts, app and group ids, message and group indices.
The planner, which claims MPI ports and device ids for a decision, is
compared the same way (both in mock mode, so dispatch is recorded).
"""

import numpy as np
import pytest

import faabric_tpu.batch_scheduler as ref_bs
import faabric_tpu.planner.planner as ref_planner
import faabric_tpu.proto as ref_proto
import faabric_tpu.util.testing as ref_testing
import faabric_tpu_torch.batch_scheduler as bs
import faabric_tpu_torch.planner.planner as port_planner
import faabric_tpu_torch.proto as port_proto
import faabric_tpu_torch.util.testing as port_testing
from faabric_tpu_torch.batch_scheduler import (
    BinPackScheduler,
    CompactScheduler,
    DecisionType,
    HostState,
    SchedulingDecision,
    SpotScheduler,
    get_batch_scheduler,
    get_decision_cache,
    locality_score,
    minimise_num_of_migrations,
    reset_batch_scheduler,
)
from faabric_tpu_torch.batch_scheduler.decision import (
    DO_NOT_MIGRATE,
    MUST_FREEZE,
    NOT_ENOUGH_SLOTS,
)
from faabric_tpu_torch.proto import BatchExecuteType, batch_exec_factory


def hosts(*specs):
    """specs: (ip, slots, used)"""
    return {ip: HostState(ip=ip, slots=s, used_slots=u) for ip, s, u in specs}


def decision_from(req, host_list):
    d = SchedulingDecision(req.app_id, req.group_id)
    for m, h in zip(req.messages, host_list):
        d.add_message(h, m.id, m.app_idx, m.group_idx)
    return d


@pytest.fixture(autouse=True)
def _reset_sched():
    yield
    reset_batch_scheduler()
    get_decision_cache().clear()
    ref_bs.reset_batch_scheduler()
    port_testing.set_mock_mode(False)


# ---------------------------------------------------------------------------
# The reference's unit tests, on the port
# ---------------------------------------------------------------------------

def test_decision_vectors_and_helpers():
    d = SchedulingDecision(app_id=1, group_id=2)
    d.add_message("a", 10, 0, 0, mpi_port=8020, device_id=0)
    d.add_message("b", 11, 1, 1, mpi_port=8021, device_id=1)
    d.add_message("a", 12, 2, 2)
    assert d.n_messages == 3
    assert not d.is_single_host()
    assert d.unique_hosts() == ["a", "b"]
    assert d.host_for_idx(1) == "b"
    assert d.host_freq_count() == {"a": 2, "b": 1}
    d.remove_message(11)
    assert d.n_messages == 2
    assert d.is_single_host()
    assert SchedulingDecision.from_dict(d.to_dict()) == d


def test_decision_in_position():
    d = SchedulingDecision(app_id=1)
    d.add_message_in_position(2, "c", 30, 2, 2)
    d.add_message_in_position(0, "a", 10, 0, 0)
    assert d.hosts == ["a", "", "c"]


def test_locality_score():
    d = SchedulingDecision(app_id=1)
    for h in ("a", "a", "b", "b"):
        d.add_message(h, 0, 0, 0)
    assert locality_score(d) == (2, 4)  # 2 hosts; 2x2 cross links
    single = SchedulingDecision(app_id=1)
    single.add_message("a", 0, 0, 0)
    assert locality_score(single) == (1, 0)


def test_decision_types():
    sched = BinPackScheduler()
    req = batch_exec_factory("demo", "echo", 4)
    in_flight = {}
    assert sched.get_decision_type(in_flight, req) == DecisionType.NEW
    in_flight[req.app_id] = (req, decision_from(req, ["a"] * 4))
    scale = batch_exec_factory("demo", "echo", 2)
    scale.app_id = req.app_id
    assert sched.get_decision_type(in_flight, scale) == \
        DecisionType.SCALE_CHANGE
    mig = batch_exec_factory("demo", "echo", 4)
    mig.app_id = req.app_id
    mig.type = int(BatchExecuteType.MIGRATION)
    assert sched.get_decision_type(in_flight, mig) == DecisionType.DIST_CHANGE


def test_bin_pack_new_fills_largest_first():
    hm = hosts(("10.0.0.1", 4, 0), ("10.0.0.2", 2, 0), ("10.0.0.3", 6, 2))
    req = batch_exec_factory("demo", "echo", 7)
    d = BinPackScheduler().make_scheduling_decision(hm, {}, req)
    assert d.hosts == ["10.0.0.3"] * 4 + ["10.0.0.1"] * 3


def test_bin_pack_not_enough_slots():
    hm = hosts(("a", 2, 1), ("b", 2, 2))
    req = batch_exec_factory("demo", "echo", 3)
    d = BinPackScheduler().make_scheduling_decision(hm, {}, req)
    assert d.app_id == NOT_ENOUGH_SLOTS


def test_bin_pack_scale_change_colocates():
    hm = hosts(("big", 8, 0), ("small", 4, 2))
    req = batch_exec_factory("demo", "echo", 2)
    in_flight = {req.app_id: (req, decision_from(req, ["small", "small"]))}
    scale = batch_exec_factory("demo", "echo", 2)
    scale.app_id = req.app_id
    d = BinPackScheduler().make_scheduling_decision(hm, in_flight, scale)
    assert d.hosts == ["small", "small"]


def test_bin_pack_dist_change_improves_locality():
    hm = hosts(("a", 2, 2), ("b", 2, 2), ("c", 4, 0))
    req = batch_exec_factory("demo", "echo", 4)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a", "a", "b", "b"]))}
    d = BinPackScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.hosts == ["c"] * 4
    assert hm["a"].used_slots == 2  # the host map is not mutated


def test_bin_pack_dist_change_do_not_migrate_when_no_gain():
    hm = hosts(("a", 4, 4), ("b", 2, 0))
    req = batch_exec_factory("demo", "echo", 4)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a"] * 4))}
    d = BinPackScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.app_id == DO_NOT_MIGRATE


def test_minimise_num_of_migrations_keeps_old_placements():
    old = SchedulingDecision(app_id=7, group_id=3)
    for i, h in enumerate(["a", "a", "b", "b"]):
        old.add_message(h, 100 + i, i, i, mpi_port=8020 + i, device_id=i % 2)
    new = SchedulingDecision(app_id=7)
    for h in ["a", "a", "a", "b"]:
        new.add_message(h, 0, 0, 0)
    out = minimise_num_of_migrations(new, old)
    assert out.host_freq_count() == {"a": 3, "b": 1}
    assert sum(out.hosts[i] != old.hosts[i] for i in range(4)) == 1
    for i in range(4):
        if out.hosts[i] == old.hosts[i]:
            assert out.mpi_ports[i] == old.mpi_ports[i]
            assert out.device_ids[i] == old.device_ids[i]


def test_compact_dist_change_consolidates_to_fewer_hosts():
    hm = hosts(("a", 4, 1), ("b", 4, 3))
    req = batch_exec_factory("demo", "echo", 2)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a", "b"]))}
    d = CompactScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.hosts == ["b", "b"]


def test_compact_do_not_migrate_when_no_host_freed():
    hm = hosts(("a", 2, 2), ("b", 2, 2))
    req = batch_exec_factory("demo", "echo", 2)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a", "b"]))}
    d = CompactScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.app_id == DO_NOT_MIGRATE


def test_compact_filters_other_tenants():
    hm = hosts(("a", 4, 2), ("b", 4, 0))
    other = batch_exec_factory("other", "fn", 2)
    other.subtype = 99
    in_flight = {other.app_id: (other, decision_from(other, ["a", "a"]))}
    req = batch_exec_factory("demo", "echo", 2)
    d = CompactScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.hosts == ["b", "b"]


def test_compact_full_cluster_migration_does_not_freeze():
    hm = hosts(("a", 2, 2), ("b", 2, 2))
    other = batch_exec_factory("other", "fn", 1)
    other.subtype = 99
    req = batch_exec_factory("demo", "echo", 2)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a", "b"])),
                 other.app_id: (other, decision_from(other, ["a"]))}
    d = CompactScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.app_id != MUST_FREEZE


def test_spot_never_schedules_on_evicted_host():
    hm = hosts(("a", 8, 0), ("b", 4, 0))
    hm["a"].for_eviction = True
    req = batch_exec_factory("demo", "echo", 2)
    assert SpotScheduler().make_scheduling_decision(hm, {}, req).hosts == \
        ["b", "b"]


def test_spot_dist_change_evacuates_evicted_host():
    hm = hosts(("a", 2, 2), ("b", 4, 0))
    hm["a"].for_eviction = True
    req = batch_exec_factory("demo", "echo", 2)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a", "a"]))}
    d = SpotScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.hosts == ["b", "b"]


def test_spot_dist_change_freezes_without_capacity():
    hm = hosts(("a", 2, 2), ("b", 2, 2))
    hm["a"].for_eviction = True
    req = batch_exec_factory("demo", "echo", 2)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a", "a"]))}
    d = SpotScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.app_id == MUST_FREEZE


def test_spot_dist_change_no_eviction_no_migration():
    hm = hosts(("a", 2, 2), ("b", 4, 0))
    req = batch_exec_factory("demo", "echo", 2)
    req.type = int(BatchExecuteType.MIGRATION)
    in_flight = {req.app_id: (req, decision_from(req, ["a", "a"]))}
    d = SpotScheduler().make_scheduling_decision(hm, in_flight, req)
    assert d.app_id == DO_NOT_MIGRATE


def test_get_batch_scheduler_mode_switch():
    reset_batch_scheduler("compact")
    assert isinstance(get_batch_scheduler(), CompactScheduler)
    reset_batch_scheduler("spot")
    assert isinstance(get_batch_scheduler(), SpotScheduler)
    reset_batch_scheduler("bin-pack")
    assert isinstance(get_batch_scheduler(), BinPackScheduler)


def test_decision_cache():
    cache = get_decision_cache()
    req = batch_exec_factory("demo", "echo", 3)
    assert cache.get_cached_decision(req) is None
    cache.add_cached_decision(req, ["a", "b", "a"], group_id=42)
    hit = cache.get_cached_decision(req)
    assert hit is not None and hit.hosts == ["a", "b", "a"]
    assert hit.group_id == 42
    req2 = batch_exec_factory("demo", "echo", 2)
    assert cache.get_cached_decision(req2) is None
    with pytest.raises(ValueError):
        cache.add_cached_decision(req2, ["a"], group_id=1)


# ---------------------------------------------------------------------------
# Seeded matrix against the reference
# ---------------------------------------------------------------------------

MODES = {"bin-pack": (BinPackScheduler, ref_bs.BinPackScheduler),
         "compact": (CompactScheduler, ref_bs.CompactScheduler),
         "spot": (SpotScheduler, ref_bs.SpotScheduler)}
KINDS = ("new", "scale", "dist")


def _request(proto, app_id, n, base_id, kind, is_mpi, subtype, first_idx=0):
    req = proto.BatchExecuteRequest(app_id=app_id, user="demo",
                                    function="fn", subtype=subtype)
    if kind == "dist":
        req.type = int(proto.BatchExecuteType.MIGRATION)
    for i in range(n):
        req.messages.append(proto.Message(
            id=base_id + i, app_id=app_id, app_idx=first_idx + i,
            group_idx=first_idx + i, user="demo", function="fn",
            is_mpi=is_mpi))
    return req


def scenario(seed: int, kind: str, chips: bool):
    """Plain values for one case: hosts, in-flight apps and the request."""
    rng = np.random.RandomState(seed * 7 + KINDS.index(kind) * 3 + chips)
    n_hosts = int(rng.randint(1, 6))
    host_rows = []
    for i in range(n_hosts):
        slots = int(rng.randint(1, 9))
        host_rows.append((f"10.0.0.{i}", slots, int(rng.randint(0, slots + 1)),
                          int(rng.randint(1, 5)) if chips else 0,
                          bool(rng.rand() < 0.25)))
    ips = [r[0] for r in host_rows]
    apps = []
    # Other tenants' apps (compact filters their hosts)
    for a in range(int(rng.randint(0, 3))):
        placed = [ips[j] for j in rng.randint(0, n_hosts, rng.randint(1, 3))]
        apps.append((500 + a, int(rng.randint(0, 2)), placed, 5000 + 10 * a))
    is_mpi = bool(rng.rand() < 0.5)
    subtype = int(rng.randint(0, 2))
    n = int(rng.randint(1, 13))
    app_id = 77
    if kind == "new":
        request = (app_id, n, 9000, kind, is_mpi, subtype, 0)
    else:
        old_n = n if kind == "dist" else int(rng.randint(1, 6))
        placed = [ips[j] for j in rng.randint(0, n_hosts, old_n)]
        apps.append((app_id, subtype, placed, 8000))
        add = n if kind == "dist" else int(rng.randint(1, 6))
        first = 0 if kind == "dist" else old_n
        base = 8000 if kind == "dist" else 9000
        request = (app_id, add, base, kind, is_mpi, subtype, first)
    return host_rows, apps, request, is_mpi


def build_case(bs_mod, proto, values):
    host_rows, apps, request, is_mpi = values
    hm = {ip: bs_mod.HostState(ip=ip, slots=s, used_slots=u, n_devices=d,
                               for_eviction=e)
          for ip, s, u, d, e in host_rows}
    in_flight = {}
    for app_id, subtype, placed, base_id in apps:
        req = _request(proto, app_id, len(placed), base_id, "new", is_mpi,
                       subtype)
        d = bs_mod.SchedulingDecision(app_id, 0)
        for m, h in zip(req.messages, placed):
            d.add_message(h, m.id, m.app_idx, m.group_idx)
        in_flight[app_id] = (req, d)
    return hm, in_flight, _request(proto, *request)


@pytest.mark.parametrize("chips", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed", range(8))
def test_policy_decisions_match_the_reference(seed, mode, kind, chips):
    values = scenario(seed, kind, chips)
    port_cls, ref_cls = MODES[mode]
    want = ref_cls().make_scheduling_decision(
        *build_case(ref_bs, ref_proto, values))
    got = port_cls().make_scheduling_decision(
        *build_case(bs, port_proto, values))
    assert got.to_dict() == want.to_dict()


PLANNER_HOSTS = [("w0", 4), ("w1", 6), ("w2", 3)]


def _planner_run(planner_mod, proto, testing, seed, kind, chips, is_mpi):
    """Register hosts, schedule an app (and a scale or dist change of it)
    on a fresh planner in mock mode; returns the decisions as dicts and
    the planner's available hosts."""
    testing.set_mock_mode(True)
    try:
        planner = planner_mod.Planner()
        rng = np.random.RandomState(seed)
        for ip, slots in PLANNER_HOSTS:
            planner.register_host(ip, slots, int(rng.randint(1, 5))
                                  if chips else 0)
        n = int(rng.randint(5, 13))
        req = _request(proto, 300 + seed, n, 1000, "new", is_mpi, 0)
        req.group_id = 4242
        out = [planner.call_batch(req).to_dict()]
        if kind == "scale":
            scale = _request(proto, 300 + seed, int(rng.randint(1, 4)), 2000,
                             "new", is_mpi, 0, first_idx=n)
            out.append(planner.call_batch(scale).to_dict())
        elif kind == "dist":
            # Free a host's worth of capacity first so a move can pay off
            planner.register_host("w3", 12, 4 if chips else 0)
            mig = _request(proto, 300 + seed, n, 1000, "dist", is_mpi, 0)
            d = planner.call_batch(mig).to_dict()
            d["group_id"] = 0  # minted fresh on each side
            out.append(d)
        hosts = sorted((h.ip, h.used_slots) for h in
                       planner.get_available_hosts())
        return out, hosts
    finally:
        testing.set_mock_mode(False)


@pytest.mark.parametrize("is_mpi", [False, True])
@pytest.mark.parametrize("chips", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(4))
def test_planner_claims_match_the_reference(seed, kind, chips, is_mpi):
    """Hosts, MPI ports and device ids of the planner's decisions, and
    the slots it holds after them."""
    want = _planner_run(ref_planner, ref_proto, ref_testing, seed, kind,
                        chips, is_mpi)
    got = _planner_run(port_planner, port_proto, port_testing, seed, kind,
                       chips, is_mpi)
    assert got == want
    decisions, _ = got
    if chips:
        assert all(d >= 0 for d in decisions[0]["device_ids"])
    assert all(p >= 8020 for p in decisions[0]["mpi_ports"]) == is_mpi
