"""Host-wide state: user/key -> StateKeyValue.

Counterpart of ``faabric_tpu/state/state.py`` (reference
include/faabric/state/State.h:23-59, src/state/State.cpp:100-160).
``get_kv`` resolves a key's master through the planner (the first
caller claims it) and caches the KV. The object also hosts the backup
side of the replicated write path: the passive
:class:`~faabric_tpu_torch.state.replica.StateReplica` images that other
hosts' masters forward into, and the promotions (the planner's PROMOTE,
or a fenced client op) that turn a replica into the master after a
failover.

``device`` is the device view's default device for every KV of this
host (``StateKeyValue.get_device_array``): None means the card.
"""

from __future__ import annotations

import threading
from typing import Optional

from faabric_tpu_torch.state.backend import (
    RedisAuthority,
    SharedFileAuthority,
    StaleStateEpoch,
)
from faabric_tpu_torch.state.kv import StateKeyValue
from faabric_tpu_torch.state.remote import StateClient
from faabric_tpu_torch.state.replica import StateReplica
from faabric_tpu_torch.telemetry import flight_record
from faabric_tpu_torch.transport.client_pool import ClientPool
from faabric_tpu_torch.util.config import get_system_config
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)


class State:
    # Concurrency contract
    GUARDS = {
        "_kvs": "_lock",
        "_replicas": "_lock",
    }

    def __init__(self, host: str, planner_client=None, device=None) -> None:
        self.host = host
        self.planner_client = planner_client
        self.device = device
        self._lock = threading.Lock()
        self._kvs: dict[str, StateKeyValue] = {}
        # Passive replicas this host backs for other hosts' masters
        self._replicas: dict[str, StateReplica] = {}
        self._state_clients = ClientPool(StateClient)

    # ------------------------------------------------------------------
    def _client_factory(self, master_host: str) -> StateClient:
        return self._state_clients.get(master_host)

    def close_clients(self) -> None:
        """Close every pooled state connection (runtime teardown); the
        pool dials again on the next remote op."""
        self._state_clients.close_all()

    def get_kv(self, user: str, key: str, size: int = 0) -> StateKeyValue:
        full = f"{user}/{key}"
        with self._lock:
            kv = self._kvs.get(full)
        if kv is not None:
            return kv

        conf = get_system_config()
        mode = conf.state_mode
        if mode in ("file", "shm"):
            kv = self._make_file_kv(user, key, size, conf.state_dir)
        elif mode == "redis":
            authority = RedisAuthority(user, key, size)
            kv = StateKeyValue(user, key, authority.size, False, "<redis>",
                               authority=authority, local_host=self.host,
                               device=self.device)
        elif mode != "inmemory":
            raise ValueError(f"Unknown STATE_MODE {mode!r}")
        else:
            kv = self._make_inmemory_kv(user, key, size)

        with self._lock:
            # Another thread may have raced us; the first one wins
            existing = self._kvs.get(full)
            if existing is not None:
                return existing
            self._kvs[full] = kv
        logger.debug("%s created KV %s (mode=%s master=%s size=%d)",
                     self.host, full, mode, kv.master_host, kv.size)
        return kv

    def _make_file_kv(self, user: str, key: str, size: int,
                      state_dir: str) -> StateKeyValue:
        if size <= 0:
            size = SharedFileAuthority.existing_size(user, key, state_dir)
            if size <= 0:
                raise ValueError(
                    f"State key {user}/{key} does not exist yet; creation "
                    "needs an explicit size")
        authority = SharedFileAuthority(user, key, size, state_dir)
        return StateKeyValue(user, key, authority.size, False, "<file>",
                             authority=authority, local_host=self.host,
                             device=self.device)

    def _resolver_for(self, user: str, key: str):
        """The placement re-claim handed to each in-memory KV: one
        planner claim giving (master, backup, epoch)."""
        if self.planner_client is None:
            return None

        def resolve() -> tuple[str, str, int]:
            return self.planner_client.claim_state_master(user, key)

        return resolve

    def _make_inmemory_kv(self, user: str, key: str,
                          size: int) -> StateKeyValue:
        full = f"{user}/{key}"
        if self.planner_client is not None:
            master, backup, epoch = \
                self.planner_client.claim_state_master(user, key)
        else:
            master, backup, epoch = self.host, "", 0
        is_master = master == self.host
        if is_master:
            flight_record("state_master_claim", key=full, host=self.host,
                          size=max(size, 0), backup=backup, epoch=epoch)

        if size <= 0:
            if is_master:
                # A claim of a key this host cannot create (no size):
                # release it, so that the creator can become the master
                if self.planner_client is not None:
                    try:
                        self.planner_client.drop_state_master(user, key)
                        flight_record("state_master_drop", key=full,
                                      host=self.host, reason="no_size")
                    except Exception:  # noqa: BLE001
                        logger.warning("Could not release claim on %s", full)
                raise ValueError(
                    f"Master creation of {full} needs an explicit size")
            size = self._client_factory(master).state_size(user, key,
                                                           epoch=epoch)

        return StateKeyValue(user, key, size, is_master, master,
                             client_factory=self._client_factory,
                             local_host=self.host, backup_host=backup,
                             epoch=epoch,
                             resolver=self._resolver_for(user, key),
                             device=self.device)

    def try_get_kv(self, user: str, key: str) -> Optional[StateKeyValue]:
        with self._lock:
            return self._kvs.get(f"{user}/{key}")

    def delete_kv(self, user: str, key: str) -> None:
        with self._lock:
            kv = self._kvs.pop(f"{user}/{key}", None)
            self._replicas.pop(f"{user}/{key}", None)
        if kv is not None and kv.is_master \
                and self.planner_client is not None:
            try:
                self.planner_client.drop_state_master(user, key)
                flight_record("state_master_drop", key=f"{user}/{key}",
                              host=self.host, reason="delete")
            except Exception:  # noqa: BLE001
                logger.debug("Could not drop master for %s/%s", user, key)

    def get_kv_count(self) -> int:
        with self._lock:
            return len(self._kvs)

    def clear(self) -> None:
        with self._lock:
            self._kvs.clear()
            self._replicas.clear()
        self._state_clients.close_all()

    # ------------------------------------------------------------------
    # The backup side: masters forward acked writes here; the planner
    # (or a fenced client op) promotes the replica after the master dies
    # ------------------------------------------------------------------
    def _get_replica(self, full: str, size: int, epoch: int) -> StateReplica:
        with self._lock:
            rep = self._replicas.get(full)
            if rep is None:
                user, _, key = full.partition("/")
                rep = StateReplica(user, key, size, epoch=epoch)
                self._replicas[full] = rep
            return rep

    def replica_count(self) -> int:
        with self._lock:
            return len(self._replicas)

    def apply_replica_chunks(self, user: str, key: str, epoch: int,
                             size: int,
                             writes: list[tuple[int, bytes]]) -> None:
        full = f"{user}/{key}"
        self._fence_or_demote_master(full, epoch)
        self._get_replica(full, size, epoch).apply_chunks(
            epoch, size, writes)

    def apply_replica_append(self, user: str, key: str, epoch: int,
                             size: int, values: list[bytes],
                             replace: bool = False) -> None:
        full = f"{user}/{key}"
        self._fence_or_demote_master(full, epoch)
        self._get_replica(full, size, epoch).apply_append(
            epoch, size, values, replace=replace)

    def _fence_or_demote_master(self, full: str, epoch: int) -> None:
        """A forward arrived for a key this host masters. At an epoch no
        newer than ours the sender is a fenced-out ex-master still
        trying to ack: reject it. At a newer one this host is the stale
        ex-master and a promoted master replicates to it: demote our KV
        into a replica seeded with its image."""
        user, _, key = full.partition("/")
        kv = self.try_get_kv(user, key)
        if kv is None or not kv.is_master:
            return
        if epoch <= kv.epoch:
            raise StaleStateEpoch(
                f"StaleStateEpoch: replicate of {full} at epoch {epoch} "
                f"rejected by its master at {self.host} "
                f"(epoch {kv.epoch})")
        logger.warning(
            "Demoting stale master %s at %s: epoch %d replicate arrived "
            "(local epoch %d)", full, self.host, epoch, kv.epoch)
        kv.mark_stale()
        image = kv.get()
        appended = (kv.authority.all_appended()
                    if hasattr(kv.authority, "all_appended") else [])
        rep = self._get_replica(full, kv.size, kv.epoch)
        rep.apply_chunks(kv.epoch, kv.size, [(0, image)])
        rep.apply_append(kv.epoch, kv.size, appended, replace=True)
        with self._lock:
            self._kvs.pop(full, None)
        flight_record("state_demoted", key=full, host=self.host,
                      old_epoch=kv.epoch, new_epoch=epoch)

    def maybe_self_promote(self, user: str, key: str,
                           req_epoch: int) -> Optional[StateKeyValue]:
        """A fenced client op found no master KV here: if this host backs
        a replica at an older epoch, the planner made it the owner and
        its PROMOTE was lost or is late, so promote now. Returns the new
        master KV, or None."""
        full = f"{user}/{key}"
        with self._lock:
            rep = self._replicas.get(full)
        if rep is None or req_epoch <= rep.epoch:
            return None
        if self.promote_replica(user, key, req_epoch, ""):
            return self.try_get_kv(user, key)
        return None

    def promote_replica(self, user: str, key: str, epoch: int,
                        backup: str) -> bool:
        """Turn this host's replica into the master copy at ``epoch``.
        Idempotent: a second PROMOTE of a promoted key returns True.
        False: no replica here (the planner then drops the mastership).
        The new backup is synced from the promoted image on a thread of
        its own."""
        full = f"{user}/{key}"
        with self._lock:
            existing = self._kvs.get(full)
            if (existing is not None and existing.is_master
                    and existing.epoch >= epoch):
                return True
            rep = self._replicas.get(full)
        if rep is None:
            return False
        image, appended, _rep_epoch = rep.snapshot()
        kv = StateKeyValue(user, key, len(image), True, self.host,
                           client_factory=self._client_factory,
                           local_host=self.host, backup_host=backup,
                           epoch=epoch,
                           resolver=self._resolver_for(user, key),
                           device=self.device)
        kv.load_image(image, appended)
        with self._lock:
            self._kvs[full] = kv
            self._replicas.pop(full, None)
        logger.warning("Promoted replica %s to master at %s (epoch %d, "
                       "new backup %r)", full, self.host, epoch, backup)
        flight_record("state_promoted", key=full, host=self.host,
                      epoch=epoch, backup=backup, size=kv.size)
        self._start_anti_entropy(kv)
        return True

    def _start_anti_entropy(self, kv: StateKeyValue) -> None:
        """After a promotion: learn the new backup from the planner when
        the PROMOTE named none, then stream the image to it, off the
        server thread (a promotion acks fast)."""
        def run() -> None:
            try:
                if not kv.backup_host and self.planner_client is not None:
                    master, backup, epoch = \
                        self.planner_client.claim_state_master(kv.user,
                                                               kv.key)
                    if master != self.host:
                        return  # a newer failover superseded this one
                    kv.adopt_placement(backup, epoch)
                kv.full_sync_backup()
            except Exception as e:  # noqa: BLE001 — the next failed
                # forward re-resolves and syncs again
                logger.warning("Full sync of %s to %r failed: %s",
                               kv.full_key, kv.backup_host, e)

        threading.Thread(target=run, daemon=True,
                         name=f"state/anti-entropy@{kv.full_key}").start()
